"""Normalization layers (counterpart of `paddle_tpu/nn/norm.py`).

`RMSNorm` runs through the port's RMSNorm kernel; `LayerNorm`,
`GroupNorm`, the `BatchNorm*` family, `InstanceNorm*` and
`LocalResponseNorm` are plain torch over `nn.functional`, as the JAX
package leaves them to XLA. BatchNorm keeps its running statistics as
the buffers `_mean` and `_variance` (the JAX names, so `state_dict`
keys copy across), updated in training with Paddle's momentum
(`F.batch_norm`). `SyncBatchNorm` waits for `distributed/`.
"""
from __future__ import annotations

import numbers

import torch

from .. import framework
from . import functional as F
from . import initializer as I
from .layer import Layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, numbers.Integral):
            normalized_shape = (int(normalized_shape),)
        self.normalized_shape = tuple(int(s) for s in normalized_shape)
        self._epsilon = epsilon
        init = dict(dtype=dtype, device=device)
        self.weight = self.create_parameter(
            self.normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0), **init)
        self.bias = self.create_parameter(
            self.normalized_shape, attr=bias_attr, is_bias=True, **init)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self):
        return f'normalized_shape={self.normalized_shape}'


class RMSNorm(Layer):
    """RMSNorm through the port's kernel (`F.rms_norm`)."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6,
                 weight_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        self.hidden_size = hidden_size
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            (hidden_size,), attr=weight_attr, dtype=dtype, device=device,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format='NCHW',
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        init = dict(dtype=dtype, device=device)
        self.weight = self.create_parameter(
            (num_channels,), attr=weight_attr,
            default_initializer=I.Constant(1.0), **init)
        self.bias = self.create_parameter(
            (num_channels,), attr=bias_attr, is_bias=True, **init)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self.weight, self.bias,
                            self._epsilon, self._data_format)


class _BatchNormBase(Layer):
    _default_format = 'NCHW'

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format=None,
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__()
        self._num_features = num_features
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format or self._default_format
        self._use_global_stats = use_global_stats
        init = dict(dtype=dtype, device=device)
        self.weight = self.create_parameter(
            (num_features,), attr=weight_attr,
            default_initializer=I.Constant(1.0), **init)
        self.bias = self.create_parameter(
            (num_features,), attr=bias_attr, is_bias=True, **init)
        dev = self.weight.device if self.weight is not None else (
            framework.current_device() if device is None
            else framework.resolve_device(device))
        self.register_buffer('_mean', torch.zeros(num_features, device=dev))
        self.register_buffer('_variance', torch.ones(num_features,
                                                     device=dev))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    _default_format = 'NCL'


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    _default_format = 'NCDHW'


class InstanceNorm2D(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format='NCHW',
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self._epsilon = epsilon
        init = dict(dtype=dtype, device=device)
        self.weight = self.create_parameter(
            (num_features,), attr=weight_attr,
            default_initializer=I.Constant(1.0), **init)
        self.bias = self.create_parameter(
            (num_features,), attr=bias_attr, is_bias=True, **init)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


InstanceNorm1D = InstanceNorm2D
InstanceNorm3D = InstanceNorm2D


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format='NCHW', name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k)


__all__ = ['LayerNorm', 'RMSNorm', 'GroupNorm', 'BatchNorm', 'BatchNorm1D',
           'BatchNorm2D', 'BatchNorm3D', 'InstanceNorm1D', 'InstanceNorm2D',
           'InstanceNorm3D', 'LocalResponseNorm']
