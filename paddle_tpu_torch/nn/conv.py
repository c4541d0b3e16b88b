"""Convolution layers (counterpart of `paddle_tpu/nn/conv.py`).

Paddle's layouts: a convolution's weight is [out, in / groups, *kernel],
a transpose's [in, out / groups, *kernel], NCHW by default; so
`state_dict()` keys and shapes copy 1:1 from the JAX package. Weights
draw Kaiming-uniform (negative slope sqrt(5), fan-in in / groups x
kernel) and the bias zeros, as the JAX layers do, from `generator` or
the framework's generator of the device. `padding_mode` is kept and, as
in the JAX layer, not read: every convolution pads with zeros. The
compute is `nn.functional.conv*` (torch's convolutions).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import functional as F
from . import initializer as I
from .layer import Layer


def _ntuple(v, n):
    return (int(v),) * n if isinstance(v, int) else tuple(int(i) for i in v)


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, n,
                 stride=1, padding=0, dilation=1, groups=1,
                 padding_mode='zeros', weight_attr=None, bias_attr=None,
                 data_format=None, transpose=False, output_padding=0, *,
                 device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = _ntuple(kernel_size, n)
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.padding_mode = padding_mode
        self.data_format = data_format
        self.output_padding = output_padding
        self._n = n
        self._transpose = transpose
        if transpose:
            wshape = (in_channels, out_channels // groups) + self.kernel_size
        else:
            wshape = (out_channels, in_channels // groups) + self.kernel_size
        fan_in = (in_channels // groups) * math.prod(self.kernel_size)
        init = dict(device=device, dtype=dtype, generator=generator)
        self.weight = self.create_parameter(
            wshape, attr=weight_attr,
            default_initializer=I.KaimingUniform(
                fan_in=fan_in, negative_slope=math.sqrt(5.0),
                nonlinearity='leaky_relu'), **init)
        self.bias = self.create_parameter(
            (out_channels,), attr=bias_attr, is_bias=True, **init) \
            if bias_attr is not False else None

    def extra_repr(self):
        return (f'{self.in_channels}, {self.out_channels}, '
                f'kernel_size={self.kernel_size}, stride={self.stride}')


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode='zeros',
                 weight_attr=None, bias_attr=None, data_format='NCL', **kw):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, **kw)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode='zeros',
                 weight_attr=None, bias_attr=None, data_format='NCHW', **kw):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, **kw)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode='zeros',
                 weight_attr=None, bias_attr=None, data_format='NCDHW',
                 **kw):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, **kw)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format='NCL', **kw):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, 'zeros', weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding, **kw)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.dilation, self.groups, self.data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format='NCHW', **kw):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, 'zeros', weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding, **kw)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.dilation, self.groups, self.data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format='NCDHW',
                 **kw):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, 'zeros', weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding, **kw)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.dilation, self.groups,
                                  self.data_format)
