"""Common layers (counterpart of `paddle_tpu/nn/common_layers.py`):
`Linear`, `Embedding`, the dropout family, activations, `Flatten`,
`Identity`, `Bilinear`, `CosineSimilarity`, `PReLU`, `RReLU` and the
containers.

`Linear.weight` keeps Paddle's [in_features, out_features] layout and
computes y = x @ W + b, so keys and shapes copy 1:1 from the JAX
package; it is not a transposed `torch.nn.Linear`. The constructors are
Paddle's (`Linear(in, out, weight_attr=None, bias_attr=None)`, a bias
unless `bias_attr=False`; Xavier-uniform weights; an Embedding's
Xavier-normal table), plus the port's keywords `device=`, `dtype=` and
`generator=` (`Layer.create_parameter`); `Linear(..., bias=False)` is
`bias_attr=False`. The resampling, padding and patch layers
(`Upsample*`, `PixelShuffle`, `PixelUnshuffle`, `ChannelShuffle`,
`Pad1D/2D/3D`, `ZeroPad2D`, `Unfold`, `Fold`) hold no parameters and
call their functional entries, as the JAX layers do.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch
from torch import nn

from . import functional as F
from . import initializer as I
from .layer import Layer


def _bias_attr(bias_attr, bias: Optional[bool]):
    if bias is not None:
        return bias_attr if bias else False
    return bias_attr


class Linear(Layer):

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 bias: Optional[bool] = None, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        init = dict(dtype=dtype, device=device, generator=generator)
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr, **init)
        self.bias = self.create_parameter(
            (out_features,), attr=_bias_attr(bias_attr, bias), is_bias=True,
            **init)

    def forward(self, x):
        y = F.linear(x, self.weight, self.bias)
        # serving.adapters tags target projections with a per-instance
        # hook, inert unless an adapter scope is active
        hook = self.__dict__.get('_adapter_hook')
        if hook is not None:
            y = hook(self, x, y)
        return y

    def extra_repr(self):
        return f'in={self.in_features}, out={self.out_features}'


class Embedding(Layer):

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse=False, weight_attr=None, name=None,
                 *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr, dtype=dtype,
            default_initializer=I.XavierNormal(), device=device,
            generator=generator)
        if padding_idx is not None:
            if self.weight.is_lazy:
                # LazyGuard: initialize() zeroes the padding row too
                fill, dev = self.weight.__dict__['_lazy_init']

                def fill_with_pad_row(t, _fill=fill):
                    _fill(t)
                    with torch.no_grad():
                        t[padding_idx] = 0
                self.weight.defer_init(fill_with_pad_row, dev)
            else:
                with torch.no_grad():
                    self.weight[padding_idx] = 0

    def forward(self, ids):
        return F.embedding(ids, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self):
        return f'{self.num_embeddings}, {self.embedding_dim}'


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode='upscale_in_train', name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f'p={self.p}'


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format='NCHW', name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format='NCDHW', name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        init = dict(dtype=dtype, device=device, generator=generator)
        self.weight = self.create_parameter(
            (out_features, in1_features, in2_features), attr=weight_attr,
            **init)
        self.bias = self.create_parameter((out_features,), attr=bias_attr,
                                          is_bias=True, **init)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


# -- activation layers ------------------------------------------------------


def _act_layer(fname, cls_name):
    fn = getattr(F, fname)

    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            kwargs.pop('name', None)
            self._args, self._kwargs = args, kwargs

        def forward(self, x):
            return fn(x, *self._args, **self._kwargs)
    _Act.__name__ = cls_name
    _Act.__qualname__ = cls_name
    return _Act


ReLU = _act_layer('relu', 'ReLU')
ReLU6 = _act_layer('relu6', 'ReLU6')
GELU = _act_layer('gelu', 'GELU')
Silu = _act_layer('silu', 'Silu')
Swish = _act_layer('silu', 'Swish')
Sigmoid = _act_layer('sigmoid', 'Sigmoid')
Tanh = _act_layer('tanh', 'Tanh')
LeakyReLU = _act_layer('leaky_relu', 'LeakyReLU')
ELU = _act_layer('elu', 'ELU')
SELU = _act_layer('selu', 'SELU')
CELU = _act_layer('celu', 'CELU')
Hardswish = _act_layer('hardswish', 'Hardswish')
Hardsigmoid = _act_layer('hardsigmoid', 'Hardsigmoid')
Hardtanh = _act_layer('hardtanh', 'Hardtanh')
Hardshrink = _act_layer('hardshrink', 'Hardshrink')
Softshrink = _act_layer('softshrink', 'Softshrink')
Tanhshrink = _act_layer('tanhshrink', 'Tanhshrink')
Mish = _act_layer('mish', 'Mish')
Softplus = _act_layer('softplus', 'Softplus')
Softsign = _act_layer('softsign', 'Softsign')
LogSigmoid = _act_layer('logsigmoid', 'LogSigmoid')
GLU = _act_layer('glu', 'GLU')
ThresholdedReLU = _act_layer('thresholded_relu', 'ThresholdedReLU')
Maxout = _act_layer('maxout', 'Maxout')
ChannelShuffle = _act_layer('channel_shuffle', 'ChannelShuffle')
PixelUnshuffle = _act_layer('pixel_unshuffle', 'PixelUnshuffle')
Softmax = _act_layer('softmax', 'Softmax')
LogSoftmax = _act_layer('log_softmax', 'LogSoftmax')


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format='NCHW', name=None, *, device=None, dtype=None):
        super().__init__()
        self.data_format = data_format
        self.weight = self.create_parameter(
            (num_parameters,), attr=weight_attr, dtype=dtype, device=device,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self.data_format)


class RReLU(Layer):
    """Randomized leaky ReLU: a random negative slope in [lower, upper]
    while training, the mean slope in eval."""

    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)


# -- containers -------------------------------------------------------------
# torch's containers under Paddle's names: children are registered as
# '0', '1', ... (or by the names given), as in the JAX package


class Sequential(Layer, nn.Sequential):
    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], (dict, OrderedDict)):
            nn.Sequential.__init__(self, OrderedDict(layers[0]))
            return
        if layers and all(isinstance(l, (tuple, list)) and len(l) == 2
                          for l in layers):
            nn.Sequential.__init__(self, OrderedDict(layers))
            return
        nn.Sequential.__init__(self, *layers)


class LayerList(Layer, nn.ModuleList):
    def __init__(self, sublayers=None):
        nn.ModuleList.__init__(self, sublayers)


class LayerDict(Layer, nn.ModuleDict):
    def __init__(self, sublayers=None):
        nn.ModuleDict.__init__(self, sublayers)


class ParameterList(Layer, nn.ParameterList):
    def __init__(self, parameters=None):
        nn.ParameterList.__init__(self, parameters)


__all__ = ['Linear', 'Embedding', 'Dropout', 'Dropout2D', 'Dropout3D',
           'AlphaDropout', 'Flatten', 'Identity', 'CosineSimilarity',
           'Bilinear', 'ReLU', 'ReLU6', 'GELU', 'Silu', 'Swish', 'Sigmoid',
           'Tanh', 'LeakyReLU', 'ELU', 'SELU', 'CELU', 'Hardswish',
           'Hardsigmoid', 'Hardtanh', 'Hardshrink', 'Softshrink',
           'Tanhshrink', 'Mish', 'Softplus', 'Softsign', 'LogSigmoid',
           'GLU', 'ThresholdedReLU', 'Maxout', 'Softmax', 'LogSoftmax',
           'PReLU', 'RReLU', 'Sequential', 'LayerList', 'LayerDict',
           'ParameterList']


# -- resampling, padding and patches ------------------------------------------


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode='nearest',
                 align_corners=False, align_mode=0, data_format='NCHW',
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode, self.data_format = align_mode, data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format='NCHW',
                 name=None):
        super().__init__(size, scale_factor, 'bilinear', True, 0, data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format='NCHW',
                 name=None):
        super().__init__(size, scale_factor, 'nearest', False, 0, data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format='NCHW', name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class _PadNd(Layer):
    def __init__(self, padding, mode='constant', value=0.0, data_format=None,
                 name=None):
        super().__init__()
        self.padding = [padding] * self._n2 if isinstance(padding, int) \
            else list(padding)
        self.mode, self.value = mode, value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value)


class Pad1D(_PadNd):
    _n2 = 2


class Pad2D(_PadNd):
    _n2 = 4


class Pad3D(_PadNd):
    _n2 = 6


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format='NCHW', name=None):
        super().__init__(padding, 'constant', 0.0, data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes, self.strides = kernel_sizes, strides
        self.paddings, self.dilations = paddings, dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)


class Fold(Layer):
    """col2im, the inverse of Unfold."""

    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.kernel_sizes = kernel_sizes
        self.strides, self.paddings = strides, paddings
        self.dilations = dilations

    def forward(self, x):
        return F.fold(x, self.output_sizes, self.kernel_sizes,
                      self.strides, self.paddings, self.dilations)
