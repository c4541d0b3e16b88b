"""Pooling layers (counterpart of `paddle_tpu/nn/pooling.py`), over the
functional pools. As in the JAX layers, the avg-pool layers keep the
functional default `exclusive=True`, and `data_format` is kept and not
read."""
from __future__ import annotations

from . import functional as F
from .layer import Layer


class _Pool(Layer):
    def __init__(self, kernel_size=None, stride=None, padding=0,
                 ceil_mode=False, **kw):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.ceil_mode = padding, ceil_mode
        kw.pop('name', None)
        self._kw = kw


class MaxPool1D(_Pool):
    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode)


class MaxPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format='NCHW',
                 name=None):
        # Paddle's positional order puts return_mask before ceil_mode
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         data_format=data_format)
        self.return_mask = return_mask

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            return_mask=self.return_mask,
                            ceil_mode=self.ceil_mode)


class MaxPool3D(_Pool):
    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode)


class AvgPool1D(_Pool):
    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode)


class AvgPool2D(_Pool):
    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode)


class AvgPool3D(_Pool):
    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode)


class _AdaptivePool(Layer):
    def __init__(self, output_size, data_format=None, name=None):
        super().__init__()
        self.output_size = output_size


class AdaptiveAvgPool1D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size)


class AdaptiveAvgPool3D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size)


class AdaptiveMaxPool1D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size)


class AdaptiveMaxPool2D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)


class MaxUnPool2D(Layer):
    """The partial inverse of MaxPool2D(return_mask=True)."""

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format='NCHW', output_size=None, name=None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.output_size = padding, output_size
        self.data_format = data_format

    def forward(self, x, indices):
        return F.max_unpool2d(x, indices, self.kernel_size, self.stride,
                              self.padding, data_format=self.data_format,
                              output_size=self.output_size)
