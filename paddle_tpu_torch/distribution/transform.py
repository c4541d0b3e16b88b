"""paddle.distribution.transform (counterpart of
`paddle_tpu/distribution/transform.py`; upstream: python/paddle/
distribution/transform.py): invertible maps with log-det-Jacobians, the
building blocks of TransformedDistribution. Torch functions recorded on
the tape through `tensor.apply_op`, so everything stays differentiable.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from .. import framework
from ..tensor import Tensor, apply_op, to_torch

__all__ = [
    'Transform', 'AffineTransform', 'ExpTransform', 'SigmoidTransform',
    'TanhTransform', 'PowerTransform', 'AbsTransform', 'ChainTransform',
]


def _as_t(x):
    """A Tensor as it is; anything else as a float32 Tensor (a torch
    tensor keeps its device, host data goes to the current place)."""
    if isinstance(x, Tensor):
        return x
    v = to_torch(x)
    if isinstance(v, torch.Tensor):
        return Tensor(v.to(torch.float32))
    return Tensor(torch.as_tensor(v, dtype=torch.float32,
                                  device=framework.current_device()))


def _bcast(value, *tensors):
    return value.expand(torch.broadcast_shapes(*(t.shape for t in tensors)))


class Transform:
    """Bijective map y = f(x). Subclasses implement `_forward`,
    `_inverse`, `_forward_log_det_jacobian` as torch functions."""

    def forward(self, x):
        return apply_op(self._forward, _as_t(x),
                        _name=type(self).__name__ + '_fwd')

    def inverse(self, y):
        return apply_op(self._inverse, _as_t(y),
                        _name=type(self).__name__ + '_inv')

    def forward_log_det_jacobian(self, x):
        return apply_op(self._forward_log_det_jacobian, _as_t(x),
                        _name=type(self).__name__ + '_fldj')

    def inverse_log_det_jacobian(self, y):
        # d/dy f^{-1} = 1 / f'(f^{-1}(y))
        x = self.inverse(y)
        return apply_op(lambda v: -self._forward_log_det_jacobian(v), x,
                        _name=type(self).__name__ + '_ildj')

    def __call__(self, x):
        return self.forward(x)


class AffineTransform(Transform):
    """y = loc + scale * x."""

    def __init__(self, loc, scale):
        self.loc = _as_t(loc)
        self.scale = _as_t(scale)

    def forward(self, x):
        return apply_op(lambda v, l, s: l + s * v, _as_t(x), self.loc,
                        self.scale, _name='affine_fwd')

    def inverse(self, y):
        return apply_op(lambda v, l, s: (v - l) / s, _as_t(y), self.loc,
                        self.scale, _name='affine_inv')

    def forward_log_det_jacobian(self, x):
        return apply_op(lambda v, s: _bcast(torch.log(torch.abs(s)), v, s),
                        _as_t(x), self.scale, _name='affine_fldj')

    def inverse_log_det_jacobian(self, y):
        return apply_op(lambda v, s: _bcast(-torch.log(torch.abs(s)), v, s),
                        _as_t(y), self.scale, _name='affine_ildj')


class ExpTransform(Transform):
    """y = exp(x)."""

    @staticmethod
    def _forward(v):
        return torch.exp(v)

    @staticmethod
    def _inverse(v):
        return torch.log(v)

    @staticmethod
    def _forward_log_det_jacobian(v):
        return v


class SigmoidTransform(Transform):
    """y = sigmoid(x)."""

    @staticmethod
    def _forward(v):
        return 1.0 / (1.0 + torch.exp(-v))

    @staticmethod
    def _inverse(v):
        return torch.log(v) - torch.log1p(-v)

    @staticmethod
    def _forward_log_det_jacobian(v):
        # log sigmoid'(x) = log σ(x) + log σ(-x), stably via softplus
        return -TF.softplus(-v) - TF.softplus(v)


class TanhTransform(Transform):
    """y = tanh(x)."""

    @staticmethod
    def _forward(v):
        return torch.tanh(v)

    @staticmethod
    def _inverse(v):
        return torch.atanh(v)

    @staticmethod
    def _forward_log_det_jacobian(v):
        # log(1 - tanh(x)^2) = 2 (log 2 - x - softplus(-2x))
        return 2.0 * (math.log(2.0) - v - TF.softplus(-2.0 * v))


class PowerTransform(Transform):
    """y = x ** power (x > 0)."""

    def __init__(self, power):
        self.power = _as_t(power)

    def forward(self, x):
        return apply_op(lambda v, p: torch.pow(v, p), _as_t(x), self.power,
                        _name='power_fwd')

    def inverse(self, y):
        return apply_op(lambda v, p: torch.pow(v, 1.0 / p), _as_t(y),
                        self.power, _name='power_inv')

    def forward_log_det_jacobian(self, x):
        return apply_op(
            lambda v, p: torch.log(torch.abs(p)) + (p - 1.0) * torch.log(v),
            _as_t(x), self.power, _name='power_fldj')

    def inverse_log_det_jacobian(self, y):
        x = self.inverse(y)
        return apply_op(
            lambda v, p: -(torch.log(torch.abs(p))
                           + (p - 1.0) * torch.log(v)),
            x, self.power, _name='power_ildj')


class AbsTransform(Transform):
    """y = |x|: not bijective; inverse returns the positive branch
    (upstream AbsTransform does the same)."""

    @staticmethod
    def _forward(v):
        return torch.abs(v)

    @staticmethod
    def _inverse(v):
        return v

    @staticmethod
    def _forward_log_det_jacobian(v):
        return torch.zeros_like(v)


class ChainTransform(Transform):
    """Composition: y = fN(...f1(x))."""

    def __init__(self, transforms):
        self.transforms = list(transforms)

    def forward(self, x):
        for t in self.transforms:
            x = t.forward(x)
        return x

    def inverse(self, y):
        for t in reversed(self.transforms):
            y = t.inverse(y)
        return y

    def forward_log_det_jacobian(self, x):
        total = None
        for t in self.transforms:
            ld = t.forward_log_det_jacobian(x)
            total = ld if total is None else total + ld
            x = t.forward(x)
        return total

    def inverse_log_det_jacobian(self, y):
        total = None
        for t in reversed(self.transforms):
            ld = t.inverse_log_det_jacobian(y)
            total = ld if total is None else total + ld
            y = t.inverse(y)
        return total
