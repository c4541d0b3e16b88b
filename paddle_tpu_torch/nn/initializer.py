"""paddle.nn.initializer (counterpart of `paddle_tpu/nn/initializer.py`).

An initializer is a callable `(shape, dtype=None, device=None,
generator=None) -> torch.Tensor`; `fill_(t, generator)` writes its
values into an existing tensor, which is how `Layer.create_parameter`
makes a parameter on its device and dtype. Random draws come from an
explicit `torch.Generator`: the one passed, else the framework's
generator of the device (`framework.default_generator`, reseeded by
`paddle.seed`). They are Philox draws, not the JAX package's threefry
ones: the distributions are the same, the numbers are not.

Fans follow the JAX package: for a Linear weight [in, out] fan_in and
fan_out are the first and last dims; a conv kernel [out, in, *k]
multiplies by the receptive field. `Normal` draws in the tensor's own
dtype (`normal_`, as the port's models always drew); the others draw in
fp32 and round into it, as the JAX initializers do.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import framework
from ..dtype import convert_dtype


def _fans(shape):
    shape = tuple(int(s) for s in shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    rf = int(np.prod(shape[2:]))  # conv kernels: [out, in, *spatial]
    return shape[1] * rf, shape[0] * rf


def _f32_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=torch.float32, device=t.device)


class Initializer:

    def __call__(self, shape, dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        dt = convert_dtype(dtype) if dtype is not None \
            else framework.get_default_dtype()
        dev = framework.current_device() if device is None \
            else framework.resolve_device(device)
        t = torch.empty(tuple(int(s) for s in shape), dtype=dt, device=dev)
        return self.fill_(t, generator)

    def fill_(self, t: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Write this initializer's values into `t` in place (no grad);
        random draws from `generator`, else the framework's."""
        g = generator if generator is not None \
            else framework.default_generator(t.device)
        with torch.no_grad():
            self._fill(t, g)
        return t

    def _fill(self, t, g):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _fill(self, t, g):
        t.fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _fill(self, t, g):
        t.normal_(self.mean, self.std, generator=g)


class TruncatedNormal(Initializer):
    """Normal truncated to mean +- 2 std (the JAX package's semantics)."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _fill(self, t, g):
        s = torch.nn.init.trunc_normal_(_f32_like(t), 0.0, 1.0, -2.0, 2.0,
                                        generator=g)
        t.copy_(s * self.std + self.mean)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _fill(self, t, g):
        t.copy_(_f32_like(t).uniform_(self.low, self.high, generator=g))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def _fill(self, t, g):
        fi, fo = _fans(t.shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / max(1, fi + fo))
        t.copy_(_f32_like(t).normal_(0.0, std, generator=g))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def _fill(self, t, g):
        fi, fo = _fans(t.shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / max(1, fi + fo))
        t.copy_(_f32_like(t).uniform_(-limit, limit, generator=g))


class _Kaiming(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity='relu'):
        self._fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _gain_over_root_fan(self, shape) -> float:
        fi, _ = _fans(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2)) \
            if self.nonlinearity in ('relu', 'leaky_relu') else 1.0
        return gain / math.sqrt(max(1, fi))


class KaimingNormal(_Kaiming):
    def _fill(self, t, g):
        std = self._gain_over_root_fan(t.shape)
        t.copy_(_f32_like(t).normal_(0.0, std, generator=g))


class KaimingUniform(_Kaiming):
    def _fill(self, t, g):
        limit = math.sqrt(3.0) * self._gain_over_root_fan(t.shape)
        t.copy_(_f32_like(t).uniform_(-limit, limit, generator=g))


class Orthogonal(Initializer):
    """QR of a normal draw with the sign of R's diagonal folded in (the
    JAX package's construction), scaled by `gain`."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def _fill(self, t, g):
        shape = tuple(t.shape)
        rows = shape[0]
        cols = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        a = torch.empty((max(rows, cols), min(rows, cols)),
                        dtype=torch.float32, device=t.device).normal_(
            generator=g)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        t.copy_((self.gain * q[:rows, :cols]).reshape(shape))


class Dirac(Initializer):
    """Identity-preserving conv kernel init."""

    def __init__(self, groups=1):
        self.groups = groups

    def _fill(self, t, g):
        shape = tuple(t.shape)
        out_c, in_c = shape[0], shape[1]
        w = np.zeros(shape, np.float32)
        centers = [s // 2 for s in shape[2:]]
        for i in range(out_c):
            ch = i % in_c if in_c else 0
            w[(i, ch) + tuple(centers)] = 1.0
        t.copy_(torch.from_numpy(w))


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def _fill(self, t, g):
        v = self.value
        arr = v.detach().cpu() if isinstance(v, torch.Tensor) else \
            torch.as_tensor(np.asarray(v.numpy() if hasattr(v, 'numpy')
                                       else v))
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f'Assign initializer shape {tuple(arr.shape)} '
                             f'!= param shape {tuple(t.shape)}')
        t.copy_(arr)


def calculate_gain(nonlinearity, param=None):
    if nonlinearity == 'tanh':
        return 5.0 / 3
    if nonlinearity == 'relu':
        return math.sqrt(2.0)
    if nonlinearity == 'leaky_relu':
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == 'selu':
        return 3.0 / 4
    return 1.0


class Bilinear(Initializer):
    """Bilinear-upsampling kernel for transposed convs: every [kh, kw]
    slice of the 4-D weight is the tent filter."""

    def _fill(self, t, g):
        shape = tuple(t.shape)
        if len(shape) != 4:
            raise ValueError('Bilinear initializer expects a 4-D conv '
                             f'weight, got shape {shape}')
        kh, kw = shape[2], shape[3]

        def tent(k):
            f = (k + 1) // 2
            c = (2 * f - 1 - f % 2) / (2.0 * f)
            return 1 - np.abs(np.arange(k) / f - c)
        kern = np.outer(tent(kh), tent(kw)).astype(np.float32)
        t.copy_(torch.from_numpy(np.broadcast_to(kern, shape).copy()))


_GLOBAL_WEIGHT_INIT = None
_GLOBAL_BIAS_INIT = None


def set_global_initializer(weight_init, bias_init=None):
    """Override the default parameter initializers for layers built
    afterwards; pass None to restore the built-in defaults."""
    global _GLOBAL_WEIGHT_INIT, _GLOBAL_BIAS_INIT
    _GLOBAL_WEIGHT_INIT = weight_init
    _GLOBAL_BIAS_INIT = bias_init


def _global_default(is_bias):
    return _GLOBAL_BIAS_INIT if is_bias else _GLOBAL_WEIGHT_INIT


__all__ = ['Initializer', 'Constant', 'Normal', 'TruncatedNormal',
           'Uniform', 'XavierNormal', 'XavierUniform', 'KaimingNormal',
           'KaimingUniform', 'Orthogonal', 'Dirac', 'Assign', 'Bilinear',
           'calculate_gain', 'set_global_initializer']
