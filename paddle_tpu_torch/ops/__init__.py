"""The op library and the Tensor's methods and operators (counterpart of
`paddle_tpu/ops/__init__.py`), beside the Hopper kernels (`kernels`).

The functions of `creation`, `math`, `reduction`, `manipulation`,
`search` and `linalg` take Paddle's arguments and run through
`tensor.apply_op` under the JAX op's name; `_METHOD_NAMES` attaches the
JAX package's method table to the port's `Tensor`, with the Python
operators and the in-place forms (which rebind the handle).
"""
from __future__ import annotations

import numpy as np
import torch

from ..tensor import Tensor
from . import creation, kernels, linalg, manipulation, math, reduction, search
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .reduction import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403

_METHOD_SOURCES = (math, reduction, manipulation, linalg, search)

_METHOD_NAMES = [
    # math
    'add', 'subtract', 'multiply', 'divide', 'floor_divide', 'mod',
    'remainder', 'pow', 'maximum', 'minimum', 'exp', 'expm1', 'log', 'log2', 'log10',
    'log1p', 'sqrt', 'rsqrt', 'abs', 'neg', 'sign', 'sin', 'cos', 'tan',
    'asin', 'acos', 'atan', 'sinh', 'cosh', 'tanh', 'asinh', 'acosh', 'atanh',
    'erf', 'erfinv', 'floor', 'ceil', 'round', 'trunc', 'frac', 'reciprocal',
    'square', 'sigmoid', 'clip', 'lerp', 'scale', 'increment', 'digamma',
    'lgamma', 'nan_to_num', 'logit', 'atan2', 'outer', 'inner', 'logaddexp',
    'equal', 'not_equal', 'greater_than', 'greater_equal', 'less_than',
    'less_equal', 'equal_all', 'allclose', 'isclose', 'logical_and',
    'logical_or', 'logical_xor', 'logical_not', 'bitwise_and', 'bitwise_or',
    'bitwise_xor', 'bitwise_not', 'isnan', 'isinf', 'isfinite', 'deg2rad',
    'rad2deg', 'conj', 'real', 'imag', 'angle', 'sgn', 'trapezoid',
    'cumulative_trapezoid', 'logcumsumexp', 'is_complex',
    'is_floating_point', 'is_integer',
    # reduction
    'sum', 'mean', 'prod', 'max', 'min', 'amax', 'amin', 'all', 'any',
    'std', 'var', 'median', 'quantile', 'logsumexp', 'cumsum', 'cumprod',
    'cummax', 'cummin', 'count_nonzero', 'nansum', 'nanmean', 'nanmedian',
    'nanquantile',
    # manipulation
    'reshape', 'reshape_', 'flatten', 'squeeze', 'unsqueeze', 'transpose',
    't', 'moveaxis', 'swapaxes', 'split', 'chunk', 'unbind', 'tile', 'expand',
    'expand_as', 'broadcast_to', 'flip', 'roll', 'rot90', 'gather',
    'gather_nd', 'scatter', 'scatter_', 'scatter_nd_add', 'index_select',
    'index_sample', 'index_add', 'index_put', 'take_along_axis',
    'put_along_axis', 'repeat_interleave', 'pad', 'diagonal', 'kron', 'diff',
    'as_complex', 'as_real', 'slice', 'strided_slice', 'unfold',
    # linalg
    'matmul', 'mm', 'bmm', 'dot', 'mv', 'norm', 'dist', 'cross', 'histogram',
    'matrix_power', 'cholesky', 'inv',
    # search
    'argmax', 'argmin', 'topk', 'sort', 'argsort', 'where', 'nonzero',
    'masked_select', 'masked_fill', 'unique', 'unique_consecutive',
    'searchsorted', 'kthvalue', 'mode', 'isin',
]


def _attach_methods():
    missing = []
    for name in _METHOD_NAMES:
        for src in _METHOD_SOURCES:
            fn = getattr(src, name, None)
            if fn is not None:
                setattr(Tensor, name, fn)
                break
        else:
            missing.append(name)
    if missing:  # strict: a listed method that resolves nowhere is a bug
        raise ImportError(
            f'Tensor methods listed in _METHOD_NAMES are unresolved: '
            f'{missing}')

    # creation-style helpers as methods
    Tensor.zeros_like = lambda s, dtype=None: creation.zeros_like(s, dtype)
    Tensor.ones_like = lambda s, dtype=None: creation.ones_like(s, dtype)
    Tensor.fill_ = _fill_

    # python operators
    Tensor.__add__ = lambda s, o: math.add(s, o)
    Tensor.__radd__ = lambda s, o: math.add(o, s)
    Tensor.__sub__ = lambda s, o: math.subtract(s, o)
    Tensor.__rsub__ = lambda s, o: math.subtract(o, s)
    Tensor.__mul__ = lambda s, o: math.multiply(s, o)
    Tensor.__rmul__ = lambda s, o: math.multiply(o, s)
    Tensor.__truediv__ = lambda s, o: math.divide(s, o)
    Tensor.__rtruediv__ = lambda s, o: math.divide(o, s)
    Tensor.__floordiv__ = lambda s, o: math.floor_divide(s, o)
    Tensor.__rfloordiv__ = lambda s, o: math.floor_divide(o, s)
    Tensor.__mod__ = lambda s, o: math.mod(s, o)
    Tensor.__rmod__ = lambda s, o: math.mod(o, s)
    Tensor.__divmod__ = lambda s, o: (math.floor_divide(s, o),
                                      math.mod(s, o))
    Tensor.__rdivmod__ = lambda s, o: (math.floor_divide(o, s),
                                       math.mod(o, s))
    Tensor.__pos__ = lambda s: s
    Tensor.__lshift__ = lambda s, o: math.bitwise_left_shift(s, o)
    Tensor.__rlshift__ = lambda s, o: math.bitwise_left_shift(o, s)
    Tensor.__rshift__ = lambda s, o: math.bitwise_right_shift(s, o)
    Tensor.__rrshift__ = lambda s, o: math.bitwise_right_shift(o, s)
    Tensor.__pow__ = lambda s, o: math.pow(s, o)
    Tensor.__rpow__ = lambda s, o: math.pow(o, s)
    Tensor.__matmul__ = lambda s, o: linalg.matmul(s, o)
    Tensor.__rmatmul__ = lambda s, o: linalg.matmul(o, s)
    Tensor.__neg__ = lambda s: math.neg(s)
    Tensor.__abs__ = lambda s: math.abs(s)
    Tensor.__invert__ = lambda s: math.logical_not(s)
    Tensor.__eq__ = lambda s, o: math.equal(s, o)
    Tensor.__ne__ = lambda s, o: math.not_equal(s, o)
    Tensor.__lt__ = lambda s, o: math.less_than(s, o)
    Tensor.__le__ = lambda s, o: math.less_equal(s, o)
    Tensor.__gt__ = lambda s, o: math.greater_than(s, o)
    Tensor.__ge__ = lambda s, o: math.greater_equal(s, o)
    Tensor.__and__ = lambda s, o: math.logical_and(s, o)
    Tensor.__or__ = lambda s, o: math.logical_or(s, o)
    Tensor.__xor__ = lambda s, o: math.logical_xor(s, o)

    # in-place arithmetic (a functional rebind underneath)
    Tensor.add_ = lambda s, o: s._rebind(math.add(s, o))
    Tensor.subtract_ = lambda s, o: s._rebind(math.subtract(s, o))
    Tensor.multiply_ = lambda s, o: s._rebind(math.multiply(s, o))
    Tensor.divide_ = lambda s, o: s._rebind(math.divide(s, o))
    Tensor.scale_ = lambda s, *a, **k: s._rebind(math.scale(s, *a, **k))
    Tensor.clip_ = lambda s, *a, **k: s._rebind(math.clip(s, *a, **k))
    Tensor.exp_ = lambda s: s._rebind(math.exp(s))
    Tensor.sqrt_ = lambda s: s._rebind(math.sqrt(s))
    Tensor.zero_ = lambda s: _fill_(s, 0)
    Tensor.floor_ = lambda s: s._rebind(math.floor(s))
    Tensor.ceil_ = lambda s: s._rebind(math.ceil(s))
    Tensor.masked_fill_ = lambda s, m, v: s._rebind(
        search.masked_fill(s, m, v))
    Tensor.index_fill_ = lambda s, idx, axis, v: s._rebind(
        manipulation.index_fill(s, idx, axis, v))
    Tensor.uniform_ = _uniform_
    Tensor.normal_ = _normal_
    Tensor.exponential_ = _exponential_
    Tensor.element_size = lambda s: s.value.element_size()
    Tensor.set_value = _set_value

    Tensor.__iadd__ = lambda s, o: s._rebind(math.add(s, o))
    Tensor.__isub__ = lambda s, o: s._rebind(math.subtract(s, o))
    Tensor.__imul__ = lambda s, o: s._rebind(math.multiply(s, o))
    Tensor.__itruediv__ = lambda s, o: s._rebind(math.divide(s, o))

    # transpose property
    Tensor.T = property(lambda s: manipulation.t(s))


def _fresh(t, value):
    """Give `t` a new value outside the graph (a leaf keeps requiring
    grad and keeps its gradient, as `_rebind` does)."""
    return t._rebind(Tensor(value.detach()))


def _fill_(t, v):
    return _fresh(t, torch.full_like(t.value, v))


def _gen(t, seed):
    from .. import framework
    if seed:
        return torch.Generator(device=t.value.device).manual_seed(int(seed))
    return framework.default_generator(t.value.device)


def _uniform_(t, min=-1.0, max=1.0, seed=0):
    u = torch.rand(t.value.shape, dtype=t.dtype, device=t.value.device,
                   generator=_gen(t, seed))
    return _fresh(t, u * (max - min) + min)


def _normal_(t, mean=0.0, std=1.0, seed=0):
    n = torch.randn(t.value.shape, dtype=t.dtype, device=t.value.device,
                    generator=_gen(t, seed))
    return _fresh(t, mean + std * n)


def _exponential_(t, lam=1.0, seed=0):
    u = torch.rand(t.value.shape, dtype=t.dtype, device=t.value.device,
                   generator=_gen(t, seed))
    u = u.clamp(min=torch.finfo(t.dtype).tiny)
    return _fresh(t, -torch.log(u) / lam)


def _set_value(t, value):
    v = value.value if isinstance(value, Tensor) else torch.as_tensor(
        np.asarray(value))
    return _fresh(t, v.to(device=t.value.device, dtype=t.dtype)
                  .reshape(t.value.shape))


def broadcast_shape(x_shape, y_shape):
    """The broadcast shape of two shape lists (paddle.broadcast_shape)."""
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


_attach_methods()
