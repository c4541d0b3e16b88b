"""Creation ops (counterpart of `paddle_tpu/ops/creation.py`).

Every creator makes its tensor on the current place (`framework.
set_device`, `gpu:0` unless changed) as a leaf that stops the gradient;
an op that builds on an input (`zeros_like`, `one_hot`, `diag`, ...)
stays on the input's device. Random creators draw from the port's
generator of that device (`framework.default_generator`), seeded by
`paddle_tpu_torch.seed`: torch's Philox, not the JAX package's
threefry, so the same seed gives other numbers (ROADMAP.md, "RNG").
"""
from __future__ import annotations

import math as _math

import numpy as np
import torch

from .. import framework
from ..dtype import convert_dtype, int32 as INT32, int64 as INT64
from ..tensor import Parameter, Tensor, apply_op, to_torch
from ._helpers import defop


def _dt(dtype, default=None):
    d = convert_dtype(dtype)
    if d is None:
        d = default or framework.get_default_dtype()
    return d


def _shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.value.tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(to_torch(s)) if not isinstance(s, (int, np.integer))
                 else int(s) for s in shape)


def _dev(place=None) -> torch.device:
    if place is None:
        return framework.current_device()
    if isinstance(place, framework.Place):
        return place.torch_device()
    name, _, idx = str(place).partition(':')
    return (framework.CPUPlace(0) if name == 'cpu' else
            framework.CUDAPlace(int(idx or 0))).torch_device()


def _scalar(v):
    v = to_torch(v)
    return v.item() if isinstance(v, torch.Tensor) else v


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """A Tensor of `data` on `place` (default: the current place). With
    no dtype: a bool stays bool, a Python int is int32 (int64 past
    int32's range), a Python float and a float64 array take the default
    dtype, and anything else keeps its dtype."""
    dev = _dev(place)
    val = to_torch(data)
    if dtype is not None:
        dt = _dt(dtype)
        if isinstance(val, torch.Tensor):
            arr = val.detach().to(device=dev, dtype=dt)
        else:
            arr = torch.tensor(np.asarray(val), device=dev).to(dt)
    elif isinstance(val, torch.Tensor):
        arr = val.detach().to(dev)
    elif isinstance(val, (bool, np.bool_)):
        arr = torch.tensor(bool(val), device=dev)
    elif isinstance(val, (int, np.integer)):
        arr = torch.tensor(int(val), device=dev,
                           dtype=INT64 if abs(int(val)) > 2 ** 31 - 1
                           else INT32)
    elif isinstance(val, float):
        arr = torch.tensor(val, dtype=framework.get_default_dtype(),
                           device=dev)
    else:
        a = np.asarray(val)
        arr = torch.tensor(a, device=dev)
        if a.dtype == np.float64:
            arr = arr.to(framework.get_default_dtype())
    if arr is val:
        arr = arr.clone()
    return Tensor(arr, stop_gradient=stop_gradient)


def zeros(shape, dtype=None, name=None):
    return Tensor(torch.zeros(_shape(shape), dtype=_dt(dtype), device=_dev()))


def ones(shape, dtype=None, name=None):
    return Tensor(torch.ones(_shape(shape), dtype=_dt(dtype), device=_dev()))


def full(shape, fill_value, dtype=None, name=None):
    fv = _scalar(fill_value)
    if dtype is None and isinstance(fill_value, (bool, int)):
        return Tensor(torch.full(_shape(shape), fv, device=_dev()))
    return Tensor(torch.full(_shape(shape), fv, dtype=_dt(dtype),
                             device=_dev()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    return Tensor(torch.zeros_like(to_torch(x), dtype=convert_dtype(dtype)))


def ones_like(x, dtype=None, name=None):
    return Tensor(torch.ones_like(to_torch(x), dtype=convert_dtype(dtype)))


def full_like(x, fill_value, dtype=None, name=None):
    return Tensor(torch.full_like(to_torch(x), _scalar(fill_value),
                                  dtype=convert_dtype(dtype)))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = (framework.get_default_dtype()
                 if any(isinstance(v, float) for v in (start, end, step))
                 else INT64)
    return Tensor(torch.arange(start, end, step, dtype=_dt(dtype),
                               device=_dev()))


def linspace(start, stop, num, dtype=None, name=None):
    return Tensor(torch.linspace(_scalar(start), _scalar(stop),
                                 int(_scalar(num)), dtype=_dt(dtype),
                                 device=_dev()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return Tensor(torch.logspace(_scalar(start), _scalar(stop),
                                 int(_scalar(num)), base=base,
                                 dtype=_dt(dtype), device=_dev()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return Tensor(torch.eye(num_rows, num_columns or num_rows,
                            dtype=_dt(dtype), device=_dev()))


def diag(x, offset=0, padding_value=0, name=None):
    def f(v):
        out = torch.diag(v, offset)
        if v.dim() == 1 and padding_value != 0:
            mask = torch.ones_like(v, dtype=torch.bool).diag(offset)
            out = torch.where(mask, out, torch.full_like(
                out, _scalar(padding_value)))
        return out
    return defop(f, name='diag')(x)


def diagflat(x, offset=0, name=None):
    return defop(lambda v: torch.diagflat(v, offset), name='diagflat')(x)


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(apply_op(lambda *vs: torch.meshgrid(*vs, indexing='ij'),
                         *args, _name='meshgrid'))


def tril(x, diagonal=0, name=None):
    return defop(lambda v: torch.tril(v, diagonal), name='tril')(x)


def triu(x, diagonal=0, name=None):
    return defop(lambda v: torch.triu(v, diagonal), name='triu')(x)


def tril_indices(row, col, offset=0, dtype='int64'):
    r, c = np.tril_indices(row, offset, col)
    return Tensor(torch.tensor(np.stack([r, c]), dtype=_dt(dtype),
                               device=_dev()))


def triu_indices(row, col, offset=0, dtype='int64'):
    r, c = np.triu_indices(row, offset, col)
    return Tensor(torch.tensor(np.stack([r, c]), dtype=_dt(dtype),
                               device=_dev()))


def assign(x, output=None):
    v = to_torch(x)
    val = (v.detach().clone() if isinstance(v, torch.Tensor)
           else torch.tensor(np.asarray(v), device=_dev()))
    if output is not None:
        output._value = val
        return output
    return Tensor(val)


def clone(x):
    return x.clone() if isinstance(x, Tensor) else Tensor(
        torch.as_tensor(np.asarray(x), device=_dev()))


def numel(x):
    v = to_torch(x)
    return Tensor(torch.tensor(v.numel(), dtype=INT64, device=v.device))


def is_tensor(x):
    return isinstance(x, Tensor)


def shape(x):
    """The runtime shape as an int32 tensor (Paddle's paddle.shape)."""
    v = to_torch(x)
    return Tensor(torch.tensor(list(v.shape), dtype=INT32, device=v.device))


def rank(x):
    v = to_torch(x)
    return Tensor(torch.tensor(v.dim(), dtype=INT32, device=v.device))


# -- random creators -------------------------------------------------------

def _gen(dev, seed=0):
    if seed:
        return torch.Generator(device=dev).manual_seed(int(seed))
    return framework.default_generator(dev)


def rand(shape, dtype=None, name=None):
    dev = _dev()
    return Tensor(torch.rand(_shape(shape), dtype=_dt(dtype), device=dev,
                             generator=_gen(dev)))


def randn(shape, dtype=None, name=None):
    dev = _dev()
    return Tensor(torch.randn(_shape(shape), dtype=_dt(dtype), device=dev,
                              generator=_gen(dev)))


standard_normal = randn


def randint(low=0, high=None, shape=(1,), dtype='int64', name=None):
    if high is None:
        low, high = 0, low
    dev = _dev()
    return Tensor(torch.randint(int(low), int(high), _shape(shape),
                                dtype=_dt(dtype), device=dev,
                                generator=_gen(dev)))


def randperm(n, dtype='int64', name=None):
    dev = _dev()
    return Tensor(torch.randperm(int(n), dtype=_dt(dtype), device=dev,
                                 generator=_gen(dev)))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    m, s = to_torch(mean), to_torch(std)
    dev = next((t.device for t in (m, s) if isinstance(t, torch.Tensor)),
               None) or _dev()
    if shape is None:
        shape = torch.broadcast_shapes(
            *(tuple(t.shape) if isinstance(t, torch.Tensor) else ()
              for t in (m, s)))
    dt = framework.get_default_dtype()
    sample = torch.randn(_shape(shape) if shape else (), dtype=dt,
                         device=dev, generator=_gen(dev))
    return Tensor(sample * torch.as_tensor(s, dtype=dt, device=dev)
                  + torch.as_tensor(m, dtype=dt, device=dev))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = _dev()
    u = torch.rand(_shape(shape), dtype=_dt(dtype), device=dev,
                   generator=_gen(dev, seed))
    return Tensor(u * (max - min) + min)


def bernoulli(x, name=None):
    p = to_torch(x)
    return Tensor(torch.bernoulli(p.detach(), generator=_gen(p.device)))


def multinomial(x, num_samples=1, replacement=False, name=None):
    p = to_torch(x)
    return Tensor(torch.multinomial(p.detach(), int(num_samples),
                                    replacement=replacement,
                                    generator=_gen(p.device)))


def poisson(x, name=None):
    lam = to_torch(x)
    return Tensor(torch.poisson(lam.detach(), generator=_gen(lam.device)))


def standard_gamma(x, name=None):
    alpha = to_torch(x)
    return Tensor(torch._standard_gamma(alpha.detach(),
                                        generator=_gen(alpha.device)))


def one_hot(x, num_classes, name=None):
    """One-hot integer labels in the default float dtype (Paddle's
    paddle.nn.functional.one_hot)."""
    dt = framework.get_default_dtype()
    n = int(_scalar(num_classes))
    return defop(lambda v: torch.nn.functional.one_hot(v.long(), n).to(dt),
                 name='one_hot')(x)


def create_parameter(shape, dtype=None, default_initializer=None,
                     is_bias=False, attr=None, name=None):
    """A Parameter on the current place: from `default_initializer(shape,
    dtype)`, zeros for a bias, else Xavier-uniform (Paddle's default for
    weights)."""
    dt, shp, dev = _dt(dtype), _shape(shape), _dev()
    if default_initializer is not None:
        val = to_torch(default_initializer(shp, dt)).to(device=dev, dtype=dt)
    elif is_bias:
        val = torch.zeros(shp, dtype=dt, device=dev)
    else:
        fan_in = shp[0] if shp else 1
        fan_out = shp[-1] if shp else 1
        limit = _math.sqrt(6.0 / max(1, fan_in + fan_out))
        val = torch.rand(shp, dtype=dt, device=dev, generator=_gen(dev)) \
            * (2 * limit) - limit
    return Parameter(val.detach(), name=name or '')


def vander(x, n=None, increasing=False, name=None):
    return defop(lambda v: torch.linalg.vander(v, N=n).flip(-1)
                 if not increasing else torch.linalg.vander(v, N=n),
                 name='vander')(x)
