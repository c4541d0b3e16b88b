"""Reduction ops (counterpart of `paddle_tpu/ops/reduction.py`).

Paddle semantics: `axis=None` reduces every dim, `keepdim=False` by
default, an axis may be a list. Integer sums and products keep their
dtype, as jnp's do (torch would widen int32 to int64); a bool sum is
int64, where the JAX package's is int32 only because x64 is off.
Medians and quantiles interpolate linearly, as jnp's.
"""
from __future__ import annotations

import builtins

import torch

from ..dtype import convert_dtype
from ._helpers import defop


def _dims(axis, v):
    """None, or a tuple of non-negative dims."""
    if axis is None:
        return None
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return tuple(sorted(int(a) % builtins.max(v.dim(), 1) for a in axes))


def _keep(out, v, dims, keepdim):
    """Put the reduced dims back as size 1 (dims None: all of them)."""
    if not keepdim:
        return out
    if dims is None:
        return out.reshape([1] * v.dim())
    for d in dims:
        out = out.unsqueeze(d)
    return out


def _int_dtype(v):
    """The accumulation dtype that keeps an integer input's dtype."""
    if v.dtype == torch.bool:
        return torch.int64
    if not (v.is_floating_point() or v.is_complex()):
        return v.dtype
    return None


def _red(fn, name, float_only=False):
    def f(x, axis=None, keepdim=False, dtype=None):
        if float_only and not (x.is_floating_point() or x.is_complex()):
            x = x.float()
        dims = _dims(axis, x)
        out = fn(x, dims)
        out = _keep(out, x, dims, keepdim)
        if dtype is not None:
            out = out.to(convert_dtype(dtype))
        return out
    return defop(f, name=name)


def _sum(v, dims):
    dt = _int_dtype(v)
    return torch.sum(v, dtype=dt) if dims is None else \
        torch.sum(v, dim=dims, dtype=dt)


def _prod(v, dims):
    dt = _int_dtype(v)
    if dims is None:
        return torch.prod(v, dtype=dt)
    for d in reversed(dims):
        v = torch.prod(v, dim=d, dtype=dt)
    return v


def _all_dims(fn):
    return lambda v, dims: fn(v) if dims is None else fn(v, dim=dims)


sum = _red(_sum, 'sum')
mean = _red(_all_dims(torch.mean), 'mean', float_only=True)
prod = _red(_prod, 'prod')
max = _red(_all_dims(torch.amax), 'max')
min = _red(_all_dims(torch.amin), 'min')
amax = max
amin = min
all = _red(lambda v, dims: torch.all(v) if dims is None
           else torch.all(v, dim=dims), 'all')
any = _red(lambda v, dims: torch.any(v) if dims is None
           else torch.any(v, dim=dims), 'any')
nansum = _red(lambda v, dims: torch.nansum(v) if dims is None
              else torch.nansum(v, dim=dims), 'nansum')
nanmean = _red(_all_dims(torch.nanmean), 'nanmean', float_only=True)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    def f(v):
        dims = _dims(axis, v)
        return torch.std(v, dim=dims, correction=1 if unbiased else 0,
                         keepdim=keepdim)
    return defop(f, name='std')(x)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    def f(v):
        dims = _dims(axis, v)
        return torch.var(v, dim=dims, correction=1 if unbiased else 0,
                         keepdim=keepdim)
    return defop(f, name='var')(x)


def _quantile(v, q, axis, keepdim, fn):
    """jnp.quantile's linear interpolation over `axis` (None, an int or
    a list) through torch.quantile / nanquantile, which take one dim."""
    if not v.is_floating_point():
        v = v.float()
    qt = torch.as_tensor(q, dtype=v.dtype, device=v.device)
    dims = _dims(axis, v)
    if dims is None:
        out = fn(v.reshape(-1), qt)
    else:
        rest = [d for d in range(v.dim()) if d not in dims]
        w = v.permute(*rest, *dims).reshape(
            *[v.shape[d] for d in rest], -1)
        out = fn(w, qt, dim=-1)
    if keepdim:
        lead = qt.dim()
        shape = list(out.shape[:lead]) + [
            1 if dims is None or d in dims else v.shape[d]
            for d in range(v.dim())]
        out = out.reshape(shape)
    return out


def median(x, axis=None, keepdim=False, name=None):
    return defop(lambda v: _quantile(v, 0.5, axis, keepdim, torch.quantile),
                 name='median')(x)


def quantile(x, q, axis=None, keepdim=False, name=None):
    return defop(lambda v: _quantile(v, q, axis, keepdim, torch.quantile),
                 name='quantile')(x)


def nanmedian(x, axis=None, keepdim=False, name=None):
    return defop(lambda v: _quantile(v, 0.5, axis, keepdim,
                                     torch.nanquantile), name='nanmedian')(x)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return defop(lambda v: _quantile(v, q, axis, keepdim, torch.nanquantile),
                 name='nanquantile')(x)


def logsumexp(x, axis=None, keepdim=False, name=None):
    def f(v):
        dims = _dims(axis, v)
        if dims is None:
            return _keep(torch.logsumexp(v.reshape(-1), 0), v, None, keepdim)
        return torch.logsumexp(v, dim=dims, keepdim=keepdim)
    return defop(f, name='logsumexp')(x)


def cumsum(x, axis=None, dtype=None, name=None):
    def f(v):
        if axis is None:
            v = v.reshape(-1)
        out = torch.cumsum(v, dim=0 if axis is None else int(axis),
                           dtype=_int_dtype(v))
        return out if dtype is None else out.to(convert_dtype(dtype))
    return defop(f, name='cumsum')(x)


def cumprod(x, dim=None, dtype=None, name=None):
    def f(v):
        if dim is None:
            v = v.reshape(-1)
        out = torch.cumprod(v, dim=0 if dim is None else int(dim),
                            dtype=_int_dtype(v))
        return out if dtype is None else out.to(convert_dtype(dtype))
    return defop(f, name='cumprod')(x)


def _cum_ext(fn, opname):
    def op(x, axis=None, dtype='int64', name=None):
        def f(v):
            vv = v.reshape(-1) if axis is None else v
            vals, inds = fn(vv, 0 if axis is None else int(axis))
            return vals, inds.to(convert_dtype(dtype))
        return defop(f, name=opname)(x)
    return op


cummax = _cum_ext(torch.cummax, 'cummax')
cummin = _cum_ext(torch.cummin, 'cummin')


def count_nonzero(x, axis=None, keepdim=False, name=None):
    def f(v):
        dims = _dims(axis, v)
        out = torch.count_nonzero(v, dim=dims)
        return _keep(out, v, dims, keepdim).to(torch.int64)
    return defop(f, name='count_nonzero')(x)
