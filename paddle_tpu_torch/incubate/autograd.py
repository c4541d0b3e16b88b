"""paddle.incubate.autograd (counterpart of
`paddle_tpu/incubate/autograd.py`): functional forward and reverse
differentiation, `jvp`, `vjp`, `Jacobian` and `Hessian`, over
`torch.func` (the JAX package's are jax transforms). `func` takes and
returns Tensors (or torch tensors); it runs on torch values wrapped as
Tensors, as the JAX package runs it on its arrays."""
from __future__ import annotations

import torch

from ..tensor import Tensor, to_torch


def _functionalize(func):
    """A Tensor-level callable as a callable over torch values."""
    def raw(*vals):
        out = func(*[Tensor(v) for v in vals])
        if isinstance(out, (tuple, list)):
            return tuple(to_torch(o) for o in out)
        return to_torch(out)
    return raw


def _as_vals(xs):
    xs = xs if isinstance(xs, (tuple, list)) else (xs,)
    return tuple(torch.as_tensor(to_torch(x)) for x in xs)


def _wrap(o):
    return tuple(Tensor(t) for t in o) if isinstance(o, tuple) else Tensor(o)


def jvp(func, xs, v=None):
    """Forward mode: (func(xs), J v). v defaults to ones (upstream
    incubate.autograd.jvp)."""
    vals = _as_vals(xs)
    tangents = _as_vals(v) if v is not None else tuple(
        torch.ones_like(x) for x in vals)
    out, tang = torch.func.jvp(_functionalize(func), vals, tangents)
    return _wrap(out), _wrap(tang)


def vjp(func, xs, v=None):
    """Reverse mode: (func(xs), v^T J). v defaults to ones and must
    mirror the output structure for multi-output funcs (upstream
    incubate.autograd.vjp)."""
    vals = _as_vals(xs)
    out, pull = torch.func.vjp(_functionalize(func), *vals)
    if v is not None:
        cvals = _as_vals(v)
        if isinstance(out, tuple) and len(cvals) != len(out):
            raise ValueError(f'v has {len(cvals)} cotangents for '
                             f'{len(out)} outputs')
        cot = tuple(cvals) if isinstance(out, tuple) else cvals[0]
    else:
        cot = (tuple(torch.ones_like(o) for o in out)
               if isinstance(out, tuple) else torch.ones_like(out))
    gw = tuple(Tensor(g) for g in pull(cot))
    return _wrap(out), gw if len(gw) > 1 else gw[0]


class Jacobian:
    """Full Jacobian of func at xs (upstream incubate.autograd.Jacobian):
    index or slice it like an array; [:] gives the whole matrix. With
    several inputs each input's dims are flattened and the blocks joined
    along the last axis."""

    def __init__(self, func, xs, is_batched=False):
        vals = _as_vals(xs)
        argnums = tuple(range(len(vals)))
        jac_fn = torch.func.jacrev(_functionalize(func), argnums=argnums)
        jac = (torch.func.vmap(jac_fn) if is_batched else jac_fn)(*vals)
        if len(vals) == 1:
            self._jac = jac[0]
        else:
            out_ndim = jac[0].dim() - vals[0].dim()
            self._jac = torch.cat([j.reshape(j.shape[:out_ndim] + (-1,))
                                   for j in jac], dim=-1)

    def __getitem__(self, idx):
        return Tensor(self._jac[idx])

    @property
    def shape(self):
        return list(self._jac.shape)


class Hessian:
    """Hessian of a scalar func at xs (upstream
    incubate.autograd.Hessian); with several inputs the full block matrix
    over the flattened inputs."""

    def __init__(self, func, xs, is_batched=False):
        vals = _as_vals(xs)
        f = _functionalize(func)
        argnums = tuple(range(len(vals)))
        hes_fn = torch.func.hessian(lambda *a: f(*a).reshape(()),
                                    argnums=argnums)
        hes = (torch.func.vmap(hes_fn) if is_batched else hes_fn)(*vals)
        if len(vals) == 1:
            self._hes = hes[0][0]
        else:
            sizes = [v.numel() for v in vals]
            self._hes = torch.cat([torch.cat(
                [h.reshape(sizes[i], sizes[j]) for j, h in enumerate(row)],
                dim=1) for i, row in enumerate(hes)], dim=0)

    def __getitem__(self, idx):
        return Tensor(self._hes[idx])

    @property
    def shape(self):
        return list(self._hes.shape)
