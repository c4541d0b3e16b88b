"""Search, sort and selection ops (counterpart of
`paddle_tpu/ops/search.py`). Sorts are stable, as the JAX package's;
the ops whose output size depends on the data (`nonzero` aside, which
torch computes on the device) run on the host as in the JAX package:
`unique`, `unique_consecutive` and `mode`."""
from __future__ import annotations

import numpy as np
import torch

from ..dtype import convert_dtype
from ..tensor import Tensor, apply_op, to_torch
from ._helpers import defop


def argmax(x, axis=None, keepdim=False, dtype='int64', name=None):
    def f(v):
        out = (torch.argmax(v.reshape(-1)) if axis is None
               else torch.argmax(v, dim=int(axis), keepdim=keepdim))
        return out.to(convert_dtype(dtype))
    return defop(f, name='argmax')(x)


def argmin(x, axis=None, keepdim=False, dtype='int64', name=None):
    def f(v):
        out = (torch.argmin(v.reshape(-1)) if axis is None
               else torch.argmin(v, dim=int(axis), keepdim=keepdim))
        return out.to(convert_dtype(dtype))
    return defop(f, name='argmin')(x)


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    def f(v, kk):
        kk = int(kk.item() if isinstance(kk, torch.Tensor) else kk)
        vals, idx = torch.topk(v, kk, dim=int(axis), largest=largest,
                               sorted=True)
        return vals, idx
    return defop(f, name='topk')(x, k)


def sort(x, axis=-1, descending=False, name=None):
    return defop(lambda v: torch.sort(v, dim=axis, descending=descending,
                                      stable=True).values, name='sort')(x)


def argsort(x, axis=-1, descending=False, name=None):
    return defop(lambda v: torch.argsort(v, dim=axis, descending=descending,
                                         stable=True), name='argsort')(x)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=False)

    def f(c, a, b):
        if not isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
            a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
        if not isinstance(b, torch.Tensor) and isinstance(a, torch.Tensor):
            b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
        return torch.where(c.bool(), a, b)
    return defop(f, name='where')(condition, x, y)


def nonzero(x, as_tuple=False):
    v = to_torch(x)
    if as_tuple:
        return tuple(Tensor(i) for i in torch.nonzero(v, as_tuple=True))
    return Tensor(torch.nonzero(v))


def masked_select(x, mask, name=None):
    return defop(lambda v, m: v[m.bool().broadcast_to(v.shape)],
                 name='masked_select')(x, mask)


def masked_fill(x, mask, value, name=None):
    def f(v, m, val):
        return torch.where(m.bool(), torch.as_tensor(val, dtype=v.dtype,
                                                     device=v.device), v)
    return defop(f, name='masked_fill')(x, mask, value)


def _device_tensor(a, like, dtype=None):
    return Tensor(torch.as_tensor(np.asarray(a), device=like.device,
                                  dtype=dtype))


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype='int64', name=None):
    v = to_torch(x)
    res = np.unique(Tensor(v).numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(res, tuple):
        return Tensor(torch.as_tensor(res, device=v.device, dtype=v.dtype))
    out = [Tensor(torch.as_tensor(res[0], device=v.device, dtype=v.dtype))]
    idx = convert_dtype(dtype)
    i = 1
    for flag in (return_index, return_inverse, return_counts):
        if flag:
            out.append(_device_tensor(res[i].reshape(-1), v, idx))
            i += 1
    return tuple(out)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, name=None):
    t = to_torch(x)
    v = Tensor(t).numpy()
    if axis is None:
        v = v.reshape(-1)
    keep = (np.concatenate([[True], v[1:] != v[:-1]]) if v.size
            else np.array([], bool))
    outs = [Tensor(torch.as_tensor(v[keep], device=t.device, dtype=t.dtype))]
    if return_inverse:
        outs.append(_device_tensor(np.cumsum(keep) - 1, t, torch.int64))
    if return_counts:
        pos = np.flatnonzero(keep)
        outs.append(_device_tensor(np.diff(np.append(pos, v.size)), t,
                                   torch.int64))
    return outs[0] if len(outs) == 1 else tuple(outs)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return defop(lambda s, v: torch.searchsorted(s, v, right=right,
                                                 out_int32=out_int32),
                 name='searchsorted')(sorted_sequence, values)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def f(v):
        vals, idx = torch.kthvalue(v, int(k), dim=int(axis), keepdim=keepdim)
        return vals, idx
    return defop(f, name='kthvalue')(x)


def mode(x, axis=-1, keepdim=False, name=None):
    t = to_torch(x)
    v = Tensor(t).numpy()
    ax = int(axis) % v.ndim

    def pick(a):
        vals, counts = np.unique(a, return_counts=True)
        m = vals[np.argmax(counts)]
        return m, np.max(np.nonzero(a == m)[0])
    out_v = np.apply_along_axis(lambda a: pick(a)[0], ax, v)
    out_i = np.apply_along_axis(lambda a: pick(a)[1], ax, v)
    if keepdim:
        out_v, out_i = np.expand_dims(out_v, ax), np.expand_dims(out_i, ax)
    return (Tensor(torch.as_tensor(out_v, device=t.device, dtype=t.dtype)),
            _device_tensor(out_i, t, torch.int64))


def is_empty(x):
    v = to_torch(x)
    return Tensor(torch.tensor(v.numel() == 0, device=v.device))


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return apply_op(lambda a, b: torch.isin(a, b, invert=invert), x, test_x,
                    _name='isin')


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    """paddle.bucketize: searchsorted with 1-D boundaries."""
    return searchsorted(sorted_sequence, x, out_int32=out_int32,
                        right=right, name=name)
