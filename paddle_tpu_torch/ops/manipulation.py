"""Shape and layout ops (counterpart of `paddle_tpu/ops/manipulation.py`).

Paddle's semantics are kept: reshape's 0 copies the input's dim,
expand's -1 keeps it, `gather` takes rows along an axis, `split` takes a
count or sections with one -1. Index arguments may be int32 (Paddle's
habit); they are widened to int64 where torch needs it. Scatters are
functional (`index_put` without `_`), as the JAX package's `.at[]`.
"""
from __future__ import annotations

import builtins
import itertools

import numpy as np
import torch

from ..tensor import Tensor, to_torch
from ._helpers import defop


def _int(v):
    v = to_torch(v)
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def _norm_shape(shape, in_shape):
    return [in_shape[i] if s == 0 else s for i, s in enumerate(shape)]


def reshape(x, shape, name=None):
    if isinstance(shape, Tensor):
        shape = shape.value.tolist()
    shape = tuple(_int(s) for s in shape)
    return defop(lambda v: v.reshape(_norm_shape(shape, v.shape)),
                 name='reshape')(x)


def reshape_(x, shape, name=None):
    return x._rebind(reshape(x, shape))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def f(v):
        if v.dim() == 0:
            return v.reshape(-1)
        return torch.flatten(v, start_axis % v.dim(), stop_axis % v.dim())
    return defop(f, name='flatten')(x)


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return x._rebind(flatten(x, start_axis, stop_axis))


def squeeze(x, axis=None, name=None):
    def f(v):
        if axis is None:
            return torch.squeeze(v)
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        axes = tuple(a % v.dim() for a in axes if v.shape[a % v.dim()] == 1)
        return torch.squeeze(v, axes) if axes else v
    return defop(f, name='squeeze')(x)


def unsqueeze(x, axis, name=None):
    def f(v):
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        final = v.dim() + len(axes)
        for a in sorted(_int(a) % final for a in axes):
            v = v.unsqueeze(a)
        return v
    return defop(f, name='unsqueeze')(x)


def transpose(x, perm, name=None):
    return defop(lambda v: v.permute(*[int(p) for p in perm]),
                 name='transpose')(x)


def t(x, name=None):
    return defop(lambda v: v.permute(*reversed(range(v.dim())))
                 if v.dim() >= 2 else v, name='t')(x)


def moveaxis(x, source, destination, name=None):
    return defop(lambda v: torch.movedim(v, source, destination),
                 name='moveaxis')(x)


def swapaxes(x, axis1, axis2, name=None):
    return defop(lambda v: torch.swapaxes(v, axis1, axis2),
                 name='swapaxes')(x)


def concat(x, axis=0, name=None):
    ax = _int(axis)
    return defop(lambda vs: torch.cat(vs, dim=ax), name='concat')(list(x))


def stack(x, axis=0, name=None):
    return defop(lambda vs: torch.stack(vs, dim=axis), name='stack')(list(x))


def split(x, num_or_sections, axis=0, name=None):
    def f(v):
        ax = _int(axis) % v.dim()
        total = v.shape[ax]
        if isinstance(num_or_sections, int):
            if total % num_or_sections:
                raise ValueError(f'split: dim {ax} of size {total} does not '
                                 f'divide into {num_or_sections} parts')
            return torch.split(v, total // num_or_sections, dim=ax)
        secs = [_int(s) for s in num_or_sections]
        known = builtins.sum(s for s in secs if s != -1)
        secs = [s if s != -1 else total - known for s in secs]
        return torch.split(v, secs, dim=ax)
    return list(defop(f, name='split')(x))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    return list(defop(lambda v: torch.unbind(v, dim=axis), name='unbind')(x))


def tile(x, repeat_times, name=None):
    rt = [_int(r) for r in (repeat_times if isinstance(
        repeat_times, (list, tuple)) else [repeat_times])]
    return defop(lambda v: torch.tile(v, rt), name='tile')(x)


def expand(x, shape, name=None):
    def f(v):
        tgt = [_int(s) for s in shape]
        offset = len(tgt) - v.dim()
        out = [v.shape[i - offset] if s == -1 else s
               for i, s in enumerate(tgt)]
        return v.broadcast_to(out)
    return defop(f, name='expand')(x)


def expand_as(x, y, name=None):
    return defop(lambda v, w: v.broadcast_to(w.shape),
                 name='expand_as')(x, y)


def broadcast_to(x, shape, name=None):
    return defop(lambda v: v.broadcast_to([_int(s) for s in shape]),
                 name='broadcast_to')(x)


def broadcast_tensors(inputs, name=None):
    return list(defop(lambda vs: torch.broadcast_tensors(*vs),
                      name='broadcast_tensors')(list(inputs)))


def flip(x, axis, name=None):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return defop(lambda v: torch.flip(v, list(axes)), name='flip')(x)


def roll(x, shifts, axis=None, name=None):
    return defop(lambda v: torch.roll(v, shifts, dims=axis), name='roll')(x)


def rot90(x, k=1, axes=(0, 1), name=None):
    return defop(lambda v: torch.rot90(v, k, list(axes)), name='rot90')(x)


def gather(x, index, axis=0, name=None):
    ax = _int(axis)

    def f(v, i):
        if i.dim() == 0:
            return v.select(ax, int(i))
        return torch.index_select(v, ax, i.reshape(-1).long())
    return defop(f, name='gather')(x, index)


def gather_nd(x, index, name=None):
    return defop(lambda v, i: v[tuple(i.long().unbind(-1))],
                 name='gather_nd')(x, index)


def scatter(x, index, updates, overwrite=True, name=None):
    def f(v, i, u):
        i = (i.reshape(-1).long(),)
        u = u.to(v.dtype)
        if overwrite:
            return v.index_put(i, u)
        # Paddle's semantics: zero the target rows, then accumulate
        return v.index_put(i, torch.zeros_like(u)).index_put(
            i, u, accumulate=True)
    return defop(f, name='scatter')(x, index, updates)


def scatter_(x, index, updates, overwrite=True, name=None):
    return x._rebind(scatter(x, index, updates, overwrite))


def scatter_nd_add(x, index, updates, name=None):
    return defop(lambda v, i, u: v.index_put(
        tuple(i.long().unbind(-1)), u.to(v.dtype), accumulate=True),
        name='scatter_nd_add')(x, index, updates)


def scatter_nd(index, updates, shape, name=None):
    def f(i, u):
        base = torch.zeros([_int(s) for s in shape], dtype=u.dtype,
                           device=u.device)
        return base.index_put(tuple(i.long().unbind(-1)), u,
                              accumulate=True)
    return defop(f, name='scatter_nd')(index, updates)


def index_select(x, index, axis=0, name=None):
    return defop(lambda v, i: torch.index_select(v, int(axis), i.long()),
                 name='index_select')(x, index)


def index_sample(x, index, name=None):
    return defop(lambda v, i: torch.gather(v, 1, i.long()),
                 name='index_sample')(x, index)


def index_add(x, index, axis, value, name=None):
    return defop(lambda v, i, u: torch.index_add(v, int(axis), i.long(),
                                                 u.to(v.dtype)),
                 name='index_add')(x, index, value)


def index_put(x, indices, value, accumulate=False, name=None):
    return defop(lambda v, idx, u: v.index_put(
        tuple(i.long() if i.dtype != torch.bool else i for i in idx),
        u.to(v.dtype), accumulate=accumulate),
        name='index_put')(x, list(indices), value)


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    def f(v, i):
        i = i.long()
        if broadcast:
            tgt = list(v.shape)
            tgt[axis] = i.shape[axis]
            i = i.broadcast_to(tgt)
        return torch.gather(v, axis, i)
    return defop(f, name='take_along_axis')(arr, indices)


def put_along_axis(arr, indices, values, axis, reduce='assign', name=None):
    def f(v, i, u):
        i = i.long()
        u = torch.as_tensor(u, dtype=v.dtype, device=v.device) \
            .broadcast_to(i.shape)
        if reduce == 'assign':
            return torch.scatter(v, axis, i, u)
        if reduce == 'add':
            return torch.scatter_add(v, axis, i, u)
        if reduce in ('mul', 'multiply'):
            return torch.scatter_reduce(v, axis, i, u, 'prod')
        raise ValueError(f'unknown reduce {reduce!r}')
    return defop(f, name='put_along_axis')(arr, indices, values)


def repeat_interleave(x, repeats, axis=None, name=None):
    return defop(lambda v, r: torch.repeat_interleave(v, r, dim=axis),
                 name='repeat_interleave')(x, repeats)


_PAD_MODES = {'constant': 'constant', 'reflect': 'reflect',
              'replicate': 'replicate', 'circular': 'circular'}


def pad(x, pad, mode='constant', value=0.0, data_format='NCHW', name=None):
    def f(v, p):
        p = [int(q) for q in (p.tolist() if isinstance(p, torch.Tensor)
                              else p)]
        nd = v.dim()
        if len(p) == 2 * nd:
            width = [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
        else:
            # Paddle's layout: innermost dims first, [left, right, top,
            # bottom, ...]
            width = [(0, 0)] * nd
            if mode == 'constant' and len(p) == 4 and nd == 4 \
                    and data_format == 'NCHW':
                width[2], width[3] = (p[2], p[3]), (p[0], p[1])
            elif len(p) == 4 and nd == 4 and data_format == 'NHWC':
                width[1], width[2] = (p[2], p[3]), (p[0], p[1])
            else:
                for k in range(len(p) // 2):
                    width[nd - 1 - k] = (p[2 * k], p[2 * k + 1])
        first = next((d for d in range(nd) if width[d] != (0, 0)), nd)
        flat = [q for d in reversed(range(first, nd)) for q in width[d]]
        if mode == 'constant':
            return torch.nn.functional.pad(v, flat, value=float(value))
        return torch.nn.functional.pad(v, flat, mode=_PAD_MODES[mode])
    return defop(f, name='pad')(x, pad)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return defop(lambda v: torch.diagonal(v, offset, axis1, axis2),
                 name='diagonal')(x)


def kron(x, y, name=None):
    return defop(torch.kron, name='kron')(x, y)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return defop(lambda v, pre, app: torch.diff(v, n, axis, pre, app),
                 name='diff')(x, prepend, append)


def as_complex(x, name=None):
    return defop(lambda v: torch.complex(v[..., 0], v[..., 1]),
                 name='as_complex')(x)


def as_real(x, name=None):
    return defop(lambda v: torch.stack([v.real, v.imag], dim=-1),
                 name='as_real')(x)


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return x.astype(shape_or_dtype)


def _positions(n, start, stop, step):
    return list(range(n)[builtins.slice(start, stop, step)])


def slice(x, axes, starts, ends, name=None):
    def f(v):
        idx = [builtins.slice(None)] * v.dim()
        for ax, s, e in zip(axes, starts, ends):
            idx[int(ax)] = builtins.slice(_int(s), _int(e))
        return v[tuple(idx)]
    return defop(f, name='slice')(x)


def strided_slice(x, axes, starts, ends, strides, name=None):
    def f(v):
        for ax, s, e, st in zip(axes, starts, ends, strides):
            ax = int(ax)
            pos = _positions(v.shape[ax], _int(s), _int(e), _int(st))
            v = torch.index_select(v, ax, torch.tensor(pos, dtype=torch.long,
                                                       device=v.device))
        return v
    return defop(f, name='strided_slice')(x)


def crop(x, shape=None, offsets=None, name=None):
    def f(v):
        offs = [int(o) for o in (offsets or [0] * v.dim())]
        shp = [int(s) if int(s) != -1 else v.shape[i] - offs[i]
               for i, s in enumerate(shape or v.shape)]
        return v[tuple(builtins.slice(o, o + s) for o, s in zip(offs, shp))]
    return defop(f, name='crop')(x)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    def f(v):
        size = index_num // nshards
        lo = shard_id * size
        ok = (v >= lo) & (v < lo + size)
        return torch.where(ok, v - lo, torch.full_like(v, ignore_value))
    return defop(f, name='shard_index')(input)


def atleast_1d(*inputs, name=None):
    outs = [defop(torch.atleast_1d, name='atleast_1d')(x) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs, name=None):
    outs = [defop(torch.atleast_2d, name='atleast_2d')(x) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs, name=None):
    outs = [defop(torch.atleast_3d, name='atleast_3d')(x) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def hstack(x, name=None):
    return defop(torch.hstack, name='hstack')(builtins.list(x))


def vstack(x, name=None):
    return defop(torch.vstack, name='vstack')(builtins.list(x))


def row_stack(x, name=None):
    return vstack(x, name=name)


def dstack(x, name=None):
    return defop(torch.dstack, name='dstack')(builtins.list(x))


def column_stack(x, name=None):
    return defop(torch.column_stack, name='column_stack')(builtins.list(x))


def unfold(x, axis, size, step, name=None):
    """Sliding windows of length `size` with stride `step` along `axis`,
    the window dim appended last (torch.Tensor.unfold's semantics)."""
    return defop(lambda v: v.unfold(int(axis) % v.dim(), size, step),
                 name='unfold')(x)


def cartesian_prod(x, name=None):
    """The Cartesian product of 1-D tensors: [prod(len_i), len(x)]."""
    def f(vs):
        grids = torch.meshgrid(*vs, indexing='ij')
        return torch.stack([g.reshape(-1) for g in grids], dim=-1)
    return defop(f, name='cartesian_prod')(builtins.list(x))


def combinations(x, r=2, with_replacement=False, name=None):
    """The r-length combinations of a 1-D tensor's elements, in
    itertools' order: [n_combinations, r]."""
    def f(v):
        n = v.shape[0]
        it = (itertools.combinations_with_replacement(range(n), int(r))
              if with_replacement else itertools.combinations(range(n),
                                                              int(r)))
        idx = np.array(builtins.list(it), dtype=np.int64).reshape(-1, int(r))
        return v[torch.as_tensor(idx, device=v.device)]
    return defop(f, name='combinations')(x)


def block_diag(inputs, name=None):
    return defop(lambda vs: torch.block_diag(*[torch.atleast_2d(v)
                                               for v in vs]),
                 name='block_diag')(builtins.list(inputs))


def tensor_split(x, num_or_indices, axis=0, name=None):
    arg = (num_or_indices if isinstance(num_or_indices, int)
           else [int(a) for a in num_or_indices])
    return builtins.list(defop(lambda v: torch.tensor_split(v, arg,
                                                            dim=int(axis)),
                               name='tensor_split')(x))


def hsplit(x, num_or_indices, name=None):
    # numpy's semantics: a 1-D input splits along axis 0
    ax = 0 if to_torch(x).dim() == 1 else 1
    return tensor_split(x, num_or_indices, axis=ax, name=name)


def vsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=0, name=name)


def dsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=2, name=name)


def unflatten(x, axis, shape, name=None):
    return defop(lambda v: torch.unflatten(v, int(axis) % v.dim(),
                                           [int(s) for s in shape]),
                 name='unflatten')(x)


def view_as(x, other, name=None):
    return defop(lambda v, o: v.reshape(o.shape), name='view_as')(x, other)


def take(x, index, mode='raise', name=None):
    """Flat-index gather (paddle.take): negative indices wrap; 'clip'
    clamps out-of-range ones; 'wrap' takes them modulo the size."""
    def f(v, idx):
        flat = v.reshape(-1)
        n = flat.shape[0]
        idx = idx.long()
        if mode == 'wrap':
            idx = idx % n
        elif mode == 'clip':
            idx = idx.clamp(0, n - 1)
        else:
            idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
        return flat[idx]
    return defop(f, name='take')(x, index)


def select_scatter(x, values, axis, index, name=None):
    return defop(lambda v, val: torch.select_scatter(
        v, val.to(v.dtype), int(axis), int(index)),
        name='select_scatter')(x, values)


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    def f(v, val):
        idx = [builtins.slice(None)] * v.dim()
        for ax, st, en, sd in zip(axes, starts, ends, strides):
            idx[int(ax)] = builtins.slice(int(st), int(en), int(sd))
        out = v.clone()
        out[tuple(idx)] = val.to(v.dtype)
        return out
    return defop(f, name='slice_scatter')(x, value)


def masked_scatter(x, mask, value, name=None):
    """Fill the True positions of `mask` with consecutive elements of
    `value` (paddle.masked_scatter)."""
    return defop(lambda v, m, val: torch.masked_scatter(
        v, m.bool().broadcast_to(v.shape), val.to(v.dtype)),
        name='masked_scatter')(x, mask, value)


def index_fill(x, index, axis, value, name=None):
    return defop(lambda v, idx: torch.index_fill(v, int(axis), idx.long(),
                                                 value),
                 name='index_fill')(x, index)
