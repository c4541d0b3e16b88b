"""paddle.geometric: graph message-passing ops (counterpart of
`paddle_tpu/geometric.py`): the segment reductions and `send_u_recv` /
`send_ue_recv`, over `index_add` and `scatter_reduce`, each an op
through `tensor.apply_op`.

The JAX package's semantics are kept: an empty segment of
`segment_min` / `segment_max` holds the reduction's identity (+inf /
-inf for floats, the integer type's max / min), while `send_u_recv` and
`send_ue_recv` zero their empty buckets (upstream's rule: by value for
floats, by edge count for ints, where the JAX package keeps the
identity); without
`out_size` the segment count is the largest id + 1, read on the host,
and the message-passing ops keep at least x's rows.
"""
from __future__ import annotations

import torch

from .ops._helpers import defop
from .tensor import to_torch

__all__ = ['segment_sum', 'segment_mean', 'segment_min', 'segment_max',
           'send_u_recv', 'send_ue_recv']


def _num_segments(ids, out_size):
    if out_size is not None:
        return int(out_size)
    return int(to_torch(ids).max()) + 1


def _identity(dtype, op: str):
    """The identity of min / max in `dtype` (what an empty segment
    holds)."""
    if dtype.is_floating_point:
        return float('inf') if op == 'min' else float('-inf')
    info = torch.iinfo(dtype)
    return info.max if op == 'min' else info.min


def _reduce(d: torch.Tensor, ids: torch.Tensor, n: int,
            op: str) -> torch.Tensor:
    """Rows of `d` reduced into `n` buckets by `ids` ('sum', 'min' or
    'max'; empty min / max buckets hold the identity)."""
    shape = (n,) + tuple(d.shape[1:])
    ids = ids.long()
    if op == 'sum':
        return d.new_zeros(shape).index_add(0, ids, d)
    idx = ids.reshape((-1,) + (1,) * (d.dim() - 1)).expand_as(d)
    return torch.full(shape, _identity(d.dtype, op), dtype=d.dtype,
                      device=d.device).scatter_reduce(
        0, idx, d, 'amin' if op == 'min' else 'amax', include_self=True)


def _mean(d: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    tot = _reduce(d, ids, n, 'sum')
    cnt = _reduce(torch.ones(ids.shape[0], dtype=tot.dtype,
                             device=d.device), ids, n, 'sum')
    return tot / torch.clamp(cnt.reshape((n,) + (1,) * (d.dim() - 1)),
                             min=1)


def _segment(op_name):
    def f(data, segment_ids, out_size=None, name=None):
        n = _num_segments(segment_ids, out_size)
        return defop(lambda d, ids: _reduce(d, ids, n, op_name),
                     name=f'segment_{op_name}')(data, segment_ids)
    f.__name__ = f'segment_{op_name}'
    return f


segment_sum = _segment('sum')
segment_min = _segment('min')
segment_max = _segment('max')


def segment_mean(data, segment_ids, out_size=None, name=None):
    n = _num_segments(segment_ids, out_size)
    return defop(lambda d, ids: _mean(d, ids, n),
                 name='segment_mean')(data, segment_ids)


_REDUCERS = {'sum': 'sum', 'mean': 'mean', 'min': 'min', 'max': 'max'}


def _buckets(x, dst_index, out_size) -> int:
    if out_size is not None:
        return int(out_size)
    return max(_num_segments(dst_index, None), int(to_torch(x).shape[0]))


def _recv(msgs: torch.Tensor, dst: torch.Tensor, n: int, reduce_op: str):
    if reduce_op == 'mean':
        return _mean(msgs, dst, n)
    out = _reduce(msgs, dst, n, reduce_op)
    if reduce_op in ('min', 'max'):
        # empty buckets come back at the identity; upstream zeroes them.
        # Floats find them by value (the JAX rule, so an inf message is
        # zeroed too); ints by an edge count, since iinfo.max / iinfo.min
        # is also a value a live bucket can hold
        if out.is_floating_point():
            empty = torch.isinf(out)
        else:
            ones = torch.ones_like(dst, dtype=torch.int64)
            cnt = torch.zeros(n, dtype=torch.int64, device=out.device
                              ).index_add(0, dst.long(), ones)
            empty = (cnt == 0).reshape((n,) + (1,) * (out.dim() - 1))
        out = torch.where(empty, torch.zeros_like(out), out)
    return out


def send_u_recv(x, src_index, dst_index, reduce_op='sum', out_size=None,
                name=None):
    """Gather `x` rows at src_index, reduce them into dst_index buckets
    (upstream: paddle.geometric.send_u_recv)."""
    if reduce_op not in _REDUCERS:
        raise ValueError(f'unsupported reduce_op {reduce_op!r}')
    n = _buckets(x, dst_index, out_size)
    return defop(lambda xv, src, dst: _recv(xv[src.long()], dst, n,
                                            reduce_op),
                 name='send_u_recv')(x, src_index, dst_index)


_MESSAGE_OPS = {'add': torch.add, 'sub': torch.sub, 'mul': torch.mul,
                'div': torch.div}


def send_ue_recv(x, y, src_index, dst_index, message_op='add',
                 reduce_op='sum', out_size=None, name=None):
    """Message = x[src] (op) y[edge]; then reduce into dst buckets
    (upstream: paddle.geometric.send_ue_recv)."""
    if message_op not in _MESSAGE_OPS:
        raise ValueError(f'unsupported message_op {message_op!r}')
    if reduce_op not in _REDUCERS:
        raise ValueError(f'unsupported reduce_op {reduce_op!r}')
    n = _buckets(x, dst_index, out_size)
    return defop(lambda xv, yv, src, dst: _recv(
        _MESSAGE_OPS[message_op](xv[src.long()], yv), dst, n, reduce_op),
        name='send_ue_recv')(x, y, src_index, dst_index)
