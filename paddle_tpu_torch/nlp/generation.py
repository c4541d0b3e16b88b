"""Decode helpers shared by the model and the serving engine (counterpart
of `paddle_tpu/nlp/generation.py:55-181`).

The port keeps its KV in pages (`serving/kv_pool.py`): `update_kv_cache`
writes new K/V rows into their pages through a page table, and
`cached_forward` is the one decode-forward contract the engine calls.
"""
from __future__ import annotations

import torch


def as_offset(position_offset, device) -> torch.Tensor:
    """A position offset (None / int / [B] sequence / tensor) as an int64
    tensor on `device`: a scalar, or [B] per-sequence offsets."""
    if position_offset is None:
        return torch.zeros((), dtype=torch.int64, device=device)
    return torch.as_tensor(position_offset, device=device).long()


def offset_grid(offset: torch.Tensor, s: int) -> torch.Tensor:
    """Positions of `s` consecutive tokens from `offset`: [S] for a scalar
    offset, [B, S] for per-sequence offsets."""
    ar = torch.arange(s, dtype=torch.int64, device=offset.device)
    if offset.dim() >= 1:
        return offset[:, None] + ar[None, :]
    return offset + ar


def decode_mask(q: torch.Tensor, k_cache: torch.Tensor,
                offset) -> torch.Tensor:
    """[1, 1, Sq, L] boolean slot-causal mask over a length-L cache: the
    query at slot offset + i sees key slots <= offset + i."""
    s, length = q.shape[1], k_cache.shape[1]
    q_pos = int(offset) + torch.arange(s, device=q.device)
    k_pos = torch.arange(length, device=q.device)
    return (k_pos[None, :] <= q_pos[:, None])[None, None]


def update_kv_cache(k_pages: torch.Tensor, v_pages: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, table: torch.Tensor,
                    offset) -> None:
    """Write K/V rows into their pages, in place.

    k/v [B, S, HKV, D] are the rows at positions offset[b] + i of batch
    row b; pages are [num_pages, page_size, HKV, D]; table [B, P] maps a
    row's page index (position // page_size) to a page id. Positions past
    the table, and unreserved entries, land on the null page 0, which no
    attention reads unmasked."""
    b, s = k.shape[:2]
    ps = k_pages.shape[1]
    p = table.shape[1]
    off = as_offset(offset, k.device)
    pos = offset_grid(off, s).expand(b, s)
    idx = torch.div(pos, ps, rounding_mode='floor')
    page = torch.gather(table.long(), 1, idx.clamp(max=p - 1))
    page = torch.where(idx < p, page, 0)
    row = pos % ps
    k_pages[page, row] = k.to(k_pages.dtype)
    v_pages[page, row] = v.to(v_pages.dtype)


def cached_forward(model):
    """The decode-forward contract: returns
    ``fwd(tok [N, 1], pages, pos [N], table [N, P]) -> logits [N, 1, V]``.
    Each slot's pending token sits at position pos[n]: its K/V are written
    into the slot's pages and it attends to the rows [0, pos[n]] through
    the paged-attention kernel. `pages` is the per-layer list of
    (k_pages, v_pages) and is updated in place."""
    def fwd(tok, pages, pos, table):
        return model(tok, position_offset=pos, kv_pages=pages, table=table)
    return fwd
