"""Decode helpers shared by the model and the serving engine (counterpart
of `paddle_tpu/nlp/generation.py:55-181`).

The port keeps its KV in pages (`serving/kv_pool.py`): `update_kv_cache`
writes new K/V rows into their pages through a page table and
`gather_rows` reads a slot's rows back; `chunk_rows` builds a prompt
chunk's attention rows; `cached_forward` is the decode forward the
engine calls, `chunk_forward` the forward of one prompt chunk against
the rows already in a slot's pages.
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
                    offset, floor=None) -> None:
    """Write K/V rows into their pages, in place.

    k/v [B, S, HKV, D] are the rows at positions offset[b] + i of batch
    row b; pages are [num_pages, page_size, HKV, D]; table [B, P] maps a
    row's page index (position // page_size) to a page id. Positions past
    the table, and unreserved entries, land on the null page 0, which no
    attention reads unmasked. With `floor` (rows, scalar or [B]) a row
    whose page ends at or below it lands there too: the pages under a
    slot's attached prefix are shared and never rewritten."""
    b, s = k.shape[:2]
    ps = k_pages.shape[1]
    p = table.shape[1]
    off = as_offset(offset, k.device)
    pos = offset_grid(off, s).expand(b, s)
    idx = torch.div(pos, ps, rounding_mode='floor')
    page = torch.gather(table.long(), 1, idx.clamp(max=p - 1))
    keep = idx < p
    if floor is not None:
        fl = as_offset(floor, k.device)
        keep = keep & ((idx + 1) * ps > (fl[:, None] if fl.dim() else fl))
    page = torch.where(keep, page, 0)
    row = pos % ps
    k_pages[page, row] = k.to(k_pages.dtype)
    v_pages[page, row] = v.to(v_pages.dtype)


def gather_rows(pages: torch.Tensor, table_row: torch.Tensor,
                length=None) -> torch.Tensor:
    """Rows [0, length) of one slot as a contiguous [1, length, HKV, D]
    tensor, read from `pages` [num_pages, page_size, HKV, D] through the
    slot's page table row `table_row` [1, P]; with `length` None, every
    row the table maps, [1, P * page_size, HKV, D] (a fixed shape: no
    host value sizes it)."""
    ps, p = pages.shape[1], table_row.shape[1]
    n = p if length is None else -(-int(length) // ps)
    rows = pages[table_row[0, :n].long()]            # [n, ps, HKV, D]
    return rows.reshape(1, n * ps, *pages.shape[2:])[:, :length]


def chunk_rows(k_pages: torch.Tensor, v_pages: torch.Tensor,
               k: torch.Tensor, v: torch.Tensor, table: torch.Tensor,
               start: torch.Tensor, floor=None) -> tuple:
    """The attention rows of one prompt chunk (the JAX engine's
    `_paged_chunk_prefill_fn`, `paddle_tpu/serving/engine.py:763-790`),
    with no host value: the chunk's fresh K/V rows k/v [1, S, HKV, D] at
    positions start + i (`start` a 0-d device tensor) are written into
    the slot's pages through `table` [1, P] (rows whose page ends at or
    below `floor` go to the null page), and returned is the slot's whole
    table row gathered [1, P * page_size, HKV, D] with the fresh rows
    written over [start, start + S), even below the floor: the chunk
    attends its own rows, and rows [0, start) from the pages. Rows past
    start + S hold whatever the pages hold; the caller attends to the
    first start + S only (`flash_attention_fwd(seqused_k=)`).
    start + S <= P * page_size."""
    pos = offset_grid(start, k.shape[1])
    k_all = gather_rows(k_pages, table).index_copy_(1, pos, k)
    v_all = gather_rows(v_pages, table).index_copy_(1, pos, v)
    update_kv_cache(k_pages, v_pages, k, v, table, start, floor)
    return k_all, v_all


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


def chunk_forward(model):
    """The chunk-forward contract (the JAX engine's `cached_forward` with
    a slot-causal mask, `paddle_tpu/serving/engine.py:763-790`): returns
    ``fwd(ids [1, S], pages, start, table [1, P], floor) -> logits
    [1, S, V]``. The S tokens of one slot sit at positions start + i: each
    layer writes their K/V rows into the slot's pages (rows whose page
    ends at or below `floor` go to the null page instead) and attends
    through the causal flash kernel over the slot's rows [0, start) read
    from its pages followed by the chunk's own rows (`chunk_rows`), so
    token i sees the slot's rows <= start + i. `start` and `floor` are
    ints or 0-d tensors (on the model's device, the forward reads no
    host value). `pages` is updated in place."""
    def fwd(ids, pages, start, table, floor=0):
        return model(ids, position_offset=start, kv_pages=pages,
                     table=table, floor=floor)
    return fwd
