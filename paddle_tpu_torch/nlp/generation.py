"""Decode helpers shared by the model and the serving engine (counterpart
of `paddle_tpu/nlp/generation.py:55-181`).

The port keeps its KV in pages (`serving/kv_pool.py`): `update_kv_cache`
writes new K/V rows into their pages through a page table and
`gather_rows` reads a slot's rows back; `chunk_rows` builds a prompt
chunk's attention rows; `cached_forward` is the decode forward the
engine calls, `chunk_forward` the forward of one prompt chunk against
the rows already in a slot's pages.

With int8 pages (`kv_quant='int8'`) each helper also takes the pool's
per-(page, kv head) f32 scales: reads dequantize, and a write
requantizes every page it touches, whole, at the page's fresh absmax
scale (`write_pages`), as the JAX `scatter_pages` does. A layer's paged
KV is a `LayerKV`: the pages, their scales for int8, and in a decode
round the round's float window (`serving/decode_graph.py`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..quantization import (kv_dequantize_page, kv_page_scales,
                            kv_quantize_page)


class LayerKV(NamedTuple):
    """One layer's paged KV as the model takes it: k/v pages
    [num_pages, ps, HKV, D]; for int8 pages their f32 scales
    [num_pages, HKV]; in a decode round over int8 pages the round's
    float window k_win/v_win [N, W, ps, HKV, D], which holds the slot's
    logical pages win_first[n] .. win_first[n] + W - 1 in place of the
    int8 ones (`kernels.paged_attention`). A plain (k, v) pair is the
    unquantized case."""
    k: torch.Tensor
    v: torch.Tensor
    k_scales: Optional[torch.Tensor] = None
    v_scales: Optional[torch.Tensor] = None
    k_win: Optional[torch.Tensor] = None
    v_win: Optional[torch.Tensor] = None
    win_first: Optional[torch.Tensor] = None


def window_count(span: int, page_size: int) -> int:
    """Pages a span of `span` consecutive rows can touch at any alignment
    (the JAX `scatter_pages` window count, `kv_pool.py:372`)."""
    return (int(span) + page_size - 2) // page_size + 1


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
                    offset, floor=None, scales=None) -> None:
    """Write K/V rows into their pages, in place.

    k/v [B, S, HKV, D] are the rows at positions offset[b] + i of batch
    row b; pages are [num_pages, page_size, HKV, D]; table [B, P] maps a
    row's page index (position // page_size) to a page id. Positions past
    the table, and unreserved entries, land on the null page 0, which no
    attention reads unmasked. With `floor` (rows, scalar or [B]) a row
    whose page ends at or below it lands there too: the pages under a
    slot's attached prefix are shared and never rewritten.

    With `scales` (the int8 pool's (k_scales, v_scales)) each page the
    span touches is requantized whole from a slab that holds the rows and
    zeros in the rest of the page: the JAX whole prefill's zero slab
    (`paddle_tpu/serving/engine.py:743-761`)."""
    b, s = k.shape[:2]
    ps = k_pages.shape[1]
    p = table.shape[1]
    off = as_offset(offset, k.device)
    if scales is not None:
        nwin = window_count(s, ps)
        off = off.expand(b)
        first = torch.div(off, ps, rounding_mode='floor')
        idx = first[:, None] + torch.arange(nwin, device=k.device)
        keep = idx * ps < (off + s)[:, None]
        if floor is not None:
            keep = keep & ((idx + 1) * ps > as_offset(floor, k.device)
                           .expand(b)[:, None])
        rows = (off - first * ps)[:, None] + torch.arange(s, device=k.device)
        bi = torch.arange(b, device=k.device)[:, None]
        for pages, sc, x in ((k_pages, scales[0], k), (v_pages, scales[1], v)):
            slab = x.new_zeros((b, nwin * ps) + tuple(x.shape[2:]))
            slab[bi, rows] = x
            write_pages(pages, sc, slab.unflatten(1, (nwin, ps)), table,
                        first, keep)
        return
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


def write_pages(pages: torch.Tensor, scales: Optional[torch.Tensor],
                slab: torch.Tensor, table: torch.Tensor, first: torch.Tensor,
                keep: torch.Tensor) -> None:
    """Write whole pages, in place: slab [B, W, ps, HKV, D] holds the
    logical pages first[b] .. first[b] + W - 1 of batch row b (`table`
    [B, P]); window w goes to its page where keep[b, w], else (and past
    the table) to the null page 0, so a page is written once, from the
    window that names it. With `scales` (int8 pages) each written page
    is quantized at its fresh per-(page, kv head) absmax scale, which
    goes into `scales` [num_pages, HKV]. No host value is read."""
    p = table.shape[1]
    idx = first[:, None] + torch.arange(slab.shape[1], device=slab.device)
    pid = torch.gather(table.long(), 1, idx.clamp(max=p - 1))
    pid = torch.where(keep & (idx < p), pid, 0)
    if scales is None:
        pages[pid] = slab.to(pages.dtype)
        return
    sc = kv_page_scales(slab)
    pages[pid] = kv_quantize_page(slab, sc)
    scales[pid] = sc


def gather_rows(pages: torch.Tensor, table_row: torch.Tensor,
                length=None, scales=None, dtype=None) -> torch.Tensor:
    """Rows [0, length) of one slot as a contiguous [1, length, HKV, D]
    tensor, read from `pages` [num_pages, page_size, HKV, D] through the
    slot's page table row `table_row` [1, P]; with `length` None, every
    row the table maps, [1, P * page_size, HKV, D] (a fixed shape: no
    host value sizes it). With `scales` [num_pages, HKV] the int8 pages
    are dequantized into `dtype`."""
    ps, p = pages.shape[1], table_row.shape[1]
    n = p if length is None else -(-int(length) // ps)
    ids = table_row[0, :n].long()
    rows = pages[ids]                                # [n, ps, HKV, D]
    if scales is not None:
        rows = kv_dequantize_page(rows, scales[ids], dtype)
    return rows.reshape(1, n * ps, *pages.shape[2:])[:, :length]


def chunk_rows(k_pages: torch.Tensor, v_pages: torch.Tensor,
               k: torch.Tensor, v: torch.Tensor, table: torch.Tensor,
               start: torch.Tensor, floor=None, scales=None) -> tuple:
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
    start + S <= P * page_size.

    With `scales` (the int8 pool's (k_scales, v_scales)) the gather
    dequantizes into k's dtype, and each page [start, start + S) touches
    above the floor is requantized whole from the gathered row: its
    older rows, the fresh ones and the rows past start + S, as the JAX
    chunk's scatter does. The gather keeps its fixed shape."""
    s = k.shape[1]
    pos = offset_grid(start, s)
    ks, vs = (None, None) if scales is None else scales
    k_all = gather_rows(k_pages, table, scales=ks,
                        dtype=k.dtype).index_copy_(1, pos, k)
    v_all = gather_rows(v_pages, table, scales=vs,
                        dtype=v.dtype).index_copy_(1, pos, v)
    if scales is None:
        update_kv_cache(k_pages, v_pages, k, v, table, start, floor)
        return k_all, v_all
    ps, p = k_pages.shape[1], table.shape[1]
    first = torch.div(start, ps, rounding_mode='floor').reshape(1)
    idx = first[:, None] + torch.arange(window_count(s, ps),
                                        device=k.device)
    keep = (idx * ps < start + s) & ((idx + 1) * ps > start)
    if floor is not None:
        keep = keep & ((idx + 1) * ps > as_offset(floor, k.device))
    for pages, sc, rows in ((k_pages, ks, k_all), (v_pages, vs, v_all)):
        slab = rows.unflatten(1, (p, ps))[:, idx[0].clamp(max=p - 1)]
        write_pages(pages, sc, slab, table, first, keep)
    return k_all, v_all


def cached_forward(model):
    """The decode-forward contract: returns
    ``fwd(tok [N, S], pages, pos [N], table [N, P]) -> logits [N, S, V]``.
    Slot n's S tokens sit at positions pos[n] + i (S = 1: the pending
    token of a decode sub-step; S = k + 1: the pending token and k draft
    tokens of a speculative verify): their K/V are written into the
    slot's pages and token i attends to the rows [0, pos[n] + i] through
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
