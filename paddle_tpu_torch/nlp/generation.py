"""Decode helpers shared by the models, the serving engine and
`GenerationMixin` (counterpart of `paddle_tpu/nlp/generation.py`).

The port's serving engine keeps its KV in pages (`serving/kv_pool.py`):
`update_kv_cache` writes new K/V rows into their pages through a page
table and `gather_rows` reads a slot's rows back; `chunk_rows` builds a
prompt chunk's attention rows; `paged_attend` is the attention of a
model's paged decode and chunk forward (the same for every causal LM);
`cached_forward` is the decode forward the engine calls,
`chunk_forward` the forward of one prompt chunk against the rows
already in a slot's pages.

With int8 pages (`kv_quant='int8'`) each helper also takes the pool's
per-(page, kv head) f32 scales: reads dequantize, and a write
requantizes every page it touches, whole, at the page's fresh absmax
scale (`write_pages`), as the JAX `scatter_pages` does. A layer's paged
KV is a `LayerKV`: the pages, their scales for int8, and in a decode
round the round's float window (`serving/decode_graph.py`).

`GenerationMixin` gives every causal LM `generate()` (greedy, sampling
with temperature / top_k / top_p, beam search) and
`speculative_generate()` over a static dense KV cache, as the JAX
package's (`paddle_tpu/nlp/generation.py:55-675`): the cache is
`model.init_cache(batch, prompt + max_new_tokens)`, each step writes its
rows at its slot (`update_static_cache`, in place) and attends through
the slot-causal `decode_mask` (or `padded_decode_mask` for a padded
batch). A masked step takes the plain attention, as the JAX package
sends masked attention to XLA. The JAX decode is one compiled
`while_loop`; here it is a Python loop that stops early once every
sequence has emitted EOS (which reads one flag a step on the host).
Sampling draws from a `torch.Generator` seeded by `seed` (else the
framework's): Philox draws, so sampled tokens are the JAX package's
only in distribution; greedy and beam tokens are the same.

`Seq2SeqGenerationMixin` gives an encoder-decoder (T5) the same
`generate()` and `speculative_generate()`
(`paddle_tpu/nlp/generation.py:675-1100`): the encoder and each decoder
layer's cross K/V run once per call, then single-token decoder steps
over the static self-attention cache, reusing `_next_token`,
`process_logits` and `update_static_cache`. Both mixins run the same
loops (`_sample_loop`, `_beam_loop`, `_speculate`), each over the
one-step forward the mixin supplies.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import NamedTuple, Optional

import numpy as np
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


def round_kv(x: torch.Tensor, dtype) -> torch.Tensor:
    """`x` rounded through `dtype` (a KV pool's, or its compute dtype)
    and back, or `x` itself when `dtype` is None or x's own: the values a
    forward that writes its rows into such a pool, then attends them, as
    the JAX forward does, reads back. Every bf16 and fp16 value is exact
    in f32, so through a wider dtype this changes nothing."""
    if dtype is None or dtype == x.dtype:
        return x
    return x.to(dtype).to(x.dtype)


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
    query at slot offset + i sees key slots <= offset + i (`offset` an
    int or a 0-d tensor)."""
    s, length = q.shape[1], k_cache.shape[1]
    q_pos = as_offset(offset, q.device) + torch.arange(s, device=q.device)
    k_pos = torch.arange(length, device=q.device)
    return (k_pos[None, :] <= q_pos[:, None])[None, None]


def padded_decode_mask(keep: torch.Tensor, cache_len: int, cache_offset,
                       sq: int) -> torch.Tensor:
    """[B, 1, Sq, L] boolean mask for decode over a static cache holding a
    left- or right-padded prompt: slot-causal and the key slot not a pad
    slot. `keep` [B, S_prompt] (True: a real token); generated slots are
    always kept, and a query always sees its own slot, so a row of pads
    never softmaxes over nothing."""
    b, s_prompt = keep.shape
    dev = keep.device
    k_slot = torch.arange(cache_len, device=dev)
    q_slot = as_offset(cache_offset, dev) + torch.arange(sq, device=dev)
    causal = k_slot[None, :] <= q_slot[:, None]                 # [Sq, L]
    keep_full = torch.cat([keep.bool(), torch.ones(
        (b, cache_len - s_prompt), dtype=torch.bool, device=dev)], dim=1)
    self_ok = k_slot[None, :] == q_slot[:, None]
    return (causal[None] & (keep_full[:, None, :] | self_ok[None]))[:, None]


def pad_mask(attention_mask) -> Optional[torch.Tensor]:
    """A model's `attention_mask`: None, a [B, S] pad mask (turned into a
    boolean [B, 1, 1, S], as the JAX models do), or a mask already
    broadcastable over [B, H, Sq, Sk]."""
    if attention_mask is None or attention_mask.dim() != 2:
        return attention_mask
    return (attention_mask > 0)[:, None, None, :]


def update_static_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                        k: torch.Tensor, v: torch.Tensor, slot) -> tuple:
    """Write K/V rows [B, S, HKV, D] into a static dense cache [B, L, HKV,
    D] at slots slot + i (`slot` an int, a 0-d tensor, or [B] per-row
    slots), in place; returns (k_cache, v_cache). The JAX package's
    `update_kv_cache` (`paddle_tpu/nlp/generation.py:75-94`) over the
    static cache; the paged pool's writer is `update_kv_cache` here."""
    b, s = k.shape[:2]
    pos = offset_grid(as_offset(slot, k.device), s).expand(b, s)
    rows = torch.arange(b, device=k.device)[:, None]
    k_cache[rows, pos] = k.to(k_cache.dtype)
    v_cache[rows, pos] = v.to(v_cache.dtype)
    return k_cache, v_cache


def attend_static(q, k, v, cache, offset, cache_offset=None,
                  attn_mask=None) -> tuple:
    """The attention of a static-cache forward (`GenerationMixin`): this
    call's rows k/v written into the layer's `cache` at slot
    `cache_offset` (default: the position `offset`), then q attends over
    the whole cache under `attn_mask` or the slot-causal `decode_mask`,
    through the plain attention (a masked call). Returns (out [B, S, H,
    D], (k_cache, v_cache))."""
    from ..nn import functional as F
    slot = offset if cache_offset is None else as_offset(cache_offset,
                                                         q.device)
    k_cache, v_cache = update_static_cache(cache[0], cache[1], k, v, slot)
    mask = attn_mask if attn_mask is not None else decode_mask(q, k_cache,
                                                               slot)
    out = F.scaled_dot_product_attention(q, k_cache, v_cache, attn_mask=mask)
    return out, (k_cache, v_cache)


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
               start: torch.Tensor, floor=None, scales=None,
               dtype=None) -> tuple:
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
    dequantizes into `dtype`, the pool's compute dtype (default k's),
    and each page [start, start + S) touches above the floor is
    requantized whole from the gathered row: its older rows, the fresh
    ones and the rows past start + S, as the JAX chunk's scatter does.
    The gather keeps its fixed shape. The row is built in the pool's
    (compute) dtype, as the JAX chunk's gathered row is, and returned in
    k's: a pool in another dtype than the model's rounds the fresh rows
    through it, and a float gather is cast to q's dtype (exact whichever
    side is wider)."""
    s = k.shape[1]
    pos = offset_grid(start, s)
    ks, vs = (None, None) if scales is None else scales
    dt = k_pages.dtype if scales is None else (dtype or k.dtype)
    k_all = gather_rows(k_pages, table, scales=ks,
                        dtype=dt).index_copy_(1, pos, k.to(dt))
    v_all = gather_rows(v_pages, table, scales=vs,
                        dtype=dt).index_copy_(1, pos, v.to(dt))
    if scales is None:
        update_kv_cache(k_pages, v_pages, k, v, table, start, floor)
        return k_all.to(k.dtype), v_all.to(v.dtype)
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
    return k_all.to(k.dtype), v_all.to(v.dtype)


def paged_attend(q, k, v, kv_pages, table, offset, floor=None,
                 kv_dtype=None):
    """The attention of a paged forward, for any causal LM: q [B, S, H, D]
    and this call's new rows k/v [B, S, HKV, D] (after any position
    embedding); `kv_pages` one layer's `LayerKV` (or (k, v) pages);
    `offset` a [N] tensor (decode: slot n's S tokens at positions
    offset[n] + i, written into its pages, token i attending through the
    paged kernel to positions [0, offset[n] + i]) or a 0-d tensor
    `start` (one slot's prompt chunk at [start, start + S): its rows
    written into the pages, below `floor` to the null page, and attended
    causally with the slot's earlier rows through the flash kernel over
    the whole gathered row, its key count start + S read on the device).
    Returns [B, S, H, D]. A chunk with head_dim < 64 takes the plain
    attention, as the JAX package sends it to XLA. `kv_dtype`: an int8
    pool's compute dtype (its chunk's gather and fresh rows, `chunk_rows`);
    float pages are read in their own dtype, and a decode reads the
    round's window in the dtype it was made in.

    The pool may hold another float dtype than the model's (the engine's
    `dtype`): the decode reads the pages as they are, through the paged
    kernel's pair for (q's dtype, the pages'), and returns q's dtype."""
    from ..ops import kernels
    b, s = q.shape[:2]
    kv = LayerKV(*kv_pages)
    scales = None if kv.k_scales is None else (kv.k_scales, kv.v_scales)
    if offset.dim() == 0:
        if b != 1:
            raise ValueError('a paged chunk forward takes one slot')
        k_all, v_all = chunk_rows(kv.k, kv.v, k, v, table, offset, floor,
                                  scales, kv_dtype)
        used = (offset + s).to(torch.int32).reshape(1)
        if kernels.flash_head_dim_ok(q.shape[-1]):
            return kernels.flash_attention_fwd(q, k_all, v_all, causal=True,
                                               seqused_k=used)
        return kernels.attention_reference(q, k_all, v_all, causal=True,
                                           seqused_k=used)
    if offset.dim() != 1:
        raise ValueError('the paged decode forward takes a [N] position '
                         'offset')
    # token i of slot n sees the keys below offset[n] + 1 + i; one token
    # per slot passes the kernel a 3-D query, several a 4-D (contiguous:
    # a fused projection's q is a strided view)
    lengths = (offset + 1).to(torch.int32)
    qs = (q[:, 0] if s == 1 else q).contiguous()
    if scales is None:
        update_kv_cache(kv.k, kv.v, k, v, table, offset)
        out = kernels.paged_attention(qs, kv.k, kv.v, table, lengths)
    else:
        if kv.k_win is None:
            raise ValueError('a decode forward over int8 pages writes into '
                             'the round\'s float window '
                             '(serving/decode_graph.py)')
        # the new rows go into the window, never into an int8 page: the
        # round's end requantizes the touched pages
        ps = kv.k.shape[1]
        n = torch.arange(b, device=offset.device)[:, None]
        at = offset_grid(offset, s)                              # [N, S]
        w = torch.div(at, ps, rounding_mode='floor') - kv.win_first[:, None]
        kv.k_win[n, w, at % ps] = k.to(kv.k_win.dtype)
        kv.v_win[n, w, at % ps] = v.to(kv.v_win.dtype)
        out = kernels.paged_attention(
            qs, kv.k, kv.v, table, lengths, k_scales=kv.k_scales,
            v_scales=kv.v_scales, k_win=kv.k_win, v_win=kv.v_win,
            win_first=kv.win_first)
    return out[:, None] if s == 1 else out


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


# ---------------------------------------------------------------------------
# GenerationMixin: generate() and speculative_generate() over a static cache
# ---------------------------------------------------------------------------

NEG_INF = torch.finfo(torch.float32).min

# warn-once latch for the prompt-already-at-max_length case (tests reset it)
_warned_max_length = [False]


def _record_spec_stats(rounds: int, emitted: int, accepted: int,
                       proposed: int, source: str = 'generate') -> None:
    """Speculative-decode stats into the shared registry (`paddle_spec_*`,
    labeled by source), as the JAX package's."""
    from .. import observability as _obs
    if not _obs.enabled():
        return
    reg = _obs.get_registry()
    for name, doc, n in (
            ('paddle_spec_rounds_total', 'speculative-decode rounds by '
             'source', rounds),
            ('paddle_spec_emitted_tokens_total', 'tokens emitted by '
             'speculative decode by source', emitted),
            ('paddle_spec_proposed_drafts_total', 'draft tokens proposed by '
             'source', proposed),
            ('paddle_spec_accepted_drafts_total', 'draft tokens accepted by '
             'source', accepted)):
        reg.counter(name, doc, ('source',)).labels(source=source).inc(n)


def process_logits(logits: torch.Tensor, temperature: float, top_k: int,
                   top_p: float) -> torch.Tensor:
    """Filter [B, V] logits for sampling (fp32): temperature, then top_k,
    then top_p (the smallest head whose mass reaches top_p; top-1 always
    kept), filtered entries at the fp32 minimum."""
    logits = logits.float()
    if temperature != 1.0:
        logits = logits / max(temperature, 1e-6)
    v = logits.shape[-1]
    if top_k and 0 < top_k < v:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, NEG_INF)
    if top_p and top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff_idx = ((cum - probs) < top_p).sum(dim=-1) - 1
        cutoff = srt.gather(-1, cutoff_idx[:, None])
        logits = logits.masked_fill(logits < cutoff, NEG_INF)
    return logits


def _next_token(logits, generator, strategy, temperature, top_k, top_p):
    """(the next token [B], its log-prob under the raw distribution)."""
    if strategy == 'greedy_search':
        tok = logits.argmax(dim=-1)
    else:
        probs = torch.softmax(process_logits(logits, temperature, top_k,
                                             top_p), dim=-1)
        tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
    logp = torch.log_softmax(logits.float(), dim=-1)
    return tok, logp.gather(-1, tok[:, None])[:, 0]


def _as_ids(x, device) -> torch.Tensor:
    from ..tensor import to_torch
    t = to_torch(x)
    t = torch.as_tensor(np.asarray(t) if not isinstance(t, torch.Tensor)
                        else t, device=device)
    return t[None] if t.dim() == 1 else t


def _sampling_generator(strategy: str, seed, device):
    """The generator a sampling decode draws from: seeded by `seed`, else
    the framework's of `device`; None for greedy."""
    if strategy != 'sampling':
        return None
    if seed is not None:
        return torch.Generator(device=device).manual_seed(int(seed))
    from ..framework import default_generator
    return default_generator(device)


@contextlib.contextmanager
def _evaluating(*models):
    """Each model in eval mode for the block, its training mode restored
    after."""
    was = [m.training for m in models]
    for m in models:
        m.eval()
    try:
        yield
    finally:
        for m, w in zip(models, was):
            if w:
                m.train()


def _sample_loop(logits, step, pick, max_new_tokens, eos_token_id,
                 pad_token_id):
    """The greedy/sampling decode shared by both mixins, from the first
    position's logits [B, V]: `pick(logits, i) -> (token [B], log-prob
    [B])` chooses emitted token i, `step(tok [B], i) -> logits [B, V]`
    feeds it back. A finished row emits pad; the loop stops once every
    row has emitted EOS. Returns (ids [B, max_new_tokens], summed
    log-probs [B] fp32)."""
    b = logits.shape[0]
    dev = logits.device
    nxt, nxt_logp = pick(logits, 0)
    out = torch.full((b, max_new_tokens), pad_token_id, dtype=torch.int64,
                     device=dev)
    scores = torch.zeros((b,), dtype=torch.float32, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    for i in range(max_new_tokens):
        if bool(finished.all()):
            break
        tok = torch.where(finished, pad_token_id, nxt)
        out[:, i] = tok
        scores = scores + torch.where(finished, 0.0, nxt_logp)
        finished = finished | (tok == eos_token_id)
        if i + 1 == max_new_tokens:
            break
        nxt, nxt_logp = pick(step(tok, i), i + 1)
    return out, scores


def _beam_loop(logits, step, reorder, k, max_new_tokens, eos_token_id,
               pad_token_id, length_penalty):
    """Beam search shared by both mixins, from the first position's
    logits [B, V]: the K beams of the B rows decode as one [B * K] batch.
    `step(tok [B * K], i) -> logits [B * K, V]` feeds emitted token i;
    `reorder(src [B * K])` gathers the caller's caches to the surviving
    beams' rows after each step. Returns (the best beam's ids [B,
    max_new_tokens], its length-normalized score [B])."""
    logp0 = torch.log_softmax(logits.float(), dim=-1)          # [B, V]
    b, v = logp0.shape
    dev = logp0.device
    scores, tok = torch.topk(logp0, k, dim=-1)                 # [B, K]
    out = torch.full((b, k, max_new_tokens), pad_token_id,
                     dtype=torch.int64, device=dev)
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    lengths = torch.zeros((b, k), dtype=torch.int64, device=dev)
    pad_only = torch.full((v,), -1e9, device=dev)
    pad_only[pad_token_id] = 0.0
    for i in range(max_new_tokens):
        if bool(finished.all()):
            break
        tok = torch.where(finished, pad_token_id, tok)
        out[:, :, i] = tok
        lengths = lengths + (~finished).long()
        finished = finished | (tok == eos_token_id)
        logp = torch.log_softmax(step(tok.reshape(b * k), i).float(), dim=-1)
        # a finished beam has one candidate: its frozen score with pad
        logp = torch.where(finished[:, :, None], pad_only,
                           logp.reshape(b, k, v))
        cand = scores[:, :, None] + logp
        scores, flat = torch.topk(cand.reshape(b, k * v), k, dim=-1)
        src = torch.div(flat, v, rounding_mode='floor')        # [B, K]
        tok = flat % v
        out = out.gather(1, src[:, :, None].expand(-1, -1, max_new_tokens))
        finished = finished.gather(1, src)
        lengths = lengths.gather(1, src)
        reorder((torch.arange(b, device=dev)[:, None] * k + src).reshape(-1))
    norm = lengths.clamp(min=1).float() ** length_penalty
    best = (scores / norm).argmax(dim=1)
    best_out = out.gather(1, best[:, None, None].expand(
        -1, 1, max_new_tokens))[:, 0]
    return best_out, (scores / norm).gather(1, best[:, None])[:, 0]


def _speculate(first, draft_next, target_choices, base, k, max_new_tokens,
               eos_token_id, pad_token_id):
    """The speculative accept loop shared by both mixins (batch 1), from
    the target's first greedy token: each round the draft proposes k
    tokens (`draft_next(token, slot) -> its next greedy token`), the
    target scores the pending token and the drafts in one forward
    (`target_choices(tokens, slot) -> its greedy token after each`) and
    keeps the longest agreeing prefix plus its own next token. The
    pending token after e emitted ones sits at slot `base + e`. Returns
    (ids, a list of max_new_tokens with pad after the first EOS, stats
    with `rounds`, `emitted`, `target_forwards_saved` and
    `acceptance_rate`)."""
    v = first                                  # the pending token
    out = [v]
    rounds = 0
    e = 1
    while e < max_new_tokens and v != eos_token_id:
        p = base + e                           # the slot of `v`
        drafts, cur = [], v
        for j in range(k):
            cur = draft_next(cur, p + j)
            drafts.append(cur)
        choice = target_choices([v] + drafts, p)
        a = 0
        while a < k and drafts[a] == choice[a] \
                and drafts[a] != eos_token_id:
            a += 1
        v = choice[a]
        out.extend(drafts[:a] + [v])
        e += a + 1
        rounds += 1
    out = out[:max_new_tokens]
    out += [pad_token_id] * (max_new_tokens - len(out))
    if eos_token_id >= 0 and eos_token_id in out:
        first_eos = out.index(eos_token_id)
        out = out[:first_eos + 1] + [pad_token_id] * (len(out)
                                                      - first_eos - 1)
    rounds_i = max(rounds, 1)
    emitted_i = min(e, max_new_tokens)
    # e stays unclamped: a final round's overshoot drafts still count as
    # accepted, as in the JAX package
    accepted = max(e - 1 - rounds_i, 0)
    _record_spec_stats(rounds_i, emitted_i, accepted, rounds_i * k)
    return out, {'rounds': rounds_i, 'emitted': emitted_i,
                 'target_forwards_saved': accepted,
                 'acceptance_rate': accepted / (rounds_i * k)}


def _spec_args(model, ids, num_draft_tokens, eos_token_id, pad_token_id):
    """(k, eos, pad) of a speculative call, checked: batch 1, k >= 1;
    eos and pad default to the model config's."""
    if ids.shape[0] != 1:
        raise ValueError('speculative_generate is a latency '
                         'optimization for a single stream; batch '
                         f'size must be 1, got {ids.shape[0]}')
    cfg = getattr(model, 'config', None)
    if eos_token_id is None:
        eos_token_id = getattr(cfg, 'eos_token_id', -1)
    if pad_token_id is None:
        pad_token_id = getattr(cfg, 'pad_token_id', 0)
    k = int(num_draft_tokens)
    if k < 1:
        raise ValueError('num_draft_tokens must be >= 1')
    return k, int(eos_token_id), int(pad_token_id)


class GenerationMixin:
    """Mixed into the causal LMs (`GPTForCausalLM`, `LlamaForCausalLM`).
    The host provides `init_cache(batch, length)` and a forward taking
    (`position_offset`, `cache`, `cache_offset`, `attention_mask`,
    `use_cache=True`) that returns (logits, caches); `device` and
    `config` (its `eos_token_id`, `pad_token_id`, `vocab_size`,
    `max_position_embeddings`)."""

    def _step(self, tok, cache, pos, slot, mask):
        return self(tok, position_offset=pos, cache=cache, cache_offset=slot,
                    attention_mask=mask, use_cache=True)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 20,
                 max_length: Optional[int] = None,
                 decode_strategy: str = 'greedy_search',
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, num_beams: int = 1,
                 length_penalty: float = 0.0,
                 repetition_penalty: float = 1.0, min_new_tokens: int = 0,
                 min_length: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 pad_token_id: Optional[int] = None, use_cache: bool = True,
                 seed: Optional[int] = None, attention_mask=None, **kwargs):
        """Returns (generated ids [B, max_new_tokens] int64, per-sequence
        score [B] fp32: the summed log-probs of the emitted tokens, or
        for beam search the length-normalized beam score). Tokens after
        EOS are `pad_token_id`. The JAX package's semantics
        (`paddle_tpu/nlp/generation.py:416-510`), including the padded
        prompt (`attention_mask` [B, S]: per-sequence position origins),
        the repetition penalty, `min_new_tokens` and `max_length`."""
        from ..tensor import Tensor
        if decode_strategy not in ('greedy_search', 'sampling',
                                   'beam_search'):
            raise ValueError(f'unknown decode_strategy {decode_strategy!r}')
        if decode_strategy == 'beam_search' and num_beams < 1:
            raise ValueError('beam_search requires num_beams >= 1')
        if kwargs:
            raise TypeError(f'generate() got unexpected kwargs '
                            f'{sorted(kwargs)}')
        wrap = isinstance(input_ids, Tensor)
        dev = self.device
        ids = _as_ids(input_ids, dev).long()
        b, s = ids.shape
        padded = attention_mask is not None
        if padded:
            keep = _as_ids(attention_mask, dev).bool()
            if tuple(keep.shape) != (b, s):
                raise ValueError(f'attention_mask shape {tuple(keep.shape)} '
                                 f'does not match input_ids shape {(b, s)}')
        else:
            keep = torch.ones((b, s), dtype=torch.bool, device=dev)
        if max_length is not None:
            max_new_tokens = int(max_length) - s
            if max_new_tokens <= 0:
                if not _warned_max_length[0]:
                    _warned_max_length[0] = True
                    warnings.warn(
                        f'generate(): prompt length {s} already meets '
                        f'max_length={int(max_length)}; returning 0 new '
                        f'tokens. Use max_new_tokens= to request a budget '
                        f'beyond the prompt.', UserWarning, stacklevel=2)
                out = (torch.zeros((b, 0), dtype=torch.int64, device=dev),
                       torch.zeros((b,), dtype=torch.float32, device=dev))
                return tuple(Tensor(t) for t in out) if wrap else out
        if min_length is not None:     # the upstream total-length minimum
            min_new_tokens = max(int(min_length) - s, min_new_tokens)
        if decode_strategy == 'beam_search' and (
                repetition_penalty != 1.0 or min_new_tokens > 0):
            raise NotImplementedError(
                'repetition_penalty/min_new_tokens are supported for '
                'greedy_search and sampling (not beam_search)')
        cfg = getattr(self, 'config', None)
        max_pos = getattr(cfg, 'max_position_embeddings', None)
        if max_pos is not None and s + max_new_tokens > max_pos:
            raise ValueError(
                f'prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds '
                f'max_position_embeddings ({max_pos})')
        if eos_token_id is None:
            eos_token_id = getattr(cfg, 'eos_token_id', -1)
        if pad_token_id is None:
            pad_token_id = getattr(cfg, 'pad_token_id', 0)
        with _evaluating(self):
            if decode_strategy == 'beam_search':
                out = self._beam_decode(ids, keep, padded, int(max_new_tokens),
                                        int(num_beams), int(eos_token_id),
                                        int(pad_token_id),
                                        float(length_penalty))
            else:
                out = self._decode(ids, keep, padded, int(max_new_tokens),
                                   decode_strategy, float(temperature),
                                   int(top_k), float(top_p),
                                   int(eos_token_id), int(pad_token_id),
                                   float(repetition_penalty),
                                   int(min_new_tokens),
                                   _sampling_generator(decode_strategy, seed,
                                                       dev))
        return tuple(Tensor(t) for t in out) if wrap else out

    def _prefill(self, ids, keep, padded, total):
        b, s = ids.shape
        cache = self.init_cache(b, total)
        if padded:
            offsets = keep.sum(dim=1) - s                      # [B]
            mask = padded_decode_mask(keep, total, 0, s)
        else:
            offsets = torch.zeros((), dtype=torch.int64, device=ids.device)
            mask = None
        logits, cache = self._step(ids, cache, offsets, 0, mask)
        return logits, cache, offsets

    def _decode(self, ids, keep, padded, max_new_tokens, strategy,
                temperature, top_k, top_p, eos_token_id, pad_token_id,
                repetition_penalty, min_new_tokens, gen):
        b, s = ids.shape
        dev = ids.device
        total = s + max_new_tokens
        vocab = self.config.vocab_size

        def processors(logits, seen, emit_idx):
            # the CTRL repetition penalty over every token already in the
            # sequence, and EOS suppressed until min_new_tokens
            if repetition_penalty != 1.0:
                pen = torch.where(logits > 0, logits / repetition_penalty,
                                  logits * repetition_penalty)
                logits = torch.where(seen, pen, logits)
            if min_new_tokens > 0 and eos_token_id >= 0 \
                    and emit_idx < min_new_tokens:
                is_eos = torch.arange(logits.shape[-1],
                                      device=dev) == eos_token_id
                logits = logits.masked_fill(is_eos, NEG_INF)
            return logits

        track = repetition_penalty != 1.0
        seen = None
        if track:
            contrib = (keep if padded else torch.ones_like(keep)).long()
            seen = torch.zeros((b, vocab), dtype=torch.int64, device=dev)
            seen.scatter_add_(1, ids, contrib)
            seen = seen > 0
        logits, cache, offsets = self._prefill(ids, keep, padded, total)

        def pick(logits, emit_idx):
            nxt, logp = _next_token(processors(logits, seen, emit_idx), gen,
                                    strategy, temperature, top_k, top_p)
            if track:
                seen[torch.arange(b, device=dev), nxt] = True
            return nxt, logp

        def step(tok, i):
            nonlocal cache
            mask = padded_decode_mask(keep, total, s + i, 1) \
                if padded else None
            logits, cache = self._step(tok[:, None], cache, offsets + s + i,
                                       s + i, mask)
            return logits[:, -1]
        return _sample_loop(logits[:, -1], step, pick, max_new_tokens,
                            eos_token_id, pad_token_id)

    def _beam_decode(self, ids, keep, padded, max_new_tokens, k,
                     eos_token_id, pad_token_id, length_penalty):
        """Beam search over the static cache: the K beams of the B
        prompts decode as one [B * K] batch, reordered by a gather on
        the cache's batch dim each step (the JAX `_beam_decode_jit`)."""
        b, s = ids.shape
        total = s + max_new_tokens
        logits, cache, offsets = self._prefill(ids, keep, padded, total)
        cache = [tuple(c.repeat_interleave(k, dim=0) for c in kv)
                 for kv in cache]
        offsets_bk = (offsets.expand(b) if offsets.dim() == 0
                      else offsets).repeat_interleave(k)
        keep_bk = keep.repeat_interleave(k, dim=0)

        def step(tok, i):
            nonlocal cache
            mask = padded_decode_mask(keep_bk, total, s + i, 1) \
                if padded else None
            logits, cache = self._step(tok[:, None], cache,
                                       offsets_bk + s + i, s + i, mask)
            return logits[:, -1]

        def reorder(src):
            nonlocal cache
            cache = [tuple(c.index_select(0, src) for c in kv)
                     for kv in cache]
        return _beam_loop(logits[:, -1], step, reorder, k, max_new_tokens,
                          eos_token_id, pad_token_id, length_penalty)

    @torch.no_grad()
    def speculative_generate(self, draft_model, input_ids,
                             max_new_tokens: int = 20,
                             num_draft_tokens: int = 4,
                             eos_token_id: Optional[int] = None,
                             pad_token_id: Optional[int] = None):
        """Greedy decode accelerated by a smaller draft model (batch 1):
        the draft proposes k tokens, the target scores them in one cached
        forward and keeps the longest agreeing prefix plus its own next
        token, so the output equals `generate(decode_strategy=
        'greedy_search')` for any draft. Returns (ids [1,
        max_new_tokens], stats with `rounds`, `emitted`,
        `target_forwards_saved` and `acceptance_rate`)."""
        from ..tensor import Tensor
        wrap = isinstance(input_ids, Tensor)
        dev = self.device
        ids = _as_ids(input_ids, dev).long()
        k, eos_token_id, pad_token_id = _spec_args(
            self, ids, num_draft_tokens, eos_token_id, pad_token_id)
        with _evaluating(self, draft_model):
            s = ids.shape[1]
            total = s + max_new_tokens + k + 2
            target = [self, self.init_cache(1, total)]
            draft = [draft_model, draft_model.init_cache(1, total)]

            def fwd(entry, tok, pos):
                model, cache = entry
                logits, entry[1] = model(tok, position_offset=pos,
                                         cache=cache, cache_offset=pos,
                                         use_cache=True)
                return logits[0]

            def row(toks):
                return torch.tensor([toks], device=dev)
            first = int(fwd(target, ids, 0)[-1].argmax())
            fwd(draft, ids, 0)
            out, stats = _speculate(
                first, lambda t, p: int(fwd(draft, row([t]), p)[-1].argmax()),
                lambda ts, p: fwd(target, row(ts), p).argmax(dim=-1).tolist(),
                s - 1, k, max_new_tokens, eos_token_id, pad_token_id)
        ids_out = torch.tensor([out], dtype=torch.int64, device=dev)
        return (Tensor(ids_out) if wrap else ids_out), stats


# ---------------------------------------------------------------------------
# Seq2SeqGenerationMixin: the encoder-decoder generate() (T5)
# ---------------------------------------------------------------------------

class Seq2SeqGenerationMixin:
    """Mixed into encoder-decoder models (T5), the counterpart of the JAX
    package's (`paddle_tpu/nlp/generation.py:675-1100`). The host class
    provides `device`, `config` (its `eos_token_id`, `pad_token_id`,
    `decoder_start_token_id`), a forward taking (`decoder_input_ids`,
    `encoder_output`, `encoder_cross_kv`, `attention_mask`, `cache`,
    `cache_offset`, `use_cache=True`) that returns (logits, caches), and

    - ``encode(input_ids, attention_mask=None) -> encoder hidden``,
    - ``cross_kv(encoder_hidden) -> per-decoder-layer (k, v)``,
    - ``init_cache(batch_size, max_length) -> self-attention caches``.

    A call encodes once and computes each layer's cross K/V once; the
    decoder then runs single-token steps over the static self-attention
    cache (decoder slot 0 holds the start token, emitted token i slot 1 +
    i) in a Python loop, where the JAX package runs one compiled
    `while_loop`; greedy and sampling stop early once every sequence has
    emitted EOS (one flag read on the host a step). Sampling draws from
    a `torch.Generator` (seeded by `seed`, else the framework's), so its
    tokens are the JAX package's only in distribution; greedy, beam and
    speculative tokens are the same."""

    def _s2s_prepare(self, input_ids, attention_mask):
        """(ids [B, S] int64, keep [B, S] int64) on the model's device."""
        dev = self.device
        ids = _as_ids(input_ids, dev).long()
        if attention_mask is None:
            return ids, torch.ones_like(ids)
        keep = _as_ids(attention_mask, dev).long()
        if tuple(keep.shape) != tuple(ids.shape):
            raise ValueError(f'attention_mask shape {tuple(keep.shape)} '
                             f'does not match input_ids shape '
                             f'{tuple(ids.shape)}')
        return ids, keep

    def _s2s_step(self, tok, enc_h, cross, keep, cache, slot):
        return self(decoder_input_ids=tok, encoder_output=enc_h,
                    encoder_cross_kv=cross, attention_mask=keep,
                    cache=cache, cache_offset=slot, use_cache=True)

    def _s2s_encoded(self, ids, keep, total):
        """(encoder states, cross K/V, a fresh cache of `total`
        slots)."""
        enc_h = self.encode(ids, attention_mask=keep)
        return enc_h, self.cross_kv(enc_h), self.init_cache(ids.shape[0],
                                                            total)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 20,
                 max_length: Optional[int] = None,
                 decode_strategy: str = 'greedy_search',
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, num_beams: int = 1,
                 length_penalty: float = 0.0, min_new_tokens: int = 0,
                 eos_token_id: Optional[int] = None,
                 pad_token_id: Optional[int] = None,
                 decoder_start_token_id: Optional[int] = None,
                 use_cache: bool = True, seed: Optional[int] = None,
                 attention_mask=None, **kwargs):
        """Returns (generated ids [B, max_new_tokens] int64, per-sequence
        score [B] fp32: the summed log-probs of the emitted tokens, or for
        beam search the length-normalized beam score). `input_ids` are
        the encoder's inputs (`attention_mask` [B, S] their padding);
        decoding starts from `decoder_start_token_id`; tokens after EOS
        are `pad_token_id`; `max_length` counts the start token."""
        from ..tensor import Tensor
        if decode_strategy not in ('greedy_search', 'sampling',
                                   'beam_search'):
            raise ValueError(f'unknown decode_strategy {decode_strategy!r}')
        if decode_strategy == 'beam_search' and num_beams < 1:
            raise ValueError('beam_search requires num_beams >= 1')
        if decode_strategy == 'beam_search' and min_new_tokens > 0:
            raise NotImplementedError(
                'min_new_tokens is supported for greedy_search and '
                'sampling (not beam_search)')
        if kwargs:
            raise TypeError(f'generate() got unexpected kwargs '
                            f'{sorted(kwargs)}')
        wrap = isinstance(input_ids, Tensor)
        ids, keep = self._s2s_prepare(input_ids, attention_mask)
        if max_length is not None:
            max_new_tokens = max(int(max_length) - 1, 1)
        cfg = getattr(self, 'config', None)
        if eos_token_id is None:
            eos_token_id = getattr(cfg, 'eos_token_id', -1)
        if pad_token_id is None:
            pad_token_id = getattr(cfg, 'pad_token_id', 0)
        if decoder_start_token_id is None:
            decoder_start_token_id = getattr(cfg, 'decoder_start_token_id',
                                             0)
        with _evaluating(self):
            if decode_strategy == 'beam_search':
                out = self._s2s_beam_decode(
                    ids, keep, int(max_new_tokens), int(num_beams),
                    int(eos_token_id), int(pad_token_id),
                    int(decoder_start_token_id), float(length_penalty))
            else:
                out = self._s2s_decode(
                    ids, keep, int(max_new_tokens), decode_strategy,
                    float(temperature), int(top_k), float(top_p),
                    int(eos_token_id), int(pad_token_id),
                    int(decoder_start_token_id), int(min_new_tokens),
                    _sampling_generator(decode_strategy, seed, ids.device))
        return tuple(Tensor(t) for t in out) if wrap else out

    def _s2s_decode(self, ids, keep, max_new_tokens, strategy, temperature,
                    top_k, top_p, eos_token_id, pad_token_id, start_id,
                    min_new_tokens, gen):
        b = ids.shape[0]
        dev = ids.device

        def processors(logits, emit_idx):
            # EOS suppressed until min_new_tokens
            if min_new_tokens > 0 and eos_token_id >= 0 \
                    and emit_idx < min_new_tokens:
                is_eos = torch.arange(logits.shape[-1],
                                      device=dev) == eos_token_id
                logits = logits.masked_fill(is_eos, NEG_INF)
            return logits

        enc_h, cross, cache = self._s2s_encoded(ids, keep, 1 + max_new_tokens)
        start = torch.full((b, 1), start_id, dtype=torch.int64, device=dev)
        logits, cache = self._s2s_step(start, enc_h, cross, keep, cache, 0)

        def pick(logits, emit_idx):
            return _next_token(processors(logits, emit_idx), gen, strategy,
                               temperature, top_k, top_p)

        def step(tok, i):
            nonlocal cache
            logits, cache = self._s2s_step(tok[:, None], enc_h, cross, keep,
                                           cache, 1 + i)
            return logits[:, -1]
        return _sample_loop(logits[:, -1], step, pick, max_new_tokens,
                            eos_token_id, pad_token_id)

    def _s2s_beam_decode(self, ids, keep, max_new_tokens, k, eos_token_id,
                         pad_token_id, start_id, length_penalty):
        """Beam search: the encoder runs once, then the cross K/V, the
        self-attention cache and the encoder mask are repeated to a
        [B * K] batch, reordered by a gather on the cache's batch dim
        each step (the JAX `_s2s_beam_decode_jit`, its last step's
        reorder included)."""
        b = ids.shape[0]
        dev = ids.device
        enc_h, cross, cache = self._s2s_encoded(ids, keep, 1 + max_new_tokens)
        start = torch.full((b, 1), start_id, dtype=torch.int64, device=dev)
        logits, cache = self._s2s_step(start, enc_h, cross, keep, cache, 0)

        def rep(t):
            return t.repeat_interleave(k, dim=0)
        cache = [tuple(rep(c) for c in kv) for kv in cache]
        cross = [tuple(rep(c) for c in kv) for kv in cross]
        enc_h, keep = rep(enc_h), rep(keep)

        def step(tok, i):
            nonlocal cache
            logits, cache = self._s2s_step(tok[:, None], enc_h, cross, keep,
                                           cache, 1 + i)
            return logits[:, -1]

        def reorder(src):
            nonlocal cache
            cache = [tuple(c.index_select(0, src) for c in kv)
                     for kv in cache]
        return _beam_loop(logits[:, -1], step, reorder, k, max_new_tokens,
                          eos_token_id, pad_token_id, length_penalty)

    @torch.no_grad()
    def speculative_generate(self, draft_model, input_ids,
                             max_new_tokens: int = 20,
                             num_draft_tokens: int = 4,
                             eos_token_id: Optional[int] = None,
                             pad_token_id: Optional[int] = None,
                             decoder_start_token_id: Optional[int] = None,
                             attention_mask=None):
        """Greedy seq2seq decode accelerated by a smaller encoder-decoder
        draft (batch 1): both models encode the same inputs once; the
        draft proposes k tokens, the target scores them in one cached
        forward and keeps the longest agreeing prefix plus its own next
        token, so the output equals `generate(decode_strategy=
        'greedy_search')` for any draft. Returns (ids [1,
        max_new_tokens], stats with `rounds`, `emitted`,
        `target_forwards_saved` and `acceptance_rate`)."""
        from ..tensor import Tensor
        wrap = isinstance(input_ids, Tensor)
        ids, keep = self._s2s_prepare(input_ids, attention_mask)
        k, eos_token_id, pad_token_id = _spec_args(
            self, ids, num_draft_tokens, eos_token_id, pad_token_id)
        if decoder_start_token_id is None:
            decoder_start_token_id = getattr(self.config,
                                             'decoder_start_token_id', 0)
        dev = ids.device
        with _evaluating(self, draft_model):
            total = 1 + max_new_tokens + k + 2
            start = int(decoder_start_token_id)
            models = []
            for m in (self, draft_model):
                kp = keep.to(m.device)
                models.append([m, *m._s2s_encoded(ids.to(m.device), kp,
                                                  total), kp])

            def fwd(entry, toks, slot):
                m, enc_h, cross, cache, kp = entry
                logits, entry[3] = m._s2s_step(
                    torch.tensor([toks], device=m.device), enc_h, cross, kp,
                    cache, slot)
                return logits[0]
            target, draft = models
            first = int(fwd(target, [start], 0)[-1].argmax())
            fwd(draft, [start], 0)
            out, stats = _speculate(
                first, lambda t, p: int(fwd(draft, [t], p)[-1].argmax()),
                lambda ts, p: fwd(target, ts, p).argmax(dim=-1).tolist(),
                0, k, max_new_tokens, eos_token_id, pad_token_id)
        ids_out = torch.tensor([out], dtype=torch.int64, device=dev)
        return (Tensor(ids_out) if wrap else ids_out), stats
