"""The paged decode sub-step over static device buffers, replayed from a
captured CUDA graph on the card (the port's counterpart of the JAX
engine's compiled decode block, `paddle_tpu/serving/engine.py:
_paged_decode_fn`, which is traced once per engine).

`DecodeStep` keeps every tensor a sub-step reads or writes in a buffer
allocated once per engine on its device: the pending token, its
position, the active mask, the masked page table, the sampling
parameters and, with an adapter bank, the per-row bank slots. A round
refills them with `copy_` from pinned host staging, then runs
`decode_block` sub-steps, each one replay of the captured graph.

The sub-step body: the paged forward (`cached_forward`) into a static
fp32 logits buffer, the greedy argmax, `tok = where(active, argmax, 0)`
and `pos = min(pos + 1, max_len - 1)`, in place. Rows that sample draw
between replays (`draw_rows`, each from its own generator, the calls
the uncaptured loop makes) and write their token into `tok`. An
all-greedy round, the common mix, runs nothing between replays but the
copy of each sub-step's tokens into the round's output: the host's
counterpart of the JAX engine's all-greedy `lax.cond`.

Capture happens at the engine's first decode round on a CUDA device: a
warm-up over zeroed buffers on a side stream (its K/V writes land on the
null page 0; it loads every kernel library and makes the stream's cuBLAS
handle), then `torch.cuda.graph` on that stream, under
`torch.inference_mode()` and, with a bank, inside `adapter_scope` over
the bank's packed tensors and the static rows, so the adapter hooks run
once, at capture. What the graph holds never changes shape or storage:
the slot count, the table width, the KV pages and the bank's packed
tensors (written in place) are fixed per engine, so it is captured once.
A failed capture or replay raises; nothing falls back to the uncaptured
body on the card. On the CPU nothing is captured and the same body is
called directly, so the CPU tests run the code the card replays.

Over int8 pages (`kv_quant='int8'`) the round keeps the pages it can
touch in a float window, the port's counterpart of the JAX round's float
view (`paddle_tpu/serving/engine.py:698-741`, `kv_pool.py:353-397`): W =
`window_count(decode_block, ps)` pages per slot and layer, [N, W, ps,
HKV, D] in the model's dtype. Two more bodies run around the replays,
each captured as a graph of its own (no trace key: the JAX engine counts
only `paged_decode_step`): the round's begin sets `win_first = min(pos //
ps, P - 1)` from the staged positions and fills each window page by
dequantizing the slot's int8 page; each sub-step writes its row into the
window and the paged kernel reads the window in place of those pages;
the round's end requantizes each window page that overlaps [pos0, pos0 +
decode_block) into its page at a fresh absmax scale, and writes no other
page. A window past the table's last page (a round that runs into the
slot's end) goes to the null page, so the last page is written once,
from the window the sub-steps wrote. An inactive slot's staged table row
is the null page, so its window writes land there.

With a draft model the round is `SpecStep`, the port's counterpart of
the JAX engine's compiled speculation round (`paddle_tpu/serving/
engine.py:_paged_spec_fn`, :792-856), captured once as one graph: k
draft sub-steps, each the draft's decode forward over its row pool read
as pages (`kv_pool.SlotPool`) and a greedy argmax on the device, then
one verify of [pending, d_1 .. d_k] through the target's paged forward,
k + 1 query rows per slot in one paged-kernel call per layer, and the
longest-prefix acceptance. Over int8 pages its window covers the k + 1
rows of the verify.

`GraphStep` is what the sub-step shares with the captured prefill
(`prefill_graph.PrefillStep`): the static buffers and their pinned
staging, the capture and the replay.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from ..nlp.generation import LayerKV, window_count, write_pages
from ..ops import kernels
from ..ops.kernels import NEG_INF
from ..quantization import kv_dequantize_page
from .adapters.apply import adapter_scope


class GraphError(RuntimeError):
    """A CUDA graph's capture or replay failed: what the device holds is
    in doubt, so the engine treats it as fatal, never as the failure of
    the request it was serving."""


def draw_rows(logits: torch.Tensor, tok: torch.Tensor, temp: torch.Tensor,
              topk: torch.Tensor, topp: torch.Tensor, rows: np.ndarray,
              generators) -> None:
    """Overwrite tok[r] for each sampling row r of the host array `rows`
    with a draw from the fp32 [N, V] `logits` slab: temperature, then
    top-k, then top-p (the JAX engine's order; `top_k <= 0 or >= V` and
    `top_p >= 1` disable a filter), from the row's own generator
    `generators[r]`. temp/topk/topp are [N] tensors on the logits'
    device."""
    if rows.size == 0:
        return
    idx = torch.from_numpy(rows).to(logits.device)
    x = logits[idx] / temp[idx].clamp(min=1e-6)[:, None]
    v = x.shape[-1]
    k = topk[idx]
    k_eff = torch.where((k > 0) & (k < v), k, v).long()
    srt = x.sort(dim=-1, descending=True).values
    kth = srt.gather(1, k_eff[:, None] - 1)
    x = x.masked_fill(x < kth, NEG_INF)
    p = topp[idx]
    srt_p = x.sort(dim=-1, descending=True).values
    probs = torch.softmax(srt_p, dim=-1)
    cum = probs.cumsum(dim=-1)
    cutoff_idx = ((cum - probs) < p[:, None]).sum(dim=-1) - 1
    cutoff = srt_p.gather(1, cutoff_idx.clamp(0, v - 1)[:, None])
    x = x.masked_fill((p[:, None] < 1.0) & (x < cutoff), NEG_INF)
    dist = torch.softmax(x, dim=-1)
    for j, r in enumerate(rows):
        tok[r] = torch.multinomial(dist[j], 1, generator=generators[r])[0]


def sample_rows(logits: torch.Tensor, temp: torch.Tensor,
                topk: torch.Tensor, topp: torch.Tensor,
                sampling: np.ndarray, generators) -> torch.Tensor:
    """Next token per row of a [N, V] logits slab: the raw argmax
    (greedy), then `draw_rows` for the rows flagged in the host array
    `sampling`."""
    logits = logits.float()
    out = logits.argmax(dim=-1)
    draw_rows(logits, out, temp, topk, topp, np.flatnonzero(sampling),
              generators)
    return out


class GraphStep:
    """A body over static device buffers, run directly or replayed from
    a CUDA graph captured once (the shared part of `DecodeStep` and
    `prefill_graph.PrefillStep`).

    `spec` maps each buffer's name to its (shape, dtype): `buf[name]` on
    `device`, refilled by `stage` from a pinned host twin. A subclass
    names itself in `what` (for errors) and defines `_body()`, which
    reads and writes only the buffers and tensors fixed per engine. The
    methods named in `side` are bodies of their own, run around the
    main one by `run_side` and captured beside it.
    """

    what = 'step'
    side = ()

    def __init__(self, spec: dict, device: torch.device):
        pin = device.type == 'cuda'
        self.device = device
        self.buf = {k: torch.zeros(s, dtype=d, device=device)
                    for k, (s, d) in spec.items()}
        self._host = {k: torch.zeros(s, dtype=d, pin_memory=pin)
                      for k, (s, d) in spec.items()}
        self.graph = None
        self._out = None             # the body's output at capture
        self._launches = None

    def stage(self, **host) -> None:
        """Copy each named host value into its pinned staging buffer and
        from there into its device buffer (queued, no sync). Call only
        once the copies of the previous staging have run (the caller's
        fetch or sync waits for them)."""
        for name, arr in host.items():
            staged = self._host[name]
            staged.numpy()[...] = arr
            self.buf[name].copy_(staged, non_blocking=True)

    def _body(self):
        raise NotImplementedError

    def capture(self, pool=None) -> None:
        """Capture the body as a CUDA graph, its memory from `pool` (a
        `torch.cuda.graph_pool_handle()` shared with other graphs, or
        None for a pool of its own): a warm-up over zeroed buffers on a
        side stream, then the capture on that stream.

        The garbage collector is off while it captures: cyclic garbage
        can hold the CUDA graphs of engines dropped earlier, and a
        collection inside the capture frees them there, which
        invalidates the capture under way (the body's next cuBLAS call
        then fails with CUBLAS_STATUS_INTERNAL_ERROR)."""
        for t in self.buf.values():
            t.zero_()        # the warm-up writes only the null page
        dev = self.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        graphs = {}
        collecting = gc.isenabled()
        gc.disable()
        try:
            for name in ('_body',) + tuple(self.side):
                body = getattr(self, name)
                with torch.cuda.stream(stream):
                    body()
                graph = torch.cuda.CUDAGraph()
                with kernels.CapturedLaunches() as held, \
                        torch.cuda.graph(graph, pool=pool, stream=stream):
                    out = body()
                graphs[name] = (graph, out, held)
        except RuntimeError as exc:
            raise GraphError(
                f'capturing the {self.what} as a CUDA graph failed: '
                f'{exc}') from exc
        finally:
            if collecting:
                gc.enable()
        self.graph, self._out, self._launches = graphs.pop('_body')
        self._side_graphs = graphs

    def run_once(self):
        """Queue the body once: a replay of the graph when captured (its
        output is the capture's static output), else the body itself.
        Waits for nothing."""
        if self.graph is None:
            return self._body()
        try:
            self.graph.replay()
        except RuntimeError as exc:
            raise GraphError(
                f'replaying the {self.what} graph failed: {exc}') from exc
        self._launches.replayed()
        return self._out

    def run_side(self, name: str):
        """Queue the side body `name` once, replayed when captured."""
        if self.graph is None:
            return getattr(self, name)()
        graph, out, held = self._side_graphs[name]
        try:
            graph.replay()
        except RuntimeError as exc:
            raise GraphError(
                f'replaying the {self.what} graph {name} failed: '
                f'{exc}') from exc
        held.replayed()
        return out


class DecodeStep(GraphStep):
    """One engine's decode sub-step over static buffers on `device`.

    Args:
        fwd: the model's `cached_forward`.
        pages: the pool's per-layer (k_pages, v_pages), updated in place.
        num_slots, table_width: the page table's [N, P].
        max_length: the slot length (positions stop at max_length - 1).
        decode_block: sub-steps per round.
        adapter_arrays: `AdapterBank.device_arrays()`, or None without a
            bank.
        scales: the int8 pool's per-layer (k_scales, v_scales), or None
            for pages in the model's dtype.
        compute_dtype: the window's dtype (the model's), with `scales`.
        extra: more static buffers, {name: (shape, dtype)}.
    """

    what = 'decode sub-step'

    def __init__(self, fwd, pages, num_slots: int, table_width: int,
                 max_length: int, decode_block: int, device: torch.device,
                 adapter_arrays=None, scales=None, compute_dtype=None,
                 extra=None):
        self._fwd = fwd
        self._max_len = int(max_length)
        self._arrays = adapter_arrays
        n = num_slots
        spec = {'tok': ((n,), torch.int64), 'pos': ((n,), torch.int64),
                'active': ((n,), torch.bool),
                'table': ((n, table_width), torch.int32),
                'temp': ((n,), torch.float32), 'topk': ((n,), torch.int64),
                'topp': ((n,), torch.float32)}
        if adapter_arrays is not None:
            spec['rows'] = ((n,), torch.int32)
        if scales is not None:
            # set by the round's begin, not staged
            spec['win_first'] = ((n,), torch.int32)
            spec['pos0'] = ((n,), torch.int64)
        spec.update(extra or {})
        super().__init__(spec, device)
        self.out = torch.zeros((n, decode_block), dtype=torch.int64,
                               device=device)
        self._pages = pages
        self._windows = None
        if scales is not None:
            self._w = window_count(decode_block, pages[0][0].shape[1])
            self._windows = [tuple(
                torch.zeros((n, self._w) + tuple(t.shape[1:]),
                            dtype=compute_dtype, device=device) for t in kv)
                for kv in pages]
            self._pages = [LayerKV(*kv, *sc, *win, self.buf['win_first'])
                           for kv, sc, win in zip(pages, scales,
                                                  self._windows)]
            self.side = ('_round_begin', '_round_end')

    def _body(self) -> torch.Tensor:
        b = self.buf
        with adapter_scope(self._arrays, b.get('rows')):
            logits = self._fwd(b['tok'][:, None], self._pages, b['pos'],
                               b['table'])[:, -1].float()
        b['tok'].copy_(torch.where(b['active'], logits.argmax(dim=-1), 0))
        b['pos'].copy_(torch.clamp(b['pos'] + 1, max=self._max_len - 1))
        return logits

    def _window_pages(self) -> tuple:
        """(window's logical pages [N, W], their page ids: the staged
        table's, or the null page past the table)."""
        table = self.buf['table']
        p = table.shape[1]
        idx = self.buf['win_first'].long()[:, None] + torch.arange(
            self._w, device=table.device)
        pid = torch.gather(table.long(), 1, idx.clamp(max=p - 1))
        return idx, torch.where(idx < p, pid, 0)

    def _round_begin(self) -> None:
        """Set the round's window from the staged positions and fill it
        with the slot's pages, dequantized."""
        pos = self.buf['pos'].clamp(max=self._max_len - 1)
        ps, p = self._pages[0].k.shape[1], self.buf['table'].shape[1]
        self.buf['pos0'].copy_(pos)
        self.buf['win_first'].copy_(
            torch.div(pos, ps, rounding_mode='floor').clamp(max=p - 1))
        _, pid = self._window_pages()
        for kv in self._pages:
            for pages, sc, win in ((kv.k, kv.k_scales, kv.k_win),
                                   (kv.v, kv.v_scales, kv.v_win)):
                win.copy_(kv_dequantize_page(pages[pid], sc[pid], win.dtype))

    def _round_end(self) -> None:
        """Requantize each window page the round touched, [pos0, pos0 +
        decode_block), into its page (the JAX round's scatter)."""
        ps = self._pages[0].k.shape[1]
        idx, _ = self._window_pages()
        pos0 = self.buf['pos0'][:, None]
        keep = (idx * ps < pos0 + self.out.shape[1]) & ((idx + 1) * ps > pos0)
        for kv in self._pages:
            for pages, sc, win in ((kv.k, kv.k_scales, kv.k_win),
                                   (kv.v, kv.v_scales, kv.v_win)):
                write_pages(pages, sc, win, self.buf['table'],
                            self.buf['win_first'].long(), keep)

    def run(self, sampling: np.ndarray, generators) -> torch.Tensor:
        """Queue `decode_block` sub-steps over the staged buffers (graph
        replays once captured, else the body itself); rows flagged in
        the host array `sampling` draw between them. Returns the static
        [N, decode_block] token buffer; an all-greedy round waits for
        nothing."""
        b = self.buf
        rows = np.flatnonzero(sampling)
        if self._windows is not None:
            self.run_side('_round_begin')
        for j in range(self.out.shape[1]):
            logits = self.run_once()
            draw_rows(logits, b['tok'], b['temp'], b['topk'], b['topp'],
                      rows, generators)
            self.out[:, j].copy_(b['tok'])
        if self._windows is not None:
            self.run_side('_round_end')
        return self.out


class SpecStep(DecodeStep):
    """One speculating engine's round over static buffers on `device`: k
    draft proposals and one verify of k + 1 rows (the JAX
    `_paged_spec_fn`), replayed from one CUDA graph on the card.

    The body, all on the device:
    - k draft sub-steps: the draft's decode forward of the current token
      at position min(pos + j, max_length - 1) over its row pool read as
      pages through the staged identity table `d_table` (an inactive
      slot writes its junk row into its own draft row, above its live
      length, as in JAX), then the argmax;
    - the verify: the target's paged forward of [pending, d_1 .. d_k] at
      positions pos .. pos + k over the masked table, inside
      `adapter_scope` with a bank (the draft stays outside it, as in
      JAX): each slot's k + 1 rows written into its pages (over int8
      pages into the round's window) and one paged-kernel call per layer
      with q [N, k + 1, H, D], row t seeing the keys [0, pos + t];
    - the acceptance: `choice` the verify's argmax per row, `match` the
      drafts that equal it, stopping at eos and zero for sampling rows,
      a = sum(cumprod(match)), the tokens [N, k + 1] (the accepted drafts
      then the target's own next token) and the counts a + 1 [N], both
      zero for inactive slots.
    Sampling rows then draw one token from the verify's first-row logits
    with their own generator, between the replay and the fetch
    (`draw_rows`); their count is 1.

    Over int8 pages the window holds W = `window_count(k + 1, ps)` pages
    per slot and layer; its fill and requantize run around the replay, as
    in `DecodeStep`, and the requantize rewrites every page the span
    [pos, pos + k + 1) touches, rejected rows included, as the JAX
    scatter does.

    Args (beyond `DecodeStep`'s, with `k` in place of decode_block):
        draft_fwd: the draft model's `cached_forward`.
        draft_pages: the draft pool's per-layer (k_pages, v_pages)
            (`SlotPool.pages`).
    """

    what = 'speculation round'

    def __init__(self, fwd, pages, num_slots: int, table_width: int,
                 max_length: int, k: int, device: torch.device, draft_fwd,
                 draft_pages, adapter_arrays=None, scales=None,
                 compute_dtype=None):
        n = num_slots
        super().__init__(
            fwd, pages, n, table_width, max_length, k + 1, device,
            adapter_arrays, scales, compute_dtype,
            extra={'eos': ((n,), torch.int64),
                   'greedy': ((n,), torch.bool),
                   'd_table': ((n, -(-max_length
                                     // draft_pages[0][0].shape[1])),
                               torch.int32)})
        self.k = int(k)
        self._draft_fwd = draft_fwd
        self._draft_pages = draft_pages
        self.counts = torch.zeros(n, dtype=torch.int64, device=device)

    def _body(self) -> torch.Tensor:
        return self._verify(self._propose())

    def _propose(self) -> torch.Tensor:
        """The k draft sub-steps; returns the drafts [N, k]."""
        b = self.buf
        pos, cur = b['pos'], b['tok']
        drafts = []
        for j in range(self.k):
            p = torch.clamp(pos + j, max=self._max_len - 1)
            cur = self._draft_fwd(cur[:, None], self._draft_pages, p,
                                  b['d_table'])[:, -1].argmax(dim=-1)
            drafts.append(cur)
        return torch.stack(drafts, dim=1)

    def _verify(self, drafts: torch.Tensor) -> torch.Tensor:
        """The verify of [pending, drafts] and the acceptance, into `out`
        and `counts`; returns the first row's fp32 logits [N, V]."""
        b, k = self.buf, self.k
        pos = b['pos']
        block = torch.cat([b['tok'][:, None], drafts], dim=1)  # [N, k + 1]
        with adapter_scope(self._arrays, b.get('rows')):
            logits = self._fwd(block, self._pages, pos, b['table']).float()
        choice = logits.argmax(dim=-1)                          # [N, k + 1]
        match = ((drafts == choice[:, :k]) & (drafts != b['eos'][:, None])
                 & b['greedy'][:, None])
        a = torch.cumprod(match.long(), dim=1).sum(dim=1)
        nxt = choice.gather(1, a[:, None])
        j = torch.arange(k + 1, device=pos.device)[None, :]
        ext = torch.cat([drafts, drafts[:, -1:]], dim=1)
        toks = torch.where(j < a[:, None], ext,
                           torch.where(j == a[:, None], nxt, 0))
        self.out.copy_(torch.where(b['active'][:, None], toks, 0))
        self.counts.copy_(torch.where(b['active'], a + 1, 0))
        return logits[:, 0]

    def run(self, sampling: np.ndarray, generators) -> tuple:
        """Queue the round over the staged buffers (a graph replay once
        captured, else the body); rows flagged in the host array
        `sampling` then draw their one token from the verify's first-row
        logits. Returns the static ([N, k + 1] tokens, [N] counts)
        buffers; waits for nothing."""
        b = self.buf
        if self._windows is not None:
            self.run_side('_round_begin')
        logits = self.run_once()
        draw_rows(logits, self.out[:, 0], b['temp'], b['topk'], b['topp'],
                  np.flatnonzero(sampling), generators)
        if self._windows is not None:
            self.run_side('_round_end')
        return self.out, self.counts
