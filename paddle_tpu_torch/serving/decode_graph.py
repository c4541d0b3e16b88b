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

`GraphStep` is what the sub-step shares with the captured prefill
(`prefill_graph.PrefillStep`): the static buffers and their pinned
staging, the capture and the replay.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels
from ..ops.kernels import NEG_INF
from .adapters.apply import adapter_scope


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
    reads and writes only the buffers and tensors fixed per engine.
    """

    what = 'step'

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
        side stream, then the capture on that stream."""
        for t in self.buf.values():
            t.zero_()        # the warm-up writes only the null page
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(side):
                self._body()
            with kernels.CapturedLaunches() as held, \
                    torch.cuda.graph(graph, pool=pool, stream=side):
                out = self._body()
        except RuntimeError as exc:
            raise RuntimeError(
                f'capturing the {self.what} as a CUDA graph failed: '
                f'{exc}') from exc
        self.graph, self._out, self._launches = graph, out, held

    def run_once(self):
        """Queue the body once: a replay of the graph when captured (its
        output is the capture's static output), else the body itself.
        Waits for nothing."""
        if self.graph is None:
            return self._body()
        try:
            self.graph.replay()
        except RuntimeError as exc:
            raise RuntimeError(
                f'replaying the {self.what} graph failed: {exc}') from exc
        self._launches.replayed()
        return self._out


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
    """

    what = 'decode sub-step'

    def __init__(self, fwd, pages, num_slots: int, table_width: int,
                 max_length: int, decode_block: int, device: torch.device,
                 adapter_arrays=None):
        self._fwd = fwd
        self._pages = pages
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
        super().__init__(spec, device)
        self.out = torch.zeros((n, decode_block), dtype=torch.int64,
                               device=device)

    def _body(self) -> torch.Tensor:
        b = self.buf
        with adapter_scope(self._arrays, b.get('rows')):
            logits = self._fwd(b['tok'][:, None], self._pages, b['pos'],
                               b['table'])[:, -1].float()
        b['tok'].copy_(torch.where(b['active'], logits.argmax(dim=-1), 0))
        b['pos'].copy_(torch.clamp(b['pos'] + 1, max=self._max_len - 1))
        return logits

    def run(self, sampling: np.ndarray, generators) -> torch.Tensor:
        """Queue `decode_block` sub-steps over the staged buffers (graph
        replays once captured, else the body itself); rows flagged in
        the host array `sampling` draw between them. Returns the static
        [N, decode_block] token buffer; an all-greedy round waits for
        nothing."""
        b = self.buf
        rows = np.flatnonzero(sampling)
        for j in range(self.out.shape[1]):
            logits = self.run_once()
            draw_rows(logits, b['tok'], b['temp'], b['topk'], b['topp'],
                      rows, generators)
            self.out[:, j].copy_(b['tok'])
        return self.out
