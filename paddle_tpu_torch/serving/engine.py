"""Continuous-batching inference engine (counterpart of
`paddle_tpu/serving/engine.py:InferenceEngine`), with the prefix cache,
chunked prefill and speculative decoding with a draft model, graceful
drain, eviction and in-place weight swaps, over either KV layout of the
JAX engine, chosen by its rule (:236-245):

- row (the default: none of `kv_page_size`, `kv_pages`, `kv_quant`
  given): one KV row of max_length per slot (`kv_pool.SlotPool`). The
  rows are stored as pages under a fixed identity page table, so every
  forward below reads and writes them through the same kernels and
  bodies as the paged pool's, under the JAX row engine's names
  (`decode_step`, `prefill_<b>`, `chunk_prefill_<b>`,
  `spec_decode_k<k>`). The prefix cache (`RadixPrefixCache`) retains
  whole slots: a hit's first chunk reads the retained row (its rows
  below the chunk are copied into the slot's row first) and writes only
  the slot's, a full hit copies the row (`copy_slot`), and retirement
  hands the slot to the cache, which adopts it or lets it be freed.
  Admission counts zero-ref retained slots as free (`_effective_free`),
  evicts the least recently used one when the free list is empty, and
  requeues the batch when a promised slot was pinned meanwhile;
- paged (`kv_page_size`, default 16, `kv_pages` or `kv_quant`): what
  follows.

One engine is one event loop: `step()` admits queued requests into free
slots (reserving every page each can touch, and requeueing on
`PagePoolExhausted`), advances every slot that is mid-prefill by one
chunk, then advances every active slot one decode round of
`decode_block` sub-steps. Each sub-step runs the model's paged forward
(`nlp.generation.cached_forward`): the pending token's K/V rows are
written into its page, and it attends through the paged-attention
kernel over the slot's page table, which is the function the JAX engine
computes by gathering pages, attending densely under a slot-causal mask
and scattering the touched pages back.

Admission (`_begin_request`) takes one of three paths:
- a short cold prompt is prefilled whole at its length bucket: the
  causal flash kernel over the right-padded bucket, its K/V slab
  scattered into the slot's pages;
- with `prefix_cache`, the longest cached prefix of the prompt, cut to
  whole pages, is attached read-only into the slot's table (the pages
  are shared, not copied); the suffix, like any prompt longer than
  `prefill_chunk_tokens`, is prefilled one bucket-shaped chunk per
  `step()` (`_prefill_chunk`). The chunk forward writes its rows into
  the slot's pages and attends through the causal flash kernel over the
  slot's rows before it plus its own, bottom-right aligned, which is the
  JAX chunk's mask `k_slot <= start + i`. A slot mid-prefill is parked
  (inactive for decode, its table redirected to the null page), and a
  window whose bucket would overrun the slot shifts down, its writes
  below the attach boundary (`floor`) sent to the null page so a shared
  page is never rewritten;
- a prompt whose every token is cached in whole pages (a full hit)
  prefills nothing: the page holding its last row is split off first
  (copy-on-write), since the first decode round re-forwards that row.
At retirement the prompt's full pages are held by the prefix cache and
the slot is freed; adapter requests are cached under their own
`(adapter_id, adapter_version)` namespace.

The sub-step runs over static device buffers (`decode_graph.
DecodeStep`), and on the card it is captured as a CUDA graph at the
first decode round and replayed `decode_block` times a round, where the
JAX engine compiles the round once (`stats()['traces']
['paged_decode_step']` counts the capture, as the JAX engine counts its
trace). Prefill is captured too, one graph per (kind, bucket) at its
first use (`prefill_graph.PrefillStep`, all sharing one memory pool):
a whole prefill replays `paged_prefill_<bucket>` and a chunk
`paged_chunk_prefill_<bucket>`, the JAX engine's per-bucket programs
and trace names, each counted once in `traces`; a chunk's start and
floor are device buffers, so one chunk graph serves every start.
`_capture_decode = False` and `_capture_prefill = False` run the same
bodies uncaptured on the card (the eager twin of the tests and
`chip_smoke.py`); on the CPU nothing is captured.

With `kv_quant='int8'` the pages are int8 with per-(page, kv head)
scales (`kv_pool.PagedSlotPool(quant='int8')`): a whole prefill
quantizes each page it touches from its rows and zeros past the bucket,
a chunk requantizes the pages it touches from the slot's dequantized
row, and a decode round keeps the pages it can touch in a float window
that its sub-steps write and the paged kernel reads, requantizing the
touched ones at the round's end (`decode_graph.DecodeStep`), which is
what the JAX engine's gather, compute and scatter of touched pages
does. Shared prefix pages are never requantized: the floor keeps a
chunk's writes off them, and the full hit's last page is split off
first.

A request whose admission or prefill chunk raises fails alone
(`FAILED`, counted in `stats()['failed']`): its slot, pages, prefix
node and adapter pin are released and the engine keeps serving, as the
JAX engine does. A failed graph capture or replay (`GraphError`) and a
CUDA error are not a request's failure: what the device holds is in
doubt, so they escape `step()`.

With a `draft_model` each round is one speculation round
(`decode_graph.SpecStep`, the JAX `_paged_spec_fn`, captured as one
graph `paged_spec_decode_k{k}`): the draft proposes k tokens greedily
from its own KV, a row pool slot for slot with the paged pool
(`kv_pool.SlotPool`, filled at activation by a whole-bucket draft
prefill, `draft_prefill_<bucket>`), and the target verifies the pending
token and the k drafts in one forward of k + 1 rows per slot, each
greedy slot emitting its longest accepted prefix and the target's own
next token: the tokens of plain greedy decoding, in fewer target
passes. Sampling slots draw one token a round from the verify's first
row. Every request reserves k rows of headroom past its budget.

Graceful drain (`drain`, `begin_drain`, or a `PreemptionHandler` wired
in by `enable_graceful_drain`) stops admitting and finishes every
accepted request, failing the stragglers past a deadline; `evict_all`
hands every accepted request back untouched. `swap_weights` copies a
published state into the live parameters in place (a drained engine
only), so every captured graph reads the new weights and nothing is
captured again; `restore_weights` copies the old ones back.

Greedy requests take the raw argmax, so their tokens never depend on
batch neighbours; sampling requests draw from their own
`torch.Generator`, seeded from `SamplingParams.seed`, between replays.

With an `AdapterBank`, each request may decode under its own LoRA
adapter (`submit(..., adapter_id=)`): admission pins the adapter's bank
slot into the host row vector `_adapter_rows` (0 = the zero base
adapter), which each round stages into the sub-step's static rows; the
sub-step runs inside `adapter_scope` over the bank's tensors and those
rows, and each prefill or chunk inside a scope over its step's static
row, staged with the slot's, so one batch mixes base and adapted
requests.

Observability, hooked where the JAX paged engine hooks its own and under
its names (`observability/`):
- metrics: `paddle_serving_requests_total{status}` (submitted,
  rejected, completed, failed), `_tokens_total`, `_prefills_total
  {bucket}`, `_prefill_tokens_total`, `_decode_steps_total`,
  `_decode_rounds_total`, `_chunk_rounds_total`, `_chunk_tokens_total`,
  `_spec_rounds_total`, `_spec_proposed_total`, `_spec_accepted_total`,
  `paddle_spec_*{source="engine"}`, the `_slots` / `_active_slots`
  gauges, the `_slot_occupancy` histogram per round and the TTFT/TPOT
  histograms; `paddle_weight_version{scope}` after a swap;
- spans: `serving.queue` (submit to admission), `serving.prefill`,
  `serving.prefill_chunk`, `serving.draft_prefill`,
  `serving.decode_round` / `serving.spec_round` and `serving.drain`.
  A round's span holds its token fetch, which waits for the device (a
  graph replay returns at launch), and a prefill's span its device
  sync, so the goodput ledger's `serving_decode` and `serving_prefill`
  hold device time, not the residual;
- events: `serving_request_failed`, `page_pool_exhausted`,
  `adapter_bank_saturated`, `paged_cow`, `prefix_hit`,
  `serving_drain_begin`, `serving_drain_complete`;
- the request ledger: a record per request opened at `submit`, its
  queue wait sampled by reason at each requeue (`pool_exhausted`,
  `adapter_pinned`), its prefix lookup, admission, prefill and
  prefill-wait, and each round's wall in both books (`note_round`);
- `/healthz`: `note_degraded('draining', scope=obs_scope)` from the
  drain's start (cleared by the caller, `clear_degraded`), a `decode`
  progress beat per round, and the weight version per scope.
Every gauge reads host state (the host page table, `_active`,
`pool.occupancy`); nothing reads a device tensor for a metric. The JAX
event `serving_pool_recovered` has no counterpart: it follows a failed
donated program, whose pool rows the JAX engine rebuilds; in the port a
failed capture or replay is fatal to the engine (`GraphError`).
"""
from __future__ import annotations

import collections
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import observability as _obs
from ..nlp.generation import cached_forward
from ..observability import cost as _cost
from ..observability import reqledger as _reqledger
from ..framework import generator as _generator
from ..resilience.retry import RetryPolicy, call_with_retry, is_cuda_error
from .adapters.bank import AdapterUnavailable
from .api import GREEDY, RUNNING, RequestHandle, SamplingParams
from .decode_graph import DecodeStep, GraphError, SpecStep
from .kv_pool import PagePoolExhausted, PagedSlotPool, SlotPool
from .prefill_graph import PrefillStep
from .prefix_cache import PagedPrefixCache, RadixPrefixCache
from .scheduler import FCFSScheduler

# occupancy is a ratio; the latency-shaped default buckets are wrong here
_OCCUPANCY_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)

# rows per page of the row pool's identity table: the paged engine's
# default page, so a row engine drives the paged kernel through a table
# of the paged engine's width
ROW_PAGE_SIZE = 16


def _to_device(step, **host) -> None:
    """Host->device staging of a step's static buffers (module-level so
    fault-injection tests can patch it; call sites wrap it in retry)."""
    step.stage(**host)


def _from_device(x: torch.Tensor) -> np.ndarray:
    """Device->host fetch of a round's tokens (patchable, as
    `_to_device`)."""
    return x.to('cpu', copy=True).numpy()


def program_name(trace_key: str) -> str:
    """The JAX program name a `stats()['traces']` key is cataloged under
    (`observability.cost`): the decode sub-step's graph serves the JAX
    engine's whole decode block, the others keep their key."""
    if trace_key == 'paged_decode_step':
        return 'serving.paged_decode_block'
    if trace_key == 'decode_step':
        return 'serving.decode_block'
    return f'serving.{trace_key}'


def _model_cost(model, kv_itemsize: int) -> _cost.TransformerCost:
    return _cost.TransformerCost(
        model.config, torch.empty((), dtype=model.dtype).element_size(),
        kv_itemsize)

def _host_tensor(value) -> torch.Tensor:
    """A published weight (a tensor, a numpy array or anything
    `np.asarray` reads, e.g. a JAX array) as a tensor; numpy bfloat16
    goes through float32, which holds it exactly."""
    if isinstance(value, torch.Tensor):
        return value.detach()
    arr = np.asarray(getattr(value, 'value', value))
    if arr.dtype.name == 'bfloat16':
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.require(arr, requirements=('C', 'W')))


def _device_fault(exc: Exception) -> bool:
    """A failed graph capture or replay, or a CUDA error (PyTorch's or a
    kernel wrapper's, `is_cuda_error`): fatal to the engine, not one
    request's failure."""
    return isinstance(exc, GraphError) or is_cuda_error(exc)


class InferenceEngine:
    """Single-host continuous-batching engine around one causal LM.

    Args:
        model: a port model with the serving contract: `init_cache`,
            `prefill_kv(ids)` (per-layer K/V rows of a prompt) and the
            paged forward behind `cached_forward`. It runs on its own
            device, and so does the engine.
        num_slots: KV slots = max concurrently decoding requests.
        max_length: per-slot cache length; every request needs
            prompt_len + max_new_tokens <= max_length.
        decode_block: sub-steps per decode round; a request finishing
            mid-round wastes at most decode_block - 1 sub-steps.
        buckets: prefill length buckets (default: powers of two).
        max_prefill_tokens: per-iteration prefill budget (scheduler).
        eos_token_id: default eos (-1 = never); per-request params win.
        dtype: the KV pool's dtype (and the draft's pool's, and under
            `kv_quant='int8'` the dtype the pages dequantize into): any
            float dtype, whatever the model's. None keeps the model's
            dtype; the JAX engine's None makes a float32 pool, a fault in
            the reference that the port does not share (ROADMAP). Every
            attention reads the K/V as the pool holds them: a decode
            through the paged kernel's pair for (the model's dtype, the
            pool's), a prefill over rows rounded through the pool's dtype.
        retry_policy: `resilience.RetryPolicy` for the host<->device
            copies of a round and a prefill (sites serving.h2d /
            serving.d2h); a CUDA error is never retried.
        donate_pool: the JAX engine's pool-donation flag, kept and
            reported in `stats()`; torch writes the pool in place, so it
            changes nothing here.
        kv_page_size: rows per KV page (paged engine; 16 when only
            `kv_pages` or `kv_quant` is given); max_length must be a
            multiple. Without it, `kv_pages` and `kv_quant` the engine
            keeps one KV row per slot.
        kv_pages: total pages including the null page 0 (paged engine).
            Default num_slots * pages_per_slot + 1; lower oversubscribes,
            and admission then requeues on page exhaustion.
        adapter_bank: a `serving.AdapterBank` attached to this model;
            enables `submit(..., adapter_id=)`. A request pins its
            adapter at admission (a store-backed bank may load it then)
            and unpins it at retirement; a bank full of pinned slots
            requeues the request.
        prefix_cache: a `PagedPrefixCache` (paged engine) or a
            `RadixPrefixCache` (row engine) over this engine's pool, or a
            fraction of the pool's pages (paged) or slots (row) it may
            hold (True = 0.5); None or False = no cache.
        prefill_chunk_tokens: prompts longer than this prefill one chunk
            (at its length bucket) per `step()`; None = whole prefills
            (a prefix hit's suffix is then one chunk).
        kv_quant: 'int8' stores the paged KV as int8 with per-(page, kv
            head) absmax scales (half the bytes of bf16 KV); None keeps
            it in `dtype`.
        draft_model: a smaller causal LM on the engine's device for
            speculative decoding: each round it proposes
            `num_draft_tokens` tokens greedily from its own row KV pool
            and the model verifies them in one forward of k + 1 rows per
            slot (greedy output identical to plain greedy). Sampling
            requests decode one token per round.
        num_draft_tokens: draft proposals per speculation round (k).
        weight_version: the initial weight-version tag, stamped on every
            request at admission; `swap_weights` moves it.
    """

    def __init__(self, model, num_slots: int = 8, max_length: int = 256,
                 decode_block: int = 4,
                 buckets: Optional[Sequence[int]] = None,
                 max_prefill_tokens: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 dtype=None, retry_policy: Optional[RetryPolicy] = None,
                 max_wait_s: Optional[float] = None,
                 prefix_cache=None,
                 prefill_chunk_tokens: Optional[int] = None,
                 draft_model=None, num_draft_tokens: int = 4,
                 weight_version: int = 0,
                 donate_pool: Optional[bool] = None,
                 kv_page_size: Optional[int] = None,
                 kv_pages: Optional[int] = None,
                 kv_quant: Optional[str] = None,
                 adapter_bank=None):
        cfg = getattr(model, 'config', None)
        max_pos = getattr(cfg, 'max_position_embeddings', None)
        if max_pos is not None and max_length > max_pos:
            raise ValueError(
                f'max_length {max_length} exceeds the model\'s '
                f'max_position_embeddings {max_pos}')
        if decode_block < 1:
            raise ValueError('decode_block must be >= 1')
        model.eval()
        self.model = model
        self.device = model.device
        self._fwd = cached_forward(model)
        # monotone weight-version tag, moved by swap_weights; every
        # request is stamped with the version it decodes under
        self.weight_version = int(weight_version)
        self.eos_token_id = int(
            getattr(cfg, 'eos_token_id', -1) if eos_token_id is None
            else eos_token_id)
        self.decode_block = int(decode_block)
        self.adapter_bank = adapter_bank
        # the JAX rule (engine.py:236-245): paged when any page argument
        # is given, else one row per slot
        self._paged = (kv_page_size is not None or kv_pages is not None
                       or kv_quant is not None)
        page_size = int(kv_page_size) if kv_page_size else 16
        if self._paged:
            self.pool = PagedSlotPool(model, num_slots, max_length, dtype,
                                      buckets, page_size=page_size,
                                      num_pages=kv_pages, quant=kv_quant)
        else:
            self.pool = SlotPool(model, num_slots, max_length, dtype,
                                 buckets, page_size=ROW_PAGE_SIZE)
        self.scheduler = FCFSScheduler(max_prefill_tokens,
                                       max_wait_s=max_wait_s)
        if prefill_chunk_tokens is not None and prefill_chunk_tokens < 1:
            raise ValueError('prefill_chunk_tokens must be >= 1')
        self.prefill_chunk_tokens = (int(prefill_chunk_tokens)
                                     if prefill_chunk_tokens else None)
        self.pool.prefill_chunk_tokens = self.prefill_chunk_tokens
        # the host<->device copies of a round and a prefill retry under
        # this policy (sites serving.h2d / serving.d2h); a CUDA error is
        # never transient (`resilience.is_transient`)
        self._retry = retry_policy or RetryPolicy()
        # torch writes the pool in place, so there is nothing to donate;
        # the flag is kept and reported as the JAX engine reports it
        self._donate_pool = True if donate_pool is None else bool(
            donate_pool)
        if isinstance(prefix_cache, RadixPrefixCache):
            if self._paged != isinstance(prefix_cache, PagedPrefixCache):
                raise ValueError(
                    'prefix cache layout does not match the pool: a '
                    'paged engine needs a PagedPrefixCache (and a row '
                    'engine a RadixPrefixCache)')
            self.prefix_cache: Optional[RadixPrefixCache] = prefix_cache
        elif prefix_cache:
            cache_cls = (PagedPrefixCache if self._paged
                         else RadixPrefixCache)
            self.prefix_cache = cache_cls(
                self.pool, 0.5 if prefix_cache is True
                else float(prefix_cache))
        else:
            self.prefix_cache = None
        if self.prefix_cache is not None:
            budget = (self.prefix_cache.budget_pages if self._paged
                      else self.prefix_cache.budget_slots)
            if budget < 1:
                raise ValueError(
                    'prefix cache budget rounds to zero '
                    + ('pages' if self._paged else 'slots')
                    + '; raise the fraction or the pool size (retention '
                    'must leave capacity for decode)')
        if self.prefix_cache is not None:
            self.prefix_cache.set_version(self.weight_version)
        self.draft_model = draft_model
        self.spec_k = int(num_draft_tokens)
        # a speculation round verifies [pos, pos + k]: every request needs
        # k rows past its token budget
        self._headroom = self.spec_k if draft_model is not None else 0
        self.draft_pool: Optional[SlotPool] = None
        if draft_model is not None:
            if self.spec_k < 1:
                raise ValueError('num_draft_tokens must be >= 1')
            d_pos = getattr(getattr(draft_model, 'config', None),
                            'max_position_embeddings', None)
            if d_pos is not None and max_length > d_pos:
                raise ValueError(
                    f'max_length {max_length} exceeds the DRAFT model\'s '
                    f'max_position_embeddings {d_pos}')
            if draft_model.device != self.device:
                raise ValueError(
                    f'the draft model is on {draft_model.device}, the '
                    f'engine on {self.device}')
            draft_model.eval()
            # the draft's KV: one row per slot, slot for slot with the
            # paged pool (never allocated or freed on its own)
            self.draft_pool = SlotPool(draft_model, num_slots, max_length,
                                       dtype, buckets,
                                       page_size=self.pool.page_size)
        self._draining = False
        self._drain_t0 = 0.0
        self._drain_deadline_s: Optional[float] = None
        self._preempt = None
        # observability scope of the degraded-state and weight-version
        # notes: None = the whole process; a router tags each replica's
        # engine 'replica:N'
        self.obs_scope: Optional[str] = None
        # slot -> [handle, prefill cursor, source row]: slots
        # mid-chunked-prefill (inactive for decode until the cursor
        # reaches the prompt end); the source is the retained row of a
        # row engine's prefix hit until its first chunk, else the slot
        self._prefilling: dict = {}
        n = self.pool.num_slots
        # per-slot decode state + sampling params, host-authoritative
        # (tiny arrays staged every round; the KV pages stay on device)
        self._tok = np.zeros(n, np.int64)       # pending (last emitted)
        self._pos = np.zeros(n, np.int64)       # its position
        self._active = np.zeros(n, bool)
        self._temp = np.ones(n, np.float32)
        self._topk = np.zeros(n, np.int64)
        self._topp = np.ones(n, np.float32)
        self._greedy = np.ones(n, bool)
        self._eos_arr = np.full(n, -1, np.int64)   # spec acceptance stop
        self._gens: List[Optional[torch.Generator]] = [None] * n
        self._adapter_rows = np.zeros(n, np.int32)  # 0 = base adapter
        self._slot_req: dict = {}               # slot -> RequestHandle
        self._counts = collections.Counter()
        self._seconds = collections.Counter()
        self._trace_counts = collections.Counter()
        # program name -> invocations booked in the catalog by this
        # engine (a round, a prefill, a chunk: as the JAX engine calls
        # its programs)
        self._program_calls = collections.Counter()
        self._cost = _model_cost(model, self.pool.pages[0][0].element_size())
        self._draft_cost = (None if draft_model is None else
                            _model_cost(draft_model, self.draft_pool.pages[0][
                                0].element_size()))
        arrays = (None if adapter_bank is None
                  else adapter_bank.device_arrays())
        if draft_model is None:
            self._decode = DecodeStep(
                self._fwd, self.pool.pages, n, self.pool.pages_per_slot,
                self.pool.max_length, self.decode_block, self.device,
                arrays, scales=self.pool.scales,
                compute_dtype=self.pool.compute_dtype)
            self._decode_name = ('paged_decode_step' if self._paged
                                 else 'decode_step')
        else:
            self._decode = SpecStep(
                self._fwd, self.pool.pages, n, self.pool.pages_per_slot,
                self.pool.max_length, self.spec_k, self.device,
                cached_forward(draft_model), self.draft_pool.pages, arrays,
                scales=self.pool.scales,
                compute_dtype=self.pool.compute_dtype)
            # the JAX engine's trace names (engine.py:640, 806)
            self._decode_name = ('paged_' if self._paged else '') + \
                f'spec_decode_k{self.spec_k}'
        # (kind, bucket) -> PrefillStep, built at first use
        self._prefill_steps: dict = {}
        self._prefill_pool = None       # the prefill graphs' memory pool
        # on the card the sub-step is captured at the first decode round
        # and each prefill step at its first use; False runs them
        # uncaptured there (the eager reference of the tests and
        # chip_smoke.py)
        self._capture_decode = self.device.type == 'cuda'
        self._capture_prefill = self.device.type == 'cuda'
        self._init_metrics()

    def _init_metrics(self):
        """The JAX engine's metric families (engine.py `_init_metrics`)."""
        reg = _obs.get_registry()
        self._m_requests = reg.counter(
            'paddle_serving_requests_total',
            'serving requests by lifecycle event', ('status',))
        self._m_tokens = reg.counter(
            'paddle_serving_tokens_total', 'generated tokens')
        self._m_prefills = reg.counter(
            'paddle_serving_prefills_total', 'prefills by length bucket',
            ('bucket',))
        self._m_prefill_tokens = reg.counter(
            'paddle_serving_prefill_tokens_total',
            'real (unpadded) prompt tokens prefilled')
        self._m_decode_steps = reg.counter(
            'paddle_serving_decode_steps_total',
            'single-token decode sub-steps executed')
        self._m_rounds = reg.counter(
            'paddle_serving_decode_rounds_total',
            'compiled decode-block invocations')
        self._m_slots = reg.gauge(
            'paddle_serving_slots', 'KV slot capacity')
        self._m_active = reg.gauge(
            'paddle_serving_active_slots', 'slots currently decoding')
        self._m_occupancy = reg.histogram(
            'paddle_serving_slot_occupancy',
            'occupied-slot fraction per decode round',
            buckets=_OCCUPANCY_BUCKETS)
        self._m_ttft = reg.histogram(
            'paddle_serving_ttft_seconds',
            'submit -> first token latency')
        self._m_tpot = reg.histogram(
            'paddle_serving_tpot_seconds',
            'mean inter-token latency per finished request')
        self._m_chunk_rounds = reg.counter(
            'paddle_serving_chunk_rounds_total',
            'chunked-prefill rounds executed')
        self._m_chunk_tokens = reg.counter(
            'paddle_serving_chunk_tokens_total',
            'prompt tokens prefilled via chunk rounds')
        self._m_spec_rounds = reg.counter(
            'paddle_serving_spec_rounds_total',
            'speculation rounds (draft + verify) executed')
        self._m_spec_proposed = reg.counter(
            'paddle_serving_spec_proposed_total',
            'draft tokens proposed to the verifier')
        self._m_spec_accepted = reg.counter(
            'paddle_serving_spec_accepted_total',
            'draft tokens accepted by the verifier')
        # the paddle_spec_* family, labeled by source
        self._m_spec_shared = reg.counter(
            'paddle_spec_rounds_total',
            'speculative-decode rounds by source', ('source',))
        self._m_spec_shared_prop = reg.counter(
            'paddle_spec_proposed_drafts_total',
            'draft tokens proposed by source', ('source',))
        self._m_spec_shared_acc = reg.counter(
            'paddle_spec_accepted_drafts_total',
            'draft tokens accepted by source', ('source',))
        if _obs.enabled():
            self._m_slots.set(self.pool.num_slots)

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    @staticmethod
    def _normalize_prompt(prompt) -> List[int]:
        arr = np.asarray(prompt.cpu() if isinstance(prompt, torch.Tensor)
                         else prompt)
        if arr.ndim == 2 and arr.shape[0] == 1:
            arr = arr[0]
        if arr.ndim != 1 or arr.size < 1:
            raise ValueError(
                f'prompt must be a non-empty 1-D token sequence, got '
                f'shape {arr.shape}')
        return [int(t) for t in arr]

    def submit(self, prompt, params: Optional[SamplingParams] = None,
               priority: Optional[int] = None,
               adapter_id: Optional[str] = None, **kwargs) -> RequestHandle:
        """Queue one request; returns its live handle. Validation errors
        raise here. `adapter_id` decodes the request under that LoRA
        adapter of the engine's bank (None = base model); an adapter the
        bank neither holds nor can load from its store raises
        `AdapterUnavailable` here. A draining engine refuses every new
        request (RuntimeError)."""
        if params is None:
            params = SamplingParams(**kwargs)
        elif kwargs:
            raise TypeError('pass params= or keyword sampling args, '
                            'not both')
        if adapter_id is not None:
            if self.adapter_bank is None:
                raise ValueError(
                    f'adapter_id={adapter_id!r} needs an engine built '
                    f'with adapter_bank=')
            if not self.adapter_bank.available(adapter_id):
                raise AdapterUnavailable(
                    adapter_id, 'not resident and no servable store '
                                'version')
        self._check_drain()
        if self._draining:
            if _obs.enabled():
                self._m_requests.labels(status='rejected').inc()
            raise RuntimeError(
                'engine is draining (preemption signal received): not '
                'admitting new requests')
        toks = self._normalize_prompt(prompt)
        self.pool.bucket_for(len(toks))   # raises when no bucket fits
        headroom = self._headroom
        if len(toks) + params.max_new_tokens + headroom \
                > self.pool.max_length:
            raise ValueError(
                f'prompt ({len(toks)}) + max_new_tokens '
                f'({params.max_new_tokens})'
                + (f' + speculation headroom ({headroom})' if headroom
                   else '')
                + f' exceeds the slot length ({self.pool.max_length})')
        h = RequestHandle(toks, params, engine=self)
        h.adapter_id = adapter_id
        if priority is not None:
            h.priority = int(priority)
        h._eos = int(self.eos_token_id if params.eos_token_id is None
                     else params.eos_token_id)
        self._counts['submitted'] += 1
        if _obs.enabled():
            self._m_requests.labels(status='submitted').inc()
            # queue span: begins now, ends at admission; request_id is
            # the trace id every span and event of the request carries
            h._queue_span = _obs.Span('serving.queue',
                                      request_id=h.request_id).begin()
        if _reqledger.enabled():
            rec = _reqledger.get_ledger().open_for(h)
            if rec is not None:
                rec.queue_enter(h._t_submit, 'priority_queued')
        self.scheduler.submit(h)
        return h

    # ------------------------------------------------------------------
    # the iteration loop
    # ------------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self._slot_req) or self.scheduler.queue_depth > 0

    def step(self) -> int:
        """One scheduler iteration: admit queued requests into free slots
        (prefilling the whole ones), advance every mid-prefill slot one
        chunk, then advance every active slot one decode round (one
        speculation round with a draft model). Returns the number of
        requests that progressed."""
        self._check_drain()
        self._admit()
        self._advance_prefills()
        n = len(self._slot_req)
        if not np.any(self._active):
            return n            # chunk-prefill-only progress this round
        t0 = time.perf_counter()
        if self.draft_model is not None:
            toks, counts = self._spec_round()
        else:
            toks, counts = self._decode_round(), None
        now = time.perf_counter()
        self._seconds['decode'] += now - t0
        # the ledger before the emission loop, so the round that produced
        # a request's first token lands in its TTFT sub-book (mark_first
        # fires in _emit): every active participant waited the round's
        # whole wall (waterfall), and the wall splits evenly (fair share)
        _reqledger.get_ledger().note_round(
            now - t0, [h._ledger_rec for slot, h in self._slot_req.items()
                       if self._active[slot]],
            'spec_verify' if self.draft_model is not None else 'decode',
            now=now, absorb=True)
        self._counts['decode_rounds'] += 1
        if _obs.enabled():
            self._m_rounds.inc()
            self._m_occupancy.observe(self.pool.occupancy)
            self._m_tokens.inc(0)   # the family exists even idle
        for slot, h in list(self._slot_req.items()):
            if not self._active[slot]:
                continue            # mid-chunked-prefill: no tokens yet
            c = self.decode_block if counts is None else int(counts[slot])
            if counts is not None and self._greedy[slot]:
                self._counts['spec_proposed'] += self.spec_k
                self._counts['spec_accepted'] += c - 1
                if _obs.enabled():
                    self._m_spec_proposed.inc(self.spec_k)
                    self._m_spec_accepted.inc(c - 1)
                    self._m_spec_shared_prop.labels(
                        source='engine').inc(self.spec_k)
                    self._m_spec_shared_acc.labels(
                        source='engine').inc(c - 1)
            done = False
            emitted = 0
            first = not h.tokens
            for j in range(c):
                t = int(toks[slot, j])
                h._emit(t, now)
                emitted += 1
                if len(h.tokens) >= h.params.max_new_tokens or t == h._eos:
                    done = True
                    break
            self._counts['tokens'] += emitted
            if _obs.enabled():
                self._m_tokens.inc(emitted)
                if first:
                    self._m_ttft.observe(h.ttft)
            if done:
                self._retire(slot, h, now)
            else:
                self._tok[slot] = toks[slot, c - 1]
                self._pos[slot] += c
                self.pool.note_written(slot, self._pos[slot] + 1)
        return n

    def _decode_round(self) -> np.ndarray:
        """`decode_block` paged sub-steps over every slot; returns the
        [num_slots, decode_block] tokens. The `serving.decode_round` span
        holds the fetch, which waits for the round."""
        cost = self._round_cost() if _obs.enabled() else None
        t0 = time.perf_counter()
        with _obs.span('serving.decode_round',
                       slots=len(self._slot_req),
                       requests=[h.request_id
                                 for h in self._slot_req.values()]):
            with torch.inference_mode():
                toks = self._fetch(self._queue_round())
        self._book_program(self._decode_name, time.perf_counter() - t0,
                           cost)
        _obs.note_progress('decode')   # /healthz decode liveness beat
        self._counts['decode_steps'] += self.decode_block
        if _obs.enabled():
            self._m_decode_steps.inc(self.decode_block)
        return toks

    def _spec_round(self) -> tuple:
        """One speculation round over every slot (`SpecStep`): returns the
        host ([num_slots, k + 1] tokens, [num_slots] accepted counts + 1).
        The `serving.spec_round` span holds the fetch, which waits for the
        round. One verify pass: one decode step."""
        cost = self._round_cost() if _obs.enabled() else None
        t0 = time.perf_counter()
        with _obs.span('serving.spec_round',
                       slots=len(self._slot_req), k=self.spec_k,
                       requests=[h.request_id
                                 for h in self._slot_req.values()]):
            with torch.inference_mode():
                toks, counts = self._queue_round()
                toks, counts = self._fetch(toks), self._fetch(counts)
        self._book_program(self._decode_name, time.perf_counter() - t0,
                           cost)
        _obs.note_progress('decode')
        self._counts['decode_steps'] += 1
        self._counts['spec_rounds'] += 1
        if _obs.enabled():
            self._m_decode_steps.inc(1)
            self._m_spec_rounds.inc()
            self._m_spec_shared.labels(source='engine').inc()
        return toks, counts

    def _fetch(self, x: torch.Tensor) -> np.ndarray:
        """A round's device buffer on the host (waits for the round),
        retried under the engine's policy at site serving.d2h."""
        return call_with_retry(_from_device, x, policy=self._retry,
                               site='serving.d2h')

    def _stage(self, step, **host) -> None:
        """`step.stage(**host)`, retried under the engine's policy at site
        serving.h2d."""
        call_with_retry(_to_device, step, policy=self._retry,
                        site='serving.h2d', **host)

    def _queue_round(self):
        """Stage the round's host state (`_stage_round`) and queue it
        (`DecodeStep.run`, or `SpecStep.run` with a draft model); returns
        the device [num_slots, decode_block] token buffer, or with a
        draft model the ([num_slots, k + 1] tokens, [num_slots] counts)
        buffers."""
        return self._stage_round().run(self._active & ~self._greedy,
                                       self._gens)

    def _stage_round(self) -> DecodeStep:
        """Stage the round's host state into the sub-step's (or the
        speculation round's) static buffers; returns the step. Inactive
        slots have their table row redirected to the null page, so their
        writes land nowhere real. Captures the step first when this is
        the engine's first round on the card."""
        step = self._decode
        if self._capture_decode and step.graph is None:
            self._capture(self._decode_name, step.capture)
        staged = dict(
            tok=self._tok, pos=self._pos, active=self._active,
            table=np.where(self._active[:, None], self.pool.page_table, 0),
            temp=self._temp, topk=self._topk, topp=self._topp)
        if self.adapter_bank is not None:
            staged['rows'] = self._adapter_rows
        if self.draft_model is not None:
            staged.update(eos=self._eos_arr, greedy=self._greedy,
                          d_table=self.draft_pool.table)
        self._stage(step, **staged)
        return step

    def run(self) -> int:
        """Drive until queue and slots drain; returns iterations."""
        rounds = 0
        while self.has_work:
            self.step()
            rounds += 1
        return rounds

    def stream(self, handle: RequestHandle):
        """Per-token iterator for one request (see RequestHandle.stream)."""
        return handle.stream()

    def generate_many(self, prompts, params=None,
                      adapter_ids=None) -> List[RequestHandle]:
        """Submit a batch of prompts and drain the engine. `params` is one
        SamplingParams for all, or one per prompt; `adapter_ids` is one
        adapter id (or None) for all, or one per prompt."""
        if params is None or isinstance(params, SamplingParams):
            params = [params or SamplingParams()] * len(prompts)
        if len(params) != len(prompts):
            raise ValueError('one SamplingParams per prompt')
        if adapter_ids is None or isinstance(adapter_ids, str):
            adapter_ids = [adapter_ids] * len(prompts)
        if len(adapter_ids) != len(prompts):
            raise ValueError('one adapter id (or None) per prompt')
        handles = [self.submit(p, sp, adapter_id=aid)
                   for p, sp, aid in zip(prompts, params, adapter_ids)]
        self.run()
        return handles

    # ------------------------------------------------------------------
    # graceful drain (preemption) and eviction
    # ------------------------------------------------------------------
    @property
    def draining(self) -> bool:
        return self._draining

    def enable_graceful_drain(self, handler=None, deadline_s: float = 30.0,
                              signals=None):
        """Wire a `resilience.PreemptionHandler` into the engine: once it
        is flagged (SIGTERM by default, the eviction grace window),
        `submit` refuses new requests, every accepted request, queued or
        in flight, still finishes, and `drain()` bounds that by
        `deadline_s`. Pass a ready handler to share one; returns the
        handler in use."""
        if handler is None:
            import signal as _signal
            from ..resilience.preemption import PreemptionHandler
            handler = PreemptionHandler(
                signals=signals or (_signal.SIGTERM,)).install()
        self._preempt = handler
        self._drain_deadline_s = float(deadline_s)
        return handler

    def _check_drain(self):
        if (not self._draining and self._preempt is not None
                and self._preempt.requested):
            self._begin_drain()

    def begin_drain(self):
        """Stop admitting new submissions now, without driving decode:
        the non-blocking half of `drain()`; later `step()`s finish the
        accepted requests."""
        self._begin_drain()

    def _begin_drain(self):
        if self._draining:
            return
        self._draining = True
        self._drain_t0 = time.monotonic()
        info = {'queued': self.scheduler.queue_depth,
                'in_flight': len(self._slot_req)}
        # /healthz is 503 from here on: the engine is leaving the pool
        _obs.note_degraded('draining', info, scope=self.obs_scope)
        _obs.emit('serving_drain_begin', **info)

    def _fail_remaining(self, exc: BaseException):
        """Fail every accepted request, queued and in flight, with `exc`
        (a drain past its deadline), freeing their slots."""
        for h in self.scheduler.drain():
            h._fail(exc)
            self._counts['failed'] += 1
            if _obs.enabled():
                self._m_requests.labels(status='failed').inc()
        for slot, h in list(self._slot_req.items()):
            self._fail_request(slot, h, exc)
        if _obs.enabled():
            self._m_active.set(len(self._slot_req))

    def evict_all(self) -> List[RequestHandle]:
        """Take every accepted request, queued and in flight, out of the
        engine without failing it, and return the handles (queued first,
        then by slot): the failover hand-off, whose orphans are submitted
        elsewhere. Their slots and pages are freed; the engine stays
        serviceable."""
        out = self.scheduler.drain()
        for slot, h in list(self._slot_req.items()):
            self._detach_slot(slot, h)
            self.pool.free(slot)
            out.append(h)
        for h in out:
            if h._queue_span is not None:   # no open queue span leaks
                h._queue_span.end()
                h._queue_span = None
        if _obs.enabled():
            self._m_active.set(len(self._slot_req))
        return out

    def drain(self, deadline_s: Optional[float] = None) -> bool:
        """Stop admitting new submissions and drive decode until every
        accepted request (queued and in flight) finishes, bounded by the
        deadline (default: `enable_graceful_drain`'s; None = no bound).
        Past the deadline the stragglers FAIL with a TimeoutError rather
        than being dropped silently. Returns True when everything
        finished in time. /healthz stays `draining` afterwards (the
        process is expected to exit; `clear_degraded('draining')` takes
        it back)."""
        if deadline_s is None:
            deadline_s = self._drain_deadline_s
        self._begin_drain()
        timed_out = False
        # the drain span books this window as `preemption_drain` in the
        # goodput ledger, minus the nested decode/prefill spans, which
        # stay productive serving time
        with _obs.span('serving.drain'):
            while self.has_work:
                if deadline_s is not None and \
                        time.monotonic() - self._drain_t0 > deadline_s:
                    timed_out = True
                    self._fail_remaining(TimeoutError(
                        f'drain deadline {deadline_s}s exceeded'))
                    break
                self.step()
        _obs.emit('serving_drain_complete',
                  timed_out=timed_out,
                  seconds=round(time.monotonic() - self._drain_t0, 3))
        return not timed_out

    # ------------------------------------------------------------------
    # weight swaps (the trainer-to-serving hot swap)
    # ------------------------------------------------------------------
    def _require_drained(self, what: str):
        if self._slot_req or self.scheduler.queue_depth > 0:
            raise RuntimeError(
                f'{what} requires a drained engine, but '
                f'{len(self._slot_req)} slot(s) are decoding and '
                f'{self.scheduler.queue_depth} request(s) are queued '
                f'(drain through the router/updater first)')

    def _live_tensors(self) -> list:
        """(name, tensor, kind, required) of every parameter and buffer of
        the model: a swap must name each parameter; buffers may be
        absent and keep their values."""
        out = [(name, t, 'parameter' if t.requires_grad
                else 'frozen parameter', True)
               for name, t in self.model.named_parameters()]
        out += [(name, t, 'buffer', False)
                for name, t in self.model.named_buffers()]
        return out

    def swap_weights(self, state, *, version: int, strict: bool = True):
        """Replace the model's weights with a published snapshot
        (``{name: array}`` as `state_dict()` gives it: numpy arrays or
        tensors), in place, on a drained engine (no queued or in-flight
        request: that is what makes the per-request `weight_version` a
        whole-response guarantee).

        Every value is checked against its live tensor's shape before
        anything is written (a refused swap changes nothing), then cast
        to its dtype and copied into it under `torch.no_grad()`. The
        parameters keep their storage, which is what every captured CUDA
        graph reads, so nothing is captured again (`stats()['traces']`
        does not move). `strict=True` demands every parameter; buffers
        may be absent and keep their values. The draft model of a
        speculating engine is not swapped, unless it is the model itself.

        Returns the previous weights as a token for `restore_weights`: a
        host (CPU) copy of every swapped tensor and the previous version
        (the JAX engine keeps its old device arrays by reference; an
        in-place copy cannot)."""
        self._require_drained('swap_weights')
        staged = []
        for name, live, kind, required in self._live_tensors():
            if name not in state:
                if strict and required:
                    raise KeyError(f'published weights missing {kind} '
                                   f'{name!r}: refusing a partial swap')
                continue
            new = _host_tensor(state[name])
            if tuple(new.shape) != tuple(live.shape):
                raise ValueError(
                    f'{kind} {name!r} shape {tuple(new.shape)} does not '
                    f'match the live tensor {tuple(live.shape)}: swapping '
                    f'it would change the shapes every captured graph was '
                    f'recorded at')
            staged.append((name, live, new))
        prev = ({name: live.detach().to('cpu', copy=True)
                 for name, live, _ in staged}, self.weight_version)
        self._copy_weights((live, new) for _, live, new in staged)
        self._set_weight_version(version)
        return prev

    def restore_weights(self, prev):
        """Roll back to the weights `swap_weights` returned `prev` for,
        copying its host copy back in place (a drained engine only). The
        prefix cache's entries of the restored version serve again (they
        were never flushed, only shadowed)."""
        self._require_drained('restore_weights')
        host, version = prev
        live = dict((name, t) for name, t, _, _ in self._live_tensors())
        self._copy_weights((live[name], t) for name, t in host.items())
        self._set_weight_version(version)

    def _copy_weights(self, pairs):
        with torch.no_grad():
            for live, new in pairs:
                live.copy_(new)
        self._sync()

    def _set_weight_version(self, version: int):
        self.weight_version = int(version)
        if self.prefix_cache is not None:
            # no flush: entries of other versions go stale and are
            # reclaimed lazily; this version's survivors serve again
            self.prefix_cache.set_version(self.weight_version)
        _obs.note_weight_version(self.weight_version,
                                 scope=self.obs_scope)
        if _obs.enabled():
            _obs.get_registry().gauge(
                'paddle_weight_version',
                'live weight version per serving scope',
                ('scope',)).labels(
                    scope=self.obs_scope or 'engine').set(
                        self.weight_version)

    # ------------------------------------------------------------------
    # admission / retirement
    # ------------------------------------------------------------------
    def _admission_cost(self, prompt_len: int) -> int:
        """Prefill cost charged against the scheduler's per-iteration
        budget: with chunking, one chunk bucket this round (the rest
        spreads over later rounds); without, the whole prompt's
        bucket."""
        if self.prefill_chunk_tokens:
            prompt_len = min(prompt_len, self.prefill_chunk_tokens)
        return self.pool.bucket_for(prompt_len)

    def _requeue_blocked(self, handles, reason: str):
        """Requeue `handles` at the queue front in their order (first
        submit time kept) and sample the blocking reason into each one's
        ledger record: the queue time since its last mark books under the
        reason just observed, and a new interval opens."""
        now = time.perf_counter()
        for h in handles:
            rec = h._ledger_rec
            if rec is not None:
                if rec._q_mark is None and now > rec._last_touch:
                    # this handle reached _begin_request (queue_exit ran)
                    # before the seat aborted: the aborted seating work
                    # (a store load that found the bank full, the page
                    # reservation walk) is admission time, not residual
                    rec.add('admission', now - rec._last_touch, now=now)
                rec.queue_block(now, reason)
        for back in reversed(handles):
            self.scheduler.requeue(back)
        self._counts['requeued'] += len(handles)

    def _effective_free(self) -> int:
        """Slots admissible now: the free list, and in a row engine the
        zero-ref retained prefixes the pool can reclaim on demand (the
        JAX `_effective_free`). Paged retention pins pages, not slots, so
        there the free list is the truth and page pressure surfaces at
        reservation."""
        free = self.pool.free_count
        if self.prefix_cache is not None and not self._paged:
            free += self.prefix_cache.reclaimable_count
        return free

    def _alloc_slot(self) -> int:
        """`pool.alloc()`; in a row engine whose free list is empty the
        least recently used zero-ref retained prefix yields its slot
        first. Raises RuntimeError when nothing is free."""
        if (not self._paged and self.pool.free_count == 0
                and self.prefix_cache is not None):
            self.prefix_cache.evict_lru()
        return self.pool.alloc()

    def _admit(self):
        admitted = self.scheduler.admissible(self._effective_free(),
                                             self._admission_cost)
        for idx, h in enumerate(admitted):
            try:
                slot = self._alloc_slot()
            except RuntimeError:
                # the reclaimable slot this batch was promised has been
                # pinned since (a sibling admission hit its prefix): not
                # a failure; this handle and the rest of the batch go
                # back to the queue front in order
                self._requeue_blocked(admitted[idx:], 'pool_exhausted')
                break
            try:
                self._begin_request(slot, h)
            except AdapterUnavailable as exc:
                if exc.transient:
                    # the bank is full of pinned slots: pins free as
                    # in-flight requests retire, so this is back-pressure,
                    # not a failure. Requeue this handle alone at the queue
                    # front and keep admitting the rest
                    self.pool.free(slot)
                    _obs.emit('adapter_bank_saturated',
                              request_id=h.request_id,
                              adapter_id=h.adapter_id, detail=str(exc))
                    self._requeue_blocked([h], 'adapter_pinned')
                    continue
                # evicted since submit, or nothing servable in its store:
                # a request-level failure; the engine keeps serving
                # everyone else
                self._fail_request(slot, h, exc, event=True)
                continue
            except PagePoolExhausted as exc:
                # not a failure: free the slot (which drops any attached
                # prefix pages) and send this handle and everything
                # behind it back to the queue front in order; pages free
                # up as in-flight requests retire
                self.pool.free(slot)
                _obs.emit('page_pool_exhausted', request_id=h.request_id,
                          queued=self.scheduler.queue_depth,
                          detail=str(exc))
                self._requeue_blocked(admitted[idx:], 'pool_exhausted')
                break
            except Exception as exc:
                # a request-level failure (the JAX engine's _admit): fail
                # this handle, keep serving everyone else
                if _device_fault(exc):
                    raise
                self._fail_request(slot, h, exc, event=True)
        if _obs.enabled():
            self._m_active.set(len(self._slot_req))

    def _prefix_ns(self, h: RequestHandle):
        """The prefix-cache namespace of this request's KV: an adapter
        request's prefill KV holds its LoRA deltas, so it is keyed on
        (adapter_id, adapter_version); base requests share None."""
        if h.adapter_id is None:
            return None
        return (h.adapter_id, h.adapter_version)

    def _seat_paged(self, slot: int, h: RequestHandle, s: int) -> tuple:
        """Attach the longest page-aligned cached prefix read-only, then
        reserve every page the request can touch (prompt + token budget
        + speculation headroom) all-or-nothing, reclaiming zero-ref cache
        holds under pressure; on a full-prompt hit split off the page of
        the last prompt row.
        Raises PagePoolExhausted with the prefix node released (the
        caller frees the slot, which drops the attached pages). Returns
        (node, cursor): cursor is the page-aligned count of prefix rows
        seated; the suffix [cursor, s) prefills into fresh pages."""
        ps = self.pool.page_size
        node, cursor = None, 0
        if self.prefix_cache is not None:
            t_pfx = time.perf_counter()
            node, matched = self.prefix_cache.lookup(
                h.prompt_tokens, namespace=self._prefix_ns(h))
            if node is not None:
                # whole pages only: no suffix or decode write ever falls
                # in a shared page
                cursor = (min(matched, node.slot.kv_len) // ps) * ps
                if cursor < 1:
                    node = None
                else:
                    self.prefix_cache.acquire(node)
            if h._ledger_rec is not None:
                t1 = time.perf_counter()
                h._ledger_rec.add('prefix_lookup', t1 - t_pfx, now=t1)
        try:
            if node is not None:
                self.pool.attach_prefix(slot, node.slot, cursor // ps)
            self._reserve_pages(slot, min(
                s + h.params.max_new_tokens + self._headroom,
                self.pool.max_length))
            if cursor >= s:
                # full hit: the pending-token re-forward at s - 1 writes
                # into the last shared page; copy-on-write it first
                while True:
                    try:
                        if self.pool.ensure_exclusive(slot, s - 1):
                            _obs.emit('paged_cow', slot=slot,
                                      request_id=h.request_id, pos=s - 1)
                        break
                    except PagePoolExhausted:
                        if self.prefix_cache is None or \
                                not self.prefix_cache.evict_lru():
                            raise
        except PagePoolExhausted:
            if node is not None:
                self.prefix_cache.release(node)
            raise
        return node, cursor

    def _seat_row(self, h: RequestHandle) -> tuple:
        """A row engine's prefix lookup (the JAX `_begin_request`'s row
        branch): the longest cached prefix, acquired, and its length,
        which need not be page-aligned (the retained row is read, never
        shared). Returns (node, matched), or (None, 0)."""
        if self.prefix_cache is None:
            return None, 0
        t_pfx = time.perf_counter()
        node, matched = self.prefix_cache.lookup(
            h.prompt_tokens, namespace=self._prefix_ns(h))
        if node is not None:
            self.prefix_cache.acquire(node)
        if h._ledger_rec is not None:
            t1 = time.perf_counter()
            h._ledger_rec.add('prefix_lookup', t1 - t_pfx, now=t1)
        return node, matched

    def _reserve_pages(self, slot: int, total: int):
        """`PagedSlotPool.reserve`, with zero-ref cache holds yielding
        their pages LRU-first until the reservation fits or nothing is
        left to evict."""
        while True:
            try:
                self.pool.reserve(slot, total)
                return
            except PagePoolExhausted:
                if self.prefix_cache is None or \
                        not self.prefix_cache.evict_lru():
                    raise

    def _begin_request(self, slot: int, h: RequestHandle):
        """Seat `h` in `slot`: pin its adapter (before the lookup: the
        namespace needs the version it decodes under), attach its cached
        prefix and reserve its pages, then prefill nothing (full hit),
        the whole prompt (short and cold), or enter the chunked-prefill
        state machine (a suffix, or a long prompt). Raises
        AdapterUnavailable or PagePoolExhausted with nothing of the
        request left in the engine; `_admit` fails the request on any
        other exception (`_fail_request`)."""
        t_adm0 = time.perf_counter()
        rec = h._ledger_rec
        pfx0 = 0.0
        if rec is not None:
            rec.queue_exit(t_adm0)   # queue_wait ends; admission begins
            pfx0 = rec.phases['prefix_lookup']
        s = len(h.prompt_tokens)
        self._pin_adapter(slot, h)
        src = slot
        if self._paged:
            try:
                node, cursor = self._seat_paged(slot, h, s)
            except PagePoolExhausted:
                self._unpin_adapter(slot, h)
                raise
        else:
            node, cursor = self._seat_row(h)
            if node is not None:
                src = node.slot
        if node is not None:
            h._prefix_node = node
            h._prefix_len = cursor
        if h._queue_span is not None:
            h._queue_span.end()   # admission closes the queue span
            h._queue_span = None
        self._slot_req[slot] = h
        h.status = RUNNING
        # stamped once, here: a swap needs a drained engine, so every
        # token of this request decodes under this version
        h.weight_version = self.weight_version
        if rec is not None:
            # admission = seating work since queue exit, minus the
            # prefix-lookup seconds already booked inside this window
            t1 = time.perf_counter()
            rec.add('admission', (t1 - t_adm0)
                    - (rec.phases['prefix_lookup'] - pfx0), now=t1)
        if node is not None:
            _obs.emit('prefix_hit', request_id=h.request_id,
                      matched=h._prefix_len, prompt_len=s, slot=slot)
        if cursor >= s:
            # full hit: nothing to prefill. A row engine copies the
            # retained row; a paged one shares its pages already. The
            # first decode round re-forwards the last prompt token
            if not self._paged:
                self.pool.copy_slot(src, slot)
            self.pool.note_written(slot, s)
            self._activate(slot, h)
            return
        chunk = self.prefill_chunk_tokens
        if cursor == 0 and (chunk is None or s <= chunk):
            self._whole_prefill(slot, h)
            self._activate(slot, h)
            return
        # a suffix or a long prompt: one bucket-shaped chunk per step
        # from the cursor (the first in this step's _advance_prefills);
        # parked until then, inactive for decode, its position at the
        # last row
        self._pos[slot] = self.pool.max_length - 1
        self._tok[slot] = 0
        self._active[slot] = False
        self._prefilling[slot] = [h, cursor, src]
        self._counts['chunked_prefills'] += 1

    def _prefill_step(self, kind: str, bucket: int) -> PrefillStep:
        """The `PrefillStep` of (kind, bucket), built at its first use and,
        on the card, captured then (counted in `traces` under the JAX
        engine's name, once)."""
        step = self._prefill_steps.get((kind, bucket))
        if step is None and kind == 'draft':
            step = self._prefill_steps[(kind, bucket)] = PrefillStep(
                kind, bucket, self.draft_model, self.draft_pool.pages,
                self.draft_pool.pages_per_slot, self.device,
                kv_dtype=self.draft_pool.compute_dtype)
        elif step is None:
            step = self._prefill_steps[(kind, bucket)] = PrefillStep(
                kind, bucket, self.model, self.pool.pages,
                self.pool.pages_per_slot, self.device,
                None if self.adapter_bank is None
                else self.adapter_bank.device_arrays(),
                scales=self.pool.scales, paged=self._paged,
                kv_dtype=self.pool.compute_dtype)
        if self._capture_prefill and step.graph is None:
            if self._prefill_pool is None:
                self._prefill_pool = torch.cuda.graph_pool_handle()
            self._capture(step.name,
                          lambda: step.capture(self._prefill_pool))
        return step

    def preload_programs(self) -> dict:
        """Capture now, before any request, every graph this engine can
        replay: the decode sub-step (or the speculation round) and a
        prefill graph at every bucket of each kind it may run (whole;
        chunk when it chunks or caches prefixes; draft with a draft
        model). The counterpart of the JAX engine's `preload_programs`,
        which loads its persisted executables from the program store: a
        replica process calls it before it binds its socket, so its
        serving window captures nothing. Returns `stats()['traces']`
        after (empty where nothing is captured, as on the CPU)."""
        kinds = ['whole']
        if self.prefill_chunk_tokens or self.prefix_cache is not None:
            kinds.append('chunk')
        if self.draft_model is not None:
            kinds.append('draft')
        with torch.inference_mode():
            if self._capture_decode and self._decode.graph is None:
                self._capture(self._decode_name, self._decode.capture)
            if self._capture_prefill:
                for kind in kinds:
                    for bucket in self.pool.buckets:
                        self._prefill_step(kind, bucket)
        self._sync()
        return dict(self._trace_counts)

    def _capture(self, key: str, capture):
        """Run `capture()` (a graph capture), count it in `traces` under
        `key` and book it in the program catalog: its seconds as the
        program's compile and what it added to the memory pool as its
        peak memory."""
        t0 = time.perf_counter()
        m0 = torch.cuda.memory_reserved(self.device)
        capture()
        dt = time.perf_counter() - t0
        self._seconds['capture'] += dt
        self._trace_counts[key] += 1
        if _obs.enabled():
            cat = _cost.get_catalog()
            name = program_name(key)
            cat.note_compile(name, dt, kind='serving')
            cat.note_memory(name, max(
                torch.cuda.memory_reserved(self.device) - m0, 0),
                kind='serving')

    def _book_program(self, key: str, seconds: float, cost):
        """Book one call of the program of `key` in the catalog: its host
        wall and its analytic (FLOPs, bytes); `cost` is None while
        observability is off (nothing is booked then)."""
        name = program_name(key)
        self._program_calls[name] += 1
        if cost is not None and _obs.enabled():
            cat = _cost.get_catalog()
            cat.note_invocation(name, seconds, kind='serving')
            cat.note_cost(name, *cost, kind='serving')

    def _round_cost(self) -> tuple:
        """Analytic (FLOPs, bytes) of the round about to run, from the
        staged positions: every slot's row runs the matmuls (the batch is
        static), each active slot attends its keys so far at each
        sub-step, and a speculation round adds k draft sub-steps and a
        verify of k + 1 rows per slot."""
        n = self.pool.num_slots
        last = self.pool.max_length - 1
        pos = self._pos[self._active].astype(np.int64)

        def keys(t: int) -> int:     # keys of every active slot's row t
            return int(np.minimum(pos + t, last).sum()) + pos.size
        if self.draft_model is None:
            steps = [self._cost.forward(n, keys(j), keys(j), n)
                     for j in range(self.decode_block)]
        else:
            k = self.spec_k
            steps = [self._draft_cost.forward(n, keys(j), keys(j), n)
                     for j in range(k)]
            steps.append(self._cost.forward(
                n * (k + 1), sum(keys(t) for t in range(k + 1)), keys(k),
                n * (k + 1)))
        return (sum(f for f, _ in steps), sum(b for _, b in steps))

    def _prefill_cost(self, kind: str, bucket: int, start: int) -> tuple:
        """Analytic (FLOPs, bytes) of one prefill at `bucket` rows: causal
        attention over the bucket, a chunk's rows also over the `start`
        rows before it; no LM head (a prefill writes K/V only)."""
        cost = self._draft_cost if kind == 'draft' else self._cost
        keys = bucket * start + bucket * (bucket + 1) // 2
        return cost.forward(bucket, keys, start, bucket, head=False)

    def _run_prefill(self, slot: int, kind: str, window, bucket: int,
                     **staged):
        """Stage the right-padded `window` of prompt tokens, the slot's
        table row (for 'draft' its draft row's identity row), its bank
        row (with a bank, not for 'draft') and `staged` into the (kind,
        bucket) step and run it; returns when the device is done (the
        prefill's wall is timed over it)."""
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :len(window)] = window
        table = (self.draft_pool.table if kind == 'draft'
                 else self.pool.page_table)[slot:slot + 1]
        if self.adapter_bank is not None and kind != 'draft':
            staged['rows'] = self._adapter_rows[slot:slot + 1]
        t0 = time.perf_counter()
        with torch.inference_mode():
            step = self._prefill_step(kind, bucket)
            self._stage(step, ids=ids, table=table, **staged)
            step.run_once()
        if kind == 'draft':
            self.draft_pool.note_row_write()
        elif not self._paged:
            self.pool.note_row_write()
        self._sync()
        self._book_program(step.name, time.perf_counter() - t0,
                           self._prefill_cost(kind, bucket,
                                              int(staged.get('start', 0)))
                           if _obs.enabled() else None)

    def _whole_prefill(self, slot: int, h: RequestHandle):
        """Prefill the right-padded prompt bucket through the causal flash
        kernel and scatter its K/V rows into the slot's pages (pad rows
        past the reservation fall on the null page), through the whole
        `PrefillStep` of its bucket. No logits: the first token comes
        from the next decode round, which re-forwards the last prompt
        token at position s - 1."""
        s = len(h.prompt_tokens)
        bucket = self.pool.bucket_for(s)
        t0 = time.perf_counter()
        with _obs.span('serving.prefill', request_id=h.request_id,
                       bucket=bucket, slot=slot, prompt_len=s):
            self._run_prefill(slot, 'whole', h.prompt_tokens, bucket)
        self._seconds['prefill'] += time.perf_counter() - t0
        self.pool.note_written(slot, s)
        self._note_prefill(h, t0)
        self._counts['prefills'] += 1
        self._counts['prefill_tokens'] += s
        self._counts['prefill_bucket_tokens'] += bucket
        if _obs.enabled():
            self._m_prefills.labels(bucket=bucket).inc()
            self._m_prefill_tokens.inc(s)

    def _note_prefill(self, h: RequestHandle, t0: float):
        """Ledger: the prefill that just ran (since `t0`) books as
        `prefill` for its owner and `prefill_wait` for every other seated
        request: the chunked-prefill convoy, named instead of smeared."""
        now = time.perf_counter()
        _reqledger.get_ledger().note_prefill(
            now - t0, h._ledger_rec,
            [o._ledger_rec for o in self._slot_req.values()], now=now)

    def _advance_prefills(self):
        """Drive every mid-prefill slot forward one chunk (in admission
        order). A slot whose cursor reaches the prompt end activates for
        decode in the same step."""
        for slot in list(self._prefilling):
            h, cursor, _ = self._prefilling[slot]
            try:
                self._prefill_chunk(slot, h, cursor)
            except Exception as exc:
                if _device_fault(exc):
                    raise
                self._fail_request(slot, h, exc, event=True)

    def _prefill_chunk(self, slot: int, h: RequestHandle, cursor: int):
        """Prefill the prompt window [start, start + bucket) of `slot`
        through the chunk `PrefillStep` of its bucket (the chunk forward,
        `LlamaForCausalLM.prefill_kv` with the pool's pages): the chunk of
        up to `prefill_chunk_tokens` tokens from the cursor, at its length
        bucket. A window whose bucket would overrun the slot shifts its
        start down and forwards rows below the cursor again. In a paged
        engine the floor (the attach boundary) keeps those writes out of
        the shared pages. In a row engine the first chunk of a prefix hit
        reads the retained row (the source in `_prefilling`; its rows
        below the window are copied into the slot's row first) and writes
        only the slot's row; every write then stays in the slot's own row,
        so the floor is 0."""
        s = len(h.prompt_tokens)
        src = self._prefilling[slot][2]
        c = min(self.prefill_chunk_tokens or s, s - cursor)
        bucket = self.pool.bucket_for(c)
        start = min(cursor, self.pool.max_length - bucket)
        t0 = time.perf_counter()
        with _obs.span('serving.prefill_chunk', request_id=h.request_id,
                       bucket=bucket, slot=slot, start=start,
                       cursor=cursor, prompt_len=s):
            if src != slot:
                self.pool.copy_rows(src, slot, start)
                self._prefilling[slot][2] = slot
            self._run_prefill(slot, 'chunk',
                              h.prompt_tokens[start:start + bucket],
                              bucket, start=start,
                              floor=h._prefix_len if self._paged else 0)
        self._seconds['prefill'] += time.perf_counter() - t0
        new_cursor = min(start + bucket, s)
        self.pool.note_written(slot, new_cursor)
        self._note_prefill(h, t0)
        self._prefilling[slot][1] = new_cursor
        self._counts['chunk_rounds'] += 1
        self._counts['prefill_tokens'] += new_cursor - cursor
        self._counts['prefill_bucket_tokens'] += bucket
        if _obs.enabled():
            self._m_chunk_rounds.inc()
            self._m_chunk_tokens.inc(new_cursor - cursor)
            self._m_prefill_tokens.inc(new_cursor - cursor)
        if new_cursor >= s:
            del self._prefilling[slot]
            self._activate(slot, h)

    def _activate(self, slot: int, h: RequestHandle):
        """Arm the slot for decode: the pending token is the last prompt
        token at position s - 1. With a draft model the prompt is
        prefilled into the slot's draft row first."""
        p = h.params
        if self.draft_model is not None:
            self._draft_prefill(slot, h)
        greedy = p.strategy == GREEDY
        self._tok[slot] = h.prompt_tokens[-1]
        self._pos[slot] = len(h.prompt_tokens) - 1
        self._active[slot] = True
        self._temp[slot] = p.temperature
        self._topk[slot] = p.top_k
        self._topp[slot] = p.top_p
        self._greedy[slot] = greedy
        self._eos_arr[slot] = h._eos
        self._gens[slot] = None if greedy else _generator(
            h.request_id if p.seed is None else p.seed, self.device)

    def _draft_prefill(self, slot: int, h: RequestHandle):
        """Prefill the prompt's whole bucket into the slot's draft row (the
        JAX `_draft_prefill`), through the draft `PrefillStep` of its
        bucket: unchunked and uncached, since the draft is small. Rows
        past the bucket become zero."""
        s = len(h.prompt_tokens)
        bucket = self.pool.bucket_for(s)
        t0 = time.perf_counter()
        with _obs.span('serving.draft_prefill', request_id=h.request_id,
                       bucket=bucket, slot=slot):
            self._run_prefill(slot, 'draft', h.prompt_tokens, bucket)
        self._seconds['prefill'] += time.perf_counter() - t0
        self._note_prefill(h, t0)

    def _pin_adapter(self, slot: int, h: RequestHandle):
        """Pin the request's adapter and point the slot's row at its bank
        slot (0, the zero base adapter, for a base request). Raises
        `AdapterUnavailable` when the adapter was evicted since submit."""
        if h.adapter_id is None:
            self._adapter_rows[slot] = 0
            return
        pin, version = self.adapter_bank.pin(h.adapter_id)
        h._adapter_pin = pin
        h.adapter_version = version
        self._adapter_rows[slot] = pin

    def _unpin_adapter(self, slot: int, h: RequestHandle):
        """Release the request's bank pin (idempotent) and point the slot's
        row back at the zero base adapter."""
        if h._adapter_pin is not None:
            self.adapter_bank.unpin(h._adapter_pin)
            h._adapter_pin = None
        self._adapter_rows[slot] = 0

    def _detach_slot(self, slot: int, h: RequestHandle):
        """The slot teardown that failure and retirement share (the JAX
        engine's `_detach_slot`): drop the engine's references to `h`,
        release its prefix node and unpin its adapter. The pool slot is
        freed by the caller: retirement first hands its pages to the
        prefix cache."""
        self._slot_req.pop(slot, None)
        self._active[slot] = False
        self._prefilling.pop(slot, None)
        self._greedy[slot] = True
        self._gens[slot] = None
        if h._prefix_node is not None:
            self.prefix_cache.release(h._prefix_node)
            h._prefix_node = None
        self._unpin_adapter(slot, h)

    def _fail_request(self, slot: int, h: RequestHandle, exc: Exception,
                      event: bool = False):
        """Fail `h` alone: detach it, free its slot and pages, mark the
        handle FAILED with `exc` and count it; `event` emits
        `serving_request_failed` (a failed admission or chunk; a drain
        past its deadline emits none, as in the JAX engine)."""
        self._detach_slot(slot, h)
        self.pool.free(slot)
        h._fail(exc)
        self._counts['failed'] += 1
        if _obs.enabled():
            self._m_requests.labels(status='failed').inc()
            if event:
                _obs.emit('serving_request_failed',
                          request_id=h.request_id,
                          error=type(exc).__name__)

    def _retire(self, slot: int, h: RequestHandle, now: float):
        """Finish `h`, release its prefix pin and adapter and hand the
        prompt's KV (rows [0, prompt_len), under the request's namespace)
        to the prefix cache: a paged engine's cache holds the prompt's
        full pages (a `PageHold`, which survives the slot's free), a row
        engine's adopts the slot itself, which then stays allocated. The
        slot is freed unless the cache adopted it."""
        h._finish(now)
        self._detach_slot(slot, h)
        retained = False
        if self.prefix_cache is not None:
            retained = self.prefix_cache.insert(
                h.prompt_tokens, slot, namespace=self._prefix_ns(h))
        if not retained:
            self.pool.free(slot)
        self._counts['completed'] += 1
        if _obs.enabled():
            self._m_requests.labels(status='completed').inc()
            self._m_active.set(len(self._slot_req))
            tpot = h.tpot
            if tpot is not None:
                self._m_tpot.observe(tpot)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Host-side counters. `prefill_seconds` is wall time of the
        prefills and chunks (each ends in a device sync),
        `decode_seconds` wall time of the decode rounds (each ends in the
        token fetch); `capture_seconds` is the part of both spent
        capturing CUDA graphs. `prefill_tokens` counts prompt tokens
        computed (whole prefills and chunks; attached prefix rows are
        not)."""
        c = self._counts
        out = {
            'submitted': c['submitted'],
            'completed': c['completed'],
            'failed': c['failed'],
            'requeued': c['requeued'],
            'tokens': c['tokens'],
            'prefills': c['prefills'],
            'prefill_tokens': c['prefill_tokens'],
            'prefill_bucket_tokens': c['prefill_bucket_tokens'],
            'decode_rounds': c['decode_rounds'],
            'decode_steps': c['decode_steps'],
            'chunked_prefills': c['chunked_prefills'],
            'chunk_rounds': c['chunk_rounds'],
            'prefill_seconds': self._seconds['prefill'],
            'decode_seconds': self._seconds['decode'],
            'capture_seconds': self._seconds['capture'],
            'queue_depth': self.scheduler.queue_depth,
            'active_slots': len(self._slot_req),
            'weight_version': self.weight_version,
            'donate_pool': self._donate_pool,
            'kv_layout': 'paged' if self._paged else 'row',
            'traces': dict(self._trace_counts),
            'pool': self.pool.stats(),
        }
        if self.prefix_cache is not None:
            out['prefix_cache'] = self.prefix_cache.stats()
        if self.adapter_bank is not None:
            out['adapters'] = self.adapter_bank.stats()
        if self.draft_model is not None:
            proposed = c['spec_proposed']
            out['spec'] = {
                'k': self.spec_k,
                'rounds': c['spec_rounds'],
                'proposed': proposed,
                'accepted': c['spec_accepted'],
                'acceptance_rate': (c['spec_accepted'] / proposed
                                    if proposed else 0.0),
            }
        return out

    def reset_stats(self):
        """Zero the host-side counters (the capture count survives, as
        the JAX engine's trace counts do)."""
        self._counts.clear()
        self._seconds.clear()
