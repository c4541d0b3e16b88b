"""Continuous-batching inference engine over the paged KV pool
(counterpart of `paddle_tpu/serving/engine.py:InferenceEngine` with
`kv_page_size` set, unquantized, with the prefix cache and chunked
prefill, without int8 KV or a draft model).

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
"""
from __future__ import annotations

import collections
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..nlp.generation import cached_forward
from ..framework import generator as _generator
from .adapters.bank import AdapterUnavailable
from .api import GREEDY, RUNNING, RequestHandle, SamplingParams
from .decode_graph import DecodeStep
from .kv_pool import PagePoolExhausted, PagedSlotPool
from .prefill_graph import PrefillStep
from .prefix_cache import PagedPrefixCache, RadixPrefixCache
from .scheduler import FCFSScheduler


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
        kv_page_size: rows per KV page; max_length must be a multiple.
        kv_pages: total pages including the null page 0. Default
            num_slots * pages_per_slot + 1; lower oversubscribes, and
            admission then requeues on page exhaustion.
        adapter_bank: a `serving.AdapterBank` attached to this model;
            enables `submit(..., adapter_id=)`. A request pins its
            adapter at admission and unpins it at retirement.
        prefix_cache: a `PagedPrefixCache` over this engine's pool, or a
            fraction of the pool's pages it may hold (True = 0.5); None
            or False = no cache.
        prefill_chunk_tokens: prompts longer than this prefill one chunk
            (at its length bucket) per `step()`; None = whole prefills
            (a prefix hit's suffix is then one chunk).
    """

    def __init__(self, model, num_slots: int = 8, max_length: int = 256,
                 decode_block: int = 4,
                 buckets: Optional[Sequence[int]] = None,
                 max_prefill_tokens: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 max_wait_s: Optional[float] = None,
                 kv_page_size: int = 16, kv_pages: Optional[int] = None,
                 adapter_bank=None, prefix_cache=None,
                 prefill_chunk_tokens: Optional[int] = None):
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
        self.eos_token_id = int(
            getattr(cfg, 'eos_token_id', -1) if eos_token_id is None
            else eos_token_id)
        self.decode_block = int(decode_block)
        self.adapter_bank = adapter_bank
        self.pool = PagedSlotPool(model, num_slots, max_length, buckets,
                                  page_size=int(kv_page_size),
                                  num_pages=kv_pages)
        self.scheduler = FCFSScheduler(max_prefill_tokens,
                                       max_wait_s=max_wait_s)
        if prefill_chunk_tokens is not None and prefill_chunk_tokens < 1:
            raise ValueError('prefill_chunk_tokens must be >= 1')
        self.prefill_chunk_tokens = (int(prefill_chunk_tokens)
                                     if prefill_chunk_tokens else None)
        if isinstance(prefix_cache, RadixPrefixCache):
            if not isinstance(prefix_cache, PagedPrefixCache):
                raise ValueError(
                    'prefix cache layout does not match the pool: a '
                    'paged engine needs a PagedPrefixCache (and a row '
                    'engine a RadixPrefixCache)')
            self.prefix_cache: Optional[PagedPrefixCache] = prefix_cache
        elif prefix_cache:
            self.prefix_cache = PagedPrefixCache(
                self.pool, 0.5 if prefix_cache is True
                else float(prefix_cache))
        else:
            self.prefix_cache = None
        if self.prefix_cache is not None and \
                self.prefix_cache.budget_pages < 1:
            raise ValueError(
                'prefix cache budget rounds to zero pages; raise the '
                'fraction or the pool size (retention must leave capacity '
                'for decode)')
        # slot -> [handle, prefill cursor]: slots mid-chunked-prefill
        # (inactive for decode until the cursor reaches the prompt end)
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
        self._gens: List[Optional[torch.Generator]] = [None] * n
        self._adapter_rows = np.zeros(n, np.int32)  # 0 = base adapter
        self._slot_req: dict = {}               # slot -> RequestHandle
        self._counts = collections.Counter()
        self._seconds = collections.Counter()
        self._trace_counts = collections.Counter()
        self._decode = DecodeStep(
            self._fwd, self.pool.pages, n, self.pool.pages_per_slot,
            self.pool.max_length, self.decode_block, self.device,
            None if adapter_bank is None else adapter_bank.device_arrays())
        # (kind, bucket) -> PrefillStep, built at first use
        self._prefill_steps: dict = {}
        self._prefill_pool = None       # the prefill graphs' memory pool
        # on the card the sub-step is captured at the first decode round
        # and each prefill step at its first use; False runs them
        # uncaptured there (the eager reference of the tests and
        # chip_smoke.py)
        self._capture_decode = self.device.type == 'cuda'
        self._capture_prefill = self.device.type == 'cuda'

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
        bank does not hold raises `AdapterUnavailable` here."""
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
                raise AdapterUnavailable(adapter_id, 'not resident')
        toks = self._normalize_prompt(prompt)
        self.pool.bucket_for(len(toks))   # raises when no bucket fits
        if len(toks) + params.max_new_tokens > self.pool.max_length:
            raise ValueError(
                f'prompt ({len(toks)}) + max_new_tokens '
                f'({params.max_new_tokens}) exceeds the slot length '
                f'({self.pool.max_length})')
        h = RequestHandle(toks, params, engine=self)
        h.adapter_id = adapter_id
        if priority is not None:
            h.priority = int(priority)
        h._eos = int(self.eos_token_id if params.eos_token_id is None
                     else params.eos_token_id)
        self._counts['submitted'] += 1
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
        chunk, then advance every active slot one decode round. Returns
        the number of requests that progressed."""
        self._admit()
        self._advance_prefills()
        n = len(self._slot_req)
        if not np.any(self._active):
            return n            # chunk-prefill-only progress this round
        t0 = time.perf_counter()
        toks = self._decode_round()
        now = time.perf_counter()
        self._seconds['decode'] += now - t0
        self._counts['decode_rounds'] += 1
        for slot, h in list(self._slot_req.items()):
            if not self._active[slot]:
                continue            # mid-chunked-prefill: no tokens yet
            done = False
            emitted = 0
            for j in range(self.decode_block):
                t = int(toks[slot, j])
                h._emit(t, now)
                emitted += 1
                if len(h.tokens) >= h.params.max_new_tokens or t == h._eos:
                    done = True
                    break
            self._counts['tokens'] += emitted
            if done:
                self._retire(slot, h, now)
            else:
                self._tok[slot] = toks[slot, -1]
                self._pos[slot] += self.decode_block
                self.pool.note_written(slot, self._pos[slot] + 1)
        return n

    def _decode_round(self) -> np.ndarray:
        """`decode_block` paged sub-steps over every slot; returns the
        [num_slots, decode_block] tokens (the fetch waits for the
        round)."""
        with torch.inference_mode():
            toks = self._queue_round().to('cpu', copy=True).numpy()
        self._counts['decode_steps'] += self.decode_block
        return toks

    def _queue_round(self) -> torch.Tensor:
        """Stage the round's host state into the sub-step's static
        buffers and queue its sub-steps (`DecodeStep`); returns the
        device [num_slots, decode_block] token buffer. Inactive slots
        have their table row redirected to the null page, so their
        writes land nowhere real. Captures the sub-step first when this
        is the engine's first round on the card."""
        step = self._decode
        if self._capture_decode and step.graph is None:
            t0 = time.perf_counter()
            step.capture()
            self._seconds['capture'] += time.perf_counter() - t0
            self._trace_counts['paged_decode_step'] += 1
        staged = dict(
            tok=self._tok, pos=self._pos, active=self._active,
            table=np.where(self._active[:, None], self.pool.page_table, 0),
            temp=self._temp, topk=self._topk, topp=self._topp)
        if self.adapter_bank is not None:
            staged['rows'] = self._adapter_rows
        step.stage(**staged)
        return step.run(self._active & ~self._greedy, self._gens)

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

    def _admit(self):
        admitted = self.scheduler.admissible(self.pool.free_count,
                                             self._admission_cost)
        for idx, h in enumerate(admitted):
            slot = self.pool.alloc()
            try:
                self._begin_request(slot, h)
            except AdapterUnavailable as exc:
                # evicted since submit: a request-level failure; the
                # engine keeps serving everyone else
                self.pool.free(slot)
                h._fail(exc)
                self._counts['failed'] += 1
                continue
            except PagePoolExhausted:
                # not a failure: free the slot (which drops any attached
                # prefix pages) and send this handle and everything
                # behind it back to the queue front in order; pages free
                # up as in-flight requests retire
                self.pool.free(slot)
                for back in reversed(admitted[idx:]):
                    self.scheduler.requeue(back)
                self._counts['requeued'] += len(admitted) - idx
                break

    def _prefix_ns(self, h: RequestHandle):
        """The prefix-cache namespace of this request's KV: an adapter
        request's prefill KV holds its LoRA deltas, so it is keyed on
        (adapter_id, adapter_version); base requests share None."""
        if h.adapter_id is None:
            return None
        return (h.adapter_id, h.adapter_version)

    def _seat_paged(self, slot: int, h: RequestHandle, s: int) -> tuple:
        """Attach the longest page-aligned cached prefix read-only, then
        reserve every page the request can touch (prompt + token budget)
        all-or-nothing, reclaiming zero-ref cache holds under pressure;
        on a full-prompt hit split off the page of the last prompt row.
        Raises PagePoolExhausted with the prefix node released (the
        caller frees the slot, which drops the attached pages). Returns
        (node, cursor): cursor is the page-aligned count of prefix rows
        seated; the suffix [cursor, s) prefills into fresh pages."""
        ps = self.pool.page_size
        node, cursor = None, 0
        if self.prefix_cache is not None:
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
        try:
            if node is not None:
                self.pool.attach_prefix(slot, node.slot, cursor // ps)
            self._reserve_pages(slot, min(s + h.params.max_new_tokens,
                                          self.pool.max_length))
            if cursor >= s:
                # full hit: the pending-token re-forward at s - 1 writes
                # into the last shared page; copy-on-write it first
                while True:
                    try:
                        self.pool.ensure_exclusive(slot, s - 1)
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
        request left in the engine."""
        s = len(h.prompt_tokens)
        self._pin_adapter(slot, h)
        try:
            node, cursor = self._seat_paged(slot, h, s)
        except PagePoolExhausted:
            self._unpin_adapter(slot, h)
            raise
        if node is not None:
            h._prefix_node = node
            h._prefix_len = cursor
        self._slot_req[slot] = h
        h.status = RUNNING
        if cursor >= s:
            # full hit: the pages are shared already; the first decode
            # round re-forwards the last prompt token
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
        self._prefilling[slot] = [h, cursor]
        self._counts['chunked_prefills'] += 1

    def _prefill_step(self, kind: str, bucket: int) -> PrefillStep:
        """The `PrefillStep` of (kind, bucket), built at its first use and,
        on the card, captured then (counted in `traces` under the JAX
        engine's name, once)."""
        step = self._prefill_steps.get((kind, bucket))
        if step is None:
            step = self._prefill_steps[(kind, bucket)] = PrefillStep(
                kind, bucket, self.model, self.pool.pages,
                self.pool.pages_per_slot, self.device,
                None if self.adapter_bank is None
                else self.adapter_bank.device_arrays())
        if self._capture_prefill and step.graph is None:
            if self._prefill_pool is None:
                self._prefill_pool = torch.cuda.graph_pool_handle()
            t0 = time.perf_counter()
            step.capture(self._prefill_pool)
            self._seconds['capture'] += time.perf_counter() - t0
            self._trace_counts[step.name] += 1
        return step

    def _run_prefill(self, slot: int, kind: str, window, bucket: int,
                     **staged):
        """Stage the right-padded `window` of prompt tokens, the slot's
        table row, its bank row (with a bank) and `staged` into the
        (kind, bucket) step and run it; returns when the device is done
        (the prefill's wall is timed over it)."""
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :len(window)] = window
        if self.adapter_bank is not None:
            staged['rows'] = self._adapter_rows[slot:slot + 1]
        with torch.inference_mode():
            step = self._prefill_step(kind, bucket)
            step.stage(ids=ids, table=self.pool.page_table[slot:slot + 1],
                       **staged)
            step.run_once()
        self._sync()

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
        self._run_prefill(slot, 'whole', h.prompt_tokens, bucket)
        self._seconds['prefill'] += time.perf_counter() - t0
        self.pool.note_written(slot, s)
        self._counts['prefills'] += 1
        self._counts['prefill_tokens'] += s
        self._counts['prefill_bucket_tokens'] += bucket

    def _advance_prefills(self):
        """Drive every mid-prefill slot forward one chunk (in admission
        order). A slot whose cursor reaches the prompt end activates for
        decode in the same step."""
        for slot in list(self._prefilling):
            h, cursor = self._prefilling[slot]
            self._prefill_chunk(slot, h, cursor)

    def _prefill_chunk(self, slot: int, h: RequestHandle, cursor: int):
        """Prefill the prompt window [start, start + bucket) of `slot`
        through the chunk `PrefillStep` of its bucket (the chunk forward,
        `LlamaForCausalLM.prefill_kv` with the pool's pages): the chunk of
        up to `prefill_chunk_tokens` tokens from the cursor, at its length
        bucket. A window whose bucket would overrun the slot shifts its
        start down and forwards rows below the cursor again; the floor
        (the attach boundary) keeps those writes out of the shared
        pages."""
        s = len(h.prompt_tokens)
        c = min(self.prefill_chunk_tokens or s, s - cursor)
        bucket = self.pool.bucket_for(c)
        start = min(cursor, self.pool.max_length - bucket)
        t0 = time.perf_counter()
        self._run_prefill(slot, 'chunk', h.prompt_tokens[start:start + bucket],
                          bucket, start=start, floor=h._prefix_len)
        self._seconds['prefill'] += time.perf_counter() - t0
        new_cursor = min(start + bucket, s)
        self.pool.note_written(slot, new_cursor)
        self._prefilling[slot][1] = new_cursor
        self._counts['chunk_rounds'] += 1
        self._counts['prefill_tokens'] += new_cursor - cursor
        self._counts['prefill_bucket_tokens'] += bucket
        if new_cursor >= s:
            del self._prefilling[slot]
            self._activate(slot, h)

    def _activate(self, slot: int, h: RequestHandle):
        """Arm the slot for decode: the pending token is the last prompt
        token at position s - 1."""
        p = h.params
        greedy = p.strategy == GREEDY
        self._tok[slot] = h.prompt_tokens[-1]
        self._pos[slot] = len(h.prompt_tokens) - 1
        self._active[slot] = True
        self._temp[slot] = p.temperature
        self._topk[slot] = p.top_k
        self._topp[slot] = p.top_p
        self._greedy[slot] = greedy
        self._gens[slot] = None if greedy else _generator(
            h.request_id if p.seed is None else p.seed, self.device)

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

    def _retire(self, slot: int, h: RequestHandle, now: float):
        """Finish `h`, release its prefix pin and adapter, hand the
        prompt's full pages to the prefix cache (a `PageHold`: its rows
        [0, prompt_len) are the prompt's prefill KV, under the request's
        namespace) and free the slot; held pages survive the free."""
        h._finish(now)
        if h._prefix_node is not None:
            self.prefix_cache.release(h._prefix_node)
            h._prefix_node = None
        self._unpin_adapter(slot, h)
        del self._slot_req[slot]
        self._active[slot] = False
        self._greedy[slot] = True
        self._gens[slot] = None
        if self.prefix_cache is not None:
            self.prefix_cache.insert(h.prompt_tokens, slot,
                                     namespace=self._prefix_ns(h))
        self.pool.free(slot)
        self._counts['completed'] += 1

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
            'kv_layout': 'paged',
            'traces': dict(self._trace_counts),
            'pool': self.pool.stats(),
        }
        if self.prefix_cache is not None:
            out['prefix_cache'] = self.prefix_cache.stats()
        if self.adapter_bank is not None:
            out['adapters'] = self.adapter_bank.stats()
        return out

    def reset_stats(self):
        """Zero the host-side counters (the capture count survives, as
        the JAX engine's trace counts do)."""
        self._counts.clear()
        self._seconds.clear()
