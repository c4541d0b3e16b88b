"""Continuous-batching inference engine over the paged KV pool
(counterpart of `paddle_tpu/serving/engine.py:InferenceEngine` with
`kv_page_size` set, unquantized, without prefix cache, chunked prefill
or draft model).

One engine is one event loop: `step()` admits queued requests into free
slots (reserving every page each can touch, and requeueing on
`PagePoolExhausted`), prefills each admitted prompt whole at its length
bucket, then advances every active slot one decode round of
`decode_block` sub-steps. Each sub-step runs the model's paged forward
(`nlp.generation.cached_forward`): the pending token's K/V rows are
written into its page, and it attends through the paged-attention
kernel over the slot's page table, which is the function the JAX engine
computes by gathering pages, attending densely under a slot-causal mask
and scattering the touched pages back. Prefill runs the causal flash
kernel over the right-padded bucket and scatters the slab into the
slot's pages.

The sub-step runs over static device buffers (`decode_graph.
DecodeStep`), and on the card it is captured as a CUDA graph at the
first decode round and replayed `decode_block` times a round, where the
JAX engine compiles the round once (`stats()['traces']
['paged_decode_step']` counts the capture, as the JAX engine counts its
trace).

Greedy requests take the raw argmax, so their tokens never depend on
batch neighbours; sampling requests draw from their own
`torch.Generator`, seeded from `SamplingParams.seed`, between replays.

With an `AdapterBank`, each request may decode under its own LoRA
adapter (`submit(..., adapter_id=)`): admission pins the adapter's bank
slot into the host row vector `_adapter_rows` (0 = the zero base
adapter), which each round stages into the sub-step's static rows; the
sub-step runs inside `adapter_scope` over the bank's tensors and those
rows, and each prefill inside a scope over its slot's row, so one batch
mixes base and adapted requests.
"""
from __future__ import annotations

import collections
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..nlp.generation import cached_forward
from ..framework import generator as _generator
from .adapters.apply import adapter_scope
from .adapters.bank import AdapterUnavailable
from .api import GREEDY, RUNNING, RequestHandle, SamplingParams
from .decode_graph import DecodeStep
from .kv_pool import PagePoolExhausted, PagedSlotPool, scatter_pages
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
    """

    def __init__(self, model, num_slots: int = 8, max_length: int = 256,
                 decode_block: int = 4,
                 buckets: Optional[Sequence[int]] = None,
                 max_prefill_tokens: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 max_wait_s: Optional[float] = None,
                 kv_page_size: int = 16, kv_pages: Optional[int] = None,
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
        # on the card the sub-step is captured at the first decode round;
        # False runs it uncaptured there (the eager reference of the
        # tests and chip_smoke.py)
        self._capture_decode = self.device.type == 'cuda'

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
        """One scheduler iteration: admit (and prefill) queued requests
        into free slots, then advance every active slot one decode round.
        Returns the number of requests that progressed."""
        self._admit()
        n = len(self._slot_req)
        if not np.any(self._active):
            return n
        t0 = time.perf_counter()
        toks = self._decode_round()
        now = time.perf_counter()
        self._seconds['decode'] += now - t0
        self._counts['decode_rounds'] += 1
        for slot, h in list(self._slot_req.items()):
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
            step.capture()
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
    def _admit(self):
        admitted = self.scheduler.admissible(self.pool.free_count,
                                             self.pool.bucket_for)
        for idx, h in enumerate(admitted):
            slot = self.pool.alloc()
            s = len(h.prompt_tokens)
            try:
                # pin before reserving pages: the pin rolls back with a
                # requeue
                self._pin_adapter(slot, h)
            except AdapterUnavailable as exc:
                # evicted since submit: a request-level failure; the
                # engine keeps serving everyone else
                self.pool.free(slot)
                h._fail(exc)
                self._counts['failed'] += 1
                continue
            try:
                self.pool.reserve(slot, min(s + h.params.max_new_tokens,
                                            self.pool.max_length))
            except PagePoolExhausted:
                # not a failure: this handle and everything behind it go
                # back to the queue front in order; pages free up as
                # in-flight requests retire
                self._unpin_adapter(slot, h)
                self.pool.free(slot)
                for back in reversed(admitted[idx:]):
                    self.scheduler.requeue(back)
                self._counts['requeued'] += len(admitted) - idx
                break
            self._slot_req[slot] = h
            h.status = RUNNING
            self._whole_prefill(slot, h)
            self._activate(slot, h)

    def _whole_prefill(self, slot: int, h: RequestHandle):
        """Prefill the right-padded prompt bucket through the causal flash
        kernel and scatter its K/V rows into the slot's pages (pad rows
        past the reservation fall on the null page). No logits: the first
        token comes from the next decode round, which re-forwards the
        last prompt token at position s - 1."""
        s = len(h.prompt_tokens)
        bucket = self.pool.bucket_for(s)
        t0 = time.perf_counter()
        ids = torch.zeros((1, bucket), dtype=torch.int64)
        ids[0, :s] = torch.tensor(h.prompt_tokens)
        table = torch.from_numpy(self.pool.page_table[slot:slot + 1])
        with torch.inference_mode(), adapter_scope(*self._adapter_args(slot)):
            slab = self.model.prefill_kv(ids.to(self.device))
            scatter_pages(self.pool.pages, table.to(self.device), slab,
                          torch.zeros(1, dtype=torch.int64,
                                      device=self.device))
        self._sync()
        self._seconds['prefill'] += time.perf_counter() - t0
        self.pool.note_written(slot, s)
        self._counts['prefills'] += 1
        self._counts['prefill_tokens'] += s
        self._counts['prefill_bucket_tokens'] += bucket

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

    def _adapter_args(self, slot: int) -> tuple:
        """(bank tensors, the slot's bank slot on the device) for the
        prefill's `adapter_scope`; (None, None), an inert scope, without a
        bank."""
        if self.adapter_bank is None:
            return None, None
        return (self.adapter_bank.device_arrays(),
                torch.from_numpy(self._adapter_rows[slot:slot + 1].copy()
                                 ).to(self.device))

    def _retire(self, slot: int, h: RequestHandle, now: float):
        h._finish(now)
        self._unpin_adapter(slot, h)
        del self._slot_req[slot]
        self._active[slot] = False
        self._greedy[slot] = True
        self._gens[slot] = None
        self.pool.free(slot)
        self._counts['completed'] += 1

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Host-side counters. `prefill_seconds` is wall time of the
        prefills (each ends in a device sync), `decode_seconds` wall time
        of the decode rounds (each ends in the token fetch)."""
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
            'prefill_seconds': self._seconds['prefill'],
            'decode_seconds': self._seconds['decode'],
            'queue_depth': self.scheduler.queue_depth,
            'active_slots': len(self._slot_req),
            'kv_layout': 'paged',
            'traces': dict(self._trace_counts),
            'pool': self.pool.stats(),
        }
        if self.adapter_bank is not None:
            out['adapters'] = self.adapter_bank.stats()
        return out

    def reset_stats(self):
        """Zero the host-side counters (the capture count survives, as
        the JAX engine's trace counts do)."""
        self._counts.clear()
        self._seconds.clear()
