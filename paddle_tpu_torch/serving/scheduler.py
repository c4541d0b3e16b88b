"""Iteration-level scheduler (Orca-style continuous batching) with
priority classes (counterpart of `paddle_tpu/serving/scheduler.py`).

The engine calls `admissible()` between decode rounds; the scheduler
hands back the queued request(s) that fit the currently free slots,
under a per-iteration prefill token budget. Admission order is a stable
priority key (priority class, then FCFS within class); the head request
is never overtaken, and the first admission of an iteration ignores the
budget so a single over-budget prompt still makes progress. A request
that waited longer than `max_wait_s` is promoted one class, once (a
`request_promoted` event).

Queue depth is exported as `paddle_serving_queue_depth` on every
mutation, so the gauge is live even between scrapes. Why a queued
request still waits (`pool_exhausted`, `adapter_pinned`) is sampled into
its request-ledger record by the engine at each requeue.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

from .. import observability as _obs
from .api import PRIORITY_NORMAL, RequestHandle


class FCFSScheduler:
    """Priority + FCFS request queue and iteration-level admission.

    `max_prefill_tokens` caps the summed BUCKETED prompt lengths admitted
    in one scheduling iteration (0/None = unbounded). Bucketed — not raw
    — lengths, because the bucket is what the prefill actually computes.

    `max_wait_s` arms the starvation guard (None = off): a request older
    than this is promoted one priority class, once, and counted in
    `promotions`.
    """

    def __init__(self, max_prefill_tokens: Optional[int] = None,
                 max_wait_s: Optional[float] = None):
        self.max_prefill_tokens = (int(max_prefill_tokens)
                                   if max_prefill_tokens else 0)
        self.max_wait_s = (float(max_wait_s) if max_wait_s else None)
        self.promotions = 0
        self._queue: List[RequestHandle] = []
        self._gauge = None
        if _obs.enabled():
            self._gauge = _obs.get_registry().gauge(
                'paddle_serving_queue_depth',
                'requests waiting for a slot')
            self._gauge.set(0)

    def _note_depth(self):
        if self._gauge is not None:
            self._gauge.set(len(self._queue))

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def submit(self, handle: RequestHandle):
        self._queue.append(handle)
        self._note_depth()

    def pending(self) -> List[RequestHandle]:
        """Snapshot of the queued handles (router introspection)."""
        return list(self._queue)

    def requeue(self, handle: RequestHandle):
        """Put an already-admitted handle back at the queue FRONT (the
        engine could not seat it: its page reservation hit
        PagePoolExhausted, or its adapter bank was full of pinned slots).
        Front insertion preserves FCFS-within-class order, and the
        handle's `_t_submit` is deliberately NOT touched: queue_wait,
        ttft, and the starvation guard all measure from FIRST submit,
        however many times the request bounces back."""
        self._queue.insert(0, handle)
        self._note_depth()

    def drain(self) -> List[RequestHandle]:
        """Pop and return every queued request (a drain past its deadline
        fails them; `evict_all` hands them back)."""
        out = list(self._queue)
        self._queue.clear()
        self._note_depth()
        return out

    def _effective_priority(self, handle: RequestHandle,
                            now: float) -> int:
        p = int(getattr(handle, 'priority', PRIORITY_NORMAL))
        if (self.max_wait_s is not None and p > 0
                and now - handle._t_submit > self.max_wait_s):
            if not getattr(handle, '_promoted', False):
                handle._promoted = True
                self.promotions += 1
                _obs.emit('request_promoted',
                          request_id=handle.request_id,
                          from_priority=p, to_priority=p - 1,
                          waited_s=round(now - handle._t_submit, 3))
            p -= 1
        return p

    def admissible(self, free_slots: int,
                   bucket_for: Callable[[int], int]) -> List[RequestHandle]:
        """Pop the admission-order prefix that fits `free_slots` and the
        prefill token budget this iteration. Order = stable sort by
        (effective priority, submit order); the prefix rule is the same
        as FCFS — once the next-in-order request doesn't fit the budget,
        nothing behind it is considered (no overtaking)."""
        if not self._queue or free_slots <= 0:
            return []
        now = time.perf_counter()
        # python's sort is stable: within a class, list order == FCFS
        order = sorted(self._queue,
                       key=lambda h: self._effective_priority(h, now))
        admitted: List[RequestHandle] = []
        budget = self.max_prefill_tokens
        for h in order:
            if len(admitted) >= free_slots:
                break
            cost = bucket_for(len(h.prompt_tokens))
            if admitted and self.max_prefill_tokens and cost > budget:
                break   # budget spent; the head waits, nothing overtakes
            admitted.append(h)
            budget -= cost
        for h in admitted:
            self._queue.remove(h)
        if admitted:
            self._note_depth()
        return admitted
