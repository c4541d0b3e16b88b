"""Iteration-level scheduler (Orca-style continuous batching) with
priority classes (counterpart of `paddle_tpu/serving/scheduler.py`,
without its observability calls).

The engine calls `admissible()` between decode rounds; the scheduler
hands back the queued request(s) that fit the currently free slots,
under a per-iteration prefill token budget. Admission order is a stable
priority key (priority class, then FCFS within class); the head request
is never overtaken, and the first admission of an iteration ignores the
budget so a single over-budget prompt still makes progress. A request
that waited longer than `max_wait_s` is promoted one class, once.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

from .api import PRIORITY_NORMAL, RequestHandle


class FCFSScheduler:
    """Priority + FCFS request queue and iteration-level admission.

    `max_prefill_tokens` caps the summed BUCKETED prompt lengths admitted
    in one scheduling iteration (0/None = unbounded). `max_wait_s` arms
    the starvation guard (None = off).
    """

    def __init__(self, max_prefill_tokens: Optional[int] = None,
                 max_wait_s: Optional[float] = None):
        self.max_prefill_tokens = (int(max_prefill_tokens)
                                   if max_prefill_tokens else 0)
        self.max_wait_s = (float(max_wait_s) if max_wait_s else None)
        self.promotions = 0
        self._queue: List[RequestHandle] = []

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def submit(self, handle: RequestHandle):
        self._queue.append(handle)

    def requeue(self, handle: RequestHandle):
        """Put an already-admitted handle back at the queue FRONT (its
        page reservation hit PagePoolExhausted). `_t_submit` is not
        touched: latency measures from the first submit."""
        self._queue.insert(0, handle)

    def _effective_priority(self, handle: RequestHandle,
                            now: float) -> int:
        p = int(getattr(handle, 'priority', PRIORITY_NORMAL))
        if (self.max_wait_s is not None and p > 0
                and now - handle._t_submit > self.max_wait_s):
            if not getattr(handle, '_promoted', False):
                handle._promoted = True
                self.promotions += 1
            p -= 1
        return p

    def admissible(self, free_slots: int,
                   bucket_for: Callable[[int], int]) -> List[RequestHandle]:
        """Pop the admission-order prefix that fits `free_slots` and the
        prefill token budget this iteration (no overtaking)."""
        if not self._queue or free_slots <= 0:
            return []
        now = time.perf_counter()
        order = sorted(self._queue,
                       key=lambda h: self._effective_priority(h, now))
        admitted: List[RequestHandle] = []
        budget = self.max_prefill_tokens
        for h in order:
            if len(admitted) >= free_slots:
                break
            cost = bucket_for(len(h.prompt_tokens))
            if admitted and self.max_prefill_tokens and cost > budget:
                break
            admitted.append(h)
            budget -= cost
        for h in admitted:
            self._queue.remove(h)
        return admitted
