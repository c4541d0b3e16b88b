"""Replay a trace against a Router in real time, and report what the
user felt.

A copy of `paddle_tpu/loadgen/replay.py`.

The `LoadReplayer` runs the closed loop: it submits each
`TraceRequest` when its arrival instant comes due (scaled by
`time_scale`, so a 60 s trace can replay in 6 s on CPU), steps the
router between arrivals so decode keeps advancing, polls the
autoscaler (when one is attached) once per loop iteration, and records
per-request outcomes — accepted/shed/failed, TTFT — plus the
*replica-second* integral: how much hardware the fleet occupied while
serving the trace. Replica-seconds count every ATTACHED replica,
draining ones included — a draining replica still owns its chips until
it is removed, and honest per-hardware SLO math must charge for it.

The report answers the bench's headline question: p99-TTFT SLO
attainment per replica-hour — attainment counted against every
OFFERED request (a shed request is a miss the user felt; grading only
admitted work would let an aggressive shedder look perfect).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

from ..serving.tenancy import AdmissionRejected
from ..serving.api import FAILED, FINISHED, SamplingParams
from .trace import TraceRequest

NO_EOS = -1


@dataclasses.dataclass
class ReplayOutcome:
    """One trace request's fate."""
    request: TraceRequest
    outcome: str                 # 'completed' | 'shed' | 'failed'
    reason: str = ''             # shed reason / error type
    ttft_s: Optional[float] = None
    tokens: int = 0
    # per-phase seconds from the request ledger (reqledger.PHASES plus
    # 'residual'), when the ledger was enabled during the replay; the
    # report's decomposition columns come from here
    phases: Optional[dict] = None


def _reap_phases(h) -> Optional[dict]:
    """Pull the finalized phase waterfall off a handle's ledger record
    (None when the ledger is disabled or the record never finalized)."""
    rec = getattr(h, '_ledger_rec', None)
    if rec is None or rec.t_done is None:
        return None
    summ = rec.summary()
    phases = dict(summ['phases'])
    phases['residual'] = summ['residual_s']
    return phases


class ReplayReport:
    """Per-request outcomes + fleet occupancy, with the SLO math."""

    def __init__(self, outcomes: List[ReplayOutcome], wall_s: float,
                 replica_seconds: float, time_scale: float,
                 truncated: bool = False):
        self.outcomes = outcomes
        self.wall_s = float(wall_s)
        self.replica_seconds = float(replica_seconds)
        self.time_scale = float(time_scale)
        self.truncated = bool(truncated)

    def _ttfts(self) -> List[float]:
        return sorted(o.ttft_s for o in self.outcomes
                      if o.ttft_s is not None)

    def count(self, outcome: str) -> int:
        return sum(1 for o in self.outcomes if o.outcome == outcome)

    @property
    def dropped(self) -> int:
        """Requests that neither completed nor failed/shed TYPED — the
        zero-drop invariant the autoscaler tests pin at 0."""
        return sum(1 for o in self.outcomes
                   if o.outcome not in ('completed', 'shed', 'failed'))

    def slo_attainment(self, slo_ttft_s: float) -> float:
        """Fraction of OFFERED requests that completed with
        TTFT <= SLO. Shed and failed requests are misses."""
        if not self.outcomes:
            return 1.0
        good = sum(1 for o in self.outcomes
                   if o.outcome == 'completed'
                   and o.ttft_s is not None and o.ttft_s <= slo_ttft_s)
        return good / len(self.outcomes)

    def phase_decomposition(self) -> dict:
        """Per-phase p50/p99/mean seconds across outcomes that carry a
        ledger waterfall — the report's "where did the time go" columns.
        Empty when the request ledger was disabled during the replay."""
        books = [o.phases for o in self.outcomes if o.phases]
        if not books:
            return {}
        names = sorted({p for b in books for p in b})
        out = {}
        for p in names:
            vals = sorted(b.get(p, 0.0) for b in books)
            n = len(vals)
            out[p] = {
                'p50_s': round(vals[min(int(0.50 * n), n - 1)], 6),
                'p99_s': round(vals[min(int(0.99 * n), n - 1)], 6),
                'mean_s': round(sum(vals) / n, 6),
            }
        return out

    def report(self, slo_ttft_s: float) -> dict:
        ttfts = self._ttfts()

        def q(p):
            if not ttfts:
                return None
            return round(ttfts[min(int(p * len(ttfts)),
                                   len(ttfts) - 1)], 4)

        attainment = self.slo_attainment(slo_ttft_s)
        rep_hours = self.replica_seconds / 3600.0
        phases = self.phase_decomposition()
        return {
            'offered': len(self.outcomes),
            'completed': self.count('completed'),
            'shed': self.count('shed'),
            'failed': self.count('failed'),
            'dropped': self.dropped,
            'tokens': sum(o.tokens for o in self.outcomes),
            'wall_s': round(self.wall_s, 3),
            'ttft_p50_s': q(0.50),
            'ttft_p99_s': q(0.99),
            'slo_ttft_s': slo_ttft_s,
            'slo_attainment': round(attainment, 4),
            'replica_seconds': round(self.replica_seconds, 3),
            'attainment_per_replica_hour':
                round(attainment / rep_hours, 2) if rep_hours > 0
                else None,
            'truncated': self.truncated,
            # per-phase latency decomposition (request ledger); {} when
            # the ledger was off — the headline numbers above never
            # depend on it
            'phases': phases,
        }


class LoadReplayer:
    """Drive one trace through a Router (and optionally an Autoscaler).

    Args:
        router: the serving Router to submit into.
        trace: sorted TraceRequests (make_trace output).
        autoscaler: optional serving.Autoscaler; polled once per loop
            iteration — the replayer is the policy loop's clock, the
            way a serving frontend's event loop would be.
        time_scale: multiply trace arrival instants by this (0.1 ⇒
            replay 10x faster than recorded).
        max_wall_s: hard safety bound on the replay (a wedged fleet
            must fail the test, not hang it); sets `truncated`.
        clock/sleep: injectable for tests.
    """

    def __init__(self, router, trace: Sequence[TraceRequest],
                 autoscaler=None, time_scale: float = 1.0,
                 max_wall_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        if time_scale <= 0:
            raise ValueError('time_scale must be positive')
        self.router = router
        self.trace = list(trace)
        self.autoscaler = autoscaler
        self.time_scale = float(time_scale)
        self.max_wall_s = max_wall_s
        self._clock = clock
        self._sleep = sleep

    def run(self) -> ReplayReport:
        router = self.router
        outcomes: List[ReplayOutcome] = []
        live: List[tuple] = []       # (TraceRequest, RouterHandle)
        t0 = self._clock()
        last = t0
        replica_seconds = 0.0
        truncated = False
        i = 0
        n = len(self.trace)
        while True:
            now = self._clock()
            replica_seconds += len(router.replicas) * (now - last)
            last = now
            if self.max_wall_s is not None and now - t0 > self.max_wall_s:
                truncated = True
                break
            # submit everything that has come due
            while i < n and (now - t0) >= \
                    self.trace[i].arrival_s * self.time_scale:
                req = self.trace[i]
                i += 1
                try:
                    h = router.submit(
                        list(req.prompt_tokens),
                        SamplingParams(max_new_tokens=req.max_new_tokens,
                                       eos_token_id=NO_EOS),
                        tenant=req.tenant, priority=req.priority,
                        adapter_id=getattr(req, 'adapter', None))
                    live.append((req, h))
                except AdmissionRejected as exc:
                    outcomes.append(ReplayOutcome(
                        req, 'shed', reason=exc.reason))
            if self.autoscaler is not None:
                self.autoscaler.poll()
            router.step()
            # reap finished handles into outcomes
            if live:
                still = []
                for req, h in live:
                    if not h.done:
                        still.append((req, h))
                    elif h.status == FAILED:
                        outcomes.append(ReplayOutcome(
                            req, 'failed',
                            reason=type(h.error).__name__
                            if h.error is not None else 'untyped',
                            tokens=len(h.tokens),
                            phases=_reap_phases(h)))
                    else:
                        outcomes.append(ReplayOutcome(
                            req, 'completed', ttft_s=h.ttft,
                            tokens=len(h.tokens),
                            phases=_reap_phases(h)))
                live = still
            if i >= n and not live:
                break
            if i < n and not live and not any(
                    r.engine.has_work for r in router.replicas):
                # idle gap before the next arrival: sleep a slice of it
                # instead of hot-spinning (the autoscaler still polls
                # every iteration, so cap the slice)
                due = t0 + self.trace[i].arrival_s * self.time_scale
                gap = due - self._clock()
                if gap > 0:
                    self._sleep(min(gap, 0.005))
        for req, h in live:   # truncated: record what never finished
            if h.status == FINISHED:
                out = 'completed'
            elif h.status == FAILED:
                out = 'failed'
            else:
                out = 'dangling'   # counts in ReplayReport.dropped
            outcomes.append(ReplayOutcome(
                req, out, ttft_s=h.ttft, tokens=len(h.tokens),
                phases=_reap_phases(h)))
        outcomes.sort(key=lambda o: o.request.index)
        return ReplayReport(outcomes, self._clock() - t0,
                            replica_seconds, self.time_scale,
                            truncated=truncated)
