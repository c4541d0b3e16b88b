"""Per-request latency ledger: explain every millisecond of the p99
(a copy of `paddle_tpu/observability/reqledger.py`).

The goodput ledger (goodput.py) explains every wall-clock second of the
FLEET; this module applies the same closure discipline to ONE request.
Dean & Barroso ("The Tail at Scale") and Dapper both argue the tail is
only debuggable with per-request, cross-component attribution — when
the TTFT p99 breaches, "where did my p99 go" needs an answer naming a
phase, not a histogram.

Every request's lifetime decomposes into an exhaustive, non-overlapping
taxonomy (`PHASES`), with the unexplained remainder reported as an
explicit residual — never hidden inside a phase it doesn't belong to:

  admission          tenancy/QoS checks + replica pick + seating work
  queue_wait         submitted but not seated; partitioned by the
                     BLOCKING REASON sampled at each scheduler pass
                     (`BLOCKED_REASONS`)
  prefix_lookup      radix prefix-cache probe at seating
  prefill            this request's own prefill compute (whole-prompt
                     or per chunk/bucket; draft-model prefill included)
  prefill_wait       seated while ANOTHER slot's prefill chunk runs —
                     the chunked-prefill convoy, named explicitly
  decode             batched decode rounds. Waterfall book: each
                     participant is charged the FULL round wall (the
                     request really waited that long), so per-request
                     phases sum to E2E. Fair-share book:
                     `decode_fair_s` = round_wall / n_active per round,
                     so per-request fair shares sum to the ENGINE
                     decode wall — both closures are tier-1-asserted.
  spec_verify        speculation rounds (draft + target verify),
                     rejected-draft cost included
  rpc_transport      framed-RPC surplus on process replicas (parent
                     round wall minus the child's reported step wall)
  failover_resubmit  replica-death detection + re-placement gap
  retry_backoff      transient-retry backoff sleeps attributable to
                     this request (reserved: today's per-call retries
                     ride inside the round phase that ran them)

Records attach to request handles (`handle._ledger_rec`) and are
mutated only by the thread driving that handle (the engine/router
loop); the ledger itself only aggregates FINALIZED records, under its
lock. One record survives failover: the router re-points the fresh
engine handle at the original record, so the waterfall spans replicas.

Tail exemplars keep full waterfalls for the slowest K per sliding
window plus a reservoir sample of everything else; `report()` is the
`/requests` payload (per-phase p50/p99 decomposition, a "p99 driver"
ranking = which phase dominates at the tail, blocked-reason ranking).
Finalized records queue for the fleet's wire plane
(`drain_wire_records`), which comes with `wire.py`.

The `request_slow` threshold is `slow_ttft_s` x `slow_factor`; the JAX
ledger falls back on a registered SLO engine's TTFT objective, which
comes with `slo.py` (until then a ledger without `slow_ttft_s` flags no
request, as the JAX one does with no engine registered).
"""
from __future__ import annotations

import random
import time
from typing import Any, Dict, List, Optional, Sequence

from . import events as _events
from . import metrics as _metrics
from ..analysis.runtime import concurrency as _concurrency

# the exhaustive, non-overlapping per-request taxonomy (report order).
# 'residual' is computed at finalize, never accumulated.
PHASES = (
    'admission',
    'queue_wait',
    'prefix_lookup',
    'prefill',
    'prefill_wait',
    'decode',
    'spec_verify',
    'rpc_transport',
    'failover_resubmit',
    'retry_backoff',
)

# queue_wait partition: the blocking reason sampled at each scheduler
# pass / requeue. The vocabulary is closed — dashboards group by it.
BLOCKED_REASONS = (
    'pool_exhausted',       # KV page/slot reservation failed; requeued
    'adapter_pinned',       # adapter bank full of pinned slots; requeued
    'priority_queued',      # waiting behind other admissible work
    'breaker_open',         # origin replica circuit-broken; waiting on
                            # a survivor's queue after failover
    'no_healthy_replica',   # no failover target existed at sample time
)

#: per-record waterfall segment cap — beyond it, phase seconds still
#: accumulate (closure holds) but the rendered waterfall truncates
MAX_SEGMENTS = 256
#: adjacent same-phase segments closer than this coalesce
_COALESCE_GAP_S = 1e-4


class RequestRecord:
    """One request's phase books. Mutated by the driving thread only;
    handed to the ledger exactly once, at finalize."""

    __slots__ = (
        'request_id', 'tenant', 'priority', 'adapter_id', 't_submit',
        't_first', 't_done', 'outcome', 'tokens', 'failovers',
        'replica_id', 'phases', 'ttft_phases', 'blocked', 'decode_fair_s',
        'segments', 'segments_dropped', 'wall_ts',
        '_q_mark', '_q_reason', '_last_touch', '_owner',
    )

    def __init__(self, request_id: int, t_submit: float,
                 tenant: Optional[str] = None,
                 priority: Optional[int] = None,
                 adapter_id: Optional[str] = None):
        self.request_id = request_id
        self.tenant = tenant
        self.priority = priority
        self.adapter_id = adapter_id
        self.t_submit = float(t_submit)
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        self.outcome: Optional[str] = None
        self.tokens = 0
        self.failovers = 0
        self.replica_id: Optional[int] = None
        self.phases: Dict[str, float] = dict.fromkeys(PHASES, 0.0)
        # the TTFT sub-book: phase seconds accrued while no token had
        # been emitted yet — closes against measured TTFT
        self.ttft_phases: Dict[str, float] = dict.fromkeys(PHASES, 0.0)
        self.blocked: Dict[str, float] = {}
        self.decode_fair_s = 0.0
        self.segments: List[List[float]] = []   # [phase_idx, start, dur]
        self.segments_dropped = 0
        self.wall_ts: Optional[float] = None
        self._q_mark: Optional[float] = None
        self._q_reason = 'priority_queued'
        self._last_touch = self.t_submit
        # the ledger this record finalizes into (set by open(); handle
        # hooks route through it so a bench/test ledger keeps its own
        # books instead of leaking into the default singleton's)
        self._owner: Optional['RequestLedger'] = None

    # -- phase attribution -------------------------------------------------
    def add(self, phase: str, dur: float, now: Optional[float] = None):
        """Attribute `dur` seconds ending at `now` to `phase` (both
        books the phase belongs to: waterfall always; TTFT sub-book
        while the first token is still pending)."""
        if dur <= 0.0:
            return
        end = time.perf_counter() if now is None else now
        self.phases[phase] += dur
        if self.t_first is None:
            self.ttft_phases[phase] += dur
        self._last_touch = end
        start = end - dur - self.t_submit   # waterfall-relative
        segs = self.segments
        idx = PHASES.index(phase)
        if segs:
            last = segs[-1]
            if (last[0] == idx
                    and start - (last[1] + last[2]) < _COALESCE_GAP_S):
                last[2] = max(last[2], start + dur - last[1])
                return
        if len(segs) >= MAX_SEGMENTS:
            self.segments_dropped += 1
            return
        segs.append([idx, start, dur])

    def fair_decode(self, dur: float):
        """Fair-share book only: this request's share of one batched
        round (round wall / participants)."""
        self.decode_fair_s += dur

    def mark_first(self, now: float):
        """First token emitted: freeze the TTFT sub-book."""
        if self.t_first is None:
            self.t_first = now

    # -- queue bookkeeping -------------------------------------------------
    def queue_enter(self, now: float, reason: str = 'priority_queued'):
        """The request (re-)entered a scheduler queue."""
        self._q_mark = now
        self._q_reason = reason
        self._last_touch = now

    def queue_block(self, now: float, reason: str):
        """A scheduler pass sampled WHY this queued request is still
        waiting: the interval since the last mark books under the
        freshly sampled reason, and a new interval opens."""
        self._settle_queue(now, reason)
        self._q_mark = now
        self._q_reason = reason

    def queue_exit(self, now: float):
        """The request left the queue (seating attempt begins). No-op
        when not queued."""
        self._settle_queue(now, self._q_reason)
        self._q_mark = None

    def _settle_queue(self, now: float, reason: str):
        if self._q_mark is None:
            return
        dur = now - self._q_mark
        if dur > 0.0:
            self.add('queue_wait', dur, now=now)
            self.blocked[reason] = self.blocked.get(reason, 0.0) + dur

    def rebase_submit(self, t_submit: float):
        """Re-anchor the record at the ROUTER's submit instant: the gap
        between router entry and engine enqueue (QoS checks + replica
        pick) books as `admission`. Call before any segment exists on
        the engine clock would go stale — i.e. immediately after the
        first placement."""
        delta = self.t_submit - float(t_submit)
        if delta <= 0.0:
            return
        self.t_submit = float(t_submit)
        self.phases['admission'] += delta
        if self.t_first is None:
            self.ttft_phases['admission'] += delta
        for seg in self.segments:
            seg[1] += delta
        self.segments.insert(0, [PHASES.index('admission'), 0.0, delta])

    # -- views --------------------------------------------------------------
    def e2e_s(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit

    def ttft_s(self) -> Optional[float]:
        if self.t_first is None:
            return None
        return self.t_first - self.t_submit

    def summary(self, segments: bool = False) -> Dict[str, Any]:
        e2e = self.e2e_s()
        ttft = self.ttft_s()
        attributed = sum(self.phases.values())
        residual = overcount = 0.0
        if e2e is not None:
            residual = e2e - attributed
            overcount = max(-residual, 0.0)
            residual = max(residual, 0.0)
        t_resid = t_over = 0.0
        if ttft is not None:
            t_attr = sum(self.ttft_phases.values())
            t_resid = ttft - t_attr
            t_over = max(-t_resid, 0.0)
            t_resid = max(t_resid, 0.0)
        out = {
            'request_id': self.request_id,
            'tenant': self.tenant,
            'priority': self.priority,
            'adapter_id': self.adapter_id,
            'outcome': self.outcome,
            'tokens': self.tokens,
            'failovers': self.failovers,
            'replica_id': self.replica_id,
            'e2e_s': e2e,
            'ttft_s': ttft,
            'phases': {p: v for p, v in self.phases.items() if v > 0.0},
            'ttft_phases': {p: v for p, v in self.ttft_phases.items()
                            if v > 0.0},
            'blocked': dict(self.blocked),
            'decode_fair_s': self.decode_fair_s,
            'residual_s': residual,
            'overcount_s': overcount,
            'ttft_residual_s': t_resid,
            'ttft_overcount_s': t_over,
            'wall_ts': self.wall_ts,
            # submit instant on the span clock (events._now timeline):
            # stitch_trace projects segments through the same per-process
            # skew offset every span rides
            'ts': self.t_submit - _events._EPOCH,
        }
        if segments:
            out['segments'] = [
                {'phase': PHASES[int(i)], 'start_s': round(s, 6),
                 'dur_s': round(d, 6)}
                for i, s, d in self.segments]
            out['segments_dropped'] = self.segments_dropped
        return out


def _quantile(sorted_vals: Sequence[float], p: float) -> Optional[float]:
    if not sorted_vals:
        return None
    return sorted_vals[min(int(p * len(sorted_vals)),
                           len(sorted_vals) - 1)]


class RequestLedger:
    """Aggregates finalized `RequestRecord`s; see module docstring.

    Thread model: records mutate un-locked on their driving thread;
    everything the ledger itself holds mutates under `_lock`
    (finalize arrives from engine/router/mirror threads, report() from
    scrape threads).

    Args:
        window_s: sliding window for the slowest-K exemplars and the
            p50/p99 decomposition.
        top_k: slowest exemplars (full waterfalls) kept per window.
        reservoir: reservoir-sampled exemplars kept alongside.
        slow_factor: `request_slow` fires when TTFT exceeds
            slow_factor x the SLO TTFT objective.
        slow_ttft_s: explicit SLO TTFT; None flags no request (the
            registered SLO engine's objective comes with `slo.py`).
    """

    _window = _concurrency.guarded_by('_lock', mutable=True)
    _slowest = _concurrency.guarded_by('_lock', mutable=True)
    _reservoir = _concurrency.guarded_by('_lock', mutable=True)
    _wire_buf = _concurrency.guarded_by('_lock', mutable=True)

    WINDOW_MAX = 4096
    WIRE_BUF_MAX = 2048

    def __init__(self, window_s: float = 300.0, top_k: int = 16,
                 reservoir: int = 64, slow_factor: float = 3.0,
                 slow_ttft_s: Optional[float] = None):
        self.window_s = float(window_s)
        self.top_k = int(top_k)
        self.reservoir_cap = int(reservoir)
        self.slow_factor = float(slow_factor)
        self.slow_ttft_s = slow_ttft_s
        self._lock = _concurrency.Lock('RequestLedger._lock')
        self._enabled = True
        self._window: List[Dict[str, Any]] = []
        self._slowest: List[Dict[str, Any]] = []
        self._reservoir: List[Dict[str, Any]] = []
        self._wire_buf: List[Dict[str, Any]] = []
        self._wire_dropped = 0
        self._res_seen = 0
        self._rng = random.Random(0x5eed)
        self._totals: Dict[str, float] = dict.fromkeys(PHASES, 0.0)
        self._blocked_totals: Dict[str, float] = {}
        self._residual_total = 0.0
        self._overcount_total = 0.0
        self._decode_fair_total = 0.0
        self._engine_decode_wall_s = 0.0
        self._finished = 0
        self._slow_count = 0

    # -- lifecycle -----------------------------------------------------------
    @property
    def is_enabled(self) -> bool:
        return self._enabled

    def enable(self) -> 'RequestLedger':
        self._enabled = True
        return self

    def disable(self) -> 'RequestLedger':
        """Stop opening records (the A/B bench's off arm). In-flight
        records keep accumulating and still finalize."""
        self._enabled = False
        return self

    def reset(self):
        with self._lock:
            self._window.clear()
            self._slowest.clear()
            self._reservoir.clear()
            self._wire_buf.clear()
            self._wire_dropped = 0
            self._res_seen = 0
            self._totals = dict.fromkeys(PHASES, 0.0)
            self._blocked_totals = {}
            self._residual_total = 0.0
            self._overcount_total = 0.0
            self._decode_fair_total = 0.0
            self._engine_decode_wall_s = 0.0
            self._finished = 0
            self._slow_count = 0

    # -- record creation / engine helpers ------------------------------------
    def open(self, request_id: int, t_submit: float,
             tenant: Optional[str] = None, priority: Optional[int] = None,
             adapter_id: Optional[str] = None) -> Optional[RequestRecord]:
        if not self._enabled:
            return None
        rec = RequestRecord(request_id, t_submit, tenant=tenant,
                            priority=priority, adapter_id=adapter_id)
        rec._owner = self
        return rec

    def open_for(self, handle) -> Optional[RequestRecord]:
        """Create + attach a record for a request handle (engine submit
        path). Returns None while disabled."""
        rec = self.open(handle.request_id, handle._t_submit,
                        priority=getattr(handle, 'priority', None),
                        adapter_id=getattr(handle, 'adapter_id', None))
        handle._ledger_rec = rec
        return rec

    def note_round(self, dur: float, records: Sequence[RequestRecord],
                   phase: str = 'decode', now: Optional[float] = None,
                   absorb: bool = False):
        """One batched decode/speculation round of wall `dur` with these
        participants: waterfall book charges each the FULL round wall,
        fair-share book splits it evenly, and the engine decode wall
        accumulates once — the two closure invariants' raw material.

        `absorb=True` additionally charges each participant the idle
        gap since its record was last touched (a single-threaded driver
        serializes replicas, so an active request waits out the OTHER
        replicas' rounds between its own — that wait is part of its
        decode period, and leaving it in the residual would break the
        1% closure the tier-1 tests pin). The fair-share book never
        absorbs: it stays round_wall / n so it closes to the engine
        decode wall, not the driver wall."""
        recs = [r for r in records if r is not None]
        if dur <= 0.0 or not recs:
            return
        end = time.perf_counter() if now is None else now
        share = dur / len(recs)
        for rec in recs:
            d = dur
            if absorb:
                d = max(dur, end - rec._last_touch)
            rec.add(phase, d, now=end)
            rec.fair_decode(share)
        with self._lock:
            self._engine_decode_wall_s += dur

    def note_prefill(self, dur: float, owner: Optional[RequestRecord],
                     seated: Sequence[RequestRecord],
                     now: Optional[float] = None):
        """One prefill (whole or chunk) of wall `dur`: the owner books
        `prefill`; every OTHER seated request books `prefill_wait` —
        the chunked-prefill convoy, named instead of smeared. Like
        `note_round(absorb=True)`, each participant also absorbs the
        idle gap since its last touch (per-chunk python dispatch
        overhead between spans would otherwise pile into residuals)."""
        if dur <= 0.0:
            return
        end = time.perf_counter() if now is None else now
        if owner is not None:
            owner.add('prefill', max(dur, end - owner._last_touch),
                      now=end)
        for rec in seated:
            if rec is not None and rec is not owner:
                rec.add('prefill_wait',
                        max(dur, end - rec._last_touch), now=end)

    def engine_decode_wall_s(self) -> float:
        with self._lock:
            return self._engine_decode_wall_s

    # -- finalize -------------------------------------------------------------
    def finalize(self, handle, now: Optional[float] = None,
                 outcome: Optional[str] = None):
        """Close a handle's record into the books (idempotent: the first
        caller wins — engine retire, mirror update, or router reap).
        Routes to the record's OWNING ledger, so handle hooks can always
        call through the default singleton."""
        rec = getattr(handle, '_ledger_rec', None)
        if rec is None:
            return
        (rec._owner or self).finalize_record(
            rec,
            now=now if now is not None else getattr(handle, '_t_done',
                                                    None),
            outcome=outcome,
            tokens=len(getattr(handle, 'tokens', ()) or ()))

    def finalize_record(self, rec: RequestRecord,
                        now: Optional[float] = None,
                        outcome: Optional[str] = None, tokens: int = 0):
        if rec.t_done is not None:
            return   # already closed (failover/reap double-report)
        end = time.perf_counter() if now is None else now
        rec.queue_exit(end)   # a failed request may die still queued
        rec.t_done = end
        rec.outcome = outcome or 'completed'
        rec.tokens = int(tokens)
        rec.wall_ts = time.time()
        summ = rec.summary()
        wf = rec.summary(segments=True)
        with self._lock:
            self._finished += 1
            for p, v in rec.phases.items():
                self._totals[p] += v
            for r, v in rec.blocked.items():
                self._blocked_totals[r] = \
                    self._blocked_totals.get(r, 0.0) + v
            self._residual_total += summ['residual_s']
            self._overcount_total += summ['overcount_s']
            self._decode_fair_total += rec.decode_fair_s
            self._window.append(summ)
            if len(self._window) > self.WINDOW_MAX:
                del self._window[:len(self._window) - self.WINDOW_MAX]
            self._res_seen += 1
            self._note_exemplar(wf)
            if len(self._wire_buf) < self.WIRE_BUF_MAX:
                self._wire_buf.append(wf)
            else:
                self._wire_dropped += 1
        self._maybe_slow(summ)

    def _note_exemplar(self, wf: Dict[str, Any]):
        # caller holds self._lock and has already counted this record
        # into _res_seen (the reservoir's 1-indexed item number)
        horizon = wf['wall_ts'] - self.window_s
        self._slowest = [w for w in self._slowest
                         if w['wall_ts'] >= horizon]
        self._slowest.append(wf)
        self._slowest.sort(key=lambda w: -(w['e2e_s'] or 0.0))
        del self._slowest[self.top_k:]
        if len(self._reservoir) < self.reservoir_cap:
            self._reservoir.append(wf)
        else:
            j = self._rng.randrange(self._res_seen)
            if j < self.reservoir_cap:
                self._reservoir[j] = wf

    def _slow_threshold_s(self) -> Optional[float]:
        base = self.slow_ttft_s
        if base is None:
            return None
        return base * self.slow_factor

    def _maybe_slow(self, summ: Dict[str, Any]):
        thr = self._slow_threshold_s()
        ttft = summ['ttft_s']
        if thr is None or ttft is None or ttft <= thr:
            return
        phases = summ['ttft_phases'] or summ['phases']
        driver = max(phases, key=phases.get) if phases else 'residual'
        with self._lock:
            self._slow_count += 1
        # one pathological request captures its own postmortem: the
        # flight recorder triggers on this event and bundles
        # requests.json alongside the trace tail
        _events.emit('request_slow', request_id=summ['request_id'],
                     tenant=summ['tenant'], ttft_s=round(ttft, 4),
                     threshold_s=round(thr, 4), driver=driver,
                     failovers=summ['failovers'])

    # -- wire plane -----------------------------------------------------------
    def drain_wire_records(self) -> List[Dict[str, Any]]:
        """Hand the finalized-record backlog to the Shipper (each call
        drains; re-ship idempotence rides the segment seq, as for every
        other kind)."""
        with self._lock:
            out, self._wire_buf = self._wire_buf, []
            return out

    # -- the books ------------------------------------------------------------
    def report(self, top: Optional[int] = None,
               now: Optional[float] = None) -> Dict[str, Any]:
        """The `/requests` payload: per-phase decomposition percentiles
        over the window, the p99-driver ranking, blocked-reason ranking,
        slowest-K waterfalls + reservoir exemplars, closure totals."""
        wall_now = time.time() if now is None else now
        horizon = wall_now - self.window_s
        with self._lock:
            window = [s for s in self._window
                      if (s['wall_ts'] or 0.0) >= horizon]
            slowest = [dict(w) for w in self._slowest
                       if w['wall_ts'] >= horizon]
            exemplars = [dict(w) for w in self._reservoir]
            totals = dict(self._totals)
            blocked = dict(self._blocked_totals)
            closure = {
                'finished': self._finished,
                'attributed_s': sum(self._totals.values()),
                'residual_s': self._residual_total,
                'overcount_s': self._overcount_total,
                'decode_fair_s': self._decode_fair_total,
                'engine_decode_wall_s': self._engine_decode_wall_s,
                'slow_requests': self._slow_count,
                'wire_records_dropped': self._wire_dropped,
            }
        e2es = sorted(s['e2e_s'] for s in window
                      if s['e2e_s'] is not None)
        ttfts = sorted(s['ttft_s'] for s in window
                       if s['ttft_s'] is not None)
        decomposition = {}
        for p in PHASES + ('residual',):
            vals = sorted((s['phases'].get(p, 0.0) if p != 'residual'
                           else s['residual_s']) for s in window)
            if vals and vals[-1] > 0.0:
                decomposition[p] = {
                    'p50_s': _quantile(vals, 0.50),
                    'p99_s': _quantile(vals, 0.99),
                    'mean_s': sum(vals) / len(vals),
                }
        # p99 driver: among the tail cohort (e2e >= p99), which phase
        # holds the most seconds — the ranking IS the answer to "where
        # did my p99 go"
        driver_ranking: List[Dict[str, Any]] = []
        p99_driver = None
        p99 = _quantile(e2es, 0.99)
        if p99 is not None:
            tail = [s for s in window
                    if s['e2e_s'] is not None and s['e2e_s'] >= p99]
            sums: Dict[str, float] = {}
            for s in tail:
                for p, v in s['phases'].items():
                    sums[p] = sums.get(p, 0.0) + v
                sums['residual'] = sums.get('residual', 0.0) \
                    + s['residual_s']
            total = sum(sums.values()) or 1.0
            driver_ranking = [
                {'phase': p, 'seconds': v, 'share': v / total}
                for p, v in sorted(sums.items(), key=lambda kv: -kv[1])
                if v > 0.0]
            if driver_ranking:
                p99_driver = driver_ranking[0]['phase']
        blocked_ranking = [
            {'reason': r, 'seconds': v}
            for r, v in sorted(blocked.items(), key=lambda kv: -kv[1])]
        return {
            'enabled': self._enabled,
            'window_s': self.window_s,
            'window_requests': len(window),
            'e2e_p50_s': _quantile(e2es, 0.50),
            'e2e_p99_s': p99,
            'ttft_p50_s': _quantile(ttfts, 0.50),
            'ttft_p99_s': _quantile(ttfts, 0.99),
            'phases': decomposition,
            'p99_driver': p99_driver,
            'p99_driver_ranking': driver_ranking,
            'blocked_ranking': blocked_ranking,
            'phase_totals': totals,
            'blocked_totals': blocked,
            'closure': closure,
            'slowest': slowest[:top] if top is not None else slowest,
            'exemplars': exemplars,
        }


_ledger = RequestLedger()


def get_ledger() -> RequestLedger:
    return _ledger


def enabled() -> bool:
    """Instrumentation-site fast path: is the default ledger opening
    records right now?"""
    return _ledger._enabled


def _reqledger_collector(reg: '_metrics.MetricsRegistry'):
    """Scrape-time mirror of the default ledger (mirror, not accumulate
    — the contract every collector follows). Residual rides the phase
    label so `sum(paddle_request_phase_seconds_total)` is the fleet's
    total accounted request time."""
    with _ledger._lock:
        totals = dict(_ledger._totals)
        blocked = dict(_ledger._blocked_totals)
        residual = _ledger._residual_total
        overcount = _ledger._overcount_total
        fair = _ledger._decode_fair_total
        wall = _ledger._engine_decode_wall_s
        finished = _ledger._finished
        slow = _ledger._slow_count
    secs = reg.counter('paddle_request_phase_seconds_total',
                       'seconds attributed per request-ledger phase '
                       'across finished requests', ('phase',))
    for p, v in list(totals.items()) + [('residual', residual)]:
        secs.labels(phase=p).value = max(float(v), 0.0)   # mirror
    blk = reg.counter('paddle_request_queue_blocked_seconds_total',
                      'queue_wait seconds partitioned by the sampled '
                      'blocking reason', ('reason',))
    for r, v in blocked.items():
        blk.labels(reason=r).value = max(float(v), 0.0)   # mirror
    reg.counter('paddle_requests_finished_total',
                'requests finalized into the request ledger'
                )._sole().value = float(finished)          # mirror
    reg.counter('paddle_requests_slow_total',
                'requests whose TTFT crossed the request_slow '
                'threshold (N x SLO)')._sole().value = float(slow)
    reg.gauge('paddle_request_overcount_seconds',
              'attributed request seconds beyond measured E2E '
              '(clipped out of residuals)').set(overcount)
    reg.counter('paddle_request_decode_fair_seconds_total',
                'fair-share decode seconds across finished requests '
                '(sums to the engine decode wall)'
                )._sole().value = max(float(fair), 0.0)    # mirror
    reg.counter('paddle_request_decode_wall_seconds_total',
                'engine decode/speculation round wall seconds the '
                'ledger observed')._sole().value = \
        max(float(wall), 0.0)                              # mirror


def install():
    """Idempotent: register the default ledger's scrape-time collector
    (runs at package import; the ledger itself is always on)."""
    _metrics.get_registry().register_collector(_reqledger_collector)
