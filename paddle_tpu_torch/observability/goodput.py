"""Goodput ledger: explain every wall-clock second of a run (a copy of
`paddle_tpu/observability/goodput.py`, with the MFU window that the
program catalog's roofline (`cost.py`) divides through).

A ledger that classifies 100% of wall time into productive vs. overhead
categories, with the unexplained remainder reported as an explicit
residual, never hidden inside a category it does not belong to
(MegaScale's goodput diagnostics, arXiv:2402.15627).

The `GoodputLedger` is an `EventLog` listener: every span the runtime
records (serving prefill/decode, drain, checkpoint save/restore, retry
backoff, ...) is mapped by name into one of the taxonomy's categories.
Per-thread interval bookkeeping subtracts nested spans from their
parents, so a decode round inside a drain counts once, as serving
decode, and the drain keeps only its own surplus. A `bad_step` event
moves the last step's seconds from `step_compute` to `rollback`.

In the port's serving engine the decode-round spans close after the
round's token fetch, which waits for the device, and the prefill spans
after the prefill's device sync: `serving_decode` and `serving_prefill`
hold the device time of the rounds and prefills, not only their launch.

The invariant: `sum(categories) + residual == wall_seconds` exactly
(residual is computed as the difference and reported, including the
`overcount` case where concurrent threads attribute more busy seconds
than one wall clock holds).

Always on (installed at package import, like the flight recorder);
`stop()`/`start()` detach/reattach the listener for A/B measurement,
`reset()` opens a fresh measurement window. Ledger state mirrors into
`paddle_goodput_seconds_total{category}` / `paddle_goodput_fraction` /
`paddle_goodput_wall_seconds_total` at scrape time.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from . import events as _events
from . import metrics as _metrics
from ..analysis.runtime import concurrency as _concurrency

# the exhaustive, non-overlapping taxonomy (order = report order).
# 'residual' is computed, not accumulated: wall - sum(attributed).
CATEGORIES = (
    'step_compute',        # productive train-step device+host time
    'compile',             # program trace + compile (no port span yet)
    'checkpoint_save',
    'checkpoint_restore',
    'retry_backoff',       # transient-error backoff sleeps
    'rollback',            # wasted bad-step compute + snapshot restore
    'remesh',              # elastic shrink/grow transitions
    'preemption_drain',    # serving graceful-drain surplus
    'weight_swap',         # trainer→serving hot-swap (drain/load/
                           # verify/rejoin surplus; nested decode keeps
                           # serving while a replica drains)
    'scale_up',            # autoscaler replica provisioning (engine
                           # build + program-store warm load)
    'scale_down',          # autoscaler cordon/removal surplus (nested
                           # decode during the drain stays serving)
    'serving_prefill',
    'serving_decode',
    'host_wait',           # data-loader / input-pipeline wait
)

# span name -> category. Spans not listed here (profiler RecordEvent
# user regions, serving queue spans on requester threads) are ignored:
# their time stays in whatever enclosing category covers it, or in the
# residual — which is the honest answer for unclassified work.
SPAN_CATEGORIES: Dict[str, str] = {
    'train.step': 'step_compute',
    'fleet.dist_train_step': 'step_compute',
    'bench.eager_step': 'step_compute',
    'step.compute': 'step_compute',
    'jit.trace': 'compile',
    'jit.compile': 'compile',
    'checkpoint_save': 'checkpoint_save',
    'checkpoint_restore': 'checkpoint_restore',
    'resilience.backoff': 'retry_backoff',
    'resilience.rollback': 'rollback',
    'elastic.resize': 'remesh',
    'serving.drain': 'preemption_drain',
    # the rolling weight swap: sub-spans (drain wait, store load+verify,
    # health gate, rejoin) all book as weight_swap; decode rounds nested
    # inside the drain wait stay serving_decode — the fleet kept serving
    'hotswap.swap': 'weight_swap',
    'hotswap.drain': 'weight_swap',
    'hotswap.load': 'weight_swap',
    'hotswap.verify': 'weight_swap',
    'hotswap.rejoin': 'weight_swap',
    'hotswap.rollback': 'weight_swap',
    # autoscaling: provisioning books as scale_up; the cordon/removal
    # bookkeeping as scale_down — the drain itself is NOT wrapped, so
    # decode rounds finishing the victim's work stay serving_decode
    # (the fleet kept serving; only the machinery is overhead)
    'autoscale.provision': 'scale_up',
    'autoscale.retire': 'scale_down',
    'serving.prefill': 'serving_prefill',
    'serving.prefill_chunk': 'serving_prefill',
    'serving.draft_prefill': 'serving_prefill',
    'serving.decode_round': 'serving_decode',
    'serving.spec_round': 'serving_decode',
    'step.data_wait': 'host_wait',
    'step.host_wait': 'host_wait',
}

# per-thread attributed-interval lists are pruned to this many entries;
# a parent span arriving after its children were pruned would double
# count, but parents always arrive within one span depth of their
# children so the horizon only needs to cover one step's fan-out
_MAX_INTERVALS = 256


class GoodputLedger:
    """Classifies wall time from the span stream; see module docstring.

    Thread model: `on_event` is called by EventLog.append from whatever
    thread ended the span; all state mutates under one lock. Per-thread
    interval lists make the nested-span subtraction exact for the
    strictly-nested spans one thread produces; across threads, busy
    seconds can legitimately exceed one wall clock (a serving engine
    decoding while the trainer steps) — that surplus is reported as
    `overcount_seconds`, never silently clipped.
    """

    def __init__(self, log: Optional[_events.EventLog] = None,
                 span_map: Optional[Dict[str, str]] = None):
        # `is None`, not truthiness: an empty EventLog is falsy
        self._log = _events.get_event_log() if log is None else log
        self._map = dict(span_map or SPAN_CATEGORIES)
        self._lock = _concurrency.Lock('GoodputLedger._lock')
        self._seconds: Dict[str, float] = {c: 0.0 for c in CATEGORIES}
        self._intervals: Dict[int, List[Tuple[float, float]]] = {}
        # tid -> seconds the most recent step-span attributed (the
        # bad_step reclassification target)
        self._last_step: Dict[int, float] = {}
        self._t0 = _events._now()
        self._running = False
        # per-program invocation counts at window start: the MFU
        # baseline (cost.record_roofline / aggregate_mfu divide the
        # window's executed FLOPs by the window's WALL seconds)
        self._mfu_baseline: Dict[str, int] = {}

    # -- lifecycle -----------------------------------------------------------
    def start(self, reset: bool = False) -> 'GoodputLedger':
        """Attach to the event log (idempotent); `reset=True` also opens
        a fresh measurement window."""
        if reset:
            self.reset()
        if not self._running:
            self._running = True
            self._log.add_listener(self.on_event)
        return self

    def stop(self) -> 'GoodputLedger':
        """Detach from the event log; accumulated seconds survive (the
        A/B bench arms toggle this)."""
        self._running = False
        self._log.remove_listener(self.on_event)
        return self

    @property
    def running(self) -> bool:
        return self._running

    def reset(self):
        """Open a fresh window: zero every category, forget intervals,
        restart the wall clock at now, and re-baseline the MFU window
        (per-program invocation counts as of now)."""
        try:
            from .cost import get_catalog
            baseline = {r.name: r.invocations
                        for r in get_catalog().records()}
        except Exception:  # paddle-lint: disable=swallowed-exception -- catalog optional at reset; empty baseline just disables per-program MFU deltas
            baseline = {}
        with self._lock:
            self._seconds = {c: 0.0 for c in CATEGORIES}
            self._intervals.clear()
            self._last_step.clear()
            self._t0 = _events._now()
            self._mfu_baseline = baseline

    def mfu_window(self) -> 'Tuple[float, Dict[str, int]]':
        """(wall seconds since the last reset, invocation baseline at
        that reset) — the window cost.py's MFU/roofline math divides
        through."""
        with self._lock:
            return (max(_events._now() - self._t0, 0.0),
                    dict(self._mfu_baseline))

    # -- attribution ---------------------------------------------------------
    def on_event(self, event: Dict[str, Any]):
        name = event.get('name')
        if event.get('ph') == 'X':
            cat = self._map.get(name)
            if cat is None:
                return
            self._attribute(event.get('tid', 0), float(event['ts']),
                            float(event.get('dur', 0.0)), cat,
                            depth=event.get('depth'))
        elif name == 'bad_step':
            self._reclassify_last_step(event.get('tid', 0), 'rollback')

    def note_span(self, name: str, ts: float, dur: float,
                  tid: Optional[int] = None):
        """Direct-feed path for span-shaped regions that never touch the
        event log (regions frequent enough to flush the bounded ring)."""
        if not self._running:
            return
        cat = self._map.get(name)
        if cat is None:
            return
        self._attribute(threading.get_ident() if tid is None else tid,
                        float(ts), float(dur), cat)

    def _attribute(self, tid: int, ts: float, dur: float,
                   cat: str, depth: Optional[int] = None) -> float:
        end = ts + dur
        with self._lock:
            if end <= self._t0:
                return 0.0   # span entirely before this window
            ts = max(ts, self._t0)    # clip spans straddling a reset
            dur = end - ts            # credit only the in-window part
            ivs = self._intervals.setdefault(tid, [])
            # children end (and arrive) before their parents, so any
            # already-attributed overlap on this thread is nested work
            # that must NOT count again under the parent's category
            overlap = 0.0
            kept = []
            for s, e in ivs:
                if e > ts and s < end:
                    overlap += min(e, end) - max(s, ts)
                    ts_u, end_u = min(ts, s), max(end, e)
                    ts, end = ts_u, end_u   # grow the union in place
                else:
                    kept.append((s, e))
            if depth == 1:
                # a TOP-LEVEL span just closed on this thread: no open
                # ancestor exists, so nothing recorded so far (this span
                # included) can overlap any later span — drop the
                # bookkeeping outright. Steady-state cost is O(1); the
                # capped scan only pays inside deep nesting.
                kept = []
            else:
                kept.append((ts, end))
                kept.sort()
                if len(kept) > _MAX_INTERVALS:
                    kept = kept[-_MAX_INTERVALS:]
            self._intervals[tid] = kept
            credit = max(dur - overlap, 0.0)
            self._seconds[cat] += credit
            if cat == 'step_compute':
                # remembered so bad_step can take this step's time back
                self._last_step[tid] = credit
            return credit

    def _reclassify_last_step(self, tid: int, to_cat: str):
        """A bad step's compute was waste, not goodput: move the most
        recent step-span credit on this thread into `to_cat`."""
        with self._lock:
            moved = self._last_step.pop(tid, 0.0)
            if moved > 0:
                self._seconds['step_compute'] -= moved
                self._seconds[to_cat] += moved

    # -- the books -----------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        """Close the books on the current window.

        categories + residual always sum to wall_seconds exactly;
        `overcount_seconds` carries any cross-thread surplus (busy
        seconds beyond one wall clock) that was clipped OUT of the
        residual so fractions stay in [0, 1]."""
        now = _events._now()
        with self._lock:
            wall = max(now - self._t0, 0.0)
            cats = dict(self._seconds)
        attributed = sum(cats.values())
        residual = wall - attributed
        overcount = max(-residual, 0.0)
        residual = max(residual, 0.0)
        # normalize by the larger of wall and attributed: when
        # concurrent threads attribute more busy seconds than one wall
        # clock holds, fractions are shares of total accounted time and
        # still sum to 1 (the surplus itself rides overcount_seconds)
        denom = max(wall, attributed) or 1.0
        fractions = {c: v / denom for c, v in cats.items()}
        fractions['residual'] = residual / denom
        return {
            'running': self._running,
            'wall_seconds': wall,
            'categories': cats,
            'attributed_seconds': attributed,
            'residual_seconds': residual,
            'overcount_seconds': overcount,
            'fractions': fractions,
        }

    def report_text(self, max_width: int = 40) -> str:
        """Human-readable ledger table (examples print this at exit)."""
        r = self.report()
        lines = [f'goodput ledger: {r["wall_seconds"]:.3f} s wall '
                 f'({"running" if r["running"] else "stopped"})',
                 f'  {"category":<20}{"seconds":>10}{"fraction":>10}']
        rows = list(r['categories'].items()) \
            + [('residual', r['residual_seconds'])]
        for cat, secs in rows:
            frac = r['fractions'][cat]
            bar = '#' * int(round(frac * 20))
            lines.append(f'  {cat:<20}{secs:>10.3f}{frac:>10.1%}  {bar}')
        if r['overcount_seconds'] > 0:
            lines.append(f'  (+{r["overcount_seconds"]:.3f} s busy beyond '
                         f'one wall clock: concurrent threads)')
        return '\n'.join(lines)


_ledger = GoodputLedger()


def get_ledger() -> GoodputLedger:
    return _ledger


def _goodput_collector(reg: '_metrics.MetricsRegistry'):
    """Scrape-time mirror of the default ledger (mirror, not accumulate
    — the same contract every other collector follows). Residual rides
    the category label so `sum(paddle_goodput_seconds_total)` IS the
    wall clock; fractions are gauges the fleet merge recomputes."""
    r = _ledger.report()
    secs = reg.counter('paddle_goodput_seconds_total',
                       'wall seconds attributed per goodput category',
                       ('category',))
    frac = reg.gauge('paddle_goodput_fraction',
                     'fraction of wall time per goodput category',
                     ('category',))
    wall = reg.counter('paddle_goodput_wall_seconds_total',
                       'wall seconds covered by the goodput ledger '
                       'window')
    over = reg.gauge('paddle_goodput_overcount_seconds',
                     'attributed busy seconds beyond one wall clock '
                     '(concurrent threads)')
    rows = list(r['categories'].items()) \
        + [('residual', r['residual_seconds'])]
    for cat, v in rows:
        secs.labels(category=cat).value = max(float(v), 0.0)   # mirror
        frac.labels(category=cat).set(r['fractions'][cat])
    wall._sole().value = float(r['wall_seconds'])              # mirror
    over.set(r['overcount_seconds'])


def install():
    """Idempotent: start the always-on default ledger and register its
    scrape-time collector (runs at package import)."""
    _metrics.get_registry().register_collector(_goodput_collector)
    _ledger.start()
