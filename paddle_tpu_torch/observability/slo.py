"""SLO engine: declarative objectives, multi-window burn rates,
breach-triggered capture (a copy of `paddle_tpu/observability/slo.py`).

Metrics alone answer "what is the p99 right now"; an operator needs
"are we burning the error budget fast enough to page, and what was the
process doing when we crossed the line". This module is the standard
SRE answer (multi-window multi-burn-rate alerting) wired into the
machinery this repo already has:

- **Objectives are declarative**: `Objective.latency_p99` judges a
  windowed-quantile gauge against a latency bound (TTFT p99 vs the
  serving SLO), `Objective.ratio` judges bad/total counter pairs
  (availability from `paddle_router_requests_total{outcome=...}`,
  shed rate from `paddle_router_shed_total`). Each carries an error
  BUDGET — the allowed bad fraction.
- **Evaluated over the aggregated fleet view** when a view function is
  given (the Aggregator's `merged()` doc — the same shape
  `merge_snapshots` produces), falling back to the local registry
  snapshot, so one engine definition works single-process and fleet.
- **Multi-window burn rates**: each `poll()` appends the tick's bad
  fraction to a short (default 5 m) and a long (default 1 h) sliding
  window; burn = mean bad fraction / budget. The alert fires only
  when BOTH windows exceed the burn threshold — the short window gives
  fast detection, the long window keeps a transient blip from paging —
  and clears when the short window recovers.
- **Breaches capture their own evidence**: the `slo_breach` event is a
  flight-recorder trigger (the bundle carries rings, metrics, traces,
  and this engine's burn state), and when a capture directory is
  configured the engine additionally starts a BOUNDED
  `torch.profiler` capture on a thread of its own (stopped after
  `capture_s` — a breach must never leave an unbounded profiler
  running), where the JAX package starts `jax.profiler.trace`; the
  capture writes a chrome trace into the capture directory.

Gauges published per objective: `paddle_slo_error_budget_remaining`
(1.0 = untouched budget, 0.0 = fully burned over the long window),
`paddle_slo_burn_rate{slo,window}`, and `paddle_slo_alerting`.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import metrics as _metrics
from ..analysis.runtime import concurrency as _concurrency

DEFAULT_SHORT_WINDOW_S = 300.0     # 5 m: fast detection
DEFAULT_LONG_WINDOW_S = 3600.0     # 1 h: sustained confirmation
DEFAULT_BURN_ALERT = 10.0          # page when burning 10x budget


def _view_samples(view: Dict[str, Any], name: str
                  ) -> List[Dict[str, Any]]:
    for m in view.get('metrics', []):
        if m['name'] == name:
            return list(m.get('samples', []))
    return []


def _sum_matching(view: Dict[str, Any], name: str,
                  match: Optional[Dict[str, str]] = None) -> float:
    total = 0.0
    for s in _view_samples(view, name):
        labels = s.get('labels', {})
        if match and not all(labels.get(k) == v
                             for k, v in match.items()):
            continue
        total += float(s.get('value', 0.0))
    return total


def _max_value(view: Dict[str, Any], name: str) -> Optional[float]:
    vals = [float(s.get('value', 0.0)) for s in _view_samples(view, name)]
    return max(vals) if vals else None


@dataclasses.dataclass
class Objective:
    """One declarative SLO. Use the constructors — `kind` selects how a
    tick's bad fraction is computed from the (fleet) view:

    - `latency_p99`: gauge `metric` (a windowed-quantile gauge; the
      fleet merge takes the worst process) against `threshold_s`; the
      tick is bad (1.0) while the quantile sits over the bound.
    - `ratio`: bad/total counter families with optional label matches;
      the tick's bad fraction is d(bad)/d(total) since the last poll
      (no traffic → no data → the tick is skipped, honestly).
    """

    name: str
    kind: str                       # 'latency_p99' | 'ratio'
    budget: float                   # allowed bad fraction, e.g. 0.001
    description: str = ''
    metric: str = ''                # latency_p99: the quantile gauge
    threshold_s: float = 0.0
    bad: Sequence[Tuple[str, Optional[Dict[str, str]]]] = ()
    total: Sequence[Tuple[str, Optional[Dict[str, str]]]] = ()

    def __post_init__(self):
        if not 0.0 < self.budget < 1.0:
            raise ValueError(f'budget must be in (0, 1); '
                             f'got {self.budget}')
        if self.kind not in ('latency_p99', 'ratio'):
            raise ValueError(f'unknown objective kind {self.kind!r}')

    @staticmethod
    def latency_p99(name: str, metric: str, threshold_s: float,
                    budget: float, description: str = '') -> 'Objective':
        return Objective(name=name, kind='latency_p99', budget=budget,
                         metric=metric, threshold_s=float(threshold_s),
                         description=description
                         or f'{metric} <= {threshold_s}s')

    @staticmethod
    def ratio(name: str, bad, total, budget: float,
              description: str = '') -> 'Objective':
        def norm(spec):
            out = []
            for item in (spec if isinstance(spec, (list, tuple))
                         and spec and isinstance(spec[0], (list, tuple))
                         else [spec]):
                if isinstance(item, str):
                    out.append((item, None))
                else:
                    nm, match = item
                    out.append((nm, dict(match) if match else None))
            return tuple(out)
        return Objective(name=name, kind='ratio', budget=budget,
                         bad=norm(bad), total=norm(total),
                         description=description or name)


def default_objectives(slo_ttft_s: float = 1.0) -> List[Objective]:
    """The serving objectives: TTFT p99 against the
    latency SLO, availability (failed / routed), shed rate (shed /
    offered = routed + shed)."""
    routed = ('paddle_router_requests_total', None)
    shed = ('paddle_router_shed_total', None)
    return [
        Objective.latency_p99(
            'ttft_p99', 'paddle_ttft_p99_window', slo_ttft_s,
            budget=0.05,
            description=f'router TTFT p99 under {slo_ttft_s}s'),
        Objective.ratio(
            'availability',
            bad=('paddle_router_requests_total', {'outcome': 'failed'}),
            total=[routed], budget=0.01,
            description='routed requests that fail'),
        Objective.ratio(
            'shed_rate', bad=[shed], total=[routed, shed], budget=0.05,
            description='offered load rejected by admission control'),
    ]


class SLOEngine:
    """Evaluate objectives over sliding windows; alert on multi-window
    burn; capture on breach.

    Args:
        objectives: the declarative objective list.
        view_fn: zero-arg callable returning a merged metrics doc (an
            `Aggregator.merged()`; None → the local registry snapshot,
            which shares the shape), or an
            `aggregator.FleetSignalSource`, whose `merged_view` it reads.
        clock: injectable monotonic clock — windows and tests run on it.
        short_window_s / long_window_s / burn_alert: the multi-window
            burn-rate alert shape.
        capture_dir: when set, a breach starts a bounded
            `torch.profiler` capture here for `capture_s` seconds.
        flight: emit `slo_breach` (a flight-recorder trigger) on alert
            transitions (off for engines running inside benches).
    """

    def __init__(self, objectives: Optional[Sequence[Objective]] = None,
                 view_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 short_window_s: float = DEFAULT_SHORT_WINDOW_S,
                 long_window_s: float = DEFAULT_LONG_WINDOW_S,
                 burn_alert: float = DEFAULT_BURN_ALERT,
                 capture_dir: Optional[str] = None,
                 capture_s: float = 3.0,
                 flight: bool = True):
        if long_window_s <= short_window_s:
            raise ValueError('long_window_s must exceed short_window_s')
        self.objectives = list(objectives if objectives is not None
                               else default_objectives())
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f'duplicate objective names in {names}')
        if hasattr(view_fn, 'merged_view'):       # a FleetSignalSource
            view_fn = view_fn.merged_view
        self._view_fn = view_fn
        self._clock = clock
        self.short_window_s = float(short_window_s)
        self.long_window_s = float(long_window_s)
        self.burn_alert = float(burn_alert)
        self.capture_dir = capture_dir
        self.capture_s = float(capture_s)
        self._flight = bool(flight)
        self._lock = _concurrency.Lock('SLOEngine._lock')
        self._windows: Dict[str, Tuple[Any, Any]] = {}
        for o in self.objectives:
            self._windows[o.name] = (
                _metrics.SlidingWindow(self.short_window_s, clock=clock),
                _metrics.SlidingWindow(self.long_window_s, clock=clock))
        self._counter_base: Dict[str, Tuple[float, float]] = {}
        self._alerting: Dict[str, bool] = {o.name: False
                                           for o in self.objectives}
        self._breaches: List[Dict[str, Any]] = []
        self._capturing = False
        reg = _metrics.get_registry()
        self._m_budget = reg.gauge(
            'paddle_slo_error_budget_remaining',
            'fraction of the error budget left over the long burn '
            'window (1 = untouched, 0 = fully burned)', ('slo',))
        self._m_burn = reg.gauge(
            'paddle_slo_burn_rate',
            'error-budget burn rate (bad fraction / budget) per '
            'window', ('slo', 'window'))
        self._m_alerting = reg.gauge(
            'paddle_slo_alerting',
            '1 while the multi-window burn alert is firing', ('slo',))
        self._m_breaches = reg.counter(
            'paddle_slo_breaches_total',
            'burn-rate alert transitions into firing', ('slo',))

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def _view(self) -> Dict[str, Any]:
        if self._view_fn is not None:
            return self._view_fn()
        return _metrics.get_registry().snapshot()

    def _tick_bad_fraction(self, o: Objective,
                           view: Dict[str, Any]) -> Optional[float]:
        if o.kind == 'latency_p99':
            v = _max_value(view, o.metric)
            if v is None:
                return None
            return 1.0 if v > o.threshold_s else 0.0
        bad = sum(_sum_matching(view, nm, match) for nm, match in o.bad)
        total = sum(_sum_matching(view, nm, match)
                    for nm, match in o.total)
        base = self._counter_base.get(o.name)
        self._counter_base[o.name] = (bad, total)
        if base is None:
            return None    # first poll: no interval to judge yet
        d_bad, d_total = bad - base[0], total - base[1]
        if d_total <= 0:
            return None    # no traffic this tick: no evidence either way
        return min(max(d_bad / d_total, 0.0), 1.0)

    def poll(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One evaluation tick: read the view, update every objective's
        windows/gauges, fire or clear alerts. Returns `report()`."""
        del now   # windows read the injected clock directly
        view = self._view()
        fired: List[str] = []
        recovered: List[str] = []
        with self._lock:
            for o in self.objectives:
                frac = self._tick_bad_fraction(o, view)
                short, long_ = self._windows[o.name]
                if frac is not None:
                    short.observe(frac)
                    long_.observe(frac)
                burn_s = self._burn(short, o)
                burn_l = self._burn(long_, o)
                remaining = self._budget_remaining(long_, o)
                alert = (burn_s is not None and burn_l is not None
                         and burn_s >= self.burn_alert
                         and burn_l >= self.burn_alert)
                # latch: fire when BOTH windows burn hot, clear only
                # when the short (detection) window cools back down
                was = self._alerting[o.name]
                now_alerting = was
                if alert and not was:
                    now_alerting = True
                    fired.append(o.name)
                    self._breaches.append({
                        'slo': o.name, 'wall_ts': time.time(),
                        'burn_short': burn_s, 'burn_long': burn_l,
                        'budget_remaining': remaining})
                elif was and burn_s is not None \
                        and burn_s < self.burn_alert:
                    now_alerting = False
                    recovered.append(o.name)
                self._alerting[o.name] = now_alerting
                if _metrics.enabled():
                    if burn_s is not None:
                        self._m_burn.labels(
                            slo=o.name, window='short').set(burn_s)
                    if burn_l is not None:
                        self._m_burn.labels(
                            slo=o.name, window='long').set(burn_l)
                    if remaining is not None:
                        self._m_budget.labels(slo=o.name).set(remaining)
                    self._m_alerting.labels(slo=o.name).set(
                        1.0 if self._alerting[o.name] else 0.0)
        for name in fired:
            if _metrics.enabled():
                self._m_breaches.labels(slo=name).inc()
            if self._flight:
                from .events import emit
                last = self._breaches[-1]
                emit('slo_breach', slo=name,
                     burn_short=round(last['burn_short'], 3),
                     burn_long=round(last['burn_long'], 3),
                     budget_remaining=last['budget_remaining'])
            self._maybe_capture(name)
        for name in recovered:
            if self._flight:
                from .events import emit
                emit('slo_recovered', slo=name)
        return self.report()

    @staticmethod
    def _burn(window, o: Objective) -> Optional[float]:
        mean = window.mean()
        if mean is None:
            return None
        return mean / o.budget

    @staticmethod
    def _budget_remaining(long_window, o: Objective) -> Optional[float]:
        mean = long_window.mean()
        if mean is None:
            return None
        return max(0.0, min(1.0, 1.0 - mean / o.budget))

    # ------------------------------------------------------------------
    # breach capture
    # ------------------------------------------------------------------
    def _maybe_capture(self, slo_name: str):
        """Bounded torch.profiler capture on breach: a capture thread of
        its own starts a profile (CPU, and CUDA where a card is present:
        the device's kernels are recorded whichever thread launched
        them), sleeps `capture_s`, stops it and exports a chrome trace
        into `capture_dir`. The profiler is started and stopped on that
        one thread (the torch profiler is bound to the thread that
        started it), and the bound is the thread's own sleep, so a
        breach never leaves an unbounded profiler running. Best-effort —
        a missing/busy profiler must never make a breach worse: a
        failure is counted (`count_suppressed`), never raised."""
        if self.capture_dir is None or self.capture_s <= 0:
            return
        with self._lock:
            if self._capturing:
                return
            self._capturing = True
        try:
            import os
            path = os.path.join(self.capture_dir,
                                f'slo_{slo_name}_{int(time.time())}')
            os.makedirs(path, exist_ok=True)

            def _capture():
                try:
                    import torch
                    from torch import profiler as _profiler
                    acts = [_profiler.ProfilerActivity.CPU]
                    if torch.cuda.is_available():
                        acts.append(_profiler.ProfilerActivity.CUDA)
                    with _profiler.profile(activities=acts) as prof:
                        time.sleep(self.capture_s)
                    prof.export_chrome_trace(
                        os.path.join(path, 'trace.json'))
                except Exception:
                    _metrics.count_suppressed('slo.capture_stop')
                finally:
                    with self._lock:
                        self._capturing = False
            threading.Thread(target=_capture, name='slo-capture',
                             daemon=True).start()
            from .events import emit
            emit('slo_capture', slo=slo_name, path=path,
                 capture_s=self.capture_s)
        except Exception:
            # capture thread or directory unavailable: the breach
            # evidence is the flight bundle
            _metrics.count_suppressed('slo.capture')
            with self._lock:
                self._capturing = False

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def alerting(self, name: str) -> bool:
        with self._lock:
            return bool(self._alerting.get(name))

    def report(self) -> Dict[str, Any]:
        """The /slo payload (and the flight bundle's SLO section)."""
        out = []
        with self._lock:
            for o in self.objectives:
                short, long_ = self._windows[o.name]
                out.append({
                    'name': o.name, 'kind': o.kind,
                    'description': o.description,
                    'budget': o.budget,
                    'threshold_s': o.threshold_s or None,
                    'burn_short': self._burn(short, o),
                    'burn_long': self._burn(long_, o),
                    'budget_remaining': self._budget_remaining(long_, o),
                    'alerting': self._alerting[o.name],
                })
            breaches = list(self._breaches[-32:])
        return {'objectives': out, 'breaches': breaches,
                'burn_alert': self.burn_alert,
                'windows_s': [self.short_window_s, self.long_window_s]}


# ---------------------------------------------------------------------------
# process-wide registration (the /slo endpoint + flight bundle read this)
# ---------------------------------------------------------------------------

_engine: List[Optional[SLOEngine]] = [None]


def set_engine(engine: Optional[SLOEngine]) -> Optional[SLOEngine]:
    _engine[0] = engine
    return engine


def get_engine() -> Optional[SLOEngine]:
    return _engine[0]
