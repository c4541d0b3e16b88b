"""Always-on flight recorder: the anomalous window is always on disk (a
copy of `paddle_tpu/observability/flight.py`).

When the serving engine fails a request, a checkpoint fails its
checksum or the concurrency sanitizer reports, the evidence (the spans
around it, the counters into it, the request waterfalls) is usually
gone by the time anyone looks. The recorder rides the instrumentation
that exists: spans and events live in the shared `EventLog`, and the
trigger is an `EventLog` listener watching for the anomaly events of
`TRIGGER_EVENTS`. A dump bundles:

  flight.json    trigger + ring of step/memory samples + counter deltas
  events.jsonl   the event-log tail (spans around the anomaly)
  trace.json     the same window as a chrome trace
  metrics.json   full registry snapshot
  programs.json  ProgramCatalog snapshot (per-program cost attribution)
  goodput.json   goodput-ledger books + roofline/MFU attribution
  requests.json  request-ledger report (per-request phase waterfalls)
  prefix_cache.json  serving prefix-cache state (when serving)
  slo.json       SLO burn-rate state + the event log's drop count
  summary.txt    debug.observability_summary() + the catalog report

Bundles go under `dump_dir`: the one given, else `PADDLE_FLIGHT_DIR`
read at dump time, else a per-process directory under the temp dir.
Auto-dumps are debounced (`min_interval_s`) so an anomaly storm
produces one bundle per window, not thousands; manual `dump()` always
writes.
"""
from __future__ import annotations

import collections
import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

from . import metrics as _metrics
from ..analysis.runtime import concurrency as _concurrency

# anomaly events that auto-trigger a dump (emitted by resilience/
# serving/debug — see each site)
TRIGGER_EVENTS = frozenset((
    'hang_suspected', 'loss_spike', 'bad_step', 'skip_budget_exhausted',
    'serving_request_failed', 'checkpoint_corrupt',
    'router_failover_storm', 'donation_quarantined',
    'sanitizer_violation', 'slo_breach', 'segment_quarantined',
    'replica_crash', 'replica_quarantined', 'request_slow',
))


def _default_dir() -> str:
    return os.environ.get(
        'PADDLE_FLIGHT_DIR',
        os.path.join(tempfile.gettempdir(),
                     f'paddle_flight_{os.getpid()}'))


class FlightRecorder:
    """Bounded ring of recent step/memory samples + anomaly-triggered
    postmortem dumps. Always on: recording is a deque append per step.

    The rings are written by the training/serving thread and read by
    whatever thread EMITTED the trigger event (a watchdog or scrape
    thread dumping mid-run) — iterating a deque while another thread
    appends raises "deque mutated during iteration", which is exactly
    the postmortem dying mid-incident. Both rings are declared
    `guarded_by('_lock')` so the concurrency sanitizer enforces the
    discipline the hard-won fix below established: every access copies
    or appends under the lock."""

    _steps = _concurrency.guarded_by('_lock', mutable=True)
    _memory = _concurrency.guarded_by('_lock', mutable=True)

    def __init__(self, capacity: int = 512,
                 min_interval_s: float = 60.0,
                 dump_dir: Optional[str] = None):
        self.capacity = int(capacity)
        self.min_interval_s = float(min_interval_s)
        self._dump_dir = dump_dir
        self._lock = _concurrency.Lock('FlightRecorder._lock')
        self._steps: collections.deque = collections.deque(maxlen=capacity)
        self._memory: collections.deque = collections.deque(
            maxlen=capacity)
        self._last_dump_t: Optional[float] = None
        self._last_counters: Dict[str, float] = {}
        self._dumping = False
        self._n_dumps = 0
        self.dumps: List[str] = []

    @property
    def dump_dir(self) -> str:
        """Where bundles go: the directory given (or set), else
        `PADDLE_FLIGHT_DIR` as it is now, else a per-process temp dir."""
        return self._dump_dir or _default_dir()

    @dump_dir.setter
    def dump_dir(self, path: Optional[str]):
        self._dump_dir = path

    # -- recording (hot-ish path: one locked deque append per step) ---------
    def record_step(self, loss=None, tokens_per_sec: Optional[float] = None,
                    step: Optional[int] = None):
        sample = {'t': time.time(), 'step': step}
        if loss is not None:
            sample['loss'] = float(loss)
        if tokens_per_sec is not None:
            sample['tokens_per_sec'] = float(tokens_per_sec)
        with self._lock:
            self._steps.append(sample)

    def record_memory(self, nbytes: int):
        with self._lock:
            self._memory.append({'t': time.time(), 'bytes': int(nbytes)})

    # -- triggering ---------------------------------------------------------
    def on_event(self, event: Dict[str, Any]):
        """EventLog listener: an anomaly event lands a debounced dump."""
        if event.get('name') not in TRIGGER_EVENTS:
            return
        now = time.monotonic()
        with self._lock:
            if self._dumping:
                return
            if (self._last_dump_t is not None
                    and now - self._last_dump_t < self.min_interval_s):
                return
            self._last_dump_t = now
        try:
            self.dump(reason=event.get('name'), trigger=event)
        except Exception:
            # a failed postmortem must never kill the run — but a
            # recorder that silently stopped dumping is a postmortem
            # with no body; count it
            _metrics.count_suppressed('flight.dump')

    # -- the postmortem bundle ----------------------------------------------
    def _headline_counters(self, reg) -> Dict[str, float]:
        # the JAX recorder's step and serving headline counters (its
        # compile, resilience and program-store ones have no source in
        # the port yet)
        out = {}
        for name in ('paddle_steps_total', 'paddle_serving_tokens_total',
                     'paddle_serving_decode_steps_total'):
            out[name] = reg.value(name)
        return out

    def dump(self, dir: Optional[str] = None, reason: str = 'manual',
             trigger: Optional[Dict[str, Any]] = None) -> str:
        """Write one postmortem bundle; returns its directory."""
        from .cost import get_catalog
        from .events import get_event_log
        from .exporters import to_chrome_trace
        with self._lock:
            self._dumping = True
            self._n_dumps += 1
            n = self._n_dumps
        try:
            base = dir or self.dump_dir
            stamp = time.strftime('%Y%m%d_%H%M%S')
            path = os.path.join(base, f'flight_{n:03d}_{stamp}_{reason}')
            os.makedirs(path, exist_ok=True)
            reg = _metrics.get_registry()
            log = get_event_log()

            counters = self._headline_counters(reg)
            deltas = {k: v - self._last_counters.get(k, 0.0)
                      for k, v in counters.items()}
            self._last_counters = counters
            with self._lock:
                # copy under the lock: the train/serving thread keeps
                # appending while this (listener) thread dumps — an
                # unlocked list() dies with "deque mutated during
                # iteration" exactly when the postmortem matters
                steps = list(self._steps)
                memory = list(self._memory)
            with open(os.path.join(path, 'flight.json'), 'w') as f:
                json.dump({
                    'reason': reason, 'trigger': trigger,
                    'time': time.time(),
                    'steps': steps,
                    'memory': memory,
                    'counters': counters,
                    'counters_delta_since_last_dump': deltas,
                }, f, indent=1, default=str)
            log.to_jsonl(os.path.join(path, 'events.jsonl'))
            to_chrome_trace(log, os.path.join(path, 'trace.json'))
            with open(os.path.join(path, 'metrics.json'), 'w') as f:
                json.dump(reg.snapshot(), f, indent=1)
            cat = get_catalog()
            with open(os.path.join(path, 'programs.json'), 'w') as f:
                json.dump(cat.snapshot(), f, indent=1, default=str)
            try:
                # where the seconds went INTO this incident: the ledger
                # + roofline books
                from .cost import roofline_summary
                from .goodput import get_ledger
                with open(os.path.join(path, 'goodput.json'), 'w') as f:
                    json.dump({'goodput': get_ledger().report(),
                               'roofline': roofline_summary()},
                              f, indent=1, default=str)
            except Exception:
                _metrics.count_suppressed('flight.bundle_section')
                # partial bundle beats none mid-crash
            try:
                # per-request phase waterfalls: which requests were slow
                # at the moment of the incident and WHERE their
                # milliseconds went (the request_slow trigger's own
                # evidence section — the bundle answers "why" without a
                # live /requests endpoint)
                from .reqledger import get_ledger as _get_reqledger
                with open(os.path.join(path, 'requests.json'),
                          'w') as f:
                    json.dump(_get_reqledger().report(), f, indent=1,
                              default=str)
            except Exception:
                _metrics.count_suppressed('flight.bundle_section')
            try:
                # serving prefix-cache posture: what was retained /
                # pinned when the anomaly fired (an eviction storm or a
                # pinned-full cache is a likely TTFT-regression cause)
                from ..serving.prefix_cache import snapshot_all
                caches = snapshot_all()
            except Exception:
                _metrics.count_suppressed('flight.bundle_section')
                caches = []
            if caches:
                with open(os.path.join(path, 'prefix_cache.json'),
                          'w') as f:
                    json.dump(caches, f, indent=1, default=str)
            try:
                # SLO posture: burn-rate state at the moment of the
                # incident plus the event ring's drop count (the breach
                # bundle's own evidence section; the fleet aggregator's
                # per-process counts come with it)
                from .slo import get_engine
                slo_doc: Dict[str, Any] = {
                    'local_events_dropped': log.dropped}
                engine = get_engine()
                if engine is not None:
                    slo_doc['slo'] = engine.report()
                with open(os.path.join(path, 'slo.json'), 'w') as f:
                    json.dump(slo_doc, f, indent=1, default=str)
            except Exception:
                _metrics.count_suppressed('flight.bundle_section')
            try:
                from .. import debug
                summary = debug.observability_summary() + '\n'
            except Exception:
                _metrics.count_suppressed('flight.bundle_section')
                summary = ''   # partial bundle beats none mid-crash
            with open(os.path.join(path, 'summary.txt'), 'w') as f:
                f.write(summary + cat.report() + '\n')
            self.dumps.append(path)
            if _metrics.enabled():
                reg.counter('paddle_flight_dumps_total',
                            'flight-recorder postmortem bundles written',
                            ('reason',)).labels(reason=reason).inc()
            return path
        finally:
            with self._lock:
                self._dumping = False

    def clear(self):
        with self._lock:
            self._steps.clear()
            self._memory.clear()


_recorder = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    return _recorder


def install():
    """Idempotent: hook the default EventLog so anomaly events trigger
    dumps (runs at package import — the recorder is always on)."""
    from .events import get_event_log
    get_event_log().add_listener(_recorder.on_event)
