"""Structured event log + span tracing with real timestamps (a copy of
`paddle_tpu/observability/events.py`).

One bounded in-process `EventLog` of JSON-able events carrying actual
begin timestamps and durations, so the chrome-trace export is a true
timeline and JSONL tailing works for long runs.

`span(name, **attrs)` is the tracing API every subsystem uses: a context
manager that records perf_counter begin/end, nesting depth, and thread
id into the event log and a `paddle_span_seconds{name}` histogram in the
metrics registry. `emit(name, **attrs)` records an instant event (e.g.
`serving_request_failed` from the serving engine).

`EVENT_SCHEMA` is the JAX package's, whole: the events of modules the
port does not have yet (the fleet, the program store, training
resilience) are declared already, so the contract dashboards and
flight-bundle readers parse against is one for both packages.
"""
from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Dict, List, Optional

from . import metrics as _metrics
from ..analysis.runtime import concurrency as _concurrency

# one process-wide clock origin so event timestamps from every thread /
# subsystem land on a single comparable timeline
_EPOCH = time.perf_counter()


def _now() -> float:
    return time.perf_counter() - _EPOCH


# ---------------------------------------------------------------------------
# declared event types: every `emit()` name the runtime may produce.
# The schema is the contract dashboards/flight-bundle consumers parse
# against, so drive-by event additions must land HERE first — a tier-1
# lint walks the source tree and fails on any emit() literal missing
# from this registry (tests/test_torch_obs_engine.py scans the port's
# tree), and emit() itself counts undeclared names into
# `paddle_events_undeclared_total` so dynamic names can't slip past the
# static scan either. Span names are NOT events — they stay free-form
# (profiler RecordEvent regions carry user strings).
# ---------------------------------------------------------------------------
EVENT_SCHEMA: Dict[str, str] = {
    # debug / training anomalies
    'loss_spike': 'LossSpikeDetector flagged a step loss',
    'bad_step': 'FaultTolerantStep rolled back a NaN/spike step',
    'skip_budget_exhausted': 'bad-step skip budget exceeded; run dies',
    'hang_suspected': 'watchdog step deadline exceeded',
    'retry': 'transient error re-attempted with backoff',
    'preemption_signal': 'SIGTERM/SIGINT flagged by PreemptionHandler',
    'preempt_save': 'forced sync checkpoint on preemption',
    'checkpoint_corrupt': 'manifest checksum mismatch on restore',
    # fleet / elastic
    'fleet_init': 'mesh initialized',
    'topology_change': 'mesh rebuilt over a new device set',
    'topology_change_rejected': 'unusable device count; resize skipped',
    'device_probe_failed': 'device_source poll raised',
    # program store
    'program_cache_hit': 'program served from memory/disk tier',
    'program_cache_miss': 'program compiled fresh',
    'program_cache_reject': 'stored program found but unusable',
    'program_store_persist': 'program exported to the persistent tier',
    'program_store_persist_skipped': 'program not persistable',
    'program_store_preload': 'bulk preload completed',
    'program_store_invalidate': 'fingerprint refresh dropped entries',
    'program_store_wipe': 'persistent tier deleted on disk',
    # donation gauntlet (programs/donation.py)
    'donation_probe_ok': 'subprocess probe classified the runtime '
                         'donation-safe',
    'donation_probe_failed': 'probe found corruption/crash; store runs '
                             'undonated',
    'donation_enabled': 'store-served programs re-apply donate_argnums '
                        '(sentinel-guarded)',
    'donation_quarantined': 'corruption sentinel tripped; donation off '
                            'for this fingerprint',
    'serving_pool_recovered': 'donated decode failed mid-call; pool '
                              'rows rebuilt',
    # serving engine / router / tenancy
    'serving_request_failed': 'request failed; engine survives',
    'serving_drain_begin': 'graceful drain started',
    'serving_drain_complete': 'graceful drain finished',
    'prefix_hit': 'radix prefix-cache hit on admission',
    'prefix_evict': 'retained prefix slot reclaimed',
    # paged KV pool (serving/kv_pool.PagedSlotPool)
    'paged_cow': 'copy-on-write split of a shared KV page at admission',
    'page_pool_exhausted': 'page reservation failed after reclaiming '
                           'retention; request requeued',
    'request_shed': 'admission rejected under load shedding',
    'request_promoted': 'starvation promotion across QoS classes',
    'router_failover': 'accepted requests resubmitted to survivors',
    'router_failover_storm': 'failover budget exhausted',
    'breaker_open': 'replica circuit breaker opened',
    'breaker_half_open': 'breaker cooldown elapsed; probing',
    'breaker_closed': 'breaker probe succeeded; replica back',
    # online weight updates (trainer→serving hot-swap)
    'weight_publish': 'trainer published a weight version to the store',
    'weight_swap_begin': 'replica drain for a weight hot-swap started',
    'weight_swap_complete': 'replica rejoined on the new weight version',
    'weight_swap_failed': 'swap health gate failed; replica reverted',
    'weight_rollback': 'replica restored its previous weight version',
    'weight_version_quarantined':
        'weight version quarantined after a failed gate or load',
    'weight_writer_stale':
        'dead mid-commit weight publisher detected; marker+tmp swept',
    'rollout_iteration':
        'one serve→score→train→publish→swap turn of the rollout loop',
    # concurrency sanitizer (analysis/runtime/concurrency.py)
    'sanitizer_violation': 'runtime concurrency sanitizer report: '
                           'lock-order cycle, non-reentrant re-entry, '
                           'or lockset race',
    # goodput-driven autoscaling (serving/autoscaler.py)
    'autoscale_up': 'autoscaler provisioned a replica (warm '
                    'program-store path) and joined it to the fleet',
    'autoscale_down_begin': 'autoscaler cordoned a replica; graceful '
                            'drain toward removal started',
    'autoscale_down_complete': 'drained replica removed from the '
                               'fleet; no request dropped',
    # fleet observability plane (observability/{wire,shipper,aggregator,slo})
    'segment_shipped': 'fleet-plane telemetry segments committed to '
                       'the spool',
    'segment_quarantined': 'spool segment failed decode/sha256 '
                           'verification; renamed aside, not applied',
    'slo_breach': 'multi-window burn-rate alert fired for an SLO '
                  'objective',
    'slo_recovered': 'burn-rate alert cleared; short window cooled',
    'slo_capture': 'bounded jax.profiler capture started on breach',
    'fleet_signals_stale': 'FleetSignalSource fell back to the local '
                           'router: every per-process signal was stale',
    # process fleet runtime (serving/{supervisor,remote,replica_main})
    'replica_spawn': 'supervisor launched a replica process',
    'replica_ready': 'replica process warm-started and answering RPC',
    'replica_exit': 'replica process exited (rc + classification)',
    'replica_crash': 'replica process died uncleanly (crash or hang)',
    'replica_hang': 'heartbeat deadline exceeded on a live pid; '
                    'escalated to SIGKILL',
    'replica_restart': 'respawn scheduled with exponential backoff',
    'replica_quarantined': 'crash-looping replica circuit-broken out '
                           'of the respawn loop',
    'replica_retired': 'replica process retired through graceful drain',
    'replica_orphan_reaped': 'stale replica process from a previous '
                             'supervisor incarnation SIGKILLed',
    # multi-tenant adapter serving (serving/adapters/bank.py)
    'adapter_load': 'LoRA adapter factors written into a bank slot',
    'adapter_publish': 'adapter version committed to its weight store',
    'adapter_evict': 'zero-ref adapter slot reclaimed (LRU) for a '
                     'newcomer',
    'adapter_load_reject': 'adapter manifest failed verification; '
                           'version quarantined, bank keeps serving',
    'adapter_bank_saturated': 'adapter bank full of referenced slots; '
                              'request requeued (adapter_pinned) '
                              'instead of failed',
    # per-request latency ledger (observability/reqledger.py)
    'request_slow': 'request finished over the slow threshold '
                    '(N x the ttft_p99 SLO); carries the dominant '
                    'phase as the suspected driver',
}


def declare_event(name: str, help: str = ''):
    """Register an event type at runtime (deployment-specific emitters,
    fault-injection tests). Idempotent; returns the name."""
    EVENT_SCHEMA.setdefault(name, help or name)
    return name


class EventLog:
    """Bounded, thread-safe ring of structured events (oldest dropped)."""

    def __init__(self, capacity: int = 8192):
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._lock = _concurrency.Lock('EventLog._lock')
        self._dropped = 0
        self._seq = 0
        self._listeners: List = []

    @property
    def capacity(self) -> int:
        return self._events.maxlen

    @property
    def dropped(self) -> int:
        return self._dropped

    def append(self, event: Dict[str, Any]):
        with self._lock:
            # monotone per-log sequence: the /events?since= cursor that
            # survives ring eviction (timestamps alone can collide)
            self._seq += 1
            event.setdefault('seq', self._seq)
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(event)
        # listeners run OUTSIDE the lock (a listener may read the log,
        # e.g. the flight recorder dumping on an anomaly event)
        for fn in list(self._listeners):
            try:
                fn(event)
            except Exception:
                # a broken listener must not break emit sites — but it
                # must not break them SILENTLY either (a dead flight
                # recorder or goodput ledger looks exactly like "no
                # anomalies" otherwise)
                _metrics.count_suppressed('event_listener')

    def add_listener(self, fn):
        """`fn(event)` runs after every append (anomaly triggers)."""
        if fn not in self._listeners:
            self._listeners.append(fn)
        return fn

    def remove_listener(self, fn):
        if fn in self._listeners:
            self._listeners.remove(fn)

    def emit(self, name: str, **attrs):
        """Record an instant (zero-duration) event at the current time.
        Undeclared names (missing from EVENT_SCHEMA) are still logged
        but counted — the runtime complement of the static source lint."""
        if not _metrics.enabled():
            return
        if name not in EVENT_SCHEMA:
            _metrics.get_registry().counter(
                'paddle_events_undeclared_total',
                'emit() calls whose event type is not in EVENT_SCHEMA',
                ('event',)).labels(event=name).inc()
        self.append({'name': name, 'ph': 'i', 'ts': _now(),
                     'tid': threading.get_ident(), 'attrs': attrs})

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def clear(self):
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def __len__(self):
        return len(self._events)

    def to_jsonl(self, path: Optional[str] = None) -> str:
        text = '\n'.join(json.dumps(e) for e in self.events())
        if text:
            text += '\n'
        if path is not None:
            with open(path, 'w') as f:
                f.write(text)
        return text

    def to_chrome_trace(self, path: Optional[str] = None) -> Dict[str, Any]:
        from .exporters import to_chrome_trace
        return to_chrome_trace(self, path)


_default_log = EventLog()


def get_event_log() -> EventLog:
    return _default_log


@_metrics.get_registry().register_collector
def _dropped_collector(reg):
    """Scrape-time mirror: events silently aged out of the bounded ring
    are visible on /metrics, so trace truncation is never a surprise."""
    fam = reg.counter('paddle_events_dropped_total',
                      'events dropped by the bounded EventLog')
    fam._sole().value = float(_default_log.dropped)   # mirror


def emit(name: str, **attrs):
    _default_log.emit(name, **attrs)


class _SpanState(threading.local):
    def __init__(self):
        self.depth = 0


_span_state = _SpanState()


class Span:
    """Timed region recorded into the EventLog + span histogram. Nestable;
    usable as a context manager or via explicit begin()/end()."""

    __slots__ = ('name', 'attrs', '_t0', '_log', '_active')

    def __init__(self, name: str, _log: Optional[EventLog] = None, **attrs):
        self.name = name
        self.attrs = attrs
        # `is None`, not truthiness: an EMPTY EventLog is falsy
        # (__len__ == 0) and `or` would silently reroute the span to
        # the default log
        self._log = _default_log if _log is None else _log
        self._t0 = 0.0
        self._active = False

    def begin(self) -> 'Span':
        self._active = _metrics.enabled()
        if self._active:
            _span_state.depth += 1
            self._t0 = _now()
        return self

    def end(self):
        if not self._active:
            return
        self._active = False
        dur = _now() - self._t0
        depth = _span_state.depth
        _span_state.depth -= 1
        ev = {'name': self.name, 'ph': 'X', 'ts': self._t0, 'dur': dur,
              'tid': threading.get_ident(), 'depth': depth}
        if self.attrs:
            ev['attrs'] = self.attrs
        self._log.append(ev)
        _metrics.get_registry().histogram(
            'paddle_span_seconds', 'span(name) wall time',
            ('name',)).labels(name=self.name).observe(dur)

    def __enter__(self) -> 'Span':
        return self.begin()

    def __exit__(self, *exc):
        self.end()


def span(name: str, **attrs) -> Span:
    """`with span('fleet.dist_train_step', step=i): ...` — records a real
    begin/end timestamped event and a duration histogram sample."""
    return Span(name, **attrs)
