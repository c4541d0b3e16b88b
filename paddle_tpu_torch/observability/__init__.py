"""paddle_tpu_torch.observability: the metrics + tracing layer
(counterpart of `paddle_tpu/observability`).

One process-wide `MetricsRegistry` (labeled Counter/Gauge/Histogram),
one bounded `EventLog` of real-timestamped spans/events, the exporters
(Prometheus text, JSONL, chrome trace), the goodput ledger (every
wall-clock second), the per-request ledger (every millisecond of a
request), the always-on flight recorder (a postmortem bundle per
anomaly), the program catalog and roofline (`cost.py`), per-step
training telemetry (`telemetry.py`), the SLO engine (`slo.py`:
declarative objectives with multi-window burn-rate alerts) and the HTTP
endpoint (`start_server`: /metrics, /healthz, /summary, /events, /trace,
/programs, /goodput, /slo, /requests, /fleet/metrics, /fleet/trace).
The serving engine, scheduler, prefix cache, adapter bank, weight store,
checkpoints and retries report here under the JAX package's names,
labels and HELP texts, so the same dashboards and tests read both
packages.

Cross-process (the fleet plane): `wire` is the versioned JSONL segment
format (the JAX package's bytes), `Shipper` spools a process's metric
deltas, events, spans and request waterfalls to a shared directory,
and `Aggregator` tails spools into one merged view
(`merge_snapshots`), stitches skew-corrected cross-process traces and
feeds `FleetSignalSource` (the autoscaler's `signal_source`, the SLO
engine's `view_fn`); `set_aggregator` registers it for the server's
`/fleet/metrics` and `/fleet/trace`.

Everything is pure Python and imports nothing of JAX.

`install()` runs at import: the flight recorder, the goodput ledger,
the program catalog's and the request ledger's scrape-time collectors
hook the default event log and registry. All hooks are no-ops while observability is disabled
(`disable()` / `FLAGS_observability`).
"""
from __future__ import annotations

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      DEFAULT_BUCKETS, QUANTILES, SlidingWindow,
                      count_suppressed, enable, enabled, disable,
                      get_registry, merge_snapshots, process_uid)
from .events import (EVENT_SCHEMA, EventLog, Span, declare_event, emit,
                     get_event_log, span)
from .exporters import (chrome_track_metadata, fleet_to_prometheus_text,
                        read_jsonl, to_chrome_trace, to_jsonl,
                        to_prometheus_text)
from .wire import (WIRE_VERSION, WireError, decode_segment,
                   encode_segment, make_segment, metrics_delta,
                   read_segment, write_segment)
from .shipper import Shipper
from .aggregator import (Aggregator, FleetSignalSource, get_aggregator,
                         set_aggregator)
from .slo import (Objective, SLOEngine, default_objectives,
                  get_engine as get_slo_engine,
                  set_engine as set_slo_engine)
from .telemetry import (StepTelemetry, collective_totals,
                        device_memory_bytes, note_jit_cache_entry)
from .cost import (MfuWindow, ProgramCatalog, ProgramRecord,
                   aggregate_mfu, device_peaks, record_roofline,
                   roofline_summary, get_catalog as program_catalog)
from .goodput import (CATEGORIES as GOODPUT_CATEGORIES, GoodputLedger,
                      get_ledger)
from .reqledger import (BLOCKED_REASONS, PHASES as REQUEST_PHASES,
                        RequestLedger, RequestRecord,
                        get_ledger as get_request_ledger)
from .flight import FlightRecorder, get_flight_recorder
from .server import (ObservabilityServer, clear_degraded, degraded_states,
                     hang_suspected, health, note_degraded, note_progress,
                     note_weight_version, start_server, weight_versions)
from . import cost as _cost
from . import flight as _flight
from . import goodput as _goodput
from . import reqledger as _reqledger

__all__ = [
    'Counter', 'Gauge', 'Histogram', 'MetricsRegistry', 'DEFAULT_BUCKETS',
    'QUANTILES', 'SlidingWindow', 'count_suppressed',
    'enable', 'enabled', 'disable', 'get_registry', 'merge_snapshots',
    'process_uid',
    'EVENT_SCHEMA', 'EventLog', 'Span', 'declare_event', 'emit',
    'get_event_log', 'span',
    'read_jsonl', 'to_chrome_trace', 'to_jsonl', 'to_prometheus_text',
    'chrome_track_metadata', 'fleet_to_prometheus_text',
    'WIRE_VERSION', 'WireError', 'decode_segment', 'encode_segment',
    'make_segment', 'metrics_delta', 'read_segment', 'write_segment',
    'Shipper', 'Aggregator', 'FleetSignalSource', 'get_aggregator',
    'set_aggregator',
    'Objective', 'SLOEngine', 'default_objectives', 'get_slo_engine',
    'set_slo_engine',
    'StepTelemetry', 'collective_totals', 'device_memory_bytes',
    'note_jit_cache_entry',
    'MfuWindow', 'ProgramCatalog', 'ProgramRecord', 'program_catalog',
    'aggregate_mfu', 'device_peaks', 'record_roofline', 'roofline_summary',
    'GOODPUT_CATEGORIES', 'GoodputLedger', 'get_ledger',
    'BLOCKED_REASONS', 'REQUEST_PHASES', 'RequestLedger',
    'RequestRecord', 'get_request_ledger',
    'FlightRecorder', 'get_flight_recorder',
    'ObservabilityServer', 'clear_degraded', 'degraded_states',
    'hang_suspected', 'health', 'install', 'note_degraded',
    'note_progress', 'note_weight_version', 'start_server',
    'weight_versions',
]


def install():
    """Idempotent: hook the always-on flight recorder and goodput ledger
    on the default event log and register the program catalog's, the
    goodput and the request ledgers' scrape-time collectors (runs at
    package import)."""
    _cost.install()
    _flight.install()
    _goodput.install()
    _reqledger.install()


install()
