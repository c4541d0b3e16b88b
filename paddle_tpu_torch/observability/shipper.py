"""Shipper: spool this process's telemetry for a fleet aggregator (a
copy of `paddle_tpu/observability/shipper.py`).

The push half of the fleet observability plane: a background thread
periodically snapshots the registry, computes the wire-format delta
since the last ship, collects the event-log tail and the finalized
request-ledger waterfalls, and commits them into a spool directory as
sha256-manifested segments (tmp-write + atomic rename, see
`wire.write_segment`). A shared filesystem is the transport, as for the
weight plane: no sockets and no serialization beyond JSON.

- **Deltas, so shipping is idempotent and cheap.** Counters ship
  increments, gauges last-writes, histograms bucket increments; a
  quiet process ships nothing. The aggregator dedupes on
  `(process_uid, seq)`, so a re-ship changes no merged counter.
- **The hot path never sees the shipper.** Instrument sites write to
  the in-process registry and event log as before; the shipper reads
  them at its own cadence on its own daemon thread (`ship_now` holds
  the shipper lock, the registry lock only nests inside it).
- **The event ring can outrun the shipper**, and that loss is itself
  shipped: `EventLog.dropped` rides the registry as
  `paddle_events_dropped_total`, so the fleet view shows every
  process's drop count.

`ship_now()` is the synchronous core (tests and the final flush);
`start()`/`stop()` run it on an interval. `stop(flush=True)` ships the
tail, so a graceful shutdown loses nothing.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from . import metrics as _metrics
from . import wire
from ..analysis.runtime import concurrency as _concurrency


class Shipper:
    """Spools registry deltas + event/span segments for one process.

    Args:
        spool_dir: shared spool root (the aggregator tails it); this
            process writes under `spool_dir/<process_uid>/`.
        registry: source MetricsRegistry (default: the process one).
        event_log: source EventLog (default: the process one).
        interval_s: background ship cadence.
        uid: override the process identity (tests simulating a fleet
            from one process).
    """

    def __init__(self, spool_dir: str, registry=None, event_log=None,
                 interval_s: float = 1.0, uid: Optional[str] = None):
        from .events import get_event_log
        self.spool_dir = spool_dir
        # `is None`, not truthiness: an empty registry/log is falsy
        self._registry = _metrics.get_registry() if registry is None \
            else registry
        self._log = get_event_log() if event_log is None else event_log
        self.interval_s = float(interval_s)
        self.uid = uid if uid is not None else wire.process_uid()
        self._lock = _concurrency.Lock('Shipper._lock')
        self._seq = 0
        self._prev_snapshot: Optional[Dict[str, Any]] = None
        self._last_event_seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._shipped_segments = 0
        reg = _metrics.get_registry()
        self._m_segments = reg.counter(
            'paddle_segments_shipped_total',
            'fleet-plane segments committed to the spool', ('kind',))
        self._m_bytes = reg.counter(
            'paddle_segment_bytes_shipped_total',
            'encoded bytes committed to the fleet spool')

    # ------------------------------------------------------------------
    # the synchronous core
    # ------------------------------------------------------------------
    def ship_now(self) -> List[str]:
        """Build + commit the pending segments; returns committed paths
        (empty when nothing changed). One registry snapshot and one
        event-log copy per call — never per event."""
        with self._lock:
            snap = self._registry.snapshot()
            delta = wire.metrics_delta(self._prev_snapshot, snap)
            events = [e for e in self._log.events()
                      if e.get('seq', 0) > self._last_event_seq]
            spans = [e for e in events if e.get('ph') == 'X']
            instants = [e for e in events if e.get('ph') != 'X']
            # the same instant stamps wall and mono: the skew-estimation
            # pair every segment of this batch carries
            from .events import _now
            from .reqledger import get_ledger as _get_reqledger
            wall_ts, mono_ts = time.time(), _now()
            # finalized request waterfalls ship as their own kind; their
            # 'ts' fields ride the span clock, so the aggregator's skew
            # offsets project them onto the fleet timeline unchanged
            requests = _get_reqledger().drain_wire_records()
            paths: List[str] = []
            total_bytes = 0
            for kind, records in ((wire.KIND_METRICS, delta),
                                  (wire.KIND_EVENTS, instants),
                                  (wire.KIND_SPANS, spans),
                                  (wire.KIND_REQUESTS, requests)):
                if not records:
                    continue
                self._seq += 1
                seg = wire.make_segment(kind, records, self._seq,
                                        uid=self.uid, wall_ts=wall_ts,
                                        mono_ts=mono_ts)
                paths.append(wire.write_segment(self.spool_dir, seg))
                total_bytes += len(wire.encode_segment(seg))
                if _metrics.enabled():
                    self._m_segments.labels(kind=kind).inc()
            self._prev_snapshot = snap
            if events:
                self._last_event_seq = max(e.get('seq', 0) for e in events)
            self._shipped_segments += len(paths)
            if total_bytes and _metrics.enabled():
                self._m_bytes.inc(total_bytes)
        if paths:
            from .events import emit
            emit('segment_shipped', n=len(paths), seq=self._seq,
                 process_uid=self.uid)
        return paths

    # ------------------------------------------------------------------
    # background thread
    # ------------------------------------------------------------------
    def start(self) -> 'Shipper':
        """Ship on `interval_s` from a daemon thread. Idempotent."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f'paddle-shipper:{self.uid}',
            daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.ship_now()
            except Exception:
                # a broken ship must not kill the thread (the spool disk
                # filling up is an ops problem, not a process-fatal one)
                # — but it must be countable
                _metrics.count_suppressed('shipper.ship')

    def stop(self, flush: bool = True):
        """Stop the background thread; `flush` ships the tail first so
        graceful shutdown loses no telemetry."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(2.0, 2 * self.interval_s))
            self._thread = None
        if flush:
            try:
                self.ship_now()
            except Exception:
                _metrics.count_suppressed('shipper.flush')

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {'process_uid': self.uid, 'seq': self._seq,
                    'segments_shipped': self._shipped_segments,
                    'last_event_seq': self._last_event_seq,
                    'running': self._thread is not None
                    and self._thread.is_alive()}
