"""Aggregator: tail spool directories into one fleet view (a copy of
`paddle_tpu/observability/aggregator.py`).

The pull half of the fleet observability plane: `poll()` scans a spool
directory for committed wire segments (`wire.py`), verifies each
payload against its sha256 manifest, dedupes by `(process_uid, seq)` so
re-shipped segments are idempotent, and folds metric deltas into
per-process accumulation states. The merged view applies
`metrics.merge_snapshots`' rules (counters sum, gauges max, goodput
fractions recomputed).

The aggregator is also the fleet's trace stitcher (Dapper): span
segments from the router's and the replicas' processes carry the
request id in their attrs; every segment header's `(wall_ts, mono_ts)`
pair, sampled at one instant on the shipping process, yields a
per-process clock-skew estimate (the median of wall - mono), and
`stitch_trace()` projects every process's span clock onto the common
wall timeline and renders one chrome-trace waterfall with one labeled
track per process.

A segment that fails decode (torn write, bit rot, version drift) is
quarantined: renamed aside with its `.quarantined` suffix, counted and
evented, never applied and never crashed on.
"""
from __future__ import annotations

import collections
import os
import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Set

from . import metrics as _metrics
from . import wire
from ..analysis.runtime import concurrency as _concurrency

#: per-process bound on retained events/spans (oldest dropped) — the
#: aggregator is a view, not an archive
MAX_EVENTS_PER_PROCESS = 65536
#: per-process bound on retained request-ledger waterfalls
MAX_REQUESTS_PER_PROCESS = 4096
#: clock-pair samples retained per process for the skew estimate
MAX_CLOCK_PAIRS = 64


class Aggregator:
    """Tails one spool dir into per-process states + a merged view.

    Args:
        spool_dir: the directory shippers commit segments into.
        delete_applied: unlink a segment file once applied (spool
            retention for long-lived fleets). Off by default: with the
            files kept, a restarted aggregator rebuilds the identical
            merged view by re-applying everything once.
    """

    def __init__(self, spool_dir: str, delete_applied: bool = False):
        self.spool_dir = spool_dir
        self.delete_applied = bool(delete_applied)
        self._lock = _concurrency.Lock('Aggregator._lock')
        self._seen_paths: Set[str] = set()
        self._applied: Dict[str, Set[int]] = {}
        self._states: Dict[str, Dict[str, Any]] = {}
        self._events: Dict[str, collections.deque] = {}
        # finalized request-ledger waterfalls, per shipping process
        self._requests: Dict[str, collections.deque] = {}
        self._clock_pairs: Dict[str, collections.deque] = {}
        self._last_segment_wall: Dict[str, float] = {}
        self._quarantined: List[str] = []
        self._duplicates = 0
        self._applied_total = 0
        reg = _metrics.get_registry()
        self._m_applied = reg.counter(
            'paddle_segments_applied_total',
            'spool segments decoded, verified, and folded into the '
            'fleet view', ('kind',))
        self._m_duplicate = reg.counter(
            'paddle_segments_duplicate_total',
            're-shipped segments skipped by (process_uid, seq) dedupe')
        self._m_quarantined = reg.counter(
            'paddle_segments_quarantined_total',
            'spool segments that failed decode/sha256 and were moved '
            'aside unapplied')
        self._m_processes = reg.gauge(
            'paddle_fleet_processes',
            'distinct processes observed in the fleet spool')

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------
    def poll(self) -> Dict[str, int]:
        """One ingest pass over the spool; returns counts for this
        pass. Never raises on segment content — bad files quarantine."""
        applied = duplicates = quarantined = 0
        for path in self._segment_paths():
            if path in self._seen_paths:
                continue   # already decoded + applied on a prior poll
            outcome = self._ingest(path)
            self._seen_paths.add(path)
            if outcome == 'applied':
                applied += 1
            elif outcome == 'duplicate':
                duplicates += 1
            elif outcome == 'quarantined':
                quarantined += 1
        if _metrics.enabled():
            self._m_processes.set(len(self.process_uids()))
        return {'applied': applied, 'duplicates': duplicates,
                'quarantined': quarantined}

    def _segment_paths(self) -> List[str]:
        out = []
        try:
            subdirs = sorted(os.listdir(self.spool_dir))
        except OSError:
            return []   # spool not created yet: nothing shipped
        for sub in subdirs:
            d = os.path.join(self.spool_dir, sub)
            if not os.path.isdir(d):
                continue
            try:
                names = sorted(os.listdir(d))
            except OSError:
                continue   # raced with a cleanup; next poll rescans
            for name in names:
                if name.endswith(wire.SEGMENT_SUFFIX):
                    out.append(os.path.join(d, name))
        return out

    def _ingest(self, path: str) -> str:
        try:
            seg = wire.read_segment(path)
        except (wire.WireError, OSError, UnicodeDecodeError) as e:
            return self._quarantine(path, e)
        uid, seq = seg['process_uid'], int(seg['seq'])
        with self._lock:
            seen = self._applied.setdefault(uid, set())
            if seq in seen:
                self._duplicates += 1
                dup = True
            else:
                seen.add(seq)
                self._apply_locked(seg)
                self._applied_total += 1
                dup = False
        if dup:
            if _metrics.enabled():
                self._m_duplicate.inc()
            self._remove_applied(path)
            return 'duplicate'
        if _metrics.enabled():
            self._m_applied.labels(kind=seg['kind']).inc()
        self._remove_applied(path)
        return 'applied'

    def _remove_applied(self, path: str):
        if not self.delete_applied:
            return
        try:
            os.unlink(path)
        except OSError:
            pass   # a concurrent aggregator won the unlink; harmless

    def _quarantine(self, path: str, err: Exception) -> str:
        """Move a bad segment aside (atomic rename) so no later poll
        re-trips on it; the file survives for forensics."""
        qpath = path + wire.QUARANTINE_SUFFIX
        try:
            os.replace(path, qpath)
        except OSError:
            qpath = path   # couldn't move it; remember it as-is
        with self._lock:
            self._quarantined.append(qpath)
        from .events import emit
        emit('segment_quarantined', path=os.path.basename(path),
             error=f'{type(err).__name__}: {err}')
        if _metrics.enabled():
            self._m_quarantined.inc()
        return 'quarantined'

    def _apply_locked(self, seg: Dict[str, Any]):
        uid, seq = seg['process_uid'], int(seg['seq'])
        pairs = self._clock_pairs.setdefault(
            uid, collections.deque(maxlen=MAX_CLOCK_PAIRS))
        pairs.append((float(seg['wall_ts']), float(seg['mono_ts'])))
        self._last_segment_wall[uid] = float(seg['wall_ts'])
        if seg['kind'] == wire.KIND_METRICS:
            state = self._states.get(uid)
            if state is None:
                state = self._states[uid] = wire.new_state(
                    uid, process_index=len(self._states))
            wire.fold_metrics_delta(state, seg['records'], seq)
        elif seg['kind'] == wire.KIND_REQUESTS:
            buf = self._requests.setdefault(
                uid, collections.deque(maxlen=MAX_REQUESTS_PER_PROCESS))
            buf.extend(seg['records'])
        else:   # events / spans share the per-process timeline buffer
            buf = self._events.setdefault(
                uid, collections.deque(maxlen=MAX_EVENTS_PER_PROCESS))
            buf.extend(seg['records'])

    # ------------------------------------------------------------------
    # the merged view
    # ------------------------------------------------------------------
    def merged(self) -> Dict[str, Any]:
        """Fleet-merged metrics doc (`merge_snapshots` shape): counters
        summed, gauges maxed across processes, goodput fractions
        recomputed."""
        with self._lock:
            # render under the lock: a concurrent poll() folding deltas
            # into a state mid-render would tear the snapshot
            snaps = [wire.state_to_snapshot(s)
                     for s in self._states.values()]
        return _metrics.merge_snapshots(snaps)

    def process_uids(self) -> List[str]:
        with self._lock:
            keys = (set(self._states) | set(self._events)
                    | set(self._requests))
            return sorted(keys)

    def requests(self, trace_id=None) -> List[Dict[str, Any]]:
        """Fleet-merged finalized request-ledger waterfalls (oldest
        first by finish wall time), each tagged with the process that
        shipped it. `trace_id` filters to one request's record(s) — the
        `/requests` → `/fleet/trace` drill-down."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            for uid, buf in self._requests.items():
                for r in buf:
                    if (trace_id is not None
                            and r.get('request_id') != trace_id):
                        continue
                    rr = dict(r)
                    rr['process_uid'] = uid
                    out.append(rr)
        out.sort(key=lambda r: r.get('wall_ts') or 0.0)
        return out

    def per_process_snapshots(self) -> Dict[str, Dict[str, Any]]:
        """Each process's accumulated metrics as a snapshot-shaped doc,
        keyed by process_uid — the per-process half of /fleet/metrics."""
        with self._lock:
            return {uid: wire.state_to_snapshot(s)
                    for uid, s in self._states.items()}

    def per_process_value(self, name: str, default: float = 0.0,
                          agg: str = 'sum', **labels) -> Dict[str, float]:
        """One metric's current value per process — counters/gauges.
        With labels given, only matching samples count; `agg` folds a
        labeled family's samples within one process ('sum' or 'max')."""
        out: Dict[str, float] = {}
        with self._lock:
            for uid, state in self._states.items():
                fam = state['families'].get(name)
                if fam is None:
                    out[uid] = default
                    continue
                vals = [s['value'] for s in fam['samples'].values()
                        if 'value' in s   # counters/gauges only
                        and all(s['labels'].get(k) == str(v)
                                for k, v in labels.items())]
                if not vals:
                    out[uid] = default
                elif agg == 'max':
                    out[uid] = max(vals)
                else:
                    out[uid] = sum(vals)
        return out

    def segment_ages(self, now: Optional[float] = None
                     ) -> Dict[str, float]:
        """Seconds since each process's newest segment (wall clock) —
        the freshness signal consumers use to ignore dead shippers."""
        now = time.time() if now is None else now
        with self._lock:
            return {uid: now - w
                    for uid, w in self._last_segment_wall.items()}

    def events_dropped(self) -> Dict[str, float]:
        """Per-process event-ring drop counts from the shipped
        `paddle_events_dropped_total` mirror — the fleet answer to
        'whose traces are truncated'."""
        return self.per_process_value('paddle_events_dropped_total')

    # ------------------------------------------------------------------
    # clock skew + trace stitching
    # ------------------------------------------------------------------
    def clock_offsets(self) -> Dict[str, float]:
        """Per-process offset mapping that process's span clock onto
        its wall clock: median over shipped (wall_ts − mono_ts) pairs.
        Robust to a slow ship (both stamps taken at one instant, so
        shipping latency cancels); NTP-disciplined wall clocks are the
        cross-process common reference, per Dapper's model."""
        with self._lock:
            return {uid: statistics.median(w - m for w, m in pairs)
                    for uid, pairs in self._clock_pairs.items() if pairs}

    def trace_ids(self) -> List[int]:
        """Distinct request trace ids observed across all processes."""
        ids = set()
        with self._lock:
            for buf in self._events.values():
                for e in buf:
                    rid = (e.get('attrs') or {}).get('request_id')
                    if rid is not None:
                        ids.add(rid)
        return sorted(ids)

    def stitch_trace(self, trace_id=None,
                     path: Optional[str] = None) -> Dict[str, Any]:
        """Chrome-trace waterfall across processes, one labeled track
        (pid) per process, timestamps skew-corrected onto the common
        wall timeline and rebased to the earliest event. `trace_id`
        restricts to spans/events whose attrs carry that `request_id`
        (the cross-process request waterfall); None stitches
        everything."""
        from .exporters import chrome_track_metadata
        offsets = self.clock_offsets()
        with self._lock:
            per_proc = {uid: list(buf)
                        for uid, buf in self._events.items()}
            per_proc_reqs = {uid: list(buf)
                             for uid, buf in self._requests.items()}
        rows: List[Dict[str, Any]] = []     # (corrected wall ts, event)
        tracks: List[Dict[str, Any]] = []
        t_min: Optional[float] = None
        all_uids = sorted(set(per_proc) | set(per_proc_reqs))
        for pid, uid in enumerate(all_uids):
            off = offsets.get(uid, 0.0)
            tids: Set[int] = set()
            kept = []
            for e in per_proc.get(uid, ()):
                if trace_id is not None and (
                        (e.get('attrs') or {}).get('request_id')
                        != trace_id):
                    continue
                wall = float(e.get('ts', 0.0)) + off
                kept.append((wall, e))
                tids.add(e.get('tid', 0))
                if t_min is None or wall < t_min:
                    t_min = wall
            # request-ledger phase annotations: each finalized record's
            # waterfall renders as `req.<phase>` slices on a synthetic
            # per-request track, skew-corrected exactly like spans (the
            # record's 'ts' rides the span clock)
            for r in per_proc_reqs.get(uid, ()):
                rid = r.get('request_id')
                if trace_id is not None and rid != trace_id:
                    continue
                base = float(r.get('ts', 0.0))
                tid = -1 - (int(rid or 0) % 97)
                for s in r.get('segments', ()):
                    e = {'name': f'req.{s["phase"]}', 'ph': 'X',
                         'ts': base + float(s['start_s']),
                         'dur': float(s['dur_s']), 'tid': tid,
                         'attrs': {'request_id': rid,
                                   'phase': s['phase'],
                                   'outcome': r.get('outcome'),
                                   'failovers': r.get('failovers')}}
                    wall = e['ts'] + off
                    kept.append((wall, e))
                    tids.add(tid)
                    if t_min is None or wall < t_min:
                        t_min = wall
            rows.extend((wall, pid, e) for wall, e in kept)
            if kept:
                tracks.append({'pid': pid, 'uid': uid, 'tids': tids,
                               'offset': off})
        t0 = t_min if t_min is not None else 0.0
        trace_events: List[Dict[str, Any]] = []
        for tr in tracks:
            trace_events.extend(chrome_track_metadata(
                tr['pid'], f'process {tr["uid"]}',
                {tid: f'tid {tid}' for tid in sorted(tr['tids'])},
                sort_index=tr['pid']))
        for wall, pid, e in sorted(rows, key=lambda r: r[0]):
            out = {'name': e['name'], 'ph': e.get('ph', 'X'), 'pid': pid,
                   'tid': e.get('tid', 0),
                   'ts': int((wall - t0) * 1e6)}
            if out['ph'] == 'X':
                out['dur'] = int(e.get('dur', 0.0) * 1e6)
            if out['ph'] == 'i':
                out['s'] = 't'
            args = dict(e.get('attrs') or {})
            if 'depth' in e:
                args['depth'] = e['depth']
            if args:
                out['args'] = args
            trace_events.append(out)
        doc = {'traceEvents': trace_events, 'displayTimeUnit': 'ms',
               'metadata': {'trace_id': trace_id,
                            'clock_offsets': {t['uid']: t['offset']
                                              for t in tracks},
                            'wall_t0': t0}}
        if path is not None:
            import json
            with open(path, 'w') as f:
                json.dump(doc, f)
        return doc

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                'spool_dir': self.spool_dir,
                'processes': sorted(set(self._states)
                                    | set(self._events)),
                'segments_applied': self._applied_total,
                'duplicates_skipped': self._duplicates,
                'quarantined': list(self._quarantined),
                'last_segment_wall_ts': dict(self._last_segment_wall),
            }


class FleetSignalSource:
    """`Router.window_signals()`-shaped control signals from the FLEET
    view instead of the local registry: the autoscaler's
    `signal_source` (and an `SLOEngine`'s `view_fn`, through
    `merged_view`) once replicas live in other processes.

    Reads the per-process windowed signal gauges the routers already
    export (`paddle_ttft_p99_window`, `paddle_queue_depth_p99_window`,
    `paddle_shed_rate_window`, `paddle_router_available_replicas`) from
    the aggregator's states, then folds them the way the quantity
    means: latency quantiles take the fleet-wide WORST (max — the SLO
    is judged at the slowest router), queue depth / shed rate /
    serving replicas SUM (capacity and demand add across processes).
    Falls back to `router.window_signals()` while the spool has no
    fresh data (fleet plane warming up, or a single-process
    deployment), so wiring it in is never a regression.

    Args:
        aggregator: the fleet Aggregator to read.
        router: optional local Router for the warm-up fallback.
        fresh_s: ignore the fleet view when its newest segment is older
            than this (a dead shipper must not freeze the autoscaler
            on stale signals).
        poll: run `aggregator.poll()` on every read (default True —
            the autoscaler's cadence is slow enough to pay an ingest).
    """

    def __init__(self, aggregator: Aggregator, router=None,
                 fresh_s: float = 30.0, poll: bool = True,
                 clock: Callable[[], float] = time.time):
        self.aggregator = aggregator
        self.router = router
        self.fresh_s = float(fresh_s)
        self._poll = bool(poll)
        self._clock = clock

    def merged_view(self) -> Dict[str, Any]:
        """The aggregator's merged metrics doc (polled first when this
        source polls): the `view_fn` an `SLOEngine` takes from it."""
        if self._poll:
            self.aggregator.poll()
        return self.aggregator.merged()

    def _fresh_uids(self) -> List[str]:
        ages = self.aggregator.segment_ages(self._clock())
        return [uid for uid, age in ages.items() if age <= self.fresh_s]

    def __call__(self) -> Dict[str, Any]:
        if self._poll:
            self.aggregator.poll()
        fresh = set(self._fresh_uids())
        agg = self.aggregator
        ttft = {u: v for u, v in agg.per_process_value(
            'paddle_ttft_p99_window', default=-1.0, agg='max').items()
            if u in fresh and v >= 0.0}
        queue = {u: v for u, v in agg.per_process_value(
            'paddle_queue_depth_p99_window', default=-1.0,
            agg='max').items() if u in fresh and v >= 0.0}
        shed = {u: v for u, v in agg.per_process_value(
            'paddle_shed_rate_window').items() if u in fresh}
        serving = {u: v for u, v in agg.per_process_value(
            'paddle_router_available_replicas').items() if u in fresh}
        if not serving and not ttft and not queue:
            # fleet plane dark. Two very different darknesses: a spool
            # that has never shipped (warm-up / single-process — quiet
            # fallback) vs a spool with data that has ALL gone stale (a
            # dead shipper fleet-wide) — the latter is an incident, so
            # it counts and emits instead of degrading silently.
            ages = self.aggregator.segment_ages(self._clock())
            if ages and not fresh:
                from .events import emit
                if _metrics.enabled():
                    _metrics.get_registry().counter(
                        'paddle_fleet_signals_stale_total',
                        'FleetSignalSource reads that fell back to the '
                        'local router because every per-process signal '
                        'was stale').inc()
                emit('fleet_signals_stale',
                     processes=len(ages),
                     oldest_age_s=round(max(ages.values()), 3),
                     fresh_s=self.fresh_s)
            if self.router is not None:
                sig = dict(self.router.window_signals())
                sig['source'] = 'local'
                return sig
            return {'ttft_p99': None, 'queue_p99': None, 'shed_rate': 0.0,
                    'serving_replicas': 0, 'source': 'fleet_empty'}
        return {
            'ttft_p99': max(ttft.values()) if ttft else None,
            'queue_p99': sum(queue.values()) if queue else None,
            'shed_rate': sum(shed.values()),
            'serving_replicas': int(sum(serving.values())),
            'processes': sorted(fresh),
            'source': 'fleet',
        }


# ---------------------------------------------------------------------------
# process-wide registration (the /fleet/* endpoints read this)
# ---------------------------------------------------------------------------

_aggregator: List[Optional[Aggregator]] = [None]


def set_aggregator(agg: Optional[Aggregator]) -> Optional[Aggregator]:
    """Register the process's fleet aggregator; the observability
    server's `/fleet/metrics` and `/fleet/trace` serve from it."""
    _aggregator[0] = agg
    return agg


def get_aggregator() -> Optional[Aggregator]:
    return _aggregator[0]
