"""Versioned JSONL wire format for the fleet observability plane (a copy
of `paddle_tpu/observability/wire.py`: the same bytes, so a segment
written by either package decodes under the other).

The in-process observability layer (registry metrics, event-log entries,
spans) is blind outside its own interpreter. This module is the
process-boundary contract, after Monarch's push-based delta shipping
(Adams et al., VLDB 2020) and Dapper's cross-process trace model
(Sigelman et al., 2010):

- A **segment** is one shippable unit: a header line followed by JSONL
  payload records. The header carries `(process_uid, seq, wall_ts,
  mono_ts)`: `seq` is the per-process monotone segment counter the
  aggregator dedupes on (re-shipping is idempotent), and the
  `(wall_ts, mono_ts)` pair, sampled at one instant on the shipping
  process (`mono_ts` on the span clock, `events._now`), lets the
  aggregator estimate per-process clock skew and project span
  timestamps onto one fleet timeline.
- **Metric payloads are deltas, not snapshots**: counters ship the
  increment since the last segment (order-independent under
  summation), gauges ship last-write values that the aggregator orders
  by segment seq (so out-of-order application converges), and
  histograms ship bucket/sum/count increments. `merge_states`
  delegates to `metrics.merge_snapshots`, so one rule set governs the
  in-process and the fleet merge.
- **Files are committed with the WeightStore's discipline**: payload
  written to a `.tmp` path, sha256 of the payload bytes recorded in
  the header (the per-segment manifest), then atomically renamed into
  the spool. A killed shipper leaves only a `.tmp` the aggregator never
  looks at; a torn or rotted committed file fails its sha256 on decode
  and is quarantined, never applied.

Wire records are plain JSON (no pickles, no framework types), so any
process that can write JSON lines to the spool directory participates
in the fleet view.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

WIRE_VERSION = 1

KIND_METRICS = 'metrics'
KIND_EVENTS = 'events'
KIND_SPANS = 'spans'
#: finalized per-request latency-ledger records (reqledger waterfalls):
#: the aggregator merges them per process so `/requests` and
#: `stitch_trace` phase annotations work fleet-wide
KIND_REQUESTS = 'requests'
KINDS = frozenset((KIND_METRICS, KIND_EVENTS, KIND_SPANS,
                   KIND_REQUESTS))

#: committed segment files (everything else in a spool dir is ignored)
SEGMENT_SUFFIX = '.jsonl'
#: suffix a quarantined segment is renamed to (kept for forensics)
QUARANTINE_SUFFIX = '.quarantined'


class WireError(ValueError):
    """A segment that must not be applied: unknown version, malformed
    JSON, or a payload that fails its sha256 manifest (torn write or
    bit rot). Aggregators quarantine on it — never crash, never apply."""


def process_uid() -> str:
    """Stable identity of THIS process on the fleet timeline:
    host-pid-nonce (the registry snapshot's `process_uid`, one value per
    process). The nonce makes pid reuse harmless (a recycled pid on the
    same host must not inherit a dead process's seq space)."""
    from .metrics import process_uid as _uid
    return _uid()


# ---------------------------------------------------------------------------
# metric deltas
# ---------------------------------------------------------------------------

def _sample_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _index_samples(snapshot_metric: Dict[str, Any]) -> Dict[Tuple, Dict]:
    return {_sample_key(s['labels']): s
            for s in snapshot_metric.get('samples', [])}


def metrics_delta(prev: Optional[Dict[str, Any]], cur: Dict[str, Any]
                  ) -> List[Dict[str, Any]]:
    """Delta records between two `MetricsRegistry.snapshot()` docs.
    `prev=None` means "first ship": every current value IS the delta.
    Families/samples with a zero delta are omitted — steady state ships
    nothing."""
    prev_by_name = {m['name']: m for m in (prev or {}).get('metrics', [])}
    out: List[Dict[str, Any]] = []
    for m in cur.get('metrics', []):
        pm = prev_by_name.get(m['name'])
        prev_samples = _index_samples(pm) if pm is not None else {}
        rec = {'name': m['name'], 'type': m['type'], 'help': m['help']}
        if m['type'] == 'histogram':
            rec['bucket_bounds'] = list(m.get('bucket_bounds', []))
        samples = []
        for s in m.get('samples', []):
            ps = prev_samples.get(_sample_key(s['labels']))
            if m['type'] == 'counter':
                d = s['value'] - (ps['value'] if ps else 0.0)
                if d != 0.0:
                    samples.append({'labels': s['labels'], 'delta': d})
            elif m['type'] == 'gauge':
                if ps is None or ps['value'] != s['value']:
                    samples.append({'labels': s['labels'],
                                    'value': s['value']})
            else:   # histogram
                cd = s['count'] - (ps['count'] if ps else 0)
                if cd == 0:
                    continue
                pb = (ps or {}).get('buckets', {})
                samples.append({
                    'labels': s['labels'],
                    'sum_delta': s['sum'] - (ps['sum'] if ps else 0.0),
                    'count_delta': cd,
                    'bucket_deltas': {b: c - pb.get(b, 0)
                                      for b, c in s['buckets'].items()
                                      if c - pb.get(b, 0) != 0},
                    'quantiles': dict(s.get('quantiles') or {}),
                })
        if samples:
            rec['samples'] = samples
            out.append(rec)
    return out


def new_state(uid: str, process_index: int = 0) -> Dict[str, Any]:
    """Empty per-process accumulation state for `fold_metrics_delta`."""
    return {'process_uid': uid, 'process_index': int(process_index),
            'families': {}}


def fold_metrics_delta(state: Dict[str, Any],
                       records: Sequence[Dict[str, Any]], seq: int):
    """Apply one metrics-delta payload into `state`. Safe under
    out-of-order and repeated-distinct-seq application: counter and
    histogram increments commute, and gauges/quantiles are last-write
    ordered by the shipping segment's `seq` (the larger seq wins no
    matter the arrival order). Idempotence for the SAME seq is the
    aggregator's job (it dedupes before folding)."""
    fams = state['families']
    for rec in records:
        fam = fams.get(rec['name'])
        if fam is None:
            fam = fams[rec['name']] = {
                'type': rec['type'], 'help': rec['help'], 'samples': {}}
            if rec['type'] == 'histogram':
                fam['bucket_bounds'] = list(rec.get('bucket_bounds', []))
        for s in rec.get('samples', []):
            key = _sample_key(s['labels'])
            cur = fam['samples'].get(key)
            if rec['type'] == 'counter':
                if cur is None:
                    cur = fam['samples'][key] = {'labels': dict(s['labels']),
                                                 'value': 0.0}
                cur['value'] += s['delta']
            elif rec['type'] == 'gauge':
                if cur is None or seq >= cur['seq']:
                    fam['samples'][key] = {'labels': dict(s['labels']),
                                           'value': s['value'], 'seq': seq}
            else:
                if cur is None:
                    cur = fam['samples'][key] = {
                        'labels': dict(s['labels']), 'sum': 0.0,
                        'count': 0, 'buckets': {}, 'quantiles': {},
                        'q_seq': -1}
                cur['sum'] += s['sum_delta']
                cur['count'] += s['count_delta']
                for b, c in s['bucket_deltas'].items():
                    cur['buckets'][b] = cur['buckets'].get(b, 0) + c
                if seq >= cur['q_seq']:
                    cur['quantiles'] = dict(s.get('quantiles') or {})
                    cur['q_seq'] = seq


def state_to_snapshot(state: Dict[str, Any]) -> Dict[str, Any]:
    """Render an accumulation state as a `snapshot()`-shaped doc so the
    in-process merge rules (`metrics.merge_snapshots`) apply verbatim."""
    metrics = []
    for name, fam in state['families'].items():
        samples = []
        for s in fam['samples'].values():
            if fam['type'] == 'histogram':
                samples.append({'labels': s['labels'], 'sum': s['sum'],
                                'count': s['count'],
                                'buckets': dict(s['buckets']),
                                'quantiles': dict(s['quantiles'])})
            else:
                samples.append({'labels': s['labels'], 'value': s['value']})
        entry = {'name': name, 'type': fam['type'], 'help': fam['help'],
                 'samples': samples}
        if fam['type'] == 'histogram':
            entry['bucket_bounds'] = list(fam.get('bucket_bounds', []))
        metrics.append(entry)
    return {'process_index': state['process_index'],
            'process_uid': state['process_uid'], 'metrics': metrics}


def merge_states(states: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """One fleet view from per-process accumulation states: counters
    sum, gauges max, histograms add, goodput fractions recomputed
    (`metrics.merge_snapshots`, deduped by process_uid)."""
    from .metrics import merge_snapshots
    return merge_snapshots([state_to_snapshot(s) for s in states])


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------

def _payload_text(records: Sequence[Dict[str, Any]]) -> str:
    return ''.join(json.dumps(r, sort_keys=True) + '\n' for r in records)


def make_segment(kind: str, records: Sequence[Dict[str, Any]], seq: int,
                 uid: Optional[str] = None,
                 wall_ts: Optional[float] = None,
                 mono_ts: Optional[float] = None) -> Dict[str, Any]:
    """Build one segment dict: header + payload records. `wall_ts`
    (time.time) and `mono_ts` (the process's span clock, `events._now`)
    must be sampled at the same instant — the pair is the aggregator's
    skew-estimation input."""
    if kind not in KINDS:
        raise ValueError(f'unknown segment kind {kind!r}; want one of '
                         f'{sorted(KINDS)}')
    if mono_ts is None:
        from .events import _now
        mono_ts = _now()
    payload = _payload_text(records)
    return {
        'v': WIRE_VERSION,
        'kind': kind,
        'process_uid': uid if uid is not None else process_uid(),
        'seq': int(seq),
        'wall_ts': time.time() if wall_ts is None else float(wall_ts),
        'mono_ts': float(mono_ts),
        'n': len(records),
        'sha256': hashlib.sha256(payload.encode('utf-8')).hexdigest(),
        'records': list(records),
    }


def encode_segment(seg: Dict[str, Any]) -> str:
    header = {k: seg[k] for k in ('v', 'kind', 'process_uid', 'seq',
                                  'wall_ts', 'mono_ts', 'n', 'sha256')}
    return json.dumps(header, sort_keys=True) + '\n' \
        + _payload_text(seg['records'])


def decode_segment(text: str) -> Dict[str, Any]:
    """Parse + verify one encoded segment. Raises `WireError` on any
    reason not to apply it (version, malformed lines, sha mismatch,
    record-count mismatch) — the quarantine signal."""
    head, sep, payload = text.partition('\n')
    if not sep:
        raise WireError('segment has no payload separator')
    try:
        header = json.loads(head)
    except ValueError as e:
        raise WireError(f'unparseable segment header: {e}') from e
    if header.get('v') != WIRE_VERSION:
        raise WireError(f'wire version {header.get("v")!r} != '
                        f'{WIRE_VERSION}')
    if header.get('kind') not in KINDS:
        raise WireError(f'unknown segment kind {header.get("kind")!r}')
    digest = hashlib.sha256(payload.encode('utf-8')).hexdigest()
    if digest != header.get('sha256'):
        raise WireError(
            f'payload sha256 mismatch (manifest {header.get("sha256")!r}, '
            f'actual {digest!r}): torn write or bit rot')
    try:
        records = [json.loads(line) for line in payload.splitlines()
                   if line.strip()]
    except ValueError as e:
        raise WireError(f'unparseable payload record: {e}') from e
    if len(records) != int(header.get('n', -1)):
        raise WireError(f'record count {len(records)} != declared '
                        f'{header.get("n")!r}')
    header['records'] = records
    return header


def segment_filename(seg: Dict[str, Any]) -> str:
    return f'seg_{seg["seq"]:08d}_{seg["kind"]}{SEGMENT_SUFFIX}'


def write_segment(spool_dir: str, seg: Dict[str, Any]) -> str:
    """Commit one segment into `spool_dir/<process_uid>/` with the
    WeightStore discipline: tmp-write then atomic rename, so a reader
    never observes a half-written committed file, and a killed writer
    leaves only a `.tmp` nothing tails. Returns the committed path.
    Re-writing the same (uid, seq) is an atomic overwrite — idempotent
    by construction on the reader side (dedupe by (uid, seq))."""
    d = os.path.join(spool_dir, seg['process_uid'])
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, segment_filename(seg))
    tmp = f'{path}.{os.getpid()}.tmp'
    with open(tmp, 'w') as f:
        f.write(encode_segment(seg))
    os.replace(tmp, path)
    return path


def read_segment(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return decode_segment(f.read())
