"""Exporters: Prometheus text, JSONL, chrome://tracing JSON and the
fleet aggregator's exposition (a copy of
`paddle_tpu/observability/exporters.py`).

One registry + one event log, three standard surfaces: a Prometheus
scrape body for dashboards, JSONL lines for plain-file tailing, and a
chrome-trace with true per-event begin timestamps and durations
(consumable by Perfetto/chrome://tracing next to a torch.profiler
trace of the device).
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional

from .metrics import MetricsRegistry, get_registry


def _fmt_labels(labels: Dict[str, str], extra: Dict[str, str]) -> str:
    all_labels = {**labels, **extra}
    if not all_labels:
        return ''
    body = ','.join(f'{k}="{_escape(str(v))}"'
                    for k, v in sorted(all_labels.items()))
    return '{' + body + '}'


def _escape(v: str) -> str:
    """Label-value escaping: backslash, double-quote, line feed."""
    return v.replace('\\', '\\\\').replace('"', '\\"').replace('\n', '\\n')


def _escape_help(v: str) -> str:
    """HELP-text escaping per the exposition format: ONLY backslash and
    line feed — escaping quotes here would corrupt the help text."""
    return v.replace('\\', '\\\\').replace('\n', '\\n')


def _num(v: float) -> str:
    f = float(v)
    if f != f:
        return 'NaN'
    if f in (float('inf'), float('-inf')):
        return '+Inf' if f > 0 else '-Inf'
    return str(int(f)) if f == int(f) else repr(f)


def to_prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """Prometheus exposition format (text/plain; version 0.0.4). Every
    sample carries a `process` label with the host's process index so
    multi-host scrapes aggregate cleanly."""
    registry = registry if registry is not None else get_registry()
    snap = registry.snapshot()
    proc = {'process': str(snap['process_index'])}
    lines = []
    for m in snap['metrics']:
        name = m['name']
        lines.append(f'# HELP {name} {_escape_help(m["help"])}')
        lines.append(f'# TYPE {name} {m["type"]}')
        for s in m['samples']:
            if m['type'] == 'histogram':
                for bound, count in s['buckets'].items():
                    lines.append(
                        f'{name}_bucket'
                        f'{_fmt_labels(s["labels"], {**proc, "le": bound})}'
                        f' {count}')
                lines.append(f'{name}_sum{_fmt_labels(s["labels"], proc)}'
                             f' {_num(s["sum"])}')
                lines.append(f'{name}_count{_fmt_labels(s["labels"], proc)}'
                             f' {s["count"]}')
            else:
                lines.append(f'{name}{_fmt_labels(s["labels"], proc)}'
                             f' {_num(s["value"])}')
        if m['type'] == 'histogram':
            # windowed quantiles ride a SEPARATE gauge family ({name}_wq
            # with a `quantile` label) — a histogram family must carry
            # only _bucket/_sum/_count samples to stay conformant, and a
            # distinct name keeps promtool/Grafana happy while /summary
            # and dashboards get true trailing-window percentiles
            qlines = []
            for s in m['samples']:
                for q, v in sorted((s.get('quantiles') or {}).items()):
                    qlines.append(
                        f'{name}_wq'
                        f'{_fmt_labels(s["labels"], {**proc, "quantile": q})}'
                        f' {_num(v)}')
            if qlines:
                lines.append(f'# HELP {name}_wq trailing-window quantiles '
                             f'of {name}')
                lines.append(f'# TYPE {name}_wq gauge')
                lines.extend(qlines)
    return '\n'.join(lines) + '\n'


def to_jsonl(registry: Optional[MetricsRegistry] = None,
             path: Optional[str] = None) -> str:
    """One JSON line per sample: {name, type, labels, process, value |
    sum/count/buckets} — the plain-file surface per-host fleet logs use."""
    registry = registry if registry is not None else get_registry()
    snap = registry.snapshot()
    lines = []
    for m in snap['metrics']:
        for s in m['samples']:
            rec = {'name': m['name'], 'type': m['type'],
                   'labels': s['labels'],
                   'process': snap['process_index']}
            if m['type'] == 'histogram':
                rec.update(sum=s['sum'], count=s['count'],
                           buckets=s['buckets'])
            else:
                rec['value'] = s['value']
            lines.append(json.dumps(rec))
    text = '\n'.join(lines)
    if text:
        text += '\n'
    if path is not None:
        with open(path, 'w') as f:
            f.write(text)
    return text


def read_jsonl(text_or_path: str):
    """Parse a to_jsonl export back into records (path or raw text)."""
    if '\n' not in text_or_path and not text_or_path.lstrip().startswith(
            '{'):
        with open(text_or_path) as f:
            text = f.read()
    else:
        text = text_or_path
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def chrome_track_metadata(pid: int, process_name: str,
                          tids: Optional[Dict[int, str]] = None,
                          sort_index: Optional[int] = None):
    """Chrome-trace 'M' (metadata) events naming one process track and
    its threads — without these, Perfetto/chrome://tracing renders bare
    pid/tid integers, which is useless the moment a stitched fleet trace
    has one track per process."""
    events = [{'name': 'process_name', 'ph': 'M', 'pid': pid, 'tid': 0,
               'args': {'name': process_name}}]
    if sort_index is not None:
        events.append({'name': 'process_sort_index', 'ph': 'M', 'pid': pid,
                       'tid': 0, 'args': {'sort_index': int(sort_index)}})
    for tid, tname in sorted((tids or {}).items()):
        events.append({'name': 'thread_name', 'ph': 'M', 'pid': pid,
                       'tid': tid, 'args': {'name': tname}})
    return events


def to_chrome_trace(event_log=None, path: Optional[str] = None
                    ) -> Dict[str, Any]:
    """chrome://tracing JSON built from the EventLog's REAL timestamps:
    each span becomes a complete ('X') event at its actual begin time
    with its actual duration; instant events ('i') keep their timestamp.
    Timestamps are microseconds on the process-wide span clock. Track
    metadata ('M') events label the process track and every live thread
    by its Python thread name."""
    import threading
    from .events import get_event_log
    from .metrics import get_registry
    # `is None`, not truthiness: an empty EventLog is falsy (__len__)
    event_log = get_event_log() if event_log is None else event_log
    thread_names = {t.ident: t.name for t in threading.enumerate()
                    if t.ident is not None}
    trace_events = []
    seen_tids = set()
    for e in event_log.events():
        out = {'name': e['name'], 'ph': e.get('ph', 'X'), 'pid': 0,
               'tid': e.get('tid', 0), 'ts': int(e['ts'] * 1e6)}
        seen_tids.add(out['tid'])
        if out['ph'] == 'X':
            out['dur'] = int(e.get('dur', 0.0) * 1e6)
        if out['ph'] == 'i':
            out['s'] = 't'   # instant scope: thread
        args = dict(e.get('attrs') or {})
        if 'depth' in e:
            args['depth'] = e['depth']
        if args:
            out['args'] = args
        trace_events.append(out)
    # the JAX package's track name: the two packages' traces read alike
    proc_name = f'paddle_tpu process {get_registry().process_index()}'
    meta = chrome_track_metadata(
        0, proc_name,
        {tid: thread_names.get(tid, f'thread-{tid}')
         for tid in sorted(seen_tids)})
    doc = {'traceEvents': meta + trace_events, 'displayTimeUnit': 'ms'}
    if path is not None:
        with open(path, 'w') as f:
            json.dump(doc, f)
    return doc


def fleet_to_prometheus_text(aggregator) -> str:
    """Prometheus exposition of an Aggregator's fleet view: the merged
    samples labeled `process="fleet"`, then each per-process state's
    samples labeled with its process_uid — the `/fleet/metrics` body.
    This is where `paddle_events_dropped_total{process=...}` becomes a
    per-process labeled series (locally it is unlabeled — existing
    single-process scrapes depend on that)."""
    sections = [('fleet', aggregator.merged())]
    sections.extend(sorted(aggregator.per_process_snapshots().items()))
    # group by family across sections: the exposition format wants all
    # of a metric's lines contiguous under one HELP/TYPE
    families: Dict[str, Dict[str, Any]] = {}
    for proc_label, snap in sections:
        for m in snap.get('metrics', []):
            fam = families.setdefault(m['name'], {
                'type': m['type'], 'help': m['help'], 'rows': []})
            fam['rows'].extend((proc_label, s) for s in m['samples'])
    lines = []
    for name, fam in families.items():
        lines.append(f'# HELP {name} {_escape_help(fam["help"])}')
        lines.append(f'# TYPE {name} {fam["type"]}')
        for proc_label, s in fam['rows']:
            proc = {'process': str(proc_label)}
            if fam['type'] == 'histogram':
                for bound, count in s['buckets'].items():
                    lines.append(
                        f'{name}_bucket'
                        f'{_fmt_labels(s["labels"], {**proc, "le": bound})}'
                        f' {count}')
                lines.append(f'{name}_sum{_fmt_labels(s["labels"], proc)}'
                             f' {_num(s["sum"])}')
                lines.append(f'{name}_count{_fmt_labels(s["labels"], proc)}'
                             f' {s["count"]}')
            else:
                lines.append(f'{name}{_fmt_labels(s["labels"], proc)}'
                             f' {_num(s["value"])}')
    return '\n'.join(lines) + '\n'
