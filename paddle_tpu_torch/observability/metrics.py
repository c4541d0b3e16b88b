"""Thread-safe metrics registry: labeled Counter / Gauge / Histogram
(a copy of `paddle_tpu/observability/metrics.py`).

One process-wide `MetricsRegistry` that every subsystem of the port
reports into (the serving engine, scheduler, prefix cache and adapter
bank, the weight store, checkpoints and retries), so one snapshot or
export answers where the requests, tokens and seconds went. Families and
HELP texts are the JAX package's, so one dashboard reads either.

Design rules:
- Hot paths never pay for observability they do not use: every direct
  write is gated on `enabled()` (`FLAGS_observability`), and state that
  exists anyway flows in through *collectors*, callbacks run at
  snapshot/export time, not per event.
- Metric families are create-or-get by name (idempotent), children are
  create-or-get by label values, and every mutation takes one registry
  RLock.
- `snapshot()` is plain data (JSON-able) and carries the process index
  and a process uid, so snapshots of several processes merge into one
  fleet view (`merge_snapshots`, the fleet aggregator's rule set).
"""
from __future__ import annotations

import bisect
import collections
import math
import os
import socket
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .. import flags as _flags
from ..analysis.runtime import concurrency as _concurrency

_enabled = [bool(_flags.flag('FLAGS_observability'))]


def enabled() -> bool:
    """Fast global gate consulted by instrumented call sites."""
    return _enabled[0]


def enable(on: bool = True):
    """Toggle direct metric writes (spans, step telemetry, collective /
    offload / compile counters). Collectors still report at snapshot
    time — they read state that exists anyway."""
    _enabled[0] = bool(on)
    _flags.set_flags({'FLAGS_observability': bool(on)})


def disable():
    enable(False)


# latency-shaped default buckets (seconds), Prometheus-style
DEFAULT_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1.0,
                   5.0, 10.0, 60.0)

# windowed quantile sketch: every histogram keeps its last N raw
# observations so /summary can render true p50/p95/p99 (serving
# TTFT/TPOT, step time) without Prometheus-side bucket interpolation
QUANTILE_WINDOW = 256
QUANTILES = (0.5, 0.95, 0.99)


def _q_key(q: float) -> str:
    """Quantile label value: '0.5', '0.95', '0.99' (no float noise)."""
    return f'{q:g}'


def _label_key(labelnames: Sequence[str], labels: Dict[str, Any]
               ) -> Tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(
            f'expected labels {tuple(labelnames)}, got {tuple(labels)}')
    return tuple(str(labels[n]) for n in labelnames)


class Counter:
    """Monotonically increasing value (one child of a family)."""

    __slots__ = ('_family', '_labels', 'value')

    def __init__(self, family, labels: Tuple[str, ...]):
        self._family = family
        self._labels = labels
        self.value = 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError(f'counters only go up; inc({amount})')
        with self._family._registry._lock:
            self.value += amount
        return self


class Gauge:
    """Point-in-time value (one child of a family)."""

    __slots__ = ('_family', '_labels', 'value')

    def __init__(self, family, labels: Tuple[str, ...]):
        self._family = family
        self._labels = labels
        self.value = 0.0

    def set(self, value: float):
        with self._family._registry._lock:
            self.value = float(value)
        return self

    def inc(self, amount: float = 1.0):
        with self._family._registry._lock:
            self.value += amount
        return self

    def dec(self, amount: float = 1.0):
        return self.inc(-amount)

    def set_to_max(self, value: float):
        """Watermark update: keep the max of the current and new value."""
        with self._family._registry._lock:
            if value > self.value:
                self.value = float(value)
        return self


class Histogram:
    """Cumulative-bucket distribution (one child of a family)."""

    __slots__ = ('_family', '_labels', 'bucket_counts', 'sum', 'count',
                 '_window')

    def __init__(self, family, labels: Tuple[str, ...]):
        self._family = family
        self._labels = labels
        self.bucket_counts = [0] * (len(family.buckets) + 1)  # +inf last
        self.sum = 0.0
        self.count = 0
        # trailing raw observations for windowed quantiles (p50/p95/p99)
        self._window: collections.deque = collections.deque(
            maxlen=QUANTILE_WINDOW)

    def observe(self, value: float):
        v = float(value)
        if not math.isfinite(v):
            # a single NaN observation would poison `sum` forever (e.g.
            # a NaN loss observed before the FT rollback drops the
            # batch); drop it but keep the drop itself visible
            self._family._registry.counter(
                'paddle_metrics_nonfinite_dropped_total',
                'non-finite histogram observations dropped',
                ('metric',)).labels(metric=self._family.name).inc()
            return self
        with self._family._registry._lock:
            self.bucket_counts[bisect.bisect_left(
                self._family.buckets, v)] += 1
            self.sum += v
            self.count += 1
            self._window.append(v)
        return self

    def window_quantiles(self, qs: Sequence[float] = QUANTILES
                         ) -> Dict[str, float]:
        """Quantiles over the trailing observation window (nearest-rank
        on up to QUANTILE_WINDOW raw samples). Empty dict before the
        first observation — an absent percentile is honest, a fabricated
        zero is not."""
        with self._family._registry._lock:
            vals = sorted(self._window)
        if not vals:
            return {}
        n = len(vals)
        return {_q_key(q): vals[min(int(q * n), n - 1)] for q in qs}


class SlidingWindow:
    """Time-windowed observation buffer: quantiles, count, and rate over
    the trailing `window_s` seconds of real time.

    The Histogram's quantile sketch is COUNT-windowed (last 256
    observations) — fine for "what did recent steps look like", useless
    for a control loop: after a burst ends, those 256 stale samples keep
    reporting the burst for however long traffic stays quiet. An
    autoscaler needs signals that age out by the clock, so this buffer
    keeps (timestamp, value) pairs and prunes everything older than the
    window on every read and write. `maxlen` bounds memory under
    pathological observation rates (oldest drop first — under that much
    traffic the window is saturated anyway); `clock` is injectable for
    deterministic tests.

    Thread-safe; cheap enough for per-request/per-round observation
    (one deque append + amortized prune)."""

    __slots__ = ('window_s', '_clock', '_obs', '_lock')

    def __init__(self, window_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 maxlen: int = 8192):
        if window_s <= 0:
            raise ValueError('window_s must be positive')
        self.window_s = float(window_s)
        self._clock = clock
        self._obs: collections.deque = collections.deque(maxlen=maxlen)
        self._lock = _concurrency.Lock('SlidingWindow._lock')

    def _prune(self, now: float):
        cutoff = now - self.window_s
        obs = self._obs
        while obs and obs[0][0] < cutoff:
            obs.popleft()

    def observe(self, value: float):
        now = self._clock()
        with self._lock:
            self._prune(now)
            self._obs.append((now, float(value)))
        return self

    def mark(self):
        """Record an occurrence (value 1.0) — the rate()-only use case
        (shed events, admissions)."""
        return self.observe(1.0)

    def values(self) -> List[float]:
        with self._lock:
            self._prune(self._clock())
            return [v for _, v in self._obs]

    def count(self) -> int:
        with self._lock:
            self._prune(self._clock())
            return len(self._obs)

    def rate(self) -> float:
        """Observations per second over the window."""
        return self.count() / self.window_s

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile over the in-window values, or None when
        the window is empty — an absent percentile is honest, a
        fabricated zero is not (same contract as window_quantiles)."""
        vals = sorted(self.values())
        if not vals:
            return None
        n = len(vals)
        return vals[min(int(q * n), n - 1)]

    def quantiles(self, qs: Sequence[float] = QUANTILES
                  ) -> Dict[str, float]:
        vals = sorted(self.values())
        if not vals:
            return {}
        n = len(vals)
        return {_q_key(q): vals[min(int(q * n), n - 1)] for q in qs}

    def mean(self) -> Optional[float]:
        vals = self.values()
        return sum(vals) / len(vals) if vals else None


_CHILD_TYPES = {'counter': Counter, 'gauge': Gauge, 'histogram': Histogram}


class _Family:
    """One named metric: a set of children keyed by label values. With no
    labelnames the family proxies its single child, so
    `reg.counter('x').inc()` works without a labels() hop."""

    def __init__(self, registry: 'MetricsRegistry', name: str, typ: str,
                 help: str, labelnames: Tuple[str, ...],
                 buckets: Optional[Tuple[float, ...]] = None):
        self._registry = registry
        self.name = name
        self.type = typ
        self.help = help
        self.labelnames = labelnames
        if typ == 'histogram':
            self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self._children: Dict[Tuple[str, ...], Any] = {}
        if not labelnames:
            self._children[()] = _CHILD_TYPES[typ](self, ())

    def labels(self, **labels):
        key = _label_key(self.labelnames, labels)
        with self._registry._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _CHILD_TYPES[self.type](
                    self, key)
        return child

    def children(self) -> List[Tuple[Tuple[str, ...], Any]]:
        """Locked snapshot of (label-values, child) pairs. Readers on
        scrape/summary/listener threads iterate THIS, never `_children`
        directly: `labels()` on another thread (a router scaling up
        mints a new replica's gauge child mid-scrape) grows the dict,
        and an unlocked iteration dies with "dictionary changed size
        during iteration"."""
        with self._registry._lock:
            return list(self._children.items())

    def total(self) -> float:
        """Locked sum of every child's value (labeled counter/gauge
        families; the headline-view aggregation)."""
        with self._registry._lock:
            return sum(c.value for c in self._children.values())

    def _sole(self):
        if self.labelnames:
            raise ValueError(
                f'{self.name} is labeled {self.labelnames}; use .labels()')
        return self._children[()]

    # unlabeled convenience proxies
    def inc(self, amount: float = 1.0):
        return self._sole().inc(amount)

    def set(self, value: float):
        return self._sole().set(value)

    def dec(self, amount: float = 1.0):
        return self._sole().dec(amount)

    def set_to_max(self, value: float):
        return self._sole().set_to_max(value)

    def observe(self, value: float):
        return self._sole().observe(value)

    @property
    def value(self):
        return self._sole().value

    @property
    def count(self):
        return self._sole().count

    @property
    def sum(self):
        return self._sole().sum


class MetricsRegistry:
    def __init__(self, process_index: Optional[int] = None):
        self._lock = _concurrency.RLock('MetricsRegistry._lock')
        self._families: Dict[str, _Family] = {}
        self._collectors: List[Callable[['MetricsRegistry'], None]] = []
        self._process_index = process_index
        self._in_collect = False

    # -- family constructors (create-or-get, conflict-checked) --------------
    def _family(self, name, typ, help, labelnames, buckets=None):
        labelnames = tuple(labelnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(
                    self, name, typ, help, labelnames, buckets)
            elif fam.type != typ or fam.labelnames != labelnames:
                raise ValueError(
                    f'metric {name!r} already registered as {fam.type}'
                    f'{fam.labelnames}; asked for {typ}{labelnames}')
            return fam

    def counter(self, name, help: str = '', labelnames: Sequence[str] = ()):
        return self._family(name, 'counter', help, labelnames)

    def gauge(self, name, help: str = '', labelnames: Sequence[str] = ()):
        return self._family(name, 'gauge', help, labelnames)

    def histogram(self, name, help: str = '',
                  labelnames: Sequence[str] = (), buckets=None):
        return self._family(name, 'histogram', help, labelnames, buckets)

    # -- collectors ----------------------------------------------------------
    def register_collector(self, fn: Callable[['MetricsRegistry'], None]):
        """`fn(registry)` runs at snapshot/export time to sync state that
        is kept outside the registry (e.g. the event log's drop
        counters) into registry metrics — the zero-hot-path-cost path."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)
        return fn

    def _collect(self):
        with self._lock:
            if self._in_collect:   # a collector snapshotting would recurse
                return
            self._in_collect = True
            try:
                for fn in list(self._collectors):
                    try:
                        fn(self)
                    except Exception:
                        # a broken collector must not kill a scrape, but
                        # its absence from the exposition must be
                        # countable (RLock: safe to create the family
                        # mid-collect)
                        count_suppressed('metrics_collector', self)
            finally:
                self._in_collect = False

    # -- introspection -------------------------------------------------------
    def process_index(self) -> int:
        if self._process_index is not None:
            return self._process_index
        # the rank of an initialized process group; a lone process is 0
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
        return 0

    def get(self, name) -> Optional[_Family]:
        return self._families.get(name)

    def value(self, name, default=0.0, **labels) -> float:
        """Read one sample's current value (counters/gauges); collectors
        are NOT run — pair with snapshot() for collected reads."""
        fam = self._families.get(name)
        if fam is None:
            return default
        key = _label_key(fam.labelnames, labels) if labels else ()
        child = fam._children.get(key)
        return default if child is None else child.value

    def snapshot(self) -> Dict[str, Any]:
        """Collected, JSON-able view of every metric."""
        self._collect()
        with self._lock:
            metrics = []
            for fam in self._families.values():
                samples = []
                for key, child in fam._children.items():
                    labels = dict(zip(fam.labelnames, key))
                    if fam.type == 'histogram':
                        samples.append({
                            'labels': labels, 'sum': child.sum,
                            'count': child.count,
                            'buckets': dict(zip(
                                [str(b) for b in fam.buckets] + ['+Inf'],
                                _cumulate(child.bucket_counts))),
                            'quantiles': child.window_quantiles()})
                    else:
                        samples.append({'labels': labels,
                                        'value': child.value})
                entry = {'name': fam.name, 'type': fam.type,
                         'help': fam.help, 'samples': samples}
                if fam.type == 'histogram':
                    entry['bucket_bounds'] = list(fam.buckets)
                metrics.append(entry)
            return {'process_index': self.process_index(),
                    'process_uid': process_uid(),
                    'metrics': metrics}

    def reset(self):
        """Zero every value (families and children survive) — opens a
        clean measurement window without re-plumbing instrument sites."""
        with self._lock:
            for fam in self._families.values():
                for child in fam._children.values():
                    if fam.type == 'histogram':
                        child.bucket_counts = [0] * len(child.bucket_counts)
                        child.sum = 0.0
                        child.count = 0
                        child._window.clear()
                    else:
                        child.value = 0.0

    # exporters live in observability.exporters; bound here for ergonomics
    def to_prometheus_text(self) -> str:
        from .exporters import to_prometheus_text
        return to_prometheus_text(self)

    def to_jsonl(self, path: Optional[str] = None) -> str:
        from .exporters import to_jsonl
        return to_jsonl(self, path)


def _cumulate(bucket_counts: List[int]) -> List[int]:
    out, acc = [], 0
    for c in bucket_counts:
        acc += c
        out.append(acc)
    return out


_process_uid: List[Optional[str]] = [None]


def process_uid() -> str:
    """Stable identity of this process across processes: host-pid-nonce
    (the JAX package's `wire.process_uid`). The nonce makes pid reuse
    harmless."""
    if _process_uid[0] is None:
        _process_uid[0] = (f'{socket.gethostname()}-{os.getpid()}-'
                           f'{uuid.uuid4().hex[:8]}')
    return _process_uid[0]


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default_registry


def count_suppressed(site: str, registry: Optional[MetricsRegistry] = None):
    """Record an intentionally-swallowed error at a best-effort site into
    `paddle_suppressed_errors_total{site}`: an error may be survivable,
    but it must never be *invisible* (a broken collector or listener
    shows up here). Never raises."""
    try:
        if not enabled():
            return
        reg = registry if registry is not None else _default_registry
        reg.counter(
            'paddle_suppressed_errors_total',
            'errors intentionally swallowed at best-effort sites '
            '(fallback taken); site names the swallow location',
            ('site',)).labels(site=site).inc()
    except Exception:
        pass   # the error sink itself must never throw


def merge_snapshots(snapshots: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-host registry snapshots into one fleet view.

    Snapshots are deduped by process identity first — the
    `(process_uid, process_index)` pair. all_gather_object on a
    single-controller mesh returns world-size copies of the one local
    snapshot (same uid AND index — merging those must not multiply
    counters), while the fleet wire plane ships snapshots from distinct
    processes that may share a process_index but never a uid. Counters
    and histogram sums/counts add across hosts; gauges take the max
    (the fleet-wide watermark reading). The merged view lists the
    surviving `processes` (indexes) and `process_uids`.
    """
    by_proc: Dict[Any, Dict[str, Any]] = {}
    for s in snapshots:
        # (uid, index) pair: gathered copies of one snapshot share both
        # and collapse; distinct processes differ in uid even when their
        # process_index collides; snapshots taken from several
        # registries inside one process differ in index.
        key = (s.get('process_uid'), int(s.get('process_index', 0)))
        by_proc.setdefault(key, s)
    merged: Dict[str, Dict[str, Any]] = {}
    for snap in by_proc.values():
        for m in snap.get('metrics', []):
            tgt = merged.setdefault(m['name'], {
                'name': m['name'], 'type': m['type'], 'help': m['help'],
                'samples': {}})
            for s in m['samples']:
                key = tuple(sorted(s['labels'].items()))
                cur = tgt['samples'].get(key)
                if cur is None:
                    tgt['samples'][key] = {k: (dict(v) if isinstance(v, dict)
                                               else v)
                                           for k, v in s.items()}
                elif m['type'] == 'counter':
                    cur['value'] += s['value']
                elif m['type'] == 'gauge':
                    cur['value'] = max(cur['value'], s['value'])
                else:
                    cur['sum'] += s['sum']
                    cur['count'] += s['count']
                    for b, c in s['buckets'].items():
                        cur['buckets'][b] = cur['buckets'].get(b, 0) + c
                    # windowed quantiles can't be re-sketched from two
                    # windows; report the fleet-wide WORST per quantile
                    for q, v in (s.get('quantiles') or {}).items():
                        qd = cur.setdefault('quantiles', {})
                        qd[q] = max(qd.get(q, v), v)
    _recompute_goodput_fractions(merged)
    return {'processes': sorted({idx for _, idx in by_proc}),
            'process_uids': sorted({uid for uid, _ in by_proc
                                    if uid is not None}),
            'metrics': [{**m, 'samples': list(m['samples'].values())}
                        for m in merged.values()]}


def _recompute_goodput_fractions(merged: Dict[str, Dict[str, Any]]):
    """Goodput fractions are ratios, so the gauge-max merge rule is
    wrong for them: after counters merge (per-category seconds and wall
    seconds SUM across hosts), recompute every
    `paddle_goodput_fraction{category}` as merged-seconds / merged-wall
    — no double count, fractions still sum to ~1 fleet-wide."""
    secs = merged.get('paddle_goodput_seconds_total')
    wall_fam = merged.get('paddle_goodput_wall_seconds_total')
    frac = merged.get('paddle_goodput_fraction')
    if not (secs and wall_fam and frac):
        return
    wall = sum(s['value'] for s in wall_fam['samples'].values())
    if wall <= 0:
        return
    by_cat = {dict(key).get('category'): s['value']
              for key, s in secs['samples'].items()}
    for key, s in frac['samples'].items():
        cat = dict(key).get('category')
        if cat in by_cat:
            s['value'] = by_cat[cat] / wall
