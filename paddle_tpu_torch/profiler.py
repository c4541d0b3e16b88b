"""paddle.profiler (counterpart of `paddle_tpu/profiler.py`; upstream:
python/paddle/profiler/profiler.py).

Host regions (`RecordEvent`, `annotate`) are timed in-process with their
real begin timestamps and durations, feed the port's observability
registry and event log (as the JAX package's feed its own), and are each
also a `torch.profiler.record_function`, so they name their spans in a
device trace. `Profiler(trace_dir=...)` without `timer_only` traces the
device with `torch.profiler` (CPU and, where there is a card, CUDA
activities) and writes a Chrome trace into `trace_dir` at `stop()`
(`trace_path`); the JAX package writes XLA's perfetto trace there.
`profile(dir)` is the one-liner; `Profiler` mirrors upstream's
start/step/stop object API with its schedulers, `summary()`, `export()`,
`export_chrome_tracing` and `load_profiler_result`.

`dispatch_stats()` keeps the JAX package's keys, all 0: the port has no
eager dispatch cache (torch runs eager ops without tracing).
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from . import observability as _obs


_DISPATCH_KEYS = ('hits', 'misses', 'retraces', 'fallbacks', 'calls')


def _dispatch_delta(since: Optional[Dict[str, int]]) -> Dict[str, int]:
    """The dispatch-cache counters' deltas: 0 each, as the port has no
    dispatch cache."""
    return {k: 0 for k in _DISPATCH_KEYS}


class _HostTimer(threading.local):
    def __init__(self):
        self.stack: List = []
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)
        # per-event records with REAL begin timestamps:
        # (name, begin_perf_counter_s, duration_s)
        self.events: List[Tuple[str, float, float]] = []
        self.active = False


_host = _HostTimer()


def _host_reset():
    _host.totals.clear()
    _host.counts.clear()
    _host.events.clear()


class RecordEvent:
    """Named host region, nestable; shows up in summary() and, as a
    `torch.profiler.record_function`, in a device trace. Each occurrence
    records its actual begin timestamp and duration (exported verbatim by
    export_chrome_tracing) and, when observability is enabled, lands in
    the shared EventLog and span histogram too."""

    def __init__(self, name: str):
        self.name = name
        self._fn_ctx = None
        self._t0 = 0.0
        self._span = None

    def begin(self):
        if _obs.enabled():
            self._span = _obs.span(self.name).begin()
        self._t0 = time.perf_counter()
        self._fn_ctx = torch.profiler.record_function(self.name)
        self._fn_ctx.__enter__()
        return self

    def end(self):
        dt = time.perf_counter() - self._t0
        if _host.active:
            _host.totals[self.name] += dt
            _host.counts[self.name] += 1
            _host.events.append((self.name, self._t0, dt))
        if self._fn_ctx is not None:
            self._fn_ctx.__exit__(None, None, None)
            self._fn_ctx = None
        if self._span is not None:
            self._span.end()
            self._span = None

    def __enter__(self):
        return self.begin()

    def __exit__(self, *exc):
        self.end()


def annotate(name: str) -> RecordEvent:
    return RecordEvent(name)


class Profiler:
    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, trace_dir: Optional[str] = None):
        self.timer_only = timer_only
        self.trace_dir = trace_dir
        self.trace_path: Optional[str] = None
        self._torch_prof = None
        self._tracing = False
        self._step_count = 0
        self._step_times: List[float] = []
        self._last_step_t: Optional[float] = None
        # upstream scheduler protocol: a fn(step)->ProfilerState driving
        # windowed recording; tuple (start, end) means RECORD in [a, b)
        if isinstance(scheduler, tuple):
            a, b = scheduler
            if b <= a:
                raise ValueError(f'scheduler window ({a}, {b}) is empty')
            # upstream tuple scheduler: ONE record window [a, b)
            scheduler = make_scheduler(closed=a, ready=0, record=b - a,
                                       repeat=1)
        self._scheduler = scheduler
        self._on_trace_ready = on_trace_ready
        self._window_open = False
        self._dispatch_start: Optional[Dict[str, int]] = None

    def dispatch_stats(self) -> Dict[str, int]:
        """The JAX package's dispatch-cache counter deltas since start()
        (hits / misses / retraces / fallbacks / calls): 0 each here."""
        return _dispatch_delta(self._dispatch_start)

    def start(self):
        _host.active = True
        _host_reset()
        if self._scheduler is not None and self._scheduler(0) in (
                ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN):
            self._window_open = True
        self._last_step_t = time.perf_counter()
        if self.trace_dir and not self.timer_only:
            os.makedirs(self.trace_dir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._torch_prof = torch.profiler.profile(activities=acts)
            self._torch_prof.start()
            self._tracing = True
        return self

    def step(self):
        now = time.perf_counter()
        if self._last_step_t is not None:
            self._step_times.append(now - self._last_step_t)
        self._last_step_t = now
        self._step_count += 1
        if self._scheduler is not None:
            # schedules are 0-based; step() is the boundary between
            # completed step (count-1) and upcoming step (count)
            rec = (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
            prev = self._scheduler(self._step_count - 1)
            if self._window_open and (
                    prev == ProfilerState.RECORD_AND_RETURN
                    or prev not in rec):
                self._window_open = False
                if self._on_trace_ready is not None:
                    self._on_trace_ready(self)
            if not self._window_open \
                    and self._scheduler(self._step_count) in rec:
                self._window_open = True
                # a window exports ITS steps only: reset the host
                # aggregates when it opens
                _host_reset()

    def stop(self):
        # a scheduler window still open at stop() owns real data (e.g. a
        # RECORD phase the loop exited mid-cycle): flush it to
        # on_trace_ready before deactivating, instead of dropping it
        if self._window_open:
            self._window_open = False
            if self._on_trace_ready is not None:
                self._on_trace_ready(self)
        _host.active = False
        if self._tracing:
            try:
                self._torch_prof.stop()
                self.trace_path = os.path.join(
                    self.trace_dir,
                    f'paddle_tpu_torch_device_{self._step_count}.json')
                self._torch_prof.export_chrome_trace(self.trace_path)
            finally:
                self._tracing = False
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def summary(self, sorted_by='total', max_rows=30) -> str:
        rows = sorted(_host.totals.items(), key=lambda kv: -kv[1])
        lines = [f'{"region":<40}{"calls":>8}{"total_s":>12}{"avg_ms":>10}']
        for name, total in rows[:max_rows]:
            n = _host.counts[name]
            lines.append(
                f'{name:<40}{n:>8}{total:>12.4f}{total / n * 1e3:>10.2f}')
        if self._step_times:
            avg = sum(self._step_times) / len(self._step_times)
            lines.append(f'steps: {self._step_count}, avg step '
                         f'{avg * 1e3:.2f} ms')
        d = self.dispatch_stats()
        if d['calls']:
            rate = d['hits'] / d['calls']
            lines.append(
                f'eager dispatch: {d["calls"]} ops, {rate:.1%} cache hits'
                f' ({d["misses"]} misses, {d["retraces"]} retraces, '
                f'{d["fallbacks"]} fallbacks)')
        # shared observability registry: compile time / comm bytes /
        # memory watermark recorded by the instrumented runtime
        reg = _obs.get_registry()
        compiles = reg.value('paddle_jit_compiles_total')
        if compiles:
            lines.append(
                f'jit: {int(compiles)} compiles, '
                f'{reg.value("paddle_jit_compile_seconds_total"):.3f} s')
        comm = _obs.collective_totals(reg)
        if comm['calls']:
            lines.append(f'collectives: {int(comm["calls"])} calls, '
                         f'{int(comm["bytes"])} bytes')
        mem = reg.value('paddle_memory_watermark_bytes')
        if mem:
            lines.append(f'memory watermark: {mem / 2**20:.1f} MiB')
        s = '\n'.join(lines)
        return s

    def export(self, path: str):
        with open(path, 'w') as f:
            json.dump({'regions': {k: {'total_s': v,
                                       'calls': _host.counts[k]}
                                   for k, v in _host.totals.items()},
                       'step_times': self._step_times,
                       'dispatch': self.dispatch_stats(),
                       'observability': _obs.get_registry().snapshot()}, f)


@contextlib.contextmanager
def profile(trace_dir: Optional[str] = None, timer_only=False):
    """`with paddle_tpu_torch.profiler.profile(trace_dir):`: a device
    trace (torch.profiler) and host region timing."""
    p = Profiler(trace_dir=trace_dir, timer_only=timer_only)
    p.start()
    try:
        yield p
    finally:
        p.stop()


class ProfilerState:
    """Scheduler states (upstream paddle.profiler.ProfilerState)."""
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget:
    """Hardware targets (upstream paddle.profiler.ProfilerTarget); the
    JAX package's TPU alias is kept."""
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM_DEVICE = 3
    TPU = 3  # alias: the custom device of this build


def make_scheduler(*, closed, ready, record, repeat=0, skip_first=0):
    """Windowed profiling schedule (upstream
    paddle.profiler.make_scheduler): skip_first steps, then cycles of
    closed -> ready -> record; repeat=0 cycles forever."""
    cycle = closed + ready + record
    if cycle <= 0:
        raise ValueError('closed + ready + record must be positive')

    def schedule(step: int) -> int:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= cycle * repeat:
            return ProfilerState.CLOSED
        pos = s % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD
    return schedule


def export_chrome_tracing(dir_name: str, worker_name: str = None):
    """on_trace_ready factory writing chrome://tracing JSON of the host
    regions (upstream paddle.profiler.export_chrome_tracing). Each
    RecordEvent occurrence is emitted at its real begin timestamp with
    its real duration. The device timeline is the torch.profiler trace a
    Profiler with `trace_dir` writes (`Profiler.trace_path`)."""
    def handler(prof: 'Profiler'):
        os.makedirs(dir_name, exist_ok=True)
        events = []
        counts: Dict[str, int] = collections.defaultdict(int)
        window = sorted(_host.events, key=lambda e: e[1])
        origin = window[0][1] if window else 0.0
        for name, t0, dur in window:
            counts[name] += 1
            events.append({
                'name': name, 'ph': 'X', 'pid': 0,
                'tid': worker_name or 'host',
                'ts': int((t0 - origin) * 1e6), 'dur': int(dur * 1e6),
                'args': {'calls': counts[name]},
            })
        path = os.path.join(
            dir_name, f'paddle_tpu_trace_{prof._step_count}.json')
        with open(path, 'w') as f:
            json.dump({'traceEvents': events}, f)
        return path
    return handler


def load_profiler_result(path: str):
    """Read back a chrome-tracing JSON written by
    export_chrome_tracing (upstream load_profiler_result)."""
    with open(path) as f:
        return json.load(f)
