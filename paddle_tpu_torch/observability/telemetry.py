"""Runtime instrumentation: the jit-cache gauge, collective totals, the
device-memory watermark and per-step training telemetry (a copy of
`paddle_tpu/observability/telemetry.py`).

- `StepTelemetry` tracks steps/sec, tokens/sec, last loss, and the
  device-memory watermark; a training loop drives it once per step
  (`step(loss=, tokens=)`), beside the `train.step` span the port's
  `jit.TrainStep` opens.
- `note_jit_cache_entry(kind)` counts executables held by python-side
  caches (`paddle_jit_cache_entries{kind}`): `jit.TrainStep` notes
  `train_step` once, at its first call, as the JAX step notes its one
  trace.
- `device_memory_bytes()` reads `torch.cuda.memory_stats()`.

The JAX `install()` hooks `jax.monitoring`'s compile events into
`paddle_jit_compiles_total` and the dispatch cache's collector into
`paddle_dispatch_*`. PyTorch has neither: the port runs eagerly and
captures CUDA graphs, and it books each capture (seconds, count) in the
program catalog (`cost.py`, `note_compile`) instead, so this module has
no `install()`.
"""
from __future__ import annotations

import collections
import time
from typing import Optional

from . import metrics as _metrics


def note_jit_cache_entry(kind: str = 'to_static'):
    """Called when a new executable lands in a python-side cache (the
    port's `jit.TrainStep` at its first call)."""
    if not _metrics.enabled():
        return
    _metrics.get_registry().gauge(
        'paddle_jit_cache_entries',
        'executables held by python-side jit caches', ('kind',)).labels(
            kind=kind).inc()


def collective_totals(reg: Optional['_metrics.MetricsRegistry'] = None
                      ) -> dict:
    """Sum the per-(op, axis) collective counters into totals plus a
    per-label breakdown: {'calls', 'bytes', 'per_op': {(op, axis):
    {'calls', 'bytes'}}}."""
    reg = reg if reg is not None else _metrics.get_registry()
    out = {'calls': 0.0, 'bytes': 0.0, 'per_op': {}}
    for metric, field in (('paddle_collective_calls_total', 'calls'),
                          ('paddle_collective_bytes_total', 'bytes')):
        fam = reg.get(metric)
        if fam is None:
            continue
        for key, child in fam.children():
            out[field] += child.value
            row = out['per_op'].setdefault(key, {'calls': 0.0, 'bytes': 0.0})
            row[field] += child.value
    return out


def device_memory_bytes() -> int:
    """The device-memory footprint: the CUDA caching allocator's peak
    allocated bytes (`allocated_bytes.all.peak` of
    `torch.cuda.memory_stats()`), else its current allocated bytes. On
    the CPU, or without a card, there are no allocator stats and this
    returns 0 (unknown)."""
    import torch
    if not torch.cuda.is_available():
        return 0
    try:
        stats = torch.cuda.memory_stats()
    except Exception:  # paddle-lint: disable=swallowed-exception -- allocator stats unavailable; 0 means unknown
        return 0
    for key in ('allocated_bytes.all.peak', 'allocated_bytes.all.current'):
        if stats.get(key):
            return int(stats[key])
    return 0


class StepTelemetry:
    """Per-step training telemetry into the shared registry.

    `step(loss=..., tokens=...)` once per optimizer step updates:
    paddle_steps_total, paddle_tokens_total, paddle_steps_per_sec /
    paddle_tokens_per_sec (trailing-window rates), paddle_loss_last,
    and the paddle_memory_watermark_bytes high-water gauge.
    """

    def __init__(self, registry: Optional['_metrics.MetricsRegistry'] = None,
                 window: int = 20, memory_every: int = 1):
        reg = registry if registry is not None else _metrics.get_registry()
        self._steps = reg.counter('paddle_steps_total',
                                  'optimizer steps taken')
        self._tokens = reg.counter('paddle_tokens_total',
                                   'training tokens consumed')
        self._sps = reg.gauge('paddle_steps_per_sec',
                              'trailing-window steps/sec')
        self._tps = reg.gauge('paddle_tokens_per_sec',
                              'trailing-window tokens/sec')
        self._loss = reg.gauge('paddle_loss_last', 'last observed loss')
        self._mem = reg.gauge('paddle_memory_watermark_bytes',
                              'device-memory high-water mark')
        self._times = collections.deque(maxlen=max(window, 2))
        self._tok_hist = collections.deque(maxlen=max(window, 2))
        self._memory_every = max(int(memory_every), 1)
        self._n = 0

    def step(self, loss=None, tokens: Optional[int] = None):
        if not _metrics.enabled():
            return self
        from . import flight as _flight
        from .server import note_progress
        now = time.perf_counter()
        self._times.append(now)
        self._n += 1
        self._steps.inc()
        if tokens:
            self._tokens.inc(tokens)
            self._tok_hist.append(tokens)
        if loss is not None:
            try:
                self._loss.set(float(loss))
            except (TypeError, ValueError):
                pass
        if len(self._times) >= 2:
            dt = self._times[-1] - self._times[0]
            if dt > 0:
                n = len(self._times) - 1
                self._sps.set(n / dt)
                if self._tok_hist:
                    # rate over the steps the window actually spans
                    tok = sum(list(self._tok_hist)[-n:])
                    self._tps.set(tok / dt)
        if self._n % self._memory_every == 0:
            mem = device_memory_bytes()
            self._mem.set_to_max(mem)
            _flight.get_flight_recorder().record_memory(mem)
        # liveness heartbeat (/healthz) + flight-recorder ring sample
        note_progress('step')
        _flight.get_flight_recorder().record_step(
            loss=self._loss.value if loss is not None else None,
            tokens_per_sec=self._tps.value, step=self._n)
        return self

    def phase(self, name: str, **attrs):
        """Step-phase waterfall sub-span: `with telemetry.phase(
        'data_wait'): batch = next(loader)` records a `step.{name}`
        span the goodput ledger classifies (step.data_wait ->
        host_wait, step.compute -> step_compute, ...) and the chrome
        trace renders as the per-step waterfall."""
        from . import events as _events
        return _events.span(f'step.{name}', **attrs)

    def update_memory_watermark(self):
        if _metrics.enabled():
            self._mem.set_to_max(device_memory_bytes())
        return self

    def summary(self) -> dict:
        return {'steps': self._steps.value,
                'tokens': self._tokens.value,
                'steps_per_sec': self._sps.value,
                'tokens_per_sec': self._tps.value,
                'loss_last': self._loss.value,
                'memory_watermark_bytes': self._mem.value}
