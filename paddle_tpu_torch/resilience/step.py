"""FaultTolerantStep: rollback and skip-the-bad-batch around a train step
(counterpart of `paddle_tpu/resilience/step.py`).

Large-model practice (PaLM's skip-the-bad-step restarts) treats an
occasional NaN/Inf or loss-spike step as data to drop, not a run to kill:
restore the last known-good state, skip the offending batch, keep going,
up to a bounded skip budget, past which something is structurally wrong
and the run fails loudly.

The wrapper works over the port's `jit.TrainStep` (callable(inputs,
labels) -> loss, with `.layer`, `opt_state()`/`load_opt_state()` and
`._n_calls`), or over a bare callable given explicit `snapshot_fn` /
`restore_fn`. A snapshot holds host copies of the layer's parameters and
buffers, the optimizer's slots and step count and the step's `_n_calls`,
taken every `snapshot_interval` good steps, so a rollback replays from
at most `snapshot_interval - 1` steps back (with the default interval of
1 the replay is exactly "this batch never happened"). The LR scheduler is
not rolled back, as in the JAX package.

Where the JAX step snapshots through `np.asarray` (a bf16 moment would
come back as fp32 there, and numpy has no bf16), the port's snapshot
keeps each tensor's own dtype: one host buffer per tensor, pinned for a
tensor on the card, allocated at the first snapshot and reused by every
later one. A restore copies back in place (`copy_`): the optimizer keys
its slots by the parameter objects and the serving graphs read
parameters by address, so no tensor is replaced. A snapshot waits for
its copies (its seconds are what a rollback point costs).

Reports into the shared observability registry:
`paddle_resilience_rollbacks_total`,
`paddle_resilience_skipped_batches_total`, the `bad_step` and
`skip_budget_exhausted` events and the `resilience.rollback` span.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch

from .. import flags as _flags
from .. import observability as _obs
from .retry import RetryPolicy, call_with_retry


class SkipBudgetExhausted(RuntimeError):
    """More bad steps than the skip budget allows: the failure is not an
    isolated batch; stop instead of silently dropping the dataset."""


class FaultTolerantStep:
    """Wrap a train step with snapshot / bad-step rollback / retry.

    Args:
        step: the underlying step: a `TrainStep`, or any callable with
            `snapshot_fn`/`restore_fn`.
        skip_budget: total bad steps the run may drop before
            `SkipBudgetExhausted` (default FLAGS_ft_skip_budget).
        snapshot_interval: good steps between host snapshots (default
            FLAGS_ft_snapshot_interval; 1 = snapshot before every step).
        spike_window / spike_sigma / spike_min_steps: LossSpikeDetector
            config; `check_spikes=False` reduces detection to NaN/Inf.
        retry_policy: RetryPolicy for transient errors raised by the
            step; None disables retry.
        watchdog: an armed `StepWatchdog` whose watch() brackets each
            step call; None disables.
    """

    def __init__(self, step: Callable, *, skip_budget: Optional[int] = None,
                 snapshot_interval: Optional[int] = None,
                 spike_window: int = 20, spike_sigma: float = 6.0,
                 spike_min_steps: int = 5, check_spikes: bool = True,
                 retry_policy: Optional[RetryPolicy] = None,
                 watchdog=None,
                 snapshot_fn: Optional[Callable[[], Any]] = None,
                 restore_fn: Optional[Callable[[Any], None]] = None):
        self.step = step
        self.skip_budget = int(_flags.flag('FLAGS_ft_skip_budget')
                               if skip_budget is None else skip_budget)
        self.snapshot_interval = max(1, int(
            _flags.flag('FLAGS_ft_snapshot_interval')
            if snapshot_interval is None else snapshot_interval))
        self.retry_policy = retry_policy
        self.watchdog = watchdog
        self._snapshot_fn = snapshot_fn
        self._restore_fn = restore_fn
        if snapshot_fn is None and not hasattr(step, 'layer'):
            raise TypeError(
                f'{type(step).__name__} is not step-shaped (no .layer); '
                f'pass explicit snapshot_fn/restore_fn')
        self._spikes = None
        if check_spikes:
            from ..debug import LossSpikeDetector
            self._spikes = LossSpikeDetector(
                window=spike_window, threshold_sigma=spike_sigma,
                min_steps=spike_min_steps)
        self._snapshot = None
        self._host: Dict[tuple, torch.Tensor] = {}
        self._since_snapshot = 0
        self.rollbacks = 0
        self.skipped_batches = 0
        self.good_steps = 0
        self.last_step_skipped = False

    # -- state capture ------------------------------------------------------
    def _live(self) -> Dict[tuple, torch.Tensor]:
        """{key: the live tensor}: parameters, buffers and optimizer
        slots of the wrapped step."""
        layer = self.step.layer
        live = {('param', n): p for n, p in layer.named_parameters()}
        live.update({('buffer', n): b for n, b in layer.named_buffers()})
        opt = self.step.opt_state() if hasattr(self.step, 'opt_state') \
            else None
        for n, slots in (opt or {}).get('slots', {}).items():
            for k, v in slots.items():
                live[('slot', n, k)] = v
        return live, opt

    def _buffer(self, key, t: torch.Tensor) -> torch.Tensor:
        buf = self._host.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self._host[key] = torch.empty(
                t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        return buf

    @torch.no_grad()
    def _capture(self):
        if self._snapshot_fn is not None:
            return self._snapshot_fn()
        live, opt = self._live()
        devices = set()
        for key, t in live.items():
            self._buffer(key, t).copy_(t.detach(), non_blocking=t.is_cuda)
            if t.is_cuda:
                devices.add(t.device)
        for dev in devices:
            torch.cuda.current_stream(dev).synchronize()
        return {'keys': set(live),
                'opt_step': None if opt is None else opt['step'],
                'has_slots': bool(opt and opt['slots']),
                'n_calls': int(getattr(self.step, '_n_calls', 0))}

    @torch.no_grad()
    def _restore(self, snap):
        if self._restore_fn is not None:
            self._restore_fn(snap)
            return
        live, opt = self._live()
        for key, t in live.items():
            if key in snap['keys']:
                t.copy_(self._host[key], non_blocking=t.is_cuda)
        if not snap['has_slots'] and hasattr(self.step, 'load_opt_state'):
            self.step.load_opt_state(None)    # before the first update
        if opt is not None and snap['opt_step'] is not None:
            self.step.optimizer._step_count = snap['opt_step']
        if hasattr(self.step, '_n_calls'):
            self.step._n_calls = snap['n_calls']

    def snapshot_tensors(self) -> Dict[tuple, torch.Tensor]:
        """The last snapshot's host copies, by ('param' | 'buffer', name)
        or ('slot', parameter name, slot name)."""
        keys = self._snapshot['keys'] if self._snapshot else ()
        return {k: self._host[k] for k in keys}

    # -- the wrapped step ---------------------------------------------------
    def _run(self, *args, **kwargs):
        ctx = self.watchdog.watch() if self.watchdog is not None else None
        if ctx is None:
            return self.step(*args, **kwargs)
        with ctx:
            return self.step(*args, **kwargs)

    def __call__(self, *args, **kwargs):
        self.last_step_skipped = False
        if self._snapshot is None \
                or self._since_snapshot >= self.snapshot_interval:
            self._snapshot = self._capture()
            self._since_snapshot = 0
        if self.retry_policy is not None:
            loss = call_with_retry(self._run, *args,
                                   policy=self.retry_policy,
                                   site='train_step', **kwargs)
        else:
            loss = self._run(*args, **kwargs)
        lv = float(loss)
        bad = self._spikes.update(lv) if self._spikes is not None \
            else not math.isfinite(lv)
        if bad:
            self.rollbacks += 1
            self.skipped_batches += 1
            if _obs.enabled():
                reg = _obs.get_registry()
                reg.counter('paddle_resilience_rollbacks_total',
                            'bad-step rollbacks to the last snapshot').inc()
                reg.counter('paddle_resilience_skipped_batches_total',
                            'batches dropped by bad-step handling').inc()
                _obs.emit('bad_step', loss=lv,
                          skipped=self.skipped_batches,
                          budget=self.skip_budget)
            # spanned so the restore cost books as `rollback` in the
            # goodput ledger (which also moves the bad step's compute
            # there on the `bad_step` event emitted above)
            with _obs.span('resilience.rollback',
                           skipped=self.skipped_batches):
                self._restore(self._snapshot)
            self.last_step_skipped = True
            if self.skipped_batches > self.skip_budget:
                # flight-recorder trigger: the postmortem bundle is on
                # disk before the run dies on the raise below
                _obs.emit('skip_budget_exhausted', loss=lv,
                          skipped=self.skipped_batches,
                          budget=self.skip_budget)
                raise SkipBudgetExhausted(
                    f'{self.skipped_batches} bad steps exceed the skip '
                    f'budget of {self.skip_budget} (last loss {lv})')
        else:
            self.good_steps += 1
            self._since_snapshot += 1
        return loss

    def stats(self) -> Dict[str, Any]:
        return {'good_steps': self.good_steps,
                'rollbacks': self.rollbacks,
                'skipped_batches': self.skipped_batches,
                'skip_budget': self.skip_budget,
                'snapshot_interval': self.snapshot_interval}

    # look like the wrapped step (Model.fit reads its state through it)
    def __getattr__(self, name):
        return getattr(self.step, name)


__all__ = ['FaultTolerantStep', 'SkipBudgetExhausted']
