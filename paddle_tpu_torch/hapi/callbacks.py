"""hapi callbacks (counterpart of `paddle_tpu/hapi/callbacks.py`;
upstream: python/paddle/hapi/callbacks.py), copied: the same hooks,
logs and side effects. `VisualDL` writes the JAX callback's JSONL records
(`utils.logging.SummaryWriter`); `MetricsLoggerCallback` feeds the port's
`observability.StepTelemetry` and a `debug.LossSpikeDetector`."""
from __future__ import annotations

import math
import os
import sys
import time
import warnings
from typing import Dict, List, Optional


class Callback:
    def __init__(self):
        self.model = None
        self.params: Dict = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks: List[Callback]):
        self.callbacks = callbacks

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def __getattr__(self, name):
        if not name.startswith('on_'):
            raise AttributeError(name)

        def dispatch(*args, **kwargs):
            for c in self.callbacks:
                getattr(c, name)(*args, **kwargs)
        return dispatch


class ProgBarLogger(Callback):
    def __init__(self, log_freq=10, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t0 = time.time()
        if self.verbose:
            total = self.params.get('epochs')
            print(f'Epoch {epoch + 1}/{total}', file=sys.stderr)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose >= 2 and step % self.log_freq == 0:
            kv = ' - '.join(f'{k}: {v:.4f}' if isinstance(v, float)
                            else f'{k}: {v}'
                            for k, v in (logs or {}).items())
            print(f'  step {step}: {kv}', file=sys.stderr)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            kv = ' - '.join(f'{k}: {v:.4f}' if isinstance(v, float)
                            else f'{k}: {v}'
                            for k, v in (logs or {}).items())
            print(f'  epoch done in {dt:.1f}s - {kv}', file=sys.stderr)


class LRSchedulerCallback(Callback):
    """Steps an LRScheduler attached to the optimizer (upstream name:
    paddle.callbacks.LRScheduler)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, '_optimizer', None)
        lr = getattr(opt, '_learning_rate', None)
        return lr if hasattr(lr, 'step') else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir='checkpoint'):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.model:
            self.model.save(os.path.join(self.save_dir, 'final'))


def _resolve_mode(mode, monitor):
    """'auto' -> 'max' for accuracy-like monitors, else 'min' (shared by
    EarlyStopping and ReduceLROnPlateau)."""
    if mode == 'auto':
        return 'max' if 'acc' in monitor else 'min'
    return mode


def _extract_metric(logs, monitor):
    """Pull a scalar metric out of a hapi logs dict (metrics may arrive
    as 1-element lists); None if absent."""
    cur = (logs or {}).get(monitor)
    if cur is None:
        return None
    return float(cur[0] if isinstance(cur, (list, tuple)) else cur)


class EarlyStopping(Callback):
    def __init__(self, monitor='loss', mode='auto', patience=0,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.mode = _resolve_mode(mode, monitor)
        self.stopped = False
        self.wait = 0
        self.best = None
        self._warned_nan = False
        self._warned_missing = False

    def _better(self, cur, best):
        if best is None:
            return True
        delta = self.min_delta if self.mode == 'max' else -self.min_delta
        return cur > best + delta if self.mode == 'max' \
            else cur < best - delta

    def on_eval_end(self, logs=None):
        cur = _extract_metric(logs, self.monitor)
        if cur is None:
            if not self._warned_missing:
                self._warned_missing = True
                warnings.warn(
                    f'EarlyStopping: monitored metric {self.monitor!r} is '
                    f'missing from eval logs; callback is inactive')
            return
        # a NaN metric must never become `best` (NaN compares false
        # against everything, so every later value would look like "no
        # improvement"); treat the NaN step itself as no improvement
        if math.isnan(cur):
            if not self._warned_nan:
                self._warned_nan = True
                warnings.warn(
                    f'EarlyStopping: monitored metric {self.monitor!r} is '
                    f'NaN; treating as no improvement')
            improved = False
        else:
            improved = self._better(cur, self.best)
        if improved:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.stopped = True
                if self.model is not None:
                    self.model.stop_training = True


class VisualDL(Callback):
    """Metric logging via the JSONL summary writer
    (paddle.callbacks.VisualDL parity)."""

    def __init__(self, log_dir='vdl_log'):
        super().__init__()
        self.log_dir = log_dir
        self._writer = None
        self._step = 0

    def _ensure_writer(self):
        if self._writer is None:  # standalone evaluate() skips train_begin
            from ..utils.logging import SummaryWriter
            self._writer = SummaryWriter(self.log_dir)
        return self._writer

    def on_train_begin(self, logs=None):
        self._ensure_writer()

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        w = self._ensure_writer()
        for k, v in (logs or {}).items():
            try:
                w.add_scalar(f'train/{k}', float(v), self._step)
            except (TypeError, ValueError):
                pass

    def on_eval_end(self, logs=None):
        w = self._ensure_writer()
        for k, v in (logs or {}).items():
            try:
                v = v[0] if isinstance(v, (list, tuple)) else v
                w.add_scalar(f'eval/{k}', float(v), self._step)
            except (TypeError, ValueError):
                pass

    def on_train_end(self, logs=None):
        if self._writer:
            self._writer.close()


class MetricsLoggerCallback(Callback):
    """Streams per-step train metrics into the shared observability
    registry via StepTelemetry (steps/sec, tokens/sec, last loss,
    device-memory watermark) and flags divergence with a
    debug.LossSpikeDetector whose hits land in the EventLog as
    `loss_spike` events.

    `tokens_per_batch` sets the token increment per optimizer step (e.g.
    batch_size * seq_len for an LM); when None only step rates are
    tracked. `log_dir` additionally appends registry JSONL exports every
    `export_freq` steps for plain-file tailing. `metrics_port` starts
    the HTTP observability endpoint (observability.start_server) on
    train begin, so a hapi `fit()` is scrapeable from outside the
    process (/metrics, /healthz, /summary, /events, /trace, /programs).
    """

    def __init__(self, tokens_per_batch: Optional[int] = None,
                 log_dir: Optional[str] = None, export_freq: int = 100,
                 spike_window: int = 20,
                 metrics_port: Optional[int] = None):
        super().__init__()
        self.tokens_per_batch = tokens_per_batch
        self.log_dir = log_dir
        self.export_freq = max(int(export_freq), 1)
        self._spike_window = spike_window
        self.metrics_port = metrics_port
        self.server = None
        self._telemetry = None
        self._spikes = None
        self._n = 0

    @property
    def telemetry(self):
        if self._telemetry is None:
            from .. import observability as obs
            self._telemetry = obs.StepTelemetry()
        return self._telemetry

    def on_train_begin(self, logs=None):
        from ..debug import LossSpikeDetector
        self._spikes = LossSpikeDetector(window=self._spike_window)
        self.telemetry
        if self.metrics_port is not None and self.server is None:
            from .. import observability as obs
            self.server = obs.start_server(self.metrics_port)

    def on_train_batch_end(self, step, logs=None):
        loss = (logs or {}).get('loss')
        if isinstance(loss, (list, tuple)):
            loss = loss[0] if loss else None
        self.telemetry.step(loss=loss, tokens=self.tokens_per_batch)
        if loss is not None and self._spikes is not None:
            self._spikes.update(loss)
        self._n += 1
        if self.log_dir and self._n % self.export_freq == 0:
            self._export()

    def on_train_end(self, logs=None):
        if self.log_dir:
            self._export()

    def _export(self):
        from .. import observability as obs
        os.makedirs(self.log_dir, exist_ok=True)
        obs.to_jsonl(path=os.path.join(self.log_dir, 'metrics.jsonl'))


# upstream name parity: paddle.callbacks.LRScheduler
# (python/paddle/hapi/callbacks.py exposes the class under this name)
LRScheduler = LRSchedulerCallback


class ReduceLROnPlateau(Callback):
    """Shrink the LR when the monitored metric plateaus (upstream
    paddle.callbacks.ReduceLROnPlateau). Works on the optimizer the
    hapi Model was prepared with."""

    def __init__(self, monitor='loss', factor=0.1, patience=10,
                 mode='auto', min_delta=1e-4, cooldown=0, min_lr=0.0,
                 verbose=1):
        super().__init__()
        if not 0.0 < factor < 1.0:
            raise ValueError('factor must be in (0, 1), got '
                             f'{factor!r}')
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.verbose = verbose
        self.mode = _resolve_mode(mode, monitor)
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0
        self._eval_seen_this_epoch = False
        self._warned_nan = False
        self._warned_missing = False

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == 'max':
            return cur > self.best + self.min_delta
        return cur < self.best - self.min_delta

    def _on_metric(self, logs):
        cur = _extract_metric(logs, self.monitor)
        if cur is None:
            if not self._warned_missing:
                self._warned_missing = True
                warnings.warn(
                    f'ReduceLROnPlateau: monitored metric '
                    f'{self.monitor!r} is missing from logs; callback is '
                    f'inactive')
            return
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        # NaN must not poison `best` (see EarlyStopping): it counts as a
        # plateau step but is never stored
        if math.isnan(cur):
            if not self._warned_nan:
                self._warned_nan = True
                warnings.warn(
                    f'ReduceLROnPlateau: monitored metric '
                    f'{self.monitor!r} is NaN; treating as no improvement')
        elif self._better(cur):
            self.best = cur
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience and self.cooldown_counter == 0:
            opt = getattr(self.model, '_optimizer', None)
            if opt is None:
                return
            old = float(opt.get_lr())
            new = max(old * self.factor, self.min_lr)
            if new < old:
                opt.set_lr(new)
                if self.verbose:
                    print(f'ReduceLROnPlateau: lr {old:.2e} -> {new:.2e}')
            self.cooldown_counter = self.cooldown
            self.wait = 0

    def on_eval_end(self, logs=None):
        # eval metrics win: remember we saw them so the epoch-end train
        # metrics for the same epoch don't double-count patience
        self._eval_seen_this_epoch = True
        self._on_metric(logs)

    def on_epoch_end(self, epoch, logs=None):
        if self._eval_seen_this_epoch:
            self._eval_seen_this_epoch = False
            return
        self._on_metric(logs)


__all__ = ['Callback', 'CallbackList', 'EarlyStopping', 'LRScheduler',
           'LRSchedulerCallback', 'MetricsLoggerCallback', 'ModelCheckpoint',
           'ProgBarLogger', 'ReduceLROnPlateau', 'VisualDL']
