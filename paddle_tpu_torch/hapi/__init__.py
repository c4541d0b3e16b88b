"""hapi: the high-level `paddle.Model` train/eval/predict API (counterpart
of `paddle_tpu/hapi/__init__.py`; upstream: python/paddle/hapi/model.py).

`fit` drives the port's `jit.TrainStep` over an `io.DataLoader`, and is
where the training user's fault tolerance meets the data: step-indexed
checkpoints of the model, the optimizer's state, `_n_calls`, the global
step and the loader's mid-epoch cursor (`utils.CheckpointManager`, the
JAX package's npz layout and tree, so checkpoints cross between the
packages), `resume` from them bit for bit, `fault_tolerance`
(`resilience.FaultTolerantStep`), `step_timeout`
(`resilience.StepWatchdog`) and `handle_preemption`
(`resilience.PreemptionHandler`). eval and predict run the network under
`torch.no_grad`, batches moved to its device. `prepare(amp_configs=)`
takes 'O1' (training and evaluation batches under `amp.auto_cast`) and
'O2' (`amp.decorate`: the model cast once, fp32 masters in the
optimizer), as the JAX Model does.

Not ported yet (ROADMAP.md, Queue 1): `fit(elastic=...)`
(`resilience/elastic.py`, which waits for `distributed/`).
`accumulate_grad_batches > 1` raises, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import serialization
from ..io import DataLoader, Dataset
from ..jit import TrainStep, _to_device
from ..metric import Metric
from ..weights import _copy_by_name
from . import callbacks as callbacks_mod
from .callbacks import (Callback, CallbackList, EarlyStopping,
                        LRSchedulerCallback, MetricsLoggerCallback,
                        ModelCheckpoint, ProgBarLogger, ReduceLROnPlateau,
                        VisualDL)

__all__ = ['Model', 'Callback', 'EarlyStopping', 'LRSchedulerCallback',
           'ReduceLROnPlateau', 'MetricsLoggerCallback',
           'ModelCheckpoint', 'ProgBarLogger', 'VisualDL', 'callbacks_mod']


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f'{what} is not ported yet (ROADMAP.md, '
                               f'Queue 1)')


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _spanned_batches(loader):
    """Iterate `loader` with each batch fetch inside a `step.data_wait`
    span: input-pipeline stalls land in the goodput ledger's host_wait
    category instead of the unattributed residual."""
    from .. import observability as _obs
    it = iter(loader)
    while True:
        with _obs.span('step.data_wait'):
            try:
                batch = next(it)
            except StopIteration:
                return
        yield batch


def _as_loader(data, batch_size, shuffle, num_workers, drop_last):
    if data is None or isinstance(data, DataLoader):
        return data
    if isinstance(data, Dataset):
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          num_workers=num_workers, drop_last=drop_last)
    raise TypeError(f'expected Dataset/DataLoader, got {type(data)}')


def _feed_metric(m: Metric, out, lab):
    """compute() may return one value or a tuple destined for update()."""
    res = m.compute(out, lab)
    if isinstance(res, tuple):
        m.update(*res)
    else:
        m.update(res)


def _split_batch(batch):
    """(inputs..., label) convention: the last element is the label."""
    if isinstance(batch, (list, tuple)):
        if len(batch) >= 2:
            *ins, lab = batch
            return tuple(ins), lab
        return tuple(batch), None  # 1-tuple: the sole element is the input
    return (batch,), None


def _host_array(t) -> np.ndarray:
    """A network output as a host array (bf16/fp16 read as fp32, which
    holds them exactly)."""
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


class Model:
    def __init__(self, network: torch.nn.Module, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._train_step: Optional[TrainStep] = None
        self._ft_step = None  # FaultTolerantStep wrapper, set by fit()
        self.stop_training = False

    @property
    def _device(self) -> torch.device:
        p = next(self.network.parameters(), None)
        return p.device if p is not None else torch.device('cpu')

    # -- setup --------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        if loss is not None and not callable(loss):
            raise TypeError('loss must be callable (a loss Layer or fn)')
        self._amp_level = 'O0'
        self._amp_dtype = 'bfloat16'
        if amp_configs:
            from .. import amp as _amp
            cfg = ({'level': amp_configs} if isinstance(amp_configs, str)
                   else dict(amp_configs))
            level = cfg.get('level', 'O1')
            self._amp_dtype = cfg.get('dtype', 'bfloat16')
            if level == 'O2':
                out = _amp.decorate(self.network, optimizer, level='O2',
                                    dtype=self._amp_dtype)
                if optimizer is not None:
                    self.network, optimizer = out
                else:
                    self.network = out
            elif level not in ('O0', 'O1'):
                raise ValueError(f'bad amp level {level!r}')
            self._amp_level = level
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(f'metric {m!r} is not a paddle.metric.Metric')
        self._train_step = None
        return self

    def _ensure_step(self):
        if self._train_step is None:
            if self._optimizer is None or self._loss is None:
                raise RuntimeError('call prepare(optimizer, loss) first')
            _loss = self._loss

            def loss_fn(outputs, labels):
                out = outputs[0] if isinstance(outputs, (list, tuple)) \
                    else outputs
                return _loss(out, labels)
            self._train_step = TrainStep(self.network, loss_fn,
                                         self._optimizer)
            restored = self.__dict__.pop('_restored_opt_state', None)
            if restored is not None:
                self._train_step.load_opt_state(restored)
        return self._train_step

    # -- batch-level API ----------------------------------------------------
    def _amp_ctx(self):
        """auto_cast around a training or evaluation batch under O1 (O2
        runs the decorated model as it is), as the JAX Model does."""
        if getattr(self, '_amp_level', 'O0') == 'O1':
            from .. import amp as _amp
            return _amp.auto_cast(level='O1', dtype=self._amp_dtype)
        return contextlib.nullcontext()

    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        step = self._ft_step if self._ft_step is not None \
            else self._ensure_step()
        ins = tuple(_to_list(inputs)) if isinstance(inputs, (list, tuple)) \
            else (inputs,)
        with self._amp_ctx():
            loss = step(ins if len(ins) > 1 else ins[0], labels)
        return [float(loss)]

    def _forward(self, ins):
        dev = self._device
        with torch.no_grad():
            out = self.network(*[_to_device(x, dev) for x in ins])
        return out[0] if isinstance(out, (list, tuple)) else out

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        with self._amp_ctx():
            out = self._forward(_to_list(inputs))
        res = {}
        if self._loss is not None and labels is not None:
            with torch.no_grad():
                res['loss'] = [float(self._loss(
                    out, _to_device(labels, self._device)))]
        for m in self._metrics:
            _feed_metric(m, out, labels)
        return res

    def predict_batch(self, inputs):
        self.network.eval()
        return self._forward(_to_list(inputs))

    # -- loops --------------------------------------------------------------
    def _save_train_ckpt(self, mgr, it, loader, force=False):
        """Step-indexed training checkpoint in the JAX tree: the model,
        the optimizer's state in the JAX step's `_opt_state` layout
        (None before the first update), `n_calls` and the global step,
        with the loader's cursor in the committed sidecar, so resume
        replays the exact remaining batches."""
        st = self._ensure_step()
        opt = st.opt_state()
        tree = {'model': dict(self.network.state_dict()),
                'opt': ({'step': np.asarray(opt['step'], np.int32),
                         'slots': opt['slots']} if opt['slots'] else None),
                'n_calls': st._n_calls,
                'step': it}
        return mgr.save(it, tree, force=force,
                        dataloader=loader
                        if hasattr(loader, 'state_dict') else None)

    def _restore_train_ckpt(self, mgr, step, loader):
        """Inverse of _save_train_ckpt, in place: parameters and slots
        keep their storage. Returns the restored global step."""
        cursor_loader = loader if hasattr(loader, 'set_state_dict') else None
        tree = mgr.restore(step, dataloader=cursor_loader)
        _copy_by_name(tree['model'], self.network.state_dict(),
                      'checkpoint does not match the model')
        st = self._ensure_step()
        st.load_opt_state(tree.get('opt'))
        st._n_calls = int(np.asarray(tree.get('n_calls', 0)))
        return int(np.asarray(tree.get('step', 0)))

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None,
            ckpt_dir=None, ckpt_interval=1, resume=None,
            fault_tolerance=None, step_timeout=None,
            handle_preemption=None, elastic=None):
        """Train the prepared model.

        Fault-tolerance knobs (all off by default):
          ckpt_dir: directory (or a CheckpointManager) for step-indexed
            training checkpoints every `ckpt_interval` optimizer steps,
            each committed with the dataloader cursor.
          resume: 'auto' restores the latest committed step from
            ckpt_dir (fresh run if none exist); an int restores that
            exact step. Restores params, the optimizer's slots and step
            count, `n_calls`, the global step and the mid-epoch
            dataloader cursor: the resumed loss trajectory is bit-exact
            against an uninterrupted run.
          fault_tolerance: True (defaults) or a dict of
            resilience.FaultTolerantStep kwargs: NaN/Inf and loss-spike
            steps roll back to the last snapshot and the batch is
            skipped, within a bounded skip budget.
          step_timeout: seconds before a step is declared hang-suspected
            (resilience.StepWatchdog; emits `hang_suspected`).
          handle_preemption: install SIGTERM/SIGINT handlers that force
            a synchronous checkpoint and exit the loop cleanly (defaults
            to True when ckpt_dir is set).
          elastic: not ported (ROADMAP.md, Queue 1); a truthy value
            raises.
        """
        if accumulate_grad_batches != 1:
            raise NotImplementedError(
                'accumulate_grad_batches > 1 is not implemented yet '
                '(ROADMAP.md, Queue 1); raise the batch size')
        if elastic:
            raise _not_ported('fit(elastic=...) (resilience/elastic.py, '
                              'after distributed/)')
        from .. import observability as _obs
        from .. import resilience as _res
        loader = _as_loader(train_data, batch_size, shuffle, num_workers,
                            drop_last)
        eval_loader = _as_loader(eval_data, batch_size, False, num_workers,
                                 False)
        cbs = _to_list(callbacks)
        if verbose and not any(isinstance(c, ProgBarLogger) for c in cbs):
            cbs = [ProgBarLogger(log_freq, verbose=verbose)] + cbs
        if save_dir:
            cbs.append(ModelCheckpoint(save_freq, save_dir))
        cblist = CallbackList(cbs)
        cblist.set_model(self)
        cblist.set_params({'epochs': epochs, 'verbose': verbose,
                           'metrics': ['loss'] + [m.name()
                                                  for m in self._metrics]})
        # ---- resilience plumbing ----------------------------------------
        mgr = None
        if ckpt_dir is not None:
            from ..utils.checkpoint import CheckpointManager
            if isinstance(ckpt_dir, CheckpointManager):
                mgr = ckpt_dir
            else:
                mgr = CheckpointManager(
                    ckpt_dir, backend='npz',
                    save_interval_steps=max(1, int(ckpt_interval)))
        if resume not in (None, False) and mgr is None:
            raise ValueError("fit(resume=...) requires ckpt_dir")
        # The JAX fit preloads the train programs of a persistent program
        # store here; the port runs eagerly and has no program store, so
        # there is nothing to warm.
        it_count = 0
        start_epoch = 0
        if resume not in (None, False):
            target = mgr.latest_step() if resume == 'auto' else int(resume)
            if target is not None:   # 'auto' on an empty dir = fresh run
                it_count = self._restore_train_ckpt(mgr, target, loader)
                if hasattr(loader, 'state_dict'):
                    start_epoch = int(loader.state_dict()['epoch'])
        if fault_tolerance:
            ft_cfg = dict(fault_tolerance) \
                if isinstance(fault_tolerance, dict) else {}
            self._ft_step = _res.FaultTolerantStep(self._ensure_step(),
                                                   **ft_cfg)
        wd = _res.StepWatchdog(step_timeout) if step_timeout else None
        if handle_preemption is None:
            handle_preemption = mgr is not None
        preempt = _res.PreemptionHandler().install() \
            if handle_preemption else None

        self.stop_training = False
        cblist.on_train_begin()
        history = {'loss': []}
        epoch_logs: Dict[str, Any] = {}
        try:
            for epoch in range(start_epoch, epochs):
                if self.stop_training:
                    break
                cblist.on_epoch_begin(epoch)
                self.network.train()
                epoch_logs = {}
                for step, batch in enumerate(_spanned_batches(loader)):
                    cblist.on_train_batch_begin(step)
                    ins, lab = _split_batch(batch)
                    if wd is not None:
                        with wd.watch():
                            loss = self.train_batch(list(ins), lab)
                    else:
                        loss = self.train_batch(list(ins), lab)
                    skipped = self._ft_step is not None \
                        and self._ft_step.last_step_skipped
                    logs = {'loss': loss[0]}
                    cblist.on_train_batch_end(step, logs)
                    if not skipped:
                        epoch_logs.update(logs)
                        history['loss'].append(loss[0])
                        it_count += 1
                        if mgr is not None and mgr.should_save(it_count):
                            self._save_train_ckpt(mgr, it_count, loader)
                    if preempt is not None and preempt.requested:
                        # eviction grace window: one forced synchronous
                        # checkpoint (dataloader cursor included), then
                        # leave the loop cleanly
                        if mgr is not None:
                            self._save_train_ckpt(mgr, it_count, loader,
                                                  force=True)
                        if _obs.enabled():
                            _obs.get_registry().counter(
                                'paddle_resilience_preempt_saves_total',
                                'forced checkpoints on preemption '
                                'signals').inc()
                            _obs.emit('preempt_save', step=it_count,
                                      saved=mgr is not None)
                        self.stop_training = True
                    if num_iters is not None and it_count >= num_iters:
                        self.stop_training = True
                    if self.stop_training:
                        break
                if self.stop_training and preempt is not None \
                        and preempt.requested:
                    break   # skip eval: the grace window is for saving
                if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                    eval_logs = self._run_eval(eval_loader, cblist)
                    epoch_logs.update({f'eval_{k}': v
                                       for k, v in eval_logs.items()})
                cblist.on_epoch_end(epoch, epoch_logs)
            cblist.on_train_end(epoch_logs if epochs else {})
            if self._ft_step is not None:
                history['resilience'] = self._ft_step.stats()
        finally:
            if preempt is not None:
                preempt.uninstall()
            if wd is not None:
                wd.stop()
            self._ft_step = None
        return history

    def _run_eval(self, loader, cblist=None):
        self.network.eval()
        for m in self._metrics:
            m.reset()
        if cblist:
            cblist.on_eval_begin()
        losses = []
        for step, batch in enumerate(loader):
            if cblist:
                cblist.on_eval_batch_begin(step)
            ins, lab = _split_batch(batch)
            out = self._forward(ins)
            if self._loss is not None and lab is not None:
                with torch.no_grad():
                    losses.append(float(self._loss(
                        out, _to_device(lab, self._device))))
            for m in self._metrics:
                _feed_metric(m, out, lab)
            if cblist:
                cblist.on_eval_batch_end(step)
        logs: Dict[str, Any] = {}
        if losses:
            logs['loss'] = float(np.mean(losses))
        for m in self._metrics:
            name = m.name()
            acc = m.accumulate()
            if isinstance(name, list):
                for n, a in zip(name, acc):
                    logs[n] = a
            else:
                logs[name] = acc
        if cblist:
            cblist.on_eval_end(logs)
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None):
        loader = _as_loader(eval_data, batch_size, False, num_workers, False)
        cbs = _to_list(callbacks)
        cblist = CallbackList(cbs) if cbs else None
        if cblist:
            cblist.set_model(self)
        return self._run_eval(loader, cblist)

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        loader = _as_loader(test_data, batch_size, False, num_workers, False)
        outs = []
        for batch in loader:
            ins, _ = _split_batch(batch) if isinstance(batch, (list, tuple)) \
                else ((batch,), None)
            outs.append(_host_array(self.predict_batch(list(ins))))
        if stack_outputs:
            return [np.concatenate(outs, axis=0)]
        return [outs]

    # -- persistence ---------------------------------------------------------
    def save(self, path, training=True):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        serialization.save(self.network.state_dict(), path + '.pdparams')
        if training and self._optimizer is not None:
            # the live optimizer state, in the JAX step's layout when a
            # train step holds it
            opt = self._train_step.opt_state() \
                if self._train_step is not None else None
            if opt is not None and opt['slots']:
                serialization.save(
                    {'jit_opt_state': {
                        'step': np.asarray(opt['step'], np.int32),
                        'slots': opt['slots']}}, path + '.pdopt')
            else:
                serialization.save(self._optimizer.state_dict(),
                                   path + '.pdopt')

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        sd = serialization.load(path + '.pdparams', return_numpy=True)
        own = self.network.state_dict()
        missing = sorted(set(own) - set(sd))
        unexpected = sorted(set(sd) - set(own))
        if not skip_mismatch and (missing or unexpected):
            raise RuntimeError(
                f'state mismatch loading model: missing={missing}, '
                f'unexpected={unexpected} (pass skip_mismatch=True to '
                f'ignore)')
        shared = sorted(set(own) & set(sd))
        _copy_by_name({k: sd[k] for k in shared},
                      {k: own[k] for k in shared}, 'model state')
        self._train_step = None
        self.__dict__.pop('_restored_opt_state', None)
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + '.pdopt'):
            opt_sd = serialization.load(path + '.pdopt', return_numpy=True)
            if isinstance(opt_sd, dict) and 'jit_opt_state' in opt_sd:
                self._restored_opt_state = opt_sd['jit_opt_state']
            else:
                self._optimizer.set_state_dict(opt_sd)
        return self

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        """Print the network and its parameter counts; returns
        {'total_params', 'trainable_params'}. With `input_size` it is
        `utils.flops.summary` (one dry run on float32 zeros of that
        shape and a table of each leaf layer's output shape), as in the
        JAX package."""
        if input_size is not None:
            from ..utils.flops import summary as _summary
            return _summary(self.network, input_size=input_size)
        total = int(sum(p.numel() for p in self.network.parameters()))
        trainable = int(sum(p.numel() for p in self.network.parameters()
                            if p.requires_grad))
        lines = [repr(self.network),
                 f'Total params: {total:,}',
                 f'Trainable params: {trainable:,}']
        print('\n'.join(lines))
        return {'total_params': total, 'trainable_params': trainable}
