"""`TrainStep` (counterpart of `paddle_tpu/jit/__init__.py:TrainStep`).

The JAX package traces the forward, the loss, the gradient and the
optimizer update into one jitted, donated program. PyTorch runs eagerly,
so the port's step is the same sequence run as it stands: no `jit`
counterpart and no `torch.compile`. The kernels under the model are
what runs on the card.

An optimizer built with `offload='host'` keeps its slots in pinned host
memory and streams the update through HBM (`optimizer/offload.py`), as
the JAX step's offload path runs its `OffloadEngine` after the jitted
gradient step. `opt_state()` and `load_opt_state()` read and write the
optimizer's state in the JAX step's `_opt_state` layout, which the fault-
tolerant step's snapshots and `hapi.Model`'s checkpoints hold.

Observability, as the JAX step reports: each call runs under the
`train.step` span (the goodput ledger's `step_compute`), the first call
notes `paddle_jit_cache_entries{kind="train_step"}` (the JAX step's one
trace), and every call is booked in the program catalog as `train_step`
of kind `train` with its host seconds and an analytic count of its
work (`observability.cost`).
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from .. import observability as _obs
from ..observability import cost as _cost
from ..weights import _copy_by_name


def _to_device(value, device: torch.device):
    if value is None:
        return None
    if isinstance(value, tuple):
        return tuple(_to_device(v, device) for v in value)
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.as_tensor(np.asarray(value), device=device)


class TrainStep:
    """One training step of `layer`: `step(inputs, labels)` runs the
    forward (`layer(*inputs)` for a tuple, else `layer(inputs)`),
    `loss_fn(output, labels)`, the backward and `optimizer`'s update of
    every trainable parameter of `layer` (named by `named_parameters()`,
    as the JAX step names its parameter tree), then drops the grads.
    Numpy or tensor inputs go to the layer's device. Returns the loss as
    a detached device tensor, without waiting for the device."""

    def __init__(self, layer: torch.nn.Module, loss_fn: Callable,
                 optimizer):
        self.layer = layer
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._params = [(n, p) for n, p in layer.named_parameters()
                        if p.requires_grad]
        if not self._params:
            raise ValueError('TrainStep: the layer has no trainable '
                             'parameters')
        self.device = self._params[0][1].device
        self._n_calls = 0

    def __call__(self, inputs, labels) -> torch.Tensor:
        t0 = time.perf_counter()
        with _obs.span('train.step'):
            inputs = _to_device(inputs, self.device)
            labels = _to_device(labels, self.device)
            with torch.enable_grad():
                out = self.layer(*inputs) if isinstance(inputs, tuple) \
                    else self.layer(inputs)
                loss = self.loss_fn(out, labels)
                del out
                loss.backward()
            self.optimizer.update(self._params)
            for _, p in self._params:
                p.grad = None
        if self._n_calls == 0:
            _obs.note_jit_cache_entry('train_step')
        self._n_calls += 1
        if _obs.enabled():
            cat = _cost.get_catalog()
            cat.note_invocation('train_step', time.perf_counter() - t0,
                                kind='train')
            cat.note_cost('train_step', *self._cost(inputs), kind='train')
        return loss.detach()

    def opt_state(self) -> dict:
        """The optimizer's state in the JAX step's `_opt_state` layout:
        {'step': updates so far, 'slots': {parameter name: {slot name:
        tensor}}}, parameters without slots yet left out. The tensors are
        the optimizer's own (on the card, or the host buffers of an
        offloaded optimizer, its copies settled): a caller that keeps
        them copies them."""
        opt = self.optimizer
        opt._settle()
        return {'step': opt._step_count,
                'slots': {n: opt._slots[p] for n, p in self._params
                          if p in opt._slots}}

    def load_opt_state(self, state) -> None:
        """Copy `state` (`opt_state()`'s layout, with tensors or numpy
        arrays: a JAX step's `_opt_state` on the host loads too) into the
        optimizer's slots in place, made first where missing, so no slot
        moves. None, or no slots: the state before the first update."""
        opt = self.optimizer
        if state is None or not state.get('slots'):
            opt.reset_state()
            return
        opt._settle()
        opt._prepare_slots([p for _, p in self._params])
        for n, p in self._params:
            if n in state['slots']:
                _copy_by_name(state['slots'][n], opt._slots_for(p),
                              f'optimizer slots of {n} do not match')
        opt._step_count = int(np.asarray(state['step']))

    def _cost(self, inputs) -> tuple:
        """Analytic (FLOPs, bytes) of one step. A layer with a
        transformer config (`observability.cost.TransformerCost`) over
        [B, S] token ids: 3 forward passes' FLOPs (the forward, and the
        backward's two) with causal attention over S, and its weights
        read by the forward and the backward; any other layer: 6 FLOPs
        per trainable parameter per input row. Both add the update's
        traffic: parameters read and written, gradients read, and two
        fp32 moments read and written. Activations are not counted: the
        bytes are a lower bound."""
        x = inputs[0] if isinstance(inputs, tuple) else inputs
        n = sum(p.numel() for _, p in self._params)
        pbytes = sum(p.numel() * p.element_size() for _, p in self._params)
        update = 3 * pbytes + 16 * n
        cfg = getattr(self.layer, 'config', None)
        if getattr(cfg, 'intermediate_size', None) is not None \
                and x.dim() == 2 and not x.is_floating_point():
            b, s = x.shape
            fwd = _cost.TransformerCost(cfg, self._params[0][1]
                                        .element_size())
            flops, nbytes = fwd.forward(b * s, b * s * (s + 1) // 2,
                                        0, b * s)
            return 3 * flops, 2 * nbytes + pbytes + update
        rows = x.numel() if not x.is_floating_point() else \
            x.numel() // max(x.shape[-1], 1)
        return 6.0 * n * rows, 2 * pbytes + pbytes + update


__all__ = ['TrainStep']
