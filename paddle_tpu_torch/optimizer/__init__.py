"""Optimizers (counterpart of `paddle_tpu/optimizer/__init__.py`:
`Optimizer`, `Adam`, `AdamW`).

The update rule is Paddle's, as the JAX package computes it per leaf:
gradients and the update in fp32; Adam's bias correction folded into
the step size, lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t), and
epsilon added to sqrt(v) outside the correction,
p <- p - lr_t * m / (sqrt(v) + epsilon). `torch.optim.AdamW` places
epsilon inside the correction and is not used. AdamW's weight decay is
decoupled, p <- p - lr * coeff * p (with p before the Adam step), on
every parameter unless `apply_decay_param_fun(name)` says no; Adam's
`weight_decay` is L2 (added to the gradient).

`multi_precision` keeps an fp32 master copy of each bf16 parameter;
`moment_dtype` stores m and v in that dtype (updated in fp32), which is
how the 1.9 B-parameter training rung keeps its optimizer state at
7.5 GB. Updates run in place under `no_grad`: parameters, masters and
moments are overwritten in their own storage, so the state is never
held twice (the JAX package gets the same from buffer donation); only
one parameter's fp32 temporaries exist at a time.

Parameters are passed as tensors, or as (name, tensor) pairs such as
`model.named_parameters()`, which give `apply_decay_param_fun` its
names. `jit.TrainStep` updates every trainable parameter of its layer
under its `named_parameters()` name, as the JAX `TrainStep` does.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .. import dtype as _dtype

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _not_ported(what: str):
    return NotImplementedError(f'{what} is not ported yet (ROADMAP.md, '
                               f'Queue 1)')


class Optimizer:
    """Base optimizer; subclasses implement `_init_slots` and `_rule`."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        if grad_clip is not None:
            raise _not_ported('grad_clip')
        if not isinstance(learning_rate, (int, float)):
            raise _not_ported('an LRScheduler learning rate')
        self._learning_rate = float(learning_rate)
        self._named = self._named_list(parameters)
        self._coeff = 0.0 if weight_decay is None else float(weight_decay)
        self._multi_precision = bool(multi_precision)
        self._step_count = 0
        self._slots: Dict[torch.Tensor, dict] = {}

    @staticmethod
    def _named_list(parameters) -> Optional[List[Tuple[Optional[str],
                                                        torch.Tensor]]]:
        if parameters is None:
            return None
        return [item if isinstance(item, tuple) else (None, item)
                for item in parameters]

    # -- the per-parameter rule ----------------------------------------
    def _init_slots(self, p: torch.Tensor) -> dict:
        return {}

    def _rule(self, g32, p32, slots, lr, step):
        """(fp32 grad, fp32 param, slots, lr, step) -> new fp32 param;
        updates the slots in place."""
        raise NotImplementedError

    def _decoupled_decay(self) -> bool:
        return False

    def _coeff_for(self, name: Optional[str]) -> float:
        return self._coeff

    def _slots_for(self, p: torch.Tensor) -> dict:
        slots = self._slots.get(p)
        if slots is None:
            slots = self._init_slots(p)
            if self._multi_precision and p.dtype in _LOW_PRECISION:
                slots['master'] = p.detach().float()
            self._slots[p] = slots
        return slots

    @torch.no_grad()
    def update(self, named: Iterable[Tuple[Optional[str], torch.Tensor]]):
        """One update step of every (name, parameter) pair whose grad is
        set (`step()` passes the parameters given at construction,
        `TrainStep` its layer's named trainable parameters)."""
        lr = np.float32(self.get_lr())
        self._step_count += 1
        for name, p in named:
            if p.grad is None:
                continue
            slots = self._slots_for(p)
            master = slots.get('master')
            p32 = master if master is not None else p.float()
            g32 = p.grad.float()
            coeff = self._coeff_for(name)
            if coeff and not self._decoupled_decay():
                g32 = g32 + p32 * coeff
            new = self._rule(g32, p32, slots, lr, self._step_count)
            if coeff and self._decoupled_decay():
                new = new - p32 * float(lr * np.float32(coeff))
            if master is not None:
                master.copy_(new)
            p.copy_(new)

    # -- the eager API ---------------------------------------------------
    def step(self) -> None:
        """Update every parameter given at construction that has a grad."""
        if self._named is None:
            raise ValueError('optimizer constructed without parameters')
        self.update(self._named)

    def clear_grad(self) -> None:
        """Drop the gradients (set to None, which frees their memory)."""
        for _, p in self._named or ():
            p.grad = None

    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value: float) -> None:
        self._learning_rate = float(value)


class Adam(Optimizer):

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, moment_dtype=None,
                 offload=None):
        """moment_dtype: storage dtype of m and v (default fp32); the
        moment update computes in fp32 either way."""
        if offload is not None:
            raise _not_ported(f'offload={offload!r}')
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        self._moment_dtype = (_dtype.to_torch_dtype(moment_dtype)
                              if moment_dtype else torch.float32)

    def _init_slots(self, p):
        return {'moment1': torch.zeros(p.shape, dtype=self._moment_dtype,
                                       device=p.device),
                'moment2': torch.zeros(p.shape, dtype=self._moment_dtype,
                                       device=p.device)}

    def _rule(self, g32, p32, slots, lr, step):
        b1, b2 = self._beta1, self._beta2
        m = slots['moment1'].float() * b1 + g32 * (1 - b1)
        v = slots['moment2'].float() * b2 + g32.square() * (1 - b2)
        slots['moment1'].copy_(m)
        slots['moment2'].copy_(v)
        # the step size in fp32, as the JAX package computes it
        t = np.float32(step)
        one = np.float32(1)
        lr_t = lr * np.sqrt(one - np.power(np.float32(b2), t)) \
            / (one - np.power(np.float32(b1), t))
        return p32 - (m * float(lr_t)) / (v.sqrt() + self._epsilon)


class AdamW(Adam):
    """Adam with decoupled weight decay (0.01 on every parameter by
    default; `apply_decay_param_fun(name)` False exempts one)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False, moment_dtype=None, offload=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision,
                         moment_dtype, offload)
        self._apply_decay_fn = apply_decay_param_fun

    def _decoupled_decay(self):
        return True

    def _coeff_for(self, name):
        if self._apply_decay_fn is not None and name is not None \
                and not self._apply_decay_fn(name):
            return 0.0
        return self._coeff


__all__ = ['Adam', 'AdamW', 'Optimizer']
