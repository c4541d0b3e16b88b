"""paddle.incubate.optimizer (counterpart of
`paddle_tpu/incubate/optimizer.py`): `LookAhead` and `ModelAverage`
over the port's optimizers. Both keep their auxiliary weights as torch
tensors and write the live parameters in place (`copy_` under
`no_grad`), so a module keeps its parameter objects."""
from __future__ import annotations

import torch

from ..tensor import to_torch


def _set(p, value) -> None:
    with torch.no_grad():
        to_torch(p).copy_(value)


class LookAhead:
    """Wraps an inner optimizer: every k steps the slow weights move
    alpha of the way toward the fast weights, and the fast weights are
    reset onto them (upstream incubate.optimizer.LookAhead; Zhang et
    al. 2019)."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError('alpha must be in [0, 1]')
        if k < 1:
            raise ValueError('k must be >= 1')
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = int(k)
        self._step_count = 0
        self._slow = None

    def _params(self):
        return self.inner_optimizer._params()

    def step(self):
        self.inner_optimizer.step()
        self._step_count += 1
        params = self._params()
        if self._slow is None:
            self._slow = [to_torch(p).detach().clone() for p in params]
        if self._step_count % self.k == 0:
            for i, p in enumerate(params):
                fast = to_torch(p).detach()
                slow = self._slow[i] + self.alpha * (fast - self._slow[i])
                self._slow[i] = slow
                _set(p, slow.to(fast.dtype))

    def clear_grad(self):
        self.inner_optimizer.clear_grad()

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def set_lr(self, v):
        return self.inner_optimizer.set_lr(v)

    def state_dict(self):
        return {'inner': self.inner_optimizer.state_dict(),
                'step_count': self._step_count,
                'slow': self._slow}

    def set_state_dict(self, sd):
        self.inner_optimizer.set_state_dict(sd['inner'])
        self._step_count = sd['step_count']
        self._slow = sd['slow']


class ModelAverage:
    """Running average of parameters for evaluation (upstream
    incubate.optimizer.ModelAverage): accumulate each step; apply()
    swaps the averaged weights in (restore() swaps back)."""

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        if parameters is None:
            raise ValueError('ModelAverage needs the parameter list')
        self._parameters = list(parameters)
        self.max_average_window = int(max_average_window)
        self._sums = self._zeros()
        self._count = 0
        self._backup = None

    def _zeros(self):
        return [torch.zeros_like(to_torch(p).detach())
                for p in self._parameters]

    def step(self):
        """Accumulate the current weights into the window."""
        if self._count >= self.max_average_window:
            # restart the window like upstream when it saturates
            self._sums = self._zeros()
            self._count = 0
        self._sums = [s + to_torch(p).detach()
                      for s, p in zip(self._sums, self._parameters)]
        self._count += 1

    def apply(self, executor=None, need_restore=True):
        """Swap the averaged weights into the live parameters. A second
        apply() without restore() keeps the original training weights as
        the restore point; need_restore=False discards it (the final
        swap, upstream's semantics)."""
        if self._count == 0:
            return
        if self._backup is None:
            self._backup = [to_torch(p).detach().clone()
                            for p in self._parameters]
        for p, s in zip(self._parameters, self._sums):
            _set(p, (s / self._count).to(to_torch(p).dtype))
        if not need_restore:
            self._backup = None

    def restore(self, executor=None):
        """Undo apply(): put the training weights back."""
        if self._backup is None:
            return
        for p, b in zip(self._parameters, self._backup):
            _set(p, b)
        self._backup = None
