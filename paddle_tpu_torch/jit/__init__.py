"""`TrainStep` (counterpart of `paddle_tpu/jit/__init__.py:TrainStep`).

The JAX package traces the forward, the loss, the gradient and the
optimizer update into one jitted, donated program. PyTorch runs eagerly,
so the port's step is the same sequence run as it stands: no `jit`
counterpart and no `torch.compile`. The kernels under the model are
what runs on the card.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


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

    def __call__(self, inputs, labels) -> torch.Tensor:
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
        return loss.detach()


__all__ = ['TrainStep']
