"""`Layer`: the port's module base (counterpart of `paddle_tpu/nn/layer.py`).

A `torch.nn.Module` whose parameters are created directly on their
device and dtype, with Paddle's layouts, so that `state_dict()` has the
JAX package's key names and shapes (`llama.layers.0.self_attn.q_proj.weight`
is `[in, out]` in both) and weights copy across by name. Parameters are
the port's `Parameter` (a `torch.nn.Parameter`), trainable as Paddle's
are (`stop_gradient=False`); the serving engine runs under
`torch.inference_mode`.

Calling a Layer with eager `Tensor`s unwraps them, runs the module on
torch tensors and wraps its outputs as Tensors (plain torch in, plain
torch out); `to()` takes Paddle's dtype names and 'gpu' devices, as
`amp.decorate` calls it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..dtype import _NAME_TO_DTYPE, convert_dtype
from ..tensor import Parameter, _unwrap, _wrap


def _torch_arg(a):
    """A Paddle dtype name or 'gpu[:N]' device as torch takes it."""
    if isinstance(a, str):
        if a in _NAME_TO_DTYPE:
            return convert_dtype(a)
        name, _, idx = a.partition(':')
        if name == 'gpu':
            return torch.device('cuda', int(idx or 0))
    return a


class Layer(nn.Module):

    def __call__(self, *args, **kwargs):
        found = [False]
        args = _unwrap(args, found)
        if kwargs:
            kwargs = _unwrap(kwargs, found)
        out = super().__call__(*args, **kwargs)
        return _wrap(out) if found[0] else out

    def to(self, *args, **kwargs):
        return super().to(*[_torch_arg(a) for a in args],
                          **{k: _torch_arg(v) for k, v in kwargs.items()})

    @staticmethod
    def create_parameter(shape: Sequence[int], *, device: torch.device,
                         dtype: torch.dtype, std: Optional[float] = None,
                         fill: Optional[float] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> Parameter:
        """A parameter of `shape`, made on `device`: normal(0, std) draws
        from `generator`, or the constant `fill`."""
        t = torch.empty(tuple(shape), device=device, dtype=dtype)
        with torch.no_grad():
            if fill is not None:
                t.fill_(fill)
            else:
                t.normal_(0.0, std, generator=generator)
        return Parameter(t)
