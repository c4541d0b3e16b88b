"""`Layer`: the port's module base (counterpart of `paddle_tpu/nn/layer.py`).

A `torch.nn.Module` whose parameters are created directly on their
device and dtype, with Paddle's layouts, so that `state_dict()` has the
JAX package's key names and shapes (`llama.layers.0.self_attn.q_proj.weight`
is `[in, out]` in both) and weights copy across by name. Parameters are
trainable, as Paddle's are (`stop_gradient=False`); the serving engine
runs under `torch.inference_mode`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


class Layer(nn.Module):

    @staticmethod
    def create_parameter(shape: Sequence[int], *, device: torch.device,
                         dtype: torch.dtype, std: Optional[float] = None,
                         fill: Optional[float] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> nn.Parameter:
        """A parameter of `shape`, made on `device`: normal(0, std) draws
        from `generator`, or the constant `fill`."""
        t = torch.empty(tuple(shape), device=device, dtype=dtype)
        with torch.no_grad():
            if fill is not None:
                t.fill_(fill)
            else:
                t.normal_(0.0, std, generator=generator)
        return nn.Parameter(t)
