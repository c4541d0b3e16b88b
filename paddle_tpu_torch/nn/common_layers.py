"""`Linear` and `Embedding` (counterpart of `paddle_tpu/nn/common_layers.py`).

`Linear.weight` keeps Paddle's [in_features, out_features] layout and
computes y = x @ W + b, so keys and shapes copy 1:1 from the JAX
package; it is not a transposed `torch.nn.Linear`.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import functional as F
from .layer import Layer

INIT_STD = 0.02   # normal init of random weights (the usual Llama range)


class Linear(Layer):

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = False, device: torch.device,
                 dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = self.create_parameter(
            (in_features, out_features), device=device, dtype=dtype,
            std=INIT_STD, generator=generator)
        self.bias = self.create_parameter(
            (out_features,), device=device, dtype=dtype, fill=0.0) \
            if bias else None

    def forward(self, x):
        y = F.linear(x, self.weight, self.bias)
        # serving.adapters tags target projections with a per-instance
        # hook, inert unless an adapter scope is active
        hook = self.__dict__.get('_adapter_hook')
        if hook is not None:
            y = hook(self, x, y)
        return y

    def extra_repr(self):
        return f'in={self.in_features}, out={self.out_features}'


class Embedding(Layer):

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 device: torch.device, dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), device=device, dtype=dtype,
            std=INIT_STD, generator=generator)

    def forward(self, ids):
        return F.embedding(ids, self.weight)

    def extra_repr(self):
        return f'{self.num_embeddings}, {self.embedding_dim}'
