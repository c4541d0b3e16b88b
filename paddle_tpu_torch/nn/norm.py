"""`RMSNorm` (counterpart of `paddle_tpu/nn/norm.py:RMSNorm`), through the
port's RMSNorm kernel."""
from __future__ import annotations

import torch

from . import functional as F
from .layer import Layer


class RMSNorm(Layer):

    def __init__(self, hidden_size: int, epsilon: float = 1e-6, *,
                 device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.hidden_size = hidden_size
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            (hidden_size,), device=device, dtype=dtype, fill=1.0)

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self._epsilon)
