"""Functional ops of the serving slice (counterpart of the matching subset
of `paddle_tpu/nn/functional.py`), in Paddle's layouts: `linear` takes
W as [in, out], attention takes [batch, seq, heads, head_dim]."""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import kernels


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ W + b with W [in, out] (Paddle's layout)."""
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return weight[ids.long()]


def silu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             epsilon: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim through the RMSNorm kernel."""
    return kernels.rms_norm(x, weight, epsilon)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 is_causal: bool = False):
    """Attention in [B, S, H, D] with the semantics of the JAX package's
    `_attention_xla` (GQA as [HKV, G], fp32 softmax, probabilities cast to
    q.dtype before PV, bottom-right causal alignment). Without a mask it
    goes through the flash kernel; a masked call takes the plain version,
    as the JAX package sends masked attention to XLA on every backend."""
    if attn_mask is None:
        return kernels.flash_attention_fwd(query, key, value,
                                           causal=is_causal)
    return kernels.attention_reference(query, key, value, mask=attn_mask,
                                       causal=is_causal)
