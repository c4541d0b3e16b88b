"""Quantization (counterpart of `paddle_tpu.quantization`): the int8
KV-page helpers of the paged pool, `paddle_tpu/quantization/__init__.py:
45-67`. One f32 scale per (page, kv head): the absmax over the page's
rows and head_dim, divided by 127; an all-zero page gets scale 1.0.
Quantizing rounds half to even (`torch.round`, as `jnp.round` does) and
clips to +-127; dequantizing multiplies in f32, then casts.

Post-training quantization, QAT and the observers are not ported yet.
"""
from __future__ import annotations

import torch

__all__ = ['kv_page_scales', 'kv_quantize_page', 'kv_dequantize_page']

_KV_QMAX = 127.0


def kv_page_scales(page: torch.Tensor, qmax: float = _KV_QMAX):
    """Per-(page, head) scales [..., H] of pages [..., ps, H, D]."""
    amax = page.float().abs().amax(dim=(-3, -1))
    return torch.where(amax > 0, amax / qmax, torch.ones_like(amax))


def kv_quantize_page(page: torch.Tensor, scales: torch.Tensor,
                     qmax: float = _KV_QMAX) -> torch.Tensor:
    """Pages [..., ps, H, D] as int8 at `scales` [..., H]."""
    q = torch.round(page.float() / scales[..., None, :, None])
    return q.clamp(-qmax, qmax).to(torch.int8)


def kv_dequantize_page(q: torch.Tensor, scales: torch.Tensor,
                       dtype) -> torch.Tensor:
    """int8 pages [..., ps, H, D] at `scales` [..., H], back in `dtype`."""
    return (q.float() * scales[..., None, :, None]).to(dtype)
