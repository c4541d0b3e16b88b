"""Gradient clipping (counterpart of `paddle_tpu/nn/clip.py`).

A clip object takes a list of (param, grad) pairs and returns the pairs
with clipped grads; an optimizer given one as `grad_clip` applies it
before its update and leaves `.grad` as it was. As in the JAX package, a
clipped grad is computed in fp32 and rounded back to the grad's own
dtype. `ClipGradByGlobalNorm.scale` gives the global scale as a 0-d fp32
tensor on the grads' device, from `multi_tensor_sumsq` (the kernel on the
card), and the host never reads it: `Adam`/`AdamW` hand it to the fused
update kernel, which clips each grad as it reads it.
"""
from __future__ import annotations

import torch

from ..ops import kernels as K


def _clip_scale(clip_norm: float, norm: torch.Tensor) -> torch.Tensor:
    """min(clip_norm / max(norm, 1e-12), 1) in norm's dtype and device."""
    return torch.clamp_max(norm.new_full((), clip_norm)
                           / norm.clamp_min(1e-12), 1.0)


def _scaled(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.float() * scale).to(g.dtype)


class ClipGradBase:

    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Clamp every grad element into [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, g.clamp(self.min, self.max)) if g is not None
                else (p, g) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Scale each grad alone to an L2 norm of at most clip_norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip_one(self, g: torch.Tensor) -> torch.Tensor:
        norm = g.float().square().sum().sqrt()
        return _scaled(g, _clip_scale(self.clip_norm, norm))

    def __call__(self, params_grads):
        return [(p, self._clip_one(g)) if g is not None else (p, g)
                for p, g in params_grads]


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every grad by min(clip_norm / global L2 norm, 1) (the
    pretraining default)."""

    def __init__(self, clip_norm, group_name='default_group',
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def scale(self, grads) -> torch.Tensor:
        """The scale over these grads, a 0-d fp32 tensor on their device."""
        return _clip_scale(self.clip_norm, K.multi_tensor_sumsq(grads).sqrt())

    def __call__(self, params_grads):
        gs = [g for _, g in params_grads if g is not None]
        if not gs:
            return params_grads
        s = self.scale(gs)
        return [(p, _scaled(g, s)) if g is not None else (p, g)
                for p, g in params_grads]


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False) -> torch.Tensor:
    """Scale the `.grad` of `parameters` in place to a total norm of at
    most max_norm (torch-style); returns the total norm before clipping."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    parameters = list(parameters)
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float('inf'):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = sum(g.float().abs().pow(norm_type).sum()
                    for g in grads).pow(1.0 / norm_type)
    scale = _clip_scale(max_norm, total)
    for p in parameters:
        if p.grad is not None:
            p.grad = _scaled(p.grad, scale)
    return total


__all__ = ['ClipGradBase', 'ClipGradByGlobalNorm', 'ClipGradByNorm',
           'ClipGradByValue', 'clip_grad_norm_']
