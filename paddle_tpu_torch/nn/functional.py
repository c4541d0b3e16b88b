"""Functional ops of the serving and training slices (counterpart of the
matching subset of `paddle_tpu/nn/functional.py`), in Paddle's layouts:
`linear` takes W as [in, out], attention takes [batch, seq, heads,
head_dim]."""
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
    """RMSNorm over the last dim through the RMSNorm kernel
    (differentiable; its backward is plain torch)."""
    return kernels.rms_norm(x, weight, epsilon)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 is_causal: bool = False):
    """Attention in [B, S, H, D] with the semantics of the JAX package's
    `_attention_xla` (GQA as [HKV, G], fp32 softmax, probabilities cast to
    q.dtype before PV, bottom-right causal alignment). Without a mask it
    goes through the flash kernels (`kernels.flash_attention`: the forward
    kernel alone, or the differentiable `FlashAttention` when a gradient
    is needed); a masked call takes the plain version, as the JAX package
    sends masked attention to XLA on every backend."""
    if attn_mask is None:
        return kernels.flash_attention(query, key, value, causal=is_causal)
    return kernels.attention_reference(query, key, value, mask=attn_mask,
                                       causal=is_causal)


def _reduce(per: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == 'mean':
        return per.mean()
    if reduction == 'sum':
        return per.sum()
    return per


def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = 'mean', soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Paddle's `F.cross_entropy` (the JAX package's semantics).

    Hard integer labels over [N, V] logits (the LM loss) go through the
    fused CE kernels (`kernels.softmax_cross_entropy`), whatever the
    vocab: rows whose label is `ignore_index` contribute 0 and get a 0
    gradient, 'mean' divides by max(#valid, 1), and trailing [N, 1]
    labels are accepted. The kernels take contiguous logits, so a strided
    view (such as `logits[:, :-1]` flattened) is copied here first. Soft
    labels, class weights, label smoothing and other ranks are plain
    torch, as the JAX package keeps them outside its kernel."""
    logits, lab = input, label
    fused = (use_softmax and not soft_label and weight is None
             and not label_smoothing and logits.dim() == 2
             and axis in (-1, 1) and not lab.is_floating_point())
    if fused:
        if lab.dim() == 2:                      # trailing [N, 1] labels
            lab = lab.squeeze(-1)
        valid = lab != ignore_index
        safe = torch.where(valid, lab, 0).to(torch.int32).contiguous()
        per = kernels.softmax_cross_entropy(logits.contiguous(), safe)
        per = torch.where(valid, per, 0.0)
        if reduction == 'mean':
            return per.sum() / valid.sum().clamp(min=1).to(per.dtype)
        return _reduce(per, reduction)
    axis = axis % logits.dim()
    logp = (torch.log_softmax(logits, dim=axis) if use_softmax
            else torch.log(logits.clamp(min=1e-30)))
    if soft_label:
        soft = lab
        if label_smoothing:
            nclass = logits.shape[axis]
            soft = soft * (1 - label_smoothing) + label_smoothing / nclass
        return _reduce(-(soft * logp).sum(dim=axis), reduction)
    lab = lab.long()
    if lab.dim() == logp.dim():                 # trailing [..., 1] labels
        lab = lab.squeeze(axis)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    per = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing:
        per = (1 - label_smoothing) * per \
            + label_smoothing * -logp.mean(dim=axis)
    if weight is not None:
        cw = weight[safe]
        per = torch.where(valid, per * cw, 0.0)
        if reduction == 'mean':
            return per.sum() / torch.where(valid, cw, 0.0).sum().clamp(
                min=1e-12)
        return _reduce(per, reduction)
    per = torch.where(valid, per, 0.0)
    if reduction == 'mean':
        return per.sum() / valid.sum().clamp(min=1).to(per.dtype)
    return _reduce(per, reduction)
