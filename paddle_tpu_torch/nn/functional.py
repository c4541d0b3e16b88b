"""Functional ops (counterpart of the matching subset of
`paddle_tpu/nn/functional.py`), in Paddle's layouts: `linear` takes W as
[in, out], attention takes [batch, seq, heads, head_dim].

Each entry runs through `tensor.apply_op` under the JAX function's op
name, so `amp.auto_cast` casts it by the JAX package's lists (`linear`
and `scaled_dot_product_attention` to the low dtype, `rms_norm`,
`cross_entropy`, `softmax` and `log_softmax` to fp32), and a Tensor in
gives a Tensor out while plain torch tensors (the serving and training
paths) pass through as they are.
"""
from __future__ import annotations

import torch

from ..dtype import convert_dtype
from ..ops import kernels
from ..tensor import apply_op


def _linear(x, weight, bias=None):
    if x.dtype != weight.dtype:       # jnp's promotion (an O2 model, f32 in)
        dt = torch.promote_types(x.dtype, weight.dtype)
        x, weight = x.to(dt), weight.to(dt)
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def linear(x, weight, bias=None, name=None):
    """y = x @ W + b with W [in, out] (Paddle's layout)."""
    if bias is None:
        return apply_op(_linear, x, weight, _name='linear')
    return apply_op(_linear, x, weight, bias, _name='linear')


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    def f(ids, w):
        out = w[ids.long()]
        if padding_idx is not None:
            pi = padding_idx if padding_idx >= 0 else w.shape[0] + padding_idx
            out = out.masked_fill((ids == pi)[..., None], 0)
        return out
    return apply_op(f, x, weight, _name='embedding')


def silu(x, name=None):
    return apply_op(torch.nn.functional.silu, x, _name='silu')


swish = silu


def relu(x, name=None):
    return apply_op(torch.relu, x, _name='relu')


def gelu(x, approximate=False, name=None):
    return apply_op(lambda v: torch.nn.functional.gelu(
        v, approximate='tanh' if approximate else 'none'), x, _name='gelu')


def sigmoid(x, name=None):
    return apply_op(torch.sigmoid, x, _name='sigmoid')


def tanh(x, name=None):
    return apply_op(torch.tanh, x, _name='tanh')


def softmax(x, axis=-1, dtype=None, name=None):
    def f(v):
        if dtype is not None:
            v = v.to(convert_dtype(dtype))
        return torch.softmax(v, dim=axis)
    return apply_op(f, x, _name='softmax')


def log_softmax(x, axis=-1, dtype=None, name=None):
    def f(v):
        if dtype is not None:
            v = v.to(convert_dtype(dtype))
        return torch.log_softmax(v, dim=axis)
    return apply_op(f, x, _name='log_softmax')


def rms_norm(x, weight, epsilon: float = 1e-6, name=None):
    """RMSNorm over the last dim through the RMSNorm kernel
    (differentiable; its backward is plain torch)."""
    return apply_op(lambda v, w: kernels.rms_norm(v, w, epsilon), x, weight,
                    _name='rms_norm')


def _attention(query, key, value, attn_mask=None, is_causal=False):
    if attn_mask is None:
        return kernels.flash_attention(query, key, value, causal=is_causal)
    return kernels.attention_reference(query, key, value, mask=attn_mask,
                                       causal=is_causal)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 is_causal: bool = False, name=None):
    """Attention in [B, S, H, D] with the semantics of the JAX package's
    `_attention_xla` (GQA as [HKV, G], fp32 softmax, probabilities cast to
    q.dtype before PV, bottom-right causal alignment). Without a mask it
    goes through the flash kernels (`kernels.flash_attention`: the forward
    kernel alone, or the differentiable `FlashAttention` when a gradient
    is needed; f32, bf16, and fp16 under auto_cast(dtype='float16')); a
    masked call takes the plain version, as the JAX package sends masked
    attention to XLA on every backend."""
    return apply_op(_attention, query, key, value, attn_mask, is_causal,
                    _name='scaled_dot_product_attention')


def _reduce(per: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == 'mean':
        return per.mean()
    if reduction == 'sum':
        return per.sum()
    return per


def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = 'mean', soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0, name=None):
    """Paddle's `F.cross_entropy` (the JAX package's semantics).

    Hard integer labels over [N, V] logits (the LM loss) go through the
    fused CE kernels (`kernels.softmax_cross_entropy`), whatever the
    vocab: rows whose label is `ignore_index` contribute 0 and get a 0
    gradient, 'mean' divides by max(#valid, 1), and trailing [N, 1]
    labels are accepted. The kernels take contiguous logits, so a strided
    view (such as `logits[:, :-1]` flattened) is copied here first. Soft
    labels, class weights, label smoothing and other ranks are plain
    torch, as the JAX package keeps them outside its kernel."""
    return apply_op(_cross_entropy, input, label, weight, ignore_index,
                    reduction, soft_label, axis, use_softmax,
                    label_smoothing, _name='cross_entropy')


def _cross_entropy(logits, lab, weight, ignore_index, reduction, soft_label,
                   axis, use_softmax, label_smoothing):
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
