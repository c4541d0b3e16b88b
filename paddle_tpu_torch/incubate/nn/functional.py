"""paddle.incubate.nn.functional (counterpart of
`paddle_tpu/incubate/nn/functional.py`): the fused-op entries, each the
JAX package's chain of ops in the same order, over the port's kernels
where that chain reaches a Pallas kernel:

- `fused_rms_norm` is `F.rms_norm`, the RMSNorm kernel (its weight
  inside the kernel; without one, a weight of ones), then the bias;
- `fused_multi_head_attention` and `memory_efficient_attention` attend
  through `F.scaled_dot_product_attention`: the flash forward kernel,
  and the differentiable `FlashAttention` (dq and dk/dv kernels) under a
  gradient; a mask or dropout takes the plain version, as in JAX;
- the rest (`fused_linear`, `fused_matmul_bias`, `fused_dropout_add`,
  `fused_layer_norm`, `swiglu`, `fused_feedforward`,
  `fused_rotary_position_embedding`) are torch chains, as the JAX
  package's are XLA chains.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...nn import functional as F
from ...ops import kernels
from ...ops._helpers import defop

__all__ = ['fused_linear', 'fused_matmul_bias', 'fused_dropout_add',
           'fused_rms_norm', 'fused_layer_norm', 'swiglu',
           'fused_multi_head_attention', 'fused_feedforward',
           'memory_efficient_attention',
           'fused_rotary_position_embedding']


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    def f(xv, wv, *b):
        wv = wv.t() if transpose_weight else wv
        out = xv @ wv
        return out + b[0] if b else out
    args = (x, weight) if bias is None else (x, weight, bias)
    return defop(f, name='fused_linear')(*args)


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    def f(xv, yv, *b):
        xv = xv.transpose(-1, -2) if transpose_x else xv
        yv = yv.transpose(-1, -2) if transpose_y else yv
        out = xv @ yv
        return out + b[0] if b else out
    args = (x, y) if bias is None else (x, y, bias)
    return defop(f, name='fused_matmul_bias')(*args)


def fused_dropout_add(x, y, p=0.5, training=True, mode='upscale_in_train',
                      name=None):
    return F.dropout(x, p=p, training=training, mode=mode) + y


def _last_axis(x, begin_norm_axis, what: str) -> None:
    if begin_norm_axis not in (-1, None) and \
            begin_norm_axis != len(x.shape) - 1:
        raise NotImplementedError(f'{what} normalizes the last axis')


def fused_rms_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, name=None):
    """RMSNorm over the last axis through the RMSNorm kernel (#4), then
    `norm_bias`."""
    _last_axis(x, begin_norm_axis, 'fused_rms_norm')

    def f(v, *wb):
        w = wb[0] if norm_weight is not None else torch.ones(
            v.shape[-1], dtype=v.dtype, device=v.device)
        out = kernels.rms_norm(v, w, epsilon)
        return out + wb[-1] if norm_bias is not None else out
    args = [x] + [t for t in (norm_weight, norm_bias) if t is not None]
    return defop(f, name='rms_norm')(*args)


def fused_layer_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-5,
                     begin_norm_axis=-1, name=None):
    _last_axis(x, begin_norm_axis, 'fused_layer_norm')
    return F.layer_norm(x, x.shape[-1], weight=norm_weight, bias=norm_bias,
                        epsilon=epsilon)


def swiglu(x, y=None, name=None):
    """silu(x) * y; with y=None, x is split in half on the last axis
    (upstream: python/paddle/incubate/nn/functional/swiglu.py)."""
    if y is None:
        def f(v):
            a, b = v.chunk(2, dim=-1)
            return TF.silu(a) * b
        return defop(f, name='swiglu')(x)
    return defop(lambda a, b: TF.silu(a) * b, name='swiglu')(x, y)


def fused_multi_head_attention(
        x, qkv_weight, linear_weight, pre_layer_norm=False,
        pre_ln_scale=None, pre_ln_bias=None, ln_scale=None, ln_bias=None,
        pre_ln_epsilon=1e-5, qkv_bias=None, linear_bias=None, cache_kv=None,
        attn_mask=None, dropout_rate=0.0, attn_dropout_rate=0.0,
        ln_epsilon=1e-5, training=True, mode='upscale_in_train', ring_id=-1,
        add_residual=True, name=None):
    """Pre/post-LN multi-head self-attention block (upstream:
    paddle.incubate.nn.functional.fused_multi_head_attention).

    x: [B, S, E]; qkv_weight: [3, num_heads, head_dim, E];
    qkv_bias: [3, num_heads, head_dim]; linear_weight: [E, E]. The
    attention core is F.scaled_dot_product_attention (the flash kernels
    without a mask or dropout)."""
    if cache_kv is not None or ring_id != -1:
        raise NotImplementedError('cache_kv/ring_id are not supported')
    residual = x
    h = x
    if pre_layer_norm:
        h = F.layer_norm(h, h.shape[-1], weight=pre_ln_scale,
                         bias=pre_ln_bias, epsilon=pre_ln_epsilon)

    def qkv_f(hv, wv, *b):
        # [B, S, E] x [3, N, H, E] -> [3, B, S, N, H]
        out = torch.einsum('bse,tnhe->tbsnh', hv, wv)
        return out + b[0][:, None, None] if b else out
    qkv_args = (h, qkv_weight) if qkv_bias is None else (h, qkv_weight,
                                                         qkv_bias)
    qkv = defop(qkv_f, name='fused_qkv')(*qkv_args)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, dropout_p=attn_dropout_rate,
        training=training)

    def proj_f(av, wv, *b):
        bsz, s = av.shape[0], av.shape[1]
        out = av.reshape(bsz, s, -1) @ wv
        return out + b[0] if b else out
    proj_args = (attn, linear_weight) if linear_bias is None else (
        attn, linear_weight, linear_bias)
    out = defop(proj_f, name='fused_out_proj')(*proj_args)
    out = F.dropout(out, p=dropout_rate, training=training, mode=mode)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = F.layer_norm(out, out.shape[-1], weight=ln_scale, bias=ln_bias,
                           epsilon=ln_epsilon)
    return out


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation='relu', ln1_epsilon=1e-5,
                      ln2_epsilon=1e-5, pre_layer_norm=False, training=True,
                      mode='upscale_in_train', ring_id=-1, add_residual=True,
                      name=None):
    """LN -> linear1 -> act -> dropout -> linear2 -> dropout -> +residual
    (upstream: paddle.incubate.nn.functional.fused_feedforward)."""
    if ring_id != -1:
        raise NotImplementedError('ring_id is not supported')
    residual = x
    h = x
    if pre_layer_norm:
        h = F.layer_norm(h, h.shape[-1], weight=ln1_scale, bias=ln1_bias,
                         epsilon=ln1_epsilon)
    h = fused_linear(h, linear1_weight, linear1_bias)
    h = getattr(F, activation)(h)
    h = F.dropout(h, p=dropout1_rate, training=training, mode=mode)
    h = fused_linear(h, linear2_weight, linear2_bias)
    h = F.dropout(h, p=dropout2_rate, training=training, mode=mode)
    if add_residual:
        h = residual + h
    if not pre_layer_norm:
        h = F.layer_norm(h, h.shape[-1], weight=ln2_scale, bias=ln2_bias,
                         epsilon=ln2_epsilon)
    return h


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True, name=None):
    """Apply RoPE to q/k/v ([B, S, N, H] layout; upstream:
    paddle.incubate.nn.functional.fused_rotary_position_embedding).
    sin/cos: [1, S, 1, H] (or broadcastable); without them the angles use
    the standard 10000^(-2i/H) frequencies. NeoX style rotates halves,
    GPT-J style (use_neox_rotary_style=False) interleaved pairs."""

    def make_sin_cos(s, hdim, dtype, device):
        inv = 1.0 / (10000.0 ** (torch.arange(
            0, hdim, 2, dtype=torch.float32, device=device) / hdim))
        pos = torch.arange(s, dtype=torch.float32, device=device)
        ang = torch.outer(pos, inv)                     # [S, H/2]
        if use_neox_rotary_style:
            ang = torch.cat([ang, ang], dim=-1)
        else:
            ang = torch.repeat_interleave(ang, 2, dim=-1)
        return (torch.sin(ang)[None, :, None, :].to(dtype),
                torch.cos(ang)[None, :, None, :].to(dtype))

    def rot_half(t):
        if use_neox_rotary_style:
            h1, h2 = t.chunk(2, dim=-1)
            return torch.cat([-h2, h1], dim=-1)
        t2 = t.reshape(t.shape[:-1] + (-1, 2))
        return torch.stack([-t2[..., 1], t2[..., 0]], dim=-1).reshape(
            t.shape)

    def apply_one(t, sv, cv, pos):
        if pos is not None:
            sv = sv.squeeze(2).squeeze(0)[pos.long()][:, :, None, :]
            cv = cv.squeeze(2).squeeze(0)[pos.long()][:, :, None, :]
        return t * cv + rot_half(t) * sv

    def f(tv, *rest):
        i = 0
        sv = cv = pv = None
        if sin is not None:
            sv, cv = rest[0], rest[1]
            i = 2
        if position_ids is not None:
            pv = rest[i]
        if sv is None:
            sv, cv = make_sin_cos(tv.shape[1] if pv is None
                                  else int(pv.max()) + 1,
                                  tv.shape[-1], tv.dtype, tv.device)
        return apply_one(tv, sv, cv, pv)

    extra = ([sin, cos] if sin is not None else []) + (
        [position_ids] if position_ids is not None else [])
    return tuple(None if t is None
                 else defop(f, name='fused_rope')(t, *extra)
                 for t in (q, k, v))


def memory_efficient_attention(query, key, value, attn_bias=None, p=0.0,
                               scale=None, training=True, name=None):
    """upstream paddle.incubate.nn.memory_efficient_attention (the
    xformers-style API): F.scaled_dot_product_attention, the flash
    kernels without a bias or dropout. A `scale` multiplies the query by
    scale * sqrt(D) first, as the JAX package does, so the kernel's
    1 / sqrt(D) leaves `scale`."""
    if scale is not None:
        query = query * scale * (query.shape[-1] ** 0.5)
    return F.scaled_dot_product_attention(
        query, key, value, attn_mask=attn_bias, dropout_p=p,
        is_causal=False, training=training)
