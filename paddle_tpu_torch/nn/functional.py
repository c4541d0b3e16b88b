"""Functional ops (counterpart of `paddle_tpu/nn/functional.py`), in
Paddle's layouts: `linear` takes W as [in, out], attention takes
[batch, seq, heads, head_dim].

Each entry runs through `tensor.apply_op` under the JAX function's op
name, so `amp.auto_cast` casts it by the JAX package's lists (`linear`
and `scaled_dot_product_attention` to the low dtype, `rms_norm`,
`cross_entropy`, `softmax`, `layer_norm` and the other black-list ops to
fp32), and a Tensor in gives a Tensor out while plain torch tensors (the
serving and training paths) pass through as they are.

Randomness (dropout, `rrelu`, `gumbel_softmax`, `alpha_dropout`,
attention dropout) draws from the framework's generator of the input's
device (`framework.default_generator`, reseeded by `paddle.seed`):
Philox numbers, not the JAX package's threefry ones. The keep rates,
scales and moments are the JAX package's; one seed reproduces the same
draws.

`layer_norm` keeps the JAX package's order of rounding: mean and
variance are taken in the input's dtype (`paddle_tpu/nn/functional.py:
292-302`). In f32 that is torch's fused `layer_norm` (the two agree to
about 1e-6); in bf16 and fp16 the plain ops run in the JAX order.

Not here yet, with the vision slice: convolution (`conv*`), pooling
(`*pool*`, `max_unpool2d`), padding (`pad`, `zeropad2d`), resampling and
layout (`unfold`, `fold`, `affine_grid`, `grid_sample`,
`temporal_shift`, `pixel_shuffle`, `pixel_unshuffle`, `channel_shuffle`,
`interpolate`, `upsample`); `alltoall` waits for `distributed/`.
"""
from __future__ import annotations

import math as _math
import numbers

import torch

from .. import framework
from ..dtype import convert_dtype
from ..ops import kernels
from ..tensor import Tensor, apply_op

_F = torch.nn.functional


def _gen(t: torch.Tensor) -> torch.Generator:
    return framework.default_generator(t.device)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def relu(x, name=None):
    return apply_op(torch.relu, x, _name='relu')


def relu_(x):
    return x._rebind(relu(x)) if isinstance(x, Tensor) else x.relu_()


def relu6(x, name=None):
    return apply_op(lambda v: torch.clamp(v, 0, 6), x, _name='relu6')


def gelu(x, approximate=False, name=None):
    return apply_op(lambda v: _F.gelu(
        v, approximate='tanh' if approximate else 'none'), x, _name='gelu')


def silu(x, name=None):
    return apply_op(_F.silu, x, _name='silu')


swish = silu


def sigmoid(x, name=None):
    return apply_op(torch.sigmoid, x, _name='sigmoid')


def tanh(x, name=None):
    return apply_op(torch.tanh, x, _name='tanh')


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply_op(lambda v: torch.where(v >= 0, v, negative_slope * v), x,
                    _name='leaky_relu')


def elu(x, alpha=1.0, name=None):
    return apply_op(lambda v: _F.elu(v, alpha), x, _name='elu')


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return apply_op(lambda v: scale * torch.where(v > 0, v,
                                                  alpha * torch.expm1(v)),
                    x, _name='selu')


def celu(x, alpha=1.0, name=None):
    return apply_op(lambda v: _F.celu(v, alpha), x, _name='celu')


def hardswish(x, name=None):
    return apply_op(lambda v: v * torch.clamp(v + 3, 0, 6) / 6, x,
                    _name='hardswish')


def hardsigmoid(x, slope=1 / 6, offset=0.5, name=None):
    return apply_op(lambda v: torch.clamp(slope * v + offset, 0, 1), x,
                    _name='hardsigmoid')


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return apply_op(lambda v: torch.clamp(v, min, max), x, _name='hardtanh')


def hardshrink(x, threshold=0.5, name=None):
    return apply_op(lambda v: torch.where(v.abs() > threshold, v, 0), x,
                    _name='hardshrink')


def softshrink(x, threshold=0.5, name=None):
    return apply_op(
        lambda v: torch.where(v > threshold, v - threshold,
                              torch.where(v < -threshold, v + threshold, 0)),
        x, _name='softshrink')


def tanhshrink(x, name=None):
    return apply_op(lambda v: v - torch.tanh(v), x, _name='tanhshrink')


def mish(x, name=None):
    return apply_op(lambda v: v * torch.tanh(_F.softplus(v)), x,
                    _name='mish')


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return apply_op(
        lambda v: torch.where(beta * v > threshold, v,
                              torch.log1p(torch.exp(beta * v)) / beta),
        x, _name='softplus')


def softsign(x, name=None):
    return apply_op(lambda v: v / (1 + v.abs()), x, _name='softsign')


def logsigmoid(x, name=None):
    return apply_op(_F.logsigmoid, x, _name='log_sigmoid')


def glu(x, axis=-1, name=None):
    def f(v):
        a, b = torch.chunk(v, 2, dim=axis)
        return a * torch.sigmoid(b)
    return apply_op(f, x, _name='glu')


def prelu(x, weight, data_format='NCHW', name=None):
    def f(v, w):
        if w.numel() == 1:
            wb = w.reshape(())
        else:
            ch_axis = 1 if data_format[1] == 'C' else v.dim() - 1
            shape = [1] * v.dim()
            shape[ch_axis] = w.numel()
            wb = w.reshape(shape)
        return torch.where(v >= 0, v, wb * v)
    return apply_op(f, x, weight, _name='prelu')


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


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    def f(v):
        u = torch.empty(v.shape, dtype=torch.float32, device=v.device)
        u.uniform_(torch.finfo(torch.float32).tiny, 1.0, generator=_gen(v))
        g = (-torch.log(-torch.log(u))).to(v.dtype)
        y = torch.softmax((v + g) / temperature, dim=axis)
        if hard:
            idx = y.argmax(dim=axis, keepdim=True)
            onehot = torch.zeros_like(y).scatter_(axis, idx, 1.0)
            y = (onehot - y).detach() + y
        return y
    return apply_op(f, x, _name='gumbel_softmax')


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return apply_op(lambda v: torch.where(v > threshold, v, value), x,
                    _name='thresholded_relu')


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None):
    """Randomized leaky relu: a random negative slope in [lower, upper]
    while training, the mean slope at eval."""
    if not training:
        mid = (lower + upper) / 2.0
        return apply_op(lambda v: torch.where(v >= 0, v, v * mid), x,
                        _name='rrelu')

    def f(v):
        a = torch.empty(v.shape, dtype=torch.float32, device=v.device)
        a.uniform_(lower, upper, generator=_gen(v))
        return torch.where(v >= 0, v, v * a.to(v.dtype))
    return apply_op(f, x, _name='rrelu')


def maxout(x, groups, axis=1, name=None):
    """Max over `groups` consecutive channels."""
    def f(v):
        ax = int(axis) % v.dim()
        c = v.shape[ax]
        shape = v.shape[:ax] + (c // groups, groups) + v.shape[ax + 1:]
        return v.reshape(shape).amax(dim=ax + 1)
    return apply_op(f, x, _name='maxout')


# ---------------------------------------------------------------------------
# linear / embedding / common
# ---------------------------------------------------------------------------

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
        if ids.is_floating_point() or ids.is_complex():
            # the JAX package's gather refuses them (jnp.take)
            raise ValueError('indices must have an integer type')
        out = w[ids.long()]
        if padding_idx is not None:
            pi = padding_idx if padding_idx >= 0 else w.shape[0] + padding_idx
            out = out.masked_fill((ids == pi)[..., None], 0)
        return out
    return apply_op(f, x, weight, _name='embedding')


def one_hot(x, num_classes, name=None):
    from ..ops import creation
    return creation.one_hot(x, num_classes)


def dropout(x, p=0.5, axis=None, training=True, mode='upscale_in_train',
            name=None):
    """Zero each element (or each slice along `axis`) with probability p;
    'upscale_in_train' scales the kept ones by 1 / (1 - p), the other
    mode keeps them as they are. The mask is drawn from the framework's
    generator of x's device."""
    if not training or p == 0:
        return x
    if p == 1:
        return apply_op(torch.zeros_like, x, _name='dropout')

    def f(v):
        shape = list(v.shape)
        if axis is not None:
            axes = [axis] if isinstance(axis, int) else list(axis)
            axes = [a % v.dim() for a in axes]
            shape = [s if i in axes else 1 for i, s in enumerate(shape)]
        keep = torch.empty(shape, dtype=torch.float32, device=v.device)
        keep = keep.bernoulli_(1.0 - p, generator=_gen(v)).bool()
        zero = torch.zeros((), dtype=v.dtype, device=v.device)
        if mode == 'upscale_in_train':
            return torch.where(keep, v / (1.0 - p), zero)
        return torch.where(keep, v, zero)
    return apply_op(f, x, _name='dropout')


def dropout2d(x, p=0.5, training=True, data_format='NCHW', name=None):
    ax = [0, 1] if data_format == 'NCHW' else [0, 3]
    return dropout(x, p=p, axis=ax, training=training)


def dropout3d(x, p=0.5, training=True, data_format='NCDHW', name=None):
    ax = [0, 1] if data_format == 'NCDHW' else [0, 4]
    return dropout(x, p=p, axis=ax, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout: dropped units are set to -alpha', then
    the output is rescaled to keep the mean and variance."""
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return apply_op(torch.zeros_like, x, _name='alpha_dropout')
    alpha = 1.6732632423543772 * 1.0507009873554805  # selu alpha * scale

    def f(v):
        keep = torch.empty(v.shape, dtype=torch.float32, device=v.device)
        keep = keep.bernoulli_(1.0 - p, generator=_gen(v)).bool()
        scale = (1.0 - p + p * alpha ** 2 * (1.0 - p)) ** -0.5
        bias = -scale * p * (-alpha)
        out = torch.where(keep, v, torch.full((), -alpha, dtype=v.dtype,
                                              device=v.device))
        return out * scale + bias
    return apply_op(f, x, _name='alpha_dropout')


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    def f(v):
        n = torch.linalg.vector_norm(v, ord=p, dim=axis, keepdim=True)
        return v / torch.clamp(n, min=epsilon)
    return apply_op(f, x, _name='normalize')


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    def f(lab, *pd):
        k = lab.shape[-1]
        smooth = pd[0] if pd else torch.full((k,), 1.0 / k, dtype=lab.dtype,
                                             device=lab.device)
        return (1 - epsilon) * lab + epsilon * smooth
    args = (label,) if prior_dist is None else (label, prior_dist)
    return apply_op(f, *args, _name='label_smooth')


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    def f(a, b):
        dot = (a * b).sum(dim=axis)
        na = torch.linalg.vector_norm(a, dim=axis)
        nb = torch.linalg.vector_norm(b, dim=axis)
        return dot / torch.clamp(na * nb, min=eps)
    return apply_op(f, x1, x2, _name='cosine_similarity')


def sequence_mask(x, maxlen=None, dtype='int64', name=None):
    def f(v):
        m = int(maxlen) if maxlen is not None else int(v.max())
        rng = torch.arange(m, device=v.device)
        return (rng < v[..., None]).to(convert_dtype(dtype))
    return apply_op(f, x, _name='sequence_mask')


def bilinear(x1, x2, weight, bias=None, name=None):
    def f(a, b, w, *bb):
        out = torch.einsum('bi,oij,bj->bo', a, w, b)
        return out + bb[0] if bb else out
    args = (x1, x2, weight) if bias is None else (x1, x2, weight, bias)
    return apply_op(f, *args, _name='bilinear')


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    def f(a, b):
        return torch.linalg.vector_norm(a - b + epsilon, ord=p, dim=-1,
                                        keepdim=keepdim)
    return apply_op(f, x, y, _name='pairwise_distance')


def pdist(x, p=2.0, name=None):
    """Condensed pairwise distances of rows -> [N * (N - 1) / 2]."""
    def f(v):
        n = v.shape[0]
        iu, ju = torch.triu_indices(n, n, offset=1, device=v.device)
        diff = v[iu] - v[ju]
        if p == 2.0:
            return torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))
        if p == float('inf'):
            return diff.abs().amax(-1)
        return diff.abs().pow(p).sum(-1).pow(1.0 / p)
    return apply_op(f, x, _name='pdist')


def gather_tree(ids, parents, name=None):
    """Trace beam-search parent pointers back from the last step
    ([T, B, K] layout)."""
    def f(idv, par):
        t = idv.shape[0]
        beams = torch.arange(idv.shape[2], device=idv.device).expand(
            idv.shape[1:]).clone()
        out = torch.empty_like(idv)
        for step in range(t - 1, -1, -1):
            out[step] = torch.gather(idv[step], 1, beams)
            beams = torch.gather(par[step], 1, beams).long()
        return out
    return apply_op(f, ids, parents, _name='gather_tree')


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def _affine(out, wb, weight, bias, shape=None):
    i = 0
    if weight is not None:
        out = out * (wb[i] if shape is None else wb[i].reshape(shape))
        i += 1
    if bias is not None:
        out = out + (wb[i] if shape is None else wb[i].reshape(shape))
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """LayerNorm over the trailing `normalized_shape` dims. f32 (and f64)
    take torch's fused op; lower precisions run the JAX package's ops in
    its order, in the input's dtype (see the module note)."""
    if isinstance(normalized_shape, numbers.Integral):
        normalized_shape = (int(normalized_shape),)
    normalized_shape = tuple(int(s) for s in normalized_shape)
    n_axes = len(normalized_shape)

    def f(v, *wb):
        if v.dtype in (torch.float32, torch.float64):
            i = 0
            w = b = None
            if weight is not None:
                w, i = wb[0], 1
            if bias is not None:
                b = wb[i]
            if (w is None or w.dtype == v.dtype) and \
                    (b is None or b.dtype == v.dtype):
                return _F.layer_norm(v, normalized_shape, w, b, epsilon)
        axes = tuple(range(v.dim() - n_axes, v.dim()))
        mu = v.mean(dim=axes, keepdim=True)
        var = (v - mu).square().mean(dim=axes, keepdim=True)
        out = (v - mu) * torch.rsqrt(var + epsilon)
        return _affine(out, wb, weight, bias)
    args = [x] + [t for t in (weight, bias) if t is not None]
    return apply_op(f, *args, _name='layer_norm')


def rms_norm(x, weight, epsilon: float = 1e-6, name=None):
    """RMSNorm over the last dim through the RMSNorm kernel
    (differentiable; its backward is plain torch)."""
    return apply_op(lambda v, w: kernels.rms_norm(v, w, epsilon), x, weight,
                    _name='rms_norm')


def _channel_axis(v, data_format):
    return 1 if data_format.startswith('NC') and v.dim() > 1 else -1


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format='NCHW', use_global_stats=None, name=None):
    """BatchNorm over the channel axis. In training (unless
    `use_global_stats`) the batch's mean and biased variance normalize,
    and the running statistics are updated in place with Paddle's
    momentum: running = momentum * running + (1 - momentum) * batch
    (the unbiased variance), the JAX package's rule
    (`paddle_tpu/nn/functional.py:336-346`); torch's `momentum` is the
    weight of the batch instead, so this does not call torch's op."""
    use_batch = training and not use_global_stats
    stats = [running_mean, running_var]

    def f(v, rm, rv, *wb):
        ch = _channel_axis(v, data_format) % v.dim()
        shape = [1] * v.dim()
        shape[ch] = v.shape[ch]
        if use_batch:
            axes = tuple(i for i in range(v.dim()) if i != ch)
            mu = v.mean(dim=axes)
            var = v.square().mean(dim=axes) - mu.square()
            n = v.numel() // v.shape[ch]
            with torch.no_grad():
                unbiased = var.detach() * (n / max(n - 1, 1))
                rm.mul_(momentum).add_((1 - momentum) * mu.detach())
                rv.mul_(momentum).add_((1 - momentum) * unbiased)
        else:
            mu, var = rm, rv
        out = (v - mu.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                    + epsilon)
        return _affine(out, wb, weight, bias, shape)
    args = [x] + stats + [t for t in (weight, bias) if t is not None]
    return apply_op(f, *args, _name='batch_norm')


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format='NCHW', name=None):
    channels_last = not data_format.startswith('NC')

    def f(v, *wb):
        if channels_last:
            v = torch.movedim(v, -1, 1)
        n, c = v.shape[0], v.shape[1]
        g = int(num_groups)
        vv = v.reshape((n, g, c // g) + tuple(v.shape[2:]))
        axes = tuple(range(2, vv.dim()))
        mu = vv.mean(dim=axes, keepdim=True)
        var = (vv - mu).square().mean(dim=axes, keepdim=True)
        out = ((vv - mu) * torch.rsqrt(var + epsilon)).reshape(v.shape)
        shape = [1] * v.dim()
        shape[1] = c
        out = _affine(out, wb, weight, bias, shape)
        return torch.movedim(out, 1, -1) if channels_last else out
    args = [x] + [t for t in (weight, bias) if t is not None]
    return apply_op(f, *args, _name='group_norm')


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format='NCHW', name=None):
    def f(v, *wb):
        axes = tuple(range(2, v.dim()))
        mu = v.mean(dim=axes, keepdim=True)
        var = (v - mu).square().mean(dim=axes, keepdim=True)
        out = (v - mu) * torch.rsqrt(var + eps)
        shape = [1, v.shape[1]] + [1] * (v.dim() - 2)
        return _affine(out, wb, weight, bias, shape)
    args = [x] + [t for t in (weight, bias) if t is not None]
    return apply_op(f, *args, _name='instance_norm')


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format='NCHW', name=None):
    def f(v):
        sq = v.square()
        half = size // 2
        pad = [0, 0] * (v.dim() - 2) + [half, size - half - 1]
        sq = _F.pad(sq, pad)
        acc = sum(sq.narrow(1, i, v.shape[1]) for i in range(size))
        return v / torch.pow(k + alpha * acc / size, beta)
    return apply_op(f, x, _name='local_response_norm')


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attention(query, key, value, attn_mask=None, is_causal=False,
               dropout_p=0.0):
    if attn_mask is None and not dropout_p \
            and kernels.flash_head_dim_ok(query.shape[-1]):
        return kernels.flash_attention(query, key, value, causal=is_causal)
    if not dropout_p:
        return kernels.attention_reference(query, key, value, mask=attn_mask,
                                           causal=is_causal)
    return _attention_dropout(query, key, value, attn_mask, is_causal,
                              dropout_p)


def _attention_dropout(q, k, v, mask, causal, p):
    """The plain attention with dropout on the probabilities (the JAX
    `_attention_xla` with a dropout key): kept probabilities scaled by
    1 / (1 - p), the mask drawn from the framework's generator."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) \
        * (1.0 / _math.sqrt(d))
    if causal:
        idx_q = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        idx_k = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(idx_k > idx_q, kernels.NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, kernels.NEG_INF)
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1)
    keep = torch.empty(probs.shape, dtype=torch.float32, device=q.device)
    keep = keep.bernoulli_(1.0 - p, generator=_gen(q)).bool()
    probs = torch.where(keep, probs / (1.0 - p), 0.0)
    return torch.einsum('bhqk,bkhd->bqhd', probs.to(q.dtype), v)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, name=None):
    """Attention in [B, S, H, D] with the semantics of the JAX package's
    `_attention_xla` (GQA as [HKV, G], fp32 softmax, probabilities cast to
    q.dtype before PV, bottom-right causal alignment). Without a mask or
    dropout and with D >= 64 it goes through the flash kernels
    (`kernels.flash_attention`: the forward kernel alone, or the
    differentiable `FlashAttention` when a gradient is needed; f32, bf16,
    and fp16 under auto_cast(dtype='float16'); D = 64 or 128 on the
    card); a masked call, a call with dropout (`dropout_p` while
    `training`) and any D < 64 take the plain version, as the JAX package
    sends those to XLA on every backend."""
    p = float(dropout_p) if training else 0.0
    return apply_op(_attention, query, key, value, attn_mask, is_causal, p,
                    _name='scaled_dot_product_attention')


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

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


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False, name=None):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction='none',
                         axis=axis)
    loss = apply_op(lambda t: t.unsqueeze(axis), loss, _name='unsqueeze')
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction='mean',
             name=None):
    def f(logp, lab, *w):
        lab = lab.long()
        valid = lab != ignore_index
        safe = torch.where(valid, lab, 0)
        per = -logp.gather(1, safe.unsqueeze(1)).squeeze(1)
        if w:
            cw = w[0][safe]
            per = torch.where(valid, per * cw, 0.0)
            if reduction == 'mean':
                return per.sum() / torch.where(valid, cw, 0.0).sum().clamp(
                    min=1e-12)
            return _reduce(per, reduction)
        per = torch.where(valid, per, 0.0)
        if reduction == 'mean':
            return per.sum() / valid.sum().clamp(min=1).to(per.dtype)
        return _reduce(per, reduction)
    args = (input, label) if weight is None else (input, label, weight)
    return apply_op(f, *args, _name='nll_loss')


def binary_cross_entropy(input, label, weight=None, reduction='mean',
                         name=None):
    def f(p, y, *w):
        eps = 1e-12
        per = -(y * torch.log(torch.clamp(p, min=eps))
                + (1 - y) * torch.log(torch.clamp(1 - p, min=eps)))
        if w:
            per = per * w[0]
        return _reduce(per, reduction)
    args = (input, label) if weight is None else (input, label, weight)
    return apply_op(f, *args, _name='binary_cross_entropy')


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction='mean', pos_weight=None,
                                     name=None):
    def f(z, y, *extra):
        i = 0
        w = pw = None
        if weight is not None:
            w, i = extra[0], 1
        if pos_weight is not None:
            pw = extra[i]
        # max(z, 0) - z y + log(1 + exp(-|z|)), numerically stable
        base = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))
        if pw is not None:
            base = y * pw * -_F.logsigmoid(z) + (1 - y) * -_F.logsigmoid(-z)
        if w is not None:
            base = base * w
        return _reduce(base, reduction)
    args = [logit, label] + [t for t in (weight, pos_weight) if t is not None]
    return apply_op(f, *args, _name='bce_with_logits')


def mse_loss(input, label, reduction='mean', name=None):
    return apply_op(lambda a, b: _reduce((a - b).square(), reduction),
                    input, label, _name='mse_loss')


def l1_loss(input, label, reduction='mean', name=None):
    return apply_op(lambda a, b: _reduce((a - b).abs(), reduction),
                    input, label, _name='l1_loss')


def smooth_l1_loss(input, label, reduction='mean', delta=1.0, name=None):
    def f(a, b):
        d = (a - b).abs()
        per = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
        return _reduce(per * delta, reduction)   # delta * huber_delta
    return apply_op(f, input, label, _name='smooth_l1_loss')


def kl_div(input, label, reduction='mean', log_target=False, name=None):
    def f(logp, q):
        tgt = torch.exp(q) if log_target else q
        logt = q if log_target else torch.log(torch.clamp(q, min=1e-12))
        per = tgt * (logt - logp)
        if reduction == 'batchmean':
            return per.sum() / logp.shape[0]
        return _reduce(per, reduction)
    return apply_op(f, input, label, _name='kl_div')


def margin_ranking_loss(input, other, label, margin=0.0, reduction='mean',
                        name=None):
    return apply_op(lambda a, b, y: _reduce(
        torch.clamp(-y * (a - b) + margin, min=0.0), reduction),
        input, other, label, _name='margin_ranking_loss')


def hinge_embedding_loss(input, label, margin=1.0, reduction='mean',
                         name=None):
    return apply_op(lambda a, y: _reduce(
        torch.where(y == 1, a, torch.clamp(margin - a, min=0.0)), reduction),
        input, label, _name='hinge_embedding_loss')


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction='sum', name=None):
    def f(z, y, *nrm):
        p = torch.sigmoid(z)
        ce = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))
        p_t = p * y + (1 - p) * (1 - y)
        a_t = alpha * y + (1 - alpha) * (1 - y)
        per = a_t * torch.pow(1 - p_t, gamma) * ce
        if nrm:
            per = per / nrm[0]
        return _reduce(per, reduction)
    args = (logit, label) if normalizer is None else (logit, label,
                                                      normalizer)
    return apply_op(f, *args, _name='sigmoid_focal_loss')


def square_error_cost(input, label, name=None):
    return apply_op(lambda a, b: (a - b).square(), input, label,
                    _name='square_error_cost')


def soft_margin_loss(input, label, reduction='mean', name=None):
    return apply_op(lambda x, y: _reduce(torch.log1p(torch.exp(-y * x)),
                                         reduction),
                    input, label, _name='soft_margin_loss')


def multi_label_soft_margin_loss(input, label, weight=None, reduction='mean',
                                 name=None):
    def f(x, y, *w):
        loss = -(y * _F.logsigmoid(x) + (1 - y) * _F.logsigmoid(-x))
        if w:
            loss = loss * w[0]
        return _reduce(loss.mean(dim=-1), reduction)
    args = (input, label) if weight is None else (input, label, weight)
    return apply_op(f, *args, _name='multi_label_soft_margin_loss')


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction='mean',
                        name=None):
    def f(a, pos, neg):
        def dist(u, v):
            return torch.linalg.vector_norm(u - v + epsilon, ord=p, dim=-1)
        d_pos, d_neg = dist(a, pos), dist(a, neg)
        if swap:
            d_neg = torch.minimum(d_neg, dist(pos, neg))
        return _reduce(torch.clamp(d_pos - d_neg + margin, min=0.0),
                       reduction)
    return apply_op(f, input, positive, negative,
                    _name='triplet_margin_loss')


def minimum_t(a, b):
    return apply_op(torch.minimum, a, b, _name='minimum')


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction='mean',
                                      name=None):
    if distance_function is None:
        return triplet_margin_loss(input, positive, negative, margin=margin,
                                   swap=swap, reduction=reduction)
    d_pos = distance_function(input, positive)
    d_neg = distance_function(input, negative)
    if swap:
        d_neg = minimum_t(d_neg, distance_function(positive, negative))
    return apply_op(lambda dp, dn: _reduce(
        torch.clamp(dp - dn + margin, min=0.0), reduction), d_pos, d_neg,
        _name='triplet_margin_with_distance_loss')


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction='mean', name=None):
    def f(mu, y, var):
        var = torch.clamp(var, min=epsilon)
        loss = 0.5 * (torch.log(var) + (y - mu) ** 2 / var)
        if full:
            loss = loss + 0.5 * _math.log(2 * _math.pi)
        return _reduce(loss, reduction)
    return apply_op(f, input, label, variance, _name='gaussian_nll_loss')


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction='mean', name=None):
    def f(x, y):
        loss = torch.exp(x) - y * x if log_input \
            else x - y * torch.log(x + epsilon)
        if full:   # Stirling's approximation of log(y!) where y > 1
            stirling = y * torch.log(y) - y + 0.5 * torch.log(
                2 * _math.pi * y)
            loss = loss + torch.where(y > 1, stirling, 0.0)
        return _reduce(loss, reduction)
    return apply_op(f, input, label, _name='poisson_nll_loss')


def dice_loss(input, label, epsilon=1e-5, name=None):
    """1 - the dice coefficient over one-hot labels (input [N, ..., C]
    probabilities, label [N, ..., 1] int)."""
    def f(x, y):
        oh = _F.one_hot(y[..., 0].long(), x.shape[-1]).to(x.dtype)
        red = tuple(range(1, x.dim()))
        inter = (x * oh).sum(dim=red)
        denom = x.sum(dim=red) + oh.sum(dim=red)
        return (1.0 - 2.0 * inter / (denom + epsilon)).mean()
    return apply_op(f, input, label, _name='dice_loss')


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """N-pair loss: softmax CE over the anchor-positive similarity matrix
    plus L2 on the embeddings."""
    def f(a, pos, y):
        reg = (a * a).sum(-1).mean() + (pos * pos).sum(-1).mean()
        reg = reg * 0.25 * l2_reg
        sim = a @ pos.T
        same = (y[:, None] == y[None, :]).to(a.dtype)
        tgt = same / same.sum(dim=1, keepdim=True)
        ce = (-tgt * torch.log_softmax(sim, dim=1)).sum(dim=1).mean()
        return ce + reg
    return apply_op(f, anchor, positive, labels, _name='npair_loss')


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction='mean', norm_by_times=False, name=None):
    """CTC loss (log_probs [T, B, C] logits, softmax applied inside as
    warpctc does; labels [B, L] padded past label_lengths): the alpha
    recursion over the 2L + 1 states in log space, one vectorized [B, S]
    step per frame."""
    def f(logits, lab, in_len, lab_len):
        t_max, b, _ = logits.shape
        lp = torch.log_softmax(logits.float(), dim=-1)
        s = 2 * lab.shape[1] + 1
        neg = torch.tensor(-1e30, device=logits.device)
        ext = torch.full((b, s), blank, dtype=torch.long,
                         device=logits.device)
        ext[:, 1::2] = lab.long()
        skip_ok = torch.cat([torch.zeros((b, 2), dtype=torch.bool,
                                         device=logits.device),
                             ext[:, 2:] != ext[:, :-2]], dim=1)
        pos = torch.arange(s, device=logits.device)[None, :]
        lab_len, in_len = lab_len.long(), in_len.long()
        valid = pos < (2 * lab_len[:, None] + 1)
        alpha = torch.where(pos < 2, lp[0].gather(1, ext), neg)
        alpha = torch.where(valid, alpha, neg)
        for t in range(1, t_max):
            prev1 = torch.cat([neg.expand(b, 1), alpha[:, :-1]], dim=1)
            prev2 = torch.cat([neg.expand(b, 2), alpha[:, :-2]], dim=1)
            prev2 = torch.where(skip_ok, prev2, neg)
            tot = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
            new = torch.where(valid, tot + lp[t].gather(1, ext), neg)
            alpha = torch.where((t < in_len)[:, None], new, alpha)
        last = 2 * lab_len[:, None]
        a_last = alpha.gather(1, last)[:, 0]
        a_prev = alpha.gather(1, torch.clamp(last - 1, min=0))[:, 0]
        a_prev = torch.where(lab_len > 0, a_prev, neg)
        nll = -torch.logaddexp(a_last, a_prev)
        if norm_by_times:
            nll = nll / in_len.to(nll.dtype)
        if reduction == 'mean':
            return (nll / torch.clamp(lab_len, min=1).to(nll.dtype)).mean()
        return _reduce(nll, reduction)
    return apply_op(f, log_probs, labels, input_lengths, label_lengths,
                    _name='ctc_loss')


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction='mean', name=None):
    """1 - cos(x1, x2) for label 1, max(0, cos - margin) for label -1."""
    def f(a, b, y):
        cos = (a * b).sum(-1) / torch.clamp(
            torch.linalg.vector_norm(a, dim=-1)
            * torch.linalg.vector_norm(b, dim=-1), min=1e-12)
        loss = torch.where(y > 0, 1.0 - cos, torch.clamp(cos - margin,
                                                         min=0.0))
        return _reduce(loss, reduction)
    return apply_op(f, input1, input2, label, _name='cosine_embedding_loss')


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction='mean', name=None):
    """mean_j max(0, margin - x_y + x_j)^p over the other classes."""
    def f(x, y, *w):
        c = x.shape[1]
        y = y.long()
        xy = x.gather(1, y[:, None])
        m = torch.clamp(margin - xy + x, min=0.0) ** p
        if w:
            m = m * w[0][y][:, None]
        cols = torch.arange(c, device=x.device)[None, :]
        m = torch.where(cols == y[:, None], 0.0, m)
        return _reduce(m.sum(dim=1) / c, reduction)
    args = (input, label) if weight is None else (input, label, weight)
    return apply_op(f, *args, _name='multi_margin_loss')


def log_loss(input, label, epsilon=1e-4, name=None):
    """Elementwise negative log likelihood of probabilities (no
    reduction)."""
    return apply_op(lambda x, y: -(y * torch.log(x + epsilon) + (1.0 - y)
                                   * torch.log1p(-x + epsilon)),
                    input, label, _name='log_loss')


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss: a binary logistic loss at each step of
    a walk down a tree of num_classes - 1 internal nodes (the complete
    binary tree in heap layout, or a custom one from path_table /
    path_code [N, L], -1-padded); returns the per-sample [N, 1]."""
    def f(x, lab, w, *rest):
        i = 0
        b = None
        if bias is not None:
            b, i = rest[0], 1
        if path_table is not None:
            pt = rest[i].long()
            codes = rest[i + 1].float()
            valid = pt >= 0
            nodes = torch.clamp(pt, min=0)
        else:
            c = int(num_classes)
            depth = max(1, int(_math.ceil(_math.log2(max(c, 2)))) + 1)
            node = lab.long() + (c - 1)
            nodes_l, codes_l, valid_l = [], [], []
            for _ in range(depth):
                parent = torch.div(node - 1, 2, rounding_mode='floor')
                alive = node > 0
                nodes_l.append(torch.where(alive, parent, 0))
                codes_l.append((node == 2 * parent + 2).float())
                valid_l.append(alive)
                node = torch.where(alive, parent, 0)
            nodes = torch.stack(nodes_l, dim=-1)
            codes = torch.stack(codes_l, dim=-1)
            valid = torch.stack(valid_l, dim=-1)
        z = torch.einsum('nf,ndf->nd', x.float(), w[nodes].float())
        if b is not None:
            z = z + b[nodes].float().reshape(z.shape)
        step_loss = _F.softplus(z) - codes * z
        return torch.where(valid, step_loss, 0.0).sum(dim=-1)[:, None]
    args = [input, label, weight] + ([bias] if bias is not None else []) \
        + ([path_table, path_code] if path_table is not None else [])
    return apply_op(f, *args, _name='hsigmoid_loss')


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction='mean',
                         name=None):
    """Combined-margin softmax CE over cosine logits (the ArcFace family):
    the target logit cos(theta) becomes cos(m1 theta + m2) - m3 before
    scaling."""
    if group is not None:
        raise NotImplementedError(
            'class-sharded margin_cross_entropy waits for distributed/')

    def f(x, y):
        y = y.long()
        eps = 1e-6
        tcos = x.gather(1, y[:, None])[:, 0]
        theta = torch.arccos(torch.clamp(tcos, -1.0 + eps, 1.0 - eps))
        mod = torch.cos(margin1 * theta + margin2) - margin3
        cols = torch.arange(x.shape[1], device=x.device)[None, :]
        z = torch.where(cols == y[:, None], mod[:, None], x) * scale
        lse = torch.logsumexp(z, dim=1)
        loss = _reduce(lse - mod * scale, reduction)
        if return_softmax:
            return loss, torch.exp(z - lse[:, None])
        return loss
    return apply_op(f, logits, label, _name='margin_cross_entropy')


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None, name=None):
    """Adaptive softmax (Grave et al. 2017): frequent classes in the
    head, rare ones in projected tail clusters. Returns (per-sample
    log-prob, mean nll)."""
    def f(x, y, hw, *rest):
        i = 0
        hb = None
        if head_bias is not None:
            hb, i = rest[0], 1
        tails = [(rest[j], rest[j + 1]) for j in range(i, len(rest), 2)]
        y = y.long()
        head = x @ hw
        if hb is not None:
            head = head + hb
        head_lp = torch.log_softmax(head, dim=-1)
        out = torch.where(
            y < cutoffs[0],
            head_lp.gather(1, torch.clamp(y, max=cutoffs[0] - 1)[:, None])
            [:, 0], 0.0)
        lows = [0] + list(cutoffs)
        for c, (w1, w2) in enumerate(tails):
            lo = lows[c + 1]
            hi = lows[c + 2] if c + 2 < len(lows) else None
            in_c = (y >= lo) & ((y < hi) if hi is not None else True)
            rel = torch.clamp(y - lo, 0, w2.shape[1] - 1)
            tl = torch.log_softmax((x @ w1) @ w2, dim=-1)
            within = tl.gather(1, rel[:, None])[:, 0]
            out = torch.where(in_c, head_lp[:, cutoffs[0] + c] + within, out)
        return out, -out.mean()
    args = [input, label, head_weight] + (
        [head_bias] if head_bias is not None else []) + [
        w for pair in tail_weights for w in pair]
    return apply_op(f, *args, _name='adaptive_log_softmax_with_loss')


# ---------------------------------------------------------------------------
# convolution (the vision slice). The JAX package computes these with
# lax.conv_general_dilated, outside any Pallas kernel; here they are
# torch's conv ops (cuDNN on the card), with the JAX function's padding
# rules: 'SAME' pads as XLA does (the odd cell on the high side, also at
# stride > 1), explicit (lo, hi) pairs may differ, and the transposes
# take Paddle's [in, out / groups, *k] weights with any output_padding.
# ---------------------------------------------------------------------------

def _tuplize(v, n):
    if isinstance(v, numbers.Integral):
        return (int(v),) * n
    v = tuple(int(i) for i in v)
    return v if len(v) == n else tuple(v) * (n // len(v))


def _conv_padding(padding, n, stride, dilation, ksize):
    """Paddle's padding spec as 'SAME' / 'VALID' or [(lo, hi)] per dim
    (the JAX package's `_conv_padding`)."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, numbers.Integral):
        return [(int(padding), int(padding))] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, numbers.Integral)
                                 for p in padding):
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    flat = [p for p in padding if isinstance(p, (list, tuple))]
    if flat:
        return [(int(p[0]), int(p[1])) for p in flat[-n:]]
    raise ValueError(f'bad padding {padding!r}')


def _explicit_padding(pad, spatial, ksize, stride, dilation):
    """'SAME' / 'VALID' as XLA resolves them: SAME keeps ceil(in /
    stride) outputs and puts the odd padded cell on the high side."""
    if pad == 'VALID':
        return [(0, 0)] * len(spatial)
    if pad != 'SAME':
        return pad
    out = []
    for size, k, s, d in zip(spatial, ksize, stride, dilation):
        total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
        out.append((total // 2, total - total // 2))
    return out


def _torch_pad(pairs):
    """[(lo, hi)] per dim, first dim first, as F.pad's innermost-first
    list."""
    return [p for lo_hi in reversed(pairs) for p in lo_hi]


_CONV = {1: _F.conv1d, 2: _F.conv2d, 3: _F.conv3d}
_CONV_T = {1: _F.conv_transpose1d, 2: _F.conv_transpose2d,
           3: _F.conv_transpose3d}


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, n,
             channel_last=False, name='conv'):
    stride_t = _tuplize(stride, n)
    dil_t = _tuplize(dilation, n)

    def f(v, w, *b):
        if channel_last:
            v = torch.movedim(v, -1, 1)
        pad = _explicit_padding(
            _conv_padding(padding, n, stride_t, dil_t, w.shape[2:]),
            v.shape[2:], w.shape[2:], stride_t, dil_t)
        if all(lo == hi for lo, hi in pad):
            conv_pad = tuple(lo for lo, _ in pad)
        else:
            v = _F.pad(v, _torch_pad(pad))
            conv_pad = 0
        out = _CONV[n](v, w, b[0] if b else None, stride_t, conv_pad, dil_t,
                       groups)
        return torch.movedim(out, 1, -1) if channel_last else out
    args = (x, weight) if bias is None else (x, weight, bias)
    return apply_op(f, *args, _name=name)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format='NCL', name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    channel_last=(data_format == 'NLC'), name='conv1d')


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format='NCHW', name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    channel_last=(data_format == 'NHWC'), name='conv2d')


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format='NCDHW', name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    channel_last=(data_format == 'NDHWC'), name='conv3d')


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, n, channel_last, name):
    """The transpose as the JAX package defines it (the gradient of a
    convolution): the full transposed convolution, cropped by `padding`
    (lo, hi) and extended by `output_padding` on the high side, where
    cells past the full result are zero before the bias. `output_size`
    is taken and not read, as in the JAX function."""
    stride_t = _tuplize(stride, n)
    dil_t = _tuplize(dilation, n)
    opad_t = _tuplize(output_padding, n)

    def f(v, w, *b):
        if channel_last:
            v = torch.movedim(v, -1, 1)
        pad = _conv_padding(padding, n, stride_t, dil_t, w.shape[2:])
        if isinstance(pad, str):
            if pad != 'VALID':
                raise ValueError('SAME padding unsupported for '
                                 'conv_transpose')
            pad = [(0, 0)] * n
        out = _CONV_T[n](v, w, None, stride_t, 0, 0, groups, dil_t)
        sizes = [out.shape[2 + d] - lo - hi + opad
                 for d, ((lo, hi), opad) in enumerate(zip(pad, opad_t))]
        grow = [(max(-lo, 0), max(opad - hi, 0))
                for (lo, hi), opad in zip(pad, opad_t)]
        if any(g for pair in grow for g in pair):
            out = _F.pad(out, _torch_pad(grow))
        for d, ((lo, _), (glo, _), size) in enumerate(zip(pad, grow, sizes)):
            out = out.narrow(2 + d, lo + glo, size)
        if b:
            out = out + b[0].reshape((1, -1) + (1,) * n)
        return torch.movedim(out, 1, -1) if channel_last else out
    args = (x, weight) if bias is None else (x, weight, bias)
    return apply_op(f, *args, _name=name)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format='NCL', name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                              dilation, groups, 1, data_format == 'NLC',
                              'conv1d_transpose')


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format='NCHW', output_size=None, name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                              dilation, groups, 2, data_format == 'NHWC',
                              'conv2d_transpose')


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format='NCDHW', output_size=None, name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                              dilation, groups, 3, data_format == 'NDHWC',
                              'conv3d_transpose')


# ---------------------------------------------------------------------------
# pooling: the JAX `_pool_nd` (a reduce_window over -inf or 0 padding).
# `ceil_mode` adds high-side cells only where the last window starts
# inside the input or its low padding; `exclusive` (the default) divides
# by the window's cells inside the input; with it off, the regular
# padding counts and the ceil-mode cells do not. As in the JAX function,
# `data_format` and `divisor_override` are taken and not read.
# ---------------------------------------------------------------------------

def _ceil_mode_extra(spatial, k_t, s_t, pad):
    extra = []
    for i, h in enumerate(spatial):
        lo, hi = pad[i]
        eff = h + lo + hi - k_t[i]
        out = -(-eff // s_t[i]) + 1
        if (out - 1) * s_t[i] >= h + lo:
            out -= 1
        extra.append(max(0, (out - 1) * s_t[i] + k_t[i] - (h + lo + hi)))
    return tuple(extra)


def _window_sum(v, k_t, s_t):
    """Sums over windows of k_t at strides s_t, no padding (1-D through
    the 2-D op)."""
    if len(k_t) == 1:
        return _F.avg_pool2d(v.unsqueeze(-2), (1,) + k_t, (1,) + s_t,
                             divisor_override=1).squeeze(-2)
    op = _F.avg_pool2d if len(k_t) == 2 else _F.avg_pool3d
    return op(v, k_t, s_t, divisor_override=1)


def _window_max(v, k_t, s_t):
    op = {1: _F.max_pool1d, 2: _F.max_pool2d, 3: _F.max_pool3d}[len(k_t)]
    return op(v, k_t, s_t)


def _pool_nd(x, kernel, stride, padding, n, maximum, ceil_mode=False,
             count_include_pad=True, name='pool'):
    k_t = _tuplize(kernel, n)
    s_t = _tuplize(stride if stride is not None else kernel, n)

    def f(v):
        pad = _conv_padding(padding, n, s_t, (1,) * n, k_t)
        if isinstance(pad, str):
            raise ValueError('str padding unsupported in pool')
        extra = _ceil_mode_extra(v.shape[2:], k_t, s_t, pad) if ceil_mode \
            else (0,) * n
        pads = [(lo, hi + e) for (lo, hi), e in zip(pad, extra)]
        if maximum:
            return _window_max(_F.pad(v, _torch_pad(pads),
                                      value=float('-inf')), k_t, s_t)
        out = _window_sum(_F.pad(v, _torch_pad(pads)), k_t, s_t)
        if count_include_pad and not any(extra):
            return out / float(_math.prod(k_t))
        ones = torch.ones((1, 1) + tuple(v.shape[2:]), dtype=v.dtype,
                          device=v.device)
        if count_include_pad:
            ones = _F.pad(ones, _torch_pad(pad), value=1.0)
            cnt = _window_sum(_F.pad(ones, _torch_pad(
                [(0, e) for e in extra])), k_t, s_t)
        else:
            cnt = _window_sum(_F.pad(ones, _torch_pad(pads)), k_t, s_t)
        return out / cnt
    return apply_op(f, x, _name=name)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    return _pool_nd(x, kernel_size, stride, padding, 1, True, ceil_mode,
                    name='max_pool1d')


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format='NCHW', name=None):
    if return_mask:
        return max_pool2d_with_index(x, kernel_size, stride, padding,
                                     ceil_mode)
    return _pool_nd(x, kernel_size, stride, padding, 2, True, ceil_mode,
                    name='max_pool2d')


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format='NCDHW', name=None):
    return _pool_nd(x, kernel_size, stride, padding, 3, True, ceil_mode,
                    name='max_pool3d')


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool_nd(x, kernel_size, stride, padding, 1, False, ceil_mode,
                    count_include_pad=not exclusive, name='avg_pool1d')


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format='NCHW',
               name=None):
    return _pool_nd(x, kernel_size, stride, padding, 2, False, ceil_mode,
                    count_include_pad=not exclusive, name='avg_pool2d')


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format='NCDHW',
               name=None):
    return _pool_nd(x, kernel_size, stride, padding, 3, False, ceil_mode,
                    count_include_pad=not exclusive, name='avg_pool3d')


_ADAPTIVE = {(1, False): _F.adaptive_avg_pool1d,
             (2, False): _F.adaptive_avg_pool2d,
             (3, False): _F.adaptive_avg_pool3d,
             (1, True): _F.adaptive_max_pool1d,
             (2, True): _F.adaptive_max_pool2d}


def _adaptive_pool(x, output_size, n, maximum, name):
    """Bins floor(i * in / out) to ceil((i + 1) * in / out) per dim over
    the last n dims, the JAX function's (and torch's) bucketing."""
    out_sz = _tuplize(output_size, n)
    return apply_op(lambda v: _ADAPTIVE[(n, maximum)](v, out_sz), x,
                    _name=name)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size, 1, False, 'adaptive_avg_pool1d')


def adaptive_avg_pool2d(x, output_size, data_format='NCHW', name=None):
    return _adaptive_pool(x, output_size, 2, False, 'adaptive_avg_pool2d')


def adaptive_avg_pool3d(x, output_size, data_format='NCDHW', name=None):
    return _adaptive_pool(x, output_size, 3, False, 'adaptive_avg_pool3d')


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 1, True, 'adaptive_max_pool1d')


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 2, True, 'adaptive_max_pool2d')


def max_pool2d_with_index(x, kernel_size, stride=None, padding=0,
                          ceil_mode=False, name=None):
    """(out, flat H * W indices into the unpadded input) per (N, C)
    plane, the first maximum of each window in row-major order: the mask
    `max_unpool2d` consumes."""
    k = _tuplize(kernel_size, 2)
    s = _tuplize(stride if stride is not None else kernel_size, 2)
    p = _conv_padding(padding, 2, s, (1, 1), k)

    def f(v):
        n, c, h, w = v.shape
        extra = _ceil_mode_extra((h, w), k, s, list(p)) if ceil_mode \
            else (0, 0)
        vp = _F.pad(v, [p[1][0], p[1][1] + extra[1], p[0][0],
                        p[0][1] + extra[0]], value=float('-inf'))
        hp, wp = vp.shape[-2:]
        ho = (hp - k[0]) // s[0] + 1
        wo = (wp - k[1]) // s[1] + 1
        dev = v.device
        yy = (torch.arange(ho, device=dev) * s[0])[:, None, None, None] \
            + torch.arange(k[0], device=dev)[None, None, :, None]
        xx = (torch.arange(wo, device=dev) * s[1])[None, :, None, None] \
            + torch.arange(k[1], device=dev)[None, None, None, :]
        yy, xx = torch.broadcast_tensors(yy, xx)       # [Ho, Wo, kh, kw]
        patches = vp[:, :, yy, xx].reshape(n, c, ho, wo, -1)
        out, arg = patches.max(dim=-1)
        flat = ((yy - p[0][0]) * w + (xx - p[1][0])).reshape(ho, wo, -1)
        idx = flat.expand(n, c, ho, wo, flat.shape[-1]).gather(
            -1, arg.unsqueeze(-1)).squeeze(-1)
        return out, idx.to(torch.int32)
    return apply_op(f, x, _name='max_pool2d_with_index')


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format='NCHW', name=None):
    """Pooled values scattered back to their flat H * W positions
    (`indices` from `max_pool2d(..., return_mask=True)`)."""
    if data_format != 'NCHW':
        raise NotImplementedError('max_unpool2d supports NCHW')
    k = _tuplize(kernel_size, 2)
    s = _tuplize(stride if stride is not None else kernel_size, 2)
    p = _tuplize(padding, 2)

    def f(v, idx):
        n, c, ho, wo = v.shape
        if output_size is not None:
            out_h, out_w = [int(o) for o in output_size[-2:]]
        else:
            out_h = (ho - 1) * s[0] - 2 * p[0] + k[0]
            out_w = (wo - 1) * s[1] - 2 * p[1] + k[1]
        flat = torch.zeros((n, c, out_h * out_w), dtype=v.dtype,
                           device=v.device)
        flat = flat.scatter(2, idx.reshape(n, c, -1).long(),
                            v.reshape(n, c, -1))
        return flat.reshape(n, c, out_h, out_w)
    return apply_op(f, x, indices, _name='max_unpool2d')


# ---------------------------------------------------------------------------
# padding, patches, sampling and layout
# ---------------------------------------------------------------------------

def _pad_index(size: int, lo: int, hi: int, mode: str, device):
    """Source indices of a dim padded by (lo, hi) in a gathering mode
    (numpy's 'reflect', 'edge' and 'wrap', as jnp.pad)."""
    i = torch.arange(-lo, size + hi, device=device)
    if mode == 'replicate':
        return i.clamp(0, size - 1)
    if mode == 'circular':
        return i % size
    if size == 1:
        return torch.zeros_like(i)
    period = 2 * (size - 1)
    i = i.abs() % period
    return torch.where(i > size - 1, period - i, i)


def pad(x, pad, mode='constant', value=0.0, data_format='NCHW', name=None):
    """Pad the last len(pad) // 2 dims, innermost dim first; a pad of
    2 * ndim entries gives every dim's (lo, hi), first dim first (the
    JAX function's two forms; `data_format` is not read)."""
    pad_l = [int(p) for p in (pad.tolist() if hasattr(pad, 'tolist')
                              else pad)]
    if mode not in ('constant', 'reflect', 'replicate', 'circular'):
        raise KeyError(mode)

    def f(v):
        if len(pad_l) == 2 * v.dim():
            cfg = [(pad_l[2 * i], pad_l[2 * i + 1]) for i in range(v.dim())]
        else:
            k = len(pad_l) // 2
            cfg = [(0, 0)] * (v.dim() - k) + [
                (pad_l[2 * (k - 1 - i)], pad_l[2 * (k - 1 - i) + 1])
                for i in range(k)]
        if mode == 'constant':
            return _F.pad(v, _torch_pad(cfg), value=float(value))
        for d, (lo, hi) in enumerate(cfg):
            if lo or hi:
                v = v.index_select(d, _pad_index(v.shape[d], lo, hi, mode,
                                                 v.device))
        return v
    return apply_op(f, x, _name='pad')


def zeropad2d(x, padding, data_format='NCHW', name=None):
    p = _tuplize(padding, 4)               # [left, right, top, bottom]

    def f(v):
        if data_format == 'NCHW':
            return _F.pad(v, [p[0], p[1], p[2], p[3]])
        return _F.pad(v, [0, 0, p[0], p[1], p[2], p[3]])
    return apply_op(f, x, _name='zeropad2d')


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: NCHW -> [N, C * kh * kw, L], channel-major as
    conv_general_dilated_patches orders it."""
    k = _tuplize(kernel_sizes, 2)
    s = _tuplize(strides, 2)
    d = _tuplize(dilations, 2)

    def f(v):
        pd = _explicit_padding(_conv_padding(paddings, 2, s, d, k),
                               v.shape[2:], k, s, d)
        return _F.unfold(_F.pad(v, _torch_pad(pd)), k, d, 0, s)
    return apply_op(f, x, _name='unfold')


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0,
         dilations=1, name=None):
    """col2im, the inverse of `unfold`: overlapping patches summed into
    [N, C, oh, ow] (symmetric padding per dim, as the JAX function)."""
    out_hw = _tuplize(output_sizes, 2)
    k = _tuplize(kernel_sizes, 2)
    s = _tuplize(strides, 2)
    d = _tuplize(dilations, 2)
    p = _tuplize(paddings, 2) if not isinstance(paddings, int) \
        else (paddings, paddings)
    return apply_op(lambda v: _F.fold(v, out_hw, k, d, p, s), x,
                    _name='fold')


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """[N, 2, 3] affine matrices -> [N, H, W, 2] sampling grid in [-1, 1]
    coordinates, in f32."""
    h, w = int(out_shape[2]), int(out_shape[3])

    def f(th):
        dev = th.device
        if align_corners:
            ys = torch.linspace(-1, 1, h, device=dev)
            xs = torch.linspace(-1, 1, w, device=dev)
        else:
            ys = (torch.arange(h, device=dev) + 0.5) * 2 / h - 1
            xs = (torch.arange(w, device=dev) + 0.5) * 2 / w - 1
        gy, gx = torch.meshgrid(ys, xs, indexing='ij')
        base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
        return torch.einsum('hwk,nok->nhwo', base, th.float())
    return apply_op(f, theta, _name='affine_grid')


def grid_sample(x, grid, mode='bilinear', padding_mode='zeros',
                align_corners=True, name=None):
    """Sample NCHW `x` at [N, H', W', 2] grid locations in [-1, 1]: the
    JAX function's gather and bilinear arithmetic (`zeros` blends each
    in-bounds corner, `border` clamps, `reflection` reflects across the
    cell borders)."""
    if padding_mode not in ('zeros', 'border', 'reflection'):
        raise ValueError(f'unsupported padding_mode {padding_mode!r}')

    def f(xv, gv):
        n, c, h, w = xv.shape
        gx, gy = gv[..., 0], gv[..., 1]
        if align_corners:
            fx = (gx + 1) * 0.5 * (w - 1)
            fy = (gy + 1) * 0.5 * (h - 1)
        else:
            fx = ((gx + 1) * w - 1) * 0.5
            fy = ((gy + 1) * h - 1) * 0.5

        def reflect(v, size):
            span = 2 * (size - 1) if align_corners else 2 * size
            if span == 0:
                return torch.zeros_like(v)
            v = v.abs() if align_corners else (v + 0.5).abs() - 0.5
            v = torch.remainder(v, span)
            if align_corners:
                return torch.where(v > span / 2, span - v, v)
            return torch.clamp(torch.where(v > span / 2 - 0.5,
                                           span - 1 - v, v), 0, size - 1)

        if padding_mode == 'border':
            fx = torch.clamp(fx, 0, w - 1)
            fy = torch.clamp(fy, 0, h - 1)
        elif padding_mode == 'reflection':
            fx = torch.clamp(reflect(fx, w), 0, w - 1)
            fy = torch.clamp(reflect(fy, h), 0, h - 1)

        flat = xv.reshape(n, c, h * w)

        def gather(yy, xx):
            yc = torch.clamp(yy, 0, h - 1).long()
            xc = torch.clamp(xx, 0, w - 1).long()
            idx = (yc * w + xc).reshape(n, 1, -1).expand(n, c, -1)
            return flat.gather(2, idx).reshape((n, c) + tuple(yy.shape[1:]))

        def inb(yy, xx):
            return ((yy >= 0) & (yy <= h - 1) & (xx >= 0)
                    & (xx <= w - 1)).unsqueeze(1)

        if mode == 'nearest':
            xi, yi = torch.round(fx), torch.round(fy)
            out = gather(yi, xi)
            if padding_mode == 'zeros':
                out = torch.where(inb(yi, xi), out, 0.0)
            return out.to(xv.dtype)
        x0, y0 = torch.floor(fx), torch.floor(fy)
        wx = (fx - x0).unsqueeze(1)
        wy = (fy - y0).unsqueeze(1)
        v00, v01 = gather(y0, x0), gather(y0, x0 + 1)
        v10, v11 = gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)
        if padding_mode == 'zeros':
            v00 = v00 * inb(y0, x0)
            v01 = v01 * inb(y0, x0 + 1)
            v10 = v10 * inb(y0 + 1, x0)
            v11 = v11 * inb(y0 + 1, x0 + 1)
        out = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
               + v10 * wy * (1 - wx) + v11 * wy * wx)
        return out.to(xv.dtype)
    return apply_op(f, x, grid, _name='grid_sample')


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format='NCHW',
                   name=None):
    """TSM: a `shift_ratio` share of the channels moves one segment back,
    the next share one forward ([N * T, C, H, W], T = seg_num)."""
    if data_format not in ('NCHW', 'NHWC'):
        raise ValueError(f'unsupported data_format {data_format!r}')

    def f(v):
        if data_format == 'NHWC':
            v = v.permute(0, 3, 1, 2)
        nt, c, h, w = v.shape
        v = v.reshape(nt // seg_num, seg_num, c, h, w)
        fc = int(c * shift_ratio)
        left = torch.cat([v[:, 1:, :fc], torch.zeros_like(v[:, :1, :fc])],
                         dim=1)
        right = torch.cat([torch.zeros_like(v[:, :1, fc:2 * fc]),
                           v[:, :-1, fc:2 * fc]], dim=1)
        out = torch.cat([left, right, v[:, :, 2 * fc:]], dim=2)
        out = out.reshape(nt, c, h, w)
        return out.permute(0, 2, 3, 1) if data_format == 'NHWC' else out
    return apply_op(f, x, _name='temporal_shift')


def pixel_shuffle(x, upscale_factor, data_format='NCHW', name=None):
    r = int(upscale_factor)

    def f(v):
        n, c, h, w = v.shape
        v = v.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return v.reshape(n, c // (r * r), h * r, w * r)
    return apply_op(f, x, _name='pixel_shuffle')


def pixel_unshuffle(x, downscale_factor, data_format='NCHW', name=None):
    r = int(downscale_factor)

    def f(v):
        n, c, h, w = v.shape
        v = v.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return v.reshape(n, c * r * r, h // r, w // r)
    return apply_op(f, x, _name='pixel_unshuffle')


def channel_shuffle(x, groups, data_format='NCHW', name=None):
    def f(v):
        if data_format == 'NCHW':
            n, c, h, w = v.shape
            return v.reshape(n, groups, c // groups, h, w) \
                .transpose(1, 2).reshape(n, c, h, w)
        n, h, w, c = v.shape
        return v.reshape(n, h, w, groups, c // groups) \
            .transpose(3, 4).reshape(n, h, w, c)
    return apply_op(f, x, _name='channel_shuffle')


# ---------------------------------------------------------------------------
# interpolate: `jax.image.resize` as the JAX function calls it, not
# torch's F.interpolate: 'nearest' takes floor((i + 0.5) * in / out)
# (half-pixel centres); 'linear' / 'bilinear' / 'trilinear' and
# 'bicubic' are separable weight matrices over half-pixel sample points
# with the triangle or the Keys cubic kernel (a = -0.5), widened by the
# scale when downsampling (antialiasing) and renormalized at the
# borders; align_corners=True is a linear gather for every one of those
# modes. `align_mode` and `data_format` are not read.
# ---------------------------------------------------------------------------

def _resize_kernel(method: str, x: torch.Tensor) -> torch.Tensor:
    if method == 'linear':
        return torch.clamp(1 - x.abs(), min=0)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _resize_weights(in_size: int, out_size: int, method: str, device):
    """jax.image's compute_weight_mat, [in, out] in f32."""
    scale = out_size / in_size
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    wts = _resize_kernel(method, (sample[None, :] - src[:, None]).abs()
                         / kscale)
    total = wts.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    wts = torch.where(total.abs() > eps,
                      wts / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], wts, 0.0)


def _resize(v: torch.Tensor, out_sz, method: str) -> torch.Tensor:
    for d, o in enumerate(out_sz):
        axis = 2 + d
        m = v.shape[axis]
        if m == o:
            continue
        if method == 'nearest':
            idx = torch.floor((torch.arange(o, dtype=torch.float32,
                                            device=v.device) + 0.5)
                              * m / o).long()
            v = v.index_select(axis, idx)
        else:
            w = _resize_weights(m, o, method, v.device).to(v.dtype)
            v = torch.movedim(torch.tensordot(
                torch.movedim(v, axis, -1), w, dims=1), -1, axis)
    return v


def interpolate(x, size=None, scale_factor=None, mode='nearest',
                align_corners=False, align_mode=0, data_format='NCHW',
                name=None):
    def f(v):
        spatial_in = v.shape[2:]
        if size is not None:
            out_sz = _tuplize(size, len(spatial_in))
        else:
            sf = scale_factor
            if isinstance(sf, (int, float)):
                sf = [sf] * len(spatial_in)
            out_sz = tuple(int(s * f_) for s, f_ in zip(spatial_in, sf))
        if mode == 'nearest':
            return _resize(v, out_sz, 'nearest')
        if mode not in ('bilinear', 'linear', 'trilinear', 'bicubic'):
            raise ValueError(f'unsupported interpolate mode {mode!r}')
        if not align_corners:
            return _resize(v, out_sz,
                           'cubic' if mode == 'bicubic' else 'linear')
        out = v
        for d, o in enumerate(out_sz):
            axis = 2 + d
            in_d = out.shape[axis]
            if o == 1 or in_d == 1:
                idx = torch.zeros((o,), dtype=torch.float32, device=v.device)
            else:
                idx = torch.arange(o, device=v.device) * ((in_d - 1)
                                                          / (o - 1))
            lo = torch.floor(idx).long()
            hi = torch.clamp(lo + 1, max=in_d - 1)
            shape = [1] * out.dim()
            shape[axis] = o
            w_hi = (idx - lo).to(v.dtype).reshape(shape)
            out = out.index_select(axis, lo) * (1 - w_hi) \
                + out.index_select(axis, hi) * w_hi
        return out
    return apply_op(f, x, _name='interpolate')


def upsample(x, size=None, scale_factor=None, mode='nearest',
             align_corners=False, align_mode=0, data_format='NCHW', name=None):
    return interpolate(x, size, scale_factor, mode, align_corners, align_mode,
                       data_format)
