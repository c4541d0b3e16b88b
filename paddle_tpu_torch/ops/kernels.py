"""The port's kernels: wrappers, plain versions and launch counts.

Counterpart of `paddle_tpu/ops/pallas_kernels.py`. Each TPU kernel on
the serving and training paths has a hand-written Hopper kernel here
(CUDA C++ under `paddle_tpu_torch/csrc/`, built by `ops/_build.py`):

- `flash_attention_fwd` replaces `_flash_fwd_kernel` (with the LSE),
- `flash_attention_bwd_dq` replaces `_flash_bwd_dq_kernel`,
- `flash_attention_bwd_dkv` replaces `_flash_bwd_dkv_kernel`,
- `paged_attention` replaces `_paged_attn_kernel`,
- `rms_norm_fwd` replaces `_rms_fwd_kernel`,
- `softmax_cross_entropy_fwd` replaces `_ce_fwd_kernel`,
- `softmax_cross_entropy_bwd` replaces `_ce_bwd_kernel`,
- `adapter_matmul` replaces `_adapter_matmul_kernel` (per-row LoRA delta);
  `adapter_matmul_add` fuses the hook's add into the same kernel.

Two kernels have no Pallas counterpart: `multi_tensor_adam` and
`multi_tensor_sumsq` are the optimizer update that XLA fuses inside the
JAX `TrainStep`'s one jitted program (Adam/AdamW with the global-norm
clip), as one pass over many tensors per launch.

The gradients are `torch.autograd.Function`s around them, the
counterparts of the JAX package's custom VJPs: `FlashAttention`
(`flash_attention_own`), `SoftmaxCrossEntropy` (`softmax_cross_entropy`)
and `RMSNormFunction`, whose backward is plain torch because the JAX
model's RMSNorm backward is XLA code, not a Pallas kernel.

Beside each wrapper sits its plain PyTorch version (`*_reference`), the
same function written as tensor code. A wrapper takes the plain version
only for tensors that lie on the CPU, which is how the CPU tests run;
for a CUDA tensor it launches its kernel or raises, and never falls
back. `LAUNCHES` counts kernel launches, one per launch and nowhere
else, so a run can show that its path went through the kernels; a CUDA
graph's replays count through `CapturedLaunches`.

Each CUDA source starts with a note: the TPU kernel it replaces, what
bounds it on the H100, and what its design does about that. The flash
forward, dq and dk/dv wrappers launch by dtype: bf16 on the tensor-core
(wgmma) kernels, f32 on fp32 FMA kernels; any other dtype raises. One
`paged_attention` call launches two device kernels (the split-context
pass and its combine) and counts once.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

# the JAX package's masked-logit value (jnp.finfo(float32).min)
NEG_INF = torch.finfo(torch.float32).min

LAUNCHES = {'flash_attention_fwd': 0, 'flash_attention_bwd_dq': 0,
            'flash_attention_bwd_dkv': 0, 'paged_attention': 0,
            'rms_norm': 0, 'softmax_ce_fwd': 0, 'softmax_ce_bwd': 0,
            'adapter_matmul': 0, 'multi_tensor_adam': 0,
            'multi_tensor_sumsq': 0}

# csrc/common.cuh: PttDtype
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float16: 3}
_HEAD_DIM = 128          # the kernels are compiled for D = 128
_MAX_GROUP = 8           # paged kernel: query heads per kv head, at most
PAGED_SPLIT_KEYS = 64    # paged kernel: keys per split and rows per page, at most
ADAPTER_MAX_RANK = 64    # adapter kernel: LoRA rank, at most
ADAPTER_MAX_BATCH = 1024  # adapter kernel: rows per call, at most

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = {
    'rms_norm_fwd': [_P, _P, _P, _I, _I, _F, _I, _P],
    'flash_attention_fwd': [_P] * 6 + [_I] * 5 + [_L] * 12
    + [_F, _I, _I, _P],
    'flash_attention_bwd_dq': [_P] * 8 + [_I] * 5 + [_F, _I, _I, _P],
    'flash_attention_bwd_dkv': [_P] * 8 + [_I] * 5 + [_F, _I, _I, _P],
    'softmax_ce_fwd': [_P] * 4 + [_I] * 4 + [_P],
    'softmax_ce_bwd': [_P] * 5 + [_I] * 4 + [_P],
    'paged_attention_fwd': [_P] * 12 + [_I] * 8 + [_F, _I, _I, _P],
    'adapter_matmul_fwd': [_P] * 7 + [_I] * 8 + [_P],
    'multi_tensor_adam': [_I] + [_P] * 4 + [_F] * 6 + [_I, _P] + [_I] * 4
    + [_P],
    'multi_tensor_sumsq_partial': [_I] + [_P] * 6,
    'multi_tensor_sumsq_finish': [_P, _I, _P, _P],
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class CapturedLaunches:
    """The kernel launches a CUDA graph holds, so that `LAUNCHES` counts
    replays: `with CapturedLaunches() as held: <capture>` takes the
    change in `LAUNCHES` over the capture (the wrappers count what they
    record) and undoes it, since a capture launches nothing; each
    `held.replayed()` adds it back."""

    def __enter__(self) -> 'CapturedLaunches':
        self._before = dict(LAUNCHES)
        return self

    def __exit__(self, *exc) -> bool:
        self.counts = {k: n - self._before[k] for k, n in LAUNCHES.items()
                       if n != self._before[k]}
        LAUNCHES.update(self._before)
        return False

    def replayed(self) -> None:
        for name, n in self.counts.items():
            LAUNCHES[name] += n


def _entry(source: str, fn: str):
    lib = _build.load(source)
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = _ARGTYPES[fn]
        f.restype = ctypes.c_int
    return lib, f


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (take the plain version);
    False when all lie on one CUDA device (launch the kernel). Anything
    else is a caller error."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f'tensors on several devices: {sorted(map(str, devices))}')
    dev = devices.pop()
    if dev.type == 'cpu':
        return True
    if dev.type != 'cuda':
        raise ValueError(f'no kernel for device {dev}')
    return False


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _aligned16(*tensors) -> bool:
    """Every tensor's base pointer and every stride but the last are
    16-byte multiples (the bf16 attention kernels' cp.async copies)."""
    return all(t.data_ptr() % 16 == 0
               and all(st * t.element_size() % 16 == 0
                       for st in t.stride()[:-1]) for t in tensors)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rms_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """Plain version: normalize in fp32, cast to x.dtype, then multiply by
    the weight (the JAX model's `F.rms_norm` order)."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * weight


def rms_norm_fwd(x: torch.Tensor, weight: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim of x (any leading shape), weight [width],
    through the kernel (no gradient)."""
    if _on_cpu(x, weight):
        return rms_norm_reference(x, weight, eps)
    width = x.shape[-1]
    _require(x.dtype in (torch.float32, torch.bfloat16),
             f'rms_norm kernel takes f32 or bf16, got {x.dtype}')
    _require(weight.dtype == x.dtype and tuple(weight.shape) == (width,),
             'rms_norm weight must be [width] in x.dtype')
    _require(x.is_contiguous() and weight.is_contiguous(),
             'rms_norm kernel takes contiguous tensors')
    out = torch.empty_like(x)
    rows = x.numel() // width if width else 0
    if rows == 0:
        return out
    lib, fn = _entry('rms_norm', 'rms_norm_fwd')
    rc = fn(x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, width,
            float(eps), _DTYPE_CODE[x.dtype], _stream(x))
    _build.check(lib, rc, 'rms_norm_fwd')
    LAUNCHES['rms_norm'] += 1
    return out


def rms_norm_bwd_reference(x: torch.Tensor, weight: torch.Tensor,
                           g: torch.Tensor, eps: float = 1e-6):
    """(dx, dweight) of `rms_norm_reference`, in its order of rounding:
    the weight product's gradients in x.dtype, then the normalisation's
    in fp32 (what `jax.grad` of the JAX model's `F.rms_norm` computes)."""
    width = x.shape[-1]
    xf = x.float()
    inv = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    normed = (xf * inv).to(x.dtype)
    dw = (g * normed).reshape(-1, width).sum(dim=0)
    dn = (g * weight).float()
    dx = inv * dn - xf * (inv ** 3 / width) * (dn * xf).sum(dim=-1,
                                                           keepdim=True)
    return dx.to(x.dtype), dw.to(weight.dtype)


class RMSNormFunction(torch.autograd.Function):
    """Differentiable RMSNorm: the forward kernel, and the plain backward
    (the JAX model differentiates its RMSNorm with XLA, not a kernel)."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return rms_norm_fwd(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd_reference(x, weight, g, ctx.eps)
        return dx, dw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim of x, differentiable when a gradient is
    needed (`RMSNormFunction`), else the forward kernel alone."""
    if _needs_grad(x, weight):
        return RMSNormFunction.apply(x, weight, eps)
    return rms_norm_fwd(x, weight, eps)


# ---------------------------------------------------------------------------
# flash attention forward
# ---------------------------------------------------------------------------

def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        causal: bool = False, return_lse: bool = False,
                        seqused_k: Optional[torch.Tensor] = None):
    """Plain version, the JAX package's `_attention_xla` in torch.

    q [B, Sq, H, D], k/v [B, Sk, HKV, D]. GQA repeats kv heads as
    [HKV, G]; logits and softmax in fp32; the causal mask is aligned
    bottom-right; probabilities are cast to q.dtype before PV. A boolean
    mask keeps True entries, another mask is added to the logits. With
    `return_lse` also returns the fp32 logsumexp of the logits [B, H, Sq].
    With `seqused_k` ([B] ints <= Sk, no mask) batch b attends to its
    first seqused_k[b] keys only, causal aligned at seqused_k[b] - Sq:
    each batch is this function on its sliced keys (rows past the count
    are never read). Reads the counts on the host."""
    if seqused_k is not None:
        if mask is not None:
            raise ValueError('attention_reference takes seqused_k or a '
                             'mask, not both')
        outs = [attention_reference(q[i:i + 1], k[i:i + 1, :n],
                                    v[i:i + 1, :n], causal=causal,
                                    return_lse=return_lse)
                for i, n in enumerate(seqused_k.tolist())]
        if return_lse:
            return (torch.cat([o for o, _ in outs]),
                    torch.cat([lse for _, lse in outs]))
        return torch.cat(outs)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) \
        * (1.0 / math.sqrt(d))
    if causal:
        idx_q = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        idx_k = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(idx_k > idx_q, NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, NEG_INF)
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum('bhqk,bkhd->bqhd', probs.to(q.dtype), v)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, return_lse: bool = False,
                        seqused_k: Optional[torch.Tensor] = None):
    """Attention over [B, S, H, D] (strided; the last dim contiguous).
    With `return_lse` returns (out, lse) with the fp32 logsumexp of each
    row's scaled logits as [B, H, Sq], the backward's residual. bf16
    runs on the tensor-core kernel, which needs 16-byte-aligned base
    pointers and strides; f32 on the FMA kernel.

    `seqused_k`, an int32 [B] tensor on q's device, gives each batch its
    key count (FlashAttention's seqused_k): batch b attends to keys
    [0, seqused_k[b]) of the Sk-row K/V buffers, causal aligned at
    seqused_k[b] - Sq. The kernel reads the counts on the device, so the
    call waits for nothing and replays in a CUDA graph at any counts;
    the caller keeps Sq <= seqused_k[b] <= Sk (causal) or
    1 <= seqused_k[b] <= Sk."""
    if _on_cpu(q, k, v, seqused_k):
        return attention_reference(q, k, v, causal=causal,
                                   return_lse=return_lse,
                                   seqused_k=seqused_k)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    _require(q.dtype in (torch.float32, torch.bfloat16)
             and k.dtype == q.dtype and v.dtype == q.dtype,
             'flash kernel takes q, k, v all f32 or all bf16')
    _require(d == _HEAD_DIM and k.shape[3] == d and v.shape[3] == d,
             f'flash kernel is built for head_dim {_HEAD_DIM}, got {d}')
    _require(k.shape[0] == b and tuple(v.shape) == tuple(k.shape)
             and hkv >= 1 and h % hkv == 0,
             f'flash shapes q {tuple(q.shape)} k {tuple(k.shape)} '
             f'v {tuple(v.shape)}')
    _require(q.stride(3) == 1 and k.stride(3) == 1 and v.stride(3) == 1,
             'flash kernel needs the head dim contiguous')
    _require(not causal or sq <= sk, 'causal flash needs sq <= sk')
    _require(q.dtype != torch.bfloat16 or _aligned16(q, k, v),
             'bf16 flash kernel needs 16-byte-aligned q, k, v base pointers '
             'and strides')
    _require(seqused_k is None
             or (seqused_k.dtype == torch.int32
                 and tuple(seqused_k.shape) == (b,)
                 and seqused_k.is_contiguous()),
             'flash seqused_k must be a contiguous int32 [B] tensor')
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    lib, fn = _entry('flash_attention', 'flash_attention_fwd')
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None,
            None if seqused_k is None else seqused_k.data_ptr(),
            b, sq, sk, h, hkv,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            1.0 / math.sqrt(d), int(bool(causal)), _DTYPE_CODE[q.dtype],
            _stream(q))
    _build.check(lib, rc, 'flash_attention_fwd')
    LAUNCHES['flash_attention_fwd'] += 1
    return (out, lse) if return_lse else out


# ---------------------------------------------------------------------------
# flash attention backward
# ---------------------------------------------------------------------------

def _bwd_terms(q, k, v, lse, dout, delta, causal):
    """P and dS of the FlashAttention-2 backward in fp32, [B, H, Sq, Sk],
    with K/V repeated over each GQA group: P = exp(S * scale - lse),
    dS = P * (dO V^T - delta) * scale."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    if hkv != h:
        kf = kf.repeat_interleave(h // hkv, dim=2)
        vf = vf.repeat_interleave(h // hkv, dim=2)
    scale = 1.0 / math.sqrt(d)
    qf, dof = q.float(), dout.float()
    s = torch.einsum('bqhd,bkhd->bhqk', qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        idx_q = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        idx_k = torch.arange(sk, device=q.device)[None, :]
        p = p.masked_fill(idx_k > idx_q, 0.0)
    dp = torch.einsum('bqhd,bkhd->bhqk', dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    return p, ds, qf, kf, dof


def _fold_group(t: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, Sk, H, D] per query head -> [B, Sk, HKV, D] summed over each
    kv head's group of H / HKV query heads."""
    b, sk, h, d = t.shape
    return t.reshape(b, sk, hkv, h // hkv, d).sum(dim=3)


def attention_bwd_dq_reference(q, k, v, out, lse, dout, causal=False):
    """Plain version of the dq kernel: (dq in q.dtype, delta [B, H, Sq]
    fp32 with delta = rowsum(dO * O))."""
    delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2)
    _, ds, _, kf, _ = _bwd_terms(q, k, v, lse, dout, delta, causal)
    dq = torch.einsum('bhqk,bkhd->bqhd', ds, kf)
    return dq.to(q.dtype), delta.contiguous()


def attention_bwd_dkv_reference(q, k, v, lse, delta, dout, causal=False):
    """Plain version of the dk/dv kernel: (dk, dv) per kv head, each
    summed over its query group, in k.dtype."""
    p, ds, qf, _, dof = _bwd_terms(q, k, v, lse, dout, delta, causal)
    hkv = k.shape[2]
    dk = _fold_group(torch.einsum('bhqk,bqhd->bkhd', ds, qf), hkv)
    dv = _fold_group(torch.einsum('bhqk,bqhd->bkhd', p, dof), hkv)
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_reference(q, k, v, out, lse, dout, causal=False):
    """Plain version of the flash backward: the FlashAttention-2
    arithmetic in torch, with P recomputed from the LSE. Returns
    (dq, dk, dv) in [B, S, H(KV), D] and the input dtype."""
    dq, delta = attention_bwd_dq_reference(q, k, v, out, lse, dout, causal)
    dk, dv = attention_bwd_dkv_reference(q, k, v, lse, delta, dout, causal)
    return dq, dk, dv


def _check_bwd(q, k, v, lse, dout, causal):
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    _require(q.dtype in (torch.float32, torch.bfloat16)
             and all(t.dtype == q.dtype for t in (k, v, dout)),
             'flash backward takes q, k, v, dout all f32 or all bf16')
    _require(d == _HEAD_DIM and k.shape[3] == d
             and tuple(v.shape) == tuple(k.shape) and k.shape[0] == b
             and hkv >= 1 and h % hkv == 0
             and tuple(dout.shape) == tuple(q.shape),
             f'flash backward shapes q {tuple(q.shape)} k {tuple(k.shape)} '
             f'v {tuple(v.shape)} dout {tuple(dout.shape)} (head_dim '
             f'{_HEAD_DIM})')
    _require(lse.dtype == torch.float32 and tuple(lse.shape) == (b, h, sq),
             'flash backward takes lse as f32 [B, H, Sq]')
    _require(all(t.is_contiguous() for t in (q, k, v, lse, dout)),
             'flash backward takes contiguous tensors')
    _require(not causal or sq <= sk, 'causal flash needs sq <= sk')


def flash_attention_bwd_dq(q, k, v, out, lse, dout, causal=False):
    """The dq kernel: (dq [B, Sq, H, D] in q.dtype, delta [B, H, Sq]
    fp32). Contiguous inputs; out and lse from `flash_attention_fwd`.
    bf16 runs on the tensor-core kernel (16-byte-aligned inputs), f32 on
    the FMA kernel."""
    if _on_cpu(q, k, v, out, lse, dout):
        return attention_bwd_dq_reference(q, k, v, out, lse, dout, causal)
    _check_bwd(q, k, v, lse, dout, causal)
    _require(tuple(out.shape) == tuple(q.shape) and out.dtype == q.dtype
             and out.is_contiguous(), 'flash backward: out like q')
    _require(q.dtype != torch.bfloat16 or _aligned16(q, k, v, out, dout),
             'bf16 dq kernel needs 16-byte-aligned q, k, v, out, dout base '
             'pointers')
    b, sq, h, _ = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq, delta
    lib, fn = _entry('flash_attention_bwd', 'flash_attention_bwd_dq')
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, sq, k.shape[1], h, k.shape[2], 1.0 / math.sqrt(q.shape[3]),
            int(bool(causal)), _DTYPE_CODE[q.dtype], _stream(q))
    _build.check(lib, rc, 'flash_attention_bwd_dq')
    LAUNCHES['flash_attention_bwd_dq'] += 1
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, lse, delta, dout, causal=False):
    """The dk/dv kernel: (dk, dv) [B, Sk, HKV, D] in k.dtype, each summed
    over its kv head's query group. `delta` comes from the dq kernel.
    bf16 runs on the tensor-core kernel (16-byte-aligned inputs), f32 on
    the FMA kernel."""
    if _on_cpu(q, k, v, lse, delta, dout):
        return attention_bwd_dkv_reference(q, k, v, lse, delta, dout,
                                           causal)
    _check_bwd(q, k, v, lse, dout, causal)
    _require(delta.dtype == torch.float32 and delta.shape == lse.shape
             and delta.is_contiguous(),
             'flash backward takes delta as f32 [B, H, Sq]')
    _require(q.dtype != torch.bfloat16 or _aligned16(q, k, v, dout),
             'bf16 dk/dv kernel needs 16-byte-aligned q, k, v, dout base '
             'pointers')
    b, sq, h, _ = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0 or sq == 0:
        return dk.zero_(), dv.zero_()
    lib, fn = _entry('flash_attention_bwd', 'flash_attention_bwd_dkv')
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sq, k.shape[1], h, k.shape[2], 1.0 / math.sqrt(q.shape[3]),
            int(bool(causal)), _DTYPE_CODE[q.dtype], _stream(q))
    _build.check(lib, rc, 'flash_attention_bwd_dkv')
    LAUNCHES['flash_attention_bwd_dkv'] += 1
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, causal=False):
    """(dq, dk, dv) of flash attention, [B, S, H(KV), D] in the input
    dtype: the dq kernel (which also computes delta), then the dk/dv
    kernel. Contiguous inputs."""
    dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, dout, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, lse, delta, dout, causal)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention over [B, S, H, D] (counterpart of
    the JAX package's `flash_attention_own` custom VJP): the forward
    kernel with its LSE, and the two backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_fwd(q, k, v, causal, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """Flash attention over [B, S, H, D]: differentiable through
    `FlashAttention` when a gradient is needed, else the forward kernel
    alone (no LSE written)."""
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal)
    return flash_attention_fwd(q, k, v, causal)


# ---------------------------------------------------------------------------
# paged attention (decode)
# ---------------------------------------------------------------------------

def paged_attention_reference(q, k_pages, v_pages, table, lengths, *,
                              k_scales=None, v_scales=None, sm_scale=None,
                              k_win=None, v_win=None, win_first=None):
    """Plain version, the JAX package's `paged_attention_reference` in
    torch: gather every page of the table, dequantize, masked attend.

    q [N, H, D]; k/v_pages [num_pages, ps, HKV, D]; table [N, P] int32;
    lengths [N] int32; k/v_scales [num_pages, HKV] f32 for int8 pages.
    With the window k/v_win [N, W, ps, HKV, D] and win_first [N] int32,
    logical page i of slot n with win_first[n] <= i < win_first[n] + W
    is read from the window (no scale) in place of its page. A slot with
    length 0 gets the uniform average of its gathered pages."""
    n, h, d = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    p = table.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    idx = table.long()
    k = k_pages[idx].float()                  # [N, P, ps, HKV, D]
    v = v_pages[idx].float()
    if k_scales is not None:
        k = k * k_scales[idx][:, :, None, :, None]
    if v_scales is not None:
        v = v * v_scales[idx][:, :, None, :, None]
    if k_win is not None:
        # window pages past the table go to a spare page P, dropped after
        w = k_win.shape[1]
        at = win_first.long()[:, None] + torch.arange(w, device=q.device)
        at = torch.where(at < p, at, p)
        rows = torch.arange(n, device=q.device)[:, None]
        k = torch.cat([k, k[:, :1]], dim=1)
        v = torch.cat([v, v[:, :1]], dim=1)
        k[rows, at] = k_win.float()
        v[rows, at] = v_win.float()
        k, v = k[:, :p], v[:, :p]
    k = k.reshape(n, p * ps, hkv, d)
    v = v.reshape(n, p * ps, hkv, d)
    g = h // hkv
    qf = q.float().reshape(n, hkv, g, d) * sm_scale
    s = torch.einsum('nkgd,nskd->nkgs', qf, k)
    live = torch.arange(p * ps, device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~live[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum('nkgs,nskd->nkgd', w, v)
    return o.reshape(n, h, d).to(q.dtype)


def paged_split(p: int, ps: int):
    """(pages per split, splits) of the paged kernel for a table of `p`
    pages of `ps` rows: each split holds at most PAGED_SPLIT_KEYS keys,
    and the count comes from the table's width, never from the lengths."""
    pps = max(1, PAGED_SPLIT_KEYS // ps)
    return pps, -(-p // pps)


def paged_attention(q, k_pages, v_pages, table, lengths, *, k_scales=None,
                    v_scales=None, sm_scale=None, k_win=None, v_win=None,
                    win_first=None):
    """Decode attention over a page-table KV pool (shapes as in
    `paged_attention_reference`). On the card a slot with length 0
    computes its first page only (finite, meaningless: callers mask
    such slots), where the plain version averages all its pages. The
    kernel splits each slot's context into runs of at most
    PAGED_SPLIT_KEYS keys (`paged_split`) and combines them in a second
    kernel, over an fp32 workspace it takes from the caching allocator;
    it takes pages of at most PAGED_SPLIT_KEYS rows.

    Over int8 pages a decode round passes its float window (k/v_win in
    q.dtype, win_first int32 on the device): the int8 splits skip the
    window's pages, and one more split per (slot, kv head) attends the
    window's W * ps <= PAGED_SPLIT_KEYS rows, so each split reads one
    dtype. The call counts once."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError('pass both k_scales and v_scales or neither')
    window = (k_win, v_win, win_first)
    if any(t is None for t in window) != all(t is None for t in window):
        raise ValueError('pass k_win, v_win and win_first together or none')
    if k_win is not None and k_scales is None:
        raise ValueError('the float window is read over int8 pages only')
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _on_cpu(q, k_pages, v_pages, table, lengths, k_scales, v_scales,
               k_win, v_win, win_first):
        return paged_attention_reference(
            q, k_pages, v_pages, table, lengths, k_scales=k_scales,
            v_scales=v_scales, sm_scale=sm_scale, k_win=k_win, v_win=v_win,
            win_first=win_first)
    n, h, d = q.shape
    num_pages, ps, hkv = k_pages.shape[:3]
    p = table.shape[1]
    quant = k_scales is not None
    w = 0 if k_win is None else k_win.shape[1]
    _require(q.dtype in (torch.float32, torch.bfloat16),
             f'paged kernel takes an f32 or bf16 query, got {q.dtype}')
    _require(k_pages.dtype == v_pages.dtype
             and k_pages.dtype == (torch.int8 if quant else q.dtype),
             'paged kernel takes pages in q.dtype, or int8 with scales')
    _require(d == _HEAD_DIM and k_pages.shape[3] == d
             and tuple(v_pages.shape) == tuple(k_pages.shape),
             f'paged kernel is built for head_dim {_HEAD_DIM}, got '
             f'q {tuple(q.shape)} pages {tuple(k_pages.shape)}')
    _require(hkv >= 1 and h % hkv == 0 and h // hkv <= _MAX_GROUP,
             f'paged kernel takes at most {_MAX_GROUP} query heads per kv '
             f'head, got H={h} HKV={hkv}')
    _require(table.dtype == torch.int32 and lengths.dtype == torch.int32
             and tuple(table.shape) == (n, p) and tuple(lengths.shape) == (n,),
             'table [N, P] and lengths [N] must be int32')
    if quant:
        _require(k_scales.dtype == torch.float32
                 and v_scales.dtype == torch.float32
                 and tuple(k_scales.shape) == (num_pages, hkv)
                 and tuple(v_scales.shape) == (num_pages, hkv),
                 'scales must be f32 [num_pages, HKV]')
    if w:
        _require(k_win.dtype == q.dtype and v_win.dtype == q.dtype
                 and tuple(k_win.shape) == (n, w, ps, hkv, d)
                 and tuple(v_win.shape) == (n, w, ps, hkv, d)
                 and win_first.dtype == torch.int32
                 and tuple(win_first.shape) == (n,),
                 'the window must be [N, W, ps, HKV, D] in q.dtype, with '
                 'win_first int32 [N]')
        _require(w * ps <= PAGED_SPLIT_KEYS,
                 f'the window holds at most {PAGED_SPLIT_KEYS} rows, got '
                 f'W={w} pages of {ps}')
    _require(1 <= ps <= PAGED_SPLIT_KEYS and p >= 1,
             f'paged kernel takes pages of 1..{PAGED_SPLIT_KEYS} rows and a '
             f'table of >= 1 page, got ps={ps} P={p}')
    tensors = [q, k_pages, v_pages, table, lengths] + (
        [k_scales, v_scales] if quant else []) + (
        [k_win, v_win, win_first] if w else [])
    _require(all(t.is_contiguous() for t in tensors),
             'paged kernel takes contiguous tensors')
    _require(_aligned16(k_pages, v_pages, *([k_win, v_win] if w else [])),
             'paged kernel needs 16-byte-aligned page pools and windows')
    out = torch.empty_like(q)
    if n == 0:
        return out
    pps, splits = paged_split(p, ps)
    ws = torch.empty((n, hkv, splits + (1 if w else 0), h // hkv, d + 2),
                     dtype=torch.float32, device=q.device)
    lib, fn = _entry('paged_attention', 'paged_attention_fwd')
    ptr = (lambda t: None if t is None else t.data_ptr())
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), lengths.data_ptr(), ptr(k_scales),
            ptr(v_scales), ptr(k_win), ptr(v_win), ptr(win_first),
            ws.data_ptr(), out.data_ptr(), n, h, hkv, p, ps, pps, splits, w,
            float(sm_scale), _DTYPE_CODE[q.dtype],
            _DTYPE_CODE[k_pages.dtype], _stream(q))
    _build.check(lib, rc, 'paged_attention_fwd')
    LAUNCHES['paged_attention'] += 1
    return out


# ---------------------------------------------------------------------------
# fused softmax cross-entropy
# ---------------------------------------------------------------------------

def softmax_cross_entropy_fwd_reference(logits: torch.Tensor,
                                        labels: torch.Tensor):
    """Plain version of the CE forward: (nll [N], lse [N]) in fp32. A
    label outside [0, V) has no target logit (nll = lse)."""
    v = logits.shape[-1]
    xf = logits.float()
    lse = torch.logsumexp(xf, dim=-1)
    lab = labels.long()
    hit = (lab >= 0) & (lab < v)
    target = xf.gather(1, lab.clamp(0, max(v - 1, 0))[:, None])[:, 0]
    return lse - torch.where(hit, target, 0.0), lse


def softmax_cross_entropy_bwd_reference(logits, labels, lse, g):
    """Plain version of the CE backward: (softmax - onehot) * g in fp32,
    in the logits dtype."""
    xf = logits.float()
    cols = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (cols[None, :] == labels.long()[:, None]).float()
    dx = (torch.exp(xf - lse[:, None]) - onehot) * g[:, None]
    return dx.to(logits.dtype)


def _check_ce(logits, labels):
    _require(logits.dim() == 2 and logits.shape[1] >= 1,
             f'CE kernel takes logits [N, V >= 1], got {tuple(logits.shape)}')
    n, v = logits.shape
    _require(logits.dtype in (torch.float32, torch.bfloat16),
             f'CE kernel takes f32 or bf16 logits, got {logits.dtype}')
    _require(labels.dtype == torch.int32 and tuple(labels.shape) == (n,),
             'CE kernel takes labels as int32 [N]')
    _require(logits.is_contiguous() and labels.is_contiguous(),
             'CE kernel takes contiguous logits and labels')
    return n, v


def _rows_aligned(v: int, *tensors) -> bool:
    """Every row of these [N, V] tensors starts 16-byte aligned and holds
    a whole number of 8-element vectors (the kernels' wide loads)."""
    return v % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def softmax_cross_entropy_fwd(logits: torch.Tensor, labels: torch.Tensor):
    """(nll [N] f32, lse [N] f32) for contiguous logits [N, V] and int32
    labels [N], reading the logits once."""
    if _on_cpu(logits, labels):
        return softmax_cross_entropy_fwd_reference(logits, labels)
    n, v = _check_ce(logits, labels)
    nll = torch.empty(n, dtype=torch.float32, device=logits.device)
    lse = torch.empty(n, dtype=torch.float32, device=logits.device)
    if n == 0:
        return nll, lse
    lib, fn = _entry('cross_entropy', 'softmax_ce_fwd')
    rc = fn(logits.data_ptr(), labels.data_ptr(), nll.data_ptr(),
            lse.data_ptr(), n, v, int(_rows_aligned(v, logits)),
            _DTYPE_CODE[logits.dtype], _stream(logits))
    _build.check(lib, rc, 'softmax_ce_fwd')
    LAUNCHES['softmax_ce_fwd'] += 1
    return nll, lse


def softmax_cross_entropy_bwd(logits, labels, lse, g):
    """dlogits [N, V] in the logits dtype: (softmax - onehot) * g, with
    lse from the forward and g [N] f32."""
    if _on_cpu(logits, labels, lse, g):
        return softmax_cross_entropy_bwd_reference(logits, labels, lse, g)
    n, v = _check_ce(logits, labels)
    _require(all(t.dtype == torch.float32 and tuple(t.shape) == (n,)
                 and t.is_contiguous() for t in (lse, g)),
             'CE backward takes lse and g as contiguous f32 [N]')
    dx = torch.empty_like(logits)
    if n == 0:
        return dx
    lib, fn = _entry('cross_entropy', 'softmax_ce_bwd')
    rc = fn(logits.data_ptr(), labels.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dx.data_ptr(), n, v,
            int(_rows_aligned(v, logits, dx)), _DTYPE_CODE[logits.dtype],
            _stream(logits))
    _build.check(lib, rc, 'softmax_ce_bwd')
    LAUNCHES['softmax_ce_bwd'] += 1
    return dx


class SoftmaxCrossEntropy(torch.autograd.Function):
    """Differentiable fused CE, per-row nll [N] of logits [N, V]
    (counterpart of the JAX package's `softmax_cross_entropy` custom
    VJP). The residuals are the logits and the fp32 lse: no fp32 [N, V]
    buffer exists; the backward recomputes the softmax."""

    @staticmethod
    def forward(ctx, logits, labels):
        nll, lse = softmax_cross_entropy_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return softmax_cross_entropy_bwd(
            logits, labels, lse, g.float().contiguous()), None


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Per-row nll [N] of contiguous logits [N, V] for int32 labels [N],
    differentiable in the logits."""
    return SoftmaxCrossEntropy.apply(logits, labels)


# ---------------------------------------------------------------------------
# segmented adapter (LoRA) matmul
# ---------------------------------------------------------------------------

def adapter_matmul_reference(x, a_bank, b_bank, rows, scale):
    """Plain version, the JAX package's `adapter_matmul_reference` in
    torch, in its order: x, the gathered factors and the scale in fp32,
    h1 = x A, out = h1 B, times scale[rows[b]], cast to x.dtype.

    x [B, T, H]; a_bank [C, H, R]; b_bank [C, R, O]; rows [B] (bank slot
    of each row; slot 0 is the zero base adapter); scale [C] f32.
    Returns the [B, T, O] delta in x.dtype."""
    idx = rows.long()
    a = a_bank[idx].float()                       # [B, H, R]
    b = b_bank[idx].float()                       # [B, R, O]
    s = scale[idx].float()                        # [B]
    h1 = torch.einsum('bth,bhr->btr', x.float(), a)
    out = torch.einsum('btr,bro->bto', h1, b)
    return (out * s[:, None, None]).to(x.dtype)


def adapter_matmul_add_reference(y, x, a_bank, b_bank, rows, scale):
    """Plain version of `adapter_matmul_add`: y plus the delta rounded to
    x.dtype, added in y's dtype (the JAX hook's `y + Tensor(delta)`)."""
    return y + adapter_matmul_reference(x, a_bank, b_bank, rows,
                                        scale).reshape(y.shape)


_ADAPTER_DTYPES = (torch.float32, torch.bfloat16)


def _adapter_dims(x, a_bank, b_bank, rows, scale) -> tuple:
    """(B, T, H, C, R, O) of an adapter call; raises on shapes the
    function does not take. Messages are built only when a check fails:
    the hook calls this 128 times per decode sub-step."""
    if x.dim() != 3 or a_bank.dim() != 3 or b_bank.dim() != 3:
        raise ValueError('adapter_matmul takes x [B, T, H], a_bank [C, H, R]'
                         ' and b_bank [C, R, O]')
    bsz, t, h = x.shape
    c, ah, r = a_bank.shape
    bc, br, o = b_bank.shape
    if not (ah == h and bc == c and br == r and c >= 1
            and rows.shape == (bsz,) and scale.shape == (c,)):
        raise ValueError(
            f'adapter_matmul shapes x {tuple(x.shape)} a_bank '
            f'{tuple(a_bank.shape)} b_bank {tuple(b_bank.shape)} rows '
            f'{tuple(rows.shape)} scale {tuple(scale.shape)}')
    if not 1 <= r <= ADAPTER_MAX_RANK:
        raise ValueError(f'adapter kernel takes a rank of '
                         f'1..{ADAPTER_MAX_RANK}, got {r}')
    return bsz, t, h, c, r, o


def _adapter_launch(x, a_bank, b_bank, rows, scale, y, out, dims) -> None:
    """Check what the kernel takes and launch it: out = delta (y None) or
    y + delta. One launch, counted once."""
    bsz, t, h, c, r, o = dims
    if not (x.dtype in _ADAPTER_DTYPES and a_bank.dtype in _ADAPTER_DTYPES
            and b_bank.dtype == a_bank.dtype):
        raise ValueError(f'adapter kernel takes x and the bank in f32 or '
                         f'bf16, got {x.dtype}, {a_bank.dtype}, '
                         f'{b_bank.dtype}')
    if rows.dtype != torch.int32 or scale.dtype != torch.float32:
        raise ValueError('adapter kernel takes rows int32 and scale f32')
    if not (x.is_contiguous() and a_bank.is_contiguous()
            and b_bank.is_contiguous() and rows.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError('adapter kernel takes contiguous tensors')
    if bsz > ADAPTER_MAX_BATCH:
        raise ValueError(f'adapter kernel takes at most {ADAPTER_MAX_BATCH} '
                         f'rows, got {bsz}')
    if out.numel() == 0:
        return
    lib, fn = _entry('adapter_matmul', 'adapter_matmul_fwd')
    rc = fn(x.data_ptr(), a_bank.data_ptr(), b_bank.data_ptr(),
            rows.data_ptr(), scale.data_ptr(),
            None if y is None else y.data_ptr(), out.data_ptr(), bsz, t, h,
            r, o, c, _DTYPE_CODE[x.dtype], _DTYPE_CODE[a_bank.dtype],
            _stream(x))
    _build.check(lib, rc, 'adapter_matmul_fwd')
    LAUNCHES['adapter_matmul'] += 1


def adapter_matmul(x, a_bank, b_bank, rows, scale):
    """Per-row LoRA delta over a packed adapter bank (shapes as in
    `adapter_matmul_reference`; the JAX package's signature). The kernel
    reads each row's slot on the device and groups the rows by slot. It
    takes x and the bank in f32 or bf16 (independently), rows int32 in
    [0, C) (outside it the row's delta is NaN), scale f32, all
    contiguous, a rank of at most ADAPTER_MAX_RANK and at most
    ADAPTER_MAX_BATCH rows."""
    dims = _adapter_dims(x, a_bank, b_bank, rows, scale)
    if _on_cpu(x, a_bank, b_bank, rows, scale):
        return adapter_matmul_reference(x, a_bank, b_bank, rows, scale)
    bsz, t, _, _, _, o = dims
    out = torch.empty((bsz, t, o), dtype=x.dtype, device=x.device)
    _adapter_launch(x, a_bank, b_bank, rows, scale, None, out, dims)
    return out


def adapter_matmul_add(y, x, a_bank, b_bank, rows, scale):
    """A new tensor y + adapter_matmul(x, a_bank, b_bank, rows, scale), the
    delta rounded to x.dtype before the add, from one kernel pass. y is
    the projection's output: x.dtype, [B, T, O] (or [B, O] when T = 1),
    contiguous on the card. The result has y's shape."""
    dims = _adapter_dims(x, a_bank, b_bank, rows, scale)
    bsz, t, _, _, _, o = dims
    if y.dtype != x.dtype or not (y.shape == (bsz, t, o)
                                  or (t == 1 and y.shape == (bsz, o))):
        raise ValueError(f'adapter_matmul_add takes y in x.dtype '
                         f'{x.dtype} as [{bsz}, {t}, {o}] (or [{bsz}, {o}] '
                         f'for one token), got {y.dtype} {tuple(y.shape)}')
    if _on_cpu(y, x, a_bank, b_bank, rows, scale):
        return adapter_matmul_add_reference(y, x, a_bank, b_bank, rows,
                                            scale)
    if not y.is_contiguous():
        raise ValueError('adapter_matmul_add takes a contiguous y')
    out = torch.empty_like(y)
    _adapter_launch(x, a_bank, b_bank, rows, scale, y, out, dims)
    return out


# ---------------------------------------------------------------------------
# multi-tensor optimizer update (Adam/AdamW) and sum of squares
# ---------------------------------------------------------------------------

MT_CHUNK = 16384              # elements per block (csrc: kChunk)
MT_ADAM_MAX_TENSORS = 48      # tensors per update launch (kAdamMaxTensors)
MT_SUMSQ_MAX_TENSORS = 96     # tensors per sum-of-squares launch
_MT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_MOMENT_DTYPES = (torch.float32, torch.bfloat16)
_DECAY_MODES = {'l2': 0, 'l1': 1, 'decoupled': 2}


def mt_batches(numels, max_tensors: int) -> list:
    """The launches of a multi-tensor kernel over tensors of these element
    counts: [(indices, first chunks)], at most `max_tensors` tensors each,
    empty tensors left out; first chunks[j] is the first block of the j-th
    tensor of the launch and first chunks[-1] the launch's block count.
    Computed from shapes alone, so building it reads nothing from the
    device."""
    launches, idx, first = [], [], [0]
    for i, n in enumerate(numels):
        if n == 0:
            continue
        idx.append(i)
        first.append(first[-1] + -(-n // MT_CHUNK))
        if len(idx) == max_tensors:
            launches.append((idx, first))
            idx, first = [], [0]
    if idx:
        launches.append((idx, first))
    return launches


def _mt_check(tensors, what: str) -> None:
    """The multi-tensor kernels take contiguous fp32/bf16/fp16 tensors
    whose storage starts 16-byte aligned (their 16-byte vectors)."""
    for t in tensors:
        _require(t.dtype in _MT_DTYPES,
                 f'{what} takes fp32, bf16 or fp16 tensors, got {t.dtype}')
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 f'{what} takes contiguous tensors that start 16-byte '
                 f'aligned (got a view at {t.data_ptr() % 16} bytes past '
                 f'an aligned address, or a strided one)')


def _c_array(ctype, values):
    return (ctype * len(values))(*values)


def multi_tensor_sumsq_reference(tensors) -> torch.Tensor:
    """Plain version: the sum of squares of every element, each tensor
    summed in fp32, then the tensors' sums in order (the JAX clip's
    `sum(jnp.sum(jnp.square(g.astype(f32))) for g in leaves)`)."""
    total = torch.zeros((), dtype=torch.float32,
                        device=tensors[0].device if tensors else 'cpu')
    for t in tensors:
        total = total + t.float().square().sum()
    return total


def multi_tensor_sumsq(tensors) -> torch.Tensor:
    """The sum of squares over every element of `tensors`, accumulated in
    fp32, as a 0-d fp32 tensor on their device; on the card the value is
    never read by the host. An empty list gives a CPU zero."""
    tensors = list(tensors)
    if not tensors or _on_cpu(*tensors):
        return multi_tensor_sumsq_reference(tensors)
    _mt_check(tensors, 'multi_tensor_sumsq')
    dev = tensors[0].device
    launches = mt_batches([t.numel() for t in tensors], MT_SUMSQ_MAX_TENSORS)
    blocks = sum(first[-1] for _, first in launches)
    partial = torch.empty(max(blocks, 1), dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    stream = _stream(out)
    lib, fn = _entry('multi_tensor_adam', 'multi_tensor_sumsq_partial')
    offset = partial.data_ptr()
    for idx, first in launches:
        ts = [tensors[i] for i in idx]
        ptrs = _c_array(_P, [t.data_ptr() for t in ts])
        numel = _c_array(_L, [t.numel() for t in ts])
        codes = _c_array(_I, [_DTYPE_CODE[t.dtype] for t in ts])
        starts = _c_array(_I, first)
        rc = fn(len(ts), ctypes.addressof(ptrs), ctypes.addressof(numel),
                ctypes.addressof(codes), ctypes.addressof(starts), offset,
                stream)
        _build.check(lib, rc, 'multi_tensor_sumsq')
        LAUNCHES['multi_tensor_sumsq'] += 1
        offset += first[-1] * 4
    _, finish = _entry('multi_tensor_adam', 'multi_tensor_sumsq_finish')
    _build.check(lib, finish(partial.data_ptr(), blocks, out.data_ptr(),
                             stream), 'multi_tensor_sumsq (finish)')
    return out


@torch.no_grad()
def multi_tensor_adam_reference(params, grads, m, v, masters, vmax, *, lr_t,
                                beta1, beta2, epsilon, decay, decay_mode,
                                clip_scale=None) -> None:
    """Plain version: Paddle's Adam step of each tensor in turn, in place,
    as the JAX package's `_leaf_apply` + `Adam._rule` compute it: the grad
    in fp32 (scaled by `clip_scale` and rounded back to its dtype first, as
    the JAX clip leaves it), L2 (`coeff * p`) or L1 (`coeff * sign(p)`)
    decay added to it, m and v updated in fp32 and stored in their dtype,
    the step from the fp32 values, decoupled decay `p - decay * p` with
    `decay` = lr * coeff and p from before the step."""
    for p, g, m_i, v_i, master, vm, coeff in zip(params, grads, m, v,
                                                 masters, vmax, decay):
        p32 = master if master is not None else p.float()
        g32 = g.float()
        if clip_scale is not None:
            g32 = (g32 * clip_scale).to(g.dtype).float()
        if coeff and decay_mode != 'decoupled':
            g32 = g32 + (p32.sign() if decay_mode == 'l1' else p32) * coeff
        m32 = m_i.float() * beta1 + g32 * (1 - beta1)
        v32 = v_i.float() * beta2 + g32.square() * (1 - beta2)
        m_i.copy_(m32)
        v_i.copy_(v32)
        if vm is not None:
            v32 = torch.maximum(vm.float(), v32)
            vm.copy_(v32)
        new = p32 - (m32 * float(lr_t)) / (v32.sqrt() + epsilon)
        if coeff and decay_mode == 'decoupled':
            new = new - p32 * coeff
        if master is not None:
            master.copy_(new)
        p.copy_(new)


def multi_tensor_adam(params, grads, m, v, masters=None, vmax=None, *,
                      lr_t, beta1, beta2, epsilon, decay, decay_mode,
                      clip_scale=None) -> None:
    """One Paddle Adam/AdamW step of every tensor in the lists, in place.

    params, grads, m, v: equal-length lists (grads in the params' dtypes;
    m and v fp32 or bf16). masters: fp32 master copies or None entries (or
    None); vmax: amsgrad's running max of v, in m's dtype (or None).
    lr_t: the bias-corrected step size in fp32; decay: one coefficient per
    tensor, for 'decoupled' already lr * coeff rounded to fp32;
    decay_mode: 'l2', 'l1' or 'decoupled'; clip_scale: None or a 0-d fp32
    tensor on the params' device (the global-norm clip's scale). On the
    card one launch covers up to MT_ADAM_MAX_TENSORS tensors of one (param
    dtype, moment dtype, master, amsgrad) group; a tensor the kernel cannot
    take raises."""
    n = len(params)
    masters = [None] * n if masters is None else list(masters)
    vmax = [None] * n if vmax is None else list(vmax)
    decay = [float(c) for c in decay]
    _require(all(len(x) == n for x in (grads, m, v, masters, vmax, decay)),
             'multi_tensor_adam: lists of unequal length')
    _require(decay_mode in _DECAY_MODES,
             f'multi_tensor_adam: decay_mode {decay_mode!r}')
    if n == 0:
        return
    held = [t for ts in (params, grads, m, v, masters, vmax) for t in ts
            if t is not None]
    if _on_cpu(*held, clip_scale):
        return multi_tensor_adam_reference(
            params, grads, m, v, masters, vmax, lr_t=lr_t, beta1=beta1,
            beta2=beta2, epsilon=epsilon, decay=decay, decay_mode=decay_mode,
            clip_scale=clip_scale)
    _mt_check(held, 'multi_tensor_adam')
    _require(clip_scale is None or (clip_scale.dtype == torch.float32
                                    and clip_scale.numel() == 1),
             'multi_tensor_adam: clip_scale must be one fp32 element')
    groups = {}
    for i, p in enumerate(params):
        same = [grads[i], m[i], v[i]] + [t for t in (masters[i], vmax[i])
                                         if t is not None]
        _require(all(t.numel() == p.numel() for t in same),
                 f'multi_tensor_adam: tensor {i}: sizes differ')
        _require(grads[i].dtype == p.dtype,
                 f'multi_tensor_adam: tensor {i}: grad {grads[i].dtype} vs '
                 f'param {p.dtype}')
        _require(m[i].dtype in _MOMENT_DTYPES and v[i].dtype == m[i].dtype
                 and (vmax[i] is None or vmax[i].dtype == m[i].dtype),
                 f'multi_tensor_adam: tensor {i}: moments must share one '
                 f'dtype, fp32 or bf16')
        _require(masters[i] is None or masters[i].dtype == torch.float32,
                 f'multi_tensor_adam: tensor {i}: the master must be fp32')
        key = (p.dtype, m[i].dtype, masters[i] is not None,
               vmax[i] is not None)
        groups.setdefault(key, []).append(i)
    lib, fn = _entry('multi_tensor_adam', 'multi_tensor_adam')
    stream = _stream(params[0])
    scale_ptr = None if clip_scale is None else clip_scale.data_ptr()
    for (p_dtype, m_dtype, has_master, ams), idx in groups.items():
        for sel, first in mt_batches([params[i].numel() for i in idx],
                                     MT_ADAM_MAX_TENSORS):
            sel = [idx[j] for j in sel]
            ptrs = _c_array(_P, [
                None if t is None else t.data_ptr() for i in sel
                for t in (params[i], grads[i], m[i], v[i], masters[i],
                          vmax[i])])
            numel = _c_array(_L, [params[i].numel() for i in sel])
            starts = _c_array(_I, first)
            coeffs = _c_array(_F, [decay[i] for i in sel])
            rc = fn(len(sel), ctypes.addressof(ptrs), ctypes.addressof(numel),
                    ctypes.addressof(starts), ctypes.addressof(coeffs),
                    float(lr_t), float(beta1), float(beta2),
                    float(1 - beta1), float(1 - beta2), float(epsilon),
                    _DECAY_MODES[decay_mode], scale_ptr,
                    _DTYPE_CODE[p_dtype], _DTYPE_CODE[m_dtype],
                    int(has_master), int(ams), stream)
            _build.check(lib, rc, 'multi_tensor_adam')
            LAUNCHES['multi_tensor_adam'] += 1
