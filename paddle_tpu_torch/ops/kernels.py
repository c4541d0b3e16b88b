"""The port's kernels: wrappers, plain versions and launch counts.

Counterpart of `paddle_tpu/ops/pallas_kernels.py`. Each TPU kernel on
the serving path has a hand-written Hopper kernel here (CUDA C++ under
`paddle_tpu_torch/csrc/`, built by `ops/_build.py`):

- `flash_attention_fwd` replaces `_flash_fwd_kernel`,
- `paged_attention` replaces `_paged_attn_kernel`,
- `rms_norm` replaces `_rms_fwd_kernel`.

Beside each wrapper sits its plain PyTorch version (`*_reference`), the
same function written as tensor code. A wrapper takes the plain version
only for tensors that lie on the CPU, which is how the CPU tests run;
for a CUDA tensor it launches its kernel or raises, and never falls
back. `LAUNCHES` counts kernel launches, one per launch and nowhere
else, so a run can show that its path went through the kernels.

Each CUDA source starts with a note: the TPU kernel it replaces, what
bounds it on the H100, and what its design does about that.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

# the JAX package's masked-logit value (jnp.finfo(float32).min)
NEG_INF = torch.finfo(torch.float32).min

LAUNCHES = {'flash_attention_fwd': 0, 'paged_attention': 0, 'rms_norm': 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIM = 128          # the kernels are compiled for D = 128
_MAX_GROUP = 8           # paged kernel: query heads per kv head, at most

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = {
    'rms_norm_fwd': [_P, _P, _P, _I, _I, _F, _I, _P],
    'flash_attention_fwd': [_P, _P, _P, _P, _I, _I, _I, _I, _I]
    + [_L] * 12 + [_F, _I, _I, _P],
    'paged_attention_fwd': [_P] * 8 + [_I] * 5 + [_F, _I, _I, _P],
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim of x (any leading shape), weight [width]."""
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


# ---------------------------------------------------------------------------
# flash attention forward
# ---------------------------------------------------------------------------

def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        causal: bool = False) -> torch.Tensor:
    """Plain version, the JAX package's `_attention_xla` in torch.

    q [B, Sq, H, D], k/v [B, Sk, HKV, D]. GQA repeats kv heads as
    [HKV, G]; logits and softmax in fp32; the causal mask is aligned
    bottom-right; probabilities are cast to q.dtype before PV. A boolean
    mask keeps True entries, another mask is added to the logits."""
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
    return torch.einsum('bhqk,bkhd->bqhd', probs.to(q.dtype), v)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Attention over [B, S, H, D] (strided; the last dim contiguous)."""
    if _on_cpu(q, k, v):
        return attention_reference(q, k, v, causal=causal)
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
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib, fn = _entry('flash_attention', 'flash_attention_fwd')
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, h, hkv,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            1.0 / math.sqrt(d), int(bool(causal)), _DTYPE_CODE[q.dtype],
            _stream(q))
    _build.check(lib, rc, 'flash_attention_fwd')
    LAUNCHES['flash_attention_fwd'] += 1
    return out


# ---------------------------------------------------------------------------
# paged attention (decode)
# ---------------------------------------------------------------------------

def paged_attention_reference(q, k_pages, v_pages, table, lengths, *,
                              k_scales=None, v_scales=None, sm_scale=None):
    """Plain version, the JAX package's `paged_attention_reference` in
    torch: gather every page of the table, dequantize, masked attend.

    q [N, H, D]; k/v_pages [num_pages, ps, HKV, D]; table [N, P] int32;
    lengths [N] int32; k/v_scales [num_pages, HKV] f32 for int8 pages.
    A slot with length 0 gets the uniform average of its gathered pages."""
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


def paged_attention(q, k_pages, v_pages, table, lengths, *, k_scales=None,
                    v_scales=None, sm_scale=None):
    """Decode attention over a page-table KV pool (shapes as in
    `paged_attention_reference`). On the card a slot with length 0
    computes its first page only (finite, meaningless: callers mask
    such slots), where the plain version averages all its pages."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError('pass both k_scales and v_scales or neither')
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _on_cpu(q, k_pages, v_pages, table, lengths, k_scales, v_scales):
        return paged_attention_reference(
            q, k_pages, v_pages, table, lengths, k_scales=k_scales,
            v_scales=v_scales, sm_scale=sm_scale)
    n, h, d = q.shape
    num_pages, ps, hkv = k_pages.shape[:3]
    p = table.shape[1]
    quant = k_scales is not None
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
    tensors = [q, k_pages, v_pages, table, lengths] + (
        [k_scales, v_scales] if quant else [])
    _require(all(t.is_contiguous() for t in tensors),
             'paged kernel takes contiguous tensors')
    out = torch.empty_like(q)
    if n == 0:
        return out
    lib, fn = _entry('paged_attention', 'paged_attention_fwd')
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), lengths.data_ptr(),
            k_scales.data_ptr() if quant else None,
            v_scales.data_ptr() if quant else None,
            out.data_ptr(), n, h, hkv, p, ps, float(sm_scale),
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype], _stream(q))
    _build.check(lib, rc, 'paged_attention_fwd')
    LAUNCHES['paged_attention'] += 1
    return out
