"""Dtype names of the port (counterpart of `paddle_tpu/dtype.py`).

Paddle's string names and their aliases map to torch dtypes;
`convert_dtype` (and its older name `to_torch_dtype`) accepts a name, a
torch dtype or a numpy dtype. 64-bit types stay 64-bit: the JAX package
narrows int64, float64 and complex128 to their 32-bit types only
because jax's x64 flag is off, a TPU artifact the port does not carry
(ROADMAP.md, "Differences that are not faults").
"""
from __future__ import annotations

import numpy as np
import torch

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_NAME_TO_DTYPE = {
    'float16': float16, 'fp16': float16, 'half': float16,
    'bfloat16': bfloat16, 'bf16': bfloat16,
    'float32': float32, 'fp32': float32, 'float': float32,
    'float64': float64, 'fp64': float64, 'double': float64,
    'int8': int8, 'int16': int16, 'int32': int32, 'int64': int64,
    'uint8': uint8, 'bool': bool_,
    'complex64': complex64, 'complex128': complex128,
}

# numpy's dtypes (bfloat16 has none) and back
_NUMPY = {np.dtype(np.float16): float16, np.dtype(np.float32): float32,
          np.dtype(np.float64): float64, np.dtype(np.int8): int8,
          np.dtype(np.int16): int16, np.dtype(np.int32): int32,
          np.dtype(np.int64): int64, np.dtype(np.uint8): uint8,
          np.dtype(np.bool_): bool_, np.dtype(np.complex64): complex64,
          np.dtype(np.complex128): complex128}


def convert_dtype(dtype):
    """A torch dtype from a Paddle name, a torch dtype or a numpy dtype
    (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        try:
            return _NAME_TO_DTYPE[dtype]
        except KeyError:
            raise ValueError(f'unsupported dtype name: {dtype!r}') from None
    if dtype is bool:
        return bool_
    if dtype is float:
        return float64
    if dtype is int:
        return int64
    try:
        return _NUMPY[np.dtype(dtype)]
    except (TypeError, KeyError):
        name = getattr(dtype, 'name', None) or str(dtype)
        if name in _NAME_TO_DTYPE:
            return _NAME_TO_DTYPE[name]
        raise ValueError(f'unsupported dtype: {dtype!r}') from None


def to_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a Paddle dtype name."""
    if dtype is None:
        raise ValueError('unknown dtype None')
    return convert_dtype(dtype)


def dtype_name(dtype) -> str:
    """Paddle's name of a dtype ('float32', 'bfloat16', 'bool', ...)."""
    return str(convert_dtype(dtype)).replace('torch.', '')


def is_floating(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return not d.is_floating_point and not d.is_complex and d != bool_


def is_inexact(dtype) -> bool:
    d = convert_dtype(dtype)
    return d.is_floating_point or d.is_complex


def finfo(dtype):
    return torch.finfo(convert_dtype(dtype))


def iinfo(dtype):
    return torch.iinfo(convert_dtype(dtype))
