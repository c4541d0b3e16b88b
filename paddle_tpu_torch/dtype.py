"""Dtype names of the port (counterpart of `paddle_tpu/dtype.py`, the
subset the serving slice needs): Paddle's string names map to torch
dtypes, and `to_torch_dtype` accepts either form."""
from __future__ import annotations

import torch

float32 = torch.float32
bfloat16 = torch.bfloat16
int8 = torch.int8
int32 = torch.int32
int64 = torch.int64

_BY_NAME = {'float32': float32, 'bfloat16': bfloat16, 'int8': int8,
            'int32': int32, 'int64': int64}


def to_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a Paddle dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _BY_NAME[str(dtype)]
    except KeyError:
        raise ValueError(f'unknown dtype {dtype!r}') from None
