"""paddle.device (counterpart of `paddle_tpu/device/__init__.py`; upstream:
python/paddle/device/): device selection, synchronization, and memory
figures from PyTorch's CUDA caching allocator (`framework.py`)."""
from __future__ import annotations

import torch

from ..framework import (device_memory_limit, get_device,
                         is_compiled_with_cuda, max_memory_allocated,
                         max_memory_reserved, memory_allocated,
                         memory_reserved, set_device, synchronize)
from . import cuda  # noqa: F401  (the upstream alias module)

__all__ = ['get_device', 'set_device', 'synchronize', 'memory_allocated',
           'max_memory_allocated', 'memory_reserved', 'max_memory_reserved',
           'device_memory_limit', 'cuda']


def device_count() -> int:
    """The CUDA devices this process sees (0 without a card)."""
    return torch.cuda.device_count()
