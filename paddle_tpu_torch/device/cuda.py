"""paddle.device.cuda (counterpart of `paddle_tpu/device/cuda.py`; upstream:
python/paddle/device/cuda/__init__.py): the caching allocator's memory
figures, `device_count`, `synchronize` and `empty_cache`.

`empty_cache` has upstream's meaning here: it releases the caching
allocator's unused blocks (`torch.cuda.empty_cache()`). The JAX
package's is a synchronization only, as XLA manages its own memory
(ROADMAP: differences that are not faults)."""
from __future__ import annotations

import torch

from ..framework import (device_memory_limit, max_memory_allocated,
                         max_memory_reserved, memory_allocated,
                         memory_reserved, synchronize)

__all__ = ['memory_allocated', 'max_memory_allocated', 'memory_reserved',
           'max_memory_reserved', 'device_memory_limit', 'synchronize',
           'device_count', 'empty_cache']


def device_count() -> int:
    return torch.cuda.device_count()


def empty_cache() -> None:
    """Release the caching allocator's unused blocks to the CUDA runtime."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
