"""Seeds, devices and generators (counterpart of `paddle_tpu/framework.py`).

The port runs on the card: every entry point resolves `device=None` to
`cuda` and raises when there is no card, so a run never moves to the
CPU unless the caller asks for it with `device='cpu'` (as the CPU tests
do). Randomness comes from explicit `torch.Generator`s.
"""
from __future__ import annotations

from typing import Optional

import torch

DEFAULT_DEVICE = 'cuda'


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means `cuda`. Raises when a CUDA
    device is asked for and there is none."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {dev} requested but no CUDA device is available; pass '
            f"device='cpu' to run on the CPU")
    return dev


def seed(value: int) -> None:
    """Seed torch's default generators on every device (`paddle.seed`)."""
    torch.manual_seed(int(value))


def generator(seed_value: Optional[int] = None,
              device=None) -> torch.Generator:
    """A torch.Generator on `device` (default `cuda`), seeded when
    `seed_value` is given (else from torch's default seed sequence)."""
    g = torch.Generator(device=resolve_device(device))
    if seed_value is not None:
        g.manual_seed(int(seed_value))
    else:
        g.seed()
    return g
