"""Carry the JAX package's weights into a port model.

Both packages use Paddle's parameter names and layouts (`Linear.weight`
is [in, out] in both), so the conversion is a checked copy by name.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def from_jax_state(state: Mapping[str, np.ndarray], model: torch.nn.Module
                   ) -> torch.nn.Module:
    """Copy `state` ({JAX state_dict name: numpy array}) into `model`'s
    parameters, cast to each parameter's dtype and device. Every name
    must match on both sides, with equal shapes. Returns `model`."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f'state does not match the model: missing {missing}, '
                       f'unexpected {extra}')
    with torch.no_grad():
        for name, dst in own.items():
            arr = np.asarray(state[name])
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f'{name}: shape {tuple(arr.shape)} != '
                                 f'{tuple(dst.shape)}')
            if arr.dtype.name == 'bfloat16':
                arr = arr.astype(np.float32)   # torch cannot read numpy bf16
            dst.copy_(torch.from_numpy(np.array(arr)))
    return model
