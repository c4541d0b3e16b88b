"""Carry the JAX package's weights (and LoRA adapter banks) into the port.

Both packages use Paddle's parameter names and layouts (`Linear.weight`
is [in, out] in both), so the conversion is a checked copy by name.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _copy_by_name(src: Mapping, dst: Mapping[str, torch.Tensor],
                  what: str) -> None:
    """Copy each numpy array src[name] into the tensor dst[name], cast to
    its dtype and device. Every name must match on both sides, with equal
    shapes."""
    missing = sorted(set(dst) - set(src))
    extra = sorted(set(src) - set(dst))
    if missing or extra:
        raise KeyError(f'{what}: missing {missing}, unexpected {extra}')
    with torch.no_grad():
        for name, t in dst.items():
            arr = np.asarray(src[name])
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f'{name}: shape {tuple(arr.shape)} != '
                                 f'{tuple(t.shape)}')
            if arr.dtype.name == 'bfloat16':
                arr = arr.astype(np.float32)   # torch cannot read numpy bf16
            t.copy_(torch.from_numpy(np.array(arr)))


def from_jax_state(state: Mapping[str, np.ndarray], model: torch.nn.Module
                   ) -> torch.nn.Module:
    """Copy `state` ({JAX state_dict name: numpy array}) into `model`'s
    parameters, cast to each parameter's dtype and device. Every name
    must match on both sides, with equal shapes. Returns `model`."""
    _copy_by_name(state, model.state_dict(), 'state does not match the model')
    return model


def _flat_bank(arrays: Mapping) -> dict:
    """{'scale', '<site>.a', '<site>.b'} of a device_arrays() pytree."""
    flat = {'scale': arrays['scale']}
    for site, fac in arrays['factors'].items():
        flat[f'{site}.a'], flat[f'{site}.b'] = fac['a'], fac['b']
    return flat


def from_jax_adapter_arrays(arrays: Mapping, bank) -> None:
    """Copy a JAX `AdapterBank.device_arrays()` pytree (leaves as numpy
    arrays: `{'factors': {site: {'a', 'b'}}, 'scale'}`) into the port
    bank's packed tensors, cast to the bank's dtype. Site names (the
    `state_dict` prefixes of the adapted projections) must match on both
    sides, with equal shapes. The slot table is not carried: load the
    same adapter ids in the same order, or read the slots from the JAX
    bank."""
    _copy_by_name(_flat_bank(arrays), _flat_bank(bank.device_arrays()),
                  'adapter arrays do not match the bank')
