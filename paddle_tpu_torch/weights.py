"""Carry the JAX package's weights (and LoRA adapter banks) into the port.

Both packages use Paddle's parameter names and layouts (`Linear.weight`
is [in, out] in both), so the conversion is a checked copy by name.
`param_digest` fingerprints a model's weights where they live, so two
processes can show they serve the same numbers without moving them. A
quantized model's int8 weights and scales are buffers under the JAX
names (`from_jax_state` copies them); its activation scales are
attributes (`set_act_scales`).
"""
from __future__ import annotations

import hashlib
import json
from typing import Mapping

import numpy as np
import torch


def _copy_by_name(src: Mapping, dst: Mapping[str, torch.Tensor],
                  what: str) -> None:
    """Copy each numpy array (or tensor) src[name] into the tensor
    dst[name] in place, cast to its dtype and device: a port `Parameter`
    or eager `Tensor` keeps its identity (and an optimizer's hold on it).
    Every name must match on both sides, with equal shapes."""
    from .tensor import to_torch
    missing = sorted(set(dst) - set(src))
    extra = sorted(set(src) - set(dst))
    if missing or extra:
        raise KeyError(f'{what}: missing {missing}, unexpected {extra}')
    with torch.no_grad():
        for name, t in dst.items():
            t, val = to_torch(t), to_torch(src[name])
            if isinstance(val, torch.Tensor):     # bf16 ones included
                if tuple(val.shape) != tuple(t.shape):
                    raise ValueError(f'{name}: shape {tuple(val.shape)}'
                                     f' != {tuple(t.shape)}')
                t.copy_(val)
                continue
            arr = np.asarray(val)
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


def set_act_scales(model: torch.nn.Module,
                   scales: Mapping[str, object]) -> None:
    """Set each `QuantedLinear`'s act_scale from `scales` ({layer name:
    float or None}, e.g. the JAX model's, read from its `QuantedLinear`
    sublayers by name). Every name must match on both sides; with
    `from_jax_state` (the int8 weights and their scales are buffers) it
    carries a quantized model across whole."""
    from .quantization import QuantedLinear
    layers = {name: layer for name, layer in model.named_modules()
              if isinstance(layer, QuantedLinear)}
    missing = sorted(set(layers) - set(scales))
    extra = sorted(set(scales) - set(layers))
    if missing or extra:
        raise KeyError(f'act scales: missing {missing}, unexpected {extra}')
    for name, layer in layers.items():
        v = scales[name]
        layer.act_scale = None if v is None else float(v)


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


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def param_digest(model: torch.nn.Module) -> str:
    """sha256 of every `state_dict` entry's name, dtype, shape and two
    sums of its raw bits (reinterpreted as integers, widened to int64:
    their sum and their sum of squares, wrapping), computed on the
    tensors' own device. Equal weights give equal digests on any device;
    a changed value changes them."""
    rows = []
    with torch.no_grad():
        for name, t in model.state_dict().items():
            bits = t.detach().contiguous().view(
                _BITS[t.element_size()]).to(torch.int64)
            rows.append([name, str(t.dtype), list(t.shape),
                         int(bits.sum()), int((bits * bits).sum())])
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()
