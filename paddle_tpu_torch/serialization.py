"""paddle.save / paddle.load (counterpart of `paddle_tpu/serialization.py`;
upstream: python/paddle/framework/io.py).

The JAX package's container and layout: the object tree is flattened
to arrays in one `.npz` plus a JSON manifest of the structure (no
pickle, so loading runs no code). Nested dict/list/tuple of torch
tensors, numpy arrays, scalars, strings and None (state_dicts and
optimizer state_dicts). Dict keys keep their Python type ('s:'/'i:'/
'b:'/'f:' tagged).

bf16 and fp8 leaves: npz cannot store them, so they are written as the
same-width unsigned integers with the true dtype name in the manifest
(`np_dtype`), as the JAX package writes them; either package reads the
other's files. numpy has no bf16 or fp8 without `ml_dtypes`, which the
port does not use, so the port reads such a leaf back as a torch tensor
of that dtype (the uint view reinterpreted). What `load` returns:

- `return_numpy=False` (the default): every leaf saved as a tensor comes
  back as a torch tensor on `device` (default `cuda`; pass
  device='cpu' off the card); every leaf saved as an array comes back
  as a numpy array, except bf16/fp8 ones, which come back as CPU tensors;
- `return_numpy=True`: every leaf comes back as a numpy array, except
  bf16/fp8 ones, which come back as CPU tensors.

A numpy array with a bf16/fp8 dtype (made by a caller that has
`ml_dtypes`) is written the same way; saving one needs no `ml_dtypes`
here.

`save_sharded` / `load_sharded` write and read the JAX package's
sharded directory (`tree.json`, the structure; `manifest.json` and
`shard_<k>.bin`, the arrays) through the port's copy of the host C++
shard writer (`utils/ckpt_native.py`). A bf16 or fp8 leaf travels as its
raw same-width unsigned integers under its `np_dtype` name, as in the npz
container, so a directory written by either package loads in the other.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from .framework import resolve_device

_ARRAY_KEY = '__arr__'

# dtypes numpy lacks: torch dtype <-> the JAX package's `np_dtype` name
_TORCH_ONLY = {torch.bfloat16: 'bfloat16',
               torch.float8_e4m3fn: 'float8_e4m3fn',
               torch.float8_e5m2: 'float8_e5m2'}
_BY_NAME = {name: dt for dt, name in _TORCH_ONLY.items()}
# torch integer dtypes of each width (`.numpy()` takes these)
_TORCH_INT = {1: torch.int8, 2: torch.int16}


def _tag_key(k):
    if isinstance(k, bool):   # before int: bool is an int subclass
        return f'b:{k}'
    if isinstance(k, int):
        return f'i:{k}'
    if isinstance(k, float):
        return f'f:{k!r}'
    return f's:{k}'


def _untag_key(tagged: str):
    tag, _, v = tagged.partition(':')
    if tag == 'i':
        return int(v)
    if tag == 'b':
        return v == 'True'
    if tag == 'f':
        return float(v)
    return v


def _encode_tensor(t: torch.Tensor):
    """A host numpy array of `t` for npz, and the dtype name to record
    when npz cannot hold its dtype (then the array is its uint view)."""
    t = t.detach().to('cpu').contiguous()
    name = _TORCH_ONLY.get(t.dtype)
    if name is None:
        return t.numpy(), None
    size = t.element_size()
    return t.view(_TORCH_INT[size]).numpy().view(f'u{size}'), name


def _encode_array(a: np.ndarray):
    """npz cannot store ml_dtypes (bf16/fp8 have numpy kind 'V'); view
    them as the same-width uint and record the true dtype name."""
    if a.dtype.kind == 'V':
        return a.view(np.dtype(f'u{a.dtype.itemsize}')), a.dtype.name
    return a, None


def _decode_array(a: np.ndarray, np_dtype):
    """The saved leaf: `a` itself, or for a recorded bf16/fp8 name the
    torch CPU tensor its uint view stands for."""
    if not np_dtype:
        return a
    dt = _BY_NAME.get(np_dtype)
    if dt is None:
        raise TypeError(f'cannot read a leaf of dtype {np_dtype!r} without '
                        f'ml_dtypes (the port reads {sorted(_BY_NAME)})')
    ints = np.ascontiguousarray(a).view(f'i{a.dtype.itemsize}')
    return torch.from_numpy(ints).view(dt)


def _flatten(obj: Any, arrays: list, path: str):
    if isinstance(obj, torch.Tensor):
        arr, np_dtype = _encode_tensor(obj)
        arrays.append(arr)
        return {_ARRAY_KEY: len(arrays) - 1, 'kind': 'tensor',
                'np_dtype': np_dtype}
    if isinstance(obj, np.ndarray):
        arr, np_dtype = _encode_array(obj)
        arrays.append(arr)
        return {_ARRAY_KEY: len(arrays) - 1, 'kind': 'ndarray',
                'np_dtype': np_dtype}
    if isinstance(obj, dict):
        for k in obj:
            if not isinstance(k, (str, int, bool, float)):
                raise TypeError(
                    f'paddle.save dict keys must be str/int/bool/float, '
                    f'got {type(k).__name__} at {path!r}')
        return {'kind': 'dict',
                'items': [[_tag_key(k), _flatten(v, arrays, f'{path}.{k}')]
                          for k, v in obj.items()]}
    if isinstance(obj, (list, tuple)):
        return {'kind': 'list' if isinstance(obj, list) else 'tuple',
                'items': [_flatten(v, arrays, f'{path}[{i}]')
                          for i, v in enumerate(obj)]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {'kind': 'scalar', 'value': obj}
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return {'kind': 'scalar', 'value': obj.item()}
    raise TypeError(
        f'paddle.save cannot serialize {type(obj).__name__} at {path!r}')


def _unflatten(spec, arrays, return_numpy, device):
    kind = spec['kind']
    if kind in ('tensor', 'ndarray'):
        arr = _decode_array(arrays[f'a{spec[_ARRAY_KEY]}'],
                            spec.get('np_dtype'))
        if kind == 'tensor' and not return_numpy:
            if isinstance(arr, np.ndarray):
                arr = torch.from_numpy(np.require(arr, requirements='W'))
            return arr.to(resolve_device(device))
        return arr
    if kind == 'dict':
        return {_untag_key(k): _unflatten(v, arrays, return_numpy, device)
                for k, v in spec['items']}
    if kind == 'list':
        return [_unflatten(v, arrays, return_numpy, device)
                for v in spec['items']]
    if kind == 'tuple':
        return tuple(_unflatten(v, arrays, return_numpy, device)
                     for v in spec['items'])
    return spec['value']


def save(obj: Any, path: str, protocol=None, **config):
    """Serialize a nested object tree to `path` (npz + manifest)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    arrays: list = []
    manifest = _flatten(obj, arrays, '<root>')
    tmp = path + '.tmp'
    np.savez(tmp, manifest=json.dumps(manifest),
             **{f'a{i}': a for i, a in enumerate(arrays)})
    os.replace(tmp + '.npz' if os.path.exists(tmp + '.npz') else tmp, path)


def load(path: str, return_numpy=False, device=None, **config) -> Any:
    """Restore an object tree saved by `save` (of either package). Leaves
    saved as tensors come back on `device` (default `cuda`) unless
    `return_numpy` (see the module docstring for bf16/fp8 leaves)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(str(data['manifest']))
        return _unflatten(manifest, data, return_numpy, device)


def save_sharded(obj: Any, dirname: str, n_shards: int = 8):
    """Serialize like `save`, but through the parallel C++ shard writer:
    arrays are size-balanced across `shard_<k>.bin` files written by one
    thread each (no zip or CRC pass). Layout: tree.json (structure) +
    manifest.json + shards."""
    from .utils import ckpt_native
    os.makedirs(dirname, exist_ok=True)
    arrays: list = []
    manifest = _flatten(obj, arrays, '<root>')
    ckpt_native.write_shards(
        dirname, {f'a{i}': a for i, a in enumerate(arrays)},
        n_shards=n_shards)
    tmp = os.path.join(dirname, 'tree.json.tmp')
    with open(tmp, 'w') as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(dirname, 'tree.json'))


def load_sharded(dirname: str, return_numpy=False, device=None) -> Any:
    """Restore an object tree saved by `save_sharded` (of either
    package) through the parallel C++ shard reader; leaves come back as
    `load` returns them (tensors on `device`, default `cuda`)."""
    tree_file = os.path.join(dirname, 'tree.json')
    if not os.path.isfile(tree_file):
        raise FileNotFoundError(
            f'{dirname!r} is not a sharded checkpoint (no tree.json)')
    from .utils import ckpt_native
    with open(tree_file) as f:
        manifest = json.load(f)
    return _unflatten(manifest, ckpt_native.read_shards(dirname),
                      return_numpy, device)
