"""ctypes bindings for the C++ checkpoint sharder (counterpart of
`paddle_tpu/utils/ckpt_native.py`), over the port's own copy of its
source, `paddle_tpu_torch/csrc/host/ckpt_sharder.cpp`.

The JAX package's build and degrade contract: the library is compiled
with g++ at first use (into the git-ignored `build/host/`, `host_lib`),
rebuilt when the source is newer, and `available()` returns False where
no compiler is present; `write_shards` / `read_shards` then raise, and a
caller that can falls back to the single-stream npz container
(`CheckpointManager(backend='native')` does).

A sharded checkpoint directory holds `manifest.json` plus
`shard_<k>.bin` files; arrays are packed back-to-back per shard, and
shards are written and read by one C++ thread each. The manifest records
each array's shard, offset, bytes, numpy dtype string and shape, in the
JAX package's format, so either package reads the other's directories.
"""
from __future__ import annotations

import ctypes
import json
import os
from typing import Dict, List, Tuple

import numpy as np

from .host_lib import HostLib

MANIFEST = 'manifest.json'


def _bind(lib):
    pp = ctypes.POINTER(ctypes.c_char_p)
    for name in ('ckpt_write', 'ckpt_read'):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [pp, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_ulonglong)]
    return lib


LIB = HostLib('paddle_tpu_torch_ckpt', 'ckpt_sharder.cpp', _bind)


def get_lib():
    return LIB.get()


def available() -> bool:
    return LIB.available()


def _plan_shards(sizes: List[int], n_shards: int) -> List[List[int]]:
    """Greedy size-balanced assignment: largest array to lightest shard.
    Returns per-shard lists of array indices."""
    n_shards = max(1, min(n_shards, max(len(sizes), 1)))
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    loads = [0] * n_shards
    shards: List[List[int]] = [[] for _ in range(n_shards)]
    for i in order:
        k = loads.index(min(loads))
        shards[k].append(i)
        loads[k] += sizes[i]
    return [s for s in shards if s]


def _call(lib_fn, dirname: str, per_shard_arrays: List[List[np.ndarray]]):
    """Marshal per-shard array lists into the flat C arguments and call
    ckpt_write/ckpt_read (arrays of shard k go to shard_<k>.bin, packed
    back-to-back in list order)."""
    paths, starts, ptrs, sizes = [], [0], [], []
    for k, arrs in enumerate(per_shard_arrays):
        paths.append(
            os.path.join(dirname, f'shard_{k}.bin').encode('utf-8'))
        for a in arrs:
            ptrs.append(a.ctypes.data)
            sizes.append(a.nbytes)
        starts.append(starts[-1] + len(arrs))
    rc = lib_fn(
        (ctypes.c_char_p * len(paths))(*paths), len(paths),
        (ctypes.c_longlong * len(starts))(*starts),
        (ctypes.c_void_p * max(len(ptrs), 1))(*ptrs),
        (ctypes.c_ulonglong * max(len(sizes), 1))(*sizes))
    if rc:
        raise IOError(f'checkpoint shard io failed on '
                      f'{os.path.join(dirname, f"shard_{rc - 1}.bin")}')


def write_shards(dirname: str, named: Dict[str, np.ndarray],
                 n_shards: int = 8) -> None:
    """Write `named` host arrays as a sharded checkpoint directory."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError('native checkpoint sharder unavailable')
    os.makedirs(dirname, exist_ok=True)
    names = list(named)
    arrays = [np.ascontiguousarray(named[n]) for n in names]
    shards = _plan_shards([a.nbytes for a in arrays], n_shards)
    entries = {}
    for k, idxs in enumerate(shards):
        off = 0
        for i in idxs:
            a = arrays[i]
            entries[names[i]] = {
                'shard': k, 'offset': off, 'nbytes': a.nbytes,
                'dtype': a.dtype.str, 'shape': list(a.shape)}
            off += a.nbytes
    _call(lib.ckpt_write, dirname,
          [[arrays[i] for i in idxs] for idxs in shards])
    with open(os.path.join(dirname, MANIFEST), 'w') as f:
        json.dump({'n_shards': len(shards), 'arrays': entries}, f)


def read_shards(dirname: str) -> Dict[str, np.ndarray]:
    """Read a sharded checkpoint directory back into named host
    arrays."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError('native checkpoint sharder unavailable')
    with open(os.path.join(dirname, MANIFEST)) as f:
        manifest = json.load(f)
    entries = manifest['arrays']
    out = {name: np.empty(e['shape'], dtype=np.dtype(e['dtype']))
           for name, e in entries.items()}
    per_shard: List[List[Tuple[int, str]]] = [
        [] for _ in range(manifest['n_shards'])]
    for name, e in entries.items():
        per_shard[e['shard']].append((e['offset'], name))
    _call(lib.ckpt_read, dirname,
          [[out[name] for _, name in sorted(members)]
           for members in per_shard])
    return out
