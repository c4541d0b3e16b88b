"""Packed, device-resident LoRA adapter bank (counterpart of
`paddle_tpu/serving/adapters/bank.py`).

The bank keeps a fixed number of adapters on the model's device as
packed factors: one `[capacity + 1, in, rank]` A bank and one
`[capacity + 1, rank, out]` B bank per target projection, and a
`[capacity + 1]` scale vector. Each forward gathers a row's factors by
index, so any mix of adapters runs through the same kernels:

- bank slot 0 is the reserved all-zero base adapter (scale 0), so rows
  without an adapter get an exactly-zero delta;
- a host-side slot table maps adapter_id -> (slot, version), with
  reference-count pinning while a request decodes under an adapter and
  LRU eviction of slots that no request pins.

Slot writes are in-place `copy_`s into the packed tensors, the port's
counterpart of the JAX bank's functional `.at[slot].set`: the tensors
keep their shapes, dtypes and storage, so `device_arrays()` stays valid
across any sequence of loads and evictions.

Not ported yet (ROADMAP.md, Queue 1): the store-backed half of the JAX
bank (`store_dir=`, `publish`, hot-swap to a newer version on `pin`,
quarantine of a corrupt manifest), and the adapter metrics and events.
Without a store, `pin` never loads, so it never finds the bank full.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import dtype as _dtype
from ...ops import kernels
from . import apply as _apply

#: attribute-name suffixes of the projections that receive adapters by
#: default: attention qkv/out, the classic LoRA target set (the JAX
#: package's names; Llama's projections are q/k/v/o_proj, so a Llama bank
#: names its targets)
DEFAULT_TARGETS = ('qkv_proj', 'out_proj')

_NOT_PORTED = ('the store-backed adapter bank (store_dir=, publish) is not '
               'ported yet (ROADMAP.md, Queue 1); load factors with '
               'AdapterBank.load')


class AdapterUnavailable(KeyError):
    """Typed miss: the bank cannot pin the named adapter (never loaded,
    or evicted). `transient=True` marks a bank full of pinned slots."""

    def __init__(self, adapter_id: str, detail: str = '',
                 transient: bool = False):
        super().__init__(adapter_id)
        self.adapter_id = adapter_id
        self.detail = detail
        self.transient = transient

    def __str__(self):
        base = f'adapter {self.adapter_id!r} unavailable'
        return f'{base}: {self.detail}' if self.detail else base


class AdapterBank:
    """Fixed-capacity packed LoRA bank over a model's target Linears.

    `capacity` counts loadable adapter slots (the packed tensors carry
    one more row: the zero base adapter at slot 0). `rank` is the shared
    LoRA rank, at most `kernels.ADAPTER_MAX_RANK`; factors of any other
    rank are rejected at load. The tensors live on the model's device in
    `dtype` (the scale in f32).
    """

    def __init__(self, model, capacity: int = 8, rank: int = 8, *,
                 targets: Sequence[str] = DEFAULT_TARGETS,
                 dtype='float32', store_dir: Optional[str] = None):
        if store_dir is not None:
            raise NotImplementedError(_NOT_PORTED)
        if capacity < 1:
            raise ValueError(f'capacity must be >= 1, got {capacity}')
        if rank < 1:
            raise ValueError(f'rank must be >= 1, got {rank}')
        if rank > kernels.ADAPTER_MAX_RANK:
            raise ValueError(f'rank {rank} exceeds the adapter kernel\'s '
                             f'{kernels.ADAPTER_MAX_RANK}')
        self.capacity = int(capacity)
        self.rank = int(rank)
        self.dtype = _dtype.to_torch_dtype(dtype)
        self.targets = tuple(targets)
        # site name -> (in_features, out_features), insertion-ordered
        self.sites: Dict[str, Tuple[int, int]] = {}
        self._tagged: List[Any] = []
        self._attach(model)
        if not self.sites:
            raise ValueError(
                f'no target projections matching {self.targets} found '
                f'on {type(model).__name__}: nothing to adapt')
        self.device = next(model.parameters()).device
        rows = self.capacity + 1
        self._a = {s: torch.zeros((rows, i, self.rank), dtype=self.dtype,
                                  device=self.device)
                   for s, (i, o) in self.sites.items()}
        self._b = {s: torch.zeros((rows, self.rank, o), dtype=self.dtype,
                                  device=self.device)
                   for s, (i, o) in self.sites.items()}
        self._scale = torch.zeros((rows,), dtype=torch.float32,
                                  device=self.device)
        # written in place, so one pytree serves every forward
        self._arrays = {'factors': {s: {'a': self._a[s], 'b': self._b[s]}
                                    for s in self.sites},
                        'scale': self._scale}
        # host-side slot table
        self._keys: List[Optional[str]] = [None] * rows   # slot -> id
        self._versions: List[int] = [0] * rows            # slot -> ver
        self._refs: List[int] = [0] * rows
        self._lru: List[int] = [0] * rows
        self._refs[0] = 1          # slot 0 is never evictable
        self._by_key: Dict[str, int] = {}                 # id -> slot
        self._tick = 0

    # -- model tagging ------------------------------------------------------

    def _attach(self, model):
        suffixes = set(self.targets)
        for name, layer in model.named_modules():
            if name.rsplit('.', 1)[-1] not in suffixes:
                continue
            if not hasattr(layer, 'in_features'):
                continue
            self.sites[name] = (int(layer.in_features),
                                int(layer.out_features))
            layer._adapter_site = name
            layer._adapter_hook = _apply.linear_hook
            self._tagged.append(layer)

    def detach(self):
        """Remove the hooks (tests, model reuse); the bank is dead after
        this."""
        for layer in self._tagged:
            layer.__dict__.pop('_adapter_hook', None)
            layer.__dict__.pop('_adapter_site', None)
        self._tagged = []

    # -- geometry / tensors ---------------------------------------------------

    def describe_statics(self) -> Dict[str, Any]:
        """The bank's geometry and target-site set; slot contents never
        appear here."""
        return {'capacity': self.capacity, 'rank': self.rank,
                'targets': tuple(sorted(self.sites))}

    def device_arrays(self) -> Dict[str, Any]:
        """The tensors every banked forward reads:
        `{'factors': {site: {'a', 'b'}}, 'scale'}`."""
        return self._arrays

    # -- slot table ----------------------------------------------------------

    def lookup(self, adapter_id: str) -> Optional[Tuple[int, int]]:
        """(slot, version) if the adapter is resident, else None."""
        slot = self._by_key.get(adapter_id)
        if slot is None:
            return None
        return slot, self._versions[slot]

    def available(self, adapter_id: str) -> bool:
        """True if a pin() could succeed right now (the adapter is
        resident)."""
        return adapter_id in self._by_key

    def pin(self, adapter_id: str) -> Tuple[int, int]:
        """Pin `adapter_id` for one request; returns (slot, version).
        Raises `AdapterUnavailable` when the adapter is not resident."""
        slot = self._by_key.get(adapter_id)
        if slot is None:
            raise AdapterUnavailable(adapter_id, 'not loaded')
        self._refs[slot] += 1
        self._tick += 1
        self._lru[slot] = self._tick
        return slot, self._versions[slot]

    def unpin(self, slot: int):
        if slot <= 0:
            return
        if self._refs[slot] <= 0:
            raise RuntimeError(f'unpin of unpinned bank slot {slot}')
        self._refs[slot] -= 1

    def _pinned_count(self) -> int:
        return sum(1 for s in range(1, self.capacity + 1)
                   if self._refs[s] > 0)

    def _alloc_slot(self, adapter_id: str) -> int:
        free = [s for s in range(1, self.capacity + 1)
                if self._keys[s] is None]
        if free:
            return free[0]
        victims = [s for s in range(1, self.capacity + 1)
                   if self._refs[s] == 0]
        if not victims:
            raise AdapterUnavailable(
                adapter_id, f'bank full: all {self.capacity} slots '
                            f'pinned by in-flight requests',
                transient=True)
        victim = min(victims, key=lambda s: self._lru[s])
        old = self._keys[victim]
        if old is not None and self._by_key.get(old) == victim:
            del self._by_key[old]
        self._keys[victim] = None
        self._versions[victim] = 0
        return victim

    # -- loading -------------------------------------------------------------

    def load(self, adapter_id: str, factors: Dict[str, Tuple[Any, Any]],
             *, alpha: Optional[float] = None, version: int = 0
             ) -> Tuple[int, int]:
        """Install host factors (`{site: (A [in, rank], B [rank, out])}`,
        numpy arrays or tensors) into a bank slot: the adapter's own slot
        if it is resident, else a free one, else the least recently used
        unpinned one. Returns (slot, version)."""
        self._check_factors(adapter_id, factors)
        slot = self._by_key.get(adapter_id)
        if slot is None:
            slot = self._alloc_slot(adapter_id)
        self._write_slot(slot, adapter_id, factors, alpha, int(version))
        return slot, int(version)

    def publish(self, adapter_id: str, factors: Dict[str, Tuple[Any, Any]],
                *, alpha: Optional[float] = None,
                meta: Optional[Dict[str, Any]] = None) -> int:
        raise NotImplementedError(_NOT_PORTED)

    def _check_factors(self, adapter_id: str,
                       factors: Dict[str, Tuple[Any, Any]]):
        for site, (a, b) in factors.items():
            dims = self.sites.get(site)
            if dims is None:
                raise ValueError(f'{adapter_id}: unknown target site '
                                 f'{site!r} (bank targets '
                                 f'{tuple(self.sites)})')
            i, o = dims
            if np.shape(a) != (i, self.rank) or np.shape(b) != (self.rank, o):
                raise ValueError(
                    f'{adapter_id}: factor shapes for {site!r} are '
                    f'{np.shape(a)}/{np.shape(b)}, bank wants '
                    f'{(i, self.rank)}/{(self.rank, o)} (all adapters '
                    f'share rank={self.rank})')
        missing = set(self.sites) - set(factors)
        if missing:
            raise ValueError(f'{adapter_id}: factors missing for target '
                             f'sites {sorted(missing)}')

    def _write_slot(self, slot: int, adapter_id: str,
                    factors: Dict[str, Tuple[Any, Any]],
                    alpha: Optional[float], version: int):
        # in place: the packed tensors keep their storage (the JAX
        # bank's `.at[slot].set`)
        with torch.no_grad():
            for site, (a, b) in factors.items():
                self._a[site][slot].copy_(torch.as_tensor(a))
                self._b[site][slot].copy_(torch.as_tensor(b))
            scaling = float(self.rank if alpha is None else alpha) / self.rank
            self._scale[slot] = scaling
        self._keys[slot] = adapter_id
        self._versions[slot] = int(version)
        self._by_key[adapter_id] = slot
        self._tick += 1
        self._lru[slot] = self._tick

    # -- introspection ---------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        resident = {self._keys[s]: {'slot': s,
                                    'version': self._versions[s],
                                    'refs': self._refs[s]}
                    for s in range(1, self.capacity + 1)
                    if self._keys[s] is not None}
        return {'capacity': self.capacity, 'rank': self.rank,
                'sites': len(self.sites), 'resident': resident,
                'pinned': self._pinned_count()}


def make_adapter_factors(bank: AdapterBank, seed: int, scale: float = 0.02
                         ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Deterministic random LoRA factors matching `bank`'s sites and rank
    (numpy f32; the same arrays as the JAX package's helper for the same
    seed and sites). Both factors are non-zero, so adapters differ."""
    rng = np.random.RandomState(seed)
    out = {}
    for site, (i, o) in bank.sites.items():
        a = rng.standard_normal((i, bank.rank)).astype(np.float32) * scale
        b = rng.standard_normal((bank.rank, o)).astype(np.float32) * scale
        out[site] = (a, b)
    return out
