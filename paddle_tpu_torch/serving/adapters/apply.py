"""Run-time segmented adapter application (counterpart of
`paddle_tpu/serving/adapters/apply.py`).

The engine runs one forward over every slot of a decode round, and each
row may decode under its own LoRA adapter, so the per-row deltas are
driven by tensors (the packed bank factors and a per-row slot vector),
never by Python branches per request:

- `adapter_scope(arrays, rows)` is a context manager the engine wraps
  around each forward. It publishes the bank's packed tensors and the
  per-row bank slots to a thread-local that every `Linear` the forward
  calls can see. Outside a scope (training, `generate`, a bank-less
  engine) the hook is inert, so attaching a bank perturbs no other path.
  Where the JAX package sets the scope at trace time, the port sets it
  at run time, around the eager forward.
- `linear_hook(linear, x, y)`, installed on target `Linear`s by
  `AdapterBank`, returns the projection's output plus the segmented
  delta, `kernels.adapter_matmul_add(y, x, A, B, rows, scale)` (one
  kernel pass), while a scope is active. Rows on bank slot 0 (the
  reserved all-zero base adapter) get an exactly-zero delta, so requests
  without an adapter stay bit-identical to a bank-less engine.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ...ops import kernels


class _ScopeState(threading.local):
    def __init__(self):
        self.scope: Optional['_Scope'] = None


_state = _ScopeState()


class _Scope:
    """One active adapter context: the bank's tensors
    (`factors[site] = {'a': [C, H, R], 'b': [C, R, O]}` and `scale [C]`)
    and the per-row bank slots `rows [B]` (int32, on the model's device)
    of the current forward."""

    __slots__ = ('factors', 'scale', 'rows')

    def __init__(self, factors: Dict[str, Dict[str, Any]], scale, rows):
        self.factors = factors
        self.scale = scale
        self.rows = rows


class adapter_scope:
    """`with adapter_scope(arrays, rows): forward(...)`, where arrays is
    `AdapterBank.device_arrays()` (or None for an inert scope, so call
    sites need no branch)."""

    __slots__ = ('_arrays', '_rows', '_prev')

    def __init__(self, arrays: Optional[Dict[str, Any]], rows):
        self._arrays = arrays
        self._rows = rows
        self._prev = None

    def __enter__(self):
        self._prev = _state.scope
        if self._arrays is not None:
            _state.scope = _Scope(self._arrays['factors'],
                                  self._arrays['scale'], self._rows)
        return self

    def __exit__(self, *exc):
        _state.scope = self._prev
        return False


def active_scope() -> Optional[_Scope]:
    return _state.scope


def linear_hook(linear, x, y):
    """Returns y plus the per-row LoRA delta of a tagged Linear while an
    adapter scope is active, and y unchanged otherwise. One kernel pass,
    `kernels.adapter_matmul_add`, computes the delta, rounds it to
    x.dtype and adds it to y, as the JAX package's `y + Tensor(delta)`."""
    sc = _state.scope
    if sc is None:
        return y
    fac = sc.factors.get(linear._adapter_site)
    if fac is None:
        return y
    xv = x[:, None, :] if x.dim() == 2 else x   # [B, H] -> [B, 1, H]
    return kernels.adapter_matmul_add(y, xv.contiguous(), fac['a'],
                                      fac['b'], sc.rows, sc.scale)
