"""paddle.sparse (counterpart of `paddle_tpu/sparse/__init__.py`):
SparseCooTensor / SparseCsrTensor creation, conversion, unary and binary
ops and matmul, over torch's sparse layouts.

A `SparseCooTensor` keeps Paddle's (indices [sparse_ndim, nnz], values,
shape), indices int32 as in the JAX package (whose x64 is off; no
dimension may pass 2^31 - 1, the JAX index-bound check), and computes
through a `torch.sparse_coo_tensor` built from them (torch's COO takes
int64 indices): `to_dense`, `coalesce`, `matmul` (sparse @ dense by
torch's sparse kernels, cuSPARSE on the card). A `SparseCsrTensor` keeps
(crows, cols, values) and converts to COO for compute. Elementwise
binaries take the union of the patterns (add, subtract) or the first
operand's pattern (multiply); unary ops map the values, duplicates
kept, as the JAX package's BCOO ops do.
"""
from __future__ import annotations

import builtins
from typing import List, Sequence

import numpy as np
import torch

from .. import framework
from ..dtype import to_torch_dtype
from ..tensor import Tensor, to_torch

__all__ = [
    'sparse_coo_tensor', 'sparse_csr_tensor', 'SparseCooTensor',
    'SparseCsrTensor', 'is_same_shape', 'add', 'subtract', 'multiply',
    'matmul', 'masked_matmul', 'relu', 'tanh', 'sqrt', 'sin', 'abs',
    'neg', 'pow', 'cast', 'transpose', 'nn',
]


_INDEX_BOUND = 2 ** 31 - 1  # int32 index space, as the JAX package's


def _check_index_bound(shape):
    if builtins.any(int(s) > _INDEX_BOUND for s in shape):
        raise ValueError(
            f'sparse indices are int32; dimension sizes {tuple(shape)} '
            f'exceed {_INDEX_BOUND}')


def _value(x, device=None) -> torch.Tensor:
    v = to_torch(x)
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(np.asarray(v), device=device)
    return v


class SparseCooTensor:
    """COO sparse tensor: `indices` in Paddle's [sparse_ndim, nnz]
    layout."""

    is_sparse_coo_val = True

    def __init__(self, indices: torch.Tensor, values: torch.Tensor,
                 shape: Sequence[int]):
        self._indices = indices
        self._values = values
        self._shape = tuple(int(s) for s in shape)

    def _torch(self) -> torch.Tensor:
        """The torch COO tensor of these entries (uncoalesced)."""
        return torch.sparse_coo_tensor(self._indices.long(), self._values,
                                       self._shape, check_invariants=True)

    @classmethod
    def _from_torch(cls, t: torch.Tensor, index_dtype=torch.int32):
        return cls(t._indices().to(index_dtype), t._values(), t.shape)

    # -- the Paddle surface -------------------------------------------------
    @property
    def shape(self) -> List[int]:
        return list(self._shape)

    @property
    def dtype(self):
        return self._values.dtype

    def nnz(self) -> int:
        return int(self._values.shape[0])

    def indices(self) -> Tensor:
        return Tensor(self._indices)

    def values(self) -> Tensor:
        return Tensor(self._values)

    def to_dense(self) -> Tensor:
        return Tensor(self._torch().to_dense())

    def coalesce(self) -> 'SparseCooTensor':
        return SparseCooTensor._from_torch(self._torch().coalesce(),
                                           self._indices.dtype)

    def to_sparse_csr(self) -> 'SparseCsrTensor':
        if len(self._shape) != 2:
            raise ValueError('to_sparse_csr supports 2-D tensors only')
        _check_index_bound(self._shape)
        csr = self._torch().coalesce().to_sparse_csr()
        return SparseCsrTensor(csr.crow_indices().to(torch.int32),
                               csr.col_indices().to(torch.int32),
                               csr.values(), self._shape)

    def is_sparse_coo(self) -> bool:
        return True

    def is_sparse_csr(self) -> bool:
        return False

    def astype(self, dtype) -> 'SparseCooTensor':
        return SparseCooTensor(self._indices,
                               self._values.to(to_torch_dtype(dtype)),
                               self._shape)

    def t(self) -> 'SparseCooTensor':
        return transpose(self, list(range(len(self._shape)))[::-1])

    def numpy(self) -> np.ndarray:
        return self.to_dense().numpy()

    def __repr__(self):
        return (f'SparseCooTensor(shape={self.shape}, nnz={self.nnz()}, '
                f'dtype={self.dtype})')

    def _unary(self, fn) -> 'SparseCooTensor':
        return SparseCooTensor(self._indices, fn(self._values), self._shape)

    def __add__(self, other):
        return add(self, other)

    def __sub__(self, other):
        return subtract(self, other)

    def __mul__(self, other):
        return multiply(self, other)

    def __matmul__(self, other):
        return matmul(self, other)


class SparseCsrTensor:
    """CSR surface (crows, cols, values); compute converts to COO."""

    def __init__(self, crows, cols, values, shape: Sequence[int]):
        self._crows = _value(crows)
        self._cols = _value(cols, self._crows.device)
        self._values = _value(values, self._crows.device)
        self._shape = list(int(s) for s in shape)

    @property
    def shape(self) -> List[int]:
        return list(self._shape)

    @property
    def dtype(self):
        return self._values.dtype

    def nnz(self) -> int:
        return int(self._values.shape[0])

    def crows(self) -> Tensor:
        return Tensor(self._crows)

    def cols(self) -> Tensor:
        return Tensor(self._cols)

    def values(self) -> Tensor:
        return Tensor(self._values)

    def _rows(self) -> torch.Tensor:
        counts = torch.diff(self._crows.long())
        return torch.repeat_interleave(
            torch.arange(self._shape[0], device=self._crows.device), counts,
            output_size=self.nnz())

    def to_sparse_coo(self, sparse_dim: int = 2) -> SparseCooTensor:
        idx = torch.stack([self._rows().to(self._cols.dtype), self._cols])
        return SparseCooTensor(idx, self._values, self._shape)

    def to_dense(self) -> Tensor:
        return self.to_sparse_coo().to_dense()

    def is_sparse_coo(self) -> bool:
        return False

    def is_sparse_csr(self) -> bool:
        return True

    def numpy(self) -> np.ndarray:
        return self.to_dense().numpy()

    def __repr__(self):
        return (f'SparseCsrTensor(shape={self.shape}, nnz={self.nnz()}, '
                f'dtype={self.dtype})')


def _as_coo(x) -> SparseCooTensor:
    if isinstance(x, SparseCooTensor):
        return x
    if isinstance(x, SparseCsrTensor):
        return x.to_sparse_coo()
    raise TypeError(f'expected a sparse tensor, got {type(x).__name__}')


def sparse_coo_tensor(indices, values, shape=None, dtype=None,
                      place=None, stop_gradient=True) -> SparseCooTensor:
    """A COO tensor from Paddle-layout [sparse_ndim, nnz] indices, on the
    values' device (numpy inputs: the current place)."""
    dev = (framework.current_device() if not isinstance(
        to_torch(values), torch.Tensor) else None)
    vals = _value(values, dev)
    idx = _value(indices, vals.device).to(torch.int32)
    if dtype is not None:
        vals = vals.to(to_torch_dtype(dtype))
    if shape is None:
        shape = tuple(int(s) + 1 for s in idx.max(dim=1).values)
    _check_index_bound(shape)
    return SparseCooTensor(idx, vals, shape)


def sparse_csr_tensor(crows, cols, values, shape, dtype=None,
                      place=None, stop_gradient=True) -> SparseCsrTensor:
    dev = (framework.current_device() if not isinstance(
        to_torch(values), torch.Tensor) else None)
    vals = _value(values, dev)
    if dtype is not None:
        vals = vals.to(to_torch_dtype(dtype))
    _check_index_bound(shape)
    return SparseCsrTensor(_value(crows, vals.device).to(torch.int32),
                           _value(cols, vals.device).to(torch.int32),
                           vals, shape)


def is_same_shape(x, y) -> bool:
    return list(x.shape) == list(y.shape)


# -- binary ops -------------------------------------------------------------

def _binary(x, y, sub: bool) -> SparseCooTensor:
    a, b = _as_coo(x), _as_coo(y)
    if a.shape != b.shape:
        raise ValueError(f'shape mismatch: {tuple(a.shape)} vs '
                         f'{tuple(b.shape)}')
    # the union of the patterns: both entry lists, duplicates summed
    out = torch.sparse_coo_tensor(
        torch.cat([a._indices, b._indices], dim=1).long(),
        torch.cat([a._values, -b._values if sub else b._values]),
        a._shape, check_invariants=True).coalesce()
    return SparseCooTensor._from_torch(out)


def add(x, y) -> SparseCooTensor:
    return _binary(x, y, False)


def subtract(x, y) -> SparseCooTensor:
    return _binary(x, y, True)


def multiply(x, y):
    """Elementwise product. Sparse * scalar scales the values; sparse *
    sparse keeps x's (coalesced) pattern, times y's values there."""
    if isinstance(y, (int, float)):
        a = _as_coo(x)
        return SparseCooTensor(a._indices, a._values * y, a._shape)
    a = _as_coo(x).coalesce()
    gathered = _as_coo(y)._torch().to_dense()[tuple(a._indices.long())]
    return SparseCooTensor(a._indices, a._values * gathered, a._shape)


def matmul(x, y) -> Tensor:
    """sparse @ dense -> dense (upstream sparse.matmul), through torch's
    sparse matmul."""
    return Tensor(torch.sparse.mm(_as_coo(x)._torch(), _value(y)))


def masked_matmul(x, y, mask) -> SparseCooTensor:
    """dense @ dense sampled at `mask`'s sparsity (SDDMM)."""
    m = _as_coo(mask).coalesce()
    xv, yv = _value(x), _value(y)
    rows, cols = m._indices[0].long(), m._indices[1].long()
    vals = torch.einsum('nk,nk->n', xv[rows], yv.t()[cols])
    return SparseCooTensor(m._indices, vals, m._shape)


# -- unary ops --------------------------------------------------------------

def _make_unary(fn, name):
    def op(x):
        if isinstance(x, SparseCsrTensor):
            return op(x.to_sparse_coo()).to_sparse_csr()
        return x._unary(fn)
    op.__name__ = name
    return op


relu = _make_unary(torch.relu, 'relu')
tanh = _make_unary(torch.tanh, 'tanh')
sqrt = _make_unary(torch.sqrt, 'sqrt')
sin = _make_unary(torch.sin, 'sin')
abs = _make_unary(torch.abs, 'abs')
neg = _make_unary(torch.neg, 'neg')


def pow(x, factor):
    return _make_unary(lambda v: torch.pow(v, factor), 'pow')(x)


def cast(x, index_dtype=None, value_dtype=None):
    a = _as_coo(x)
    idx = (a._indices.to(to_torch_dtype(index_dtype)) if index_dtype
           else a._indices)
    vals = (a._values.to(to_torch_dtype(value_dtype)) if value_dtype
            else a._values)
    return SparseCooTensor(idx, vals, a._shape)


def transpose(x, perm) -> SparseCooTensor:
    a = _as_coo(x)
    perm = [int(p) for p in perm]
    return SparseCooTensor(a._indices[perm], a._values,
                           [a._shape[p] for p in perm])


class _SparseReLU:
    def __call__(self, x):
        return relu(x)


nn = type('nn', (), {'ReLU': _SparseReLU})
