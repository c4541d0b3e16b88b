"""Linear algebra (counterpart of `paddle_tpu/ops/linalg.py`).

`matmul` is one `torch.matmul` (cuBLAS on the card, as the JAX package
leaves its products to XLA); the `paddle.linalg` namespace maps onto
`torch.linalg`. The randomized low-rank factorizations draw from the
port's generator of their input's device.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import framework
from ._helpers import defop


def _promoted(a, b):
    """Both operands in their promoted dtype, as jnp's products take
    mixed inputs (torch's refuse them)."""
    if a.dtype == b.dtype:
        return a, b
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def f(a, b):
        a, b = _promoted(a, b)
        if transpose_x and a.dim() >= 2:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() >= 2:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return defop(f, name='matmul')(x, y)


def mm(x, y, name=None):
    return matmul(x, y)


def bmm(x, y, name=None):
    return defop(lambda a, b: torch.bmm(*_promoted(a, b)), name='bmm')(x, y)


def dot(x, y, name=None):
    return defop(lambda a, b: (a * b).sum(-1), name='dot')(x, y)


def mv(x, vec, name=None):
    return defop(lambda a, v: torch.mv(*_promoted(a, v)), name='mv')(x, vec)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return defop(lambda i, a, b: beta * i + alpha * (a @ b),
                 name='addmm')(input, x, y)


def einsum(equation, *operands, name=None):
    return defop(lambda *vs: torch.einsum(equation, *vs),
                 name='einsum')(*operands)


def _axes(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def norm(x, p='fro', axis=None, keepdim=False, name=None):
    def f(v):
        if axis is None and p in ('fro', 2):
            return torch.sqrt((v * v).sum())
        ax = _axes(axis)
        if ax is None:
            ax = tuple(range(v.dim()))
        if p == 'fro':
            return torch.sqrt((v * v).sum(dim=ax, keepdim=keepdim))
        if p in (np.inf, 'inf', float('inf')):
            return v.abs().amax(dim=ax, keepdim=keepdim)
        if p in (-np.inf, float('-inf')):
            return v.abs().amin(dim=ax, keepdim=keepdim)
        if p == 0:
            return (v != 0).to(v.dtype).sum(dim=ax, keepdim=keepdim)
        return (v.abs() ** p).sum(dim=ax, keepdim=keepdim) ** (1.0 / p)
    return defop(f, name='norm')(x)


def dist(x, y, p=2, name=None):
    return norm(defop(torch.subtract, name='sub')(x, y), p=p)


def cross(x, y, axis=9, name=None):
    def f(a, b):
        ax = axis if axis != 9 else next(
            (i for i, s in enumerate(a.shape) if s == 3), -1)
        return torch.linalg.cross(a, b, dim=ax)
    return defop(f, name='cross')(x, y)


def histogram(input, bins=100, min=0, max=0, name=None):
    def f(v):
        lo, hi = ((min, max) if (min != 0 or max != 0)
                  else (v.min().item(), v.max().item()))
        return torch.histc(v.float(), bins=bins, min=lo, max=hi).to(
            torch.int64)
    return defop(f, name='histogram')(input)


def bincount(x, weights=None, minlength=0, name=None):
    return defop(lambda v, w: torch.bincount(v, w, minlength),
                 name='bincount')(x, weights)


def matrix_power(x, n, name=None):
    return defop(lambda v: torch.linalg.matrix_power(v, n),
                 name='matrix_power')(x)


# the paddle.linalg namespace

cholesky = defop(lambda x, upper=False: torch.linalg.cholesky(x, upper=upper),
                 name='cholesky')
inv = defop(torch.linalg.inv, name='inv')
det = defop(torch.linalg.det, name='det')
slogdet = defop(lambda x: tuple(torch.linalg.slogdet(x)), name='slogdet')
pinv = defop(lambda x, rcond=1e-15, hermitian=False:
             torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian),
             name='pinv')
solve = defop(torch.linalg.solve, name='solve')
lstsq = defop(lambda a, b, rcond=None: tuple(torch.linalg.lstsq(
    a, b, rcond=rcond)), name='lstsq')
matrix_rank = defop(lambda x, tol=None, hermitian=False:
                    torch.linalg.matrix_rank(x, rtol=tol,
                                             hermitian=hermitian),
                    name='matrix_rank')


def qr(x, mode='reduced', name=None):
    def f(v):
        q, r = torch.linalg.qr(v, mode=mode)
        return r if mode == 'r' else (q, r)
    return defop(f, name='qr')(x)


def svd(x, full_matrices=False, name=None):
    return defop(lambda v: tuple(torch.linalg.svd(
        v, full_matrices=full_matrices)), name='svd')(x)


def eigh(x, UPLO='L', name=None):
    return defop(lambda v: tuple(torch.linalg.eigh(v, UPLO=UPLO)),
                 name='eigh')(x)


def eigvalsh(x, UPLO='L', name=None):
    return defop(lambda v: torch.linalg.eigvalsh(v, UPLO=UPLO),
                 name='eigvalsh')(x)


def eig(x, name=None):
    return defop(lambda v: tuple(torch.linalg.eig(v)), name='eig')(x)


def eigvals(x, name=None):
    return defop(torch.linalg.eigvals, name='eigvals')(x)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def f(a, b):
        if transpose:
            a, up = a.transpose(-1, -2), not upper
        else:
            up = upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)
    return defop(f, name='triangular_solve')(x, y)


def cholesky_solve(x, y, upper=False, name=None):
    return defop(lambda b, l: torch.cholesky_solve(b, l, upper=upper),
                 name='cholesky_solve')(x, y)


def cond(x, p=None, name=None):
    return defop(lambda v: torch.linalg.cond(v, p), name='cond')(x)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return defop(lambda v, fw, aw: torch.cov(
        v if rowvar else v.T, correction=1 if ddof else 0, fweights=fw,
        aweights=aw), name='cov')(x, fweights, aweights)


def corrcoef(x, rowvar=True, name=None):
    return defop(lambda v: torch.corrcoef(v if rowvar else v.T),
                 name='corrcoef')(x)


def multi_dot(x, name=None):
    return defop(torch.linalg.multi_dot, name='multi_dot')(list(x))


def lu(x, pivot=True, get_infos=False, name=None):
    """paddle.linalg.lu: the packed LU factors and 1-based pivots (and
    zero infos when asked)."""
    def f(v):
        lu_mat, piv = torch.linalg.lu_factor(v, pivot=pivot)
        piv = piv.to(torch.int32)
        if get_infos:
            return lu_mat, piv, torch.zeros(v.shape[:-2], dtype=torch.int32,
                                            device=v.device)
        return lu_mat, piv
    return defop(f, name='lu')(x)


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(P, L, U) of paddle.linalg.lu's output, batched too."""
    def f(lu_mat, piv):
        if lu_mat.shape[-2] != lu_mat.shape[-1]:
            raise NotImplementedError('lu_unpack supports square matrices '
                                      'only')
        return tuple(torch.lu_unpack(lu_mat, piv))
    return defop(f, name='lu_unpack')(x, y)


def matrix_exp(x, name=None):
    return defop(torch.linalg.matrix_exp, name='matrix_exp')(x)


def matrix_norm(x, p='fro', axis=(-2, -1), keepdim=False, name=None):
    return defop(lambda v: torch.linalg.matrix_norm(
        v, ord=p, dim=tuple(axis), keepdim=keepdim), name='matrix_norm')(x)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return defop(lambda v: torch.linalg.vector_norm(
        v, ord=p, dim=_axes(axis), keepdim=keepdim), name='vector_norm')(x)


def vecdot(x, y, axis=-1, name=None):
    return defop(lambda a, b: torch.linalg.vecdot(a, b, dim=axis),
                 name='vecdot')(x, y)


def householder_product(x, tau, name=None):
    """Q of a QR factorization from Householder reflectors (LAPACK
    orgqr)."""
    return defop(torch.linalg.householder_product,
                 name='householder_product')(x, tau)


def ormqr(x, tau, other, left=True, transpose=False, name=None):
    """Multiply by the implicit full Q of geqrf's output (LAPACK ormqr):
    Q @ other, Q^T @ other, other @ Q or other @ Q^T."""
    return defop(lambda a, t, o: torch.ormqr(a, t, o, left=left,
                                             transpose=transpose),
                 name='ormqr')(x, tau, other)


def _rand_lowrank_q(a, q, niter, gen):
    """Randomized range finder (Halko et al. 2011): Q spans the top-q
    column space of a after `niter` power iterations."""
    r = torch.randn(a.shape[:-2] + (a.shape[-1], q), dtype=a.dtype,
                    device=a.device, generator=gen)
    qm, _ = torch.linalg.qr(a @ r)
    for _ in range(niter):
        qn, _ = torch.linalg.qr(a.transpose(-1, -2) @ qm)
        qm, _ = torch.linalg.qr(a @ qn)
    return qm


def _lowrank(a, k, niter):
    qm = _rand_lowrank_q(a, min(k, *a.shape[-2:]), niter,
                         framework.default_generator(a.device))
    u, s, vh = torch.linalg.svd(qm.transpose(-1, -2) @ a,
                                full_matrices=False)
    return qm @ u, s, vh.transpose(-1, -2)


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """Randomized top-q SVD (paddle.linalg.svd_lowrank; Halko et al.)."""
    def f(a, *m):
        return _lowrank(a - m[0] if m else a, q, niter)
    return defop(f, name='svd_lowrank')(*((x,) if M is None else (x, M)))


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """Randomized PCA (paddle.linalg.pca_lowrank): the top-q principal
    directions of the (optionally centered) data matrix."""
    def f(a):
        k = q if q is not None else min(6, *a.shape[-2:])
        if center:
            a = a - a.mean(dim=-2, keepdim=True)
        return _lowrank(a, k, niter)
    return defop(f, name='pca_lowrank')(x)
