"""One case per function of the op library, shared by
`tests/test_torch_ops.py` (the port against the JAX package on the CPU)
and `chip_smoke.py`'s op sweep (the port on the card against the port on
the CPU). It imports numpy only: a case names its op, how to make its
inputs from a seeded `np.random.RandomState`, and how to call it on
either package (`P` is `paddle_tpu` or `paddle_tpu_torch`).

Input specs: 'f3,4' normal float32; 'p3,4' float32 in [0.5, 2); 'u3,4'
float32 in (-0.9, 0.9); 'i3,4' int32 in [0, 5); 'n3,4' int32 in [1, 9);
'b3,4' bool; 's4' a symmetric positive definite float32 matrix; 'c3,4'
complex64; or a numpy array as it is. A case's float inputs get
gradients (`grad=False` turns that off for ops whose outputs do not
carry one, or whose two packages differentiate a tie or a branch
differently).
"""
from __future__ import annotations

import numpy as np

F32_RTOL, F32_ATOL = 1e-5, 1e-6


class Case:
    def __init__(self, name, *specs, args=(), kw=None, call=None, grad=True,
                 rtol=F32_RTOL, atol=F32_ATOL, method=None, numpy=None):
        self.name, self.specs, self.args = name, specs, args
        # where the JAX package's function is at fault, the expected
        # outputs as a numpy function of the inputs
        self.numpy = numpy
        self.kw = kw or {}
        self.call = call
        self.grad = grad
        self.rtol, self.atol = rtol, atol
        # the Tensor method of the same name is called too, unless the
        # case calls a custom form or the op is no method
        self.method = (method if method is not None
                       else call is None and name in METHODS)

    def inputs(self, seed=0):
        rng = np.random.RandomState(seed)
        return [make(s, rng) for s in self.specs]

    def run(self, P, tensors):
        if self.call is not None:
            return self.call(P, *tensors)
        return getattr(P, self.name)(*tensors, *self.args, **self.kw)

    def run_method(self, tensors):
        return getattr(tensors[0], self.name)(*tensors[1:], *self.args,
                                              **self.kw)


def make(spec, rng):
    if not isinstance(spec, str):
        return np.asarray(spec)
    kind, shape = spec[0], tuple(int(s) for s in spec[1:].split(',') if s)
    if kind == 'f':
        return rng.standard_normal(shape).astype(np.float32)
    if kind == 'p':
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)
    if kind == 'u':
        return rng.uniform(-0.9, 0.9, shape).astype(np.float32)
    if kind == 'i':
        return rng.randint(0, 5, shape).astype(np.int32)
    if kind == 'n':
        return rng.randint(1, 9, shape).astype(np.int32)
    if kind == 'b':
        return rng.rand(*shape) > 0.5
    if kind == 's':
        a = rng.standard_normal(shape * 2).astype(np.float32)
        return (a @ a.T + shape[0] * np.eye(shape[0])).astype(np.float32)
    if kind == 'c':
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)
    raise ValueError(spec)


def _index_add_np(x, i, v):
    out = x.copy()
    np.add.at(out, i, v)
    return out


IDX3 = np.array([2, 0, 1, 2], np.int32)      # rows of a 3-row input
SORTED = np.array([-1.5, -0.2, 0.3, 0.9, 2.0], np.float32)

_UNARY_ANY = ['abs', 'neg', 'sign', 'sin', 'cos', 'tan', 'atan', 'sinh',
              'cosh', 'tanh', 'asinh', 'erf', 'floor', 'ceil', 'round',
              'trunc', 'frac', 'square', 'sigmoid', 'exp', 'expm1',
              'deg2rad', 'rad2deg', 'positive', 'negative', 'sinc',
              'isnan', 'isinf', 'isfinite', 'isreal', 'signbit',
              'isposinf', 'isneginf', 'stanh']
_UNARY_POS = ['log', 'log2', 'log10', 'log1p', 'sqrt', 'rsqrt',
              'reciprocal', 'digamma', 'lgamma', 'i0', 'i1', 'acosh']
_UNARY_UNIT = ['asin', 'acos', 'atanh', 'erfinv', 'logit']
_NO_GRAD = {'sign', 'floor', 'ceil', 'round', 'trunc', 'isnan', 'isinf',
            'isfinite', 'isreal', 'signbit', 'isposinf', 'isneginf'}
_BINARY = ['add', 'subtract', 'multiply', 'divide', 'maximum', 'minimum',
           'fmax', 'fmin', 'atan2', 'hypot', 'copysign', 'logaddexp',
           'equal', 'not_equal', 'greater_than', 'greater_equal',
           'less_than', 'less_equal', 'isclose', 'nextafter', 'heaviside']
_BINARY_NO_GRAD = {'equal', 'not_equal', 'greater_than', 'greater_equal',
                   'less_than', 'less_equal', 'isclose', 'nextafter',
                   'heaviside', 'copysign'}
_LOGICAL = ['logical_and', 'logical_or', 'logical_xor']
_BITWISE = ['bitwise_and', 'bitwise_or', 'bitwise_xor', 'gcd', 'lcm',
            'floor_divide', 'mod', 'remainder', 'floor_mod',
            'bitwise_left_shift', 'bitwise_right_shift']


def _cases():
    c = []
    # -- math: elementwise -------------------------------------------------
    special = dict(rtol=1e-4, atol=1e-5)
    for n in _UNARY_ANY:
        c.append(Case(n, 'f3,4', grad=n not in _NO_GRAD))
    for n in _UNARY_POS:
        c.append(Case(n, 'p3,4' if n != 'acosh' else
                      np.float32([[1.5, 2.0, 3.0]]),
                      **(special if n in ('digamma', 'lgamma', 'i0', 'i1')
                         else {})))
    for n in _UNARY_UNIT:
        c.append(Case(n, 'u3,4' if n != 'logit' else
                      np.float32([[0.2, 0.5, 0.7]]),
                      **(special if n == 'erfinv' else {})))
    for n in _BINARY:
        c.append(Case(n, 'f3,4', 'f3,4', grad=n not in _BINARY_NO_GRAD))
    c.append(Case('pow', 'p3,4', 'f3,4', rtol=1e-4))
    c.append(Case('pow', 'f3,4', args=(2.0,), call=lambda P, x: P.pow(x, 2.0)))
    for n in _LOGICAL:
        c.append(Case(n, 'b3,4', 'b3,4', grad=False))
    c.append(Case('logical_not', 'b3,4', grad=False))
    c.append(Case('bitwise_not', 'i3,4', grad=False))
    for n in _BITWISE:
        c.append(Case(n, 'n3,4', 'n3,4' if 'shift' not in n
                      else np.int32([[1, 2, 0, 3]] * 3), grad=False))
    c.append(Case('mod', 'f3,4', 'p3,4', grad=False, call=lambda P, x, y:
                  P.mod(x, y)))
    c += [
        Case('inner', 'f3,4', 'f2,4'),
        Case('outer', 'f3', 'f4'),
        Case('ldexp', 'f3,4', 'n3,4', grad=False),
        Case('clip', 'f3,4', kw=dict(min=-0.5, max=0.7)),
        Case('lerp', 'f3,4', 'f3,4', 'u3,4'),
        Case('scale', 'f3,4', kw=dict(scale=2.0, bias=0.5)),
        Case('scale', 'f3,4', kw=dict(scale=2.0, bias=0.5,
                                      bias_after_scale=False),
             call=lambda P, x: P.scale(x, 2.0, 0.5, False)),
        Case('increment', 'f3,4', kw=dict(value=2.0)),
        Case('equal_all', 'f3,4', 'f3,4', grad=False),
        Case('equal_all', 'f3,4', call=lambda P, x: P.equal_all(x, x),
             grad=False),
        Case('allclose', 'f3,4', 'f3,4', grad=False),
        Case('nan_to_num', np.float32([[np.nan, np.inf, -np.inf, 1.5]]),
             grad=False),
        Case('conj', 'c3,4', grad=False),
        Case('real', 'c3,4', grad=False),
        Case('imag', 'c3,4', grad=False),
        Case('angle', 'c3,4', grad=False),
        Case('sgn', 'c3,4', grad=False),
        Case('sgn', 'f3,4', grad=False, call=lambda P, x: P.sgn(x)),
        Case('polar', 'p3,4', 'f3,4', grad=False),
        Case('complex', 'f3,4', 'f3,4', grad=False),
        Case('is_complex', 'c3,4', grad=False),
        Case('is_floating_point', 'f3,4', grad=False),
        Case('is_integer', 'i3,4', grad=False),
        Case('tensordot', 'f3,4,5', 'f4,5,2'),
        Case('tensordot', 'f3,4', 'f4,2', kw=dict(axes=[[1], [0]]),
             call=lambda P, x, y: P.tensordot(x, y, axes=[[1], [0]])),
        Case('cdist', 'f3,4', 'f5,4', rtol=1e-4, atol=1e-5),
        Case('cdist', 'f3,4', 'f5,4', call=lambda P, x, y: P.cdist(x, y,
                                                                   p=1.0),
             rtol=1e-4, atol=1e-5),
        Case('trapezoid', 'f3,5'),
        Case('trapezoid', 'f3,5', 'p5', call=lambda P, y, x:
             P.trapezoid(y, x)),
        Case('cumulative_trapezoid', 'f3,5'),
        Case('logcumsumexp', 'f3,4', kw=dict(axis=1), rtol=1e-4),
        Case('renorm', 'f3,4', kw=dict(p=2.0, axis=0, max_norm=1.0)),
        Case('trace', 'f4,4'),
        Case('polygamma', 'p3,4', kw=dict(n=1), rtol=1e-4, atol=1e-5),
        Case('multigammaln', 'p3,4', call=lambda P, x: P.multigammaln(
            x + 2.0, 3), rtol=1e-4, atol=1e-5),
        Case('logit', np.float32([[0.05, 0.5, 0.97]]), kw=dict(eps=0.1),
             call=lambda P, x: P.logit(x, 0.1)),
    ]
    # -- reductions --------------------------------------------------------
    for n in ('sum', 'mean', 'prod', 'max', 'min', 'amax', 'amin',
              'nansum', 'nanmean', 'logsumexp'):
        c.append(Case(n, 'f3,4,5', kw=dict(axis=1)))
        c.append(Case(n, 'f3,4,5', kw=dict(axis=[0, 2], keepdim=True),
                      call=lambda P, x, n=n: getattr(P, n)(
                          x, axis=[0, 2], keepdim=True)))
        c.append(Case(n, 'f3,4,5', call=lambda P, x, n=n: getattr(P, n)(x)))
    c += [
        Case('sum', 'i3,4', kw=dict(axis=0), grad=False,
             call=lambda P, x: P.sum(x, axis=0)),
        Case('all', 'b3,4', kw=dict(axis=1), grad=False),
        Case('any', 'b3,4', kw=dict(axis=1), grad=False),
        Case('std', 'f3,4,5', kw=dict(axis=1)),
        Case('std', 'f3,4,5', call=lambda P, x: P.std(x, unbiased=False)),
        Case('var', 'f3,4,5', kw=dict(axis=[0, 2], keepdim=True)),
        Case('median', 'f3,4', kw=dict(axis=1)),
        Case('median', 'f3,4', call=lambda P, x: P.median(x)),
        Case('quantile', 'f3,4', kw=dict(q=0.3, axis=1)),
        Case('quantile', 'f3,4', call=lambda P, x: P.quantile(
            x, [0.25, 0.75], axis=[0, 1], keepdim=True)),
        Case('nanmedian', np.float32([[1, np.nan, 3, 4], [2, 5, np.nan, 0]]),
             kw=dict(axis=1), grad=False),
        Case('nanquantile', np.float32([[1, np.nan, 3, 4], [2, 5, 1, 0]]),
             kw=dict(q=0.4, axis=1), grad=False),
        Case('cumsum', 'f3,4', kw=dict(axis=1)),
        Case('cumsum', 'f3,4', call=lambda P, x: P.cumsum(x)),
        Case('cumprod', 'u3,4', kw=dict(dim=1)),
        Case('cummax', 'f3,4', kw=dict(axis=1)),
        Case('cummin', 'f3,4', kw=dict(axis=0)),
        Case('count_nonzero', np.float32([[0, 1, 2], [0, 0, 3]]),
             kw=dict(axis=1), grad=False),
    ]
    # -- manipulation ------------------------------------------------------
    c += [
        Case('reshape', 'f2,3,4', args=([0, -1],)),
        Case('flatten', 'f2,3,4', kw=dict(start_axis=1)),
        Case('squeeze', 'f1,3,1,4', kw=dict(axis=[0, 2])),
        Case('squeeze', 'f1,3,1,4', call=lambda P, x: P.squeeze(x)),
        Case('unsqueeze', 'f3,4', kw=dict(axis=[0, 2])),
        Case('transpose', 'f2,3,4', args=([2, 0, 1],)),
        Case('t', 'f3,4'),
        Case('moveaxis', 'f2,3,4', args=(0, 2)),
        Case('swapaxes', 'f2,3,4', args=(0, 2)),
        Case('concat', 'f2,3', 'f4,3', call=lambda P, a, b: P.concat(
            [a, b], axis=0)),
        Case('stack', 'f2,3', 'f2,3', call=lambda P, a, b: P.stack(
            [a, b], axis=1)),
        Case('split', 'f4,6', args=(3,), kw=dict(axis=1)),
        Case('split', 'f4,6', call=lambda P, x: P.split(x, [2, -1, 1],
                                                        axis=1)),
        Case('chunk', 'f4,6', args=(2,)),
        Case('unbind', 'f3,4', kw=dict(axis=1)),
        Case('tile', 'f2,3', args=([2, 1, 2],)),
        Case('expand', 'f1,3', args=([4, -1],)),
        Case('expand_as', 'f1,3', 'f4,3', grad=False),
        Case('broadcast_to', 'f1,3', args=([2, 4, 3],)),
        Case('broadcast_tensors', 'f1,3', 'f4,1', call=lambda P, a, b:
             P.broadcast_tensors([a, b])),
        Case('flip', 'f3,4', kw=dict(axis=[0, 1])),
        Case('roll', 'f3,4', kw=dict(shifts=1, axis=1)),
        Case('rot90', 'f3,4', kw=dict(k=1)),
        Case('gather', 'f3,4', IDX3),
        Case('gather', 'f3,4', np.int32([1, 3]), kw=dict(axis=1),
             call=lambda P, x, i: P.gather(x, i, axis=1)),
        Case('gather_nd', 'f3,4', np.int32([[0, 1], [2, 3]])),
        Case('scatter', 'f4,3', np.int32([1, 3]), 'f2,3'),
        Case('scatter', 'f4,3', np.int32([1, 3]), 'f2,3',
             call=lambda P, x, i, u: P.scatter(x, i, u, overwrite=False)),
        Case('scatter_nd_add', 'f4,3', np.int32([[1], [3], [1]]), 'f3,3'),
        Case('scatter_nd', np.int32([[1], [3], [1]]), 'f3,3',
             call=lambda P, i, u: P.scatter_nd(i, u, [5, 3])),
        Case('index_select', 'f3,4', np.int32([3, 0]), kw=dict(axis=1)),
        Case('index_sample', 'f3,4', np.int32([[0, 3], [1, 1], [2, 0]])),
        # the JAX index_add calls the op `slice` where it means the builtin
        # (paddle_tpu/ops/manipulation.py:225) and raises: numpy stands in
        Case('index_add', 'f4,3', np.int32([0, 2]), 'f2,3',
             call=lambda P, x, i, v: P.index_add(x, i, 0, v),
             numpy=_index_add_np),
        Case('index_put', 'f4,3', np.int32([0, 3]), np.int32([1, 2]), 'f2',
             call=lambda P, x, i, j, v: P.index_put(x, [i, j], v)),
        Case('take_along_axis', 'f3,4', np.int32([[0], [3], [1]]),
             kw=dict(axis=1)),
        Case('put_along_axis', 'f3,4', np.int32([[0], [3], [1]]), 'f3,1',
             kw=dict(axis=1)),
        Case('put_along_axis', 'f3,4', np.int32([[0], [3], [1]]), 'f3,1',
             call=lambda P, x, i, v: P.put_along_axis(x, i, v, 1,
                                                      reduce='add')),
        Case('repeat_interleave', 'f3,4', args=(2,), kw=dict(axis=0)),
        Case('pad', 'f2,3', args=([1, 0, 2, 1],)),
        Case('pad', 'f1,1,3,4', call=lambda P, x: P.pad(x, [1, 2, 0, 1],
                                                        mode='reflect')),
        Case('diagonal', 'f3,4', kw=dict(offset=1)),
        Case('kron', 'f2,3', 'f2,2'),
        Case('diff', 'f3,5', kw=dict(axis=1)),
        Case('as_complex', 'f3,2', grad=False),
        Case('as_real', 'c3', grad=False),
        Case('view', 'f2,6', args=([3, 4],), method=False),
        Case('slice', 'f4,5', args=([0, 1], [1, 0], [3, -1])),
        Case('strided_slice', 'f4,6', args=([1], [5], [0], [-2])),
        Case('strided_slice', 'f4,6', call=lambda P, x: P.strided_slice(
            x, [0, 1], [0, 1], [4, 6], [2, 2])),
        Case('crop', 'f4,5', kw=dict(shape=[2, -1], offsets=[1, 2])),
        Case('shard_index', np.int32([[0], [5], [9], [12]]), grad=False,
             call=lambda P, x: P.shard_index(x, 16, 2, 1)),
        Case('atleast_1d', 'f', call=lambda P, x: P.atleast_1d(x)),
        Case('atleast_2d', 'f3', call=lambda P, x: P.atleast_2d(x)),
        Case('atleast_3d', 'f3', call=lambda P, x: P.atleast_3d(x)),
        Case('hstack', 'f2,3', 'f2,1', call=lambda P, a, b: P.hstack([a, b])),
        Case('vstack', 'f2,3', 'f1,3', call=lambda P, a, b: P.vstack([a, b])),
        Case('row_stack', 'f2,3', 'f1,3',
             call=lambda P, a, b: P.row_stack([a, b])),
        Case('dstack', 'f2,3', 'f2,3', call=lambda P, a, b: P.dstack([a, b])),
        Case('column_stack', 'f3', 'f3,2',
             call=lambda P, a, b: P.column_stack([a, b])),
        Case('unfold', 'f2,7', args=(1, 3, 2)),
        Case('cartesian_prod', 'f3', 'f2',
             call=lambda P, a, b: P.cartesian_prod([a, b])),
        Case('combinations', 'f4', kw=dict(r=2)),
        Case('block_diag', 'f2,2', 'f1,3',
             call=lambda P, a, b: P.block_diag([a, b])),
        Case('tensor_split', 'f7,2', args=(3,)),
        Case('tensor_split', 'f7,2', call=lambda P, x: P.tensor_split(
            x, [2, 5])),
        Case('hsplit', 'f2,6', args=(3,)),
        Case('vsplit', 'f6,2', args=(2,)),
        Case('dsplit', 'f2,2,6', args=(3,)),
        Case('unflatten', 'f2,12', args=(1, [3, -1])),
        Case('view_as', 'f2,6', 'f3,4', grad=False),
        Case('take', 'f3,4', np.int32([0, 5, -1, 11])),
        Case('take', 'f3,4', np.int32([0, 5, -1, 14]),
             call=lambda P, x, i: P.take(x, i, mode='clip')),
        Case('select_scatter', 'f3,4', 'f4', args=(0, 1)),
        Case('slice_scatter', 'f4,6', 'f2,3',
             args=([0, 1], [0, 1], [4, 6], [2, 2])),
        Case('masked_scatter', 'f3,4', 'b3,4', 'f12'),
        Case('index_fill', 'f3,4', np.int32([0, 2]), args=(1, 2.5)),
        Case('reshape_', 'f2,3,4', args=([6, 4],), grad=False),
        Case('flatten_', 'f2,3,4', grad=False),
        Case('scatter_', 'f4,3', np.int32([1, 3]), 'f2,3', grad=False),
        Case('rsqrt_', 'p3,4', grad=False),
    ]
    # -- search ------------------------------------------------------------
    c += [
        Case('argmax', 'f3,4', kw=dict(axis=1), grad=False),
        Case('argmax', 'f3,4', grad=False, call=lambda P, x: P.argmax(x)),
        Case('argmin', 'f3,4', kw=dict(axis=0, keepdim=True), grad=False),
        Case('topk', 'f3,6', args=(2,)),
        Case('topk', 'f3,6', call=lambda P, x: P.topk(x, 2, axis=0,
                                                      largest=False)),
        Case('sort', 'f3,6', kw=dict(axis=1, descending=True)),
        Case('argsort', 'f3,6', kw=dict(axis=1), grad=False),
        Case('where', 'b3,4', 'f3,4', 'f3,4'),
        Case('where', 'b3,4', grad=False, call=lambda P, c: P.where(c)),
        Case('nonzero', 'b3,4', grad=False),
        Case('nonzero', 'b3,4', grad=False, call=lambda P, x: P.nonzero(
            x, as_tuple=True)),
        Case('masked_select', 'f3,4', 'b3,4', grad=False),
        Case('masked_fill', 'f3,4', 'b3,4', args=(-1.5,)),
        Case('unique', np.int32([3, 1, 3, 0, 1, 1]), grad=False,
             kw=dict(return_index=True, return_inverse=True,
                     return_counts=True)),
        Case('unique_consecutive', np.int32([1, 1, 2, 2, 2, 3, 1]),
             grad=False, kw=dict(return_inverse=True, return_counts=True)),
        Case('searchsorted', SORTED, 'f3,4', grad=False),
        Case('bucketize', 'f3,4', SORTED, grad=False, method=False),
        Case('kthvalue', 'f3,6', args=(2,)),
        Case('mode', np.int32([[1, 2, 2, 3], [4, 4, 1, 1]]), grad=False),
        Case('is_empty', 'f3,0', grad=False, method=False),
        Case('isin', np.int32([1, 2, 3, 4]), np.int32([2, 4]), grad=False),
    ]
    # -- linalg ------------------------------------------------------------
    lt = dict(rtol=1e-4, atol=1e-5)
    c += [
        Case('matmul', 'f3,4', 'f4,5'),
        Case('matmul', 'f2,3,4', 'f2,5,4', call=lambda P, a, b: P.matmul(
            a, b, transpose_y=True)),
        Case('mm', 'f3,4', 'f4,5'),
        Case('bmm', 'f2,3,4', 'f2,4,5'),
        Case('dot', 'f3,4', 'f3,4'),
        Case('mv', 'f3,4', 'f4'),
        Case('addmm', 'f3,5', 'f3,4', 'f4,5', kw=dict(beta=0.5, alpha=2.0),
             method=False),
        Case('einsum', 'f3,4', 'f4,5', call=lambda P, a, b: P.einsum(
            'ij,jk->ik', a, b)),
        Case('norm', 'f3,4'),
        Case('norm', 'f3,4', call=lambda P, x: P.norm(x, p=1, axis=1)),
        Case('norm', 'f3,4', call=lambda P, x: P.norm(x, p=float('inf'),
                                                      axis=0)),
        Case('dist', 'f3,4', 'f3,4'),
        Case('cross', 'f4,3', 'f4,3'),
        Case('histogram', 'f20', kw=dict(bins=5, min=-2, max=2), grad=False),
        Case('bincount', np.int32([0, 3, 1, 3, 3]), grad=False,
             method=False),
        Case('matrix_power', 's3', args=(3,), **lt),
        Case('cholesky', 's4', **lt),
        Case('inv', 's4', **lt),
        Case('det', 's3', method=False, **lt),
        Case('slogdet', 's3', method=False, **lt),
        Case('pinv', 'f4,3', method=False, **lt),
        Case('solve', 's4', 'f4,2', method=False, **lt),
        Case('lstsq', 'f5,3', 'f5,2', method=False, grad=False,
             call=lambda P, a, b: P.lstsq(a, b)[0], **lt),
        Case('matrix_rank', 'f4,3', method=False, grad=False),
        Case('qr', 'f4,3', method=False, grad=False,
             call=lambda P, x: [abs(t) for t in P.qr(x)], **lt),
        Case('svd', 'f4,3', method=False, grad=False,
             call=lambda P, x: P.svd(x)[1], **lt),
        Case('eigh', 's4', method=False, grad=False,
             call=lambda P, x: P.eigh(x)[0], **lt),
        Case('eigvalsh', 's4', method=False, **lt),
        Case('eig', 's4', method=False, grad=False,
             call=lambda P, x: P.sort(P.real(P.eig(x)[0])), **lt),
        Case('eigvals', 's4', method=False, grad=False,
             call=lambda P, x: P.sort(P.real(P.eigvals(x))), **lt),
        Case('triangular_solve', 's4', 'f4,2', method=False,
             call=lambda P, a, b: P.triangular_solve(P.triu(a), b), **lt),
        Case('cholesky_solve', 'f4,2', 's4', method=False,
             call=lambda P, b, a: P.cholesky_solve(b, P.cholesky(a)), **lt),
        Case('cond', 's4', method=False, grad=False, **lt),
        Case('cov', 'f3,6', method=False, **lt),
        Case('corrcoef', 'f3,6', method=False, **lt),
        Case('multi_dot', 'f3,4', 'f4,5', 'f5,2', method=False,
             call=lambda P, a, b, d: P.multi_dot([a, b, d]), **lt),
        Case('lu', 's4', method=False, grad=False,
             call=lambda P, x: P.lu(x)[0], **lt),
        Case('lu_unpack', 's4', method=False, grad=False,
             call=lambda P, x: P.lu_unpack(*P.lu(x)), **lt),
        Case('matrix_exp', 'u3,3', method=False, **lt),
        Case('matrix_norm', 'f3,4', method=False, **lt),
        Case('vector_norm', 'f3,4', kw=dict(p=3.0, axis=1), method=False,
             **lt),
        Case('vecdot', 'f3,4', 'f3,4', method=False),
        Case('householder_product', 'f4,3', 'u3', method=False,
             grad=False, **lt),
        Case('ormqr', 'f4,3', 'u3', 'f4,2', method=False, grad=False, **lt),
    ]
    # -- creation (deterministic) ------------------------------------------
    c += [
        Case('to_tensor', 'f3,4', grad=False, method=False),
        Case('zeros', grad=False, call=lambda P: P.zeros([2, 3])),
        Case('ones', grad=False, call=lambda P: P.ones([2, 3], 'int32')),
        Case('full', grad=False, call=lambda P: P.full([2, 3], 1.5)),
        Case('empty', grad=False, call=lambda P: P.empty([2, 3]) * 0),
        Case('zeros_like', 'f2,3', grad=False, method=False),
        Case('ones_like', 'f2,3', grad=False, method=False),
        Case('full_like', 'f2,3', args=(2.5,), grad=False, method=False),
        Case('empty_like', 'f2,3', grad=False, method=False,
             call=lambda P, x: P.empty_like(x) * 0),
        Case('arange', grad=False, call=lambda P: P.arange(1, 10, 2)),
        Case('arange', grad=False, call=lambda P: P.arange(0.0, 1.0, 0.25)),
        Case('linspace', grad=False, call=lambda P: P.linspace(0, 1, 5)),
        Case('logspace', grad=False, call=lambda P: P.logspace(0, 2, 3)),
        Case('eye', grad=False, call=lambda P: P.eye(3, 4)),
        Case('diag', 'f3', method=False),
        Case('diag', 'f3', call=lambda P, x: P.diag(x, offset=1,
                                                    padding_value=2.0)),
        Case('diag', 'f3,4', call=lambda P, x: P.diag(x, offset=-1)),
        Case('diagflat', 'f2,2', method=False),
        Case('meshgrid', 'f3', 'f2', call=lambda P, a, b: P.meshgrid(a, b),
             grad=False),
        Case('tril', 'f3,4', kw=dict(diagonal=1), method=False),
        Case('triu', 'f3,4', kw=dict(diagonal=-1), method=False),
        Case('tril_indices', grad=False, call=lambda P: P.tril_indices(3, 4,
                                                                       1)),
        Case('triu_indices', grad=False, call=lambda P: P.triu_indices(3, 3)),
        Case('assign', 'f2,3', grad=False, method=False),
        Case('clone', 'f2,3', method=False),
        Case('numel', 'f2,3', grad=False, method=False),
        Case('is_tensor', 'f2,3', grad=False, method=False),
        Case('shape', 'f2,3', grad=False, method=False),
        Case('rank', 'f2,3', grad=False, method=False),
        Case('one_hot', np.int32([0, 3, 1]), args=(4,), grad=False,
             method=False),
        Case('vander', 'f3', kw=dict(n=4), method=False),
        Case('vander', 'f3', call=lambda P, x: P.vander(x, increasing=True)),
        Case('create_parameter', grad=False, call=lambda P: P.create_parameter(
            [2, 3], is_bias=True)),
    ]
    return c


# the Tensor methods of the JAX package's table (ops/__init__.py)
METHODS = {
    'add', 'subtract', 'multiply', 'divide', 'floor_divide', 'mod',
    'remainder', 'pow', 'maximum', 'minimum', 'exp', 'expm1', 'log', 'log2',
    'log10', 'log1p', 'sqrt', 'rsqrt', 'abs', 'neg', 'sign', 'sin', 'cos',
    'tan', 'asin', 'acos', 'atan', 'sinh', 'cosh', 'tanh', 'asinh', 'acosh',
    'atanh', 'erf', 'erfinv', 'floor', 'ceil', 'round', 'trunc', 'frac',
    'reciprocal', 'square', 'sigmoid', 'clip', 'lerp', 'scale', 'increment',
    'digamma', 'lgamma', 'nan_to_num', 'logit', 'atan2', 'outer', 'inner',
    'logaddexp', 'equal', 'not_equal', 'greater_than', 'greater_equal',
    'less_than', 'less_equal', 'equal_all', 'allclose', 'isclose',
    'logical_and', 'logical_or', 'logical_xor', 'logical_not', 'bitwise_and',
    'bitwise_or', 'bitwise_xor', 'bitwise_not', 'isnan', 'isinf', 'isfinite',
    'deg2rad', 'rad2deg', 'conj', 'real', 'imag', 'angle', 'sgn',
    'trapezoid', 'cumulative_trapezoid', 'logcumsumexp', 'is_complex',
    'is_floating_point', 'is_integer', 'sum', 'mean', 'prod', 'max', 'min',
    'amax', 'amin', 'all', 'any', 'std', 'var', 'median', 'quantile',
    'logsumexp', 'cumsum', 'cumprod', 'cummax', 'cummin', 'count_nonzero',
    'nansum', 'nanmean', 'nanmedian', 'nanquantile', 'reshape', 'reshape_',
    'flatten', 'squeeze', 'unsqueeze', 'transpose', 't', 'moveaxis',
    'swapaxes', 'split', 'chunk', 'unbind', 'tile', 'expand', 'expand_as',
    'broadcast_to', 'flip', 'roll', 'rot90', 'gather', 'gather_nd',
    'scatter', 'scatter_', 'scatter_nd_add', 'index_select', 'index_sample',
    'index_add', 'index_put', 'take_along_axis', 'put_along_axis',
    'repeat_interleave', 'pad', 'diagonal', 'kron', 'diff', 'as_complex',
    'as_real', 'slice', 'strided_slice', 'unfold', 'matmul', 'mm', 'bmm',
    'dot', 'mv', 'norm', 'dist', 'cross', 'histogram', 'matrix_power',
    'cholesky', 'inv', 'argmax', 'argmin', 'topk', 'sort', 'argsort',
    'where', 'nonzero', 'masked_select', 'masked_fill', 'unique',
    'unique_consecutive', 'searchsorted', 'kthvalue', 'mode', 'isin',
}

# the random creators: checked for shape, dtype, device and moments
RANDOM = ('rand', 'randn', 'standard_normal', 'randint', 'randperm',
          'normal', 'uniform', 'bernoulli', 'multinomial', 'poisson',
          'standard_gamma', 'svd_lowrank', 'pca_lowrank')

CASES = _cases()
