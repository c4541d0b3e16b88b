"""The op library of the port against the JAX package's, on the CPU.

One case per function (`tests/torch_op_cases.py`): the same seeded numpy
inputs go through `paddle_tpu` and `paddle_tpu_torch`, and the outputs
must agree, and for float ops the gradients of a seeded weighted sum of
the outputs with respect to every float input, through `paddle.grad` on
both sides. Each case whose op is a Tensor method runs in its method
form too. Tolerance: f32 rtol 1e-5, atol 1e-6, or a case's own where
the JAX test's is looser (special functions, linear algebra: rtol 1e-4,
atol 1e-5). Dtypes must agree through `same_dtype`: the JAX package's
int32 stands for an int64 of the port where jax's x64 flag narrowed it
(ROADMAP.md, "Differences that are not faults"). The random creators
are checked for shape, dtype, device and moments, not values: the JAX
package draws from threefry and the port from torch's Philox.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from torch_op_cases import CASES, METHODS, RANDOM


@pytest.fixture(autouse=True, scope='module')
def _cpu_place():
    ptt.set_device('cpu')
    yield
    ptt.set_device('gpu')


def _ids(cases):
    seen, ids = {}, []
    for c in cases:
        k = seen[c.name] = seen.get(c.name, -1) + 1
        ids.append(c.name if k == 0 else f'{c.name}-{k}')
    return ids


def same_dtype(jax_dtype, torch_dtype) -> bool:
    """The JAX dtype's name, with int32 standing for int64 (x64 off)."""
    j = str(np.dtype(jax_dtype)) if str(jax_dtype) != 'bfloat16' \
        else 'bfloat16'
    t = str(torch_dtype).replace('torch.', '')
    return j == t or (j == 'int32' and t == 'int64')


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x.numpy() if hasattr(x, 'numpy') else x)


def _dtype(x):
    return getattr(x, 'dtype', None)


def _tensors(P, arrays, grad):
    return [P.to_tensor(a, stop_gradient=not (grad and a.dtype.kind == 'f'))
            for a in arrays]


def _grads(P, out, ts):
    """Gradients of sum(out_i * w_i) over the float outputs, w seeded."""
    rng = np.random.RandomState(7)
    terms = []
    for o in _leaves(out):
        if getattr(o, 'stop_gradient', True):
            continue
        w = rng.standard_normal(o.shape).astype(np.float32)
        terms.append((o * P.to_tensor(w)).sum())
    wrt = [t for t in ts if not t.stop_gradient]
    if not terms or not wrt:
        return []
    loss = terms[0]
    for t in terms[1:]:
        loss = loss + t
    gs = P.grad(loss, wrt, allow_unused=True)
    return [None if g is None else _np(g) for g in gs]


def _compare(case, got, want, what):
    got_l, want_l = _leaves(got), _leaves(want)
    assert len(got_l) == len(want_l), f'{what}: {len(got_l)} outputs, ' \
        f'JAX {len(want_l)}'
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        if _dtype(w) is not None and _dtype(g) is not None:
            assert same_dtype(_dtype(w), _dtype(g)), \
                f'{what}[{i}]: dtype {_dtype(g)}, JAX {_dtype(w)}'
        gv, wv = _np(g), _np(w)
        assert gv.shape == wv.shape, f'{what}[{i}]: shape {gv.shape}, JAX ' \
            f'{wv.shape}'
        if gv.dtype.kind in 'fc':
            np.testing.assert_allclose(gv, wv, rtol=case.rtol, atol=case.atol,
                                       equal_nan=True, err_msg=f'{what}[{i}]')
        else:
            np.testing.assert_array_equal(gv, wv, err_msg=f'{what}[{i}]')


@pytest.mark.parametrize('case', CASES, ids=_ids(CASES))
def test_op_matches_jax(case):
    arrays = case.inputs()
    tt = _tensors(ptt, arrays, case.grad)
    got = case.run(ptt, tt)
    if case.numpy is not None:      # the JAX function is at fault
        _compare(case, got, case.numpy(*arrays), case.name)
        return
    jt = _tensors(paddle, arrays, case.grad)
    want = case.run(paddle, jt)
    _compare(case, got, want, case.name)
    if case.grad:
        gw = _grads(paddle, want, jt)
        gg = _grads(ptt, got, tt)
        assert len(gg) == len(gw)
        for i, (g, w) in enumerate(zip(gg, gw)):
            assert (g is None) == (w is None), f'grad[{i}] presence'
            if w is not None:
                np.testing.assert_allclose(
                    g, w, rtol=case.rtol, atol=max(case.atol, 1e-6),
                    err_msg=f'{case.name} grad[{i}]')


_METHOD_CASES = [c for c in CASES if c.method]


@pytest.mark.parametrize('case', _METHOD_CASES, ids=_ids(_METHOD_CASES))
def test_method_form_matches_jax(case):
    arrays = case.inputs()
    got = case.run_method(_tensors(ptt, arrays, False))
    want = (case.numpy(*arrays) if case.numpy is not None
            else case.run_method(_tensors(paddle, arrays, False)))
    _compare(case, got, want, f'{case.name} (method)')


def test_every_op_has_a_case_and_every_method_is_attached():
    from paddle_tpu.ops import (creation, linalg, manipulation, math,
                                reduction, search)
    names = {n for m in (creation, math, reduction, manipulation, search,
                         linalg)
             for n, v in vars(m).items()
             if callable(v) and not n.startswith('_') and n != 'defop'
             and getattr(v, '__module__', '').startswith('paddle_tpu.ops')}
    covered = {c.name for c in CASES} | set(RANDOM)
    assert not sorted(names - covered)
    for n in METHODS:
        assert callable(getattr(ptt.Tensor, n)), n


@pytest.mark.parametrize('name', RANDOM)
def test_random_creators_shape_dtype_device_moments(name):
    ptt.seed(3)
    paddle.seed(3)
    n = 20000
    calls = {
        'rand': (lambda P: P.rand([n]), 0.5, 1 / 12),
        'randn': (lambda P: P.randn([n]), 0.0, 1.0),
        'standard_normal': (lambda P: P.standard_normal([n]), 0.0, 1.0),
        'randint': (lambda P: P.randint(0, 10, [n]), 4.5, 8.25),
        'randperm': (lambda P: P.randperm(n), (n - 1) / 2, (n * n - 1) / 12),
        'normal': (lambda P: P.normal(1.0, 2.0, [n]), 1.0, 4.0),
        'uniform': (lambda P: P.uniform([n], min=-2.0, max=2.0), 0.0, 4 / 3),
        'bernoulli': (lambda P: P.bernoulli(P.full([n], 0.3)), 0.3, 0.21),
        'multinomial': (lambda P: P.multinomial(
            P.to_tensor(np.float32([0.2, 0.3, 0.5])), n, replacement=True),
            1.3, 0.61),
        'poisson': (lambda P: P.poisson(P.full([n], 4.0)), 4.0, 4.0),
        'standard_gamma': (lambda P: P.standard_gamma(P.full([n], 2.0)),
                           2.0, 2.0),
    }
    if name in ('svd_lowrank', 'pca_lowrank'):
        a = np.random.RandomState(0).standard_normal((20, 8)).astype(
            np.float32)
        a[:, 0] *= 30.0
        a[:, 1] *= 10.0
        kw = dict(q=2) if name == 'svd_lowrank' else dict(q=2, center=False)
        s_t = getattr(ptt.linalg, name)(ptt.to_tensor(a), **kw)[1].numpy()
        s_j = np.asarray(getattr(paddle.linalg, name)(paddle.to_tensor(a),
                                                      **kw)[1])
        np.testing.assert_allclose(s_t, s_j, rtol=1e-3)
        return
    fn, mean, var = calls[name]
    got, want = fn(ptt), fn(paddle)
    assert got.shape == want.shape
    assert same_dtype(want.dtype, got.dtype), (want.dtype, got.dtype)
    assert got.place == ptt.CPUPlace(0)
    v = got.numpy().astype(np.float64)
    assert abs(v.mean() - mean) < 4 * np.sqrt(var / v.size) + 1e-9
    assert abs(v.var() - var) < 0.05 * var
