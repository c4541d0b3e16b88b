"""`incubate` and `geometric` of the port against the JAX package's, on
the CPU.

The same seeded numpy inputs and weights go through `paddle_tpu` and
`paddle_tpu_torch`. On the CPU the port's kernels take their plain
versions: `fused_rms_norm` the RMSNorm kernel's, the attention entries
the flash kernels' (the JAX package's flash path runs its XLA twin on the
CPU); the card runs the kernels (tests/test_torch_cuda.py,
chip_smoke.py phase 14). Tolerances: f32 rtol 1e-5 and atol 1e-5 of the
output's scale (sums in another order); gradients 1e-4; the segment ops
and the optimizers' weights rtol 1e-6.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu import geometric as jgeo
from paddle_tpu.incubate import autograd as jia
from paddle_tpu.incubate.nn import functional as jIF
from paddle_tpu_torch import geometric as tgeo
from paddle_tpu_torch import incubate as tinc
from paddle_tpu_torch.incubate import autograd as tia
from paddle_tpu_torch.incubate.nn import functional as tIF
from paddle_tpu_torch.ops import kernels as K


@pytest.fixture(autouse=True, scope='module')
def _cpu_place():
    ptt.set_device('cpu')
    yield
    ptt.set_device('gpu')


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x.numpy())


def _close(got, want, tol=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _rng(seed):
    return np.random.default_rng(seed)


def _pair(a):
    return paddle.to_tensor(a), ptt.to_tensor(a)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# -- the fused entries ------------------------------------------------------

def test_fused_linear_and_matmul_bias_match_jax():
    rng = _rng(0)
    x, w, b = _f32(rng, 3, 5, 8), _f32(rng, 8, 6), _f32(rng, 6)
    (jx, tx), (jw, tw), (jb, tb) = _pair(x), _pair(w), _pair(b)
    _close(tIF.fused_linear(tx, tw, tb), jIF.fused_linear(jx, jw, jb))
    wt = _pair(np.ascontiguousarray(w.T))
    _close(tIF.fused_linear(tx, wt[1], transpose_weight=True),
           jIF.fused_linear(jx, wt[0], transpose_weight=True))
    y = _pair(_f32(rng, 3, 6, 8))
    _close(tIF.fused_matmul_bias(tx, y[1], transpose_y=True),
           jIF.fused_matmul_bias(jx, y[0], transpose_y=True))
    _close(tIF.fused_matmul_bias(tx, tw, tb), jIF.fused_matmul_bias(jx, jw,
                                                                     jb))


def test_fused_dropout_add_and_swiglu_match_jax():
    rng = _rng(1)
    x, y = _f32(rng, 4, 16), _f32(rng, 4, 16)
    (jx, tx), (jy, ty) = _pair(x), _pair(y)
    _close(tIF.fused_dropout_add(tx, ty, p=0.3, training=False),
           jIF.fused_dropout_add(jx, jy, p=0.3, training=False))
    _close(tIF.swiglu(tx), jIF.swiglu(jx))
    _close(tIF.swiglu(tx, ty), jIF.swiglu(jx, jy))
    # in training, a dropped element is 0 and a kept one (x / (1 - p)) + y
    out = _np(tIF.fused_dropout_add(tx, ty, p=0.5, training=True))
    kept = ~np.isclose(out, y)
    np.testing.assert_allclose(out[kept], (x / 0.5 + y)[kept], rtol=1e-5)
    assert 0 < kept.mean() < 1


@pytest.mark.parametrize('weight,bias', [(True, False), (True, True),
                                         (False, False)])
def test_fused_rms_norm_is_the_rms_kernel(weight, bias):
    """fused_rms_norm against the JAX chain (RMSNorm, times the weight,
    plus the bias), through the port's RMSNorm kernel: one `rms_norm`
    wrapper call per use (its plain version on the CPU)."""
    rng = _rng(2)
    x = _f32(rng, 2, 7, 64, scale=3.0)
    w, b = _f32(rng, 64), _f32(rng, 64)
    jx, tx = _pair(x)
    jw, tw = _pair(w) if weight else (None, None)
    jb, tb = _pair(b) if bias else (None, None)
    calls = []
    real = K.rms_norm
    K.rms_norm = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        got = tIF.fused_rms_norm(tx, tw, tb, epsilon=1e-5)
    finally:
        K.rms_norm = real
    assert calls == [1]
    _close(got, jIF.fused_rms_norm(jx, jw, jb, epsilon=1e-5))
    with pytest.raises(NotImplementedError):
        tIF.fused_rms_norm(tx, tw, begin_norm_axis=1)


def test_fused_layer_norm_matches_jax():
    rng = _rng(3)
    x, w, b = _f32(rng, 3, 32), _f32(rng, 32), _f32(rng, 32)
    (jx, tx), (jw, tw), (jb, tb) = _pair(x), _pair(w), _pair(b)
    _close(tIF.fused_layer_norm(tx, tw, tb), jIF.fused_layer_norm(jx, jw, jb))


def _mha_weights(rng, e, n, h):
    return dict(qkv_weight=_f32(rng, 3, n, h, e, scale=0.2),
                qkv_bias=_f32(rng, 3, n, h, scale=0.1),
                linear_weight=_f32(rng, n * h, e, scale=0.2),
                linear_bias=_f32(rng, e, scale=0.1),
                pre_ln_scale=_f32(rng, e), pre_ln_bias=_f32(rng, e),
                ln_scale=_f32(rng, e), ln_bias=_f32(rng, e))


@pytest.mark.parametrize('pre_ln', [True, False])
@pytest.mark.parametrize('mask', [False, True])
def test_fused_multi_head_attention_matches_jax(pre_ln, mask):
    """The attention block at head_dim 64 (the flash path unmasked, the
    plain one under a mask), forward and gradients of x and qkv_weight."""
    rng = _rng(4 + pre_ln + 2 * mask)
    b, s, n, h = 2, 9, 2, 64
    e = n * h
    x = _f32(rng, b, s, e)
    ws = _mha_weights(rng, e, n, h)
    m = (np.tril(np.ones((s, s), bool))[None, None] if mask else None)
    jx, tx = _pair(x)
    jx.stop_gradient = tx.stop_gradient = False
    jw = {k: paddle.to_tensor(v) for k, v in ws.items()}
    tw = {k: ptt.to_tensor(v) for k, v in ws.items()}
    jw['qkv_weight'].stop_gradient = False
    tw['qkv_weight'].stop_gradient = False
    kw = dict(pre_layer_norm=pre_ln, dropout_rate=0.0, attn_dropout_rate=0.0)
    jout = jIF.fused_multi_head_attention(
        jx, attn_mask=None if m is None else paddle.to_tensor(m), **jw, **kw)
    tout = tIF.fused_multi_head_attention(
        tx, attn_mask=None if m is None else ptt.to_tensor(m), **tw, **kw)
    _close(tout, jout)
    jg = paddle.grad((jout ** 2).sum(), [jx, jw['qkv_weight']])
    tg = ptt.grad((tout ** 2).sum(), [tx, tw['qkv_weight']])
    for g, want in zip(tg, jg):
        _close(g, want, 1e-4)


def test_fused_feedforward_matches_jax():
    rng = _rng(5)
    x = _f32(rng, 2, 5, 16)
    ws = dict(linear1_weight=_f32(rng, 16, 32), linear2_weight=_f32(rng, 32,
                                                                     16),
              linear1_bias=_f32(rng, 32), linear2_bias=_f32(rng, 16),
              ln1_scale=_f32(rng, 16), ln1_bias=_f32(rng, 16),
              ln2_scale=_f32(rng, 16), ln2_bias=_f32(rng, 16))
    jx, tx = _pair(x)
    for pre in (True, False):
        for act in ('relu', 'gelu'):
            kw = dict(dropout1_rate=0.0, dropout2_rate=0.0, activation=act,
                      pre_layer_norm=pre)
            _close(tIF.fused_feedforward(
                tx, **{k: ptt.to_tensor(v) for k, v in ws.items()}, **kw),
                jIF.fused_feedforward(
                jx, **{k: paddle.to_tensor(v) for k, v in ws.items()}, **kw))


@pytest.mark.parametrize('neox', [True, False], ids=['neox', 'gptj'])
@pytest.mark.parametrize('given', ['default', 'sin_cos', 'position_ids'])
def test_fused_rotary_position_embedding_matches_jax(neox, given):
    rng = _rng(6)
    b, s, n, h = 2, 7, 3, 16
    q, k, v = (_f32(rng, b, s, n, h) for _ in range(3))
    jargs, targs = {}, {}
    if given == 'sin_cos':
        ang = rng.random((1, s, 1, h)).astype(np.float32)
        (jargs['sin'], targs['sin']) = _pair(np.sin(ang))
        (jargs['cos'], targs['cos']) = _pair(np.cos(ang))
    if given == 'position_ids':
        pos = rng.integers(0, 12, (b, s)).astype(np.int64)
        (jargs['position_ids'], targs['position_ids']) = _pair(pos)
    jout = jIF.fused_rotary_position_embedding(
        *(paddle.to_tensor(a) for a in (q, k, v)),
        use_neox_rotary_style=neox, **jargs)
    tout = tIF.fused_rotary_position_embedding(
        *(ptt.to_tensor(a) for a in (q, k, v)),
        use_neox_rotary_style=neox, **targs)
    for got, want in zip(tout, jout):
        _close(got, want)
    assert tIF.fused_rotary_position_embedding(ptt.to_tensor(q))[1:] == \
        (None, None)


@pytest.mark.parametrize('scale', [None, 0.3])
@pytest.mark.parametrize('bias', [False, True])
def test_memory_efficient_attention_matches_jax(scale, bias):
    """At BERT's head width (64): the flash path without a bias, the
    plain one with; `scale` multiplies q by scale * sqrt(D) first, as in
    the JAX package."""
    rng = _rng(7)
    q, k, v = (_f32(rng, 2, 11, 4, 64) for _ in range(3))
    ab = _f32(rng, 2, 4, 11, 11) if bias else None
    got = tinc.nn.memory_efficient_attention(
        *(ptt.to_tensor(a) for a in (q, k, v)),
        attn_bias=None if ab is None else ptt.to_tensor(ab), scale=scale)
    want = paddle.incubate.nn.memory_efficient_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)),
        attn_bias=None if ab is None else paddle.to_tensor(ab), scale=scale)
    _close(got, want)


# -- incubate.autograd ------------------------------------------------------

def _t2(a):
    return paddle.to_tensor(np.asarray(a, np.float32)), \
        ptt.to_tensor(np.asarray(a, np.float32))


def test_jvp_vjp_match_jax():
    jx, tx = _t2([1.0, 2.0, 3.0])
    jv, tv = _t2([2.0, 0.0, 1.0])
    for f in (lambda a: a ** 3, lambda a: (a * a).sum() * a):
        for kw in ({}, 'v'):
            ja = (jv,) if kw else ()
            ta = (tv,) if kw else ()
            jo, jt = jia.jvp(f, jx, *ja)
            to, tt = tia.jvp(f, tx, *ta)
            _close(to, jo)
            _close(tt, jt)
            jo, jg = jia.vjp(f, jx, *ja)
            to, tg = tia.vjp(f, tx, *ta)
            _close(tg, jg)


def test_vjp_multi_output_matches_jax():
    jx, tx = _t2([1.0, 2.0])
    f = lambda a: (a * 2, a * 3)    # noqa: E731
    (jo, jg), (to, tg) = jia.vjp(f, jx), tia.vjp(f, tx)
    assert isinstance(to, tuple) and len(to) == 2
    _close(tg, jg)
    cot_j = [_t2([1.0, 0.0])[0], _t2([0.0, 1.0])[0]]
    cot_t = [_t2([1.0, 0.0])[1], _t2([0.0, 1.0])[1]]
    _close(tia.vjp(f, tx, v=cot_t)[1], jia.vjp(f, jx, v=cot_j)[1])
    with pytest.raises(ValueError, match='cotangents'):
        tia.vjp(f, tx, v=cot_t[:1])


@pytest.mark.parametrize('batched', [False, True])
def test_jacobian_hessian_match_jax(batched):
    rng = _rng(8)
    x, y = _f32(rng, 3, 4) if batched else _f32(rng, 4), _f32(rng, 1)
    (jx, tx), (jy, ty) = _pair(x), _pair(y)
    if batched:
        f = lambda a: a ** 2 * 3    # noqa: E731
        _close(tia.Jacobian(f, tx, is_batched=True)[:],
               jia.Jacobian(f, jx, is_batched=True)[:])
        return
    g2 = lambda a, b: a * b[0]      # noqa: E731
    J = tia.Jacobian(g2, [tx, ty])
    _close(J[:], jia.Jacobian(g2, [jx, jy])[:])
    assert J.shape == [4, 5]
    h = lambda a, b: (a * a * b[0]).sum() + (a ** 3).sum()   # noqa: E731
    _close(tia.Hessian(h, [tx, ty])[:], jia.Hessian(h, [jx, jy])[:])
    h1 = lambda a: (a ** 3).sum()   # noqa: E731
    _close(tia.Hessian(h1, tx)[:], jia.Hessian(h1, jx)[:])


# -- incubate.optimizer -----------------------------------------------------

def _linear_pair(seed):
    paddle.seed(seed)
    jm = paddle.nn.Linear(4, 1)
    tm = ptt.nn.Linear(4, 1)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(jm.weight.numpy()))
        tm.bias.copy_(torch.from_numpy(jm.bias.numpy()))
    return jm, tm


def _problem():
    rng = np.random.RandomState(0)
    X = rng.standard_normal((16, 4)).astype(np.float32)
    return X, X @ np.array([[1.0], [2.0], [-1.0], [0.5]], np.float32)


def test_lookahead_matches_jax():
    """LookAhead(SGD, alpha 0.5, k 3) over 10 steps: the same weights
    after each step; the slow weights reset the fast ones every k."""
    X, y = _problem()
    jm, tm = _linear_pair(0)
    jla = paddle.incubate.optimizer.LookAhead(
        paddle.optimizer.SGD(learning_rate=0.1, parameters=jm.parameters()),
        alpha=0.5, k=3)
    tla = tinc.optimizer.LookAhead(
        ptt.optimizer.SGD(learning_rate=0.1, parameters=tm.parameters()),
        alpha=0.5, k=3)
    for _ in range(10):
        for m, la, mk in ((jm, jla, paddle.to_tensor),
                          (tm, tla, ptt.to_tensor)):
            loss = ((m(mk(X)) - mk(y)) ** 2).mean()
            loss.backward()
            la.step()
            la.clear_grad()
        np.testing.assert_allclose(_np(tm.weight), jm.weight.numpy(),
                                   rtol=1e-6, atol=1e-7)
    assert tla.get_lr() == jla.get_lr()
    with pytest.raises(ValueError):
        tinc.optimizer.LookAhead(tla.inner_optimizer, alpha=1.5)
    with pytest.raises(ValueError):
        tinc.optimizer.LookAhead(tla.inner_optimizer, k=0)


def test_model_average_matches_jax():
    """ModelAverage over 5 SGD steps (window 3: it restarts), apply twice
    (the first restore point kept), restore."""
    X, y = _problem()
    jm, tm = _linear_pair(1)
    jopt = paddle.optimizer.SGD(learning_rate=0.1, parameters=jm.parameters())
    topt = ptt.optimizer.SGD(learning_rate=0.1, parameters=tm.parameters())
    jma = paddle.incubate.optimizer.ModelAverage(
        parameters=jm.parameters(), max_average_window=3)
    tma = tinc.optimizer.ModelAverage(parameters=tm.parameters(),
                                      max_average_window=3)
    for _ in range(5):
        for m, opt, ma, mk in ((jm, jopt, jma, paddle.to_tensor),
                               (tm, topt, tma, ptt.to_tensor)):
            loss = ((m(mk(X)) - mk(y)) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            ma.step()
    live = _np(tm.weight).copy()
    for ma in (jma, tma):
        ma.apply()
        ma.apply()
    np.testing.assert_allclose(_np(tm.weight), jm.weight.numpy(), rtol=1e-6)
    assert not np.allclose(_np(tm.weight), live)
    jma.restore()
    tma.restore()
    np.testing.assert_allclose(_np(tm.weight), live, rtol=0)
    np.testing.assert_allclose(_np(tm.weight), jm.weight.numpy(), rtol=1e-6)
    with pytest.raises(ValueError):
        tinc.optimizer.ModelAverage()


# -- geometric --------------------------------------------------------------

SEG_IDS = np.array([0, 0, 1, 3, 3, 3], np.int64)      # segment 2 empty


@pytest.mark.parametrize('op', ['segment_sum', 'segment_mean',
                                'segment_min', 'segment_max'])
@pytest.mark.parametrize('dtype', ['float32', 'int64'])
@pytest.mark.parametrize('out_size', [None, 6])
def test_segment_ops_match_jax(op, dtype, out_size):
    """Every segment reduction, an empty segment (the identity for
    min / max, 0 for sum / mean), with and without out_size; also through
    `incubate`'s re-export."""
    rng = _rng(9)
    data = (rng.standard_normal((6, 3)) * 5).astype(dtype)
    (jd, td), (ji, ti) = _pair(data), _pair(SEG_IDS.astype(np.int32))
    want = _np(getattr(jgeo, op)(jd, ji, out_size=out_size))
    got = _np(getattr(tgeo, op)(td, ti, out_size=out_size))
    if dtype == 'int64' and op in ('segment_min', 'segment_max'):
        # the empty segment: the identity of the port's int64 against the
        # JAX package's int32 (x64 off)
        empty = ~np.isin(np.arange(got.shape[0]), SEG_IDS)
        lim = np.iinfo(np.int64)
        assert (got[empty] == (lim.max if op == 'segment_min'
                               else lim.min)).all()
        got, want = got[~empty], want[~empty]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert getattr(tinc, op) is getattr(tgeo, op)


@pytest.mark.parametrize('reduce_op', ['sum', 'mean', 'min', 'max'])
@pytest.mark.parametrize('out_size', [None, 7])
def test_send_u_recv_matches_jax(reduce_op, out_size):
    rng = _rng(10)
    x = _f32(rng, 5, 4)
    src = np.array([0, 1, 2, 3, 4, 0, 2], np.int32)
    dst = np.array([1, 0, 1, 4, 4, 3, 0], np.int32)      # bucket 2 empty
    (jx, tx), (js, ts), (jd, td) = _pair(x), _pair(src), _pair(dst)
    want = jgeo.send_u_recv(jx, js, jd, reduce_op, out_size=out_size)
    _close(tgeo.send_u_recv(tx, ts, td, reduce_op, out_size=out_size), want)
    _close(tinc.graph_send_recv(tx, ts, td, pool_type=reduce_op,
                                out_size=out_size), want)
    with pytest.raises(ValueError):
        tgeo.send_u_recv(tx, ts, td, 'prod')


@pytest.mark.parametrize('message_op', ['add', 'sub', 'mul', 'div'])
@pytest.mark.parametrize('reduce_op', ['sum', 'mean', 'max'])
def test_send_ue_recv_matches_jax(message_op, reduce_op):
    rng = _rng(11)
    x = _f32(rng, 5, 4)
    y = (_f32(rng, 7, 4) + 3.0).astype(np.float32)
    src = np.array([0, 1, 2, 3, 4, 0, 2], np.int32)
    dst = np.array([1, 0, 1, 4, 4, 3, 0], np.int32)
    (jx, tx), (jy, ty) = _pair(x), _pair(y)
    (js, ts), (jd, td) = _pair(src), _pair(dst)
    _close(tgeo.send_ue_recv(tx, ty, ts, td, message_op, reduce_op),
           jgeo.send_ue_recv(jx, jy, js, jd, message_op, reduce_op))
    with pytest.raises(ValueError):
        tgeo.send_ue_recv(tx, ty, ts, td, 'pow', reduce_op)


@pytest.mark.parametrize('entry', ['send_u_recv', 'send_ue_recv',
                                   'graph_send_recv'])
@pytest.mark.parametrize('reduce_op', ['min', 'max'])
def test_int_min_max_buckets_found_by_edge_count(entry, reduce_op):
    """A live int32 bucket whose min is INT32_MAX stays INT32_MAX; the
    empty bucket is 0 in the port (upstream's rule) and the identity in
    the JAX package (`jnp.isinf` is False on ints)."""
    lim = np.iinfo(np.int32)
    x = np.array([[lim.max], [5], [-3]], np.int32)
    src, dst = np.array([0, 1, 2], np.int32), np.array([0, 1, 1], np.int32)
    y = np.zeros((3, 1), np.int32)
    (jx, tx), (jy, ty) = _pair(x), _pair(y)
    (js, ts), (jd, td) = _pair(src), _pair(dst)
    if entry == 'send_u_recv':
        want = jgeo.send_u_recv(jx, js, jd, reduce_op, out_size=3)
        got = tgeo.send_u_recv(tx, ts, td, reduce_op, out_size=3)
    elif entry == 'send_ue_recv':
        want = jgeo.send_ue_recv(jx, jy, js, jd, 'add', reduce_op,
                                 out_size=3)
        got = tgeo.send_ue_recv(tx, ty, ts, td, 'add', reduce_op,
                                out_size=3)
    else:
        from paddle_tpu import incubate as jinc
        want = jinc.graph_send_recv(jx, js, jd, pool_type=reduce_op,
                                    out_size=3)
        got = tinc.graph_send_recv(tx, ts, td, pool_type=reduce_op,
                                   out_size=3)
    got, want = _np(got).ravel(), _np(want).ravel()
    live = {'min': [lim.max, -3], 'max': [lim.max, 5]}[reduce_op]
    np.testing.assert_array_equal(got[:2], want[:2])
    np.testing.assert_array_equal(got[:2], live)
    assert got[2] == 0
    assert want[2] == (lim.max if reduce_op == 'min' else lim.min)


def test_segment_sum_is_differentiable():
    rng = _rng(12)
    d = _f32(rng, 6, 3)
    (jd, td), (ji, ti) = _pair(d), _pair(SEG_IDS.astype(np.int32))
    jd.stop_gradient = td.stop_gradient = False
    wj, wt = _pair(_f32(rng, 4, 3))
    (jg,) = paddle.grad((jgeo.segment_sum(jd, ji) * wj).sum(), [jd])
    (tg,) = ptt.grad((tgeo.segment_sum(td, ti) * wt).sum(), [td])
    _close(tg, jg)
