"""`quantization` of the port against the JAX package's, on the CPU:
the observers, PTQ (weight-only and calibrated), QAT and the quantized
state.

The same seeded numpy data and the same float weights go through both
packages. Tolerances: observer scales rtol 1e-6 (the same numpy
arithmetic on the host); int8 weights equal, weight scales rtol 1e-6;
quantized forwards and QAT losses f32 rtol 1e-5 and atol 1e-5 of the
output's scale (matmuls summed in another order); the calibrated
activation quantization rounds activations, so a value within f32 noise
of a rounding boundary may land one step apart: there at most 1% of the
outputs differ past that tolerance, by at most two activation steps.
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu import quantization as jq
from paddle_tpu_torch import quantization as tq
from paddle_tpu_torch.weights import from_jax_state, set_act_scales


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
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _data(n=6, scale=1.0, seed=0, shape=(32, 16)):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32) * scale
            for _ in range(n)]


@pytest.mark.parametrize('name', ['AbsmaxObserver', 'AVGObserver',
                                  'EMAObserver', 'HistObserver',
                                  'KLObserver', 'MSEObserver'])
def test_observer_scales_match_jax(name):
    """Every observer over the same six batches (one with an outlier):
    the same per-tensor scale; before any data both raise."""
    data = _data(scale=2.0, seed=2)
    data[3][0, 0] = 40.0
    jo, to = getattr(jq, name)(), getattr(tq, name)()
    with pytest.raises(RuntimeError, match='no calibration'):
        to.scales()
    for d in data:
        jo(paddle.to_tensor(d))
        out = to(ptt.to_tensor(d))
        assert out is not None
    np.testing.assert_allclose(to.scales(), jo.scales(), rtol=1e-6)


def test_channel_observer_matches_jax_and_the_kv_scales():
    """AbsmaxChannelObserver over [page_size, H, D] slabs (channel axis
    1): the JAX observer's per-head scales, and the KV pool's
    `kv_page_scales` of their running max."""
    rng = np.random.RandomState(5)
    slabs = [rng.standard_normal((16, 4, 8)).astype(np.float32) * s
             for s in (1.0, 3.0, 0.5)]
    jo = jq.AbsmaxChannelObserver(channel_axis=1)
    to = tq.AbsmaxChannelObserver(channel_axis=1)
    for s in slabs:
        jo(paddle.to_tensor(s))
        to(torch.from_numpy(s))
    np.testing.assert_allclose(to.scales(), jo.scales(), rtol=1e-6)
    peak = np.max(np.abs(np.stack(slabs)), axis=0)
    np.testing.assert_allclose(
        to.scales(), tq.kv_page_scales(torch.from_numpy(peak)).numpy(),
        rtol=1e-6)


def _mlp_pair(seed, width=16):
    """(JAX model, port model) over the same float weights: Linear(width,
    32) -> ReLU -> Linear(32, 8)."""
    paddle.seed(seed)
    jm = paddle.nn.Sequential(paddle.nn.Linear(width, 32),
                              paddle.nn.ReLU(), paddle.nn.Linear(32, 8))
    tm = ptt.nn.Sequential(ptt.nn.Linear(width, 32), ptt.nn.ReLU(),
                           ptt.nn.Linear(32, 8))
    from_jax_state({k: v.numpy() for k, v in jm.state_dict().items()}, tm)
    return jm, tm


def _quanted(model, mod):
    return [l for _, l in (model.named_sublayers()
                           if hasattr(model, 'named_sublayers')
                           else model.named_modules())
            if isinstance(l, mod.QuantedLinear)]


def test_ptq_weight_only_matches_jax():
    """Weight-only PTQ: per-channel int8 weights and scales equal to the
    JAX package's, the quantized forward equal, the float model left as
    it was (inplace=False), and the quantized state bytes equal."""
    jm, tm = _mlp_pair(0)
    jqm = jq.PTQ().quantize(jm)
    tqm = tq.PTQ().quantize(tm)
    assert isinstance(tm[0], ptt.nn.Linear)
    jl, tl = _quanted(jqm, jq), _quanted(tqm, tq)
    assert len(tl) == len(jl) == 2
    for t, j in zip(tl, jl):
        np.testing.assert_array_equal(_np(t.weight_int8),
                                      _np(j.weight_int8))
        assert t.weight_int8.dtype == torch.int8
        np.testing.assert_allclose(_np(t.weight_scale), _np(j.weight_scale),
                                   rtol=1e-6)
        assert t.act_scale is None and t.compute_dtype == 'float32'
    x = _data(1, seed=1, shape=(8, 16))[0]
    _close(tqm(ptt.to_tensor(x)), jqm(paddle.to_tensor(x)))
    assert tq.quanted_state_bytes(tqm) == jq.quanted_state_bytes(jqm) == \
        (16 * 32 + 32 * 8) + 4 * (32 + 8)
    with pytest.raises(ValueError, match='no quantizable'):
        tq.PTQ().quantize(ptt.nn.Sequential(ptt.nn.ReLU()))
    single = tq.PTQ().quantize(tm[0])
    assert isinstance(single, tq.QuantedLinear)
    with pytest.raises(ValueError, match='inplace'):
        tq.PTQ().quantize(tm[0], inplace=True)


@pytest.mark.parametrize('observer', ['abs_max', 'avg', 'ema', 'hist', 'kl',
                                      'mse'])
def test_ptq_calibrated_matches_jax(observer):
    """PTQ with an activation observer: quantize inserts observers, six
    calibration batches, convert bakes each layer's activation scale;
    the scales and the deployed forward equal the JAX package's."""
    jm, tm = _mlp_pair(3)
    jp, tp = jq.PTQ(jq.QuantConfig(activation=observer)), \
        tq.PTQ(tq.QuantConfig(activation=observer))
    jo, to = jp.quantize(jm), tp.quantize(tm)
    data = _data(seed=4)
    for d in data:
        jo(paddle.to_tensor(d))
        to(ptt.to_tensor(d))
    jd, td = jp.convert(jo), tp.convert(to)
    jl, tl = _quanted(jd, jq), _quanted(td, tq)
    assert len(tl) == 2
    for t, j in zip(tl, jl):
        np.testing.assert_allclose(t.act_scale, j.act_scale, rtol=1e-6)
    got, want = _np(td(ptt.to_tensor(data[0]))), \
        _np(jd(paddle.to_tensor(data[0])))
    scale = np.abs(want).max()
    off = np.abs(got - want) > 1e-5 * scale
    assert off.mean() <= 0.01
    step = max(t.act_scale for t in tl) * float(
        np.abs(_np(tl[1].weight_int8) * _np(tl[1].weight_scale)).sum(0).max())
    assert np.abs(got - want).max() <= 2 * step
    with pytest.raises(ValueError, match='unknown activation'):
        tq.PTQ(tq.QuantConfig(activation='nope')).quantize(tm)


def test_prebuilt_observer_is_a_prototype():
    ob = tq.HistObserver(percent=0.999)
    cfg = tq.QuantConfig(activation=ob)
    made = cfg.make_observer()
    assert isinstance(made, tq.HistObserver) and made is not ob
    assert made.percent == ob.percent


def test_quantized_model_carries_across_from_jax():
    """A calibrated JAX PTQ model's state (int8 weights and scales as
    buffers, under the JAX names) and activation scales, carried into
    the port's quantized model of the same structure: equal buffers and
    scales."""
    jm, tm = _mlp_pair(6)
    jp = jq.PTQ(jq.QuantConfig(activation='abs_max'))
    jo = jp.quantize(jm)
    for d in _data(seed=7):
        jo(paddle.to_tensor(d))
    jd = jp.convert(jo)
    # a port model of the same structure with other weights
    _, other = _mlp_pair(8)
    tp = tq.PTQ(tq.QuantConfig(activation='abs_max'))
    to = tp.quantize(other)
    to(ptt.to_tensor(_data(1, seed=9)[0]))
    td = tp.convert(to)
    from_jax_state({k: v.numpy() for k, v in jd.state_dict().items()}, td)
    set_act_scales(td, {n: l.act_scale for n, l in jd.named_sublayers()
                        if isinstance(l, jq.QuantedLinear)})
    for t, j in zip(_quanted(td, tq), _quanted(jd, jq)):
        np.testing.assert_array_equal(_np(t.weight_int8),
                                      _np(j.weight_int8))
        assert t.act_scale == pytest.approx(j.act_scale, rel=1e-7)
    assert [n for n, m in td.named_modules()
            if isinstance(m, tq.QuantedLinear)] == ['0', '2']
    x = _data(1, seed=10)[0]
    got, want = _np(td(ptt.to_tensor(x))), _np(jd(paddle.to_tensor(x)))
    assert (np.abs(got - want) > 1e-5 * np.abs(want).max()).mean() <= 0.01
    with pytest.raises(KeyError):
        set_act_scales(td, {'0': None})


def test_qat_steps_match_jax_and_convert():
    """QAT: fake-quantized weights (straight-through) under 4 Adam steps
    of cross-entropy; the losses equal the JAX package's and fall; the
    converted model's QuantedLinears equal the JAX ones."""
    jm, tm = _mlp_pair(1)
    jqat, tqat = jq.QAT(), tq.QAT()
    jqm, tqm = jqat.quantize(jm), tqat.quantize(tm)
    rng = np.random.RandomState(1)
    x = rng.randn(16, 16).astype(np.float32)
    labels = np.random.RandomState(2).randint(0, 8, 16)
    jopt = paddle.optimizer.Adam(learning_rate=5e-3,
                                 parameters=jqm.parameters())
    topt = ptt.optimizer.Adam(learning_rate=5e-3,
                              parameters=tqm.parameters())
    jl, tl = [], []
    for _ in range(4):
        for m, opt, mk, out, F in (
                (jqm, jopt, paddle.to_tensor, jl, paddle.nn.functional),
                (tqm, topt, ptt.to_tensor, tl, ptt.nn.functional)):
            loss = F.cross_entropy(m(mk(x)), mk(labels))
            loss.backward()
            opt.step()
            opt.clear_grad()
            out.append(float(loss.numpy()))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    jc, tc = jqat.convert(jqm), tqat.convert(tqm)
    for t, j in zip(_quanted(tc, tq), _quanted(jc, jq)):
        np.testing.assert_array_equal(_np(t.weight_int8),
                                      _np(j.weight_int8))
    _close(tc(ptt.to_tensor(x)), jc(paddle.to_tensor(x)))
    assert tq.quanted_state_bytes(tc) == jq.quanted_state_bytes(jc)


def test_fake_quant_passes_the_gradient_straight_through():
    w = torch.randn(8, 4, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    fq = tq.FakeQuantAbsMax()
    q = fq(w)
    assert not torch.equal(q, w)
    assert q.unique().numel() <= 4 * 255
    (g,) = torch.autograd.grad((q * 3).sum(), [w])
    assert torch.equal(g, torch.full_like(w, 3.0))
    jfq = jq.FakeQuantAbsMax()
    _close(q, jfq(paddle.to_tensor(w.detach().numpy())))


def test_bf16_quanted_linear_computes_in_bf16():
    """A bf16 Linear's QuantedLinear dequantizes into bf16 (the JAX
    package's compute dtype rule) and is deep-copied by PTQ."""
    lin = ptt.nn.Linear(16, 8, dtype='bfloat16')
    q = tq.QuantedLinear.from_linear(lin)
    assert q.compute_dtype == 'bfloat16'
    y = q(torch.randn(2, 16, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16
    deep = copy.deepcopy(q)
    assert torch.equal(deep.weight_int8, q.weight_int8)
