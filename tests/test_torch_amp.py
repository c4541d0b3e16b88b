"""Mixed precision of the port against the JAX package's, on the CPU.

`tests/test_amp.py`'s cases run on both packages (the auto_cast policy
by op name, nesting, custom lists and their validation, gradients into
fp32 parameters, GradScaler's scaling and its skip on an overflow, O2
`decorate` with master weights): the same dtypes, and values within
bf16's tolerance (rtol 2e-2: one bf16 rounding is 2^-8 relative, and
the two packages round the products' inputs at the same points but sum
in another order). GradScaler's scale sequence, found_inf flags and
weights under injected infs must be equal. A 2-layer tiny Llama's loss
and gradients under O1 bf16, and under O2 through `decorate`, agree
with the JAX package's (loss rtol 2e-3, every gradient to a relative
norm error of 0.05, phase 4's bf16 limit): the gradients are read as
the update of SGD(lr=1) through each package's TrainStep (the masters'
under O2), because the JAX package's eager tape cannot run the backward
of a black-list op fed by a white-list one (its cast is outside the
recorded vjp, so the cotangent's dtype mismatches); the port's eager
loop under O1 gives its TrainStep's loss and gradients bit for bit.
`Model.prepare(amp_configs='O1'|'O2')` fits with the JAX Model's losses
(rtol 2e-2). The numerics checker and the operator stats run on the op
choke point of both.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as jio
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import programs
from paddle_tpu.hapi import Model as JaxModel
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.optimizer import AdamW as JaxAdamW
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import Model
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.weights import from_jax_state

from test_torch_hapi import TorchNet, JaxNet, _data
from test_torch_observability import isolated_observability
from test_torch_train import _jax_loss, _models, _torch_loss

BF16_RTOL = 2e-2
LLAMA_LOSS_RTOL, LLAMA_GRAD_REL = 2e-3, 0.05


@pytest.fixture(autouse=True, scope='module')
def _cpu_place(tmp_path_factory):
    ptt.set_device('cpu')
    yield from isolated_observability(tmp_path_factory)
    ptt.set_device('gpu')


def _a(seed=0, shape=(8, 8)):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _dt(t):
    return str(t.dtype).replace('torch.', '').replace('paddle.', '')


def _linears(i, o, seed=0):
    paddle.seed(seed)
    jm = jnn.Linear(i, o)
    tm = tnn.Linear(i, o, bias=True, device=torch.device('cpu'),
                    dtype=torch.float32)
    from_jax_state({k: np.asarray(v.numpy())
                    for k, v in jm.state_dict().items()}, tm)
    return jm, tm


def test_autocast_whitelist_casts_matmul_to_bf16():
    a, b = _a(0), _a(1)
    for P in (paddle, ptt):
        x, y = P.to_tensor(a), P.to_tensor(b)
        with P.amp.auto_cast(dtype='bfloat16'):
            out = P.matmul(x, y)
        assert _dt(out) == 'bfloat16'
        assert _dt(P.matmul(x, y)) == 'float32'
    with ptt.amp.auto_cast():
        got = ptt.matmul(ptt.to_tensor(a), ptt.to_tensor(b))
    with paddle.amp.auto_cast():
        want = paddle.matmul(paddle.to_tensor(a), paddle.to_tensor(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy(),
                                                       np.float32),
                               rtol=BF16_RTOL, atol=BF16_RTOL)


def test_autocast_blacklist_stays_fp32():
    for P, FF in ((paddle, JF), (ptt, F)):
        x = P.to_tensor(_a(2, (4, 8))).astype('bfloat16')
        with P.amp.auto_cast(dtype='bfloat16'):
            out = FF.softmax(x)
            red = P.sum(x)
        assert _dt(out) == 'float32' and _dt(red) == 'float32'


def test_autocast_o2_casts_everything_but_blacklist():
    for P in (paddle, ptt):
        a = P.to_tensor(_a(3, (4, 4)))
        with P.amp.auto_cast(level='O2'):
            s = P.add(a, a)
            e = P.exp(a)
        assert _dt(s) == 'bfloat16' and _dt(e) == 'float32'


def test_autocast_fp16_and_plain_torch_inputs():
    x = torch.from_numpy(_a(4))
    with ptt.amp.auto_cast(dtype='float16'):
        y = F.linear(x, x)
        z = F.rms_norm(y, torch.ones(8))
    assert type(y) is torch.Tensor and y.dtype == torch.float16
    assert z.dtype == torch.float32
    assert ptt.tensor._amp_cast_hook is None     # no open scope: no hook


def test_autocast_nesting_restores_state():
    for P in (paddle, ptt):
        a = P.to_tensor(_a(5, (4, 4)))
        with P.amp.auto_cast():
            with P.amp.auto_cast(enable=False):
                assert _dt(P.matmul(a, a)) == 'float32'
            assert _dt(P.matmul(a, a)) == 'bfloat16'
        assert _dt(P.matmul(a, a)) == 'float32'


def test_custom_white_list_overrides_black_list():
    for P in (paddle, ptt):
        x = P.to_tensor(_a(6, (4, 4)))
        with P.amp.auto_cast(custom_white_list={'sum'}):
            assert _dt(P.sum(x)) == 'bfloat16'
        with P.amp.auto_cast(custom_black_list={'matmul'}):
            assert _dt(P.matmul(x, x)) == 'float32'
        with pytest.raises(ValueError):
            P.amp.auto_cast(custom_white_list={'sum'},
                            custom_black_list={'sum'}).__enter__()
        with pytest.raises(ValueError):
            P.amp.auto_cast(level='O3').__enter__()
    assert ptt.tensor._amp_cast_hook is None


def test_autocast_gradients_flow_into_fp32_params():
    jm, tm = _linears(8, 4)
    x = _a(7, (2, 8))
    with paddle.amp.auto_cast():
        jl = jm(paddle.to_tensor(x)).astype('float32').sum()
    with ptt.amp.auto_cast():
        tl = tm(ptt.to_tensor(x)).astype('float32').sum()
    jl.backward()
    tl.backward()
    assert tm.weight.grad.dtype == torch.float32
    np.testing.assert_allclose(tm.weight.grad.numpy(),
                               np.asarray(jm.weight.grad.numpy()),
                               rtol=BF16_RTOL, atol=BF16_RTOL)
    np.testing.assert_allclose(float(tl), float(jl), rtol=BF16_RTOL)


def test_grad_scaler_scales_and_unscales():
    jm, tm = _linears(4, 2, seed=1)
    x = _a(8, (3, 4))
    res = {}
    for P, m in ((paddle, jm), (ptt, tm)):
        opt = P.optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
        scaler = P.amp.GradScaler(init_loss_scaling=128.0)
        loss = m(P.to_tensor(x)).sum()
        scaled = scaler.scale(loss)
        np.testing.assert_allclose(float(scaled), 128.0 * float(loss),
                                   rtol=1e-6)
        scaled.backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        res[P.__name__] = np.asarray(m.weight.numpy())
    np.testing.assert_allclose(res['paddle_tpu_torch'], res['paddle_tpu'],
                               rtol=1e-5, atol=1e-6)


def test_grad_scaler_skips_on_inf_and_decays():
    for P, m in zip((paddle, ptt), _linears(2, 2, seed=2)):
        opt = P.optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
        scaler = P.amp.GradScaler(init_loss_scaling=64.0,
                                  decr_every_n_nan_or_inf=1)
        x = P.to_tensor(np.array([[1e38, 1e38]], np.float32))
        loss = (m(x) * 1e10).sum()           # overflow -> inf grads
        scaler.scale(loss).backward()
        w_before = np.asarray(m.weight.numpy()).copy()
        scaler.step(opt)
        scaler.update()
        np.testing.assert_array_equal(np.asarray(m.weight.numpy()), w_before)
        assert scaler.get_loss_scaling() == 32.0


def test_grad_scaler_sequence_under_injected_infs():
    """Nine steps, an inf injected into the loss at steps 2, 3 and 6:
    the same scale after each step, the same skipped updates and the same
    weights in both packages."""
    bad = {2, 3, 6}
    seqs = {}
    for P, m in zip((paddle, ptt), _linears(4, 3, seed=3)):
        opt = P.optimizer.SGD(learning_rate=0.05, parameters=m.parameters())
        scaler = P.amp.GradScaler(init_loss_scaling=2.0 ** 10,
                                  incr_every_n_steps=2,
                                  decr_every_n_nan_or_inf=1)
        rng = np.random.RandomState(4)
        scales, found = [], []
        for step in range(9):
            x = P.to_tensor(rng.standard_normal((5, 4)).astype(np.float32))
            loss = (m(x) ** 2).mean()
            if step in bad:
                loss = loss * float('inf')
            scaler.scale(loss).backward()
            scaler.unscale_(opt)
            found.append(scaler._found_inf)
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            scales.append(scaler.get_loss_scaling())
        seqs[P.__name__] = (scales, found, np.asarray(m.weight.numpy()))
    (js, jf, jw), (ts, tf, tw) = seqs['paddle_tpu'], seqs['paddle_tpu_torch']
    assert ts == js and tf == jf
    assert tf == [s in bad for s in range(9)]
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-6)


def test_decorate_o2_bf16_master_weights_training():
    x, tgt = _a(9, (4, 8)), _a(10, (4, 8))
    losses = {}
    for P, m in zip((paddle, ptt), _linears(8, 8, seed=4)):
        opt = P.optimizer.AdamW(learning_rate=1e-2,
                                parameters=m.parameters())
        m, opt = P.amp.decorate(m, opt, level='O2', dtype='bfloat16')
        assert _dt(m.weight) == 'bfloat16' and opt._multi_precision
        xb = P.to_tensor(x).astype('bfloat16')
        tb = P.to_tensor(tgt).astype('bfloat16')
        out = []
        for _ in range(10):
            loss = ((m(xb) - tb).astype('float32') ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            out.append(float(loss))
        assert _dt(m.weight) == 'bfloat16'
        assert out[-1] < out[0]
        losses[P.__name__] = out
    np.testing.assert_allclose(losses['paddle_tpu_torch'],
                               losses['paddle_tpu'], rtol=BF16_RTOL)


def _state(sd):
    """Copies of a state dict's values in fp32 (the port's alias the
    parameters, which the update writes in place)."""
    return {n: np.array(v.float().numpy() if isinstance(v, torch.Tensor)
                        else v.numpy(), np.float32) for n, v in sd.items()}


@pytest.mark.parametrize('level', ['O1', 'O2'])
def test_tiny_llama_loss_and_grads_match_jax(level):
    programs.get_store().clear_memory()
    jm, tm = _models(False)
    jopt = paddle.optimizer.SGD(learning_rate=1.0,
                                parameters=jm.parameters())
    topt = ptt.optimizer.SGD(learning_rate=1.0, parameters=tm.parameters())
    if level == 'O2':
        jm, jopt = paddle.amp.decorate(jm, jopt, level='O2')
        tm, topt = ptt.amp.decorate(tm, topt, level='O2')
        assert tm.dtype == torch.bfloat16
    j0, t0 = _state(jm.state_dict()), _state(tm.state_dict())
    js = JaxTrainStep(jm, _jax_loss, jopt)
    ts = ptt.jit.TrainStep(tm, _torch_loss, topt)
    ids = np.random.RandomState(0).randint(0, 128, (2, 24))
    with paddle.amp.auto_cast(level=level):
        jl = float(js(ids, ids).numpy())
    with ptt.amp.auto_cast(level=level):
        tl = float(ts(ids, ids))
    np.testing.assert_allclose(tl, jl, rtol=LLAMA_LOSS_RTOL)
    if level == 'O2':       # the update lands in the fp32 masters
        j1 = {n: np.asarray(s['master'], np.float32)
              for n, s in js._opt_state['slots'].items()}
        t1 = {n: s['master'].numpy()
              for n, s in ts.opt_state()['slots'].items()}
    else:
        j1, t1 = _state(jm.state_dict()), _state(tm.state_dict())
    for n in j0:
        gj, gt = j0[n] - j1[n], t0[n] - t1[n]
        rel = np.linalg.norm(gt - gj) / np.linalg.norm(gj)
        assert rel < LLAMA_GRAD_REL, (n, rel)


def test_eager_o1_loop_equals_train_step_bit_for_bit():
    """The canonical eager loop (Tensors in, `loss.backward()`,
    `opt.step()`, `opt.clear_grad()`) under O1 gives the TrainStep's
    losses and parameters exactly."""
    _, a = _models(False)
    _, b = _models(False)
    oa = ptt.optimizer.AdamW(learning_rate=1e-3, parameters=a.parameters())
    step = ptt.jit.TrainStep(
        b, lambda logits, lab: F.cross_entropy(logits.reshape(-1, 128),
                                               lab.reshape(-1)),
        ptt.optimizer.AdamW(learning_rate=1e-3, parameters=b.parameters()))
    rng = np.random.RandomState(1)
    for _ in range(3):
        ids = rng.randint(0, 128, (2, 24))
        x = ptt.to_tensor(ids)
        with ptt.amp.auto_cast():
            loss, _ = a(x, labels=x)
        assert isinstance(loss, ptt.Tensor)
        loss.backward()
        oa.step()
        oa.clear_grad()
        with ptt.amp.auto_cast():
            lb = step(ids, ids)
        assert float(loss) == float(lb)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n


@pytest.mark.parametrize('level', ['O1', 'O2'])
def test_model_prepare_amp_configs_fit_matches_jax(level):
    programs.get_store().clear_memory()
    paddle.seed(3)
    jnet = JaxNet()
    tnet = from_jax_state({k: np.asarray(v.numpy())
                           for k, v in jnet.state_dict().items()}, TorchNet())
    jm = JaxModel(jnet).prepare(
        JaxAdamW(learning_rate=1e-2, parameters=jnet.parameters()),
        jnn.CrossEntropyLoss(), amp_configs=level)
    tm = Model(tnet).prepare(
        ptt.optimizer.AdamW(learning_rate=1e-2, parameters=tnet.parameters()),
        tnn.CrossEntropyLoss(), amp_configs={'level': level})
    if level == 'O2':
        assert tm.network.fc1.weight.dtype == torch.bfloat16
        assert tm._optimizer._multi_precision
    x, y = _data()
    kw = dict(batch_size=8, epochs=2, verbose=0, shuffle=False)
    jh = jm.fit(jio.TensorDataset([x, y]), **kw)
    th = tm.fit(tio.TensorDataset([x, y]), **kw)
    assert len(th['loss']) == len(jh['loss']) == 10
    np.testing.assert_allclose(th['loss'], jh['loss'], rtol=BF16_RTOL)
    je = jm.eval_batch([paddle.to_tensor(x[:8])], paddle.to_tensor(y[:8]))
    te = tm.eval_batch([x[:8]], y[:8])
    np.testing.assert_allclose(te['loss'], je['loss'], rtol=BF16_RTOL)


def test_check_numerics_and_the_tensor_checker():
    bad = np.float32([1.0, np.inf, np.nan])
    for P, dbg in ((paddle, paddle.amp.debugging),
                   (ptt, ptt.amp.debugging)):
        with pytest.raises(P.debug.NumericsError, match='1 NaN, 1 Inf'):
            dbg.check_numerics(P.to_tensor(bad), 'x')
        dbg.enable_tensor_checker()
        try:
            with pytest.raises(P.debug.NumericsError, match='log'):
                P.log(P.to_tensor(np.float32([-1.0, 1.0])))
        finally:
            dbg.disable_tensor_checker()
        P.log(P.to_tensor(np.float32([-1.0])))      # off again
    ptt.amp.debugging.enable_operator_stats_collection()
    try:
        with ptt.amp.auto_cast():
            ptt.matmul(ptt.to_tensor(_a()), ptt.to_tensor(_a(1)))
        stats = ptt.amp.debugging.collect_operator_numerical_stats()
    finally:
        ptt.amp.debugging.disable_operator_stats_collection()
    assert stats['matmul'] == {'calls': 1, 'dtypes': {'bfloat16': 1}}


def test_supported_dtypes():
    assert ptt.amp.is_bfloat16_supported() and ptt.amp.is_float16_supported()


def test_recompute_reruns_the_forward_under_its_amp_policy():
    """A checkpointed layer's backward, run outside `auto_cast`,
    recomputes the forward under the policy the forward ran under: the
    gradients equal those without recompute."""
    grads = []
    for remat in (False, True):
        _, tm = _models(remat)
        ids = ptt.to_tensor(np.random.RandomState(2).randint(0, 128,
                                                              (2, 24)))
        with ptt.amp.auto_cast():
            loss, _ = tm(ids, labels=ids)
        loss.backward()                       # outside the scope
        grads.append({n: p.grad.clone() for n, p in tm.named_parameters()})
    for n, g in grads[0].items():
        assert torch.equal(grads[1][n], g), n
