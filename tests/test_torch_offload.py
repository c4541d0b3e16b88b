"""The port's host-offloaded optimizer state against the JAX package's, on
the CPU.

`AdamW(offload='host')` keeps the slots in host buffers and streams each
update through a two-slot ring (`paddle_tpu_torch/optimizer/offload.py`;
on the CPU the copies are host-to-host, as the JAX engine degrades).
Three `TrainStep`s of the tiny GQA Llama must equal the JAX offloaded
step (losses rtol 1e-5, parameters atol 4e-5: the tolerances of
tests/test_torch_train.py), the port's in-HBM step bit for bit (the same
kernel's plain version on the same values, elementwise, whatever the
pieces), and the JAX engine's transfer counters exactly. The JAX offload
test holds offload to in-HBM at rtol 1e-6 (tests/test_offload_optimizer.py);
the port holds it to 0.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import observability as jobs
from paddle_tpu import programs
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import Adam, AdamW, NAdam
from paddle_tpu_torch.optimizer.offload import OffloadEngine

from test_torch_observability import isolated_observability
from test_torch_train import (LOSS_RTOL, PARAM_ATOL, _batches, _jax_loss,
                              _models, _torch_loss)

LR = 1e-3


@pytest.fixture
def fresh_observability(tmp_path_factory):
    yield from isolated_observability(tmp_path_factory)


def _port_run(offload, steps=3, chunk=None, **kw):
    _, tm = _models(False)
    opt = AdamW(learning_rate=LR, parameters=tm.parameters(),
                offload=offload, **kw)
    if chunk is not None:
        opt._engine = OffloadEngine(opt, chunk=chunk)
    step = TrainStep(tm, _torch_loss, opt)
    losses = [float(step(ids, ids)) for ids in _batches(steps)]
    return losses, tm, step


def _jax_run(offload, steps=3, **kw):
    programs.get_store().clear_memory()
    jm, _ = _models(False)
    step = JaxTrainStep(jm, _jax_loss, JaxAdamW(
        learning_rate=LR, parameters=jm.parameters(),
        offload=offload, **kw))
    losses = [float(step(ids, ids).numpy()) for ids in _batches(steps)]
    return losses, jm, step


def _bits(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize('chunk', [None, 1024])
def test_offload_equals_in_hbm_bit_for_bit(chunk):
    """chunk=1024 cuts the wider parameters into pieces and spreads the
    update over many ring groups."""
    base_l, base_m, base_s = _port_run(None)
    off_l, off_m, off_s = _port_run('host', chunk=chunk)
    assert base_l == off_l
    want, got = _bits(base_m), _bits(off_m)
    for n in want:
        assert torch.equal(got[n], want[n]), n
    bs, os_ = base_s.opt_state(), off_s.opt_state()
    assert bs['step'] == os_['step'] == 3
    for n, slots in bs['slots'].items():
        for k, v in slots.items():
            assert torch.equal(os_['slots'][n][k], v), (n, k)


@pytest.mark.parametrize('kw', [dict(multi_precision=True),
                                dict(amsgrad=True),
                                dict(grad_clip='global')])
def test_offload_options_equal_in_hbm(kw):
    def run(offload):
        opts = dict(kw)
        if opts.get('grad_clip') == 'global':
            opts['grad_clip'] = ClipGradByGlobalNorm(0.1)
        return _port_run(offload, chunk=1024, **opts)
    base_l, base_m, _ = run(None)
    off_l, off_m, _ = run('host')
    assert base_l == off_l
    for n, p in _bits(base_m).items():
        assert torch.equal(_bits(off_m)[n], p), n


def test_offload_matches_jax_offload_and_counters(fresh_observability):
    jl, jm, _ = _jax_run('host')
    jreg = jobs.get_registry()
    jh2d = jreg.counter('paddle_offload_h2d_bytes_total', '').value
    jd2h = jreg.counter('paddle_offload_d2h_bytes_total', '').value
    tl, tm, _ = _port_run('host')
    treg = tobs.get_registry()
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    want = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    for n, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[n], rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
    slot_bytes = sum(p.numel() * 4 * 2 for p in tm.parameters())
    assert jh2d == jd2h == 3 * slot_bytes
    assert treg.counter('paddle_offload_h2d_bytes_total', '').value == jh2d
    assert treg.counter('paddle_offload_d2h_bytes_total', '').value == jd2h


def test_offload_slots_are_host_views_of_one_buffer():
    _, tm, step = _port_run('host', steps=1)
    opt = step.optimizer
    eng = opt._engine
    assert eng.initialized and set(eng._host) == {'moment1', 'moment2'}
    for p in tm.parameters():
        slots = opt._slots[p]
        for k, v in slots.items():
            assert v.device.type == 'cpu' and v.shape == p.shape
            assert v.untyped_storage().data_ptr() == \
                eng._host[k].untyped_storage().data_ptr()
    assert all(t.numel() <= eng.chunk for ring in eng._ring
               for t in ring.values())


def test_offload_state_dict_roundtrip_into_the_same_buffers():
    _, _, step = _port_run('host', steps=2)
    sd = step.optimizer.state_dict()
    _, tm2 = _models(False)
    opt2 = AdamW(learning_rate=LR, parameters=tm2.parameters(),
                 offload='host')
    opt2.set_state_dict(sd)
    host = {k: v.untyped_storage().data_ptr()
            for k, v in opt2._engine._host.items()}
    assert opt2._step_count == 2
    for p, want in zip(tm2.parameters(), sd['slots']):
        for k, v in opt2._slots[p].items():
            np.testing.assert_array_equal(v.numpy(), want[k])
            assert v.untyped_storage().data_ptr() == host[k]
    opt2.set_state_dict(sd)             # again: copied, not reallocated
    assert {k: v.untyped_storage().data_ptr()
            for k, v in opt2._engine._host.items()} == host


def test_offload_resumes_a_jax_offload_state():
    """A JAX offloaded optimizer's `state_dict()` (its engine's host
    slots) loads into the port's host buffers; the next step then
    matches the JAX one's."""
    programs.get_store().clear_memory()
    jm, tm = _models(False)
    jopt = JaxAdamW(learning_rate=LR, parameters=jm.parameters(),
                    offload='host')
    jstep = JaxTrainStep(jm, _jax_loss, jopt)
    ids = _batches(2)
    jstep(ids[0], ids[0])
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    from paddle_tpu_torch.weights import from_jax_state
    from_jax_state(state, tm)
    tstep = TrainStep(tm, _torch_loss, AdamW(
        learning_rate=LR, parameters=tm.parameters(), offload='host'))
    jslots = jstep._opt_state
    tstep.load_opt_state({'step': np.asarray(jslots['step']),
                          'slots': {n: {k: np.asarray(v) for k, v in s.items()}
                                    for n, s in jslots['slots'].items()}})
    want = float(jstep(ids[1], ids[1]).numpy())
    got = float(tstep(ids[1], ids[1]))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    for n, p in tm.state_dict().items():
        np.testing.assert_allclose(
            p.numpy(), np.asarray(jm.state_dict()[n].numpy()), rtol=0,
            atol=PARAM_ATOL, err_msg=n)


@pytest.mark.parametrize('offload', ['disk', 'cpu', True])
def test_offload_other_values_raise(offload):
    with pytest.raises(ValueError, match="offload must be None or 'host'"):
        AdamW(parameters=[torch.zeros(1)], offload=offload)
    with pytest.raises(ValueError):
        JaxAdamW(parameters=[paddle.zeros([1])], offload=offload)


def test_offload_of_an_adam_variant_names_roadmap():
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        NAdam(parameters=[torch.zeros(1)], offload='host')
    assert Adam(parameters=[torch.zeros(1)], offload='host')._engine


def test_offload_allocates_every_parameter_at_the_first_update():
    """A parameter without a grad at the first update still gets its
    host slots then (the buffers are allocated once); its later updates
    equal the in-HBM optimizer's."""
    def run(offload):
        a = torch.nn.Parameter(torch.linspace(-1, 1, 200))
        b = torch.nn.Parameter(torch.linspace(2, 3, 70))
        opt = AdamW(learning_rate=0.1, parameters=[a, b], offload=offload)
        a.grad = torch.ones(200)
        opt.step()
        if offload:
            assert set(opt._slots) == {a, b}
            host = opt._engine._host['moment1'].untyped_storage().data_ptr()
        b.grad = torch.full((70,), -0.5)
        opt.step()
        if offload:
            assert opt._engine._host['moment1'].untyped_storage() \
                .data_ptr() == host
        return a.detach().clone(), b.detach().clone()
    for x, y in zip(run(None), run('host')):
        assert torch.equal(x, y)
