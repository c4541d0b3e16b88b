"""The fault-tolerant step, the loss-spike detector and the step watchdog,
the port against the JAX package, on the CPU.

Both packages' `FaultTolerantStep`s wrap their `TrainStep`s over the tiny
GQA Llama (AdamW, the same weights and batches). A batch is poisoned
through the loss: the labels carry a scale the loss is multiplied by,
NaN (the update then writes NaNs into the parameters and moments) or 60
(a spike, once the detector's window holds 5 losses). Both must give the
same losses, rollbacks, skipped batches and events, and end on the same
parameters (losses rtol 1e-5, parameters atol 4e-5: the tolerances of
tests/test_torch_train.py); and the port's restore must give back the
snapshot bit for bit, in the same tensors. `SkipBudgetExhausted` raises
after `skip_budget_exhausted` is emitted. `LossSpikeDetector` flags the
same steps on one loss sequence. `StepWatchdog` fires once on a slow
step, emits `hang_suspected` with /healthz's hang state set until the
step returns, and interrupts the main thread.
"""
import math
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import debug as jdebug
from paddle_tpu import observability as jobs
from paddle_tpu import programs
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.observability import server as jserver
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.resilience import FaultTolerantStep as JaxFT
from paddle_tpu.resilience import SkipBudgetExhausted as JaxSkip
from paddle_tpu.resilience import StepWatchdog as JaxWatchdog
from paddle_tpu_torch import debug as tdebug
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.observability import server as tserver
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.resilience import (FaultTolerantStep,
                                         SkipBudgetExhausted, StepWatchdog)

from test_torch_observability import isolated_observability
from test_torch_train import LOSS_RTOL, PARAM_ATOL, _batches, _models

LR = 1e-3
EVENTS = ('bad_step', 'loss_spike', 'skip_budget_exhausted')


@pytest.fixture
def fresh_observability(tmp_path_factory):
    yield from isolated_observability(tmp_path_factory)


def _jax_loss(logits, labels):
    ids, scale = labels
    return JF.cross_entropy(logits[:, :-1].reshape([-1, 128]),
                            ids[:, 1:].reshape([-1])) * scale


def _torch_loss(logits, labels):
    ids, scale = labels
    return F.cross_entropy(logits[:, :-1].reshape(-1, 128),
                           ids[:, 1:].reshape(-1)) * scale


def _steps(offload=None, **ft):
    programs.get_store().clear_memory()
    jm, tm = _models(False)
    jstep = JaxFT(JaxTrainStep(jm, _jax_loss, JaxAdamW(
        learning_rate=LR, parameters=jm.parameters())), **ft)
    tstep = FaultTolerantStep(TrainStep(tm, _torch_loss, AdamW(
        learning_rate=LR, parameters=tm.parameters(), offload=offload)),
        **ft)
    return jm, tm, jstep, tstep


def _events(obs):
    return [(e['name'], e.get('skipped'), e.get('step'))
            for e in obs.get_event_log().events() if e['name'] in EVENTS]


def _run(jstep, tstep, scales, seed=0):
    batches = _batches(len(scales), seed=seed)
    jl, tl = [], []
    for ids, scale in zip(batches, scales):
        sc = np.float32(scale)
        jl.append(float(jstep(ids, (ids, sc)).numpy()))
        tl.append(float(tstep(ids, (ids, sc))))
    return jl, tl


def _same(a, b):
    for x, y in zip(a, b):
        if math.isnan(x):
            assert math.isnan(y)
        else:
            np.testing.assert_allclose(y, x, rtol=LOSS_RTOL)


@pytest.mark.parametrize('interval', [1, 2])
@pytest.mark.parametrize('offload', [None, 'host'])
def test_nan_and_spike_batches_match_jax(fresh_observability, interval,
                                         offload):
    jm, tm, jstep, tstep = _steps(offload, snapshot_interval=interval)
    scales = [1, 1, 1, 1, 1, 1, float('nan'), 1, 60, 1, 1]
    jl, tl = _run(jstep, tstep, scales)
    _same(jl, tl)
    assert tstep.stats() == jstep.stats()
    assert tstep.stats()['rollbacks'] == 2
    assert tstep.step._n_calls == jstep.step._n_calls
    assert tstep.step.optimizer._step_count == \
        int(np.asarray(jstep.step._opt_state['step']))
    assert _events(tobs) == _events(jobs)
    assert [e[0] for e in _events(tobs)] == ['loss_spike', 'bad_step'] * 2
    jsd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    for name, p in tm.state_dict().items():
        assert np.isfinite(p.numpy()).all()
        np.testing.assert_allclose(p.numpy(), jsd[name], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def test_a_bad_first_batch_restores_the_state_before_any_update(
        fresh_observability):
    jm, tm, jstep, tstep = _steps(check_spikes=False)
    jl, tl = _run(jstep, tstep, [float('nan'), 1, 1])
    _same(jl, tl)
    assert tstep.stats() == jstep.stats()
    assert tstep.step.optimizer._step_count == 2
    jsd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), jsd[name], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


@pytest.mark.parametrize('offload', [None, 'host'])
def test_restore_gives_the_snapshot_bit_for_bit_in_place(offload):
    _, tm, _, tstep = _steps(offload, check_spikes=False)
    batches = _batches(3)
    for ids in batches[:2]:
        tstep(ids, (ids, np.float32(1)))
    live = {('param', n): p for n, p in tm.named_parameters()}
    opt = tstep.step.opt_state()
    live.update({('slot', n, k): v for n, s in opt['slots'].items()
                 for k, v in s.items()})
    ptrs = {k: v.data_ptr() for k, v in live.items()}
    before = {k: v.detach().clone() for k, v in live.items()}
    tstep(batches[2], (batches[2], np.float32('nan')))
    assert tstep.last_step_skipped
    snap = tstep.snapshot_tensors()
    assert set(snap) == set(live)
    for k, v in live.items():
        assert v.data_ptr() == ptrs[k], k
        assert torch.equal(v.detach(), before[k]), k
        assert torch.equal(snap[k], before[k]), k
        assert snap[k].dtype == v.dtype
    assert tstep.step.optimizer._step_count == 2
    assert tstep.step._n_calls == 2


@pytest.mark.parametrize('budget', [0, 1])
def test_skip_budget_exhausted_raises_like_jax(fresh_observability, budget):
    _, _, jstep, tstep = _steps(skip_budget=budget, check_spikes=False)
    scales = [1] + [float('nan')] * (budget + 1)
    batches = _batches(len(scales))
    for step, exc in ((jstep, JaxSkip), (tstep, SkipBudgetExhausted)):
        with pytest.raises(exc, match='exceed the skip budget'):
            for ids, sc in zip(batches, scales):
                out = step(ids, (ids, np.float32(sc)))
                if step is jstep:
                    out.numpy()
    assert _events(tobs) == _events(jobs)
    assert _events(tobs)[-1][0] == 'skip_budget_exhausted'
    assert tstep.stats() == jstep.stats()


def test_loss_spike_detector_flags_the_jax_steps(fresh_observability):
    rng = np.random.RandomState(4)
    losses = list(5 - 0.01 * np.arange(40) + 0.02 * rng.randn(40))
    losses[8] = 9.0
    losses[12] = float('nan')
    losses[13] = float('inf')
    losses[20:24] = [7.0] * 4              # a level shift flags each step
    losses[30] = 5.4
    j = jdebug.LossSpikeDetector(window=10, threshold_sigma=4.0,
                                 min_steps=5)
    t = tdebug.LossSpikeDetector(window=10, threshold_sigma=4.0,
                                 min_steps=5)
    assert [t.update(x) for x in losses] == [j.update(x) for x in losses]
    assert t.spikes == j.spikes and len(t.spikes) >= 7
    assert list(t.window) == list(j.window)
    assert _events(tobs) == _events(jobs)


def _watched(dog, seconds):
    with dog.watch():
        time.sleep(seconds)


@pytest.mark.parametrize('pkg', ['jax', 'torch'])
def test_watchdog_fires_once_and_clears(fresh_observability, pkg):
    cls, obs, server = {'jax': (JaxWatchdog, jobs, jserver),
                        'torch': (StepWatchdog, tobs, tserver)}[pkg]
    seen = []
    dog = cls(0.05, on_hang=lambda elapsed: seen.append(
        (elapsed, server.hang_suspected())), poll_interval=0.01)
    try:
        _watched(dog, 0.3)
        assert dog.fired == 1 and len(seen) == 1
        assert seen[0][0] >= 0.05 and seen[0][1] is True
        assert not server.hang_suspected()
        _watched(dog, 0.0)                 # a quick step: no fire
        assert dog.fired == 1
        names = [e['name'] for e in obs.get_event_log().events()]
        assert names.count('hang_suspected') == 1
        hangs = obs.get_registry().counter(
            'paddle_resilience_hangs_total', '').value
        assert hangs == 1
    finally:
        dog.stop()


def test_watchdog_interrupts_the_main_thread():
    dog = StepWatchdog(0.05, on_hang='interrupt', poll_interval=0.01)
    try:
        with pytest.raises(KeyboardInterrupt):
            with dog.watch():
                deadline = time.monotonic() + 5.0
                while time.monotonic() < deadline:
                    time.sleep(0.01)
        assert dog.fired == 1
    finally:
        dog.stop()
    assert not tserver.hang_suspected()


def test_disabled_watchdog_starts_no_thread():
    dog = StepWatchdog(0)
    with dog.watch():
        pass
    assert not dog.enabled and dog._thread is None


def test_ft_step_takes_explicit_snapshot_functions():
    state = {'x': 1.0}
    snaps = []

    def body(value):
        state['x'] = value
        return torch.tensor(value)

    def snapshot():
        snaps.append(dict(state))
        return dict(state)

    ft = FaultTolerantStep(body, snapshot_fn=snapshot,
                           restore_fn=lambda s: state.update(s),
                           check_spikes=False)
    ft(2.0)
    ft(float('nan'))
    assert state['x'] == 2.0 and ft.rollbacks == 1
    with pytest.raises(TypeError, match='step-shaped'):
        FaultTolerantStep(body)
