"""The port's optimizers (paddle_tpu_torch/optimizer) against the JAX
package's `apply_gradients`, on the CPU: the same parameters and
gradients (made from a seed with numpy) go through both for 3 steps (8
for RAdam, whose rectified branch starts at step 6), for each of the 13
optimizers, under gradient clips, LR schedulers and L1/L2 decay, and
from a JAX `state_dict()` loaded into the port. On the CPU `Adam` and
`AdamW` run `multi_tensor_adam`'s plain version.

Tolerances: fp32 state agrees to rtol 1e-6, atol 1e-7 (the same fp32
operations in the same order; lr_t is computed in fp32 on both sides).
Parameters or moments stored in bf16 agree to one bf16 rounding
(rtol 2^-7), since the fp32 values they are rounded from agree to a few
fp32 ulps and can fall on either side of a rounding boundary.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.nn import clip as jclip
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer import lr as tlr

SHAPES = {'w': (6, 5), 'b': (5,), 'norm.weight': (5,)}
BF16_RTOL = 2.0 ** -7


def _params_and_grads(seed=0, steps=3):
    rng = np.random.default_rng(seed)
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in SHAPES.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32)
              for n, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


def _run_both(jax_opt, make_torch_opt, param_dtype=torch.float32, steps=3,
              after_step=None, grad_scale=1.0):
    """Run `steps` updates on both sides (`after_step()` after each, e.g.
    to step both schedulers); returns ({name: jax param}, {name: port
    param}, jax state, port optimizer)."""
    params, grads = _params_and_grads(steps=steps)
    grads = [{n: g * np.float32(grad_scale) for n, g in step.items()}
             for step in grads]
    jdt = jnp.float32 if param_dtype == torch.float32 else jnp.bfloat16
    jp = {n: jnp.asarray(v, jdt) for n, v in params.items()}
    tp = {n: torch.from_numpy(v).to(param_dtype) for n, v in params.items()}
    opt = make_torch_opt(list(tp.items()))
    state = jax_opt.init_state(jp)
    for g in grads:
        jp, state = jax_opt.apply_gradients(
            {n: jnp.asarray(v, jdt) for n, v in g.items()}, jp, state,
            jnp.asarray(jax_opt.get_lr(), jnp.float32))
        for n, t in tp.items():
            t.grad = torch.from_numpy(g[n]).to(param_dtype)
        opt.step()
        if after_step is not None:
            after_step()
    return ({n: np.asarray(v, np.float32) for n, v in jp.items()},
            {n: t.float().numpy() for n, t in tp.items()}, state, opt)


def _close(got, want, rtol=1e-6, atol=1e-7):
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=rtol, atol=atol,
                                   err_msg=n)


def test_adamw_fp32_moments_match_jax():
    jopt = JAdamW(learning_rate=1e-2)
    want, got, state, opt = _run_both(
        jopt, lambda ps: AdamW(learning_rate=1e-2, parameters=ps))
    _close(got, want)
    for n, p in opt._named:
        for slot in ('moment1', 'moment2'):
            np.testing.assert_allclose(
                opt._slots[p][slot].numpy(),
                np.asarray(state['slots'][n][slot]), rtol=1e-6, atol=1e-9)


def test_adamw_bf16_moments_match_jax():
    kw = dict(learning_rate=1e-2, moment_dtype='bfloat16', beta2=0.95)
    want, got, state, opt = _run_both(
        JAdamW(**kw), lambda ps: AdamW(parameters=ps, **kw))
    _close(got, want, rtol=1e-5, atol=1e-6)
    for n, p in opt._named:
        m = opt._slots[p]['moment1']
        assert m.dtype == torch.bfloat16
        np.testing.assert_allclose(
            m.float().numpy(),
            np.asarray(state['slots'][n]['moment1'], np.float32),
            rtol=BF16_RTOL, atol=1e-6)


def test_adamw_multi_precision_bf16_params_match_jax():
    """bf16 parameters with fp32 masters: the masters agree in fp32, the
    bf16 parameters within one bf16 rounding."""
    kw = dict(learning_rate=1e-2, multi_precision=True)
    want, got, state, opt = _run_both(
        JAdamW(**kw), lambda ps: AdamW(parameters=ps, **kw),
        param_dtype=torch.bfloat16)
    _close(got, want, rtol=BF16_RTOL, atol=1e-6)
    for n, p in opt._named:
        assert p.dtype == torch.bfloat16
        np.testing.assert_allclose(
            opt._slots[p]['master'].numpy(),
            np.asarray(state['slots'][n]['master']), rtol=1e-6, atol=1e-7)


def test_adamw_bf16_params_without_masters_match_jax():
    """The training rung's setting: bf16 params, bf16 moments, no fp32
    masters."""
    kw = dict(learning_rate=1e-2, moment_dtype='bfloat16')
    want, got, _, _ = _run_both(JAdamW(**kw),
                                lambda ps: AdamW(parameters=ps, **kw),
                                param_dtype=torch.bfloat16)
    _close(got, want, rtol=BF16_RTOL, atol=1e-6)


def test_adamw_apply_decay_param_fun_matches_jax():
    def fn(name):
        return not (name == 'b' or name.endswith('norm.weight'))
    kw = dict(learning_rate=1e-2, weight_decay=0.1,
              apply_decay_param_fun=fn)
    want, got, _, _ = _run_both(JAdamW(**kw),
                                lambda ps: AdamW(parameters=ps, **kw))
    _close(got, want)
    # and the exemption matters: with decay everywhere 'b' moves otherwise
    everywhere, _, _, _ = _run_both(JAdamW(learning_rate=1e-2,
                                           weight_decay=0.1),
                                    lambda ps: AdamW(parameters=ps))
    assert not np.allclose(everywhere['b'], want['b'], rtol=0, atol=1e-6)


def test_adam_l2_weight_decay_matches_jax():
    kw = dict(learning_rate=1e-2, weight_decay=0.05)
    want, got, _, _ = _run_both(JAdam(**kw),
                                lambda ps: Adam(parameters=ps, **kw))
    _close(got, want)


def test_epsilon_sits_outside_the_bias_correction():
    """One step from zero moments with a tiny gradient: Paddle's rule
    gives lr_t * m / (sqrt(v) + eps), which differs from
    torch.optim.AdamW's lr * m_hat / (sqrt(v_hat) + eps)."""
    p = torch.zeros(3)
    p.grad = torch.full((3,), 1e-6)
    opt = AdamW(learning_rate=1.0, weight_decay=0.0, parameters=[p])
    opt.step()
    ref = torch.zeros(3, requires_grad=True)
    ref.grad = torch.full((3,), 1e-6)
    torch.optim.AdamW([ref], lr=1.0, weight_decay=0.0).step()
    b1, b2, eps, g = 0.9, 0.999, 1e-8, 1e-6
    lr_t = np.sqrt(1 - b2) / (1 - b1)
    paddle = -lr_t * (1 - b1) * g / (np.sqrt(1 - b2) * g + eps)
    np.testing.assert_allclose(p.numpy(), paddle, rtol=1e-5)
    assert not np.allclose(p.numpy(), ref.detach().numpy(), rtol=1e-3)


def test_eager_api():
    p = torch.ones(4, requires_grad=True)
    opt = AdamW(learning_rate=0.5, parameters=[p])
    assert opt.get_lr() == 0.5
    opt.set_lr(0.25)
    assert opt.get_lr() == 0.25
    opt.step()                      # no grad yet: nothing moves
    assert torch.equal(p.detach(), torch.ones(4))
    (p * 2).sum().backward()
    opt.step()
    assert (p.detach() < 1).all()
    opt.clear_grad()
    assert p.grad is None
    with pytest.raises(ValueError):
        AdamW(learning_rate=0.1).step()


@pytest.mark.parametrize('kw', [dict(offload='host')])
def test_unported_options_raise(kw):
    """`offload='host'`, which this test once saw refused, now builds the
    host-offload engine, whose update equals the in-HBM one bit for bit;
    any other value raises ValueError, as in the JAX package. Parity with
    the JAX engine is in tests/test_torch_offload.py."""
    with pytest.raises(ValueError, match="offload must be None or 'host'"):
        AdamW(parameters=[torch.zeros(1)], offload='disk')
    got = []
    for opts in ({}, kw):
        p = torch.nn.Parameter(torch.linspace(-1, 1, 300))
        opt = AdamW(learning_rate=0.1, parameters=[p], **opts)
        assert (opt._engine is not None) == bool(opts)
        for _ in range(2):
            p.grad = p.detach() * 3 - 1
            opt.step()
        got.append(p.detach().clone())
    assert torch.equal(got[0], got[1])


def _close_slots(opt, state, rtol=1e-6, atol=1e-7):
    """Every slot of every parameter, port against JAX."""
    for n, p in opt._named:
        want = state['slots'][n]
        got = opt._slots[p]
        assert set(got) == set(want), n
        for k, v in got.items():
            np.testing.assert_allclose(
                v.float().numpy(), np.asarray(want[k], np.float32),
                rtol=rtol, atol=atol, err_msg=f'{n}.{k}')


def _not_norm(name):
    return 'norm' not in name


# (id, optimizer class name, keyword arguments, steps): every optimizer
# of the JAX package, and the options that change its arithmetic
OPTIMIZERS = [
    ('SGD', 'SGD', dict(learning_rate=0.1), 3),
    ('SGD-l2', 'SGD', dict(learning_rate=0.1, weight_decay=0.05), 3),
    ('Momentum', 'Momentum', dict(learning_rate=0.1, momentum=0.9), 3),
    ('Momentum-nesterov', 'Momentum',
     dict(learning_rate=0.1, momentum=0.8, use_nesterov=True), 3),
    ('Adagrad', 'Adagrad',
     dict(learning_rate=0.1, initial_accumulator_value=0.1), 3),
    ('RMSProp', 'RMSProp', dict(learning_rate=0.01), 3),
    ('RMSProp-centered-momentum', 'RMSProp',
     dict(learning_rate=0.01, centered=True, momentum=0.9), 3),
    ('Adam', 'Adam', dict(learning_rate=0.01), 3),
    ('AdamW', 'AdamW', dict(learning_rate=0.01, weight_decay=0.1,
                            apply_decay_param_fun=_not_norm), 3),
    ('Lamb', 'Lamb', dict(learning_rate=0.01,
                          exclude_from_weight_decay_fn=lambda n: n == 'b'),
     3),
    ('Adadelta', 'Adadelta', dict(learning_rate=1.0), 3),
    ('Adamax', 'Adamax', dict(learning_rate=0.01), 3),
    ('NAdam', 'NAdam', dict(learning_rate=0.01), 3),
    ('RAdam', 'RAdam', dict(learning_rate=0.01, beta2=0.9), 8),
    ('Rprop', 'Rprop', dict(learning_rate=0.01), 3),
    ('ASGD', 'ASGD', dict(learning_rate=0.1, batch_num=2), 3),
    ('ASGD-1', 'ASGD', dict(learning_rate=0.1), 3),
]


@pytest.mark.parametrize('cls,kw,steps', [c[1:] for c in OPTIMIZERS],
                         ids=[c[0] for c in OPTIMIZERS])
def test_optimizer_matches_jax(cls, kw, steps):
    """Parameters and every slot after `steps` updates, at the file's
    fp32 tolerance."""
    want, got, state, opt = _run_both(
        getattr(jopt, cls)(**kw),
        lambda ps: getattr(topt, cls)(parameters=ps, **kw), steps=steps)
    _close(got, want)
    _close_slots(opt, state)
    assert int(state['step']) == opt._step_count == steps


def test_every_jax_optimizer_has_a_twin():
    names = {n for n, v in vars(jopt).items()
             if isinstance(v, type) and issubclass(v, jopt.Optimizer)}
    assert len(names) == 14            # Optimizer and its 13 subclasses
    assert {c[1] for c in OPTIMIZERS} == names - {'Optimizer'}
    for n in names:
        assert issubclass(getattr(topt, n), topt.Optimizer), n


def _schedulers(m):
    return m.LinearWarmup(m.CosineAnnealingDecay(1e-2, T_max=8,
                                                 eta_min=1e-3),
                          warmup_steps=2, start_lr=0.0, end_lr=1e-2)


@pytest.mark.parametrize('param_dtype,moment_dtype', [
    (torch.float32, None), (torch.bfloat16, 'bfloat16')])
@pytest.mark.parametrize('clip_norm', [1.0, 1e3])
def test_adamw_global_clip_and_schedule_match_jax(clip_norm, param_dtype,
                                                  moment_dtype):
    """Phase 5b's recipe on both sides: AdamW(beta2=0.95, eps=1e-5,
    decay 0.1 but not on norms) under ClipGradByGlobalNorm, the lr from
    LinearWarmup around a cosine stepped after every update. Grads of
    norm ~24 clip at 1.0 (scale < 1: each grad is scaled and rounded to
    its dtype, then used in fp32) and pass at 1e3."""
    js, ts = _schedulers(jlr), _schedulers(tlr)
    kw = dict(beta2=0.95, epsilon=1e-5, weight_decay=0.1,
              apply_decay_param_fun=_not_norm, moment_dtype=moment_dtype)
    jax_opt = JAdamW(learning_rate=js,
                     grad_clip=jclip.ClipGradByGlobalNorm(clip_norm), **kw)

    def after():
        js.step()
        ts.step()

    want, got, state, opt = _run_both(
        jax_opt, lambda ps: AdamW(
            learning_rate=ts, parameters=ps,
            grad_clip=tnn.ClipGradByGlobalNorm(clip_norm), **kw),
        param_dtype=param_dtype, steps=4, after_step=after, grad_scale=4.0)
    if param_dtype == torch.float32:
        _close(got, want)
        _close_slots(opt, state)
    else:
        _close(got, want, rtol=BF16_RTOL, atol=1e-6)
        _close_slots(opt, state, rtol=BF16_RTOL, atol=1e-6)
    assert opt.get_lr() == jax_opt.get_lr() == ts() != 0.0


@pytest.mark.parametrize('clip', [
    lambda m: m.ClipGradByValue(0.5), lambda m: m.ClipGradByNorm(1.0)],
    ids=['value', 'norm'])
def test_adam_per_tensor_clips_match_jax(clip):
    want, got, state, opt = _run_both(
        JAdam(learning_rate=1e-2, grad_clip=clip(jclip)),
        lambda ps: Adam(learning_rate=1e-2, parameters=ps,
                        grad_clip=clip(tnn)), grad_scale=2.0)
    _close(got, want)
    _close_slots(opt, state)


@pytest.mark.parametrize('cls', ['Adam', 'SGD', 'Momentum'])
@pytest.mark.parametrize('reg', ['L1Decay', 'L2Decay'])
def test_regularizers_match_jax(cls, reg):
    """L2Decay adds coeff * p to the grad, L1Decay coeff * sign(p): through
    the multi-tensor update (Adam) and through the per-parameter rules."""
    want, got, state, opt = _run_both(
        getattr(jopt, cls)(learning_rate=0.05,
                           weight_decay=getattr(jopt, reg)(0.2)),
        lambda ps: getattr(topt, cls)(learning_rate=0.05, parameters=ps,
                                      weight_decay=getattr(topt, reg)(0.2)))
    _close(got, want)
    _close_slots(opt, state)
    plain, _, _, _ = _run_both(jopt.SGD(learning_rate=0.05) if cls == 'SGD'
                               else getattr(jopt, cls)(learning_rate=0.05),
                               lambda ps: topt.SGD(parameters=ps))
    assert not np.allclose(plain['w'], want['w'], rtol=0, atol=1e-6)


@pytest.mark.parametrize('param_dtype,kw', [
    (torch.float32, dict()),
    (torch.float32, dict(moment_dtype='bfloat16', beta2=0.9)),
    (torch.bfloat16, dict(multi_precision=True, weight_decay=0.1))],
    ids=['fp32', 'bf16-moments', 'bf16-masters'])
def test_amsgrad_matches_jax(param_dtype, kw):
    """The running max of v is stored rounded, and the step uses the
    fp32 max, on both sides. The grads shrink 100-fold a step so that v
    falls and the max, not v, sets the step."""
    params, grads = _params_and_grads(steps=4)
    jdt = jnp.float32 if param_dtype == torch.float32 else jnp.bfloat16
    jax_opt = JAdamW(learning_rate=1e-2, amsgrad=True, **kw)
    jp = {n: jnp.asarray(v, jdt) for n, v in params.items()}
    tp = {n: torch.from_numpy(v).to(param_dtype) for n, v in params.items()}
    opt = AdamW(learning_rate=1e-2, amsgrad=True, parameters=list(tp.items()),
                **kw)
    state = jax_opt.init_state(jp)
    for i, g in enumerate(grads):
        g = {n: v * np.float32(0.01 ** i) for n, v in g.items()}
        jp, state = jax_opt.apply_gradients(
            {n: jnp.asarray(v, jdt) for n, v in g.items()}, jp, state,
            jnp.asarray(jax_opt.get_lr(), jnp.float32))
        for n, t in tp.items():
            t.grad = torch.from_numpy(g[n]).to(param_dtype)
        opt.step()
    want = {n: np.asarray(v, np.float32) for n, v in jp.items()}
    got = {n: t.float().numpy() for n, t in tp.items()}
    low = param_dtype == torch.bfloat16 or 'moment_dtype' in kw
    _close(got, want, **(dict(rtol=BF16_RTOL, atol=1e-6) if low else {}))
    _close_slots(opt, state, **(dict(rtol=BF16_RTOL, atol=1e-6) if low
                                else {}))
    for n, p in opt._named:
        vmax, v = opt._slots[p]['moment2_max'], opt._slots[p]['moment2']
        assert (vmax.float() >= v.float()).all() and \
            (vmax.float() > v.float()).any()


def _jax_params(params):
    return {n: paddle.Parameter(jnp.asarray(v), name=n)
            for n, v in params.items()}


@pytest.mark.parametrize('kw', [
    dict(),
    dict(moment_dtype='bfloat16', amsgrad=True),
])
def test_jax_state_dict_resumes_in_the_port(kw):
    """A JAX AdamW (eager, under a scheduler) takes 2 steps; its
    `state_dict()` and parameters load into a fresh port AdamW, and both
    take 2 more steps: parameters, slots and lr agree at the file's
    tolerances (bf16 moments: one bf16 rounding)."""
    params, grads = _params_and_grads(steps=4)
    js, ts = _schedulers(jlr), _schedulers(tlr)
    jp = _jax_params(params)
    jax_opt = JAdamW(learning_rate=js, parameters=list(jp.values()),
                     weight_decay=0.1, **kw)

    def jax_step(g):
        for n, p in jp.items():
            p.grad = paddle.to_tensor(g[n])
        jax_opt.step()
        js.step()

    for g in grads[:2]:
        jax_step(g)
    sd = jax_opt.state_dict()
    tp = {n: torch.from_numpy(np.array(p.numpy())) for n, p in jp.items()}
    opt = AdamW(learning_rate=ts, parameters=list(tp.items()),
                weight_decay=0.1, **kw)
    opt.set_state_dict(sd)
    assert opt._step_count == 2 and ts.last_epoch == js.last_epoch == 2
    for g in grads[2:]:
        jax_step(g)
        for n, t in tp.items():
            t.grad = torch.from_numpy(g[n])
        opt.step()
        ts.step()
    tol = dict(rtol=BF16_RTOL, atol=1e-6) if kw else {}
    _close({n: t.numpy() for n, t in tp.items()},
           {n: p.numpy() for n, p in jp.items()}, **tol)
    port_sd = opt.state_dict()
    jax_sd = jax_opt.state_dict()
    assert port_sd['step'] == jax_sd['step'] == 4
    assert port_sd['LR_Scheduler'] == jax_sd['LR_Scheduler']
    for got_s, want_s in zip(port_sd['slots'], jax_sd['slots']):
        assert set(got_s) == set(want_s)
        for k in got_s:
            np.testing.assert_allclose(got_s[k],
                                       np.asarray(want_s[k], np.float32),
                                       err_msg=k, **(tol or dict(
                                           rtol=1e-6, atol=1e-9)))


def test_port_state_dict_round_trip():
    """A port optimizer's state_dict restores a fresh one (slots cast back
    to their dtypes, the scheduler's state included); the two then step
    alike."""
    params, grads = _params_and_grads(steps=3)

    def make():
        tp = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
        return tp, NAdamLike(tp)

    def NAdamLike(tp):
        return topt.NAdam(learning_rate=_schedulers(tlr),
                          parameters=list(tp.items()),
                          moment_dtype='bfloat16')

    tp, opt = make()
    for n, t in tp.items():
        t.grad = torch.from_numpy(grads[0][n])
    opt.step()
    opt._learning_rate.step()
    sd = opt.state_dict()
    tp2 = {n: t.clone() for n, t in tp.items()}
    opt2 = NAdamLike(tp2)
    opt2.set_state_dict(sd)
    for p2 in tp2.values():
        s = opt2._slots[p2]
        assert s['moment1'].dtype == torch.bfloat16 and s['mu_product'].shape == ()
    for g in grads[1:]:
        for o, ts_ in ((opt, tp), (opt2, tp2)):
            for n, t in ts_.items():
                t.grad = torch.from_numpy(g[n])
            o.step()
    for n in tp:
        assert torch.equal(tp[n], tp2[n])
    with pytest.raises(KeyError):
        Adam(parameters=list(tp2.values())).set_state_dict(
            {'step': 1, 'slots': [{'velocity': np.zeros((6, 5))}]})


def test_scheduler_drives_the_lr_and_set_lr_refuses():
    sched = tlr.StepDecay(0.5, step_size=1, gamma=0.5)
    p = torch.ones(4, requires_grad=True)
    opt = topt.SGD(learning_rate=sched, parameters=[p])
    assert opt.get_lr() == 0.5
    with pytest.raises(RuntimeError):
        opt.set_lr(0.1)
    for lr in (0.5, 0.25):
        before = p.detach().clone()
        p.grad = torch.ones(4)
        opt.step()
        torch.testing.assert_close(p.detach(), before - lr)
        sched.step()
    assert opt.get_lr() == 0.125


def test_minimize_and_clear_gradients():
    p = torch.ones(3, requires_grad=True)
    opt = topt.SGD(learning_rate=0.5, parameters=[p])
    assert opt.minimize((p * 2).sum()) == (None, None)
    torch.testing.assert_close(p.detach(), torch.zeros(3))
    opt.clear_gradients()
    assert p.grad is None


def test_grad_clip_leaves_grads_as_they_were():
    p = torch.ones(3, requires_grad=True)
    g = torch.full((3,), 10.0)
    p.grad = g.clone()
    topt.SGD(learning_rate=1.0, parameters=[p],
             grad_clip=tnn.ClipGradByGlobalNorm(1.0)).step()
    torch.testing.assert_close(p.grad, g)
    torch.testing.assert_close(p.detach(), torch.ones(3) - 3 ** -0.5)
