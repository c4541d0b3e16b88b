"""The port's optimizers (paddle_tpu_torch/optimizer) against the JAX
package's `Adam`/`AdamW.apply_gradients`, on the CPU: the same
parameters and gradients (made from a seed with numpy) go through both
for 3 steps.

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

from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch.optimizer import Adam, AdamW

SHAPES = {'w': (6, 5), 'b': (5,), 'norm.weight': (5,)}
BF16_RTOL = 2.0 ** -7


def _params_and_grads(seed=0, steps=3):
    rng = np.random.default_rng(seed)
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in SHAPES.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32)
              for n, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


def _run_both(jax_opt, make_torch_opt, param_dtype=torch.float32, steps=3):
    """Run `steps` updates on both sides; returns ({name: jax param},
    {name: port param}, jax state, port optimizer)."""
    params, grads = _params_and_grads(steps=steps)
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


@pytest.mark.parametrize('kw', [dict(offload='host'),
                                dict(grad_clip=object()),
                                dict(learning_rate=lambda: 0.1)])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        AdamW(parameters=[torch.zeros(1)], **kw)
