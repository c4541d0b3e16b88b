"""The port's gradient clips (paddle_tpu_torch/nn/clip.py) and the plain
version of the multi-tensor sum of squares against the JAX package's
clips (paddle_tpu/nn/clip.py), on the CPU.

The same grads (made from a seed with numpy) go through both, in fp32
and in bf16, scaled so that each clip's scale falls below 1 (the grads
shrink) and above it (they pass unchanged). Tolerances: fp32 rtol 1e-6
(the squares are summed in another order in each framework); a bf16
grad is clipped in fp32 and rounded once to bf16 on each side, and the
fp32 values agree to a few ulps, so the results agree to one bf16
rounding (rtol 2^-7).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import clip as jclip
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.ops import kernels as K

SHAPES = [(6, 5), (5,), (3, 4, 2)]
TOL = {torch.float32: dict(rtol=1e-6, atol=1e-7),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-6)}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _grads(scale, seed=0):
    rng = np.random.default_rng(seed)
    return [scale * rng.standard_normal(s).astype(np.float32) for s in SHAPES]


def _both(grads, dtype):
    jg = [Tensor(jnp.asarray(g, JDT[dtype])) for g in grads]
    tg = [torch.from_numpy(g).to(dtype) for g in grads]
    return jg, tg


def _check(got, want, dtype):
    for t, j in zip(got, want):
        assert t.dtype == dtype
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j.value, np.float32),
                                   **TOL[dtype])


# the clip, the grad scale that puts its scale below 1 and the one above
CLIPS = [
    ('value', lambda m: m.ClipGradByValue(0.5), 1.0, 0.1),
    ('value-min', lambda m: m.ClipGradByValue(0.4, min=-0.2), 1.0, 0.05),
    ('norm', lambda m: m.ClipGradByNorm(1.0), 1.0, 0.01),
    ('global', lambda m: m.ClipGradByGlobalNorm(1.0), 1.0, 0.01),
]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('below', [True, False])
@pytest.mark.parametrize('name,make,big,small', CLIPS,
                         ids=[c[0] for c in CLIPS])
def test_clip_matches_jax(name, make, big, small, below, dtype):
    grads = _grads(big if below else small)
    jg, tg = _both(grads, dtype)
    params = [object() for _ in grads]
    want = make(jclip)(list(zip(params, jg)))
    got = make(tnn)(list(zip(params, tg)))
    assert [p for p, _ in got] == params
    _check([g for _, g in got], [g for _, g in want], dtype)
    changed = any(not torch.equal(a, b) for a, b in
                  zip([g for _, g in got], tg))
    assert changed == below


def test_clip_passes_none_grads_through():
    g = torch.ones(3)
    for clip in (tnn.ClipGradByValue(0.1), tnn.ClipGradByNorm(0.1),
                 tnn.ClipGradByGlobalNorm(0.1)):
        out = clip([('a', None), ('b', g)])
        assert out[0] == ('a', None) and out[1][1].abs().max() <= 0.1
    assert tnn.ClipGradByGlobalNorm(1.0)([('a', None)]) == [('a', None)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_global_scale_is_the_jax_scale(dtype):
    """`scale` (what Adam/AdamW hand the fused kernel) is the JAX clip's
    `min(clip / max(norm, 1e-12), 1)`: a 0-d fp32 tensor."""
    jg, tg = _both(_grads(1.0), dtype)
    want = jclip.ClipGradByGlobalNorm(1.5)._scale([g.value for g in jg])
    got = tnn.ClipGradByGlobalNorm(1.5).scale(tg)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(tnn.ClipGradByGlobalNorm(1e6).scale(tg)) == 1.0


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_sumsq_plain_matches_jax(dtype):
    grads = _grads(3.0, seed=4) + [np.zeros((0,), np.float32)]
    jg, tg = _both(grads, dtype)
    want = sum(jnp.sum(jnp.square(g.value.astype(jnp.float32))) for g in jg)
    got = K.multi_tensor_sumsq(tg)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(K.multi_tensor_sumsq([])) == 0.0


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('norm_type', [2.0, 1.0, float('inf')])
@pytest.mark.parametrize('below', [True, False])
def test_clip_grad_norm_matches_jax(norm_type, dtype, below):
    grads = _grads(1.0 if below else 0.01, seed=2)
    jg, tg = _both(grads, dtype)
    jp = [Tensor(jnp.zeros(g.shape, JDT[dtype])) for g in grads]
    tp = [torch.zeros(g.shape, dtype=dtype) for g in grads]
    for p, g in zip(jp, jg):
        p.grad = g
    for p, g in zip(tp, tg):
        p.grad = g
    want = jclip.clip_grad_norm_(jp, 1.0, norm_type=norm_type)
    got = tnn.clip_grad_norm_(tp, 1.0, norm_type=norm_type)
    np.testing.assert_allclose(float(got), float(np.asarray(want.value)),
                               **TOL[dtype])
    _check([p.grad for p in tp], [p.grad for p in jp], dtype)
    assert any(not torch.equal(p.grad, g) for p, g in zip(tp, tg)) == below


def test_clip_grad_norm_edge_cases():
    assert float(tnn.clip_grad_norm_([torch.zeros(2)], 1.0)) == 0.0
    p = torch.zeros(4)
    p.grad = torch.full((4,), 2.0)
    total = tnn.clip_grad_norm_(p, 1.0)           # a single tensor
    assert float(total) == 4.0
    torch.testing.assert_close(p.grad, torch.full((4,), 0.5))
