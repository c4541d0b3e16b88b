"""The port's kernels (paddle_tpu_torch/ops/kernels.py) against the JAX
package's oracles, on the CPU.

On the CPU every wrapper takes its kernel's plain PyTorch version, so
these tests hold the plain versions to the functions the TPU kernels
compute: `_attention_xla` for flash attention, `F.rms_norm` and the
Pallas `rms_norm` (interpret mode) for RMSNorm, and
`paged_attention_reference` for paged attention. The same inputs, made
from a seed with numpy, go to both packages. fp32 tolerance: rtol 2e-4,
atol 2e-5 (the sums run in another order in each framework).

The CUDA kernels themselves are held to their plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.ops.pallas import _attention_xla
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch.ops import kernels as K

RTOL, ATOL = 2e-4, 2e-5


def _np(shape, rng, dtype=np.float32):
    return rng.standard_normal(shape).astype(dtype)


# ---------------------------------------------------------------------------
# flash attention: plain version vs _attention_xla
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('sq,sk,h,hkv', [
    (7, 7, 4, 4),       # ragged, smaller than any tile
    (33, 33, 4, 2),     # GQA
    (100, 100, 8, 2),
    (5, 12, 4, 1),      # sq < sk: bottom-right causal alignment
])
def test_flash_plain_matches_attention_xla(sq, sk, h, hkv):
    rng = np.random.default_rng(sq * 10 + hkv)
    q, k, v = (_np((2, sq, h, 16), rng), _np((2, sk, hkv, 16), rng),
               _np((2, sk, hkv, 16), rng))
    want = np.asarray(_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True))
    got = K.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_masked_attention_matches_attention_xla():
    rng = np.random.default_rng(3)
    q, k, v = _np((2, 6, 4, 16), rng), _np((2, 9, 2, 16), rng), \
        _np((2, 9, 2, 16), rng)
    mask = rng.random((2, 1, 6, 9)) > 0.3
    mask[..., 0] = True
    want = np.asarray(_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), mask=jnp.asarray(mask)))
    got = K.attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v),
                                mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# RMSNorm: plain version vs F.rms_norm and the Pallas kernel
# ---------------------------------------------------------------------------

def test_rms_plain_matches_functional_and_pallas():
    rng = np.random.default_rng(5)
    x, w = _np((3, 8, 64), rng), _np((64,), rng)
    got = K.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy()
    functional = JF.rms_norm(Tensor(jnp.asarray(x)), Tensor(jnp.asarray(w)),
                             epsilon=1e-6).numpy()
    pallas = np.asarray(pk.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6,
                                    True))
    np.testing.assert_allclose(got, functional, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)


def test_rms_plain_bf16_follows_functional_rounding():
    """bf16: normalize in fp32, cast, then multiply by the weight in bf16
    (the JAX model's order). Agreement within one bf16 rounding."""
    rng = np.random.default_rng(6)
    x, w = _np((16, 64), rng), (1 + 0.1 * _np((64,), rng))
    xt = torch.from_numpy(x).bfloat16()
    wt = torch.from_numpy(w).bfloat16()
    got = K.rms_norm(xt, wt, 1e-6)
    assert got.dtype == torch.bfloat16
    want = JF.rms_norm(Tensor(jnp.asarray(xt.float().numpy(), jnp.bfloat16)),
                       Tensor(jnp.asarray(wt.float().numpy(), jnp.bfloat16)),
                       epsilon=1e-6).numpy().astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=8e-3,
                               atol=8e-3)


# ---------------------------------------------------------------------------
# paged attention: plain version vs paged_attention_reference
# ---------------------------------------------------------------------------

def _paged_case(seed, h=4, hkv=4, n=4, p=4, ps=8, d=16, num_pages=20,
                quant=False):
    rng = np.random.default_rng(seed)
    q = _np((n, h, d), rng)
    table = rng.integers(1, num_pages, (n, p)).astype(np.int32)
    lengths = rng.integers(1, p * ps + 1, (n,)).astype(np.int32)
    if quant:
        kp = rng.integers(-127, 128, (num_pages, ps, hkv, d)).astype(np.int8)
        vp = rng.integers(-127, 128, (num_pages, ps, hkv, d)).astype(np.int8)
        ks = (rng.random((num_pages, hkv)) / 127 + 1e-3).astype(np.float32)
        vs = (rng.random((num_pages, hkv)) / 127 + 1e-3).astype(np.float32)
        return q, kp, vp, table, lengths, ks, vs
    return (q, _np((num_pages, ps, hkv, d), rng),
            _np((num_pages, ps, hkv, d), rng), table, lengths, None, None)


def _paged_both(q, kp, vp, table, lengths, ks, vs):
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.from_numpy(a)
    want = np.asarray(pk.paged_attention_reference(
        j(q), j(kp), j(vp), j(table), j(lengths), k_scales=j(ks),
        v_scales=j(vs)))
    got = K.paged_attention(t(q), t(kp), t(vp), t(table), t(lengths),
                            k_scales=t(ks), v_scales=t(vs)).numpy()
    return got, want


@pytest.mark.parametrize('case', ['f32', 'gqa', 'int8', 'int8_gqa',
                                  'null_page', 'zero_length'])
def test_paged_plain_matches_reference(case):
    kw = {'gqa': dict(hkv=2), 'int8': dict(quant=True),
          'int8_gqa': dict(quant=True, hkv=1)}.get(case, {})
    q, kp, vp, table, lengths, ks, vs = _paged_case(
        seed=len(case), **kw)
    if case == 'null_page':
        # an inactive slot's table row is redirected to the null page
        table[1] = 0
    if case == 'zero_length':
        lengths[2] = 0
    got, want = _paged_both(q, kp, vp, table, lengths, ks, vs)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_paged_entries_past_length_are_inert():
    """Table entries past a slot's length may point anywhere: the output
    does not change when they move to the null page."""
    q, kp, vp, table, lengths, _, _ = _paged_case(seed=9)
    lengths[:] = kp.shape[1]                      # one page used
    t = torch.from_numpy
    base = K.paged_attention(t(q), t(kp), t(vp), t(table), t(lengths))
    table[:, 1:] = 0
    got = K.paged_attention(t(q), t(kp), t(vp), t(table), t(lengths))
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# dispatch: the CPU takes the plain version, nothing else falls back
# ---------------------------------------------------------------------------

def test_cpu_dispatch_counts_no_launch():
    K.reset_launch_counts()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(_np((2, 8, 4, 16), rng))
    K.flash_attention_fwd(x, x, x, causal=True)
    K.rms_norm(x, torch.ones(16), 1e-6)
    q, kp, vp, table, lengths, _, _ = _paged_case(seed=1)
    t = torch.from_numpy
    K.paged_attention(t(q), t(kp), t(vp), t(table), t(lengths))
    assert K.LAUNCHES == {name: 0 for name in K.LAUNCHES}


@pytest.mark.parametrize('call', ['flash', 'rms', 'paged'])
def test_wrappers_raise_off_cpu_and_cuda(call):
    """A tensor that is neither on the CPU nor on a CUDA device has no
    kernel and no fallback: the wrapper raises."""
    x = torch.zeros((1, 8, 2, 128), device='meta')
    with pytest.raises(ValueError):
        if call == 'flash':
            K.flash_attention_fwd(x, x, x, causal=True)
        elif call == 'rms':
            K.rms_norm(x, torch.ones(128, device='meta'))
        else:
            K.paged_attention(x[:, 0], x, x,
                              torch.zeros((1, 1), dtype=torch.int32,
                                          device='meta'),
                              torch.ones(1, dtype=torch.int32,
                                         device='meta'))


def test_mixed_devices_raise():
    with pytest.raises(ValueError):
        K.rms_norm(torch.zeros(2, 4), torch.ones(4, device='meta'))
