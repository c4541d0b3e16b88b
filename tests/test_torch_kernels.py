"""The port's kernels (paddle_tpu_torch/ops/kernels.py) against the JAX
package's oracles, on the CPU.

On the CPU every wrapper takes its kernel's plain PyTorch version, so
these tests hold the plain versions to the functions the TPU kernels
compute: `_attention_xla` for flash attention, `F.rms_norm` and the
Pallas `rms_norm` (interpret mode) for RMSNorm, and
`paged_attention_reference` for paged attention; and the training
kernels' plain versions to the Pallas flash backward and fused
cross-entropy kernels (interpret mode), `_ce_xla`, `F.cross_entropy` and
`jax.grad`. The same inputs, made
from a seed with numpy, go to both packages. fp32 tolerance: rtol 2e-4,
atol 2e-5 (the sums run in another order in each framework).

The CUDA kernels themselves are held to their plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.ops.pallas import _attention_xla
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.nn import functional as TF
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


RMS_LIMITS = {'float32': (1e-5, 1e-6), 'bfloat16': (8e-3, 8e-3),
              'float16': (1e-3, 1e-3)}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16', 'float16'])
@pytest.mark.parametrize('rows,width', [(8, 4096), (3, 1024), (2, 2048),
                                        (5, 4100)])
def test_rms_plain_at_the_kernel_widths_matches_functional(rows, width,
                                                           dtype):
    """The plain version (the wrapper's CPU route) at the RMSNorm kernel's
    widths (decode's 8 rows of 4096, 1024, 2048, and 4100: not a multiple
    of the 16-byte vector) against the JAX `F.rms_norm` in the same dtype.
    Limits: f32 rtol 1e-5 and atol 1e-6; bf16 one rounding of a value
    <= 4 (8e-3); fp16 one rounding (1e-3)."""
    rng = np.random.default_rng(rows * width)
    x = _np((rows, width), rng)
    w = 1 + 0.1 * _np((width,), rng)
    tdt = getattr(torch, dtype)
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    got = K.rms_norm(xt, wt, 1e-6)
    assert got.dtype == tdt
    want = JF.rms_norm(Tensor(jnp.asarray(xt.float().numpy(), dtype)),
                       Tensor(jnp.asarray(wt.float().numpy(), dtype)),
                       epsilon=1e-6).numpy().astype(np.float32)
    rtol, atol = RMS_LIMITS[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol)


def test_rms_vector_path_choice():
    """The kernel moves 16 bytes at a time only when the width is a
    multiple of 16 / itemsize and x, weight and out are 16-byte aligned;
    otherwise it runs the same kernel with one-element accesses. A view
    one element past an aligned buffer gives the plain result of its
    copy."""
    buf = torch.zeros(2 * 4096 + 8, dtype=torch.bfloat16)
    w = torch.ones(4096, dtype=torch.bfloat16)
    x = buf[:2 * 4096].view(2, 4096)
    assert K.rms_norm_vector_ok(x, w, torch.empty_like(x))
    odd = buf[1:2 * 4096 + 1].view(2, 4096)
    assert not K.rms_norm_vector_ok(odd, w, torch.empty_like(x))
    assert not K.rms_norm_vector_ok(buf[:2 * 4100].view(2, 4100),
                                    torch.ones(4100, dtype=torch.bfloat16),
                                    torch.empty(2, 4100,
                                                dtype=torch.bfloat16))
    f = torch.zeros(3, 1026)
    assert not K.rms_norm_vector_ok(f, torch.ones(1026), f)
    assert K.rms_norm_vector_ok(torch.zeros(3, 1024), torch.ones(1024),
                                torch.zeros(3, 1024))
    buf.normal_(generator=torch.Generator().manual_seed(0))
    odd = buf[1:2 * 4096 + 1].view(2, 4096)
    assert torch.equal(K.rms_norm(odd, w), K.rms_norm(odd.clone(), w))


# ---------------------------------------------------------------------------
# paged attention: plain version vs paged_attention_reference
# ---------------------------------------------------------------------------

def _paged_case(seed, h=4, hkv=4, n=4, p=4, ps=8, d=16, num_pages=20,
                quant=False, distinct=False):
    """(q, k_pages, v_pages, table, lengths, k_scales, v_scales) from a
    seed; `distinct`: every slot on pages of its own (a window's pages
    belong to one slot)."""
    rng = np.random.default_rng(seed)
    q = _np((n, h, d), rng)
    table = rng.integers(1, num_pages, (n, p)).astype(np.int32)
    if distinct:
        table = (rng.permutation(num_pages - 1)[:n * p] + 1).reshape(
            n, p).astype(np.int32)
    lengths = rng.integers(1, p * ps + 1, (n,)).astype(np.int32)
    if quant:
        kp = rng.integers(-127, 128, (num_pages, ps, hkv, d)).astype(np.int8)
        vp = rng.integers(-127, 128, (num_pages, ps, hkv, d)).astype(np.int8)
        ks = (rng.random((num_pages, hkv)) / 127 + 1e-3).astype(np.float32)
        vs = (rng.random((num_pages, hkv)) / 127 + 1e-3).astype(np.float32)
        return q, kp, vp, table, lengths, ks, vs
    return (q, _np((num_pages, ps, hkv, d), rng),
            _np((num_pages, ps, hkv, d), rng), table, lengths, None, None)


def _jax_paged(q, kp, vp, table, lengths, ks, vs, window=None):
    """The JAX `paged_attention_reference`; with `window` (`_window`'s)
    over its float pages, which hold the window's rows."""
    j = lambda a: None if a is None else jnp.asarray(a)
    if window is not None:
        _, kp, vp = window
        ks = vs = None
    return np.asarray(pk.paged_attention_reference(
        j(q), j(kp), j(vp), j(table), j(lengths), k_scales=j(ks),
        v_scales=j(vs)))


def _paged_both(q, kp, vp, table, lengths, ks, vs, window=None):
    """(the port's plain version, the JAX `paged_attention_reference`);
    with `window` the port reads the window in place of its pages."""
    t = lambda a: None if a is None else torch.from_numpy(a)
    win = {} if window is None else window[0]
    got = K.paged_attention(t(q), t(kp), t(vp), t(table), t(lengths),
                            k_scales=t(ks), v_scales=t(vs), **win).numpy()
    return got, _jax_paged(q, kp, vp, table, lengths, ks, vs, window)


def _window(kp, vp, ks, vs, table, lengths, rng, w=2):
    """The decode round's float window over int8 pages: W pages per slot
    from the page of its last key row, filled with other values than the
    int8 pages they stand for. Returns (the port's window arguments, the
    JAX side's float pages: the int8 pages dequantized, the window's rows
    in place of the pages it stands for)."""
    from paddle_tpu import quantization as jquant
    n, p = table.shape
    ps, hkv, d = kp.shape[1:]
    first = np.minimum((lengths - 1) // ps, p - 1).astype(np.int32)
    kw, vw = (_np((n, w, ps, hkv, d), rng) for _ in range(2))
    jk, jv = (np.array(jquant.kv_dequantize_page(
        jnp.asarray(x), jnp.asarray(sc), jnp.float32))
        for x, sc in ((kp, ks), (vp, vs)))
    for i in range(n):
        for c in range(w):
            if first[i] + c < p:
                pid = table[i, first[i] + c]
                jk[pid], jv[pid] = kw[i, c], vw[i, c]
    t = torch.from_numpy
    return dict(k_win=t(kw), v_win=t(vw), win_first=t(first)), jk, jv


@pytest.mark.parametrize('case', ['f32', 'gqa', 'int8', 'int8_gqa',
                                  'null_page', 'zero_length', 'int8_d64',
                                  'int8_gqa_d64', 'int8_window_d64',
                                  'int8_window_gqa_d64'])
def test_paged_plain_matches_reference(case):
    """The plain version against the JAX `paged_attention_reference`:
    float and int8 pages at head_dim 16, GQA, a null-page slot, a slot of
    length 0; int8 pages at head_dim 64 (GPT-2's), with GQA and with the
    decode round's float window."""
    kw = {'gqa': dict(hkv=2), 'int8': dict(quant=True),
          'int8_gqa': dict(quant=True, hkv=1)}.get(case, {})
    if case.endswith('_d64'):
        kw = dict(quant=True, d=64, hkv=1 if 'gqa' in case else 4,
                  distinct='window' in case)
    q, kp, vp, table, lengths, ks, vs = _paged_case(
        seed=len(case), **kw)
    if case == 'null_page':
        # an inactive slot's table row is redirected to the null page
        table[1] = 0
    if case == 'zero_length':
        lengths[2] = 0
    window = None
    if 'window' in case:
        window = _window(kp, vp, ks, vs, table, lengths,
                         np.random.default_rng(len(case) + 1))
    got, want = _paged_both(q, kp, vp, table, lengths, ks, vs, window)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('case', ['f32', 'gqa', 'int8', 'gqa_int8',
                                  'page_16', 'int8_d64', 'gqa_int8_d64',
                                  'int8_window_d64', 'gqa_int8_window_d64'])
def test_paged_split_model_matches_reference(case):
    """The card kernel's split-and-combine arithmetic (per split m, l and
    P V, then the exp(m_s - M) rescale; `test_torch_smoke.
    paged_split_model`) against the JAX `paged_attention_reference`, over
    tables of 20 pages of 8 rows (splits of 8 pages; of 16 rows: splits
    of 4 pages): lengths at a split boundary and one on either side, a
    full table and length 1. At head_dim 64 over int8 pages, with GQA
    and with the round's window (the int8 splits skip its pages, one
    more split attends its rows)."""
    from test_torch_smoke import paged_split_model
    kw = {'gqa': dict(hkv=1), 'int8': dict(quant=True),
          'gqa_int8': dict(hkv=1, quant=True),
          'page_16': dict(ps=16)}.get(case, {})
    if case.endswith('_d64'):
        kw = dict(quant=True, d=64, hkv=1 if 'gqa' in case else 4,
                  distinct=True)
    q, kp, vp, table, lengths, ks, vs = _paged_case(
        seed=len(case) + 20, n=7, p=20,
        num_pages=141 if case.endswith('_d64') else 60, **kw)
    lengths[:] = [63, 64, 65, 128, 129, 160, 1]
    window, win = None, {}
    if 'window' in case:
        window = _window(kp, vp, ks, vs, table, lengths,
                         np.random.default_rng(len(case)))
        win = window[0]
    want = _jax_paged(q, kp, vp, table, lengths, ks, vs, window)
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = paged_split_model(t(q), t(kp), t(vp), t(table), t(lengths),
                            k_scales=t(ks), v_scales=t(vs), **win).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# the verify's query rows: T rows per slot, row t seeing lengths + t keys;
# (lengths, T): a span inside one page, one that crosses a page boundary
# (ps 8), one that reaches the table's last row, and T = 1
VERIFY_CASES = {'t5': 5, 't5_gqa': 5, 't3_int8': 3, 't5_int8_window': 5,
                't2_int8_gqa': 2, 't1': 1, 't3_int8_d64': 3,
                't5_int8_window_d64': 5, 't2_int8_gqa_window_d64': 2}


@pytest.mark.parametrize('case', sorted(VERIFY_CASES))
def test_paged_plain_with_query_rows_matches_reference_per_row(case):
    """The T-row plain version (q [N, T, H, D]) against the JAX
    `paged_attention_reference` applied to each row t alone with lengths
    + t, over pages that already hold the block's rows: float pages, int8
    pages, and int8 pages with the round's float window (the window's
    rows written into float copies of its pages for the JAX side); at
    head_dim 16 and, over int8 pages, at 64."""
    t_rows = VERIFY_CASES[case]
    quant = 'int8' in case
    hkv = 1 if 'gqa' in case else 4
    d = 64 if case.endswith('_d64') else 16
    n, p, ps = 4, 4, 8
    rng = np.random.default_rng(len(case) + t_rows)
    _, kp, vp, _, _, ks, vs = _paged_case(seed=len(case), hkv=hkv, n=n,
                                          p=p, ps=ps, d=d, num_pages=20,
                                          quant=quant)
    # every slot its own pages: a window's pages belong to one slot
    table = (rng.permutation(19)[:n * p] + 1).reshape(n, p).astype(np.int32)
    lengths = np.array([3, 6, p * ps - t_rows + 1, 1], np.int32)
    q = _np((n, t_rows, 4, d), rng)
    j = lambda a: None if a is None else jnp.asarray(a)
    tt = lambda a: None if a is None else torch.from_numpy(a)
    win = {}
    jk, jv, jks, jvs = kp, vp, ks, vs
    if 'window' in case:
        win, jk, jv = _window(kp, vp, ks, vs, table, lengths, rng)
        jks = jvs = None
    got = K.paged_attention(tt(q), tt(kp), tt(vp), tt(table), tt(lengths),
                            k_scales=tt(ks), v_scales=tt(vs), **win).numpy()
    assert got.shape == q.shape
    for r in range(t_rows):
        want = np.asarray(pk.paged_attention_reference(
            j(q[:, r]), j(jk), j(jv), j(table), j(lengths + r),
            k_scales=j(jks), v_scales=j(jvs)))
        np.testing.assert_allclose(got[:, r], want, rtol=1e-5, atol=1e-6)


def test_paged_one_query_row_is_the_decode_call_bit_for_bit():
    """q [N, 1, H, D] gives the 3-D call's output exactly."""
    q, kp, vp, table, lengths, _, _ = _paged_case(seed=4, hkv=2)
    t = torch.from_numpy
    flat = K.paged_attention(t(q), t(kp), t(vp), t(table), t(lengths))
    rows = K.paged_attention(t(q)[:, None], t(kp), t(vp), t(table),
                             t(lengths))
    assert torch.equal(rows[:, 0], flat)


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


# (head_dim, dtype, int8 pages, query rows per slot) -> the LAUNCHES key
# of one paged call: over int8 pages `_int8` at both widths, then any
# `_fp16`, then any `_d64`
_PAGED_KEYS = {
    (128, torch.bfloat16, False, 1): 'paged_attention',
    (128, torch.bfloat16, False, 5): 'paged_attention_verify',
    (128, torch.bfloat16, True, 1): 'paged_attention_int8',
    (128, torch.bfloat16, True, 5): 'paged_attention_verify_int8',
    (128, torch.float32, True, 1): 'paged_attention_int8',
    (128, torch.float16, False, 1): 'paged_attention_fp16',
    (128, torch.float16, False, 5): 'paged_attention_verify_fp16',
    (128, torch.float16, True, 1): 'paged_attention_int8_fp16',
    (128, torch.float16, True, 5): 'paged_attention_verify_int8_fp16',
    (64, torch.bfloat16, False, 1): 'paged_attention_d64',
    (64, torch.bfloat16, False, 5): 'paged_attention_verify_d64',
    (64, torch.bfloat16, True, 1): 'paged_attention_int8_d64',
    (64, torch.float32, True, 5): 'paged_attention_verify_int8_d64',
    (64, torch.float16, False, 1): 'paged_attention_fp16_d64',
    (64, torch.float16, True, 1): 'paged_attention_int8_fp16_d64',
    (64, torch.float16, True, 5): 'paged_attention_verify_int8_fp16_d64',
}


@pytest.mark.parametrize('case', list(_PAGED_KEYS),
                         ids=lambda c: '-'.join(map(str, c)))
def test_paged_launch_key_names_int8_at_both_widths(case):
    """The key a paged call counts under (`kernels.paged_key`, the
    wrapper's): a run can tell an int8 call from a float one at D = 128
    as at D = 64, and every key is one `LAUNCHES` holds."""
    d, dtype, int8, t = case
    key = K.paged_key(4 if t > 1 else 3, int8, dtype, d)
    assert key == _PAGED_KEYS[case]
    assert key in K.LAUNCHES


@pytest.mark.parametrize('call', ['flash', 'rms', 'paged', 'sumsq', 'adam'])
def test_wrappers_raise_off_cpu_and_cuda(call):
    """A tensor that is neither on the CPU nor on a CUDA device has no
    kernel and no fallback: the wrapper raises."""
    x = torch.zeros((1, 8, 2, 128), device='meta')
    with pytest.raises(ValueError):
        if call == 'flash':
            K.flash_attention_fwd(x, x, x, causal=True)
        elif call == 'rms':
            K.rms_norm(x, torch.ones(128, device='meta'))
        elif call == 'sumsq':
            K.multi_tensor_sumsq([x])
        elif call == 'adam':
            K.multi_tensor_adam([x], [x], [x], [x], lr_t=1e-3, beta1=0.9,
                                beta2=0.999, epsilon=1e-8, decay=[0.0],
                                decay_mode='l2')
        else:
            K.paged_attention(x[:, 0], x, x,
                              torch.zeros((1, 1), dtype=torch.int32,
                                          device='meta'),
                              torch.ones(1, dtype=torch.int32,
                                         device='meta'))


def test_mixed_devices_raise():
    with pytest.raises(ValueError):
        K.rms_norm(torch.zeros(2, 4), torch.ones(4, device='meta'))


# ---------------------------------------------------------------------------
# flash attention backward: plain version vs the Pallas kernels (interpret
# mode) and jax.grad
# ---------------------------------------------------------------------------

def _flash_case(seed, b=1, sq=256, sk=256, h=4, hkv=2, d=128):
    rng = np.random.default_rng(seed)
    return (_np((b, sq, h, d), rng), _np((b, sk, hkv, d), rng),
            _np((b, sk, hkv, d), rng), _np((b, sq, h, d), rng))


@pytest.mark.parametrize('causal', [False, True])
def test_flash_bwd_plain_matches_pallas_interpret(causal):
    """[1, 256, 4 heads, 2 kv heads, 128], f32: the port's forward LSE and
    backward (plain versions on the CPU) against the Pallas forward with
    return_lse and the Pallas dq and dk/dv kernels in interpret mode, and
    against jax.grad of `flash_attention_own`. Tolerance: rtol 2e-4,
    atol 2e-5 (fp32 sums in another order)."""
    q, k, v, g = _flash_case(seed=int(causal))
    hkv, rep = k.shape[2], q.shape[2] // k.shape[2]
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = K.flash_attention_fwd(tq, tk, tv, causal=causal,
                                     return_lse=True)
    dq, dk, dv = K.flash_attention_bwd(tq, tk, tv, out, lse, tg,
                                       causal=causal)

    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    jout, jlse = pk.flash_attention_fwd(jq, jk, jv, causal=causal,
                                        interpret=True, return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               rtol=RTOL, atol=ATOL)
    tr = lambda x: x.transpose(0, 2, 1, 3)
    jdq, jdk, jdv = pk.flash_attention_bwd(
        tr(jq), tr(jnp.repeat(jk, rep, axis=2)),
        tr(jnp.repeat(jv, rep, axis=2)), tr(jout), jlse, tr(jg),
        causal=causal, interpret=True)
    fold = lambda x: np.asarray(tr(x)).reshape(1, 256, hkv, rep, 128).sum(3)
    np.testing.assert_allclose(dq.numpy(), np.asarray(tr(jdq)), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(dk.numpy(), fold(jdk), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dv.numpy(), fold(jdv), rtol=RTOL, atol=ATOL)

    _, vjp = jax.vjp(lambda a, b_, c: pk.flash_attention_own(
        a, b_, c, causal, 128, 128, True), jq, jk, jv)
    for got, want in zip((dq, dk, dv), vjp(jg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize('sq,sk,h,hkv,causal', [
    (33, 33, 4, 2, True),      # GQA, ragged
    (5, 12, 4, 1, True),       # sq < sk: bottom-right causal alignment
    (20, 20, 2, 2, False),
])
def test_flash_attention_function_grads_match_attention_xla(sq, sk, h, hkv,
                                                            causal):
    """`FlashAttention.apply` (forward with LSE, FA-2 backward) against
    jax.grad of `_attention_xla`, f32, head dim 16."""
    rng = np.random.default_rng(sq + sk)
    q, k, v = _np((2, sq, h, 16), rng), _np((2, sk, hkv, 16), rng), \
        _np((2, sk, hkv, 16), rng)
    g = _np((2, sq, h, 16), rng)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = K.FlashAttention.apply(tq, tk, tv, causal)
    out.backward(torch.from_numpy(g))
    want_out, vjp = jax.vjp(
        lambda a, b_, c: _attention_xla(a, b_, c, causal=causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=RTOL, atol=ATOL)
    for got, want in zip((tq, tk, tv), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


def test_sdpa_takes_the_function_only_when_a_grad_is_needed():
    # head_dim 64: below it sdpa takes the plain version (the JAX rule)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_np((1, 6, 2, 64), rng))
    assert TF.scaled_dot_product_attention(x, x, x, is_causal=True) \
        .grad_fn is None
    xg = x.clone().requires_grad_()
    out = TF.scaled_dot_product_attention(xg, x, x, is_causal=True)
    assert type(out.grad_fn).__name__ == 'FlashAttentionBackward'
    with torch.no_grad():
        assert TF.scaled_dot_product_attention(xg, x, x).grad_fn is None


# ---------------------------------------------------------------------------
# fused cross-entropy: plain versions vs the Pallas kernels and _ce_xla
# ---------------------------------------------------------------------------

def _ce_case(seed, n, v):
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal((n, v))).astype(np.float32)
    lab = rng.integers(0, v, (n,)).astype(np.int32)
    g = rng.standard_normal(n).astype(np.float32)
    return x, lab, g


@pytest.mark.parametrize('n,v', [(37, 300), (5, 2500)])
def test_ce_plain_matches_pallas_interpret_and_ce_xla(n, v):
    """Ragged N and V (neither a block multiple), f32: nll, lse and
    dlogits of the plain versions against the Pallas kernels in
    interpret mode and against `_ce_xla`. Tolerance rtol 2e-4, atol
    2e-5."""
    x, lab, g = _ce_case(n + v, n, v)
    tx, tl, tg = torch.from_numpy(x), torch.from_numpy(lab), \
        torch.from_numpy(g)
    nll, lse = K.softmax_cross_entropy_fwd(tx, tl)
    dx = K.softmax_cross_entropy_bwd(tx, tl, lse, tg)

    jx, jl, jg = jnp.asarray(x), jnp.asarray(lab), jnp.asarray(g)
    jnll, jlse = pk.softmax_cross_entropy_fwd(jx, jl, interpret=True)
    np.testing.assert_allclose(nll.numpy(), np.asarray(jnll), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=RTOL,
                               atol=ATOL)
    _, vjp = jax.vjp(lambda a: pk.softmax_cross_entropy(a, jl, True), jx)
    np.testing.assert_allclose(dx.numpy(), np.asarray(vjp(jg)[0]),
                               rtol=RTOL, atol=ATOL)
    valid = jnp.ones((n,), bool)
    xla_nll, vjp = jax.vjp(lambda a: JF._ce_xla(a, jl, valid), jx)
    np.testing.assert_allclose(nll.numpy(), np.asarray(xla_nll), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(vjp(jg)[0]),
                               rtol=RTOL, atol=ATOL)

    tx.requires_grad_()
    K.SoftmaxCrossEntropy.apply(tx, tl).backward(tg)
    np.testing.assert_allclose(tx.grad.numpy(), dx.numpy(), rtol=0, atol=0)


def test_ce_label_outside_vocab_has_no_target():
    """As in the Pallas kernel, a label outside [0, V) picks no logit."""
    x, lab, _ = _ce_case(7, 4, 50)
    lab[1], lab[2] = -100, 50
    nll, lse = K.softmax_cross_entropy_fwd(torch.from_numpy(x),
                                           torch.from_numpy(lab))
    jnll, _ = pk.softmax_cross_entropy_fwd(jnp.asarray(x), jnp.asarray(lab),
                                           interpret=True)
    np.testing.assert_allclose(nll.numpy(), np.asarray(jnll), rtol=RTOL,
                               atol=ATOL)
    assert nll[1] == lse[1] and nll[2] == lse[2]


def _jax_ce(x, lab, dtype, **kw):
    """(loss, dlogits) of the JAX package's F.cross_entropy, through its
    eager tape."""
    xt = Tensor(jnp.asarray(x, dtype))
    xt.stop_gradient = False
    loss = JF.cross_entropy(xt, Tensor(jnp.asarray(lab)), **kw)
    loss.backward()
    return (np.asarray(loss.value, np.float32),
            np.asarray(xt.grad.value, np.float32))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('reduction,label_shape', [
    ('mean', 'flat'), ('sum', 'flat'), ('mean', 'column')])
def test_cross_entropy_matches_jax(dtype, reduction, label_shape):
    """F.cross_entropy on [N, V] hard labels with ignore_index rows, value
    and gradient, against the JAX package's. f32: rtol 2e-4, atol 2e-5;
    bf16: the gradient carries one bf16 rounding (2^-8 relative), so
    rtol 1e-2, atol 1e-3 (|dlogit| <= 1)."""
    x, lab, _ = _ce_case(11, 24, 96)
    lab[[2, 9, 10]] = -100
    if label_shape == 'column':
        lab = lab[:, None]
    jdt = jnp.float32 if dtype == 'float32' else jnp.bfloat16
    want_loss, want_dx = _jax_ce(x, lab, jdt, reduction=reduction)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    loss = TF.cross_entropy(tx, torch.from_numpy(lab), reduction=reduction)
    loss.backward()
    tol = (RTOL, ATOL) if dtype == 'float32' else (1e-2, 1e-3)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=tol[0],
                               atol=tol[1])
    assert tx.grad.dtype == tx.dtype
    np.testing.assert_allclose(tx.grad.float().numpy(), want_dx,
                               rtol=tol[0], atol=tol[1])
    assert not tx.grad.float()[[2, 9, 10]].any()


@pytest.mark.parametrize('kw', [
    dict(label_smoothing=0.1), dict(reduction='none'),
    dict(weight=np.linspace(0.5, 1.5, 96).astype(np.float32)),
    dict(soft_label=True)])
def test_cross_entropy_plain_branches_match_jax(kw):
    """Class weights, label smoothing, soft labels and reduction='none'
    (plain torch, outside the kernels, as in the JAX package)."""
    x, lab, _ = _ce_case(12, 16, 96)
    lab[3] = -100
    if kw.get('soft_label'):
        lab = np.random.default_rng(0).dirichlet(np.ones(96), 16).astype(
            np.float32)
    jkw = dict(kw)
    if 'weight' in kw:
        jkw['weight'] = Tensor(jnp.asarray(kw['weight']))
    want_loss, want_dx = _jax_ce(x, lab, jnp.float32, **jkw) \
        if kw.get('reduction') != 'none' else (None, None)
    tkw = dict(kw)
    if 'weight' in kw:
        tkw['weight'] = torch.from_numpy(kw['weight'])
    tx = torch.from_numpy(x).requires_grad_()
    loss = TF.cross_entropy(tx, torch.from_numpy(lab), **tkw)
    if kw.get('reduction') == 'none':
        want = JF.cross_entropy(Tensor(jnp.asarray(x)),
                                Tensor(jnp.asarray(lab)),
                                reduction='none').numpy()
        np.testing.assert_allclose(loss.detach().numpy(), want, rtol=RTOL,
                                   atol=ATOL)
        return
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tx.grad.numpy(), want_dx, rtol=RTOL,
                               atol=ATOL)


def test_cross_entropy_loss_layer():
    x, lab, _ = _ce_case(13, 8, 40)
    layer = CrossEntropyLoss(ignore_index=lab[0])
    got = layer(torch.from_numpy(x), torch.from_numpy(lab))
    want = TF.cross_entropy(torch.from_numpy(x), torch.from_numpy(lab),
                            ignore_index=int(lab[0]))
    assert float(got) == float(want)


# ---------------------------------------------------------------------------
# RMSNorm gradient vs jax.grad of the JAX model's F.rms_norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_rms_norm_grad_matches_jax(dtype):
    """dx and dweight of the port's RMSNorm against jax.grad of the JAX
    `F.rms_norm` (normalise in fp32, cast, multiply by the weight), on the
    same inputs. f32: rtol 2e-4, atol 2e-5. bf16 inputs: held to the JAX
    gradient taken in f32 of the same bf16 values; dx carries two bf16
    roundings (atol 3e-2 at |dx| <= 4), dweight a bf16 rounding of a sum
    of 48 terms (atol 0.1 at |dw| <= 15). (JAX's own bf16 gradient sums
    dweight in bf16 and lands 0.18 off that reference on these inputs;
    the port sums in fp32 and lands 0.055 off.)"""
    rng = np.random.default_rng(21)
    x, w, g = _np((3, 16, 64), rng), 1 + 0.1 * _np((64,), rng), \
        _np((3, 16, 64), rng)
    tdt = getattr(torch, dtype)
    tx, tw, tg = (torch.from_numpy(a).to(tdt) for a in (x, w, g))
    jx, jw, jg = (jnp.asarray(t.float().numpy()) for t in (tx, tw, tg))

    def f(a, b_):
        return JF.rms_norm(Tensor(a), Tensor(b_), epsilon=1e-6).value

    _, vjp = jax.vjp(f, jx, jw)
    want_dx, want_dw = (np.asarray(t) for t in vjp(jg))
    tx.requires_grad_()
    tw.requires_grad_()
    K.rms_norm(tx, tw, 1e-6).backward(tg)
    assert tx.grad.dtype == tdt and tw.grad.dtype == tdt
    tol_dx, tol_dw = ((RTOL, ATOL), (RTOL, ATOL)) if dtype == 'float32' \
        else ((0, 3e-2), (0, 0.1))
    np.testing.assert_allclose(tx.grad.float().numpy(), want_dx,
                               rtol=tol_dx[0], atol=tol_dx[1])
    np.testing.assert_allclose(tw.grad.float().numpy(), want_dw,
                               rtol=tol_dw[0], atol=tol_dw[1])


# ---------------------------------------------------------------------------
# multi-tensor Adam and sum of squares: launch plan, checks, plain version
# ---------------------------------------------------------------------------

def test_mt_batches_plan_launches_from_shapes():
    """300 tensors (some empty, one of several chunks) make launches of at
    most 48 tensors; each launch's first-chunk table is the prefix sum of
    its tensors' chunk counts, and every non-empty tensor is in one."""
    rng = np.random.default_rng(0)
    numels = [int(n) for n in rng.integers(0, 3 * K.MT_CHUNK, 300)]
    numels[5] = 0
    numels[7] = 1
    numels[9] = 10 * K.MT_CHUNK + 3
    launches = K.mt_batches(numels, K.MT_ADAM_MAX_TENSORS)
    seen = []
    for idx, first in launches:
        assert 1 <= len(idx) <= K.MT_ADAM_MAX_TENSORS
        assert len(first) == len(idx) + 1 and first[0] == 0
        for j, i in enumerate(idx):
            assert first[j + 1] - first[j] == -(-numels[i] // K.MT_CHUNK)
        seen += idx
    assert seen == [i for i, n in enumerate(numels) if n]
    assert len(launches) == -(-len(seen) // K.MT_ADAM_MAX_TENSORS)
    assert K.mt_batches([0, 0], 48) == [] and K.mt_batches([], 48) == []


def test_mt_check_refuses_what_the_kernels_cannot_take():
    buf = torch.zeros(64, dtype=torch.bfloat16)
    K._mt_check([buf, buf[8:]], 'k')              # 16 bytes in: aligned
    for bad in (buf[1:], buf.view(8, 8).t(), torch.zeros(4, dtype=torch.float64)):
        with pytest.raises(ValueError):
            K._mt_check([bad], 'k')


def _jax_adam_leaf(p, g, slots, lr, step, *, coeff=0.0, mode='l2',
                   decoupled=False, amsgrad=False, moment_dtype='float32',
                   scale=None):
    """One JAX `_leaf_apply` of Adam/AdamW, after the JAX clip's rounding
    of g * scale to g's dtype."""
    from paddle_tpu.optimizer import Adam as JAdam, AdamW as JAdamW
    from paddle_tpu.optimizer import L1Decay
    wd = L1Decay(coeff) if mode == 'l1' else coeff
    opt = (JAdamW if decoupled else JAdam)(
        learning_rate=lr, weight_decay=wd, amsgrad=amsgrad,
        moment_dtype=moment_dtype)
    if scale is not None:
        g = (g.astype(jnp.float32) * scale).astype(g.dtype)
    return opt._leaf_apply(g, p, slots, jnp.float32(lr),
                           jnp.asarray(step, jnp.int32))


@pytest.mark.parametrize('mode', ['l2', 'l1', 'decoupled'])
@pytest.mark.parametrize('amsgrad', [False, True])
@pytest.mark.parametrize('scale', [None, 0.3])
def test_multi_tensor_adam_plain_matches_jax_leaf(mode, amsgrad, scale):
    """The plain version over a mixed list (fp32 params with fp32
    moments; bf16 params with fp32 masters and bf16 moments) against the
    JAX package's per-leaf Adam step, two steps, with a clip scale and
    per-tensor decay coefficients (0 on one tensor)."""
    rng = np.random.default_rng(3)
    lr, coeffs = 1e-2, [0.1, 0.0, 0.05]
    specs = [((7, 5), torch.float32, torch.float32, False),
             ((13,), torch.bfloat16, torch.bfloat16, True),
             ((3, 3), torch.float32, torch.float32, False)]
    tp, jstate = [], []
    for shape, pdt, mdt, master in specs:
        v = rng.standard_normal(shape).astype(np.float32)
        t = torch.tensor(v, dtype=pdt)     # a copy: updated in place below
        slots = {'moment1': torch.zeros(shape, dtype=mdt),
                 'moment2': torch.zeros(shape, dtype=mdt)}
        if amsgrad:
            slots['moment2_max'] = torch.zeros(shape, dtype=mdt)
        if master:
            slots['master'] = t.float()
        tp.append((t, slots))
        jdt = jnp.float32 if pdt == torch.float32 else jnp.bfloat16
        js = {k: jnp.zeros(shape, jnp.float32 if mdt == torch.float32
                           else jnp.bfloat16) for k in slots if k != 'master'}
        if master:
            js['master'] = jnp.asarray(np.array(t.float().numpy()))
        jstate.append([jnp.asarray(v, jdt), js, mdt])
    for step in (1, 2):
        grads = [rng.standard_normal(t.shape).astype(np.float32)
                 for t, _ in tp]
        one = np.float32(1)
        lr_t = np.float32(lr) * np.sqrt(one - np.power(np.float32(0.999),
                                                       np.float32(step))) \
            / (one - np.power(np.float32(0.9), np.float32(step)))
        decay = [float(np.float32(lr) * np.float32(c)) if mode == 'decoupled'
                 else c for c in coeffs]
        K.multi_tensor_adam(
            [t for t, _ in tp],
            [torch.from_numpy(g).to(t.dtype) for g, (t, _) in zip(grads, tp)],
            [s['moment1'] for _, s in tp], [s['moment2'] for _, s in tp],
            [s.get('master') for _, s in tp],
            [s['moment2_max'] for _, s in tp] if amsgrad else None,
            lr_t=float(lr_t), beta1=0.9, beta2=0.999, epsilon=1e-8,
            decay=decay, decay_mode=mode,
            clip_scale=None if scale is None else torch.tensor(scale))
        for j, (g, c) in enumerate(zip(grads, coeffs)):
            p, js, mdt = jstate[j]
            new_p, new_s = _jax_adam_leaf(
                p, jnp.asarray(g, p.dtype), js, lr, step, coeff=c,
                mode='l2' if mode == 'decoupled' else mode,
                decoupled=mode == 'decoupled', amsgrad=amsgrad,
                moment_dtype='bfloat16' if mdt == torch.bfloat16
                else 'float32',
                scale=None if scale is None else jnp.float32(scale))
            jstate[j][:2] = [new_p, new_s]
    for (t, slots), (p, js, _) in zip(tp, jstate):
        low = t.dtype == torch.bfloat16
        tol = dict(rtol=2 ** -7, atol=1e-6) if low else dict(rtol=1e-6,
                                                             atol=1e-7)
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(p, np.float32), **tol)
        for k, v in slots.items():
            np.testing.assert_allclose(
                v.float().numpy(), np.asarray(js[k], np.float32), err_msg=k,
                **(tol if v.dtype == torch.bfloat16 else dict(rtol=1e-6,
                                                                atol=1e-7)))


def test_multi_tensor_cpu_takes_the_plain_version_and_counts_nothing():
    K.reset_launch_counts()
    p, g = torch.ones(4), torch.full((4,), 0.5)
    m, v = torch.zeros(4), torch.zeros(4)
    assert float(K.multi_tensor_sumsq([g, g])) == 2.0
    K.multi_tensor_adam([p], [g], [m], [v], lr_t=0.1, beta1=0.9,
                        beta2=0.999, epsilon=1e-8, decay=[0.0],
                        decay_mode='l2')
    K.multi_tensor_adam([], [], [], [], lr_t=0.1, beta1=0.9, beta2=0.999,
                        epsilon=1e-8, decay=[], decay_mode='l2')
    assert (p < 1).all() and (m > 0).all()
    assert K.LAUNCHES == {name: 0 for name in K.LAUNCHES}
    with pytest.raises(ValueError):
        K.multi_tensor_adam([p], [g], [m], [v], lr_t=0.1, beta1=0.9,
                            beta2=0.999, epsilon=1e-8, decay=[0.0],
                            decay_mode='l3')
