"""The kernel check of `chip_smoke.py` can fail a wrong kernel.

`chip_smoke.compare` holds each kernel's output to its plain version by
two relative readings (`rel_max`, `rel_norm`) under limits set per
dtype. Here, on the CPU, the plain versions stand in for the card's
kernels: the same function computed in fp64 and rounded once to the
output dtype (what a correct kernel that sums in another order gives)
must pass, and the same function with a term left out, or off by 2%,
must fail. Inputs come from numpy with a seed, at a small training-like
shape (B=1, S=256, 4 query heads over 2 kv heads, D=128; CE at
[64, 1000] with ignored rows and an O(1) upstream gradient; the adapter
delta at B=8, T=2, H=256, rank 8, O=192 over a bank of 5 slots). The
bf16 tensor-core kernels round in their own order (P to bf16 before
P V over 64-key tiles of an online softmax; P^T and dS^T to bf16 before
the dV and dK products): that order must pass the bf16 limits, and the
redesign's likely faults must not. The timing phase's guard against a
profiler reading that contradicts the CUDA events is checked on given
readings.
"""
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import kernels as K

_spec = importlib.util.spec_from_file_location(
    'chip_smoke', pathlib.Path(__file__).resolve().parent.parent
    / 'chip_smoke.py')
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

B, S, H, HKV, D = 1, 256, 4, 2, 128
N, V = 64, 1000


def _randn(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(dtype)


def _attention(dtype):
    rng = np.random.RandomState(0)
    q = _randn(rng, (B, S, H, D), dtype)
    k = _randn(rng, (B, S, HKV, D), dtype)
    v = _randn(rng, (B, S, HKV, D), dtype)
    dout = _randn(rng, (B, S, H, D), dtype)
    out, lse = K.attention_reference(q, k, v, causal=True, return_lse=True)
    dq, delta = K.attention_bwd_dq_reference(q, k, v, out, lse, dout, True)
    dk, dv = K.attention_bwd_dkv_reference(q, k, v, lse, delta, dout, True)
    return dict(q=q, k=k, v=v, dout=dout, out=out, lse=lse, delta=delta,
                dq=dq, dk=dk, dv=dv)


def _attention_fp64(a, delta_term=True):
    """Forward and FlashAttention-2 backward in fp64 with the plain
    versions' bottom-right causal mask, each output rounded once. The
    backward takes the forward's residuals (out, lse) as given, as the
    kernels do."""
    dtype = a['q'].dtype
    q, k, v, do = (a[n].double() for n in ('q', 'k', 'v', 'dout'))
    k = k.repeat_interleave(H // HKV, dim=2)
    v = v.repeat_interleave(H // HKV, dim=2)
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    s = torch.einsum('bqhd,bkhd->bhqk', q, k) / math.sqrt(D)
    s = s.masked_fill(~keep, -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum('bhqk,bkhd->bqhd', torch.exp(s - lse[..., None]), v)
    p = torch.exp(s - a['lse'].double()[..., None])
    delta = (do * a['out'].double()).sum(-1).transpose(1, 2)
    if not delta_term:
        delta = torch.zeros_like(delta)
    dp = torch.einsum('bqhd,bkhd->bhqk', do, v)
    ds = p * (dp - delta[..., None]) / math.sqrt(D)
    dq = torch.einsum('bhqk,bkhd->bqhd', ds, k)
    dk = K._fold_group(torch.einsum('bhqk,bqhd->bkhd', ds, q), HKV)
    dv = K._fold_group(torch.einsum('bhqk,bqhd->bkhd', p, do), HKV)
    return dict(out=out.to(dtype), lse=lse.float(), dq=dq.to(dtype),
                dk=dk.to(dtype), dv=dv.to(dtype))


def _cross_entropy(dtype):
    rng = np.random.RandomState(1)
    x = (3 * _randn(rng, (N, V), torch.float32)).to(dtype)
    lab = torch.from_numpy(rng.randint(0, V, (N,)).astype(np.int32))
    lab[::7] = 0
    g = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    g[::7] = 0.0
    nll, lse = K.softmax_cross_entropy_fwd_reference(x, lab)
    dx = K.softmax_cross_entropy_bwd_reference(x, lab, lse, g)
    xf = x.double()
    lse64 = torch.logsumexp(xf, dim=-1)
    onehot = torch.zeros_like(xf)
    onehot[torch.arange(N), lab.long()] = 1.0
    soft = torch.exp(xf - lse64[:, None])
    gd = g.double()[:, None]
    return dict(
        nll=nll, lse=lse, dx=dx,
        nll64=(lse64 - xf[torch.arange(N), lab.long()]).float(),
        lse64=lse64.float(),
        dx64=((soft - onehot) * gd).to(dtype),
        dx_onehot_only=(-onehot * gd).to(dtype))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_compare_accepts_a_correct_kernel(dtype):
    """One rounding of the exact result passes every output's limits."""
    a = _attention(dtype)
    e = _attention_fp64(a)
    for name in ('dq', 'dk', 'dv'):
        smoke.compare(name, e[name], a[name])
    smoke.compare('forward', (e['out'], e['lse']), (a['out'], a['lse']))
    c = _cross_entropy(dtype)
    smoke.compare('ce fwd', (c['nll64'], c['lse64']), (c['nll'], c['lse']))
    smoke.compare('ce bwd', c['dx64'], c['dx'])


def _repeat_kv(a):
    return (a[n].float().repeat_interleave(H // HKV, dim=2)
            for n in ('k', 'v'))


def _forward_tensor_core(a, rescale=True, tile=64):
    """The bf16 tensor-core forward's arithmetic: fp32 logits, an online
    softmax over `tile`-key blocks (the running max rescales the sums
    and the output by alpha unless `rescale` is False), P rounded to
    bf16 before P V, fp32 sums, O / l rounded once; the LSE m + log l."""
    k, v = _repeat_kv(a)
    s = torch.einsum('bqhd,bkhd->bhqk', a['q'].float(), k) / math.sqrt(D)
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -math.inf)
    m = torch.full((B, H, S), -math.inf)
    l = torch.zeros(B, H, S)
    o = torch.zeros(B, H, S, D)
    for k0 in range(0, S, tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(dim=-1))
        alpha = torch.exp(m - m_new) if rescale else torch.ones_like(m)
        p = torch.exp(st - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            'bhqk,bkhd->bhqd', p.bfloat16().float(), v[:, k0:k0 + tile])
        m = m_new
    out = (o / l[..., None]).transpose(1, 2).to(a['q'].dtype)
    return out, m + torch.log(l)


def _dkv_tensor_core(a, first_head_only=False):
    """The bf16 tensor-core dk/dv kernel's arithmetic: P^T and dS^T in
    fp32, rounded to bf16 before the dV and dK products, fp32 sums over
    every query head of each GQA group (or, as a fault, only the first
    head of each group), each gradient rounded once."""
    k, v = _repeat_kv(a)
    q, do = a['q'].float(), a['dout'].float()
    s = torch.einsum('bqhd,bkhd->bhqk', q, k) / math.sqrt(D)
    p = torch.exp(s - a['lse'][..., None]).tril()
    dp = torch.einsum('bqhd,bkhd->bhqk', do, v)
    ds = p * (dp - a['delta'][..., None]) / math.sqrt(D)
    if first_head_only:
        first = (torch.arange(H) % (H // HKV) == 0).float()[None, :, None, None]
        p, ds = p * first, ds * first
    dk = torch.einsum('bhqk,bqhd->bkhd', ds.bfloat16().float(), q)
    dv = torch.einsum('bhqk,bqhd->bkhd', p.bfloat16().float(), do)
    return (K._fold_group(dk, HKV).to(a['k'].dtype),
            K._fold_group(dv, HKV).to(a['v'].dtype))


@pytest.mark.parametrize('kernel', ['forward', 'dkv'])
def test_compare_accepts_the_tensor_core_rounding_order(kernel):
    """The bf16 wgmma kernels' order of rounding passes the bf16 limits
    against the plain versions."""
    a = _attention(torch.bfloat16)
    if kernel == 'forward':
        smoke.compare(kernel, _forward_tensor_core(a), (a['out'], a['lse']))
    else:
        smoke.compare(kernel, _dkv_tensor_core(a), (a['dk'], a['dv']))


def _mutant(case, dtype):
    """(kernel output with a fault, plain output)."""
    if case.startswith('ce'):
        c = _cross_entropy(dtype)
        got = {'ce_bwd_zeros': torch.zeros_like(c['dx']),
               'ce_bwd_onehot_only': c['dx_onehot_only']}[case]
        return got, c['dx']
    a = _attention(dtype)
    if case == 'dq_gain_2pct':
        return (a['dq'].double() * 1.02).to(dtype), a['dq']
    if case == 'forward_probs_rounded_to_bf16':
        # f32 inputs: a forward that rounds P to bf16 before P V
        kr = a['k'].float().repeat_interleave(H // HKV, dim=2)
        vr = a['v'].float().repeat_interleave(H // HKV, dim=2)
        s = torch.einsum('bqhd,bkhd->bhqk', a['q'].float(), kr) / math.sqrt(D)
        p = torch.exp(s - a['lse'][..., None]).tril()
        out = torch.einsum('bhqk,bkhd->bqhd',
                           p.to(torch.bfloat16).float(), vr)
        return out.to(dtype), a['out']
    if case == 'forward_without_rescale':
        return _forward_tensor_core(a, rescale=False), (a['out'], a['lse'])
    if case == 'dkv_first_head_of_each_group_only':
        return _dkv_tensor_core(a, first_head_only=True), (a['dk'], a['dv'])
    e = _attention_fp64(a, delta_term=False)
    name = {'dq_without_delta': 'dq', 'dk_without_delta': 'dk'}[case]
    return e[name], a[name]


@pytest.mark.parametrize('case,dtype', [
    ('dq_without_delta', torch.bfloat16),
    ('dk_without_delta', torch.bfloat16),
    ('dq_gain_2pct', torch.bfloat16),
    ('ce_bwd_zeros', torch.bfloat16),
    ('ce_bwd_onehot_only', torch.bfloat16),
    ('dq_without_delta', torch.float32),
    ('ce_bwd_onehot_only', torch.float32),
    ('forward_probs_rounded_to_bf16', torch.float32),
    ('forward_without_rescale', torch.bfloat16),
    ('dkv_first_head_of_each_group_only', torch.bfloat16),
])
def test_compare_rejects_a_wrong_kernel(case, dtype):
    got, want = _mutant(case, dtype)
    with pytest.raises(AssertionError, match='rel_max'):
        smoke.compare(case, got, want)


def _adapter(dtype):
    """(x, a_bank, b_bank, rows, scale) with an f32 bank whose slot 0 is
    zero, rows mixing slot 0 with repeated slots, and x in `dtype`."""
    rng = np.random.RandomState(2)
    x = _randn(rng, (8, 2, 256), dtype)
    a = 0.05 * _randn(rng, (5, 256, 8), torch.float32)
    b = 0.05 * _randn(rng, (5, 8, 192), torch.float32)
    a[0], b[0] = 0.0, 0.0
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 5).astype(np.float32))
    scale[0] = 0.0
    rows = torch.tensor([0, 1, 2, 1, 0, 3, 3, 4], dtype=torch.int32)
    return x, a, b, rows, scale


def _adapter_fp64(x, a, b, rows, scale):
    idx = rows.long()
    out = torch.einsum('bth,bhr,bro->bto', x.double(), a[idx].double(),
                       b[idx].double())
    return (out * scale.double()[idx][:, None, None]).to(x.dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_compare_accepts_a_correct_adapter_kernel(dtype):
    args = _adapter(dtype)
    smoke.compare('adapter', _adapter_fp64(*args),
                  K.adapter_matmul_reference(*args))


@pytest.mark.parametrize('case,dtype', [
    ('neighbour_slot', torch.bfloat16),
    ('scale_dropped', torch.bfloat16),
    ('gain_2pct', torch.bfloat16),
    ('neighbour_slot', torch.float32),
    ('bank_rounded_to_bf16', torch.float32),
])
def test_compare_rejects_a_wrong_adapter_kernel(case, dtype):
    """A kernel that reads the next slot's factors, leaves out the scale,
    is off by 2%, or rounds an f32 bank to bf16 fails the limits."""
    x, a, b, rows, scale = _adapter(dtype)
    want = K.adapter_matmul_reference(x, a, b, rows, scale)
    if case == 'neighbour_slot':
        got = _adapter_fp64(x, a, b, torch.where(rows > 0, rows % 4 + 1, 0),
                            scale)
    elif case == 'scale_dropped':
        got = _adapter_fp64(x, a, b, rows, (scale > 0).float())
    elif case == 'gain_2pct':
        got = (_adapter_fp64(x, a, b, rows, scale).double() * 1.02).to(dtype)
    else:
        got = _adapter_fp64(x, a.bfloat16().float(), b.bfloat16().float(),
                            rows, scale)
    with pytest.raises(AssertionError, match='rel_max'):
        smoke.compare(case, got, want)


def test_compare_rejects_a_dtype_or_shape_change():
    x = torch.ones(4, 8, dtype=torch.bfloat16)
    with pytest.raises(AssertionError, match='kernel gives'):
        smoke.compare('dtype', x.float(), x)
    with pytest.raises(AssertionError, match='kernel gives'):
        smoke.compare('shape', x[:2], x)


@pytest.mark.parametrize('dev,per_call,ev,wrong', [
    (0.232, 1, 0.470, True),    # one long kernel read at half its time
    (0.850, 1, 0.574, True),    # above the events, which bound it
    (0.850, 3, 0.574, True),
    (0.450, 1, 0.470, False),   # within PROFILER_MIN_SHARE of the events
    (0.500, 1, 0.470, False),
    (0.004, 1, 0.012, False),   # a short kernel: events read the launch rate
    (0.300, 8, 0.600, False),   # 0.075 ms per launch: gaps may explain it
    (None, 0, 0.470, False),    # no profiler reading to doubt
])
def test_profiler_disagrees(dev, per_call, ev, wrong):
    assert smoke.profiler_disagrees(dev, per_call, ev) is wrong


@pytest.mark.parametrize('readings,want', [
    ([(0.470, (0.232, 1)), (0.468, (0.233, 1))], 0.468),   # lost twice
    ([(0.470, (0.232, 1)), (0.471, (0.466, 1))], 0.466),   # lost once
    ([(0.574, (0.850, 1)), (0.571, (0.849, 1))], 0.571),   # above, twice
    ([(0.470, (0.466, 1))], 0.466),
    ([(0.012, (None, 0))], 0.012),
])
def test_timed_takes_the_events_when_the_profiler_disagrees(
        monkeypatch, readings, want):
    """`timed` measures again once when the profiler's reading contradicts
    the CUDA events, and reports the event time if it does so again."""
    evs = iter([ev for ev, _ in readings])
    devs = iter([dev for _, dev in readings])
    monkeypatch.setattr(smoke, 'time_ms', lambda fn: next(evs))
    monkeypatch.setattr(smoke, 'device_ms', lambda fn: next(devs))
    assert smoke.timed(lambda: None) == (want, readings[-1][0])
    assert next(evs, None) is None
