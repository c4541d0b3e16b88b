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
delta at B=8, T=2, H=256, rank 8, O=192 over a bank of 5 slots, and y +
delta with y of the delta's scale). The
bf16 tensor-core kernels round in their own order (P to bf16 before
P V over 64-key tiles of an online softmax; P^T and dS^T to bf16 before
the dV and dK products; dS to bf16 before the dQ product): that order
must pass the bf16 limits, and the redesign's likely faults must not.
The cluster adapter kernel's arithmetic (`adapter_cluster_model`: H in
8 slices summed in rank order) must pass, and an H slice left out, a
slot group's later row given its first row's delta or none, y + 2 delta
and the delta without y must fail.
The split-context paged kernel's arithmetic (`paged_split_model`: per
split m, l and P V, then the exp(m_s - M) rescale) must equal the plain
version to the f32 limits, and a combine without the rescale or without
the last live split must fail them. At a chunk shape (sq < sk) the
flash forward must pass with the bottom-right causal mask and fail
aligned top-left. The timing phase's reading (calls
queued behind a GPU-side sleep, else the CUDA events) is checked on
given readings.
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
    """The tensor-core forward's arithmetic: fp32 logits, an online
    softmax over `tile`-key blocks (the running max rescales the sums
    and the output by alpha unless `rescale` is False), P rounded to the
    input dtype (bf16 or fp16) before P V, fp32 sums, O / l rounded
    once; the LSE m + log l."""
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
            'bhqk,bkhd->bhqd', p.to(a['q'].dtype).float(),
            v[:, k0:k0 + tile])
        m = m_new
    out = (o / l[..., None]).transpose(1, 2).to(a['q'].dtype)
    return out, m + torch.log(l)


def _dkv_tensor_core(a, first_head_only=False):
    """The tensor-core dk/dv kernel's arithmetic: P^T and dS^T in fp32,
    rounded to the input dtype before the dV and dK products, fp32 sums over
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
    low = a['q'].dtype
    dk = torch.einsum('bhqk,bqhd->bkhd', ds.to(low).float(), q)
    dv = torch.einsum('bhqk,bqhd->bkhd', p.to(low).float(), do)
    return (K._fold_group(dk, HKV).to(a['k'].dtype),
            K._fold_group(dv, HKV).to(a['v'].dtype))


def _dq_tensor_core(a):
    """The tensor-core dq kernel's arithmetic: S and dP in fp32, dS
    rounded to the input dtype (bf16 or fp16) before dQ += dS K, fp32
    sums, dQ rounded once."""
    k, v = _repeat_kv(a)
    q, do = a['q'].float(), a['dout'].float()
    s = torch.einsum('bqhd,bkhd->bhqk', q, k) / math.sqrt(D)
    p = torch.exp(s - a['lse'][..., None]).tril()
    dp = torch.einsum('bqhd,bkhd->bhqk', do, v)
    ds = p * (dp - a['delta'][..., None]) / math.sqrt(D)
    dq = torch.einsum('bhqk,bkhd->bqhd', ds.to(a['q'].dtype).float(), k)
    return dq.to(a['q'].dtype)


@pytest.mark.parametrize('kernel', ['forward', 'dkv', 'dq'])
def test_compare_accepts_the_tensor_core_rounding_order(kernel):
    """The bf16 wgmma kernels' order of rounding passes the bf16 limits
    against the plain versions."""
    a = _attention(torch.bfloat16)
    if kernel == 'forward':
        smoke.compare(kernel, _forward_tensor_core(a), (a['out'], a['lse']))
    elif kernel == 'dkv':
        smoke.compare(kernel, _dkv_tensor_core(a), (a['dk'], a['dv']))
    else:
        smoke.compare(kernel, _dq_tensor_core(a), a['dq'])


def paged_split_model(q, k_pages, v_pages, table, lengths, k_scales=None,
                      v_scales=None, k_win=None, v_win=None, win_first=None,
                      rescale=True, drop_last_split=False, late_mask=False):
    """The split-context paged kernel's arithmetic in plain torch, fp32.

    Each slot's pages run in splits of `K.paged_split` pages; a split
    past the slot's last page (ceil(length / ps), at least 1) holds
    nothing. Per live split and query head: the scores (keys at or past
    the length masked), m = their max, l = sum exp(s - m), acc = the
    exp(s - m)-weighted sum of V rows. With the decode round's window
    (int8 pages), the splits skip the window's logical pages [win_first,
    win_first + W) (a split left with none holds nothing), and one more
    partial attends the window's W * ps rows (keys at or past the length
    or the table's end masked; none when the window starts at or past
    the length). The combine: out = sum_s acc_s w_s / sum_s l_s w_s with
    w_s = exp(m_s - M), M = max_s m_s. As faults: `rescale=False` takes
    w_s = 1, `drop_last_split` leaves out each slot's last live split,
    `late_mask` masks from one key past the length."""
    n, h, d = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    p = table.shape[1]
    g = h // hkv
    pps, splits = K.paged_split(p, ps)
    qf = q.float().reshape(n, hkv, g, d) / math.sqrt(d)
    out = torch.empty(n, hkv, g, d)

    def part(i, k, v, keys, length):
        s = torch.einsum('kgd,tkd->kgt', qf[i], k.reshape(-1, hkv, d))
        s = s.masked_fill(keys >= length + late_mask, K.NEG_INF)
        m = s.amax(dim=-1)
        e = torch.exp(s - m[..., None])
        return m, e.sum(dim=-1), torch.einsum('kgt,tkd->kgd', e,
                                              v.reshape(-1, hkv, d))

    for i in range(n):
        length = int(lengths[i])
        n_pages = min(max(-(-length // ps), 1), p)
        w0 = -1 if k_win is None else int(win_first[i])
        w = 0 if k_win is None else k_win.shape[1]
        parts = []
        for first in range(0, min(splits * pps, n_pages), pps):
            pages = [c for c in range(first, min(first + pps, n_pages))
                     if not w0 <= c < w0 + w]
            if not pages:
                continue
            ids = table[i, pages].long()
            k, v = k_pages[ids].float(), v_pages[ids].float()
            if k_scales is not None:
                k = k * k_scales[ids][:, None, :, None]
                v = v * v_scales[ids][:, None, :, None]
            keys = (torch.tensor(pages)[:, None] * ps
                    + torch.arange(ps)).reshape(-1)
            parts.append(part(i, k, v, keys, length))
        if w and w0 * ps < max(length, 1):
            keys = w0 * ps + torch.arange(w * ps)
            parts.append(part(i, k_win[i].float(), v_win[i].float(), keys,
                              min(length, p * ps)))
        if drop_last_split and len(parts) > 1:
            parts = parts[:-1]
        m, l, acc = (torch.stack(x) for x in zip(*parts))
        w = torch.exp(m - m.amax(dim=0)) if rescale else torch.ones_like(m)
        out[i] = (acc * w[..., None]).sum(dim=0) / (l * w).sum(dim=0)[..., None]
    return out.reshape(n, h, d).to(q.dtype)


_PAGED_CASES = {
    # (H, HKV, page size, lengths) over tables of 10 pages. Pages of 16
    # rows: splits of 4 pages (64 keys), the last split of a full table
    # holding 2 pages; of 8 rows: 2 splits of 8 pages; of 64 rows: 10
    # splits of 1 page; of 5 rows: one split of 12 pages, past the table
    'split_boundary': (4, 4, 16, [63, 64, 65, 127, 128, 129]),
    'full_table': (4, 4, 16, [160, 100, 159]),
    'length_1': (4, 4, 16, [1, 2, 17]),
    'one_split': (4, 4, 16, [1, 17, 64]),
    'group_4': (8, 2, 16, [1, 64, 65, 160]),
    'group_8': (16, 2, 16, [1, 64, 65, 160]),
    'page_8': (4, 4, 8, [7, 8, 63, 64, 65, 80]),
    'page_64': (4, 2, 64, [1, 63, 64, 65, 640]),
    'page_5': (4, 2, 5, [1, 5, 49, 50]),
}


def _paged(case):
    """(q, k_pages, v_pages, table, lengths) in f32 for a case of
    _PAGED_CASES, D = 128, each slot on its own 10 pages."""
    h, hkv, ps, lengths = _PAGED_CASES[case]
    rng = np.random.RandomState(3)
    n, p = len(lengths), 10
    num_pages = n * p + 1
    q = _randn(rng, (n, h, D), torch.float32)
    kp = _randn(rng, (num_pages, ps, hkv, D), torch.float32)
    vp = _randn(rng, (num_pages, ps, hkv, D), torch.float32)
    table = torch.from_numpy(
        (rng.permutation(num_pages - 1)[:n * p] + 1).astype(np.int32)
        .reshape(n, p))
    return q, kp, vp, table, torch.tensor(lengths, dtype=torch.int32)


@pytest.mark.parametrize('case', sorted(_PAGED_CASES))
def test_paged_split_model_matches_plain(case):
    """The split-and-combine arithmetic equals the plain version within
    the f32 limits, across split boundaries, a full table, length 1, one
    split, GQA groups of 4 and 8, and pages of 5, 8 and 64 rows."""
    args = _paged(case)
    smoke.compare(case, paged_split_model(*args),
                  K.paged_attention_reference(*args))


# the paged kernel's instantiations: (D, bytes of a KV element) of its
# split tiles (pages in q's dtype, f32 or bf16, int8 pages) at D = 128
# and 64; a split's tile holds PAGED_SPLIT_KEYS rows
PAGED_TILES = [(d, elt) for d in (128, 64) for elt in (4, 2, 1)]


def chunk_at(d, elt, t, c):
    """Byte offset of 16-byte chunk c of row t in a split's tile: a
    mirror of `chunk_at` in paddle_tpu_torch/csrc/paged_attention.cuh
    (the chunk swizzled inside its row over 8 chunks, over 4 in a 64-byte
    row)."""
    row = d * elt
    return t * row + ((c ^ (t & (3 if row == 64 else 7))) << 4)


def chunk_at_before(d, elt, t, c):
    """The layout before int8 pages at D = 64 were built: XOR with t & 7
    whatever the row's width."""
    return t * d * elt + ((c ^ (t & 7)) << 4)


def tile_faults(layout, d, elt):
    """What is wrong with `layout` for a (D, element bytes) tile: a chunk
    outside its own row, two chunks on the same 16 bytes, or a warp's
    shared access that meets a bank twice. The split kernel's threads:
    D / 8 lanes a key row, lane dg's row slot tid // (D / 8); cp.async
    stores 16 bytes a thread (8 threads a pass of the memory), the reads
    `row8` 16 bytes (f32: chunks dg and dg + D / 8; bf16: chunk dg) or 8
    (int8: chunk dg >> 1 at (dg & 1) * 8; 16 threads a pass)."""
    rows, chunks, lanes = K.PAGED_SPLIT_KEYS, d * elt // 16, d // 8
    faults = []
    seen = {}
    for t in range(rows):
        for c in range(chunks):
            off = layout(d, elt, t, c)
            if not t * chunks * 16 <= off < (t + 1) * chunks * 16:
                faults.append(f'row {t} chunk {c} at {off}: outside its row')
            if off in seen:
                faults.append(f'row {t} chunk {c} on {seen[off]}\'s bytes')
            seen[off] = (t, c)

    def conflicts(addrs, size):
        # one pass of the memory: 128 bytes, 32 banks of 4 bytes; a bank
        # met by two distinct words is a conflict
        per = 128 // size
        for i in range(0, len(addrs), per):
            words = {a // size for a in addrs[i:i + per]}
            banks = [b for w in words for b in
                     range(w * size // 4 % 32, w * size // 4 % 32 + size // 4)]
            if len(banks) != len(set(banks)):
                return True
        return False

    stores = [layout(d, elt, i // chunks, i % chunks)
              for i in range(32 * (rows * chunks // 32))]
    if any(conflicts(stores[w:w + 32], 16) for w in range(0, len(stores), 32)):
        faults.append('cp.async stores meet a bank twice')
    for warp in range(128 // 32):
        for i in range(rows // (128 // lanes)):
            tids = range(32 * warp, 32 * warp + 32)
            rs = [tid // lanes + 128 // lanes * i for tid in tids]
            dg = [tid % lanes for tid in tids]
            if elt == 1:
                reads = [[layout(d, elt, t, g >> 1) + (g & 1) * 8
                          for t, g in zip(rs, dg)]]
            elif elt == 2:
                reads = [[layout(d, elt, t, g) for t, g in zip(rs, dg)]]
            else:
                reads = [[layout(d, elt, t, g + o) for t, g in zip(rs, dg)]
                         for o in (0, d // 8)]
            if any(conflicts(r, 8 if elt == 1 else 16) for r in reads):
                faults.append(f'row8 reads of warp {warp} meet a bank twice')
    return faults


@pytest.mark.parametrize('d,elt', PAGED_TILES)
def test_paged_tile_layout_keeps_rows_apart_without_bank_conflicts(d, elt):
    """Every built (D, KV dtype): each (row, chunk) of a split's tile on
    its own 16 bytes inside its row, and the staging stores and the
    `row8` reads free of bank conflicts. The layout before int8 pages at
    D = 64 (XOR with t & 7 on every row) fails there: it puts a 64-byte
    row's chunks into the next row's bytes."""
    assert tile_faults(chunk_at, d, elt) == []
    if d * elt == 64:
        assert any('outside its row' in f
                   for f in tile_faults(chunk_at_before, d, elt))
    else:
        assert tile_faults(chunk_at_before, d, elt) == []


# the paged kernel's built (D, KV dtype) pairs: pages in q's dtype (f32,
# bf16, fp16) and int8 pages, at D = 128 and 64 (`paged_attention_entry`
# in csrc/paged_attention.cuh, one library per q dtype); fp16 is a 2-byte
# element and takes the bf16 tile layout
PAGED_TILE_DTYPES = [(d, dt) for d in (128, 64) for dt in (
    torch.float32, torch.bfloat16, torch.float16, torch.int8)]


@pytest.mark.parametrize('d,dtype', PAGED_TILE_DTYPES,
                         ids=[f'{d}-{str(dt)[6:]}'
                              for d, dt in PAGED_TILE_DTYPES])
def test_paged_tile_layout_holds_for_every_built_dtype(d, dtype):
    """Each (D, KV dtype) the kernel is built for, fp16 pages included,
    has a tile of its element's width (`PAGED_TILES`) whose layout keeps
    rows apart without bank conflicts."""
    elt = torch.tensor([], dtype=dtype).element_size()
    assert (d, elt) in PAGED_TILES
    assert tile_faults(chunk_at, d, elt) == []


def _mutant(case, dtype):
    """(kernel output with a fault, plain output)."""
    if case.startswith('paged'):
        args = _paged('split_boundary')
        fault = {'paged_combine_without_rescale': dict(rescale=False),
                 'paged_combine_drops_last_live_split':
                     dict(drop_last_split=True),
                 'paged_mask_one_key_late': dict(late_mask=True)}[case]
        return (paged_split_model(*args, **fault),
                K.paged_attention_reference(*args))
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
    if case == 'dq_without_the_causal_mask':
        # dS from P without the causal mask (a diagonal tile left unmasked)
        k, v = _repeat_kv(a)
        s = torch.einsum('bqhd,bkhd->bhqk', a['q'].float(), k) / math.sqrt(D)
        p = torch.exp(s - a['lse'][..., None])
        dp = torch.einsum('bqhd,bkhd->bhqk', a['dout'].float(), v)
        ds = p * (dp - a['delta'][..., None]) / math.sqrt(D)
        dq = torch.einsum('bhqk,bkhd->bqhd', ds.to(dtype).float(), k)
        return dq.to(dtype), a['dq']
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
    ('dq_without_the_causal_mask', torch.bfloat16),
    ('paged_combine_without_rescale', torch.float32),
    ('paged_combine_drops_last_live_split', torch.float32),
    ('paged_mask_one_key_late', torch.float32),
])
def test_compare_rejects_a_wrong_kernel(case, dtype):
    got, want = _mutant(case, dtype)
    with pytest.raises(AssertionError, match='rel_max'):
        smoke.compare(case, got, want)


@pytest.mark.parametrize('kernel', ['forward', 'dkv', 'dq'])
def test_compare_accepts_the_fp16_tensor_core_rounding_order(kernel):
    """The fp16 instantiations of the wgmma kernels round at the bf16
    kernels' points, to fp16: that order passes the fp16 limits, and so
    does one rounding of the exact result."""
    a = _attention(torch.float16)
    if kernel == 'forward':
        smoke.compare(kernel, _forward_tensor_core(a), (a['out'], a['lse']))
    elif kernel == 'dkv':
        smoke.compare(kernel, _dkv_tensor_core(a), (a['dk'], a['dv']))
    else:
        smoke.compare(kernel, _dq_tensor_core(a), a['dq'])
    e = _attention_fp64(a)
    for name in ('dq', 'dk', 'dv'):
        smoke.compare(name, e[name], a[name])


@pytest.mark.parametrize('case', [
    'forward_probs_rounded_to_bf16', 'forward_without_rescale',
    'dq_without_delta', 'dk_without_delta', 'dq_gain_2pct',
    'dkv_first_head_of_each_group_only', 'dq_without_the_causal_mask'])
def test_compare_rejects_a_wrong_fp16_kernel(case):
    """The fp16 limits fail the redesign's faults, and a kernel that
    rounds like the bf16 one (P to bf16) though its inputs are fp16."""
    got, want = _mutant(case, torch.float16)
    with pytest.raises(AssertionError, match='rel_max'):
        smoke.compare(case, got, want)


def test_compare_takes_an_overflow_only_as_the_plain_versions_inf():
    """An fp16 gradient past 65504 is inf in the plain version; the
    kernel must give inf at exactly those places (GradScaler reads it),
    never a clamped finite value, and no inf elsewhere."""
    a = _attention(torch.float16)
    want = a['dq'].clone()
    want[0, 3, 1, :4] = float('inf')
    want[0, 5, 0, 7] = -float('inf')
    smoke.compare('dq overflow', want.clone(), want)
    clamped = want.clone()
    clamped[0, 3, 1, :4] = 65504.0
    with pytest.raises(AssertionError, match='inf/NaN exactly'):
        smoke.compare('dq clamped', clamped, want)
    extra = want.clone()
    extra[0, 9, 2, 0] = float('inf')
    with pytest.raises(AssertionError, match='inf/NaN exactly'):
        smoke.compare('dq extra inf', extra, want)


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


def adapter_cluster_model(x, a, b, rows, scale, y=None, drop_slice=None,
                          later_rows=None, gain=1.0):
    """The cluster adapter kernel's arithmetic in plain torch, fp32: H cut
    into the 8 blocks' slices (ceil(H / 8) rounded up to 8), each slice's
    partial x A summed in rank order, then h1 B, the scale, one rounding to
    x.dtype and, with y, the add in y's dtype. As faults: `drop_slice`
    leaves one block's H slice out of the cluster's sum; `later_rows`
    'leader' gives every later row of a slot group its first row's delta,
    'zero' a zero delta; `gain` scales the delta (2: y + 2 delta)."""
    h = x.shape[2]
    hs = -(-(-(-h // 8)) // 8) * 8
    idx = rows.long()
    af, bf = a[idx].float(), b[idx].float()
    h1 = torch.zeros(x.shape[0], x.shape[1], a.shape[2])
    for k in range(8):
        if k != drop_slice:
            part = slice(k * hs, min(h, (k + 1) * hs))
            h1 += torch.einsum('bth,bhr->btr', x[:, :, part].float(),
                               af[:, part])
    d = (torch.einsum('btr,bro->bto', h1, bf)
         * scale[idx][:, None, None] * gain).to(x.dtype)
    first = {}
    for i, s in enumerate(rows.tolist()):
        if s not in first:
            first[s] = i
        elif later_rows == 'leader':
            d[i] = d[first[s]]
        elif later_rows == 'zero':
            d[i] = 0
    return d if y is None else y + d


def _adapter_y(x):
    rng = np.random.RandomState(4)
    return (0.5 * _randn(rng, (x.shape[0], x.shape[1], 192),
                         torch.float32)).to(x.dtype)


@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_compare_accepts_the_cluster_adapter_kernel(dtype, fused):
    """The cluster kernel's order of sums, and fp64 rounded once, pass
    against the plain delta and the plain y + delta."""
    args = _adapter(dtype)
    if fused:
        y = _adapter_y(args[0])
        want = K.adapter_matmul_add_reference(y, *args)
        smoke.compare('adapter + y', adapter_cluster_model(*args, y=y), want)
        smoke.compare('adapter + y fp64', y + _adapter_fp64(*args), want)
    else:
        smoke.compare('adapter', adapter_cluster_model(*args),
                      K.adapter_matmul_reference(*args))


@pytest.mark.parametrize('case,dtype', [
    ('h_slice_missing', torch.bfloat16),
    ('h_slice_missing', torch.float32),
    ('later_row_gets_leader_delta', torch.bfloat16),
    ('later_row_gets_zero_delta', torch.bfloat16),
    ('later_row_gets_leader_delta', torch.float32),
    ('y_plus_twice_delta', torch.bfloat16),
    ('y_plus_twice_delta', torch.float32),
    ('delta_without_y', torch.bfloat16),
])
def test_compare_rejects_a_wrong_cluster_adapter_kernel(case, dtype):
    """The redesign's likely faults fail the limits against y + delta: an
    H slice left out of the cluster reduction, a slot group's later row
    given the first row's delta or none, the delta added twice, or the
    delta returned without y."""
    args = _adapter(dtype)
    y = _adapter_y(args[0])
    want = K.adapter_matmul_add_reference(y, *args)
    if case == 'h_slice_missing':
        got = adapter_cluster_model(*args, y=y, drop_slice=3)
    elif case.startswith('later_row'):
        got = adapter_cluster_model(
            *args, y=y, later_rows='zero' if 'zero' in case else 'leader')
    elif case == 'y_plus_twice_delta':
        got = adapter_cluster_model(*args, y=y, gain=2.0)
    else:
        got = adapter_cluster_model(*args)
    with pytest.raises(AssertionError, match='rel_max'):
        smoke.compare(case, got, want)


def _chunk_attention(dtype, top_left=False):
    """(plain output, the same function in fp64 rounded once) of causal
    attention at a chunk shape of the smoke (64 queries over 576 keys,
    the suffix's rows after 512 cached ones); with `top_left` the fp64
    one masks key j > i instead of j > i + sk - sq: the mask SDPA's
    is_causal gives, another function when sq < sk."""
    sq, sk = 64, 576
    assert (sq, sk) in smoke.CHUNK_SHAPES
    rng = np.random.RandomState(7)
    q = _randn(rng, (B, sq, H, D), dtype)
    k = _randn(rng, (B, sk, HKV, D), dtype)
    v = _randn(rng, (B, sk, HKV, D), dtype)
    want = K.attention_reference(q, k, v, causal=True)
    kr = k.double().repeat_interleave(H // HKV, dim=2)
    vr = v.double().repeat_interleave(H // HKV, dim=2)
    s = torch.einsum('bqhd,bkhd->bhqk', q.double(), kr) / math.sqrt(D)
    shift = 0 if top_left else sk - sq
    keep = torch.arange(sk)[None, :] <= torch.arange(sq)[:, None] + shift
    p = torch.softmax(s.masked_fill(~keep, -math.inf), dim=-1)
    return want, torch.einsum('bhqk,bkhd->bqhd', p, vr).to(dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_compare_takes_the_chunk_shape_and_rejects_top_left(dtype):
    """At sq < sk the bottom-right causal mask, rounded once, passes; a
    kernel aligned top-left (query i sees keys <= i) fails."""
    want, right = _chunk_attention(dtype)
    smoke.compare('flash chunk', right, want)
    _, top_left = _chunk_attention(dtype, top_left=True)
    with pytest.raises(AssertionError, match='rel_max'):
        smoke.compare('flash chunk, top-left', top_left, want)


def test_prefix_trace_is_the_shared_system_prompt_mix():
    """16 prompts: 13 with the 512-token system prompt and a suffix from
    PREFIX_SUFFIXES in turn, the warm-up's exact repeat (544 tokens, a
    whole number of pages: the only possible full hit), two cold
    900-token prompts, none sharing the system prompt."""
    warm, prompts = smoke.prefix_trace(32000, np.random.RandomState(5))
    system = warm[:smoke.PREFIX_SYSTEM]
    assert len(prompts) == 16 and len(warm) == 544 and len(warm) % 16 == 0
    shared = [p for p in prompts if p[:512] == system and p != warm]
    assert [len(p) - 512 for p in shared] == \
        list((smoke.PREFIX_SUFFIXES * 3)[:13])
    assert prompts.count(warm) == 1
    cold = [p for p in prompts if p[:512] != system]
    assert [len(p) for p in cold] == [smoke.PREFIX_COLD] * 2
    assert all(len(p) + 32 <= smoke.PREFIX_ENGINE['max_length']
               for p in prompts)


def test_compare_rejects_a_dtype_or_shape_change():
    x = torch.ones(4, 8, dtype=torch.bfloat16)
    with pytest.raises(AssertionError, match='kernel gives'):
        smoke.compare('dtype', x.float(), x)
    with pytest.raises(AssertionError, match='kernel gives'):
        smoke.compare('shape', x[:2], x)


@pytest.mark.parametrize('queued,ev,want', [
    (0.029, 0.060, 0.029),    # a small kernel: the events read the launches
    (0.466, 0.470, 0.466),    # a long kernel: both read the device
    (None, 0.470, 0.470),     # the host could not keep ahead: the events
])
def test_timed_takes_the_queued_calls_or_else_the_events(
        monkeypatch, queued, ev, want):
    """`timed` reports the calls queued behind a sleep (the device time
    without the host's launch gaps), beside the back-to-back event time,
    which it reports instead only when the calls could not be queued."""
    monkeypatch.setattr(smoke, 'time_ms', lambda fn: ev)
    monkeypatch.setattr(smoke, 'queued_ms', lambda fn: queued)
    assert smoke.timed(lambda: None) == (want, ev)


@pytest.mark.parametrize('queries,want,sleeps', [
    ([False], 0.1, 1),          # still asleep when the host was done
    ([True, False], 0.1, 2),    # a call waited: again, sleeping 4x longer
    ([True, True], None, 2),    # a call waited twice: no reading
])
def test_queued_ms_keeps_only_calls_the_sleep_held(monkeypatch, queries,
                                                   want, sleeps):
    """`queued_ms` keeps a timing only when the GPU was still asleep after
    the host had launched every call (the event after the sleep not yet
    reached), so that no launch gap is in it; it gives None rather than a
    reading with gaps."""
    answers, slept, calls = iter(queries), [], []

    class Event:
        def __init__(self, enable_timing=False):
            pass

        def record(self):
            pass

        def query(self):
            return next(answers)

        def elapsed_time(self, end):
            return 2.0                 # ms over 20 calls

    monkeypatch.setattr(smoke.torch.cuda, 'Event', Event)
    monkeypatch.setattr(smoke.torch.cuda, 'synchronize', lambda: None)
    monkeypatch.setattr(smoke.torch.cuda, '_sleep', slept.append)
    assert smoke.queued_ms(lambda: calls.append(1)) == want
    assert len(slept) == sleeps
    assert all(b == 4 * a for a, b in zip(slept, slept[1:]))
    assert len(calls) == 21 + 20 * sleeps


def test_queued_ms_with_before_times_each_call_alone(monkeypatch):
    """With `before` (the smoke's L2 flush), `queued_ms` runs before()
    ahead of every call, warm-up and launch-rate calls too, and times each
    call alone between its own pair of events, never before() itself:
    the reading is the mean of the pairs."""
    order, pairs = [], []

    class Event:
        def __init__(self, enable_timing=False):
            self.t = None

        def record(self):
            self.t = len(order)
            order.append('event')

        def query(self):
            return False               # still asleep: every call queued

        def elapsed_time(self, end):
            pairs.append(order[self.t + 1:end.t])
            return 0.5 * len(pairs)    # ms: 0.5, 1.0, ..., 10.0

    monkeypatch.setattr(smoke.torch.cuda, 'Event', Event)
    monkeypatch.setattr(smoke.torch.cuda, 'synchronize', lambda: None)
    monkeypatch.setattr(smoke.torch.cuda, '_sleep', lambda cycles: None)
    got = smoke.queued_ms(lambda: order.append('call'),
                          before=lambda: order.append('before'))
    assert got == pytest.approx(sum(0.5 * i for i in range(1, 21)) / 20)
    assert pairs == [['call']] * 20
    assert order.count('before') == order.count('call') == 41


# ---------------------------------------------------------------------------
# the multi-tensor Adam cases and the pretraining phase's helpers
# ---------------------------------------------------------------------------

def _adam_state(master_moments):
    """bf16 params with fp32 masters and moments (or bf16 moments and no
    masters), bf16 grads, a clip scale < 1: the smoke's optimizer case at
    a small size."""
    rng = np.random.RandomState(6)
    shapes = [(64, 48), (48,), (300,)]
    ps = [0.02 * _randn(rng, s, torch.float32) for s in shapes]
    m_dtype = torch.float32 if master_moments else torch.bfloat16
    return dict(
        params=[p.bfloat16() for p in ps],
        grads=[(0.01 * _randn(rng, s, torch.float32)).bfloat16()
               for s in shapes],
        m=[(1e-3 * _randn(rng, s, torch.float32)).to(m_dtype)
           for s in shapes],
        v=[(1e-4 * _randn(rng, s, torch.float32).abs()).to(m_dtype)
           for s in shapes],
        masters=[p.clone() if master_moments else None for p in ps])


_ADAM_KW = dict(lr_t=1e-3, beta1=0.9, beta2=0.95, epsilon=1e-5,
                decay=[3e-5, 0.0, 3e-5], decay_mode='decoupled')


def _adam_outputs(st, fault=None):
    """One step of the plain version (or of a kernel with `fault`) on a
    copy of `st`; returns every updated tensor, as the smoke's case."""
    st = {k: [None if x is None else x.clone() for x in v]
          for k, v in st.items()}
    scale = torch.tensor(0.37)
    kw = dict(_ADAM_KW)
    grads = st['grads']
    if fault == 'clip_scale_not_rounded_to_the_grad_dtype':
        grads = [g.float() * scale for g in grads]
        scale = None
    elif fault == 'no_decay':
        kw['decay'] = [0.0] * 3
    elif fault == 'clip_scale_ignored':
        scale = None
    elif fault == 'beta2_for_beta1':
        kw['beta1'] = kw['beta2']
    if grads is not st['grads']:    # fp32 grads: widen the params too
        st['params'] = [p.float() for p in st['params']]
    K.multi_tensor_adam_reference(st['params'], grads, st['m'], st['v'],
                                  st['masters'], [None] * 3,
                                  clip_scale=scale, **kw)
    params = [p.bfloat16() for p in st['params']]
    return tuple(x for ts in (params, st['m'], st['v'], st['masters'])
                 for x in ts if x is not None)


@pytest.mark.parametrize('fault', ['clip_scale_not_rounded_to_the_grad_dtype',
                                   'no_decay', 'clip_scale_ignored',
                                   'beta2_for_beta1'])
def test_compare_rejects_a_wrong_adam_kernel(fault):
    """With fp32 masters and moments (the smoke's second size), each
    fault moves an fp32 output past the f32 limits; a correct kernel
    passes."""
    st = _adam_state(master_moments=True)
    want = _adam_outputs(st)
    smoke.compare('adam', _adam_outputs(st), want)
    with pytest.raises(AssertionError, match='rel_max'):
        smoke.compare(fault, _adam_outputs(st, fault), want)


def test_rung_tensor_shapes_are_the_models():
    """One decoder layer plus lm_head of Llama-2-7B: 333.5 M elements,
    under the names and shapes the port's Llama gives them."""
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
    shapes = smoke.rung_tensor_shapes(LlamaConfig.llama2_7b())
    assert sum(math.prod(s) for _, s in shapes) == 333_455_360
    cfg = LlamaConfig.tiny(num_key_value_heads=2, num_hidden_layers=1)
    params = dict(LlamaForCausalLM(cfg, device='cpu').named_parameters())
    for name, shape in smoke.rung_tensor_shapes(cfg):
        full = name if name.startswith('lm_head') else f'llama.layers.0.{name}'
        assert tuple(params[full].shape) == shape, name


def test_pretraining_optimizer_and_update_bound():
    """Llama 2's recipe: decay on all but norms, the clip, the warm-up's
    lr; and the update's bound counts 14 bytes a bf16 parameter (16 under
    the clip, which reads the grads twice)."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    named = [('w', torch.zeros(10, dtype=torch.bfloat16)),
             ('input_layernorm.weight', torch.zeros(6, dtype=torch.bfloat16))]
    opt, sched = smoke.pretraining_optimizer(
        named, 3e-4, 2000, 498000, start_lr=0.0, moment_dtype='bfloat16')
    assert isinstance(opt._grad_clip, ClipGradByGlobalNorm)
    assert opt._coeff_for('w') == 0.1
    assert opt._coeff_for('input_layernorm.weight') == 0.0
    for k in range(5):
        assert opt.get_lr() == 3e-4 * k / 2000
        sched.step()
    for _, p in named:
        p.grad = torch.ones_like(p)
    opt.step()
    assert smoke.update_bound_ms(opt, named) == pytest.approx(
        16 * 16 / smoke.HBM_BYTES_PER_S * 1e3)
    opt._grad_clip = None
    assert smoke.update_bound_ms(opt, named) == pytest.approx(
        14 * 16 / smoke.HBM_BYTES_PER_S * 1e3)
