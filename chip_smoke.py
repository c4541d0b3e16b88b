#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --hook-us TREE   # host us of one adapted
                                           # projection, port in TREE
    python3 chip_smoke.py --train-ms TREE  # the training rung's step
                                           # time, port in TREE

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. build: compile every kernel source under `paddle_tpu_torch/csrc/` with
   nvcc (sm_90a), all sources at once; log each kernel's registers and
   spills, and require HGMMA (wgmma) instructions in the bf16 flash
   forward, dq and dk/dv kernels (`cuobjdump -sass`);
2. kernels: hold each kernel against its plain PyTorch version on the
   card, in f32 and bf16, at the serving and training paths' shapes
   (plus GQA, ragged lengths, int8 pages, ignored CE rows, and adapter
   rows on slot 0, whose delta must be exactly zero and whose fused
   y + delta must equal y bit for bit); then the multi-tensor sum of
   squares and Adam update over the training rung's tensors of one
   decoder layer plus lm_head (bf16 with bf16 moments, and bf16 with
   fp32 masters and moments; a global-norm clip scale below 1, and
   amsgrad), every updated p, m, v (master, max) held to the plain
   version (the cases are freed after the check and rebuilt for 8);
3. consistency: the engine (its decode sub-step replayed from a CUDA
   graph) at 2 layers of Llama-2-7B width in f32, greedy;
   each request's first 16 tokens must equal a no-cache full-recompute
   forward of the same model; then adapter consistency at the same size:
   with a bank of two LoRA adapters, a mixed wave [base, ad0, ad1, ad0]
   gives each request the tokens it gets served alone under its adapter
   on a fresh engine and bank, base requests the tokens of a bank-less
   engine, and an adapter changes some tokens;
4. train consistency: the same width at 2 layers in f32 (TF32 off), one
   forward and backward of the next-token loss on the card (kernels) and
   on the CPU (plain versions) with the same weights: the losses and
   every parameter's gradient must agree, and again on the card with
   `use_recompute=True`; then two `TrainStep`s on each under Llama 2's
   AdamW recipe (global-norm clip, LinearWarmup around a cosine stepped
   after each step): the losses, and each parameter's update over the
   two steps, must agree;
5. train: the JAX bench's `llama2_7b_shape_8L` rung (Llama-2-7B width,
   8 layers, bf16, recompute, batch 2 x seq 2048, AdamW lr 3e-4 with bf16
   moments) through `TrainStep`, 2 warm-up and 6 timed steps on 4
   rotating batches, with every training kernel's launch count read
   around the timed steps and required to be > 0 (the multi-tensor Adam
   update included); then steps on one fixed batch it has not seen: the
   first loss (held out) must stay near ln(V), as no model that sees
   only past tokens can predict uniform random tokens, and the loss must
   then fall by at least OVERFIT_MIN_DROP;
5b. pretrain: the same model and rung under Llama 2's pretraining
   optimizer (AdamW 0.9/0.95/1e-5, decay 0.1 except on norms,
   ClipGradByGlobalNorm(1.0), 2000 warm-up steps into a cosine from
   3e-4 to 3e-5 over 498,000), phase 5's optimizer state freed first: 2
   warm-up and 6 timed steps, the scheduler stepped after each; each
   step's lr must be the schedule's, the loss finite, and the sum of
   squares and Adam kernels must both launch;
6. serve: Llama-2-7B (32 layers, bf16, random weights from a seed) behind
   the 8-slot paged engine, which replays its decode sub-step from a
   captured CUDA graph, 12 requests (prompts 13-700 tokens, 32 new
   tokens; 11 greedy, 1 sampling), with every serving kernel's launch
   count read around that run (replays counted) and required to be > 0,
   and one capture; then the same requests on an engine that runs the
   sub-step uncaptured (the eager loop): every request's tokens must be
   equal, and both runs are logged side by side; then the same model,
   prompts and settings behind an engine with an `AdapterBank` of three
   rank-8 adapters on q/k/v/o_proj, request i under
   [base, ad0, ad1, ad2][i % 4], graph and eager alike: every request
   finishes with the same tokens in both, the adapter kernel runs
   exactly once per adapted projection of every prefill and decode
   sub-step, base requests get phase 6's tokens and adapted ones
   differ; then the host time of one adapted projection (hook, wrapper
   and launch) at the decode shape;
7. profile: one decode round with every slot busy (wall time, then a
   torch.profiler breakdown of the next round's device time) on the
   plain and on the banked engine, each replayed from its graph and run
   eagerly, one prefill forward, and one training step (forward +
   backward, then the optimizer update, each profiled); each decode
   round must run the split-context paged kernels and RMSNorm and not
   the first design's `paged_attn_kernel` (the banked ones also the
   cluster adapter kernel and not the first design's
   `adapter_matmul_kernel`), the prefill the wgmma forward kernel, the
   training step the wgmma forward, dq and dk/dv kernels, and its update
   window (phase 5b's optimizer, then phase 5's) the multi-tensor Adam
   kernel (5b's also the sum of squares), its device ms logged beside
   the bound of the bytes the update must move;
8. timing: each kernel case of phase 2 timed (device time per call:
   CUDA events around calls queued behind a GPU-side sleep, which hides
   the host's launch gaps; beside it the event time of back-to-back
   calls, the host's launch rate for a small kernel), with its plain
   version, the one PyTorch call that computes the same function where
   there is one, and the card's bound for the same work; the adapter
   cases also beside a composite of several PyTorch calls, the
   multi-tensor ones beside PyTorch's nearest calls (`_foreach_norm`, the
   fused `torch.optim.AdamW`; neither computes the same function), and
   the decode ones also with L2 flushed before each call.

Phases 5, 5b and 6 run before any profiling: once torch.profiler has
run in a process, every later launch costs the host more.

The last lines are the card's name and power limit, a JSON line with the
kernel table, and `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, published
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense bf16 tensor cores
                  torch.float32: 67e12}     # fp32 outside the tensor cores
# kernel vs plain, per output and by the output's dtype, two readings:
# rel_max = max|kernel - plain| / max|plain| and rel_norm = |kernel -
# plain| / |plain| (Frobenius norms). A correct kernel sums in another
# order than its plain version, which moves an f32 output by about 1e-6
# of its scale; a bf16 output then differs by one bf16 ulp on a few
# elements, and the plain attention forward also rounds its
# probabilities to bf16 (as the JAX package's does), about 3e-3 of the
# output's norm. A kernel that leaves out a term (delta, the softmax
# term of CE) or is off by 2% fails the limits (tests/test_torch_smoke.py
# holds this check to such kernels on the CPU). The readings that set
# each limit are in PERF.md, section 2.
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -6, 2 ** -7)}
REPLACES = {
    'flash_attention_fwd':
        'paddle_tpu/ops/pallas_kernels.py:89 (_flash_fwd_kernel)',
    'flash_attention_bwd_dq':
        'paddle_tpu/ops/pallas_kernels.py:226 (_flash_bwd_dq_kernel)',
    'flash_attention_bwd_dkv':
        'paddle_tpu/ops/pallas_kernels.py:272 (_flash_bwd_dkv_kernel)',
    'rms_norm': 'paddle_tpu/ops/pallas_kernels.py:434 (_rms_fwd_kernel)',
    'paged_attention':
        'paddle_tpu/ops/pallas_kernels.py:701 (_paged_attn_kernel)',
    'softmax_ce_fwd': 'paddle_tpu/ops/pallas_kernels.py:494 (_ce_fwd_kernel)',
    'softmax_ce_bwd': 'paddle_tpu/ops/pallas_kernels.py:531 (_ce_bwd_kernel)',
    'adapter_matmul':
        'paddle_tpu/ops/pallas_kernels.py:851 (_adapter_matmul_kernel)',
    'multi_tensor_adam':
        'no Pallas site: the Adam/AdamW update XLA fuses inside the JAX '
        'TrainStep (paddle_tpu/jit/__init__.py:269-273, '
        'paddle_tpu/optimizer/__init__.py:114-133)',
    'multi_tensor_sumsq':
        'no Pallas site: the global-norm clip XLA fuses inside the JAX '
        'TrainStep (paddle_tpu/jit/__init__.py:269-273, '
        'paddle_tpu/optimizer/__init__.py:114-133)',
}
SOURCES = {
    'flash_attention_fwd': 'paddle_tpu_torch/csrc/flash_attention.cu',
    'flash_attention_bwd_dq': 'paddle_tpu_torch/csrc/flash_attention_bwd.cu',
    'flash_attention_bwd_dkv': 'paddle_tpu_torch/csrc/flash_attention_bwd.cu',
    'rms_norm': 'paddle_tpu_torch/csrc/rms_norm.cu',
    'paged_attention': 'paddle_tpu_torch/csrc/paged_attention.cu',
    'softmax_ce_fwd': 'paddle_tpu_torch/csrc/cross_entropy.cu',
    'softmax_ce_bwd': 'paddle_tpu_torch/csrc/cross_entropy.cu',
    'adapter_matmul': 'paddle_tpu_torch/csrc/adapter_matmul.cu',
    'multi_tensor_adam': 'paddle_tpu_torch/csrc/multi_tensor_adam.cu',
    'multi_tensor_sumsq': 'paddle_tpu_torch/csrc/multi_tensor_adam.cu',
}
# the tensor-core (wgmma) kernels that bf16 inputs run on, by source
WGMMA_KERNELS = {'flash_attention': ('flash_fwd_wgmma_kernel',),
                 'flash_attention_bwd': ('flash_bwd_dq_wgmma_kernel',
                                         'flash_bwd_dkv_wgmma_kernel')}
# the device kernels of one paged_attention call
PAGED_KERNELS = ('paged_attn_split_kernel', 'paged_attn_combine_kernel')
SERVE_KERNELS = ('flash_attention_fwd', 'paged_attention', 'rms_norm')
ADAPTER_KERNELS = SERVE_KERNELS + ('adapter_matmul',)
# Llama's projections; the bank's default targets name the JAX package's
# qkv_proj/out_proj
ADAPTER_TARGETS = ('q_proj', 'k_proj', 'v_proj', 'o_proj')
TRAIN_KERNELS = ('flash_attention_fwd', 'flash_attention_bwd_dq',
                 'flash_attention_bwd_dkv', 'rms_norm', 'softmax_ce_fwd',
                 'softmax_ce_bwd', 'multi_tensor_adam')
PRETRAIN_KERNELS = TRAIN_KERNELS + ('multi_tensor_sumsq',)
# training rung: the JAX bench's llama2_7b_shape_8L (bench.py:88-101,
# _run_config at :116-191)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARMUP = 2, 2048, 6, 2
TRAIN_LR = 3e-4
# Llama 2's pretraining optimizer (Touvron et al. 2023, section 2.2 and
# Table 1): AdamW(0.9, 0.95, eps 1e-5), decay 0.1, global-norm clip 1.0,
# 2000 warm-up steps, cosine to 10% of the peak lr
PRETRAIN_PEAK_LR, PRETRAIN_WARMUP, PRETRAIN_T_MAX = 3e-4, 2000, 498000
OVERFIT_STEPS = 10
OVERFIT_MIN_DROP = 0.5        # nats, first to last loss on one fixed batch
HELD_OUT_SLACK = 0.5          # nats below ln(V) a held-out loss may fall
# train consistency (f32, TF32 off): the loss to rel 1e-4, each gradient
# to a relative norm error of 1e-3 (fp32 sums over 128 tokens in another
# order on the card and on the CPU)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-4, 1e-3
DEV = 'cuda'


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA
    events around the run, after a warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int = 20, attempts: int = 2, before=None):
    """Device ms per call of fn() without the host's launch gaps: the
    calls are queued behind a GPU-side sleep longer than the host takes
    to launch them, and CUDA events time them back to back on the device.
    With `before`, before() runs ahead of each call, untimed (e.g. writing
    a buffer larger than L2, so that fn's inputs come from device memory),
    and events around each call alone time it. None when the sleep ended
    before the host had launched them all (a call that waits for the
    device), `attempts` times with a longer sleep each time."""
    def step():
        if before is not None:
            before()
        fn()

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    launch_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(min(launch_s, 0.25) * 4e9) + 100_000   # ~2x at ~2 GHz
    for _ in range(attempts):
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(1 if before is None else iters)]
        torch.cuda._sleep(cycles)
        if before is None:
            events[0][0].record()
            for _ in range(iters):
                fn()
            events[0][1].record()
        else:
            for start, end in events:
                before()
                start.record()
                fn()
                end.record()
        queued = not events[0][0].query()   # still sleeping: no call waited
        torch.cuda.synchronize()
        if queued:
            return sum(a.elapsed_time(b) for a, b in events) / iters
        cycles *= 4
    return None


def _device_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def timed(fn):
    """(device ms per call: the calls queued behind a sleep (`queued_ms`),
    or the CUDA-event ms if the host could not keep ahead of the device;
    the CUDA-event ms of back-to-back calls, which for a small kernel is
    the host's launch rate). The profiler is not read here: in some
    processes it lost the device events of most windows, and it has read
    whole kernels at half and at 1.5 times their event time."""
    ev = time_ms(fn)
    dev = queued_ms(fn)
    if dev is None:
        log('[timing]   the host could not keep ahead of the device; '
            'taking the events')
    return (ev if dev is None else dev), ev


def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(name: str, got, want) -> dict:
    """{max_abs_err, rel_max, rel_norm} of the kernel's output against the
    plain version's (the worst over the outputs of a tuple, each held to
    the limits of its own dtype); raises past a limit."""
    if isinstance(got, tuple):
        readings = [compare(f'{name} [{i}]', g, w)
                    for i, (g, w) in enumerate(zip(got, want))]
        return {k: max(r[k] for r in readings) for k in readings[0]}
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f'{name}: kernel gives {got.dtype} '
                             f'{tuple(got.shape)}, plain {want.dtype} '
                             f'{tuple(want.shape)}')
    if not torch.isfinite(got).all():
        raise AssertionError(f'{name}: kernel output has non-finite values')
    lim_max, lim_norm = TOL[want.dtype]
    got, want = got.double(), want.double()
    diff = got - want
    max_abs = float(diff.abs().max())
    rel_max = max_abs / max(float(want.abs().max()), 1e-30)
    rel_norm = float(diff.norm()) / max(float(want.norm()), 1e-30)
    if rel_max > lim_max or rel_norm > lim_norm:
        raise AssertionError(f'{name}: kernel vs plain rel_max {rel_max:.3e}'
                             f' (limit {lim_max:.3e}), rel_norm '
                             f'{rel_norm:.3e} (limit {lim_norm:.3e})')
    return dict(max_abs_err=max_abs, rel_max=rel_max, rel_norm=rel_norm)


def live_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs attention computes per (batch, head): all of
    them, or with the bottom-right causal mask those at or below the
    diagonal."""
    if not causal:
        return sq * sk
    return sq * (sk - sq) + sq * (sq + 1) // 2


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def hgmma_counts(lib_path, kernels) -> dict:
    """{kernel: count of HGMMA (wgmma) instructions} in `cuobjdump -sass`
    of a built kernel library, over the functions whose symbol contains
    each of `kernels`."""
    from paddle_tpu_torch.ops import _build
    cuobjdump = str(Path(_build._nvcc()).parent / 'cuobjdump')
    sass = subprocess.run([cuobjdump, '-sass', str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    counts, owners = dict.fromkeys(kernels, 0), []
    for line in sass.splitlines():
        if 'Function : ' in line:
            owners = [k for k in kernels if k in line]
        elif 'HGMMA' in line:
            for k in owners:
                counts[k] += 1
    return counts


def build():
    """Compile every kernel source; log each kernel's registers and
    spills, and require the tensor-core kernels' libraries to hold HGMMA
    instructions."""
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f'[build] {len(logs)} kernel source(s) compiled in '
        f'{time.perf_counter() - t0:.1f} s')
    for name in _build.SOURCES:    # ptxas -v of this build or the cached one
        for line in _build.build_log(name).splitlines():
            if ('entry function' in line or 'registers' in line
                    or 'spill' in line or 'Performance Loss' in line):
                log(f'[build] {name}: {line.strip()}')
    for source, label in (
            ('adapter_matmul', 'adapter_sgmv_kernel: {n} instantiations (x '
                               'and bank dtype x padded rank x vector path)'),
            ('multi_tensor_adam', 'multi_tensor_adam.cu: {n} kernels (param '
                                  'dtype x moment dtype x master x amsgrad,'
                                  ' the sum of squares and its finish)')):
        regs, spills = [], []
        for line in _build.build_log(source).splitlines():
            if 'Used' in line and 'registers' in line:
                regs.append(int(line.split('Used')[1].split()[0]))
            elif 'spill stores' in line:
                spills.append(int(line.split('bytes spill stores')[0]
                                  .split(',')[-1]))
        log(f'[build] {label.format(n=len(regs))}, registers '
            f'{min(regs, default=0)}-{max(regs, default=0)}, spill stores '
            f'{sum(spills)} bytes in all')
    lib_dir = _build._build_dir(_build._nvcc())
    for source, kernels in WGMMA_KERNELS.items():
        counts = hgmma_counts(lib_dir / f'lib{source}.so', kernels)
        log(f'[build] {source}: HGMMA instructions per kernel {counts}')
        for fn, n in counts.items():
            if n <= 0:
                raise AssertionError(f'build: {fn} in lib{source}.so holds '
                                     f'no HGMMA instruction')


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def _case_list():
    """(cases, add): `add(kernel, name, dtype, run, plain, lib, moved, ops,
    ...)` appends one kernel check to `cases`, its bound from the bytes
    moved and the operations at the peak rate of `dtype`'s arithmetic."""
    cases = []

    def add(kernel, name, dtype, run, plain, lib, moved, ops, rep=False,
            zero_rows=None, zero_base=None, yardstick=None, cold=False):
        b_ms, by = bound_ms(moved, ops, dtype)
        cases.append(dict(kernel=kernel, name=name, dtype=dtype, run=run,
                          plain=plain, lib=lib, bound_ms=b_ms, bound_by=by,
                          rep=rep, zero_rows=zero_rows, zero_base=zero_base,
                          yardstick=yardstick, cold=cold))
    return cases, add


def kernel_cases() -> list:
    """Every kernel check of the serving and training paths: the kernel's
    wrapper, its plain version and the one PyTorch call computing the same
    function (or None) as closures over inputs made on the card from a
    seed, at the paths' shapes, with the bytes and operations the work
    needs. `rep` marks the case each kernel's JSON entry reports;
    `zero_rows` rows whose output must equal `zero_base` bit for bit;
    `yardstick` a (label, call) of PyTorch that is timed beside the kernel
    though it is not one call of the same function; `cold` a case also
    timed with L2 flushed."""
    from paddle_tpu_torch.ops import kernels as K
    F = torch.nn.functional
    gen = torch.Generator(device=DEV).manual_seed(0)
    cases, add = _case_list()

    # flash attention: prefill shapes (buckets 8 .. 1024), causal, D = 128
    for dtype in (torch.float32, torch.bfloat16):
        for s, hkv in ((8, 32), (100, 32), (512, 32), (1024, 32),
                       (100, 8), (512, 8)):
            q = _randn((1, s, 32, 128), dtype, gen)
            k = _randn((1, s, hkv, 128), dtype, gen)
            v = _randn((1, s, hkv, 128), dtype, gen)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            add('flash_attention_fwd',
                f'flash {str(dtype)[6:]} S={s} H=32 HKV={hkv}', dtype,
                lambda q=q, k=k, v=v: K.flash_attention_fwd(q, k, v,
                                                            causal=True),
                lambda q=q, k=k, v=v: K.attention_reference(q, k, v,
                                                            causal=True),
                lambda qt=qt, kt=kt, vt=vt, g=hkv != 32:
                    F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True,
                                                   enable_gqa=g),
                nbytes(q, k, v, q), 4 * 128 * 32 * (s * (s + 1) // 2),
                rep=dtype == torch.bfloat16 and s == 1024 and hkv == 32)

    # paged attention: decode shapes, 8 slots, context up to 1024, ps 16
    n, h, ps, p = 8, 32, 16, 64
    num_pages = n * p + 1
    table = (torch.randperm(num_pages - 1, generator=gen, device=DEV)[:n * p]
             + 1).to(torch.int32).reshape(n, p).contiguous()
    lengths = torch.tensor([1024, 1000, 777, 513, 256, 100, 17, 1],
                           dtype=torch.int32, device=DEV)
    live_rows = int(lengths.sum())
    for dtype, hkv, quant in ((torch.float32, 32, False),
                              (torch.bfloat16, 32, False),
                              (torch.float32, 8, False),
                              (torch.bfloat16, 8, False),
                              (torch.float32, 32, True),
                              (torch.bfloat16, 8, True)):
        q = _randn((n, h, 128), dtype, gen)
        shape = (num_pages, ps, hkv, 128)
        if quant:
            kp = torch.randint(-127, 128, shape, generator=gen, device=DEV,
                               dtype=torch.int8)
            vp = torch.randint(-127, 128, shape, generator=gen, device=DEV,
                               dtype=torch.int8)
            ks = torch.rand((num_pages, hkv), generator=gen,
                            device=DEV) / 127 + 1e-3
            vs = torch.rand((num_pages, hkv), generator=gen,
                            device=DEV) / 127 + 1e-3
        else:
            kp, vp = _randn(shape, dtype, gen), _randn(shape, dtype, gen)
            ks = vs = None
        args = (q, kp, vp, table, lengths)
        row_bytes = hkv * 128 * kp.element_size() * 2
        add('paged_attention',
            f'paged {str(dtype)[6:]} N=8 H=32 HKV={hkv} ctx<=1024'
            + (' int8 pages' if quant else ''), dtype,
            lambda a=args, ks=ks, vs=vs: K.paged_attention(
                *a, k_scales=ks, v_scales=vs),
            lambda a=args, ks=ks, vs=vs: K.paged_attention_reference(
                *a, k_scales=ks, v_scales=vs),
            None,
            nbytes(q, q, table, lengths) + live_rows * row_bytes
            + (2 * n * p * hkv * 4 if quant else 0),
            4 * 128 * h * live_rows,
            rep=dtype == torch.bfloat16 and hkv == 32 and not quant)

    # RMSNorm: decode (8 rows), prefill (1024 rows) and a training batch
    # (2 x 2048 rows), width 4096
    for dtype in (torch.float32, torch.bfloat16):
        for r in (8, 1024, TRAIN_BATCH * TRAIN_SEQ):
            x = _randn((r, 4096), dtype, gen)
            w = (1 + 0.1 * torch.randn(4096, generator=gen,
                                       device=DEV)).to(dtype)
            add('rms_norm', f'rms_norm {str(dtype)[6:]} rows={r} width=4096',
                dtype,
                lambda x=x, w=w: K.rms_norm(x, w, 1e-6),
                lambda x=x, w=w: K.rms_norm_reference(x, w, 1e-6),
                lambda x=x, w=w: F.rms_norm(x, (4096,), w, 1e-6),
                nbytes(x, x, w), 4 * x.numel(),
                rep=dtype == torch.bfloat16 and r == 1024)
    _training_cases(add, gen)
    _adapter_cases(add, gen)
    return cases


def _training_cases(add, gen) -> None:
    """The training path's kernels: flash forward with its LSE and the
    two backward kernels at the training shape (B=2, S=2048, H=32,
    causal), plus a GQA and a ragged case; the CE forward and backward
    at [4094, 32000] with ignored rows."""
    from paddle_tpu_torch.ops import kernels as K
    F = torch.nn.functional
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, hkv in ((TRAIN_BATCH, TRAIN_SEQ, 32), (1, 1024, 8),
                          (1, 1000, 32)):
            tag = f'{str(dtype)[6:]} B={b} S={s} H=32 HKV={hkv} causal'
            rep = dtype == torch.bfloat16 and s == TRAIN_SEQ
            q = _randn((b, s, 32, 128), dtype, gen)
            k = _randn((b, s, hkv, 128), dtype, gen)
            v = _randn((b, s, hkv, 128), dtype, gen)
            dout = _randn((b, s, 32, 128), dtype, gen)
            out, lse = K.flash_attention_fwd(q, k, v, True, return_lse=True)
            _, delta = K.attention_bwd_dq_reference(q, k, v, out, lse, dout,
                                                    True)
            pairs = b * 32 * live_pairs(s, s, True)
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=hkv != 32)
            dout_t = dout.transpose(1, 2)

            def sdpa_bwd(o=sdpa_out, ins=(qt, kt, vt), g=dout_t):
                return torch.autograd.grad(o, ins, g, retain_graph=True)

            add('flash_attention_fwd', f'flash fwd+lse {tag}', dtype,
                lambda q=q, k=k, v=v: K.flash_attention_fwd(
                    q, k, v, True, return_lse=True),
                lambda q=q, k=k, v=v: K.attention_reference(
                    q, k, v, causal=True, return_lse=True),
                lambda qt=qt, kt=kt, vt=vt, g=hkv != 32:
                    F.scaled_dot_product_attention(
                        qt.detach(), kt.detach(), vt.detach(),
                        is_causal=True, enable_gqa=g),
                nbytes(q, k, v, q, lse), 2 * 2 * 128 * pairs)
            add('flash_attention_bwd_dq', f'flash bwd dq {tag}', dtype,
                lambda a=(q, k, v, out, lse, dout):
                    K.flash_attention_bwd_dq(*a, True),
                lambda a=(q, k, v, out, lse, dout):
                    K.attention_bwd_dq_reference(*a, True),
                sdpa_bwd,
                nbytes(q, k, v, out, dout, lse, q, delta),
                3 * 2 * 128 * pairs, rep=rep)
            add('flash_attention_bwd_dkv', f'flash bwd dk/dv {tag}', dtype,
                lambda a=(q, k, v, lse, delta, dout):
                    K.flash_attention_bwd_dkv(*a, True),
                lambda a=(q, k, v, lse, delta, dout):
                    K.attention_bwd_dkv_reference(*a, True),
                sdpa_bwd,
                nbytes(q, k, v, dout, lse, delta, k, v),
                4 * 2 * 128 * pairs, rep=rep)

    n, vocab = TRAIN_BATCH * (TRAIN_SEQ - 1), 32000
    for dtype in (torch.float32, torch.bfloat16):
        x = (3 * torch.randn((n, vocab), generator=gen, device=DEV)).to(dtype)
        lab = torch.randint(0, vocab, (n,), generator=gen, device=DEV,
                            dtype=torch.int32)
        lab[::7] = 0                        # ignored rows: safe label 0 ...
        # an O(1) upstream gradient of either sign, so that both the
        # softmax and the one-hot term of dlogits stand far above the limit
        g = torch.randn((n,), generator=gen, device=DEV)
        g[::7] = 0.0                        # ... and no gradient
        _, lse = K.softmax_cross_entropy_fwd_reference(x, lab)
        xg = x.detach().requires_grad_()
        lab64 = lab.long()
        lib_nll = F.cross_entropy(xg, lab64, reduction='none')
        tag = f'{str(dtype)[6:]} N={n} V={vocab}'
        rep = dtype == torch.bfloat16
        add('softmax_ce_fwd', f'ce fwd {tag}', dtype,
            lambda x=x, lab=lab: K.softmax_cross_entropy_fwd(x, lab),
            lambda x=x, lab=lab: K.softmax_cross_entropy_fwd_reference(x, lab),
            lambda x=x, lab=lab64: F.cross_entropy(x, lab, reduction='none'),
            nbytes(x, lab, lse, lse), 4 * x.numel(), rep=rep)
        add('softmax_ce_bwd', f'ce bwd {tag}', dtype,
            lambda a=(x, lab, lse, g): K.softmax_cross_entropy_bwd(*a),
            lambda a=(x, lab, lse, g):
                K.softmax_cross_entropy_bwd_reference(*a),
            lambda o=lib_nll, x=xg, g=g:
                torch.autograd.grad(o, x, g, retain_graph=True),
            nbytes(x, lab, lse, g, x), 4 * x.numel(), rep=rep)


ADAPTER_COMPOSITE = ('composite of several PyTorch calls (index_select x2, '
                     'bmm x2, casts; not one library call)')


def adapter_composite(x, a_bank, b_bank, rows, scale):
    """The adapter delta from several PyTorch calls (two index_selects, two
    bmms, casts and the scale): the nearest library yardstick, since no one
    PyTorch call computes it. Timed only; the port never calls it."""
    idx = rows.long()
    h1 = torch.bmm(x.float(), a_bank.index_select(0, idx).float())
    out = torch.bmm(h1, b_bank.index_select(0, idx).float())
    return (out * scale.index_select(0, idx)[:, None, None]).to(x.dtype)


def _adapter_cases(add, gen) -> None:
    """adapter_matmul (the delta) and adapter_matmul_add (y + delta, what
    the serve path's hook calls) at the serve path's shapes: decode (8
    slots, T=1) and prefill (one row, T=1024) at H = O = 4096 and rank 8,
    with rows mixing slot 0 and repeated slots, x and the bank each in f32
    and bf16; and a ragged case (H=4000, O=1000, rank 16). y is of the
    delta's scale, so that an add that drops or doubles the delta fails.
    The bytes count the factors and scale of each distinct adapted slot
    the rows use, once (slot 0's rows read none), and x, rows and the
    output of every row. The decode cases are also timed with L2 flushed."""
    from paddle_tpu_torch.ops import kernels as K
    slots = 5
    for b, t, h, r, o, rows in ((8, 1, 4096, 8, 4096, [0, 1, 2, 1, 0, 3, 3, 1]),
                                (1, 1024, 4096, 8, 4096, [3]),
                                (6, 5, 4000, 16, 1000, [0, 2, 2, 1, 0, 4])):
        for x_dtype in (torch.float32, torch.bfloat16):
            for w_dtype in (torch.float32, torch.bfloat16):
                x = _randn((b, t, h), x_dtype, gen)
                a = (0.05 * torch.randn((slots, h, r), generator=gen,
                                        device=DEV)).to(w_dtype)
                bb = (0.05 * torch.randn((slots, r, o), generator=gen,
                                         device=DEV)).to(w_dtype)
                a[0], bb[0] = 0, 0
                scale = torch.rand(slots, generator=gen, device=DEV) + 0.5
                scale[0] = 0.0
                y = (0.5 * torch.randn((b, t, o), generator=gen,
                                       device=DEV)).to(x_dtype)
                rows_t = torch.tensor(rows, dtype=torch.int32, device=DEV)
                used = len(set(rows) - {0})   # slot 0 reads no factors
                moved = (nbytes(x, rows_t) + b * t * o * x.element_size()
                         + used * ((h * r + r * o) * a.element_size() + 4))
                args = (x, a, bb, rows_t, scale)
                tag = (f'x {str(x_dtype)[6:]} bank {str(w_dtype)[6:]} '
                       f'B={b} T={t} H={h} R={r} O={o}')
                dtype = (torch.bfloat16 if torch.float32 not in
                         (x_dtype, w_dtype) else torch.float32)
                decode_rep = (t == 1 and x_dtype == torch.bfloat16
                              and w_dtype == torch.float32)
                add('adapter_matmul', f'adapter {tag}', dtype,
                    lambda a=args: K.adapter_matmul(*a),
                    lambda a=args: K.adapter_matmul_reference(*a), None,
                    moved, 2 * b * t * r * (h + o), zero_rows=rows_t == 0,
                    zero_base=torch.zeros_like(y),
                    yardstick=(ADAPTER_COMPOSITE,
                               lambda a=args: adapter_composite(*a)),
                    cold=t == 1)
                add('adapter_matmul', f'adapter + y {tag}', dtype,
                    lambda a=args, y=y: K.adapter_matmul_add(y, *a),
                    lambda a=args, y=y: K.adapter_matmul_add_reference(y, *a),
                    None, moved + nbytes(y), 2 * b * t * r * (h + o),
                    rep=decode_rep, zero_rows=rows_t == 0, zero_base=y,
                    yardstick=(ADAPTER_COMPOSITE, lambda a=args, y=y:
                               y + adapter_composite(*a)),
                    cold=t == 1)


FOREACH_NORM = ('torch._foreach_norm, then the sum of the squared norms '
                '(not the same function: a norm per tensor; library_ms null)')
FUSED_ADAMW = ('torch.optim.AdamW(fused=True) on the same tensors (not the '
               'same function: epsilon inside the bias correction, no clip '
               'scale; library_ms null)')


def rung_tensor_shapes(cfg) -> list:
    """[(name, shape)] of one decoder layer of `cfg` plus lm_head, named
    and laid out as the port's Llama holds them (Linear weights [in, out])."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    q, kv = cfg.num_attention_heads * cfg.head_dim, \
        cfg.num_key_value_heads * cfg.head_dim
    return [('self_attn.q_proj.weight', (h, q)),
            ('self_attn.k_proj.weight', (h, kv)),
            ('self_attn.v_proj.weight', (h, kv)),
            ('self_attn.o_proj.weight', (q, h)),
            ('mlp.gate_proj.weight', (h, inter)),
            ('mlp.up_proj.weight', (h, inter)),
            ('mlp.down_proj.weight', (inter, h)),
            ('input_layernorm.weight', (h,)),
            ('post_attention_layernorm.weight', (h,)),
            ('lm_head.weight', (h, cfg.vocab_size))]


def optimizer_cases() -> list:
    """The multi-tensor kernels at the training rung's tensors: one
    decoder layer of Llama-2-7B width plus lm_head (333.5 M elements),
    bf16 grads whose global norm (~180) puts phase 5b's clip of 1.0 at a
    scale below 1. The sum of squares; and one AdamW step of phase 5b's
    settings (step 10, lr 3e-4, decay 0.1 except on norms) in four
    variants: bf16 params and moments under the clip (the rung's, the
    JSON row), the same with amsgrad and no clip, and bf16 params with
    fp32 masters and moments, with the clip and with amsgrad. The kernel
    and the plain version each update their own copy of the same state
    in place and return it; every output is compared."""
    from paddle_tpu_torch.nlp import LlamaConfig
    from paddle_tpu_torch.ops import kernels as K
    shapes = rung_tensor_shapes(LlamaConfig.llama2_7b())
    gen = torch.Generator(device=DEV).manual_seed(8)
    cases, add = _case_list()
    grads = [(0.01 * torch.randn(s, generator=gen, device=DEV)).bfloat16()
             for _, s in shapes]
    n = sum(g.numel() for g in grads)
    add('multi_tensor_sumsq', f'sumsq bf16 grads, one layer + lm_head '
        f'({n / 1e6:.1f} M)', torch.float32,
        lambda: K.multi_tensor_sumsq(grads),
        lambda: K.multi_tensor_sumsq_reference(grads), None,
        nbytes(*grads) + 4, 2 * n, rep=True,
        yardstick=(FOREACH_NORM, lambda: torch.stack(
            torch._foreach_norm(grads)).square().sum()))
    clip = torch.clamp_max(1.0 / K.multi_tensor_sumsq(grads).sqrt()
                           .clamp_min(1e-12), 1.0)
    if not float(clip) < 1.0:
        raise AssertionError(f'optimizer cases: clip scale {float(clip)}')
    lr, t = np.float32(PRETRAIN_PEAK_LR), np.float32(10)
    lr_t = lr * np.sqrt(np.float32(1) - np.power(np.float32(0.95), t)) \
        / (np.float32(1) - np.power(np.float32(0.9), t))
    kw = dict(lr_t=float(lr_t), beta1=0.9, beta2=0.95, epsilon=1e-5,
              decay=[0.0 if 'norm' in name else float(lr * np.float32(0.1))
                     for name, _ in shapes], decay_mode='decoupled')

    def make_state(m_dtype, master, ams):
        """(params, m, v, masters, vmax) as after some steps, the same
        values at every call."""
        g = torch.Generator(device=DEV).manual_seed(9)

        def rand(shape, dtype, scale, positive=False):
            x = scale * torch.randn(shape, generator=g, device=DEV)
            return (x.abs() if positive else x).to(dtype)

        ps = [rand(s, torch.bfloat16, 0.02) for _, s in shapes]
        return (ps, [rand(s, m_dtype, 1e-3) for _, s in shapes],
                [rand(s, m_dtype, 1e-4, True) for _, s in shapes],
                [p.float() for p in ps] if master else [None] * len(ps),
                [rand(s, m_dtype, 1e-4, True) for _, s in shapes] if ams
                else None)

    def step(fn, state, scale):
        ps, m, v, masters, vmax = state
        fn(ps, grads, m, v, masters, vmax or [None] * len(ps),
           clip_scale=scale, **kw)
        return tuple(x for ts in (ps, m, v, masters, vmax or ())
                     for x in ts if x is not None)

    for m_dtype, master, ams in ((torch.bfloat16, False, False),
                                 (torch.bfloat16, False, True),
                                 (torch.float32, True, False),
                                 (torch.float32, True, True)):
        scale = None if ams else clip
        mine, ref = (make_state(m_dtype, master, ams) for _ in range(2))
        moved = (2 * nbytes(*(x for ts in mine[1:] if ts for x in ts
                              if x is not None))
                 + nbytes(*mine[0]) * (1 if master else 2) + nbytes(*grads)
                 + (4 if scale is not None else 0))
        tag = (f'adam bf16 params, {str(m_dtype)[6:]} moments'
               + (', fp32 masters' if master else '')
               + (', amsgrad' if ams else ', global clip scale < 1')
               + f', one layer + lm_head ({n / 1e6:.1f} M)')
        rep = m_dtype == torch.bfloat16 and not ams
        yard = None
        if rep:
            held = [torch.nn.Parameter(p.clone()) for p in mine[0]]
            for p, gr in zip(held, grads):
                p.grad = gr
            fused = torch.optim.AdamW(held, lr=PRETRAIN_PEAK_LR,
                                      betas=(0.9, 0.95), eps=1e-5,
                                      weight_decay=0.1, fused=True)
            yard = (FUSED_ADAMW, fused.step)
        add('multi_tensor_adam', tag, torch.float32,
            lambda st=mine, sc=scale: step(K.multi_tensor_adam, st, sc),
            lambda st=ref, sc=scale: step(K.multi_tensor_adam_reference,
                                          st, sc),
            None, moved, 15 * n, rep=rep, yardstick=yard)
    return cases


def check_kernels(cases) -> None:
    """Hold every kernel against its plain version, and adapter rows on
    slot 0 to an exact zero delta (y bit for bit with the add; fatal on a
    miss)."""
    for c in cases:
        got = c['run']()
        r = compare(c['name'], got, c['plain']())
        if c['zero_rows'] is not None:
            rows = c['zero_rows']
            if not torch.equal(got[rows], c['zero_base'][rows]):
                raise AssertionError(f'{c["name"]}: rows on slot 0 are not '
                                     f'left unchanged (delta not exactly 0)')
            log(f'[kernels] {c["name"]}: {int(rows.sum())} rows on slot 0 '
                f'bit-equal to ' + ('y' if c['zero_base'].any()
                                    else 'zero'))
        c['max_abs_err'] = r['max_abs_err']
        log(f'[kernels] {c["name"]}: max_abs_err {r["max_abs_err"]:.3e} '
            f'rel_max {r["rel_max"]:.3e} rel_norm {r["rel_norm"]:.3e}')


def time_kernels(cases) -> dict:
    """Time every case; returns {kernel: its JSON entry's numbers}. Runs
    last: once torch.profiler has run in a process, every later launch
    costs the host more, so the serve phase and the unprofiled decode
    round are measured before any profiler use."""
    rows = {}
    # written before each cold call: more than the H100's 50 MB of L2
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    for c in cases:
        ms, ev = timed(c['run'])
        plain, _ = timed(c['plain'])
        lib = timed(c['lib'])[0] if c['lib'] is not None else None
        log(f'[timing] {c["name"]}: kernel {ms:.4f} ms (events {ev:.4f})  '
            f'plain {plain:.4f} ms  library '
            + (f'{lib:.4f} ms' if lib is not None else 'none')
            + f'  bound {c["bound_ms"]:.4f} ms ({c["bound_by"]})')
        if c['yardstick'] is not None:
            label, call = c['yardstick']
            log(f'[timing]   {c["name"]}: {label} {timed(call)[0]:.4f} ms')
        if c['cold']:
            cold = queued_ms(c['run'], before=flush.zero_)
            log(f'[timing]   {c["name"]}: kernel with L2 flushed before '
                f'each call ' + (f'{cold:.4f} ms' if cold is not None else
                                 'not measured (the host fell behind)'))
        if c['rep']:
            rows[c['kernel']] = dict(
                shape=c['name'], max_abs_err=c['max_abs_err'], ms=ms,
                plain_ms=plain, bound_ms=c['bound_ms'],
                bound_by=c['bound_by'], library_ms=lib)
    return rows


# ---------------------------------------------------------------------------
# phase 3: paged engine against a no-cache full recompute
# ---------------------------------------------------------------------------

def check_consistency(cfg):
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.serving import InferenceEngine, SamplingParams
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    torch.backends.cudnn.allow_tf32 = False
    model = LlamaForCausalLM(cfg, device=DEV, dtype='float32',
                             generator=ptt.generator(0, DEV))
    eng = InferenceEngine(model, num_slots=8, max_length=1024,
                          decode_block=8, kv_page_size=16)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(3, cfg.vocab_size, (s,)).tolist()
               for s in (5, 16, 37, 130)]
    n_new = 16
    handles = eng.generate_many(
        prompts, SamplingParams(max_new_tokens=n_new, eos_token_id=-1))
    with torch.inference_mode():
        for h, prompt in zip(handles, prompts):
            seq = list(prompt)
            for _ in range(n_new):
                logits = model(torch.tensor([seq], device=DEV))
                seq.append(int(logits[0, -1].argmax()))
            ref = seq[len(prompt):]
            if h.tokens != ref:
                raise AssertionError(
                    f'consistency: prompt len {len(prompt)}: engine '
                    f'{h.tokens} != full recompute {ref}')
    log(f'[consistency] 2 layers f32, {len(prompts)} requests x {n_new} '
        f'greedy tokens: paged engine == no-cache full recompute')
    del eng, model
    torch.cuda.empty_cache()


def adapter_bank(model, n_adapters: int, capacity: int, scale: float = 0.02):
    """An f32 rank-8 bank on Llama's q/k/v/o projections holding
    ad0..ad{n-1}, with factors `make_adapter_factors(bank, seed=i + 1)`."""
    from paddle_tpu_torch.serving import AdapterBank, make_adapter_factors
    bank = AdapterBank(model, capacity=capacity, rank=8,
                       targets=ADAPTER_TARGETS, dtype='float32')
    for i in range(n_adapters):
        bank.load(f'ad{i}', make_adapter_factors(bank, seed=i + 1,
                                                 scale=scale))
    return bank


def check_adapter_consistency(cfg):
    """The tests/test_adapters.py acceptance bar on the card, at 2
    layers of Llama-2-7B width in f32, greedy: in a mixed wave
    [base, ad0, ad1, ad0] each request gets the tokens it gets served
    alone under its adapter (fresh engine and bank), base requests those
    of a bank-less engine, and the adapters change some tokens. Factors
    at scale 0.05, large enough to move greedy tokens at this depth."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.serving import InferenceEngine, SamplingParams
    model = LlamaForCausalLM(cfg, device=DEV, dtype='float32',
                             generator=ptt.generator(7, DEV))
    rng = np.random.RandomState(4)
    prompts = [rng.randint(3, cfg.vocab_size, (s,)).tolist()
               for s in (5, 16, 37, 130)]
    ids = [None, 'ad0', 'ad1', 'ad0']
    sp = SamplingParams(max_new_tokens=16, eos_token_id=-1)

    def tokens(adapter_ids, banked=True):
        eng = InferenceEngine(
            model, num_slots=8, max_length=1024, decode_block=8,
            kv_page_size=16,
            adapter_bank=adapter_bank(model, 2, 2, 0.05) if banked else None)
        return [h.tokens for h in eng.generate_many(prompts, sp,
                                                    adapter_ids=adapter_ids)]

    base = tokens(None, banked=False)
    alone = {aid: tokens(aid) for aid in ('ad0', 'ad1')}
    mixed = tokens(ids)
    for j, aid in enumerate(ids):
        want = base[j] if aid is None else alone[aid][j]
        if mixed[j] != want:
            raise AssertionError(f'adapter consistency: request {j} under '
                                 f'{aid}: mixed wave {mixed[j]} != '
                                 f'{"bank-less" if aid is None else "alone"}'
                                 f' {want}')
    changed = sum(alone[aid][j] != base[j] for aid in alone
                  for j in range(len(prompts)))
    if not changed:
        raise AssertionError('adapter consistency: no adapter changed a '
                             'token')
    log(f'[adapter-consistency] 2 layers f32, mixed wave {ids} x 16 greedy '
        f'tokens == each adapter alone, base == bank-less engine; '
        f'{changed} of {2 * len(prompts)} adapted requests differ from base')
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: training on the card against training on the CPU
# ---------------------------------------------------------------------------

def next_token_loss(logits, labels):
    """The JAX bench's loss (bench.py:_run_config): predict token t+1
    from positions <= t."""
    from paddle_tpu_torch.nn import functional as PF
    vocab = logits.shape[-1]
    return PF.cross_entropy(logits[:, :-1].reshape(-1, vocab),
                            labels[:, 1:].reshape(-1))


def _loss_and_grads(model, ids):
    x = torch.as_tensor(ids, device=model.device)
    loss = next_token_loss(model(x), x)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return loss.item(), grads


def _grad_errors(got: dict, want: dict) -> dict:
    """{name: |got - want| / |want|} (Frobenius norms, on got's device)."""
    out = {}
    for name, w in want.items():
        w = w.to(got[name].device, torch.float64)
        out[name] = float((got[name].double() - w).norm() / w.norm())
    return out


def check_train_consistency(cfg) -> None:
    """One forward + backward of the next-token loss at 2 layers of
    Llama-2-7B width in f32 (TF32 off): on the card (kernels) and on the
    CPU (plain versions) with the same weights, then on the card with
    use_recompute=True. Fatal if the losses or any gradient disagree."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEV, dtype='float32',
                             generator=ptt.generator(5, DEV))
    on_cpu = LlamaForCausalLM(cfg, device='cpu', dtype='float32')
    on_cpu.load_state_dict({k: v.cpu() for k, v in
                            model.state_dict().items()})
    ids = np.random.RandomState(3).randint(0, cfg.vocab_size, (1, 128))
    loss_card, g_card = _loss_and_grads(model, ids)
    loss_cpu, g_cpu = _loss_and_grads(on_cpu, ids)
    del on_cpu
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    errs = _grad_errors(g_card, g_cpu)
    worst = max(errs, key=errs.get)
    log(f'[train-consistency] 2 layers f32, 1 x 128 tokens: loss card '
        f'{loss_card:.6f} cpu {loss_cpu:.6f} (rel {rel:.2e}, limit '
        f'{TRAIN_LOSS_RTOL}); worst gradient rel error {errs[worst]:.2e} '
        f'({worst}; limit {TRAIN_GRAD_RTOL})')
    if rel > TRAIN_LOSS_RTOL or errs[worst] > TRAIN_GRAD_RTOL:
        raise AssertionError('train consistency: card and CPU disagree')
    model.config.use_recompute = True
    loss_remat, g_remat = _loss_and_grads(model, ids)
    errs = _grad_errors(g_remat, g_card)
    worst = max(errs, key=errs.get)
    log(f'[train-consistency] use_recompute=True on the card: loss '
        f'{loss_remat:.6f}, worst gradient rel error vs no recompute '
        f'{errs[worst]:.2e} ({worst}) in {time.perf_counter() - t0:.1f} s')
    if abs(loss_remat - loss_card) > TRAIN_LOSS_RTOL * abs(loss_card) \
            or errs[worst] > TRAIN_GRAD_RTOL:
        raise AssertionError('train consistency: recompute changes the '
                             'gradients')
    del model, g_card, g_cpu, g_remat
    torch.cuda.empty_cache()


def pretraining_optimizer(named, peak_lr: float, warmup: int, t_max: int,
                          start_lr: float, **kw):
    """(AdamW, its scheduler): Llama 2's pretraining optimizer over the
    (name, parameter) pairs `named`: betas 0.9 / 0.95, epsilon 1e-5,
    decoupled decay 0.1 on every parameter whose name holds no `norm`
    (as PaddleNLP's Trainer exempts norms), ClipGradByGlobalNorm(1.0),
    and LinearWarmup from start_lr to peak_lr over `warmup` steps into a
    cosine to peak_lr / 10 over t_max steps."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)
    sched = LinearWarmup(CosineAnnealingDecay(peak_lr, T_max=t_max,
                                              eta_min=peak_lr / 10),
                         warmup_steps=warmup, start_lr=start_lr,
                         end_lr=peak_lr)
    opt = AdamW(learning_rate=sched, beta1=0.9, beta2=0.95, epsilon=1e-5,
                weight_decay=0.1, parameters=named,
                apply_decay_param_fun=lambda name: 'norm' not in name,
                grad_clip=ClipGradByGlobalNorm(1.0), **kw)
    return opt, sched


def check_train_steps(cfg) -> None:
    """Two `TrainStep`s under Llama 2's optimizer (a 2-step warm-up from
    1e-4 into a cosine, so both steps move) at 2 layers of Llama-2-7B
    width in f32 (TF32 off), on the card (kernels, the update through the
    multi-tensor sum of squares and Adam) and on the CPU (plain versions),
    from the same weights on the same two batches. Fatal unless each
    step's loss agrees to TRAIN_LOSS_RTOL and each parameter's update over
    the two steps to a relative norm error of TRAIN_GRAD_RTOL (epsilon
    1e-5 damps the step of an element whose grad is near 0, where the two
    devices' grads differ most)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels as K
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEV, dtype='float32',
                             generator=ptt.generator(6, DEV))
    on_cpu = LlamaForCausalLM(cfg, device='cpu', dtype='float32')
    on_cpu.load_state_dict({k: v.cpu() for k, v in
                            model.state_dict().items()})
    start = {k: v.clone() for k, v in on_cpu.state_dict().items()}
    rng = np.random.RandomState(9)
    batches = [rng.randint(0, cfg.vocab_size, (1, 128)) for _ in range(2)]
    losses, lrs = {}, {}
    K.reset_launch_counts()
    for tag, m in (('card', model), ('cpu', on_cpu)):
        opt, sched = pretraining_optimizer(m.named_parameters(), 3e-4, 2,
                                           1000, start_lr=1e-4)
        step = TrainStep(m, next_token_loss, opt)
        losses[tag], lrs[tag] = [], []
        for ids in batches:
            lrs[tag].append(opt.get_lr())
            losses[tag].append(float(step(ids, ids)))
            sched.step()
        if tag == 'card':
            launches = {k: K.LAUNCHES[k] for k in ('multi_tensor_adam',
                                                   'multi_tensor_sumsq')}
        del opt, step
    if min(launches.values()) <= 0:
        raise AssertionError(f'train steps: the card skipped a kernel: '
                             f'{launches}')
    rel = [abs(a - b) / abs(b) for a, b in zip(losses['card'], losses['cpu'])]
    got = {k: v.cpu() - start[k] for k, v in model.state_dict().items()}
    want = {k: v - start[k] for k, v in on_cpu.state_dict().items()}
    errs = _grad_errors(got, want)
    worst = max(errs, key=errs.get)
    log(f'[train-steps] 2 layers f32, 2 TrainSteps of Llama 2\'s AdamW '
        f'(lr {lrs["card"]}, clip 1.0, decay 0.1 but norms): losses card '
        f'{losses["card"]} cpu {losses["cpu"]} (rel {max(rel):.2e}, limit '
        f'{TRAIN_LOSS_RTOL}); worst update rel error {errs[worst]:.2e} '
        f'({worst}; limit {TRAIN_GRAD_RTOL}); kernel launches on the card '
        f'{launches}; {time.perf_counter() - t0:.1f} s')
    if lrs['card'] != lrs['cpu'] or max(rel) > TRAIN_LOSS_RTOL \
            or errs[worst] > TRAIN_GRAD_RTOL:
        raise AssertionError('train steps: card and CPU disagree')
    del model, on_cpu, got, want, start
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: train the llama2_7b_shape_8L rung
# ---------------------------------------------------------------------------

def train_flops_per_step(cfg, batch: int, seq: int) -> float:
    """bench.py:169-180: 3x the forward's weight-matmul and attention
    flops (recompute not counted)."""
    h, layers = cfg.hidden_size, cfg.num_hidden_layers
    qkvo = h * (cfg.num_attention_heads * cfg.head_dim) * 2 \
        + h * (cfg.num_key_value_heads * cfg.head_dim) * 2
    n_matmul = layers * (qkvo + 3 * h * cfg.intermediate_size) \
        + h * cfg.vocab_size
    fwd = 2 * n_matmul * batch * seq + layers * 4 * batch * seq * seq * h
    return 3 * fwd


def train(cfg) -> dict:
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.optimizer import AdamW
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEV, dtype='bfloat16',
                             generator=ptt.generator(0, DEV))
    n_params = sum(p.numel() for p in model.parameters())
    big = n_params > 1e9            # bench.py: bf16 moments above 1e9
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                multi_precision=not big,
                moment_dtype='bfloat16' if big else None)
    step = TrainStep(model, next_token_loss, opt)
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
               for _ in range(4)]
    log(f'[train] Llama {cfg.num_hidden_layers} layers x '
        f'{cfg.hidden_size}, {n_params / 1e9:.3f} B params bf16, '
        f'recompute {cfg.use_recompute}, AdamW lr {TRAIN_LR} moments '
        f'{"bf16" if big else "fp32"}, batch {TRAIN_BATCH} x {TRAIN_SEQ}; '
        f'built in {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP):
        loss = step(batches[i % 4], batches[i % 4])
    warm = float(loss)
    log(f'[train] {TRAIN_WARMUP} warm-up steps in '
        f'{time.perf_counter() - t0:.2f} s, loss {warm:.4f}')
    torch.cuda.reset_peak_memory_stats()

    K.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        loss = step(batches[i % 4], batches[i % 4])
    final = float(loss)             # waits for the last step
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    missing = [k for k in TRAIN_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f'train: kernels never launched on the main '
                             f'path: {missing}')
    if not np.isfinite(final):
        raise AssertionError(f'train: loss {final} is not finite')
    flops = train_flops_per_step(cfg, TRAIN_BATCH, TRAIN_SEQ)
    res = {'step_s': dt, 'tokens_per_s': TRAIN_BATCH * TRAIN_SEQ / dt,
           'mfu': flops / dt / PEAK_OPS_PER_S[torch.bfloat16],
           'loss': final, 'peak_mem_gb': (peak - base) / 1e9,
           'peak_mem_raw_gb': peak / 1e9, 'launches': launches,
           'params_b': n_params / 1e9}
    log(f'[train] {TRAIN_STEPS} steps: {dt * 1e3:.1f} ms/step, '
        f'{res["tokens_per_s"]:.0f} tokens/s, MFU {res["mfu"]:.4f} '
        f'(bench.py FLOP count {flops / 1e12:.1f} TFLOP/step vs 989 '
        f'TFLOP/s), loss {final:.4f}, peak device memory '
        f'{res["peak_mem_gb"]:.2f} GB above the {base / 1e9:.2f} GB held '
        f'before the phase ({res["peak_mem_raw_gb"]:.2f} GB in all)')
    log(f'[train] kernel launches on the timed steps: {launches}')

    # a fifth batch, never trained on: its first loss is held out. The
    # tokens are uniform and independent, so a model that sees no future
    # token cannot beat ln(V) on them (a causal-mask leak would)
    fixed = rng.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
    losses = [float(step(fixed, fixed)) for _ in range(OVERFIT_STEPS)]
    floor = math.log(cfg.vocab_size) - HELD_OUT_SLACK
    drop = losses[0] - losses[-1]
    log(f'[train] one fixed unseen batch: held-out loss {losses[0]:.4f} '
        f'(required >= ln(V) - {HELD_OUT_SLACK} = {floor:.4f}), then '
        + ' '.join(f'{x:.4f}' for x in losses[1:])
        + f'; drop {drop:.4f} nats (required >= {OVERFIT_MIN_DROP})')
    if not all(np.isfinite(losses)) or losses[0] < floor:
        raise AssertionError(f'train: held-out loss {losses[0]:.4f} below '
                             f'{floor:.4f}: the model sees future tokens')
    if drop < OVERFIT_MIN_DROP:
        raise AssertionError(f'train: the loss on one fixed batch fell by '
                             f'{drop:.4f} < {OVERFIT_MIN_DROP} nats')
    res.update(overfit_losses=losses, step=step, batch=fixed,
               batches=batches, base=base)
    return res


# ---------------------------------------------------------------------------
# phase 5b: the rung under Llama 2's pretraining optimizer
# ---------------------------------------------------------------------------

def pretrain(trained: dict, cfg) -> dict:
    """Phase 5's model and batches under Llama 2's pretraining optimizer
    (`pretraining_optimizer`, bf16 moments as the rung keeps them), phase
    5's optimizer state freed first: 2 warm-up and 6 timed steps, the
    scheduler stepped after each. Each step's lr must be LinearWarmup's
    value after that many scheduler steps, the loss finite, and every
    kernel of PRETRAIN_KERNELS must launch on the timed steps. The peak
    memory is counted above phase 5's base, so the two read alike; the
    optimizer state is freed at the end (phase 7 makes it anew)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import kernels as K
    model = trained['step'].layer
    trained['step'].optimizer._slots.clear()
    torch.cuda.empty_cache()
    opt, sched = pretraining_optimizer(
        model.named_parameters(), PRETRAIN_PEAK_LR, PRETRAIN_WARMUP,
        PRETRAIN_T_MAX, start_lr=0.0, moment_dtype='bfloat16')
    step = TrainStep(model, next_token_loss, opt)
    batches = trained['batches']

    def one(i):
        want = PRETRAIN_PEAK_LR * (i / PRETRAIN_WARMUP)   # LinearWarmup
        if opt.get_lr() != want:
            raise AssertionError(f'pretrain: step {i} lr {opt.get_lr()} != '
                                 f'the schedule\'s {want}')
        loss = step(batches[i % 4], batches[i % 4])
        sched.step()
        return loss

    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP):
        loss = one(i)
    warm = float(loss)
    log(f'[pretrain] {TRAIN_WARMUP} warm-up steps in '
        f'{time.perf_counter() - t0:.2f} s, loss {warm:.4f}')
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS):
        loss = one(i)
    final = float(loss)
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k in PRETRAIN_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f'pretrain: kernels never launched on the main '
                             f'path: {missing}')
    if not np.isfinite(final):
        raise AssertionError(f'pretrain: loss {final} is not finite')
    mfu = train_flops_per_step(cfg, TRAIN_BATCH, TRAIN_SEQ) / dt \
        / PEAK_OPS_PER_S[torch.bfloat16]
    res = {'step_s': dt, 'tokens_per_s': TRAIN_BATCH * TRAIN_SEQ / dt,
           'mfu': mfu, 'loss': final,
           'peak_mem_gb': (peak - trained['base']) / 1e9,
           'launches': launches, 'step': step}
    log(f'[pretrain] Llama 2\'s optimizer (clip 1.0, decay 0.1 but norms, '
        f'lr {PRETRAIN_PEAK_LR} x i / {PRETRAIN_WARMUP} in warm-up, each '
        f'step\'s lr checked), {TRAIN_STEPS} steps: {dt * 1e3:.1f} ms/step '
        f'beside phase 5\'s {trained["step_s"] * 1e3:.1f} (same process), '
        f'{res["tokens_per_s"]:.0f} tokens/s, MFU {mfu:.4f}, loss '
        f'{final:.4f}, peak device memory {res["peak_mem_gb"]:.2f} GB above '
        f'phase 5\'s base (phase 5: {trained["peak_mem_gb"]:.2f})')
    log(f'[pretrain] kernel launches on the timed steps: {launches}')
    opt._slots.clear()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 6: serve Llama-2-7B
# ---------------------------------------------------------------------------

SERVE_LENS = (13, 700, 48, 311, 96, 650, 27, 205, 512, 64, 400, 150)


def _run_serve(eng, prompts, params, adapter_ids, kernels, tag,
               base: int) -> dict:
    """One counted run of the 12 requests on `eng` after a warm-up: one
    short request (a graph engine captures its decode sub-step at its
    first round, and the capture empties the allocator's cache), then
    the same requests for one token each (every prefill bucket's first
    cuBLAS plans, kernel shapes and cached blocks). Each of `kernels`'
    launch counts is read around the counted run (graph replays counted)
    and required to be > 0. Every request must finish with 32 tokens; a
    graph engine must have captured its sub-step once, an eager one
    never. Peak memory is counted above `base` bytes."""
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import FINISHED, SamplingParams
    vocab = eng.model.config.vocab_size
    one = SamplingParams(max_new_tokens=1, eos_token_id=-1)
    eng.generate_many([prompts[0][:8]], one)
    eng.generate_many(prompts, one, adapter_ids=adapter_ids)
    eng.reset_stats()
    torch.cuda.reset_peak_memory_stats()

    K.reset_launch_counts()
    t0 = time.perf_counter()
    handles = eng.generate_many(prompts, params, adapter_ids=adapter_ids)
    wall = time.perf_counter() - t0
    launches = {k: K.LAUNCHES[k] for k in kernels}

    st = eng.stats()
    for h in handles:
        if h.status != FINISHED or len(h.tokens) != 32:
            raise AssertionError(f'{tag}: request {h} did not finish with '
                                 f'32 tokens')
        if not all(0 <= t < vocab for t in h.tokens):
            raise AssertionError(f'{tag}: token out of range in {h.tokens}')
    missing = [k for k, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f'{tag}: kernels never launched on the main '
                             f'path: {missing}')
    want_traces = {'paged_decode_step': 1} if eng._capture_decode else {}
    if st['traces'] != want_traces:
        raise AssertionError(f'{tag}: decode captures {st["traces"]}, want '
                             f'{want_traces}')
    ttft = sorted(h.ttft for h in handles)
    res = {
        'requests': len(handles), 'wall_s': wall,
        'prefills': st['prefills'],
        'prefill_tokens': st['prefill_tokens'],
        'prefill_bucket_tokens': st['prefill_bucket_tokens'],
        'prefill_s': st['prefill_seconds'],
        'prefill_tok_per_s': st['prefill_tokens'] / st['prefill_seconds'],
        'decode_tokens': st['tokens'], 'decode_s': st['decode_seconds'],
        'decode_tok_per_s': st['tokens'] / st['decode_seconds'],
        'decode_rounds': st['decode_rounds'],
        'decode_steps': st['decode_steps'],
        'ttft_mean_s': sum(ttft) / len(ttft), 'ttft_max_s': ttft[-1],
        'ttft_p50_s': ttft[len(ttft) // 2],
        'peak_mem_gb': (torch.cuda.max_memory_allocated() - base) / 1e9,
        'launches': launches, 'tokens': [h.tokens for h in handles],
    }
    log(f'[{tag}] {len(handles)} requests in {wall:.2f} s: prefill '
        f'{res["prefill_tok_per_s"]:.0f} tok/s ({st["prefill_tokens"]} '
        f'prompt tokens in {st["prefill_seconds"]:.3f} s), decode '
        f'{res["decode_tok_per_s"]:.1f} tok/s ({st["tokens"]} tokens in '
        f'{st["decode_seconds"]:.3f} s, {st["decode_rounds"]} rounds), TTFT '
        f'mean {res["ttft_mean_s"]:.3f} s p50 {res["ttft_p50_s"]:.3f} s max '
        f'{res["ttft_max_s"]:.3f} s, peak device memory '
        f'{res["peak_mem_gb"]:.2f} GB above the {base / 1e9:.2f} GB held '
        f'before the engine was built; decode captures {st["traces"]}')
    log(f'[{tag}] kernel launches on this run: {launches}')
    return res


def eager_twin(eng):
    """An engine with `eng`'s model, bank and settings that runs its
    decode sub-steps uncaptured: the eager reference of a graph engine."""
    from paddle_tpu_torch.serving import InferenceEngine
    twin = InferenceEngine(eng.model, num_slots=eng.pool.num_slots,
                           max_length=eng.pool.max_length,
                           decode_block=eng.decode_block,
                           kv_page_size=eng.pool.page_size,
                           adapter_bank=eng.adapter_bank)
    twin._capture_decode = False
    return twin


def serve_eager(eng, res, prompts, params, adapter_ids, kernels,
                tag: str) -> dict:
    """The counted run of `_run_serve` on `eager_twin(eng)`: every request
    must get the graph run's (`res`) tokens, the seeded sampling one
    included. Logs both runs side by side; the result holds the eager
    engine under 'engine'."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    twin = eager_twin(eng)
    eager = _run_serve(twin, prompts, params, adapter_ids, kernels,
                       f'{tag} eager', base)
    for j, (a, b) in enumerate(zip(res['tokens'], eager['tokens'])):
        if a != b:
            at = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            raise AssertionError(
                f'{tag}: request {j}: graph and eager tokens differ first at '
                f'position {at} ({a[at]} vs {b[at]}): graph {a} eager {b}')
    log(f'[{tag}] graph == eager: the tokens of all {len(res["tokens"])} '
        f'requests are equal (sampling included)')
    for key, unit, fmt in (('decode_tok_per_s', 'tok/s', '.1f'),
                           ('prefill_tok_per_s', 'tok/s', '.0f'),
                           ('ttft_mean_s', 's', '.3f'),
                           ('ttft_p50_s', 's', '.3f'),
                           ('ttft_max_s', 's', '.3f'),
                           ('peak_mem_gb', 'GB', '.3f'),
                           ('wall_s', 's', '.3f')):
        log(f'[{tag}]   {key}: graph {res[key]:{fmt}} {unit}, eager '
            f'{eager[key]:{fmt}} {unit}')
    eager['engine'] = twin
    return eager


def serve(cfg) -> dict:
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.serving import (SAMPLING, InferenceEngine,
                                          SamplingParams)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEV, dtype='bfloat16',
                             generator=ptt.generator(1234, DEV))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng = InferenceEngine(model, num_slots=8, max_length=1024,
                          decode_block=8, kv_page_size=16)
    log(f'[serve] Llama {cfg.num_hidden_layers} layers x {cfg.hidden_size} '
        f'bf16 built in {time.perf_counter() - t0:.1f} s, '
        f'{nbytes(*model.parameters()) / 1e9:.2f} GB of weights;'
        f' KV pool {eng.pool.num_pages} pages, '
        f'{eng.pool.pool_bytes / 1e9:.2f} GB')
    rng = np.random.RandomState(2)
    prompts = [rng.randint(3, cfg.vocab_size, (s,)).tolist()
               for s in SERVE_LENS]
    params = [SamplingParams(max_new_tokens=32, eos_token_id=-1)
              for _ in prompts]
    params[5] = SamplingParams(max_new_tokens=32, eos_token_id=-1,
                               strategy=SAMPLING, temperature=0.8,
                               top_p=0.9, seed=7)
    res = _run_serve(eng, prompts, params, None, SERVE_KERNELS, 'serve',
                     base)
    eager = serve_eager(eng, res, prompts, params, None, SERVE_KERNELS,
                        'serve')
    res.update(engine=eng, eager=eager, prompts=prompts, params=params)
    return res


def serve_adapters(served) -> dict:
    """Phase 6's model, prompts, parameters and engine settings behind an
    engine with a bank of three adapters (capacity 4, rank 8, f32, on
    q/k/v/o_proj), request i under [base, ad0, ad1, ad2][i % 4], as
    bench.py mixes adapters. Requires the adapter kernel once per adapted
    projection of every prefill and decode forward (replays counted),
    base requests to get phase 6's tokens, some adapted request to differ
    from them, and the eager loop to give the same tokens."""
    from paddle_tpu_torch.serving import InferenceEngine
    model = served['engine'].model
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    bank = adapter_bank(model, 3, 4)
    eng = InferenceEngine(model, num_slots=8, max_length=1024,
                          decode_block=8, kv_page_size=16, adapter_bank=bank)
    log(f'[serve-adapters] bank of 3 adapters over {len(bank.sites)} '
        f'projections built in {time.perf_counter() - t0:.1f} s')
    prompts = served['prompts']
    ids = [(None, 'ad0', 'ad1', 'ad2')[i % 4] for i in range(len(prompts))]
    res = _run_serve(eng, prompts, served['params'], ids, ADAPTER_KERNELS,
                     'serve-adapters', base)
    eager = serve_eager(eng, res, prompts, served['params'], ids,
                        ADAPTER_KERNELS, 'serve-adapters')
    for run, tag in ((res, 'graph'), (eager, 'eager')):
        want = len(bank.sites) * (run['prefills'] + run['decode_steps'])
        if run['launches']['adapter_matmul'] != want:
            raise AssertionError(
                f'serve-adapters ({tag}): {run["launches"]["adapter_matmul"]}'
                f' adapter launches, want {len(bank.sites)} x '
                f'({run["prefills"]} prefills + {run["decode_steps"]} decode '
                f'sub-steps) = {want}')
    base = [j for j, aid in enumerate(ids) if aid is None]
    wrong = [j for j in base if res['tokens'][j] != served['tokens'][j]]
    if wrong:
        raise AssertionError(f'serve-adapters: base requests {wrong} differ '
                             f'from phase 6')
    changed = [j for j, aid in enumerate(ids)
               if aid is not None and res['tokens'][j] != served['tokens'][j]]
    if not changed:
        raise AssertionError('serve-adapters: no adapted request differs '
                             'from phase 6')
    log(f'[serve-adapters] {res["launches"]["adapter_matmul"]} adapter '
        f'launches = {len(bank.sites)} x ({res["prefills"]} prefills + '
        f'{res["decode_steps"]} decode sub-steps, replays counted), and so '
        f'for the eager run; base requests {base} == phase 6; adapted '
        f'requests {changed} differ from it')
    log(f'[serve-adapters] beside phase 6 (same process): decode '
        f'{res["decode_tok_per_s"]:.1f} vs {served["decode_tok_per_s"]:.1f} '
        f'tok/s, prefill {res["prefill_tok_per_s"]:.0f} vs '
        f'{served["prefill_tok_per_s"]:.0f} tok/s, TTFT mean '
        f'{res["ttft_mean_s"]:.3f} vs {served["ttft_mean_s"]:.3f} s')
    res.update(engine=eng, eager=eager, prompts=prompts, ids=ids)
    return res


def hook_host_us(calls: int = 200) -> float:
    """Host µs of one adapted projection at the serve path's decode shape:
    the hook, its wrapper and its launch(es) (`linear_hook` on a tagged
    4096 x 4096 bf16 Linear inside an adapter scope: x [8, 4096] bf16, a
    rank-8 f32 bank of 5 slots, rows [0, 1, 2, 1, 0, 3, 3, 1]), host clock
    over `calls` calls after a warm-up, the device not waited for. Uses
    only the port's public hook API, so it also times an earlier tree."""
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.serving.adapters import apply
    gen = torch.Generator(device=DEV).manual_seed(3)
    lin = Linear(4096, 4096, device=DEV, dtype=torch.bfloat16, generator=gen)
    lin._adapter_site = 'site'
    arrays = {'factors': {'site': {
        'a': 0.05 * torch.randn((5, 4096, 8), generator=gen, device=DEV),
        'b': 0.05 * torch.randn((5, 8, 4096), generator=gen, device=DEV)}},
        'scale': torch.rand(5, generator=gen, device=DEV)}
    rows = torch.tensor([0, 1, 2, 1, 0, 3, 3, 1], dtype=torch.int32,
                        device=DEV)
    x = torch.randn((8, 4096), generator=gen, device=DEV).bfloat16()
    y = lin(x)
    with torch.inference_mode(), apply.adapter_scope(arrays, rows):
        for _ in range(20):
            apply.linear_hook(lin, x, y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            apply.linear_hook(lin, x, y)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
    return host / calls * 1e6


# ---------------------------------------------------------------------------
# phase 7: where the time goes (torch.profiler, device activity)
# ---------------------------------------------------------------------------

_GROUPS = (('paged_attention', PAGED_KERNELS),
           ('adapter_matmul', ('adapter_sgmv_kernel',)),
           ('flash_attention_bwd', ('flash_bwd_dq_kernel',
                                    'flash_bwd_dq_wgmma_kernel',
                                    'flash_bwd_dkv_kernel',
                                    'flash_bwd_dkv_wgmma_kernel')),
           ('flash_attention', ('flash_fwd_kernel',
                                'flash_fwd_wgmma_kernel')),
           ('cross_entropy', ('ce_fwd_kernel', 'ce_bwd_kernel')),
           ('rms_norm', ('rms_norm_kernel',)),
           ('matmul', ('gemm', 'gemv', 'xmma', 'cutlass', 'splitk',
                       'nvjet')))


def _breakdown(windows, wall_s: float, label: str) -> float:
    """Log profiled windows [(prof, group or None)]: device time by group
    (a window with a group puts all its device time there; otherwise
    kernels are grouped by name) and the top kernels, and the device's
    idle share of `wall_s`. Returns the device busy ms."""
    groups, names = {}, {}
    for prof, forced in windows:
        for e in _device_events(prof):
            ms = e.time_range.elapsed_us() / 1e3
            low = e.name.lower()
            g = forced or next((g for g, keys in _GROUPS
                                if any(k in low for k in keys)), 'other')
            for table, key in ((groups, g), (names, e.name[:70])):
                c = table.setdefault(key, [0, 0.0])
                c[0] += 1
                c[1] += ms
    busy = sum(v[1] for v in groups.values())
    if not busy:
        log(f'[profile] {label}: the profiler recorded no device time '
            f'(device busy share not measured)')
        return busy
    log(f'[profile] {label}: wall {wall_s * 1e3:.2f} ms, device busy '
        f'{busy:.2f} ms, idle share {1 - busy / (wall_s * 1e3):.3f}')
    for g, (n, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        log(f'[profile]   {g:20s} {n:6d} launches {ms:9.3f} ms')
    for name, (n, ms) in sorted(names.items(),
                                key=lambda kv: -kv[1][1])[:8]:
        log(f'[profile]   top: {ms:8.3f} ms {n:5d}x {name}')
    return busy


def require_kernels(prof, kernels, label: str, absent=()) -> None:
    """Fail unless the profiled window ran a device event of each of
    `kernels`, and none of `absent` (by name)."""
    seen = {e.name for e in _device_events(prof)}
    missing = [k for k in kernels if not any(k in n for n in seen)]
    if missing:
        raise AssertionError(f'profile: the {label} ran no device event of '
                             f'{missing}')
    stale = [k for k in absent if any(k in n for n in seen)]
    if stale:
        raise AssertionError(f'profile: the {label} ran {stale}')
    log(f'[profile]   {label} ran ' + ', '.join(kernels)
        + (' and no ' + ', '.join(absent) if absent else ''))


def profile_serve(served, adapted) -> None:
    """On the serve and banked engines, graph and eager, after their
    counted runs: time one decode round of each with every slot busy (no
    profiler yet; the banked engines' requests under the serve-adapters
    mix), then profile the next round of each, and one prefill forward of
    the longest prompt's bucket. Every round must run the split-context
    paged kernels and not the first design's `paged_attn_kernel`; the
    banked ones the cluster adapter kernel and not the first design's
    `adapter_matmul_kernel`. The graph rounds' kernels are read from the
    profile of a replayed round."""
    from torch.profiler import ProfilerActivity, profile
    prompts, adapter_ids = served['prompts'], adapted['ids']
    rounds = []
    for e, ids, label in (
            (served['engine'], None, 'decode round, graph'),
            (served['eager']['engine'], None, 'decode round, eager'),
            (adapted['engine'], adapter_ids,
             'decode round with adapters, graph'),
            (adapted['eager']['engine'], adapter_ids,
             'decode round with adapters, eager')):
        n = e.pool.num_slots
        for p, aid in zip(prompts[:n], ids or [None] * n):
            e.submit(p, max_new_tokens=4 * e.decode_block, eos_token_id=-1,
                     adapter_id=aid)
        e.step()                # admit + prefill all, first round
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.step()                # a pure decode round, not profiled
        rounds.append((e, time.perf_counter() - t0,
                       f'{label} ({n} slots x {e.decode_block} sub-steps)'))
    for e, wall, label in rounds:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            e.step()            # the next decode round, profiled
            wall_prof = time.perf_counter() - t0
        busy = _breakdown([(prof, None)], wall, label)
        log(f'[profile]   (the profiled round took {wall_prof * 1e3:.2f} '
            f'ms, idle share {1 - busy / (wall_prof * 1e3):.3f} of it; the '
            f'idle share above uses the unprofiled round)')
        require_kernels(prof, PAGED_KERNELS + ('rms_norm_kernel',), label,
                        absent=('paged_attn_kernel',))
        if e.adapter_bank is not None:
            require_kernels(prof, ('adapter_sgmv_kernel',), label,
                            absent=('adapter_matmul_kernel',))
        e.run()
    eng = served['engine']
    bucket = eng.pool.bucket_for(len(prompts[1]))
    ids = torch.zeros((1, bucket), dtype=torch.int64, device=DEV)
    ids[0, :len(prompts[1])] = torch.tensor(prompts[1], device=DEV)
    with torch.inference_mode():
        eng.model.prefill_kv(ids)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.model.prefill_kv(ids)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    _breakdown([(prof, None)], wall, f'prefill forward, bucket {bucket} '
                                     f'({len(prompts[1])} prompt tokens)')
    require_kernels(prof, ('flash_fwd_wgmma_kernel',), 'prefill forward')


def update_bound_ms(opt, named) -> float:
    """The least time of one Adam/AdamW update of `named` parameters under
    `opt` at 3.35 TB/s: each parameter read and written (only written when
    an fp32 master is read instead), its grad (of its dtype) read, twice
    under a global-norm clip (the norm, then the update), each slot read
    and written."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    reads = 2 if isinstance(opt._grad_clip, ClipGradByGlobalNorm) else 1
    total = 0
    for _, p in named:
        slots = opt._slots[p]
        total += (nbytes(p) * ((1 if 'master' in slots else 2) + reads)
                  + 2 * nbytes(*slots.values()))
    return total / HBM_BYTES_PER_S * 1e3


def profile_train(step, batch, step_s: float, label: str) -> None:
    """One training step of `step` (phase 5's or 5b's) in two profiled
    windows: the forward and backward, and the optimizer update. The
    update window must run the multi-tensor Adam kernel (and, under a
    global-norm clip, the sum of squares); its device ms is logged beside
    `update_bound_ms`. The idle share is taken against `step_s`, the step
    time measured before any profiling (a step run after the profiler has
    been used costs the host more; its wall is logged beside it)."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    float(step(batch, batch))
    wall_now = time.perf_counter() - t0
    x = torch.as_tensor(batch, device=DEV)
    with profile(activities=[ProfilerActivity.CUDA]) as fwd_bwd:
        next_token_loss(step.layer(x), x).backward()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as update:
        # CUPTI has missed a window's first kernel (the sum of squares
        # here): a marker of ~1 us goes first
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        step.optimizer.update(step._params)
        for _, p in step._params:
            p.grad = None
        torch.cuda.synchronize()
    _breakdown([(fwd_bwd, None), (update, 'optimizer')], step_s,
               f'training step, {label} (batch {TRAIN_BATCH} x {TRAIN_SEQ}; '
               f'wall = the step time of its phase)')
    log(f'[profile]   (an unprofiled step run now, after the serve '
        f'profile, took {wall_now * 1e3:.2f} ms)')
    require_kernels(fwd_bwd, ('flash_fwd_wgmma_kernel',
                              'flash_bwd_dq_wgmma_kernel',
                              'flash_bwd_dkv_wgmma_kernel'),
                    'training step')
    clipped = isinstance(step.optimizer._grad_clip, ClipGradByGlobalNorm)
    require_kernels(update, ('multi_tensor_adam_kernel',)
                    + (('multi_tensor_sumsq_kernel',) if clipped else ()),
                    f'update window ({label})')
    dev = sum(e.time_range.elapsed_us() for e in _device_events(update)
              if 'spin_kernel' not in e.name) / 1e3
    log(f'[profile]   update window ({label}): device {dev:.3f} ms, bound '
        f'{update_bound_ms(step.optimizer, step._params):.3f} ms (the bytes '
        f'of params, grads{" read twice" if clipped else ""} and optimizer '
        f'state at 3.35 TB/s)')


def rung_step_s(steps: int = TRAIN_STEPS) -> tuple:
    """(seconds per step, peak device bytes) of phase 5's rung and recipe
    (AdamW lr 3e-4, bf16 moments), host clock over `steps` steps after
    TRAIN_WARMUP. Uses only the port's public API, so it also times an
    earlier tree."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=8, use_recompute=True)
    model = LlamaForCausalLM(cfg, device=DEV, dtype='bfloat16',
                             generator=ptt.generator(0, DEV))
    step = TrainStep(model, next_token_loss, AdamW(
        learning_rate=TRAIN_LR, parameters=model.parameters(),
        moment_dtype='bfloat16'))
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
               for _ in range(4)]
    for i in range(TRAIN_WARMUP):
        float(step(batches[i % 4], batches[i % 4]))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(steps):
        loss = step(batches[i % 4], batches[i % 4])
    float(loss)
    return ((time.perf_counter() - t0) / steps,
            torch.cuda.max_memory_allocated())


def release(*runs) -> None:
    """Drop the engines and train steps that the phases' results hold on
    the card (and the eager twins'), keeping their numbers."""
    for run in runs:
        for key in ('engine', 'step'):
            run.pop(key, None)
        if isinstance(run.get('eager'), dict):
            release(run['eager'])
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    if sys.argv[1:2] == ['--hook-us']:
        # python3 chip_smoke.py --hook-us TREE: hook_host_us() of the port
        # in the checkout TREE (to set an earlier tree beside this one)
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
        from paddle_tpu_torch.ops import _build
        _build.build_all()
        log(f'[host] {sys.argv[2]}: one adapted projection {hook_host_us():.2f}'
            f' us of host time per call')
        return 0
    if sys.argv[1:2] == ['--train-ms']:
        # python3 chip_smoke.py --train-ms TREE: rung_step_s() of the port
        # in the checkout TREE
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
        from paddle_tpu_torch.ops import _build
        from paddle_tpu_torch.nlp import LlamaConfig
        _build.build_all()
        dt, peak = rung_step_s()
        flops = train_flops_per_step(
            LlamaConfig.llama2_7b(num_hidden_layers=8), TRAIN_BATCH,
            TRAIN_SEQ)
        log(f'[train] {sys.argv[2]}: {dt * 1e3:.1f} ms/step, MFU '
            f'{flops / dt / PEAK_OPS_PER_S[torch.bfloat16]:.4f}, peak device '
            f'memory {peak / 1e9:.2f} GB in all')
        return 0
    from paddle_tpu_torch.nlp import LlamaConfig  # fails outside the repo
    log(f'[env] torch {torch.__version__} cuda {torch.version.cuda} '
        f'device {torch.cuda.get_device_name(0)}')
    # every comparison below runs fp32 products in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log('[env] TF32 off for matmul and cuDNN')
    t0 = time.perf_counter()
    build()
    cases = kernel_cases()
    check_kernels(cases)
    check_kernels(optimizer_cases())    # freed here, rebuilt for phase 8
    torch.cuda.empty_cache()
    check_consistency(LlamaConfig.llama2_7b(num_hidden_layers=2))
    check_adapter_consistency(LlamaConfig.llama2_7b(num_hidden_layers=2))
    check_train_consistency(LlamaConfig.llama2_7b(num_hidden_layers=2))
    check_train_steps(LlamaConfig.llama2_7b(num_hidden_layers=2))
    rung = LlamaConfig.llama2_7b(num_hidden_layers=8, use_recompute=True)
    trained = train(rung)
    pretrained = pretrain(trained, rung)
    res = serve(LlamaConfig.llama2_7b())
    adapted = serve_adapters(res)
    log(f'[host] one adapted projection (hook + wrapper + launch, decode '
        f'shape): {hook_host_us():.2f} us of host time per call')
    profile_serve(res, adapted)
    release(res, adapted)
    profile_train(pretrained['step'], trained['batch'],
                  pretrained['step_s'], 'Llama 2 pretraining optimizer')
    pretrained['step'].optimizer._slots.clear()
    profile_train(trained['step'], trained['batch'], trained['step_s'],
                  'bench optimizer')
    release(trained, pretrained)
    opt_cases = optimizer_cases()
    check_kernels(opt_cases)
    rows = time_kernels(cases + opt_cases)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    table = []
    for name in REPLACES:
        r = rows[name]
        launches = sum(run['launches'].get(name, 0)
                       for run in (res, trained, pretrained, adapted))
        table.append({
            'name': name, 'route': 'cuda', 'source': SOURCES[name],
            'replaces': REPLACES[name], 'launches': launches,
            'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
            'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
            'bound_by': r['bound_by'], 'library_ms': r['library_ms'],
            'shape': r['shape']})
    log(f'[done] {time.perf_counter() - t0:.1f} s')
    print(smi)
    print(json.dumps({'kernels': table}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
