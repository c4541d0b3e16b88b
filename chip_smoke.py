#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --hook-us TREE   # host us of one adapted
                                           # projection, port in TREE
    python3 chip_smoke.py --train-ms TREE  # the training rung's step
                                           # time, port in TREE
    python3 chip_smoke.py --int8-rmse      # int8 KV's logit error by
                                           # depth
    python3 chip_smoke.py --paged-ms TREE [OUT]  # the paged kernel over
                                           # float pages, port in TREE
                                           # (OUT: its outputs saved)
    python3 chip_smoke.py --paged-bits A B # two saved outputs bit-equal?

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. build: compile every kernel source under `paddle_tpu_torch/csrc/` with
   nvcc (sm_90a), all sources at once; log each kernel's registers and
   spills, and require HGMMA (wgmma) instructions in the bf16 flash
   forward, dq and dk/dv kernels (`cuobjdump -sass`);
2. kernels: hold each kernel against its plain PyTorch version on the
   card, in f32 and bf16, at the serving and training paths' shapes
   (plus GQA, ragged lengths, the flash forward at the chunk shapes sq <
   sk of CHUNK_SHAPES, and again with the key count sk read from device
   memory over a 1024-row buffer whose rows past it are NaN (the
   captured chunk's call), int8 pages, int8 pages with the decode
   round's float window (window starts at row offsets 0, 9 and 15 of a
   page, a length-1 slot, an inactive slot on the null page; f32 and
   bf16, HKV 32 and 8), the speculative verify's k + 1 = 5 query rows
   per slot (f32 and bf16 at the serve shape, HKV 8, over int8 pages with
   the round's window of W = 2 pages, spans that cross a page boundary,
   an inactive slot), ignored CE rows, and adapter
   rows on slot 0, whose delta must be exactly zero and whose fused
   y + delta must equal y bit for bit); then the multi-tensor sum of
   squares and Adam update over the training rung's tensors of one
   decoder layer plus lm_head (bf16 with bf16 moments, and bf16 with
   fp32 masters and moments; a global-norm clip scale below 1, and
   amsgrad), every updated p, m, v (master, max) held to the plain
   version (the cases are freed after the check and rebuilt for 8);
3. consistency: the engine (its decode sub-step and each prefill bucket
   replayed from a CUDA graph) at 2 layers of Llama-2-7B width in f32,
   greedy; each request's first 16 tokens must equal a no-cache
   full-recompute forward of the same model, and with a seeded sampling
   request added its eager twin (nothing captured) must give the same
   tokens; then adapter consistency at the same size:
   with a bank of two LoRA adapters, a mixed wave [base, ad0, ad1, ad0]
   gives each request the tokens it gets served alone under its adapter
   on a fresh engine and bank (and on the eager twin), base requests the
   tokens of a bank-less engine, and an adapter changes some tokens;
   then the prefix cache and
   chunked prefill at the same size: after a warm-up prompt, suffix hits
   (one in two chunks), a cold 900-token prompt in four chunks and a full
   hit (COW split) give the tokens of its eager twin, of an engine
   without cache or chunking and of a no-cache recompute, and every page
   is free after a forced clear; then the same with `kv_quant='int8'`:
   the graph engine's tokens equal its eager twin's, greedy and with a
   seeded sampling request, and with the prefix cache and chunking over
   the same paths, and every page is free after a forced clear; the
   first decode sub-step's logits equal (to 1e-4) those of the float
   engine over its pages roundtripped through int8 (the JAX bench's
   int8 arm) and lie within the bench's relative RMSE bound of 0.05 of
   float KV; then speculative decoding (k = 4) at the same size: the
   spec engine's tokens equal the plain engine's (greedy and a seeded
   sampling request) with an independent 1-layer draft and with the
   target as its own draft, graph == eager, and so with the prefix
   cache and chunks and behind a bank; with int8 KV graph == eager (the
   plain int8 engine's tokens logged: the verify's rejected rows enter
   the touched pages' requantize scales); `traces` exactly the
   round and the prefill and draft-prefill buckets run; a swap to
   perturbed weights and a restore give the pre-swap tokens bit for bit
   with `traces` unchanged; `drain()` finishes every accepted request,
   one parked mid-chunk included; `evict_all()` frees every page;
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
   the 8-slot paged engine, which replays its decode sub-step and each
   prefill bucket from captured CUDA graphs, 12 requests (prompts 13-700
   tokens, 32 new tokens; 11 greedy, 1 sampling), with every serving
   kernel's launch count read around that run (replays counted) and
   required to be > 0, and `traces` exactly one capture of the sub-step
   and of each bucket the run used; then the same requests on an engine
   that runs both uncaptured (the eager loop): every request's tokens
   must be equal, and both runs are logged side by side; then the same
   model,
   prompts and settings behind an engine with an `AdapterBank` of three
   rank-8 adapters on q/k/v/o_proj, request i under
   [base, ad0, ad1, ad2][i % 4], graph and eager alike: every request
   finishes with the same tokens in both, the adapter kernel runs
   exactly once per adapted projection of every prefill and decode
   sub-step, base requests get phase 6's tokens and adapted ones
   differ; then serve-prefix: the same model behind an engine with
   `prefix_cache=0.25, prefill_chunk_tokens=256` on bench.py:stack_ab's
   shared-system-prompt trace at these lengths (a warm-up prompt of the
   512-token system prompt + 32 alone, then 16 requests: 13 suffix hits,
   the warm-up's exact repeat, two cold 900-token prompts; one sampling),
   on five engines in one process: graph (decode and prefill captured),
   eager, eager prefill (the decode graph only: the configuration before
   the prefill was captured) and two cold twins without cache or
   chunking (prefill captured and eager), each warmed by the trace once
   so its counted run captures nothing, logged side by side (hits, reused
   tokens, chunk rounds, COW splits, prompt tokens computed, prefill
   wall, TTFT, decode tok/s, the pool's peak pages, prefills by (kind,
   bucket), capture seconds, device memory held after the captures);
   graph, eager and eager-prefill tokens must be equal, hits >= 13, one
   COW split, a chunk run, the flash forward once per layer of every
   prefill and chunk, `traces` exactly the buckets run, a suffix hit's
   last logits through attached pages and the chunk forward equal to the
   same split without the cache and the whole prompt's chunk forward
   equal to a cold forward (bit for bit; the prefix path against the
   cold forward logged), and every page free after a forced clear; then
   the walls of a whole prefill at bucket 1024 and a 256-token chunk at
   start 512, captured and eager, and the device time of the captured
   chunk's whole-row gather;
6d. serve-int8: phase 6's model, requests and engine with
   `kv_quant='int8'`, graph and eager twin, then phase 6c's serve-prefix
   trace on the int8 prefix/chunk engine, graph and eager twin: tokens
   equal between the twins, `traces` exactly the buckets run, the paged
   kernel once per layer of every decode sub-step, the first decode
   sub-step's relative logit RMSE of phase 6's prompts against phase 6's
   bf16-KV engine at most 1.25 times the JAX bench's int8 arm's (phase
   6's engine over its pages roundtripped through int8; the bench's 0.05
   holds at its 4 layers, not at 32), every page free after a forced
   clear; pool bytes, decode tok/s, TTFT and peak used
   pages logged beside phases 6 and 6c;
6e. serve-spec: phase 6's model, requests and engine settings (k = 4,
   decode rounds of one speculation round) with two drafts in turn, the
   bench's same-width 2-layer random draft and the model itself, each on
   the graph engine and its eager twin: tokens equal between the twins,
   the verify kernel once per layer of every round, `traces` exactly the
   round and the buckets run; decode tok/s, TTFT, tokens per round per
   greedy slot and the acceptance rate logged beside phase 6, and how
   many requests get phase 6's tokens (bf16: a 5-row verify can round
   differently from a 1-row step; a reading, not a gate);
6f. drain and swap: a fresh phase-6 engine: `swap_weights` to a host
   copy of the weights with one layer perturbed and `restore_weights`
   (their seconds logged), after which the 12 requests get phase 6's
   tokens; `evict_all()` after two steps hands back all 12 with every
   page free; `drain()` after two steps finishes all 12 with phase 6's
   tokens;
6g. adapter store and weight store: (a) phase 6b's wave behind a
   store-backed bank (f32, rank 8, capacity 4; its store a fresh
   directory under the gitignored `build/stores/`, removed at the end):
   ad0..ad2 published once each with 6b's factors, every request's
   tokens == 6b's through pins that load from the store; ad0 v2
   published while an ad0 request decodes (that request keeps 6b's
   tokens; a new one gets v2 in another slot, with the tokens of a fresh
   bank `load`ed with v2); a corrupt v3 quarantined while v2 keeps
   serving; a capacity-2 bank with three adapters in flight (each
   request gets its tokens alone, some admission requeued); `traces`
   unchanged after each engine's warm-up and the adapter kernel once per
   adapted projection of every prefill and decode sub-step; one publish,
   each hot load and its slot copy, the round that admits the v2 request
   beside a round that admits nothing, and the pool's and the bank's
   bytes logged. (b) the weight store at Llama-2-7B width and 2 bf16
   layers (1.33 GB a version; 32 layers would write 13.5 GB a version to
   disk) on a graph engine: `WeightPublisher` publishes v1, then a
   perturbed v2 and a v3 with one bf16 NaN; v2 is loaded, passes
   `finite_weights_gate`, is swapped in and passes a `CanaryGate` whose
   tokens come from a fresh engine on v2's weights; the gate refuses v3,
   which is quarantined (latest is v2 again), and `restore_weights` gives
   v1's tokens; publish and load GB/s, the sha256 and the swap seconds
   logged;
   then the host time of one adapted projection (hook, wrapper and
   launch) at the decode shape;
7. profile: one decode round with every slot busy (wall time, then a
   torch.profiler breakdown of the next round's device time) on the
   plain and on the banked engine, each replayed from its graph and run
   eagerly, a whole prefill at bucket 1024 and a 256-token chunk at start
   512 on the serve-prefix engine, each replayed from its graph and run
   eagerly (wgmma flash, no SDPA kernel; idle share against phase 6c's
   walls), and one training step (forward +
   backward, then the optimizer update, each profiled); each decode
   round must run the split-context paged kernels and RMSNorm and not
   the first design's `paged_attn_kernel` (the banked ones also the
   cluster adapter kernel and not the first design's
   `adapter_matmul_kernel`), the prefills the wgmma forward kernel, the
   training step the wgmma forward, dq and dk/dv kernels, and its update
   window (phase 5b's optimizer, then phase 5's) the multi-tensor Adam
   kernel (5b's also the sum of squares), its device ms logged beside
   the bound of the bytes the update must move; then one int8 decode
   round, graph and eager, profiled in three windows (the window's
   fill, the sub-steps, the requantize of the touched pages): the
   sub-steps must run the int8 split, window and combine kernels, and
   the fill and requantize device work; then one speculation round of
   phase 6e's 2-layer-draft engine, graph (one replayed round) and eager
   (the draft sub-steps and the verify in windows of their own);
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
run in a process, every later launch costs the host more. Phases 6e and
6f run right after phase 6, before 6b-6d, while only phase 6's engines
hold device memory, and free their engines; 6g runs after 6b and frees
its engines before 6c; phase 7 builds fresh spec engines once the serve
engines are freed.

The last lines are the card's name and power limit, a JSON line with the
kernel table, and `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import collections
import gc
import itertools
import json
import math
import shutil
import subprocess
import sys
import tempfile
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
    'paged_attention_int8_window':
        'paddle_tpu/ops/pallas_kernels.py:701 (_paged_attn_kernel, int8 '
        'pages; the float window is the JAX decode round\'s float view, '
        'paddle_tpu/serving/engine.py:698-741)',
    'paged_attention_verify':
        'paddle_tpu/ops/pallas_kernels.py:701 (_paged_attn_kernel, k + 1 '
        'query rows per slot; the JAX verify is a gather and dense '
        'attention, paddle_tpu/serving/engine.py:811-835)',
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
    'paged_attention_int8_window': 'paddle_tpu_torch/csrc/paged_attention.cu',
    'paged_attention_verify': 'paddle_tpu_torch/csrc/paged_attention.cu',
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
# (sq, sk) of the flash forward on the suffix / chunk prefill path: a
# 256-token chunk after a 512-row prefix and after 768 rows, a 64-token
# suffix after 512, and an 8-token one
CHUNK_SHAPES = ((256, 768), (256, 1024), (64, 576), (8, 520))
# the rows of a slot of the serve engines (max_length): the captured chunk
# prefill gathers them all and attends to the first start + sq
SLOT_ROWS = 1024
# the device kernels of one paged_attention call
PAGED_KERNELS = ('paged_attn_split_kernel', 'paged_attn_combine_kernel')
# ... and of one call over int8 pages with the decode round's window
INT8_KERNELS = ('paged_attn_int8_split_kernel', 'paged_attn_window_kernel',
                'paged_attn_combine_kernel')
SERVE_KERNELS = ('flash_attention_fwd', 'paged_attention', 'rms_norm')
ADAPTER_KERNELS = SERVE_KERNELS + ('adapter_matmul',)
SPEC_KERNELS = SERVE_KERNELS + ('paged_attention_verify',)
# speculative decoding: k draft tokens a round (bench.py:372), so the
# verify's k + 1 query rows per slot
SPEC_K = 4
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
        parts = [compare(f'{name} [{i}]', g, w)
                 for i, (g, w) in enumerate(zip(got, want))]
        return {k: max(r[k] for r in parts) for k in parts[0]}
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f'{name}: kernel gives {got.dtype} '
                             f'{tuple(got.shape)}, plain {want.dtype} '
                             f'{tuple(want.shape)}')
    if not torch.isfinite(got).all():
        raise AssertionError(f'{name}: kernel output has non-finite values')
    lim_max, lim_norm = TOL[want.dtype]
    r = readings(got, want)
    if r['rel_max'] > lim_max or r['rel_norm'] > lim_norm:
        raise AssertionError(f'{name}: kernel vs plain rel_max '
                             f'{r["rel_max"]:.3e} (limit {lim_max:.3e}), '
                             f'rel_norm {r["rel_norm"]:.3e} (limit '
                             f'{lim_norm:.3e})')
    return r


def readings(got, want) -> dict:
    """{max_abs_err, rel_max, rel_norm} of `got` against `want`, in fp64."""
    got, want = got.double(), want.double()
    diff = got - want
    max_abs = float(diff.abs().max())
    return dict(max_abs_err=max_abs,
                rel_max=max_abs / max(float(want.abs().max()), 1e-30),
                rel_norm=float(diff.norm()) / max(float(want.norm()), 1e-30))


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

    # flash attention at the chunk shapes: a suffix or chunk of sq queries
    # over the slot's sk = start + sq rows, causal aligned bottom-right;
    # the library's counterpart is SDPA under a lower-right causal bias
    # (is_causal=True aligns top-left, another function when sq < sk),
    # over K/V repeated to 32 heads
    from torch.nn.attention.bias import causal_lower_right
    for dtype in (torch.float32, torch.bfloat16):
        for (sq, sk), hkv in itertools.product(CHUNK_SHAPES, (32, 8)):
            q = _randn((1, sq, 32, 128), dtype, gen)
            k = _randn((1, sk, hkv, 128), dtype, gen)
            v = _randn((1, sk, hkv, 128), dtype, gen)
            qt, kt, vt = (t.transpose(1, 2) for t in
                          (q, k.repeat_interleave(32 // hkv, dim=2),
                           v.repeat_interleave(32 // hkv, dim=2)))
            add('flash_attention_fwd',
                f'flash {str(dtype)[6:]} chunk sq={sq} sk={sk} H=32 '
                f'HKV={hkv}', dtype,
                lambda q=q, k=k, v=v: K.flash_attention_fwd(q, k, v,
                                                            causal=True),
                lambda q=q, k=k, v=v: K.attention_reference(q, k, v,
                                                            causal=True),
                lambda qt=qt, kt=kt, vt=vt, sq=sq, sk=sk:
                    F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=causal_lower_right(sq, sk)),
                nbytes(q, k, v, q), 4 * 128 * 32 * live_pairs(sq, sk, True))

    # the same shapes as the captured chunk prefill calls them: sq queries
    # over the slot's whole 1024-row K/V buffer, the key count sk read
    # from device memory (seqused_k); the rows past it are NaN, so a
    # kernel that read one would fail the check. The bytes moved are the
    # rows the count covers; the library call is SDPA on them (a view)
    for dtype in (torch.float32, torch.bfloat16):
        for (sq, sk), hkv in itertools.product(CHUNK_SHAPES, (32, 8)):
            q = _randn((1, sq, 32, 128), dtype, gen)
            k = _randn((1, SLOT_ROWS, hkv, 128), dtype, gen)
            v = _randn((1, SLOT_ROWS, hkv, 128), dtype, gen)
            k[:, sk:] = float('nan')
            v[:, sk:] = float('nan')
            used = torch.tensor([sk], dtype=torch.int32, device=DEV)
            qt, kt, vt = (t.transpose(1, 2) for t in
                          (q, k[:, :sk].repeat_interleave(32 // hkv, dim=2),
                           v[:, :sk].repeat_interleave(32 // hkv, dim=2)))
            add('flash_attention_fwd',
                f'flash {str(dtype)[6:]} seqused_k chunk sq={sq} sk={sk} of '
                f'{SLOT_ROWS} rows H=32 HKV={hkv}', dtype,
                lambda q=q, k=k, v=v, u=used: K.flash_attention_fwd(
                    q, k, v, causal=True, seqused_k=u),
                lambda q=q, k=k, v=v, u=used: K.attention_reference(
                    q, k, v, causal=True, seqused_k=u),
                lambda qt=qt, kt=kt, vt=vt, sq=sq, sk=sk:
                    F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=causal_lower_right(sq, sk)),
                nbytes(q, q, used) + 2 * sk * hkv * 128 * k.element_size(),
                4 * 128 * 32 * live_pairs(sq, sk, True))

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

    _paged_window_cases(add, gen, table, lengths)
    _paged_verify_cases(add, gen)

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


# the int8 decode round's window: W pages per slot at decode_block 8,
# ps 16 (`window_count`); row offsets 0, 9 and 15 of the round's first
# row in its page, a length-1 slot, and an inactive slot (its table row
# the null page) parked at the slot's last row
WINDOW_PAGES = 2
WINDOW_POS = (1023, 1001, 768, 521, 255, 96, 0, 1023)


def _paged_window_cases(add, gen, serve_table, serve_lengths) -> None:
    """The paged kernel over int8 pages with the decode round's float
    window (f32 and bf16, HKV 32 and 8): the window holds the slot's
    logical pages pos // 16 .. + 1, filled with other values than the
    int8 pages there, so a kernel that read those pages fails. Then the
    case phase 8 reports: bf16 at the serve shape of the bf16 case above
    (its table and lengths, the window at each slot's last row). Bytes:
    the live int8 rows below the window and their scales, the window's
    live rows in q's dtype, q, out, table, lengths and win_first."""
    from paddle_tpu_torch.ops import kernels as K
    n, h, ps, p = 8, 32, 16, 64
    num_pages = n * p + 1
    table = (torch.randperm(num_pages - 1, generator=gen, device=DEV)[:n * p]
             + 1).to(torch.int32).reshape(n, p)
    table[-1] = 0                        # the inactive slot: the null page
    pos = torch.tensor(WINDOW_POS, dtype=torch.int32, device=DEV)
    cases = [(dtype, hkv, table.contiguous(), pos, False)
             for dtype, hkv in ((torch.float32, 32), (torch.bfloat16, 32),
                                (torch.float32, 8), (torch.bfloat16, 8))]
    cases.append((torch.bfloat16, 32, serve_table, serve_lengths - 1, True))
    for dtype, hkv, tbl, pos, rep in cases:
        lengths = (pos + 1).to(torch.int32)
        win_first = (pos // ps).to(torch.int32)
        q = _randn((n, h, 128), dtype, gen)
        shape = (num_pages, ps, hkv, 128)
        kp, vp = (torch.randint(-127, 128, shape, generator=gen, device=DEV,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((num_pages, hkv), generator=gen, device=DEV)
                  / 127 + 1e-3 for _ in range(2))
        wshape = (n, WINDOW_PAGES, ps, hkv, 128)
        kw, vw = _randn(wshape, dtype, gen), _randn(wshape, dtype, gen)
        args = (q, kp, vp, tbl, lengths)
        kw_args = dict(k_scales=ks, v_scales=vs, k_win=kw, v_win=vw,
                       win_first=win_first)
        below = int((win_first.long() * ps).sum())       # int8 rows
        in_win = int((lengths - win_first * ps).sum())   # window rows
        add('paged_attention_int8_window',
            f'paged {str(dtype)[6:]} N=8 H=32 HKV={hkv} int8 pages + '
            f'{str(dtype)[6:]} window W={WINDOW_PAGES} '
            + ('ctx<=1024 (serve)' if rep else
               'offsets 0/9/15, len 1, inactive slot'), dtype,
            lambda a=args, kw=kw_args: K.paged_attention(*a, **kw),
            lambda a=args, kw=kw_args: K.paged_attention_reference(*a, **kw),
            None,
            nbytes(q, q, tbl, lengths, win_first)
            + below * hkv * 128 * 2 + 2 * int(win_first.sum()) * hkv * 4
            + in_win * hkv * 128 * kw.element_size() * 2,
            4 * 128 * h * int(lengths.sum()), rep=rep)


# the verify's key count of query row 0 per slot at the serve shape: rows
# 510 .. 514 and 14 .. 18 cross a page boundary, 1020 .. 1024 end at the
# slot's last row
VERIFY_LENGTHS = (1020, 1000, 777, 510, 254, 100, 14, 1)


def _paged_verify_cases(add, gen) -> None:
    """The paged kernel over k + 1 = 5 query rows per slot (the
    speculative verify) at the serve shape (8 slots, H 32, ctx <= 1024):
    f32 and bf16, HKV 32 and 8, over int8 pages with the round's window
    of W = window_count(5, 16) = 2 pages (filled with other values than
    the pages it stands for), and with an inactive slot (its table row
    the null page, parked at the slot's last row). Row t of slot n sees
    lengths[n] + t keys. Bytes: the union of the rows the 5 rows see,
    read once (the kernel folds them into one block), q, out, table and
    lengths; with the window the int8 rows below it and their scales and
    the window's rows in q's dtype."""
    from paddle_tpu_torch.nlp.generation import window_count
    from paddle_tpu_torch.ops import kernels as K
    n, h, ps, p, t = 8, 32, 16, 64, SPEC_K + 1
    num_pages = n * p + 1
    table = (torch.randperm(num_pages - 1, generator=gen, device=DEV)[:n * p]
             + 1).to(torch.int32).reshape(n, p).contiguous()
    parked = table.clone()
    parked[-1] = 0
    lengths = torch.tensor(VERIFY_LENGTHS, dtype=torch.int32, device=DEV)
    last = [ln + t - 1 for ln in VERIFY_LENGTHS]        # keys of row T - 1
    w = window_count(t, ps)
    first = torch.div(lengths - 1, ps, rounding_mode='floor').to(torch.int32)
    for dtype, hkv, mode, tbl, rep in (
            (torch.float32, 32, 'float', table, False),
            (torch.bfloat16, 32, 'float', table, True),
            (torch.float32, 8, 'float', table, False),
            (torch.bfloat16, 8, 'float', table, False),
            (torch.bfloat16, 32, 'int8_window', table, False),
            (torch.float32, 8, 'int8_window', table, False),
            (torch.bfloat16, 32, 'float', parked, False)):
        q = _randn((n, t, h, 128), dtype, gen)
        shape = (num_pages, ps, hkv, 128)
        kw = {}
        elt = torch.tensor([], dtype=dtype).element_size()
        if mode == 'float':
            kp, vp = _randn(shape, dtype, gen), _randn(shape, dtype, gen)
            moved = sum(last) * hkv * 128 * elt * 2
        else:
            kp, vp = (torch.randint(-127, 128, shape, generator=gen,
                                    device=DEV, dtype=torch.int8)
                      for _ in range(2))
            kw = dict(zip(('k_scales', 'v_scales'), (
                torch.rand((num_pages, hkv), generator=gen, device=DEV)
                / 127 + 1e-3 for _ in range(2))))
            wshape = (n, w, ps, hkv, 128)
            kw.update(k_win=_randn(wshape, dtype, gen),
                      v_win=_randn(wshape, dtype, gen), win_first=first)
            below = int(first.long().sum()) * ps
            moved = (below * hkv * 128 * 2 + 2 * int(first.sum()) * hkv * 4
                     + (sum(last) - below) * hkv * 128 * elt * 2)
        args = (q, kp, vp, tbl, lengths)
        add('paged_attention_verify',
            f'paged verify {str(dtype)[6:]} N=8 T={t} H=32 HKV={hkv} '
            f'ctx<=1024' + (f' int8 pages + window W={w}'
                            if mode != 'float' else '')
            + (' inactive slot' if tbl is parked else ''), dtype,
            lambda a=args, kw=kw: K.paged_attention(*a, **kw),
            lambda a=args, kw=kw: K.paged_attention_reference(*a, **kw),
            None,
            moved + nbytes(q, q, tbl, lengths)
            + (nbytes(first) if mode != 'float' else 0),
            4 * 128 * h * sum(ln + i for ln in VERIFY_LENGTHS
                              for i in range(t)), rep=rep)


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
    """The graph engine's greedy tokens equal a no-cache full recompute;
    with a seeded sampling request added, its eager twin (decode and
    prefill uncaptured) gives the same tokens."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.serving import (SAMPLING, InferenceEngine,
                                          SamplingParams)
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
    params = [SamplingParams(max_new_tokens=n_new, eos_token_id=-1)
              for _ in prompts] + [SamplingParams(
                  max_new_tokens=n_new, eos_token_id=-1, strategy=SAMPLING,
                  temperature=0.8, top_p=0.9, seed=5)]
    graph_equals_eager(eng, prompts + prompts[2:3], params, 'consistency')
    del eng, model
    torch.cuda.empty_cache()


def check_int8_consistency(cfg):
    """With `kv_quant='int8'` at 2 layers in f32: the graph engine's
    tokens equal its eager twin's, greedy and with a seeded sampling
    request; the same with the prefix cache and chunked prefill over the
    serve-prefix trace's paths (suffix hits in chunks, a cold prompt in
    four chunks, a full hit with its COW split); and every page is free
    after a forced clear. The first decode sub-step's logits of phase 6's
    prompts must equal, to INT8_EXACT, those of the float engine over
    its pages roundtripped through int8 (the JAX bench's int8 arm), and
    lie within INT8_RMSE_BOUND of float KV. The greedy tokens against
    float KV are logged (int8 rounding may move an argmax)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.serving import (SAMPLING, InferenceEngine,
                                          SamplingParams)
    model = LlamaForCausalLM(cfg, device=DEV, dtype='float32',
                             generator=ptt.generator(0, DEV))
    rng = np.random.RandomState(1)
    prompts = [rng.randint(3, cfg.vocab_size, (s,)).tolist()
               for s in (5, 16, 37, 130)]
    greedy = SamplingParams(max_new_tokens=16, eos_token_id=-1)
    params = [greedy] * len(prompts) + [SamplingParams(
        max_new_tokens=16, eos_token_id=-1, strategy=SAMPLING,
        temperature=0.8, top_p=0.9, seed=5)]
    eng = InferenceEngine(model, num_slots=8, max_length=1024,
                          decode_block=8, kv_page_size=16, kv_quant='int8')
    got = graph_equals_eager(eng, prompts + prompts[2:3], params,
                             'int8-consistency')
    dense = InferenceEngine(model, num_slots=8, max_length=1024,
                            decode_block=8, kv_page_size=16)
    ref = [h.tokens for h in dense.generate_many(prompts, greedy)]
    same = sum(a == b for a, b in zip(got, ref))
    log(f'[int8-consistency] {same} of {len(prompts)} greedy requests get '
        f'the float-KV engine\'s 16 tokens')
    # the first decode sub-step of phase 6's prompts: the int8 engine
    # against the float engine over its pages roundtripped through int8
    # (the JAX bench's int8 arm), and against float KV
    rng = np.random.RandomState(2)
    serve_prompts = [rng.randint(3, cfg.vocab_size, (s,)).tolist()
                     for s in SERVE_LENS]
    q = first_step_logits(eng, serve_prompts)
    f = first_step_logits(dense, serve_prompts)
    rt = first_step_logits(dense, serve_prompts, roundtrip=True)
    exact, rmse = rel_rmse(q, rt), rel_rmse(q, f)
    log(f'[int8-consistency] first decode sub-step of {len(serve_prompts)} '
        f'prompts: relative logit RMSE {exact:.3e} against the float engine '
        f'over int8-roundtripped pages (limit {INT8_EXACT}), {rmse:.4e} '
        f'against float KV (the JAX bench\'s bound {INT8_RMSE_BOUND}; the '
        f'roundtripped pages: {rel_rmse(rt, f):.4e})')
    if not (exact <= INT8_EXACT and rmse <= INT8_RMSE_BOUND):
        raise AssertionError(f'int8 consistency: relative logit RMSE '
                             f'{exact:.3e} against the roundtripped pages, '
                             f'{rmse:.4e} against float KV')
    del eng, dense
    warm, trace = prefix_trace(cfg.vocab_size, np.random.RandomState(6))
    prompts = [trace[i] for i in (0, 3, 5, 6, 11)]
    params = [greedy] * len(prompts)
    params[1] = SamplingParams(max_new_tokens=16, eos_token_id=-1,
                               strategy=SAMPLING, temperature=0.8,
                               top_p=0.9, seed=3)
    eng = InferenceEngine(model, **PREFIX_ENGINE, **PREFIX_OPTS,
                          kv_quant='int8')
    twin = eager_twin(eng, **PREFIX_OPTS)
    runs = []
    for e in (eng, twin):
        e.generate_many([warm], greedy)
        runs.append([h.tokens for h in e.generate_many(prompts, params)])
        st = e.stats()
        if st['prefix_cache']['hits'] < 4 or st['pool']['cow_splits'] != 1 \
                or st['chunk_rounds'] < 7:
            raise AssertionError(
                f'int8 prefix consistency: hits '
                f'{st["prefix_cache"]["hits"]}, COW '
                f'{st["pool"]["cow_splits"]}, chunk rounds '
                f'{st["chunk_rounds"]}: the trace missed a path')
        pages_free_after_clear(e, 'int8-prefix-consistency')
    if runs[0] != runs[1]:
        raise AssertionError(f'int8 prefix consistency: graph engine '
                             f'{runs[0]} != eager twin {runs[1]}')
    log(f'[int8-prefix-consistency] 2 layers f32, int8 KV, {len(prompts)} '
        f'requests x 16 tokens (suffix hits in chunks, a cold prompt in '
        f'chunks, a full hit with its COW split, one sampling): graph '
        f'engine (captures {eng.stats()["traces"]}) == its eager twin')
    del eng, twin, model
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

    def tokens(adapter_ids, banked=True, graph=True):
        eng = InferenceEngine(
            model, num_slots=8, max_length=1024, decode_block=8,
            kv_page_size=16,
            adapter_bank=adapter_bank(model, 2, 2, 0.05) if banked else None)
        eng._capture_decode = eng._capture_prefill = graph
        return [h.tokens for h in eng.generate_many(prompts, sp,
                                                    adapter_ids=adapter_ids)]

    base = tokens(None, banked=False)
    alone = {aid: tokens(aid) for aid in ('ad0', 'ad1')}
    mixed = tokens(ids)
    if tokens(ids, graph=False) != mixed:
        raise AssertionError('adapter consistency: the mixed wave on the '
                             'eager twin differs from the graph engine')
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
        f'tokens == each adapter alone == the eager twin\'s, base == '
        f'bank-less engine; {changed} of {2 * len(prompts)} adapted '
        f'requests differ from base')
    del model
    torch.cuda.empty_cache()


def perturbed_state(model, scale: float = 0.05) -> dict:
    """A host (CPU) copy of `model`'s state with layer 0's MLP down
    projection moved by `scale` times a seeded normal draw: weights a
    swap can publish."""
    state = {k: v.detach().to('cpu', copy=True)
             for k, v in model.state_dict().items()}
    w = state['llama.layers.0.mlp.down_proj.weight']
    gen = torch.Generator().manual_seed(0)
    w += (scale * torch.randn(w.shape, generator=gen)).to(w.dtype)
    return state


def draft_config(cfg, layers: int):
    """The target's config cut to `layers` layers: a same-width draft, as
    the JAX bench builds it (bench.py:366)."""
    return type(cfg)(**{**cfg.__dict__, 'num_hidden_layers': layers})


def spec_traces(eng, whole, draft, chunk=()) -> dict:
    """The `traces` of a speculating graph engine that ran whole prefills
    at the buckets `whole`, draft prefills at `draft` and chunks at
    `chunk`."""
    return {eng._decode_name: 1,
            **{f'paged_prefill_{b}': 1 for b in whole},
            **{f'draft_prefill_{b}': 1 for b in draft},
            **{f'paged_chunk_prefill_{b}': 1 for b in chunk}}


def check_spec_consistency(cfg) -> None:
    """Speculative decoding (k = SPEC_K) at 2 layers of Llama-2-7B width in
    f32: with an independent 1-layer draft and with the target as its own
    draft, the graph engine's tokens equal its eager twin's and the plain
    engine's (greedy, and a seeded sampling request, which draws one token
    a round from the verify's first row with its own generator); the
    same with int8 KV, with the prefix cache and chunked prefill, and
    behind a bank of two adapters; `traces` exactly the round and the
    prefill and draft-prefill buckets run. Then on the graph engine: a
    swap to perturbed weights and a restore give the pre-swap tokens bit
    for bit with `traces` unchanged; `evict_all()` after a step hands
    every request back with every page free; `drain()` after a step
    finishes every accepted request, one parked mid-chunk included, with
    the plain engine's tokens."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.serving import (FINISHED, SAMPLING,
                                          InferenceEngine, SamplingParams)
    model = LlamaForCausalLM(cfg, device=DEV, dtype='float32',
                             generator=ptt.generator(0, DEV))
    draft = LlamaForCausalLM(draft_config(cfg, 1), device=DEV,
                             dtype='float32', generator=ptt.generator(8, DEV))
    rng = np.random.RandomState(1)
    prompts = [rng.randint(3, cfg.vocab_size, (s,)).tolist()
               for s in (5, 16, 37, 130)]
    greedy = SamplingParams(max_new_tokens=16, eos_token_id=-1)
    sampled = SamplingParams(max_new_tokens=16, eos_token_id=-1,
                             strategy=SAMPLING, temperature=0.8, top_p=0.9,
                             seed=5)
    prompts, params = prompts + prompts[2:3], [greedy] * 4 + [sampled]
    kw = dict(num_slots=8, max_length=1024, kv_page_size=16)
    spec_kw = dict(num_draft_tokens=SPEC_K, **kw)
    buckets = sorted({8, 16, 64, 256})        # the buckets of the prompts

    def plain_tokens(prompts, params, ids=None, **opts):
        return [h.tokens for h in InferenceEngine(
            model, decode_block=8, **kw, **opts).generate_many(
                prompts, params, adapter_ids=ids)]

    for quant in (None, 'int8'):
        want = plain_tokens(prompts, params, kv_quant=quant)
        for label, d in (('independent 1-layer draft', draft),
                         ('self-draft', model)):
            if quant and d is model:
                continue
            tag = f'spec-consistency ({label}' + (', int8 KV)' if quant
                                                  else ')')
            eng = InferenceEngine(model, draft_model=d, kv_quant=quant,
                                  **spec_kw)
            got = graph_equals_eager(eng, prompts, params, tag)
            # over int8 pages the verify's rejected rows enter each touched
            # page's requantize scale (as in the JAX engine), so the plain
            # engine's tokens are a reading there, not a gate
            same = sum(a == b for a, b in zip(got, want))
            if got != want and not quant:
                raise AssertionError(f'{tag}: spec engine {got} != plain '
                                     f'engine {want}')
            if eng.stats()['traces'] != spec_traces(eng, buckets, buckets):
                raise AssertionError(f'{tag}: captures '
                                     f'{eng.stats()["traces"]}')
            log(f'[{tag}] 2 layers f32, {len(prompts)} requests x 16 tokens '
                f'(one sampling): {same} of {len(prompts)} equal the plain '
                f'engine\'s; spec {eng.stats()["spec"]}')
    # the prefix cache and chunked prefill: suffix hits in chunks, a cold
    # prompt in four chunks, a full hit with its COW split
    warm, trace = prefix_trace(cfg.vocab_size, np.random.RandomState(6))
    pre = [trace[i] for i in (0, 3, 5, 6, 11)]
    pre_params = [greedy] * len(pre)
    pre_params[1] = sampled
    want = [h.tokens for h in InferenceEngine(
        model, decode_block=8, **kw).generate_many(pre, pre_params)]
    eng = InferenceEngine(model, draft_model=draft, **PREFIX_OPTS, **spec_kw)
    eng.generate_many([warm], greedy)
    runs = []
    for e in (eng, eager_twin(eng, **PREFIX_OPTS)):
        if e is not eng:
            e.generate_many([warm], greedy)
        runs.append([h.tokens for h in e.generate_many(pre, pre_params)])
        st = e.stats()
        if st['prefix_cache']['hits'] < 4 or st['pool']['cow_splits'] != 1 \
                or st['chunk_rounds'] < 7:
            raise AssertionError(
                f'spec prefix consistency: hits {st["prefix_cache"]["hits"]}'
                f', COW {st["pool"]["cow_splits"]}, chunk rounds '
                f'{st["chunk_rounds"]}: the trace missed a path')
        pages_free_after_clear(e, 'spec-prefix-consistency')
    if not runs[0] == runs[1] == want:
        raise AssertionError(f'spec prefix consistency: graph {runs[0]}, '
                             f'eager {runs[1]}, plain {want}')
    log(f'[spec-prefix-consistency] {len(pre)} requests (suffix hits in '
        f'chunks, a cold prompt in chunks, a full hit, one sampling): graph '
        f'(captures {eng.stats()["traces"]}) == eager == the plain engine')
    del eng, runs
    # behind a bank: the verify runs under the adapters, the draft not
    ids = [None, 'ad0', 'ad1', 'ad0', None]
    bank = adapter_bank(model, 2, 2, 0.05)
    want = plain_tokens(prompts, params, adapter_bank=bank, ids=ids)
    eng = InferenceEngine(model, draft_model=draft, adapter_bank=bank,
                          **spec_kw)
    got = [h.tokens for h in eng.generate_many(prompts, params,
                                               adapter_ids=ids)]
    twin = [h.tokens for h in eager_twin(eng).generate_many(
        prompts, params, adapter_ids=ids)]
    if not got == twin == want:
        raise AssertionError(f'spec bank consistency: graph {got}, eager '
                             f'{twin}, plain {want}')
    log(f'[spec-bank-consistency] mixed wave {ids}: graph == eager == the '
        f'plain banked engine')
    del eng, bank
    # swap and restore, evict, drain on the graph engine
    eng = InferenceEngine(model, draft_model=draft,
                          prefill_chunk_tokens=256, **spec_kw)
    long = np.random.RandomState(3).randint(3, cfg.vocab_size,
                                            (900,)).tolist()
    before = [h.tokens for h in eng.generate_many(prompts, params)]
    traces = dict(eng.stats()['traces'])
    prev = eng.swap_weights(perturbed_state(model), version=1)
    moved = sum(a != b for a, b in zip(
        [h.tokens for h in eng.generate_many(prompts, params)], before))
    eng.restore_weights(prev)
    again = [h.tokens for h in eng.generate_many(prompts, params)]
    if again != before or eng.stats()['traces'] != traces or not moved:
        raise AssertionError(f'spec swap: {moved} requests moved by the '
                             f'swap; after the restore {again} (before '
                             f'{before}), captures {eng.stats()["traces"]} '
                             f'(before {traces})')
    log(f'[spec-swap] swap to perturbed weights moved {moved} of '
        f'{len(prompts)} requests; the restore gives the pre-swap tokens bit '
        f'for bit, captures unchanged {traces}')
    hs = [eng.submit(p, sp) for p, sp in zip(prompts + [long],
                                             params + [greedy])]
    eng.step()
    out = eng.evict_all()
    if sorted(h.request_id for h in out) != sorted(h.request_id for h in hs) \
            or eng.pool.free_page_count != eng.pool.num_pages - 1:
        raise AssertionError(f'spec evict_all: {len(out)} of {len(hs)} '
                             f'handles back, {eng.pool.used_page_count} pages '
                             f'still used')
    want = plain_tokens(prompts + [long], params + [greedy],
                        prefill_chunk_tokens=256)
    hs = [eng.submit(p, sp) for p, sp in zip(prompts + [long],
                                             params + [greedy])]
    eng.step()
    parked = len(eng._prefilling)
    if not parked or not eng.drain() or \
            any(h.status != FINISHED for h in hs) or \
            [h.tokens for h in hs] != want:
        raise AssertionError(f'spec drain: {parked} parked mid-chunk; '
                             f'{[h.status for h in hs]}')
    log(f'[spec-drain] evict_all() after a step: {len(out)} handles back, '
        f'every page free; drain() after a step ({parked} request parked '
        f'mid-chunk) finished all {len(hs)} with the plain engine\'s tokens')
    del eng, model, draft
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
    first round, and a capture empties the allocator's cache), then
    the same requests for one token each (a graph engine captures each
    prefill bucket's graph; every bucket's first cuBLAS plans, kernel
    shapes and cached blocks), so the counted run captures nothing. Each
    of `kernels`' launch counts is read around the counted run (graph
    replays counted) and required to be > 0. Every request must finish
    with 32 tokens; a graph engine must have captured its decode
    sub-step and each prefill bucket it used once, an eager one nothing.
    Peak memory is counted above `base` bytes."""
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
    handles = [eng.submit(p, sp, adapter_id=aid) for p, sp, aid in
               zip(prompts, params, adapter_ids or [None] * len(prompts))]
    peak_pages = 0
    while eng.has_work:
        eng.step()
        peak_pages = max(peak_pages, eng.pool.used_page_count)
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
    want_traces = expected_traces(eng, {
        ('whole', eng.pool.bucket_for(len(p)))
        for p in prompts + [prompts[0][:8]]})
    if st['traces'] != want_traces:
        raise AssertionError(f'{tag}: captures {st["traces"]}, want '
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
        'ttft_p50_s': ttft[len(ttft) // 2], 'peak_pages': peak_pages,
        'peak_mem_gb': (torch.cuda.max_memory_allocated() - base) / 1e9,
        'launches': launches, 'tokens': [h.tokens for h in handles],
    }
    log(f'[{tag}] {len(handles)} requests in {wall:.2f} s: prefill '
        f'{res["prefill_tok_per_s"]:.0f} tok/s ({st["prefill_tokens"]} '
        f'prompt tokens in {st["prefill_seconds"]:.3f} s), decode '
        f'{res["decode_tok_per_s"]:.1f} tok/s ({st["tokens"]} tokens in '
        f'{st["decode_seconds"]:.3f} s, {st["decode_rounds"]} rounds), TTFT '
        f'mean {res["ttft_mean_s"]:.3f} s p50 {res["ttft_p50_s"]:.3f} s max '
        f'{res["ttft_max_s"]:.3f} s, pool peak {peak_pages} of '
        f'{eng.pool.num_pages - 1} pages, peak device memory '
        f'{res["peak_mem_gb"]:.2f} GB above the {base / 1e9:.2f} GB held '
        f'before the engine was built; captures {st["traces"]}')
    log(f'[{tag}] kernel launches on this run: {launches}')
    return res


def eager_twin(eng, **kw):
    """An engine with `eng`'s model, bank and settings (and `kw`) that runs
    its decode sub-steps and its prefills uncaptured: the eager
    reference of a graph engine."""
    from paddle_tpu_torch.serving import InferenceEngine
    twin = InferenceEngine(eng.model, num_slots=eng.pool.num_slots,
                           max_length=eng.pool.max_length,
                           decode_block=eng.decode_block,
                           kv_page_size=eng.pool.page_size,
                           adapter_bank=eng.adapter_bank,
                           kv_quant=eng.pool.quant,
                           draft_model=eng.draft_model,
                           num_draft_tokens=eng.spec_k, **kw)
    twin._capture_decode = twin._capture_prefill = False
    return twin


def graph_equals_eager(eng, prompts, params, tag: str, **kw) -> list:
    """Serve `prompts` on `eng` (decode and prefill captured) and on its
    eager twin (with `kw`); every request's tokens must be equal.
    Returns them."""
    got = [h.tokens for h in eng.generate_many(prompts, params)]
    want = [h.tokens for h in eager_twin(eng, **kw).generate_many(
        prompts, params)]
    if got != want:
        raise AssertionError(f'{tag}: graph engine {got} != eager twin '
                             f'{want}')
    log(f'[{tag}] graph engine (captures {eng.stats()["traces"]}) == its '
        f'eager twin: {len(prompts)} requests, sampling included')
    return got


def expected_traces(eng, buckets) -> dict:
    """The `traces` of `eng` after its prefills ran at `buckets`
    ({(kind, bucket)}): one capture of the decode sub-step (or of a
    speculating engine's round) and one per prefill bucket and kind (the
    JAX engine's names; with a draft also its draft prefill at each
    whole bucket), or none at all for what runs eagerly."""
    out = {eng._decode_name: 1} if eng._capture_decode else {}
    if eng._capture_prefill:
        names = {'whole': 'paged_prefill', 'chunk': 'paged_chunk_prefill',
                 'draft': 'draft_prefill'}
        if eng.draft_model is not None:
            buckets = set(buckets) | {('draft', b) for kind, b in buckets
                                      if kind == 'whole'}
        out.update({f'{names[kind]}_{b}': 1 for kind, b in buckets})
    return out


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


# ---------------------------------------------------------------------------
# phase 6c: serve with the prefix cache and chunked prefill
# ---------------------------------------------------------------------------

# bench.py:stack_ab's shared-system-prompt trace (:1480) at the serve
# cell's lengths, with paged_ab's / stack_ab's engine options
PREFIX_SYSTEM, PREFIX_COLD = 512, 900
PREFIX_SUFFIXES = (3, 30, 9, 44, 200, 380)
PREFIX_ENGINE = dict(num_slots=8, max_length=1024, decode_block=8,
                     kv_page_size=16)
PREFIX_OPTS = dict(prefix_cache=0.25, prefill_chunk_tokens=256)
PREFIX_MIN_HITS = 13


def prefix_trace(vocab: int, rng) -> tuple:
    """(warm-up prompt, 16 prompts). The warm-up is the 512-token system
    prompt + 32 tokens: 34 whole pages, which it leaves in the cache at
    retirement. The 16: 13 with the system prompt and a suffix of
    PREFIX_SUFFIXES[i % 6] tokens, an exact repeat of the warm-up (the
    only full hit: the cache holds whole pages only), and two cold
    900-token prompts (4 chunk rounds of 256 each)."""
    system = rng.randint(3, vocab, (PREFIX_SYSTEM,)).tolist()
    warm = system + rng.randint(3, vocab, (32,)).tolist()
    shared = [system + rng.randint(3, vocab, (n,)).tolist()
              for n in (PREFIX_SUFFIXES * 3)[:13]]
    cold = [rng.randint(3, vocab, (PREFIX_COLD,)).tolist() for _ in range(2)]
    return warm, (shared[:6] + cold[:1] + shared[6:10] + [warm]
                  + shared[10:] + cold[1:])


def _run_prefix(eng, warm, prompts, params, tag: str, base: int) -> dict:
    """The warm-up prompt alone (it seeds the cache), then the trace once
    (a graph engine captures the prefill buckets the trace uses, and a
    capture's warm-up launches count), then a fresh cache and the
    warm-up prompt again, so that the counted run starts from the same
    state, runs the same buckets and captures nothing. The counted run
    of `prompts` is stepped by hand to read the pool's peak of used
    pages; launches of SERVE_KERNELS are read around it, and the flash
    forward must have launched once per layer of every whole prefill and
    chunk (graph replays counted). Every request must finish with 32
    tokens in range, and `traces` must name exactly the decode sub-step
    and the (kind, bucket) of every prefill the runs ran, for what the
    engine captures."""
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import (FINISHED, PagedPrefixCache,
                                          SamplingParams)
    vocab = eng.model.config.vocab_size
    sp_warm = SamplingParams(max_new_tokens=32, eos_token_id=-1)
    buckets = collections.Counter()
    run_prefill = eng._run_prefill

    def recorded(slot, kind, window, bucket, **staged):
        buckets[(kind, bucket)] += 1
        run_prefill(slot, kind, window, bucket, **staged)

    eng._run_prefill = recorded
    try:
        t0 = time.perf_counter()
        eng.generate_many([warm], sp_warm)
        eng.generate_many(prompts, params)
        warm_s = time.perf_counter() - t0
        capture_s = eng.stats()['capture_seconds']
        if eng.prefix_cache is not None:
            # a fresh cache: the warm-up pass's refused inserts (every
            # entry pinned, the budget full) leave bare trie nodes, which
            # clear() does not prune and later lookups descend into, so
            # they change the hits (tests/test_torch_prefix_cache.py:
            # test_refused_insert_leaves_the_same_trie_as_jax)
            eng.prefix_cache.clear(force=True)
            eng.prefix_cache = PagedPrefixCache(
                eng.pool, PREFIX_OPTS['prefix_cache'])
        eng.generate_many([warm], sp_warm)
        traces = eng.stats()['traces']
        warm_buckets = set(buckets)
        buckets.clear()
        eng.reset_stats()
        cache0 = eng.prefix_cache.stats() if eng.prefix_cache else {}
        cow0 = eng.pool.stats()['cow_splits']
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        handles = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
        peak_pages = 0
        while eng.has_work:
            eng.step()
            peak_pages = max(peak_pages, eng.pool.used_page_count)
        wall = time.perf_counter() - t0
    finally:
        del eng._run_prefill
    launches = {k: K.LAUNCHES[k] for k in SERVE_KERNELS}
    for h in handles:
        if h.status != FINISHED or len(h.tokens) != 32 or \
                not all(0 <= t < vocab for t in h.tokens):
            raise AssertionError(f'{tag}: request {h} did not finish with '
                                 f'32 tokens in range')
    missing = [k for k, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f'{tag}: kernels never launched on the main '
                             f'path: {missing}')
    st = eng.stats()
    want_traces = expected_traces(eng, warm_buckets)
    if traces != want_traces or st['traces'] != traces:
        raise AssertionError(f'{tag}: captures {traces} before the counted '
                             f'run and {st["traces"]} after it, want '
                             f'{want_traces}')
    if not set(buckets) <= warm_buckets:
        raise AssertionError(f'{tag}: the counted run ran prefills at '
                             f'{sorted(set(buckets) - warm_buckets)}, which '
                             f'the warm-up did not')
    layers = eng.model.config.num_hidden_layers
    want_flash = layers * (st['prefills'] + st['chunk_rounds'])
    if launches['flash_attention_fwd'] != want_flash:
        raise AssertionError(
            f'{tag}: {launches["flash_attention_fwd"]} flash launches, want '
            f'{layers} x ({st["prefills"]} prefills + {st["chunk_rounds"]} '
            f'chunks) = {want_flash}')
    cache = st.get('prefix_cache', {})
    ttft = sorted(h.ttft for h in handles)
    res = {
        'requests': len(handles), 'wall_s': wall,
        'hits': cache.get('hits', 0) - cache0.get('hits', 0),
        'tokens_reused': (cache.get('tokens_reused', 0)
                          - cache0.get('tokens_reused', 0)),
        'evictions': cache.get('evictions', 0) - cache0.get('evictions', 0),
        'chunk_rounds': st['chunk_rounds'],
        'chunked_prefills': st['chunked_prefills'],
        'cow_splits': st['pool']['cow_splits'] - cow0,
        'prefills': st['prefills'], 'requeued': st['requeued'],
        'prefill_tokens': st['prefill_tokens'],
        'prefill_s': st['prefill_seconds'],
        'decode_tokens': st['tokens'], 'decode_s': st['decode_seconds'],
        'decode_tok_per_s': st['tokens'] / st['decode_seconds'],
        'decode_steps': st['decode_steps'],
        'ttft_mean_s': sum(ttft) / len(ttft), 'ttft_max_s': ttft[-1],
        'ttft_p50_s': ttft[len(ttft) // 2],
        'peak_pages': peak_pages,
        'peak_mem_gb': (torch.cuda.max_memory_allocated() - base) / 1e9,
        'launches': launches, 'buckets': dict(sorted(buckets.items())),
        'capture_s': capture_s, 'warm_s': warm_s,
        'tokens': [h.tokens for h in handles],
    }
    log(f'[{tag}] {len(handles)} requests in {wall:.2f} s: prefix hits '
        f'{res["hits"]}, tokens reused {res["tokens_reused"]}, chunk rounds '
        f'{res["chunk_rounds"]} ({res["chunked_prefills"]} chunked '
        f'prefills), COW splits {res["cow_splits"]}, whole prefills '
        f'{res["prefills"]}, prompt tokens computed {res["prefill_tokens"]}'
        f' in {res["prefill_s"]:.3f} s, decode {res["decode_tok_per_s"]:.1f}'
        f' tok/s, TTFT mean {res["ttft_mean_s"]:.3f} s p50 '
        f'{res["ttft_p50_s"]:.3f} s max {res["ttft_max_s"]:.3f} s, pool '
        f'peak {peak_pages} of {eng.pool.num_pages - 1} pages, requeued '
        f'{res["requeued"]}, peak device memory {res["peak_mem_gb"]:.2f} GB '
        f'above {base / 1e9:.2f} GB')
    log(f'[{tag}] kernel launches {launches} (flash = {layers} x every '
        f'prefill and chunk); prefills by (kind, bucket) {res["buckets"]}; '
        f'captures {traces} in {capture_s:.2f} s of the {warm_s:.2f} s '
        f'warm-up')
    return res


def prefix_logits(eng, prompt) -> dict:
    """The last prompt position's logits of `prompt` (a suffix hit)
    through the prefix path, on a slot of `eng`'s pool: the cached pages
    attached, then the suffix through the chunk forward. They must equal,
    bit for bit, the same split computed without the cache (the prompt's
    prefix prefilled into a second slot's own pages, then the same suffix
    chunk): the attached pages hold what a prefill writes. And the chunk
    forward of the whole prompt from row 0 must equal a cold whole-prompt
    forward (no pages) bit for bit. Together they leave, between the
    prefix path and the cold forward, only the split of one forward into
    a prefix and a suffix chunk, whose bf16 sums (products over 44 rows
    instead of 556) run in another order through 32 layers: that reading
    is logged, not held to `compare`'s limits (PERF.md, section 6)."""
    from paddle_tpu_torch.nlp import chunk_forward
    from paddle_tpu_torch.serving import scatter_pages
    pool, ps, model = eng.pool, eng.pool.page_size, eng.model
    node, matched = eng.prefix_cache.lookup(prompt)
    if node is None:
        raise AssertionError('serve-prefix: the logits check found no '
                             'cached prefix')
    cursor = min(matched, node.slot.kv_len) // ps * ps
    fwd = chunk_forward(model)
    ids = torch.tensor([prompt], device=DEV)
    slots = [pool.alloc(), pool.alloc()]
    try:
        pool.attach_prefix(slots[0], node.slot, cursor // ps)
        tables = []
        for slot in slots:
            pool.reserve(slot, len(prompt))
            tables.append(torch.from_numpy(
                pool.page_table[slot:slot + 1]).to(DEV))
        with torch.inference_mode():
            got = fwd(ids[:, cursor:], pool.pages, cursor, tables[0],
                      cursor)[0, -1]
            scatter_pages(pool.pages, tables[1],
                          model.prefill_kv(ids[:, :cursor]),
                          torch.zeros(1, dtype=torch.long, device=DEV))
            split = fwd(ids[:, cursor:], pool.pages, cursor, tables[1],
                        0)[0, -1]
            whole = fwd(ids, pool.pages, 0, tables[1], 0)[0, -1]
            cold = model(ids)[0, -1]
    finally:
        for slot in slots:
            pool.free(slot)
    if not torch.equal(got, split):
        raise AssertionError(f'serve-prefix: logits through the attached '
                             f'pages differ from the same split without '
                             f'the cache: {readings(got, split)}')
    if not torch.equal(whole, cold):
        raise AssertionError(f'serve-prefix: the chunk forward of the whole '
                             f'prompt differs from the cold forward: '
                             f'{readings(whole, cold)}')
    r = readings(got, cold)
    log(f'[serve-prefix] logits of a {len(prompt)}-token prompt through '
        f'{cursor} attached rows + its {len(prompt) - cursor}-token suffix '
        f'== the same split without the cache, bit for bit; the whole '
        f'prompt through the chunk forward == the cold forward, bit for '
        f'bit; the prefix path vs the cold forward: max_abs_err '
        f'{r["max_abs_err"]:.3e} rel_max {r["rel_max"]:.3e} rel_norm '
        f'{r["rel_norm"]:.3e} (bf16 summation order, not a limit), argmax '
        f'{int(got.argmax())} vs {int(cold.argmax())}')
    return r


def pages_free_after_clear(eng, tag: str) -> None:
    eng.prefix_cache.clear(force=True)
    pool = eng.pool
    if pool.free_page_count != pool.num_pages - 1 or \
            pool.stats()['holds_live']:
        raise AssertionError(f'{tag}: after clear(force=True) '
                             f'{pool.used_page_count} pages are still used '
                             f'({pool.stats()["holds_live"]} holds)')
    log(f'[{tag}] after prefix_cache.clear(force=True) all '
        f'{pool.num_pages - 1} pages are free')


def check_prefix_consistency(cfg) -> None:
    """At 2 layers of Llama-2-7B width in f32: the prefix/chunk engine
    (the serve-prefix settings) after the warm-up prompt, over a suffix
    hit of 3, 44 and 380 tokens (two chunks), a cold 900-token prompt
    (four) and the warm-up's exact repeat (a full hit, COW), gives each
    request the tokens of an engine without cache or chunking and of a
    no-cache full recompute (16 greedy tokens)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.serving import InferenceEngine, SamplingParams
    model = LlamaForCausalLM(cfg, device=DEV, dtype='float32',
                             generator=ptt.generator(0, DEV))
    warm, trace = prefix_trace(cfg.vocab_size, np.random.RandomState(6))
    prompts = [trace[i] for i in (0, 3, 5, 6, 11)]
    sp = SamplingParams(max_new_tokens=16, eos_token_id=-1)
    runs = []
    for opts, graph in ((PREFIX_OPTS, True), (PREFIX_OPTS, False), ({}, True)):
        eng = InferenceEngine(model, **PREFIX_ENGINE, **opts)
        eng._capture_decode = eng._capture_prefill = graph
        eng.generate_many([warm], sp)
        runs.append([h.tokens for h in eng.generate_many(prompts, sp)])
        st = eng.stats()
        if opts:
            pc = st['prefix_cache']
            if pc['hits'] < 4 or st['pool']['cow_splits'] != 1 or \
                    st['chunk_rounds'] < 7:
                raise AssertionError(
                    f'prefix consistency: hits {pc["hits"]}, COW '
                    f'{st["pool"]["cow_splits"]}, chunk rounds '
                    f'{st["chunk_rounds"]}: the trace missed a path')
            pages_free_after_clear(eng, 'prefix-consistency')
        del eng
    with torch.inference_mode():
        for j, prompt in enumerate(prompts):
            seq = list(prompt)
            for _ in range(16):
                seq.append(int(model(torch.tensor([seq], device=DEV))
                               [0, -1].argmax()))
            ref = seq[len(prompt):]
            if not runs[0][j] == runs[1][j] == runs[2][j] == ref:
                raise AssertionError(
                    f'prefix consistency: prompt len {len(prompt)}: '
                    f'prefix/chunk engine {runs[0][j]}, its eager twin '
                    f'{runs[1][j]}, cold engine {runs[2][j]}, full '
                    f'recompute {ref}')
    log(f'[prefix-consistency] 2 layers f32, {len(prompts)} requests x 16 '
        f'greedy tokens (suffix hits of 3/44/380 tokens, a cold 900-token '
        f'prompt in chunks, a full hit with its COW split): prefix/chunk '
        f'engine (prefill captured per bucket) == its eager twin == cold '
        f'engine == no-cache full recompute')
    del model
    torch.cuda.empty_cache()


# the serve-prefix engines: (tag, options, decode captured, prefill
# captured). 'eager-prefill' is the configuration before the prefill was
# captured (decode graph, eager prefill), beside the same engine now
PREFIX_RUNS = (
    ('serve-prefix', PREFIX_OPTS, True, True),
    ('serve-prefix eager', PREFIX_OPTS, False, False),
    ('serve-prefix eager-prefill', PREFIX_OPTS, True, False),
    ('serve-prefix cold', {}, True, True),
    ('serve-prefix cold eager-prefill', {}, True, False))
# the prefills phase 7 profiles, with their walls taken here:
# (kind, bucket, start)
PROFILED_PREFILLS = (('whole', 1024, 0), ('chunk', 256, 512))


def reserved_gb() -> float:
    """The device memory PyTorch holds after a collection and the release
    of its cached free blocks (a graph's pool stays held), GB."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 1e9


def prefill_wall(eng, kind: str, bucket: int, start: int = 0,
                 reps: int = 5) -> float:
    """Median host seconds of one prefill of `eng` of `kind` at `bucket`
    (a chunk at `start`, its floor there) into a fresh slot through the
    engine's own call (staging, the step, a device sync), after one
    untimed call (a graph engine captures the bucket there if it has
    not)."""
    pool = eng.pool
    slot = pool.alloc()
    try:
        pool.reserve(slot, start + bucket)
        ids = np.random.RandomState(bucket).randint(
            3, eng.model.config.vocab_size, (bucket,))
        staged = dict(start=start, floor=start) if kind == 'chunk' else {}
        walls = []
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            eng._run_prefill(slot, kind, ids, bucket, **staged)
            walls.append(time.perf_counter() - t0)
    finally:
        pool.free(slot)
    return sorted(walls[1:])[reps // 2]


def serve_prefix(served) -> dict:
    """Phase 6's Llama-2-7B behind the serve-prefix engine (PREFIX_ENGINE
    + PREFIX_OPTS, decode and prefill captured), its eager twin, the
    same engine with its prefill eager (the configuration before the
    prefill was captured) and two cold twins (no cache, no chunking;
    prefill captured and eager), each warmed as `_run_prefix` says; one
    request samples (seeded). Gates: graph == eager == eager-prefill
    tokens, prefix hits >= 13, one COW split, the flash forward once per
    layer of every prefill and chunk, a chunk bucket run, the prefix
    path's logits (`prefix_logits`), and every page free after a forced
    clear. Logs each engine beside the cold twins, the device memory
    each engine holds after its captures, and the walls of the prefills
    phase 7 profiles, captured and eager."""
    from paddle_tpu_torch.serving import (SAMPLING, InferenceEngine,
                                          SamplingParams)
    model = served['engine'].model
    warm, prompts = prefix_trace(model.config.vocab_size,
                                 np.random.RandomState(5))
    params = [SamplingParams(max_new_tokens=32, eos_token_id=-1)
              for _ in prompts]
    params[3] = SamplingParams(max_new_tokens=32, eos_token_id=-1,
                               strategy=SAMPLING, temperature=0.8,
                               top_p=0.9, seed=11)
    runs = {}
    for tag, opts, decode_graph, prefill_graph in PREFIX_RUNS:
        r0 = reserved_gb()
        base = torch.cuda.memory_allocated()
        eng = InferenceEngine(model, **PREFIX_ENGINE, **opts)
        eng._capture_decode, eng._capture_prefill = decode_graph, prefill_graph
        runs[tag] = run = _run_prefix(eng, warm, prompts, params, tag, base)
        run['reserved_gb'] = reserved_gb() - r0
        log(f'[{tag}] device memory the engine holds after its captures '
            f'(reserved): {run["reserved_gb"]:.3f} GB (its KV pool: '
            f'{eng.pool.pool_bytes / 1e9:.3f} GB)')
        if 'cold' not in tag:
            run['engine'] = eng
        del eng      # a cold twin goes here, before the next baseline
    res, eager, parent = (runs[t] for t in (
        'serve-prefix', 'serve-prefix eager', 'serve-prefix eager-prefill'))
    for j, (a, b, c) in enumerate(zip(res['tokens'], eager['tokens'],
                                      parent['tokens'])):
        if not a == b == c:
            raise AssertionError(f'serve-prefix: request {j}: graph {a}, '
                                 f'eager {b}, eager prefill {c}')
    if res['hits'] < PREFIX_MIN_HITS or res['cow_splits'] != 1:
        raise AssertionError(f'serve-prefix: {res["hits"]} prefix hits '
                             f'(want >= {PREFIX_MIN_HITS}), '
                             f'{res["cow_splits"]} COW splits (want 1)')
    if not any(kind == 'chunk' for kind, _ in res['buckets']):
        raise AssertionError('serve-prefix: no chunk prefill ran')
    cold = runs['serve-prefix cold']
    same = sum(a == b for a, b in zip(res['tokens'], cold['tokens']))
    log(f'[serve-prefix] graph == eager == eager prefill: the tokens of all '
        f'{len(prompts)} requests are equal (sampling included); '
        f'{same} of {len(prompts)} equal the cold twin\'s (bf16: a '
        f'suffix chunk sums its projections in another order than a whole '
        f'prefill)')
    for key, fmt in (('hits', 'd'), ('tokens_reused', 'd'),
                     ('chunk_rounds', 'd'), ('cow_splits', 'd'),
                     ('prefill_tokens', 'd'), ('prefill_s', '.3f'),
                     ('decode_tok_per_s', '.1f'), ('ttft_mean_s', '.3f'),
                     ('ttft_p50_s', '.3f'), ('ttft_max_s', '.3f'),
                     ('peak_pages', 'd'), ('wall_s', '.3f'),
                     ('capture_s', '.3f'), ('reserved_gb', '.3f')):
        log(f'[serve-prefix]   {key}: ' + ', '.join(
            f'{tag[13:] or "prefix/chunk"} {run[key]:{fmt}}'
            for tag, run in runs.items()))
    for tag in ('serve-prefix', 'serve-prefix eager-prefill'):
        for cold_tag in ('serve-prefix cold', 'serve-prefix cold '
                                              'eager-prefill'):
            run, c = runs[tag], runs[cold_tag]
            log(f'[serve-prefix]   {tag[13:] or "prefix/chunk"} against '
                f'{cold_tag[13:]}: prefill wall {run["prefill_s"]:.3f} vs '
                f'{c["prefill_s"]:.3f} s, TTFT mean {run["ttft_mean_s"]:.3f}'
                f' vs {c["ttft_mean_s"]:.3f} s (p50 {run["ttft_p50_s"]:.3f} '
                f'vs {c["ttft_p50_s"]:.3f}, max {run["ttft_max_s"]:.3f} vs '
                f'{c["ttft_max_s"]:.3f}), decode '
                f'{run["decode_tok_per_s"]:.1f} vs '
                f'{c["decode_tok_per_s"]:.1f} tok/s')
    eng = res['engine']
    res['logits'] = prefix_logits(eng, prompts[3])
    for tag in ('serve-prefix', 'serve-prefix eager',
                'serve-prefix eager-prefill'):
        pages_free_after_clear(runs[tag]['engine'], tag)
    # before any profiling: the walls phase 7 sets its device times beside
    res['walls'] = {}
    for kind, bucket, start in PROFILED_PREFILLS:
        for label, e in (('captured', eng), ('eager', parent['engine'])):
            res['walls'][(kind, bucket, label)] = w = prefill_wall(
                e, kind, bucket, start)
            log(f'[serve-prefix] {kind} prefill at bucket {bucket}'
                + (f' (start {start})' if kind == 'chunk' else '')
                + f', {label}: wall {w * 1e3:.2f} ms (median of 5)')
    ms = whole_row_gather_ms(eng)
    layers = model.config.num_hidden_layers
    log(f'[serve-prefix] the captured chunk\'s whole-row gather: '
        f'{ms:.4f} ms of device time per layer (K and V, '
        f'{eng.pool.max_length} rows), {layers * ms:.3f} ms per chunk '
        f'forward of {layers} layers')
    res['gather_ms'] = ms
    res['eager'], res['eager_prefill'] = eager, parent
    res['params'] = params
    release(eager)
    return res


# ---------------------------------------------------------------------------
# phase 6d: serve with int8 paged KV
# ---------------------------------------------------------------------------

# the JAX package's int8 KV quality bound: relative decode-logit RMSE
# against float KV (bench.py:1537, PAGED_INT8_RMSE_BOUND; a copy, as
# bench.py is the JAX side's), set on the bench's 4-layer f32 GPT
# (bench.py:1153-1165, paged_int8_rmse :1540). The scheme's own error
# grows with depth: on random-weight Llama-2-7B width, the bench's int8
# arm (pages roundtripped through int8) is 0.025 at 2 f32 layers and
# 0.081 at 32 (`python3 chip_smoke.py --int8-rmse`; PERF.md). So
# the bound gates phase 3 (2 f32 layers); at 32 layers (phase 6d) the
# port's int8 KV must cost no more than INT8_REF_SLACK times the
# bench's int8 arm on the same model and prompts.
INT8_RMSE_BOUND = 0.05
INT8_REF_SLACK = 1.25
# f32: the int8 engine against the float engine over int8-roundtripped
# pages (the same function, sums in another order; 1.2e-6 measured)
INT8_EXACT = 1e-4


def roundtrip_pages(pool) -> None:
    """Every page of a float pool through int8 and back, in place, each
    at its own per-(page, kv head) absmax scale: the JAX bench's int8 arm
    (bench.py:paged_int8_rmse's `roundtrip`)."""
    from paddle_tpu_torch.quantization import (kv_dequantize_page,
                                               kv_page_scales,
                                               kv_quantize_page)
    for kv in pool.pages:
        for t in kv:
            sc = kv_page_scales(t)
            t.copy_(kv_dequantize_page(kv_quantize_page(t, sc), sc, t.dtype))


def first_step_logits(eng, prompts, roundtrip=False) -> torch.Tensor:
    """[len(prompts), V] f32 logits of each prompt's first decode sub-step
    on `eng`: its whole prefill as the engine runs it (captured or
    eager), then one sub-step of a staged round (after the round's window
    fill over int8 pages), as many prompts at once as the engine has
    slots; the slots are freed after, and no token is emitted. With
    `roundtrip` (a float pool) the pages go through int8 and back
    between the prefill and the sub-step (`roundtrip_pages`)."""
    from paddle_tpu_torch.serving import SamplingParams
    one = SamplingParams(max_new_tokens=1, eos_token_id=-1)
    out = []
    for i in range(0, len(prompts), eng.pool.num_slots):
        handles = [eng.submit(p, one) for p in
                   prompts[i:i + eng.pool.num_slots]]
        eng._admit()
        slot_of = {id(h): s for s, h in eng._slot_req.items()}
        with torch.inference_mode():
            if roundtrip:
                roundtrip_pages(eng.pool)
            step = eng._stage_round()
            if step.side:
                step.run_side('_round_begin')
            logits = step.run_once().clone()
        for h in handles:
            slot = slot_of[id(h)]
            out.append(logits[slot])
            eng._detach_slot(slot, h)
            eng.pool.free(slot)
    eng.reset_stats()
    return torch.stack(out)


def rel_rmse(got, want) -> float:
    """The JAX bench's relative logit RMSE (bench.py:paged_int8_rmse):
    |got - want| over the norm of `want` about each row's mean, fp64."""
    got, want = got.double(), want.double()
    ref = want - want.mean(dim=-1, keepdim=True)
    return float((got - want).norm() / ref.norm())


def serve_int8(served, prefixed) -> dict:
    """Phase 6's Llama-2-7B behind the same engine with `kv_quant='int8'`:
    phase 6's 12 requests (graph and eager twin), then phase 6c's
    serve-prefix trace (`PREFIX_OPTS`, graph and eager twin, each warmed
    as `_run_prefix` says). Gates: graph tokens equal eager tokens in
    both; `traces` exactly the buckets run; the paged kernel launched
    once per layer of every decode sub-step (replays counted); the first
    decode sub-step's relative logit RMSE of phase 6's prompts against
    phase 6's bf16-KV engine at most INT8_REF_SLACK times that of the
    JAX bench's int8 arm (the bf16 engine over its pages roundtripped
    through int8). Logs each beside phase 6 and 6c: pool bytes, decode
    tok/s, TTFT, peak used pages."""
    from paddle_tpu_torch.serving import InferenceEngine
    bf16 = served['engine']
    model = bf16.model
    layers = model.config.num_hidden_layers
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng = InferenceEngine(model, num_slots=8, max_length=1024,
                          decode_block=8, kv_page_size=16, kv_quant='int8')
    log(f'[serve-int8] KV pool {eng.pool.num_pages} pages, '
        f'{eng.pool.pool_bytes / 1e9:.3f} GB int8 with scales, against '
        f'{bf16.pool.pool_bytes / 1e9:.3f} GB bf16 (phase 6); window '
        f'{sum(t.nbytes for kv in eng._decode._windows for t in kv) / 1e6:.1f}'
        f' MB')
    prompts, params = served['prompts'], served['params']
    res = _run_serve(eng, prompts, params, None, SERVE_KERNELS, 'serve-int8',
                     base)
    eager = serve_eager(eng, res, prompts, params, None, SERVE_KERNELS,
                        'serve-int8')
    want = first_step_logits(bf16, prompts)
    got = first_step_logits(eng, prompts)
    ref = first_step_logits(bf16, prompts, roundtrip=True)
    rmse, ref_rmse = rel_rmse(got, want), rel_rmse(ref, want)
    agree = int((got.argmax(-1) == want.argmax(-1)).sum())
    log(f'[serve-int8] first decode sub-step of the {len(prompts)} prompts: '
        f'relative logit RMSE {rmse:.4e} against the bf16-KV engine, the '
        f'JAX bench\'s int8 arm (its pages roundtripped through int8) '
        f'{ref_rmse:.4e} (limit {INT8_REF_SLACK} x that; the bench\'s '
        f'4-layer bound {INT8_RMSE_BOUND}), against each other '
        f'{rel_rmse(got, ref):.4e}; argmax equal on {agree} of '
        f'{len(prompts)}')
    if not rmse <= INT8_REF_SLACK * ref_rmse:
        raise AssertionError(f'serve-int8: relative logit RMSE {rmse:.4e} '
                             f'> {INT8_REF_SLACK} x the bench\'s int8 arm\'s '
                             f'{ref_rmse:.4e}')
    same = sum(a == b for a, b in zip(res['tokens'], served['tokens']))
    log(f'[serve-int8] {same} of {len(prompts)} requests get the bf16-KV '
        f'engine\'s 32 tokens')
    # the serve-prefix trace
    warm, trace = prefix_trace(model.config.vocab_size,
                               np.random.RandomState(5))
    pparams = prefixed['params']
    runs = {}
    for tag, graph in (('serve-int8-prefix', True),
                       ('serve-int8-prefix eager', False)):
        torch.cuda.synchronize()
        pbase = torch.cuda.memory_allocated()
        e = InferenceEngine(model, **PREFIX_ENGINE, **PREFIX_OPTS,
                            kv_quant='int8')
        e._capture_decode = e._capture_prefill = graph
        runs[tag] = _run_prefix(e, warm, trace, pparams, tag, pbase)
        pages_free_after_clear(e, tag)
        del e
    pre, pre_eager = runs['serve-int8-prefix'], runs['serve-int8-prefix eager']
    if pre['tokens'] != pre_eager['tokens']:
        diff = {j: next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
                for j, (a, b) in enumerate(zip(pre['tokens'],
                                               pre_eager['tokens'])) if a != b}
        raise AssertionError(f'serve-int8-prefix: graph and eager tokens '
                             f'differ in requests {diff} ({{request: first '
                             f'position}}): graph {pre["tokens"]} eager '
                             f'{pre_eager["tokens"]}')
    log(f'[serve-int8-prefix] graph == eager: the tokens of all '
        f'{len(trace)} requests are equal (sampling included)')
    for tag, run in (('serve-int8', res), ('serve-int8 eager', eager),
                     ('serve-int8-prefix', pre),
                     ('serve-int8-prefix eager', pre_eager)):
        want_paged = layers * run['decode_steps']
        if run['launches']['paged_attention'] != want_paged:
            raise AssertionError(
                f'{tag}: {run["launches"]["paged_attention"]} paged launches,'
                f' want {layers} x {run["decode_steps"]} decode sub-steps = '
                f'{want_paged}')
    log(f'[serve-int8] int8 paged launches = {layers} x decode sub-steps on '
        f'all four runs ({res["launches"]["paged_attention"]} on the graph '
        f'serve run, replays counted)')
    for key, fmt in (('decode_tok_per_s', '.1f'), ('ttft_mean_s', '.3f'),
                     ('ttft_p50_s', '.3f'), ('ttft_max_s', '.3f'),
                     ('peak_pages', 'd'), ('prefill_s', '.3f'),
                     ('peak_mem_gb', '.3f')):
        log(f'[serve-int8]   {key}: serve int8 {res[key]:{fmt}} (eager '
            f'{eager[key]:{fmt}}) vs bf16 {served[key]:{fmt}}; serve-prefix '
            f'int8 {pre[key]:{fmt}} (eager {pre_eager[key]:{fmt}}) vs bf16 '
            f'{prefixed[key]:{fmt}}')
    prefix_same = sum(a == b for a, b in zip(pre['tokens'],
                                             prefixed['tokens']))
    log(f'[serve-int8-prefix] hits {pre["hits"]}, COW splits '
        f'{pre["cow_splits"]}, chunk rounds {pre["chunk_rounds"]} (bf16: '
        f'{prefixed["hits"]}, {prefixed["cow_splits"]}, '
        f'{prefixed["chunk_rounds"]}); {prefix_same} of {len(trace)} '
        f'requests get the bf16-KV tokens')
    res.update(engine=eng, eager=eager, prefix=pre, rmse=rmse,
               ref_rmse=ref_rmse, prompts=prompts)
    res['launches']['paged_attention_int8_window'] = \
        res['launches'].pop('paged_attention')
    return res


# ---------------------------------------------------------------------------
# phase 6e: serve with speculative decoding; 6f: drain, evict and swap
# ---------------------------------------------------------------------------

def first_difference(a, b):
    """The first position where two token lists differ, or None."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def serve_spec(served) -> dict:
    """Phase 6's model, requests and engine settings with a draft model
    (k = SPEC_K), two drafts in turn: the JAX bench's same-width 2-layer
    draft with random weights (bench.py:361-370) and the model itself
    (the acceptance ceiling). Each on the graph engine and its eager twin
    (`_run_serve`, `serve_eager`): equal tokens, the verify kernel once
    per layer of every round (replays counted). Logs decode tok/s, TTFT,
    tokens per round per greedy slot and the acceptance rate beside phase
    6, and how many requests get phase 6's tokens (a reading: in bf16 a
    5-row verify can round differently from a 1-row step). With the
    2-layer draft also the wall of one round with every slot busy, graph
    and eager, before any profiling (phase 7's idle shares use it). Runs
    right after phase 6, while only its engines hold device memory, and
    frees its engines. Returns {'draft2': run, 'self': run, 'model',
    'draft'}."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.serving import InferenceEngine
    model = served['engine'].model
    layers = model.config.num_hidden_layers
    draft = LlamaForCausalLM(draft_config(model.config, 2), device=DEV,
                             dtype='bfloat16',
                             generator=ptt.generator(4321, DEV))
    greedy = [j for j, sp in enumerate(served['params'])
              if sp.strategy != 'sampling']
    out = {}
    for key, d, label in (('draft2', draft, '2-layer random draft'),
                          ('self', model, 'self-draft')):
        tag = f'serve-spec {label}'
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        eng = InferenceEngine(model, num_slots=8, max_length=1024,
                              kv_page_size=16, draft_model=d,
                              num_draft_tokens=SPEC_K)
        res = _run_serve(eng, served['prompts'], served['params'], None,
                         SPEC_KERNELS, tag, base)
        spec = eng.stats()['spec']
        want = layers * res['decode_steps']
        if res['launches']['paged_attention_verify'] != want or \
                spec['rounds'] != res['decode_steps']:
            raise AssertionError(
                f'{tag}: {res["launches"]["paged_attention_verify"]} verify '
                f'launches, want {layers} x {res["decode_steps"]} rounds')
        eager = serve_eager(eng, res, served['prompts'], served['params'],
                            None, SPEC_KERNELS, tag)
        if key == 'draft2':
            for run, e in ((res, eng), (eager, eager['engine'])):
                run['round_wall_s'] = spec_round_wall(e, served['prompts'])
        per_round = 1 + spec['accepted'] / max(spec['proposed'] / SPEC_K, 1)
        same = [j for j in range(len(res['tokens']))
                if res['tokens'][j] == served['tokens'][j]]
        diffs = {j: first_difference(res['tokens'][j], served['tokens'][j])
                 for j in range(len(res['tokens'])) if j not in same}
        log(f'[{tag}] k={SPEC_K}: {spec["rounds"]} rounds, acceptance rate '
            f'{spec["acceptance_rate"]:.4f}, {per_round:.3f} tokens per round '
            f'per greedy slot; decode {res["decode_tok_per_s"]:.1f} tok/s = '
            f'{res["decode_tok_per_s"] / served["decode_tok_per_s"]:.3f} x '
            f'phase 6\'s {served["decode_tok_per_s"]:.1f} (same process), '
            f'TTFT mean {res["ttft_mean_s"]:.3f} s p50 '
            f'{res["ttft_p50_s"]:.3f} s max {res["ttft_max_s"]:.3f} s (phase '
            f'6: {served["ttft_mean_s"]:.3f} / {served["ttft_p50_s"]:.3f} / '
            f'{served["ttft_max_s"]:.3f})')
        log(f'[{tag}] {len(same)} of {len(res["tokens"])} requests '
            f'({sum(j in same for j in greedy)} of {len(greedy)} greedy) get '
            f'phase 6\'s tokens; first differing position by request '
            f'{diffs}')
        res.update(engine=eng, eager=eager, spec=spec,
                   tokens_per_round=per_round)
        release(res)
        out[key] = res
    out.update(model=model, draft=draft, prompts=served['prompts'])
    return out


def spec_round_wall(eng, prompts) -> float:
    """Seconds of one speculation round of `eng` with every slot busy
    (its first round admits and prefills them), unprofiled; the engine
    is drained after."""
    n = eng.pool.num_slots
    for p in prompts[:n]:
        eng.submit(p, max_new_tokens=4 * (SPEC_K + 1), eos_token_id=-1)
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    wall = time.perf_counter() - t0
    eng.run()
    return wall


def drain_swap(served) -> dict:
    """On a fresh engine with phase 6's settings: `swap_weights` to a host
    copy of the weights with layer 0's MLP perturbed, then
    `restore_weights` (each one's seconds logged: 13.5 GB each way, the
    swap also taking the host copy of the old weights), after which the
    12 requests get phase 6's tokens with nothing captured again;
    `evict_all()` after two steps hands back all 12 with every page
    free; `drain()` after two steps finishes all 12 with phase 6's
    tokens."""
    from paddle_tpu_torch.serving import FINISHED, InferenceEngine
    model = served['engine'].model
    prompts, params = served['prompts'], served['params']
    eng = InferenceEngine(model, num_slots=8, max_length=1024,
                          decode_block=8, kv_page_size=16)
    eng.generate_many(prompts, params)          # captures what it uses
    traces = dict(eng.stats()['traces'])
    t0 = time.perf_counter()
    state = perturbed_state(model)
    t_state = time.perf_counter() - t0
    t0 = time.perf_counter()
    prev = eng.swap_weights(state, version=1)
    t_swap = time.perf_counter() - t0
    moved = sum(h.tokens != want for h, want in zip(
        eng.generate_many(prompts, params), served['tokens']))
    t0 = time.perf_counter()
    eng.restore_weights(prev)
    t_restore = time.perf_counter() - t0
    del state, prev
    back = [h.tokens for h in eng.generate_many(prompts, params)]
    if back != served['tokens'] or eng.stats()['traces'] != traces:
        raise AssertionError(f'swap: after the restore the tokens differ '
                             f'from phase 6 or captures moved '
                             f'({eng.stats()["traces"]} vs {traces})')
    gb = nbytes(*model.parameters()) / 1e9
    log(f'[swap] {gb:.2f} GB of weights: the host copy of the new weights '
        f'took {t_state:.3f} s; swap_weights {t_swap:.3f} s (a host copy of '
        f'the old weights, then the new ones copied in place), '
        f'restore_weights {t_restore:.3f} s; the swap moved {moved} of '
        f'{len(prompts)} requests, and after the restore all get phase 6\'s '
        f'tokens; captures unchanged')
    hs = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    eng.step()
    eng.step()
    out = eng.evict_all()
    if sorted(h.request_id for h in out) != sorted(h.request_id for h in hs) \
            or eng.pool.free_page_count != eng.pool.num_pages - 1:
        raise AssertionError(f'evict_all: {len(out)} of {len(hs)} handles, '
                             f'{eng.pool.used_page_count} pages still used')
    hs = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    eng.step()
    eng.step()
    t0 = time.perf_counter()
    ok = eng.drain()
    t_drain = time.perf_counter() - t0
    if not ok or any(h.status != FINISHED for h in hs) or \
            [h.tokens for h in hs] != served['tokens']:
        raise AssertionError('drain: not every request finished with phase '
                             '6\'s tokens')
    log(f'[drain] evict_all() after two steps: {len(out)} handles back, all '
        f'{eng.pool.num_pages - 1} pages free; drain() after two steps '
        f'finished all {len(hs)} requests in {t_drain:.3f} s with phase 6\'s '
        f'tokens')
    del eng
    torch.cuda.empty_cache()
    return dict(swap_s=t_swap, restore_s=t_restore, state_s=t_state)


# ---------------------------------------------------------------------------
# phase 6g: the adapter store and the weight store
# ---------------------------------------------------------------------------

# where 6g's stores live while it runs (inside the checkout's build
# directory, which .gitignore lists); each run makes and removes its own
STORE_ROOT = Path(__file__).resolve().parent / 'build' / 'stores'


def _store_dir(prefix: str) -> Path:
    STORE_ROOT.mkdir(parents=True, exist_ok=True)
    return Path(tempfile.mkdtemp(prefix=prefix, dir=STORE_ROOT))


def _flip_payload(store, version: int) -> None:
    """Flip one byte in the middle of a committed version's payload (a torn
    write or bit rot, which its sha256 manifest must catch)."""
    payload = Path(store.directory) / f'step_{version}' / 'tree.npz'
    raw = bytearray(payload.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    payload.write_bytes(bytes(raw))


def _timed_loads(bank) -> list:
    """Wrap `bank`'s store load and slot write to log each one's seconds
    (synchronised): [(adapter, version, load s or None on a reject,
    slot-copy s)]."""
    loads = []
    load, write = bank._load_version, bank._write_slot

    def timed_write(*args):
        t0 = time.perf_counter()
        write(*args)
        torch.cuda.synchronize()
        loads[-1][3] = time.perf_counter() - t0

    def timed_load(adapter_id, store, version):
        loads.append([adapter_id, version, None, None])
        t0 = time.perf_counter()
        slot = load(adapter_id, store, version)
        torch.cuda.synchronize()
        if slot is not None:
            loads[-1][2] = time.perf_counter() - t0
        return slot

    bank._load_version, bank._write_slot = timed_load, timed_write
    return loads


def _count_launches(run: dict, launches: dict) -> None:
    """Add a segment's kernel launches into `run['launches']`."""
    for k, n in launches.items():
        run['launches'][k] = run['launches'].get(k, 0) + n


def serve_adapter_store(served, adapted) -> dict:
    """Phase 6b's model, prompts, parameters and mix behind a store-backed
    bank (f32, rank 8, capacity 4, q/k/v/o_proj, its store a fresh
    directory removed at the end): ad0..ad2 published once each with 6b's
    factors, the 12 requests served through pins that load them from the
    store (every request's tokens == 6b's); then ad0 v2 published while an
    ad0 request decodes (it keeps 6b's tokens; a new ad0 request gets v2,
    in another slot, with the tokens of a fresh bank `load`ed with v2); a
    corrupt v3 (quarantined, v2 keeps serving); then a capacity-2 bank on
    the same store with three adapters in flight (each request gets its
    tokens alone, some admission requeued). Nothing is captured after
    each engine's warm-up, and the adapter kernel runs once per adapted
    projection of every prefill and decode sub-step. Logs one publish,
    each hot load (store read + sha256 + slot copy) and its slot copy,
    the round that admits the v2 request beside one that admits nothing,
    and the pool's and the bank's bytes. Frees its engines."""
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import (AdapterBank, InferenceEngine,
                                          WeightStore, make_adapter_factors)
    model = served['engine'].model
    prompts, params, ids = served['prompts'], served['params'], adapted['ids']
    root = _store_dir('adapters-')
    tag = 'adapter-store'
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        bank = AdapterBank(model, capacity=4, rank=8, targets=ADAPTER_TARGETS,
                           dtype='float32', store_dir=str(root))
        publish_s = []
        for i in range(3):
            t0 = time.perf_counter()
            bank.publish(f'ad{i}', make_adapter_factors(bank, seed=i + 1))
            publish_s.append(time.perf_counter() - t0)
        ad_mb = sum(nbytes(torch.from_numpy(x)) for a_b in
                    make_adapter_factors(bank, seed=1).values()
                    for x in a_b) / 1e6
        loads = _timed_loads(bank)
        eng = InferenceEngine(model, num_slots=8, max_length=1024,
                              decode_block=8, kv_page_size=16,
                              adapter_bank=bank)
        res = _run_serve(eng, prompts, params, ids, ADAPTER_KERNELS, tag,
                         base)
        sites = len(bank.sites)
        want = sites * (res['prefills'] + res['decode_steps'])
        if res['tokens'] != adapted['tokens'] or \
                res['launches']['adapter_matmul'] != want:
            raise AssertionError(
                f'{tag}: tokens differ from 6b on requests '
                f'{[j for j, (a, b) in enumerate(zip(res["tokens"], adapted["tokens"])) if a != b]}'
                f' or {res["launches"]["adapter_matmul"]} adapter launches '
                f'!= {want}')
        traces = dict(eng.stats()['traces'])
        log(f'[{tag}] published ad0..ad2 (v1 each, {ad_mb:.1f} MB of f32 '
            f'factors a version) in {", ".join(f"{s:.3f}" for s in publish_s)}'
            f' s; the wave\'s pins loaded them from the store: '
            + '; '.join(f'{a} v{v} {t * 1e3:.1f} ms (slot copy '
                        f'{c * 1e3:.2f} ms)' for a, v, t, c in loads)
            + f'; all 12 requests == phase 6b\'s tokens, {want} adapter '
            f'launches = {sites} x ({res["prefills"]} prefills + '
            f'{res["decode_steps"]} sub-steps)')

        # a publish while an ad0 request decodes, then a corrupt version
        j = ids.index('ad0')
        prompt, sp = prompts[j], params[j]
        loads.clear()
        eng.reset_stats()
        K.reset_launch_counts()
        h1 = eng.submit(prompt, sp, adapter_id='ad0')
        eng.step()                       # admit, prefill, one round
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        plain_round = time.perf_counter() - t0
        if h1.done or h1.adapter_version != 1:
            raise AssertionError(f'{tag}: the v1 request is not mid-decode')
        t0 = time.perf_counter()
        v2 = bank.publish('ad0', make_adapter_factors(bank, seed=11))
        publish_v2 = time.perf_counter() - t0
        h2 = eng.submit(prompt, sp, adapter_id='ad0')
        t0 = time.perf_counter()
        eng.step()                       # admits h2: hot load + prefill
        admit_round = time.perf_counter() - t0
        slot1, slot2 = h1._adapter_pin, h2._adapter_pin
        eng.run()
        store = WeightStore(str(root / 'ad0'))
        t0 = time.perf_counter()
        store.mgr.verify(v2)
        verify_s = time.perf_counter() - t0
        hot = list(loads)
        v3 = bank.publish('ad0', make_adapter_factors(bank, seed=12))
        _flip_payload(store, v3)
        h3 = eng.submit(prompt, sp, adapter_id='ad0')
        eng.run()
        st = eng.stats()
        launches = {k: K.LAUNCHES[k] for k in ADAPTER_KERNELS}
        _count_launches(res, launches)
        want = sites * (st['prefills'] + st['decode_steps'])

        # the v2 reference: a fresh bank `load`ed with v2, eager, a pool of
        # one request's pages
        ref_bank = AdapterBank(model, capacity=4, rank=8,
                               targets=ADAPTER_TARGETS, dtype='float32')
        ref_bank.load('ad0', make_adapter_factors(ref_bank, seed=11))
        ref = InferenceEngine(model, num_slots=8, max_length=1024,
                              decode_block=8, kv_page_size=16,
                              kv_pages=1 + 1024 // 16, adapter_bank=ref_bank)
        ref._capture_decode = ref._capture_prefill = False
        v2_tokens = ref.generate_many([prompt], sp,
                                      adapter_ids='ad0')[0].tokens
        del ref, ref_bank
        problems = []
        if h1.tokens != adapted['tokens'][j]:
            problems.append('the v1 request left 6b\'s tokens')
        if (h2.adapter_version, h2.tokens) != (v2, v2_tokens) or \
                slot2 in (None, slot1):
            problems.append(f'the new request got v{h2.adapter_version} in '
                            f'slot {slot2} (v1 in {slot1})')
        if (h3.adapter_version, h3.tokens) != (v2, v2_tokens) or \
                store.quarantined() != [v3]:
            problems.append(f'after the corrupt v3: v{h3.adapter_version}, '
                            f'quarantined {store.quarantined()}')
        if st['traces'] != traces or launches['adapter_matmul'] != want:
            problems.append(f'captures {st["traces"]} (after the warm-up '
                            f'{traces}), {launches["adapter_matmul"]} '
                            f'adapter launches, want {want}')
        if problems:
            raise AssertionError(f'{tag}: ' + '; '.join(problems))
        pool_gb = eng.pool.pool_bytes / 1e9
        bank_mb = nbytes(*[t for s in bank.sites
                           for t in (bank._a[s], bank._b[s])],
                         bank._scale) / 1e6
        log(f'[{tag}] ad0 v2 published in {publish_v2:.3f} s while a v1 '
            f'request decoded (slot {slot1}); the round that admitted the v2 '
            f'request (hot load, prefill of {len(prompt)} tokens, decode '
            f'round) {admit_round * 1e3:.1f} ms beside a round that admitted '
            f'nothing {plain_round * 1e3:.1f} ms; its hot load '
            + '; '.join(f'{a} v{v} {t * 1e3:.1f} ms (slot copy '
                        f'{c * 1e3:.2f} ms)' for a, v, t, c in hot)
            + f', the sha256 of the version alone {verify_s * 1e3:.1f} ms; '
            f'v1 request == 6b\'s tokens, v2 request in slot {slot2} == a '
            f'fresh bank loaded with v2; corrupt v3 quarantined '
            f'({store.quarantined()}), v2 still served; captures unchanged; '
            f'{want} adapter launches = {sites} x ({st["prefills"]} prefills'
            f' + {st["decode_steps"]} sub-steps); KV pool {pool_gb:.2f} GB, '
            f'bank {bank_mb:.1f} MB')
        del eng, bank, h1, h2, h3
        gc.collect()
        torch.cuda.empty_cache()

        # saturated: three adapters in flight on two slots
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        sat_bank = AdapterBank(model, capacity=2, rank=8,
                               targets=ADAPTER_TARGETS, dtype='float32',
                               store_dir=str(root))
        sat = InferenceEngine(model, num_slots=8, max_length=1024,
                              decode_block=8, kv_page_size=16,
                              adapter_bank=sat_bank)
        order = [ids.index(a) for a in ('ad0', 'ad1', 'ad2')]
        run = _run_serve(sat, [prompts[j] for j in order],
                         [params[j] for j in order], ['ad0', 'ad1', 'ad2'],
                         ADAPTER_KERNELS, f'{tag} saturated', base)
        st = sat.stats()
        alone = [v2_tokens] + [adapted['tokens'][j] for j in order[1:]]
        want = sites * (run['prefills'] + run['decode_steps'])
        if run['tokens'] != alone or st['requeued'] < 1 or st['failed'] or \
                run['launches']['adapter_matmul'] != want:
            raise AssertionError(
                f'{tag} saturated: tokens == alone '
                f'{[a == b for a, b in zip(run["tokens"], alone)]}, '
                f'requeued {st["requeued"]}, failed {st["failed"]}, '
                f'{run["launches"]["adapter_matmul"]} adapter launches, '
                f'want {want}')
        _count_launches(res, run['launches'])
        log(f'[{tag} saturated] 3 adapters in flight on 2 slots: '
            f'{st["requeued"]} admissions requeued, none failed; every '
            f'request == its tokens alone (ad0 at v2); {want} adapter '
            f'launches')
        del sat, sat_bank
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def weight_store_swap(served) -> dict:
    """The weight store at Llama-2-7B width, 2 bf16 layers (a version of
    the full 32 layers is 13.5 GB; two would write 27 GB to disk), on a
    graph engine of phase 6's settings: v1 published from the model by
    `WeightPublisher`, v2 a copy with layer 0's MLP perturbed, v3 a copy
    with one bf16 NaN. v2: load (sha256 checked), `finite_weights_gate`
    (passes), `swap_weights`, and a `CanaryGate` whose expected tokens come
    from a fresh engine on a model given v2's weights (passes). v3: load,
    the gate refuses it, `quarantine`, the store's latest is v2 again, and
    `restore_weights` gives v1's tokens. Nothing is captured after the
    warm-up. Logs publish and load GB/s, the sha256 seconds and the swap
    seconds. Frees what it made."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import (CanaryGate, InferenceEngine,
                                          SamplingParams, WeightPublisher,
                                          WeightStore, finite_weights_gate)
    tag = 'weight-store'
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2)
    model = LlamaForCausalLM(cfg, device=DEV, dtype='bfloat16',
                             generator=ptt.generator(1234, DEV))
    gb = nbytes(*model.parameters()) / 1e9
    prompts = served['prompts'][:4]
    sp = SamplingParams(max_new_tokens=8, eos_token_id=-1)
    root = _store_dir('weights-')
    try:
        K.reset_launch_counts()
        eng = InferenceEngine(model, num_slots=8, max_length=1024,
                              decode_block=8, kv_page_size=16)
        v1_tokens = [h.tokens for h in eng.generate_many(prompts, sp)]
        traces = dict(eng.stats()['traces'])
        store = WeightStore(str(root))
        t0 = time.perf_counter()
        WeightPublisher(model, store).publish(step=0)      # v1
        publish_s = time.perf_counter() - t0
        state = perturbed_state(model)
        v2 = store.publish(state, meta={'step': 1})
        name = 'llama.layers.1.self_attn.q_proj.weight'
        nan = state[name].clone()
        nan.view(-1)[nan.numel() // 3] = float('nan')
        v3 = store.publish({**state, name: nan}, meta={'step': 2})
        del state, nan
        t0 = time.perf_counter()
        store.mgr.verify(v2)
        verify_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tree = store.load(v2)
        load_s = time.perf_counter() - t0
        gate = finite_weights_gate(eng, v2, tree)
        t0 = time.perf_counter()
        prev = eng.swap_weights(tree, version=v2)
        swap_s = time.perf_counter() - t0
        fresh_model = LlamaForCausalLM(cfg, device=DEV, dtype='bfloat16',
                                       generator=ptt.generator(1, DEV))
        fresh_model.load_state_dict({
            k: v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
            for k, v in tree.items()})
        fresh = InferenceEngine(fresh_model, num_slots=8, max_length=1024,
                                decode_block=8, kv_page_size=16)
        expect = fresh.generate_many([prompts[0]], sp)[0].tokens
        del fresh, fresh_model, tree
        canary = CanaryGate(prompts[0], max_new_tokens=8, expect=expect)(
            eng, v2, None)
        moved = [h.tokens for h in eng.generate_many(prompts, sp)]
        tree3 = store.load(v3)
        refused = finite_weights_gate(eng, v3, tree3)
        del tree3
        if not refused[0]:
            store.quarantine(v3, refused[1])
        latest = store.latest_version()
        eng.restore_weights(prev)
        back = [h.tokens for h in eng.generate_many(prompts, sp)]
        launches = {k: K.LAUNCHES[k] for k in SERVE_KERNELS}
        problems = []
        if gate != (True, '') or canary != (True, ''):
            problems.append(f'v2: gate {gate}, canary {canary}')
        if moved == v1_tokens:
            problems.append('v2 moved no token')
        if refused[0] or store.quarantined() != [v3] or latest != v2:
            problems.append(f'v3: gate {refused}, quarantined '
                            f'{store.quarantined()}, latest {latest}')
        if back != v1_tokens or eng.stats()['traces'] != traces:
            problems.append(f'after the restore: tokens == v1 '
                            f'{back == v1_tokens}, captures '
                            f'{eng.stats()["traces"]} vs {traces}')
        if problems:
            raise AssertionError(f'{tag}: ' + '; '.join(problems))
        log(f'[{tag}] Llama-2-7B width at 2 bf16 layers, {gb:.3f} GB a '
            f'version: WeightPublisher.publish {publish_s:.3f} s '
            f'({gb / publish_s:.3f} GB/s: the host copy, the npz write, the '
            f'sha256); load {load_s:.3f} s ({gb / load_s:.3f} GB/s, the '
            f'sha256 alone {verify_s:.3f} s); swap_weights {swap_s:.3f} s; '
            f'v2 passed the finite gate and the canary (tokens {expect}), '
            f'moved the tokens; v3 refused ({refused[1]}), quarantined, '
            f'latest v{latest}; the restore gave v1\'s tokens, captures '
            f'unchanged')
        del eng, prev, store
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {'launches': launches}


def paged_float_ms(readings: int = 5, outputs=None) -> list:
    """[(case, [device ms per call] x readings)] of the paged kernel over
    pages in q's dtype at phase 2's serve shape (8 slots, H 32, context
    up to 1024): bf16 and f32 at HKV 32, bf16 at HKV 8 (`queued_ms`);
    where the port takes several query rows per slot, also the verify's
    5 rows, bf16 at HKV 32 and 8. With `outputs` (a dict) each one-row
    case's output goes there, on the host, for a bit comparison of two
    trees (`--paged-bits`)."""
    from paddle_tpu_torch.ops import kernels as K
    gen = torch.Generator(device=DEV).manual_seed(0)
    n, h, ps, p = 8, 32, 16, 64
    num_pages = n * p + 1
    table = (torch.randperm(num_pages - 1, generator=gen, device=DEV)[:n * p]
             + 1).to(torch.int32).reshape(n, p).contiguous()
    lengths = torch.tensor([1024, 1000, 777, 513, 256, 100, 17, 1],
                           dtype=torch.int32, device=DEV)
    out = []
    for dtype, hkv in ((torch.bfloat16, 32), (torch.float32, 32),
                       (torch.bfloat16, 8)):
        q = _randn((n, h, 128), dtype, gen)
        kp, vp = (_randn((num_pages, ps, hkv, 128), dtype, gen)
                  for _ in range(2))
        call = (lambda q=q, kp=kp, vp=vp:
                K.paged_attention(q, kp, vp, table, lengths))
        out.append((f'{str(dtype)[6:]} HKV={hkv}',
                    [queued_ms(call) for _ in range(readings)]))
        if outputs is not None:
            outputs[out[-1][0]] = call().cpu()
    if hasattr(K, 'PAGED_MAX_ROWS'):
        # row 0's key count, so that the last row sees the decode's count
        rows0 = (lengths - SPEC_K).clamp(min=1).to(torch.int32)
        for hkv in (32, 8):
            q = _randn((n, SPEC_K + 1, h, 128), torch.bfloat16, gen)
            kp, vp = (_randn((num_pages, ps, hkv, 128), torch.bfloat16, gen)
                      for _ in range(2))
            call = (lambda q=q, kp=kp, vp=vp:
                    K.paged_attention(q, kp, vp, table, rows0))
            out.append((f'verify T={SPEC_K + 1} bf16 HKV={hkv}',
                        [queued_ms(call) for _ in range(readings)]))
    return out


def int8_rmse_by_depth() -> None:
    """The first decode sub-step's relative logit RMSE of phase 6's
    prompts at Llama-2-7B width and 1-32 layers (bf16, and f32 at 2, 8
    and 32; random weights from phase 6's seed; eager engines): the int8
    engine (q) and the float engine over its pages roundtripped through
    int8 (rt, the JAX bench's int8 arm) against the float-KV engine (f),
    and q against rt."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import InferenceEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(2)
    prompts = [rng.randint(3, 32000, (s,)).tolist() for s in SERVE_LENS]
    for dtype, depths in (('bfloat16', (1, 2, 4, 8, 16, 32)),
                          ('float32', (2, 8, 32))):
        for d in depths:
            model = LlamaForCausalLM(
                LlamaConfig.llama2_7b(num_hidden_layers=d), device=DEV,
                dtype=dtype, generator=ptt.generator(1234, DEV))
            out = {}
            for tag, quant in (('f', None), ('rt', None), ('q', 'int8')):
                eng = InferenceEngine(model, num_slots=8, max_length=1024,
                                      decode_block=8, kv_quant=quant)
                eng._capture_decode = eng._capture_prefill = False
                out[tag] = first_step_logits(eng, prompts,
                                             roundtrip=tag == 'rt')
                del eng
            f, rt, q = out['f'], out['rt'], out['q']
            log(f'[int8-rmse] {dtype} {d} layers: q vs f '
                f'{rel_rmse(q, f):.4e}, rt vs f {rel_rmse(rt, f):.4e}, q vs '
                f'rt {rel_rmse(q, rt):.4e}; argmax q == f on '
                f'{int((q.argmax(-1) == f.argmax(-1)).sum())} of '
                f'{len(prompts)}')
            del model, out
            gc.collect()
            torch.cuda.empty_cache()


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

_GROUPS = (('paged_attention', PAGED_KERNELS + INT8_KERNELS),
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


PROFILE_TRIES = 3


def marked_window(body):
    """A torch.profiler window (CUDA activity) around `body`, its result
    synchronized. CUPTI has missed the first kernels of a window, most
    often of one opened right after another (the sum of squares of the
    update window after the training step's), so a host pause and a GPU
    sleep of ~1 us (`spin_kernel`) go first."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        body()
        torch.cuda.synchronize()
    return prof


def missing_kernels(prof, kernels) -> list:
    """The names of `kernels` of which the window holds no device event."""
    seen = {e.name for e in _device_events(prof)}
    return [k for k in kernels if not any(k in n for n in seen)]


def require_kernels(prof, kernels, label: str, absent=()) -> None:
    """Fail unless the profiled window ran a device event of each of
    `kernels`, and none of `absent` (by name)."""
    seen = {e.name for e in _device_events(prof)}
    missing = missing_kernels(prof, kernels)
    if missing:
        raise AssertionError(f'profile: the {label} ran no device event of '
                             f'{missing}')
    stale = [k for k in absent if any(k in n for n in seen)]
    if stale:
        raise AssertionError(f'profile: the {label} ran {stale}')
    log(f'[profile]   {label} ran ' + ', '.join(kernels)
        + (' and no ' + ', '.join(absent) if absent else ''))


def profile_serve(served, adapted, prefixed) -> None:
    """On the serve and banked engines, graph and eager, after their
    counted runs: time one decode round of each with every slot busy (no
    profiler yet; the banked engines' requests under the serve-adapters
    mix), then profile the next round of each, then the prefills of
    `profile_prefills`. Every round must run the split-context
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
    profile_prefills(prefixed)


def profile_int8(run) -> None:
    """On the int8 serve engine and its eager twin: one decode round with
    every slot busy, timed unprofiled, then the next round in three
    profiled windows: the round's begin (the window's fill), its
    decode_block sub-steps, its end (the touched pages requantized).
    The sub-steps must run the int8 split, window and combine kernels and
    RMSNorm, and not the float split kernel; the fill and the requantize
    must run device work. Device ms by group, the two bodies each a group
    of their own."""
    for e, label in ((run['engine'], 'int8 decode round, graph'),
                     (run['eager']['engine'], 'int8 decode round, eager')):
        n = e.pool.num_slots
        for p in run['prompts'][:n]:
            e.submit(p, max_new_tokens=4 * e.decode_block, eos_token_id=-1)
        e.step()                # admit + prefill all, first round
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.step()                # a pure decode round, not profiled
        wall = time.perf_counter() - t0
        windows = []
        with torch.inference_mode():
            step = e._stage_round()
            for group, body in (
                    ('int8 window fill',
                     lambda: step.run_side('_round_begin')),
                    (None, lambda: [step.run_once()
                                    for _ in range(e.decode_block)]),
                    ('int8 window requantize',
                     lambda: step.run_side('_round_end'))):
                prof = marked_window(body)
                windows.append((prof, group))
                if group is not None and not any(
                        'spin_kernel' not in ev.name
                        for ev in _device_events(prof)):
                    raise AssertionError(f'profile: the {label}\'s {group} '
                                         f'ran no device work')
        _breakdown(windows, wall,
                   f'{label} ({n} slots x {e.decode_block} sub-steps; wall '
                   f'of an unprofiled round)')
        require_kernels(windows[1][0], INT8_KERNELS + ('rms_norm_kernel',),
                        label, absent=('paged_attn_split_kernel',
                                       'paged_attn_kernel'))
        e.run()


def profile_spec(spec) -> None:
    """One speculation round of phase 6e's 2-layer-draft engine with every
    slot busy, profiled, on fresh engines (phase 6e freed its own): on
    the graph engine one replayed round (device ms by kernel group), on
    its eager twin the draft's k sub-steps and the verify with the
    acceptance in windows of their own (the draft's kernels are the
    target's, so only a window tells them apart); idle shares against
    the unprofiled round walls phase 6e took. Each must run the
    split-context paged kernels and RMSNorm."""
    from paddle_tpu_torch.serving import InferenceEngine
    run = spec['draft2']
    for graph, wall, label in (
            (True, run['round_wall_s'], 'spec round, graph'),
            (False, run['eager']['round_wall_s'], 'spec round, eager')):
        e = InferenceEngine(spec['model'], num_slots=8, max_length=1024,
                            kv_page_size=16, draft_model=spec['draft'],
                            num_draft_tokens=SPEC_K)
        e._capture_decode = e._capture_prefill = graph
        n = e.pool.num_slots
        for p in spec['prompts'][:n]:
            e.submit(p, max_new_tokens=4 * (SPEC_K + 1), eos_token_id=-1)
        e.step()                # admit + prefill all, first round
        windows = []
        with torch.inference_mode():
            step = e._stage_round()
            if step.graph is not None:
                bodies = ((None, step.run_once),)
            else:
                drafts = []
                bodies = (('draft (k sub-steps)',
                           lambda: drafts.append(step._propose())),
                          (None, lambda: step._verify(drafts[0])))
            for group, body in bodies:
                windows.append((marked_window(body), group))
        _breakdown(windows, wall, f'{label} ({n} slots, k={SPEC_K}, 2-layer '
                                  f'draft; wall of an unprofiled round)')
        for prof, _ in windows:
            require_kernels(prof, PAGED_KERNELS + ('rms_norm_kernel',),
                            label)
        e.run()
        del e
        torch.cuda.empty_cache()


def profile_prefills(prefixed) -> None:
    """Each of PROFILED_PREFILLS (a whole prefill at bucket 1024, a
    256-token chunk at start 512 over its slot's 1024 rows) on the
    serve-prefix engine, replayed from its captured graph, and on the
    same engine with its prefill eager, each profiled once into a fresh
    slot: device time by group beside the wall that phase 6c measured
    before any profiling (the idle share is taken against it; the
    profiled call's own wall is logged too). Each must run the wgmma
    flash kernel and none of PyTorch's own attention (flash,
    memory-efficient or cuDNN SDPA)."""
    from torch.profiler import ProfilerActivity, profile
    for kind, bucket, start in PROFILED_PREFILLS:
        for label, eng in (('captured', prefixed['engine']),
                           ('eager', prefixed['eager_prefill']['engine'])):
            pool = eng.pool
            slot = pool.alloc()
            try:
                pool.reserve(slot, start + bucket)
                ids = np.random.RandomState(bucket + 1).randint(
                    3, eng.model.config.vocab_size, (bucket,))
                staged = (dict(start=start, floor=start)
                          if kind == 'chunk' else {})
                eng._run_prefill(slot, kind, ids, bucket, **staged)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    eng._run_prefill(slot, kind, ids, bucket, **staged)
                    wall_prof = time.perf_counter() - t0
            finally:
                pool.free(slot)
            what = (f'{kind} prefill, bucket {bucket}'
                    + (f' at start {start} (sq {bucket}, key count '
                       f'{start + bucket} of {pool.max_length} rows)'
                       if kind == 'chunk' else '') + f', {label}')
            busy = _breakdown([(prof, None)],
                              prefixed['walls'][(kind, bucket, label)], what)
            log(f'[profile]   (the profiled call took {wall_prof * 1e3:.2f} '
                f'ms, idle share {1 - busy / (wall_prof * 1e3):.3f} of it; '
                f'the idle share above uses the unprofiled wall of phase '
                f'6c)')
            require_kernels(prof, ('flash_fwd_wgmma_kernel',), what,
                            absent=('pytorch_flash', 'fmha', 'cudnn'))


def whole_row_gather_ms(eng) -> float:
    """Device ms of the captured chunk's whole-row gather for one layer:
    K and V of every row of one slot's table (`gather_rows` over
    max_length rows), queued behind a GPU sleep."""
    from paddle_tpu_torch.nlp import gather_rows
    pool = eng.pool
    slot = pool.alloc()
    try:
        pool.reserve(slot, pool.max_length)
        table = torch.from_numpy(pool.page_table[slot:slot + 1]).to(DEV)
        k_pages, v_pages = pool.pages[0]
        ms = timed(lambda: (gather_rows(k_pages, table),
                            gather_rows(v_pages, table)))[0]
    finally:
        pool.free(slot)
    return ms


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
    `update_bound_ms`. Where the profiler recorded no event of a required
    kernel, the next step is profiled in its place, up to PROFILE_TRIES
    steps; the last one is checked and read. The idle share is taken
    against `step_s`, the step time measured before any profiling (a step
    run after the profiler has been used costs the host more; its wall is
    logged beside it)."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    float(step(batch, batch))
    wall_now = time.perf_counter() - t0
    x = torch.as_tensor(batch, device=DEV)
    clipped = isinstance(step.optimizer._grad_clip, ClipGradByGlobalNorm)
    step_kernels = ('flash_fwd_wgmma_kernel', 'flash_bwd_dq_wgmma_kernel',
                    'flash_bwd_dkv_wgmma_kernel')
    update_kernels = (('multi_tensor_adam_kernel',)
                      + (('multi_tensor_sumsq_kernel',) if clipped else ()))

    def update_body():
        step.optimizer.update(step._params)
        for _, p in step._params:
            p.grad = None

    for attempt in range(1, PROFILE_TRIES + 1):
        fwd_bwd = marked_window(
            lambda: next_token_loss(step.layer(x), x).backward())
        update = marked_window(update_body)
        missing = (missing_kernels(fwd_bwd, step_kernels)
                   + missing_kernels(update, update_kernels))
        if not missing or attempt == PROFILE_TRIES:
            break
        log(f'[profile]   training step, {label}: the profiler recorded no '
            f'event of {missing} in step {attempt} of {PROFILE_TRIES}; '
            f'profiling the next step')
    _breakdown([(fwd_bwd, None), (update, 'optimizer')], step_s,
               f'training step, {label} (batch {TRAIN_BATCH} x {TRAIN_SEQ}; '
               f'wall = the step time of its phase)')
    log(f'[profile]   (an unprofiled step run now, after the serve '
        f'profile, took {wall_now * 1e3:.2f} ms)')
    require_kernels(fwd_bwd, step_kernels, 'training step')
    require_kernels(update, update_kernels, f'update window ({label})')
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
    if sys.argv[1:2] == ['--paged-ms']:
        # python3 chip_smoke.py --paged-ms TREE [OUT]: paged_float_ms() of
        # the port in TREE (to set an earlier tree beside this one); OUT
        # keeps its one-row outputs
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
        from paddle_tpu_torch.ops import _build
        _build.SOURCES = ('paged_attention',)     # the one source it runs
        _build.build_all()
        outputs = {} if len(sys.argv) > 3 else None
        log(f'[paged] {sys.argv[2]}: ' + '; '.join(
            f'{label}: ' + ' '.join('not measured' if ms is None else
                                    f'{ms:.4f}' for ms in times)
            for label, times in paged_float_ms(outputs=outputs))
            + ' ms per call')
        if outputs is not None:
            torch.save(outputs, sys.argv[3])
        return 0
    if sys.argv[1:2] == ['--paged-bits']:
        # python3 chip_smoke.py --paged-bits A B: two --paged-ms outputs
        a, b = (torch.load(f) for f in sys.argv[2:4])
        for label in a:
            log(f'[paged] {label}: bit-equal {torch.equal(a[label], b[label])}')
        return 0
    if sys.argv[1:2] == ['--int8-rmse']:
        # python3 chip_smoke.py --int8-rmse: int8 KV's logit error by depth
        from paddle_tpu_torch.ops import _build
        _build.build_all()
        int8_rmse_by_depth()
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
    check_prefix_consistency(LlamaConfig.llama2_7b(num_hidden_layers=2))
    check_int8_consistency(LlamaConfig.llama2_7b(num_hidden_layers=2))
    check_spec_consistency(LlamaConfig.llama2_7b(num_hidden_layers=2))
    check_train_consistency(LlamaConfig.llama2_7b(num_hidden_layers=2))
    check_train_steps(LlamaConfig.llama2_7b(num_hidden_layers=2))
    rung = LlamaConfig.llama2_7b(num_hidden_layers=8, use_recompute=True)
    trained = train(rung)
    pretrained = pretrain(trained, rung)
    res = serve(LlamaConfig.llama2_7b())
    spec = serve_spec(res)
    drain_swap(res)
    adapted = serve_adapters(res)
    t6g = time.perf_counter()
    stored = serve_adapter_store(res, adapted)
    weights = weight_store_swap(res)
    log(f'[weight-store] phase 6g (both stores) took '
        f'{time.perf_counter() - t6g:.1f} s')
    prefixed = serve_prefix(res)
    int8 = serve_int8(res, prefixed)
    log(f'[host] one adapted projection (hook + wrapper + launch, decode '
        f'shape): {hook_host_us():.2f} us of host time per call')
    profile_serve(res, adapted, prefixed)
    profile_int8(int8)
    release(res, adapted, prefixed, prefixed['eager_prefill'], int8)
    profile_spec(spec)
    del spec['model'], spec['draft']
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
                       for run in (res, trained, pretrained, adapted,
                                   stored, weights, prefixed, int8,
                                   spec['draft2'], spec['self']))
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
