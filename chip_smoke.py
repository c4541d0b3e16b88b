#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. build: compile every kernel of the serving path from
   `paddle_tpu_torch/csrc/` with nvcc (sm_90a), all sources at once;
2. kernels: hold each kernel against its plain PyTorch version on the
   card, in f32 and bf16, at the serving path's shapes (plus GQA and
   int8 pages);
3. consistency: the engine at 2 layers of Llama-2-7B width in f32, greedy;
   each request's first 16 tokens must equal a no-cache full-recompute
   forward of the same model;
4. serve: Llama-2-7B (32 layers, bf16, random weights from a seed) behind
   the 8-slot paged engine, 12 requests (prompts 13-700 tokens, 32 new
   tokens; 11 greedy, 1 sampling), with every kernel's launch count read
   around that run and required to be > 0;
5. profile: one decode round with every slot busy (wall time, then a
   torch.profiler breakdown of the next round's device time) and one
   prefill forward;
6. timing: each kernel case of phase 2 timed (device time per call from
   the profiler, beside CUDA-event time), with its plain version, the one
   PyTorch call that computes the same function where there is one, and
   the card's bound for the same work.

The last lines are the card's name and power limit, a JSON line with the
kernel table, and `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, published
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense bf16 tensor cores
                  torch.float32: 67e12}     # fp32 outside the tensor cores
# kernel vs plain: sums run in another order on the card, so fp32 agrees
# to ~1e-6 on unit-scale inputs (limit 1e-4); bf16 outputs carry one
# rounding of 2^-8 relative, i.e. up to ~2e-2 at |y| ~ 4 (limit 2e-2
# absolute + 2e-2 relative)
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 2e-2)}
REPLACES = {
    'flash_attention_fwd':
        'paddle_tpu/ops/pallas_kernels.py:89 (_flash_fwd_kernel)',
    'paged_attention':
        'paddle_tpu/ops/pallas_kernels.py:701 (_paged_attn_kernel)',
    'rms_norm': 'paddle_tpu/ops/pallas_kernels.py:434 (_rms_fwd_kernel)',
}
SOURCES = {'flash_attention_fwd': 'paddle_tpu_torch/csrc/flash_attention.cu',
           'paged_attention': 'paddle_tpu_torch/csrc/paged_attention.cu',
           'rms_norm': 'paddle_tpu_torch/csrc/rms_norm.cu'}
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


def _device_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, iters: int = 10, attempts: int = 3):
    """Mean device time per call of fn(): the summed durations of the GPU
    activity it causes (torch.profiler / CUPTI), without the host's gaps
    between launches. A window whose device-event count is not a whole
    multiple of `iters` lost events and is measured again; None when no
    window is whole."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = _device_events(prof)
        if events and len(events) % iters == 0:
            return sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters
    return None


def timed(fn):
    """(device ms per call from the profiler, or the CUDA-event ms when
    the profiler saw no device time; the CUDA-event ms of back-to-back
    calls, which for a small kernel is the host's launch rate)."""
    ev = time_ms(fn)
    dev = device_ms(fn)
    return (ev if dev is None else dev), ev


def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(name: str, got, want, dtype) -> float:
    atol, rtol = TOL[dtype]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f'{name}: kernel output has non-finite values')
    err = (got - want).abs()
    limit = atol + rtol * want.abs()
    if bool((err > limit).any()):
        raise AssertionError(f'{name}: max |kernel - plain| '
                             f'{float(err.max()):.3e} exceeds atol {atol} '
                             f'rtol {rtol}')
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def build():
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f'[build] {len(logs)} kernel source(s) compiled in '
        f'{time.perf_counter() - t0:.1f} s')
    for name, text in logs.items():
        for line in text.splitlines():
            if 'registers' in line or 'spill' in line:
                log(f'[build] {name}: {line.strip()}')


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def kernel_cases() -> list:
    """Every kernel check: the kernel's wrapper, its plain version and the
    one PyTorch call computing the same function (or None) as closures
    over inputs made on the card from a seed, at the serving path's
    shapes, with the bytes and operations the work needs. `rep` marks the
    case each kernel's JSON entry reports."""
    from paddle_tpu_torch.ops import kernels as K
    F = torch.nn.functional
    gen = torch.Generator(device=DEV).manual_seed(0)
    cases = []

    def add(kernel, name, dtype, run, plain, lib, moved, ops, rep=False):
        b_ms, by = bound_ms(moved, ops, dtype)
        cases.append(dict(kernel=kernel, name=name, dtype=dtype, run=run,
                          plain=plain, lib=lib, bound_ms=b_ms, bound_by=by,
                          rep=rep))

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

    # RMSNorm: decode (8 rows) and prefill (1024 rows), width 4096
    for dtype in (torch.float32, torch.bfloat16):
        for r in (8, 1024):
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
    return cases


def check_kernels(cases) -> None:
    """Hold every kernel against its plain version (fatal on a miss)."""
    for c in cases:
        c['max_abs_err'] = compare(c['name'], c['run'](), c['plain'](),
                                   c['dtype'])
        log(f'[kernels] {c["name"]}: max_abs_err {c["max_abs_err"]:.3e} '
            f'(limit atol {TOL[c["dtype"]][0]} rtol {TOL[c["dtype"]][1]})')


def time_kernels(cases) -> dict:
    """Time every case; returns {kernel: its JSON entry's numbers}. Runs
    last: once torch.profiler has run in a process, every later launch
    costs the host more, so the serve phase and the unprofiled decode
    round are measured before any profiler use."""
    rows = {}
    for c in cases:
        ms, ev = timed(c['run'])
        plain, _ = timed(c['plain'])
        lib = timed(c['lib'])[0] if c['lib'] is not None else None
        log(f'[timing] {c["name"]}: kernel {ms:.4f} ms (events {ev:.4f})  '
            f'plain {plain:.4f} ms  library '
            + (f'{lib:.4f} ms' if lib is not None else 'none')
            + f'  bound {c["bound_ms"]:.4f} ms ({c["bound_by"]})')
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
    if DEV == 'cuda':
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: serve Llama-2-7B
# ---------------------------------------------------------------------------

def serve(cfg) -> dict:
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nlp import LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import (FINISHED, SAMPLING,
                                          InferenceEngine, SamplingParams)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEV, dtype='bfloat16',
                             generator=ptt.generator(1234, DEV))
    eng = InferenceEngine(model, num_slots=8, max_length=1024,
                          decode_block=8, kv_page_size=16)
    log(f'[serve] Llama {cfg.num_hidden_layers} layers x {cfg.hidden_size} '
        f'bf16 built in {time.perf_counter() - t0:.1f} s;'
        f' KV pool {eng.pool.num_pages} pages, '
        f'{eng.pool.pool_bytes / 1e9:.2f} GB')
    rng = np.random.RandomState(2)
    lens = [13, 700, 48, 311, 96, 650, 27, 205, 512, 64, 400, 150]
    prompts = [rng.randint(3, cfg.vocab_size, (s,)).tolist() for s in lens]
    params = [SamplingParams(max_new_tokens=32, eos_token_id=-1)
              for _ in prompts]
    params[5] = SamplingParams(max_new_tokens=32, eos_token_id=-1,
                               strategy=SAMPLING, temperature=0.8,
                               top_p=0.9, seed=7)
    # warm-up outside the counted run (first cuBLAS handles and plans)
    eng.generate_many([prompts[0][:8]],
                      SamplingParams(max_new_tokens=8, eos_token_id=-1))
    eng.reset_stats()

    K.reset_launch_counts()
    t0 = time.perf_counter()
    handles = eng.generate_many(prompts, params)
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)

    st = eng.stats()
    for h in handles:
        if h.status != FINISHED or len(h.tokens) != 32:
            raise AssertionError(f'serve: request {h} did not finish with '
                                 f'32 tokens')
        if not all(0 <= t < cfg.vocab_size for t in h.tokens):
            raise AssertionError(f'serve: token out of range in {h.tokens}')
    missing = [k for k, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f'serve: kernels never launched on the main '
                             f'path: {missing}')
    ttft = sorted(h.ttft for h in handles)
    res = {
        'requests': len(handles), 'wall_s': wall,
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
        'peak_mem_gb': (torch.cuda.max_memory_allocated() / 1e9
                        if DEV == 'cuda' else None),
        'launches': launches,
    }
    log(f'[serve] {len(handles)} requests in {wall:.2f} s: prefill '
        f'{res["prefill_tok_per_s"]:.0f} tok/s ({st["prefill_tokens"]} '
        f'prompt tokens in {st["prefill_seconds"]:.3f} s), decode '
        f'{res["decode_tok_per_s"]:.1f} tok/s ({st["tokens"]} tokens in '
        f'{st["decode_seconds"]:.3f} s, {st["decode_rounds"]} rounds), TTFT '
        f'mean {res["ttft_mean_s"]:.3f} s p50 {res["ttft_p50_s"]:.3f} s max '
        f'{res["ttft_max_s"]:.3f} s, peak device memory '
        f'{res["peak_mem_gb"]} GB')
    log(f'[serve] kernel launches on this run: {launches}')
    res.update(engine=eng, prompts=prompts)
    return res


# ---------------------------------------------------------------------------
# phase 5: where the serving time goes (torch.profiler, device activity)
# ---------------------------------------------------------------------------

_GROUPS = (('paged_attention', ('paged_attn_kernel',)),
           ('flash_attention', ('flash_fwd_kernel',)),
           ('rms_norm', ('rms_norm_kernel',)),
           ('matmul', ('gemm', 'gemv', 'xmma', 'cutlass', 'splitk',
                       'nvjet')))


def _breakdown(prof, wall_s: float, label: str) -> None:
    """Log a profiled window: device time by group and the top kernels,
    and the device's idle share of `wall_s`."""
    groups, names = {}, {}
    for e in _device_events(prof):
        ms = e.time_range.elapsed_us() / 1e3
        low = e.name.lower()
        g = next((g for g, keys in _GROUPS
                  if any(k in low for k in keys)), 'other')
        for table, key in ((groups, g), (names, e.name[:70])):
            c = table.setdefault(key, [0, 0.0])
            c[0] += 1
            c[1] += ms
    busy = sum(v[1] for v in groups.values())
    if not busy:
        log(f'[profile] {label}: the profiler recorded no device time '
            f'(device busy share not measured)')
        return
    log(f'[profile] {label}: wall {wall_s * 1e3:.2f} ms, device busy '
        f'{busy:.2f} ms, idle share {1 - busy / (wall_s * 1e3):.3f}')
    for g, (n, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        log(f'[profile]   {g:16s} {n:6d} launches {ms:9.3f} ms')
    for name, (n, ms) in sorted(names.items(),
                                key=lambda kv: -kv[1][1])[:8]:
        log(f'[profile]   top: {ms:8.3f} ms {n:5d}x {name}')


def profile_serve(eng, prompts) -> None:
    """On the serve engine after its counted run: time one decode round
    with every slot busy (no profiler yet), profile the next one, and
    profile one prefill forward of the longest prompt's bucket."""
    from torch.profiler import ProfilerActivity, profile
    for p in prompts[:eng.pool.num_slots]:
        eng.submit(p, max_new_tokens=4 * eng.decode_block, eos_token_id=-1)
    eng.step()                  # admit + prefill all, first round
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()                  # a pure decode round, not profiled
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()              # the next decode round, profiled
        wall_prof = time.perf_counter() - t0
    _breakdown(prof, wall, f'decode round ({eng.pool.num_slots} slots x '
                           f'{eng.decode_block} sub-steps)')
    log(f'[profile]   (the profiled round took {wall_prof * 1e3:.2f} ms; '
        f'the idle share uses the unprofiled round)')
    eng.run()
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
    _breakdown(prof, wall, f'prefill forward, bucket {bucket} '
                           f'({len(prompts[1])} prompt tokens)')


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    from paddle_tpu_torch.nlp import LlamaConfig  # fails outside the repo
    log(f'[env] torch {torch.__version__} cuda {torch.version.cuda} '
        f'device {torch.cuda.get_device_name(0)}')
    t0 = time.perf_counter()
    build()
    cases = kernel_cases()
    check_kernels(cases)
    check_consistency(LlamaConfig.llama2_7b(num_hidden_layers=2))
    res = serve(LlamaConfig.llama2_7b())
    profile_serve(res['engine'], res['prompts'])
    rows = time_kernels(cases)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    table = []
    for name in ('flash_attention_fwd', 'paged_attention', 'rms_norm'):
        r = rows[name]
        table.append({
            'name': name, 'route': 'cuda', 'source': SOURCES[name],
            'replaces': REPLACES[name], 'launches': res['launches'][name],
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
