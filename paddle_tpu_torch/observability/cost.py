"""Per-program cost attribution: the ProgramCatalog (a copy of
`paddle_tpu/observability/cost.py`).

The catalog records, per named program, its compile (capture) count and
seconds, its invocations and host wall time, and its FLOPs, bytes
accessed and peak memory, so `top_programs()` answers which programs a
decode round or a train step spends its time and FLOPs in, and the
roofline view (`record_roofline`, `aggregate_mfu`, `MfuWindow`,
`roofline_summary`) sets them against the device's peaks.

The JAX package enrolls each jitted program through `wrap_jit` and reads
XLA's `cost_analysis()` and `memory_analysis()` off the compiled
executable. A captured CUDA graph offers neither, so the port has no
`CatalogedJit` / `wrap_jit`: the serving engine enrolls each program
under the JAX program's name (`serving.paged_decode_block`,
`serving.paged_prefill_<b>`, `serving.paged_chunk_prefill_<b>`,
`serving.paged_spec_decode_k<k>`, `serving.draft_prefill_<b>`, and a row
engine's `serving.decode_block`, `serving.prefill_<b>`,
`serving.chunk_prefill_<b>`, `serving.spec_decode_k<k>`) with
`note_compile` at its capture and `note_invocation` at each call, and
`jit.TrainStep` as `train_step`. Their FLOPs and bytes come from an
analytic count of the work (`note_cost`, `note` = 'analytic': 2 x
matmul parameters x tokens, attention over the keys each row reads,
weight bytes per pass and the KV rows read and written). The KV rows a
round reads follow the data (each slot's length), so a record holds the
mean over its invocations; FLOPs x invocations is the exact total.
`peak_memory_bytes` is what the capture added to the graph's memory
pool.

`device_peaks` keys on `torch.cuda.get_device_name()`; the table holds
the H100 (dense bf16 tensor-core peak and HBM3 bandwidth). On the CPU,
or on a device not in the table, the peaks are 'unknown' and no MFU is
published, as in the JAX package; `PADDLE_PEAK_FLOPS` /
`PADDLE_PEAK_HBM_GBPS` override.
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import metrics as _metrics
from ..analysis.runtime import concurrency as _concurrency

# ---------------------------------------------------------------------------
# roofline peaks: per-device peak bf16 FLOP/s + HBM bandwidth, keyed by
# a substring of `torch.cuda.get_device_name()`. Published spec-sheet
# numbers (H100 SXM: 989 TFLOP/s dense bf16, 3350 GB/s). Override per
# deployment with PADDLE_PEAK_FLOPS (FLOP/s) / PADDLE_PEAK_HBM_GBPS
# (GB/s) — the only honest path on CPU or unlisted hardware, where the
# fallback is an explicit 'unknown' (no MFU published) rather than a
# silently-wrong guess.
# ---------------------------------------------------------------------------
PEAK_SPECS: Dict[str, Dict[str, float]] = {
    'h100': {'flops': 989e12, 'hbm_gbps': 3350.0},
}


def _device_kind(device) -> str:
    """The device's name: `torch.cuda.get_device_name` of a CUDA device
    (default: device 0 when a card is present), '' otherwise."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            return ''
        device = torch.device('cuda', 0)
    if isinstance(device, str):
        device = torch.device(device)
    if isinstance(device, torch.device) and device.type != 'cuda':
        return ''
    return str(torch.cuda.get_device_name(device))


def device_peaks(device=None) -> Dict[str, Any]:
    """Resolve the roofline peaks for `device` (default: CUDA device 0).

    Returns {'device_kind', 'peak_flops', 'peak_hbm_bytes_per_s',
    'source'} where source is 'env' (operator override), 'table'
    (PEAK_SPECS match), or 'unknown' (peaks are None — MFU/roofline
    gauges are NOT published rather than normalized against a guess)."""
    try:
        kind = _device_kind(device)
    except Exception:  # paddle-lint: disable=swallowed-exception -- device probe; kind stays unknown and no MFU gauge is published against a guess
        kind = ''
    env_flops = os.environ.get('PADDLE_PEAK_FLOPS')
    env_bw = os.environ.get('PADDLE_PEAK_HBM_GBPS')
    if env_flops:
        try:
            return {'device_kind': kind or 'env-override',
                    'peak_flops': float(env_flops),
                    'peak_hbm_bytes_per_s': (float(env_bw) * 1e9
                                             if env_bw else None),
                    'source': 'env'}
        except ValueError:
            pass   # malformed override falls through to the table
    low = kind.lower()
    for key, spec in PEAK_SPECS.items():
        if key in low:
            return {'device_kind': kind, 'peak_flops': spec['flops'],
                    'peak_hbm_bytes_per_s': spec['hbm_gbps'] * 1e9,
                    'source': 'table'}
    return {'device_kind': kind or 'unknown', 'peak_flops': None,
            'peak_hbm_bytes_per_s': None, 'source': 'unknown'}


def _ledger_window() -> 'Tuple[Optional[float], Dict[str, int]]':
    """The goodput ledger's measurement window: (wall seconds since the
    ledger's last reset, per-program invocation baseline captured at
    that reset). MFU is FLOPs-over-WALL — per-call host timing cannot
    see device time under async dispatch (a call returns in
    microseconds while the chip works for milliseconds), so the only
    honest denominator is the wall clock of a window whose invocation
    counts we also know."""
    try:
        from .goodput import get_ledger
        return get_ledger().mfu_window()
    except Exception:  # paddle-lint: disable=swallowed-exception -- ledger optional; (None, {}) window disables MFU rather than faking it
        return None, {}


def record_roofline(rec: 'ProgramRecord',
                    peaks: Optional[Dict[str, Any]] = None,
                    wall_seconds: Optional[float] = None,
                    baseline: Optional[Dict[str, int]] = None
                    ) -> Dict[str, Any]:
    """MFU contribution + roofline classification for one program.

    mfu = (per-invocation FLOPs x invocations in the
    window) / (window WALL seconds) / peak FLOP/s — the program's
    contribution to machine utilization, PaLM-style: per-program MFUs
    sum to the aggregate, and every overhead second (compile,
    checkpoint, backoff — the goodput ledger's categories) shows up as
    MFU lost, not hidden. Roofline bound compares the program's
    arithmetic intensity (FLOPs / bytes accessed) with the machine
    balance (peak FLOPs / peak bandwidth): below the ridge the program
    cannot be compute-bound no matter how good the kernels are. Fields
    are None when the record has no analysis or the device peaks are
    unknown. The window defaults to the goodput ledger's (wall since
    its last reset; invocation baseline captured there)."""
    peaks = peaks or device_peaks()
    if wall_seconds is None:
        wall_seconds, baseline = _ledger_window()
    baseline = baseline or {}
    out = {'mfu': None, 'roofline_bound': None,
           'arithmetic_intensity': None}
    if rec.flops > 0 and rec.bytes_accessed > 0:
        out['arithmetic_intensity'] = rec.flops / rec.bytes_accessed
    pf, pb = peaks['peak_flops'], peaks['peak_hbm_bytes_per_s']
    if pf and rec.flops > 0 and wall_seconds and wall_seconds > 0:
        d_inv = rec.invocations - baseline.get(rec.name, 0)
        if d_inv > 0:
            out['mfu'] = rec.flops * d_inv / wall_seconds / pf
    if pf and pb and out['arithmetic_intensity'] is not None:
        balance = pf / pb
        out['roofline_bound'] = ('compute'
                                 if out['arithmetic_intensity'] >= balance
                                 else 'bandwidth')
    return out


def aggregate_mfu(records: List['ProgramRecord'],
                  peaks: Optional[Dict[str, Any]] = None,
                  wall_seconds: Optional[float] = None,
                  baseline: Optional[Dict[str, int]] = None
                  ) -> Dict[str, Any]:
    """Aggregate MFU: total model FLOPs executed in the window / window
    WALL seconds / peak, summed off the records' per-invocation FLOPs.
    Programs without cost analysis contribute nothing (their time is invisible
    to MFU, which the goodput ledger's residual makes loud instead)."""
    peaks = peaks or device_peaks()
    if wall_seconds is None:
        wall_seconds, baseline = _ledger_window()
    baseline = baseline or {}
    flops = sum(r.flops * max(r.invocations - baseline.get(r.name, 0), 0)
                for r in records if r.flops > 0)
    out = {'flops_total': flops, 'wall_seconds': wall_seconds,
           'mfu': None, 'peaks': peaks}
    if peaks['peak_flops'] and wall_seconds and wall_seconds > 0:
        out['mfu'] = flops / wall_seconds / peaks['peak_flops']
    return out


class MfuWindow:
    """Bounded MFU measurement: wall clock + per-program invocation
    counts snapshot at `__enter__`, deltas at `result()` — the same
    FLOPs-over-wall estimator as `paddle_mfu`, but over exactly the
    code between enter and result."""

    def __init__(self, catalog: Optional['ProgramCatalog'] = None,
                 peaks: Optional[Dict[str, Any]] = None):
        # `is None`: an empty ProgramCatalog must not be swapped out
        self._catalog = catalog if catalog is not None else get_catalog()
        self._peaks = peaks or device_peaks()
        self._before: Dict[str, int] = {}
        self._t0 = 0.0

    def __enter__(self) -> 'MfuWindow':
        self._before = {r.name: r.invocations
                        for r in self._catalog.records()}
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        pass

    def result(self) -> Dict[str, Any]:
        wall = time.perf_counter() - self._t0
        return aggregate_mfu(self._catalog.records(), self._peaks,
                             wall_seconds=wall, baseline=self._before)


class TransformerCost:
    """Analytic FLOPs and bytes of a decoder-only transformer's passes,
    from its config (`hidden_size`, `intermediate_size`,
    `num_hidden_layers`, `num_attention_heads`, `num_key_value_heads`
    (`num_attention_heads` where the config has none), `vocab_size`,
    `hidden_act`).

    The MLP has three matrices (gate, up, down: Llama's SwiGLU, a config
    without `hidden_act`, or any act but gelu and relu) or two (a plain
    gelu / relu MLP: GPT's `linear1`, `linear2`). A pass over `rows`
    token rows costs 2 FLOPs per matmul parameter per row (q/k/v/o and
    the MLP of every layer, and the LM head when `head`), plus 4 x heads
    x head_dim FLOPs per layer for each (query row, key) pair it attends
    (QK^T and PV). It reads every matmul weight once and the K/V rows it
    attends, and writes the K/V rows of its tokens. A model with learned
    positions (a config without `rope_theta`: GPT) also reads one
    position row per token row: 0.3% of GPT-3 XL's bytes at a 2048-row
    prefill. The biases (9 x hidden a layer: 0.03% of GPT-3 XL's
    weights), the embedding gather, the norms and activations are left
    out: below 0.1% of the bytes, or small beside the weights at
    serving widths."""

    def __init__(self, config, weight_itemsize: int = 2,
                 kv_itemsize: Optional[int] = None):
        h = int(config.hidden_size)
        hq = int(config.num_attention_heads)
        hk = int(getattr(config, 'num_key_value_heads', None) or hq)
        d = h // hq
        layers = int(config.num_hidden_layers)
        act = getattr(config, 'hidden_act', None)
        self.mlp_matrices = 2 if act in ('gelu', 'relu') else 3
        self.layer_params = layers * (
            2 * h * hq * d + 2 * h * hk * d
            + self.mlp_matrices * h * int(config.intermediate_size))
        self.head_params = h * int(config.vocab_size)
        self.weight_itemsize = int(weight_itemsize)
        self.attn_flops = 4 * hq * d * layers
        self.kv_row_bytes = 2 * hk * d * layers * int(
            weight_itemsize if kv_itemsize is None else kv_itemsize)
        self.position_row_bytes = 0 if hasattr(config, 'rope_theta') \
            else h * self.weight_itemsize

    def params(self, head: bool) -> int:
        return self.layer_params + (self.head_params if head else 0)

    def forward(self, rows: int, keys: int, kv_read: int = 0,
                kv_written: int = 0, head: bool = True) -> Tuple[float,
                                                                 float]:
        """(FLOPs, bytes) of one pass over `rows` rows that attends
        `keys` (query, key) pairs, reads `kv_read` K/V rows and writes
        `kv_written`."""
        p = self.params(head)
        flops = 2.0 * p * rows + float(self.attn_flops) * keys
        nbytes = (float(p) * self.weight_itemsize
                  + float(self.kv_row_bytes) * (kv_read + kv_written)
                  + float(self.position_row_bytes) * rows)
        return flops, nbytes


class ProgramRecord:
    """One named compiled program's cumulative accounting."""

    __slots__ = ('name', 'kind', 'compile_count', 'compile_seconds',
                 'invocations', 'host_seconds', 'flops', 'bytes_accessed',
                 'peak_memory_bytes', 'argument_bytes', 'output_bytes',
                 'temp_bytes', 'analyzed', 'note')

    def __init__(self, name: str, kind: str = 'jit'):
        self.name = name
        self.kind = kind
        self.compile_count = 0
        self.compile_seconds = 0.0
        self.invocations = 0
        self.host_seconds = 0.0
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.peak_memory_bytes = 0
        self.argument_bytes = 0
        self.output_bytes = 0
        self.temp_bytes = 0
        self.analyzed = False
        self.note = ''

    def as_dict(self) -> Dict[str, Any]:
        return {
            'name': self.name, 'kind': self.kind,
            'compile_count': self.compile_count,
            'compile_seconds': self.compile_seconds,
            'invocations': self.invocations,
            'host_seconds': self.host_seconds,
            'flops': self.flops, 'bytes_accessed': self.bytes_accessed,
            'peak_memory_bytes': self.peak_memory_bytes,
            'argument_bytes': self.argument_bytes,
            'output_bytes': self.output_bytes,
            'temp_bytes': self.temp_bytes,
            'analyzed': self.analyzed, 'note': self.note,
        }


class ProgramCatalog:
    """Registry of every named compiled program in the process."""

    def __init__(self):
        self._lock = _concurrency.RLock('ProgramCatalog._lock')
        self._records: Dict[str, ProgramRecord] = {}
        # name -> [FLOPs, bytes, invocations] summed over analytic notes
        self._cost_sums: Dict[str, List[float]] = {}

    # -- enrollment ---------------------------------------------------------
    def record(self, name: str, kind: str = 'jit') -> ProgramRecord:
        with self._lock:
            rec = self._records.get(name)
            if rec is None:
                rec = self._records[name] = ProgramRecord(name, kind)
            return rec

    def note_invocation(self, name: str, seconds: float = 0.0, n: int = 1,
                        kind: str = 'jit'):
        rec = self.record(name, kind)
        with self._lock:
            rec.invocations += n
            rec.host_seconds += seconds
        return rec

    def note_compile(self, name: str, seconds: float, kind: str = 'jit'):
        rec = self.record(name, kind)
        with self._lock:
            rec.compile_count += 1
            rec.compile_seconds += seconds
        return rec

    def note_cost(self, name: str, flops: float, bytes_accessed: float,
                  kind: str = 'jit'):
        """Book one invocation's analytic FLOPs and bytes: the record
        holds the mean per invocation over every note so far (the work
        of a decode round follows its slots' lengths), so its FLOPs x
        invocations is the exact total."""
        rec = self.record(name, kind)
        with self._lock:
            tot = self._cost_sums.setdefault(name, [0.0, 0.0, 0])
            tot[0] += float(flops)
            tot[1] += float(bytes_accessed)
            tot[2] += 1
            rec.flops = tot[0] / tot[2]
            rec.bytes_accessed = tot[1] / tot[2]
            rec.analyzed = True
            rec.note = 'analytic'
        return rec

    def note_memory(self, name: str, peak_bytes: int, kind: str = 'jit'):
        """Keep the largest peak-memory figure seen for `name`."""
        rec = self.record(name, kind)
        with self._lock:
            rec.peak_memory_bytes = max(rec.peak_memory_bytes,
                                        int(peak_bytes))
        return rec

    # -- reporting ----------------------------------------------------------
    def records(self) -> List[ProgramRecord]:
        with self._lock:
            return list(self._records.values())

    def top_programs(self, n: int = 10, sort_by: str = 'host_seconds',
                     kind: Optional[str] = None) -> List[Dict[str, Any]]:
        """The attribution report: programs ranked by `sort_by`
        ('host_seconds', 'flops', 'bytes_accessed', 'invocations',
        'compile_seconds', 'mfu'). Every row carries the roofline view
        — 'mfu', 'roofline_bound' ('compute'|'bandwidth'), and
        'arithmetic_intensity' — None where the device peaks are
        unknown or the program has no cost analysis. Pure dict reads —
        never compiles."""
        peaks = device_peaks()
        wall, baseline = _ledger_window()
        rows = []
        for r in self.records():
            if kind is not None and r.kind != kind:
                continue
            row = r.as_dict()
            row.update(record_roofline(r, peaks, wall, baseline))
            rows.append(row)
        rows.sort(key=lambda r: (-(r.get(sort_by) or 0.0), r['name']))
        return rows[:n]

    def snapshot(self) -> Dict[str, Any]:
        return {'programs': [r.as_dict() for r in self.records()]}

    def report(self, max_rows: int = 12) -> str:
        """Human-readable program-attribution table."""
        rows = self.top_programs(n=max_rows)
        peaks = device_peaks()
        wall, baseline = _ledger_window()
        agg = aggregate_mfu(self.records(), peaks, wall, baseline)
        head = f'program catalog: {len(self.records())} program(s)'
        if agg['mfu'] is not None:
            head += (f'  aggregate MFU {agg["mfu"]:.3f} '
                     f'({peaks["device_kind"]}, peak '
                     f'{peaks["peak_flops"] / 1e12:.0f} TFLOP/s, '
                     f'{peaks["source"]})')
        else:
            head += (f'  MFU unknown (device {peaks["device_kind"]!r} '
                     f'not in peak table; set PADDLE_PEAK_FLOPS)')
        lines = [head,
                 f'  {"program":<28}{"kind":<10}{"calls":>8}'
                 f'{"host s":>10}{"compile s":>10}{"GFLOPs":>10}'
                 f'{"GB moved":>10}{"peak MiB":>10}{"mfu":>7}'
                 f'{"bound":>11}']
        for r in rows:
            mfu = f'{r["mfu"]:.3f}' if r['mfu'] is not None else '-'
            bound = r['roofline_bound'] or '-'
            lines.append(
                f'  {r["name"][:27]:<28}{r["kind"]:<10}'
                f'{r["invocations"]:>8}'
                f'{r["host_seconds"]:>10.3f}'
                f'{r["compile_seconds"]:>10.3f}'
                f'{r["flops"] / 1e9:>10.3f}'
                f'{r["bytes_accessed"] / 1e9:>10.3f}'
                f'{r["peak_memory_bytes"] / 2**20:>10.1f}'
                f'{mfu:>7}{bound:>11}')
        return '\n'.join(lines)

    def reset(self):
        with self._lock:
            self._records.clear()
            self._cost_sums.clear()


_catalog = ProgramCatalog()


def get_catalog() -> ProgramCatalog:
    return _catalog


def roofline_summary(max_rows: int = 5) -> Dict[str, Any]:
    """The /summary roofline section: device peaks (+ how they were
    resolved), aggregate MFU, per-bound program counts, and the top
    analyzed programs by MFU-weighted host time."""
    peaks = device_peaks()
    wall, baseline = _ledger_window()
    records = _catalog.records()
    agg = aggregate_mfu(records, peaks, wall, baseline)
    rows = []
    for r in records:
        roof = record_roofline(r, peaks, wall, baseline)
        if roof['mfu'] is None:
            continue
        rows.append({'name': r.name, 'host_seconds': r.host_seconds,
                     'mfu': roof['mfu'],
                     'bound': roof['roofline_bound'],
                     'intensity': roof['arithmetic_intensity']})
    rows.sort(key=lambda r: -r['mfu'])
    bounds = {'compute': 0, 'bandwidth': 0}
    for r in rows:
        if r['bound'] in bounds:
            bounds[r['bound']] += 1
    return {'device_kind': peaks['device_kind'],
            'peak_flops': peaks['peak_flops'],
            'peak_hbm_bytes_per_s': peaks['peak_hbm_bytes_per_s'],
            'source': peaks['source'],
            'mfu': agg['mfu'],
            'flops_total': agg['flops_total'],
            'window_wall_seconds': agg['wall_seconds'],
            'bound_counts': bounds,
            'programs': rows[:max_rows]}


def _program_collector(reg: '_metrics.MetricsRegistry'):
    """Scrape-time mirror of the catalog into `paddle_program_*`
    metrics (mirror, not accumulate — same contract as the dispatch
    collector)."""
    cat = _catalog
    inv = reg.counter('paddle_program_invocations_total',
                      'compiled-program invocations', ('program',))
    host = reg.counter('paddle_program_host_seconds_total',
                       'host wall seconds inside compiled programs',
                       ('program',))
    comp = reg.counter('paddle_program_compile_seconds_total',
                       'seconds compiling each program', ('program',))
    flops = reg.gauge('paddle_program_flops',
                      'XLA cost_analysis FLOPs per invocation',
                      ('program',))
    byts = reg.gauge('paddle_program_bytes_accessed',
                     'XLA cost_analysis bytes accessed per invocation',
                     ('program',))
    peak = reg.gauge('paddle_program_peak_memory_bytes',
                     'XLA memory_analysis peak bytes', ('program',))
    pmfu = reg.gauge('paddle_program_mfu',
                     'model-FLOPs utilization per program '
                     '(cost_analysis FLOPs / host seconds / device peak)',
                     ('program',))
    bound = reg.gauge(
        'paddle_roofline_bound',
        'programs on each side of the roofline ridge '
        '(arithmetic intensity vs machine balance)', ('bound',))
    agg = reg.gauge('paddle_mfu',
                    'aggregate model-FLOPs utilization across analyzed '
                    'programs (0 while device peaks are unknown)')
    peaks = device_peaks()
    wall, baseline = _ledger_window()
    counts = {'compute': 0, 'bandwidth': 0}
    records = cat.records()
    for r in records:
        inv.labels(program=r.name).value = float(r.invocations)
        host.labels(program=r.name).value = float(r.host_seconds)
        comp.labels(program=r.name).value = float(r.compile_seconds)
        flops.labels(program=r.name).set(r.flops)
        byts.labels(program=r.name).set(r.bytes_accessed)
        peak.labels(program=r.name).set(r.peak_memory_bytes)
        roof = record_roofline(r, peaks, wall, baseline)
        if roof['mfu'] is not None:
            pmfu.labels(program=r.name).set(roof['mfu'])
        if roof['roofline_bound'] is not None:
            counts[roof['roofline_bound']] += 1
    for b, n in counts.items():
        bound.labels(bound=b).set(n)
    a = aggregate_mfu(records, peaks, wall, baseline)
    agg.set(a['mfu'] if a['mfu'] is not None else 0.0)


def install(registry: Optional['_metrics.MetricsRegistry'] = None):
    """Idempotent: register the scrape-time program collector."""
    reg = registry if registry is not None else _metrics.get_registry()
    reg.register_collector(_program_collector)
