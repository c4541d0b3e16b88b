"""The observability report (counterpart of `observability_summary` in
`paddle_tpu/debug.py`).

`observability_summary()` is one report over the shared registry: the
serving engine's traffic (requests, queue, slots, tokens, TTFT/TPOT,
prefills, decode steps, the prefix cache, chunked prefill and
speculation), training steps and the memory watermark, the adapter
bank, retries, checkpoints, the serving router (per-replica breaker,
load and health), the goodput ledger, the roofline and the program
catalog, the request ledger's closure and the hottest host spans with
the event log's drops. It is what the HTTP server's /summary renders
(`as_dict=True` for ?format=json) and what a flight bundle's
`summary.txt` holds. The sections and keys are the JAX report's; the
sections the port has no source for yet (dispatch, jit, collectives,
offload, elastic, the program store) are left out, and `adapters` and
`requests` are the port's own.

`LossSpikeDetector` (the JAX module's, copied) flags a training loss
that leaves its trailing window; the fault-tolerant step and
`hapi.MetricsLoggerCallback` run it.

`check_numerics` raises `NumericsError` on a NaN or Inf in a tensor, and
`enable_check_numerics` scans every eager op's output at the op choke
point (`tensor.apply_op`'s hook; FLAGS_check_nan_inf), as the JAX
package's do.
"""
from __future__ import annotations

import collections
import math
from typing import Deque, List

import torch

from . import flags as _flags
from . import observability as _obs


class NumericsError(RuntimeError):
    pass


def check_numerics(x, name: str = 'tensor', raise_on_error: bool = True):
    """Raise (or print) on NaN or Inf values in a tensor, with their
    counts; integer tensors pass. Reads the counts on the host."""
    from .tensor import to_torch
    val = to_torch(x)
    if not isinstance(val, torch.Tensor):
        val = torch.as_tensor(val)
    if not val.is_floating_point():
        return x
    f32 = val.detach().float()
    n_nan = int(torch.isnan(f32).sum())
    n_inf = int(torch.isinf(f32).sum())
    if n_nan or n_inf:
        msg = (f'check_numerics({name}): {n_nan} NaN, {n_inf} Inf of '
               f'{f32.numel()} values, shape {tuple(f32.shape)}')
        if raise_on_error:
            raise NumericsError(msg)
        print(msg)
    return x


def _scan_outputs(out, op_name):
    if isinstance(out, (list, tuple)):
        for o in out:
            _scan_outputs(o, op_name)
        return
    from .tensor import Tensor
    if isinstance(out, (Tensor, torch.Tensor)):
        check_numerics(out, name=op_name or 'op')


def enable_check_numerics(level: int = 0):
    """Scan every eager op's output for NaN/Inf at the op choke point
    (FLAGS_check_nan_inf=1). Heavy: a host read per op; debugging only."""
    from . import tensor as tmod
    _flags.set_flags({'FLAGS_check_nan_inf': True,
                      'FLAGS_check_nan_inf_level': level})
    tmod._numerics_hook = _scan_outputs


def disable_check_numerics():
    from . import tensor as tmod
    _flags.set_flags({'FLAGS_check_nan_inf': False})
    tmod._numerics_hook = None


def _observability_data(max_rows: int = 10) -> dict:
    """The machine-readable structure behind observability_summary():
    one JSON-able dict per section, read off the same registry snapshot
    the text report formats."""
    reg = _obs.get_registry()
    snap = reg.snapshot()   # runs the collectors first
    spans = reg.get('paddle_span_seconds')
    span_rows = []
    if spans is not None:
        for key, child in sorted(spans.children(),
                                 key=lambda kv: -kv[1].sum)[:max_rows]:
            span_rows.append({
                'name': key[0], 'calls': child.count,
                'total_s': child.sum,
                'avg_ms': (child.sum / child.count * 1e3
                           if child.count else 0.0)})
    log = _obs.get_event_log()
    closure = _obs.get_request_ledger().report(top=0)['closure']
    return {
        'process_index': snap['process_index'],
        'steps': {
            'total': int(reg.value('paddle_steps_total')),
            'steps_per_sec': reg.value('paddle_steps_per_sec'),
            'tokens_per_sec': reg.value('paddle_tokens_per_sec'),
            'loss_last': reg.value('paddle_loss_last'),
            # trailing-window step-time percentiles off the train.step
            # span histogram
            'step_time_quantiles_ms': _span_quantiles_ms(reg, 'train.step')
            or _span_quantiles_ms(reg, 'step.compute')},
        'memory': {
            'watermark_bytes': reg.value('paddle_memory_watermark_bytes')},
        'resilience': {
            'retries': int(_labeled_total(
                reg, 'paddle_resilience_retries_total')),
            'rollbacks': int(reg.value(
                'paddle_resilience_rollbacks_total')),
            'skipped_batches': int(reg.value(
                'paddle_resilience_skipped_batches_total')),
            'preempt_saves': int(reg.value(
                'paddle_resilience_preempt_saves_total')),
            'hangs': int(reg.value('paddle_resilience_hangs_total'))},
        'checkpoints': {
            'saves': int(reg.value('paddle_checkpoint_saves_total')),
            'save_bytes': int(reg.value(
                'paddle_checkpoint_save_bytes_total')),
            'restores': int(reg.value('paddle_checkpoint_restores_total')),
            'restore_bytes': int(reg.value(
                'paddle_checkpoint_restore_bytes_total'))},
        'serving': {
            'submitted': int(reg.value('paddle_serving_requests_total',
                                       status='submitted')),
            'completed': int(reg.value('paddle_serving_requests_total',
                                       status='completed')),
            'failed': int(reg.value('paddle_serving_requests_total',
                                    status='failed')),
            'queue_depth': int(reg.value('paddle_serving_queue_depth')),
            'active_slots': int(reg.value('paddle_serving_active_slots')),
            'slots': int(reg.value('paddle_serving_slots')),
            'tokens': int(reg.value('paddle_serving_tokens_total')),
            'ttft_avg_ms': _hist_avg_ms(reg, 'paddle_serving_ttft_seconds'),
            'tpot_avg_ms': _hist_avg_ms(reg, 'paddle_serving_tpot_seconds'),
            'ttft_quantiles_ms': _hist_quantiles_ms(
                reg, 'paddle_serving_ttft_seconds'),
            'tpot_quantiles_ms': _hist_quantiles_ms(
                reg, 'paddle_serving_tpot_seconds'),
            'prefills': int(_labeled_total(
                reg, 'paddle_serving_prefills_total')),
            'decode_steps': int(reg.value(
                'paddle_serving_decode_steps_total')),
            'prefix': {
                'hits': int(reg.value(
                    'paddle_serving_prefix_hits_total')),
                'misses': int(reg.value(
                    'paddle_serving_prefix_misses_total')),
                'tokens_reused': int(reg.value(
                    'paddle_serving_prefix_tokens_reused_total')),
                'retained_slots': int(reg.value(
                    'paddle_serving_prefix_retained_slots')),
                'evictions': int(reg.value(
                    'paddle_serving_prefix_evictions_total'))},
            'chunk': {
                'rounds': int(reg.value(
                    'paddle_serving_chunk_rounds_total')),
                'tokens': int(reg.value(
                    'paddle_serving_chunk_tokens_total'))},
            'spec': {
                'rounds': int(reg.value(
                    'paddle_serving_spec_rounds_total')),
                'proposed': int(reg.value(
                    'paddle_serving_spec_proposed_total')),
                'accepted': int(reg.value(
                    'paddle_serving_spec_accepted_total'))}},
        'adapters': {
            'loads': int(reg.value('paddle_adapter_loads_total')),
            'evictions': int(reg.value('paddle_adapter_evictions_total')),
            'pinned': int(reg.value('paddle_adapter_pinned')),
            'requests': int(_labeled_total(
                reg, 'paddle_adapter_requests_total'))},
        'router': _router_data(reg),
        'goodput': _obs.get_ledger().report(),
        'roofline': _obs.roofline_summary(max_rows=max_rows),
        'programs': _obs.program_catalog().top_programs(n=max_rows),
        'requests': closure,
        'spans': span_rows,
        'events': {'logged': len(log), 'dropped': log.dropped,
                   'flight_dumps': int(_labeled_total(
                       reg, 'paddle_flight_dumps_total'))},
    }


def observability_summary(max_rows: int = 10, as_dict: bool = False):
    """One report over the shared observability registry: where this
    process's requests, tokens and seconds went.

    Sections always print (zeros included) so tooling can grep fields.
    `as_dict=True` returns the machine-readable structure backing the
    text (the /summary?format=json payload); both views are rendered
    from the SAME snapshot so their headline counters always agree.
    """
    d = _observability_data(max_rows)
    if as_dict:
        return d
    lines = [f'observability summary (process {d["process_index"]})']
    st = d['steps']
    lines.append(
        f'  steps: {st["total"]} total  '
        f'{st["steps_per_sec"]:.2f} steps/s  '
        f'{st["tokens_per_sec"]:.1f} tokens/s  '
        f'loss {st["loss_last"]:.4f}')
    if st['step_time_quantiles_ms']:
        qs = st['step_time_quantiles_ms']
        lines.append('    step time ' + '  '.join(
            f'p{float(q) * 100:g} {v:.2f} ms' for q, v in sorted(
                qs.items(), key=lambda kv: float(kv[0]))))
    lines.append(
        f'  memory: watermark '
        f'{d["memory"]["watermark_bytes"] / 2**20:.1f} MiB')
    rs = d['resilience']
    lines.append(
        f'  resilience: {rs["retries"]} retries  '
        f'{rs["rollbacks"]} rollbacks  '
        f'{rs["skipped_batches"]} skipped batches  '
        f'{rs["preempt_saves"]} preempt saves  '
        f'{rs["hangs"]} hangs')
    ck = d['checkpoints']
    lines.append(
        f'  checkpoints: {ck["saves"]} saves ({ck["save_bytes"]} bytes)  '
        f'{ck["restores"]} restores ({ck["restore_bytes"]} bytes)')
    sv = d['serving']
    lines.append(
        f'  serving: {sv["submitted"]} requests '
        f'({sv["completed"]} done, {sv["failed"]} failed)  '
        f'queue {sv["queue_depth"]}  '
        f'slots {sv["active_slots"]}/{sv["slots"]}  '
        f'{sv["tokens"]} tokens')
    lines.append(
        f'    ttft avg {sv["ttft_avg_ms"]:.2f} ms  '
        f'tpot avg {sv["tpot_avg_ms"]:.2f} ms  '
        f'{sv["prefills"]} prefills  '
        f'{sv["decode_steps"]} decode steps')
    if sv['ttft_quantiles_ms']:
        ttft_q = '  '.join(f'p{float(q) * 100:g} {v:.2f}'
                           for q, v in sorted(
                               sv['ttft_quantiles_ms'].items(),
                               key=lambda kv: float(kv[0])))
        tpot_q = '  '.join(f'p{float(q) * 100:g} {v:.2f}'
                           for q, v in sorted(
                               sv['tpot_quantiles_ms'].items(),
                               key=lambda kv: float(kv[0])))
        lines.append(f'    ttft ms: {ttft_q}'
                     + (f'  |  tpot ms: {tpot_q}' if tpot_q else ''))
    px, chk, spc = sv['prefix'], sv['chunk'], sv['spec']
    hit_rate = (px['hits'] / (px['hits'] + px['misses'])
                if px['hits'] + px['misses'] else 0.0)
    lines.append(
        f'    prefix cache: {px["hits"]} hits / {px["misses"]} misses '
        f'({hit_rate:.1%})  {px["tokens_reused"]} tokens reused  '
        f'{px["retained_slots"]} retained  {px["evictions"]} evicted')
    spec_rate = (spc['accepted'] / spc['proposed']
                 if spc['proposed'] else 0.0)
    lines.append(
        f'    chunked prefill: {chk["rounds"]} rounds '
        f'{chk["tokens"]} tokens  |  speculation: {spc["rounds"]} '
        f'rounds  accept {spc["accepted"]}/{spc["proposed"]} '
        f'({spec_rate:.1%})')
    ad = d['adapters']
    lines.append(
        f'  adapters: {ad["loads"]} loads  {ad["evictions"]} evictions  '
        f'{ad["pinned"]} pinned  {ad["requests"]} requests')
    rt = d['router']
    lines.append(
        f'  router: {rt["replicas"]} replicas '
        f'({rt["available"]} available)  queue {rt["queue_depth"]}  '
        f'{rt["failovers"]} failovers  {rt["shed"]} shed')
    for row in rt['per_replica']:
        states = ','.join(row['health_states']) or 'healthy'
        lines.append(
            f'    replica {row["replica"]}: breaker {row["breaker"]}  '
            f'{states}  outstanding {row["outstanding_tokens"]} tokens')
    gp = d['goodput']
    lines.append(
        f'  goodput: {gp["wall_seconds"]:.1f} s wall  '
        f'{gp["attributed_seconds"]:.1f} s attributed  '
        f'residual {gp["fractions"]["residual"]:.1%}'
        + (f'  (+{gp["overcount_seconds"]:.1f} s concurrent overcount)'
           if gp['overcount_seconds'] > 0 else ''))
    for cat, secs in gp['categories'].items():
        if secs > 0:
            lines.append(f'    {cat:<20}{secs:>10.3f} s '
                         f'{gp["fractions"][cat]:>7.1%}')
    rf = d['roofline']
    if rf['mfu'] is not None:
        lines.append(
            f'  roofline: MFU {rf["mfu"]:.3f} on {rf["device_kind"]} '
            f'(peak {rf["peak_flops"] / 1e12:.0f} TFLOP/s, '
            f'{rf["source"]})  '
            f'{rf["bound_counts"]["compute"]} compute-bound / '
            f'{rf["bound_counts"]["bandwidth"]} bandwidth-bound '
            f'programs')
        for row in rf['programs']:
            bound = row['bound'] or '?'
            lines.append(f'    {row["name"][:31]:<32} mfu '
                         f'{row["mfu"]:.3f}  {bound}-bound  '
                         f'{row["host_seconds"]:.3f} s')
    else:
        lines.append(
            f'  roofline: MFU unknown (device {rf["device_kind"]!r} '
            f'not in the peak table; set PADDLE_PEAK_FLOPS / '
            f'PADDLE_PEAK_HBM_GBPS)')
    lines.append(f'  programs: {len(d["programs"])} tracked '
                 f'(top by host time)')
    for p in d['programs']:
        lines.append(
            f'    {p["name"][:31]:<32} {p["invocations"]:>6} calls '
            f'{p["host_seconds"]:>9.3f} s  '
            f'{p["flops"] / 1e9:>9.3f} GFLOP  '
            f'{p["bytes_accessed"] / 1e9:>8.3f} GB  '
            f'peak {p["peak_memory_bytes"] / 2**20:>8.1f} MiB')
    rq = d['requests']
    lines.append(
        f'  requests: {rq["finished"]} finished  '
        f'{rq["attributed_s"]:.3f} s attributed  '
        f'{rq["residual_s"]:.3f} s residual  '
        f'decode fair {rq["decode_fair_s"]:.3f} s of '
        f'{rq["engine_decode_wall_s"]:.3f} s engine decode  '
        f'{rq["slow_requests"]} slow')
    lines.append(f'  host spans: {len(d["spans"])} region(s), '
                 f'event log {d["events"]["logged"]} events '
                 f'({d["events"]["dropped"]} dropped, '
                 f'{d["events"]["flight_dumps"]} flight dumps)')
    for row in d['spans']:
        lines.append(f'    {row["name"]:<32} {row["calls"]:>6} calls '
                     f'{row["total_s"]:>10.4f} s  avg '
                     f'{row["avg_ms"]:>8.2f} ms')
    return '\n'.join(lines)


def _router_data(reg) -> dict:
    """Serving-router view: fleet counters + per-replica breaker state,
    load, and active degraded states (the /summary per-replica health)."""
    breaker_names = {0: 'closed', 1: 'half_open', 2: 'open'}
    per_replica = []
    fam = reg.get('paddle_router_breaker_state')
    out_fam = reg.get('paddle_router_outstanding_tokens')
    if fam is not None:
        for (rid,), child in sorted(fam.children()):
            outstanding = 0
            if out_fam is not None:
                oc = out_fam._children.get((rid,))
                outstanding = int(oc.value) if oc is not None else 0
            per_replica.append({
                'replica': rid,
                'breaker': breaker_names.get(int(child.value),
                                             str(child.value)),
                'outstanding_tokens': outstanding,
                'health_states': sorted(
                    _obs.degraded_states(scope=f'replica:{rid}')),
            })
    outcomes: dict = {}
    req_fam = reg.get('paddle_router_requests_total')
    if req_fam is not None:
        for (tenant, outcome), child in req_fam.children():
            outcomes[outcome] = outcomes.get(outcome, 0) + int(child.value)
    return {
        'replicas': int(reg.value('paddle_router_replicas')),
        'available': int(reg.value('paddle_router_available_replicas')),
        'queue_depth': int(reg.value('paddle_router_queue_depth')),
        'failovers': int(_labeled_total(
            reg, 'paddle_router_failovers_total')),
        'shed': int(_labeled_total(reg, 'paddle_router_shed_total')),
        'outcomes': outcomes,
        'per_replica': per_replica,
    }


def _labeled_total(reg, name: str) -> float:
    """Sum a labeled counter family across all label values."""
    fam = reg.get(name)
    if fam is None:
        return 0.0
    return fam.total()


def _hist_avg_ms(reg, name: str) -> float:
    """Mean of an unlabeled histogram family, in milliseconds."""
    fam = reg.get(name)
    if fam is None:
        return 0.0
    child = fam._children.get(())
    if child is None or not child.count:
        return 0.0
    return child.sum / child.count * 1e3


def _hist_quantiles_ms(reg, name: str) -> dict:
    """Windowed p50/p95/p99 of an unlabeled histogram, in ms."""
    fam = reg.get(name)
    if fam is None:
        return {}
    child = fam._children.get(())
    if child is None:
        return {}
    return {q: v * 1e3 for q, v in child.window_quantiles().items()}


def _span_quantiles_ms(reg, span_name: str) -> dict:
    """Windowed quantiles of one `paddle_span_seconds{name=}` child."""
    fam = reg.get('paddle_span_seconds')
    if fam is None:
        return {}
    child = fam._children.get((span_name,))
    if child is None:
        return {}
    return {q: v * 1e3 for q, v in child.window_quantiles().items()}


class LossSpikeDetector:
    """Windowed spike detector: flags a step whose loss exceeds
    mean + k*std of the trailing window, or is non-finite.

    Flagged values are EXCLUDED from the trailing window: a spike (or a
    level shift that registers as one) must not inflate its own baseline
    mean/std, which would mask every later spike. Each flagged step also
    emits a `loss_spike` event into the observability EventLog."""

    def __init__(self, window: int = 20, threshold_sigma: float = 6.0,
                 min_steps: int = 5):
        self.window: Deque[float] = collections.deque(maxlen=window)
        self.k = threshold_sigma
        self.min_steps = min_steps
        self.spikes: List[int] = []
        self._step = 0

    def _note_spike(self, value: float):
        self.spikes.append(self._step)
        _obs.emit('loss_spike', step=self._step, loss=value,
                  window=len(self.window))

    def update(self, loss: float) -> bool:
        """Returns True if this step is a spike."""
        v = float(loss)
        self._step += 1
        if not math.isfinite(v):
            self._note_spike(v)
            return True
        spiked = False
        if len(self.window) >= self.min_steps:
            mean = sum(self.window) / len(self.window)
            var = sum((x - mean) ** 2 for x in self.window) \
                / len(self.window)
            std = math.sqrt(var)
            if v > mean + self.k * max(std, 1e-12):
                spiked = True
                self._note_spike(v)
        if not spiked:
            self.window.append(v)
        return spiked
