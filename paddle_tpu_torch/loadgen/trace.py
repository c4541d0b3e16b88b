"""Deterministic trace construction: arrivals × tenants × lengths.

A copy of `paddle_tpu/loadgen/trace.py`.

``make_trace`` is the single entry point: one explicit seed drives ONE
``numpy.random.RandomState`` through a fixed draw order — arrival
instants first (thinning), then per-request (tenant, prompt length,
output length, prompt token ids) — so the same arguments always
produce a bit-identical trace. That is what makes an autoscaling bench
honest: the static-fleet arm and the autoscaled arm replay the SAME
requests at the SAME instants, and a rerun three PRs later replays
them again.

Tenants model the mixed traffic the router's QoS layer exists for:
each ``TenantClass`` carries a selection weight and the priority class
its requests submit under (paid traffic HIGH, best-effort LOW — the
priorities `serving.tenancy` maps to shedding and admission order).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..serving.api import PRIORITY_NORMAL
from .arrivals import ArrivalSchedule, arrival_times
from .lengths import FixedLength, LengthDistribution


@dataclasses.dataclass(frozen=True)
class TenantClass:
    """One traffic class: selection weight + the priority its requests
    carry (serving.api.PRIORITY_HIGH/NORMAL/LOW).

    `adapters` is the tenant's LoRA adapter mix as
    ((adapter_id | None, weight), ...): each request drawn for this
    tenant picks one entry by weight (None = the base model). Empty
    means pure base traffic AND consumes no RNG draw, so traces built
    before adapter mixes existed stay bit-identical."""
    name: str = 'default'
    weight: float = 1.0
    priority: int = PRIORITY_NORMAL
    adapters: Tuple[Tuple[Optional[str], float], ...] = ()

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError('tenant weight must be positive')
        for entry in self.adapters:
            if len(entry) != 2 or float(entry[1]) <= 0:
                raise ValueError(
                    f'adapter mix entries must be (adapter_id, '
                    f'positive weight); got {entry!r}')


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One scheduled request. `prompt_tokens` is a tuple so the trace
    is hashable/immutable — replaying must not mutate it."""
    index: int
    arrival_s: float
    tenant: str
    priority: int
    prompt_tokens: Tuple[int, ...]
    max_new_tokens: int
    adapter: Optional[str] = None


def make_trace(schedule: ArrivalSchedule, duration_s: float, seed: int,
               prompt_lengths: LengthDistribution,
               output_lengths: Optional[LengthDistribution] = None,
               tenants: Optional[Sequence[TenantClass]] = None,
               vocab_size: int = 256) -> List[TraceRequest]:
    """Build the full request schedule for one run.

    Token ids are drawn uniformly from [1, vocab_size) (0 is reserved —
    many models pad with it), so a trace binds to any model with at
    least `vocab_size` tokens. Determinism: everything below consumes
    `RandomState(seed)` in one fixed order; equal arguments ⇒
    bit-identical traces (tier-1-tested).
    """
    if vocab_size < 2:
        raise ValueError('vocab_size must be >= 2')
    rng = np.random.RandomState(int(seed))
    output_lengths = output_lengths or FixedLength(8)
    tenant_list = list(tenants) if tenants else [TenantClass()]
    names = sorted({t.name for t in tenant_list})
    if len(names) != len(tenant_list):
        raise ValueError('tenant names must be unique')
    weights = np.array([t.weight for t in tenant_list], dtype=np.float64)
    cdf = np.cumsum(weights / weights.sum())

    instants = arrival_times(schedule, duration_s, rng)
    out: List[TraceRequest] = []
    for i, at in enumerate(instants):
        u = float(rng.random_sample())
        ti = int(np.searchsorted(cdf, u, side='right')) if u < cdf[-1] \
            else len(tenant_list) - 1
        tenant = tenant_list[ti]
        plen = prompt_lengths.sample(rng)
        olen = output_lengths.sample(rng)
        toks = tuple(int(v) for v in rng.randint(1, vocab_size, size=plen))
        # adapter draw comes LAST and only for tenants that declare a
        # mix: pre-adapter traces (and base-only tenants) consume the
        # exact same RNG stream as before, so they stay bit-identical
        adapter = None
        if tenant.adapters:
            aw = np.array([float(w) for _, w in tenant.adapters],
                          dtype=np.float64)
            acdf = np.cumsum(aw / aw.sum())
            au = float(rng.random_sample())
            ai = int(np.searchsorted(acdf, au, side='right')) \
                if au < acdf[-1] else len(tenant.adapters) - 1
            adapter = tenant.adapters[ai][0]
        out.append(TraceRequest(index=i, arrival_s=float(at),
                                tenant=tenant.name,
                                priority=int(tenant.priority),
                                prompt_tokens=toks,
                                max_new_tokens=int(olen),
                                adapter=adapter))
    return out


def validate_trace(trace: Sequence[TraceRequest], max_length: int,
                   headroom: int = 0) -> None:
    """Fail FAST if any request cannot fit an engine's slot length
    (prompt + budget + optional speculation headroom): a trace that
    would raise mid-replay makes every downstream 'zero dropped
    requests' assertion meaningless."""
    for r in trace:
        need = len(r.prompt_tokens) + r.max_new_tokens + headroom
        if need > max_length:
            raise ValueError(
                f'trace request {r.index} needs {need} slot tokens '
                f'(prompt {len(r.prompt_tokens)} + output '
                f'{r.max_new_tokens} + headroom {headroom}) > '
                f'max_length {max_length}')


def trace_stats(trace: Sequence[TraceRequest]) -> dict:
    """Shape summary (bench JSON reports this next to the results)."""
    if not trace:
        return {'requests': 0}
    plens = [len(r.prompt_tokens) for r in trace]
    olens = [r.max_new_tokens for r in trace]
    by_tenant: dict = {}
    by_adapter: dict = {}
    for r in trace:
        by_tenant[r.tenant] = by_tenant.get(r.tenant, 0) + 1
        ad = getattr(r, 'adapter', None)
        if ad is not None:
            by_adapter[ad] = by_adapter.get(ad, 0) + 1
    extra = {'by_adapter': by_adapter} if by_adapter else {}
    return {
        **extra,
        'requests': len(trace),
        'span_s': round(trace[-1].arrival_s - trace[0].arrival_s, 3),
        'prompt_tokens': int(sum(plens)),
        'output_tokens': int(sum(olens)),
        'prompt_len_mean': round(float(np.mean(plens)), 1),
        'prompt_len_max': int(max(plens)),
        'output_len_mean': round(float(np.mean(olens)), 1),
        'by_tenant': by_tenant,
    }
