"""paddle_tpu_torch.loadgen — deterministic arrival-process load generation
(a copy of `paddle_tpu/loadgen`: numpy and stdlib, so `make_trace` gives
the JAX package's trace from the same seed, bit for bit).

The "millions of users" north star needs traffic that looks like users:
requests arriving on a clock (not as fast as a client can submit),
rates that swing and spike, mixed tenants with different priorities,
and heavy-tailed prompt/output lengths. This package builds such
traces — **bit-identically reproducible from one explicit seed** — and
replays them against the serving Router in (scaled) real time:

- `arrivals`: Poisson / diurnal / burst (flash-crowd) arrival
  schedules, realized by Lewis–Shedler thinning.
- `lengths`: lognormal and empirical-histogram length distributions.
- `trace`: `make_trace(schedule, duration_s, seed, ...)` — arrivals ×
  tenants × lengths into a list of `TraceRequest`s; `validate_trace`
  checks every request fits the engine geometry up front.
- `replay`: `LoadReplayer` drives a Router (and optionally an
  `serving.Autoscaler`) through the trace and reports what users felt:
  TTFT quantiles, p99-TTFT SLO attainment, and — the hardware-honesty
  denominator — replica-seconds occupied.

    from paddle_tpu_torch import loadgen
    trace = loadgen.make_trace(
        loadgen.DiurnalSchedule(2.0, 20.0, period_s=60), 60.0, seed=7,
        prompt_lengths=loadgen.LognormalLengths(12, 0.6, 4, 48),
        output_lengths=loadgen.FixedLength(8),
        tenants=[loadgen.TenantClass('paid', 1, 0),
                 loadgen.TenantClass('free', 3, 2)])
    report = loadgen.LoadReplayer(router, trace,
                                  autoscaler=scaler).run().report(0.5)

Everything is host-side stdlib+numpy — no torch, no device — so traces
generate anywhere and replays measure the fleet, not the generator.
"""
from __future__ import annotations

from .arrivals import (ArrivalSchedule, BurstSchedule, DiurnalSchedule,
                       PoissonSchedule, arrival_times)
from .lengths import (EmpiricalLengths, FixedLength, LengthDistribution,
                      LognormalLengths)
from .trace import (TenantClass, TraceRequest, make_trace, trace_stats,
                    validate_trace)
from .replay import LoadReplayer, ReplayOutcome, ReplayReport

__all__ = [
    'ArrivalSchedule', 'PoissonSchedule', 'DiurnalSchedule',
    'BurstSchedule', 'arrival_times',
    'LengthDistribution', 'FixedLength', 'LognormalLengths',
    'EmpiricalLengths',
    'TenantClass', 'TraceRequest', 'make_trace', 'validate_trace',
    'trace_stats',
    'LoadReplayer', 'ReplayOutcome', 'ReplayReport',
]
