"""Arrival processes: when do requests show up?

A copy of `paddle_tpu/loadgen/arrivals.py`.

Every serving bench so far replays a FIXED trace — requests arrive as
fast as the client can submit them, which measures throughput but says
nothing about latency under the traffic real fleets see: memoryless
request streams (Poisson), slow day/night swings (diurnal), and flash
crowds (burst). This module models arrival RATE as a function of time
and turns it into concrete arrival instants via Lewis–Shedler thinning
(Lewis & Shedler 1979): draw a homogeneous Poisson process at the
schedule's peak rate, keep each candidate with probability
``rate_at(t) / max_rate``. Thinning is exact for any bounded intensity
function and — fed from one seeded ``RandomState`` — fully
deterministic: the same seed replays the same instants bit-identically
(the loadgen determinism contract, tier-1-tested).

Rates are requests/second; schedules are pure host-side math (no torch,
no devices) so traces can be generated anywhere, including inside the
analysis/CI sandbox.
"""
from __future__ import annotations

import math
from typing import List


class ArrivalSchedule:
    """A bounded arrival-intensity function over [0, duration)."""

    #: upper bound on rate_at over the whole horizon (the thinning
    #: envelope); subclasses must set it
    max_rate: float = 0.0

    def rate_at(self, t: float) -> float:
        raise NotImplementedError

    def describe(self) -> dict:
        return {'kind': type(self).__name__, 'max_rate': self.max_rate}


class PoissonSchedule(ArrivalSchedule):
    """Memoryless steady-state traffic at a constant rate."""

    def __init__(self, rate: float):
        if rate <= 0:
            raise ValueError('rate must be positive')
        self.rate = float(rate)
        self.max_rate = self.rate

    def rate_at(self, t: float) -> float:
        return self.rate

    def describe(self) -> dict:
        return {'kind': 'poisson', 'rate': self.rate}


class DiurnalSchedule(ArrivalSchedule):
    """Day/night swing: a raised cosine from `base_rate` (trough, at
    t=0 with phase=0) to `peak_rate` (half a period later), repeating
    every `period_s`. `phase` shifts the cycle in fractions of a period
    (phase=0.5 starts at the peak)."""

    def __init__(self, base_rate: float, peak_rate: float,
                 period_s: float, phase: float = 0.0):
        if base_rate < 0 or peak_rate < base_rate:
            raise ValueError('need 0 <= base_rate <= peak_rate')
        if period_s <= 0:
            raise ValueError('period_s must be positive')
        self.base_rate = float(base_rate)
        self.peak_rate = float(peak_rate)
        self.period_s = float(period_s)
        self.phase = float(phase)
        self.max_rate = self.peak_rate

    def rate_at(self, t: float) -> float:
        x = t / self.period_s + self.phase
        swing = 0.5 * (1.0 - math.cos(2.0 * math.pi * x))
        return self.base_rate + (self.peak_rate - self.base_rate) * swing

    def describe(self) -> dict:
        return {'kind': 'diurnal', 'base_rate': self.base_rate,
                'peak_rate': self.peak_rate, 'period_s': self.period_s,
                'phase': self.phase}


class BurstSchedule(ArrivalSchedule):
    """Flash crowd: steady `base_rate` with a rectangular spike to
    `burst_rate` during [burst_start_s, burst_start_s + burst_len_s)."""

    def __init__(self, base_rate: float, burst_rate: float,
                 burst_start_s: float, burst_len_s: float):
        if base_rate < 0 or burst_rate < base_rate:
            raise ValueError('need 0 <= base_rate <= burst_rate')
        if burst_len_s <= 0:
            raise ValueError('burst_len_s must be positive')
        self.base_rate = float(base_rate)
        self.burst_rate = float(burst_rate)
        self.burst_start_s = float(burst_start_s)
        self.burst_len_s = float(burst_len_s)
        self.max_rate = self.burst_rate

    def rate_at(self, t: float) -> float:
        if self.burst_start_s <= t < self.burst_start_s + self.burst_len_s:
            return self.burst_rate
        return self.base_rate

    def describe(self) -> dict:
        return {'kind': 'burst', 'base_rate': self.base_rate,
                'burst_rate': self.burst_rate,
                'burst_start_s': self.burst_start_s,
                'burst_len_s': self.burst_len_s}


def arrival_times(schedule: ArrivalSchedule, duration_s: float,
                  rng) -> List[float]:
    """Concrete arrival instants in [0, duration_s), sorted, via
    thinning against `schedule.max_rate`. Deterministic for a given
    `rng` state: draws consume the stream in one fixed order
    (exponential gap, then the acceptance uniform), so the same seed
    yields bit-identical instants."""
    if duration_s <= 0:
        raise ValueError('duration_s must be positive')
    lam = float(schedule.max_rate)
    if lam <= 0:
        return []
    out: List[float] = []
    t = 0.0
    while True:
        # exponential inter-arrival of the ENVELOPE process
        t += -math.log(1.0 - float(rng.random_sample())) / lam
        if t >= duration_s:
            return out
        if float(rng.random_sample()) * lam <= schedule.rate_at(t):
            out.append(t)
