"""Prompt/output length distributions.

A copy of `paddle_tpu/loadgen/lengths.py`.

Real traffic is not 24 identical prompts: prompt lengths are heavy-
tailed (a lognormal body is the standard fit for chat traffic — most
prompts short, a long tail of document-stuffed ones) and production
traces come with *measured* histograms worth replaying exactly. Both
shapes live here behind one two-method interface: ``sample(rng)``
draws one integer length from an explicit ``RandomState`` (the
determinism contract — no hidden global RNG), ``bounds()`` reports the
support so trace construction can validate against an engine's
``max_length`` before a single request is submitted.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class LengthDistribution:
    """One integer-valued sampling distribution."""

    def sample(self, rng) -> int:
        raise NotImplementedError

    def bounds(self) -> Tuple[int, int]:
        """(min, max) achievable value — trace validation reads this."""
        raise NotImplementedError

    def describe(self) -> dict:
        return {'kind': type(self).__name__}


class FixedLength(LengthDistribution):
    def __init__(self, n: int):
        if n < 1:
            raise ValueError('length must be >= 1')
        self.n = int(n)

    def sample(self, rng) -> int:
        return self.n

    def bounds(self) -> Tuple[int, int]:
        return (self.n, self.n)

    def describe(self) -> dict:
        return {'kind': 'fixed', 'n': self.n}


class LognormalLengths(LengthDistribution):
    """Heavy-tailed lengths: ``round(median * exp(sigma * N(0,1)))``
    clipped into [lo, hi]. `median` is the UN-clipped median (the
    lognormal's exp(mu)); clipping moves mass onto the bounds rather
    than re-normalizing, which is what an engine with a hard
    `max_length` actually does to real traffic."""

    def __init__(self, median: float, sigma: float, lo: int, hi: int):
        if median <= 0 or sigma < 0:
            raise ValueError('median must be > 0 and sigma >= 0')
        if not 1 <= lo <= hi:
            raise ValueError('need 1 <= lo <= hi')
        self.median = float(median)
        self.sigma = float(sigma)
        self.lo = int(lo)
        self.hi = int(hi)

    def sample(self, rng) -> int:
        v = self.median * float(np.exp(self.sigma * rng.standard_normal()))
        return int(np.clip(int(round(v)), self.lo, self.hi))

    def bounds(self) -> Tuple[int, int]:
        return (self.lo, self.hi)

    def describe(self) -> dict:
        return {'kind': 'lognormal', 'median': self.median,
                'sigma': self.sigma, 'lo': self.lo, 'hi': self.hi}


class EmpiricalLengths(LengthDistribution):
    """Replay a measured histogram exactly: ``{length: weight}`` with
    arbitrary positive weights (counts or probabilities — normalized
    here). Sampling inverts the CDF with one uniform draw, so the
    stream consumption is one value per sample regardless of bin
    count (determinism depends on a FIXED draw order)."""

    def __init__(self, histogram: Dict[int, float]):
        if not histogram:
            raise ValueError('histogram must be non-empty')
        items = sorted((int(k), float(v)) for k, v in histogram.items())
        if any(k < 1 for k, _ in items):
            raise ValueError('lengths must be >= 1')
        if any(v < 0 for _, v in items) or not any(v > 0 for _, v in items):
            raise ValueError('weights must be >= 0 with a positive total')
        self.values = np.array([k for k, _ in items], dtype=np.int64)
        w = np.array([v for _, v in items], dtype=np.float64)
        self.probs = w / w.sum()
        self._cdf = np.cumsum(self.probs)

    def sample(self, rng) -> int:
        u = float(rng.random_sample())
        return int(self.values[int(np.searchsorted(self._cdf, u,
                                                   side='right'))
                               if u < self._cdf[-1] else len(self.values) - 1])

    def bounds(self) -> Tuple[int, int]:
        return (int(self.values[0]), int(self.values[-1]))

    def describe(self) -> dict:
        return {'kind': 'empirical', 'bins': len(self.values),
                'lo': int(self.values[0]), 'hi': int(self.values[-1])}
