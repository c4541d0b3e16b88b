"""The port's LR schedulers (paddle_tpu_torch/optimizer/lr.py) against the
JAX package's (paddle_tpu/optimizer/lr.py), on the CPU.

Both are the same Python arithmetic on host floats, so every value must
be exactly equal: each scheduler is built with the same arguments on
both sides and read after each of 30 steps, `ReduceOnPlateau` fed the
same metrics (made from a seed with numpy), `LinearWarmup` around a
cosine, and a `state_dict` taken mid-run restored into a fresh twin on
each side (and across the packages).
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 30

# (scheduler name, constructor args): one case for each scheduler but
# ReduceOnPlateau (fed metrics below), and the option branches that
# change the arithmetic
CASES = [
    ('NoamDecay', lambda m: m.NoamDecay(d_model=64, warmup_steps=8,
                                        learning_rate=2.0)),
    ('PiecewiseDecay', lambda m: m.PiecewiseDecay([5, 12, 20],
                                                  [0.1, 0.05, 0.01, 0.001])),
    ('NaturalExpDecay', lambda m: m.NaturalExpDecay(0.5, gamma=0.1)),
    ('InverseTimeDecay', lambda m: m.InverseTimeDecay(0.5, gamma=0.3)),
    ('PolynomialDecay', lambda m: m.PolynomialDecay(0.1, decay_steps=12,
                                                    end_lr=1e-3, power=2.0)),
    ('PolynomialDecay-cycle', lambda m: m.PolynomialDecay(
        0.1, decay_steps=7, end_lr=1e-3, power=1.5, cycle=True)),
    ('ExponentialDecay', lambda m: m.ExponentialDecay(0.3, gamma=0.9)),
    ('MultiStepDecay', lambda m: m.MultiStepDecay(0.2, milestones=[3, 9, 17],
                                                  gamma=0.5)),
    ('StepDecay', lambda m: m.StepDecay(0.2, step_size=4, gamma=0.7)),
    ('LambdaDecay', lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e)),
    ('CosineAnnealingDecay', lambda m: m.CosineAnnealingDecay(
        0.1, T_max=11, eta_min=1e-3)),
    ('LinearWarmup-float', lambda m: m.LinearWarmup(0.1, warmup_steps=6,
                                                    start_lr=0.0,
                                                    end_lr=0.1)),
    ('LinearWarmup-cosine', lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(3e-4, T_max=20, eta_min=3e-5),
        warmup_steps=5, start_lr=0.0, end_lr=3e-4)),
    ('OneCycleLR-cos', lambda m: m.OneCycleLR(0.1, total_steps=25)),
    ('OneCycleLR-linear', lambda m: m.OneCycleLR(
        0.1, total_steps=25, anneal_strategy='linear', phase_pct=0.2)),
    ('CyclicLR', lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                      step_size_down=6)),
    ('CyclicLR-triangular2', lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=3, mode='triangular2')),
    ('CyclicLR-exp_range', lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=3, mode='exp_range', exp_gamma=0.97)),
    ('CosineAnnealingWarmRestarts', lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=4, T_mult=2, eta_min=1e-4)),
    ('MultiplicativeDecay', lambda m: m.MultiplicativeDecay(
        0.1, lambda e: 0.9 if e % 2 else 0.99)),
    ('LinearLR', lambda m: m.LinearLR(0.1, total_steps=13,
                                      start_factor=0.25, end_factor=1.0)),
]


def _values(sched, steps=STEPS):
    out = [sched()]
    for _ in range(steps):
        sched.step()
        out.append(sched())
    return out


@pytest.mark.parametrize('name,make', CASES, ids=[c[0] for c in CASES])
def test_scheduler_matches_jax_exactly(name, make):
    want = _values(make(jlr))
    got = _values(make(tlr))
    assert got == want
    assert len(set(got)) > 1 or name.startswith('LinearWarmup-float')


def test_every_jax_scheduler_has_a_twin():
    names = {n for n, v in vars(jlr).items()
             if isinstance(v, type) and issubclass(v, jlr.LRScheduler)}
    assert len(names) == 18           # LRScheduler and its 17 subclasses
    for n in names:
        assert issubclass(getattr(tlr, n), tlr.LRScheduler), n
    covered = {c[0].split('-')[0] for c in CASES}
    assert covered == names - {'LRScheduler', 'ReduceOnPlateau'}


def _metrics(n=STEPS, seed=0):
    """A falling, then flat, then noisy loss: improvements, plateaus and
    cooldowns."""
    rng = np.random.default_rng(seed)
    base = np.concatenate([np.linspace(2.0, 1.0, 8), np.full(10, 1.0),
                           1.0 + 0.05 * rng.standard_normal(n - 18)])
    return [float(x) for x in base]


@pytest.mark.parametrize('kw', [
    dict(mode='min', patience=2, cooldown=1),
    dict(mode='min', patience=1, threshold=0.05, threshold_mode='abs',
         factor=0.5, min_lr=1e-3),
    dict(mode='max', patience=2, factor=0.3),
])
def test_reduce_on_plateau_matches_jax_exactly(kw):
    js, ts = jlr.ReduceOnPlateau(0.1, **kw), tlr.ReduceOnPlateau(0.1, **kw)
    js.step()                           # no metric: nothing moves
    ts.step()
    got, want = [ts()], [js()]
    for m in _metrics():
        js.step(m)
        ts.step(torch.tensor(m, dtype=torch.float64))   # a loss tensor
        got.append(ts())
        want.append(js())
        assert (ts.best, ts.num_bad, ts.cooldown_counter) == \
            (js.best, js.num_bad, js.cooldown_counter)
    assert got == want
    assert len(set(got)) > 1


def test_linear_warmup_steps_its_cosine_only_after_warmup():
    inner = tlr.CosineAnnealingDecay(3e-4, T_max=10)
    sched = tlr.LinearWarmup(inner, warmup_steps=4, start_lr=0.0,
                             end_lr=3e-4)
    for _ in range(4):
        assert inner.last_epoch == 0
        sched.step()
    assert sched() == inner() == 3e-4
    sched.step()
    assert inner.last_epoch == 1 and sched() == inner() < 3e-4


@pytest.mark.parametrize('name,make', [c for c in CASES
                                       if c[0] in ('CosineAnnealingDecay',
                                                   'LinearWarmup-cosine',
                                                   'MultiplicativeDecay',
                                                   'OneCycleLR-cos')])
def test_state_dict_round_trip(name, make):
    """A state_dict taken after 9 steps restores a fresh twin that then
    runs on exactly as the original, within the port and from the JAX
    package into the port."""
    src_t, src_j = make(tlr), make(jlr)
    for _ in range(9):
        src_t.step()
        src_j.step()
    saved = (src_t.state_dict(), src_j.state_dict())
    rest = _values(src_t, 12)
    for sd in saved:
        assert all(not callable(v) for v in sd.values())
        fresh = make(tlr)
        fresh.set_state_dict(sd)
        assert fresh.last_epoch == 9
        assert _values(fresh, 12) == rest


def test_values_are_plain_python_floats():
    s = tlr.LinearWarmup(tlr.CosineAnnealingDecay(1.0, T_max=4), 2, 0.0, 1.0)
    for _ in range(6):
        s.step()
        assert type(s()) is float and math.isfinite(s())
