"""Load generation (paddle_tpu_torch.loadgen) against the JAX package's,
on the CPU.

- `arrival_times` of Poisson, diurnal and burst schedules, the length
  distributions' draws, `make_trace` (tenants, adapter mixes) and
  `trace_stats` / `validate_trace` are bit-equal across the packages for
  the same seeds.
- `LoadReplayer` on one fake clock through both packages' routers onto
  one banked replica (the tiny GQA Llama carried across by
  `from_jax_state`, two adapters from the same seeds): the same
  `ReplayReport.report()` (its times are the fake clock's) and the same
  outcome per request. The bench's `adapters_smoke` trace shape: two
  tenants, one with an `ad0`/`ad1`/base mix.
"""
import dataclasses
import types

import numpy as np
import pytest

from paddle_tpu import loadgen as jload
from paddle_tpu.loadgen import replay as jreplay
from paddle_tpu_torch import loadgen as pload
from paddle_tpu_torch.loadgen import replay as preplay
from test_torch_observability import isolated_observability
from test_torch_router import (ENGINE, KITS, FakeClock, models, start,
                               ticking, use_clock)

LOADGEN = {'jax': (jload, jreplay), 'torch': (pload, preplay)}
TARGETS = ('q_proj', 'k_proj', 'v_proj', 'o_proj')
__all__ = ['models']     # the module fixture, shared with the router tests


@pytest.fixture(autouse=True, scope='module')
def _isolated(tmp_path_factory):
    yield from isolated_observability(tmp_path_factory)


def _schedules(L):
    return [L.PoissonSchedule(8.0), L.DiurnalSchedule(1.0, 12.0, 3.0, 0.25),
            L.BurstSchedule(2.0, 40.0, 1.0, 0.5)]


@pytest.mark.parametrize('seed', [0, 7, 77])
def test_arrivals_and_lengths_bit_equal(seed):
    got = {}
    for name, (L, _) in LOADGEN.items():
        rng = np.random.RandomState(seed)
        arrivals = [L.arrival_times(s, 4.0, rng) for s in _schedules(L)]
        dists = [L.FixedLength(6), L.LognormalLengths(12, 0.6, 4, 64),
                 L.EmpiricalLengths({3: 0.2, 17: 0.5, 40: 0.3})]
        draws = [[d.sample(rng) for _ in range(40)] for d in dists]
        got[name] = (arrivals, draws, [d.bounds() for d in dists],
                     [s.max_rate for s in _schedules(L)])
    assert got['torch'] == got['jax']
    assert all(len(a) > 0 for a in got['torch'][0])


def _trace(L, seed, adapters=True):
    tenants = [
        L.TenantClass(name='paid', weight=2.0, priority=0,
                      adapters=(('ad0', 2.0), ('ad1', 1.0), (None, 1.0))
                      if adapters else ()),
        L.TenantClass(name='free', weight=1.0, priority=2),
    ]
    return L.make_trace(L.PoissonSchedule(8.0), 4.0, seed=seed,
                        prompt_lengths=L.LognormalLengths(8, 0.5, 3, 24),
                        output_lengths=L.FixedLength(6), tenants=tenants,
                        vocab_size=128)


@pytest.mark.parametrize('seed', [77, 3])
@pytest.mark.parametrize('adapters', [True, False])
def test_make_trace_bit_equal(seed, adapters):
    got = {}
    for name, (L, _) in LOADGEN.items():
        trace = _trace(L, seed, adapters)
        assert trace == _trace(L, seed, adapters)   # deterministic
        L.validate_trace(trace, max_length=64)
        with pytest.raises(ValueError, match='max_length'):
            L.validate_trace(trace, max_length=12)
        got[name] = ([dataclasses.asdict(r) for r in trace],
                     L.trace_stats(trace))
    assert got['torch'] == got['jax']
    assert ('by_adapter' in got['torch'][1]) == adapters


def _replay(kit, model, clock, loadgen, trace_seed=77):
    L, R = loadgen
    use_clock(_replay.monkeypatch, clock, R)
    bank = kit.serving.AdapterBank(model, capacity=4, rank=4,
                                   targets=TARGETS)
    for i in range(2):
        bank.load(f'ad{i}', kit.factors(bank, seed=1 + i, scale=0.2))
    eng = ticking(kit.serving.InferenceEngine(model, adapter_bank=bank,
                                              **ENGINE), clock)
    reg = kit.tenancy.TenantRegistry()
    reg.add('paid', priority=0)
    reg.add('free', priority=2)
    router = kit.serving.Router([kit.serving.Replica(0, eng)], tenants=reg)
    for w in (router._win_ttft, router._win_queue, router._win_shed,
              router._win_accept):
        w._clock = clock
    trace = _trace(L, trace_seed)
    report = L.LoadReplayer(router, trace, time_scale=0.2, max_wall_s=60.0,
                            clock=clock, sleep=clock.sleep).run()
    return types.SimpleNamespace(
        report=report.report(slo_ttft_s=0.5),
        outcomes=[(o.request.index, o.outcome, o.reason, o.ttft_s,
                   o.tokens) for o in report.outcomes],
        stats=L.trace_stats(trace), bank=bank.stats())


def test_replay_through_both_routers_matches(models, monkeypatch):
    got = {}
    for name, kit in KITS.items():
        kit = types.SimpleNamespace(**vars(kit))
        kit.factors = kit.serving.make_adapter_factors
        clock = FakeClock()
        start(kit, monkeypatch, clock)
        _replay.monkeypatch = monkeypatch
        got[name] = _replay(kit, models[name], clock, LOADGEN[name])
    p, j = got['torch'], got['jax']
    assert p.report == j.report
    assert p.outcomes == j.outcomes
    assert p.stats == j.stats
    rep = p.report
    assert rep['dropped'] == 0 and rep['offered'] == p.stats['requests']
    assert rep['completed'] == rep['offered'] and not rep['truncated']
    assert len(p.stats['by_adapter']) >= 2
    assert rep['tokens'] == 6 * rep['completed']
    assert rep['ttft_p50_s'] is not None and rep['replica_seconds'] > 0
