"""The autoscaler and the rolling weight swap (paddle_tpu_torch.serving.
autoscaler and hotswap.ReplicaUpdater) against the JAX package's, on the
CPU, over the tiny GQA Llama carried across by `from_jax_state`.

- Policy: the same decision sequence (`hold`, `hold_cooldown`,
  `scale_up`, `hold_at_max`, `scale_down`, ...) from one scripted
  sequence of window signals on one fake clock, with the same
  `autoscale_*` events, `stats()` and decision counters; the config's
  validation and the `FLAGS_autoscale*` flags match.
- A real scale-up under a burst and a drained scale-down in the quiet
  after it, over the port's `ReplicaSet` (the new replica over its own
  copy of the weights): no request lost, the same tokens, decisions and
  `autoscale_*` events as the JAX fleet, and the goodput ledger books
  the provision under `scale_up` in both (the retire span's seconds
  under `scale_down` alike in both).
- `ReplicaUpdater`: versions the JAX package publishes (into a weight
  store per fleet) roll across both fleets (2 replicas each) with equal per-replica
  versions after every poll; a NaN version is rolled back on the first
  replica by the gate, quarantined and aborts the roll in both.
"""
import types

import numpy as np
import pytest

from paddle_tpu import flags as jflags
from paddle_tpu.serving import autoscaler as jauto
from paddle_tpu_torch import flags as pflags
from paddle_tpu_torch.serving import autoscaler as pauto
from paddle_tpu_torch.serving import replica_model
from test_torch_observability import isolated_observability
from test_torch_router import (ENGINE, KITS, ROUND_S, FakeClock, jax_state,
                               make_router, models, params, prompts, start,
                               ticking)

AUTO = {'jax': jauto, 'torch': pauto}
__all__ = ['models']     # the module fixture, shared with the router tests


@pytest.fixture(autouse=True, scope='module')
def _isolated(tmp_path_factory):
    yield from isolated_observability(tmp_path_factory)


def _factory(kit, model, clock):
    """The replica factory: a fresh engine over the same weights (in the
    port over a copy of its own), ticking the clock."""
    def make():
        m = model if kit.name == 'jax' else replica_model(model)
        return ticking(kit.serving.InferenceEngine(m, **ENGINE), clock)
    return make


def _events(obs):
    return [(e['name'], {k: v for k, v in e['attrs'].items()
                         if k != 'provision_s' and k != 'drain_s'})
            for e in obs.get_event_log().events()
            if e['name'].startswith('autoscale_')]


def _signals(t):
    """A scripted signal sequence: quiet, a TTFT breach, a queue backlog,
    shedding, then a long quiet stretch."""
    base = {'window_s': 30.0, 'ttft_p50': 0.05, 'ttft_p99': 0.1,
            'queue_p50': 0.0, 'queue_p99': 0.0, 'shed_rate': 0.0,
            'accept_rate': 1.0, 'serving_replicas': 1}
    if 3 <= t < 5:
        base.update(ttft_p99=0.95)
    elif 5 <= t < 8:
        base.update(queue_p99=12.0)
    elif 8 <= t < 10:
        base.update(shed_rate=0.5)
    elif t in (14, 15):
        base.update(queue_p99=None)
    return base


def _policy(kit, model, clock):
    auto = AUTO[kit.name]
    router = make_router(kit, model, 1, clock)
    t = [0]
    scaler = auto.Autoscaler(
        router, _factory(kit, model, clock),
        auto.AutoscalerConfig(min_replicas=1, max_replicas=2,
                              slo_ttft_s=1.0, cooldown_s=2.0,
                              down_stable_s=3.0),
        clock=clock, force=True, signal_source=lambda: _signals(t[0]))
    out = []
    for t[0] in range(40):
        clock.advance(1.0)
        out.append(scaler.poll())
        if router.replicas and any(r.engine.has_work
                                   for r in router.replicas):
            router.run()
    st = scaler.stats()
    return types.SimpleNamespace(
        decisions=out, events=_events(kit.obs),
        stats={k: v for k, v in st.items() if k != 'provision_ema_s'},
        replicas=[r.id for r in router.replicas])


def test_policy_decisions_match(models, monkeypatch):
    got = {}
    for name, kit in KITS.items():
        clock = FakeClock()
        start(kit, monkeypatch, clock)
        got[name] = _policy(kit, models[name], clock)
    p, j = got['torch'], got['jax']
    assert p.decisions == j.decisions
    assert p.events == j.events
    assert p.stats == j.stats and p.replicas == j.replicas
    assert {'hold', 'hold_cooldown', 'scale_up', 'scale_down',
            'hold_at_min'} <= set(p.decisions)
    assert p.decisions.count('scale_up') == 1
    assert [e for e, _ in p.events] == [
        'autoscale_up', 'autoscale_down_begin', 'autoscale_down_complete']


def test_config_and_flags_match():
    for kw in ({'min_replicas': 0}, {'min_replicas': 3, 'max_replicas': 2},
               {'slo_ttft_s': 0.0}, {'down_ttft_frac': 0.9},
               {'down_queue_per_replica': 5.0}, {'cooldown_s': -1.0}):
        errs = []
        for auto in (jauto, pauto):
            with pytest.raises(ValueError) as exc:
                auto.AutoscalerConfig(**kw)
            errs.append(str(exc.value))
        assert errs[0] == errs[1]
    names = ('FLAGS_autoscale', 'FLAGS_autoscale_min_replicas',
             'FLAGS_autoscale_max_replicas', 'FLAGS_autoscale_cooldown_s')
    assert pflags.get_flags(names) == jflags.get_flags(names)
    assert pauto.AutoscalerConfig.from_flags() == pauto.AutoscalerConfig(
        **vars(jauto.AutoscalerConfig.from_flags()))


def _burst(kit, model, clock):
    auto = AUTO[kit.name]
    router = make_router(kit, model, 1, clock, signal_window_s=1.0)
    for w in (router._win_ttft, router._win_queue, router._win_shed,
              router._win_accept):
        w._clock = clock
    scaler = auto.Autoscaler(
        router, _factory(kit, model, clock),
        auto.AutoscalerConfig(min_replicas=1, max_replicas=2,
                              slo_ttft_s=5.0, cooldown_s=0.2,
                              down_stable_s=0.3,
                              up_queue_per_replica=2.0,
                              down_queue_per_replica=0.5),
        clock=clock, force=True)
    burst = prompts([9, 14, 6, 11, 8, 13, 7, 10, 12, 5], seed=9)
    handles = [router.submit(p, params(kit, 4)) for p in burst[:6]]
    decisions = []
    for _ in range(400):
        decisions.append(scaler.poll())
        if decisions[-1] == 'scale_up':
            # the second half of the burst lands on the grown fleet
            handles += [router.submit(p, params(kit, 4))
                        for p in burst[6:]]
        router.step()             # samples the queue even when idle
        if not router._live:
            clock.advance(ROUND_S)
            if len(router.replicas) == 1 and 'scale_down' in decisions:
                break
    gp = kit.obs.get_ledger().report()['categories']
    return types.SimpleNamespace(
        decisions=decisions, events=_events(kit.obs),
        tokens=[list(h.tokens) for h in handles],
        status=[h.status for h in handles],
        placed=[h.replica_id for h in handles],
        replicas=[r.id for r in router.replicas],
        booked=(gp['scale_up'] > 0, gp['scale_down'] > 0))


def test_scale_up_then_drained_scale_down_matches(models, monkeypatch):
    got = {}
    for name, kit in KITS.items():
        clock = FakeClock()
        start(kit, monkeypatch, clock)
        got[name] = _burst(kit, models[name], clock)
    p, j = got['torch'], got['jax']
    assert p.decisions == j.decisions
    assert p.events == j.events
    assert p.tokens == j.tokens and p.status == j.status
    assert p.placed == j.placed and p.replicas == j.replicas
    assert p.booked == j.booked and p.booked[0]
    assert all(s == 'FINISHED' for s in p.status)
    assert p.decisions.count('scale_up') == 1
    assert p.decisions.count('scale_down') == 1
    assert 1 in p.placed                   # the new replica served work


def _roll(kit, model, clock, store_dir):
    router = make_router(kit, model, 2, clock)
    store = kit.serving.WeightStore(store_dir)
    updater = kit.serving.ReplicaUpdater(router, store)
    return router, updater


def test_replica_updater_rolls_jax_versions_across_both_fleets(
        monkeypatch, tmp_path):
    from paddle_tpu.serving import WeightStore as JaxStore
    from test_torch_router import port_model
    jm, state = jax_state(11)
    fresh = {'jax': jm, 'torch': port_model(state)}
    # one store per fleet (a quarantine by one fleet's gate must not
    # hide the version from the other), both written by the JAX package
    dirs = {n: str(tmp_path / f'weights_{n}') for n in KITS}
    publishers = {n: JaxStore(d) for n, d in dirs.items()}
    clocks = {n: FakeClock() for n in KITS}
    fleets = {}
    for name, kit in KITS.items():
        start(kit, monkeypatch, clocks[name])
        fleets[name] = _roll(kit, fresh[name], clocks[name], dirs[name])
    probe = prompts([10, 17], seed=12)
    history = []
    nan_state = dict(jax_state(99)[1])
    key = sorted(nan_state)[0]
    nan_state[key] = np.full_like(nan_state[key], np.nan)
    for new in (jax_state(1234)[1], jax_state(4321)[1], nan_state):
        version = {publishers[n].publish(new) for n in KITS}.pop()
        step = {}
        for name, kit in KITS.items():
            router, updater = fleets[name]
            for p in probe:            # traffic in flight during the roll
                router.submit(p, params(kit, 4))
            res = updater.poll()
            router.run()
            toks = [list(h.tokens) for h in router.generate_many(
                probe, params(kit, 4))]
            step[name] = (version, updater.current_versions(),
                          updater.fleet_version, res['outcome'],
                          [r['outcome'] for r in res['replicas']], toks)
        assert step['torch'] == step['jax']
        history.append(step['torch'])
    assert [h[1] for h in history] == [{0: 1, 1: 1}, {0: 2, 1: 2},
                                       {0: 2, 1: 2}]
    assert history[2][3] == 'aborted' and history[2][4] == ['rolled_back']
    assert all(pub.quarantined() == [3] for pub in publishers.values())
    assert history[0][5] != history[1][5]
    for name, kit in KITS.items():
        swaps = kit.obs.get_registry().value('paddle_swap_total',
                                             outcome='completed')
        assert swaps == 4
        assert kit.obs.get_registry().value(
            'paddle_swap_rollbacks_total') == 1
