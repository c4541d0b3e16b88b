"""The SLO engine (paddle_tpu_torch.observability.slo) against the JAX
package's, on the CPU.

- `SLOEngine` over the same seeded sequence of synthetic registry views
  on one fake clock: the same `poll()` reports tick by tick (burn rates
  of both windows, budget remaining, alert state), the same breach and
  recovery transitions, the same `slo_*` events and `paddle_slo_*`
  gauges; objective validation raises the same errors.
- After a 2-replica router run (the router tests' fake clock), an engine
  of `default_objectives()` polled once per router round reads the local
  registry, and `/slo?poll=1` on each package's server gives the same
  body in its non-time fields.
- A breach with a capture directory starts a bounded `torch.profiler`
  capture in the port (`slo_capture`) on a thread of its own, stopped
  after `capture_s`.
"""
import json
import time
import urllib.request

import numpy as np
import pytest

from paddle_tpu import observability as jobs
from paddle_tpu_torch import observability as pobs
from test_torch_observability import (isolated_observability,
                                      reset_observability)
from test_torch_router import (KITS, TRACE, FakeClock, make_router,
                               models, params, start)

OBS = {'jax': jobs, 'torch': pobs}
__all__ = ['models']     # the module fixture, shared with the router tests


@pytest.fixture(autouse=True, scope='module')
def _isolated(tmp_path_factory):
    yield from isolated_observability(tmp_path_factory)


def _views(seed, ticks=40):
    """Cumulative router counters and a TTFT p99 gauge, tick by tick: a
    calm stretch, a burst of failures and slow first tokens, recovery."""
    rng = np.random.RandomState(seed)
    ok = failed = shed = 0.0
    out = []
    for t in range(ticks):
        bad = 8 <= t < 22
        ok += int(rng.randint(5, 20))
        failed += int(rng.randint(2, 6)) if bad else int(rng.rand() < 0.1)
        shed += int(rng.randint(0, 4)) if bad else 0
        p99 = float(rng.uniform(1.2, 2.0) if bad else rng.uniform(0.1, 0.4))
        samples = [{'labels': {'tenant': 'a', 'outcome': 'completed'},
                    'value': ok},
                   {'labels': {'tenant': 'a', 'outcome': 'failed'},
                    'value': failed}]
        if t % 7 == 3:
            samples = samples[:1] + [{'labels': {'tenant': 'b',
                                                 'outcome': 'failed'},
                                      'value': 0.0}] + samples[1:]
        out.append({'metrics': [
            {'name': 'paddle_router_requests_total', 'samples': samples},
            {'name': 'paddle_router_shed_total', 'samples': [
                {'labels': {'tenant': 'b', 'reason': 'shed'},
                 'value': shed}]},
            {'name': 'paddle_ttft_p99_window', 'samples': (
                [] if t in (0, 30) else [{'labels': {}, 'value': p99}])}]})
    return out


def _strip(report):
    return {**report, 'breaches': [{k: v for k, v in b.items()
                                    if k != 'wall_ts'}
                                   for b in report['breaches']]}


def _slo_run(obs, seed):
    reset_observability(obs)
    clock = FakeClock(step=30.0)
    views = iter(_views(seed))
    eng = obs.SLOEngine(obs.default_objectives(1.0), view_fn=lambda: next(
        views), clock=clock, short_window_s=120.0, long_window_s=600.0,
        burn_alert=4.0)
    reports = []
    for _ in range(40):
        clock.advance()
        reports.append(_strip(eng.poll()))
    events = [(e['name'], e.get('attrs')) for e in
              obs.get_event_log().events() if e['name'].startswith('slo_')]
    gauges = {}     # non-zero: other tests' children survive a reset at 0
    for m in obs.get_registry().snapshot()['metrics']:
        if m['name'].startswith('paddle_slo_'):
            for s in m['samples']:
                if s['value']:
                    gauges[(m['name'], tuple(sorted(
                        s['labels'].items())))] = s['value']
    return reports, events, gauges, {o.name: eng.alerting(o.name)
                                     for o in eng.objectives}


@pytest.mark.parametrize('seed', [0, 1])
def test_slo_engine_matches_over_synthetic_views(seed):
    got = {name: _slo_run(obs, seed) for name, obs in OBS.items()}
    assert got['torch'] == got['jax']
    reports, events, gauges, _ = got['torch']
    names = [n for n, _ in events]
    assert 'slo_breach' in names and 'slo_recovered' in names
    assert any(r['breaches'] for r in reports)
    assert ('paddle_slo_breaches_total', (('slo', 'availability'),)) in gauges


def test_objective_validation_matches():
    def errors(obs):
        out = []
        for make in (
                lambda: obs.Objective.ratio('x', 'a', 'b', budget=0.0),
                lambda: obs.Objective.ratio('x', 'a', 'b', budget=1.0),
                lambda: obs.Objective('x', 'gauge', 0.1),
                lambda: obs.SLOEngine([obs.Objective.ratio(
                    'x', 'a', 'b', 0.1)] * 2),
                lambda: obs.SLOEngine(short_window_s=10,
                                      long_window_s=10)):
            try:
                make()
                out.append(None)
            except ValueError as exc:
                out.append(str(exc))
        return out
    assert errors(pobs) == errors(jobs)
    assert None not in errors(pobs)


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, json.loads(r.read().decode())


def test_slo_endpoint_after_a_router_run(models, monkeypatch):
    bodies = {}
    for name, kit in KITS.items():
        clock = FakeClock()
        start(kit, monkeypatch, clock)
        router = make_router(kit, models[name], 2, clock)
        slo = kit.obs.SLOEngine(kit.obs.default_objectives(0.08),
                                clock=clock, short_window_s=1.0,
                                long_window_s=4.0, burn_alert=2.0)
        kit.obs.set_slo_engine(slo)
        srv = kit.obs.start_server(0, host='127.0.0.1')
        try:
            for p in TRACE:
                router.submit(p, params(kit))
            while router._live:
                router.step()
                slo.poll()
            status, body = _get(f'{srv.url}/slo?poll=1')
        finally:
            srv.stop()
            kit.obs.set_slo_engine(None)
        assert status == 200
        bodies[name] = _strip(body)
    assert bodies['torch'] == bodies['jax']
    objs = {o['name']: o for o in bodies['torch']['objectives']}
    assert objs['availability']['burn_long'] == 0.0
    assert objs['ttft_p99']['burn_short'] is not None


def test_breach_capture_is_bounded(tmp_path):
    reset_observability(pobs)
    clock = FakeClock(step=30.0)
    views = iter(_views(0))
    eng = pobs.SLOEngine(pobs.default_objectives(1.0), view_fn=lambda: next(
        views), clock=clock, short_window_s=120.0, long_window_s=600.0,
        burn_alert=4.0, capture_dir=str(tmp_path), capture_s=0.2)
    for _ in range(40):
        clock.advance()
        eng.poll()
    caps = [e['attrs'] for e in pobs.get_event_log().events()
            if e['name'] == 'slo_capture']
    assert caps, 'no capture started on the breach'
    deadline = time.time() + 20
    while eng._capturing and time.time() < deadline:
        time.sleep(0.05)
    assert not eng._capturing
    path = caps[0]['path']
    assert path.startswith(str(tmp_path))
    assert (tmp_path / path.rsplit('/', 1)[-1] / 'trace.json').exists() or \
        pobs.get_registry().value('paddle_suppressed_errors_total',
                                  site='slo.capture_stop') > 0
