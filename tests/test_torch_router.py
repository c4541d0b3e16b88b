"""Replicated serving in one process (paddle_tpu_torch.serving.router and
tenancy) against the JAX package's, on the CPU, over the tiny GQA Llama
carried across by `from_jax_state`.

- `CircuitBreaker` on an injected clock: the same states, admissions and
  `breaker_*` events through a scripted failure/probe sequence.
- Tenancy over a seeded table of inputs: `TokenBucket` grants and
  `retry_after`, `TenantRegistry`, `parse_tenant_spec` (its errors too),
  `prefill_rounds`, `estimate_queue_rounds` and `AdmissionRejected`.
- A 2-replica router on one trace: the same tokens and replica
  placements per request, `stats()`, `paddle_router_*` counters and
  gauges (the sliding-window signal gauges too), histogram counts and
  router events; the `router` section of
  `debug.observability_summary()`.
- Chaos: replica 0 raises a `TransientError` at its k-th step; the same
  failovers in both, 0 lost, every request's tokens equal to the
  undisturbed run's. A fatal error fails the orphans with the typed
  `ReplicaFailure` in both; in the port a CUDA error is fatal too.
- QoS: a protected tenant beside a sheddable flood, the same sheds,
  reasons and `retry_after_s`.
- The parameter-storage trap: the port's replicas past the first hold
  their own parameters, so after a swap of replica 0 alone replica 1
  still decodes the old version's tokens, in both packages.

Both packages' routers run on one fake clock (their `time` module
replaced, their windows' clocks set) that advances a fixed step per
replica round, so both see the same instants; the request ledger is off
(its records would mix the fake clock with the engines' real one).
"""
import types

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import debug as jdebug
from paddle_tpu import observability as jobs
from paddle_tpu import serving as jserving
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.resilience import TransientError as JaxTransient
from paddle_tpu.serving import router as jrouter
from paddle_tpu.serving import tenancy as jtenancy
from paddle_tpu_torch import debug as pdebug
from paddle_tpu_torch import observability as pobs
from paddle_tpu_torch import serving as pserving
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.resilience import TransientError as PortTransient
from paddle_tpu_torch.serving import router as prouter
from paddle_tpu_torch.serving import tenancy as ptenancy
from paddle_tpu_torch.weights import from_jax_state
from test_torch_observability import (isolated_observability,
                                      reset_observability)

NO_EOS = -1
ENGINE = dict(num_slots=2, max_length=64, decode_block=2, kv_page_size=16)
ROUND_S = 0.05          # fake seconds per replica round
ROUTER_EVENTS = frozenset((
    'router_failover', 'router_failover_storm', 'breaker_open',
    'breaker_half_open', 'breaker_closed', 'request_shed'))
WINDOW_GAUGES = frozenset((
    'paddle_ttft_p50_window', 'paddle_ttft_p99_window',
    'paddle_queue_depth_p50_window', 'paddle_queue_depth_p99_window',
    'paddle_shed_rate_window'))

KITS = {
    'jax': types.SimpleNamespace(
        name='jax', obs=jobs, serving=jserving, router=jrouter,
        tenancy=jtenancy, debug=jdebug, Transient=JaxTransient),
    'torch': types.SimpleNamespace(
        name='torch', obs=pobs, serving=pserving, router=prouter,
        tenancy=ptenancy, debug=pdebug, Transient=PortTransient),
}


@pytest.fixture(autouse=True, scope='module')
def _isolated(tmp_path_factory):
    yield from isolated_observability(tmp_path_factory)


def jax_state(seed):
    paddle.seed(seed)
    jm = jllama.LlamaForCausalLM(
        jllama.LlamaConfig.tiny(num_key_value_heads=2)).eval()
    return jm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def port_model(state):
    return from_jax_state(state, LlamaForCausalLM(
        LlamaConfig.tiny(num_key_value_heads=2), device='cpu'))


@pytest.fixture(scope='module')
def models():
    """{'jax': JAX model, 'torch': the port's, same weights}."""
    jm, state = jax_state(11)
    return {'jax': jm, 'torch': port_model(state)}


class FakeClock:
    """One clock for both packages: `advance()` moves it by a fixed
    step (each replica round does). It starts at 0: a replay compares
    `now - t0` against an arrival and sleeps `t0 + arrival - now`, and
    with t0 = 0 the two agree exactly in floating point."""

    def __init__(self, t: float = 0.0, step: float = ROUND_S):
        self.t = float(t)
        self.step = float(step)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt=None):
        self.t += self.step if dt is None else float(dt)

    def sleep(self, dt):
        self.advance(dt)


def use_clock(monkeypatch, clock, *modules):
    """Replace `time` in `modules` by the fake clock."""
    fake = types.SimpleNamespace(perf_counter=clock, monotonic=clock,
                                 time=clock, sleep=clock.sleep)
    for mod in modules:
        monkeypatch.setattr(mod, 'time', fake)


def ticking(engine, clock):
    """Make each of `engine`'s rounds advance the clock by one step."""
    real = engine.step

    def step():
        clock.advance()
        return real()
    engine.step = step
    return engine


def start(kit, monkeypatch, clock):
    """A clean slate for one package: registries, logs and ledgers reset,
    the request ledger off, the router module on the fake clock."""
    reset_observability(kit.obs)
    kit.obs.get_request_ledger().disable()
    use_clock(monkeypatch, clock, kit.router)


def make_router(kit, model, replicas, clock, breaker=None, **router_kw):
    """A Router over a `ReplicaSet(model, replicas, **ENGINE)` whose
    engines tick the clock, whose breakers and windows read it."""
    rs = kit.serving.ReplicaSet(
        model, replicas, breaker_kwargs=dict(breaker or {}, clock=clock),
        **ENGINE)
    for r in rs:
        ticking(r.engine, clock)
    router = kit.serving.Router(rs, **router_kw)
    for w in (router._win_ttft, router._win_queue, router._win_shed,
              router._win_accept):
        w._clock = clock
    return router


def prompts(lens, seed=0, vocab=128):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, (s,)).tolist() for s in lens]


def params(kit, n=5):
    return kit.serving.SamplingParams(max_new_tokens=n, eos_token_id=NO_EOS)


TRACE = prompts([12, 30, 7, 22, 15, 9], seed=3)


def router_events(obs):
    """The router's events in order, time fields removed."""
    out = []
    for e in obs.get_event_log().events():
        if e['name'] in ROUTER_EVENTS:
            out.append((e['name'], {k: v for k, v in (e.get('attrs') or {})
                                    .items()}))
    return out


def router_metrics(obs):
    """{(family, labels): value} of the router's families: counters and
    gauges exactly (the window gauges are on the fake clock), histograms
    by count."""
    out = {}
    for m in obs.get_registry().snapshot()['metrics']:
        name = m['name']
        if not (name.startswith('paddle_router_') or name in WINDOW_GAUGES):
            continue
        for s in m['samples']:
            key = (name, tuple(sorted((k, str(v))
                                      for k, v in s['labels'].items())))
            if m['type'] == 'histogram':
                if s['count']:
                    out[key] = ('count', s['count'])
            elif s['value']:
                out[key] = s['value']
    return out


def both(fn, models, monkeypatch, **kw):
    """`fn(kit, model, clock, **kw)` for each package, each from a clean
    slate on a fresh clock; returns {'jax': ..., 'torch': ...}."""
    out = {}
    for name, kit in KITS.items():
        clock = FakeClock()
        start(kit, monkeypatch, clock)
        out[name] = fn(kit, models[name], clock, **kw)
    return out


# ---------------------------------------------------------------------------
# the breaker and tenancy
# ---------------------------------------------------------------------------

def _breaker_script(kit, clock):
    reset_observability(kit.obs)
    b = kit.router.CircuitBreaker(name='7', failure_threshold=2,
                                  reset_after_s=3.0, clock=clock)
    seen = []

    def note(what):
        seen.append((what, b.state, b.admits()))
    for step in ('fail', 'ok', 'fail', 'fail', 'tick', 'tick', 'tick',
                 'probe', 'fail', 'tick', 'tick', 'tick', 'tick', 'probe',
                 'ok', 'fail', 'fail', 'tick4', 'probe', 'ok'):
        if step == 'fail':
            b.record_failure()
        elif step == 'ok':
            b.record_success()
        elif step == 'probe':
            b.begin_probe()
        else:
            clock.advance(4.0 if step == 'tick4' else 1.0)
        note(step)
    return seen, router_events(kit.obs)


def test_circuit_breaker_transitions_match():
    got = {name: _breaker_script(kit, FakeClock())
           for name, kit in KITS.items()}
    assert got['torch'] == got['jax']
    states = {s for _, s, _ in got['torch'][0]}
    assert states == {'closed', 'open', 'half_open'}
    assert [e for e, _ in got['torch'][1]][:3] == [
        'breaker_open', 'breaker_half_open', 'breaker_open']


TENANT_SPECS = (
    'paid:priority=high,rate=50,burst=100,adapter=paid-v2;'
    'free:priority=low,rate=2,concurrency=2',
    'a:priority=normal', 'b:concurrency=3;c:rate=0.5,burst=1',
    '', 'x:priority=urgent', 'y:rate=abc', 'z:nope=1', ':priority=high',
    'p:priority=high;p:priority=low',
)


def _tenancy_table(kit, seed):
    rng = np.random.RandomState(seed)
    clock = FakeClock(step=0.0)
    out = []
    for _ in range(6):
        rate, burst = float(rng.choice([0.5, 2.0, 10.0])), \
            int(rng.randint(1, 5))
        bucket = kit.tenancy.TokenBucket(rate, burst, clock=clock)
        row = []
        for _ in range(12):
            clock.advance(float(rng.choice([0.0, 0.1, 0.7])))
            row.append((bucket.try_acquire(), round(bucket.retry_after(),
                                                    12)))
        out.append(row)
    for spec in TENANT_SPECS:
        try:
            reg = kit.tenancy.parse_tenant_spec(spec)
            out.append(sorted((n, t.spec()) for n, t in
                              reg.tenants().items()))
            out.append(reg.get('unknown-tenant').spec())
        except (ValueError, KeyError) as exc:
            out.append((type(exc).__name__, str(exc)))
    for _ in range(8):
        chunk = None if rng.rand() < 0.3 else int(rng.randint(1, 64))
        lens = [int(x) for x in rng.randint(1, 300, rng.randint(0, 6))]
        out.append((kit.tenancy.estimate_queue_rounds(lens, chunk),
                    [kit.tenancy.prefill_rounds(n, chunk) for n in lens]))
    for reason in ('shed', 'rate_limited', 'bogus'):
        try:
            exc = kit.tenancy.AdmissionRejected('t', reason, 1.5, 'why')
            out.append((exc.tenant, exc.reason, exc.retry_after_s,
                        str(exc)))
        except ValueError as err:
            out.append(('ValueError', str(err)))
    return out


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_tenancy_matches_over_a_seeded_table(seed):
    assert _tenancy_table(KITS['torch'], seed) == \
        _tenancy_table(KITS['jax'], seed)


# ---------------------------------------------------------------------------
# the router on a trace
# ---------------------------------------------------------------------------

def _serve(kit, model, clock, replicas=2, kill=None, trace=TRACE,
           breaker=None):
    router = make_router(kit, model, replicas, clock, breaker)
    placed = []
    handles = []
    for p in trace:
        h = router.submit(p, params(kit))
        placed.append(h.replica_id)
        handles.append(h)
    victim = router.replicas[0].engine
    if kill is not None:
        at, exc = kill
        real, calls = victim.step, [0]

        def dying():
            calls[0] += 1
            if calls[0] == at:
                raise exc
            return real()
        victim.step = dying
    router.run()
    if breaker:
        # after the cooldown the open breaker admits one probe, whose
        # success closes it
        clock.advance(breaker['reset_after_s'])
        probe = router.submit(trace[0], params(kit))
        router.run()
        handles.append(probe)
        placed.append(probe.replica_id)
    st = router.stats()
    lost = sum(1 for h in handles
               if not (h.status == 'FINISHED'
                       or (h.status == 'FAILED' and h.error is not None)))
    return types.SimpleNamespace(
        router=router, placed=placed, lost=lost,
        final=[h.replica_id for h in handles],
        tokens=[list(h.tokens) for h in handles],
        status=[h.status for h in handles],
        failovers=[h.failovers for h in handles],
        errors=[type(h.error).__name__ if h.error is not None else None
                for h in handles],
        ttft=[h.ttft for h in handles],
        stats={k: v for k, v in st.items()},
        events=router_events(kit.obs), metrics=router_metrics(kit.obs),
        summary=router_summary(kit, router))


def router_summary(kit, router):
    """The `router` section of `debug.observability_summary()`, read for
    `router`'s replicas and the outcomes it produced: a registry reset
    zeroes the families' children but keeps them, so other tests' routers
    in this process leave rows at zero."""
    out = dict(kit.debug.observability_summary(as_dict=True)['router'])
    ids = {str(r.id) for r in router.replicas}
    out['per_replica'] = [r for r in out['per_replica']
                          if str(r['replica']) in ids]
    out['outcomes'] = {k: v for k, v in out['outcomes'].items() if v}
    return out


def _same(a, b, fields):
    for f in fields:
        assert getattr(a, f) == getattr(b, f), f


def test_two_replica_router_matches_jax(models, monkeypatch):
    got = both(_serve, models, monkeypatch)
    p, j = got['torch'], got['jax']
    _same(p, j, ('placed', 'final', 'tokens', 'status', 'failovers', 'ttft',
                 'stats', 'events', 'metrics', 'summary'))
    assert set(p.placed) == {0, 1} and p.lost == 0
    assert all(s == 'FINISHED' for s in p.status)
    assert p.stats['completed'] == len(TRACE)
    assert ('paddle_router_requests_total',
            (('outcome', 'completed'), ('tenant', 'default'))) in p.metrics
    assert any(k[0] == 'paddle_ttft_p99_window' for k in p.metrics)
    assert set(p.summary) == {'replicas', 'available', 'queue_depth',
                              'failovers', 'shed', 'outcomes',
                              'per_replica'}
    # one replica serves the same tokens: placement never changes them
    one = both(_serve, models, monkeypatch, replicas=1)
    assert one['torch'].tokens == one['jax'].tokens == p.tokens


def test_chaos_failover_matches_jax(models, monkeypatch):
    calm = both(_serve, models, monkeypatch)
    got = {}
    for name, kit in KITS.items():
        clock = FakeClock()
        start(kit, monkeypatch, clock)
        got[name] = _serve(kit, models[name], clock, kill=(
            3, kit.Transient('UNAVAILABLE: injected replica loss')),
            breaker={'failure_threshold': 1, 'reset_after_s': 1.0})
    p, j = got['torch'], got['jax']
    _same(p, j, ('placed', 'final', 'tokens', 'status', 'failovers',
                 'errors', 'stats', 'events', 'metrics', 'summary'))
    assert p.lost == 0 and sum(p.failovers) > 0
    assert p.tokens[:-1] == calm['torch'].tokens
    assert p.tokens[-1] == calm['torch'].tokens[0]
    assert p.placed[-1] == 0                  # the probe went to replica 0
    assert all(s == 'FINISHED' for s in p.status)
    assert [e for e, _ in p.events] == [
        'breaker_open', 'router_failover', 'breaker_half_open',
        'breaker_closed']
    assert p.summary['failovers'] == sum(p.failovers)


@pytest.mark.parametrize('fatal', ['value', 'cuda'])
def test_fatal_replica_error_fails_orphans_typed(models, monkeypatch,
                                                 fatal):
    got = {}
    for name, kit in KITS.items():
        if fatal == 'cuda' and name == 'jax':
            continue
        clock = FakeClock()
        start(kit, monkeypatch, clock)
        exc = (ValueError('corrupted page table') if fatal == 'value' else
               RuntimeError('CUDA error: an illegal memory access was '
                            'encountered'))
        got[name] = _serve(kit, models[name], clock, kill=(2, exc))
    p = got['torch']
    if 'jax' in got:
        _same(p, got['jax'], ('final', 'tokens', 'status', 'failovers',
                              'errors', 'stats', 'events', 'metrics'))
    assert p.lost == 0 and 'ReplicaFailure' in p.errors
    assert sum(p.failovers) == 0
    assert p.stats['failed'] == p.errors.count('ReplicaFailure')


def _qos(kit, model, clock):
    router = make_router(
        kit, model, 1, clock,
        tenants='paid:priority=high;free:priority=low,concurrency=2',
        shed_queue_depth=2)
    accepted, shed = [], []
    for i, p in enumerate(prompts([10, 14, 8, 20, 6, 12, 9, 16, 11, 7],
                                  seed=5)):
        tenant = 'paid' if i % 3 == 0 else 'free'
        try:
            accepted.append((tenant, router.submit(p, params(kit, 4),
                                                   tenant=tenant)))
        except kit.tenancy.AdmissionRejected as exc:
            shed.append((i, exc.tenant, exc.reason, exc.retry_after_s))
        if i % 3 == 2:
            router.step()     # a burst of three, then one fleet round
    router.run()
    return types.SimpleNamespace(
        shed=shed, tokens=[list(h.tokens) for _, h in accepted],
        status=[h.status for _, h in accepted],
        ttft=[(t, h.ttft) for t, h in accepted],
        stats=router.stats(), events=router_events(kit.obs),
        metrics=router_metrics(kit.obs))


def test_qos_shedding_matches_jax(models, monkeypatch):
    got = both(_qos, models, monkeypatch)
    p, j = got['torch'], got['jax']
    _same(p, j, ('shed', 'tokens', 'status', 'ttft', 'stats', 'events',
                 'metrics'))
    assert p.shed and all(r is not None for *_, r in p.shed)
    assert {reason for _, _, reason, _ in p.shed} >= {'concurrency'}
    assert all(s == 'FINISHED' for s in p.status)
    paid = [i for i, (t, _) in enumerate(p.ttft) if t == 'paid']
    assert paid and all(p.status[i] == 'FINISHED' for i in paid)


# ---------------------------------------------------------------------------
# the parameter-storage trap
# ---------------------------------------------------------------------------

def _swap_one(kit, model, clock, tree, tmp_path):
    router = make_router(kit, model, 2, clock)
    probe = prompts([11, 19], seed=8)
    sp = params(kit, 6)
    before = [[list(h.tokens) for h in r.engine.generate_many(probe, sp)]
              for r in router.replicas]
    store = kit.serving.WeightStore(str(tmp_path / kit.name))
    updater = kit.serving.ReplicaUpdater(router, store)
    res = updater._swap_replica(router.replicas[0], 1, tree)
    after = [[list(h.tokens) for h in r.engine.generate_many(probe, sp)]
             for r in router.replicas]
    return types.SimpleNamespace(
        before=before, after=after, outcome=res['outcome'],
        versions=updater.current_versions(), fleet=updater.fleet_version,
        recaptures=res['real_compiles'])


def test_swap_of_one_replica_leaves_the_other_on_its_version(
        models, monkeypatch, tmp_path):
    trained = jax_state(1234)[1]
    fresh = {'jax': jax_state(11)[0], 'torch': port_model(jax_state(11)[1])}
    got = {}
    for name, kit in KITS.items():
        clock = FakeClock()
        start(kit, monkeypatch, clock)
        got[name] = _swap_one(kit, fresh[name], clock, trained, tmp_path)
    p, j = got['torch'], got['jax']
    _same(p, j, ('before', 'after', 'outcome', 'versions', 'fleet',
                 'recaptures'))
    assert p.outcome == 'completed' and p.versions == {0: 1, 1: 0}
    assert p.fleet is None                   # a mixed fleet
    assert p.before[0] == p.before[1] == p.after[1]
    assert p.after[0] != p.after[1]
    # the new version's tokens are those of an engine over the new weights
    eng = pserving.InferenceEngine(port_model(trained), **ENGINE)
    want = [list(h.tokens) for h in eng.generate_many(
        prompts([11, 19], seed=8), params(KITS['torch'], 6))]
    assert p.after[0] == want
    # the port's replicas past the first own their parameters
    r0, r1 = (r.engine.model for r in (
        make_router(KITS['torch'], models['torch'], 2, FakeClock())
        .replicas))
    assert r0 is models['torch']
    for (n0, t0), (n1, t1) in zip(r0.named_parameters(),
                                  r1.named_parameters()):
        assert n0 == n1 and t0.data_ptr() != t1.data_ptr()
        assert bool((t0 == t1).all())
