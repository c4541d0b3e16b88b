"""The port's observability layer (`paddle_tpu_torch/observability`,
`analysis/runtime/concurrency.py`) against the JAX package's, module by
module, on the CPU: each test applies one seeded sequence of operations
to both packages' modules and compares what comes out.

- `to_prometheus_text` and `to_jsonl` byte-equal for the same registry
  operations: label escaping, non-finite values, histogram buckets, the
  non-finite drop counter and the `_wq` quantile gauges;
- `SlidingWindow` quantiles, counts, rates and means under an injected
  clock;
- the `EventLog` ring (sequence numbers, drops) and the HTTP server's
  `/events` filters (`type=`, `since=` by sequence and by time, `n=`,
  `trace_id=`);
- span nesting and `to_chrome_trace`, timestamps removed;
- the `GoodputLedger` fed one span stream (directly and through the
  event log, a `bad_step` included) under a fixed clock: equal seconds
  per category and an equal residual;
- `RequestLedger.report()` for the same records;
- `EVENT_SCHEMA`;
- with `FLAGS_observability` off, the hot-path hooks make no registry
  call;
- an AB/BA lock pair reports `lock_order_cycle` in both sanitizers (and
  raises under strict mode), a re-entry raises in both.
"""
import ast
import importlib
import json
import math
import pathlib
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu import observability as jobs
from paddle_tpu.analysis.runtime import concurrency as jconc
from paddle_tpu.observability import events as jevents
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import reqledger as jreq
from paddle_tpu_torch import observability as pobs
from paddle_tpu_torch.analysis.runtime import concurrency as pconc
from paddle_tpu_torch.observability import events as pevents
from paddle_tpu_torch.observability import metrics as pmetrics
from paddle_tpu_torch.observability import reqledger as preq

ROOT = pathlib.Path(__file__).resolve().parents[1]
# both packages export a function `retry` beside the module
jretry = importlib.import_module('paddle_tpu.resilience.retry')
pretry = importlib.import_module('paddle_tpu_torch.resilience.retry')

PACKAGES = {'jax': (jobs, jmetrics, jevents, jreq, jconc),
            'torch': (pobs, pmetrics, pevents, preq, pconc)}


def reset_observability(obs):
    """Zero one package's process-global observability state: the
    registry's values, the event log, both ledgers (the request ledger
    opening records again) and every degraded state."""
    obs.enable()
    obs.get_registry().reset()
    obs.get_event_log().clear()
    obs.get_ledger().reset()
    led = obs.get_request_ledger()
    led.enable()
    led.reset()
    for state in obs.degraded_states('*'):
        for scope in [None] + [f'replica:{i}' for i in range(8)]:
            obs.clear_degraded(state, scope=scope, force=True)


def isolated_observability(tmp_path_factory):
    """The body of a module fixture of the port's tests that drive both
    packages: both packages' observability state is reset around the
    module, and both flight recorders write their bundles (a failed
    request, a sanitizer report, a slow request) into a temp directory,
    never into the checkout."""
    saved = []
    for name, obs in (('jax', jobs), ('torch', pobs)):
        rec = obs.get_flight_recorder()
        saved.append((rec, rec.dump_dir))
        rec.dump_dir = str(tmp_path_factory.mktemp(f'flight_{name}'))
        reset_observability(obs)
    yield
    for rec, prev in saved:
        rec.dump_dir = prev
    for obs in (jobs, pobs):
        reset_observability(obs)


@pytest.fixture(autouse=True, scope='module')
def _isolated(tmp_path_factory):
    yield from isolated_observability(tmp_path_factory)


# ---------------------------------------------------------------------------
# the registry and its exporters
# ---------------------------------------------------------------------------

_LABEL_VALUES = ('plain', 'a"quote', 'back\\slash', 'new\nline', 'é',
                 'sp ace', '')
_FAMILIES = (
    ('c_requests_total', 'counter', 'requests "by" status\\path', ('status',)),
    ('c_plain_total', 'counter', 'a plain counter\nsecond line', ()),
    ('g_depth', 'gauge', 'queue depth', ()),
    ('g_by_scope', 'gauge', 'by scope', ('scope', 'kind')),
    ('h_latency_seconds', 'histogram', 'latency', ()),
    ('h_ratio', 'histogram', 'ratio', ('bucket',)),
)
_RATIO_BUCKETS = (0.125, 0.25, 0.5, 1.0)


def _apply_registry_ops(metrics_mod, seed: int):
    """One seeded sequence of registry operations on a fresh registry."""
    reg = metrics_mod.MetricsRegistry(process_index=0)
    rng = np.random.RandomState(seed)
    for _ in range(160):
        name, typ, help_, labels = _FAMILIES[rng.randint(len(_FAMILIES))]
        if typ == 'histogram':
            fam = reg.histogram(name, help_, labels,
                                buckets=_RATIO_BUCKETS if labels else None)
        else:
            fam = getattr(reg, typ)(name, help_, labels)
        lv = {n: _LABEL_VALUES[rng.randint(len(_LABEL_VALUES))]
              for n in labels}
        child = fam.labels(**lv) if labels else fam
        r = rng.rand()
        if typ == 'counter':
            child.inc(float(rng.randint(0, 5)) if r < 0.5
                      else float(rng.rand() * 3))
        elif typ == 'gauge':
            if r < 0.1:
                child.set(float('nan'))
            elif r < 0.2:
                child.set(float('inf') if rng.rand() < 0.5
                          else float('-inf'))
            elif r < 0.5:
                child.set(float(rng.randn() * 100))
            elif r < 0.7:
                child.set_to_max(float(rng.randint(-5, 50)))
            elif r < 0.85:
                child.inc(float(rng.randint(1, 4)))
            else:
                child.dec(0.5)
        else:
            if r < 0.08:
                child.observe(float('nan'))       # dropped and counted
            elif r < 0.12:
                child.observe(float('inf'))
            else:
                child.observe(float(abs(rng.randn()) * 0.3))
    return reg


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_prometheus_text_and_jsonl_byte_equal(seed):
    regs = {k: _apply_registry_ops(mods[1], seed)
            for k, mods in PACKAGES.items()}
    jtext = jobs.to_prometheus_text(regs['jax'])
    ptext = pobs.to_prometheus_text(regs['torch'])
    assert ptext == jtext
    # the exposition carries what the operations made
    assert 'paddle_metrics_nonfinite_dropped_total' in ptext
    assert '_wq{' in ptext and 'le="+Inf"' in ptext
    assert ('NaN' in ptext) == ('NaN' in jtext)
    assert '\\"quote' in ptext or 'a\\"quote' in ptext
    jl = jobs.to_jsonl(regs['jax'])
    pl = pobs.to_jsonl(regs['torch'])
    assert pl == jl
    assert pobs.read_jsonl(pl) == jobs.read_jsonl(jl)
    # snapshots agree but for the process uid
    js, ps = regs['jax'].snapshot(), regs['torch'].snapshot()
    js.pop('process_uid'), ps.pop('process_uid')
    assert json.dumps(ps, sort_keys=True, default=str) == \
        json.dumps(js, sort_keys=True, default=str)


def test_registry_conflicts_and_reset_match():
    """The same misuse raises in both registries, and `reset` zeroes."""
    for _, metrics_mod, *_ in PACKAGES.values():
        reg = metrics_mod.MetricsRegistry(process_index=0)
        reg.counter('x_total', 'x', ('a',)).labels(a='1').inc(2)
        with pytest.raises(ValueError):
            reg.gauge('x_total', 'x', ('a',))
        with pytest.raises(ValueError):
            reg.counter('x_total').labels(b='1')
        with pytest.raises(ValueError):
            reg.counter('x_total', 'x', ('a',)).labels(a='1').inc(-1)
        assert reg.value('x_total', a='1') == 2
        reg.reset()
        assert reg.value('x_total', a='1') == 0


# ---------------------------------------------------------------------------
# the sliding window
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize('seed', [0, 1])
def test_sliding_window_quantiles_under_injected_clock(seed):
    outs = {}
    for k, (_, metrics_mod, *_r) in PACKAGES.items():
        clock = _Clock()
        win = metrics_mod.SlidingWindow(window_s=5.0, clock=clock,
                                        maxlen=64)
        rng = np.random.RandomState(seed)
        seen = []
        for i in range(300):
            clock.t += float(rng.exponential(0.05))
            if rng.rand() < 0.1:
                win.mark()
            else:
                win.observe(float(rng.lognormal(0.0, 1.0)))
            if i % 25 == 0:
                seen.append((win.count(), win.rate(), win.mean(),
                             win.quantile(0.5), win.quantile(0.99),
                             win.quantiles(), win.values()))
        clock.t += 10.0          # everything ages out
        seen.append((win.count(), win.mean(), win.quantile(0.5),
                     win.quantiles()))
        outs[k] = seen
    assert outs['torch'] == outs['jax']
    assert outs['torch'][-1] == (0, None, None, {})


# ---------------------------------------------------------------------------
# the event log, its ring and the /events filters
# ---------------------------------------------------------------------------

def _strip(e):
    return {k: v for k, v in e.items() if k not in ('ts', 'tid', 'dur')}


def _emit_stream(obs, log):
    for i in range(12):
        log.emit('prefix_hit' if i % 3 else 'serving_request_failed',
                 request_id=i % 4, i=i)
    log.emit('not_declared_anywhere', i=99)


def test_event_log_ring_and_drops_match():
    outs = {}
    for k, (obs, metrics_mod, events_mod, *_r) in PACKAGES.items():
        log = events_mod.EventLog(capacity=5)
        assert not log            # empty logs are falsy in both
        _emit_stream(obs, log)
        outs[k] = ([_strip(e) for e in log.events()], log.dropped,
                   len(log), log.capacity,
                   obs.get_registry().value(
                       'paddle_events_undeclared_total',
                       event='not_declared_anywhere'))
        log.clear()
        assert len(log) == 0 and log.dropped == 0
    assert outs['torch'] == outs['jax']
    events, dropped, n, cap, undeclared = outs['torch']
    assert (dropped, n, cap) == (8, 5, 5)
    assert [e['seq'] for e in events] == [9, 10, 11, 12, 13]
    assert undeclared >= 1


_EVENT_QUERIES = ('', '?n=3', '?n=100000', '?type=prefix_hit',
                  '?type=serving_request_failed,prefix_hit&n=2',
                  '?since=7', '?since=7&type=prefix_hit', '?trace_id=2',
                  '?since=0.0', '?n=-4')


def _get(url, timeout=5.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_events_endpoint_filters_match(monkeypatch):
    bodies = {}
    for k, (obs, metrics_mod, events_mod, *_r) in PACKAGES.items():
        log = events_mod.EventLog(capacity=64)
        monkeypatch.setattr(events_mod, '_default_log', log)
        _emit_stream(obs, log)
        srv = obs.start_server(0, host='127.0.0.1')
        try:
            out = []
            for q in _EVENT_QUERIES:
                status, body = _get(f'{srv.url}/events{q}')
                out.append((q, status, [_strip(json.loads(line))
                                        for line in body.splitlines()]))
            out.append(_get(f'{srv.url}/events?since=abc')[0])
        finally:
            srv.stop()
        bodies[k] = out
    assert bodies['torch'] == bodies['jax']
    by_q = {q: ev for q, _, ev in bodies['torch'][:-1]}
    assert len(by_q['?n=3']) == 3
    assert all(e['name'] == 'prefix_hit' for e in by_q['?type=prefix_hit'])
    assert [e['seq'] for e in by_q['?since=7']] == [8, 9, 10, 11, 12, 13]
    assert bodies['torch'][-1] == 400


# ---------------------------------------------------------------------------
# spans and the chrome trace
# ---------------------------------------------------------------------------

def _span_tree(obs, events_mod):
    log = events_mod.EventLog()
    with events_mod.Span('outer', _log=log, step=1):
        with events_mod.Span('mid', _log=log):
            with events_mod.Span('inner', _log=log, k='v'):
                pass
            log.emit('retry', site='x', attempt=0)
        sp = events_mod.Span('explicit', _log=log, n=2).begin()
        sp.end()
        sp.end()                   # a second end records nothing
    return log


def _relative_depth(event, base):
    """`event` with its nesting depth (a field, or a trace event's arg)
    counted from `base`."""
    event = dict(event)
    if 'depth' in event:
        event['depth'] -= base
    if 'depth' in (event.get('args') or {}):
        event['args'] = {**event['args'],
                         'depth': event['args']['depth'] - base}
    return event


def test_span_nesting_and_chrome_trace_match():
    """Depths are counted from the thread's depth before the tree: a
    span some earlier code began and never ended (a request's queue span
    when it is failed while queued, in both packages) stays open on this
    thread."""
    outs = {}
    for k, (obs, metrics_mod, events_mod, *_r) in PACKAGES.items():
        base = events_mod._span_state.depth
        log = _span_tree(obs, events_mod)
        trace = obs.to_chrome_trace(log)
        outs[k] = ([_relative_depth(_strip(e), base) for e in log.events()],
                   [_relative_depth({kk: v for kk, v in e.items()
                                     if kk not in ('ts', 'dur')}, base)
                    for e in trace['traceEvents']],
                   trace['displayTimeUnit'])
    assert outs['torch'] == outs['jax']
    names = [(e['name'], e.get('depth')) for e in outs['torch'][0]]
    assert names == [('inner', 3), ('retry', None), ('mid', 2),
                     ('explicit', 2), ('outer', 1)]


# ---------------------------------------------------------------------------
# the goodput ledger
# ---------------------------------------------------------------------------

# (name, ts, dur, tid) on a fixed clock: nested serving spans, a drain
# around decode rounds, spans straddling the window start, a span of
# no category, a second thread
_SPANS = (
    ('serving.prefill', 1.0, 0.5, 1), ('serving.decode_round', 1.6, 0.2, 1),
    ('serving.decode_round', 1.9, 0.2, 1), ('serving.drain', 1.5, 0.8, 1),
    ('checkpoint_save', 3.0, 0.4, 1), ('resilience.backoff', 3.1, 0.1, 1),
    ('serving.queue', 0.0, 5.0, 2), ('serving.spec_round', 4.0, 0.3, 2),
    ('serving.prefill_chunk', -0.5, 1.0, 1), ('jit.compile', 0.2, 0.1, 3),
    ('serving.draft_prefill', 4.5, 0.05, 1), ('train.step', 5.0, 1.0, 1),
)


def _goodput_books(obs, events_mod, goodput_mod, monkeypatch, via_log):
    now = [0.0]
    monkeypatch.setattr(events_mod, '_now', lambda: now[0])
    log = events_mod.EventLog()
    led = goodput_mod.GoodputLedger(log=log).start(reset=True)
    for name, ts, dur, tid in _SPANS:
        if via_log:
            log.append({'name': name, 'ph': 'X', 'ts': ts, 'dur': dur,
                        'tid': tid, 'depth': 2})
        else:
            led.note_span(name, ts, dur, tid=tid)
    if via_log:
        log.append({'name': 'bad_step', 'ph': 'i', 'ts': 6.0, 'tid': 1})
    now[0] = 10.0
    rep = led.report()
    text = led.report_text()
    led.stop()
    return rep, text


@pytest.mark.parametrize('via_log', [False, True])
def test_goodput_ledger_books_match(monkeypatch, via_log):
    import paddle_tpu.observability.goodput as jgood
    import paddle_tpu_torch.observability.goodput as pgood
    assert pgood.CATEGORIES == jgood.CATEGORIES
    assert pgood.SPAN_CATEGORIES == jgood.SPAN_CATEGORIES
    j = _goodput_books(jobs, jevents, jgood, monkeypatch, via_log)
    p = _goodput_books(pobs, pevents, pgood, monkeypatch, via_log)
    assert p == j
    rep = p[0]
    assert rep['wall_seconds'] == 10.0
    assert math.isclose(sum(rep['categories'].values())
                        + rep['residual_seconds'], 10.0)
    assert rep['categories']['serving_decode'] > 0
    assert rep['categories']['preemption_drain'] > 0


# ---------------------------------------------------------------------------
# the request ledger
# ---------------------------------------------------------------------------

def _request_books(req_mod, events_mod, monkeypatch):
    monkeypatch.setattr(events_mod, '_EPOCH', 0.0)
    monkeypatch.setattr(req_mod.time, 'time', lambda: 5000.0)
    led = req_mod.RequestLedger(window_s=100.0, top_k=3, reservoir=2,
                                slow_ttft_s=0.5, slow_factor=2.0)
    rng = np.random.RandomState(3)
    recs = []
    t = 10.0
    for i in range(7):
        rec = led.open(i, t, tenant=f't{i % 2}', priority=i % 3,
                       adapter_id=None if i % 2 else 'ad0')
        rec.queue_enter(t)
        t_q = t + float(rng.rand())
        rec.queue_block(t_q, 'pool_exhausted' if i % 2
                        else 'adapter_pinned')
        rec.queue_exit(t_q + 0.25)
        rec.add('prefix_lookup', 0.01, now=t_q + 0.26)
        rec.add('admission', 0.02, now=t_q + 0.28)
        recs.append(rec)
        t += 0.3
    end = t + 1.0
    led.note_prefill(0.4, recs[0], recs[:4], now=end)
    for r in range(4):
        end += 0.07
        led.note_round(0.07, recs[:5], 'decode' if r % 2 else
                       'spec_verify', now=end, absorb=bool(r % 2))
        if r == 0:
            for rec in recs[:5]:
                rec.mark_first(end)
    for i, rec in enumerate(recs):
        led.finalize_record(rec, now=end + 0.01 * i,
                            outcome='failed' if i == 6 else None,
                            tokens=i)
    led.finalize_record(recs[0], now=end + 5.0)   # closed once only
    return led.report(), led.report(top=1), [r.summary(segments=True)
                                             for r in recs]


def test_request_ledger_report_matches(monkeypatch):
    j = _request_books(jreq, jevents, monkeypatch)
    p = _request_books(preq, pevents, monkeypatch)
    assert json.dumps(p, sort_keys=True) == json.dumps(j, sort_keys=True)
    rep = p[0]
    assert rep['closure']['finished'] == 7
    assert rep['closure']['slow_requests'] >= 1
    assert {'adapter_pinned', 'pool_exhausted'} <= set(rep['blocked_totals'])
    assert len(p[1]['slowest']) == 1
    assert preq.PHASES == jreq.PHASES
    assert preq.BLOCKED_REASONS == jreq.BLOCKED_REASONS


# ---------------------------------------------------------------------------
# the event schema
# ---------------------------------------------------------------------------

def _schema_literal(path):
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.AnnAssign) and \
                getattr(node.target, 'id', None) == 'EVENT_SCHEMA':
            return ast.literal_eval(node.value)
    raise AssertionError(f'no EVENT_SCHEMA in {path}')


def test_event_schema_equal():
    jlit = _schema_literal(ROOT / 'paddle_tpu/observability/events.py')
    plit = _schema_literal(ROOT / 'paddle_tpu_torch/observability/events.py')
    assert plit == jlit
    # the runtime schemas hold the literal (JAX tests may declare more)
    assert set(jlit) <= set(jevents.EVENT_SCHEMA)
    assert set(plit) <= set(pevents.EVENT_SCHEMA)
    for name, help_ in plit.items():
        assert pevents.EVENT_SCHEMA[name] == help_


# ---------------------------------------------------------------------------
# observability off: the hot-path hooks make no registry call
# ---------------------------------------------------------------------------

def _hot_path_ops(obs, retry_mod):
    obs.emit('prefix_hit', request_id=1)
    with obs.span('serving.decode_round', slots=2):
        pass
    obs.Span('serving.queue', request_id=1).begin().end()
    obs.count_suppressed('flight.dump')
    retry_mod._note_retry('checkpoint_save', 0, OSError('x'), 0.0)
    policy = retry_mod.RetryPolicy(max_retries=2, base_delay=0.0,
                                   jitter=0.0)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise ConnectionError('transient')
        return 7
    assert retry_mod.call_with_retry(flaky, policy=policy,
                                     site='t') == 7


@pytest.mark.parametrize('pkg', ['jax', 'torch'])
def test_disabled_observability_makes_no_registry_calls(pkg, monkeypatch):
    obs = PACKAGES[pkg][0]
    retry_mod = jretry if pkg == 'jax' else pretry
    reg = obs.get_registry()
    calls = []
    for meth in ('counter', 'gauge', 'histogram', '_family'):
        orig = getattr(reg, meth)
        monkeypatch.setattr(
            reg, meth, lambda *a, _m=meth, _o=orig, **kw:
            calls.append(_m) or _o(*a, **kw))
    before = len(obs.get_event_log())
    obs.disable()
    try:
        assert not obs.enabled()
        _hot_path_ops(obs, retry_mod)
    finally:
        obs.enable()
    assert calls == []
    assert len(obs.get_event_log()) == before
    _hot_path_ops(obs, retry_mod)      # and on, they do
    assert calls


def test_disabled_flag_is_the_same_flag():
    import paddle_tpu.flags as jflags
    import paddle_tpu_torch.flags as pflags
    for flags, obs in ((jflags, jobs), (pflags, pobs)):
        assert flags.get_flags('FLAGS_observability') == {
            'FLAGS_observability': True}
        obs.disable()
        assert flags.flag('FLAGS_observability') is False
        obs.enable()
        assert flags.flag('FLAGS_observability') is True
        assert flags.flag('FLAGS_concurrency_sanitizer') in (
            'off', 'report', 'strict')


# ---------------------------------------------------------------------------
# the concurrency sanitizer
# ---------------------------------------------------------------------------

def _abba(conc, mode):
    conc.reset()
    with conc.sanitized(mode):
        a, b = conc.Lock('Test.a'), conc.Lock('Test.b')
        with a:
            with b:
                pass
        raised = None
        try:
            with b:
                with a:
                    pass
        except conc.ConcurrencySanitizerError as exc:
            raised = exc.kind
        found = conc.violations(conc.KIND_LOCK_ORDER)
        stats = conc.stats()
        rl = conc.RLock('Test.r')
        with rl:
            with rl:             # re-entrant: no report
                pass
        c = conc.Lock('Test.c')
        reentry = None
        with c:
            try:
                c.acquire()
            except conc.ConcurrencySanitizerError as exc:
                reentry = exc.kind
    conc.reset()
    return ([(v['kind'], v['cycle']) for v in found], raised,
            stats['violations'], stats['edges'], reentry)


@pytest.mark.parametrize('mode', ['report', 'strict'])
def test_abba_lock_pair_reports_a_cycle_in_both(mode):
    j = _abba(jconc, mode)
    p = _abba(pconc, mode)
    assert p == j
    found, raised, by_kind, edges, reentry = p
    assert found == [('lock_order_cycle', ['Test.a', 'Test.b'])]
    assert raised == ('lock_order_cycle' if mode == 'strict' else None)
    assert by_kind['lock_order_cycle'] == 1 and edges == 2
    assert reentry == 'reentry'
    assert pconc.mode() == jconc.mode() == 'off'


def test_sanitizer_report_reaches_metrics_and_events():
    for obs, conc in ((jobs, jconc), (pobs, pconc)):
        conc.reset()
        before = obs.get_registry().value(
            'paddle_sanitizer_violations_total', kind='lock_order_cycle')
        _abba(conc, 'report')
        assert obs.get_registry().value(
            'paddle_sanitizer_violations_total',
            kind='lock_order_cycle') == before + 1
        assert any(e['name'] == 'sanitizer_violation'
                   for e in obs.get_event_log().events())


def _edges_artifact(conc, path):
    conc.reset()
    with conc.sanitized('report'):
        a, b, c = (conc.Lock('Edge.a'), conc.Lock('Edge.b'),
                   conc.Lock('Edge.c'))
        with a:
            with b:
                with c:
                    pass
    out = conc.export_edges(str(path))
    conc.reset()
    return out


@pytest.mark.parametrize('writer', ['torch', 'jax'])
def test_edges_artifact_crosses_both_ways(writer, tmp_path):
    """An edges artifact one package writes is read by the other's
    `load_edges`, with the same edges; malformed input raises the same
    errors in both."""
    src, dst = (pconc, jconc) if writer == 'torch' else (jconc, pconc)
    path = _edges_artifact(src, tmp_path / 'edges.json')
    with open(path) as f:
        doc = json.load(f)
    assert doc['version'] == 1
    got = dst.load_edges(path)
    assert got == src.load_edges(path)
    assert sorted((e['from'], e['to']) for e in got) == [
        ('Edge.a', 'Edge.b'), ('Edge.a', 'Edge.c'), ('Edge.b', 'Edge.c')]
    assert all(set(e) == {'from', 'to', 'thread', 'stack'} for e in got)
    for bad, msg in (({'version': 1}, 'missing "edges" list'),
                     ({'edges': [{'from': 'x'}]}, 'malformed edge entry')):
        p = tmp_path / 'bad.json'
        p.write_text(json.dumps(bad))
        for conc in (pconc, jconc):
            with pytest.raises(ValueError, match=msg):
                conc.load_edges(str(p))


def test_lock_names_match():
    """Every observability lock of the port is allocated under the JAX
    package's name."""
    names = {}
    for k, (obs, metrics_mod, events_mod, req_mod, conc) in \
            PACKAGES.items():
        names[k] = sorted({
            metrics_mod.MetricsRegistry()._lock.name,
            metrics_mod.SlidingWindow()._lock.name,
            events_mod.EventLog()._lock.name,
            obs.GoodputLedger()._lock.name,
            req_mod.RequestLedger()._lock.name,
            obs.FlightRecorder()._lock.name,
            obs.server._live_lock.name})
    assert names['torch'] == names['jax']


def test_observability_imports_no_jax_and_no_reference_package():
    import subprocess
    import sys
    code = ('import sys\n'
            'import paddle_tpu_torch.observability, paddle_tpu_torch.debug\n'
            'import paddle_tpu_torch.analysis.runtime\n'
            'bad = sorted(m for m in sys.modules if m in ("jax", "jaxlib") '
            'or m.startswith(("jax.", "jaxlib.")) or m == "paddle_tpu" '
            'or m.startswith("paddle_tpu."))\n'
            'print(bad)\n'
            'sys.exit(1 if bad else 0)\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
