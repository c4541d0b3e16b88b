"""The port's serving engine under observability against the JAX paged
engine's, on the CPU, over the tiny GQA Llama carried across by
`from_jax_state`.

- For each trace (greedy with a seeded sampling request under page
  pressure; the prefix cache with chunks and a full hit with its COW
  split; int8 KV; a bank of two adapters, then a capacity-1 store bank
  that requeues; a draft model with k = 2; `begin_drain` / `drain`), the
  JAX engine and the port's run it from a clean slate and must leave:
  every non-time `paddle_*` counter and gauge equal, histogram counts
  equal (the occupancy histogram's buckets too), the ordered events and
  spans equal in name, nesting and non-time fields (request ids mapped
  to submission order), each request-ledger record with the same phase
  keys and the same number of rounds, and both ledgers closed within 1%
  (every finished request's waterfall against its E2E, the fair-share
  decode book against the engine decode wall, the goodput categories
  plus residual against the wall) in both packages. The program
  catalog's families mirror a process-wide catalog (and its FLOPs and
  bytes are XLA's in the JAX package, an analytic count in the port):
  they are compared as each program's invocations during the trace.
- With observability off the port's engine changes no metric and logs
  no event.
- The port's HTTP server beside a live engine on 127.0.0.1:0: `/metrics`
  parses line by line under the exposition format, its serving counters
  and `/summary?format=json`'s serving section equal `stats()`,
  `/healthz` goes 200 -> 503 `draining` -> 200, `/goodput`,
  `/requests`, `/trace` answer, `/programs` and `/slo` answer 200 with
  bodies of the JAX server's shape (the same programs with the same
  invocations, the same SLO report), `/fleet/metrics` and `/fleet/trace`
  answer 503 with the JAX server's body while no fleet aggregator is
  registered.
- A failed admission writes one flight bundle with its files, under a
  temp directory.
- Lint: every `emit('...')` literal in `paddle_tpu_torch/` is declared
  in the port's `EVENT_SCHEMA`, and every `paddle_*` family the port
  registers is registered by the JAX package under the same type, labels
  and HELP text.
"""
import ast
import importlib.util
import json
import os
import pathlib
import re
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import observability as jobs
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.observability import reqledger as jreq
from paddle_tpu.serving import AdapterBank as JaxBank
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu.serving import make_adapter_factors as jax_factors
from paddle_tpu_torch import observability as pobs
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import reqledger as preq
from paddle_tpu_torch.serving import (FAILED, FINISHED, AdapterBank,
                                      InferenceEngine, SamplingParams,
                                      make_adapter_factors)
from paddle_tpu_torch.weights import from_jax_state
from test_torch_observability import (isolated_observability,
                                      reset_observability)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the smoke's strict exposition parser (chip_smoke.py imports no jax and
# runs nothing at import)
_spec = importlib.util.spec_from_file_location('chip_smoke',
                                               ROOT / 'chip_smoke.py')
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)
parse_exposition = smoke.parse_exposition
NO_EOS = -1
TARGETS = ('q_proj', 'k_proj', 'v_proj', 'o_proj')


_reset = reset_observability


@pytest.fixture(autouse=True, scope='module')
def _isolated(tmp_path_factory):
    yield from isolated_observability(tmp_path_factory)


def _pair(seed, **cfg):
    paddle.seed(seed)
    jm = jllama.LlamaForCausalLM(
        jllama.LlamaConfig.tiny(num_key_value_heads=2, **cfg)).eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = from_jax_state(state, LlamaForCausalLM(
        LlamaConfig.tiny(num_key_value_heads=2, **cfg), device='cpu'))
    return jm, tm


@pytest.fixture(scope='module')
def models():
    """(JAX target, port target, JAX draft, port draft)."""
    return _pair(11) + _pair(99, num_hidden_layers=1)


def _kits(models, tmp_path):
    jm, tm, jd, td = models
    return {
        'jax': types.SimpleNamespace(
            name='jax', obs=jobs, req=jreq, Engine=JaxEngine,
            Params=JaxParams, Bank=JaxBank, factors=jax_factors, model=jm,
            draft=jd, store=str(tmp_path / 'jax_store')),
        'torch': types.SimpleNamespace(
            name='torch', obs=pobs, req=preq, Engine=InferenceEngine,
            Params=SamplingParams, Bank=AdapterBank,
            factors=make_adapter_factors, model=tm, draft=td,
            store=str(tmp_path / 'torch_store')),
    }


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, (s,)).tolist() for s in lens]


def _engine(kit, **kw):
    kw = {'num_slots': 3, 'max_length': 64, 'decode_block': 2,
          'kv_page_size': 16, **kw}
    return kit.Engine(kit.model, **kw)


def _sp(kit, n=6, **kw):
    return kit.Params(max_new_tokens=n, eos_token_id=NO_EOS, **kw)


# ---------------------------------------------------------------------------
# the traces: each drives one package's engine(s); returns the handles in
# submission order
# ---------------------------------------------------------------------------

def _trace_greedy_sampling(kit):
    """Greedy and one seeded sampling request, under page pressure (eight
    usable pages: the third 3-page reservation requeues)."""
    eng = _engine(kit, kv_pages=9)
    prompts = _prompts([40, 30, 35, 8, 12], seed=1)
    params = [_sp(kit) for _ in prompts]
    params[3] = _sp(kit, strategy='sampling', temperature=0.8, top_p=0.9,
                    seed=7)
    hs = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    eng.run()
    return hs


def _trace_prefix_chunks(kit):
    """A system prompt seeded by a first wave and hit by a second (suffix
    chunks, a cold prompt in chunks), then a 32-token prompt served twice:
    a full hit with its COW split."""
    eng = _engine(kit, max_length=96, prefix_cache=0.5,
                  prefill_chunk_tokens=16)
    rng = np.random.RandomState(0)
    sysp = rng.randint(1, 128, (20,)).tolist()
    wave = [sysp + rng.randint(1, 128, (n,)).tolist() for n in (3, 12, 30)]
    wave.append(rng.randint(1, 128, (50,)).tolist())
    full = rng.randint(1, 128, (32,)).tolist()
    hs = []
    for w in ([wave[0]], wave, [full], [full]):
        hs += eng.generate_many(w, _sp(kit))
    return hs


def _trace_int8(kit):
    eng = _engine(kit, kv_quant='int8')
    return eng.generate_many(_prompts([9, 17, 5, 23], seed=2), _sp(kit))


def _trace_adapters(kit):
    """A bank of two loaded adapters under a mixed wave, then a
    capacity-1 store-backed bank with two adapters in flight: the second
    pin finds the slot pinned and its request requeues (adapter_pinned)."""
    bank = kit.Bank(kit.model, capacity=3, rank=4, targets=TARGETS)
    for i in range(2):
        bank.load(f'ad{i}', kit.factors(bank, seed=1 + i, scale=0.2),
                  version=1)
    eng = _engine(kit, adapter_bank=bank)
    hs = eng.generate_many(_prompts([5, 7, 6, 9], seed=3), _sp(kit),
                           adapter_ids=['ad0', None, 'ad1', 'ad0'])
    small = kit.Bank(kit.model, capacity=1, rank=4, targets=TARGETS,
                     store_dir=kit.store)
    for i in range(2):
        small.publish(f'st{i}', kit.factors(small, seed=5 + i, scale=0.2))
    eng2 = _engine(kit, adapter_bank=small)
    hs += eng2.generate_many(_prompts([6, 8, 5], seed=4), _sp(kit),
                             adapter_ids=['st0', 'st1', None])
    return hs


def _trace_spec(kit):
    eng = _engine(kit, draft_model=kit.draft, num_draft_tokens=2)
    return eng.generate_many(_prompts([7, 12, 5], seed=5), _sp(kit))


def _trace_drain(kit):
    """Requests queued and in flight when the drain begins: a late submit
    is refused (a rejected request), `drain()` finishes the rest."""
    eng = _engine(kit)
    hs = [eng.submit(p, _sp(kit)) for p in _prompts([6, 9, 14, 5, 8],
                                                    seed=6)]
    eng.step()
    eng.begin_drain()
    with pytest.raises(RuntimeError, match='draining'):
        eng.submit([1, 2, 3], _sp(kit))
    assert eng.drain() is True
    return hs


TRACES = {'greedy_sampling': _trace_greedy_sampling,
          'prefix_chunks': _trace_prefix_chunks, 'int8': _trace_int8,
          'adapters': _trace_adapters, 'spec': _trace_spec,
          'drain': _trace_drain}


# ---------------------------------------------------------------------------
# what one run leaves behind
# ---------------------------------------------------------------------------

def _port_vocabulary():
    """The event names the port emits (its source's `emit` literals) and
    the span names it opens."""
    events, spans = set(), set()
    for path in (ROOT / 'paddle_tpu_torch').rglob('*.py'):
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Call) and node.args and
                    isinstance(node.args[0], ast.Constant) and
                    isinstance(node.args[0].value, str)):
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, 'id', None)
            if name == 'emit':
                events.add(node.args[0].value)
            elif name in ('span', 'Span'):
                spans.add(node.args[0].value)
    return events, spans


PORT_EVENTS, PORT_SPANS = _port_vocabulary()
# JAX-only events and spans a JAX engine may log: its program store and
# compiles, which the port has no counterpart of (it captures CUDA
# graphs, counted in stats()['traces'])
JAX_ONLY = re.compile(r'^(program_|jit\.|donation_)')
# the program catalog's scrape-time mirror (observability/cost.py)
CATALOG_FAMILIES = frozenset((
    'paddle_program_invocations_total', 'paddle_program_host_seconds_total',
    'paddle_program_compile_seconds_total', 'paddle_program_flops',
    'paddle_program_bytes_accessed', 'paddle_program_peak_memory_bytes',
    'paddle_program_mfu', 'paddle_roofline_bound', 'paddle_mfu'))
_TIME_KEYS = {'ts', 'dur', 'tid', 'seq', 'seconds', 'delay_s'}


def _events(obs, ids, base):
    """The ordered events and spans of the port's vocabulary, time fields
    removed, request ids mapped to submission order, depths counted from
    `base` (a span begun and never ended before the run, such as the
    queue span of a request failed while queued, stays open on the
    thread); and the names of the events left out."""
    kept, other = [], set()
    for e in obs.get_event_log().events():
        if e['name'] not in PORT_EVENTS | PORT_SPANS:
            other.add(e['name'])
            continue
        out = {k: v for k, v in e.items() if k not in _TIME_KEYS | {'attrs'}}
        if 'depth' in out:
            out['depth'] -= base
        attrs = {k: v for k, v in (e.get('attrs') or {}).items()
                 if k not in _TIME_KEYS}
        if 'request_id' in attrs:
            attrs['request_id'] = ids.get(attrs['request_id'], 'unknown')
        if 'requests' in attrs:
            attrs['requests'] = [ids.get(r, 'unknown')
                                 for r in attrs['requests']]
        out['attrs'] = attrs
        kept.append(out)
    return kept, other


def _metrics(obs, names):
    """{(family, labels): value} of every non-zero sample of `names`:
    counters and gauges exactly, histograms by count (the occupancy
    histogram, whose values are not times, by its buckets too); a family
    of seconds or fractions that is not a histogram is left out."""
    out = {}
    for m in obs.get_registry().snapshot()['metrics']:
        name = m['name']
        if name not in names:
            continue
        timed = 'seconds' in name or 'fraction' in name
        if m['type'] != 'histogram' and timed:
            continue
        for s in m['samples']:
            key = (name, tuple(sorted(s['labels'].items())))
            if m['type'] == 'histogram':
                if s['count']:
                    out[key] = (s['count'],) if timed else (
                        s['count'], tuple(s['buckets'].items()))
            elif s['value']:
                out[key] = s['value']
    return out


class _Rounds:
    """Counts each record's decode/speculation rounds (the request
    ledger's `note_round` participants)."""

    def __init__(self, req_mod, monkeypatch):
        self.by_rec = {}
        orig = req_mod.RequestLedger.note_round

        def note_round(led, dur, records, *a, **kw):
            for r in records:
                if r is not None:
                    self.by_rec[id(r)] = self.by_rec.get(id(r), 0) + 1
            return orig(led, dur, records, *a, **kw)
        monkeypatch.setattr(req_mod.RequestLedger, 'note_round',
                            note_round)


def _assert_closed(summary, frac=0.01):
    e2e = summary['e2e_s']
    gap = summary['residual_s'] + summary['overcount_s']
    assert gap <= frac * e2e + 1e-6, summary
    if summary['ttft_s'] is not None:
        tgap = summary['ttft_residual_s'] + summary['ttft_overcount_s']
        assert tgap <= frac * summary['ttft_s'] + 1e-6, summary


def _run(kit, trace, monkeypatch):
    """Run `trace` on one package from a clean slate; returns what the
    comparison reads, after checking that both ledgers close."""
    _reset(kit.obs)
    rounds = _Rounds(kit.req, monkeypatch)
    base = kit.obs.events._span_state.depth
    calls0 = _program_calls(kit.obs)
    hs = trace(kit)
    calls = {name: n - calls0.get(name, 0)
             for name, n in _program_calls(kit.obs).items()
             if n != calls0.get(name, 0)}
    ids = {h.request_id: i for i, h in enumerate(hs)}
    events, other = _events(kit.obs, ids, base)
    led = kit.obs.get_request_ledger()
    records = []
    for h in hs:
        rec = h._ledger_rec
        assert rec is not None and rec.t_done is not None, h
        s = rec.summary()
        if h.status == FINISHED:
            _assert_closed(s)
        records.append((h.status, sorted(s['phases']),
                        rounds.by_rec.get(id(rec), 0), s['tokens'],
                        sorted(s['blocked'])))
    closure = led.report()['closure']
    wall = closure['engine_decode_wall_s']
    assert wall > 0
    assert abs(closure['decode_fair_s'] - wall) <= 0.01 * wall + 1e-6
    gp = kit.obs.get_ledger().report()
    assert abs(sum(gp['categories'].values()) + gp['residual_seconds']
               - gp['wall_seconds']) <= 0.01 * gp['wall_seconds']
    assert gp['overcount_seconds'] == 0.0
    assert gp['categories']['serving_decode'] > 0
    names = {m['name'] for m in kit.obs.get_registry().snapshot()['metrics']
             if m['name'].startswith('paddle_')
             and m['name'] not in CATALOG_FAMILIES}
    return types.SimpleNamespace(
        events=events, other=other, records=records, closure=closure,
        tokens=[len(h.tokens) for h in hs], handles=hs,
        finished=closure['finished'], names=names,
        metrics=_metrics(kit.obs, names), programs=calls)


def _program_calls(obs):
    """{program: invocations} of the package's program catalog."""
    return {r.name: r.invocations for r in obs.program_catalog().records()}


@pytest.mark.parametrize('trace', sorted(TRACES))
def test_engine_observability_equals_jax(models, tmp_path, monkeypatch,
                                         trace):
    kits = _kits(models, tmp_path)
    # the JAX engine compiles its programs at their first use, and its
    # compile seconds (fed to the goodput ledger beside the prefill and
    # decode spans that hold them) would overcount the wall: a warm-up
    # run of the trace (stores of its own) compiles them first
    TRACES[trace](_kits(models, tmp_path / 'warm')['jax'])
    j = _run(kits['jax'], TRACES[trace], monkeypatch)
    p = _run(kits['torch'], TRACES[trace], monkeypatch)
    # the families the port registers (the JAX registry also holds its
    # program store's and compiles')
    pm = p.metrics
    jm = {k: v for k, v in j.metrics.items() if k[0] in p.names}
    assert pm == jm
    assert p.programs == j.programs and p.programs
    assert p.events == j.events
    assert p.records == j.records
    assert p.tokens == j.tokens
    assert p.finished == j.finished == len(p.handles)
    assert not p.other, p.other
    assert all(JAX_ONLY.match(n) for n in j.other), j.other
    # what each trace must have exercised
    seen = {e['name'] for e in p.events}
    assert {'serving.queue', 'serving.decode_round' if trace != 'spec'
            else 'serving.spec_round'} <= seen
    want = {'greedy_sampling': {'page_pool_exhausted', 'serving.prefill'},
            'prefix_chunks': {'prefix_hit', 'paged_cow',
                              'serving.prefill_chunk'},
            'int8': {'serving.prefill'},
            'adapters': {'adapter_load', 'adapter_publish',
                         'adapter_bank_saturated', 'weight_publish',
                         'checkpoint_save'},
            'spec': {'serving.draft_prefill'},
            'drain': {'serving_drain_begin', 'serving.drain',
                      'serving_drain_complete'}}[trace]
    assert want <= seen, want - seen
    if trace == 'greedy_sampling':
        assert any('pool_exhausted' in r[4] for r in p.records)
    if trace == 'adapters':
        assert any('adapter_pinned' in r[4] for r in p.records)
    if trace == 'drain':
        assert pm[('paddle_serving_requests_total',
                   (('status', 'rejected'),))] == 1
        assert set(pobs.degraded_states('*')) == {'draining'}
        pobs.clear_degraded('draining')
        jobs.clear_degraded('draining')


def test_disabled_observability_changes_nothing(models, tmp_path):
    kit = _kits(models, tmp_path)['torch']
    _reset(pobs)
    eng = _engine(kit, prefix_cache=0.5, prefill_chunk_tokens=16)
    names = {m['name'] for m in pobs.get_registry().snapshot()['metrics']}
    before = _metrics(pobs, names)
    pobs.disable()
    preq.get_ledger().disable()
    try:
        hs = eng.generate_many(_prompts([20, 40, 9], seed=8), _sp(kit))
    finally:
        pobs.enable()
        preq.get_ledger().enable()
    assert all(h.status == FINISHED and h._ledger_rec is None for h in hs)
    # the goodput ledger's wall still moves (it mirrors the clock)
    assert _metrics(pobs, names) == before
    assert len(pobs.get_event_log()) == 0
    assert pobs.get_ledger().report()['attributed_seconds'] == 0.0
    assert eng.stats()['completed'] == 3


# ---------------------------------------------------------------------------
# the HTTP server beside a live engine
# ---------------------------------------------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_server_beside_a_live_engine(models, tmp_path):
    kits = _kits(models, tmp_path)
    kit = kits['torch']
    _reset(pobs)
    _reset(jobs)
    srv = pobs.start_server(0, host='127.0.0.1')
    jsrv = jobs.start_server(0, host='127.0.0.1')
    try:
        assert srv.url.startswith('http://127.0.0.1:')
        calls0 = {'torch': _program_calls(pobs), 'jax': _program_calls(jobs)}
        for k in (kits['jax'], kit):    # the port's engine stays `eng`
            eng = _engine(k, prefix_cache=0.5, prefill_chunk_tokens=16)
            eng.generate_many(_prompts([20, 40, 9, 33], seed=9), _sp(k))
        # /programs: the programs this trace ran, with the same
        # invocations, in both servers' bodies
        ran = {}
        for name, server in (('torch', srv), ('jax', jsrv)):
            status, body = _get(f'{server.url}/programs?format=json')
            assert status == 200
            rows = {r['name']: r for r in json.loads(body)['programs']}
            ran[name] = {n: r['invocations'] - calls0[name].get(n, 0)
                         for n, r in rows.items()
                         if r['invocations'] != calls0[name].get(n, 0)}
            assert {'mfu', 'roofline_bound', 'arithmetic_intensity',
                    'flops', 'bytes_accessed', 'peak_memory_bytes',
                    'compile_count', 'kind'} <= set(next(iter(
                        rows.values())))
            status, body = _get(f'{server.url}/programs')
            assert status == 200 and body.startswith('program catalog:')
        assert ran['torch'] == ran['jax'] and \
            'serving.paged_decode_block' in ran['torch']
        st = eng.stats()
        status, body = _get(f'{srv.url}/metrics')
        assert status == 200
        m = parse_exposition(body)
        proc = 'process="0"'
        assert m[f'paddle_serving_tokens_total{{{proc}}}'] == st['tokens']
        assert m[f'paddle_serving_decode_rounds_total{{{proc}}}'] == \
            st['decode_rounds']
        assert m[f'paddle_serving_decode_steps_total{{{proc}}}'] == \
            st['decode_steps']
        assert m[f'paddle_serving_chunk_rounds_total{{{proc}}}'] == \
            st['chunk_rounds']
        assert m[f'paddle_serving_requests_total{{{proc},'
                 f'status="completed"}}'] == st['completed']
        assert sum(v for k, v in m.items() if k.startswith(
            'paddle_serving_prefills_total{')) == st['prefills']
        status, body = _get(f'{srv.url}/summary?format=json')
        sv = json.loads(body)['serving']
        assert (sv['submitted'], sv['completed'], sv['failed'],
                sv['tokens'], sv['prefills'], sv['decode_steps'],
                sv['queue_depth'], sv['active_slots'],
                sv['chunk']['rounds'], sv['prefix']['hits']) == (
            st['submitted'], st['completed'], st['failed'], st['tokens'],
            st['prefills'], st['decode_steps'], st['queue_depth'],
            st['active_slots'], st['chunk_rounds'],
            st['prefix_cache']['hits'])
        assert 'serving:' in _get(f'{srv.url}/summary')[1]
        status, body = _get(f'{srv.url}/healthz')
        assert status == 200 and json.loads(body)['status'] == 'ok'
        eng.submit(_prompts([7], seed=10)[0], _sp(kit))
        eng.begin_drain()
        status, body = _get(f'{srv.url}/healthz')
        assert status == 503 and json.loads(body)['status'] == 'draining'
        assert eng.drain() is True
        assert _get(f'{srv.url}/healthz')[0] == 503
        pobs.clear_degraded('draining')
        status, body = _get(f'{srv.url}/healthz')
        assert status == 200
        assert 'decode' in json.loads(body)['seconds_since_progress']
        gp = json.loads(_get(f'{srv.url}/goodput?format=json')[1])
        assert gp['goodput']['categories']['serving_decode'] > 0
        rq = json.loads(_get(f'{srv.url}/requests?top=2')[1])
        assert rq['closure']['finished'] == 5 and len(rq['slowest']) == 2
        trace = json.loads(_get(f'{srv.url}/trace')[1])
        assert any(e['name'] == 'serving.decode_round'
                   for e in trace['traceEvents'])
        # /slo: 503 with no engine registered, then the same report
        for obs_mod, server in ((pobs, srv), (jobs, jsrv)):
            assert _get(f'{server.url}/slo')[0] == 503
        bodies = []
        for obs_mod, server in ((pobs, srv), (jobs, jsrv)):
            obs_mod.set_slo_engine(obs_mod.SLOEngine(
                obs_mod.default_objectives(0.5), clock=lambda: 100.0,
                flight=False))
            try:
                status, body = _get(f'{server.url}/slo?poll=1')
            finally:
                obs_mod.set_slo_engine(None)
            assert status == 200
            bodies.append(json.loads(body))
        assert bodies[0] == bodies[1]
        assert [o['name'] for o in bodies[0]['objectives']] == [
            'ttft_p99', 'availability', 'shed_rate']
        for route in ('/fleet/metrics', '/fleet/trace'):
            status, body = _get(srv.url + route)
            assert (status, body) == _get(jsrv.url + route), route
            assert status == 503 and 'set_aggregator' in body, route
        assert _get(f'{srv.url}/nope')[0] == 404
    finally:
        srv.stop()
        jsrv.stop()


def test_failed_admission_writes_one_flight_bundle(models, tmp_path,
                                                   monkeypatch):
    kit = _kits(models, tmp_path)['torch']
    _reset(pobs)
    rec = pobs.get_flight_recorder()
    monkeypatch.setattr(rec, '_dump_dir', None)
    monkeypatch.setenv('PADDLE_FLIGHT_DIR', str(tmp_path / 'flight'))
    monkeypatch.setattr(rec, '_last_dump_t', None)
    eng = _engine(kit)

    def broken(slot, h):
        raise ValueError('admission refused')
    good = eng.submit(_prompts([6], seed=11)[0], _sp(kit))
    bad = eng.submit(_prompts([9], seed=12)[0], _sp(kit))
    orig = eng._begin_request
    monkeypatch.setattr(eng, '_begin_request', lambda slot, h: (
        broken(slot, h) if h is bad else orig(slot, h)))
    eng.run()
    assert good.status == FINISHED and bad.status == FAILED
    bundles = sorted(os.listdir(tmp_path / 'flight'))
    assert len(bundles) == 1 and bundles[0].endswith(
        'serving_request_failed')
    path = tmp_path / 'flight' / bundles[0]
    assert {'flight.json', 'events.jsonl', 'trace.json', 'metrics.json',
            'summary.txt', 'goodput.json',
            'requests.json'} <= set(os.listdir(path))
    doc = json.loads((path / 'flight.json').read_text())
    assert doc['reason'] == 'serving_request_failed'
    assert doc['trigger']['attrs']['error'] == 'ValueError'
    assert pobs.get_registry().value('paddle_flight_dumps_total',
                                     reason='serving_request_failed') == 1


def test_failed_admission_leaves_its_queue_span_open_like_jax(
        models, tmp_path, monkeypatch):
    """The reference's `_admit` fails a request whose seating raised
    without ending its `serving.queue` span, so the span never records
    and the thread's span depth stays one higher (ROADMAP.md, Queue 3);
    the port does the same, and its spans' depths and events stay equal
    to the JAX engine's."""
    depths = {}
    for name, kit in _kits(models, tmp_path).items():
        _reset(kit.obs)
        eng = _engine(kit)
        orig = eng._begin_request
        before = kit.obs.events._span_state.depth
        bad = eng.submit(_prompts([9], seed=12)[0], _sp(kit))
        monkeypatch.setattr(eng, '_begin_request', lambda slot, h: (
            _raise(ValueError('admission refused')) if h is bad
            else orig(slot, h)))
        eng.run()
        assert bad.done and bad.error is not None
        names = [e['name'] for e in kit.obs.get_event_log().events()]
        depths[name] = (kit.obs.events._span_state.depth - before, names)
        kit.obs.events._span_state.depth = before
    assert depths['torch'] == depths['jax']
    assert depths['torch'] == (1, ['serving_request_failed'])


def _raise(exc):
    raise exc


# ---------------------------------------------------------------------------
# lint: the port's events are declared, its families are the JAX ones
# ---------------------------------------------------------------------------

def test_every_emitted_event_is_declared():
    from paddle_tpu_torch.observability.events import EVENT_SCHEMA
    missing = sorted(PORT_EVENTS - set(EVENT_SCHEMA))
    assert not missing, missing
    assert {'serving_request_failed', 'prefix_hit', 'paged_cow',
            'adapter_load', 'weight_publish', 'checkpoint_corrupt',
            'retry', 'preemption_signal'} <= PORT_EVENTS


def _families(tree_root):
    """{name: {(type, help, labels)}} of every registry.counter/gauge/
    histogram('paddle_...', help, labels) call with literal arguments."""
    out = {}
    for path in sorted(tree_root.rglob('*.py')):
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Call) and
                    isinstance(node.func, ast.Attribute) and
                    node.func.attr in ('counter', 'gauge', 'histogram')
                    and node.args and isinstance(node.args[0], ast.Constant)
                    and str(node.args[0].value).startswith('paddle_')):
                continue
            args = list(node.args) + [kw.value for kw in node.keywords
                                      if kw.arg in ('help', 'labelnames')]
            try:
                vals = [ast.literal_eval(a) for a in args[:3]]
            except ValueError:
                continue
            name = vals[0]
            help_ = vals[1] if len(vals) > 1 else ''
            labels = tuple(vals[2]) if len(vals) > 2 else ()
            out.setdefault(name, set()).add(
                (node.func.attr, help_, labels))
    return out


PORT_FAMILIES = _families(ROOT / 'paddle_tpu_torch')
JAX_FAMILIES = _families(ROOT / 'paddle_tpu')


@pytest.mark.parametrize('family', sorted(PORT_FAMILIES))
def test_family_registered_like_jax(family):
    assert PORT_FAMILIES[family] <= JAX_FAMILIES.get(family, set()), (
        family, PORT_FAMILIES[family], JAX_FAMILIES.get(family))


def test_lint_sees_the_serving_families():
    assert {'paddle_serving_requests_total', 'paddle_serving_tokens_total',
            'paddle_serving_queue_depth', 'paddle_adapter_pinned',
            'paddle_serving_prefix_hits_total', 'paddle_weight_version',
            'paddle_checkpoint_saves_total',
            'paddle_resilience_retries_total'} <= set(PORT_FAMILIES)
