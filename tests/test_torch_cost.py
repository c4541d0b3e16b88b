"""The program catalog and step telemetry (paddle_tpu_torch.observability.
cost and telemetry) against the JAX package's, on the CPU.

- The roofline arithmetic: `record_roofline`, `aggregate_mfu`,
  `MfuWindow` (on a fake clock) and `roofline_summary` give equal output
  from identical `ProgramRecord`s and peaks in both packages (exact),
  and `device_peaks` honours the same `PADDLE_PEAK_*` overrides.
- After a trace (the prefix cache with chunks; a speculating engine
  with a draft), the port engine's catalog holds exactly the JAX
  engine's program names and kinds with the same invocations.
- The decode block's analytic FLOPs equal a count written out here from
  the config; its ratio to the JAX record's XLA `cost_analysis` FLOPs is
  printed (not gated: XLA counts the padded, gathered shapes).
- `/programs` answers 200 (text and JSON), a flight bundle holds
  `programs.json`, `slo.json` and the roofline half of `goodput.json`.
- `StepTelemetry` over 3 `TrainStep`s of both packages (the tiny GQA
  Llama through `from_jax_state`, the same batches): equal step and
  token counters, the loss gauge to f32 tolerance, one jit-cache entry
  and one `train_step` program of kind `train` with 3 invocations, and
  one `train.step` span per step. The memory watermark is left out: the
  JAX package sums live arrays on the CPU, the port reads the CUDA
  allocator and reports 0 without a card.
"""
import json
import os
import types
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import observability as jobs
from paddle_tpu import programs
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.observability import cost as jcost
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu_torch import observability as pobs
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.observability import cost as pcost
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import InferenceEngine, SamplingParams
from paddle_tpu_torch.weights import from_jax_state
from test_torch_observability import (isolated_observability,
                                      reset_observability)
from test_torch_router import FakeClock, use_clock

COST = {'jax': jcost, 'torch': pcost}
NO_EOS = -1


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


# ---------------------------------------------------------------------------
# the roofline arithmetic
# ---------------------------------------------------------------------------

_RECORDS = (   # name, kind, invocations, host s, FLOPs, bytes
    ('serving.paged_decode_block', 'serving', 40, 2.5, 3.1e11, 1.4e10),
    ('serving.paged_prefill_512', 'serving', 7, 0.8, 6.9e12, 1.4e10),
    ('train_step', 'train', 3, 1.2, 4.0e13, 5.0e10),
    ('serving.paged_chunk_prefill_256', 'serving', 0, 0.0, 0.0, 0.0),
)
_PEAKS = {'device_kind': 'NVIDIA H100 80GB HBM3', 'peak_flops': 989e12,
          'peak_hbm_bytes_per_s': 3350e9, 'source': 'table'}


def _records(mod):
    out = []
    for name, kind, inv, host, flops, nbytes in _RECORDS:
        r = mod.ProgramRecord(name, kind)
        r.invocations, r.host_seconds = inv, host
        r.flops, r.bytes_accessed = flops, nbytes
        r.analyzed = flops > 0
        out.append(r)
    return out


def _arithmetic(mod, monkeypatch):
    recs = _records(mod)
    base = {'serving.paged_decode_block': 10, 'train_step': 1}
    out = [[mod.record_roofline(r, _PEAKS, 4.0, base) for r in recs],
           [mod.record_roofline(r, dict(_PEAKS, peak_flops=None), 4.0)
            for r in recs],
           mod.aggregate_mfu(recs, _PEAKS, 4.0, base),
           mod.aggregate_mfu(recs, _PEAKS, 0.0),
           [r.as_dict() for r in recs]]
    clock = FakeClock(step=2.0)
    use_clock(monkeypatch, clock, mod)
    cat = mod.ProgramCatalog()
    for r in recs:
        rec = cat.record(r.name, r.kind)
        rec.flops, rec.bytes_accessed = r.flops, r.bytes_accessed
    with mod.MfuWindow(cat, _PEAKS) as win:
        for r in recs:
            cat.note_invocation(r.name, r.host_seconds, n=r.invocations,
                                kind=r.kind)
        clock.advance()
        out.append(win.result())
    # roofline_summary reads the process catalog and the ledger window
    monkeypatch.setattr(mod, '_catalog', cat)
    monkeypatch.setattr(mod, 'device_peaks', lambda device=None: _PEAKS)
    monkeypatch.setattr(mod, '_ledger_window', lambda: (5.0, {}))
    out.append(mod.roofline_summary(max_rows=3))
    return out


def test_roofline_arithmetic_equal(monkeypatch):
    got = {name: _arithmetic(mod, monkeypatch) for name, mod in COST.items()}
    assert got['torch'] == got['jax']
    rows = got['torch'][0]
    assert rows[0]['roofline_bound'] == 'bandwidth'
    assert rows[1]['roofline_bound'] == 'compute'
    assert got['torch'][-1]['bound_counts'] == {'compute': 2,
                                                'bandwidth': 1}


@pytest.mark.parametrize('env', [
    {}, {'PADDLE_PEAK_FLOPS': '1e15'},
    {'PADDLE_PEAK_FLOPS': '2e14', 'PADDLE_PEAK_HBM_GBPS': '900'},
    {'PADDLE_PEAK_FLOPS': 'fast'}])
def test_device_peaks_overrides_match(monkeypatch, env):
    for key in ('PADDLE_PEAK_FLOPS', 'PADDLE_PEAK_HBM_GBPS'):
        monkeypatch.delenv(key, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    j, p = jcost.device_peaks(), pcost.device_peaks()
    # the JAX CPU device is kind 'cpu'; the port has no CUDA device here
    assert {k: v for k, v in p.items() if k != 'device_kind'} == \
        {k: v for k, v in j.items() if k != 'device_kind'}
    assert p['device_kind'] in ('unknown', 'env-override')
    assert pcost.PEAK_SPECS == {'h100': {'flops': 989e12,
                                         'hbm_gbps': 3350.0}}


# ---------------------------------------------------------------------------
# the engines' programs
# ---------------------------------------------------------------------------

def _calls(obs):
    return {r.name: (r.kind, r.invocations)
            for r in obs.program_catalog().records()}


def _delta(before, after):
    return {n: (k, inv - before.get(n, (k, 0))[1])
            for n, (k, inv) in after.items()
            if inv != before.get(n, (k, 0))[1]}


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, (s,)).tolist() for s in lens]


def _run_engines(jax_model, port_model, prompts, drafts=(None, None), **kw):
    """Serve `prompts` on each package's engine (with `drafts`' draft
    models); returns {package: (the programs' invocations during the run,
    the tokens)}."""
    kw = {'num_slots': 3, 'max_length': 96, 'decode_block': 2,
          'kv_page_size': 16, **kw}
    out = {}
    for name, obs, Engine, Params, model, draft in (
            ('jax', jobs, JaxEngine, JaxParams, jax_model, drafts[0]),
            ('torch', pobs, InferenceEngine, SamplingParams, port_model,
             drafts[1])):
        before = _calls(obs)
        eng = Engine(model, **kw) if draft is None else \
            Engine(model, draft_model=draft, **kw)
        hs = eng.generate_many(prompts, Params(max_new_tokens=5,
                                               eos_token_id=NO_EOS))
        out[name] = (_delta(before, _calls(obs)), [h.tokens for h in hs])
    return out


def test_engine_programs_match_jax(models):
    jm, tm, jd, td = models
    reset_observability(pobs)
    reset_observability(jobs)
    got = _run_engines(jm, tm, _prompts([20, 40, 9, 60, 33], seed=1),
                       prefix_cache=0.5, prefill_chunk_tokens=16)
    assert got['torch'] == got['jax']
    names = set(got['torch'][0])
    assert {'serving.paged_decode_block',
            'serving.paged_chunk_prefill_16'} <= names
    assert any(n.startswith('serving.paged_prefill_') for n in names)
    assert {k for k, _ in got['torch'][0].values()} == {'serving'}
    spec = _run_engines(jm, tm, _prompts([7, 12, 5], seed=5),
                        drafts=(jd, td), num_draft_tokens=2)
    assert spec['torch'] == spec['jax']
    assert {'serving.paged_spec_decode_k2', 'serving.draft_prefill_8'} <= \
        set(spec['torch'][0])


def test_decode_block_flops_from_the_config(models, capsys):
    jm, tm, _, _ = models
    cfg = tm.config
    pobs.program_catalog().reset()
    got = _run_engines(jm, tm, [[5, 9, 13, 17, 21]], num_slots=2,
                       max_length=64)
    assert got['torch'] == got['jax']
    # one request: prompt 5, 5 tokens at 2 a round -> 3 rounds whose
    # pending token sits at position 4, 6, 8; every round runs both
    # slots' rows through the matmuls, the active one attends p + 1 keys
    h, hq, hk = cfg.hidden_size, cfg.num_attention_heads, \
        cfg.num_key_value_heads
    d, layers = h // hq, cfg.num_hidden_layers
    per_layer = (h * hq * d) * 2 + (h * hk * d) * 2 + 3 * h * \
        cfg.intermediate_size
    matmul = layers * per_layer + h * cfg.vocab_size
    slots, block = 2, 2
    rounds = [sum(2 * matmul * slots + 4 * hq * d * layers * (p + j + 1)
                  for j in range(block)) for p in (4, 6, 8)]
    rec = {r.name: r for r in pobs.program_catalog().records()}[
        'serving.paged_decode_block']
    assert rec.invocations == 3
    assert rec.flops == pytest.approx(sum(rounds) / 3, rel=1e-12)
    assert rec.analyzed and rec.note == 'analytic'
    kv_row = 2 * hk * d * layers * 4           # f32 K and V of a token
    weights = matmul * 4
    nbytes = [sum(weights + kv_row * ((p + j + 1) + slots)
                  for j in range(block)) for p in (4, 6, 8)]
    assert rec.bytes_accessed == pytest.approx(sum(nbytes) / 3, rel=1e-12)
    jrec = {r.name: r for r in jobs.program_catalog().records()}[
        'serving.paged_decode_block']
    with capsys.disabled():
        print(f'\n[cost] serving.paged_decode_block per round: analytic '
              f'{rec.flops:.0f} FLOPs, JAX XLA cost_analysis '
              f'{jrec.flops:.0f} FLOPs, ratio '
              f'{rec.flops / jrec.flops:.3f}; bytes analytic '
              f'{rec.bytes_accessed:.0f} vs XLA {jrec.bytes_accessed:.0f}')


def test_programs_endpoint_and_flight_bundle(models, tmp_path):
    jm, tm, _, _ = models
    reset_observability(pobs)
    _run_engines(jm, tm, _prompts([9, 14], seed=2))
    srv = pobs.start_server(0, host='127.0.0.1')
    try:
        with urllib.request.urlopen(f'{srv.url}/programs', timeout=5) as r:
            assert r.status == 200
            text = r.read().decode()
        with urllib.request.urlopen(f'{srv.url}/programs?format=json',
                                    timeout=5) as r:
            doc = json.loads(r.read().decode())
        with urllib.request.urlopen(f'{srv.url}/goodput?format=json',
                                    timeout=5) as r:
            gp = json.loads(r.read().decode())
    finally:
        srv.stop()
    assert text.startswith('program catalog:')
    assert 'serving.paged_decode_block' in text
    names = {p['name'] for p in doc['programs']}
    assert 'serving.paged_decode_block' in names
    assert set(gp) == {'goodput', 'roofline'}
    assert gp['roofline']['source'] == 'unknown'
    path = pobs.get_flight_recorder().dump(dir=str(tmp_path),
                                           reason='manual')
    files = set(os.listdir(path))
    assert {'programs.json', 'slo.json', 'goodput.json',
            'summary.txt'} <= files
    progs = json.load(open(os.path.join(path, 'programs.json')))
    assert 'serving.paged_decode_block' in {p['name']
                                            for p in progs['programs']}
    assert 'roofline' in json.load(open(os.path.join(path,
                                                     'goodput.json')))
    summary = open(os.path.join(path, 'summary.txt')).read()
    assert 'program catalog:' in summary and '  router:' in summary
    assert 'local_events_dropped' in json.load(
        open(os.path.join(path, 'slo.json')))


# ---------------------------------------------------------------------------
# step telemetry over TrainSteps
# ---------------------------------------------------------------------------

_TELEMETRY = ('paddle_steps_total', 'paddle_tokens_total',
              'paddle_jit_cache_entries')


def _train(kit, steps=3):
    reset_observability(kit.obs)
    # an earlier test's `debug.reset_dispatch_stats()` leaves the JAX
    # catalog's `eager:<op>` records at their old counts, which the mirror
    # below rewrites only once the op is counted again (here, mid-run), so
    # the window starts from an empty catalog
    kit.obs.program_catalog().reset()
    # the baseline after a registry snapshot, as the reading below is:
    # the JAX catalog mirrors its eager dispatch cache's per-op counts
    # (`paddle_tpu._dispatch.stats()['per_op']`, left by any earlier
    # test in the process that ran eager ops) into `eager:<op>` records
    # at every snapshot (`cost._sync_dispatch`), so a baseline read
    # before the first mirror counts them as this run's calls
    kit.obs.get_registry().snapshot()
    before = _calls(kit.obs)
    tel = kit.obs.StepTelemetry()
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(steps):
        ids = rng.randint(0, 128, (2, 24))
        loss = kit.step(ids, ids)
        tel.step(loss=float(np.asarray(loss)), tokens=int(ids.size))
        losses.append(float(np.asarray(loss)))
    vals = {}     # non-zero: other tests' children survive a reset at 0
    for m in kit.obs.get_registry().snapshot()['metrics']:
        if m['name'] in _TELEMETRY:
            for s in m['samples']:
                if s['value']:
                    vals[(m['name'], tuple(sorted(
                        s['labels'].items())))] = s['value']
    spans = [e for e in kit.obs.get_event_log().events()
             if e['name'] == 'train.step']
    return types.SimpleNamespace(
        values=vals, loss_last=kit.obs.get_registry().value(
            'paddle_loss_last'), losses=losses, spans=len(spans),
        programs=_delta(before, _calls(kit.obs)),
        summary=tel.summary())


def _jax_loss(logits, labels):
    return JF.cross_entropy(logits[:, :-1].reshape([-1, 128]),
                            labels[:, 1:].reshape([-1]))


def _torch_loss(logits, labels):
    return F.cross_entropy(logits[:, :-1].reshape(-1, 128),
                           labels[:, 1:].reshape(-1))


def test_step_telemetry_over_train_steps_matches_jax():
    jm, tm = _pair(7)
    programs.get_store().clear_memory()    # the JAX step traces anew
    kits = {
        'jax': types.SimpleNamespace(obs=jobs, step=JaxTrainStep(
            jm, _jax_loss, JaxAdamW(learning_rate=1e-3,
                                    parameters=jm.parameters()))),
        'torch': types.SimpleNamespace(obs=pobs, step=TrainStep(
            tm, _torch_loss, AdamW(learning_rate=1e-3,
                                   parameters=tm.parameters()))),
    }
    got = {name: _train(kit) for name, kit in kits.items()}
    p, j = got['torch'], got['jax']
    assert p.values == j.values
    np.testing.assert_allclose(p.losses, j.losses, rtol=1e-5)
    np.testing.assert_allclose(p.loss_last, j.loss_last, rtol=1e-5)
    assert p.programs == j.programs == {'train_step': ('train', 3)}
    assert p.spans == j.spans == 3
    assert p.values[('paddle_steps_total', ())] == 3
    assert p.values[('paddle_tokens_total', ())] == 3 * 48
    assert p.values[('paddle_jit_cache_entries',
                     (('kind', 'train_step'),))] == 1
    rec = {r.name: r for r in pobs.program_catalog().records()}['train_step']
    assert rec.flops > 0 and rec.note == 'analytic'
    assert p.summary['steps'] == 3
