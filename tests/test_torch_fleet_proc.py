"""The port's process fleet with real CPU children (`--device cpu`):
`Supervisor`, `replica_main`, `RemoteReplica`, against the JAX engine.

Each child is `python -m paddle_tpu_torch.serving.replica_main` over a
factory that imports only torch and the port
(`tests/test_torch_fleet_factory.py`); its weights are the JAX tiny
GQA Llama's, carried across by `weights.from_jax_state` and published
to the port's `WeightStore`. Checked:

- parity: every child's greedy tokens equal the JAX in-process
  `InferenceEngine(kv_page_size=16)`'s, exactly; a seeded sampling
  request gets the port's in-process engine's tokens (its generator is
  the request's, not the process's); the children's parameter digest is
  the in-process model's, and no child maps `jax` (neither in
  `sys.modules`, checked by the factory, nor a jaxlib library in
  `/proc/<pid>/maps`);
- SIGKILL mid-decode under a Router loses 0 requests, the failed-over
  tokens equal the undisturbed run's, and the victim is respawned and
  serves;
- a SIGSTOPped child is killed at the heartbeat deadline and respawned;
- a fresh child's ready-marks and its serving window: nothing captured
  (nothing is, on the CPU) and no kernel source compiled;
- `swap_weights` by version, and `restore_weights`;
- the autoscaler scales up by spawning a process and down by draining
  and retiring one, with 0 dropped;
- a child without a card and without `--device cpu` exits 3, a bad
  factory spec exits 2.

The module fixture keeps its first child alive for every test that can
share it, as the JAX package's fleet test does.
"""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu_torch import observability as pobs
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import (FINISHED, SAMPLING, Autoscaler,
                                      AutoscalerConfig, InferenceEngine,
                                      Replica, ReplicaSpec, Router,
                                      SamplingParams, Supervisor,
                                      WeightStore)
from paddle_tpu_torch.serving.replica_main import EXIT_LOAD, EXIT_USAGE
from paddle_tpu_torch.weights import from_jax_state, param_digest
from test_torch_observability import isolated_observability

NO_EOS = -1
ENGINE_KW = dict(num_slots=2, max_length=64, decode_block=2,
                 kv_page_size=16)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACTORY = os.path.join(REPO, 'tests',
                       'test_torch_fleet_factory.py') + ':tiny_llama'
PROMPTS = [[5, 6, 7], [11, 12], [3, 1, 4, 1, 5], [23, 29, 31, 37],
           [2, 4], [9, 8, 7, 6, 5, 4]]
SAMPLED = SamplingParams(max_new_tokens=6, eos_token_id=NO_EOS,
                         strategy=SAMPLING, temperature=0.8, top_p=0.9,
                         seed=7)


def _sp(n=6):
    return SamplingParams(max_new_tokens=n, eos_token_id=NO_EOS)


def _events_since(seq):
    return [e for e in pobs.get_event_log().events()
            if e.get('seq', 0) > seq and e.get('ph') == 'i']


def _last_seq():
    evs = pobs.get_event_log().events()
    return evs[-1]['seq'] if evs else 0


def _drive(router, handles, max_rounds=3000):
    rounds = 0
    while any(not h.done for h in handles) and rounds < max_rounds:
        router.step()
        rounds += 1
    assert rounds < max_rounds, 'the router did not drive the requests dry'


def _maps_jax(pid):
    with open(f'/proc/{pid}/maps') as f:
        return 'jaxlib' in f.read()


@pytest.fixture(autouse=True, scope='module')
def _isolated(tmp_path_factory):
    yield from isolated_observability(tmp_path_factory)


@pytest.fixture(scope='module')
def fleet(tmp_path_factory):
    """The stores, a supervisor, its first child (kept alive) and the
    references: the JAX engine's greedy tokens, the port's in-process
    engine's sampled tokens and the model's digest."""
    base = tmp_path_factory.mktemp('torch_fleet_proc')
    dirs = {k: str(base / k) for k in ('run', 'weights', 'spool')}
    paddle.seed(11)
    jm = jllama.LlamaForCausalLM(
        jllama.LlamaConfig.tiny(num_key_value_heads=2)).eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    model = from_jax_state(state, LlamaForCausalLM(
        LlamaConfig.tiny(num_key_value_heads=2), device='cpu'))
    wstore = WeightStore(dirs['weights'])
    version = wstore.publish(model.state_dict())
    ref = JaxEngine(jm, **ENGINE_KW)
    ref_tokens = [h.tokens for h in ref.generate_many(
        PROMPTS, JaxParams(max_new_tokens=6, eos_token_id=NO_EOS))]
    port = InferenceEngine(model, **ENGINE_KW)
    sampled = port.generate_many([PROMPTS[2]], SAMPLED)[0].tokens
    spec = ReplicaSpec(FACTORY, model_kwargs={'num_key_value_heads': 2},
                       engine_kwargs=ENGINE_KW,
                       weight_store_dir=dirs['weights'],
                       spool_dir=dirs['spool'], drain_deadline_s=20.0,
                       device='cpu')
    sup = Supervisor(dirs['run'], spec, heartbeat_interval_s=0.2,
                     heartbeat_timeout_s=2.0, backoff_base_s=0.05,
                     backoff_cap_s=0.2, max_restarts=5,
                     restart_window_s=60.0, spawn_timeout_s=120.0)
    seed = sup.spawn('seed')
    fl = {'sup': sup, 'dirs': dirs, 'spec': spec, 'model': model,
          'wstore': wstore, 'version': version, 'ref_tokens': ref_tokens,
          'sampled': sampled, 'digest': param_digest(model), 'seed': seed}
    yield fl
    sup.stop_all(deadline_s=10.0)


def test_a_child_serves_the_jax_engines_tokens(fleet):
    rr = fleet['seed']
    assert rr.num_slots == ENGINE_KW['num_slots']
    assert rr.weight_version == fleet['version']
    before = rr.stats()
    toks = [h.tokens for h in rr.generate_many(PROMPTS, _sp())]
    assert toks == fleet['ref_tokens']
    assert rr.generate_many([PROMPTS[2]], SAMPLED)[0].tokens == \
        fleet['sampled']
    st = rr.stats()
    assert st['completed'] - before['completed'] == len(PROMPTS) + 1
    assert st['param_digest'] == fleet['digest']
    assert st['weight_version'] == fleet['version']
    hz = rr.healthz()
    assert hz['ok'] and hz['pid'] == rr.pid
    assert not _maps_jax(rr.pid)
    assert rr.scheduler.queue_depth == 0 and rr._slot_req == {}
    assert not rr.has_work


def test_submit_errors_come_back_typed(fleet):
    rr = fleet['seed']
    with pytest.raises(ValueError):
        rr.submit(list(range(40)), _sp(60))     # past the slot's length
    with pytest.raises(ValueError):
        rr.submit([], _sp())
    assert rr.submit(PROMPTS[0], _sp()).result() == fleet['ref_tokens'][0]


def test_swap_weights_by_version(fleet):
    wstore, rr = fleet['wstore'], fleet['seed']
    v2 = wstore.publish(fleet['model'].state_dict())
    assert rr.swap_weights(version=v2) == fleet['version']
    assert rr.weight_version == v2
    h = rr.submit(PROMPTS[0], _sp())
    assert h.result() == fleet['ref_tokens'][0]
    assert h.weight_version == v2
    rr.restore_weights(fleet['version'])
    assert rr.weight_version == fleet['version']
    assert rr.stats()['weight_version'] == fleet['version']


def test_sigkill_mid_decode_loses_nothing_and_respawns(fleet):
    sup = fleet['sup']
    restarted = []
    sup.on_restart = lambda name, replica: restarted.append((name, replica))
    ra, rb = sup.spawn('ca'), fleet['seed']
    router = Router([Replica(0, ra), Replica(1, rb)])
    seq0 = _last_seq()
    try:
        handles = [router.submit(p, _sp()) for p in PROMPTS]
        for _ in range(200):
            router.step()
            if ra._slot_req and rb._slot_req and any(
                    not h.done and h.tokens for h in handles):
                break
        assert ra._slot_req and rb._slot_req, 'both must be decoding'
        sup.kill('ca')                          # SIGKILL, mid-decode
        _drive(router, handles)
        assert [h.status for h in handles] == [FINISHED] * len(PROMPTS)
        assert [h.tokens for h in handles] == fleet['ref_tokens']
        assert 'router_failover' in [e['name'] for e in _events_since(seq0)]
        deadline = time.time() + 60
        while not restarted and time.time() < deadline:
            sup.poll()
            time.sleep(0.05)
        assert restarted, 'the victim was not respawned'
        names = [e['name'] for e in _events_since(seq0)]
        for want in ('replica_crash', 'replica_restart', 'replica_ready'):
            assert want in names
        assert 'replica_quarantined' not in names
        name2, rr2 = restarted[0]
        assert name2 == 'ca' and rr2.pid != ra.pid
        router.remove_replica([r.id for r in router.replicas
                               if r.engine is ra][0])
        router.add_replica(rr2)
        h = router.submit(PROMPTS[0], _sp())
        _drive(router, [h])
        assert h.tokens == fleet['ref_tokens'][0]
    finally:
        sup.on_restart = None
        sup.retire('ca', deadline_s=20.0)


def test_a_fresh_child_captures_and_compiles_nothing_serving(fleet):
    rr = fleet['sup'].spawn('warm')
    try:
        ready = rr.stats()
        toks = [h.tokens for h in rr.generate_many(PROMPTS, _sp())]
        assert toks == fleet['ref_tokens']
        after = rr.stats()
        assert after['traces'] == ready['traces_at_ready'] == {}
        assert after['captures_at_ready'] == 0
        assert after['kernel_builds'] == after['kernel_builds_at_ready'] == 0
        assert after['param_digest'] == fleet['digest']
    finally:
        fleet['sup'].retire('warm', deadline_s=20.0)


def test_a_sigstopped_child_is_killed_and_respawned(fleet):
    restarted = []
    sup = Supervisor(os.path.join(fleet['dirs']['run'], 'hang'),
                     fleet['spec'], heartbeat_interval_s=0.1,
                     heartbeat_timeout_s=1.0, backoff_base_s=0.05,
                     backoff_cap_s=0.2, max_restarts=5, spawn_timeout_s=120.0,
                     on_restart=lambda n, r: restarted.append(r))
    seq0 = _last_seq()
    rr = sup.spawn('h0')
    pid0 = rr.pid
    try:
        os.kill(pid0, signal.SIGSTOP)
        deadline = time.time() + 60
        while not restarted and time.time() < deadline:
            sup.poll()
            time.sleep(0.05)
        assert restarted, 'the SIGSTOPped child was never found hung'
        names = [e['name'] for e in _events_since(seq0)
                 if e['name'].startswith('replica_')]
        assert names == ['replica_spawn', 'replica_ready', 'replica_hang',
                         'replica_crash', 'replica_restart',
                         'replica_spawn', 'replica_ready']
        assert restarted[0].pid != pid0 and restarted[0].healthz()['ok']
        assert not os.path.exists(f'/proc/{pid0}')
    finally:
        sup.stop_all(deadline_s=10.0)


def test_the_autoscaler_spawns_and_retires_processes(fleet):
    sup, r0 = fleet['sup'], fleet['seed']
    router = Router([Replica(0, r0)])
    sig = {'window_s': 60.0, 'ttft_p50': 5.0, 'ttft_p99': 9.0,
           'queue_p50': 50.0, 'queue_p99': 90.0, 'shed_rate': 1.0,
           'accept_rate': 5.0, 'serving_replicas': 1}
    t = [100.0]
    scaler = Autoscaler(
        router, sup.replica_factory(),
        AutoscalerConfig(min_replicas=1, max_replicas=2, slo_ttft_s=0.5,
                         cooldown_s=0.0, provision_cooldown_factor=0.0,
                         down_stable_s=0.0),
        clock=lambda: t[0], force=True, signal_source=lambda: dict(sig))
    try:
        scaler.poll()
        assert len(router.replicas) == 2
        added = [r for r in router.replicas if r.engine is not r0][0]
        assert added.engine.healthz()['ok']
        new_name = added.engine.name
        assert sup.stats()[new_name]['state'] == 'ready'
        handles = [router.submit(p, _sp()) for p in PROMPTS]
        _drive(router, handles)
        assert [h.tokens for h in handles] == fleet['ref_tokens']
        sig.update(ttft_p50=0.01, ttft_p99=0.02, queue_p50=0.0,
                   queue_p99=0.0, shed_rate=0.0, accept_rate=0.1,
                   serving_replicas=2)
        deadline = time.time() + 30
        while len(router.replicas) > 1 and time.time() < deadline:
            t[0] += 5.0
            scaler.poll()
            router.step()
        assert len(router.replicas) == 1
        gone = {'seed', new_name} - {router.replicas[0].engine.name}
        assert sup.stats()[gone.pop()]['state'] == 'stopped'
        assert all(h.status == FINISHED for h in handles)
    finally:
        for name, rec in sup.stats().items():
            if rec['state'] == 'ready' and name != 'seed':
                sup.retire(name, deadline_s=20.0)


def _child(*args, **env):
    return subprocess.run(
        [sys.executable, '-m', 'paddle_tpu_torch.serving.replica_main',
         *args], cwd=REPO, env={**os.environ, **env}, capture_output=True,
        text=True, timeout=120)


def test_a_child_without_a_card_refuses_to_serve(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('needs a host without a CUDA device')
    res = _child('--socket', str(tmp_path / 's.sock'), '--model-spec',
                 FACTORY)
    assert res.returncode == EXIT_LOAD, res.stderr[-2000:]
    assert 'no CUDA device' in res.stderr
    assert not (tmp_path / 's.sock').exists()


def test_a_bad_factory_is_a_usage_error(tmp_path):
    res = _child('--socket', str(tmp_path / 's.sock'), '--model-spec',
                 'no_colon_here', '--device', 'cpu')
    assert res.returncode == EXIT_USAGE
