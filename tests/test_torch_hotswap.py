"""Versioned weights in the port (paddle_tpu_torch.serving.hotswap)
against the JAX package's, on the CPU, over the tiny GQA Llama.

- `WeightStore`, mirroring tests/test_hotswap.py's store tests: the
  round trip (f32 and bf16 weights, bit for bit), monotone versions, a
  corrupt payload refused with no fall-back, quarantine, retention,
  `keep_versions < 2`, the writer marker (a live one a loud error, a
  dead pid's swept, a foreign host's aged out) and a publisher killed
  mid-commit in a child process that imports only the port.
- `WeightPublisher` over a port model, a callable and a
  `capture_host_state()` source.
- The gates: `finite_weights_gate` refuses an f32 NaN in both packages
  and a bf16 NaN in the port, where the JAX gate passes it (the
  difference is pinned here; ROADMAP.md, Queue 3); `CanaryGate` on the
  port's engine.
- Across packages: a version the JAX store publishes loads in the
  port's, and the port engine swapped to it gives the JAX engine's
  greedy tokens after the JAX swap to the same version; a version the
  port publishes loads in the JAX store bit for bit, bf16 included.
"""
import json
import os
import subprocess
import sys
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu.serving import WeightStore as JaxStore
from paddle_tpu.serving import finite_weights_gate as jax_gate
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import (CanaryGate, InferenceEngine,
                                      SamplingParams, SwapFailed,
                                      WeightLoadError, WeightPublisher,
                                      WeightStore, finite_weights_gate)
from paddle_tpu_torch.weights import from_jax_state

NO_EOS = -1
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope='module')
def _reset_jax_metrics():
    yield
    jax_metrics.get_registry().reset()


def _jax_state(seed):
    paddle.seed(seed)
    jm = jllama.LlamaForCausalLM(
        jllama.LlamaConfig.tiny(num_key_value_heads=2)).eval()
    return jm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _port(state):
    return from_jax_state(state, LlamaForCausalLM(
        LlamaConfig.tiny(num_key_value_heads=2), device='cpu'))


@pytest.fixture(scope='module')
def models():
    jm, state = _jax_state(11)
    return jm, _port(state)


@pytest.fixture(scope='module')
def trained_state():
    """A second, distinguishable set of weights for the same config (what
    'the trainer moved on' looks like)."""
    return _jax_state(1234)[1]


def _state_of(model, dtype=torch.float32):
    return {n: t.detach().to(dtype) for n, t in model.state_dict().items()}


def _bits(leaf):
    """(dtype name, raw bytes) of a host leaf of either package."""
    if isinstance(leaf, torch.Tensor):
        ints = {2: torch.int16, 4: torch.int32}[leaf.element_size()]
        return str(leaf.dtype).replace('torch.', ''), \
            leaf.contiguous().view(ints).numpy().tobytes()
    a = np.asarray(leaf)
    return a.dtype.name, a.tobytes()


def _same(a, b):
    return set(a) == set(b) and all(_bits(a[n]) == _bits(b[n]) for n in a)


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, (s,)).tolist() for s in lens]


def _results(eng, prompts, cls=SamplingParams, n=6):
    return [eng.submit(p, cls(max_new_tokens=n, eos_token_id=NO_EOS))
            .result() for p in prompts]


def _engine(model):
    return InferenceEngine(model, num_slots=2, max_length=64, decode_block=2,
                           kv_page_size=16)


def _flip_payload(store, version):
    payload = os.path.join(store.directory, f'step_{version}', 'tree.npz')
    with open(payload, 'rb') as f:
        raw = bytearray(f.read())
    raw[len(raw) // 2] ^= 0xFF          # one flipped byte
    with open(payload, 'wb') as f:
        f.write(bytes(raw))


# ---------------------------------------------------------------------------
# the versioned store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_publish_load_round_trip_bit_exact(tmp_path, models, dtype):
    store = WeightStore(str(tmp_path / 'w'))
    state = _state_of(models[1], dtype)
    v = store.publish(state, meta={'step': 17})
    assert v == 1 and store.latest_version() == 1
    loaded = store.load(v)
    assert _same(loaded, state)
    leaf = loaded[next(iter(loaded))]
    assert isinstance(leaf, torch.Tensor if dtype == torch.bfloat16
                      else np.ndarray)
    assert store.meta(v)['step'] == 17


def test_versions_monotone_and_explicit_guard(tmp_path, models):
    store = WeightStore(str(tmp_path / 'w'))
    state = _state_of(models[1])
    assert store.publish(state) == 1
    assert store.publish(state, version=5) == 5
    assert store.next_version() == 6
    with pytest.raises(ValueError, match='monotone'):
        store.publish(state, version=3)


def test_corrupt_payload_fails_load_not_falls_back(tmp_path, models):
    store = WeightStore(str(tmp_path / 'w'))
    store.publish(_state_of(models[1]))
    v = store.publish(_state_of(models[1]))
    _flip_payload(store, v)
    with pytest.raises(WeightLoadError, match='sha256'):
        store.load(v)
    with pytest.raises(WeightLoadError, match='not committed'):
        store.load(9)


def test_quarantine_filters_latest_and_load(tmp_path, models):
    store = WeightStore(str(tmp_path / 'w'))
    state = _state_of(models[1])
    v1, v2 = store.publish(state), store.publish(state)
    store.quarantine(v2, 'failed gate (test)')
    store.quarantine(v2, 'again')               # idempotent
    assert store.latest_version() == v1
    assert store.quarantined() == [v2] and store.versions() == [v1]
    with pytest.raises(WeightLoadError, match='quarantined'):
        store.load(v2)
    assert store.publish(state) == v2 + 1      # numbering stays monotone
    # the marker is the JAX package's: its store sees the quarantine too
    assert JaxStore(str(tmp_path / 'w')).quarantined() == [v2]


def test_retention_keeps_last_k(tmp_path, models):
    store = WeightStore(str(tmp_path / 'w'), keep_versions=2)
    state = _state_of(models[1])
    for _ in range(4):
        store.publish(state)
    assert store.all_versions() == [3, 4]


def test_rollback_needs_two_versions(tmp_path):
    for cls in (WeightStore, JaxStore):
        with pytest.raises(ValueError, match='keep_versions'):
            cls(str(tmp_path / 'w'), keep_versions=1)


def test_swap_failed_carries_version_and_replica():
    e = SwapFailed(3, 1, 'drain timed out')
    assert (e.version, e.replica_id, str(e)) == (3, 1, 'drain timed out')


# ---------------------------------------------------------------------------
# stale-writer detection (trainer and servers in separate processes)
# ---------------------------------------------------------------------------

_STORE_CHILD = r'''
import json, os, sys
import numpy as np
from paddle_tpu_torch.serving.hotswap import WeightStore

d, action = sys.argv[1], sys.argv[2]
store = WeightStore(d, stale_writer_s=3600.0)
fill = float(sys.argv[3]) if len(sys.argv) > 3 else 1.0
state = {'w': np.full((4, 4), fill, 'float32')}
bad = sorted(m for m in sys.modules if m.split('.')[0] in
             ('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes'))
if action == 'publish':
    print(json.dumps({'published': store.publish(state),
                      'writer_left': store.writer_marker() is not None,
                      'bad': bad}))
elif action == 'publish_killed_mid_commit':
    # die between the tmp dir completing and the atomic commit rename:
    # the torn state a killed trainer leaves (a _WRITER marker and an
    # uncommitted step_*.tmp, never a half-offered version)
    real_replace = os.replace

    def dying(src, dst):
        if os.path.basename(dst).startswith('step_'):
            os._exit(17)
        return real_replace(src, dst)

    os.replace = dying
    store.publish(state)
elif action == 'serve':
    latest = store.latest_version()
    tree = store.load(latest) if latest is not None else None
    print(json.dumps({
        'latest': latest,
        'w0': None if tree is None else float(tree['w'].flat[0]),
        'writer_marker': store.writer_marker() is not None,
        'tmp_dirs': sorted(n for n in os.listdir(d) if n.endswith('.tmp')),
    }))
'''


def _run_store_child(tmp_path, action, fill=None):
    args = [sys.executable, '-c', _STORE_CHILD, str(tmp_path / 'wstore'),
            action]
    if fill is not None:
        args.append(str(fill))
    proc = subprocess.run(args, capture_output=True, text=True, timeout=240,
                          cwd=ROOT)
    line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() \
        else ''
    return proc.returncode, (json.loads(line) if line else None), \
        proc.stderr


def test_trainer_server_processes_with_mid_commit_kill(tmp_path):
    """Publish, die mid-commit, serve the last committed version anyway,
    recover, publish again, serve the new version: each step a process
    of its own that imports only the port."""
    rc, out, err = _run_store_child(tmp_path, 'publish', fill=1.0)
    assert rc == 0, err
    assert out == {'published': 1, 'writer_left': False, 'bad': []}
    rc, _, err = _run_store_child(tmp_path, 'publish_killed_mid_commit',
                                  fill=2.0)
    assert rc == 17, err
    rc, srv, err = _run_store_child(tmp_path, 'serve')
    assert rc == 0, err
    assert srv == {'latest': 1, 'w0': 1.0, 'writer_marker': True,
                   'tmp_dirs': ['step_2.tmp']}
    rc, out, err = _run_store_child(tmp_path, 'publish', fill=3.0)
    assert rc == 0, err
    assert out['published'] == 2
    rc, srv, err = _run_store_child(tmp_path, 'serve')
    assert rc == 0, err
    assert srv == {'latest': 2, 'w0': 3.0, 'writer_marker': False,
                   'tmp_dirs': []}


def test_live_concurrent_publisher_is_a_loud_error(tmp_path):
    store = WeightStore(str(tmp_path / 'w'))
    store._claim_writer(1)          # this live process holds the marker
    assert store.stats()['writer']['version'] == 1
    for other in (WeightStore(str(tmp_path / 'w')),
                  JaxStore(str(tmp_path / 'w'))):
        with pytest.raises(RuntimeError, match='live publisher'):
            other.publish({'w': np.ones((2, 2), 'float32')})
    store._release_writer()
    assert store.stats()['writer'] is None
    assert WeightStore(str(tmp_path / 'w')).publish(
        {'w': np.ones((2, 2), 'float32')}) == 1


def test_dead_pid_marker_swept(tmp_path):
    store = WeightStore(str(tmp_path / 'w'))
    with open(store._writer_path(), 'w') as f:
        json.dump({'pid': 2 ** 22 + 12345, 'started': 0,
                   'host': os.uname().nodename}, f)
    (tmp_path / 'w' / 'step_9.tmp').mkdir()
    assert store.publish({'w': np.ones((2, 2), 'float32')}) == 1
    assert not (tmp_path / 'w' / 'step_9.tmp').exists()
    assert store.writer_marker() is None


def test_foreign_host_marker_ages_out(tmp_path):
    store = WeightStore(str(tmp_path / 'w'), stale_writer_s=5.0)
    with open(store._writer_path(), 'w') as f:
        json.dump({'pid': 1, 'started': time.time(),
                   'host': 'some-other-host'}, f)
    with pytest.raises(RuntimeError, match='live publisher'):
        store.publish({'w': np.ones((2, 2), 'float32')})
    with open(store._writer_path(), 'w') as f:
        json.dump({'pid': 1, 'started': time.time() - 60.0,
                   'host': 'some-other-host'}, f)
    assert store.publish({'w': np.ones((2, 2), 'float32')}) == 1


def test_garbage_marker_reads_as_stale(tmp_path):
    store = WeightStore(str(tmp_path / 'w'))
    with open(store._writer_path(), 'w') as f:
        f.write('{torn')
    assert store.writer_marker() == {}
    assert store.publish({'w': np.ones((2, 2), 'float32')}) == 1


# ---------------------------------------------------------------------------
# the trainer side
# ---------------------------------------------------------------------------

def test_publisher_interval_and_no_double_publish(tmp_path, models):
    store = WeightStore(str(tmp_path / 'w'))
    pub = WeightPublisher(models[1], store, interval_steps=3)
    assert pub.maybe_publish(1) is None and pub.maybe_publish(2) is None
    assert pub.maybe_publish(3) == 1 and pub.last_published_step == 3
    assert pub.maybe_publish(3) is None      # the same step, once
    assert pub.maybe_publish(6) == 2
    assert store.meta(2) == {'step': 6}
    assert _same(store.load(2), _state_of(models[1]))
    with pytest.raises(ValueError):
        WeightPublisher(models[1], store, interval_steps=0)


@pytest.mark.parametrize('kind', ['callable', 'capture_host_state'])
def test_publisher_sources(tmp_path, models, kind):
    state = _state_of(models[1], torch.bfloat16)

    class Elastic:
        def capture_host_state(self):
            return {'model': state}

    src = (lambda: state) if kind == 'callable' else Elastic()
    store = WeightStore(str(tmp_path / 'w'))
    pub = WeightPublisher(src, store, meta_fn=lambda step: {'loss': 1.5})
    v = pub.publish(step=4)
    assert v == pub.last_published_version == 1
    assert store.meta(v) == {'step': 4, 'loss': 1.5}
    assert _same(store.load(v), state)


def test_layer_snapshot_does_not_follow_later_updates(tmp_path):
    """The publisher's snapshot is a copy: an in-place update after
    `capture()` (what the trainer does next) does not reach it."""
    model = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=2),
                             device='cpu')
    pub = WeightPublisher(model, WeightStore(str(tmp_path / 'w')))
    snap = pub.capture()
    name, param = next(iter(model.named_parameters()))
    before = snap[name].clone()
    with torch.no_grad():
        param.add_(1.0)
    assert torch.equal(snap[name], before)


# ---------------------------------------------------------------------------
# the health gates
# ---------------------------------------------------------------------------

def _nan_tree():
    w = np.ones((2, 3), np.float32)
    w[1, 2] = np.nan
    return {'w': w, 'i': np.arange(3), 'f': np.ones(3, np.float32)}


@pytest.mark.parametrize('publisher', ['port', 'jax'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_finite_gate_on_a_nan_version(tmp_path, publisher, dtype):
    """The port's gate refuses a NaN in every floating leaf. The JAX
    gate refuses an f32 NaN but passes a bf16 one: its
    `np.issubdtype(a.dtype, np.floating)` is False for
    `ml_dtypes.bfloat16` (numpy kind 'V'). When the reference is fixed,
    the last assertion shows it."""
    tree = _nan_tree()
    if publisher == 'port':
        state = {k: torch.from_numpy(v).to(torch.bfloat16)
                 if dtype == 'bfloat16' and v.dtype == np.float32 else v
                 for k, v in tree.items()}
        v = WeightStore(str(tmp_path / 'w')).publish(state)
    else:
        state = {k: v.astype(ml_dtypes.bfloat16)
                 if dtype == 'bfloat16' and v.dtype == np.float32 else v
                 for k, v in tree.items()}
        v = JaxStore(str(tmp_path / 'w')).publish(state)
    port_tree = WeightStore(str(tmp_path / 'w')).load(v)
    jax_tree = JaxStore(str(tmp_path / 'w')).load(v)
    assert finite_weights_gate(None, v, port_tree) == \
        (False, "non-finite values in 'w'")
    want = (True, '') if dtype == 'bfloat16' else \
        (False, "non-finite values in 'w'")
    assert jax_gate(None, v, jax_tree) == want
    clean = {k: x for k, x in port_tree.items() if k != 'w'}
    assert finite_weights_gate(None, v, clean) == (True, '')


def test_canary_gate_on_the_port_engine(models):
    eng = _engine(models[1])
    prompt = _prompts([7], seed=2)[0]
    want = _results(eng, [prompt], n=4)[0]
    assert CanaryGate(prompt, 4, expect=want)(eng, 0, {}) == (True, '')
    assert CanaryGate(prompt, 4)(eng, 0, {}) == (True, '')
    ok, why = CanaryGate(prompt, 4, expect=[0, 0, 0, 0])(eng, 0, {})
    assert not ok and why.startswith('canary mismatch')


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def test_jax_published_version_swaps_into_the_port_engine(tmp_path, models,
                                                          trained_state):
    """The JAX store publishes the trainer's weights; the port's store
    loads them (bit-equal to the JAX store's load), they pass the port's
    gate, and the port engine swapped to them decodes the JAX engine's
    greedy tokens after the JAX swap of the same version, and a fresh
    port engine's on those weights. The restore gives the old tokens."""
    jm, _ = models
    jstore = JaxStore(str(tmp_path / 'w'))
    v1 = jstore.publish({k: np.asarray(t.numpy())
                         for k, t in jm.state_dict().items()})
    v2 = jstore.publish(trained_state, meta={'step': 100})
    store = WeightStore(str(tmp_path / 'w'))
    assert store.versions() == [v1, v2] and store.meta(v2) == {'step': 100}
    tree = store.load(v2)
    assert _same(tree, jstore.load(v2))
    assert finite_weights_gate(None, v2, tree) == (True, '')
    own = _port({k: np.asarray(t.numpy()) for k, t in jm.state_dict().items()})
    jeng = JaxEngine(jm, num_slots=2, max_length=64, decode_block=2,
                     kv_page_size=16)
    eng = _engine(own)
    prompts = _prompts([5, 9], seed=3)
    before = _results(eng, prompts)
    assert before == _results(jeng, prompts, JaxParams)
    traces = dict(eng.stats()['traces'])
    prev = eng.swap_weights(tree, version=v2)
    jprev = jeng.swap_weights(jstore.load(v2), version=v2)
    after = _results(eng, prompts)
    assert after != before
    assert after == _results(jeng, prompts, JaxParams)
    assert after == _results(_engine(_port(trained_state)), prompts)
    assert eng.stats()['weight_version'] == v2
    assert eng.stats()['traces'] == traces
    eng.restore_weights(prev)
    jeng.restore_weights(jprev)
    assert _results(eng, prompts) == before


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_port_published_version_loads_in_the_jax_store(tmp_path, models,
                                                       dtype):
    state = _state_of(models[1], dtype)
    v = WeightStore(str(tmp_path / 'w')).publish(state, meta={'step': 3})
    jstore = JaxStore(str(tmp_path / 'w'))
    assert jstore.latest_version() == v and jstore.meta(v) == {'step': 3}
    loaded = jstore.load(v)
    assert _same(loaded, state)
    assert all(a.dtype.name == str(dtype).replace('torch.', '')
               for a in loaded.values())
