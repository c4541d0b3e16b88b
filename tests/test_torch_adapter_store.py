"""The store-backed half of the port's adapter bank and the engine's
bank-full requeue, against the JAX package's, on the CPU.

Mirrors tests/test_adapters.py's `TestAdapterStore` and its in-flight and
namespace engine tests on the tiny GQA Llama (weights through
`from_jax_state`, factors from both packages' `make_adapter_factors`):

- the bank: publish then pin loads the latest version; v2 published while
  v1 is pinned lands in a fresh slot and never touches v1's bytes; a
  corrupt or mis-shaped version is quarantined and the bank keeps
  serving what it has; the port's and the JAX bank's slot tables
  (`stats()`, `lookup`) are equal after every step;
- the engine: a store-served mixed wave, a publish while a v1 request
  decodes (v1 finishes bit-exact, the new request gets v2 in another
  slot), the prefix-cache namespace moving with the version, and a
  saturated bank (three adapters in flight on two slots): identical
  greedy tokens to the JAX engine's and to each request served alone,
  the port counting the requeue.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.serving import AdapterBank as JaxBank
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu.serving import make_adapter_factors as jax_factors
from paddle_tpu.serving.hotswap import WeightStore as JaxStore
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import (FAILED, FINISHED, QUEUED, AdapterBank,
                                      AdapterUnavailable, InferenceEngine,
                                      SamplingParams, WeightStore,
                                      make_adapter_factors)
from paddle_tpu_torch.weights import from_jax_state

NO_EOS = -1
TARGETS = ('q_proj', 'k_proj', 'v_proj', 'o_proj')


@pytest.fixture(autouse=True, scope='module')
def _reset_jax_metrics():
    yield
    jax_metrics.get_registry().reset()


@pytest.fixture(scope='module')
def models():
    paddle.seed(11)
    jm = jllama.LlamaForCausalLM(
        jllama.LlamaConfig.tiny(num_key_value_heads=2)).eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = from_jax_state(state, LlamaForCausalLM(
        LlamaConfig.tiny(num_key_value_heads=2), device='cpu'))
    return jm, tm


class Pair:
    """A port bank and a JAX bank built alike over one store directory
    each; every call runs on both, and `table()` is the slot table both
    must agree on."""

    def __init__(self, models, tmp_path, capacity=3, rank=4, store=True):
        jm, tm = models
        kw = {'capacity': capacity, 'rank': rank, 'targets': TARGETS}
        self.port = AdapterBank(
            tm, store_dir=str(tmp_path / 'port') if store else None, **kw)
        self.jax = JaxBank(
            jm, store_dir=str(tmp_path / 'jax') if store else None, **kw)

    def factors(self, seed):
        return (make_adapter_factors(self.port, seed=seed, scale=0.2),
                jax_factors(self.jax, seed=seed, scale=0.2))

    def publish(self, adapter_id, seed, **kw):
        fp, fj = self.factors(seed)
        v = self.port.publish(adapter_id, fp, **kw)
        assert self.jax.publish(adapter_id, fj, **kw) == v
        return v

    def load(self, adapter_id, seed, **kw):
        fp, fj = self.factors(seed)
        got = self.port.load(adapter_id, fp, **kw)
        assert self.jax.load(adapter_id, fj, **kw) == got
        return got

    def call(self, name, *args):
        """`name(*args)` on both banks: equal results, or the same error
        type and text."""
        out = []
        for bank in (self.port, self.jax):
            try:
                out.append(('ok', getattr(bank, name)(*args)))
            except (KeyError, ValueError) as e:   # AdapterUnavailable is a
                out.append((type(e).__name__, str(e)))   # KeyError
        assert out[0] == out[1], out
        if out[0][0] != 'ok':
            raise {'AdapterUnavailable': AdapterUnavailable,
                   'ValueError': ValueError}[out[0][0]](out[0][1])
        return out[0][1]

    def table(self):
        st = self.port.stats()
        assert st == self.jax.stats()
        return st


# ---------------------------------------------------------------------------
# the bank
# ---------------------------------------------------------------------------

def test_publish_then_pin_loads_latest(models, tmp_path):
    b = Pair(models, tmp_path, capacity=2)
    assert not b.call('available', 'ad0')
    v1 = b.publish('ad0', 1)
    assert b.call('available', 'ad0')          # servable from the store
    assert b.call('lookup', 'ad0') is None     # but not resident yet
    slot, ver = b.call('pin', 'ad0')           # lazy load on first pin
    assert ver == v1 == 1
    assert b.call('lookup', 'ad0') == (slot, v1)
    assert b.table()['resident']['ad0'] == {'slot': slot, 'version': 1,
                                            'refs': 1}
    b.call('unpin', slot)
    assert b.table()['pinned'] == 0


def test_publish_v2_never_touches_pinned_v1_slot(models, tmp_path):
    """v1 keeps decoding bit-exact out of its own slot while v2 lands in a
    fresh slot for new pins; the packed tensors keep their storage."""
    b = Pair(models, tmp_path)
    b.publish('ad0', 1)
    s1, _ = b.call('pin', 'ad0')
    site = next(iter(b.port.sites))
    arrays = b.port.device_arrays()
    a = arrays['factors'][site]['a']
    ptr, a_v1 = a.data_ptr(), a[s1].clone()
    v2 = b.publish('ad0', 2)
    assert torch.equal(a[s1], a_v1)             # publish is lazy
    s2, ver2 = b.call('pin', 'ad0')
    assert ver2 == v2 and s2 != s1
    assert torch.equal(a[s1], a_v1)             # v1's bytes are v1's
    assert torch.equal(a[s2], torch.from_numpy(b.factors(2)[0][site][0]))
    assert b.port.device_arrays() is arrays and a.data_ptr() == ptr
    assert b.table()['resident']['ad0']['version'] == v2
    # the old slot keeps its key until evicted; the id maps to v2's slot
    assert b.port._keys[s1] == 'ad0' and b.call('lookup', 'ad0') == (s2, v2)
    b.call('unpin', s1)
    b.call('unpin', s2)
    b.table()


@pytest.mark.parametrize('fault', ['corrupt', 'mis-shaped'])
def test_bad_version_quarantined_bank_keeps_serving(models, tmp_path, fault):
    """A v2 that fails its sha256 manifest, or whose factors have another
    rank: pin() quarantines it and keeps serving resident v1."""
    b = Pair(models, tmp_path, capacity=2)
    v1 = b.publish('ad0', 1)
    b.call('unpin', b.call('pin', 'ad0')[0])   # v1 resident
    for bank, key, maker in ((b.port, 'port', make_adapter_factors),
                             (b.jax, 'jax', jax_factors)):
        d = str(tmp_path / key)
        if fault == 'corrupt':
            bank.publish('ad0', maker(bank, seed=2, scale=0.2))
            payload = tmp_path / key / 'ad0' / 'step_2' / 'tree.npz'
            raw = bytearray(payload.read_bytes())
            raw[len(raw) // 2] ^= 0xFF
            payload.write_bytes(bytes(raw))
        else:
            other = (AdapterBank if key == 'port' else JaxBank)(
                models[0 if key == 'jax' else 1], capacity=2, rank=2,
                targets=TARGETS, store_dir=d)
            other.publish('ad0', maker(other, seed=2, scale=0.2))
    slot, ver = b.call('pin', 'ad0')
    assert ver == v1                           # still serving v1
    for key, cls in (('port', WeightStore), ('jax', JaxStore)):
        store = cls(str(tmp_path / key / 'ad0'))
        assert store.quarantined() == [2] and store.latest_version() == 1
    b.call('unpin', slot)
    b.table()


def test_only_quarantined_versions_are_not_available(models, tmp_path):
    b = Pair(models, tmp_path, capacity=2)
    b.publish('ad0', 1)
    for key in ('port', 'jax'):
        WeightStore(str(tmp_path / key / 'ad0')).quarantine(1, 'test')
    assert not b.call('available', 'ad0')
    with pytest.raises(AdapterUnavailable, match='no servable'):
        b.call('pin', 'ad0')


def test_bad_adapter_id_names_no_directory(models, tmp_path):
    b = Pair(models, tmp_path)
    with pytest.raises(ValueError, match='bad adapter id'):
        b.call('publish', '../escape', b.factors(1)[0])
    with pytest.raises(ValueError, match='bad adapter id'):
        b.call('available', 'a/b')


def test_full_bank_of_pins_is_transient_and_load_stays_quarantine_free(
        models, tmp_path):
    """Two pinned slots and a third adapter published: its pin raises the
    transient miss (back-pressure), its version stays servable, and it
    loads once a pin frees."""
    b = Pair(models, tmp_path, capacity=2)
    for i in range(3):
        b.publish(f'ad{i}', i + 1)
    s0, _ = b.call('pin', 'ad0')
    b.call('pin', 'ad1')
    for bank in (b.port, b.jax):
        with pytest.raises(KeyError) as ei:       # each package's miss
            bank.pin('ad2')
        assert ei.value.transient and 'bank full' in ei.value.detail
    assert b.call('available', 'ad2')
    b.call('unpin', s0)
    assert b.call('pin', 'ad2') == (s0, 1)     # ad0's slot, evicted
    assert b.call('lookup', 'ad0') is None
    b.table()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, (s,)).tolist() for s in lens]


def _engines(models, pair, **kw):
    jm, tm = models
    kw = {'num_slots': 4, 'max_length': 64, 'decode_block': 2,
          'kv_page_size': 16, **kw}
    return (JaxEngine(jm, adapter_bank=pair.jax, **kw),
            InferenceEngine(tm, adapter_bank=pair.port, **kw))


def _sp(cls, n):
    return cls(max_new_tokens=n, eos_token_id=NO_EOS)


def _alone(models, tmp_path, prompts, adapter_id, seed, n):
    """The port's tokens for `prompts` under one adapter `load`ed into a
    fresh bank without a store (and the JAX engine's, which must equal
    them)."""
    pair = Pair(models, tmp_path, capacity=2, store=False)
    pair.load(adapter_id, seed)
    jeng, eng = _engines(models, pair)
    got = [h.tokens for h in eng.generate_many(
        prompts, _sp(SamplingParams, n), adapter_ids=adapter_id)]
    assert got == [h.tokens for h in jeng.generate_many(
        prompts, _sp(JaxParams, n), adapter_ids=adapter_id)]
    return got


def test_store_served_mixed_wave_identical_to_jax_and_to_load(models,
                                                               tmp_path):
    prompts = _prompts([4, 6, 5, 7], seed=1)
    ids = [None, 'ad0', 'ad1', 'ad0']
    pair = Pair(models, tmp_path)
    pair.publish('ad0', 1)
    pair.publish('ad1', 2)
    jeng, eng = _engines(models, pair)
    assert eng.submit(prompts[0], _sp(SamplingParams, 1),
                      adapter_id='ad1').status == QUEUED  # not resident
    eng.run()
    jeng.submit(prompts[0], _sp(JaxParams, 1), adapter_id='ad1').result()
    ht = eng.generate_many(prompts, _sp(SamplingParams, 5), adapter_ids=ids)
    hj = jeng.generate_many(prompts, _sp(JaxParams, 5), adapter_ids=ids)
    assert [h.tokens for h in ht] == [h.tokens for h in hj]
    assert all(h.status == FINISHED for h in ht)
    assert [h.adapter_version for h in ht] == [None, 1, 1, 1]
    loaded = Pair(models, tmp_path / 'ref', store=False)
    loaded.load('ad0', 1, version=1)
    loaded.load('ad1', 2, version=1)
    ref = InferenceEngine(models[1], num_slots=4, max_length=64,
                          decode_block=2, adapter_bank=loaded.port)
    assert [h.tokens for h in ht] == [h.tokens for h in ref.generate_many(
        prompts, _sp(SamplingParams, 5), adapter_ids=ids)]
    assert pair.table()['pinned'] == 0


def test_hot_publish_in_flight_v1_bit_exact_new_requests_v2(models,
                                                            tmp_path):
    """Publish v2 while a v1 request is mid-decode: the v1 request
    finishes with exactly the tokens of a pure-v1 run; a request
    submitted after the publish decodes under v2, in another slot, with
    the tokens of a bank that only ever held v2. Both engines alike."""
    prompt = _prompts([6], seed=5)[0]
    want = {v: _alone(models, tmp_path / f'v{v}', [prompt], 'ad0', seed, 8)[0]
            for v, seed in ((1, 1), (2, 2))}
    assert want[1] != want[2]
    pair = Pair(models, tmp_path / 'live')
    v1 = pair.publish('ad0', 1)
    tokens = {}
    for eng, cls in zip(_engines(models, pair), (JaxParams, SamplingParams)):
        h1 = eng.submit(prompt, _sp(cls, 8), adapter_id='ad0')
        for _ in range(3):
            eng.step()                          # h1 is mid-decode on v1
        assert h1.adapter_version == v1 and not h1.done
        tokens[cls] = (h1, eng)
    assert pair.publish('ad0', 2) == 2
    for cls, (h1, eng) in tokens.items():
        h2 = eng.submit(prompt, _sp(cls, 8), adapter_id='ad0')
        eng.step()
        assert h2._adapter_pin != h1._adapter_pin
        eng.run()
        assert h1.status == FINISHED and h2.status == FINISHED
        assert h1.tokens == want[1]             # bit-exact through the swap
        assert (h2.adapter_version, h2.tokens) == (2, want[2])
    assert pair.table()['pinned'] == 0


def test_publish_changes_namespace_old_kv_unreachable(models, tmp_path):
    """The version rides the prefix-cache namespace: after a publish a new
    request misses v1's cached prefix and decodes v2's tokens. Hits equal
    the JAX engine's."""
    prompt = _prompts([40], seed=11)[0]
    pair = Pair(models, tmp_path / 'live')
    pair.publish('ad0', 1)
    jeng, eng = _engines(models, pair, prefix_cache=0.9)
    hits = []
    for e, cls in ((jeng, JaxParams), (eng, SamplingParams)):
        e.generate_many([prompt], _sp(cls, 3), adapter_ids='ad0')
        e.generate_many([prompt], _sp(cls, 3), adapter_ids='ad0')
        hits.append(e.stats()['prefix_cache']['hits'])
    assert hits[0] == hits[1] >= 1               # the same version dedupes
    pair.publish('ad0', 2)
    got = []
    for e, cls in ((jeng, JaxParams), (eng, SamplingParams)):
        got.append(e.generate_many([prompt], _sp(cls, 3),
                                   adapter_ids='ad0')[0].tokens)
        assert e.stats()['prefix_cache']['hits'] == hits[0]   # no hit
    assert got[0] == got[1] == _alone(models, tmp_path / 'v2', [prompt],
                                      'ad0', 2, 3)[0]


def test_saturated_bank_requeues_and_finishes_like_jax(models, tmp_path):
    """Three adapters in flight on a bank of two slots: the third admission
    finds every slot pinned, which is back-pressure, not a failure. Both
    engines finish every request with the tokens it gets served alone;
    the port counts the requeues."""
    prompts = _prompts([5, 7, 6, 9, 4], seed=7)
    ids = ['ad0', 'ad1', 'ad2', 'ad1', None]
    pair = Pair(models, tmp_path / 'live', capacity=2)
    for i in range(3):
        pair.publish(f'ad{i}', i + 1)
    jeng, eng = _engines(models, pair, num_slots=8)
    ht = eng.generate_many(prompts, _sp(SamplingParams, 6), adapter_ids=ids)
    hj = jeng.generate_many(prompts, _sp(JaxParams, 6), adapter_ids=ids)
    assert all(h.status == FINISHED for h in ht + hj)
    assert [h.tokens for h in ht] == [h.tokens for h in hj]
    st = eng.stats()
    assert st['requeued'] > 0 and st['failed'] == 0 and st['completed'] == 5
    assert pair.table()['pinned'] == 0
    for j, aid in enumerate(ids):
        if aid is not None:
            want = _alone(models, tmp_path / f'alone{j}', [prompts[j]], aid,
                          int(aid[2:]) + 1, 6)[0]
            assert ht[j].tokens == want, aid


def test_nothing_servable_fails_only_its_request(models, tmp_path):
    """An adapter whose only version is quarantined after submit: its
    request fails alone with the non-transient miss, in both engines."""
    prompts = _prompts([5, 6], seed=8)
    pair = Pair(models, tmp_path / 'live')
    pair.publish('ad0', 1)
    out = []
    for eng, cls, key, store in zip(
            _engines(models, pair), (JaxParams, SamplingParams),
            ('jax', 'port'), (JaxStore, WeightStore)):
        hs = [eng.submit(p, _sp(cls, 4), adapter_id=aid)
              for p, aid in zip(prompts, [None, 'ad0'])]
        store(str(tmp_path / 'live' / key / 'ad0')).quarantine(1, 'test')
        eng.run()
        assert [h.status for h in hs] == [FINISHED, FAILED]
        assert type(hs[1].error).__name__ == 'AdapterUnavailable'
        assert not hs[1].error.transient
        out.append(hs[0].tokens)
    assert out[0] == out[1]
