"""The port's row engine (`InferenceEngine` built without `kv_page_size`,
`kv_pages` or `kv_quant`: one KV row per slot) against the JAX row
engine, on the CPU, over the tiny GQA Llama in f32 and one tiny GPT at
head_dim 64, with weights carried by `from_jax_state`.

- The layout rule: for the same arguments both packages build the same
  layout (`stats()['kv_layout']`) and the same prefix-cache class, and
  both refuse a cache of the other layout with the same ValueError.
- Greedy tokens equal the JAX engine's, and the port's `stats()` equal
  JAX's wherever JAX has the key (`pool`, `prefix_cache`, `spec` and the
  counts; `traces` is left out: the port captures nothing on the CPU),
  through whole and chunked prefill, prefix hits partial and full
  repeated three times, slot-pressure eviction and the requeue of a
  batch whose promised slot got pinned, speculation with a draft,
  adapters, drain, `evict_all`, `swap_weights`, a request-level failure
  and a request that runs to the end of its row beside a live
  neighbour.
- Sampling requests are held to their own seed (the two frameworks draw
  different random numbers): the same seed gives the same tokens, with
  any batch neighbours.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import observability as obs
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.resilience import FatalError as JaxFatal
from paddle_tpu.serving import AdapterBank as JaxBank
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import PagedPrefixCache as JaxPagedCache
from paddle_tpu.serving import RadixPrefixCache as JaxRadixCache
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu.serving import engine as jax_engine_mod
from paddle_tpu.serving import kv_pool as jpool
from paddle_tpu.serving import make_adapter_factors as jax_factors
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.resilience import FatalError
from paddle_tpu_torch.serving import (FAILED, FINISHED, SAMPLING,
                                      AdapterBank, InferenceEngine,
                                      PagedPrefixCache, PagedSlotPool,
                                      RadixPrefixCache, SamplingParams,
                                      make_adapter_factors)
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.serving.kv_pool import SlotPool
from paddle_tpu_torch.weights import from_jax_state
from test_torch_gpt import D64, gpt_pair

NO_EOS = -1
TARGETS = ('q_proj', 'k_proj', 'v_proj', 'o_proj')


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope='module')
def _reset_jax_metrics():
    """The JAX engine records into the JAX package's process-global
    metrics registry; zero it after this module."""
    yield
    jax_metrics.get_registry().reset()


@pytest.fixture(autouse=True)
def _clear_draining():
    """A JAX engine's drain marks the process degraded ('draining')."""
    yield
    obs.clear_degraded('draining')


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
    return _pair(11)


@pytest.fixture(scope='module')
def drafts():
    return _pair(99, num_hidden_layers=1)


def _rand(n, rng):
    return rng.randint(1, 128, (n,)).tolist()


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [_rand(s, rng) for s in lens]


def _engines(jm, tm, jbank=None, bank=None, **kw):
    kw = {'num_slots': 3, 'max_length': 96, 'decode_block': 2, **kw}
    return (JaxEngine(jm, adapter_bank=jbank, **kw),
            InferenceEngine(tm, adapter_bank=bank, **kw))


def _stats_equal(eng, jeng):
    """Every key of the JAX engine's stats() equals the port's, but the
    traces (nothing is captured on the CPU); nested dicts key by key."""
    want, got = jeng.stats(), eng.stats()
    assert got['kv_layout'] == 'row'
    for key, value in want.items():
        if key == 'traces':
            continue
        if isinstance(value, dict):
            for k, v in value.items():
                assert got[key][k] == v, (key, k)
        else:
            assert got[key] == value, key


def _serve(eng, params_cls, waves, new=6, adapter_ids=None):
    out = []
    for wave in waves:
        out += [h.tokens for h in eng.generate_many(
            wave, params_cls(max_new_tokens=new, eos_token_id=NO_EOS),
            adapter_ids=adapter_ids)]
    return out


def _same_as_jax(jeng, eng, waves, **kw):
    want = _serve(jeng, JaxParams, waves, **kw)
    got = _serve(eng, SamplingParams, waves, **kw)
    assert got == want
    _stats_equal(eng, jeng)
    return got


def _cold(tm, prompts, new=6, **kw):
    """The same prompts on a row engine without cache or chunking."""
    kw = {'num_slots': 3, 'max_length': 96, 'decode_block': 2, **kw}
    return [h.tokens for h in InferenceEngine(tm, **kw).generate_many(
        prompts, SamplingParams(max_new_tokens=new, eos_token_id=NO_EOS))]


# ---------------------------------------------------------------------------
# the layout rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kw', [
    {}, {'kv_page_size': 16}, {'kv_pages': 9}, {'kv_quant': 'int8'},
    {'prefix_cache': True}],
    ids=['default', 'page_size', 'pages', 'int8', 'prefix_cache'])
def test_layout_and_cache_class_follow_the_jax_rule(models, kw):
    jm, tm = models
    jeng = JaxEngine(jm, num_slots=2, max_length=64, **kw)
    eng = InferenceEngine(tm, num_slots=2, max_length=64, **kw)
    assert eng.stats()['kv_layout'] == jeng.stats()['kv_layout']
    assert eng.stats()['donate_pool'] == jeng.stats()['donate_pool']
    paged = jeng.stats()['kv_layout'] == 'paged'
    assert isinstance(eng.pool, PagedSlotPool) == paged
    assert type(eng.pool).__name__ == type(jeng.pool).__name__
    if kw.get('prefix_cache'):
        assert type(eng.prefix_cache).__name__ == \
            type(jeng.prefix_cache).__name__ == 'RadixPrefixCache'
    # a cache of the other layout is refused with the JAX error
    jrow, row = jpool.SlotPool(jm, 2, 64), SlotPool(tm, 2, 64)
    jpaged = jpool.PagedSlotPool(jm, 2, 64, page_size=16)
    tpaged = PagedSlotPool(tm, 2, 64, page_size=16)
    wrong = ((JaxPagedCache(jpaged, 0.5), PagedPrefixCache(tpaged, 0.5))
             if not paged else
             (JaxRadixCache(jrow, 0.5), RadixPrefixCache(row, 0.5)))
    msgs = []
    for cls, m, cache in ((JaxEngine, jm, wrong[0]),
                          (InferenceEngine, tm, wrong[1])):
        with pytest.raises(ValueError, match='layout') as err:
            cls(m, num_slots=2, max_length=64, prefix_cache=cache,
                **{k: v for k, v in kw.items() if k != 'prefix_cache'})
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_row_pool_lifecycle_matches_jax(models):
    """alloc (lowest free), free, the exhaustion error, note_written and
    the capacity figures of the JAX `SlotPool`; `copy_slot` copies the
    row on the device and counts it."""
    jm, tm = models
    jp, tp = jpool.SlotPool(jm, 3, 40), SlotPool(tm, 3, 40)
    for p in (jp, tp):
        p.prefill_chunk_tokens = 8
        assert [p.alloc(), p.alloc()] == [0, 1]
        p.note_written(0, 12)
        p.note_written(1, 50)
        p.free(0)
        assert p.alloc() == 0 and p.alloc() == 2
        with pytest.raises(RuntimeError, match='slot pool exhausted'):
            p.alloc()
        with pytest.raises(ValueError):
            p.free(7)
    assert tp.pages_per_slot == 3 and tp.table.tolist() == [
        [1, 2, 3], [4, 5, 6], [7, 8, 9]]   # 40 rows over 3 pages of 16
    k = tp.cache[0][0]
    k[1].normal_()
    jp.copy_slot(1, 2)
    tp.copy_slot(1, 2)
    assert torch.equal(k[2], k[1]) and k[2].data_ptr() != k[1].data_ptr()
    assert tp.stats() == jp.stats()
    assert tp.stats()['stranded_rows'] == 3 * 40 - 40


# ---------------------------------------------------------------------------
# the engine against the JAX row engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('decode_block,chunk', [(1, None), (4, None),
                                                (2, 8), (3, 16)])
def test_greedy_tokens_and_stats_match_jax(models, decode_block, chunk):
    """Whole prefills (chunk None) and chunked ones, prompts of 3..50
    tokens through 3 slots."""
    jm, tm = models
    prompts = _prompts([3, 9, 5, 14, 7, 11, 30, 50], seed=1)
    jeng, eng = _engines(jm, tm, decode_block=decode_block,
                         prefill_chunk_tokens=chunk)
    got = _same_as_jax(jeng, eng, [prompts], new=9)
    if chunk:
        assert got == _cold(tm, prompts, new=9)
        assert eng.stats()['chunk_rounds'] > 0
    assert eng.pool.free_count == 3


def test_gpt_head_dim_64_matches_jax():
    jm, tm = gpt_pair(**D64)
    prompts = _prompts([5, 12, 20, 33], seed=2)
    jeng, eng = _engines(jm, tm, max_length=64, prefill_chunk_tokens=16,
                         prefix_cache=0.5)
    _same_as_jax(jeng, eng, [prompts[:2], prompts + [prompts[2] + [7, 8]]])


def test_prefix_hits_partial_and_full_three_times(models):
    """A 20-token system prompt behind suffixes, then three more waves:
    partial hits (not page-aligned: a row cache reads the retained row
    at any length) and a full-prompt hit (`copy_slot`), each prefix hit
    at least three times. A retained row written by mistake would change
    a later hit's tokens, so each wave also equals a cold engine's."""
    jm, tm = models
    rng = np.random.RandomState(0)
    sysp = _rand(20, rng)
    wave = [sysp + _rand(n, rng) for n in (3, 12, 5)]
    full = list(wave[1])
    jeng, eng = _engines(jm, tm, prefix_cache=0.7, prefill_chunk_tokens=8)
    waves = [wave[:1], wave, [full, wave[2]], [full, wave[0]]]
    got = _same_as_jax(jeng, eng, waves)
    assert got[1:4] == _cold(tm, wave)
    assert got[4:] == _cold(tm, [full, wave[2], full, wave[0]])
    pc, pool = eng.stats()['prefix_cache'], eng.stats()['pool']
    assert pc['hits'] >= 6 and pool['row_copies'] >= 2
    assert pool['copied_bytes'] == pool['row_copies'] * pool['row_bytes']
    assert eng.prefix_cache.snapshot() == jeng.prefix_cache.snapshot()
    eng.prefix_cache.clear(force=True)
    jeng.prefix_cache.clear(force=True)
    assert eng.pool.free_count == 3 and eng.stats()['pool'] == \
        jeng.stats()['pool']


def test_slot_pressure_evicts_and_requeues_like_jax(models):
    """Three slots, two of them retained: a batch of three admits on the
    free slot and the two reclaimable ones. The first request hits the
    prefix of one retained slot and pins it; the second evicts the other;
    the third finds nothing to reclaim and goes back to the queue
    (`pool_exhausted`), then runs when a slot frees."""
    jm, tm = models
    rng = np.random.RandomState(3)
    a, b = _rand(18, rng), _rand(18, rng)
    later = [b + _rand(4, rng), _rand(9, rng), _rand(7, rng)]
    jeng, eng = _engines(jm, tm, prefix_cache=1.0)
    assert eng.prefix_cache.budget_slots == 2
    got = _same_as_jax(jeng, eng, [[a, b], later])
    assert got[2:] == _cold(tm, later)
    assert eng.stats()['requeued'] >= 1
    assert eng.stats()['prefix_cache']['evictions'] >= 1


def test_speculation_with_a_draft_matches_jax(models, drafts):
    jm, tm = models
    jd, td = drafts
    prompts = _prompts([4, 13, 7, 21, 9], seed=4)
    kw = dict(num_slots=3, max_length=64, decode_block=2,
              num_draft_tokens=3)
    jeng = JaxEngine(jm, draft_model=jd, **kw)
    eng = InferenceEngine(tm, draft_model=td, **kw)
    _same_as_jax(jeng, eng, [prompts], new=10)
    assert eng.stats()['spec']['rounds'] > 0
    plain = [h.tokens for h in InferenceEngine(
        tm, num_slots=3, max_length=64).generate_many(
            prompts, SamplingParams(max_new_tokens=10,
                                    eos_token_id=NO_EOS))]
    assert [h.tokens for h in eng.generate_many(
        prompts, SamplingParams(max_new_tokens=10,
                                eos_token_id=NO_EOS))] == plain


def _bank(tm):
    bank = AdapterBank(tm, capacity=3, rank=4, targets=TARGETS)
    for i in range(2):
        bank.load(f'ad{i}', make_adapter_factors(bank, seed=1 + i,
                                                 scale=0.2), version=1)
    return bank


def _jax_bank(jm):
    bank = JaxBank(jm, capacity=3, rank=4, targets=TARGETS)
    for i in range(2):
        bank.load(f'ad{i}', jax_factors(bank, seed=1 + i, scale=0.2),
                  version=1)
    return bank


def test_adapters_match_jax(models):
    """Base and two adapters mixed in one batch, with the prefix cache:
    each adapter's prompts hit only its own namespace."""
    jm, tm = models
    rng = np.random.RandomState(5)
    sysp = _rand(24, rng)
    prompts = [sysp + _rand(n, rng) for n in (3, 8, 5, 6)]
    ids = [None, 'ad0', 'ad1', 'ad0']
    jeng, eng = _engines(jm, tm, _jax_bank(jm), _bank(tm), prefix_cache=0.7,
                         prefill_chunk_tokens=16)
    want, got = [], []
    for _ in range(2):
        want += [h.tokens for h in jeng.generate_many(
            prompts, JaxParams(max_new_tokens=6, eos_token_id=NO_EOS),
            adapter_ids=ids)]
        got += [h.tokens for h in eng.generate_many(
            prompts, SamplingParams(max_new_tokens=6, eos_token_id=NO_EOS),
            adapter_ids=ids)]
    assert got == want
    _stats_equal(eng, jeng)
    assert got[0] != got[1] != got[2]
    assert eng.stats()['adapters']['pinned'] == 0


def test_drain_evict_all_and_swap_match_jax(models):
    jm, tm = models
    tm2 = from_jax_state({k: np.asarray(v.numpy())
                          for k, v in jm.state_dict().items()},
                         LlamaForCausalLM(LlamaConfig.tiny(
                             num_key_value_heads=2), device='cpu'))
    jeng, eng = _engines(jm, tm2, num_slots=2, prefix_cache=0.5,
                         prefill_chunk_tokens=8)
    prompts = _prompts([5, 20, 7], seed=6)
    sp = [(JaxParams(max_new_tokens=5, eos_token_id=NO_EOS),
           SamplingParams(max_new_tokens=5, eos_token_id=NO_EOS))]
    hj = [jeng.submit(p, sp[0][0]) for p in prompts]
    ht = [eng.submit(p, sp[0][1]) for p in prompts]
    jeng.step(), eng.step()
    assert jeng.drain() and eng.drain()
    assert [h.tokens for h in ht] == [h.tokens for h in hj]
    assert all(h.status == FINISHED for h in ht)
    with pytest.raises(RuntimeError, match='draining'):
        eng.submit([1, 2], max_new_tokens=2)
    _stats_equal(eng, jeng)
    # evict_all hands accepted requests back and frees their slots
    fresh = InferenceEngine(tm2, num_slots=2, max_length=96,
                            decode_block=2)
    hs = [fresh.submit(p, max_new_tokens=8, eos_token_id=NO_EOS)
          for p in prompts]
    fresh.step()
    out = fresh.evict_all()
    assert sorted(h.request_id for h in out) == sorted(
        h.request_id for h in hs)
    assert fresh.pool.free_count == 2 and not fresh.has_work
    # a swap to other weights gives a fresh engine's tokens on them, and
    # a restore the old ones
    other = _pair(1234)[1]
    before = _cold(tm2, prompts, num_slots=2)
    prev = fresh.swap_weights(other.state_dict(), version=1)
    assert _serve(fresh, SamplingParams, [prompts]) == _cold(
        other, prompts, num_slots=2)
    fresh.restore_weights(prev)
    assert _serve(fresh, SamplingParams, [prompts]) == before


def test_request_failure_is_request_level_like_jax(models):
    """The second host->device staging fails fatally: that request fails
    alone in both engines, its slot is freed, and the engine serves on."""
    from paddle_tpu.resilience import RetryPolicy as JaxPolicy
    from paddle_tpu_torch.resilience import RetryPolicy
    jm, tm = models
    prompts = _prompts([4, 6, 5], seed=7)
    results = []
    for mod, cls, m, exc, policy, params in (
            (jax_engine_mod, JaxEngine, jm, JaxFatal, JaxPolicy, JaxParams),
            (engine_mod, InferenceEngine, tm, FatalError, RetryPolicy,
             SamplingParams)):
        eng = cls(m, num_slots=2, max_length=64, decode_block=2,
                  retry_policy=policy(max_retries=2, base_delay=0.0))
        orig, calls = mod._to_device, [0]

        def flaky(*a, _orig=orig, _calls=calls, _exc=exc, **k):
            _calls[0] += 1
            if _calls[0] == 2:
                raise _exc('injected device loss')
            return _orig(*a, **k)
        mod._to_device = flaky
        try:
            hs = [eng.submit(p, params(max_new_tokens=4,
                                       eos_token_id=NO_EOS))
                  for p in prompts]
            eng.run()
        finally:
            mod._to_device = orig
        results.append(([h.status for h in hs], [h.tokens for h in hs],
                        eng.pool.free_count, eng.stats()['failed']))
    assert results[1][0] == [FINISHED, FAILED, FINISHED]
    assert results[1] == results[0]


def test_row_end_beside_a_live_neighbour(models, drafts):
    """A request that ends exactly at the slot's end (the last round runs
    past it; plain decode clamps at max_length - 1, the verify of a
    speculating engine keeps k rows of headroom) beside a live neighbour
    in the next row: the neighbour's tokens equal its tokens alone, and
    both equal the JAX engine's."""
    jm, tm = models
    jd, td = drafts
    rng = np.random.RandomState(8)
    for draft, k in ((None, 0), ((jd, td), 3)):
        kw = dict(num_slots=2, max_length=32, decode_block=3)
        extra = {} if draft is None else dict(num_draft_tokens=k)
        first = [_rand(20, rng), _rand(6, rng)]
        news = [32 - 20 - k, 20]
        jeng = JaxEngine(jm, draft_model=None if draft is None else
                         draft[0], **kw, **extra)
        eng = InferenceEngine(tm, draft_model=None if draft is None else
                              draft[1], **kw, **extra)
        hj = jeng.generate_many(first, [JaxParams(max_new_tokens=n,
                                                  eos_token_id=NO_EOS)
                                        for n in news])
        ht = eng.generate_many(first, [SamplingParams(max_new_tokens=n,
                                                      eos_token_id=NO_EOS)
                                       for n in news])
        assert [h.tokens for h in ht] == [h.tokens for h in hj]
        alone = InferenceEngine(tm, num_slots=2, max_length=32).generate_many(
            first[1:], SamplingParams(max_new_tokens=20,
                                      eos_token_id=NO_EOS))
        assert ht[1].tokens == alone[0].tokens


def test_sampling_is_held_to_its_seed(models):
    _, tm = models
    prompts = _prompts([5, 9, 12], seed=9)
    sp = [SamplingParams(max_new_tokens=8, strategy=SAMPLING,
                         temperature=0.9, top_p=0.95, top_k=40, seed=s,
                         eos_token_id=NO_EOS) for s in (1, 2, 3)]

    def run(ps, sps, n=3):
        eng = InferenceEngine(tm, num_slots=n, max_length=64,
                              decode_block=3)
        return [h.tokens for h in eng.generate_many(ps, sps)]
    a = run(prompts, sp)
    assert a == run(prompts, sp)
    assert run(prompts[1:2], sp[1:2], n=1)[0] == a[1]
