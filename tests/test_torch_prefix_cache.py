"""The port's prefix cache and chunked prefill (paddle_tpu_torch/serving)
against the JAX package's, on the CPU.

The trie: one sequence of operations (retire a prompt into the cache,
look up, pin, unpin, evict, move the weight version, clear) runs
against the JAX `PagedPrefixCache` over the JAX `PagedSlotPool` and
against the port's over the port's pool; every lookup's result, every
`stats()` and the pool's free pages must be equal after each step. The
cases mirror the trie's unit tests in tests/test_prefix_cache.py (row
mode there; both caches here are the paged ones the engines use).

The engine: the port's `InferenceEngine(prefix_cache=,
prefill_chunk_tokens=)` against the JAX engine with `kv_page_size` set
over the tiny GQA Llama (weights carried by `from_jax_state`): greedy
tokens identical, and the hit, reused-token, chunk-round, COW-split and
page counters equal, on a shared-prefix trace, a full-prompt hit, a
tail-shifted window, page pressure and two adapters.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.serving import AdapterBank as JaxBank
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import PagedPrefixCache as JaxPagedCache
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu.serving import kv_pool as jpool
from paddle_tpu.serving import make_adapter_factors as jax_factors
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import (FINISHED, AdapterBank, InferenceEngine,
                                      PagedPrefixCache, PagedSlotPool,
                                      RadixPrefixCache, SamplingParams,
                                      make_adapter_factors)
from paddle_tpu_torch.weights import from_jax_state

NO_EOS = -1
TARGETS = ('q_proj', 'k_proj', 'v_proj', 'o_proj')


@pytest.fixture(autouse=True, scope='module')
def _reset_jax_metrics():
    """The JAX engine and cache record into the JAX package's
    process-global metrics registry; zero it after this module so later
    test files in the same process start from a clean registry."""
    yield
    jax_metrics.get_registry().reset()


# ---------------------------------------------------------------------------
# the trie, op for op against the JAX cache
# ---------------------------------------------------------------------------

class _JaxKV:
    """The JAX pool's init_cache contract: one layer of [B, L, H, D]."""

    def init_cache(self, batch, length, dtype=None):
        shape = (batch, length, 2, 4)
        return ((jnp.zeros(shape), jnp.zeros(shape)),)


@pytest.fixture(scope='module')
def kv_model():
    return LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                            device='cpu')


def _toks(n, base):
    return [base + i % 7 for i in range(n)]


SYS = _toks(32, 10)              # two whole pages
# (op, *args): 'retire' tokens ns -> alloc, reserve, insert, free (the
# engine's retirement); 'lookup' tokens ns; 'pin' key tokens ns -> lookup
# then acquire; 'unpin' key; 'evict'; 'version' v; 'clear' force
TRIE_CASES = {
    'insert_then_lookup': [
        ('retire', _toks(40, 1), None), ('lookup', _toks(40, 1) + [9], None),
        ('lookup', [5, 5], None)],
    'common_prefix_serves_a_diverging_prompt': [
        ('retire', SYS + [100, 101, 102], None),
        ('lookup', SYS + [200, 201], None), ('lookup', SYS[:20], None),
        ('lookup', [99] * 20, None)],
    'edge_split_and_exact_cover_dedup': [
        ('retire', SYS + _toks(16, 50), None),
        ('retire', SYS, None),                    # covered: not retained
        ('retire', SYS + _toks(16, 70), None),    # splits the edge
        ('lookup', SYS + _toks(16, 50), None),
        ('lookup', SYS + _toks(16, 70) + [3], None)],
    'below_one_page_is_not_held': [
        ('retire', _toks(9, 4), None), ('lookup', _toks(9, 4), None)],
    'lru_eviction_under_budget_pressure': [
        ('retire', _toks(48, 1), None), ('retire', _toks(48, 2), None),
        ('lookup', _toks(48, 1), None),           # refresh: 2 is the LRU
        ('retire', _toks(48, 3), None),           # 9 pages > budget 8
        ('lookup', _toks(48, 2), None), ('lookup', _toks(48, 1), None),
        ('lookup', _toks(48, 3), None)],
    'pinned_entry_survives_pressure': [
        ('retire', _toks(32, 1), None), ('pin', 'a', _toks(32, 1), None),
        ('evict',), ('retire', _toks(64, 2), None),
        ('retire', _toks(64, 3), None), ('evict',), ('unpin', 'a'),
        ('evict',), ('evict',)],
    'hit_after_evict_and_repopulate': [
        ('retire', _toks(32, 4), None), ('evict',),
        ('lookup', _toks(32, 4), None), ('retire', _toks(32, 4), None),
        ('lookup', _toks(32, 4) + [8], None)],
    'stale_entries_never_match_and_reclaim_lazily': [
        ('retire', _toks(32, 1), None), ('version', 2),
        ('lookup', _toks(32, 1), None), ('lookup', _toks(32, 1), None)],
    'fresh_insert_supersedes_stale': [
        ('retire', _toks(32, 1), None), ('version', 2),
        ('retire', _toks(32, 1), None), ('lookup', _toks(32, 1), None)],
    'rollback_revalidates_survivors': [
        ('version', 1), ('retire', _toks(32, 1), None), ('version', 2),
        ('lookup', [9, 9], None), ('version', 1),
        ('lookup', _toks(32, 1), None)],
    'pressure_prefers_stale': [
        ('retire', _toks(32, 1), None), ('version', 2),
        ('retire', _toks(32, 5), None), ('evict',),
        ('lookup', _toks(32, 5), None)],
    'pinned_stale_survives_until_released': [
        ('retire', _toks(32, 1), None), ('pin', 'a', _toks(32, 1), None),
        ('version', 2), ('lookup', _toks(32, 1), None), ('evict',),
        ('unpin', 'a'), ('evict',)],
    'namespaces_never_share': [
        ('retire', SYS, None), ('retire', SYS, ('ad0', 1)),
        ('lookup', SYS, ('ad1', 1)), ('lookup', SYS, ('ad0', 2)),
        ('lookup', SYS + [1], ('ad0', 1)), ('lookup', SYS + [1], None),
        ('retire', SYS, ('ad1', 1)), ('lookup', SYS, ('ad1', 1))],
    'clear_force_drops_pinned_entries': [
        ('retire', _toks(32, 1), None), ('retire', _toks(32, 2), None),
        ('pin', 'a', _toks(32, 1), None), ('clear', False),
        ('clear', True), ('unpin', 'a'), ('lookup', _toks(32, 1), None)],
}


def _run_trie(pool, cache, ops):
    """Apply `ops` to (pool, cache); returns one reading per step."""
    pinned, log = {}, []
    for op, *args in ops:
        if op == 'retire':
            tokens, ns = args
            slot = pool.alloc()
            pool.reserve(slot, len(tokens))
            res = cache.insert(tokens, slot, namespace=ns)
            pool.free(slot)
        elif op in ('lookup', 'pin'):
            tokens, ns = args[-2:]
            node, matched = cache.lookup(tokens, namespace=ns)
            res = (matched, None if node is None else node.kv_len,
                   None if node is None else len(node.slot.pages))
            if op == 'pin':
                cache.acquire(node)
                pinned[args[0]] = node
        elif op == 'unpin':
            cache.release(pinned.pop(args[0]))
            res = None
        elif op == 'evict':
            res = cache.evict_lru()
        elif op == 'version':
            cache.set_version(args[0])
            res = None
        else:
            cache.clear(force=args[0])
            res = None
        log.append((op, res, cache.stats(), pool.free_page_count,
                    pool.stats()['holds_live']))
    return log


@pytest.mark.parametrize('case', sorted(TRIE_CASES))
def test_trie_matches_jax_op_for_op(kv_model, case):
    jp = jpool.PagedSlotPool(_JaxKV(), 4, 64, page_size=16)
    tp = PagedSlotPool(kv_model, 4, 64, page_size=16)
    want = _run_trie(jp, JaxPagedCache(jp, 0.5), TRIE_CASES[case])
    got = _run_trie(tp, PagedPrefixCache(tp, 0.5), TRIE_CASES[case])
    assert got == want


def test_snapshot_and_budget_match_jax(kv_model):
    jp = jpool.PagedSlotPool(_JaxKV(), 4, 64, page_size=16, num_pages=9)
    tp = PagedSlotPool(kv_model, 4, 64, page_size=16, num_pages=9)
    jc, tc = JaxPagedCache(jp, 1.0), PagedPrefixCache(tp, 1.0)
    assert tc.budget_pages == jc.budget_pages == 4   # 8 - one slot's 4
    for pool, cache in ((jp, jc), (tp, tc)):
        _run_trie(pool, cache, [('retire', _toks(40, 1), None)])
    assert tc.snapshot() == jc.snapshot()
    assert tc.held_pages == 2 and tc.reclaimable_pages == 2


# the reference's refused insert (paddle_tpu/serving/prefix_cache.py:
# 322-376, the port's copy at serving/prefix_cache.py:277): with every
# entry pinned, B's insert walks and splits the trie, is refused (6
# pages > the budget of 4) and leaves its new leaf with no owner; the
# later lookup(B) descends into that bare leaf and misses the 32 shared
# tokens cached beside it, also after a forced clear and A retired
# again. Both caches must give the same readings, so that a fix on
# either side shows here.
A_TOKENS, B_TOKENS = SYS + _toks(16, 50), SYS + _toks(16, 70)
REFUSED_INSERT = [
    ('retire', A_TOKENS, None), ('pin', 'a', A_TOKENS, None),
    ('retire', B_TOKENS, None), ('unpin', 'a'), ('lookup', B_TOKENS, None),
    ('clear', True), ('retire', A_TOKENS, None), ('lookup', B_TOKENS, None),
    ('clear', True), ('lookup', A_TOKENS, None)]


def test_refused_insert_leaves_the_same_trie_as_jax(kv_model):
    jp = jpool.PagedSlotPool(_JaxKV(), 4, 64, page_size=16, num_pages=9)
    tp = PagedSlotPool(kv_model, 4, 64, page_size=16, num_pages=9)
    jc, tc = JaxPagedCache(jp, 1.0), PagedPrefixCache(tp, 1.0)
    want = _run_trie(jp, jc, REFUSED_INSERT)
    got = _run_trie(tp, tc, REFUSED_INSERT)
    assert got == want
    assert tc.snapshot() == jc.snapshot()
    assert tc.budget_pages == jc.budget_pages == 4


def test_forced_clear_frees_pages_in_lru_order(kv_model):
    """`clear(force=True)` releases its entries least recently used
    first, pinned ones included: the pool's free list comes out in the
    order an LRU clear gives, whatever the objects' ids (int8 pages keep
    stale rows that the next occupant requantizes, so which page a
    request reuses must not vary from run to run)."""
    orders = []
    for force in (True, False):
        tp = PagedSlotPool(kv_model, 4, 64, page_size=16, num_pages=13)
        tc = PagedPrefixCache(tp, 1.0)
        _run_trie(tp, tc, [('retire', _toks(32, 3), None),
                           ('retire', _toks(32, 1), None),
                           ('retire', _toks(32, 2), None),
                           ('lookup', _toks(32, 3), None)])
        tc.clear(force=force)
        assert tp.free_page_count == tp.num_pages - 1
        orders.append(list(tp._free_pages))
    assert orders[0] == orders[1]


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def models():
    paddle.seed(11)
    jm = jllama.LlamaForCausalLM(
        jllama.LlamaConfig.tiny(num_key_value_heads=2)).eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = from_jax_state(state, LlamaForCausalLM(
        LlamaConfig.tiny(num_key_value_heads=2), device='cpu'))
    return jm, tm


def _rand(n, rng):
    return rng.randint(1, 128, (n,)).tolist()


def _engines(jm, tm, jbank=None, bank=None, **kw):
    kw = {'num_slots': 3, 'max_length': 96, 'decode_block': 2,
          'kv_page_size': 16, 'prefix_cache': 0.5,
          'prefill_chunk_tokens': 16, **kw}
    return (JaxEngine(jm, adapter_bank=jbank, **kw),
            InferenceEngine(tm, adapter_bank=bank, **kw))


def _serve(eng, params_cls, waves, new=6, adapter_ids=None):
    """Each wave through `generate_many` (a cache inserts at retirement,
    so a later wave hits what an earlier one retired); returns the
    tokens of every request in order."""
    out = []
    for wave in waves:
        out += [h.tokens for h in eng.generate_many(
            wave, params_cls(max_new_tokens=new, eos_token_id=NO_EOS),
            adapter_ids=adapter_ids)]
    return out


def _counters(eng):
    st = eng.stats()
    pc, pool = st.get('prefix_cache', {}), st['pool']
    return dict(
        prefills=st['prefills'], prefill_tokens=st['prefill_tokens'],
        chunked_prefills=st['chunked_prefills'],
        chunk_rounds=st['chunk_rounds'],
        **{k: pc.get(k) for k in ('hits', 'misses', 'tokens_reused',
                                  'inserts', 'evictions', 'held_pages',
                                  'retained_slots')},
        **{k: pool[k] for k in ('cow_splits', 'holds_live', 'used_pages',
                                'shared_pages', 'free_pages')})


def _same_as_jax(jeng, eng, waves, **kw):
    want = _serve(jeng, JaxParams, waves, **kw)
    got = _serve(eng, SamplingParams, waves, **kw)
    assert got == want
    assert _counters(eng) == _counters(jeng)
    return got


def _cold(tm, prompts, new=6, **kw):
    """The same prompts on an engine without cache or chunking."""
    kw = {'num_slots': 3, 'max_length': 96, 'decode_block': 2,
          'kv_page_size': 16, **kw}
    return [h.tokens for h in InferenceEngine(tm, **kw).generate_many(
        prompts, SamplingParams(max_new_tokens=new, eos_token_id=NO_EOS))]


def _all_pages_free_after_clear(eng):
    eng.prefix_cache.clear(force=True)
    pool = eng.pool
    assert pool.free_page_count == pool.num_pages - 1
    assert pool.stats()['holds_live'] == 0


def test_shared_prefix_trace_matches_jax(models):
    """A 20-token system prompt behind suffixes of 3..30 tokens and one
    cold 50-token prompt (four chunk rounds): the first wave seeds the
    cache, the second hits it at one whole page and prefills the rest in
    chunks."""
    jm, tm = models
    rng = np.random.RandomState(0)
    sysp = _rand(20, rng)
    wave = [sysp + _rand(n, rng) for n in (3, 12, 5, 30, 9)] + [_rand(50, rng)]
    jeng, eng = _engines(jm, tm)
    got = _same_as_jax(jeng, eng, [wave[:1], wave])
    assert got[1:] == _cold(tm, wave)
    st = eng.stats()
    assert st['prefix_cache']['hits'] >= 5 and st['chunk_rounds'] > 0
    assert st['prefills'] == 0 and st['chunked_prefills'] == 7
    _all_pages_free_after_clear(eng)


def test_full_prompt_hit_copies_on_write_like_jax(models):
    """A 32-token prompt (two whole pages) served twice: the second time
    every token is cached, nothing is prefilled, and the page of the
    last prompt row is split off before its re-forward."""
    jm, tm = models
    prompt = _rand(32, np.random.RandomState(1))
    jeng, eng = _engines(jm, tm)
    got = _same_as_jax(jeng, eng, [[prompt], [prompt]])
    assert got[0] == got[1] == _cold(tm, [prompt])[0]
    st = eng.stats()
    assert st['pool']['cow_splits'] == 1
    assert st['prefix_cache']['hits'] == 1
    assert st['prefix_cache']['tokens_reused'] == 32
    assert st['prefill_tokens'] == 32            # the first serve only
    _all_pages_free_after_clear(eng)


def test_tail_shifted_window_matches_jax(models):
    """max_length 64, default buckets: a cached 20-token prompt holds one
    page (cursor 16); a 56-token prompt on it has a 40-token suffix at
    bucket 64, so its window starts at 0, not 16, and re-forwards the
    shared page's rows, whose writes the floor (16) sends to the null
    page: the shared page keeps its bytes."""
    jm, tm = models
    rng = np.random.RandomState(2)
    first = _rand(20, rng)
    second = first + _rand(36, rng)
    jeng, eng = _engines(jm, tm, max_length=64, prefill_chunk_tokens=None)
    _serve(jeng, JaxParams, [[first]], new=4)
    _serve(eng, SamplingParams, [[first]], new=4)
    hold = next(iter(eng.prefix_cache._owners)).slot
    shared = [(k[hold.pages[0]].clone(), v[hold.pages[0]].clone())
              for k, v in eng.pool.pages]
    got = _same_as_jax(jeng, eng, [[second]], new=4)
    for (k, v), (k0, v0) in zip(eng.pool.pages, shared):
        assert k[hold.pages[0]].equal(k0) and v[hold.pages[0]].equal(v0)
    assert got == _cold(tm, [second], new=4, max_length=64)
    st = eng.stats()
    assert st['chunk_rounds'] == 1 and st['prefill_tokens'] == 20 + 40
    _all_pages_free_after_clear(eng)


def test_page_pressure_evicts_holds_then_requeues_like_jax(models):
    """12 usable pages, requests of 4-5 pages each: retained holds yield
    their pages to admissions, and admission requeues when even that is
    not enough; tokens and counters equal the JAX engine's."""
    jm, tm = models
    rng = np.random.RandomState(3)
    sysp = _rand(32, rng)
    waves = [[sysp + _rand(n, rng) for n in (20, 24, 18)],
             [_rand(40, rng) for _ in range(3)],
             [sysp + _rand(n, rng) for n in (8, 26, 17)]]
    jeng, eng = _engines(jm, tm, kv_pages=13, prefix_cache=0.6)
    _same_as_jax(jeng, eng, waves, new=12)
    st = eng.stats()
    assert st['requeued'] > 0 and st['prefix_cache']['evictions'] > 0
    assert st['completed'] == 9
    _all_pages_free_after_clear(eng)


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


def test_two_adapters_never_share_a_prefix_like_jax(models):
    """The same prompts under ad0 and ad1 (a 32-token shared prefix
    each): every request misses the other adapter's entries, hits its
    own, and gets the tokens it gets served alone on an engine without
    a cache."""
    jm, tm = models
    rng = np.random.RandomState(4)
    sysp = _rand(32, rng)
    prompts = [sysp + _rand(n, rng) for n in (5, 11)]
    jeng, eng = _engines(jm, tm, _jax_bank(jm), _bank(tm))
    want, got = [], []
    for aid in ('ad0', 'ad1', 'ad0', 'ad1'):
        want += _serve(jeng, JaxParams, [prompts], adapter_ids=aid)
        got += _serve(eng, SamplingParams, [prompts], adapter_ids=aid)
    assert got == want
    assert _counters(eng) == _counters(jeng)
    pc = eng.stats()['prefix_cache']
    assert pc['namespaces'] == 2
    # each adapter's first wave misses (ad1's although ad0 retired the
    # same prompts), its second wave hits its own entries
    assert pc['misses'] == 4 and pc['hits'] == 4
    for aid, toks in (('ad0', got[0:2]), ('ad1', got[2:4])):
        alone = InferenceEngine(tm, num_slots=3, max_length=96,
                                decode_block=2, adapter_bank=_bank(tm))
        assert toks == [h.tokens for h in alone.generate_many(
            prompts, SamplingParams(max_new_tokens=6, eos_token_id=NO_EOS),
            adapter_ids=aid)]
    assert got[0] != got[2]                 # the adapters differ
    assert eng.stats()['adapters']['pinned'] == 0
    _all_pages_free_after_clear(eng)


def test_long_prompts_chunk_without_a_cache_like_jax(models):
    """Chunked prefill alone: two 70-token prompts in 16-token chunks
    beside short ones, which decode while the long ones prefill."""
    jm, tm = models
    rng = np.random.RandomState(5)
    prompts = [_rand(70, rng), _rand(6, rng), _rand(70, rng), _rand(9, rng)]
    jeng, eng = _engines(jm, tm, prefix_cache=None)
    got = _same_as_jax(jeng, eng, [prompts], new=10)
    assert got == _cold(tm, prompts, new=10)
    st = eng.stats()
    assert st['chunked_prefills'] == 2 and st['chunk_rounds'] == 10
    assert 'prefix_cache' not in st


def test_engine_validation_matches_jax(models):
    jm, tm = models
    pool = PagedSlotPool(tm, 2, 64, page_size=16)
    for bad in (dict(prefill_chunk_tokens=0),
                dict(prefix_cache=RadixPrefixCache(pool, 0.5)),
                dict(prefix_cache=0.01)):
        with pytest.raises(ValueError):
            InferenceEngine(tm, num_slots=2, max_length=64, **bad)
    for bad in (dict(prefill_chunk_tokens=0), dict(prefix_cache=0.01)):
        with pytest.raises(ValueError):
            JaxEngine(jm, num_slots=2, max_length=64, kv_page_size=16,
                      **bad)
    eng = InferenceEngine(tm, num_slots=2, max_length=64, prefix_cache=True)
    assert eng.prefix_cache.budget_pages == 4          # 0.5 of 8
    h = eng.submit([1, 2, 3], max_new_tokens=2, eos_token_id=NO_EOS)
    eng.run()
    assert h.status == FINISHED and h._prefix_node is None
