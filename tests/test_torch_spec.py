"""Speculative decoding with a draft model in the port
(`InferenceEngine(draft_model=, num_draft_tokens=)`) against the JAX
paged engine's, on the CPU, over the tiny GQA Llama (target, 2 layers)
and an independent 1-layer draft, both carried from JAX by
`from_jax_state`.

- `TestSpeculativeEngine` of tests/test_serving.py, one test per JAX
  test: an independent draft gives the JAX spec engine's tokens and
  plain greedy's; a self-draft's `stats()['spec']` equals the JAX
  engine's; sampling rows are unaffected; eos retires mid-round and frees
  the slot; the headroom is checked at submit; the built steps (the
  port's `traces` on the card) are stable across waves and named as the
  JAX engine's traces.
- One speculation round (`SpecStep`) against the JAX `_paged_spec_fn`
  from the same dirty pages, float and int8, two rounds in a row: equal
  tokens and counts, the target's pages (int8: 1 LSB on <= 0.1% of the
  elements, scales rel 1e-5) and the draft rows of the active slots.
- Tokens and spec counters equal to the JAX engine's with int8 KV, with
  the prefix cache and chunked prefill, and behind an adapter bank.
- The row `SlotPool` against the JAX one, and the draft prefill's row
  against the JAX `_draft_prefill_fn`'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.serving import AdapterBank as JaxBank
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu.serving import kv_pool as jpool
from paddle_tpu.serving import make_adapter_factors as jax_factors
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import (FINISHED, SAMPLING, AdapterBank,
                                      InferenceEngine, SamplingParams,
                                      make_adapter_factors)
from paddle_tpu_torch.serving.kv_pool import SlotPool
from paddle_tpu_torch.weights import from_jax_state
from test_torch_kv_quant import assert_pools_match

NO_EOS = -1
MAX_LEN = 64
TARGETS = ('q_proj', 'k_proj', 'v_proj', 'o_proj')


@pytest.fixture(autouse=True, scope='module')
def _reset_jax_metrics():
    """The JAX engine records into the JAX package's process-global
    metrics registry; zero it after this module."""
    yield
    jax_metrics.get_registry().reset()


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


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, (s,)).tolist() for s in lens]


def _engines(models, self_draft=False, jbank=None, bank=None, **kw):
    jm, tm, jd, td = models
    kw = {'num_slots': 3, 'max_length': MAX_LEN, 'decode_block': 2,
          'kv_page_size': 16, 'num_draft_tokens': 3, **kw}
    return (JaxEngine(jm, draft_model=jm if self_draft else jd,
                      adapter_bank=jbank, **kw),
            InferenceEngine(tm, draft_model=tm if self_draft else td,
                            adapter_bank=bank, **kw))


def _all_pages_free(pool):
    return pool.free_page_count == pool.num_pages - 1


def _run_both(jeng, eng, prompts, n_new, eos=NO_EOS, adapter_ids=None):
    hj = jeng.generate_many(prompts, JaxParams(max_new_tokens=n_new,
                                               eos_token_id=eos),
                            adapter_ids=adapter_ids)
    ht = eng.generate_many(prompts, SamplingParams(max_new_tokens=n_new,
                                                   eos_token_id=eos),
                           adapter_ids=adapter_ids)
    assert all(h.status == FINISHED for h in ht)
    return [h.tokens for h in hj], [h.tokens for h in ht]


def _plain_greedy(models, prompts, n_new, **kw):
    """The JAX plain paged engine's greedy tokens (no draft)."""
    kw = {'num_slots': 3, 'max_length': MAX_LEN, 'decode_block': 2,
          'kv_page_size': 16, **kw}
    return [h.tokens for h in JaxEngine(models[0], **kw).generate_many(
        prompts, JaxParams(max_new_tokens=n_new, eos_token_id=NO_EOS))]


# ---------------------------------------------------------------------------
# tests/test_serving.py::TestSpeculativeEngine, one test per JAX test
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kv_quant', [None, 'int8'])
def test_independent_draft_gives_jax_spec_and_plain_greedy_tokens(
        models, kv_quant):
    """The exactness guarantee: a draft that almost never agrees leaves
    greedy outputs equal to plain greedy's, and to the JAX spec engine's,
    with the same spec counters (float and int8 KV)."""
    prompts = _prompts([4, 9, 6, 20], seed=41)
    jeng, eng = _engines(models, kv_quant=kv_quant)
    want, got = _run_both(jeng, eng, prompts, 7)
    assert got == want == _plain_greedy(models, prompts, 7,
                                        kv_quant=kv_quant)
    sp = eng.stats()['spec']
    assert sp == jeng.stats()['spec']
    assert sp['rounds'] > 0 and sp['proposed'] > 0
    assert eng.stats()['decode_steps'] == sp['rounds']
    assert _all_pages_free(eng.pool)


def test_self_draft_spec_stats_equal_jax(models):
    """Draft == target: near-total acceptance, far fewer rounds than
    tokens; the counters equal the JAX engine's."""
    prompts = _prompts([5, 8], seed=43)
    jeng, eng = _engines(models, self_draft=True, num_slots=2,
                         num_draft_tokens=4)
    want, got = _run_both(jeng, eng, prompts, 12)
    assert got == want == _plain_greedy(models, prompts, 12, num_slots=2)
    sp = eng.stats()['spec']
    assert sp == jeng.stats()['spec']
    assert sp['rounds'] <= 8 and sp['acceptance_rate'] > 0.5


def test_sampling_rows_unaffected_by_speculation(models):
    """A sampling request draws one token a round from the verify's first
    row with its own generator: same seed, same tokens, and the tokens of
    the plain engine; a greedy neighbour still gets plain greedy's."""
    _, tm, _, _ = models
    prompt = _prompts([6], seed=45)[0]
    sp = dict(max_new_tokens=8, strategy=SAMPLING, temperature=1.4,
              top_k=24, eos_token_id=NO_EOS)
    eng = InferenceEngine(tm, num_slots=3, max_length=MAX_LEN,
                          draft_model=tm, num_draft_tokens=3, kv_page_size=16)
    h1 = eng.submit(prompt, SamplingParams(seed=7, **sp))
    h2 = eng.submit(prompt, SamplingParams(seed=7, **sp))
    h3 = eng.submit(prompt, SamplingParams(max_new_tokens=8,
                                           eos_token_id=NO_EOS))
    eng.run()
    assert h1.tokens == h2.tokens and len(h1.tokens) == 8
    assert h3.tokens == _plain_greedy(models, [prompt], 8)[0]
    plain = InferenceEngine(tm, num_slots=3, max_length=MAX_LEN,
                            kv_page_size=16)
    assert plain.generate_many(
        [prompt], SamplingParams(seed=7, **sp))[0].tokens == h1.tokens


def test_eos_retires_mid_round_like_jax(models):
    prompt = _prompts([6], seed=47)[0]
    ref = _plain_greedy(models, [prompt], 10)[0]
    eos = ref[3]
    jeng, eng = _engines(models, self_draft=True, num_slots=2,
                         num_draft_tokens=4)
    want, got = _run_both(jeng, eng, [prompt], 10, eos=eos)
    assert got == want == [ref[:ref.index(eos) + 1]]
    assert eng.pool.free_count == 2 and _all_pages_free(eng.pool)
    assert eng.stats()['spec'] == jeng.stats()['spec']


def test_a_fully_accepted_round_leaves_the_last_draft_row_unwritten(models):
    """The reference's draft loop writes the draft's KV for [pending, d_1
    .. d_(k-1)] only (`paddle_tpu/serving/engine.py:819-829`): after a
    round that accepts all k drafts, the row of d_k is never written and
    stays in the draft's context, so later proposals see it. The port
    keeps this (its spec counters equal the JAX engine's); a self-draft's
    acceptance pays for it (ROADMAP Queue 3)."""
    prompt = _prompts([6], seed=53)[0]
    k = 4
    jeng, eng = _engines(models, self_draft=True, num_slots=1,
                         num_draft_tokens=k)
    hj = jeng.submit(prompt, JaxParams(max_new_tokens=12,
                                       eos_token_id=NO_EOS))
    ht = eng.submit(prompt, SamplingParams(max_new_tokens=12,
                                           eos_token_id=NO_EOS))
    pos = len(prompt) - 1                     # the pending token's row
    for e in (jeng, eng):
        e.step()
        e.step()
    assert ht.tokens == hj.tokens
    assert eng.stats()['spec'] == jeng.stats()['spec']
    assert len(ht.tokens) > k + 1             # the first round took all k
    jrow = np.asarray(_leaves(jeng.draft_pool.row(0))[0][0])
    trow = eng.draft_pool.row(0)[0][0].numpy()
    for row in (jrow, trow):
        assert row[0, pos:pos + k].any(axis=(1, 2)).all()
        assert not row[0, pos + k].any()      # d_k's row: never written
        assert row[0, pos + k + 1].any()      # the next pending token's
    np.testing.assert_allclose(trow, jrow, rtol=1e-5, atol=1e-5)


def test_spec_headroom_validated_at_submit(models):
    jm, tm, _, _ = models
    msgs = []
    for cls, m, params in ((JaxEngine, jm, JaxParams),
                           (InferenceEngine, tm, SamplingParams)):
        eng = cls(m, num_slots=2, max_length=32, kv_page_size=16,
                  draft_model=m, num_draft_tokens=4)
        with pytest.raises(ValueError, match='speculation headroom') as e:
            eng.submit(list(range(1, 21)), params(max_new_tokens=10))
        msgs.append(str(e.value))
        # the same request fits an engine that does not speculate
        cls(m, num_slots=2, max_length=32, kv_page_size=16).submit(
            list(range(1, 21)), params(max_new_tokens=10))
    assert msgs[0] == msgs[1]


def test_built_steps_stable_across_waves_and_named_like_jax_traces(models):
    """The port builds (and on the card captures) one speculation round
    and one draft prefill per bucket, named as the JAX engine's traces;
    a second wave builds nothing."""
    # the JAX program store shares programs between engines of equal
    # geometry: a fresh store traces (and counts) every program here
    paddle.programs.get_store().clear_memory()
    jeng, eng = _engines(models, num_slots=2)
    sp = 4
    _run_both(jeng, eng, _prompts([3, 9, 6], seed=49), sp)
    steps = dict(eng._prefill_steps)
    built = {eng._decode_name} | {s.name for s in steps.values()}
    assert built == set(jeng.stats()['traces'])
    assert 'paged_spec_decode_k3' in built and 'draft_prefill_8' in built
    _run_both(jeng, eng, _prompts([4, 8, 5], seed=50), sp)
    assert eng._prefill_steps == steps
    assert eng.stats()['traces'] == {}          # nothing captured on the CPU


def test_ctor_validation_matches_jax(models):
    jm, tm, jd, td = models
    for cls, m in ((JaxEngine, jm), (InferenceEngine, tm)):
        with pytest.raises(ValueError, match='num_draft_tokens'):
            cls(m, max_length=MAX_LEN, kv_page_size=16, draft_model=m,
                num_draft_tokens=0)
    short = {}
    for cls, m, d in ((JaxEngine, jm, jd), (InferenceEngine, tm, td)):
        d.config.max_position_embeddings = 32
        try:
            with pytest.raises(ValueError, match='DRAFT') as e:
                cls(m, max_length=MAX_LEN, kv_page_size=16, draft_model=d)
        finally:
            d.config.max_position_embeddings = 256
        short[cls] = str(e.value)
    assert short[JaxEngine] == short[InferenceEngine]


# ---------------------------------------------------------------------------
# one speculation round against the JAX _paged_spec_fn
# ---------------------------------------------------------------------------

# per slot (position, active, eos): a span inside one page, a span that
# crosses a page boundary (14 .. 18), a span that reaches the slot's last
# row, and an inactive slot parked at the last row
ROUND_SLOTS = ((5, True, NO_EOS), (14, True, 7), (59, True, NO_EOS),
               (63, False, NO_EOS))
K_ROUND = 4


def _leaves(tree):
    return jax.tree_util.tree_flatten(tree)


class _SpecPair:
    """A JAX and a port spec engine (k = 4, independent draft), every slot
    reserved to the same page table in both, the target pages (and int8
    scales) and the draft rows filled with the same seeded values."""

    def __init__(self, models, quant, seed):
        jm, tm, jd, td = models
        n = len(ROUND_SLOTS)
        kw = dict(num_slots=n, max_length=MAX_LEN, kv_page_size=16,
                  kv_quant=quant, num_draft_tokens=K_ROUND)
        self.jeng = JaxEngine(jm, draft_model=jd, **kw)
        self.eng = InferenceEngine(tm, draft_model=td, **kw)
        for pool in (self.jeng.pool, self.eng.pool):
            for slot in range(n):
                pool.reserve(slot, MAX_LEN)
        assert np.array_equal(self.jeng.pool.page_table,
                              self.eng.pool.page_table)
        rng = np.random.default_rng(seed)
        tp = [t for kv in self.eng.pool.pages for t in kv]
        ts = ([t for kv in self.eng.pool.scales for t in kv]
              if quant else [])
        pages = [rng.integers(-127, 128, tuple(t.shape), dtype=np.int8)
                 if quant else rng.standard_normal(tuple(t.shape)).astype(
                     np.float32) for t in tp]
        scales = [rng.uniform(0.01, 0.1, tuple(t.shape)).astype(np.float32)
                  for t in ts]
        for t, x in zip(tp + ts, pages + scales):
            t.copy_(torch.from_numpy(x))
        jp, js = self.jeng.pool.device_state()
        self.jeng.pool.set_device_state(
            jax.tree_util.tree_unflatten(_leaves(jp)[1],
                                         [jnp.asarray(x) for x in pages]),
            jax.tree_util.tree_unflatten(_leaves(js)[1],
                                         [jnp.asarray(x) for x in scales])
            if quant else js)
        for slot in range(n):
            row = [(rng.standard_normal((1, MAX_LEN, 2, 16)).astype(
                np.float32), rng.standard_normal((1, MAX_LEN, 2, 16)).astype(
                np.float32)) for _ in range(len(self.eng.draft_pool.cache))]
            self.eng.draft_pool.set_row(slot, [
                tuple(torch.from_numpy(x) for x in kv) for kv in row])
            jrow = self.jeng.draft_pool.row(slot)
            self.jeng.draft_pool.set_row(slot, jax.tree_util.tree_unflatten(
                _leaves(jrow)[1], [jnp.asarray(x) for kv in row
                                   for x in kv]))

    def round(self, tok, pos, active, eos):
        """One round of both engines: ((JAX tokens, counts), (port
        tokens, counts))."""
        n = len(tok)
        j = self.jeng
        pages, scales = j.pool.device_state()
        d_params, d_frozen, d_buffers = j._draft_state
        toks, counts, pages, scales, d_pool = j._spec_jit(
            j._params, j._frozen, j._buffers, pages, scales,
            jnp.asarray(j.pool.page_table), d_params, d_frozen, d_buffers,
            j.draft_pool.cache, tok.astype(np.int32), pos.astype(np.int32),
            np.zeros(n, np.int32), active, np.ones(n, np.float32),
            np.zeros(n, np.int32), np.ones(n, np.float32), np.ones(n, bool),
            np.zeros((n, 2), np.uint32), eos.astype(np.int32))
        j.pool.set_device_state(pages, scales)
        j.draft_pool.cache = d_pool
        step = self.eng._decode
        with torch.inference_mode():
            step.stage(tok=tok, pos=pos, active=active,
                       table=np.where(active[:, None],
                                      self.eng.pool.page_table, 0),
                       temp=np.ones(n, np.float32),
                       topk=np.zeros(n, np.int64),
                       topp=np.ones(n, np.float32), eos=eos,
                       greedy=np.ones(n, bool),
                       d_table=self.eng.draft_pool.table)
            got, cnt = step.run(np.zeros(n, bool), [None] * n)
        return ((np.asarray(toks), np.asarray(counts)),
                (got.numpy().copy(), cnt.numpy().copy()))

    def assert_float_pages_match(self):
        jp, _ = self.jeng.pool.device_state()
        for want, got in zip(_leaves(jp)[0],
                             [t for kv in self.eng.pool.pages for t in kv]):
            np.testing.assert_allclose(got.numpy()[1:], np.asarray(want)[1:],
                                       rtol=1e-5, atol=1e-5)

    def assert_draft_rows_match(self, active):
        for slot in np.flatnonzero(active):
            want = _leaves(self.jeng.draft_pool.row(slot))[0]
            got = [t for kv in self.eng.draft_pool.row(slot) for t in kv]
            for w, g in zip(want, got):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('quant', [None, 'int8'])
def test_one_round_writes_the_jax_pages(models, quant):
    pair = _SpecPair(models, quant, seed=3 if quant else 4)
    pos = np.array([p for p, _, _ in ROUND_SLOTS], np.int64)
    active = np.array([a for _, a, _ in ROUND_SLOTS], bool)
    eos = np.array([e for _, _, e in ROUND_SLOTS], np.int64)
    tok = np.random.RandomState(5).randint(1, 128, (len(pos),))
    for _ in range(2):              # the second round on the first's pages
        if quant:
            tp = [t.clone() for kv in pair.eng.pool.pages for t in kv]
            ts = [t.clone() for kv in pair.eng.pool.scales for t in kv]
        (want, wcnt), (got, cnt) = pair.round(tok, pos, active, eos)
        assert np.array_equal(cnt, wcnt)
        assert np.array_equal(got[active], want[active])
        assert (cnt[~active] == 0).all() and (got[~active] == 0).all()
        if quant:
            assert_pools_match(pair.jeng.pool, pair.eng.pool, (tp, ts))
        else:
            pair.assert_float_pages_match()
        pair.assert_draft_rows_match(active)
        c = np.maximum(cnt, 1)
        tok = got[np.arange(len(pos)), c - 1]
        pos = np.where(active, pos + c, pos)
        pos = np.minimum(pos, MAX_LEN - 1 - K_ROUND * active)


# ---------------------------------------------------------------------------
# with the prefix cache and chunks, and behind a bank
# ---------------------------------------------------------------------------

def test_prefix_cache_and_chunks_equal_jax(models):
    """A shared prefix served from the cache (suffix hits in chunks, a
    full hit, a long cold prompt in chunks): tokens, spec counters, hits
    and chunk rounds equal the JAX engine's, and plain greedy's."""
    system = _prompts([32], seed=51)[0]
    tails = _prompts([3, 9, 0, 20], seed=52)
    prompts = [system + t for t in tails] + _prompts([40], seed=53)
    kw = dict(num_slots=3, prefix_cache=0.6, prefill_chunk_tokens=8)
    jeng, eng = _engines(models, **kw)
    _run_both(jeng, eng, [system + [5]], 3)            # the warm-up
    want, got = _run_both(jeng, eng, prompts, 6)
    assert got == want == _plain_greedy(models, prompts, 6)
    st, jst = eng.stats(), jeng.stats()
    assert st['spec'] == jst['spec']
    assert st['chunk_rounds'] == jst['chunk_rounds'] > 0
    for key in ('hits', 'tokens_reused'):
        assert st['prefix_cache'][key] == jst['prefix_cache'][key]
    assert st['prefix_cache']['hits'] >= 3


def _bank(tm, n=2):
    bank = AdapterBank(tm, capacity=n + 1, rank=4, targets=TARGETS)
    for i in range(n):
        bank.load(f'ad{i}', make_adapter_factors(bank, seed=1 + i,
                                                 scale=0.2), version=1)
    return bank


def _jax_bank(jm, n=2):
    bank = JaxBank(jm, capacity=n + 1, rank=4, targets=TARGETS)
    for i in range(n):
        bank.load(f'ad{i}', jax_factors(bank, seed=1 + i, scale=0.2),
                  version=1)
    return bank


def test_behind_a_bank_equals_jax_and_plain(models):
    """tests/test_adapters.py::test_speculative_decode_composes: the
    adapter scope wraps only the verify, so greedy outputs equal plain
    decode's under the same adapters, and the JAX spec engine's."""
    jm, tm, _, _ = models
    prompts = _prompts([5, 7, 6], seed=7)
    ids = ['ad0', None, 'ad1']
    jeng, eng = _engines(models, jbank=_jax_bank(jm), bank=_bank(tm))
    want, got = _run_both(jeng, eng, prompts, 6, adapter_ids=ids)
    plain = InferenceEngine(tm, num_slots=3, max_length=MAX_LEN,
                            decode_block=2, adapter_bank=_bank(tm),
                            kv_page_size=16)
    assert got == want == [h.tokens for h in plain.generate_many(
        prompts, SamplingParams(max_new_tokens=6, eos_token_id=NO_EOS),
        adapter_ids=ids)]
    assert eng.stats()['spec'] == jeng.stats()['spec']
    assert eng.stats()['adapters']['pinned'] == 0


# ---------------------------------------------------------------------------
# the row pool and the draft prefill
# ---------------------------------------------------------------------------

def test_slot_pool_rows_are_pages_and_match_the_jax_pool(models):
    jm, tm, _, _ = models
    jp = jpool.SlotPool(jm, 3, MAX_LEN)
    tp = SlotPool(tm, 3, MAX_LEN, page_size=16)
    assert tp.row_bytes == jp.row_bytes and tp.pool_bytes == jp.pool_bytes
    assert tp.bucket_for(9) == jp.bucket_for(9) == 16
    assert tp.buckets == jp.buckets
    assert tp.table.tolist() == [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]]
    k_pages = tp.pages[0][0]
    assert k_pages.shape == (13, 16, 2, 16)
    row = [(torch.full((1, 20, 2, 16), 1.0 + i), torch.full((1, 20, 2, 16),
                                                            -1.0 - i))
           for i in range(len(tp.cache))]
    tp.cache[0][0][1].fill_(9.0)                     # a dirty row
    tp.set_row(1, row)
    k1 = tp.row(1)[0][0]
    assert k1.data_ptr() == k_pages[5].data_ptr()    # a view of its pages
    assert (k1[0, :20] == 1).all() and not k1[0, 20:].any()
    assert not tp.pages[0][0][0].any()               # the null page
    assert not tp.row(0)[0][0].any() and not tp.row(2)[0][0].any()
    tp.reset_rows()
    assert not any(t.any() for kv in tp.pages for t in kv)


@pytest.mark.parametrize('bucket,s', [(8, 5), (32, 20), (64, 64)])
def test_draft_prefill_row_equals_jax(models, bucket, s):
    """The draft `PrefillStep` of a bucket writes the JAX
    `_draft_prefill_fn`'s row: the prompt's K/V, zeros past the bucket,
    over a dirty row; the other slots' rows untouched."""
    jeng, eng = _engines(models)
    for kv in eng.draft_pool.pages:
        for t in kv:
            t.fill_(3.0)
    prompt = _prompts([s], seed=bucket)[0]
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :s] = prompt
    d_params, d_frozen, d_buffers = jeng._draft_state
    want = _leaves(jeng._draft_prefill_jit(d_params, d_frozen, d_buffers,
                                           jnp.asarray(ids)))[0]
    eng._run_prefill(1, 'draft', prompt, bucket)
    got = [t for kv in eng.draft_pool.row(1) for t in kv]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
        assert not g[0, bucket:].any()
    assert all((t == 3.0).all() for kv in eng.draft_pool.row(0) for t in kv)
    assert eng._prefill_steps[('draft', bucket)].name == \
        f'draft_prefill_{bucket}'
