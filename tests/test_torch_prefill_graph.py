"""The prefill over static buffers (paddle_tpu_torch/serving/
prefill_graph.py) and the flash forward's device key count, on the CPU,
where the prefill runs uncaptured: the code the card captures as one
CUDA graph per (kind, bucket) and replays.

- A whole `PrefillStep` at every bucket writes the pages that the JAX
  engine's `_paged_prefill_fn` writes, from the same pages and table.
- One chunk `PrefillStep`, reused, matches `_paged_chunk_prefill_fn` at
  start 0, at a page-aligned start after an attached prefix, and in a
  tail-shifted window under a floor (the shared page keeps its bytes):
  nothing of an earlier start is frozen in it.
- The plain flash version with `seqused_k` is attention over each
  batch's sliced keys (the JAX `_attention_xla` on them), with the rows
  past the count NaN.
- A step's static buffers keep their storage across calls.
- The buckets the port's engine built steps for are the JAX engine's
  `paged_prefill_<b>` / `paged_chunk_prefill_<b>` trace keys on the same
  requests, with and without the prefix cache.
- A prefill under an adapter, its bank row staged into the step's
  static row, writes the JAX engine's pages.

Inputs come from numpy with a seed; the JAX side runs as
tests/test_torch_prefix_cache.py runs it. Pages are compared to the f32
parity bar of tests/test_torch_engine.py's chunk forward (2e-4), tokens
and trace keys exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.ops.pallas import _attention_xla
from paddle_tpu.programs import get_store
from paddle_tpu.serving import AdapterBank as JaxBank
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu.serving import make_adapter_factors as jax_factors
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.serving import (AdapterBank, InferenceEngine,
                                      SamplingParams, make_adapter_factors)
from paddle_tpu_torch.serving.prefill_graph import PrefillStep
from paddle_tpu_torch.weights import from_jax_state

NO_EOS = -1
TARGETS = ('q_proj', 'k_proj', 'v_proj', 'o_proj')
TOL = 2e-4
MAX_LEN = 64


@pytest.fixture(autouse=True, scope='module')
def _reset_jax_metrics():
    """The JAX engine records into the JAX package's process-global
    metrics registry; zero it after this module."""
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


def _banks(jm, tm):
    jbank = JaxBank(jm, capacity=3, rank=4, targets=TARGETS)
    bank = AdapterBank(tm, capacity=3, rank=4, targets=TARGETS)
    for i in range(2):
        jbank.load(f'ad{i}', jax_factors(jbank, seed=1 + i, scale=0.2),
                   version=1)
        bank.load(f'ad{i}', make_adapter_factors(bank, seed=1 + i,
                                                 scale=0.2), version=1)
    return jbank, bank


class _Pair:
    """A JAX engine and a port engine (2 slots, max_length 64, 16-row
    pages) with one slot reserved in each to the same page table and
    both pools' pages filled with the same seeded values."""

    def __init__(self, jm, tm, seed, banked=False):
        jbank, bank = _banks(jm, tm) if banked else (None, None)
        kw = dict(num_slots=2, max_length=MAX_LEN, kv_page_size=16)
        self.jeng = JaxEngine(jm, adapter_bank=jbank, **kw)
        self.eng = InferenceEngine(tm, adapter_bank=bank, **kw)
        self.slot = 1
        for pool in (self.jeng.pool, self.eng.pool):
            pool.reserve(self.slot, MAX_LEN)
        assert np.array_equal(self.jeng.pool.page_table,
                              self.eng.pool.page_table)
        self.table = self.eng.pool.page_table[self.slot:self.slot + 1]
        self.fill(seed)

    def fill(self, seed):
        rng = np.random.default_rng(seed)
        layers = []
        for k_pages, v_pages in self.eng.pool.pages:
            kv = [rng.standard_normal(tuple(k_pages.shape)).astype(
                np.float32) for _ in range(2)]
            k_pages.copy_(torch.from_numpy(kv[0]))
            v_pages.copy_(torch.from_numpy(kv[1]))
            layers.append(tuple(jnp.asarray(x) for x in kv))
        self.jeng.pool.set_device_state(tuple(layers), ())

    def pin(self, adapter_id):
        """Point the slot's bank row at `adapter_id` in both engines."""
        for eng in (self.jeng, self.eng):
            eng._adapter_rows[self.slot] = eng.adapter_bank.pin(
                adapter_id)[0]

    def jax_whole(self, ids):
        j = self.jeng
        pages, scales = j.pool.device_state()
        pages, _ = j._prefill_jit(j._params, j._frozen, j._buffers, pages,
                                  scales, jnp.asarray(self.table),
                                  jnp.asarray(ids, jnp.int32),
                                  *j._adapter_args(self.slot))
        return pages

    def jax_chunk(self, ids, start, floor):
        j = self.jeng
        pages, scales = j.pool.device_state()
        pages, _ = j._chunk_prefill_jit(
            j._params, j._frozen, j._buffers, pages, scales,
            jnp.asarray(self.table), jnp.asarray(ids, jnp.int32),
            jnp.int32(start), jnp.int32(floor), *j._adapter_args(self.slot))
        return pages

    def port(self, kind, ids, **staged):
        """Run the port engine's (kind, bucket) step the way the engine
        does; returns the step."""
        eng = self.eng
        if eng.adapter_bank is not None:
            staged['rows'] = eng._adapter_rows[self.slot:self.slot + 1]
        with torch.inference_mode():
            step = eng._prefill_step(kind, ids.shape[1])
            step.stage(ids=ids, table=self.table, **staged)
            step.run_once()
        return step

    def assert_pages_equal(self, jax_pages, pad_from=None):
        """Every page but the null page 0 (junk both sides write). With
        `pad_from`, the slot's rows from there to the end of their page
        are left out: the JAX whole prefill writes each touched page from
        a zero slab, so they are zero there, and the port writes only the
        bucket's rows (both are above any live position, where the
        decode lengths mask them until the slot's own decode writes)."""
        ps = self.eng.pool.page_size
        skip = ([] if pad_from is None else
                [(self.table[0, pos // ps], pos % ps)
                 for pos in range(pad_from, -(-pad_from // ps) * ps)])
        for (k, v), (jk, jv) in zip(self.eng.pool.pages, jax_pages):
            for got, want in ((k, jk), (v, jv)):
                got, want = got.numpy().copy(), np.asarray(want).copy()
                for pid, row in skip:
                    got[pid, row] = want[pid, row] = 0
                np.testing.assert_allclose(got[1:], want[1:], rtol=TOL,
                                           atol=TOL)


def _ids(n, bucket, seed):
    ids = np.zeros((1, bucket), np.int64)
    ids[0, :n] = np.random.RandomState(seed).randint(1, 128, (n,))
    return ids


@pytest.mark.parametrize('bucket,n', [(8, 5), (16, 16), (32, 20), (64, 50)])
def test_whole_step_writes_the_pages_of_jax_paged_prefill(models, bucket,
                                                           n):
    jm, tm = models
    pair = _Pair(jm, tm, seed=bucket)
    ids = _ids(n, bucket, seed=n)
    want = pair.jax_whole(ids)
    step = pair.port('whole', ids)
    assert step.name == f'paged_prefill_{bucket}' and step.graph is None
    pair.assert_pages_equal(want, pad_from=bucket)


# (start, floor): a cold first chunk, the chunk after an attached page,
# a tail-shifted window over rows under the floor (their writes go to
# the null page; the chunk still attends them fresh), the last window
CHUNK_CASES = ((0, 0), (16, 16), (16, 32), (32, 32))


def test_one_chunk_step_matches_jax_chunk_prefill_at_every_start(models):
    """One step object of bucket 32 serves every start; each case starts
    from the same seeded pages, and the pages under the floor keep their
    bytes."""
    jm, tm = models
    pair = _Pair(jm, tm, seed=0)
    steps = set()
    for i, (start, floor) in enumerate(CHUNK_CASES):
        pair.fill(seed=0)
        before = [(k.clone(), v.clone()) for k, v in pair.eng.pool.pages]
        ids = _ids(32, 32, seed=i)
        want = pair.jax_chunk(ids, start, floor)
        steps.add(pair.port('chunk', ids, start=start, floor=floor))
        pair.assert_pages_equal(want)
        for (k, v), (k0, v0) in zip(pair.eng.pool.pages, before):
            for pid in pair.table[0, :floor // 16]:
                assert torch.equal(k[pid], k0[pid])
                assert torch.equal(v[pid], v0[pid])
    assert len(steps) == 1 and set(pair.eng._prefill_steps) == {
        ('chunk', 32)}


def test_step_buffers_keep_their_storage_across_calls(models):
    jm, tm = models
    pair = _Pair(jm, tm, seed=1, banked=True)
    pair.pin('ad1')
    step = pair.port('chunk', _ids(9, 16, 0), start=0, floor=0)
    ptrs = {k: t.data_ptr() for k, t in step.buf.items()}
    assert set(ptrs) == {'ids', 'table', 'start', 'floor', 'rows'}
    for i, (start, floor) in enumerate(CHUNK_CASES):
        assert pair.port('chunk', _ids(16, 16, i), start=start,
                         floor=floor) is step
        assert {k: t.data_ptr() for k, t in step.buf.items()} == ptrs
        assert int(step.buf['start']) == start
        assert int(step.buf['floor']) == floor
        assert int(step.buf['rows'][0]) == pair.eng._adapter_rows[1] != 0


@pytest.mark.parametrize('kind', ['whole', 'chunk'])
def test_prefill_under_an_adapter_writes_the_jax_engines_pages(models,
                                                               kind):
    """The slot's bank row reaches the adapter hooks through the step's
    static row: the pages equal the JAX engine's under the same adapter,
    and differ from the base model's."""
    jm, tm = models
    pair = _Pair(jm, tm, seed=2, banked=True)
    pair.pin('ad0')
    ids = _ids(20, 32, seed=3)
    chunk = dict(start=16, floor=16) if kind == 'chunk' else {}
    want = (pair.jax_chunk(ids, **chunk) if chunk else pair.jax_whole(ids))
    pair.port(kind, ids, **chunk)
    pair.assert_pages_equal(want, pad_from=None if chunk else 32)
    adapted = [k.clone() for k, _ in pair.eng.pool.pages]
    pair.fill(seed=2)
    pair.eng._adapter_rows[pair.slot] = 0
    pair.port(kind, ids, **chunk)
    assert not all(torch.equal(a, k) for a, (k, _) in
                   zip(adapted, pair.eng.pool.pages))


def test_prefill_step_rejects_an_unknown_kind(models):
    _, tm = models
    eng = InferenceEngine(tm, num_slots=1, max_length=MAX_LEN, kv_page_size=16)
    with pytest.raises(ValueError):
        PrefillStep('partial', 8, tm, eng.pool.pages,
                    eng.pool.pages_per_slot, eng.device)


# ---------------------------------------------------------------------------
# the flash forward's plain version with a device key count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('sq,sk,h,hkv,used', [
    (5, 24, 4, 2, (17, 9)),      # GQA, two batches of other counts
    (8, 40, 4, 4, (8, 40)),      # seqused_k = sq, and the whole buffer
    (1, 33, 8, 2, (30, 1)),      # one query (a one-token chunk)
])
def test_plain_flash_with_seqused_k_is_attention_over_sliced_keys(
        causal, sq, sk, h, hkv, used):
    rng = np.random.default_rng(sq + sk)
    q = rng.standard_normal((2, sq, h, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, sk, hkv, 16)).astype(np.float32)
            for _ in range(2))
    for b, n in enumerate(used):         # rows past the count: poison
        k[b, n:] = np.nan
        v[b, n:] = np.nan
    counts = torch.tensor(used, dtype=torch.int32)
    got, lse = K.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, return_lse=True, seqused_k=counts)
    assert torch.isfinite(got).all() and torch.isfinite(lse).all()
    for b, n in enumerate(used):
        sl = [torch.from_numpy(x[b:b + 1]) for x in (q, k[:, :n], v[:, :n])]
        want, want_lse = K.attention_reference(*sl, causal=causal,
                                               return_lse=True)
        assert torch.equal(got[b:b + 1], want)
        assert torch.equal(lse[b:b + 1], want_lse)
        xla = _attention_xla(*(jnp.asarray(t.numpy()) for t in sl),
                             causal=causal)
        np.testing.assert_allclose(got[b:b + 1].numpy(), np.asarray(xla),
                                   rtol=TOL, atol=TOL)


def test_plain_flash_rejects_seqused_k_with_a_mask():
    q = torch.zeros(1, 2, 2, 16)
    with pytest.raises(ValueError):
        K.attention_reference(q, q, q, mask=torch.ones(2, 2, dtype=bool),
                              seqused_k=torch.tensor([2], dtype=torch.int32))


# ---------------------------------------------------------------------------
# the engine builds the JAX engine's per-bucket programs
# ---------------------------------------------------------------------------

def _jax_prefill_traces(jeng) -> set:
    return {k for k in jeng.stats()['traces']
            if k.startswith(('paged_prefill_', 'paged_chunk_prefill_'))}


@pytest.mark.parametrize('opts', [
    {},                                                 # whole prefills
    dict(prefix_cache=0.5, prefill_chunk_tokens=16),    # suffixes, chunks
])
def test_engine_builds_the_jax_engines_prefill_buckets(models, opts):
    """The same waves through both engines: the port built one step per
    bucket the JAX engine traced a program for (the names the card
    counts in `traces`), and the tokens are equal. On the CPU nothing is
    captured, so `traces` stays empty."""
    jm, tm = models
    rng = np.random.RandomState(7)
    sysp = rng.randint(1, 128, (20,)).tolist()
    waves = [[sysp + rng.randint(1, 128, (n,)).tolist() for n in (3, 12)],
             [sysp + rng.randint(1, 128, (n,)).tolist() for n in (5, 30)]
             + [rng.randint(1, 128, (n,)).tolist() for n in (50, 7)]]
    kw = dict(num_slots=3, max_length=96, decode_block=2, kv_page_size=16,
              **opts)
    get_store().clear_memory()     # trace the JAX programs in this test
    jeng, eng = JaxEngine(jm, **kw), InferenceEngine(tm, **kw)
    for wave in waves:
        want = jeng.generate_many(wave, JaxParams(max_new_tokens=4,
                                                  eos_token_id=NO_EOS))
        got = eng.generate_many(wave, SamplingParams(max_new_tokens=4,
                                                     eos_token_id=NO_EOS))
        assert [h.tokens for h in got] == [h.tokens for h in want]
    names = {s.name for s in eng._prefill_steps.values()}
    assert names == _jax_prefill_traces(jeng)
    assert any(n.startswith('paged_chunk') for n in names) == bool(opts)
    assert eng.stats()['traces'] == {}
