"""The port's paged engine (paddle_tpu_torch/serving) against the JAX
`InferenceEngine(kv_page_size=16)`, on the CPU, over the tiny GQA Llama
with weights carried by `from_jax_state`. Greedy tokens must be
identical; sampling is held to its own seed (the two frameworks draw
different random numbers)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import (FINISHED, SAMPLING, InferenceEngine,
                                      PromptTooLongError, SamplingParams,
                                      sample_rows)
from paddle_tpu_torch.weights import from_jax_state

NO_EOS = -1


@pytest.fixture(autouse=True, scope='module')
def _reset_jax_metrics():
    """The JAX engine records into the JAX package's process-global
    metrics registry (TTFT, tokens, ...); zero it after this module so
    later test files in the same process start from a clean registry."""
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


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, (s,)).tolist() for s in lens]


def _all_pages_free(pool):
    return pool.free_page_count == pool.num_pages - 1


@pytest.mark.parametrize('decode_block', [1, 4])
def test_greedy_tokens_identical_to_jax_engine(models, decode_block):
    jm, tm = models
    prompts = _prompts([3, 9, 5, 14, 7, 11, 30])
    news = [6, 9, 4, 12, 8, 5, 17]
    jax_eng = JaxEngine(jm, num_slots=3, max_length=64,
                        decode_block=decode_block, kv_page_size=16)
    port = InferenceEngine(tm, num_slots=3, max_length=64,
                           decode_block=decode_block, kv_page_size=16)
    hj = jax_eng.generate_many(
        prompts, [JaxParams(max_new_tokens=n, eos_token_id=NO_EOS)
                  for n in news])
    ht = port.generate_many(
        prompts, [SamplingParams(max_new_tokens=n, eos_token_id=NO_EOS)
                  for n in news])
    for a, b in zip(hj, ht):
        assert b.status == FINISHED
        assert b.tokens == a.tokens
    assert port.stats()['completed'] == len(prompts)
    assert _all_pages_free(port.pool)


def test_page_exhaustion_requeues_and_matches_jax(models):
    """15 short prompts into 15 slots but 16 pages (15 usable), each
    needing 2 pages (6 + 12 rows): admission requeues on PagePoolExhausted
    and every request still gets the JAX tokens."""
    jm, tm = models
    prompts = _prompts([6] * 15, seed=6)
    jax_eng = JaxEngine(jm, num_slots=15, max_length=64, decode_block=2,
                        kv_page_size=16, kv_pages=16)
    port = InferenceEngine(tm, num_slots=15, max_length=64, decode_block=2,
                           kv_page_size=16, kv_pages=16)
    hj = jax_eng.generate_many(
        prompts, JaxParams(max_new_tokens=12, eos_token_id=NO_EOS))
    ht = port.generate_many(
        prompts, SamplingParams(max_new_tokens=12, eos_token_id=NO_EOS))
    assert [h.tokens for h in ht] == [h.tokens for h in hj]
    st = port.stats()
    assert st['requeued'] > 0 and st['completed'] == 15
    assert _all_pages_free(port.pool)


def test_eos_stops_a_request_like_jax(models):
    jm, tm = models
    prompt = _prompts([8], seed=3)[0]
    first = JaxEngine(jm, num_slots=1, max_length=64, decode_block=4,
                      kv_page_size=16).generate_many(
        [prompt], JaxParams(max_new_tokens=10, eos_token_id=NO_EOS))[0]
    eos = first.tokens[2]
    hj = JaxEngine(jm, num_slots=1, max_length=64, decode_block=4,
                   kv_page_size=16).generate_many(
        [prompt], JaxParams(max_new_tokens=10, eos_token_id=eos))[0]
    ht = InferenceEngine(tm, num_slots=1, max_length=64, decode_block=4,
                         kv_page_size=16).generate_many(
        [prompt], SamplingParams(max_new_tokens=10, eos_token_id=eos))[0]
    assert ht.tokens == hj.tokens
    assert ht.tokens[-1] == eos


def _sample(tm, prompts, params, num_slots=4):
    eng = InferenceEngine(tm, num_slots=num_slots, max_length=64,
                          decode_block=3, kv_page_size=16)
    return [h.tokens for h in eng.generate_many(prompts, params)]


def test_sampling_same_seed_same_tokens(models):
    _, tm = models
    prompts = _prompts([5, 9, 12], seed=4)
    sp = [SamplingParams(max_new_tokens=8, strategy=SAMPLING,
                         temperature=0.9, top_p=0.95, top_k=40, seed=s,
                         eos_token_id=NO_EOS) for s in (1, 2, 3)]
    a = _sample(tm, prompts, sp)
    b = _sample(tm, prompts, sp)
    assert a == b
    # a request's tokens do not depend on its batch neighbours
    alone = _sample(tm, prompts[1:2], sp[1:2], num_slots=1)
    assert alone[0] == a[1]


def test_top_k_one_equals_greedy(models):
    _, tm = models
    prompts = _prompts([6, 13], seed=5)
    greedy = _sample(tm, prompts,
                     SamplingParams(max_new_tokens=7, eos_token_id=NO_EOS))
    topk1 = _sample(tm, prompts, [
        SamplingParams(max_new_tokens=7, strategy=SAMPLING, top_k=1,
                       temperature=1.3, seed=s, eos_token_id=NO_EOS)
        for s in (0, 1)])
    assert topk1 == greedy


def test_sample_rows_filters():
    """Temperature -> top-k -> top-p as the JAX engine orders them: a
    row whose top-p keeps one token and a row whose top-k keeps one both
    draw their argmax; greedy rows take the argmax untouched."""
    logits = torch.tensor([[0.0, 3.0, 1.0, 2.9],
                           [5.0, 0.0, 4.99, 1.0],
                           [1.0, 2.0, 3.0, 4.0]])
    gens = [torch.Generator().manual_seed(i) for i in range(3)]
    for _ in range(20):
        out = sample_rows(logits, torch.tensor([1.0, 1.0, 0.5]),
                          torch.tensor([0, 1, 0]),
                          torch.tensor([0.01, 1.0, 1.0]),
                          np.array([True, True, False]), gens)
        assert out.tolist() == [1, 0, 3]


def test_submit_validation(models):
    _, tm = models
    eng = InferenceEngine(tm, num_slots=2, max_length=32, kv_page_size=16)
    with pytest.raises(PromptTooLongError):
        eng.submit(list(range(1, 40)))
    with pytest.raises(ValueError):
        eng.submit(list(range(1, 20)), max_new_tokens=20)
    with pytest.raises(ValueError):
        InferenceEngine(tm, max_length=40, kv_page_size=16)   # not a multiple


def test_stream_yields_every_token(models):
    _, tm = models
    eng = InferenceEngine(tm, num_slots=2, max_length=64, decode_block=4,
                          kv_page_size=16)
    h = eng.submit(_prompts([7], seed=9)[0], max_new_tokens=6,
                   eos_token_id=NO_EOS)
    other = eng.submit(_prompts([4], seed=10)[0], max_new_tokens=9,
                       eos_token_id=NO_EOS)
    assert list(eng.stream(h)) == h.tokens and len(h.tokens) == 6
    assert other.result() == other.tokens and len(other.tokens) == 9
    st = eng.stats()
    assert st['prefills'] == 2 and st['prefill_tokens'] == 11
    assert st['tokens'] == 15 and not eng.has_work


# ---------------------------------------------------------------------------
# the chunk forward (suffix and chunked prefill) against the JAX
# cached_forward with the slot-causal mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('prefix,start,chunk,floor', [
    (0, 0, 16, 0),        # a first chunk
    (16, 16, 16, 16),     # the chunk after an attached page
    (20, 20, 12, 16),     # a chunk from mid-page
    (32, 16, 24, 16),     # a tail-shifted window over rows already there
    (40, 40, 8, 32)])
def test_chunk_forward_matches_jax_cached_forward(models, prefix, start,
                                                  chunk, floor):
    """Rows [0, prefix) are in the slot (pages / the JAX row), then the
    chunk prompt[start:start + chunk] runs at offset `start`: the port's
    chunk forward gives the logits of the JAX `cached_forward` with the
    mask k_slot <= start + i (`engine.py:_paged_chunk_prefill_fn`), to
    the f32 parity bar of tests/test_torch_llama.py (2e-4), and leaves
    the pages below the floor untouched."""
    import jax.numpy as jnp
    from paddle_tpu.jit import functional_state
    from paddle_tpu.nlp.generation import cached_forward as jax_cached
    from paddle_tpu_torch.nlp import chunk_forward
    from paddle_tpu_torch.serving import gather_pages, scatter_pages
    jm, tm = models
    max_len, ps = 64, 16
    prompt = np.random.RandomState(prefix + start).randint(1, 128, (64,))
    fwd = jax_cached(jm, *functional_state(jm))
    row = jm.init_cache(1, max_len)
    if prefix:
        _, row = fwd(jnp.asarray(prompt[None, :prefix]), row, 0, 0, None)
    k_slot = jnp.arange(max_len)
    mask = (k_slot[None, :] <= start + jnp.arange(chunk)[:, None])[None, None]
    want, _ = fwd(jnp.asarray(prompt[None, start:start + chunk]), row,
                  jnp.int32(start), jnp.int32(start), mask)
    pages = tm.init_cache(6, ps)
    table = torch.tensor([[4, 2, 5, 1]], dtype=torch.int32)
    with torch.no_grad():
        if prefix:
            slab = tm.prefill_kv(torch.from_numpy(prompt[None, :prefix]))
            scatter_pages(pages, table, slab, torch.zeros(1).long())
        before = gather_pages(pages, table, floor)
        got = chunk_forward(tm)(
            torch.from_numpy(prompt[None, start:start + chunk]), pages,
            start, table, floor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    for (k0, v0), (k, v) in zip(before, gather_pages(pages, table, floor)):
        assert torch.equal(k0, k) and torch.equal(v0, v)
