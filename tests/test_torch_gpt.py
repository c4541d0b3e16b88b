"""The port's GPT (paddle_tpu_torch/nlp/gpt.py) against the JAX package's,
on the CPU: the same weights (carried by `from_jax_state`, scaled so
that greedy tokens vary) and the same inputs (made from a seed with
numpy). Logits, the loss and every parameter's gradient in f32, the
fused qkv split, the paged engine against the JAX
`InferenceEngine(kv_page_size=16)` (identical greedy tokens, with the
prefix cache and chunking, int8 KV, a GPT draft and a default-target
`AdapterBank`), the last position a model serves, and the analytic
`TransformerCost` of a GPT config.

Tolerance: logits and loss 1e-5 relative to the output's scale (its
largest magnitude), gradients 1e-4 relative (1e-5 absolute: fp32 sums in
another order over a backward)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp import gpt as jgpt
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.serving import AdapterBank as JaxBank
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu.serving import make_adapter_factors as jax_factors
from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nlp.gpt import split_qkv
from paddle_tpu_torch.observability.cost import TransformerCost
from paddle_tpu_torch.serving import (AdapterBank, InferenceEngine,
                                      SamplingParams, make_adapter_factors)
from paddle_tpu_torch.weights import from_jax_state

NO_EOS = -1
SCALE = 4.0     # weights x 4: the tiny random GPT's greedy tokens vary


@pytest.fixture(autouse=True, scope='module')
def _reset_jax_metrics():
    yield
    jax_metrics.get_registry().reset()


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The port's CPU engines run many small ops: beside JAX's own thread
    pool in this process, torch's intra-op threads cost far more than
    they give (a tiny engine's wave ran ~40x slower on 8 threads than on
    one), so this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gpt_pair(seed=5, scale=SCALE, **cfg):
    """(JAX model, port model) over the same weights: the JAX tiny GPT's
    matrices times `scale`."""
    paddle.seed(seed)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig.tiny(**cfg)).eval()
    state = {k: np.asarray(v.numpy()) * (scale if v.ndim == 2 else 1.0)
             for k, v in jm.state_dict().items()}
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    tm = from_jax_state(state, GPTForCausalLM(GPTConfig.tiny(**cfg),
                                              device='cpu')).eval()
    return jm, tm


@pytest.fixture(scope='module')
def pair():
    return gpt_pair()


# a GPT of head_dim 64 (GPT-2's width per head): 2 layers, hidden 128, 2
# heads x 64, vocab 128
D64 = dict(hidden_size=128, num_attention_heads=2)


@pytest.fixture(scope='module')
def pair64():
    return gpt_pair(**D64)


def close(got, want, rtol=1e-5):
    """|got - want| <= rtol (|want| + max |want|): relative to the
    output's scale, as f32 sums in another order round."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _ids(shape, seed=0, vocab=128):
    return np.random.default_rng(seed).integers(1, vocab, shape)


def test_state_dict_keys_and_shapes_match_jax(pair):
    jm, tm = pair
    assert {k: tuple(v.shape) for k, v in jm.state_dict().items()} == {
        k: tuple(v.shape) for k, v in tm.state_dict().items()}
    untied = GPTForCausalLM(GPTConfig.tiny(tie_word_embeddings=False),
                            device='cpu')
    assert untied.lm_head.weight.shape == (64, 128)
    assert untied.lm_head.bias is None


@pytest.mark.parametrize('shape,offset', [((2, 11), None), ((1, 40), None),
                                          ((2, 6), [0, 9])])
def test_logits_match_jax(pair, shape, offset):
    jm, tm = pair
    ids = _ids(shape, seed=shape[1])
    kw_j = {} if offset is None else {
        'position_offset': paddle.to_tensor(np.array(offset, np.int32))}
    kw_t = {} if offset is None else {
        'position_offset': torch.tensor(offset)}
    want = np.asarray(jm(paddle.to_tensor(ids), **kw_j).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), **kw_t).numpy()
    close(got, want)


def test_pad_mask_forward_matches_jax(pair):
    """A 2-D pad mask becomes a boolean [B, 1, 1, S] mask (plain
    attention) in both."""
    jm, tm = pair
    ids = _ids((2, 9), seed=4)
    mask = np.ones((2, 9), np.int64)
    mask[1, :3] = 0
    want = np.asarray(jm(paddle.to_tensor(ids),
                         attention_mask=paddle.to_tensor(mask)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids),
                 attention_mask=torch.from_numpy(mask)).numpy()
    close(got, want)


def test_loss_and_gradients_match_jax():
    """`labels` give the mean CE of every position (no shift, through the
    CE kernels' plain version); every parameter's gradient, the tied
    embedding's included, equals jax's."""
    jm, tm = gpt_pair(seed=6, scale=1.0)
    ids, labels = _ids((2, 10), seed=1), _ids((2, 10), seed=2)
    jloss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    jloss.backward()
    tloss, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    tloss.backward()
    np.testing.assert_allclose(float(tloss), float(jloss.numpy()),
                               rtol=1e-5)
    jgrads = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(jgrads[name].grad.numpy()),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_qkv_split_is_three_contiguous_blocks():
    """q, k, v are the first, second and third h columns of qkv_proj's
    output (`paddle_tpu/nlp/gpt.py:97-102`); a per-head interleave of
    them would be another function."""
    nh, hd = 4, 16
    qkv = torch.arange(2 * 3 * 3 * nh * hd, dtype=torch.float32).reshape(
        2, 3, 3 * nh * hd)
    q, k, v = split_qkv(qkv, nh, hd)
    for i, t in enumerate((q, k, v)):
        assert torch.equal(t.reshape(2, 3, nh * hd),
                           qkv[..., i * nh * hd:(i + 1) * nh * hd])
    per_head = qkv.reshape(2, 3, nh, 3, hd)[..., 0, :]
    assert not torch.equal(per_head, q)


def _engines(jm, tm, **kw):
    kw = {'num_slots': 3, 'max_length': 64, 'decode_block': 2,
          'kv_page_size': 16, **kw}
    return JaxEngine(jm, **kw), InferenceEngine(tm, **kw)


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, (s,)).tolist() for s in lens]


PROMPTS = _prompts([3, 9, 5, 14, 30, 17])


PREFIX_CHUNK = {'prefix_cache': 0.5, 'prefill_chunk_tokens': 16}


@pytest.mark.parametrize('opts,d64', [
    ({}, False), (PREFIX_CHUNK, False), ({'kv_quant': 'int8'}, False),
    ({'kv_quant': 'int8'}, True),
    ({'kv_quant': 'int8', **PREFIX_CHUNK}, True)],
    ids=['plain', 'prefix_chunk', 'int8', 'int8_d64', 'int8_prefix_chunk_d64'])
def test_engine_greedy_tokens_identical_to_jax(request, opts, d64):
    """The port's engine against the JAX engine, greedy: plain, with the
    prefix cache and chunks, with int8 KV; at head_dim 64 with int8 KV,
    and with the prefix cache and chunks too."""
    jm, tm = request.getfixturevalue('pair64' if d64 else 'pair')
    je, te = _engines(jm, tm, **opts)
    # with the cache: a request sharing 24 tokens (a whole page) of one
    # served before it
    prompts = PROMPTS + [PROMPTS[4][:24] + PROMPTS[1]] if opts.get(
        'prefix_cache') else PROMPTS
    hj = je.generate_many(prompts, JaxParams(max_new_tokens=8,
                                             eos_token_id=NO_EOS))
    ht = te.generate_many(prompts, SamplingParams(max_new_tokens=8,
                                                  eos_token_id=NO_EOS))
    assert [h.tokens for h in ht] == [h.tokens for h in hj]
    assert len({tuple(h.tokens) for h in ht}) > 1


@pytest.mark.parametrize('d64', [False, True], ids=['tiny', 'int8_d64'])
def test_engine_with_gpt_draft_identical_to_jax(request, d64):
    """Speculative decoding with a 1-layer GPT draft: the tokens equal
    the JAX spec engine's (and so, over float KV, the plain engine's),
    and so do the spec counters; at head_dim 64 over int8 KV with the
    prefix cache and chunks (the verify over int8 pages and the round's
    window, the draft over its float pages)."""
    jm, tm = request.getfixturevalue('pair64' if d64 else 'pair')
    cfg = D64 if d64 else {}
    opts = {'kv_quant': 'int8', **PREFIX_CHUNK} if d64 else {}
    jd, td = gpt_pair(seed=9, num_hidden_layers=1, **cfg)
    je = JaxEngine(jm, num_slots=3, max_length=64, decode_block=2,
                   kv_page_size=16, draft_model=jd, num_draft_tokens=3,
                   **opts)
    te = InferenceEngine(tm, num_slots=3, max_length=64, decode_block=2,
                         kv_page_size=16, draft_model=td,
                         num_draft_tokens=3, **opts)
    prompts = PROMPTS + [PROMPTS[4][:24] + PROMPTS[1]] if d64 else PROMPTS
    hj = je.generate_many(prompts, JaxParams(max_new_tokens=8,
                                             eos_token_id=NO_EOS))
    ht = te.generate_many(prompts, SamplingParams(max_new_tokens=8,
                                                  eos_token_id=NO_EOS))
    assert [h.tokens for h in ht] == [h.tokens for h in hj]
    assert te.stats()['spec'] == je.stats()['spec']


def test_default_target_bank_serves_a_gpt_like_jax(pair):
    """`AdapterBank(model)` with its default targets finds GPT's
    qkv_proj and out_proj; a mixed wave gives the JAX banked engine's
    tokens."""
    jm, tm = pair
    bank, jbank = AdapterBank(tm, capacity=3, rank=4), \
        JaxBank(jm, capacity=3, rank=4)
    assert sorted(bank.sites) == sorted(jbank.sites) and len(bank.sites) \
        == 4 and {s.rsplit('.', 1)[-1] for s in bank.sites} == {
            'qkv_proj', 'out_proj'}
    for i in range(2):
        bank.load(f'ad{i}', make_adapter_factors(bank, seed=1 + i,
                                                 scale=0.2), version=1)
        jbank.load(f'ad{i}', jax_factors(jbank, seed=1 + i, scale=0.2),
                   version=1)
    ids = [None, 'ad0', 'ad1', 'ad0', None, 'ad1']
    je = JaxEngine(jm, num_slots=3, max_length=64, decode_block=2,
                   kv_page_size=16, adapter_bank=jbank)
    te = InferenceEngine(tm, num_slots=3, max_length=64, decode_block=2,
                         kv_page_size=16, adapter_bank=bank)
    hj = je.generate_many(PROMPTS, JaxParams(max_new_tokens=6,
                                             eos_token_id=NO_EOS),
                          adapter_ids=ids)
    ht = te.generate_many(PROMPTS, SamplingParams(max_new_tokens=6,
                                                  eos_token_id=NO_EOS),
                          adapter_ids=ids)
    assert [h.tokens for h in ht] == [h.tokens for h in hj]
    bank.detach()


def test_request_ending_at_the_last_position_matches_jax():
    """A model serves max_position_embeddings positions: a request whose
    last token sits at the last one is served (tokens equal JAX's), an
    engine longer than the table is refused in both, and a request past
    the slot is refused in both."""
    jm, tm = gpt_pair(seed=7, max_position_embeddings=48)
    with pytest.raises(ValueError, match='max_position_embeddings'):
        InferenceEngine(tm, num_slots=1, max_length=64)
    with pytest.raises(ValueError, match='max_position_embeddings'):
        JaxEngine(jm, num_slots=1, max_length=64, kv_page_size=16)
    je, te = _engines(jm, tm, num_slots=1, max_length=48)
    prompt = _prompts([40], seed=3)
    hj = je.generate_many(prompt, JaxParams(max_new_tokens=8,
                                            eos_token_id=NO_EOS))
    ht = te.generate_many(prompt, SamplingParams(max_new_tokens=8,
                                                 eos_token_id=NO_EOS))
    assert ht[0].tokens == hj[0].tokens and len(ht[0].tokens) == 8
    for eng, params in ((te, SamplingParams), (je, JaxParams)):
        with pytest.raises(Exception, match='exceeds the slot length'):
            eng.submit(prompt[0], params(max_new_tokens=9,
                                         eos_token_id=NO_EOS))


def test_transformer_cost_counts_a_gpt_mlp_of_two_matrices():
    """GPT's MLP is two matrices (gelu, no gate): the analytic cost's
    matmul parameters are exactly the model's weight matrices but the
    embeddings; a Llama config keeps three. A learned-position model
    reads one position row per token row."""
    cfg = GPTConfig.tiny(num_hidden_layers=3)
    cost = TransformerCost(cfg, weight_itemsize=4)
    assert cost.mlp_matrices == 2
    model = GPTForCausalLM(cfg, device='cpu')
    mats = sum(p.numel() for n, p in model.named_parameters()
               if p.dim() == 2 and 'embeddings' not in n)
    assert cost.params(head=False) == mats
    assert cost.params(head=True) == mats + 64 * 128
    flops, nbytes = cost.forward(rows=10, keys=55, kv_read=0, kv_written=10)
    assert flops == 2.0 * (mats + 64 * 128) * 10 + 4 * 64 * 3 * 55
    assert nbytes == 4.0 * (mats + 64 * 128) + 2 * 64 * 3 * 4 * 10 \
        + 10 * 64 * 4
    from paddle_tpu_torch.nlp import LlamaConfig
    llama = TransformerCost(LlamaConfig.tiny())
    assert llama.mlp_matrices == 3 and llama.position_row_bytes == 0
    big = TransformerCost(GPTConfig.gpt3_1p3b())
    # GPT-3 XL: 24 x 12 h^2 layer matrices, the 50304 x 2048 tied head
    assert big.params(head=True) == 24 * 12 * 2048 ** 2 + 50304 * 2048
