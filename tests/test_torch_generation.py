"""`GenerationMixin` (paddle_tpu_torch/nlp/generation.py) against the JAX
package's, on the CPU, over the tiny GPT and the tiny GQA Llama with the
same weights (carried by `from_jax_state`, scaled so that greedy tokens
vary): `generate` greedy (a batch, a padded batch, the repetition
penalty, min_new_tokens, EOS) and beam search give the JAX tokens and
scores, `speculative_generate` the JAX tokens and stats; sampling is
held to its own seed (the two packages draw different numbers) and its
logits filter to the JAX one; the static-cache helpers to the JAX
helpers.

Tolerance: scores 1e-5 relative (f32 sums of log-probs); tokens and
masks exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp import generation as jgen
from paddle_tpu.nlp import gpt as jgpt
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.tensor import Tensor as JTensor
from paddle_tpu_torch.nlp import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                  LlamaForCausalLM, padded_decode_mask,
                                  update_static_cache)
from paddle_tpu_torch.nlp import generation as tgen
from paddle_tpu_torch.tensor import Tensor
from paddle_tpu_torch.weights import from_jax_state

MODELS = {'gpt': (jgpt.GPTForCausalLM, jgpt.GPTConfig, GPTForCausalLM,
                  GPTConfig, {}),
          'llama': (jllama.LlamaForCausalLM, jllama.LlamaConfig,
                    LlamaForCausalLM, LlamaConfig,
                    {'num_key_value_heads': 2})}


def pair(kind='gpt', seed=5, scale=4.0, **cfg):
    jcls, jcfg, tcls, tcfg, base = MODELS[kind]
    cfg = {**base, **cfg}
    paddle.seed(seed)
    jm = jcls(jcfg.tiny(**cfg)).eval()
    state = {k: np.asarray(v.numpy()) * (scale if v.ndim == 2 else 1.0)
             for k, v in jm.state_dict().items()}
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    tm = from_jax_state(state, tcls(tcfg.tiny(**cfg), device='cpu')).eval()
    return jm, tm


@pytest.fixture(scope='module')
def gpt():
    return pair('gpt')


@pytest.fixture(scope='module')
def llama():
    return pair('llama', seed=3, scale=8.0)


def _ids(shape, seed=0):
    return np.random.default_rng(seed).integers(1, 128, shape)


def _both(jm, tm, ids, **kw):
    jkw = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    jo, js = jm.generate(paddle.to_tensor(ids), **jkw)
    to, ts = tm.generate(torch.from_numpy(ids), **tkw)
    return (np.asarray(jo.numpy()), np.asarray(js.numpy()), to.numpy(),
            ts.numpy())


@pytest.mark.parametrize('kind', ['gpt', 'llama'])
@pytest.mark.parametrize('kw', [
    dict(max_new_tokens=10, eos_token_id=-1),
    dict(max_new_tokens=10, decode_strategy='beam_search', num_beams=3,
         length_penalty=0.6, eos_token_id=-1),
    dict(max_new_tokens=8, repetition_penalty=1.8, min_new_tokens=4),
], ids=['greedy', 'beam', 'penalty'])
def test_generate_matches_jax(gpt, llama, kind, kw):
    jm, tm = gpt if kind == 'gpt' else llama
    ids = _ids((2, 7), seed=len(kw))
    jo, js, to, ts = _both(jm, tm, ids, **kw)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_allclose(ts, js, rtol=1e-5)
    assert len(set(to[0].tolist())) > 1


def test_generate_padded_batch_and_eos_match_jax(gpt):
    """A left-padded batch (`attention_mask`: per-sequence position
    origins, pad slots masked), and an EOS that finishes one row early:
    the JAX tokens (pads after EOS) and scores."""
    jm, tm = gpt
    ids = _ids((2, 8), seed=11)
    mask = np.ones((2, 8), np.int64)
    mask[0, :3] = 0
    first = _both(jm, tm, ids, max_new_tokens=6, attention_mask=mask,
                  eos_token_id=-1)
    np.testing.assert_array_equal(first[2], first[0])
    eos = int(first[2][1, 2])
    jo, js, to, ts = _both(jm, tm, ids, max_new_tokens=6,
                           attention_mask=mask, eos_token_id=eos,
                           pad_token_id=0)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_allclose(ts, js, rtol=1e-5)
    assert to[1, 2] == eos and (to[1, 3:] == 0).all()


@pytest.mark.parametrize('kind', ['gpt', 'llama'])
def test_speculative_generate_matches_jax_and_greedy(gpt, llama, kind):
    jm, tm = gpt if kind == 'gpt' else llama
    jd, td = pair(kind, seed=9, num_hidden_layers=1,
                  scale=4.0 if kind == 'gpt' else 8.0)
    ids = _ids((1, 6), seed=4)
    jo, jst = jm.speculative_generate(jd, paddle.to_tensor(ids),
                                      max_new_tokens=12,
                                      num_draft_tokens=3, eos_token_id=-1)
    to, tst = tm.speculative_generate(td, torch.from_numpy(ids),
                                      max_new_tokens=12, num_draft_tokens=3,
                                      eos_token_id=-1)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo.numpy()))
    assert tst == jst
    greedy, _ = tm.generate(torch.from_numpy(ids), max_new_tokens=12,
                            eos_token_id=-1)
    assert torch.equal(to, greedy)
    own, st = tm.speculative_generate(tm, torch.from_numpy(ids),
                                      max_new_tokens=12, eos_token_id=-1)
    assert torch.equal(own, greedy) and st['rounds'] >= 1


def test_sampling_is_held_to_its_seed(gpt):
    """Sampling draws from a generator seeded by `seed`: the same seed
    gives the same tokens, another seed others; top_k=1 is greedy."""
    _, tm = gpt
    ids = torch.from_numpy(_ids((2, 5), seed=6))
    kw = dict(max_new_tokens=12, decode_strategy='sampling', top_p=0.9,
              temperature=1.3, eos_token_id=-1)
    a, sa = tm.generate(ids, seed=1, **kw)
    b, sb = tm.generate(ids, seed=1, **kw)
    c, _ = tm.generate(ids, seed=2, **kw)
    assert torch.equal(a, b) and torch.equal(sa, sb)
    assert not torch.equal(a, c)
    g, _ = tm.generate(ids, max_new_tokens=12, eos_token_id=-1)
    k1, _ = tm.generate(ids, seed=3, max_new_tokens=12, eos_token_id=-1,
                        decode_strategy='sampling', top_k=1)
    assert torch.equal(g, k1)


@pytest.mark.parametrize('temperature,top_k,top_p', [
    (1.0, 5, 1.0), (0.7, 0, 0.8), (1.5, 20, 0.5), (1.0, 0, 1.0)])
def test_sampling_filter_matches_jax(temperature, top_k, top_p):
    logits = np.random.default_rng(top_k).standard_normal(
        (3, 64)).astype(np.float32) * 3
    want = np.asarray(jgen._process_logits(jnp.asarray(logits), temperature,
                                           top_k, top_p))
    got = tgen.process_logits(torch.from_numpy(logits), temperature, top_k,
                              top_p).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_max_length_and_min_length_follow_jax(gpt):
    jm, tm = gpt
    ids = _ids((1, 6), seed=2)
    tgen._warned_max_length[0] = False
    with pytest.warns(UserWarning, match='returning 0 new tokens'):
        out, scores = tm.generate(torch.from_numpy(ids), max_length=6)
    assert out.shape == (1, 0) and scores.shape == (1,)
    jo, _, to, _ = _both(jm, tm, ids, max_length=10, min_length=9,
                         eos_token_id=int(_both(
                             jm, tm, ids, max_new_tokens=4,
                             eos_token_id=-1)[2][0, 1]))
    np.testing.assert_array_equal(to, jo)
    assert to.shape == (1, 4)
    with pytest.raises(ValueError, match='max_position_embeddings'):
        tm.generate(torch.from_numpy(ids), max_new_tokens=200)


def test_tensor_in_gives_tensors_out(gpt):
    _, tm = gpt
    import paddle_tpu_torch as ptt
    with ptt.device_guard('cpu'):
        out, scores = tm.generate(ptt.to_tensor(_ids((1, 4))),
                                  max_new_tokens=3)
    assert isinstance(out, Tensor) and isinstance(scores, Tensor)


def test_static_cache_helpers_match_jax():
    rng = np.random.default_rng(0)
    cache = rng.standard_normal((3, 12, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 4, 2, 4)).astype(np.float32)
    for slot in (5, np.array([0, 3, 8], np.int32)):
        jk, _ = jgen.update_kv_cache(JTensor(jnp.asarray(cache)),
                                     JTensor(jnp.asarray(cache)),
                                     JTensor(jnp.asarray(new)),
                                     JTensor(jnp.asarray(new)),
                                     jnp.asarray(slot))
        tk = torch.from_numpy(cache.copy())
        update_static_cache(tk, tk.clone(), torch.from_numpy(new),
                            torch.from_numpy(new), torch.as_tensor(slot))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk.numpy()))
    keep = rng.random((2, 5)) > 0.3
    for offset, sq in ((0, 5), (7, 1)):
        want = np.asarray(jgen.padded_decode_mask(jnp.asarray(keep), 9,
                                                  jnp.int32(offset), sq))
        got = padded_decode_mask(torch.from_numpy(keep), 9, offset, sq)
        np.testing.assert_array_equal(got.numpy(), want)
