"""The port's Llama (paddle_tpu_torch/nlp) against the JAX package's, on
the CPU: the same weights (carried by `from_jax_state`) and the same
inputs (made from a seed with numpy) go through both. Logits agree to
2e-4 (SCOPE.md's parity bar); helpers to fp32 rounding."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp import generation as jgen
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.tensor import Tensor
from paddle_tpu_torch.nlp import (LlamaConfig, LlamaForCausalLM,
                                  cached_forward, decode_mask, offset_grid,
                                  update_kv_cache)
from paddle_tpu_torch.nlp.llama import _rope
from paddle_tpu_torch.serving import scatter_pages
from paddle_tpu_torch.weights import from_jax_state

LOGIT_TOL = 2e-4


def _pair(layers=2, seed=3, **cfg):
    paddle.seed(seed)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(
        num_key_value_heads=2, num_hidden_layers=layers, **cfg)).eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = from_jax_state(state, LlamaForCausalLM(
        LlamaConfig.tiny(num_key_value_heads=2, num_hidden_layers=layers,
                         **cfg), device='cpu'))
    return jm, tm


@pytest.fixture(scope='module')
def pair():
    return _pair()


@pytest.mark.parametrize('layers,shape', [(2, (2, 11)), (3, (1, 40))])
def test_logits_match_jax(layers, shape):
    jm, tm = _pair(layers=layers, seed=layers)
    ids = np.random.default_rng(layers).integers(1, 128, shape)
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_logits_with_position_offset_match_jax(pair):
    jm, tm = pair
    ids = np.random.default_rng(1).integers(1, 128, (2, 6))
    off = np.array([0, 9], np.int32)
    want = np.asarray(jm(paddle.to_tensor(ids),
                         position_offset=paddle.to_tensor(off)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids),
                 position_offset=torch.from_numpy(off)).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_state_dict_keys_and_shapes_match_jax(pair):
    jm, tm = pair
    jsd = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    tsd = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert jsd == tsd


def test_from_jax_state_rejects_mismatch(pair):
    jm, tm = pair
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    with pytest.raises(KeyError):
        from_jax_state({k: v for k, v in state.items()
                        if k != 'lm_head.weight'}, tm)
    state['llama.norm.weight'] = np.ones(3, np.float32)
    with pytest.raises(ValueError):
        from_jax_state(state, tm)


def test_paged_decode_matches_no_cache_forward(pair):
    """Prefill a prompt's K/V into pages, then decode one token per slot
    through the paged forward: its logits equal the no-cache forward of
    prompt + token at the last position."""
    _, tm = pair
    rng = np.random.default_rng(4)
    lens = [5, 19]
    prompts = [rng.integers(1, 128, (s,)) for s in lens]
    pages = tm.init_cache(9, 16)                 # 8 pages + null page 0
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    with torch.no_grad():
        for i, p in enumerate(prompts):
            slab = tm.prefill_kv(torch.from_numpy(p[:-1])[None])
            scatter_pages(pages, table[i:i + 1], slab, torch.zeros(1).long())
        tok = torch.tensor([[int(p[-1])] for p in prompts])
        pos = torch.tensor([s - 1 for s in lens])
        got = cached_forward(tm)(tok, pages, pos, table)[:, -1]
        for i, p in enumerate(prompts):
            want = tm(torch.from_numpy(p)[None])[0, -1]
            np.testing.assert_allclose(got[i].numpy(), want.numpy(),
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_rope_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    for pos in (np.arange(5, dtype=np.int32),
                np.array([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]], np.int32)):
        want = np.asarray(jllama._rope(jnp.asarray(x), jnp.asarray(pos),
                                       10000.0))
        got = _rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('offset', [3, [0, 7]])
def test_offset_grid_matches_jax(offset):
    want = np.asarray(jgen.offset_grid(jnp.asarray(offset, jnp.int32), 4))
    got = offset_grid(torch.as_tensor(offset), 4)
    assert np.array_equal(got.numpy(), want)


def test_decode_mask_matches_jax():
    q = np.zeros((1, 3, 2, 4), np.float32)
    kc = np.zeros((1, 10, 2, 4), np.float32)
    want = np.asarray(jgen.decode_mask(Tensor(jnp.asarray(q)),
                                       Tensor(jnp.asarray(kc)), 4).value)
    got = decode_mask(torch.from_numpy(q), torch.from_numpy(kc), 4)
    assert np.array_equal(got.numpy(), want)


def test_update_kv_cache_matches_contiguous_write():
    """Rows written through the page table, gathered back in table order,
    equal the JAX package's per-row write into a contiguous cache."""
    rng = np.random.default_rng(8)
    ps, p, n = 4, 3, 2
    table = np.array([[2, 5, 1], [3, 0, 4]], np.int32)   # 0 = null page
    k_pages = rng.standard_normal((6, ps, 2, 8)).astype(np.float32)
    v_pages = rng.standard_normal((6, ps, 2, 8)).astype(np.float32)
    k_new = rng.standard_normal((n, 2, 2, 8)).astype(np.float32)
    v_new = rng.standard_normal((n, 2, 2, 8)).astype(np.float32)
    off = np.array([5, 2], np.int32)       # rows in table entries 1 and 0
    kc = k_pages[table].reshape(n, p * ps, 2, 8)
    vc = v_pages[table].reshape(n, p * ps, 2, 8)
    jk, jv = jgen.update_kv_cache(Tensor(jnp.asarray(kc)),
                                  Tensor(jnp.asarray(vc)),
                                  Tensor(jnp.asarray(k_new)),
                                  Tensor(jnp.asarray(v_new)),
                                  jnp.asarray(off))
    tk, tv = torch.from_numpy(k_pages), torch.from_numpy(v_pages)
    update_kv_cache(tk, tv, torch.from_numpy(k_new), torch.from_numpy(v_new),
                    torch.from_numpy(table), torch.from_numpy(off))
    got_k = tk[torch.from_numpy(table).long()].reshape(n, p * ps, 2, 8)
    got_v = tv[torch.from_numpy(table).long()].reshape(n, p * ps, 2, 8)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(jk.value))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(jv.value))


def test_init_cache_uses_model_dtype_and_device(pair):
    _, tm = pair
    cache = tm.init_cache(3, 16)
    assert len(cache) == tm.config.num_hidden_layers
    k, v = cache[0]
    assert k.shape == (3, 16, 2, 16) and k.dtype == torch.float32
    assert k.device.type == 'cpu' and v.shape == k.shape
