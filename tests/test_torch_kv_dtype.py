"""The KV pool's dtype (`InferenceEngine(dtype=)`) in the port against
the JAX package, on the CPU.

Both engines keep their KV pool (and a speculating engine's draft pool)
in the engine's `dtype` whatever the model's, and read it back as they
hold it: the port's decode through the paged kernel's pair for (the
model's dtype, the pool's) (here its plain version), its prefill over
rows rounded through the pool's dtype, the JAX engine by writing its
rows into the pool and attending the pool. Inputs come from numpy with a
seed. The CUDA instantiations of those pairs are held to the same plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py).

The default is the one difference: the JAX engine's `dtype=None` makes a
float32 pool whatever the model's dtype (`init_cache`'s default), so a
bf16 model's attention reads f32 K/V and returns f32; the port keeps the
model's dtype. `test_default_pool_dtype_differs_from_jax` pins it, and
`test_float32_pool_on_a_bf16_model_is_its_bf16_pool` shows that the port
asked for the JAX pool gives its own bf16 pool's tokens and logits.

Tolerances:
- engines: greedy tokens identical (not asked of the tiny GPT over a
  bf16 int8 pool: after its first prefill 3 of ~4000 int8 values of one
  layer's V differ between the packages, where an f32 sum computed in
  another order lands on the other side of a bf16 rounding boundary, and
  its first token then differs). The first decode step's logits of
  the port's f32 model over a bf16 or fp16 pool against the JAX model's
  dense forward over a cache of that dtype (the same rows, rounded the
  same way, summed in another order): relative max error 5e-4 (a K/V
  value whose f32 sum lies near a rounding boundary may round to the
  neighbouring fp16 value in one package only; measured 2.5e-4 for the
  tiny GPT over fp16, 7.5e-7 to 5.9e-6 otherwise), and less than half
  the distance to the JAX forward over an f32 cache (the rows were
  rounded).
- the plain paged version over pages in another dtype against the JAX
  `paged_attention_reference` (gather, dequantize, masked attend in
  f32): f32 q 1e-5 relative to the output's scale; bf16 and fp16 q one
  rounding of the output (2^-8, 2^-11) plus 1e-5.
- a bf16 model over an f32 pool against its own bf16 pool: bit for bit
  (every bf16 value is exact in f32, and the plain versions read pages
  in f32 either way).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp import gpt as jgpt
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu import programs as jprograms
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu_torch.nlp import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                  LlamaForCausalLM)
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.serving import InferenceEngine, SamplingParams
from paddle_tpu_torch.weights import from_jax_state
from test_torch_observability import isolated_observability

NO_EOS = -1
DTYPES = {'bfloat16': torch.bfloat16, 'float16': torch.float16,
          'float32': torch.float32}


@pytest.fixture(autouse=True, scope='module')
def _isolated_observability(tmp_path_factory):
    yield from isolated_observability(tmp_path_factory)


@pytest.fixture(autouse=True, scope='module')
def _reset_jax_metrics():
    yield
    jax_metrics.get_registry().reset()


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Beside JAX in one process, torch's CPU intra-op threads slow the
    port's tiny engines many times over (tests/test_torch_gpt.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(jm, tm_cls, tm_cfg, scale, dtype='float32'):
    """(JAX model, port model) over the same weights: the JAX model's
    matrices times `scale` (so that greedy tokens vary), cast to
    `dtype`, carried to the port."""
    jm.set_state_dict({k: paddle.to_tensor(np.asarray(v.numpy()) * (
        scale if v.ndim == 2 else 1.0)) for k, v in jm.state_dict().items()})
    if dtype != 'float32':
        jm.to(dtype=dtype)
    state = {k: np.asarray(v.numpy()).astype(np.float32)
             for k, v in jm.state_dict().items()}
    tm = from_jax_state(state, tm_cls(tm_cfg, device='cpu', dtype=dtype))
    return jm.eval(), tm.eval()


@pytest.fixture(scope='module')
def llama32():
    """The tiny GQA Llama in f32, matrices x 8."""
    paddle.seed(11)
    return _pair(jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(
        num_key_value_heads=2)), LlamaForCausalLM,
        LlamaConfig.tiny(num_key_value_heads=2), 8.0)


@pytest.fixture(scope='module')
def gpt32():
    """The tiny GPT of head_dim 64 (2 heads x 64) in f32, matrices x 4."""
    paddle.seed(5)
    cfg = dict(hidden_size=128, num_attention_heads=2)
    return _pair(jgpt.GPTForCausalLM(jgpt.GPTConfig.tiny(**cfg)),
                 GPTForCausalLM, GPTConfig.tiny(**cfg), 4.0)


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, (s,)).tolist() for s in lens]


PROMPTS = _prompts([3, 9, 5, 14, 30, 17])
# a request sharing 24 tokens (a whole page and a half) of one before it
SHARED = PROMPTS + [PROMPTS[4][:24] + PROMPTS[1]]
PREFIX_CHUNK = {'prefix_cache': 0.5, 'prefill_chunk_tokens': 16}
PAGED = {'kv_page_size': 16}
# the first decode step's logits: three prompts of one length, so that
# the JAX model's dense forward runs them as one batch
LOGIT_PROMPTS = _prompts([11, 11, 11], seed=1)


def _tokens(eng, prompts, params_cls):
    return [h.tokens for h in eng.generate_many(
        prompts, params_cls(max_new_tokens=8, eos_token_id=NO_EOS))]


def _jax_cached_last(jm, prompts, dtype):
    """The JAX model's forward over prompts of one length through a
    cache of `dtype` (its rows written there, then attended: what its
    engine's prefill and first decode step read), last position, as
    numpy, with the logits' dtype."""
    ids = paddle.to_tensor(np.array(prompts, np.int64))
    cache = jm.init_cache(len(prompts), len(prompts[0]), dtype)
    cache = tuple((paddle.Tensor(k), paddle.Tensor(v)) for k, v in cache)
    logits, _ = jm(ids, cache=cache, use_cache=True)
    return np.asarray(logits.numpy().astype(np.float32))[:, -1], \
        str(logits.dtype)


def _first_step(eng, prompts):
    import chip_smoke
    return chip_smoke.first_step_logits(eng, prompts)


@pytest.mark.parametrize('model,dtype,opts', [
    ('llama', 'bfloat16', {}),
    ('llama', 'bfloat16', {**PAGED, **PREFIX_CHUNK}),
    ('llama', 'float16', PAGED),
    ('llama', 'float16', {'kv_quant': 'int8'}),
    ('llama', 'bfloat16', {'kv_quant': 'int8', **PREFIX_CHUNK}),
    ('gpt', 'float16', {'kv_quant': 'int8', **PREFIX_CHUNK}),
    ('gpt', 'bfloat16', PAGED),
    ('gpt', 'float16', {})],
    ids=['llama_bf16_row', 'llama_bf16_paged_prefix_chunk',
         'llama_fp16_paged', 'llama_fp16_int8', 'llama_bf16_int8_prefix_chunk',
         'gpt_fp16_int8_prefix_chunk', 'gpt_bf16_paged', 'gpt_fp16_row'])
def test_engine_pool_dtype_matches_jax(request, model, dtype, opts):
    """An f32 model served from a bf16 or fp16 pool (row or paged, float
    or int8 pages dequantizing into that dtype, with the prefix cache and
    chunks on two cases) by both engines with the same `dtype`: the same
    greedy tokens, pools of that dtype, and (float pools) the first decode
    step's logits within 1e-4 of the JAX cached forward over a cache of
    that dtype."""
    jm, tm = request.getfixturevalue(f'{model}32')
    kw = dict(num_slots=3, max_length=64, decode_block=2, **opts)
    prompts = SHARED if opts.get('prefix_cache') else PROMPTS
    # the JAX program store would hand this engine another pool dtype's
    # int8 programs (`test_jax_store_shares_int8_programs_across_dtypes`)
    jprograms.get_store().clear_memory()
    je = JaxEngine(jm, dtype=dtype, **kw)
    te = InferenceEngine(tm, dtype=dtype, **kw)
    assert te.pool.compute_dtype == DTYPES[dtype]
    if opts.get('kv_quant'):
        assert str(je.pool.compute_dtype) == dtype
    else:
        assert te.pool.pages[0][0].dtype == DTYPES[dtype]
        assert {str(leaf.dtype) for leaf in _pool_leaves(je.pool)} == \
            {dtype}
    want = _tokens(je, prompts, JaxParams)
    got = _tokens(te, prompts, SamplingParams)
    assert got == want
    assert len({tuple(t) for t in got}) > 1
    if opts.get('kv_quant'):
        return
    flt = _first_step(InferenceEngine(tm, dtype=dtype, **{
        k: v for k, v in kw.items() if k not in PREFIX_CHUNK}),
        LOGIT_PROMPTS)
    assert flt.dtype == torch.float32
    ref, _ = _jax_cached_last(jm, LOGIT_PROMPTS, dtype)
    unrounded, _ = _jax_cached_last(jm, LOGIT_PROMPTS, 'float32')
    scale = np.abs(ref).max()
    err = np.abs(flt.numpy() - ref).max() / scale
    assert err <= 5e-4, err
    assert err < 0.5 * np.abs(flt.numpy() - unrounded).max() / scale


def test_jax_store_shares_int8_programs_across_dtypes(llama32):
    """A fault of the reference the port does not share: the JAX program
    store keys an engine's programs by the model, its geometry and
    `kv_quant`, not by the pool's compute dtype (`paddle_tpu/serving/
    engine.py:358-383`), and an int8 pool's inputs (int8 pages, f32
    scales) look the same in every compute dtype; so a bf16 int8 engine
    built after an fp16 one in the same process runs the fp16 engine's
    programs. Its tokens then differ from a fresh bf16 int8 engine's,
    which the port's engine (it captures its own graphs) matches."""
    jm, tm = llama32
    kw = dict(num_slots=3, max_length=64, decode_block=2, kv_quant='int8')
    jprograms.get_store().clear_memory()
    fresh = _tokens(JaxEngine(jm, dtype='bfloat16', **kw), PROMPTS,
                    JaxParams)
    jprograms.get_store().clear_memory()
    _tokens(JaxEngine(jm, dtype='float16', **kw), PROMPTS, JaxParams)
    stale = _tokens(JaxEngine(jm, dtype='bfloat16', **kw), PROMPTS,
                    JaxParams)
    port = _tokens(InferenceEngine(tm, dtype='bfloat16', **kw), PROMPTS,
                   SamplingParams)
    assert port == fresh
    assert stale != fresh
    jprograms.get_store().clear_memory()


def test_draft_pool_takes_the_engine_dtype(llama32):
    """A speculating engine keeps its draft's row pool in the engine's
    `dtype` too, as the JAX engine does (engine.py:295-296): both engines
    over an f32 model and a 1-layer f32 draft with bf16 pools give the
    same tokens, and the JAX pool's default would be f32."""
    jm, tm = llama32
    paddle.seed(3)
    jd, td = _pair(jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(
        num_key_value_heads=2, num_hidden_layers=1)), LlamaForCausalLM,
        LlamaConfig.tiny(num_key_value_heads=2, num_hidden_layers=1), 8.0)
    kw = dict(num_slots=3, max_length=64, decode_block=2, kv_page_size=16,
              num_draft_tokens=3, dtype='bfloat16')
    jprograms.get_store().clear_memory()
    je = JaxEngine(jm, draft_model=jd, **kw)
    te = InferenceEngine(tm, draft_model=td, **kw)
    assert te.draft_pool.pages[0][0].dtype == torch.bfloat16
    assert all(leaf.dtype == jnp.bfloat16
               for row in je.draft_pool.rows[:1] for kv in row for leaf in kv)
    assert _tokens(te, PROMPTS, SamplingParams) == \
        _tokens(je, PROMPTS, JaxParams)
    assert te.stats()['spec'] == je.stats()['spec']


def _pool_leaves(pool):
    """A JAX pool's KV leaves: the row pool's first row, or the pages."""
    rows = pool.rows[0] if hasattr(pool, 'rows') else pool.pages
    return [leaf for kv in rows for leaf in kv]


@pytest.mark.parametrize('dtype', ['bfloat16', 'float16'])
def test_default_pool_dtype_differs_from_jax(dtype):
    """The reference's fault that the port does not share: on a 2-layer
    Llama cast to bf16 (fp16), the JAX engine's default pool (row and
    paged) holds float32 leaves and its model's logits over its default
    cache are float32; the port's pools hold the model's dtype, at half
    the pool bytes. `dtype='float32'` gives the port the JAX pool."""
    paddle.seed(7)
    jm, tm = _pair(jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(
        num_key_value_heads=2)), LlamaForCausalLM,
        LlamaConfig.tiny(num_key_value_heads=2), 8.0, dtype)
    assert tm.dtype == DTYPES[dtype]
    for opts in ({}, PAGED):
        kw = dict(num_slots=2, max_length=64, **opts)
        je, te = JaxEngine(jm, **kw), InferenceEngine(tm, **kw)
        assert {str(leaf.dtype) for leaf in _pool_leaves(je.pool)} == \
            {'float32'}
        assert {t.dtype for kv in te.pool.pages for t in kv} == \
            {DTYPES[dtype]}
        assert je.pool.pool_bytes == 2 * te.pool.pool_bytes
        wide = InferenceEngine(tm, dtype='float32', **kw)
        assert wide.pool.pool_bytes == je.pool.pool_bytes
        assert te.stats()['pool']['pool_bytes'] * 2 == \
            wide.stats()['pool']['pool_bytes']
    _, logits_dtype = _jax_cached_last(jm, LOGIT_PROMPTS, None)
    assert logits_dtype == 'float32'
    _, own = _jax_cached_last(jm, LOGIT_PROMPTS, dtype)
    assert own == dtype


@pytest.mark.parametrize('opts', [{}, PAGED, {**PAGED, **PREFIX_CHUNK}],
                         ids=['row', 'paged', 'paged_prefix_chunk'])
def test_float32_pool_on_a_bf16_model_is_its_bf16_pool(opts):
    """The port's bf16 model asked for the JAX default pool
    (`dtype='float32'`) gives its own bf16 pool's tokens and first decode
    step's logits bit for bit: the pool holds the same bf16 values, the
    decode reads pages in f32 either way, and the output stays in q's
    dtype (the JAX engine promotes it to f32 instead)."""
    paddle.seed(7)
    _, tm = _pair(jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(
        num_key_value_heads=2)), LlamaForCausalLM,
        LlamaConfig.tiny(num_key_value_heads=2), 8.0, 'bfloat16')
    kw = dict(num_slots=3, max_length=64, decode_block=2, **opts)
    prompts = SHARED if opts.get('prefix_cache') else PROMPTS
    own, wide = (InferenceEngine(tm, dtype=d, **kw)
                 for d in (None, 'float32'))
    assert wide.pool.compute_dtype == torch.float32
    assert own.pool.compute_dtype == torch.bfloat16
    assert _tokens(wide, prompts, SamplingParams) == \
        _tokens(own, prompts, SamplingParams)
    a, b = (_first_step(InferenceEngine(tm, dtype=d, **{
        k: v for k, v in kw.items() if k not in PREFIX_CHUNK}),
        LOGIT_PROMPTS) for d in (None, 'float32'))
    assert a.dtype == b.dtype == torch.float32    # the engine's slab
    assert torch.equal(a, b)


_PAIRS = [(q, kv) for q in ('float32', 'bfloat16', 'float16')
          for kv in ('float32', 'bfloat16', 'float16') if q != kv]
_ROUNDING = {'float32': 0.0, 'bfloat16': 2.0 ** -8, 'float16': 2.0 ** -11}


@pytest.mark.parametrize('t_rows', [1, 5])
@pytest.mark.parametrize('int8', [False, True], ids=['float', 'int8'])
@pytest.mark.parametrize('pair', _PAIRS, ids=lambda p: f'{p[0]}-{p[1]}')
def test_paged_plain_over_another_dtype_matches_jax(pair, int8, t_rows):
    """The plain paged version over pages in another float dtype than
    q's (or int8 pages with the round's window in it), T query rows per
    slot, GQA 4 heads over 2, D = 64: against the JAX gather, dequantize
    and masked attend (`paged_attention_reference`) of each row, over
    float pages that hold the window's rows where the window stands for
    its pages; the output in q's dtype."""
    qd, kvd = pair
    rng = np.random.default_rng(len(qd) + 3 * len(kvd) + t_rows + int8)
    n, p, ps, h, hkv, d, num_pages = 4, 4, 8, 4, 2, 64, 20
    tq, tkv = DTYPES[qd], DTYPES[kvd]
    rnd = lambda shape, dt: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dt)
    table = torch.from_numpy((rng.permutation(num_pages - 1)[:n * p] + 1)
                             .reshape(n, p).astype(np.int32))
    lengths = torch.tensor([3, 9, p * ps - t_rows + 1, 1], dtype=torch.int32)
    q = rnd((n, t_rows, h, d), tq)
    win = {}
    if int8:
        kp, vp = (torch.from_numpy(rng.integers(
            -127, 128, (num_pages, ps, hkv, d)).astype(np.int8))
            for _ in range(2))
        ks, vs = (torch.from_numpy((rng.random((num_pages, hkv)) / 127
                                    + 1e-3).astype(np.float32))
                  for _ in range(2))
        first = torch.minimum((lengths - 1) // ps,
                              torch.tensor(p - 1)).to(torch.int32)
        kw, vw = rnd((n, 2, ps, hkv, d), tkv), rnd((n, 2, ps, hkv, d), tkv)
        # the JAX gather dequantizes into the pool's compute dtype
        jk, jv = ((a.float() * sc[:, None, :, None]).to(tkv).float()
                  for a, sc in ((kp, ks), (vp, vs)))
        for i in range(n):
            for c in range(2):
                if first[i] + c < p:
                    pid = table[i, first[i] + c]
                    jk[pid], jv[pid] = kw[i, c].float(), vw[i, c].float()
        win = dict(k_scales=ks, v_scales=vs, k_win=kw, v_win=vw,
                   win_first=first)
    else:
        kp, vp = rnd((num_pages, ps, hkv, d), tkv), \
            rnd((num_pages, ps, hkv, d), tkv)
        jk, jv = kp, vp
    qt = q if t_rows > 1 else q[:, 0]
    got = K.paged_attention(qt, kp, vp, table, lengths, **win)
    assert got.dtype == tq and got.shape == qt.shape
    got = got.reshape(q.shape).double().numpy()
    j = lambda a: jnp.asarray(a.float().numpy()).astype(
        {'float32': jnp.float32, 'bfloat16': jnp.bfloat16,
         'float16': jnp.float16}[str(a.dtype).replace('torch.', '')]) \
        if a.is_floating_point() else jnp.asarray(a.numpy())
    for r in range(t_rows):
        want = np.asarray(pk.paged_attention_reference(
            j(q[:, r]), j(jk), j(jv), j(table), j(lengths + r)),
            np.float64)
        scale = np.abs(want).max()
        err = np.abs(got[:, r] - want).max()
        assert err <= (_ROUNDING[qd] + 1e-5) * scale, err / scale


def test_each_pair_counts_under_a_key_of_its_own():
    """`paged_key`: every (q, pages) pair of another dtype, float or int8
    (with the window in that dtype), decode or verify, D = 128 or 64, has
    a key of its own in `LAUNCHES`; a pool in q's dtype keeps today's."""
    keys = set()
    for q in DTYPES.values():
        for kv in DTYPES.values():
            for int8 in (False, True):
                for q_dim in (3, 4):
                    for d in (128, 64):
                        key = K.paged_key(q_dim, int8, q, d, kv)
                        assert key in K.LAUNCHES
                        if kv == q:
                            assert key == K.paged_key(q_dim, int8, q, d)
                            assert '_kv' not in key
                        else:
                            keys.add(key)
    assert len(keys) == 6 * 2 * 2 * 2
    assert K.paged_key(3, False, torch.bfloat16, 128, torch.float32) == \
        'paged_attention_bf16_kvf32'
    assert K.paged_key(4, True, torch.float16, 64, torch.bfloat16) == \
        'paged_attention_verify_int8_fp16_kvbf16_d64'
