"""fp16 models in the port against the JAX package's, on the CPU.

A model cast to fp16 (`to(dtype='float16')` in the JAX package, `dtype=
'float16'` or `.half()` in the port) runs every kernel of its path in
fp16: RMSNorm, the fused cross-entropy, the paged kernel (fp16 pages, or
int8 pages with an fp16 window) and the adapter kernel (an f32 or an
fp16 bank). On the CPU each wrapper takes its plain version; this file
holds those to the Pallas modules' own functions in fp16, then the
served and trained fp16 models to the JAX package's. Inputs come from
numpy with a seed. The CUDA kernels are held to the same plain versions
on the card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances (fp16 keeps 11 significant bits: one rounding is 2^-11
relative, one ulp 2^-10):
- RMSNorm: bit-equal to the JAX model's `F.rms_norm` (the same two
  roundings); within one ulp of the Pallas kernel, which multiplies by
  the weight before its one rounding.
- CE: nll and lse (fp32) rtol 2e-4, atol 2e-5 (fp32 sums in another
  order); dlogits within one fp16 ulp of the Pallas backward, and in the
  subnormal range within one subnormal step (2^-24), with as many
  nonzero subnormals on both sides to 0.5%.
- paged and adapter outputs: within one fp16 ulp of the output's scale
  plus 1e-3 relative (fp32 sums in another order, rounded once).
- engines: greedy tokens identical. The first decode step's logits of
  the port's fp16 engine have a relative RMSE against the JAX model in
  f32 over the same fp16-valued weights at most twice that of the JAX
  package's own fp16 dense forward (the two round at other points;
  measured 0.63 and 0.85 of it); over int8 KV at most 1.25 times that of
  the float engine over its pages roundtripped through int8 (the JAX
  bench's int8 arm, chip_smoke.py's gate; measured equal).
- TrainStep (3 AdamW steps at lr 1e-3, multi_precision): losses rtol
  2e-4 (measured 4.9e-5 at most). The f32 masters: each tensor's update
  (master less the initial fp16 weight) within a relative norm error of
  0.1 of the JAX update (measured 0.068 at most); at most 0.5% of a
  tensor's elements more than lr / 10 apart (measured 0.20%), none more
  than 6 lr. An element whose fp16 gradient is near 0 differs in sign or
  zero-ness between the packages, and Adam moves it by about lr a step
  whatever the gradient's size: three steps in opposite directions are
  at most 6 lr apart (measured 4.3 lr). The port's fp16 parameters are
  its masters rounded, bit for bit, so each is within the masters'
  difference plus one ulp of the JAX parameter.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import quantization as jquant
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.nlp import gpt as jgpt
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.serving import AdapterBank as JaxBank
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu.serving import make_adapter_factors as jax_factors
from paddle_tpu.tensor import Tensor as JTensor
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nlp import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                  LlamaForCausalLM)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import (AdapterBank, InferenceEngine,
                                      SamplingParams, make_adapter_factors)
from paddle_tpu_torch.weights import from_jax_adapter_arrays, from_jax_state
from test_torch_observability import isolated_observability

H = torch.float16
ULP = 2.0 ** -10          # one fp16 ulp at 1.0
SUB_STEP = 2.0 ** -24     # fp16's subnormal spacing
NO_EOS = -1
TARGETS = ('q_proj', 'k_proj', 'v_proj', 'o_proj')


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


def _rng(seed):
    return np.random.default_rng(seed)


def _f16(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float16)


def _close_f16(got, want, rel=1e-3):
    """Within one fp16 ulp of the output's scale plus `rel` of it."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= (ULP + rel) * scale, \
        np.abs(got - want).max() / scale


# ---------------------------------------------------------------------------
# the kernels' plain versions in fp16 against the Pallas modules' functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('rows,width', [(3, 64), (40, 256)])
def test_fp16_rms_plain_matches_functional_and_pallas(rows, width):
    """fp16 RMSNorm: bit-equal to the JAX model's `F.rms_norm` (normalize
    in fp32, round, then the weight product in fp16), within one ulp of
    the Pallas kernel in interpret mode (one rounding after the weight),
    and the port's `F.rms_norm` equal to its plain version."""
    rng = _rng(rows + width)
    x = _f16(rng, (rows, width), 3.0)
    w = (1 + 0.1 * rng.standard_normal(width)).astype(np.float16)
    got = K.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    assert got.dtype == H
    want = np.asarray(JF.rms_norm(JTensor(jnp.asarray(x)),
                                  JTensor(jnp.asarray(w)),
                                  epsilon=1e-6).value)
    assert want.dtype == np.float16
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = np.asarray(pk.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6,
                                    interpret=True))
    assert pallas.dtype == np.float16
    np.testing.assert_allclose(got.numpy().astype(np.float32),
                               pallas.astype(np.float32), rtol=ULP, atol=0)
    assert torch.equal(F.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                                  1e-6), got)


def _ce_both(x, lab, g):
    """((nll, lse, dlogits) of the port's plain versions, the same of the
    Pallas kernels in interpret mode), fp16 logits."""
    tx, tl, tg = (torch.from_numpy(a) for a in (x, lab, g))
    nll, lse = K.softmax_cross_entropy_fwd(tx, tl)
    dx = K.softmax_cross_entropy_bwd(tx, tl, lse, tg)
    jx, jl = jnp.asarray(x), jnp.asarray(lab)
    jnll, jlse = pk.softmax_cross_entropy_fwd(jx, jl, interpret=True)
    jdx = pk.softmax_cross_entropy_bwd(jx, jl, jlse, jnp.asarray(g),
                                       interpret=True)
    return ((nll.numpy(), lse.numpy(), dx.numpy()),
            (np.asarray(jnll), np.asarray(jlse), np.asarray(jdx)))


def _subnormal(a):
    a = np.abs(np.asarray(a, np.float32))
    return (a > 0) & (a < np.finfo(np.float16).tiny)


@pytest.mark.parametrize('case', ['unit', 'subnormal', 'near_max'])
def test_fp16_ce_plain_matches_pallas_interpret(case):
    """fp16 logits through the CE forward and backward, against the
    Pallas kernels in interpret mode: unit-scale logits and gradients;
    dlogits mostly subnormal (a mean over many rows of a wide vocab:
    p ~ 1/V times g ~ 1/N), kept, not flushed, as `.to(torch.float16)`
    keeps them; logits near fp16's largest value 65504."""
    rng = _rng({'unit': 1, 'subnormal': 2, 'near_max': 3}[case])
    n, v = 37, 2500
    x = _f16(rng, (n, v), 3.0)
    g = rng.standard_normal(n).astype(np.float32)
    if case == 'subnormal':
        x = _f16(rng, (n, v))
        g = np.full(n, 1.0 / 4096, np.float32)
    if case == 'near_max':
        x[:, :7] = np.float16(65504)
        x[::3, 7] = np.float16(-65504)
    lab = rng.integers(0, v, (n,)).astype(np.int32)
    (nll, lse, dx), (jnll, jlse, jdx) = _ce_both(x, lab, g)
    assert dx.dtype == np.float16 and jdx.dtype == np.float16
    np.testing.assert_allclose(nll, jnll, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(lse, jlse, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(dx.astype(np.float32), jdx.astype(np.float32),
                               rtol=ULP, atol=SUB_STEP)
    sub, jsub = _subnormal(dx), _subnormal(jdx)
    assert abs(int(sub.sum()) - int(jsub.sum())) <= 0.005 * max(
        int(jsub.sum()), 1)
    if case == 'subnormal':
        assert sub.mean() > 0.5       # what the case says it is
        assert np.all(np.isfinite(dx))


def _paged_pages(rng, num_pages, ps, hkv, d, quant):
    if quant:
        kp, vp = (rng.integers(-127, 128, (num_pages, ps, hkv, d))
                  .astype(np.int8) for _ in range(2))
        ks, vs = ((rng.random((num_pages, hkv)) / 127 + 1e-3)
                  .astype(np.float32) for _ in range(2))
        return kp, vp, ks, vs
    return (_f16(rng, (num_pages, ps, hkv, d)),
            _f16(rng, (num_pages, ps, hkv, d)), None, None)


@pytest.mark.parametrize('d', [64, 128])
@pytest.mark.parametrize('t_rows', [1, 5])
@pytest.mark.parametrize('pages', ['fp16', 'int8_window'])
def test_fp16_paged_plain_matches_reference(pages, t_rows, d):
    """An fp16 q over fp16 pages, or over int8 pages with the decode
    round's fp16 window, T query rows per slot (1: decode; 5: a
    speculative verify, row t seeing lengths + t keys), GQA 4 heads over
    2: against the JAX `paged_attention_reference` applied to each row,
    over float pages that hold the window's rows where the window stands
    for its pages."""
    rng = _rng(d + t_rows + len(pages))
    n, p, ps, h, hkv, num_pages = 4, 4, 8, 4, 2, 20
    quant = pages != 'fp16'
    kp, vp, ks, vs = _paged_pages(rng, num_pages, ps, hkv, d, quant)
    table = (rng.permutation(num_pages - 1)[:n * p] + 1).reshape(
        n, p).astype(np.int32)
    lengths = np.array([3, 9, p * ps - t_rows + 1, 1], np.int32)
    q = _f16(rng, (n, t_rows, h, d))
    win, jk, jv, jks, jvs = {}, kp, vp, ks, vs
    if quant:
        w = 2
        first = np.minimum((lengths - 1) // ps, p - 1).astype(np.int32)
        kw, vw = _f16(rng, (n, w, ps, hkv, d)), _f16(rng, (n, w, ps, hkv, d))
        jk, jv = (np.array(jquant.kv_dequantize_page(
            jnp.asarray(a), jnp.asarray(sc), jnp.float32))
            for a, sc in ((kp, ks), (vp, vs)))
        for i in range(n):
            for c in range(w):
                if first[i] + c < p:
                    pid = table[i, first[i] + c]
                    jk[pid], jv[pid] = kw[i, c], vw[i, c]
        win = dict(k_win=torch.from_numpy(kw), v_win=torch.from_numpy(vw),
                   win_first=torch.from_numpy(first))
        jks = jvs = None
    tt = lambda a: None if a is None else torch.from_numpy(a)
    qt = tt(q) if t_rows > 1 else tt(q[:, 0])
    got = K.paged_attention(qt, tt(kp), tt(vp), tt(table), tt(lengths),
                            k_scales=tt(ks), v_scales=tt(vs), **win)
    assert got.dtype == H and got.shape == qt.shape
    got = got.numpy().reshape(q.shape)
    j = lambda a: None if a is None else jnp.asarray(a)
    for r in range(t_rows):
        want = np.asarray(pk.paged_attention_reference(
            j(q[:, r]), j(jk), j(jv), j(table), j(lengths + r),
            k_scales=j(jks), v_scales=j(jvs)))
        assert want.dtype == np.float16
        _close_f16(got[:, r], want)


@pytest.mark.parametrize('bank', ['float32', 'float16'])
@pytest.mark.parametrize('t', [1, 5])
def test_fp16_adapter_plain_matches_reference(bank, t):
    """An fp16 x over an f32 bank (the JAX bank's default) and over an
    fp16 bank: the delta against the JAX `adapter_matmul_reference` and
    the Pallas kernel in interpret mode, the fused add against the JAX
    hook's y + delta; rows on slot 0 give y bit for bit."""
    rng = _rng(t + len(bank))
    b, hdim, r, o, c = 4, 64, 8, 48, 3
    x = _f16(rng, (b, t, hdim))
    a_bank = (0.2 * rng.standard_normal((c, hdim, r))).astype(bank)
    b_bank = (0.2 * rng.standard_normal((c, r, o))).astype(bank)
    a_bank[0], b_bank[0] = 0, 0
    scale = np.array([0.0, 0.5, 1.5], np.float32)
    rows = np.array([1, 0, 2, 1], np.int32)
    y = _f16(rng, (b, t, o))
    args = [torch.from_numpy(a) for a in (x, a_bank, b_bank, rows, scale)]
    jargs = [jnp.asarray(a) for a in (x, a_bank, b_bank, rows, scale)]
    got = K.adapter_matmul(*args)
    assert got.dtype == H
    want = np.asarray(pk.adapter_matmul_reference(*jargs))
    np.testing.assert_array_equal(
        np.asarray(pk.adapter_matmul(*jargs, interpret=True)), want)
    _close_f16(got.numpy(), want)
    fused = K.adapter_matmul_add(torch.from_numpy(y), *args)
    want_add = np.asarray(jnp.asarray(y) + jnp.asarray(want))
    _close_f16(fused.numpy(), want_add)
    assert np.array_equal(fused.numpy()[1], y[1])


def test_fp16_layer_norm_follows_the_jax_order():
    """fp16 LayerNorm takes mean and variance in fp16, the JAX order
    (`paddle_tpu/nn/functional.py:292-302`), against the JAX CPU result:
    at most two fp16 ulps of the output's scale apart, on at most half of
    the elements, rel_norm below 1e-3 (measured 1.5 ulps, 41.7%, 5.3e-4;
    torch's fused op, which accumulates in fp32: 1.0, 56.6%, 5.7e-4)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 768)).astype(np.float32) * 3 + 1
    w = (1 + 0.1 * rng.standard_normal(768)).astype(np.float32)
    b = (0.1 * rng.standard_normal(768)).astype(np.float32)
    want = np.asarray(JF.layer_norm(
        paddle.to_tensor(x).astype('float16'), 768,
        paddle.to_tensor(w).astype('float16'),
        paddle.to_tensor(b).astype('float16')).astype('float32').numpy())
    got = F.layer_norm(torch.from_numpy(x).half(), 768,
                       torch.from_numpy(w).half(),
                       torch.from_numpy(b).half())
    assert got.dtype == H
    got = got.float().numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 9)
    assert (diff > 0).mean() <= 0.5
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-3


def test_fp16_weights_carry_bit_for_bit(llama16):
    """`from_jax_state` carries np.float16 arrays into an fp16 model, and
    `from_jax_adapter_arrays` into an fp16 bank, bit for bit."""
    jm, tm, _ = llama16
    for name, v in jm.state_dict().items():
        got = tm.state_dict()[name]
        assert got.dtype == H
        np.testing.assert_array_equal(got.numpy(), np.asarray(v.numpy()))
    jbank = JaxBank(jm, capacity=2, rank=4, dtype='float16', targets=TARGETS)
    jbank.load('ad0', jax_factors(jbank, seed=3, scale=0.3), version=1)
    tbank = AdapterBank(tm, capacity=2, rank=4, dtype='float16',
                        targets=TARGETS)
    tbank.load('ad0', make_adapter_factors(tbank, seed=3, scale=0.3),
               version=1)
    arrays = jax.tree_util.tree_map(np.asarray, jbank.device_arrays())
    from_jax_adapter_arrays(arrays, tbank)
    got = tbank.device_arrays()
    for site, fac in arrays['factors'].items():
        for k in ('a', 'b'):
            assert got['factors'][site][k].dtype == H
            np.testing.assert_array_equal(got['factors'][site][k].numpy(),
                                          fac[k])
    tbank.detach()


# ---------------------------------------------------------------------------
# fp16 models served by both engines
# ---------------------------------------------------------------------------

def _fp16_pair(jm, tm_cls, tm_cfg, scale):
    """(JAX model in fp16, port model in fp16, JAX model in f32 over the
    same fp16-valued weights): the JAX model's matrices times `scale`
    (so that greedy tokens vary), cast to fp16, carried to the port as
    np.float16 arrays."""
    jm.set_state_dict({k: paddle.to_tensor(np.asarray(v.numpy()) * (
        scale if v.ndim == 2 else 1.0)) for k, v in jm.state_dict().items()})
    jm.to(dtype='float16')
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    assert all(a.dtype == np.float16 for a in state.values())
    tm = from_jax_state(state, tm_cls(tm_cfg, device='cpu',
                                      dtype='float16')).eval()
    j32 = type(jm)(jm.config).eval()
    j32.set_state_dict({k: paddle.to_tensor(v.astype(np.float32))
                        for k, v in state.items()})
    return jm, tm, j32


@pytest.fixture(scope='module')
def llama16():
    """The tiny GQA Llama, matrices x 8."""
    paddle.seed(11)
    return _fp16_pair(jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(
        num_key_value_heads=2)).eval(), LlamaForCausalLM,
        LlamaConfig.tiny(num_key_value_heads=2), 8.0)


@pytest.fixture(scope='module')
def gpt16():
    """The tiny GPT of head_dim 64 (2 heads x 64), matrices x 4."""
    paddle.seed(5)
    cfg = dict(hidden_size=128, num_attention_heads=2)
    return _fp16_pair(jgpt.GPTForCausalLM(jgpt.GPTConfig.tiny(**cfg)).eval(),
                      GPTForCausalLM, GPTConfig.tiny(**cfg), 4.0)


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, (s,)).tolist() for s in lens]


PROMPTS = _prompts([3, 9, 5, 14, 30, 17])
# a request sharing 24 tokens (a whole page and a half) of one before it
SHARED = PROMPTS + [PROMPTS[4][:24] + PROMPTS[1]]
PREFIX_CHUNK = {'prefix_cache': 0.5, 'prefill_chunk_tokens': 16}


def _dense_last(jm, prompts):
    """The JAX model's dense forward over prompts of one length (one
    batch), last position, in f32."""
    out = jm(paddle.to_tensor(np.array(prompts, np.int64))).numpy()
    return np.asarray(out, np.float32)[:, -1]


# the first decode step's logits: three prompts of one length, so that
# the JAX model's dense forward runs them as one batch
LOGIT_PROMPTS = _prompts([11, 11, 11], seed=1)


def _rel_rmse(got, want):
    ref = want - want.mean(axis=-1, keepdims=True)
    return float(np.linalg.norm(got - want) / np.linalg.norm(ref))


@pytest.mark.parametrize('model,opts,bank', [
    ('llama', PREFIX_CHUNK, 'float32'),
    ('llama', {'kv_quant': 'int8'}, 'float16'),
    ('gpt', {'kv_quant': 'int8', **PREFIX_CHUNK}, None)],
    ids=['llama_prefix_chunk_f32_bank', 'llama_int8_fp16_bank',
         'gpt_d64_int8_prefix_chunk'])
def test_fp16_engine_matches_jax(request, model, opts, bank):
    """An fp16 model served by the port's engine and the JAX engine
    (3 slots, decode_block 2, pages of 16): identical greedy tokens, with
    the prefix cache and chunks, int8 KV, and a bank (f32 or fp16, its
    factors carried from the JAX bank) on a mixed wave; the first decode
    step's logits of a bank-less engine against the JAX model in f32
    (float KV) and against the bench's int8 arm (int8 KV), as the module
    note says."""
    jm, tm, j32 = request.getfixturevalue(f'{model}16')
    kw = dict(num_slots=3, max_length=64, decode_block=2, kv_page_size=16,
              **opts)
    prompts = SHARED if opts.get('prefix_cache') else PROMPTS
    ids, jkw, tkw = None, dict(kw), dict(kw)
    if bank is not None:
        targets = dict(targets=TARGETS)
        jbank = JaxBank(jm, capacity=3, rank=4, dtype=bank, **targets)
        tbank = AdapterBank(tm, capacity=3, rank=4, dtype=bank, **targets)
        for i in range(2):
            jbank.load(f'ad{i}', jax_factors(jbank, seed=1 + i, scale=0.3),
                       version=1)
            tbank.load(f'ad{i}', make_adapter_factors(tbank, seed=1 + i,
                                                      scale=0.3), version=1)
        from_jax_adapter_arrays(jax.tree_util.tree_map(
            np.asarray, jbank.device_arrays()), tbank)
        assert tbank.dtype == (H if bank == 'float16' else torch.float32)
        jkw['adapter_bank'], tkw['adapter_bank'] = jbank, tbank
        ids = [(None, 'ad0', 'ad1')[i % 3] for i in range(len(prompts))]
    je, te = JaxEngine(jm, **jkw), InferenceEngine(tm, **tkw)
    hj = je.generate_many(prompts, JaxParams(max_new_tokens=8,
                                             eos_token_id=NO_EOS),
                          adapter_ids=ids)
    ht = te.generate_many(prompts, SamplingParams(max_new_tokens=8,
                                                  eos_token_id=NO_EOS),
                          adapter_ids=ids)
    assert [h.tokens for h in ht] == [h.tokens for h in hj]
    assert len({tuple(h.tokens) for h in ht}) > 1
    if bank is not None:
        tbank.detach()
    # the first decode step's logits (`chip_smoke.first_step_logits`: the
    # step that reads each prompt's last token over its prefilled pages)
    import chip_smoke
    fe = InferenceEngine(tm, **{k: v for k, v in kw.items()
                                if k != 'kv_quant'})
    flt = chip_smoke.first_step_logits(fe, LOGIT_PROMPTS).float().numpy()
    ref = _dense_last(j32, LOGIT_PROMPTS)
    assert np.all(np.isfinite(flt))
    assert _rel_rmse(flt, ref) <= 2 * _rel_rmse(_dense_last(jm, LOGIT_PROMPTS),
                                                ref)
    if opts.get('kv_quant'):
        q8 = chip_smoke.first_step_logits(InferenceEngine(tm, **kw),
                                          LOGIT_PROMPTS).float().numpy()
        trip = chip_smoke.first_step_logits(fe, LOGIT_PROMPTS,
                                            roundtrip=True).float().numpy()
        assert np.all(np.isfinite(q8))
        assert _rel_rmse(q8, flt) <= 1.25 * _rel_rmse(trip, flt)


# ---------------------------------------------------------------------------
# an fp16 TrainStep
# ---------------------------------------------------------------------------

TRAIN_LR = 1e-3


@pytest.mark.parametrize('vocab', [128, 8192],
                         ids=['v128', 'v8192_subnormal_dlogits'])
def test_fp16_train_step_matches_jax(vocab):
    """The tiny GQA Llama in fp16 (the JAX model's `to(dtype='float16')`,
    its np.float16 weights carried to the port), 3 steps of each
    package's TrainStep with AdamW(multi_precision=True): fp16 parameters,
    f32 masters and moments, the next-token CE on fp16 logits and its
    backward, no loss scaling (as the JAX TrainStep). At vocab 8192 the
    mean loss's dlogits (p ~ 1/8192 times g = 1/46) lie in fp16's
    subnormal range, where they are kept, not flushed. Losses, masters
    and fp16 parameters as the module note says."""
    def jax_loss(logits, labels):
        return JF.cross_entropy(logits[:, :-1].reshape([-1, vocab]),
                                labels[:, 1:].reshape([-1]))

    def torch_loss(logits, labels):
        return F.cross_entropy(logits[:, :-1].reshape(-1, vocab),
                               labels[:, 1:].reshape(-1))

    paddle.seed(7)
    cfg = dict(num_key_value_heads=2, vocab_size=vocab)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(**cfg))
    jm.to(dtype='float16')
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    assert all(a.dtype == np.float16 for a in state.values())
    tm = from_jax_state(state, LlamaForCausalLM(
        LlamaConfig.tiny(**cfg), device='cpu', dtype='float16'))
    jstep = JaxTrainStep(jm, jax_loss, JaxAdamW(
        learning_rate=TRAIN_LR, parameters=jm.parameters(),
        multi_precision=True))
    tstep = TrainStep(tm, torch_loss, AdamW(
        learning_rate=TRAIN_LR, parameters=tm.parameters(),
        multi_precision=True))
    rng = np.random.RandomState(0)
    for _ in range(3):
        ids = rng.randint(0, vocab, (2, 24))
        want = float(jstep(ids, ids).numpy())
        got = tstep(ids, ids)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=2e-4)
    jmaster = {n: np.asarray(s['master'], np.float32)
               for n, s in jstep._opt_state['slots'].items()}
    tmaster = {n: s['master'].numpy()
               for n, s in tstep.opt_state()['slots'].items()}
    assert set(tmaster) == set(jmaster) == set(state)
    jsd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    for name, tp in tm.state_dict().items():
        tp, jp = tp.numpy(), jsd[name]
        assert tp.dtype == jp.dtype == np.float16
        tmm, jmm = tmaster[name], jmaster[name]
        p0 = state[name].astype(np.float32)
        rel = (np.linalg.norm((tmm - p0) - (jmm - p0))
               / np.linalg.norm(jmm - p0))
        assert rel <= 0.1, (name, rel)
        diff = np.abs(tmm - jmm)
        assert (diff > TRAIN_LR / 10).mean() <= 0.005, name
        assert diff.max() <= 6 * TRAIN_LR, name
        np.testing.assert_array_equal(tp, tmm.astype(np.float16))
        ulp = np.spacing(np.maximum(np.abs(tp), np.abs(jp)))
        assert np.all(np.abs(tp.astype(np.float32) - jp.astype(np.float32))
                      <= diff + ulp), name
