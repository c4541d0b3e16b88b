"""Multi-tenant LoRA serving in the port (paddle_tpu_torch.serving.adapters
and the engine's adapter_id path) against the JAX package, on the CPU.

- The plain `adapter_matmul_reference` and the `adapter_matmul` wrapper
  (which takes the plain version for CPU tensors) against the JAX
  `adapter_matmul` in interpret mode and `adapter_matmul_reference`:
  f32 to rtol/atol 2e-5 (sums in another order), bf16 to one bf16 ulp
  (both round one fp32 result once); `adapter_matmul_add` and its plain
  version against the JAX hook's `y + adapter_matmul(...)` to the same
  tolerance, and rows on slot 0 returning y bit for bit.
- The bank's slot table, pinning, LRU eviction and validation, mirroring
  the non-store tests of tests/test_adapters.py.
- The port's engine with a bank against the JAX
  `InferenceEngine(kv_page_size=16, adapter_bank=...)` on the tiny GQA
  Llama with weights from `from_jax_state` and factors from both
  packages' `make_adapter_factors`: identical greedy tokens per request.

Inputs come from numpy with a seed. The CUDA kernel itself is held to
the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.serving import AdapterBank as JaxBank
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu.serving import make_adapter_factors as jax_factors
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.serving import (FAILED, FINISHED, AdapterBank,
                                      AdapterUnavailable, InferenceEngine,
                                      SamplingParams, make_adapter_factors)
from paddle_tpu_torch.serving.adapters import DEFAULT_TARGETS, adapter_scope
from paddle_tpu_torch.weights import from_jax_adapter_arrays, from_jax_state

NO_EOS = -1
TARGETS = ('q_proj', 'k_proj', 'v_proj', 'o_proj')   # Llama's projections
TORCH_DTYPE = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
JAX_DTYPE = {'float32': jnp.float32, 'bfloat16': jnp.bfloat16}


@pytest.fixture(autouse=True, scope='module')
def _reset_jax_metrics():
    """The JAX bank and engine record into the JAX package's
    process-global metrics registry; zero it after this module so later
    test files in the same process start from a clean registry."""
    yield
    jax_metrics.get_registry().reset()


# ---------------------------------------------------------------------------
# the kernel's plain version and wrapper against the JAX oracles
# ---------------------------------------------------------------------------

def _kernel_case(b=4, t=1, h=64, r=4, o=96, c=3, seed=0):
    """f32 numpy inputs: x [b, t, h], banks [c + 1, ...] with a zero slot
    0, scales (0 for slot 0), and rows mixing slot 0 with repeated
    slots."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((b, t, h)).astype(np.float32)
    a = rng.standard_normal((c + 1, h, r)).astype(np.float32) * 0.1
    bb = rng.standard_normal((c + 1, r, o)).astype(np.float32) * 0.1
    a[0], bb[0] = 0.0, 0.0
    scale = rng.uniform(0.5, 2.0, (c + 1,)).astype(np.float32)
    scale[0] = 0.0
    rows = np.array([0, 2, 2, c] + [1] * (b - 4), np.int32)[:b]
    return x, a, bb, rows, scale


def _to_torch(x, a, b, rows, scale, x_dtype, w_dtype):
    return (torch.from_numpy(x).to(TORCH_DTYPE[x_dtype]),
            torch.from_numpy(a).to(TORCH_DTYPE[w_dtype]),
            torch.from_numpy(b).to(TORCH_DTYPE[w_dtype]),
            torch.from_numpy(rows), torch.from_numpy(scale))


def _to_jax(x, a, b, rows, scale, x_dtype, w_dtype):
    return (jnp.asarray(x, JAX_DTYPE[x_dtype]),
            jnp.asarray(a, JAX_DTYPE[w_dtype]),
            jnp.asarray(b, JAX_DTYPE[w_dtype]),
            jnp.asarray(rows), jnp.asarray(scale))


def _f32(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(v).astype(np.float32)


def _assert_close(got, want, x_dtype):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if x_dtype == 'float32':
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        return
    # one bf16 ulp (8 significant bits) of the larger of the two values
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                     np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)


@pytest.mark.parametrize('w_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('x_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('t', [1, 8])
def test_plain_and_wrapper_match_jax(t, x_dtype, w_dtype):
    case = _kernel_case(t=t, seed=7 + t)
    tx = _to_torch(*case, x_dtype, w_dtype)
    jx = _to_jax(*case, x_dtype, w_dtype)
    want_pallas = pk.adapter_matmul(*jx, interpret=True)
    want_ref = pk.adapter_matmul_reference(*jx)
    got_ref = K.adapter_matmul_reference(*tx)
    got = K.adapter_matmul(*tx)
    assert got.dtype == got_ref.dtype == TORCH_DTYPE[x_dtype]
    assert tuple(got.shape) == (4, t, 96)
    for g in (got, got_ref):
        for w in (want_pallas, want_ref):
            _assert_close(g, w, x_dtype)


@pytest.mark.parametrize('x_dtype', ['float32', 'bfloat16'])
def test_slot_zero_rows_are_exactly_zero(x_dtype):
    """Rows on bank slot 0 get a bit-exact zero delta (zero factors,
    scale 0): base requests on a banked engine stay bit-identical."""
    x, a, b, rows, scale = _kernel_case(b=6, t=3, seed=9)
    tx = _to_torch(x, a, b, rows, scale, x_dtype, 'float32')
    for out in (K.adapter_matmul(*tx), K.adapter_matmul_reference(*tx)):
        base = out[torch.from_numpy(rows == 0)]
        assert base.numel() > 0 and torch.equal(base, torch.zeros_like(base))
        assert out[torch.from_numpy(rows != 0)].abs().sum() > 0


def _y(b, t, o, seed):
    """f32 numpy y of the delta's scale (so an add that drops or doubles
    the delta is far outside the tolerance)."""
    y = np.random.RandomState(seed).standard_normal((b, t, o))
    return (0.1 * y).astype(np.float32)


@pytest.mark.parametrize('w_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('x_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('t', [1, 8])
def test_add_plain_and_wrapper_match_jax(t, x_dtype, w_dtype):
    """adapter_matmul_add (y + delta in one pass) and its plain version
    against the JAX hook's sum: y + adapter_matmul(..., interpret=True),
    the delta in x.dtype added in y's dtype (= x.dtype)."""
    case = _kernel_case(t=t, seed=17 + t)
    y = _y(4, t, 96, seed=t)
    tx = _to_torch(*case, x_dtype, w_dtype)
    jx = _to_jax(*case, x_dtype, w_dtype)
    yt = torch.from_numpy(y).to(TORCH_DTYPE[x_dtype])
    yj = jnp.asarray(y, JAX_DTYPE[x_dtype])
    want = yj + pk.adapter_matmul(*jx, interpret=True)
    assert want.dtype == JAX_DTYPE[x_dtype]
    got = K.adapter_matmul_add(yt, *tx)
    got_ref = K.adapter_matmul_add_reference(yt, *tx)
    assert got.dtype == got_ref.dtype == TORCH_DTYPE[x_dtype]
    assert tuple(got.shape) == (4, t, 96)
    for g in (got, got_ref):
        _assert_close(g, want, x_dtype)
    if t == 1:       # a decode call's 2-D y gives a 2-D result
        flat = K.adapter_matmul_add(yt[:, 0], *tx)
        assert flat.shape == (4, 96) and torch.equal(flat, got[:, 0])


@pytest.mark.parametrize('x_dtype', ['float32', 'bfloat16'])
def test_add_slot_zero_rows_return_y_bit_for_bit(x_dtype):
    x, a, b, rows, scale = _kernel_case(b=6, t=3, seed=19)
    tx = _to_torch(x, a, b, rows, scale, x_dtype, 'float32')
    y = torch.from_numpy(_y(6, 3, 96, seed=5)).to(
        TORCH_DTYPE[x_dtype])
    base = torch.from_numpy(rows == 0)
    for out in (K.adapter_matmul_add(y, *tx),
                K.adapter_matmul_add_reference(y, *tx)):
        assert base.any() and torch.equal(out[base], y[base])
        assert not torch.equal(out[~base], y[~base])


def test_add_wrapper_raises_on_a_y_it_does_not_take():
    x, a, b, rows, scale = _kernel_case(t=2, seed=3)
    tx = _to_torch(x, a, b, rows, scale, 'float32', 'float32')
    y = torch.zeros((4, 2, 96))
    with pytest.raises(ValueError, match='takes y'):       # y's dtype
        K.adapter_matmul_add(y.bfloat16(), *tx)
    with pytest.raises(ValueError, match='takes y'):       # y's width
        K.adapter_matmul_add(y[:, :, :95], *tx)
    with pytest.raises(ValueError, match='takes y'):       # 2-D y, T = 2
        K.adapter_matmul_add(y[:, 0], *tx)
    with pytest.raises(ValueError, match='no kernel for device'):
        K.adapter_matmul_add(y.to('meta'), *(u.to('meta') for u in tx))


def test_rows_match_per_row_product():
    """Each row's delta is x_i A[s] B[s] scale[s] of its own slot s: the
    gather never leaks a neighbour's factors."""
    x, a, b, rows, scale = _kernel_case(b=6, t=2, c=4, seed=11)
    got = K.adapter_matmul(*_to_torch(x, a, b, rows, scale, 'float32',
                                      'float32')).numpy()
    for i, s in enumerate(rows):
        want = x[i].astype(np.float64) @ a[s] @ b[s] * scale[s]
        np.testing.assert_allclose(got[i], want, rtol=2e-5, atol=2e-5)


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    x, a, b, rows, scale = _kernel_case(seed=3)
    tx = _to_torch(x, a, b, rows, scale, 'float32', 'float32')
    with pytest.raises(ValueError, match='no kernel for device'):
        K.adapter_matmul(*(u.to('meta') for u in tx))
    wide = np.zeros((4, 64, 65), np.float32)
    with pytest.raises(ValueError, match='rank'):
        K.adapter_matmul(tx[0], torch.from_numpy(wide),
                         torch.zeros((4, 65, 96)), tx[3], tx[4])
    with pytest.raises(ValueError, match='shapes'):
        K.adapter_matmul(tx[0], tx[1], tx[2][:, :, :10].transpose(1, 2),
                         tx[3], tx[4])
    with pytest.raises(ValueError, match='shapes'):
        K.adapter_matmul(tx[0], tx[1], tx[2], tx[3][:2], tx[4])


# ---------------------------------------------------------------------------
# the bank
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


def _factors(bank, seed, maker=make_adapter_factors):
    """Factors strong enough to flip greedy tokens on the tiny model (as
    tests/test_adapters.py uses)."""
    return maker(bank, seed=seed, scale=0.2)


def _bank(tm, n_adapters=2, capacity=None, rank=4, **kw):
    bank = AdapterBank(tm, capacity=capacity or n_adapters + 1, rank=rank,
                       targets=TARGETS, **kw)
    for i in range(n_adapters):
        bank.load(f'ad{i}', _factors(bank, 1 + i), version=1)
    return bank


def _jax_bank(jm, n_adapters=2, capacity=None, rank=4):
    bank = JaxBank(jm, capacity=capacity or n_adapters + 1, rank=rank,
                   targets=TARGETS)
    for i in range(n_adapters):
        bank.load(f'ad{i}', _factors(bank, 1 + i, jax_factors), version=1)
    return bank


def test_ctor_validation(models):
    jm, tm = models
    with pytest.raises(ValueError):
        AdapterBank(tm, capacity=0, targets=TARGETS)
    with pytest.raises(ValueError):
        AdapterBank(tm, rank=0, targets=TARGETS)
    with pytest.raises(ValueError, match='rank'):
        AdapterBank(tm, rank=K.ADAPTER_MAX_RANK + 1, targets=TARGETS)
    with pytest.raises(ValueError):
        AdapterBank(tm, targets=('no_such_proj',))
    # the default targets name no Llama projection, in both packages
    assert DEFAULT_TARGETS == ('qkv_proj', 'out_proj')
    for make in (lambda: AdapterBank(tm), lambda: JaxBank(jm)):
        with pytest.raises(ValueError, match='nothing to adapt'):
            make()


def test_store_backed_half_is_not_ported(models, tmp_path):
    """The store-backed half is ported now (tests/test_torch_adapter_store.py
    holds it against the JAX bank): `store_dir=` builds, `publish`
    commits a version, and the adapter is servable but not resident."""
    _, tm = models
    bank = AdapterBank(tm, capacity=2, rank=4, targets=TARGETS,
                       store_dir=str(tmp_path))
    assert bank.publish('ad9', _factors(bank, 9)) == 1
    assert bank.available('ad9') and bank.lookup('ad9') is None
    assert bank.pin('ad9') == (1, 1)


def test_sites_and_statics_match_jax(models):
    jm, tm = models
    bank, jbank = AdapterBank(tm, capacity=4, rank=4, targets=TARGETS), \
        JaxBank(jm, capacity=4, rank=4, targets=TARGETS)
    assert bank.sites == jbank.sites and len(bank.sites) == 8
    st0 = bank.describe_statics()
    assert st0 == jbank.describe_statics() == {
        'capacity': 4, 'rank': 4, 'targets': tuple(sorted(bank.sites))}
    bank.load('a', make_adapter_factors(bank, 1))
    assert bank.describe_statics() == st0


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_device_arrays_shapes_and_zero_base_row(models, dtype):
    _, tm = models
    bank = AdapterBank(tm, capacity=3, rank=4, targets=TARGETS, dtype=dtype)
    arrs = bank.device_arrays()
    assert set(arrs) == {'factors', 'scale'}
    assert arrs['scale'].shape == (4,) and arrs['scale'].dtype == torch.float32
    for site, (i, o) in bank.sites.items():
        a, b = arrs['factors'][site]['a'], arrs['factors'][site]['b']
        assert a.shape == (4, i, 4) and b.shape == (4, 4, o)
        assert a.dtype == b.dtype == TORCH_DTYPE[dtype]
        assert a.device == tm.device
        assert not a[0].any() and not b[0].any()
    assert float(arrs['scale'][0]) == 0.0


def test_load_lookup_stats(models):
    _, tm = models
    bank = _bank(tm, 2)
    assert bank.lookup('ad0') == (1, 1)
    assert bank.lookup('ad1') == (2, 1)
    assert bank.lookup('ghost') is None
    assert bank.available('ad0') and not bank.available('ghost')
    st = bank.stats()
    assert st['pinned'] == 0 and st['sites'] == 8
    assert set(st['resident']) == {'ad0', 'ad1'}
    assert st['resident']['ad0'] == {'slot': 1, 'version': 1, 'refs': 0}


def test_pin_unpin_refcounts(models):
    _, tm = models
    bank = _bank(tm, 1)
    slot, ver = bank.pin('ad0')
    assert (slot, ver) == (1, 1)
    bank.pin('ad0')
    assert bank.stats()['resident']['ad0']['refs'] == 2
    bank.unpin(slot)
    bank.unpin(slot)
    assert bank.stats()['pinned'] == 0
    with pytest.raises(RuntimeError):
        bank.unpin(slot)
    bank.unpin(0)          # the base slot is never refcounted


def test_pin_unknown_raises_typed(models):
    _, tm = models
    with pytest.raises(AdapterUnavailable) as ei:
        _bank(tm, 1).pin('ghost')
    assert ei.value.adapter_id == 'ghost' and not ei.value.transient


def test_lru_evicts_oldest_zero_ref_slot_like_jax(models):
    """A bank full of unpinned adapters: the least recently pinned one
    yields its slot to the newcomer, in both packages."""
    jm, tm = models
    for bank, maker in ((_bank(tm, 2, capacity=2), make_adapter_factors),
                        (_jax_bank(jm, 2, capacity=2), jax_factors)):
        s0, _ = bank.pin('ad0')           # ad0 used after ad1: ad1 is LRU
        bank.unpin(s0)
        slot, _ = bank.load('ad2', maker(bank, 9))
        assert slot == 2                  # ad1's old slot
        assert bank.lookup('ad1') is None
        assert bank.lookup('ad0') == (1, 1)


def test_bank_full_of_pins_is_typed_unavailable(models):
    _, tm = models
    bank = _bank(tm, 2, capacity=2)
    bank.pin('ad0')
    bank.pin('ad1')
    with pytest.raises(AdapterUnavailable) as ei:
        bank.load('ad2', make_adapter_factors(bank, 9))
    assert 'bank full' in ei.value.detail and ei.value.transient


def test_factor_validation(models):
    _, tm = models
    bank = AdapterBank(tm, capacity=2, rank=4, targets=TARGETS)
    good = make_adapter_factors(bank, 1)
    site = next(iter(bank.sites))
    bad = dict(good)
    a, b = good[site]
    bad[site] = (a[:, :2], b[:2, :])
    with pytest.raises(ValueError, match='rank'):
        bank.load('x', bad)
    with pytest.raises(ValueError, match='unknown target site'):
        bank.load('x', {**good, 'nowhere.q_proj': good[site]})
    missing = dict(good)
    del missing[site]
    with pytest.raises(ValueError, match='missing'):
        bank.load('x', missing)
    assert bank.lookup('x') is None


def test_make_adapter_factors_equals_jax(models):
    jm, tm = models
    bank = AdapterBank(tm, capacity=2, rank=4, targets=TARGETS)
    jbank = JaxBank(jm, capacity=2, rank=4, targets=TARGETS)
    f1, f2 = make_adapter_factors(bank, seed=5), jax_factors(jbank, seed=5)
    f3 = make_adapter_factors(bank, seed=6)
    assert list(f1) == list(f2) == list(bank.sites)
    for site in f1:
        for k in (0, 1):
            assert f1[site][k].dtype == np.float32
            assert np.array_equal(f1[site][k], f2[site][k])
        assert not np.array_equal(f1[site][0], f3[site][0])


def test_reload_writes_the_same_slot_in_place(models):
    """Reloading a resident adapter writes its own slot in place (same
    tensor storage) and bumps the version."""
    _, tm = models
    bank = _bank(tm, 1)
    site = next(iter(bank.sites))
    a = bank.device_arrays()['factors'][site]['a']
    ptr, before = a.data_ptr(), a[1].clone()
    slot, ver = bank.load('ad0', make_adapter_factors(bank, 50), version=2)
    assert (slot, ver) == (1, 2)
    a1 = bank.device_arrays()['factors'][site]['a']
    assert a1.data_ptr() == ptr and not torch.equal(a1[1], before)


def test_hook_is_inert_outside_a_scope_and_detach_removes_it():
    """A tagged model's forward equals the untagged one outside a scope;
    inside a scope over base rows (slot 0) it is bit-identical too, and
    over an adapter's rows it moves. `detach` removes the hooks."""
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    model = LlamaForCausalLM(cfg, device='cpu')
    ids = torch.from_numpy(np.random.RandomState(0).randint(1, 128, (2, 9)))
    with torch.no_grad():
        plain = model(ids)
        bank = _bank(model, 1)
        assert torch.equal(model(ids), plain)
        arrays = bank.device_arrays()
        with adapter_scope(arrays, torch.zeros(2, dtype=torch.int32)):
            assert torch.equal(model(ids), plain)
        with adapter_scope(arrays, torch.tensor([0, 1], dtype=torch.int32)):
            moved = model(ids)
        assert torch.equal(moved[0], plain[0])
        assert not torch.allclose(moved[1], plain[1])
        bank.detach()
        assert not any('_adapter_hook' in m.__dict__
                       for m in model.modules())
        with adapter_scope(arrays, torch.tensor([0, 1], dtype=torch.int32)):
            assert torch.equal(model(ids), plain)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, (s,)).tolist() for s in lens]


def _engines(jm, tm, jbank=None, bank=None, **kw):
    kw = {'num_slots': 4, 'max_length': 64, 'decode_block': 2,
          'kv_page_size': 16, **kw}
    return (JaxEngine(jm, adapter_bank=jbank, **kw),
            InferenceEngine(tm, adapter_bank=bank, **kw))


def test_from_jax_adapter_arrays_reproduces_the_jax_bank(models):
    jm, tm = models
    jbank = _jax_bank(jm, 2)
    jarrs = jbank.device_arrays()
    arrays = {'factors': {s: {k: np.asarray(v) for k, v in f.items()}
                          for s, f in jarrs['factors'].items()},
              'scale': np.asarray(jarrs['scale'])}
    fresh = AdapterBank(tm, capacity=3, rank=4, targets=TARGETS)
    from_jax_adapter_arrays(arrays, fresh)
    loaded = _bank(tm, 2)
    for got in (fresh, loaded):
        g = got.device_arrays()
        assert np.array_equal(g['scale'].numpy(), arrays['scale'])
        for site, f in arrays['factors'].items():
            for k in ('a', 'b'):
                assert np.array_equal(g['factors'][site][k].numpy(), f[k])
    with pytest.raises(ValueError, match='shape'):
        from_jax_adapter_arrays(
            arrays, AdapterBank(tm, capacity=2, rank=4, targets=TARGETS))
    with pytest.raises(KeyError, match='missing'):
        from_jax_adapter_arrays(
            arrays, AdapterBank(tm, capacity=3, rank=4,
                                targets=('q_proj', 'k_proj', 'v_proj')))


def test_mixed_wave_identical_to_jax_and_to_each_adapter_alone(models):
    """One mixed wave (base + ad0 + ad1 in the same decode batch): the
    port's tokens equal the JAX engine's per request, and each equals
    what the request gets with its adapter served alone."""
    jm, tm = models
    prompts = _prompts([4, 6, 5, 7], seed=1)
    ids = [None, 'ad0', 'ad1', 'ad0']
    jeng, eng = _engines(jm, tm, _jax_bank(jm), _bank(tm))
    hj = jeng.generate_many(prompts, JaxParams(max_new_tokens=5,
                                               eos_token_id=NO_EOS),
                            adapter_ids=ids)
    ht = eng.generate_many(prompts, SamplingParams(max_new_tokens=5,
                                                   eos_token_id=NO_EOS),
                           adapter_ids=ids)
    for a, b, aid in zip(hj, ht, ids):
        assert b.status == FINISHED and b.adapter_id == aid
        assert b.tokens == a.tokens, aid
    sp = SamplingParams(max_new_tokens=5, eos_token_id=NO_EOS)
    alone = {aid: [h.tokens for h in InferenceEngine(
        tm, num_slots=4, max_length=64, decode_block=2,
        adapter_bank=_bank(tm)).generate_many(prompts, sp, adapter_ids=aid)]
        for aid in ('ad0', 'ad1')}
    base = [h.tokens for h in InferenceEngine(
        tm, num_slots=4, max_length=64, decode_block=2).generate_many(
        prompts, sp)]
    for j, (h, aid) in enumerate(zip(ht, ids)):
        assert h.tokens == (base[j] if aid is None else alone[aid][j])
    # the adapters do something: tokens differ per adapter
    assert alone['ad0'][1] != base[1]
    assert alone['ad0'][1] != alone['ad1'][1]
    assert eng.stats()['adapters']['pinned'] == 0


def test_base_requests_identical_to_bank_less_engine(models):
    _, tm = models
    prompts = _prompts([5, 3, 9], seed=2)
    sp = SamplingParams(max_new_tokens=6, eos_token_id=NO_EOS)
    bare = InferenceEngine(tm, num_slots=2, max_length=64, decode_block=2)
    banked = InferenceEngine(tm, num_slots=2, max_length=64, decode_block=2,
                             adapter_bank=_bank(tm))
    assert [h.tokens for h in banked.generate_many(prompts, sp)] == \
        [h.tokens for h in bare.generate_many(prompts, sp)]


def test_submit_validation(models):
    _, tm = models
    bare = InferenceEngine(tm, num_slots=2, max_length=64)
    with pytest.raises(ValueError, match='adapter_bank'):
        bare.submit([1, 2, 3], max_new_tokens=2, adapter_id='ad0')
    banked = InferenceEngine(tm, num_slots=2, max_length=64,
                             adapter_bank=_bank(tm, 1))
    with pytest.raises(AdapterUnavailable):
        banked.submit([1, 2, 3], max_new_tokens=2, adapter_id='ghost')
    with pytest.raises(ValueError, match='adapter id'):
        banked.generate_many([[1, 2], [3, 4]], adapter_ids=['ad0'])


def test_pins_released_and_stats_exposed(models):
    _, tm = models
    bank = _bank(tm, 2)
    eng = InferenceEngine(tm, num_slots=4, max_length=64, decode_block=2,
                          adapter_bank=bank)
    hs = eng.generate_many(_prompts([4, 5], seed=4),
                           SamplingParams(max_new_tokens=3,
                                          eos_token_id=NO_EOS),
                           adapter_ids=['ad0', 'ad1'])
    assert all(h.status == FINISHED and h.adapter_version == 1
               and h._adapter_pin is None for h in hs)
    st = eng.stats()['adapters']
    assert st['pinned'] == 0
    assert set(st['resident']) == {'ad0', 'ad1'}
    assert not eng._adapter_rows.any()


def test_evicted_adapter_fails_only_its_own_handle_like_jax(models):
    """ad0 is evicted between submit and admission (a third adapter takes
    its slot): only ad0's request fails, with AdapterUnavailable, in both
    engines; the rest get the same tokens in both."""
    jm, tm = models
    prompts = _prompts([5, 7, 6], seed=5)
    ids = [None, 'ad0', 'ad1']
    jbank, bank = _jax_bank(jm, 2, capacity=2), _bank(tm, 2, capacity=2)
    jeng, eng = _engines(jm, tm, jbank, bank)
    results = []
    for e, b, params, maker in (
            (jeng, jbank, JaxParams, jax_factors),
            (eng, bank, SamplingParams, make_adapter_factors)):
        hs = [e.submit(p, params(max_new_tokens=4, eos_token_id=NO_EOS),
                       adapter_id=aid) for p, aid in zip(prompts, ids)]
        b.load('ad2', _factors(b, 3, maker))      # evicts ad0 (LRU)
        e.run()
        assert [h.status for h in hs] == [FINISHED, FAILED, FINISHED]
        assert type(hs[1].error).__name__ == 'AdapterUnavailable'
        assert hs[1].error.adapter_id == 'ad0'
        results.append([h.tokens for h in hs])
    assert eng.stats()['failed'] == 1 and eng.stats()['completed'] == 2
    assert results[0][0] == results[1][0] and results[0][2] == results[1][2]
    assert bank.stats()['pinned'] == 0


def test_page_exhaustion_requeue_rolls_back_pins_like_jax(models):
    """Eight adapted prompts into 8 slots but 9 pages (8 usable), each
    needing 2: admission requeues on page exhaustion, the pin taken
    before the reservation rolls back, and every request still gets the
    JAX engine's tokens."""
    jm, tm = models
    prompts = _prompts([6] * 8, seed=6)
    ids = ['ad0', 'ad1', None, 'ad1'] * 2
    jeng, eng = _engines(jm, tm, _jax_bank(jm), _bank(tm), num_slots=8,
                         kv_pages=9)
    hj = jeng.generate_many(prompts, JaxParams(max_new_tokens=12,
                                               eos_token_id=NO_EOS),
                            adapter_ids=ids)
    ht = eng.generate_many(prompts, SamplingParams(max_new_tokens=12,
                                                   eos_token_id=NO_EOS),
                           adapter_ids=ids)
    assert [h.tokens for h in ht] == [h.tokens for h in hj]
    st = eng.stats()
    assert st['requeued'] > 0 and st['completed'] == 8
    assert st['adapters']['pinned'] == 0
