"""The port's CUDA kernels and engine on an NVIDIA GPU.

Every test here is marked `cuda` and skips where there is no card; on a
machine with one run `python -m pytest tests/test_torch_cuda.py -q`.
This file imports only torch and the port (that machine runs no jax).
Tolerances: f32 1e-4 (sums in another order), bf16 2e-2 abs + rel (one
bf16 rounding of unit-scale outputs, and the wgmma kernels' bf16 P and
dS before the second products). Attention outputs at long S are far
below unit scale, so bf16 attention is also held to `chip_smoke.py`'s
relative limits (REL_BF16).
"""
import pytest
import torch

from paddle_tpu_torch import generator
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.serving import InferenceEngine, SamplingParams

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# chip_smoke.TOL[bf16]: max|got - want| / max|want| and the same in norms
REL_BF16 = (2 ** -6, 2 ** -7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the CUDA kernels run only there)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _randn(gen, dtype, *shape):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def _close_attention(got, want, dtype):
    """`_close`, and for bf16 also REL_BF16 against the plain output's own
    scale."""
    _close(got, want, dtype)
    if dtype == torch.bfloat16:
        diff, want = got.double() - want.double(), want.double()
        assert diff.abs().max() <= REL_BF16[0] * want.abs().max()
        assert diff.norm() <= REL_BF16[1] * want.norm()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('s,hkv', [(1, 8), (63, 2), (130, 8), (1000, 1),
                                   (1, 1), (130, 2)])
def test_flash_kernel_matches_plain(cuda, dtype, s, hkv):
    """Causal self-attention at ragged S and GQA groups of 1, 4 and 8
    (bf16 on the wgmma kernel, f32 on the FMA kernel); the output and,
    with `return_lse`, the LSE; one launch per call."""
    g = torch.Generator(device=cuda).manual_seed(s)
    q = _randn(g, dtype, 2, s, 8, 128)
    k, v = _randn(g, dtype, 2, s, hkv, 128), _randn(g, dtype, 2, s, hkv, 128)
    before = K.LAUNCHES['flash_attention_fwd']
    _close_attention(K.flash_attention_fwd(q, k, v, causal=True),
                     K.attention_reference(q, k, v, causal=True), dtype)
    assert K.LAUNCHES['flash_attention_fwd'] == before + 1
    out, lse = K.flash_attention_fwd(q, k, v, True, return_lse=True)
    want, want_lse = K.attention_reference(q, k, v, causal=True,
                                           return_lse=True)
    assert K.LAUNCHES['flash_attention_fwd'] == before + 2
    _close_attention(out, want, dtype)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)


def test_flash_kernel_strided_and_rectangular(cuda):
    """[B, H, S, D] storage viewed as [B, S, H, D] (no copy), and a
    non-causal sq < sk call."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q = _randn(g, torch.float32, 1, 4, 70, 128).transpose(1, 2)
    k = _randn(g, torch.float32, 1, 4, 90, 128).transpose(1, 2)
    v = _randn(g, torch.float32, 1, 4, 90, 128).transpose(1, 2)
    assert not q.is_contiguous()
    _close(K.flash_attention_fwd(q, k, v, causal=False),
           K.attention_reference(q, k, v, causal=False), torch.float32)
    _close(K.flash_attention_fwd(q, k, v, causal=True),
           K.attention_reference(q, k, v, causal=True), torch.float32)


@pytest.mark.parametrize('causal', [False, True])
def test_flash_kernel_bf16_strided_view(cuda, causal):
    """bf16 [B, H, S, D] storage viewed as [B, S, H, D] on the wgmma
    kernel, rectangular sq < sk, with the LSE."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q = _randn(g, torch.bfloat16, 2, 8, 70, 128).transpose(1, 2)
    k = _randn(g, torch.bfloat16, 2, 2, 200, 128).transpose(1, 2)
    v = _randn(g, torch.bfloat16, 2, 2, 200, 128).transpose(1, 2)
    assert not q.is_contiguous()
    out, lse = K.flash_attention_fwd(q, k, v, causal, return_lse=True)
    want, want_lse = K.attention_reference(q, k, v, causal=causal,
                                           return_lse=True)
    _close_attention(out, want, torch.bfloat16)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)


def test_bf16_attention_raises_on_a_misaligned_view(cuda):
    """The wgmma kernels copy 16 bytes at a time: a bf16 view whose
    storage starts one element past an aligned buffer is refused, by the
    forward, the dq and the dk/dv kernel, and so is such an fp16 view
    (the fp16 instantiations, `auto_cast(dtype='float16')`'s path); the
    same values aligned are taken, one launch per call, fp16 counted
    under the `_fp16` keys."""
    b, s, h = 1, 16, 2
    buf = torch.zeros(b * s * h * 128 + 1, device=cuda, dtype=torch.bfloat16)
    x = buf[1:].view(b, s, h, 128)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    lse = torch.zeros((b, h, s), device=cuda)
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match='16-byte'):
        K.flash_attention_fwd(x, x, x, causal=True)
    with pytest.raises(ValueError, match='16-byte'):
        K.flash_attention_bwd_dq(x, x, x, x, lse, x, True)
    with pytest.raises(ValueError, match='16-byte'):
        K.flash_attention_bwd_dkv(x, x, x, lse, lse, x, True)
    assert K.LAUNCHES == before
    y = x.clone()
    hb = torch.zeros_like(buf, dtype=torch.float16)
    hx = hb[1:].view(b, s, h, 128)           # fp16, misaligned
    with pytest.raises(ValueError, match='16-byte'):
        K.flash_attention_fwd(hx, hx, hx, causal=True)
    with pytest.raises(ValueError, match='16-byte'):
        K.flash_attention_bwd_dq(hx, hx, hx, hx, lse, hx, True)
    with pytest.raises(ValueError, match='16-byte'):
        K.flash_attention_bwd_dkv(hx, hx, hx, lse, lse, hx, True)
    assert K.LAUNCHES == before
    hy = hx.clone()
    K.flash_attention_fwd(hy, hy, hy, causal=True)
    K.flash_attention_bwd_dq(hy, hy, hy, hy, lse, hy, True)
    K.flash_attention_bwd_dkv(hy, hy, hy, lse, lse, hy, True)
    for name in ('flash_attention_fwd', 'flash_attention_bwd_dq',
                 'flash_attention_bwd_dkv'):
        assert K.LAUNCHES[name + '_fp16'] == before[name + '_fp16'] + 1
    K.flash_attention_fwd(y, y, y, causal=True)
    K.flash_attention_bwd_dq(y, y, y, y, lse, y, True)
    K.flash_attention_bwd_dkv(y, y, y, lse, lse, y, True)
    assert K.LAUNCHES['flash_attention_fwd'] == \
        before['flash_attention_fwd'] + 1
    assert K.LAUNCHES['flash_attention_bwd_dq'] == \
        before['flash_attention_bwd_dq'] + 1
    assert K.LAUNCHES['flash_attention_bwd_dkv'] == \
        before['flash_attention_bwd_dkv'] + 1


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('rows', [1, 8, 300])
def test_rms_kernel_matches_plain(cuda, dtype, rows):
    g = torch.Generator(device=cuda).manual_seed(rows)
    x, w = _randn(g, dtype, rows, 4096), _randn(g, dtype, 4096)
    _close(K.rms_norm(x, w), K.rms_norm_reference(x, w), dtype)


@pytest.mark.parametrize('dtype,hkv,quant', [
    (torch.float32, 4, False), (torch.bfloat16, 4, False),
    (torch.bfloat16, 1, False), (torch.float32, 2, True),
    (torch.bfloat16, 4, True)])
def test_paged_kernel_matches_plain(cuda, dtype, hkv, quant):
    g = torch.Generator(device=cuda).manual_seed(hkv)
    n, h, ps, p, num_pages = 5, 8, 16, 6, 31
    q = _randn(g, dtype, n, h, 128)
    shape = (num_pages, ps, hkv, 128)
    if quant:
        kp = torch.randint(-127, 128, shape, generator=g, device=cuda,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g, device=cuda,
                           dtype=torch.int8)
        ks = torch.rand((num_pages, hkv), generator=g, device=cuda) / 127
        vs = torch.rand((num_pages, hkv), generator=g, device=cuda) / 127
    else:
        kp, vp = _randn(g, dtype, *shape), _randn(g, dtype, *shape)
        ks = vs = None
    table = torch.randint(1, num_pages, (n, p), generator=g, device=cuda,
                          dtype=torch.int32)
    table[3] = 0                                  # a slot on the null page
    lengths = torch.tensor([1, 16, 17, 40, 96], device=cuda,
                           dtype=torch.int32)
    _close(K.paged_attention(q, kp, vp, table, lengths, k_scales=ks,
                             v_scales=vs),
           K.paged_attention_reference(q, kp, vp, table, lengths,
                                       k_scales=ks, v_scales=vs), dtype)


_PAGED_SPLIT_CASES = {
    # (H, HKV, lengths) over tables of P = 10 pages of 16 rows: splits of
    # 4 pages (64 keys), so P is not a multiple of the split size
    'split_boundary': (8, 4, [63, 64, 65, 127, 128, 129]),
    'full_table': (8, 4, [160, 1, 159, 33]),
    'length_0': (8, 4, [0, 5, 70, 160]),
    'group_8': (16, 2, [1, 64, 65, 100, 160]),
}


@pytest.mark.parametrize('dtype,quant', [
    (torch.float32, False), (torch.bfloat16, False),
    (torch.float32, True), (torch.bfloat16, True)])
@pytest.mark.parametrize('case', sorted(_PAGED_SPLIT_CASES))
def test_paged_split_kernel_matches_plain(cuda, dtype, quant, case):
    """The split-context kernel at the edges of its splits, in every
    dtype pair the wrapper takes: lengths one below, at and one past a
    split boundary, a slot filling all P pages, a length-0 slot (its
    table row on one page, where the kernel's first page and the plain
    version's average of all pages agree) and G = 8; one call counts one
    launch."""
    h, hkv, lengths = _PAGED_SPLIT_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(len(case) + h)
    n, p, ps = len(lengths), 10, 16
    num_pages = n * p + 1
    q = _randn(g, dtype, n, h, 128)
    shape = (num_pages, ps, hkv, 128)
    if quant:
        kp = torch.randint(-127, 128, shape, generator=g, device=cuda,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g, device=cuda,
                           dtype=torch.int8)
        ks = torch.rand((num_pages, hkv), generator=g, device=cuda) / 127
        vs = torch.rand((num_pages, hkv), generator=g, device=cuda) / 127
    else:
        kp, vp = _randn(g, dtype, *shape), _randn(g, dtype, *shape)
        ks = vs = None
    table = (torch.randperm(num_pages - 1, generator=g, device=cuda)[:n * p]
             + 1).to(torch.int32).reshape(n, p)
    if case == 'length_0':
        table[0] = table[0, 0]
    lens = torch.tensor(lengths, device=cuda, dtype=torch.int32)
    key = 'paged_attention_int8' if quant else 'paged_attention'
    before = K.LAUNCHES[key]
    got = K.paged_attention(q, kp, vp, table, lens, k_scales=ks, v_scales=vs)
    assert K.LAUNCHES[key] == before + 1
    _close(got, K.paged_attention_reference(q, kp, vp, table, lens,
                                            k_scales=ks, v_scales=vs), dtype)


# (length, window's first page): the round's first row at offsets 0, 9
# and 15 of its page, a length-1 slot, a window at the table's end (its
# second page past the table), a window in a split's middle, and an
# inactive slot (its table row the null page, parked at the last row)
_WINDOW_SLOTS = ((1, 0), (10, 0), (16, 0), (17, 1), (160, 9), (100, 6),
                 (70, 4), (160, 9))


@pytest.mark.parametrize('w', [1, 2])
@pytest.mark.parametrize('dtype,hkv', [
    (torch.float32, 4), (torch.bfloat16, 4), (torch.float32, 1),
    (torch.bfloat16, 2)])
def test_paged_kernel_with_window_matches_plain(cuda, dtype, hkv, w):
    """Over int8 pages with the decode round's float window: the window
    holds other values than the int8 pages it stands for, so a kernel
    that read those pages, or a window page past its slot's length,
    fails; one call counts one launch, under `paged_attention_int8`."""
    g = torch.Generator(device=cuda).manual_seed(hkv + 10 * w)
    n, h, p, ps = len(_WINDOW_SLOTS), 8, 10, 16
    num_pages = n * p + 1
    q = _randn(g, dtype, n, h, 128)
    shape = (num_pages, ps, hkv, 128)
    kp, vp = (torch.randint(-127, 128, shape, generator=g, device=cuda,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((num_pages, hkv), generator=g, device=cuda) / 127
              + 1e-3 for _ in range(2))
    kw, vw = (_randn(g, dtype, n, w, ps, hkv, 128) for _ in range(2))
    table = (torch.randperm(num_pages - 1, generator=g, device=cuda)[:n * p]
             + 1).to(torch.int32).reshape(n, p)
    table[-1] = 0
    lens = torch.tensor([ln for ln, _ in _WINDOW_SLOTS], device=cuda,
                        dtype=torch.int32)
    first = torch.tensor([f for _, f in _WINDOW_SLOTS], device=cuda,
                         dtype=torch.int32)
    kw_args = dict(k_scales=ks, v_scales=vs, k_win=kw, v_win=vw,
                   win_first=first)
    before = dict(K.LAUNCHES)
    got = K.paged_attention(q, kp, vp, table, lens, **kw_args)
    assert K.LAUNCHES['paged_attention_int8'] == \
        before['paged_attention_int8'] + 1
    assert K.LAUNCHES['paged_attention'] == before['paged_attention']
    want = K.paged_attention_reference(q, kp, vp, table, lens, **kw_args)
    _close_attention(got, want, dtype)
    without = K.paged_attention_reference(q, kp, vp, table, lens,
                                          k_scales=ks, v_scales=vs)
    assert not torch.allclose(got.float(), without.float(), atol=1e-2)


_KV_PAIRS = [(q, kv) for q in (torch.float32, torch.bfloat16, torch.float16)
             for kv in (torch.float32, torch.bfloat16, torch.float16)
             if q != kv]
# fp16 outputs: one fp16 rounding of unit-scale values (2^-11) and sums in
# another order
_KV_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-3}


@pytest.mark.parametrize('t', [1, 5])
@pytest.mark.parametrize('d', [128, 64])
@pytest.mark.parametrize('int8', [False, True], ids=['float', 'int8'])
@pytest.mark.parametrize('pair', _KV_PAIRS,
                         ids=lambda p: f'{p[0]}-{p[1]}'.replace('torch.', ''))
def test_paged_kv_dtype_pairs(cuda, pair, int8, d, t):
    """The paged kernel over a pool kept in another float dtype than q's
    (`InferenceEngine(dtype=)`): float pages in that dtype, or int8 pages
    with the decode round's window in it, for every (q, pool) pair, at
    D = 128 and 64, one query row per slot and the verify's five; the
    output in q's dtype, held to the plain version on the same inputs;
    one call counts one launch under the pair's key (`_<q>_kv<pages>`)."""
    qd, kvd = pair
    g = torch.Generator(device=cuda).manual_seed(d + t + (7 if int8 else 0))
    n, h, hkv, p, ps = len(_WINDOW_SLOTS), 8, 4, 10, 16
    num_pages = n * p + 1
    shape = (num_pages, ps, hkv, d)
    q = _randn(g, qd, n, t, h, d) if t > 1 else _randn(g, qd, n, h, d)
    table = (torch.randperm(num_pages - 1, generator=g, device=cuda)[:n * p]
             + 1).to(torch.int32).reshape(n, p)
    table[-1] = 0
    # the verify's last row stays inside the table
    lens = torch.tensor([min(ln, p * ps - t) for ln, _ in _WINDOW_SLOTS],
                        device=cuda, dtype=torch.int32)
    if int8:
        kp, vp = (torch.randint(-127, 128, shape, generator=g, device=cuda,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((num_pages, hkv), generator=g, device=cuda)
                  / 127 + 1e-3 for _ in range(2))
        kw, vw = (_randn(g, kvd, n, 2, ps, hkv, d) for _ in range(2))
        first = torch.tensor([f for _, f in _WINDOW_SLOTS],
                             device=cuda, dtype=torch.int32)
        kw_args = dict(k_scales=ks, v_scales=vs, k_win=kw, v_win=vw,
                       win_first=first)
    else:
        kp, vp = _randn(g, kvd, *shape), _randn(g, kvd, *shape)
        kw_args = {}
    key = K.paged_key(q.dim(), int8, qd, d, kvd)
    assert '_kv' in key and key in K.LAUNCHES
    before = dict(K.LAUNCHES)
    got = K.paged_attention(q, kp, vp, table, lens, **kw_args)
    assert got.dtype == qd
    assert {k: n_ - before[k] for k, n_ in K.LAUNCHES.items()
            if n_ != before[k]} == {key: 1}
    want = K.paged_attention_reference(q, kp, vp, table, lens, **kw_args)
    torch.testing.assert_close(got.float(), want.float(), atol=_KV_TOL[qd],
                               rtol=_KV_TOL[qd])


def test_paged_wrapper_raises_on_pages_past_a_split(cuda):
    """A page of more rows than a split holds (PAGED_SPLIT_KEYS) has no
    kernel: the wrapper raises and launches nothing."""
    ps = K.PAGED_SPLIT_KEYS * 2
    q = torch.zeros((1, 4, 128), device=cuda)
    pages = torch.zeros((2, ps, 4, 128), device=cuda)
    before = K.LAUNCHES['paged_attention']
    with pytest.raises(ValueError, match='rows'):
        K.paged_attention(q, pages, pages,
                          torch.ones((1, 1), device=cuda, dtype=torch.int32),
                          torch.ones(1, device=cuda, dtype=torch.int32))
    assert K.LAUNCHES['paged_attention'] == before


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((1, 8, 2, 96), device=cuda)   # head_dim 96
    with pytest.raises(ValueError):
        K.flash_attention_fwd(x, x, x, causal=True)
    with pytest.raises(ValueError):          # f64: no kernel for it
        K.rms_norm(torch.zeros((2, 8), device=cuda, dtype=torch.float64),
                   torch.ones(8, device=cuda, dtype=torch.float64))
    # more query heads per kv head than the kernel's PAGED_MAX_ROWS rows
    q = torch.zeros((1, K.PAGED_MAX_ROWS + 8, 128), device=cuda)
    pages = torch.zeros((3, 16, 1, 128), device=cuda)
    with pytest.raises(ValueError):
        K.paged_attention(q, pages, pages,
                          torch.ones((1, 1), device=cuda, dtype=torch.int32),
                          torch.ones(1, device=cuda, dtype=torch.int32))


def test_engine_on_card_matches_engine_on_cpu(cuda):
    """The same f32 model on the card (kernels) and on the CPU (plain
    versions) gives the same greedy tokens."""
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, max_position_embeddings=256)
    on_card = LlamaForCausalLM(cfg, device=cuda,
                               generator=generator(3, cuda))
    on_cpu = LlamaForCausalLM(cfg, device='cpu')
    on_cpu.load_state_dict({k: v.cpu() for k, v in
                            on_card.state_dict().items()})
    g = torch.Generator().manual_seed(0)
    prompts = [torch.randint(1, 512, (s,), generator=g).tolist()
               for s in (3, 17, 40, 9)]
    sp = SamplingParams(max_new_tokens=12, eos_token_id=-1)
    K.reset_launch_counts()
    card = InferenceEngine(on_card, num_slots=3, max_length=128,
                           decode_block=4,
                           kv_page_size=16).generate_many(prompts, sp)
    assert all(K.LAUNCHES[k] > 0 for k in ('flash_attention_fwd',
                                           'paged_attention', 'rms_norm'))
    cpu = InferenceEngine(on_cpu, num_slots=3, max_length=128,
                          decode_block=4,
                          kv_page_size=16).generate_many(prompts, sp)
    assert [h.tokens for h in card] == [h.tokens for h in cpu]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('hkv', [32, 8])
@pytest.mark.parametrize('sq,sk', [(256, 768), (256, 1024), (64, 576),
                                   (8, 520), (13, 29), (100, 101)])
def test_flash_kernel_at_chunk_shapes_matches_plain(cuda, dtype, hkv, sq, sk):
    """The suffix / chunk prefill's shapes: sq queries over the slot's
    sk = start + sq rows, causal aligned bottom-right (query i sees keys
    <= i + sk - sq), at Llama-2-7B's 32 heads over 32 or 8 kv heads; one
    launch per call."""
    g = torch.Generator(device=cuda).manual_seed(sq + sk)
    q = _randn(g, dtype, 1, sq, 32, 128)
    k, v = _randn(g, dtype, 1, sk, hkv, 128), _randn(g, dtype, 1, sk, hkv, 128)
    before = K.LAUNCHES['flash_attention_fwd']
    _close_attention(K.flash_attention_fwd(q, k, v, causal=True),
                     K.attention_reference(q, k, v, causal=True), dtype)
    assert K.LAUNCHES['flash_attention_fwd'] == before + 1


def test_prefix_chunk_engine_matches_cold_engine(cuda):
    """f32: a shared 48-token system prompt behind suffixes (one in two
    chunks), a cold 100-token prompt in four 32-token chunks and an
    exact repeat of a 64-token prompt (a full hit and its COW split),
    through the graph engine with `prefix_cache` and
    `prefill_chunk_tokens`: the tokens of an engine without either, and
    every page free after a forced clear."""
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, device=cuda, generator=generator(5, cuda))
    g = torch.Generator().manual_seed(3)
    rand = lambda n: torch.randint(1, 512, (n,), generator=g).tolist()
    system = rand(48)
    first = system + rand(16)
    wave = [system + rand(n) for n in (3, 40, 9)] + [rand(100), first]
    sp = SamplingParams(max_new_tokens=12, eos_token_id=-1)
    out = []
    for kw in (dict(prefix_cache=0.5, prefill_chunk_tokens=32), {}):
        eng = InferenceEngine(model, num_slots=3, max_length=128,
                              decode_block=4, **kw, kv_page_size=16)
        eng.generate_many([first], sp)
        K.reset_launch_counts()
        out.append([h.tokens for h in eng.generate_many(wave, sp)])
        st = eng.stats()
        assert st['traces'] == _traces(eng)
        if kw:
            assert K.LAUNCHES['flash_attention_fwd'] > 0
            assert st['prefix_cache']['hits'] >= 4
            assert st['pool']['cow_splits'] == 1
            assert st['chunk_rounds'] >= 6
            eng.prefix_cache.clear(force=True)
            assert eng.pool.free_page_count == eng.pool.num_pages - 1
    assert out[0] == out[1]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('sq,sk,hkv,causal', [
    (130, 130, 8, True), (64, 64, 2, True), (70, 90, 4, True),
    (100, 100, 8, False), (1, 1, 8, True), (63, 63, 2, True),
    (1000, 1000, 1, True), (63, 200, 2, False), (1, 130, 1, True),
    (130, 300, 8, False)])
def test_flash_backward_kernels_match_plain(cuda, dtype, sq, sk, hkv,
                                            causal):
    """The forward's LSE and the dq and dk/dv kernels against the plain
    FA-2 backward: ragged S, GQA groups of 1, 4 and 8, sq < sk, causal
    or not (bf16 dq and dk/dv on the wgmma kernels, f32 on the FMA
    kernels). With
    one key, dq and dk are zero up to rounding and have no scale of their
    own to hold them to."""
    g = torch.Generator(device=cuda).manual_seed(sq + hkv)
    q, dout = _randn(g, dtype, 2, sq, 8, 128), _randn(g, dtype, 2, sq, 8, 128)
    k, v = _randn(g, dtype, 2, sk, hkv, 128), _randn(g, dtype, 2, sk, hkv, 128)
    out, lse = K.flash_attention_fwd(q, k, v, causal, return_lse=True)
    _, want_lse = K.attention_reference(q, k, v, causal=causal,
                                        return_lse=True)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    before = dict(K.LAUNCHES)
    got = K.flash_attention_bwd(q, k, v, out, lse, dout, causal)
    want = K.attention_bwd_reference(q, k, v, out, lse, dout, causal)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == dtype
        (_close_attention if sk > 1 or i == 2 else _close)(a, b, dtype)
    assert K.LAUNCHES['flash_attention_bwd_dq'] == \
        before['flash_attention_bwd_dq'] + 1
    assert K.LAUNCHES['flash_attention_bwd_dkv'] == \
        before['flash_attention_bwd_dkv'] + 1


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n,v', [(1, 8), (37, 1000), (300, 32000), (5, 129)])
def test_ce_kernels_match_plain(cuda, dtype, n, v):
    """CE forward and backward, aligned and ragged vocab, with ignored
    rows (label 0 after masking, g = 0)."""
    g = torch.Generator(device=cuda).manual_seed(n + v)
    x = (3 * _randn(g, torch.float32, n, v)).to(dtype)
    lab = torch.randint(0, v, (n,), generator=g, device=cuda,
                        dtype=torch.int32)
    up = torch.randn(n, generator=g, device=cuda)
    up[::3] = 0.0
    nll, lse = K.softmax_cross_entropy_fwd(x, lab)
    want_nll, want_lse = K.softmax_cross_entropy_fwd_reference(x, lab)
    torch.testing.assert_close(nll, want_nll, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    _close(K.softmax_cross_entropy_bwd(x, lab, lse, up),
           K.softmax_cross_entropy_bwd_reference(x, lab, lse, up), dtype)


def test_training_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 8, 2, 128), device=cuda)
    lse = torch.zeros((1, 2, 8), device=cuda)
    with pytest.raises(ValueError):          # strided q
        K.flash_attention_bwd(q.transpose(1, 2).contiguous().transpose(
            1, 2), q, q, q, lse, q, True)
    with pytest.raises(ValueError):          # lse in the wrong layout
        K.flash_attention_bwd(q, q, q, q, lse.transpose(1, 2), q, True)
    x = torch.zeros((4, 16), device=cuda)
    with pytest.raises(ValueError):          # int64 labels
        K.softmax_cross_entropy_fwd(x, torch.zeros(4, device=cuda,
                                                   dtype=torch.int64))
    with pytest.raises(ValueError):          # strided logits
        K.softmax_cross_entropy_fwd(x[:, :8], torch.zeros(
            4, device=cuda, dtype=torch.int32))
    with pytest.raises(ValueError):          # f64 logits
        K.softmax_cross_entropy_fwd(x.double(), torch.zeros(
            4, device=cuda, dtype=torch.int32))


def test_training_on_card_matches_training_on_cpu(cuda):
    """Two f32 AdamW steps of the same model on the card (kernels) and on
    the CPU (plain versions), with recompute: losses agree to 1e-4."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, use_recompute=True)
    on_card = LlamaForCausalLM(cfg, device=cuda, generator=generator(4, cuda))
    on_cpu = LlamaForCausalLM(cfg, device='cpu')
    on_cpu.load_state_dict({k: v.cpu() for k, v in
                            on_card.state_dict().items()})

    def loss_fn(logits, labels):
        return F.cross_entropy(logits[:, :-1].reshape(-1, 512),
                               labels[:, 1:].reshape(-1))

    ids = torch.randint(0, 512, (2, 96), generator=torch.Generator()
                        .manual_seed(0))
    K.reset_launch_counts()
    losses = []
    for model in (on_card, on_cpu):
        step = TrainStep(model, loss_fn, AdamW(learning_rate=1e-3,
                                               parameters=model.parameters()))
        losses.append([float(step(ids, ids)) for _ in range(2)])
    for name in ('flash_attention_fwd', 'flash_attention_bwd_dq',
                 'flash_attention_bwd_dkv', 'rms_norm', 'softmax_ce_fwd',
                 'softmax_ce_bwd'):
        assert K.LAUNCHES[name] > 0, name
    torch.testing.assert_close(torch.tensor(losses[0]),
                               torch.tensor(losses[1]), rtol=1e-4, atol=0)


def _adapter_case(gen, b, t, h, r, o, c, x_dtype, w_dtype, rows):
    """x [b, t, h], banks [c, h, r] / [c, r, o] with a zero slot 0, scales
    (0 for slot 0) and the given rows, on the card."""
    x = _randn(gen, x_dtype, b, t, h)
    a = (0.05 * _randn(gen, torch.float32, c, h, r)).to(w_dtype)
    bb = (0.05 * _randn(gen, torch.float32, c, r, o)).to(w_dtype)
    a[0], bb[0] = 0, 0
    scale = torch.rand(c, generator=gen, device=gen.device) + 0.5
    scale[0] = 0.0
    return x, a, bb, torch.tensor(rows, dtype=torch.int32,
                                  device=gen.device), scale


# (b, t, h, rank, o, rows): the serve path's decode and prefill calls,
# ragged widths, ranks 1, 33 and 64 (padded to 8 and 64; 64 leaves one
# row per row group, so 6 entries take two rounds), widths with no
# 16-byte chunk (scalar loads), 64 rows on one slot (one group in
# four rounds) or on 64 distinct slots (64 clusters), and more clusters of
# 16 tokens than the card holds at once (several rounds per cluster, two
# rows in a group, a short last tile)
_ADAPTER_SHAPES = {
    'decode': (8, 1, 4096, 8, 4096, [0, 1, 2, 1, 0, 3, 3, 1]),
    'prefill': (1, 1024, 4096, 8, 4096, [3]),
    'ragged': (6, 5, 4000, 16, 1000, [0, 2, 2, 1, 0, 4]),
    'rank_1': (4, 5, 256, 1, 96, [1, 1, 0, 2]),
    'rank_33': (4, 1, 520, 33, 300, [2, 0, 2, 1]),
    'rank_64': (3, 2, 64, 64, 32, [1, 0, 2]),
    'unaligned': (3, 3, 37, 8, 29, [1, 2, 1]),
    'b64_one_slot': (64, 1, 1024, 8, 512, [3] * 64),
    'b64_distinct': (64, 1, 1024, 8, 512, list(range(64))),
    'tiled_rounds': (4, 300, 1024, 8, 512, [1, 0, 2, 1]),
}


@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('w_dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('x_dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', sorted(_ADAPTER_SHAPES))
def test_adapter_kernel_matches_plain(cuda, shape, x_dtype, w_dtype, fused):
    """adapter_matmul (the delta) and adapter_matmul_add (y + delta) against
    their plain versions, one launch per call; rows on slot 0 get an exact
    zero delta and y bit for bit."""
    b, t, h, r, o, rows = _ADAPTER_SHAPES[shape]
    g = torch.Generator(device=cuda).manual_seed(b * t + r)
    args = _adapter_case(g, b, t, h, r, o, max(5, max(rows) + 1), x_dtype,
                         w_dtype, rows)
    y = _randn(g, x_dtype, b, t, o)
    before = K.LAUNCHES['adapter_matmul']
    if fused:
        got, want = (K.adapter_matmul_add(y, *args),
                     K.adapter_matmul_add_reference(y, *args))
    else:
        got, want = K.adapter_matmul(*args), K.adapter_matmul_reference(*args)
    assert K.LAUNCHES['adapter_matmul'] == before + 1
    assert got.dtype == x_dtype and got.shape == want.shape
    _close(got, want, x_dtype)
    base = args[3] == 0
    assert torch.equal(got[base], (y if fused else torch.zeros_like(y))[base])


def test_adapter_add_takes_two_dim_y_and_bad_slots_write_nan(cuda):
    """A decode call's [B, O] y gives a [B, O] result; a row whose slot is
    outside [0, C) gets NaN (delta and sum), the other rows stay right."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x, a, b, _, scale = _adapter_case(g, 5, 1, 512, 8, 256, 4,
                                      torch.bfloat16, torch.float32, [0] * 5)
    rows = torch.tensor([1, -1, 3, 4, 0], dtype=torch.int32, device=cuda)
    y = _randn(g, torch.bfloat16, 5, 256)
    got = K.adapter_matmul_add(y, x, a, b, rows, scale)
    assert got.shape == y.shape
    delta = K.adapter_matmul(x, a, b, rows, scale)[:, 0]
    for out in (got, delta):
        assert torch.isnan(out[1:4:2]).all()
        assert not torch.isnan(out[[0, 2, 4]]).any()
    ok = torch.tensor([0, 2, 4], device=cuda)
    _close(got[ok], K.adapter_matmul_add_reference(
        y[ok], x[ok], a, b, rows[ok], scale), torch.bfloat16)
    assert torch.equal(got[4], y[4])


def test_adapter_add_replays_in_a_cuda_graph(cuda):
    """adapter_matmul_add captured in a CUDA graph (the kernel reads rows
    on the device, allocates no scratch): replayed after new rows and x
    are copied into the static inputs, it gives the eager call's result."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x, a, b, rows, scale = _adapter_case(
        g, 8, 1, 4096, 8, 4096, 5, torch.bfloat16, torch.float32,
        [0, 1, 2, 1, 0, 3, 3, 1])
    y = _randn(g, torch.bfloat16, 8, 4096)
    K.adapter_matmul_add(y, x, a, b, rows, scale)        # build and load
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.adapter_matmul_add(y, x, a, b, rows, scale)    # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = K.adapter_matmul_add(y, x, a, b, rows, scale)
    new_rows = torch.tensor([4, 4, 0, 2, 1, 1, 3, 0], dtype=torch.int32,
                            device=cuda)
    new_x = _randn(g, torch.bfloat16, 8, 1, 4096)
    rows.copy_(new_rows)
    x.copy_(new_x)
    graph.replay()
    torch.cuda.synchronize()
    eager = K.adapter_matmul_add(y, new_x, a, b, new_rows, scale)
    assert torch.equal(static_out, eager)
    _close(static_out, K.adapter_matmul_add_reference(
        y, new_x, a, b, new_rows, scale), torch.bfloat16)


def test_adapter_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x, a, b, rows, scale = _adapter_case(g, 2, 1, 64, 4, 32, 3,
                                         torch.float32, torch.float32, [0, 1])
    with pytest.raises(ValueError):          # fp16 x over a bf16 bank
        K.adapter_matmul(x.half(), a.bfloat16(), b.bfloat16(), rows, scale)
    with pytest.raises(ValueError):          # bf16 x over an fp16 bank
        K.adapter_matmul(x.bfloat16(), a.half(), b.half(), rows, scale)
    with pytest.raises(ValueError):          # f64 x
        K.adapter_matmul(x.double(), a, b, rows, scale)
    with pytest.raises(ValueError):          # int64 rows
        K.adapter_matmul(x, a, b, rows.long(), scale)
    with pytest.raises(ValueError):          # strided x
        K.adapter_matmul(torch.zeros((2, 1, 128), device=cuda)[:, :, ::2],
                         a, b, rows, scale)
    with pytest.raises(ValueError):          # rank above the kernel's
        K.adapter_matmul(x, torch.zeros((3, 64, 65), device=cuda),
                         torch.zeros((3, 65, 32), device=cuda), rows, scale)
    y = torch.zeros((2, 1, 32), device=cuda)
    with pytest.raises(ValueError, match='contiguous y'):
        K.adapter_matmul_add(torch.zeros((2, 1, 64), device=cuda)[:, :, ::2],
                             x, a, b, rows, scale)
    with pytest.raises(ValueError, match='takes y'):   # y not in x.dtype
        K.adapter_matmul_add(y.bfloat16(), x, a, b, rows, scale)
    with pytest.raises(ValueError, match='takes y'):   # y of another width
        K.adapter_matmul_add(y[:, :, :16], x, a, b, rows, scale)
    many = K.ADAPTER_MAX_BATCH + 1
    with pytest.raises(ValueError, match='at most'):
        K.adapter_matmul(torch.zeros((many, 1, 64), device=cuda), a, b,
                         torch.zeros(many, dtype=torch.int32, device=cuda),
                         scale)


def test_banked_engine_on_card_matches_engine_on_cpu(cuda):
    """The same f32 model and adapters on the card (kernels) and on the
    CPU (plain versions): a mixed base/adapter wave gives the same greedy
    tokens, and the adapter kernel ran on the card."""
    from paddle_tpu_torch.serving import AdapterBank, make_adapter_factors
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, max_position_embeddings=256)
    on_card = LlamaForCausalLM(cfg, device=cuda,
                               generator=generator(6, cuda))
    on_cpu = LlamaForCausalLM(cfg, device='cpu')
    on_cpu.load_state_dict({k: v.cpu() for k, v in
                            on_card.state_dict().items()})
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, 512, (s,), generator=g).tolist()
               for s in (3, 17, 40, 9)]
    ids = [None, 'ad0', 'ad1', 'ad0']
    sp = SamplingParams(max_new_tokens=12, eos_token_id=-1)
    tokens = []
    for model in (on_card, on_cpu):
        bank = AdapterBank(model, capacity=2, rank=8,
                           targets=('q_proj', 'k_proj', 'v_proj', 'o_proj'))
        for i in range(2):
            bank.load(f'ad{i}', make_adapter_factors(bank, i + 1, scale=0.1))
        K.reset_launch_counts()
        hs = InferenceEngine(model, num_slots=3, max_length=128,
                             decode_block=4, adapter_bank=bank,
                             kv_page_size=16).generate_many(
                                 prompts, sp, adapter_ids=ids)
        tokens.append([h.tokens for h in hs])
        if model is on_card:
            assert K.LAUNCHES['adapter_matmul'] > 0
    assert tokens[0] == tokens[1]


def test_queued_calls_hide_the_launch_gaps(cuda):
    """`chip_smoke.queued_ms` times calls queued behind a GPU-side sleep:
    a kernel longer than its launch reads as the back-to-back CUDA events
    do, and a tiny one no slower than the host's launch rate."""
    import importlib.util
    import pathlib
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', pathlib.Path(__file__).resolve().parent.parent
        / 'chip_smoke.py')
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    long_call = lambda: torch.cuda._sleep(1_000_000)    # ~0.5 ms
    ev, queued = smoke.time_ms(long_call), smoke.queued_ms(long_call)
    assert queued is not None and abs(queued - ev) <= 0.05 * ev
    x = torch.zeros(1024, device=cuda)
    tiny = lambda: x.add_(1.0)
    queued = smoke.queued_ms(tiny)
    assert queued is not None and queued <= smoke.time_ms(tiny)


# ---------------------------------------------------------------------------
# the decode sub-step replayed from a CUDA graph against the eager loop
# ---------------------------------------------------------------------------

def _graph_cfg():
    return LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                       num_hidden_layers=2, num_attention_heads=2,
                       num_key_value_heads=1, max_position_embeddings=256)


def _traces(eng) -> dict:
    """The `traces` a card engine must show: one capture of the decode
    sub-step and one of each prefill step it built, under the JAX
    engine's names."""
    return {eng._decode_name: 1,
            **{step.name: 1 for step in eng._prefill_steps.values()}}


def _serve_counted(model, bank, capture, prompts, params, ids):
    """Serve one warm-up request (the graph engine captures its decode
    sub-step at its first round), then `prompts` for one token each (a
    capture's warm-up launches count, so every prefill bucket is
    captured before the count), then `prompts` with LAUNCHES counted;
    returns (tokens, LAUNCHES, engine). `capture` sets the decode and
    the prefill capture."""
    eng = InferenceEngine(model, num_slots=3, max_length=128, decode_block=4,
                          adapter_bank=bank, kv_page_size=16)
    eng._capture_decode = eng._capture_prefill = capture
    eng.generate_many([prompts[0][:3]],
                      SamplingParams(max_new_tokens=4, eos_token_id=-1))
    eng.generate_many(prompts, SamplingParams(max_new_tokens=1,
                                              eos_token_id=-1),
                      adapter_ids=ids)
    eng.reset_stats()
    K.reset_launch_counts()
    hs = eng.generate_many(prompts, params, adapter_ids=ids)
    return [h.tokens for h in hs], dict(K.LAUNCHES), eng


@pytest.mark.parametrize('banked', [False, True])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_decode_graph_equals_the_eager_loop(cuda, dtype, banked):
    """Seven requests through 3 slots at decode_block=4 (greedy ones that
    stop on eos mid-round, one seeded sampling request; with the bank
    base and two adapters mixed, so a slot is re-admitted under another
    adapter and the rows change between rounds): the engine that replays
    its captured sub-step gives the eager loop's tokens and launch counts
    (replays counted), and captures once over many rounds."""
    from paddle_tpu_torch.serving import (SAMPLING, AdapterBank,
                                          make_adapter_factors)
    model = LlamaForCausalLM(_graph_cfg(), device=cuda, dtype=dtype,
                             generator=generator(8, cuda))
    bank = None
    ids = None
    if banked:
        bank = AdapterBank(model, capacity=2, rank=8,
                           targets=('q_proj', 'k_proj', 'v_proj', 'o_proj'))
        for i in range(2):
            bank.load(f'ad{i}', make_adapter_factors(bank, i + 1, scale=0.1))
        ids = ['ad0', None, 'ad1', 'ad0', 'ad1', None, 'ad1']
    g = torch.Generator().manual_seed(2)
    prompts = [torch.randint(1, 512, (s,), generator=g).tolist()
               for s in (3, 17, 40, 9, 25, 5, 12)]
    free, _, _ = _serve_counted(model, bank, False, prompts, SamplingParams(
        max_new_tokens=24, eos_token_id=-1), ids)
    params = [SamplingParams(max_new_tokens=24, eos_token_id=t[k])
              for t, k in zip(free, (1, 2, 5, 6, 9, 1, 2))]
    params[3] = SamplingParams(max_new_tokens=24, eos_token_id=-1,
                               strategy=SAMPLING, temperature=0.8,
                               top_p=0.9, seed=7)
    graph_toks, graph_launches, graph_eng = _serve_counted(
        model, bank, True, prompts, params, ids)
    eager_toks, eager_launches, eager_eng = _serve_counted(
        model, bank, False, prompts, params, ids)
    assert graph_toks == eager_toks
    assert any(len(t) % 4 for t in graph_toks)     # some retired mid-round
    assert graph_launches == eager_launches
    assert graph_launches['paged_attention'] > 0
    st = graph_eng.stats()
    assert graph_launches['adapter_matmul'] == (
        8 * (st['prefills'] + st['decode_steps']) if banked else 0)
    assert st['decode_rounds'] >= 6         # the sampling request alone
    assert st['traces'] == _traces(graph_eng)
    assert eager_eng.stats()['traces'] == {}


@pytest.mark.parametrize('capture', [True, False])
def test_decode_round_syncs_nothing(cuda, capture):
    """A greedy round, replayed from the graph or run eagerly, queues its
    staging copies and sub-steps without one host sync (the token fetch
    after it is the round's only wait)."""
    from paddle_tpu_torch.serving import AdapterBank, make_adapter_factors
    model = LlamaForCausalLM(_graph_cfg(), device=cuda, dtype='bfloat16',
                             generator=generator(9, cuda))
    bank = AdapterBank(model, capacity=2, rank=8,
                       targets=('q_proj', 'k_proj', 'v_proj', 'o_proj'))
    bank.load('ad0', make_adapter_factors(bank, 1, scale=0.1))
    eng = InferenceEngine(model, num_slots=3, max_length=128, decode_block=4,
                          adapter_bank=bank, kv_page_size=16)
    eng._capture_decode = eng._capture_prefill = capture
    for s, aid in ((5, 'ad0'), (9, None)):
        eng.submit(list(range(1, s + 1)), max_new_tokens=12,
                   eos_token_id=-1, adapter_id=aid)
    eng.step()                 # admit, prefill, capture, first round
    torch.cuda.synchronize()
    with torch.inference_mode():
        torch.cuda.set_sync_debug_mode('error')
        try:
            out = eng._queue_round()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert out.shape == (3, 4) and bool((out[2] == 0).all())
    assert eng.stats()['traces'] == (_traces(eng) if capture else {})


# ---------------------------------------------------------------------------
# the flash forward's device key count, and the prefill replayed from one
# CUDA graph per (kind, bucket) against the eager prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('hkv', [32, 8])
@pytest.mark.parametrize('sq,used', [(256, 768), (256, 1024), (64, 576),
                                     (8, 520), (13, 29)])
def test_flash_kernel_with_seqused_k_matches_plain(cuda, dtype, hkv, sq,
                                                   used):
    """The captured chunk's call: sq queries over a 1024-row K/V buffer of
    which the first `used` rows count (read from device memory), causal
    aligned at used - sq; the rows past the count are NaN, so a read of
    one shows. Equals the host-count call on the sliced rows."""
    g = torch.Generator(device=cuda).manual_seed(sq + used)
    q = _randn(g, dtype, 1, sq, 32, 128)
    k, v = (_randn(g, dtype, 1, 1024, hkv, 128) for _ in range(2))
    k[:, used:] = float('nan')
    v[:, used:] = float('nan')
    counts = torch.tensor([used], dtype=torch.int32, device=cuda)
    before = K.LAUNCHES['flash_attention_fwd']
    got = K.flash_attention_fwd(q, k, v, causal=True, seqused_k=counts)
    assert K.LAUNCHES['flash_attention_fwd'] == before + 1
    _close_attention(got, K.attention_reference(q, k, v, causal=True,
                                                seqused_k=counts), dtype)
    assert torch.equal(got, K.flash_attention_fwd(
        q, k[:, :used], v[:, :used], causal=True))


def test_flash_kernel_with_seqused_k_replays_at_new_counts(cuda):
    """Captured once, the call attends to whatever counts its device
    array holds at each replay (two batches, other counts each time)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q = _randn(g, torch.bfloat16, 2, 64, 32, 128)
    k, v = (_randn(g, torch.bfloat16, 2, 512, 8, 128) for _ in range(2))
    counts = torch.tensor([64, 64], dtype=torch.int32, device=cuda)
    K.flash_attention_fwd(q, k, v, causal=True, seqused_k=counts)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.flash_attention_fwd(q, k, v, causal=True, seqused_k=counts)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K.flash_attention_fwd(q, k, v, causal=True, seqused_k=counts)
    for used in ((512, 100), (64, 333), (200, 64)):
        counts.copy_(torch.tensor(used, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        _close_attention(out, K.attention_reference(
            q, k, v, causal=True, seqused_k=counts), torch.bfloat16)


@pytest.mark.parametrize('banked', [False, True])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_prefill_graph_equals_the_eager_prefill(cuda, dtype, banked):
    """Both engines replay their decode graph; one replays a captured
    graph per prefill bucket, whole and chunk (a 40-token system prompt
    behind suffixes, a cold 100-token prompt in 32-token chunks, a
    seeded sampling request; with the bank, base and two adapters
    mixed), the other runs the same prefill bodies eagerly: equal tokens
    and launch counts, and `traces` names each bucket used once."""
    from paddle_tpu_torch.serving import (SAMPLING, AdapterBank,
                                          make_adapter_factors)
    model = LlamaForCausalLM(_graph_cfg(), device=cuda, dtype=dtype,
                             generator=generator(10, cuda))
    bank = ids = None
    if banked:
        bank = AdapterBank(model, capacity=2, rank=8,
                           targets=('q_proj', 'k_proj', 'v_proj', 'o_proj'))
        for i in range(2):
            bank.load(f'ad{i}', make_adapter_factors(bank, i + 1, scale=0.1))
        ids = ['ad0', None, 'ad1', 'ad0', None, 'ad1']
    g = torch.Generator().manual_seed(6)
    rand = lambda n: torch.randint(1, 512, (n,), generator=g).tolist()
    system = rand(40)
    prompts = [system + rand(n) for n in (3, 20, 9)] + [rand(100), rand(5),
                                                         system + rand(50)]
    params = [SamplingParams(max_new_tokens=12, eos_token_id=-1)
              for _ in prompts]
    params[2] = SamplingParams(max_new_tokens=12, eos_token_id=-1,
                               strategy=SAMPLING, temperature=0.8,
                               top_p=0.9, seed=3)
    runs = []
    for graph in (True, False):
        eng = InferenceEngine(model, num_slots=3, max_length=128,
                              decode_block=4, adapter_bank=bank,
                              prefix_cache=0.5, prefill_chunk_tokens=32,
                              kv_page_size=16)
        eng._capture_prefill = graph
        toks = []
        # the first pass captures what the trace uses (a capture's
        # warm-up launches count); the cache is emptied before each
        # pass, so the counted second pass runs the same buckets
        for _ in range(2):
            eng.prefix_cache.clear(force=True)
            eng.reset_stats()
            K.reset_launch_counts()
            toks.append([h.tokens for h in eng.generate_many(
                prompts, params, adapter_ids=ids)])
        assert toks[0] == toks[1]
        runs.append((toks[1], dict(K.LAUNCHES), eng))
    (graph_toks, graph_launches, graph_eng), (eager_toks, eager_launches,
                                              eager_eng) = runs
    assert graph_toks == eager_toks
    assert graph_launches == eager_launches
    st = graph_eng.stats()
    assert st['chunk_rounds'] > 0 and st['prefix_cache']['hits'] > 0
    kinds = {kind for kind, _ in graph_eng._prefill_steps}
    assert kinds == {'whole', 'chunk'}
    assert st['traces'] == _traces(graph_eng)
    assert eager_eng.stats()['traces'] == {'paged_decode_step': 1}
    assert set(eager_eng._prefill_steps) == set(graph_eng._prefill_steps)
    if banked:
        assert graph_launches['adapter_matmul'] == 8 * (
            st['prefills'] + st['chunk_rounds'] + st['decode_steps'])


def test_one_chunk_graph_at_three_starts_equals_the_eager_body(cuda):
    """One captured chunk step (bucket 32) replayed at start 0, at a
    page-aligned start after an attached prefix, and in a tail-shifted
    window under a floor, each from the same pages: the pages equal
    those the eager body writes, and the pages under the floor keep
    their bytes."""
    model = LlamaForCausalLM(_graph_cfg(), device=cuda,
                             generator=generator(11, cuda))
    engines = []
    for capture in (True, False):
        eng = InferenceEngine(model, num_slots=2, max_length=128,
                              kv_page_size=16)
        eng._capture_prefill = capture
        slot = eng.pool.alloc()
        eng.pool.reserve(slot, 128)
        engines.append(eng)
    table = engines[0].pool.page_table[slot:slot + 1]
    assert (table == engines[1].pool.page_table[slot:slot + 1]).all()
    g = torch.Generator(device=cuda).manual_seed(12)
    init = [(torch.randn(k.shape, generator=g, device=cuda),
             torch.randn(v.shape, generator=g, device=cuda))
            for k, v in engines[0].pool.pages]
    steps = set()
    for i, (start, floor) in enumerate(((0, 0), (48, 48), (80, 96))):
        ids = torch.randint(1, 512, (1, 32), generator=g, device=cuda)
        pages = []
        for eng in engines:
            for (k, v), (k0, v0) in zip(eng.pool.pages, init):
                k.copy_(k0)
                v.copy_(v0)
            with torch.inference_mode():
                step = eng._prefill_step('chunk', 32)
                step.stage(ids=ids.cpu().numpy(), table=table,
                           start=start, floor=floor)
                step.run_once()
            torch.cuda.synchronize()
            pages.append(eng.pool.pages)
        steps.add(step)
        for (k, v), (ek, ev), (k0, v0) in zip(*pages, init):
            _close(k[1:], ek[1:], torch.float32)
            _close(v[1:], ev[1:], torch.float32)
            for pid in table[0, :floor // 16]:
                assert torch.equal(k[pid], k0[pid])
                assert torch.equal(v[pid], v0[pid])
    assert engines[0]._prefill_steps[('chunk', 32)].graph is not None
    assert engines[1]._prefill_steps[('chunk', 32)].graph is None
    assert engines[0].stats()['traces'] == {'paged_chunk_prefill_32': 1}


def test_a_failed_prefill_capture_raises(cuda, monkeypatch):
    """A host read inside the prefill body (the sync a capture refuses)
    makes the capture fail: the engine raises, counts no capture, and
    never falls back to the uncaptured body."""
    from paddle_tpu_torch.serving import prefill_graph
    model = LlamaForCausalLM(_graph_cfg(), device=cuda,
                             generator=generator(13, cuda))
    body = prefill_graph.PrefillStep._body

    def body_with_a_host_read(self):
        int(self.buf['ids'][0, 0])
        body(self)

    monkeypatch.setattr(prefill_graph.PrefillStep, '_body',
                        body_with_a_host_read)
    eng = InferenceEngine(model, num_slots=2, max_length=128, kv_page_size=16)
    eng.submit(list(range(1, 6)), max_new_tokens=2, eos_token_id=-1)
    with pytest.raises(RuntimeError, match='capturing the whole prefill'):
        eng.step()
    assert eng.stats()['traces'] == {}
    assert eng._prefill_steps[('whole', 8)].graph is None
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# int8 paged KV: the captured round with its window, and a failing chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('prefix,banked', [(False, False), (True, False),
                                           (True, True)])
def test_int8_graph_engine_equals_its_eager_twin(cuda, prefix, banked):
    """`kv_quant='int8'` (bf16 model): the engine that replays its
    decode round (the window's fill, the sub-steps, the requantize) and
    its prefills from CUDA graphs gives its eager twin's tokens and
    launch counts, with and without the prefix cache and chunks and an
    adapter bank; the paged kernel runs once per layer of every sub-step
    and `traces` keeps the JAX engine's keys."""
    from paddle_tpu_torch.serving import (SAMPLING, AdapterBank,
                                          make_adapter_factors)
    model = LlamaForCausalLM(_graph_cfg(), device=cuda, dtype='bfloat16',
                             generator=generator(14, cuda))
    bank = ids = None
    if banked:
        bank = AdapterBank(model, capacity=2, rank=8,
                           targets=('q_proj', 'k_proj', 'v_proj', 'o_proj'))
        for i in range(2):
            bank.load(f'ad{i}', make_adapter_factors(bank, i + 1, scale=0.1))
        ids = ['ad0', None, 'ad1', 'ad0', None, 'ad1']
    g = torch.Generator().manual_seed(15)
    rand = lambda n: torch.randint(1, 512, (n,), generator=g).tolist()
    system = rand(40)
    prompts = [system + rand(n) for n in (3, 20, 9)] + [rand(100), rand(5),
                                                         system + rand(50)]
    params = [SamplingParams(max_new_tokens=14, eos_token_id=-1)
              for _ in prompts]
    params[2] = SamplingParams(max_new_tokens=14, eos_token_id=-1,
                               strategy=SAMPLING, temperature=0.8,
                               top_p=0.9, seed=3)
    opts = dict(prefix_cache=0.5, prefill_chunk_tokens=32) if prefix else {}
    runs = []
    for graph in (True, False):
        eng = InferenceEngine(model, num_slots=3, max_length=128,
                              decode_block=4, adapter_bank=bank,
                              kv_quant='int8', **opts, kv_page_size=16)
        eng._capture_decode = eng._capture_prefill = graph
        toks = []
        for _ in range(2):      # the first pass captures what it uses
            if prefix:
                eng.prefix_cache.clear(force=True)
            eng.reset_stats()
            K.reset_launch_counts()
            toks.append([h.tokens for h in eng.generate_many(
                prompts, params, adapter_ids=ids)])
        assert toks[0] == toks[1]
        runs.append((toks[1], dict(K.LAUNCHES), eng))
    (graph_toks, graph_launches, graph_eng), (eager_toks, eager_launches,
                                              eager_eng) = runs
    assert graph_toks == eager_toks
    assert graph_launches == eager_launches
    st = graph_eng.stats()
    assert graph_launches['paged_attention_int8'] == 2 * st['decode_steps']
    assert graph_launches['paged_attention'] == 0
    assert st['traces'] == _traces(graph_eng)
    assert eager_eng.stats()['traces'] == {}
    assert st['pool']['kv_quant'] == 'int8'
    if prefix:
        assert st['chunk_rounds'] > 0 and st['prefix_cache']['hits'] > 0
        graph_eng.prefix_cache.clear(force=True)
    assert graph_eng.pool.free_page_count == graph_eng.pool.num_pages - 1


@pytest.mark.parametrize('quant', [None, 'int8'])
def test_a_failing_chunk_fails_alone_on_the_graph_engine(cuda, quant):
    """On the graph engine a request whose second chunk raises (an
    injected Python exception) fails alone, its pages come back, and a
    later request replays the same chunk graph and gets its eager twin's
    tokens."""
    from paddle_tpu_torch.serving import FAILED, FINISHED
    model = LlamaForCausalLM(_graph_cfg(), device=cuda, dtype='bfloat16',
                             generator=generator(16, cuda))
    g = torch.Generator().manual_seed(17)
    prompts = [torch.randint(1, 512, (n,), generator=g).tolist()
               for n in (100, 12, 90)]
    sp = SamplingParams(max_new_tokens=8, eos_token_id=-1)
    kw = dict(num_slots=3, max_length=128, decode_block=4,
              prefill_chunk_tokens=32, kv_quant=quant)
    eng = InferenceEngine(model, **kw, kv_page_size=16)
    chunk = eng._prefill_chunk
    calls = []

    def failing(slot, h, cursor):
        if h.prompt_tokens == prompts[0]:
            calls.append(cursor)
            if len(calls) == 2:
                raise RuntimeError('injected')
        return chunk(slot, h, cursor)

    eng._prefill_chunk = failing
    hs = eng.generate_many(prompts[:2], sp)
    assert [h.status for h in hs] == [FAILED, FINISHED]
    assert eng.stats()['failed'] == 1
    assert eng.pool.free_page_count == eng.pool.num_pages - 1
    step = eng._prefill_steps[('chunk', 32)]
    assert step.graph is not None
    again = eng.generate_many(prompts, sp)     # the injection is spent
    twin = InferenceEngine(model, **kw, kv_page_size=16)
    twin._capture_decode = twin._capture_prefill = False
    want = twin.generate_many(prompts, sp)
    assert [h.status for h in again] == [FINISHED] * 3
    assert [h.tokens for h in again] == [h.tokens for h in want]
    assert eng._prefill_steps[('chunk', 32)] is step
    assert eng.stats()['traces']['paged_chunk_prefill_32'] == 1


# ---------------------------------------------------------------------------
# multi-tensor Adam/AdamW update and sum of squares
# ---------------------------------------------------------------------------

# element counts: 1, not a multiple of 8, a whole chunk, several chunks
# with a tail, and an empty tensor (no block)
_MT_SIZES = (1, 7, 13, 1000, K.MT_CHUNK, 3 * K.MT_CHUNK + 5, 0)
# (param dtype, moment dtype, fp32 master): masters only for 2-byte params
_MT_KINDS = [(torch.float32, torch.float32, False),
             (torch.float32, torch.bfloat16, False),
             (torch.bfloat16, torch.bfloat16, False),
             (torch.bfloat16, torch.float32, True),
             (torch.bfloat16, torch.bfloat16, True),
             (torch.float16, torch.float32, False),
             (torch.float16, torch.float32, True)]
# fp32 outputs agree to a few fp32 roundings (the kernel rounds each
# operation as the plain version's kernels do; sqrt and division may
# differ by an ulp); a bf16/fp16 output rounded from such values may
# then fall one ulp apart
_MT_RTOL = {torch.float32: 1e-6, torch.bfloat16: 2 ** -7,
            torch.float16: 2 ** -10}


def _mt_state(gen, sizes, p_dtype, m_dtype, master, ams):
    """(params, grads, m, v, masters, vmax) on the card, as after a few
    steps: params and grads of unit scale, m of the grads' scale, v > 0."""
    def t(n, dtype, scale=1.0, positive=False):
        x = torch.randn(n, generator=gen, device=gen.device) * scale
        return (x.abs() if positive else x).to(dtype)

    params = [t(n, p_dtype) for n in sizes]
    return (params, [t(n, p_dtype) for n in sizes],
            [t(n, m_dtype, 0.1) for n in sizes],
            [t(n, m_dtype, 0.01, True) for n in sizes],
            [p.float() if master else None for p in params],
            [t(n, m_dtype, 0.01, True) for n in sizes] if ams else None)


def _mt_clone(state):
    return tuple(None if ts is None else
                 [None if x is None else x.clone() for x in ts]
                 for ts in state)


def _mt_close(got, want):
    for ts_got, ts_want in zip(got, want):
        for a, b in zip(ts_got or (), ts_want or ()):
            if a is not None:
                torch.testing.assert_close(a, b, rtol=_MT_RTOL[a.dtype],
                                           atol=1e-7)


@pytest.mark.parametrize('mode,scale', [('decoupled', None),
                                        ('decoupled', 0.3), ('l2', 1.0),
                                        ('l1', 0.5)])
@pytest.mark.parametrize('ams', [False, True])
@pytest.mark.parametrize('p_dtype,m_dtype,master', _MT_KINDS)
def test_multi_tensor_adam_matches_plain(cuda, p_dtype, m_dtype, master, ams,
                                         mode, scale):
    """One step over every size, per-tensor decay (0 on one tensor), the
    clip scale below 1, at 1 and absent; one launch for the group."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    state = _mt_state(gen, _MT_SIZES, p_dtype, m_dtype, master, ams)
    ref = _mt_clone(state)
    decay = [0.01 * (i % 3) for i in range(len(_MT_SIZES))]
    kw = dict(lr_t=1e-3, beta1=0.9, beta2=0.95, epsilon=1e-5, decay=decay,
              decay_mode=mode)
    clip = None if scale is None else torch.tensor(scale, device=cuda)
    p_before = state[0][3].clone()
    before = K.LAUNCHES['multi_tensor_adam']
    K.multi_tensor_adam(*state, clip_scale=clip, **kw)
    assert K.LAUNCHES['multi_tensor_adam'] == before + 1
    K.multi_tensor_adam_reference(*ref[:4], ref[4], ref[5] or
                                  [None] * len(_MT_SIZES), clip_scale=clip,
                                  **kw)
    _mt_close(state, ref)
    assert not torch.equal(state[0][3], p_before)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_multi_tensor_sumsq_matches_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(2)
    xs = [_randn(gen, dtype, n) for n in _MT_SIZES]
    mixed = xs + [_randn(gen, torch.float32, 9), _randn(gen, torch.bfloat16,
                                                        17)]
    for ts in (xs, mixed, xs[:1]):
        got = K.multi_tensor_sumsq(ts)
        assert got.device.type == 'cuda' and got.shape == ()
        torch.testing.assert_close(got, K.multi_tensor_sumsq_reference(ts),
                                   rtol=1e-5, atol=0)
    assert float(K.multi_tensor_sumsq([])) == 0.0
    assert float(K.multi_tensor_sumsq([xs[-1]])) == 0.0     # empty tensor


def test_multi_tensor_kernels_take_300_tensors(cuda):
    """More tensors than one launch's table: several launches, each
    counted, the same result as the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    sizes = [int(n) for n in torch.randint(1, 3000, (300,), generator=gen,
                                           device=cuda).tolist()]
    state = _mt_state(gen, sizes, torch.bfloat16, torch.bfloat16, False,
                      False)
    ref = _mt_clone(state)
    kw = dict(lr_t=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8,
              decay=[1e-4] * 300, decay_mode='decoupled')
    K.reset_launch_counts()
    K.multi_tensor_adam(*state, **kw)
    K.multi_tensor_adam_reference(*ref[:4], [None] * 300, [None] * 300, **kw)
    _mt_close(state, ref)
    got = K.multi_tensor_sumsq(state[1])
    torch.testing.assert_close(got, K.multi_tensor_sumsq_reference(state[1]),
                               rtol=1e-5, atol=0)
    assert K.LAUNCHES['multi_tensor_adam'] == -(-300 // K.MT_ADAM_MAX_TENSORS)
    assert K.LAUNCHES['multi_tensor_sumsq'] == \
        -(-300 // K.MT_SUMSQ_MAX_TENSORS)


def test_multi_tensor_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    buf = torch.zeros(64, dtype=torch.bfloat16, device=cuda)
    view = buf[1:33]                     # 2 bytes past an aligned address
    ok = torch.zeros(32, dtype=torch.bfloat16, device=cuda)
    kw = dict(lr_t=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8, decay=[0.0],
              decay_mode='l2')
    with pytest.raises(ValueError, match='aligned'):
        K.multi_tensor_adam([view], [ok], [ok.float()], [ok.float()], **kw)
    with pytest.raises(ValueError, match='aligned'):
        K.multi_tensor_sumsq([view])
    f64 = torch.zeros(8, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        K.multi_tensor_adam([f64], [f64], [f64], [f64], **kw)
    with pytest.raises(ValueError):
        K.multi_tensor_adam([ok], [ok.float()], [ok], [ok], **kw)
    K.multi_tensor_adam([], [], [], [], **dict(kw, decay=[]))   # no launch
    from paddle_tpu_torch.optimizer import AdamW
    p = torch.nn.Parameter(buf[1:33].clone()[1:17])  # a misaligned param
    p.grad = torch.zeros_like(p)
    with pytest.raises(ValueError):
        AdamW(parameters=[p]).step()


def _opt_pair(cuda, make, sizes=(1, 7, 4096, 3 * K.MT_CHUNK + 5)):
    """The same bf16 parameters on the card and on the CPU, each under
    its own optimizer from make(named parameters)."""
    gen = torch.Generator().manual_seed(3)
    vals = [torch.randn(n, generator=gen).bfloat16() for n in sizes]
    names = ['w', 'norm.weight', 'b', 'lm_head']
    card = [(n, v.to(cuda).requires_grad_()) for n, v in zip(names, vals)]
    cpu = [(n, v.clone().requires_grad_()) for n, v in zip(names, vals)]
    return card, cpu, make(card), make(cpu)


def test_adamw_on_card_matches_cpu_over_fresh_grads(cuda):
    """Phase 5b's optimizer (clip, schedule, decay exemption, bf16 moments)
    takes two steps with new grad tensors each (so the launch table is
    rebuilt) on the card and on the CPU: the parameters agree to one bf16
    rounding, and the card ran the kernels."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)

    def make(named):
        return AdamW(learning_rate=LinearWarmup(
            CosineAnnealingDecay(3e-4, T_max=100, eta_min=3e-5),
            warmup_steps=2, start_lr=1e-4, end_lr=3e-4),
            beta2=0.95, epsilon=1e-5, weight_decay=0.1,
            apply_decay_param_fun=lambda n: 'norm' not in n,
            grad_clip=ClipGradByGlobalNorm(1.0), moment_dtype='bfloat16',
            parameters=named)

    card, cpu, opt_card, opt_cpu = _opt_pair(cuda, make)
    gen = torch.Generator().manual_seed(4)
    K.reset_launch_counts()
    for _ in range(2):
        for (_, pc), (_, pp) in zip(card, cpu):
            g = (3 * torch.randn(pp.shape, generator=gen)).bfloat16()
            pp.grad, pc.grad = g, g.to(cuda)
        for opt in (opt_card, opt_cpu):
            opt.step()
            opt._learning_rate.step()
    assert K.LAUNCHES['multi_tensor_adam'] == 2
    assert K.LAUNCHES['multi_tensor_sumsq'] == 2
    for (n, pc), (_, pp) in zip(card, cpu):
        torch.testing.assert_close(pc.detach().cpu(), pp.detach(),
                                   rtol=2 ** -7, atol=1e-6, msg=n)


@pytest.mark.parametrize('amsgrad', [False, True])
def test_adamw_update_syncs_nothing(cuda, amsgrad):
    """An AdamW update under a global-norm clip and a scheduler, its
    slots made on this step, never waits for the card: the norm stays on
    the device, the launch table is built from shapes."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import CosineAnnealingDecay

    def make(named):
        return AdamW(learning_rate=CosineAnnealingDecay(1e-3, T_max=10),
                     grad_clip=ClipGradByGlobalNorm(1.0), amsgrad=amsgrad,
                     multi_precision=True, parameters=named)

    card, _, opt, _ = _opt_pair(cuda, make)
    for _, p in card:
        p.grad = torch.ones_like(p)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        opt.step()
        opt.clear_grad()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert all(torch.isfinite(p).all() for _, p in card)


# ---------------------------------------------------------------------------
# speculative decoding: the paged kernel over k + 1 query rows per slot,
# the captured speculation round, and weight swaps
# ---------------------------------------------------------------------------

# (length of query row 0, window's first page) per slot: a span inside a
# page, spans that cross a page boundary (14 .. 18, 29 .. 33), a span
# that reaches the table's last row, length 1, and an inactive slot on
# the null page parked at its last row
_VERIFY_SLOTS = ((5, 0), (15, 0), (30, 1), (156, 9), (1, 0), (160, 9))


@pytest.mark.parametrize('t_rows,h,hkv', [(5, 8, 8), (5, 8, 2), (3, 16, 2),
                                          (2, 16, 1)])
@pytest.mark.parametrize('mode', ['float', 'int8', 'int8_window'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_paged_kernel_with_query_rows_matches_plain(cuda, dtype, mode,
                                                    t_rows, h, hkv):
    """q [N, T, H, D], T x G query rows per kv head (5, 20, 24 and 32),
    each row t seeing lengths + t keys: float pages, int8 pages, and int8
    pages with a float window of 2 pages that holds other values than the
    pages it stands for; one call counts one verify launch
    (`paged_attention_verify`, over int8 pages
    `paged_attention_verify_int8`)."""
    g = torch.Generator(device=cuda).manual_seed(t_rows * h + hkv)
    n, p, ps = len(_VERIFY_SLOTS), 10, 16
    num_pages = n * p + 1
    q = _randn(g, dtype, n, t_rows, h, 128)
    shape = (num_pages, ps, hkv, 128)
    kw = {}
    if mode == 'float':
        kp, vp = _randn(g, dtype, *shape), _randn(g, dtype, *shape)
    else:
        kp, vp = (torch.randint(-127, 128, shape, generator=g, device=cuda,
                                dtype=torch.int8) for _ in range(2))
        kw = dict(zip(('k_scales', 'v_scales'), (
            torch.rand((num_pages, hkv), generator=g, device=cuda) / 127
            + 1e-3 for _ in range(2))))
    if mode == 'int8_window':
        kw.update(k_win=_randn(g, dtype, n, 2, ps, hkv, 128),
                  v_win=_randn(g, dtype, n, 2, ps, hkv, 128),
                  win_first=torch.tensor([f for _, f in _VERIFY_SLOTS],
                                         device=cuda, dtype=torch.int32))
    table = (torch.randperm(num_pages - 1, generator=g, device=cuda)[:n * p]
             + 1).to(torch.int32).reshape(n, p)
    table[-1] = 0
    lens = torch.tensor([ln for ln, _ in _VERIFY_SLOTS], device=cuda,
                        dtype=torch.int32)
    key = 'paged_attention_verify' + ('' if mode == 'float' else '_int8')
    before = dict(K.LAUNCHES)
    got = K.paged_attention(q, kp, vp, table, lens, **kw)
    assert K.LAUNCHES[key] == before[key] + 1
    assert all(K.LAUNCHES[k] == before[k] for k in K.LAUNCHES if k != key)
    _close_attention(got, K.paged_attention_reference(q, kp, vp, table, lens,
                                                      **kw), dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_paged_one_query_row_equals_the_decode_call(cuda, dtype):
    """q [N, 1, H, D] runs the decode call's arithmetic: bit-equal to q
    [N, H, D]."""
    g = torch.Generator(device=cuda).manual_seed(3)
    n, p, ps, hkv = 4, 8, 16, 2
    q = _randn(g, dtype, n, 8, 128)
    kp, vp = (_randn(g, dtype, n * p + 1, ps, hkv, 128) for _ in range(2))
    table = (torch.randperm(n * p, generator=g, device=cuda) + 1).to(
        torch.int32).reshape(n, p)
    lens = torch.tensor([1, 17, 64, 128], device=cuda, dtype=torch.int32)
    flat = K.paged_attention(q, kp, vp, table, lens)
    rows = K.paged_attention(q[:, None].contiguous(), kp, vp, table, lens)
    assert torch.equal(rows[:, 0], flat)


def test_paged_wrapper_raises_past_its_query_rows(cuda):
    """More than PAGED_MAX_ROWS query rows per kv head have no kernel:
    the wrapper raises and launches nothing."""
    q = torch.zeros((1, 5, 8, 128), device=cuda)      # 5 x 8 = 40 rows
    pages = torch.zeros((3, 16, 1, 128), device=cuda)
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match='query rows'):
        K.paged_attention(q, pages, pages,
                          torch.ones((1, 1), device=cuda, dtype=torch.int32),
                          torch.ones(1, device=cuda, dtype=torch.int32))
    assert K.LAUNCHES == before


@pytest.mark.parametrize('quant,banked', [(None, False), ('int8', False),
                                          (None, True)])
def test_spec_graph_engine_equals_eager_and_plain(cuda, quant, banked):
    """The speculating engine (f32, an independent 1-layer draft, k = 4)
    replaying its round and its prefills (the draft's too) from CUDA
    graphs gives its eager twin's tokens and launch counts, a seeded
    sampling request included, and over float pages greedy requests the
    plain engine's tokens (over int8 pages the verify's rejected rows
    enter each touched page's requantize scale, as in the JAX engine, so
    they may differ); one verify launch per layer of every round;
    `traces` holds the round once and each prefill step built."""
    from paddle_tpu_torch.serving import (SAMPLING, AdapterBank,
                                          make_adapter_factors)
    model = LlamaForCausalLM(_graph_cfg(), device=cuda,
                             generator=generator(21, cuda))
    draft_cfg = _graph_cfg()
    draft_cfg.num_hidden_layers = 1
    draft = LlamaForCausalLM(draft_cfg, device=cuda,
                             generator=generator(22, cuda))
    bank = ids = None
    if banked:
        bank = AdapterBank(model, capacity=2, rank=8,
                           targets=('q_proj', 'k_proj', 'v_proj', 'o_proj'))
        for i in range(2):
            bank.load(f'ad{i}', make_adapter_factors(bank, i + 1, scale=0.1))
        ids = ['ad0', None, 'ad1', None, 'ad0']
    g = torch.Generator().manual_seed(23)
    prompts = [torch.randint(1, 512, (n,), generator=g).tolist()
               for n in (5, 40, 17, 100, 9)]
    params = [SamplingParams(max_new_tokens=14, eos_token_id=-1)
              for _ in prompts]
    params[3] = SamplingParams(max_new_tokens=14, eos_token_id=-1,
                               strategy=SAMPLING, temperature=0.8,
                               top_p=0.9, seed=3)
    kw = dict(num_slots=3, max_length=128, kv_quant=quant, adapter_bank=bank)
    runs = []
    for graph in (True, False):
        eng = InferenceEngine(model, draft_model=draft, num_draft_tokens=4,
                              **kw, kv_page_size=16)
        eng._capture_decode = eng._capture_prefill = graph
        toks = []
        for _ in range(2):      # the first pass captures what it uses
            eng.reset_stats()
            K.reset_launch_counts()
            toks.append([h.tokens for h in eng.generate_many(
                prompts, params, adapter_ids=ids)])
        assert toks[0] == toks[1]
        runs.append((toks[1], dict(K.LAUNCHES), eng))
    (graph_toks, graph_launches, graph_eng), (eager_toks, eager_launches,
                                              _) = runs
    assert graph_toks == eager_toks
    assert graph_launches == eager_launches
    st = graph_eng.stats()
    verify = 'paged_attention_verify' + ('_int8' if quant else '')
    assert graph_launches[verify] == 2 * st['spec']['rounds']
    assert st['traces'] == {'paged_spec_decode_k4': 1, **{
        step.name: 1 for step in graph_eng._prefill_steps.values()}}
    if quant is None:
        plain = InferenceEngine(model, decode_block=4, **kw,
                                kv_page_size=16).generate_many(
            prompts, params, adapter_ids=ids)
        for j, h in enumerate(plain):
            if j != 3:
                assert h.tokens == graph_toks[j]


def test_capture_runs_no_collection_of_a_dropped_engine(cuda):
    """A dropped graph engine that a reference cycle holds lives on until
    the collector runs. A collection inside a new engine's capture would free
    its graphs there and invalidate that capture (the body's next cuBLAS
    call then fails), so the collector is off while a capture runs: with
    the dropped engine's collection due at every forward of the capture,
    none runs, the new engine gives the dropped one's tokens, and the
    collector is on again afterwards and frees the dropped engine."""
    import gc
    import weakref
    model = LlamaForCausalLM(_graph_cfg(), device=cuda,
                             generator=generator(31, cuda))
    prompts = [[5, 6, 7, 8, 9], [1, 2, 3]]
    params = SamplingParams(max_new_tokens=6, eos_token_id=-1)

    def serve():
        eng = InferenceEngine(model, num_slots=2, max_length=64,
                              kv_page_size=16)
        eng._capture_decode = eng._capture_prefill = True
        return eng, [h.tokens for h in eng.generate_many(prompts, params)]

    collector_on = []

    def collect_in_capture(module, args):
        if torch.cuda.is_current_stream_capturing():
            collector_on.append(gc.isenabled())
            if gc.isenabled():     # what a collection due now would do
                gc.collect()

    eng, want = serve()
    dropped = weakref.ref(eng)
    threshold = gc.get_threshold()
    gc.set_threshold(1 << 30)      # no collection but the hook's
    try:
        cycle = [eng]
        cycle.append(cycle)
        del eng, cycle
        assert dropped() is not None
        hook = model.register_forward_pre_hook(collect_in_capture)
        try:
            _, got = serve()
        finally:
            hook.remove()
    finally:
        gc.set_threshold(*threshold)
    assert collector_on and not any(collector_on)
    assert gc.isenabled()
    assert got == want
    gc.collect()
    assert dropped() is None


def test_swap_and_restore_on_the_graph_engine(cuda):
    """On the graph engine a swap copies the new weights into the live
    parameters (the captured graphs read them: the tokens equal a fresh
    engine's on those weights) and a restore gives the old tokens bit for
    bit; nothing is captured again."""
    model = LlamaForCausalLM(_graph_cfg(), device=cuda, dtype='bfloat16',
                             generator=generator(24, cuda))
    other = LlamaForCausalLM(_graph_cfg(), device=cuda, dtype='bfloat16',
                             generator=generator(25, cuda))
    state = {k: v.cpu() for k, v in other.state_dict().items()}
    g = torch.Generator().manual_seed(26)
    prompts = [torch.randint(1, 512, (n,), generator=g).tolist()
               for n in (7, 60)]
    sp = SamplingParams(max_new_tokens=10, eos_token_id=-1)
    eng = InferenceEngine(model, num_slots=2, max_length=128, decode_block=4,
                          kv_page_size=16)
    before = [h.tokens for h in eng.generate_many(prompts, sp)]
    traces = dict(eng.stats()['traces'])
    prev = eng.swap_weights(state, version=1)
    after = [h.tokens for h in eng.generate_many(prompts, sp)]
    fresh = InferenceEngine(other, num_slots=2, max_length=128,
                            decode_block=4, kv_page_size=16)
    assert after == [h.tokens for h in fresh.generate_many(prompts, sp)]
    assert after != before
    eng.restore_weights(prev)
    assert [h.tokens for h in eng.generate_many(prompts, sp)] == before
    assert eng.stats()['traces'] == traces


# ---------------------------------------------------------------------------
# the store-backed adapter bank under the captured graphs
# ---------------------------------------------------------------------------

_TARGETS = ('q_proj', 'k_proj', 'v_proj', 'o_proj')


def _store_case(cuda, seed):
    """A 2-layer bf16 model and prompts of buckets 8, 32 and 64."""
    model = LlamaForCausalLM(_graph_cfg(), device=cuda, dtype='bfloat16',
                             generator=generator(seed, cuda))
    g = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(1, 512, (n,), generator=g).tolist()
               for n in (5, 17, 40, 9)]
    return model, prompts


def _bank_engine(model, store_dir=None, capacity=3, capture=True, load=()):
    """An engine of 3 slots over a rank-8 f32 bank on q/k/v/o_proj (with
    `store_dir`, store-backed), `load` = [(adapter id, seed)] loaded
    directly; `capture` False runs it eagerly."""
    from paddle_tpu_torch.serving import AdapterBank, make_adapter_factors
    bank = AdapterBank(model, capacity=capacity, rank=8, targets=_TARGETS,
                       store_dir=store_dir)
    for aid, seed in load:
        bank.load(aid, make_adapter_factors(bank, seed, scale=0.1),
                  version=1)
    eng = InferenceEngine(model, num_slots=3, max_length=128, decode_block=4,
                          adapter_bank=bank, kv_page_size=16)
    eng._capture_decode = eng._capture_prefill = capture
    return eng


def _publish(bank, aid, seed):
    from paddle_tpu_torch.serving import make_adapter_factors
    return bank.publish(aid, make_adapter_factors(bank, seed, scale=0.1))


def test_store_backed_bank_hot_loads_under_the_graphs(cuda, tmp_path):
    """The graph engine over a store-backed bank: a mixed wave whose pins
    load from the store gives the tokens of a bank `load`ed directly; a
    publish while a v1 request decodes leaves it bit-exact and serves a
    new request v2 from another slot (the tokens of a bank holding only
    v2); a corrupt v3 is quarantined and v2 keeps serving. Nothing is
    captured again after the warm-up, and the adapter kernel launches
    once per adapted projection of every prefill and decode sub-step."""
    from paddle_tpu_torch.serving import WeightStore
    model, prompts = _store_case(cuda, 31)
    ids = [None, 'ad0', 'ad1', 'ad0']
    sp = SamplingParams(max_new_tokens=12, eos_token_id=-1)
    # the references first: their launches must not enter the count
    ref = _bank_engine(model, capture=False, load=[('ad0', 1), ('ad1', 2)])
    want = [h.tokens for h in ref.generate_many(prompts, sp,
                                                adapter_ids=ids)]
    v1_want = ref.generate_many([prompts[2]], sp,
                                adapter_ids='ad0')[0].tokens
    v2_want = _bank_engine(model, capture=False, load=[('ad0', 11)]) \
        .generate_many([prompts[2]], sp, adapter_ids='ad0')[0].tokens
    eng = _bank_engine(model, str(tmp_path))
    bank = eng.adapter_bank
    _publish(bank, 'ad0', 1)
    _publish(bank, 'ad1', 2)
    eng.generate_many(prompts, SamplingParams(max_new_tokens=1,
                                              eos_token_id=-1),
                      adapter_ids=ids)
    traces = dict(eng.stats()['traces'])
    eng.reset_stats()
    K.reset_launch_counts()
    assert [h.tokens for h in eng.generate_many(prompts, sp,
                                                adapter_ids=ids)] == want
    h1 = eng.submit(prompts[2], sp, adapter_id='ad0')
    eng.step()
    eng.step()
    slot1 = h1._adapter_pin
    assert not h1.done and h1.adapter_version == 1
    assert _publish(bank, 'ad0', 11) == 2
    h2 = eng.submit(prompts[2], sp, adapter_id='ad0')
    eng.step()
    assert h2._adapter_pin not in (None, slot1)
    eng.run()
    assert h1.tokens == v1_want
    assert (h2.adapter_version, h2.tokens) == (2, v2_want)
    _publish(bank, 'ad0', 12)
    payload = tmp_path / 'ad0' / 'step_3' / 'tree.npz'
    raw = bytearray(payload.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    payload.write_bytes(bytes(raw))
    h3 = eng.submit(prompts[2], sp, adapter_id='ad0')
    eng.run()
    assert (h3.adapter_version, h3.tokens) == (2, v2_want)
    assert WeightStore(str(tmp_path / 'ad0')).quarantined() == [3]
    st = eng.stats()
    assert st['traces'] == traces
    assert K.LAUNCHES['adapter_matmul'] == 8 * (st['prefills'] +
                                                st['decode_steps']) > 0


def test_store_backed_bank_full_of_pins_requeues_on_the_card(cuda,
                                                             tmp_path):
    """Three adapters in flight on a bank of two slots, on the graph
    engine: the third admission is requeued (not failed) until a pin
    frees, and every request gets the tokens it gets served alone."""
    model, prompts = _store_case(cuda, 32)
    ids = ['ad0', 'ad1', 'ad2']
    sp = SamplingParams(max_new_tokens=12, eos_token_id=-1)
    eng = _bank_engine(model, str(tmp_path), capacity=2)
    for i, aid in enumerate(ids):
        _publish(eng.adapter_bank, aid, i + 1)
    eng.generate_many(prompts[:3], SamplingParams(max_new_tokens=1,
                                                  eos_token_id=-1),
                      adapter_ids=ids)
    traces = dict(eng.stats()['traces'])
    eng.reset_stats()
    got = [h.tokens for h in eng.generate_many(prompts[:3], sp,
                                               adapter_ids=ids)]
    st = eng.stats()
    assert st['requeued'] > 0 and st['failed'] == 0
    assert st['traces'] == traces
    for j, aid in enumerate(ids):
        alone = _bank_engine(model, capture=False, load=[(aid, j + 1)])
        assert got[j] == alone.generate_many(
            [prompts[j]], sp, adapter_ids=aid)[0].tokens, aid


# ---------------------------------------------------------------------------
# observability: the graph engine reports what its eager twin reports
# ---------------------------------------------------------------------------

def _obs_view(obs, before=None) -> dict:
    """The registry's non-time samples: counters (less `before`'s, for a
    run's change), gauges, and histogram counts (the occupancy
    histogram by its buckets too)."""
    out = {}
    for m in obs.get_registry().snapshot()['metrics']:
        name = m['name']
        timed = 'seconds' in name or 'fraction' in name
        if not name.startswith('paddle_serving') or (
                timed and m['type'] != 'histogram'):
            continue
        for s in m['samples']:
            key = (name, tuple(sorted(s['labels'].items())))
            if m['type'] == 'histogram':
                out[key] = ((s['count'],) if timed else
                            (s['count'], tuple(s['buckets'].values())))
            else:
                out[key] = s['value']
    if before is not None:
        for key, v in before.items():
            if key[0].endswith('_total'):
                out[key] = out[key] - v
            elif isinstance(v, tuple):
                out[key] = tuple(a - b for a, b in zip(out[key], v)) \
                    if len(v) == 1 else (out[key][0] - v[0], tuple(
                        a - b for a, b in zip(out[key][1], v[1])))
    return out


def _obs_events(obs, handles) -> list:
    """The event log's events and spans, time fields removed, request ids
    mapped to submission order."""
    ids = {h.request_id: i for i, h in enumerate(handles)}
    out = []
    for e in obs.get_event_log().events():
        attrs = dict(e.get('attrs') or {})
        attrs.pop('seconds', None)
        if 'request_id' in attrs:
            attrs['request_id'] = ids.get(attrs['request_id'])
        if 'requests' in attrs:
            attrs['requests'] = [ids.get(r) for r in attrs['requests']]
        out.append((e['name'], e.get('depth'), attrs))
    return out


def _observed_run(model, capture, prompts, params, **kw):
    """Warm an engine up (a graph engine captures its decode step and
    every prefill bucket it will use), then serve `prompts` from a clean
    event log: (the run's metric changes, its events, its tokens)."""
    from paddle_tpu_torch import observability as obs
    eng = InferenceEngine(model, num_slots=3, max_length=128, decode_block=4,
                          **kw, kv_page_size=16)
    eng._capture_decode = eng._capture_prefill = capture
    eng.generate_many([prompts[0][:3]],
                      SamplingParams(max_new_tokens=4, eos_token_id=-1))
    eng.generate_many(prompts, SamplingParams(max_new_tokens=1,
                                              eos_token_id=-1))
    traces = dict(eng.stats()['traces'])
    before = _obs_view(obs)
    obs.get_event_log().clear()
    hs = eng.generate_many(prompts, params)
    assert eng.stats()['traces'] == traces     # nothing captured again
    assert traces == (_traces(eng) if capture else {})
    return _obs_view(obs, before), _obs_events(obs, hs), \
        [h.tokens for h in hs]


@pytest.mark.parametrize('kind', ['plain', 'prefix', 'int8'])
def test_graph_engine_observability_equals_its_eager_twin(cuda, kind):
    """With observability on, the graph engine and its eager twin leave
    the same serving counters, gauges and histogram counts, and the same
    events and spans in the same order with the same non-time fields;
    the graph engine captures nothing in the observed run."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving import SAMPLING
    obs.enable()
    kw = {'plain': {}, 'int8': {'kv_quant': 'int8'},
          'prefix': {'prefix_cache': 0.5, 'prefill_chunk_tokens': 32}}[kind]
    model = LlamaForCausalLM(_graph_cfg(), device=cuda, dtype='bfloat16',
                             generator=generator(21, cuda))
    g = torch.Generator().manual_seed(22)
    system = torch.randint(1, 512, (40,), generator=g).tolist()
    prompts = [system + torch.randint(1, 512, (s,), generator=g).tolist()
               if kind == 'prefix' and i % 2 else
               torch.randint(1, 512, (s,), generator=g).tolist()
               for i, s in enumerate((3, 17, 70, 9, 25, 5))]
    params = [SamplingParams(max_new_tokens=12, eos_token_id=-1)
              for _ in prompts]
    params[3] = SamplingParams(max_new_tokens=12, eos_token_id=-1,
                               strategy=SAMPLING, temperature=0.8,
                               top_p=0.9, seed=7)
    graph = _observed_run(model, True, prompts, params, **kw)
    eager = _observed_run(model, False, prompts, params, **kw)
    assert graph[0] == eager[0]
    assert graph[1] == eager[1]
    assert graph[2] == eager[2]
    names = {name for name, _, _ in graph[1]}
    assert {'serving.queue', 'serving.decode_round'} <= names
    assert graph[0][('paddle_serving_tokens_total', ())] == 6 * 12


# ---------------------------------------------------------------------------
# replicated serving in one process: the router over graph engines
# ---------------------------------------------------------------------------

def _fleet_case(cuda):
    """A 2-layer bf16 model, 8 prompts of buckets 8 to 64, a budget of 10."""
    model = LlamaForCausalLM(_graph_cfg(), device=cuda, dtype='bfloat16',
                             generator=generator(31, cuda))
    g = torch.Generator().manual_seed(32)
    prompts = [torch.randint(1, 512, (n,), generator=g).tolist()
               for n in (5, 60, 17, 33, 9, 41, 3, 28)]
    return model, prompts, SamplingParams(max_new_tokens=10,
                                          eos_token_id=-1)


def test_two_replica_router_on_the_card_equals_one(cuda):
    """Two graph-engine replicas behind a Router (replica 1 over its own
    copy of the weights, on the card) give every request the tokens of a
    one-replica router, and each replica's programs are booked in the
    catalog under the JAX names."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving import ReplicaSet, Router
    obs.enable()
    model, prompts, sp = _fleet_case(cuda)
    kw = dict(num_slots=2, max_length=128, decode_block=4, kv_page_size=16)
    one = Router(ReplicaSet(model, 1, **kw)).generate_many(prompts, sp)
    rs = ReplicaSet(model, 2, **kw)
    two = Router(rs).generate_many(prompts, sp)
    assert [h.tokens for h in two] == [h.tokens for h in one]
    assert {h.replica_id for h in two} == {0, 1}
    p0, p1 = (dict(r.engine.model.named_parameters()) for r in rs)
    assert all(p0[n].data_ptr() != p1[n].data_ptr() for n in p0)
    assert rs[0].engine.model is model
    for r in rs:
        assert r.engine.stats()['traces'].get('paged_decode_step') == 1
        assert r.engine._program_calls['serving.paged_decode_block'] > 0
    names = {rec.name for rec in obs.program_catalog().records()}
    assert 'serving.paged_decode_block' in names


def test_router_failover_on_the_card_loses_nothing(cuda):
    """Replica 0 of two graph engines raises a transient error at its 3rd
    step: its requests fail over to replica 1, none is lost, and every
    request's tokens equal the undisturbed run's; a CUDA error instead
    fails the orphans with the typed ReplicaFailure."""
    from paddle_tpu_torch.resilience import TransientError
    from paddle_tpu_torch.serving import ReplicaSet, Router
    model, prompts, sp = _fleet_case(cuda)
    kw = dict(num_slots=2, max_length=128, decode_block=4, kv_page_size=16)
    calm = [h.tokens for h in Router(ReplicaSet(model, 2, **kw))
            .generate_many(prompts, sp)]
    for exc, transient in (
            (TransientError('UNAVAILABLE: injected replica loss'), True),
            (RuntimeError('CUDA error: an illegal memory access was '
                          'encountered'), False)):
        rs = ReplicaSet(model, 2, **kw)
        router = Router(rs)
        victim, calls = rs[0].engine, [0]
        real = victim.step

        def dying(real=real, calls=calls, exc=exc):
            calls[0] += 1
            if calls[0] == 3:
                raise exc
            return real()
        victim.step = dying
        hs = router.generate_many(prompts, sp)
        assert all(h.status == 'FINISHED' or (h.status == 'FAILED'
                                              and h.error is not None)
                   for h in hs)
        if transient:
            assert [h.tokens for h in hs] == calm
            assert sum(h.failovers for h in hs) > 0
        else:
            failed = [h for h in hs if h.status == 'FAILED']
            assert failed and all(type(h.error).__name__ ==
                                  'ReplicaFailure' for h in failed)
            assert all(h.tokens == calm[i] for i, h in enumerate(hs)
                       if h.status == 'FINISHED')


def test_replica_process_on_the_card_serves_the_in_process_tokens(
        cuda, tmp_path):
    """A replica process (`replica_main` on the card, started by a
    `Supervisor`) over the weights of an in-process graph engine,
    published to a `WeightStore`: every request's tokens equal the
    in-process engine's; at its ready-marks it had captured the decode
    step and every prefill bucket, compiled no kernel source, and its
    serving window captures nothing; its kernels launched."""
    import os
    from paddle_tpu_torch.serving import (ReplicaSpec, Supervisor,
                                          WeightStore)
    from paddle_tpu_torch.weights import param_digest
    model, prompts, sp = _fleet_case(cuda)
    kw = dict(num_slots=2, max_length=128, decode_block=4, kv_page_size=16)
    want = [h.tokens for h in InferenceEngine(model, **kw).generate_many(
        prompts, sp)]
    WeightStore(str(tmp_path / 'w')).publish(model.state_dict())
    cfg = _graph_cfg()
    factory = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           'test_torch_fleet_factory.py') + ':tiny_llama'
    spec = ReplicaSpec(factory, model_kwargs=dict(
        dtype='bfloat16', vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads,
        max_position_embeddings=cfg.max_position_embeddings),
        engine_kwargs=kw, weight_store_dir=str(tmp_path / 'w'))
    sup = Supervisor(str(tmp_path / 'run'), spec)
    try:
        rr = sup.spawn('c0')
        got = [h.tokens for h in rr.generate_many(prompts, sp)]
        st = rr.stats()
    finally:
        sup.stop_all()
    assert got == want
    assert st['param_digest'] == param_digest(model)
    buckets = st['pool']['buckets']
    assert st['traces_at_ready'] == {'paged_decode_step': 1, **{
        f'paged_prefill_{b}': 1 for b in buckets}}
    assert st['traces'] == st['traces_at_ready']
    assert st['kernel_builds'] == st['kernel_builds_at_ready'] == 0
    for name in ('flash_attention_fwd', 'paged_attention', 'rms_norm'):
        assert st['launches'][name] > 0


# ---------------------------------------------------------------------------
# the rest of training: host-offloaded optimizer state, selective
# recompute, tied embeddings, the fault-tolerant step
# ---------------------------------------------------------------------------

def _small_llama(cuda, dtype='float32', **kw):
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, **kw)
    return LlamaForCausalLM(cfg, device=cuda, dtype=dtype,
                            generator=generator(4, cuda))


def _next_token_loss(logits, labels):
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           labels[:, 1:].reshape(-1))


def _offload_pair(cuda, chunk=None, **opt_kw):
    """The same bf16 model twice on the card, one AdamW in HBM and one
    offloaded (its ring cut to `chunk` elements)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.offload import OffloadEngine
    steps = []
    for offload in (None, 'host'):
        model = _small_llama(cuda, 'bfloat16')
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    offload=offload, **opt_kw)
        if offload and chunk:
            opt._engine = OffloadEngine(opt, chunk=chunk)
        steps.append(TrainStep(model, _next_token_loss, opt))
    return steps


@pytest.mark.parametrize('opt_kw', [dict(moment_dtype='bfloat16'),
                                    dict(multi_precision=True),
                                    dict(amsgrad=True, grad_clip='global')])
def test_offload_equals_in_hbm_bit_for_bit_on_the_card(cuda, opt_kw):
    """Two steps each: parameters and every slot bit-equal, the offloaded
    slots pinned host tensors, the ring cut into many groups."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    if opt_kw.get('grad_clip') == 'global':
        opt_kw = dict(opt_kw, grad_clip=ClipGradByGlobalNorm(0.5))
    hbm, off = _offload_pair(cuda, chunk=1 << 16, **opt_kw)
    ids = torch.randint(0, 512, (2, 96), generator=torch.Generator()
                        .manual_seed(0))
    for _ in range(2):
        assert float(hbm(ids, ids)) == float(off(ids, ids))
    for (n, a), (_, b) in zip(hbm.layer.named_parameters(),
                              off.layer.named_parameters()):
        assert torch.equal(a, b), n
    want, got = hbm.opt_state(), off.opt_state()
    for n, slots in want['slots'].items():
        for k, v in slots.items():
            g = got['slots'][n][k]
            assert g.device.type == 'cpu' and g.is_pinned(), (n, k)
            assert torch.equal(g, v.cpu()), (n, k)


def test_offload_update_syncs_nothing(cuda):
    """After the first update (which allocates the pinned buffers and
    copies the masters), an offloaded update never waits for the card:
    the copies are pinned and ordered by events."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.offload import OffloadEngine
    params = [torch.randn(n, device=cuda).bfloat16().requires_grad_()
              for n in (1, 7, 4096, 3 * K.MT_CHUNK + 5)]
    opt = AdamW(learning_rate=1e-3, parameters=params,
                grad_clip=ClipGradByGlobalNorm(1.0), multi_precision=True,
                offload='host')
    opt._engine = OffloadEngine(opt, chunk=1 << 15)
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    torch.cuda.synchronize()
    groups = len(opt._engine._groups(params))
    K.reset_launch_counts()
    torch.cuda.set_sync_debug_mode('error')
    try:
        for _ in range(2):
            opt.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert groups >= 3      # the widest parameter spans two ring groups
    assert K.LAUNCHES['multi_tensor_adam'] == 2 * groups
    assert all(torch.isfinite(p).all() for p in params)
    opt._settle()
    assert all(v.is_pinned() for s in opt._slots.values() for v in s.values())


def _backward_mm(cuda, policy):
    from torch.utils._python_dispatch import TorchDispatchMode
    import collections

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func.overloadpacket.__name__] += 1
            return func(*args, **(kwargs or {}))
    model = _small_llama(cuda, 'bfloat16', use_recompute=policy)
    ids = torch.randint(0, 512, (2, 128), device=cuda)
    loss = _next_token_loss(model(ids), ids)
    K.reset_launch_counts()
    with Count() as count:
        loss.backward()
    return count.ops, dict(K.LAUNCHES)


def test_recompute_policies_on_the_card(cuda):
    """The backward's weight matmuls by policy (2 layers x 7 projections,
    plus the head): 'dots_no_batch' and 'dots' dispatch only the
    gradients' two per projection, True also reruns the forward's; no
    policy sees a bmm (attention is the flash kernels), and every
    recompute reruns the flash forward and RMSNorm kernels."""
    grads = 2 * (7 * 2 + 1)
    ops = {p: _backward_mm(cuda, p) for p in (False, True, 'dots',
                                               'dots_no_batch')}
    assert ops[False][0]['mm'] == grads
    assert ops['dots_no_batch'][0]['mm'] == ops['dots'][0]['mm'] == grads
    assert ops[True][0]['mm'] == grads + 6 * 2
    for p, (o, launches) in ops.items():
        assert o['bmm'] == 0, p
        assert launches['flash_attention_bwd_dq'] == 2, p
        assert launches['flash_attention_fwd'] == (0 if p is False else 2), p
        assert (launches['rms_norm'] > 0) == (p is not False), p


@pytest.mark.parametrize('policy', [False, 'dots_no_batch'])
def test_tied_model_on_the_card_matches_the_cpu(cuda, policy):
    """f32, TF32 off: the tied model's loss and every gradient (the
    embedding's sums the gather's and the head's) on the card equal the
    CPU plain run's."""
    model = _small_llama(cuda, tie_word_embeddings=True,
                         use_recompute=policy)
    assert model.lm_head is None
    cpu = LlamaForCausalLM(model.config, device='cpu')
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    ids = torch.randint(0, 512, (2, 96), generator=torch.Generator()
                        .manual_seed(1))
    out = []
    for m in (model, cpu):
        loss = _next_token_loss(m(ids.to(m.device)), ids.to(m.device))
        loss.backward()
        out.append((float(loss), {n: p.grad.float().cpu()
                                  for n, p in m.named_parameters()}))
    assert abs(out[0][0] - out[1][0]) <= 1e-4 * abs(out[1][0])
    for n, g in out[1][1].items():
        assert (out[0][1][n] - g).norm() <= 1e-3 * g.norm(), n


@pytest.mark.parametrize('offload', [None, 'host'])
def test_fault_tolerant_step_restores_bit_for_bit_on_the_card(cuda,
                                                              offload):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.resilience import FaultTolerantStep
    model = _small_llama(cuda, 'bfloat16')
    scale = {'v': 1.0}

    def loss_fn(logits, labels):
        return _next_token_loss(logits, labels) * scale['v']
    ft = FaultTolerantStep(TrainStep(model, loss_fn, AdamW(
        learning_rate=1e-3, parameters=model.parameters(),
        moment_dtype='bfloat16', offload=offload)), check_spikes=False)
    ids = torch.randint(0, 512, (2, 96), device=cuda)
    ft(ids, ids)
    ft(ids, ids)

    def live():
        out = {('param', n): p for n, p in model.named_parameters()}
        out.update({('slot', n, k): v for n, s in ft.opt_state()['slots']
                    .items() for k, v in s.items()})
        return out
    before = {k: v.detach().cpu().clone() for k, v in live().items()}
    scale['v'] = float('nan')
    ft(ids, ids)
    scale['v'] = 1.0
    assert ft.rollbacks == 1 and ft.last_step_skipped
    torch.cuda.synchronize()
    snap = ft.snapshot_tensors()
    for key, v in live().items():
        assert snap[key].dtype == v.dtype
        assert (not v.is_cuda) or snap[key].is_pinned()
        assert torch.equal(v.detach().cpu(), before[key]), key
        assert torch.equal(snap[key], before[key]), key
    assert torch.isfinite(ft(ids, ids))


# chip_smoke.TOL[fp16]: the bf16 limits 8 times tighter (3 more mantissa
# bits at the same rounding points)
REL_F16 = (2 ** -9, 2 ** -10)


def _close_f16(got, want):
    diff, want = got.double() - want.double(), want.double()
    assert diff.abs().max() <= REL_F16[0] * want.abs().max()
    assert diff.norm() <= REL_F16[1] * want.norm()


@pytest.mark.parametrize('sq,sk,hkv,causal', [
    (130, 130, 8, True), (1000, 1000, 1, True), (70, 90, 4, True),
    (63, 200, 2, False), (1, 130, 1, True)])
def test_fp16_flash_kernels_match_plain(cuda, sq, sk, hkv, causal):
    """The fp16 instantiations of the wgmma forward (with its LSE), dq
    and dk/dv against the plain versions, ragged, GQA, sq < sk; their
    launches count under the `_fp16` keys only."""
    dt = torch.float16
    g = torch.Generator(device=cuda).manual_seed(sq + sk)
    q, dout = _randn(g, dt, 2, sq, 8, 128), _randn(g, dt, 2, sq, 8, 128)
    k, v = _randn(g, dt, 2, sk, hkv, 128), _randn(g, dt, 2, sk, hkv, 128)
    before = dict(K.LAUNCHES)
    out, lse = K.flash_attention_fwd(q, k, v, causal, return_lse=True)
    want, want_lse = K.attention_reference(q, k, v, causal=causal,
                                           return_lse=True)
    assert out.dtype == dt
    _close_f16(out, want)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    got = K.flash_attention_bwd(q, k, v, out, lse, dout, causal)
    for i, (a, b) in enumerate(zip(
            got, K.attention_bwd_reference(q, k, v, out, lse, dout,
                                           causal))):
        assert a.dtype == dt
        if sk > 1 or i == 2:
            _close_f16(a, b)
    for name in ('flash_attention_fwd', 'flash_attention_bwd_dq',
                 'flash_attention_bwd_dkv'):
        assert K.LAUNCHES[name] == before[name]
        assert K.LAUNCHES[name + '_fp16'] == before[name + '_fp16'] + 1


def test_fp16_overflow_reaches_inf(cuda):
    """A dq past fp16's range is inf where the plain version's is, not
    clamped: what GradScaler must see."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q = _randn(g, torch.float16, 1, 256, 8, 128)
    k = (200 * _randn(g, torch.float32, 1, 256, 8, 128)).half()
    v = _randn(g, torch.float16, 1, 256, 8, 128)
    dout = (300 * _randn(g, torch.float32, 1, 256, 8, 128)).half()
    out, lse = K.flash_attention_fwd(q, k, v, True, return_lse=True)
    dq, _ = K.flash_attention_bwd_dq(q, k, v, out, lse, dout, True)
    want, _ = K.attention_bwd_dq_reference(q, k, v, out, lse, dout, True)
    assert torch.isinf(want).any() and not torch.isnan(dq).any()
    # a place may differ only where the finite side is within rounding of
    # 65504 (sums in another order), at most 1% of the infs
    differ = torch.isinf(dq) != torch.isinf(want)
    edge = 65504 * (1 - 2 ** -10)
    finite = torch.where(torch.isinf(dq), want, dq).float().abs()
    assert bool((finite[differ] >= edge).all())
    assert int(differ.sum()) <= 0.01 * int(torch.isinf(want).sum())


def _launched(key, before):
    """The launches under `key` since `before` (a copy of LAUNCHES), and
    no other key moved."""
    moved = {k: n - before[k] for k, n in K.LAUNCHES.items()
             if n != before[k]}
    assert set(moved) <= {key}, moved
    return moved.get(key, 0)


@pytest.mark.parametrize('rows,width', [(8, 4096), (1024, 4096), (7, 2048),
                                        (3, 1000)])
def test_fp16_rms_norm_kernel_matches_plain(cuda, rows, width):
    """The fp16 RMSNorm kernel (a model cast to fp16) against its plain
    version, aligned and ragged widths, rows near fp16's range; counted
    under `rms_norm_fp16` only."""
    g = torch.Generator(device=cuda).manual_seed(rows + width)
    x = (3 * _randn(g, torch.float32, rows, width)).half()
    x[0, :4] = 60000.0
    w = (1 + 0.1 * _randn(g, torch.float32, width)).half()
    before = dict(K.LAUNCHES)
    got = K.rms_norm(x, w)
    assert _launched('rms_norm_fp16', before) == 1
    assert got.dtype == torch.float16
    _close_f16(got, K.rms_norm_reference(x, w))


@pytest.mark.parametrize('case', ['unit', 'subnormal', 'near_max'])
@pytest.mark.parametrize('n,v', [(300, 32000), (5, 129)])
def test_fp16_ce_kernels_match_plain(cuda, n, v, case):
    """fp16 logits through the CE kernels: unit scale; g = 1/16 at unit
    logits, which puts most dlogits (p g, p ~ 1/V) in fp16's subnormal
    range at V = 32000, and the kernel keeps them as `.to(torch.float16)`
    does (as many nonzero subnormals, each within one subnormal step);
    logits at fp16's largest value. nll and lse stay f32; launches count
    under the `_fp16` keys."""
    g = torch.Generator(device=cuda).manual_seed(n + v + len(case))
    scale = 1.0 if case == 'subnormal' else 3.0
    x = (scale * _randn(g, torch.float32, n, v)).half()
    if case == 'near_max':
        x[:, :7] = 65504.0
        x[::3, 7] = -65504.0
    lab = torch.randint(0, v, (n,), generator=g, device=cuda,
                        dtype=torch.int32)
    up = (torch.full((n,), 1.0 / 16, device=cuda) if case == 'subnormal'
          else torch.randn(n, generator=g, device=cuda))
    before = dict(K.LAUNCHES)
    nll, lse = K.softmax_cross_entropy_fwd(x, lab)
    assert _launched('softmax_ce_fwd_fp16', before) == 1
    want_nll, want_lse = K.softmax_cross_entropy_fwd_reference(x, lab)
    torch.testing.assert_close(nll, want_nll, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    before = dict(K.LAUNCHES)
    dx = K.softmax_cross_entropy_bwd(x, lab, lse, up)
    assert _launched('softmax_ce_bwd_fp16', before) == 1
    want = K.softmax_cross_entropy_bwd_reference(x, lab, lse, up)
    assert dx.dtype == torch.float16
    _close_f16(dx, want)
    tiny = torch.finfo(torch.float16).tiny
    sub = (dx != 0) & (dx.abs() < tiny)
    want_sub = (want != 0) & (want.abs() < tiny)
    assert abs(int(sub.sum()) - int(want_sub.sum())) <= 0.005 * max(
        int(want_sub.sum()), 1)
    both = sub & want_sub
    if bool(both.any()):
        assert float((dx[both].float() - want[both].float()).abs().max()) \
            <= 2.0 ** -24
    if case == 'subnormal' and v == 32000:
        assert float(want_sub.float().mean()) > 0.5


@pytest.mark.parametrize('d', [64, 128])
@pytest.mark.parametrize('t', [1, 5])
@pytest.mark.parametrize('pages', ['fp16', 'int8_window'])
def test_fp16_paged_kernel_matches_plain(cuda, pages, t, d):
    """An fp16 q over fp16 pages, or over int8 pages with the round's
    fp16 window (starts at row offsets 0, 9 and 15, a length-1 slot, an
    inactive slot on the null page), T = 1 (decode) and 5 (verify), at
    head_dim 64 and 128: against the plain version, counted under the
    call's `_fp16` key only."""
    g = torch.Generator(device=cuda).manual_seed(d + t + len(pages))
    n, h, hkv, ps, p = 8, 8, 2, 16, 10
    num_pages = n * p + 1
    q = _randn(g, torch.float16, *((n, h, d) if t == 1 else (n, t, h, d)))
    shape = (num_pages, ps, hkv, d)
    table = (torch.randperm(num_pages - 1, generator=g, device=cuda)[:n * p]
             + 1).to(torch.int32).reshape(n, p)
    table[-1] = 0
    lens = torch.tensor([1, 10, 16, 26, 160 - t + 1, 100, 70, 150],
                        device=cuda, dtype=torch.int32)
    kw = {}
    if pages == 'fp16':
        kp, vp = (_randn(g, torch.float16, *shape) for _ in range(2))
    else:
        kp, vp = (torch.randint(-127, 128, shape, generator=g, device=cuda,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((num_pages, hkv), generator=g, device=cuda)
                  / 127 + 1e-3 for _ in range(2))
        first = torch.div(lens - 1, ps, rounding_mode='floor').to(torch.int32)
        kw = dict(k_scales=ks, v_scales=vs, win_first=first,
                  k_win=_randn(g, torch.float16, n, 2, ps, hkv, d),
                  v_win=_randn(g, torch.float16, n, 2, ps, hkv, d))
    key = K._key(('paged_attention_verify' if t > 1 else 'paged_attention')
                 + ('_int8' if pages != 'fp16' else ''), torch.float16, d)
    before = dict(K.LAUNCHES)
    got = K.paged_attention(q, kp, vp, table, lens, **kw)
    assert _launched(key, before) == 1
    assert got.dtype == torch.float16 and got.shape == q.shape
    _close_f16(got, K.paged_attention_reference(q, kp, vp, table, lens,
                                                **kw))


@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('w_dtype', [torch.float32, torch.float16])
@pytest.mark.parametrize('shape', ['decode', 'prefill', 'ragged',
                                   'tiled_rounds'])
def test_fp16_adapter_kernel_matches_plain(cuda, shape, w_dtype, fused):
    """An fp16 x over an f32 bank (the JAX bank's default) and over an
    fp16 bank, the delta and the fused add, against their plain
    versions; rows on slot 0 give an exact zero delta and y bit for bit;
    counted under `adapter_matmul_fp16` only."""
    b, t, h, r, o, rows = _ADAPTER_SHAPES[shape]
    g = torch.Generator(device=cuda).manual_seed(b * t + r + 1)
    args = _adapter_case(g, b, t, h, r, o, max(5, max(rows) + 1),
                         torch.float16, w_dtype, rows)
    y = _randn(g, torch.float16, b, t, o)
    before = dict(K.LAUNCHES)
    if fused:
        got, want = (K.adapter_matmul_add(y, *args),
                     K.adapter_matmul_add_reference(y, *args))
    else:
        got, want = K.adapter_matmul(*args), K.adapter_matmul_reference(*args)
    assert _launched('adapter_matmul_fp16', before) == 1
    assert got.dtype == torch.float16 and got.shape == want.shape
    _close_f16(got, want)
    base = args[3] == 0
    assert torch.equal(got[base], (y if fused else torch.zeros_like(y))[base])


def test_fp16_mismatched_dtypes_raise(cuda):
    """What no kernel was built for raises and launches nothing: fp16 q
    over float64 pages, an int8 window over int8 pages under an fp16 q, a
    bf16 weight under fp16 RMSNorm, an fp16 x over a bf16 bank. (fp16 q
    over bf16 pages, or over int8 pages with a bf16 window, has a build
    since the pool's dtype may differ from the model's:
    `test_paged_kv_dtype_pairs`.)"""
    h = torch.float16
    table = torch.ones((2, 2), device=cuda, dtype=torch.int32)
    lens = torch.ones(2, device=cuda, dtype=torch.int32)
    q = torch.zeros((2, 4, 128), device=cuda, dtype=h)
    before = dict(K.LAUNCHES)
    f64_pages = torch.zeros((3, 16, 2, 128), device=cuda,
                            dtype=torch.float64)
    with pytest.raises(ValueError):
        K.paged_attention(q, f64_pages, f64_pages, table, lens)
    i8 = torch.zeros((3, 16, 2, 128), device=cuda, dtype=torch.int8)
    sc = torch.ones((3, 2), device=cuda)
    win = torch.zeros((2, 1, 16, 2, 128), device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError):
        K.paged_attention(q, i8, i8, table, lens, k_scales=sc, v_scales=sc,
                          k_win=win, v_win=win,
                          win_first=torch.zeros(2, device=cuda,
                                                dtype=torch.int32))
    with pytest.raises(ValueError):
        K.rms_norm(torch.ones((4, 128), device=cuda, dtype=h),
                   torch.ones(128, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        K.adapter_matmul(torch.ones((2, 1, 128), device=cuda, dtype=h),
                         torch.zeros((2, 128, 8), device=cuda,
                                     dtype=torch.bfloat16),
                         torch.zeros((2, 8, 64), device=cuda,
                                     dtype=torch.bfloat16),
                         torch.zeros(2, device=cuda, dtype=torch.int32),
                         torch.ones(2, device=cuda))
    assert K.LAUNCHES == before


@pytest.mark.parametrize('opts', [{}, {'kv_quant': 'int8'}],
                         ids=['float_kv', 'int8_kv'])
def test_fp16_engine_graph_equals_eager(cuda, opts):
    """An fp16 Llama (2 layers, head_dim 128) behind the graph engine and
    its eager twin, with a bank of two adapters (f32, the JAX bank's
    default): equal tokens, greedy and a seeded sampling request; the
    fp16 kernels launched and no other paged, RMSNorm or adapter key."""
    from paddle_tpu_torch.serving import SAMPLING, AdapterBank, \
        make_adapter_factors
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, device=cuda, dtype='float16',
                             generator=generator(3, cuda))
    bank = AdapterBank(model, capacity=3, rank=8, dtype='float32',
                       targets=('q_proj', 'k_proj', 'v_proj', 'o_proj'))
    for i in range(2):
        bank.load(f'ad{i}', make_adapter_factors(bank, seed=i + 1,
                                                 scale=0.05))
    prompts = [[(7 * i + j) % 500 + 3 for j in range(n)]
               for i, n in enumerate((5, 40, 17, 90))]
    params = [SamplingParams(max_new_tokens=12, eos_token_id=-1)] * 3 + [
        SamplingParams(max_new_tokens=12, eos_token_id=-1,
                       strategy=SAMPLING, temperature=0.8, seed=4)]
    ids = [None, 'ad0', 'ad1', 'ad0']
    runs = []
    for graph in (True, False):
        eng = InferenceEngine(model, num_slots=4, max_length=256,
                              decode_block=4, kv_page_size=16,
                              adapter_bank=bank, **opts)
        eng._capture_decode = eng._capture_prefill = graph
        K.reset_launch_counts()
        runs.append([h.tokens for h in eng.generate_many(
            prompts, params, adapter_ids=ids)])
        assert K.LAUNCHES['rms_norm_fp16'] > 0
        assert K.LAUNCHES['paged_attention' + ('_int8' if opts else '')
                          + '_fp16'] > 0
        assert K.LAUNCHES['adapter_matmul_fp16'] > 0
        assert K.LAUNCHES['flash_attention_fwd_fp16'] > 0
        for k in ('rms_norm', 'paged_attention', 'adapter_matmul',
                  'flash_attention_fwd'):
            assert K.LAUNCHES[k] == 0, k
    assert runs[0] == runs[1]
    bank.detach()


def _dygraph_losses(model, batches, opt_cls, amp=None, scaler=None):
    """The canonical eager loop on port Tensors; the step losses."""
    import paddle_tpu_torch as ptt
    opt = opt_cls(learning_rate=1e-3, parameters=model.parameters())
    place = 'cpu' if model.device.type == 'cpu' else 'gpu'
    losses = []
    for ids in batches:
        x = ptt.to_tensor(ids, place=place)
        with (ptt.amp.auto_cast(**amp) if amp else _null()):
            loss, _ = model(x, labels=x)
        if scaler is not None:
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
        else:
            loss.backward()
            opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def _null():
    import contextlib
    return contextlib.nullcontext()


def test_dygraph_step_on_card_matches_cpu(cuda):
    """Three eager f32 steps (to_tensor, model(x, labels=x), backward,
    AdamW step, clear_grad) of 2 layers on the card and on the CPU:
    losses agree to 1e-4, and the card's ran the kernels."""
    import numpy as np
    from paddle_tpu_torch.optimizer import AdamW
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1)
    on_card = LlamaForCausalLM(cfg, device=cuda, generator=generator(5, cuda))
    on_cpu = LlamaForCausalLM(cfg, device='cpu')
    on_cpu.load_state_dict({k: v.cpu() for k, v in
                            on_card.state_dict().items()})
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, 512, (2, 96)) for _ in range(3)]
    K.reset_launch_counts()
    card = _dygraph_losses(on_card, batches, AdamW)
    assert K.LAUNCHES['flash_attention_bwd_dkv'] == 2 * 3
    cpu = _dygraph_losses(on_cpu, batches, AdamW)
    torch.testing.assert_close(torch.tensor(card), torch.tensor(cpu),
                               rtol=1e-4, atol=0)


def test_amp_fp16_step_runs_the_fp16_kernels(cuda):
    """O1 fp16 under GradScaler: finite losses, the fp16 flash kernels
    launched once per layer and step (forward, dq, dk/dv), the bf16/f32
    ones not at all, RMSNorm and CE in fp32."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.optimizer import AdamW
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1)
    model = LlamaForCausalLM(cfg, device=cuda, generator=generator(6, cuda))
    rng = np.random.RandomState(1)
    batches = [rng.randint(0, 512, (2, 96)) for _ in range(3)]
    K.reset_launch_counts()
    scaler = ptt.amp.GradScaler(init_loss_scaling=2.0 ** 12)
    losses = _dygraph_losses(model, batches, AdamW,
                             amp=dict(dtype='float16'), scaler=scaler)
    assert all(np.isfinite(losses))
    assert K.LAUNCHES['flash_attention_fwd_fp16'] == 2 * 3
    assert K.LAUNCHES['flash_attention_bwd_dq_fp16'] == 2 * 3
    assert K.LAUNCHES['flash_attention_bwd_dkv_fp16'] == 2 * 3
    assert K.LAUNCHES['flash_attention_fwd'] == 0
    assert K.LAUNCHES['rms_norm'] > 0 and K.LAUNCHES['softmax_ce_fwd'] == 3


# ---------------------------------------------------------------------------
# head_dim 64: the flash forward, dq and dk/dv and the paged kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize('sq,sk,hkv,causal', [
    (130, 130, 12, True), (1000, 1000, 4, True), (70, 90, 3, True),
    (512, 512, 12, False), (1, 130, 1, True)])
def test_d64_flash_kernels_match_plain(cuda, dtype, sq, sk, hkv, causal):
    """The D = 64 instantiations (f32 FMA, bf16 and fp16 wgmma): the
    forward with its LSE, dq and dk/dv against the plain versions at
    ragged, GQA and sq < sk shapes; launches count under the `_d64` keys
    only."""
    g = torch.Generator(device=cuda).manual_seed(sq + sk + hkv)
    q, dout = _randn(g, dtype, 2, sq, 12, 64), _randn(g, dtype, 2, sq, 12, 64)
    k, v = _randn(g, dtype, 2, sk, hkv, 64), _randn(g, dtype, 2, sk, hkv, 64)
    before = dict(K.LAUNCHES)
    out, lse = K.flash_attention_fwd(q, k, v, causal, return_lse=True)
    want, want_lse = K.attention_reference(q, k, v, causal=causal,
                                           return_lse=True)
    close = _close_f16 if dtype == torch.float16 else (
        lambda a, b: _close_attention(a, b, dtype))
    close(out, want)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    got = K.flash_attention_bwd(q, k, v, out, lse, dout, causal)
    for i, (a, b) in enumerate(zip(got, K.attention_bwd_reference(
            q, k, v, out, lse, dout, causal))):
        if sk > 1 or i == 2:
            close(a, b)
    key = '_fp16' if dtype == torch.float16 else ''
    for name in ('flash_attention_fwd', 'flash_attention_bwd_dq',
                 'flash_attention_bwd_dkv'):
        assert K.LAUNCHES[name + key] == before[name + key]
        assert K.LAUNCHES[name + key + '_d64'] == \
            before[name + key + '_d64'] + 1


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('hkv,t', [(12, 1), (4, 1), (12, 5), (3, 3)])
def test_d64_paged_kernel_matches_plain(cuda, dtype, hkv, t):
    """The D = 64 paged split and combine over float pages: one query row
    (decode) and T rows (a verify), GQA, ragged lengths, a null-page
    slot; launches under `paged_attention(_verify)_d64`."""
    g = torch.Generator(device=cuda).manual_seed(hkv * 10 + t)
    n, h, ps, p = 5, 12, 16, 8
    pages = n * p + 1
    table = (torch.randperm(pages - 1, generator=g, device=cuda)[:n * p]
             + 1).to(torch.int32).reshape(n, p).contiguous()
    table[3] = 0
    lengths = torch.tensor([1, 17, 100, 64, 128 - t], dtype=torch.int32,
                           device=cuda)
    q = _randn(g, dtype, n, h, 64) if t == 1 else _randn(g, dtype, n, t, h,
                                                         64)
    kp, vp = (_randn(g, dtype, pages, ps, hkv, 64) for _ in range(2))
    key = ('paged_attention_verify' if t > 1 else 'paged_attention') + '_d64'
    before = K.LAUNCHES[key]
    got = K.paged_attention(q, kp, vp, table, lengths)
    want = K.paged_attention_reference(q, kp, vp, table, lengths)
    live = torch.ones(n, dtype=torch.bool, device=cuda)
    live[3] = False
    _close_attention(got[live], want[live], dtype)
    assert K.LAUNCHES[key] == before + 1


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('hkv,t,w', [(12, 1, 0), (4, 1, 2), (12, 1, 2),
                                     (12, 5, 2), (3, 3, 1), (4, 5, 0)])
def test_d64_int8_paged_kernel_matches_plain(cuda, dtype, hkv, t, w):
    """The D = 64 int8 split kernel (its 64-byte tile rows) and, with the
    decode round's float window, the D = 64 window kernel: one query row
    and T rows, GQA, the window's first row at offsets 0, 9 and 15 of a
    page, a length-1 slot, a window past the table's end, an inactive
    slot on the null page; the window holds other values than the int8
    pages it stands for. Launches under `paged_attention(_verify)
    _int8_d64`."""
    g = torch.Generator(device=cuda).manual_seed(hkv * 100 + t * 10 + w)
    n, h, p, ps = len(_WINDOW_SLOTS), 12, 10, 16
    num_pages = n * p + 1
    q = _randn(g, dtype, n, h, 64) if t == 1 else _randn(g, dtype, n, t, h,
                                                         64)
    shape = (num_pages, ps, hkv, 64)
    kp, vp = (torch.randint(-127, 128, shape, generator=g, device=cuda,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((num_pages, hkv), generator=g, device=cuda) / 127
              + 1e-3 for _ in range(2))
    table = (torch.randperm(num_pages - 1, generator=g, device=cuda)[:n * p]
             + 1).to(torch.int32).reshape(n, p)
    table[-1] = 0
    lens = torch.tensor([ln for ln, _ in _WINDOW_SLOTS], device=cuda,
                        dtype=torch.int32)
    kw_args = dict(k_scales=ks, v_scales=vs)
    if w:
        kw_args.update(
            k_win=_randn(g, dtype, n, w, ps, hkv, 64),
            v_win=_randn(g, dtype, n, w, ps, hkv, 64),
            win_first=torch.tensor([f for _, f in _WINDOW_SLOTS],
                                   device=cuda, dtype=torch.int32))
    key = ('paged_attention_verify' if t > 1 else 'paged_attention') + \
        '_int8_d64'
    before = dict(K.LAUNCHES)
    got = K.paged_attention(q, kp, vp, table, lens, **kw_args)
    assert K.LAUNCHES[key] == before[key] + 1
    assert all(K.LAUNCHES[k] == before[k] for k in K.LAUNCHES if k != key)
    _close_attention(got, K.paged_attention_reference(
        q, kp, vp, table, lens, **kw_args), dtype)


def test_d64_int8_pages_and_other_widths_raise(cuda):
    """Int8 pages take head_dim 64 and 128, as float pages do: at another
    width the paged wrapper raises, and a head_dim outside {64, 128}
    raises in every attention wrapper."""
    n = 2
    table = torch.ones((n, 1), dtype=torch.int32, device=cuda)
    lengths = torch.ones(n, dtype=torch.int32, device=cuda)
    q = torch.zeros((n, 4, 80), device=cuda)
    pages = torch.zeros((2, 16, 4, 80), dtype=torch.int8, device=cuda)
    sc = torch.ones((2, 4), device=cuda)
    with pytest.raises(ValueError, match='head_dim'):
        K.paged_attention(q, pages, pages, table, lengths, k_scales=sc,
                          v_scales=sc)
    x = torch.zeros((1, 8, 2, 80), device=cuda)
    with pytest.raises(ValueError, match='head_dim'):
        K.flash_attention_fwd(x, x, x)
    with pytest.raises(ValueError, match='head_dim'):
        K.paged_attention(x[:, 0], torch.zeros((2, 16, 2, 80), device=cuda),
                          torch.zeros((2, 16, 2, 80), device=cuda),
                          table[:1], lengths[:1])


def test_gpt2_width_engine_on_card_matches_cpu(cuda):
    """A 2-layer GPT of GPT-2 small's width (12 heads x 64) in f32: the
    graph engine on the card (the D = 64 flash and paged kernels) gives
    the CPU engine's greedy tokens."""
    from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(hidden_size=768, num_attention_heads=12,
                    num_hidden_layers=2, vocab_size=512,
                    max_position_embeddings=256)
    on_card = GPTForCausalLM(cfg, device=cuda, generator=generator(3, cuda))
    on_cpu = GPTForCausalLM(cfg, device='cpu')
    on_cpu.load_state_dict({k: v.cpu() for k, v in
                            on_card.state_dict().items()})
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, 512, (s,), generator=g).tolist()
               for s in (3, 17, 40, 9)]
    sp = SamplingParams(max_new_tokens=12, eos_token_id=-1)
    K.reset_launch_counts()
    card = InferenceEngine(on_card, num_slots=3, max_length=128,
                           decode_block=4,
                           kv_page_size=16).generate_many(prompts, sp)
    assert K.LAUNCHES['flash_attention_fwd_d64'] > 0
    assert K.LAUNCHES['paged_attention_d64'] > 0
    cpu = InferenceEngine(on_cpu, num_slots=3, max_length=128,
                          decode_block=4,
                          kv_page_size=16).generate_many(prompts, sp)
    assert [h.tokens for h in card] == [h.tokens for h in cpu]


# ---------------------------------------------------------------------------
# T5: the cross-attention's flash shapes, the model card == CPU, jit export
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('sq', [1, 100, 128, 200])
def test_t5_cross_attention_flash_kernels_match_plain(cuda, dtype, sq):
    """T5's cross-attention: D = 64, non-causal, Sq queries over Sk = 512
    keys (Sq = 100 and 200 end in a partial query tile; the dk/dv kernel
    visits every query tile of each key tile): the forward with its LSE,
    dq and dk/dv against their plain versions, under the `_d64` keys."""
    g = torch.Generator(device=cuda).manual_seed(sq)
    q, dout = _randn(g, dtype, 2, sq, 4, 64), _randn(g, dtype, 2, sq, 4, 64)
    k, v = _randn(g, dtype, 2, 512, 4, 64), _randn(g, dtype, 2, 512, 4, 64)
    before = dict(K.LAUNCHES)
    out, lse = K.flash_attention_fwd(q, k, v, False, return_lse=True)
    assert _launched('flash_attention_fwd_d64', before) == 1
    want, want_lse = K.attention_reference(q, k, v, return_lse=True)
    _close_attention(out, want, dtype)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    dq, delta = K.flash_attention_bwd_dq(q, k, v, out, lse, dout)
    dk, dv = K.flash_attention_bwd_dkv(q, k, v, lse, delta, dout)
    wdq, wdk, wdv = K.attention_bwd_reference(q, k, v, out, lse, dout)
    for got, w in ((dq, wdq), (dk, wdk), (dv, wdv)):
        _close_attention(got, w, dtype)


def _t5_pair(cuda, **kw):
    from paddle_tpu_torch.nlp import T5Config, T5ForConditionalGeneration
    cfg = T5Config.tiny(d_kv=64, vocab_size=512, **kw)
    card = T5ForConditionalGeneration(cfg, device=cuda,
                                      generator=generator(3, cuda)).eval()
    cpu = T5ForConditionalGeneration(cfg, device='cpu').eval()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    return card, cpu


@pytest.mark.parametrize('kw', [{}, {'feed_forward_proj': 'gated-gelu',
                                     'tie_word_embeddings': False}])
def test_t5_card_equals_cpu(cuda, kw):
    """A tiny T5 at d_kv 64 (f32): logits padded and unmasked (the flash
    cross-attention) and the loss with -100 labels equal the CPU's to
    1e-4; greedy and 2-beam tokens are the CPU's."""
    card, cpu = _t5_pair(cuda, **kw)
    g = torch.Generator().manual_seed(5)
    ids = torch.randint(2, 512, (2, 40), generator=g)
    mask = torch.ones_like(ids)
    mask[0, 30:] = 0
    dec = torch.randint(2, 512, (2, 9), generator=g)
    labels = dec.clone()
    labels[1, -2:] = -100
    with torch.no_grad():
        for m in (mask, None):
            got = card(input_ids=ids.to(cuda), decoder_input_ids=dec.to(cuda),
                       attention_mask=None if m is None else m.to(cuda))
            want = cpu(input_ids=ids, decoder_input_ids=dec, attention_mask=m)
            _close(got.cpu(), want, torch.float32)
        loss, _ = card(input_ids=ids.to(cuda), labels=labels.to(cuda))
        want, _ = cpu(input_ids=ids, labels=labels)
        _close(loss.cpu(), want, torch.float32)
    for strat in ({}, {'decode_strategy': 'beam_search', 'num_beams': 2}):
        got, _ = card.generate(ids.to(cuda), max_new_tokens=8,
                               attention_mask=mask.to(cuda), eos_token_id=-1,
                               **strat)
        want, _ = cpu.generate(ids, max_new_tokens=8, attention_mask=mask,
                               eos_token_id=-1, **strat)
        assert torch.equal(got.cpu(), want)


def test_t5_training_step_launches_the_kernels(cuda):
    """One backward of a tiny T5 (d_kv 64, recompute) without an encoder
    mask: exactly 2 RMSNorms per encoder block and 3 per decoder block
    plus 2, twice over for the blocks (the recompute), the D = 64 flash
    forward twice per decoder block, dq and dk/dv once, CE once each
    way; the gradients equal the CPU's."""
    card, cpu = _t5_pair(cuda, use_recompute=True)
    card.train()
    cpu.train()
    g = torch.Generator().manual_seed(6)
    ids = torch.randint(2, 512, (2, 40), generator=g)
    labels = torch.randint(2, 512, (2, 12), generator=g)
    K.reset_launch_counts()
    loss, _ = card(input_ids=ids.to(cuda), labels=labels.to(cuda))
    loss.backward()
    torch.cuda.synchronize()
    cfg = card.config
    enc, dec = cfg.num_layers, cfg.num_decoder_layers
    assert {k: n for k, n in K.LAUNCHES.items() if n} == {
        'rms_norm': 2 * (2 * enc + 3 * dec) + 2,
        'flash_attention_fwd_d64': 2 * dec,
        'flash_attention_bwd_dq_d64': dec, 'flash_attention_bwd_dkv_d64': dec,
        'softmax_ce_fwd': 1, 'softmax_ce_bwd': 1}
    want, _ = cpu(input_ids=ids, labels=labels)
    want.backward()
    _close(loss.detach().cpu(), want.detach(), torch.float32)
    grads = dict(cpu.named_parameters())
    for name, p in card.named_parameters():
        _close(p.grad.cpu(), grads[name].grad, torch.float32)


def test_jit_exported_t5_launches_the_kernels(cuda, tmp_path):
    """A T5Model (bf16, d_kv 64) saved with a dynamic batch and loaded
    without its class equals the eager forward bit for bit on the card,
    and its run launches the RMSNorm and D = 64 flash kernels."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.nlp import T5Config, T5Model
    cfg = T5Config.tiny(d_kv=64, vocab_size=512)
    model = T5Model(cfg, device=cuda, dtype='bfloat16',
                    generator=generator(7, cuda)).eval()
    path = str(tmp_path / 't5')
    jit.save(model, path, input_spec=[jit.InputSpec([None, 16], 'int64'),
                                      jit.InputSpec([None, 6], 'int64')])
    loaded = jit.load(path)
    ids = torch.randint(2, 512, (3, 16), device=cuda)
    dec = torch.randint(2, 512, (3, 6), device=cuda)
    K.reset_launch_counts()
    got = loaded(ids, dec)
    torch.cuda.synchronize()
    assert K.LAUNCHES['rms_norm'] == 2 * 2 + 3 * 2 + 2
    assert K.LAUNCHES['flash_attention_fwd_d64'] == 2
    with torch.no_grad():
        want = model(ids, dec)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# the RMSNorm kernel's second design, CE at 1000 classes, ResNet-50
# ---------------------------------------------------------------------------

RMS_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -6, 2 ** -7),
           torch.float16: (2 ** -9, 2 ** -10)}


def _rel_limits(got, want, dtype):
    """chip_smoke's kernel limits: max|got - want| / max|want| and the
    same in norms, by the output's dtype."""
    diff, want = got.double() - want.double(), want.double()
    lim_max, lim_norm = RMS_TOL[dtype]
    assert diff.abs().max() <= lim_max * want.abs().max()
    assert diff.norm() <= lim_norm * want.norm()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize('rows,width', [(8, 4096), (1024, 4096),
                                        (2048, 4096), (4096, 4096),
                                        (8192, 2048), (4096, 1024),
                                        (3, 4100), (300, 1000),
                                        (2, 40000), (2, 140000),
                                        (300, 4100), (2, 9001),
                                        (300, 16384), (300, 24576)])
def test_rms_kernel_at_every_shape(cuda, dtype, rows, width):
    """The second RMSNorm design against its plain version at the shapes
    it is measured at, widths that are not a multiple of the vector (the
    one-element accesses, two passes over the row: 4100 and 9001), more rows than the grid holds at once, and rows
    too wide to live in registers (16384 in f32, 24576, 40000 and 140000:
    the two-pass form); one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(rows + width)
    x = _randn(g, dtype, rows, width)
    w = (1 + 0.1 * _randn(g, torch.float32, width)).to(dtype)
    key = 'rms_norm_fp16' if dtype == torch.float16 else 'rms_norm'
    before = K.LAUNCHES[key]
    _rel_limits(K.rms_norm(x, w), K.rms_norm_reference(x, w), dtype)
    assert K.LAUNCHES[key] == before + 1


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_rms_kernel_on_an_unaligned_view(cuda, dtype):
    """x a view one element past a 16-byte-aligned buffer (contiguous, so
    the wrapper takes it): the one-element accesses, within the limits
    of the plain version (the 16-byte path on an aligned copy sums the
    squares in another order, so f32 outputs need not be bit-equal)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    buf = _randn(g, dtype, 64 * 4096 + 1)
    x = buf[1:].view(64, 4096)
    w = (1 + 0.1 * _randn(g, torch.float32, 4096)).to(dtype)
    assert x.data_ptr() % 16 and not K.rms_norm_vector_ok(
        x, w, torch.empty_like(x))
    _rel_limits(K.rms_norm(x, w), K.rms_norm_reference(x, w), dtype)


@pytest.mark.parametrize('rows', [8, 1024])
def test_rms_kernel_in_a_cuda_graph(cuda, rows):
    """The RMSNorm launch captured in a CUDA graph (its occupancy and SM
    count read before the capture by a warm-up call) and replayed on new
    inputs copied into the captured buffer: each replay equals an eager
    call."""
    g = torch.Generator(device=cuda).manual_seed(rows)
    x = _randn(g, torch.bfloat16, rows, 4096)
    w = (1 + 0.1 * _randn(g, torch.float32, 4096)).to(torch.bfloat16)
    K.rms_norm(x, w)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K.rms_norm(x, w)
    for seed in (1, 2):
        x.copy_(_randn(torch.Generator(device=cuda).manual_seed(seed),
                       torch.bfloat16, rows, 4096))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, K.rms_norm(x.clone(), w))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n', [64, 256])
def test_ce_kernels_at_1000_classes(cuda, dtype, n):
    """CE forward and backward at a classifier's [N, 1000], with ignored
    rows and at a mean loss's g = 1 / N on every row."""
    g = torch.Generator(device=cuda).manual_seed(n)
    x = (3 * _randn(g, torch.float32, n, 1000)).to(dtype)
    lab = torch.randint(0, 1000, (n,), generator=g, device=cuda,
                        dtype=torch.int32)
    ignored = torch.randn(n, generator=g, device=cuda)
    ignored[::7] = 0.0
    for up in (ignored, torch.full((n,), 1.0 / n, device=cuda)):
        nll, lse = K.softmax_cross_entropy_fwd(x, lab)
        want_nll, want_lse = K.softmax_cross_entropy_fwd_reference(x, lab)
        torch.testing.assert_close(nll, want_nll, atol=1e-4, rtol=1e-5)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
        _close(K.softmax_cross_entropy_bwd(x, lab, lse, up),
               K.softmax_cross_entropy_bwd_reference(x, lab, lse, up), dtype)


def test_resnet50_f32_on_the_card_equals_the_cpu(cuda):
    """resnet50 at full width, batch 2, TF32 off: the eval forward's
    logits card == CPU to 1e-4 by relative norm; in train mode the loss
    to 1e-5, and the gradients of the classifier and the last convolution
    held to a float64 CPU run within 4 x the CPU's own f32 distance from
    it (at least 1e-4): f32 BatchNorm gradients at init carry errors far
    above 1e-4 on any device (chip_smoke.vision_f32_step)."""
    import copy

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import vision
    ptt.seed(7)
    cpu = vision.resnet50(device='cpu')
    card = copy.deepcopy(cpu).to(cuda)
    exact = copy.deepcopy(cpu).double()
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 3, 224, 224, generator=g)
    y = torch.randint(0, 1000, (2,), generator=g)

    def rel(a, b):
        return float((a.cpu().double() - b.double()).norm()
                     / b.double().norm())
    cpu.eval()
    card.eval()
    with torch.no_grad():
        assert rel(card(x.to(cuda)), cpu(x)) <= 1e-4
    losses = []
    for model, dev, dt in ((cpu, 'cpu', torch.float32),
                           (card, cuda, torch.float32),
                           (exact, 'cpu', torch.float64)):
        model.train()
        loss = F.cross_entropy(model(x.to(dev, dt)), y.to(dev))
        loss.backward()
        losses.append(float(loss.detach()))
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])
    for name in ('fc.weight', 'layer4.2.conv3.weight'):
        grads = [dict(m.named_parameters())[name].grad
                 for m in (cpu, card, exact)]
        assert rel(grads[1], grads[2]) <= max(1e-4,
                                              4 * rel(grads[0], grads[2]))


# ---------------------------------------------------------------------------
# the row engine (InferenceEngine's default layout) and sharded checkpoints
# ---------------------------------------------------------------------------

def _row_case(cuda, seed=41):
    model = LlamaForCausalLM(_graph_cfg(), device=cuda, dtype='bfloat16',
                             generator=generator(seed, cuda))
    g = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(1, 512, (n,), generator=g).tolist()
               for n in (5, 70, 17, 33, 9, 120)]
    from paddle_tpu_torch.serving import SAMPLING
    params = [SamplingParams(max_new_tokens=12, eos_token_id=-1)] * 5 + [
        SamplingParams(max_new_tokens=12, eos_token_id=-1,
                       strategy=SAMPLING, temperature=0.8, seed=4)]
    return model, prompts, params


@pytest.mark.parametrize('capture', [True, False])
def test_row_engine_on_the_card_equals_the_paged_engine(cuda, capture):
    """bf16: the row engine (no layout argument) and the paged engine over
    the same model give every request, a sampled one included, the same
    tokens, through the same flash, RMSNorm and paged kernels; captured,
    the row engine shows the JAX row engine's trace names once each."""
    model, prompts, params = _row_case(cuda)
    out = []
    for kw in ({}, {'kv_page_size': 16}):
        eng = InferenceEngine(model, num_slots=4, max_length=256,
                              decode_block=4, **kw)
        eng._capture_decode = eng._capture_prefill = capture
        K.reset_launch_counts()
        out.append([h.tokens for h in eng.generate_many(prompts, params)])
        assert all(K.LAUNCHES[k] > 0 for k in (
            'flash_attention_fwd', 'paged_attention', 'rms_norm'))
        if not kw:
            st = eng.stats()
            assert st['kv_layout'] == 'row' and st['pool']['free'] == 4
            want = _traces(eng) if capture else {}
            assert st['traces'] == want
            assert all(k == 'decode_step' or k.startswith('prefill_')
                       for k in st['traces'])
    assert out[0] == out[1]


def test_row_prefix_cache_on_the_card_equals_the_same_chunks(cuda):
    """bf16: a 64-token system prompt (two 32-token chunks) behind
    suffixes, hit three times, and an exact repeat (a full hit, one row
    copy), through the captured row engine with the prefix cache and
    32-token chunks: the tokens of a row engine with the same chunks and
    no cache (every row computed through the same chunks), so a retained
    row was never written."""
    model, _, _ = _row_case(cuda, seed=43)
    g = torch.Generator().manual_seed(44)
    rand = lambda n: torch.randint(1, 512, (n,), generator=g).tolist()
    system = rand(64)
    waves = [[system + rand(20)]] + [
        [system + rand(n) for n in (3, 40, 9)] for _ in range(3)]
    repeat = system + rand(30)
    waves += [[repeat], [repeat]]     # retained, then a full hit
    sp = SamplingParams(max_new_tokens=10, eos_token_id=-1)
    out = []
    for kw in (dict(prefix_cache=0.5, prefill_chunk_tokens=32),
               dict(prefill_chunk_tokens=32)):
        eng = InferenceEngine(model, num_slots=4, max_length=256,
                              decode_block=4, **kw)
        out.append([[h.tokens for h in eng.generate_many(w, sp)]
                    for w in waves])
        if 'prefix_cache' in kw:
            st = eng.stats()
            assert st['prefix_cache']['hits'] >= 9
            assert st['pool']['row_copies'] == 1
            assert st['traces'] == _traces(eng)
            eng.prefix_cache.clear(force=True)
            assert eng.pool.free_count == 4
    assert out[0] == out[1]


def test_row_end_beside_a_live_neighbour_on_the_card(cuda):
    """A request that runs to the last row of its slot (the last round
    runs past it) beside a neighbour in the next row: the neighbour's
    tokens equal its tokens alone."""
    model, _, _ = _row_case(cuda, seed=45)
    g = torch.Generator().manual_seed(46)
    first, second = (torch.randint(1, 512, (n,), generator=g).tolist()
                     for n in (40, 7))
    kw = dict(num_slots=2, max_length=64, decode_block=5)
    eng = InferenceEngine(model, **kw)
    hs = eng.generate_many([first, second], [
        SamplingParams(max_new_tokens=24, eos_token_id=-1),
        SamplingParams(max_new_tokens=40, eos_token_id=-1)])
    alone = InferenceEngine(model, **kw).generate_many(
        [second], SamplingParams(max_new_tokens=40, eos_token_id=-1))
    assert len(hs[0].tokens) == 24 and hs[1].tokens == alone[0].tokens


def test_sharded_checkpoint_loads_onto_the_card_bit_equal(cuda, tmp_path):
    from paddle_tpu_torch import serialization as ser
    g = torch.Generator(device=cuda).manual_seed(3)
    state = {'w': torch.randn(300, 257, device=cuda, generator=g)
             .bfloat16(),
             'b': torch.randn(257, device=cuda, generator=g),
             'i': torch.arange(11, device=cuda)}
    ser.save_sharded(state, str(tmp_path / 'd'), n_shards=2)
    back = ser.load_sharded(str(tmp_path / 'd'), device=cuda)
    for k, v in state.items():
        assert back[k].device.type == 'cuda' and back[k].dtype == v.dtype
        assert torch.equal(back[k], v), k


# ---------------------------------------------------------------------------
# the KV pool's dtype, and the public API packages on the card
# ---------------------------------------------------------------------------

def _first_step_logits(eng, prompts):
    import chip_smoke
    return chip_smoke.first_step_logits(eng, prompts)


@pytest.mark.parametrize('paged', [True, False], ids=['paged', 'row'])
def test_bf16_model_over_an_f32_pool_on_the_card(cuda, paged):
    """A bf16 Llama served from an f32 pool (`dtype='float32'`, the JAX
    engine's default pool): captured == eager (tokens and launches), the
    decode through the (bf16 q, f32 pages) kernel alone; its tokens and
    first decode step's logits equal the bf16 pool's bit for bit (the
    pool holds the bf16 rows exactly, and the f32 tiles keep the 16-bit
    column order, so every sum runs in the bf16 kernel's order)."""
    model = LlamaForCausalLM(_graph_cfg(), device=cuda, dtype='bfloat16',
                             generator=generator(21, cuda))
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(1, 512, (s,), generator=g).tolist()
               for s in (3, 17, 40, 9, 25)]
    kw = dict(num_slots=3, max_length=128, decode_block=4,
              **({'kv_page_size': 16} if paged else {}))
    params = SamplingParams(max_new_tokens=12, eos_token_id=-1)
    runs = {}
    for capture in (True, False):
        eng = InferenceEngine(model, dtype='float32', **kw)
        assert eng.pool.pages[0][0].dtype == torch.float32
        eng._capture_decode = eng._capture_prefill = capture
        eng.generate_many(prompts, SamplingParams(max_new_tokens=1,
                                                  eos_token_id=-1))
        K.reset_launch_counts()
        runs[capture] = ([h.tokens for h in eng.generate_many(prompts,
                                                              params)],
                         {k: n for k, n in K.LAUNCHES.items() if n})
    assert runs[True] == runs[False]
    launches = runs[True][1]
    assert launches.get('paged_attention_bf16_kvf32', 0) > 0
    assert 'paged_attention' not in launches
    own = InferenceEngine(model, **kw)
    assert [h.tokens for h in own.generate_many(prompts, params)] == \
        runs[True][0]
    wide = _first_step_logits(InferenceEngine(model, dtype='float32', **kw),
                              prompts[:3])
    assert torch.equal(wide, _first_step_logits(InferenceEngine(model, **kw),
                                                prompts[:3]))


def test_fused_entries_launch_the_kernels(cuda):
    """incubate's fused_rms_norm is the RMSNorm kernel, and
    fused_multi_head_attention the flash forward and, under a gradient,
    the dq and dk/dv kernels (bf16, head_dim 128): equal to the same
    calls on the CPU."""
    from paddle_tpu_torch.incubate.nn import functional as IF
    g = torch.Generator(device=cuda).manual_seed(3)
    x = _randn(g, torch.bfloat16, 4, 64, 256)
    w = _randn(g, torch.bfloat16, 256)
    before = dict(K.LAUNCHES)
    got = IF.fused_rms_norm(x, w, epsilon=1e-6)
    assert K.LAUNCHES['rms_norm'] == before['rms_norm'] + 1
    _close(got.cpu(), IF.fused_rms_norm(x.cpu(), w.cpu(), epsilon=1e-6),
           torch.bfloat16)
    qkv_w = (_randn(g, torch.float32, 3, 2, 128, 256) * 0.05).bfloat16()
    lin_w = (_randn(g, torch.float32, 256, 256) * 0.05).bfloat16()
    xs = x.detach().requires_grad_(True)
    before = dict(K.LAUNCHES)
    out = IF.fused_multi_head_attention(xs, qkv_w, lin_w, pre_layer_norm=True)
    out.float().square().sum().backward()
    for key in ('flash_attention_fwd', 'flash_attention_bwd_dq',
                'flash_attention_bwd_dkv'):
        assert K.LAUNCHES[key] == before[key] + 1, key
    xc = x.cpu().detach().requires_grad_(True)
    ref = IF.fused_multi_head_attention(xc, qkv_w.cpu(), lin_w.cpu(),
                                        pre_layer_norm=True)
    ref.float().square().sum().backward()
    _close(out.cpu(), ref, torch.bfloat16)
    rel = (xs.grad.float().cpu() - xc.grad.float()).norm() / \
        xc.grad.float().norm()
    assert rel <= REL_BF16[1] * 4


def test_static_program_replay_launches_the_kernels(cuda):
    """A static program (fc -> F.rms_norm -> causal attention, bf16 at
    head_dim 128) replayed by the Executor: equal to the eager calls on
    the same feed bit for bit, and each replay launches the RMSNorm and
    flash forward kernels once."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import static
    ptt.set_device('gpu')
    ptt.seed(4)
    ptt.enable_static()
    try:
        main = static.Program()
        with static.program_guard(main):
            x = static.data('x', [None, 64, 256], 'bfloat16')
            lin = ptt.nn.Linear(256, 256, dtype='bfloat16')
            gamma = ptt.ones([256], dtype='bfloat16')
            h = F.rms_norm(lin(x), gamma)
            q = ptt.reshape(h, [-1, 64, 2, 128])
            y = F.scaled_dot_product_attention(q, q, q, is_causal=True)
        feed = np.random.default_rng(0).standard_normal(
            (3, 64, 256)).astype(np.float32)
        exe = static.Executor()
        before = dict(K.LAUNCHES)
        out, = exe.run(main, feed={'x': feed}, fetch_list=[y],
                       return_numpy=False)
        assert K.LAUNCHES['rms_norm'] == before['rms_norm'] + 1
        assert K.LAUNCHES['flash_attention_fwd'] == \
            before['flash_attention_fwd'] + 1
    finally:
        ptt.disable_static()
    xe = ptt.to_tensor(feed).astype('bfloat16')
    he = F.rms_norm(lin(xe), gamma)
    want = F.scaled_dot_product_attention(
        ptt.reshape(he, [-1, 64, 2, 128]), ptt.reshape(he, [-1, 64, 2, 128]),
        ptt.reshape(he, [-1, 64, 2, 128]), is_causal=True)
    assert torch.equal(out.value, want.value)


def test_profiler_trace_names_the_kernels(cuda, tmp_path):
    """Profiler(trace_dir=) on the card: its Chrome trace holds the
    launched kernels (RMSNorm and the flash forward) and the host
    region around them."""
    import json
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.incubate.nn import functional as IF
    g = torch.Generator(device=cuda).manual_seed(6)
    x = _randn(g, torch.bfloat16, 8, 4096)
    w = _randn(g, torch.bfloat16, 4096)
    q = _randn(g, torch.bfloat16, 2, 256, 8, 128)
    IF.fused_rms_norm(x, w)
    F.scaled_dot_product_attention(q, q, q, is_causal=True)
    torch.cuda.synchronize()
    with profiler.Profiler(trace_dir=str(tmp_path)) as prof:
        with profiler.RecordEvent('api_region'):
            IF.fused_rms_norm(x, w)
            F.scaled_dot_product_attention(q, q, q, is_causal=True)
            torch.cuda.synchronize()
    names = ' '.join(e.get('name', '') for e in json.loads(
        open(prof.trace_path).read())['traceEvents'])
    assert 'api_region' in names
    assert 'rms_norm_kernel' in names and 'flash_fwd_wgmma_kernel' in names


# -- the long tail: geometric, audio, text, distribution ----------------------

def test_geometric_int_buckets_on_the_card(cuda):
    """The int32 min/max reproducer on the card: a live bucket at
    INT32_MAX stays, the empty bucket is 0 (found by an edge count)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import geometric
    lim = torch.iinfo(torch.int32)
    x = torch.tensor([[lim.max], [5], [-3]], dtype=torch.int32, device=cuda)
    src = torch.tensor([0, 1, 2], dtype=torch.int32, device=cuda)
    dst = torch.tensor([0, 1, 1], dtype=torch.int32, device=cuda)
    for op, live in (('min', [lim.max, -3]), ('max', [lim.max, 5])):
        out = geometric.send_u_recv(ptt.Tensor(x), ptt.Tensor(src),
                                    ptt.Tensor(dst), op, out_size=3)
        assert out.value.device.type == 'cuda'
        assert out.value.cpu().ravel().tolist() == live + [0]


def test_audio_features_on_the_card_equal_the_cpu(cuda):
    """LogMelSpectrogram and MFCC over four 1 s clips: the mel power
    within rel norm 1e-5 of the CPU's, log-mel within 1e-3 dB."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.audio import features
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 16000, generator=g)
    kw = dict(sr=16000, n_fft=512, hop_length=160, n_mels=64)
    card = features.LogMelSpectrogram(**kw)
    with ptt.device_guard('cpu'):
        cpu = features.LogMelSpectrogram(**kw)
        cpu_mfcc = features.MFCC(n_mfcc=20, **kw)
    mfcc = features.MFCC(n_mfcc=20, **kw)
    assert card._melspectrogram.fbank_matrix.is_cuda
    with torch.no_grad():
        mel = card._melspectrogram(x.to(cuda)).cpu().double()
        mel_c = cpu._melspectrogram(x).double()
        assert float((mel - mel_c).norm() / mel_c.norm()) <= 1e-5
        assert float((card(x.to(cuda)).cpu() - cpu(x)).abs().max()) <= 1e-3
        # the orthonormal DCT: at most 1e-3 dB times sqrt(64 mels)
        assert float((mfcc(x.to(cuda)).cpu() - cpu_mfcc(x)).abs().max()) \
            <= 1e-3 * 8


def test_viterbi_on_the_card_equals_the_cpu(cuda):
    from paddle_tpu_torch.text import viterbi_decode
    g = torch.Generator().manual_seed(2)
    pot, trans = torch.randn(8, 64, 11, generator=g), torch.randn(
        11, 11, generator=g)
    lens = torch.randint(1, 65, (8,), generator=g)
    for bos_eos in (True, False):
        s, p = viterbi_decode(pot.to(cuda), trans.to(cuda), lens.to(cuda),
                              bos_eos)
        sc, pc = viterbi_decode(pot, trans, lens, bos_eos)
        assert p.is_cuda and torch.equal(p.cpu(), pc)
        torch.testing.assert_close(s.cpu(), sc, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('family', ['Normal', 'Gamma', 'Beta', 'Dirichlet',
                                    'Poisson', 'Binomial', 'Multinomial',
                                    'StudentT', 'LKJCholesky'])
def test_distribution_draws_from_a_cuda_generator(cuda, family):
    """Draws land on the card from a CUDA generator, one seed twice
    bit-equal, the mean within 5 standard errors; log_prob at the draws
    and entropy on the card == the CPU."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import distribution as D

    def build(place):
        t = lambda v: ptt.to_tensor(torch.tensor(v), place=place)  # noqa
        return {
            'Normal': lambda: D.Normal(t([0.5, -1.0]), t([1.0, 2.0])),
            'Gamma': lambda: D.Gamma(t([0.7, 3.0]), t([1.3, 0.5])),
            'Beta': lambda: D.Beta(t([0.7, 3.0]), t([1.2, 2.5])),
            'Dirichlet': lambda: D.Dirichlet(t([0.7, 1.5, 3.0])),
            'Poisson': lambda: D.Poisson(t([0.5, 4.0])),
            'Binomial': lambda: D.Binomial(t([5.0, 20.0]), t([0.2, 0.8])),
            'Multinomial': lambda: D.Multinomial(6, t([0.2, 0.3, 0.5])),
            'StudentT': lambda: D.StudentT(t([5.0, 10.0]), t([0.0, 1.0]),
                                           t([1.0, 2.0])),
            'LKJCholesky': lambda: D.LKJCholesky(3, t(2.0)),
        }[family]()
    d, dc = build('gpu'), build('cpu')
    s = d.sample((100000,), seed=7)
    assert s.value.is_cuda
    assert torch.equal(s.value, d.sample((100000,), seed=7).value)
    if family != 'LKJCholesky':
        v = s.value.double()
        se = (v.var(0) / v.shape[0]).sqrt()
        assert bool(((v.mean(0) - d.mean.value.double()).abs()
                     <= 5 * se + 1e-9).all())
    if family not in ('Multinomial', 'LKJCholesky'):      # no entropy
        torch.testing.assert_close(d.entropy().value.cpu(),
                                   dc.entropy().value, rtol=1e-5, atol=1e-5)
    head = s.value[:512]
    torch.testing.assert_close(d.log_prob(head).value.cpu(),
                               dc.log_prob(head.cpu()).value, rtol=1e-5,
                               atol=1e-5)


def test_gamma_rsample_gradient_on_the_card_equals_the_cpu(cuda):
    """Gamma's implicit-reparameterization gradient on the card == the
    CPU's `_standard_gamma_grad` at the same draws."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import distribution as D
    a = ptt.to_tensor(torch.linspace(0.3, 4.0, 4096), place='gpu')
    b = ptt.to_tensor(torch.linspace(0.5, 2.0, 4096), place='gpu')
    a.stop_gradient = False
    s = D.Gamma(a, b).rsample(seed=3)
    (g,) = ptt.grad(s.sum(), [a])
    raw = (s.value * b.value).detach().cpu()
    want = torch._standard_gamma_grad(a.value.detach().cpu(), raw) \
        / b.value.cpu()
    torch.testing.assert_close(g.value.cpu(), want, rtol=1e-5, atol=1e-6)
