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
    forward, the dq and the dk/dv kernel, as is fp16; the same bf16
    values aligned are taken, one launch per call."""
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
    with pytest.raises(ValueError):          # fp16: neither kernel takes it
        K.flash_attention_fwd(y.half(), y.half(), y.half(), causal=True)
    with pytest.raises(ValueError):
        K.flash_attention_bwd_dq(y.half(), y.half(), y.half(), y.half(),
                                 lse, y.half(), True)
    with pytest.raises(ValueError):
        K.flash_attention_bwd_dkv(y.half(), y.half(), y.half(), lse, lse,
                                  y.half(), True)
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
    before = K.LAUNCHES['paged_attention']
    got = K.paged_attention(q, kp, vp, table, lens, k_scales=ks, v_scales=vs)
    assert K.LAUNCHES['paged_attention'] == before + 1
    _close(got, K.paged_attention_reference(q, kp, vp, table, lens,
                                            k_scales=ks, v_scales=vs), dtype)


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
    x = torch.zeros((1, 8, 2, 64), device=cuda)   # head_dim 64
    with pytest.raises(ValueError):
        K.flash_attention_fwd(x, x, x, causal=True)
    with pytest.raises(ValueError):
        K.rms_norm(torch.zeros((2, 8), device=cuda, dtype=torch.float16),
                   torch.ones(8, device=cuda, dtype=torch.float16))
    q = torch.zeros((1, 16, 128), device=cuda)
    pages = torch.zeros((3, 16, 1, 128), device=cuda)   # 16 heads per kv
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
                           decode_block=4).generate_many(prompts, sp)
    assert all(K.LAUNCHES[k] > 0 for k in ('flash_attention_fwd',
                                           'paged_attention', 'rms_norm'))
    cpu = InferenceEngine(on_cpu, num_slots=3, max_length=128,
                          decode_block=4).generate_many(prompts, sp)
    assert [h.tokens for h in card] == [h.tokens for h in cpu]


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
    with pytest.raises(ValueError):          # fp16 logits
        K.softmax_cross_entropy_fwd(x.half(), torch.zeros(
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
    with pytest.raises(ValueError):          # fp16 x
        K.adapter_matmul(x.half(), a, b, rows, scale)
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
                             decode_block=4, adapter_bank=bank
                             ).generate_many(prompts, sp, adapter_ids=ids)
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


def _serve_counted(model, bank, capture, prompts, params, ids):
    """Serve one warm-up request (the graph engine captures at its first
    round), then `prompts` with LAUNCHES counted; returns (tokens,
    LAUNCHES, engine)."""
    eng = InferenceEngine(model, num_slots=3, max_length=128, decode_block=4,
                          adapter_bank=bank)
    eng._capture_decode = capture
    eng.generate_many([prompts[0][:3]],
                      SamplingParams(max_new_tokens=4, eos_token_id=-1))
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
    assert st['traces'] == {'paged_decode_step': 1}
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
                          adapter_bank=bank)
    eng._capture_decode = capture
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
    assert eng.stats()['traces'] == ({'paged_decode_step': 1} if capture
                                     else {})


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
