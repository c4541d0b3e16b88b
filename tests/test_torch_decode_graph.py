"""The decode sub-step over static buffers (paddle_tpu_torch/serving/
decode_graph.py) on the CPU, where it runs uncaptured: the code the
card captures as a CUDA graph and replays.

- The port's engine against the JAX `InferenceEngine(kv_page_size=16,
  adapter_bank=...)` at decode_block=3, with requests that stop on eos
  mid-round, slots re-admitted under another adapter, base and adapted
  requests mixed: identical tokens per request.
- The same engine against the per-round loop it replaced (fresh tensors
  staged every round, one `sample_rows` per sub-step), with greedy and
  seeded sampling requests: identical tokens.
- The split greedy argmax / `draw_rows` path against that loop's
  `sample_rows` for the same seeds.
- `kernels.CapturedLaunches`: a capture adds nothing to `LAUNCHES`, each
  replay adds what the capture recorded.

Inputs come from numpy with a seed. The capture itself runs only on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.serving import AdapterBank as JaxBank
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu.serving import make_adapter_factors as jax_factors
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import NEG_INF
from paddle_tpu_torch.serving import (FINISHED, SAMPLING, AdapterBank,
                                      InferenceEngine, SamplingParams,
                                      make_adapter_factors, sample_rows)
from paddle_tpu_torch.serving.adapters import adapter_scope
from paddle_tpu_torch.serving.decode_graph import draw_rows
from paddle_tpu_torch.weights import from_jax_state

NO_EOS = -1
TARGETS = ('q_proj', 'k_proj', 'v_proj', 'o_proj')


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


def _prompts(lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, (s,)).tolist() for s in lens]


def _banks(jm, tm):
    """Two adapters on q/k/v/o_proj in both packages, factors strong
    enough to flip greedy tokens on the tiny model."""
    jbank = JaxBank(jm, capacity=3, rank=4, targets=TARGETS)
    bank = AdapterBank(tm, capacity=3, rank=4, targets=TARGETS)
    for i in range(2):
        jbank.load(f'ad{i}', jax_factors(jbank, seed=1 + i, scale=0.2),
                   version=1)
        bank.load(f'ad{i}', make_adapter_factors(bank, seed=1 + i,
                                                 scale=0.2), version=1)
    return jbank, bank


def test_block3_eos_mid_round_and_readmission_identical_to_jax(models):
    """Seven requests through 3 slots at decode_block=3, base and adapted
    mixed: each stops on an eos token taken from a free run at token
    index 0, 1, 3 or 4, so it retires mid-round and its slot is
    re-admitted at the next step (under another adapter or none). Every
    request gets the JAX engine's tokens."""
    jm, tm = models
    prompts = _prompts([4, 9, 6, 5, 11, 7, 3], seed=7)
    ids = [None, 'ad0', 'ad1', None, 'ad1', 'ad0', 'ad1']
    jbank, bank = _banks(jm, tm)
    kw = dict(num_slots=3, max_length=64, decode_block=3, kv_page_size=16)
    free = JaxEngine(jm, adapter_bank=jbank, **kw).generate_many(
        prompts, JaxParams(max_new_tokens=10, eos_token_id=NO_EOS),
        adapter_ids=ids)
    eos = [h.tokens[(0, 1, 3, 4)[i % 4]] for i, h in enumerate(free)]
    hj = JaxEngine(jm, adapter_bank=jbank, **kw).generate_many(
        prompts, [JaxParams(max_new_tokens=10, eos_token_id=e)
                  for e in eos], adapter_ids=ids)
    eng = InferenceEngine(tm, adapter_bank=bank, **kw)
    ht = eng.generate_many(
        prompts, [SamplingParams(max_new_tokens=10, eos_token_id=e)
                  for e in eos], adapter_ids=ids)
    assert [h.tokens for h in ht] == [h.tokens for h in hj]
    assert all(h.status == FINISHED and h.tokens[-1] == e
               for h, e in zip(ht, eos))
    assert any(len(h.tokens) % 3 for h in ht)      # some retired mid-round
    st = eng.stats()
    assert st['prefills'] == 7 and st['completed'] == 7
    assert st['adapters']['pinned'] == 0
    assert st['traces'] == {}                      # nothing captured here


def _loop_round(eng) -> np.ndarray:
    """The per-round decode loop the static-buffer sub-step replaced:
    fresh device tensors staged every round, one `sample_rows` per
    sub-step (its draws: `_loop_sample_rows`)."""
    dev = eng.device
    active = torch.from_numpy(eng._active).to(dev)
    table = torch.from_numpy(np.where(
        eng._active[:, None], eng.pool.page_table, 0)).to(dev)
    tok = torch.from_numpy(eng._tok).to(dev)
    pos = torch.from_numpy(eng._pos).to(dev)
    temp = torch.from_numpy(eng._temp).to(dev)
    topk = torch.from_numpy(eng._topk).to(dev)
    topp = torch.from_numpy(eng._topp).to(dev)
    sampling = eng._active & ~eng._greedy
    adapters, rows = (None, None)
    if eng.adapter_bank is not None:
        adapters = eng.adapter_bank.device_arrays()
        rows = torch.from_numpy(eng._adapter_rows.copy()).to(dev)
    out = []
    with torch.inference_mode():
        for _ in range(eng.decode_block):
            with adapter_scope(adapters, rows):
                logits = eng._fwd(tok[:, None], eng.pool.pages, pos,
                                  table)[:, -1]
            nxt = _loop_sample_rows(logits, temp, topk, topp, sampling,
                                    eng._gens)
            tok = torch.where(active, nxt, 0)
            pos = torch.clamp(pos + 1, max=eng.pool.max_length - 1)
            out.append(tok)
        toks = torch.stack(out, dim=1).cpu().numpy()
    eng._counts['decode_steps'] += eng.decode_block
    return toks


def _loop_sample_rows(logits, temp, topk, topp, sampling, generators):
    """The engine's `sample_rows` before the greedy/draw split."""
    logits = logits.float()
    out = logits.argmax(dim=-1)
    rows = np.flatnonzero(sampling)
    if rows.size == 0:
        return out
    idx = torch.from_numpy(rows).to(logits.device)
    x = logits[idx] / temp[idx].clamp(min=1e-6)[:, None]
    v = x.shape[-1]
    k = topk[idx]
    k_eff = torch.where((k > 0) & (k < v), k, v).long()
    srt = x.sort(dim=-1, descending=True).values
    kth = srt.gather(1, k_eff[:, None] - 1)
    x = x.masked_fill(x < kth, NEG_INF)
    p = topp[idx]
    srt_p = x.sort(dim=-1, descending=True).values
    probs = torch.softmax(srt_p, dim=-1)
    cum = probs.cumsum(dim=-1)
    cutoff_idx = ((cum - probs) < p[:, None]).sum(dim=-1) - 1
    cutoff = srt_p.gather(1, cutoff_idx.clamp(0, v - 1)[:, None])
    x = x.masked_fill((p[:, None] < 1.0) & (x < cutoff), NEG_INF)
    dist = torch.softmax(x, dim=-1)
    for j, r in enumerate(rows):
        out[r] = torch.multinomial(dist[j], 1, generator=generators[r])[0]
    return out


@pytest.mark.parametrize('banked', [False, True])
def test_static_buffer_rounds_equal_the_per_round_loop(models, banked):
    """Greedy and seeded sampling requests (top-k, top-p, temperature),
    more than the slots, at decode_block=3: the engine's static-buffer
    sub-step gives the per-round loop's tokens, with and without a bank."""
    _, tm = models
    prompts = _prompts([5, 12, 3, 8, 6], seed=8)
    params = [SamplingParams(max_new_tokens=7, eos_token_id=NO_EOS),
              SamplingParams(max_new_tokens=9, strategy=SAMPLING,
                             temperature=0.9, top_k=40, top_p=0.95, seed=3,
                             eos_token_id=NO_EOS),
              SamplingParams(max_new_tokens=5, eos_token_id=NO_EOS),
              SamplingParams(max_new_tokens=8, strategy=SAMPLING,
                             temperature=1.3, top_p=0.8, seed=4,
                             eos_token_id=NO_EOS),
              SamplingParams(max_new_tokens=6, strategy=SAMPLING,
                             top_k=5, seed=5, eos_token_id=NO_EOS)]
    ids = [None, 'ad0', 'ad1', None, 'ad0'] if banked else None
    tokens = []
    for loop in (False, True):
        bank = _banks(*models)[1] if banked else None
        eng = InferenceEngine(tm, num_slots=3, max_length=64, decode_block=3,
                              kv_page_size=16, adapter_bank=bank)
        if loop:
            eng._decode_round = lambda e=eng: _loop_round(e)
        tokens.append([h.tokens for h in eng.generate_many(
            prompts, params, adapter_ids=ids)])
    assert tokens[0] == tokens[1]
    assert all(len(t) == p.max_new_tokens for t, p in zip(tokens[0], params))


def test_greedy_then_draw_equals_sample_rows_before_the_split():
    """The sub-step's argmax + `where(active, ., 0)`, then `draw_rows` on
    the sampling rows, gives the pre-split `sample_rows`' tokens for the
    same seeds over repeated draws (the generators advance alike), and so
    does the public `sample_rows`."""
    rng = np.random.RandomState(12)
    n, v = 6, 50
    temp = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    topk = torch.tensor([0, 7, 0, 1, 60, 3])
    topp = torch.tensor([1.0, 0.9, 0.7, 1.0, 0.95, 1.0])
    active = np.array([True, True, True, False, True, True])
    sampling = active & np.array([False, True, True, False, True, True])
    rows = np.flatnonzero(sampling)

    def gens():
        return [torch.Generator().manual_seed(100 + i) for i in range(n)]

    want_g, split_g, public_g = gens(), gens(), gens()
    for _ in range(10):
        logits = torch.from_numpy(
            (3 * rng.standard_normal((n, v))).astype(np.float32))
        want = torch.where(torch.from_numpy(active), _loop_sample_rows(
            logits, temp, topk, topp, sampling, want_g), 0)
        tok = torch.where(torch.from_numpy(active), logits.argmax(dim=-1), 0)
        draw_rows(logits, tok, temp, topk, topp, rows, split_g)
        assert torch.equal(tok, want)
        public = sample_rows(logits, temp, topk, topp, sampling, public_g)
        assert torch.equal(torch.where(torch.from_numpy(active), public, 0),
                           want)


def test_captured_launches_count_replays_not_the_capture():
    K.reset_launch_counts()
    K.LAUNCHES['rms_norm'] = 5
    with K.CapturedLaunches() as held:          # what the wrappers count
        K.LAUNCHES['rms_norm'] += 65            # while a graph records
        K.LAUNCHES['paged_attention'] += 32
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0), 'rms_norm': 5}
    assert held.counts == {'rms_norm': 65, 'paged_attention': 32}
    for _ in range(3):
        held.replayed()
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0),
                          'rms_norm': 5 + 3 * 65, 'paged_attention': 96}
    with pytest.raises(RuntimeError):
        with K.CapturedLaunches():              # a capture that fails
            K.LAUNCHES['adapter_matmul'] += 128
            raise RuntimeError('capture failed')
    assert K.LAUNCHES['adapter_matmul'] == 0
    K.reset_launch_counts()
