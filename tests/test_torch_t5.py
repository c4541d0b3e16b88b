"""The port's T5 (paddle_tpu_torch/nlp/t5.py) and its
`Seq2SeqGenerationMixin` against the JAX package's, on the CPU: the same
weights (carried by `from_jax_state`, the matrices scaled so that greedy
tokens vary) and the same inputs (made from a seed with numpy).

Covered: the relative-position bucket table over rel in [-256, 256];
T5 and t5_v1_1-style (gated-gelu, untied head) logits with and without
an encoder padding mask; the loss with -100 labels and `_shift_right`;
`T5Model`'s (decoder, encoder) states; recompute equal to the plain
backward; greedy (padded encoder) tokens and scores, eos freezing with
pad, `min_new_tokens`, `max_length`, beam search (k = 1 equal to greedy,
k = 3 with eos and a length penalty) and speculative decoding against
JAX's tokens, scores and stats; sampling held to its seed; and 3 AdamW
steps of a T5 `TrainStep` against the JAX `TrainStep`.

Tolerances: logits and states 1e-5 relative to the output's scale (its
largest magnitude), over the JAX model's own weights (x 4 weights
amplify fp32 rounding, both frameworks' alike, to ~1e-5: each lies as
far from a float64 run as from the other); losses and scores rtol 1e-5,
parameters after 3 Adam steps atol 4e-5 at lr 1e-3 (as
`tests/test_torch_train.py`). Tokens are equal."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import jax.numpy as jnp
import paddle_tpu.nn.functional as JF
from paddle_tpu import programs
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.nlp import t5 as jt5
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nlp import T5Config, T5ForConditionalGeneration, T5Model
from paddle_tpu_torch.nlp.t5 import _relative_position_bucket, bucket_table
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.weights import from_jax_state

SCALE = 4.0     # weights x 4: the tiny random T5's greedy tokens vary
GATED = dict(feed_forward_proj='gated-gelu', tie_word_embeddings=False)
V = 96          # T5Config.tiny's vocab


@pytest.fixture(autouse=True, scope='module')
def _reset_jax_metrics():
    yield
    jax_metrics.get_registry().reset()


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Beside JAX's thread pool in this process, torch's intra-op threads
    cost more than they give on these tiny shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t5_pair(seed=0, scale=SCALE, **cfg):
    """(JAX model, port model) over the same weights: the JAX tiny T5's
    matrices times `scale`, both in eval mode."""
    paddle.seed(seed)
    jm = jt5.T5ForConditionalGeneration(jt5.T5Config.tiny(**cfg)).eval()
    state = {k: np.asarray(v.numpy()) * (scale if v.ndim == 2 else 1.0)
             for k, v in jm.state_dict().items()}
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    tm = from_jax_state(state, T5ForConditionalGeneration(
        T5Config.tiny(**cfg), device='cpu')).eval()
    return jm, tm


@pytest.fixture(scope='module')
def pair():
    return t5_pair()


@pytest.fixture(scope='module')
def unscaled():
    """The JAX model's own weights (the values' tests: x 4 weights
    amplify fp32 rounding, in both frameworks alike, past 1e-5)."""
    return t5_pair(scale=1.0)


@pytest.fixture(scope='module')
def gated():
    return t5_pair(seed=2, scale=1.0, **GATED)


def close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _ids(shape, seed):
    return np.random.RandomState(seed).randint(2, V, shape)


def _padded(seed=1):
    ids = _ids((2, 10), seed)
    mask = np.ones((2, 10), np.int64)
    mask[0, 7:] = 0
    mask[1, 4:] = 0
    return ids * mask, mask


def test_state_dict_keys_and_shapes_match_jax(unscaled, gated):
    for jm, tm in (unscaled, gated):
        assert {k: tuple(v.shape) for k, v in jm.state_dict().items()} == {
            k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert unscaled[1].lm_head is None and gated[1].lm_head.bias is None


@pytest.mark.parametrize('bidirectional', [True, False])
@pytest.mark.parametrize('buckets,distance', [(32, 128), (8, 16), (32, 64)])
def test_bucket_table_matches_jax(bidirectional, buckets, distance):
    """Every relative position in [-256, 256], the bucket edges n = 16,
    32, 64 of 32 buckets over 128 included; and the host table the
    forward gathers from gives the same buckets past its ends."""
    rel = np.arange(-256, 257)
    want = np.asarray(jt5._relative_position_bucket(
        jnp.asarray(rel, jnp.int32), bidirectional, buckets, distance))
    got = _relative_position_bucket(torch.from_numpy(rel), bidirectional,
                                    buckets, distance)
    np.testing.assert_array_equal(got.numpy(), want)
    table = bucket_table(bidirectional, buckets, distance)
    idx = np.clip(rel, -distance, distance) + distance
    np.testing.assert_array_equal(table.numpy()[idx], want)


@pytest.mark.parametrize('offset', [0, 5, 37])
def test_compute_bias_matches_jax(pair, offset):
    """The decoder's [1, H, Sq, Sk] bias at a query offset (the cached
    decode) and the encoder's, from the same embedding."""
    jm, tm = pair
    for side in ('encoder', 'decoder'):
        ja = getattr(jm.t5, side).block[0].self_attn
        ta = getattr(tm.t5, side).block[0].self_attn
        want = np.asarray(ja.compute_bias(3, 48, offset).numpy())
        got = ta.compute_bias(3, 48, torch.tensor(offset)).detach()
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('variant', ['relu_tied', 'gated_untied'])
@pytest.mark.parametrize('masked', [False, True])
def test_logits_match_jax(unscaled, gated, variant, masked):
    jm, tm = unscaled if variant == 'relu_tied' else gated
    ids, mask = _padded()
    if not masked:
        mask = None
    dec = _ids((2, 6), 3)
    want = jm(input_ids=ids, decoder_input_ids=dec,
              attention_mask=mask).numpy()
    with torch.no_grad():
        got = tm(input_ids=ids, decoder_input_ids=dec, attention_mask=mask)
    close(got, want)


def test_t5model_states_match_jax(unscaled):
    jm, tm = unscaled
    ids, dec = _ids((2, 9), 4), _ids((2, 5), 5)
    jdec, jenc = jm.t5(ids, dec)
    with torch.no_grad():
        tdec, tenc = tm.t5(ids, dec)
    close(tdec, jdec.numpy())
    close(tenc, jenc.numpy())
    # the mixin's protocol takes port Tensors too, as the JAX one does
    import paddle_tpu_torch as ptt
    with torch.no_grad():
        assert torch.equal(tm.t5.encode(ptt.Tensor(torch.from_numpy(ids))),
                           tenc)


def test_loss_and_shift_right_match_jax(unscaled):
    """The loss of `labels` (its last label -100 in one row: ignored, and
    its decoder input the pad id) and `_shift_right` itself."""
    jm, tm = unscaled
    ids = _ids((2, 8), 6)
    labels = _ids((2, 6), 7)
    labels[0, -1] = -100
    labels[1, 2] = -100
    np.testing.assert_array_equal(
        tm._shift_right(labels).numpy(),
        np.asarray(jm._shift_right(labels).numpy()))
    shifted = tm._shift_right(labels).numpy()
    assert (shifted[:, 0] == 0).all() and shifted[1, 3] == 0
    jloss, jlogits = jm(input_ids=ids, labels=labels)
    with torch.no_grad():
        tloss, tlogits = tm(input_ids=ids, labels=labels)
    np.testing.assert_allclose(float(tloss), float(jloss.numpy()), rtol=1e-5)
    close(tlogits, jlogits.numpy())


def test_recompute_gives_the_same_loss_and_gradients():
    """use_recompute reruns each block in the backward: the loss and every
    gradient are the plain backward's."""
    out = []
    for remat in (False, True):
        tm = T5ForConditionalGeneration(
            T5Config.tiny(use_recompute=remat), device='cpu',
            generator=torch.Generator().manual_seed(3))
        loss, _ = tm(input_ids=_ids((2, 8), 8), labels=_ids((2, 6), 9))
        loss.backward()
        out.append((loss.item(), {n: p.grad.clone()
                                  for n, p in tm.named_parameters()}))
    assert out[0][0] == out[1][0]
    for name, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][name], g, rtol=1e-6, atol=1e-7)


def test_presets_fix_their_depth_as_jax_does():
    """A preset's num_layers cannot be overridden in either package (the
    smoke cuts a preset's depth by setting the attributes)."""
    for cfg_cls in (T5Config, jt5.T5Config):
        with pytest.raises(TypeError, match='num_layers'):
            cfg_cls.t5_large(num_layers=2)
    cfg = T5Config.t5_large(num_decoder_layers=3)
    assert (cfg.num_layers, cfg.num_decoder_layers, cfg.d_model) == \
        (24, 3, 1024)


def test_parallel_options_are_not_ported():
    with pytest.raises(NotImplementedError, match='4.7'):
        T5Model(T5Config.tiny(tensor_parallel=True), device='cpu')
    with pytest.raises(NotImplementedError, match='distributed'):
        T5ForConditionalGeneration(T5Config.tiny(sequence_parallel=True),
                                   device='cpu')


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def test_greedy_padded_encoder_matches_jax(pair):
    jm, tm = pair
    ids, mask = _padded(22)
    jt, js = jm.generate(ids, max_new_tokens=8, attention_mask=mask,
                         eos_token_id=-1)
    tt, ts = tm.generate(ids, max_new_tokens=8, attention_mask=mask,
                         eos_token_id=-1)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt.numpy()))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js.numpy()), rtol=1e-5)
    assert all(len(set(r)) > 2 for r in tt.tolist())


def test_greedy_equals_an_argmax_over_full_forwards(pair):
    """The static cache's decode equals rerunning the whole decoder a
    step (no cache)."""
    _, tm = pair
    ids = _ids((2, 8), 11)
    got, _ = tm.generate(ids, max_new_tokens=8, eos_token_id=-1)
    dec = torch.zeros((2, 1), dtype=torch.int64)
    with torch.no_grad():
        for _ in range(8):
            nxt = tm(input_ids=ids, decoder_input_ids=dec)[:, -1].argmax(-1)
            dec = torch.cat([dec, nxt[:, None]], dim=1)
    assert torch.equal(got, dec[:, 1:])


def test_eos_freezes_pads_and_min_new_tokens_match_jax(pair):
    jm, tm = pair
    ids = _ids((2, 6), 12)
    first, _ = tm.generate(ids, max_new_tokens=1, eos_token_id=-1)
    eos = int(first[0, 0])
    for kw in (dict(max_new_tokens=6), dict(max_new_tokens=6,
                                              min_new_tokens=3),
               dict(max_length=5)):
        jt, js = jm.generate(ids, eos_token_id=eos, pad_token_id=7, **kw)
        tt, ts = tm.generate(ids, eos_token_id=eos, pad_token_id=7, **kw)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt.numpy()))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js.numpy()),
                                   rtol=1e-5)
    plain, _ = tm.generate(ids, max_new_tokens=6, eos_token_id=eos,
                           pad_token_id=7)
    assert plain[0, 0] == eos and (plain[0, 1:] == 7).all()
    held, _ = tm.generate(ids, max_new_tokens=6, eos_token_id=eos,
                          pad_token_id=7, min_new_tokens=3)
    assert (held[:, :3] != eos).all()
    assert tm.generate(ids, max_length=5)[0].shape == (2, 4)


def test_beam_1_equals_greedy(pair):
    _, tm = pair
    ids = _ids((2, 7), 13)
    greedy, _ = tm.generate(ids, max_new_tokens=6, eos_token_id=-1)
    beam, _ = tm.generate(ids, max_new_tokens=6, eos_token_id=-1,
                          decode_strategy='beam_search', num_beams=1)
    assert torch.equal(greedy, beam)


@pytest.mark.parametrize('eos,penalty', [(-1, 0.0), ('first', 1.0)])
def test_beam_k_matches_jax(pair, eos, penalty):
    """k = 3 beams, tokens and length-normalized scores; with eos the
    greedy first token, so some beams finish and freeze with pad."""
    jm, tm = pair
    ids, mask = _padded(14)
    if eos == 'first':
        eos = int(tm.generate(ids, max_new_tokens=1, eos_token_id=-1,
                              attention_mask=mask)[0][0, 0])
    kw = dict(max_new_tokens=5, decode_strategy='beam_search', num_beams=3,
              eos_token_id=eos, pad_token_id=93, length_penalty=penalty,
              attention_mask=mask)
    jt, js = jm.generate(ids, **kw)
    tt, ts = tm.generate(ids, **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt.numpy()))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js.numpy()), rtol=1e-5)
    if eos != -1:
        assert (tt == 93).any()


def test_beam_with_min_new_tokens_raises(pair):
    with pytest.raises(NotImplementedError, match='min_new_tokens'):
        pair[1].generate(_ids((1, 4), 0), decode_strategy='beam_search',
                         num_beams=2, min_new_tokens=2)


def test_sampling_is_held_to_its_seed(pair):
    """Sampled tokens come from a torch.Generator (the JAX package's only
    in distribution): the same seed gives the same tokens, top_k=1 gives
    greedy's, and every sampled token lies in its step's top_k."""
    _, tm = pair
    ids = _ids((2, 6), 15)
    kw = dict(max_new_tokens=6, decode_strategy='sampling', top_k=8,
              eos_token_id=-1)
    a, _ = tm.generate(ids, seed=42, **kw)
    b, _ = tm.generate(ids, seed=42, **kw)
    assert torch.equal(a, b)
    one, _ = tm.generate(ids, seed=1, **{**kw, 'top_k': 1})
    assert torch.equal(one, tm.generate(ids, max_new_tokens=6,
                                        eos_token_id=-1)[0])
    dec = torch.cat([torch.zeros((2, 1), dtype=torch.int64), a], dim=1)
    with torch.no_grad():
        logits = tm(input_ids=ids, decoder_input_ids=dec[:, :-1])
    top = logits.topk(8, dim=-1).indices
    assert (top == a[..., None]).any(-1).all()


@pytest.mark.parametrize('draft', ['self', 'one_layer'])
def test_speculative_generate_matches_jax_and_greedy(pair, draft):
    jm, tm = pair
    if draft == 'self':
        jd, td = jm, tm
    else:
        jd, td = t5_pair(seed=9, num_layers=1)
    ids = _ids((1, 9), 16)
    jt, jstats = jm.speculative_generate(jd, ids, max_new_tokens=10,
                                         eos_token_id=-1)
    tt, tstats = tm.speculative_generate(td, ids, max_new_tokens=10,
                                         eos_token_id=-1)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt.numpy()))
    assert tstats == jstats
    greedy, _ = tm.generate(ids, max_new_tokens=10, eos_token_id=-1)
    assert torch.equal(tt, greedy)
    with pytest.raises(ValueError, match='batch'):
        tm.speculative_generate(td, _ids((2, 4), 0))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_train_step_matches_jax():
    """3 AdamW steps of both TrainSteps on (encoder ids, decoder inputs) ->
    labels, the loss `F.cross_entropy` over the 96-wide vocab."""
    paddle.seed(31)
    jm = jt5.T5ForConditionalGeneration(jt5.T5Config.tiny())
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = from_jax_state(state, T5ForConditionalGeneration(T5Config.tiny(),
                                                          device='cpu'))
    programs.get_store().clear_memory()
    jstep = JaxTrainStep(jm, lambda lg, lab: JF.cross_entropy(
        lg.reshape([-1, V]), lab.reshape([-1])), JaxAdamW(
            learning_rate=1e-3, parameters=jm.parameters()))
    tstep = TrainStep(tm, lambda lg, lab: F.cross_entropy(
        lg.reshape(-1, V), lab.reshape(-1)), AdamW(
            learning_rate=1e-3, parameters=tm.parameters()))
    rng = np.random.RandomState(31)
    for _ in range(3):
        src = rng.randint(2, V, (4, 8))
        tgt = rng.randint(2, V, (4, 6))
        dec = np.concatenate([np.zeros((4, 1), np.int64), tgt[:, :-1]], 1)
        want = float(jstep((src, dec), tgt).numpy())
        np.testing.assert_allclose(float(tstep((src, dec), tgt)), want,
                                   rtol=1e-5)
    jsd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), jsd[name], rtol=0, atol=4e-5,
                                   err_msg=name)
