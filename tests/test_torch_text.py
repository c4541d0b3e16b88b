"""`text` of the port against the JAX package's, on the CPU.

`viterbi_decode` and `ViterbiDecoder` on the same seeded potentials and
transitions (L <= 32, ragged lengths from 1 to L, with and without the
BOS/EOS tags): paths equal exactly (compared as values: the port's
paths are int64, the JAX package's int32 with 64-bit off), scores within
rtol 1e-5. The synthetic datasets: the same seeds give the same arrays.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu import text as jtext
from paddle_tpu_torch import text as ttext


@pytest.fixture(autouse=True, scope='module')
def _cpu_place():
    ptt.set_device('cpu')
    yield
    ptt.set_device('gpu')


def _inputs(seed, b, length, tags):
    rng = np.random.default_rng(seed)
    pot = rng.standard_normal((b, length, tags)).astype(np.float32)
    trans = rng.standard_normal((tags, tags)).astype(np.float32)
    lens = rng.integers(1, length + 1, b).astype(np.int64)
    lens[0] = length
    return pot, trans, lens


@pytest.mark.parametrize('bos_eos', [True, False])
@pytest.mark.parametrize('b,length,tags', [(1, 1, 4), (6, 9, 5),
                                           (16, 32, 11)])
def test_viterbi_decode_matches_jax(bos_eos, b, length, tags):
    pot, trans, lens = _inputs(b * length + tags, b, length, tags)
    ts, tp = ttext.viterbi_decode(ptt.to_tensor(pot), ptt.to_tensor(trans),
                                  ptt.to_tensor(lens), bos_eos)
    js, jp = jtext.viterbi_decode(paddle.to_tensor(pot),
                                  paddle.to_tensor(trans),
                                  paddle.to_tensor(lens), bos_eos)
    assert tp.dtype == torch.int64
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp.numpy()))
    np.testing.assert_allclose(ts.numpy(), js.numpy(), rtol=1e-5)
    # zero past each length
    pos = np.arange(length)[None, :]
    assert (tp.numpy()[pos >= lens[:, None]] == 0).all()


def _brute_force(pot, trans, n, bos_eos):
    """Best path of one sequence of length n by enumeration."""
    import itertools
    tags = pot.shape[-1]
    best, arg = -np.inf, None
    for path in itertools.product(range(tags), repeat=n):
        s = pot[0, path[0]] + (trans[tags - 2, path[0]] if bos_eos else 0)
        for t in range(1, n):
            s += trans[path[t - 1], path[t]] + pot[t, path[t]]
        if bos_eos:
            s += trans[path[-1], tags - 1]
        if s > best:
            best, arg = s, path
    return best, arg


@pytest.mark.parametrize('bos_eos', [True, False])
def test_viterbi_decode_is_the_best_path(bos_eos):
    pot, trans, lens = _inputs(7, 4, 5, 4)
    scores, paths = ttext.viterbi_decode(
        ptt.to_tensor(pot), ptt.to_tensor(trans), ptt.to_tensor(lens),
        bos_eos)
    for i, n in enumerate(lens):
        best, arg = _brute_force(pot[i], trans, int(n), bos_eos)
        assert scores.numpy()[i] == pytest.approx(best, rel=1e-5)
        assert tuple(paths.numpy()[i, :n]) == arg


def test_viterbi_decoder_layer_matches_jax():
    pot, trans, lens = _inputs(3, 5, 12, 7)
    tdec = ttext.ViterbiDecoder(ptt.to_tensor(trans),
                                include_bos_eos_tag=False)
    jdec = jtext.ViterbiDecoder(paddle.to_tensor(trans),
                                include_bos_eos_tag=False)
    ts, tp = tdec(ptt.to_tensor(pot), ptt.to_tensor(lens))
    js, jp = jdec(paddle.to_tensor(pot), paddle.to_tensor(lens))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp.numpy()))
    np.testing.assert_allclose(ts.numpy(), js.numpy(), rtol=1e-5)


@pytest.mark.parametrize('cls,fields', [
    ('Imdb', ('docs', 'labels')), ('UCIHousing', ('x', 'y')),
    ('Conll05st', ('tokens', 'marks', 'labels'))])
def test_synthetic_datasets_match_jax(cls, fields):
    for mode in ('train', 'test'):
        t, j = getattr(ttext, cls)(mode=mode), getattr(jtext, cls)(mode=mode)
        assert len(t) == len(j)
        for f in fields:
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
        for a, b in zip(t[len(t) - 1], j[len(j) - 1]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match='offline'):
        getattr(ttext, cls)(data_file='x.tar.gz')
