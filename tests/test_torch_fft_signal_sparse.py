"""`fft`, `signal` and `sparse` of the port against the JAX package's, on
the CPU.

The same seeded numpy inputs go through `paddle_tpu` and
`paddle_tpu_torch`. Tolerances: f32 and complex64 rtol 1e-5, atol 1e-5
of the output's scale (FFTs summed in another order: pocketfft against
XLA's); float64 and complex128 inputs stay 64-bit in the port (ROADMAP:
"64-bit dtypes stay 64-bit"; the JAX package narrows them, x64 off) and
are held to the JAX output at the f32 tolerance. Sparse results:
exactly equal indices, values rtol 1e-6.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu import fft as jfft
from paddle_tpu import signal as jsignal
from paddle_tpu import sparse as jsparse
from paddle_tpu_torch import fft as tfft
from paddle_tpu_torch import signal as tsignal
from paddle_tpu_torch import sparse as tsparse


@pytest.fixture(autouse=True, scope='module')
def _cpu_place():
    ptt.set_device('cpu')
    yield
    ptt.set_device('gpu')


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x.numpy())


def _close(got, want, tol=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _pair(a):
    return paddle.to_tensor(a), ptt.to_tensor(a)


_RNG = np.random.default_rng(0)
REAL = _RNG.standard_normal((4, 16)).astype(np.float32)
CPLX = (_RNG.standard_normal((4, 16))
        + 1j * _RNG.standard_normal((4, 16))).astype(np.complex64)
CUBE = _RNG.standard_normal((3, 8, 10)).astype(np.float32)

_FFT_CASES = [
    ('fft', CPLX, {}), ('fft', REAL, {'n': 20}), ('ifft', CPLX,
                                                  {'norm': 'ortho'}),
    ('rfft', REAL, {'axis': 0}), ('irfft', CPLX, {'n': 30}),
    ('hfft', CPLX, {}), ('ihfft', REAL, {'norm': 'forward'}),
    ('fft2', CUBE, {}), ('ifft2', CUBE, {'axes': (0, 2)}),
    ('rfft2', CUBE, {'s': (6, 8)}), ('irfft2', CUBE.astype(np.complex64),
                                     {}),
    ('fftn', CUBE, {}), ('ifftn', CUBE, {'axes': (1,)}),
    ('rfftn', CUBE, {'norm': 'ortho'}), ('irfftn', CUBE.astype(
        np.complex64), {'s': (3, 8, 12)}),
]


@pytest.mark.parametrize('name,x,kw', _FFT_CASES,
                         ids=[f'{c[0]}-{i}' for i, c in
                              enumerate(_FFT_CASES)])
def test_fft_matches_jax(name, x, kw):
    jx, tx = _pair(x)
    want = getattr(jfft, name)(jx, **kw)
    got = getattr(tfft, name)(tx, **kw)
    assert str(got.dtype).replace('torch.', '') == str(_np(want).dtype)
    _close(got, want)


@pytest.mark.parametrize('name', ['fftshift', 'ifftshift'])
@pytest.mark.parametrize('axes', [None, [1], (0, 2)])
def test_fft_shifts_match_jax(name, axes):
    jx, tx = _pair(CUBE)
    np.testing.assert_array_equal(_np(getattr(tfft, name)(tx, axes=axes)),
                                  _np(getattr(jfft, name)(jx, axes=axes)))


@pytest.mark.parametrize('name', ['fftfreq', 'rfftfreq'])
@pytest.mark.parametrize('n,d', [(8, 1.0), (9, 0.25)])
def test_fft_frequencies_match_jax(name, n, d):
    got = getattr(tfft, name)(n, d)
    assert got.dtype == torch.float32
    _close(got, getattr(jfft, name)(n, d), 1e-6)
    assert getattr(tfft, name)(n, d, dtype='float64').dtype == torch.float64


def test_complex128_stays_128():
    """A complex128 transform stays complex128 in the port (the JAX
    package narrows it to complex64), with the same values."""
    x = CPLX.astype(np.complex128)
    got = tfft.fft(ptt.to_tensor(x))
    assert got.dtype == torch.complex128
    _close(got, jfft.fft(paddle.to_tensor(x)))
    np.testing.assert_allclose(_np(got), np.fft.fft(x), rtol=1e-12,
                               atol=1e-12)


SIGNAL = _RNG.standard_normal((2, 200)).astype(np.float32)


@pytest.mark.parametrize('frame_length,hop', [(16, 4), (32, 32), (20, 7)])
def test_frame_and_overlap_add_match_jax(frame_length, hop):
    jx, tx = _pair(SIGNAL)
    f_j = jsignal.frame(jx, frame_length, hop)
    f_t = tsignal.frame(tx, frame_length, hop)
    _close(f_t, f_j, 0)
    _close(tsignal.overlap_add(f_t, hop), jsignal.overlap_add(f_j, hop))


_STFT_CASES = [
    dict(n_fft=32), dict(n_fft=32, hop_length=8, win_length=24),
    dict(n_fft=64, center=False), dict(n_fft=32, normalized=True),
    dict(n_fft=32, onesided=False), dict(n_fft=32, pad_mode='constant'),
]


@pytest.mark.parametrize('kw', _STFT_CASES,
                         ids=[str(i) for i in range(len(_STFT_CASES))])
@pytest.mark.parametrize('window', [False, True], ids=['ones', 'hann'])
def test_stft_matches_jax(kw, window):
    jx, tx = _pair(SIGNAL)
    extra_j, extra_t = {}, {}
    if window:
        w = np.hanning(kw.get('win_length', kw['n_fft'])).astype(np.float32)
        extra_j['window'], extra_t['window'] = _pair(w)
    want = jsignal.stft(jx, **kw, **extra_j)
    got = tsignal.stft(tx, **kw, **extra_t)
    _close(got, want)


@pytest.mark.parametrize('kw', [dict(n_fft=32), dict(n_fft=32, hop_length=8),
                                dict(n_fft=64, length=180),
                                dict(n_fft=32, normalized=True)],
                         ids=['default', 'hop8', 'length', 'normalized'])
def test_istft_matches_jax_and_inverts(kw):
    """istft of the stft (Hann window, COLA at hop n_fft / 4 and 8):
    equal to the JAX package's, and back to the signal."""
    n_fft = kw['n_fft']
    w = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    jw, tw = _pair(w)
    skw = {k: v for k, v in kw.items() if k != 'length'}
    spec_j = jsignal.stft(paddle.to_tensor(SIGNAL), window=jw, **skw)
    spec_t = tsignal.stft(ptt.to_tensor(SIGNAL), window=tw, **skw)
    want = jsignal.istft(spec_j, window=jw, **kw)
    got = tsignal.istft(spec_t, window=tw, **kw)
    _close(got, want, 1e-4)
    n = _np(got).shape[-1]
    np.testing.assert_allclose(_np(got), SIGNAL[:, :n], atol=1e-4)


def test_signal_is_differentiable():
    """The stft is an op of the port: a gradient flows to its input (and
    equals the JAX package's)."""
    jx, tx = _pair(SIGNAL)
    jx.stop_gradient = False
    tx.stop_gradient = False
    (jspec, tspec) = (jsignal.stft(jx, 32), tsignal.stft(tx, 32))
    jloss = (jspec.abs() ** 2).sum()
    tloss = (tspec.abs() ** 2).sum()
    (jg,) = paddle.grad(jloss, [jx])
    (tg,) = ptt.grad(tloss, [tx])
    _close(tg, jg, 1e-4)


# -- sparse -----------------------------------------------------------------

IDX = np.array([[0, 1, 1, 3, 0], [2, 0, 3, 1, 2]], np.int64)   # a duplicate
VALS = np.array([1.0, -2.0, 3.0, 4.0, 0.5], np.float32)
IDX_B = np.array([[0, 2, 3], [2, 2, 1]], np.int64)
VALS_B = np.array([10.0, 20.0, -4.0], np.float32)
SHAPE = [4, 5]


def _coo(idx=IDX, vals=VALS, shape=SHAPE):
    return (jsparse.sparse_coo_tensor(paddle.to_tensor(idx),
                                      paddle.to_tensor(vals), shape),
            tsparse.sparse_coo_tensor(ptt.to_tensor(idx),
                                      ptt.to_tensor(vals), shape))


def _same_sparse(got, want):
    assert got.shape == want.shape and type(got).__name__ == \
        type(want).__name__
    np.testing.assert_allclose(_np(got.to_dense()), _np(want.to_dense()),
                               rtol=1e-6)


def test_coo_surface_matches_jax():
    j, t = _coo()
    assert t.nnz() == j.nnz() == 5
    np.testing.assert_array_equal(_np(t.indices()), _np(j.indices()))
    assert _np(t.indices()).dtype == np.int32
    np.testing.assert_array_equal(_np(t.values()), _np(j.values()))
    _same_sparse(t, j)
    jc, tc = j.coalesce(), t.coalesce()
    assert tc.nnz() == jc.nnz() == 4
    np.testing.assert_array_equal(_np(tc.indices()), _np(jc.indices()))
    np.testing.assert_array_equal(_np(tc.values()), _np(jc.values()))
    np.testing.assert_array_equal(t.numpy(), j.numpy())
    assert t.is_sparse_coo() and not t.is_sparse_csr()
    assert tsparse.sparse_coo_tensor(ptt.to_tensor(IDX),
                                     ptt.to_tensor(VALS)).shape == [4, 4]
    assert t.astype('float64').dtype == torch.float64


def test_csr_surface_matches_jax():
    j, t = _coo()
    jc, tc = j.to_sparse_csr(), t.to_sparse_csr()
    for name in ('crows', 'cols', 'values'):
        np.testing.assert_array_equal(_np(getattr(tc, name)()),
                                      _np(getattr(jc, name)()))
    _same_sparse(tc, jc)
    _same_sparse(tc.to_sparse_coo(), jc.to_sparse_coo())
    crows, cols, vals = (np.array([0, 2, 3, 3]), np.array([1, 3, 0]),
                         np.array([1.0, 2.0, 3.0], np.float32))
    jm = jsparse.sparse_csr_tensor(crows, cols, vals, [3, 4])
    tm = tsparse.sparse_csr_tensor(crows, cols, vals, [3, 4])
    _same_sparse(tm, jm)
    assert tm.nnz() == 3 and tm.is_sparse_csr()


@pytest.mark.parametrize('op', ['add', 'subtract', 'multiply'])
def test_sparse_binary_matches_jax(op):
    ja, ta = _coo()
    jb, tb = _coo(IDX_B, VALS_B)
    _same_sparse(getattr(tsparse, op)(ta, tb), getattr(jsparse, op)(ja, jb))
    if op == 'multiply':
        _same_sparse(tsparse.multiply(ta, 2.5), jsparse.multiply(ja, 2.5))
    assert tsparse.is_same_shape(ta, tb)
    with pytest.raises(ValueError):
        getattr(tsparse, 'add')(ta, _coo(shape=[4, 6])[1])


def test_sparse_matmul_and_masked_matmul_match_jax():
    j, t = _coo()
    y = _RNG.standard_normal((5, 3)).astype(np.float32)
    _close(tsparse.matmul(t, ptt.to_tensor(y)),
           jsparse.matmul(j, paddle.to_tensor(y)))
    _close(t @ ptt.to_tensor(y), j @ paddle.to_tensor(y))
    a = _RNG.standard_normal((4, 6)).astype(np.float32)
    b = _RNG.standard_normal((6, 5)).astype(np.float32)
    _same_sparse(tsparse.masked_matmul(ptt.to_tensor(a), ptt.to_tensor(b),
                                       t),
                 jsparse.masked_matmul(paddle.to_tensor(a),
                                       paddle.to_tensor(b), j))


@pytest.mark.parametrize('op', ['relu', 'tanh', 'sqrt', 'sin', 'abs', 'neg'])
@pytest.mark.parametrize('layout', ['coo', 'csr'])
def test_sparse_unary_matches_jax(op, layout):
    j, t = _coo(vals=np.abs(VALS) if op == 'sqrt' else VALS)
    if layout == 'csr':
        j, t = j.to_sparse_csr(), t.to_sparse_csr()
    _same_sparse(getattr(tsparse, op)(t), getattr(jsparse, op)(j))


def test_sparse_pow_cast_transpose_and_relu_layer_match_jax():
    j, t = _coo()
    _same_sparse(tsparse.pow(t, 2), jsparse.pow(j, 2))
    c = tsparse.cast(t, index_dtype='int64', value_dtype='float64')
    assert c.indices().dtype == torch.int64 and c.dtype == torch.float64
    _same_sparse(tsparse.transpose(t, [1, 0]), jsparse.transpose(j, [1, 0]))
    _same_sparse(t.t(), j.t())
    _same_sparse(tsparse.nn.ReLU()(t), jsparse.nn.ReLU()(j))


def test_sparse_index_bound_matches_jax():
    """Dimensions past the int32 index space raise in both packages."""
    big = [2 ** 31, 4]
    for pkg, mk in ((jsparse, paddle.to_tensor), (tsparse, ptt.to_tensor)):
        with pytest.raises(ValueError, match='int32'):
            pkg.sparse_coo_tensor(mk(IDX), mk(VALS), big)
        with pytest.raises(ValueError, match='int32'):
            pkg.sparse_csr_tensor(np.array([0, 1]), np.array([0]),
                                  np.array([1.0], np.float32), big)
