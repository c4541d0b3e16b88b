"""`audio` of the port against the JAX package's, on the CPU.

The same seeded numpy clips (1 s at 16 kHz) go through both packages:
windows, mel scales, filterbanks and the DCT basis (host numpy in both,
so equal to f32 rounding), `power_to_db` (its top_db clip takes the peak
of the whole tensor, not of each example), the four feature layers with
their buffers carried across by `state_dict` name (rtol 1e-5, atol 1e-5
of the output's scale), the WAV backend both ways, and the synthetic
datasets (the same seeds, so the same waveforms and labels).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu import audio as jaudio
from paddle_tpu.audio import features as jfeat
from paddle_tpu.audio import functional as jAF
from paddle_tpu_torch import audio as taudio
from paddle_tpu_torch.audio import features as tfeat
from paddle_tpu_torch.audio import functional as tAF
from paddle_tpu_torch.weights import from_jax_state

TOL = 1e-5
SR = 16000


@pytest.fixture(autouse=True, scope='module')
def _cpu_place():
    ptt.set_device('cpu')
    yield
    ptt.set_device('gpu')


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x.numpy()) if hasattr(x, 'numpy') else np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = np.asarray(_np(got), np.float64), np.asarray(_np(want),
                                                             np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _clips(seed, b=2, seconds=1.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    tone = np.sin(2 * np.pi * rng.uniform(200, 2000, (b, 1)) * t[None, :])
    return (tone + 0.1 * rng.standard_normal((b, t.size))).astype(
        np.float32)


WINDOWS = ['hann', 'hamming', 'blackman', 'bartlett', 'bohman', 'rect',
           ('gaussian', 3.0), ('exponential', 2.0), 'triang', 'cosine',
           'taylor']


@pytest.mark.parametrize('window', WINDOWS, ids=str)
@pytest.mark.parametrize('fftbins', [True, False])
def test_windows_match_jax(window, fftbins):
    for n in (7, 16):
        got = tAF.get_window(window, n, fftbins=fftbins, dtype='float32')
        want = jAF.get_window(window, n, fftbins=fftbins, dtype='float32')
        _close(got, want)
        assert got.dtype == torch.float32
    with pytest.raises(ValueError, match='unsupported window'):
        tAF.get_window('kaiser', 8)


@pytest.mark.parametrize('htk', [False, True])
def test_mel_scale_and_filterbank_match_jax(htk):
    freqs = np.array([0.0, 440.0, 999.0, 1000.0, 4000.0, 8000.0])
    assert tAF.hz_to_mel(1500.0, htk) == pytest.approx(
        jAF.hz_to_mel(1500.0, htk), rel=1e-12)
    assert tAF.mel_to_hz(20.0, htk) == pytest.approx(
        jAF.mel_to_hz(20.0, htk), rel=1e-12)
    _close(tAF.hz_to_mel(ptt.to_tensor(freqs, dtype='float64'), htk),
           jAF.hz_to_mel(paddle.to_tensor(freqs), htk))
    mels = np.linspace(0.0, 40.0, 9)
    _close(tAF.mel_to_hz(ptt.to_tensor(mels, dtype='float64'), htk),
           jAF.mel_to_hz(paddle.to_tensor(mels), htk))
    _close(tAF.mel_frequencies(20, 30.0, 7000.0, htk),
           jAF.mel_frequencies(20, 30.0, 7000.0, htk))
    _close(tAF.fft_frequencies(SR, 512), jAF.fft_frequencies(SR, 512))
    for norm in ('slaney', None):
        got = tAF.compute_fbank_matrix(SR, 512, 40, 50.0, None, htk, norm)
        want = jAF.compute_fbank_matrix(SR, 512, 40, 50.0, None, htk, norm)
        _close(got, want)
        assert tuple(got.shape) == (40, 257)


@pytest.mark.parametrize('norm', ['ortho', None])
def test_dct_matches_jax(norm):
    _close(tAF.create_dct(13, 40, norm), jAF.create_dct(13, 40, norm))


@pytest.mark.parametrize('top_db', [None, 80.0, 10.0])
def test_power_to_db_clips_at_the_peak_of_the_whole_tensor(top_db):
    rng = np.random.default_rng(1)
    spec = (rng.uniform(0.0, 1.0, (2, 5, 7)) ** 4).astype(np.float32)
    spec[1] *= 1e-3                 # the second example's peak is lower
    got = tAF.power_to_db(ptt.to_tensor(spec), 2.0, 1e-10, top_db)
    want = jAF.power_to_db(paddle.to_tensor(spec), 2.0, 1e-10, top_db)
    _close(got, want)
    if top_db is not None:
        floor = _np(got).max() - top_db
        assert np.isclose(_np(got)[1].min(), floor, atol=1e-4)


def _feature_pair(name, **kw):
    jl = getattr(jfeat, name)(**kw)
    tl = getattr(tfeat, name)(**kw)
    jstate = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert sorted(jstate) == sorted(tl.state_dict())
    for k, v in jstate.items():
        _close(tl.state_dict()[k], v)
    return jl, from_jax_state(jstate, tl)


FEATURES = [
    ('Spectrogram', dict(n_fft=512, hop_length=160)),
    ('Spectrogram', dict(n_fft=400, win_length=300, power=1.0,
                         window='hamming')),
    ('MelSpectrogram', dict(sr=SR, n_fft=512, hop_length=160, n_mels=40)),
    ('LogMelSpectrogram', dict(sr=SR, n_fft=512, hop_length=160, n_mels=40)),
    ('LogMelSpectrogram', dict(sr=SR, n_fft=512, n_mels=40, top_db=80.0,
                               htk=True)),
    ('MFCC', dict(sr=SR, n_mfcc=20, n_fft=512, hop_length=160, n_mels=40)),
]


@pytest.mark.parametrize('case', FEATURES,
                         ids=[f'{c[0]}-{i}' for i, c in enumerate(FEATURES)])
def test_feature_layers_match_jax(case):
    name, kw = case
    jl, tl = _feature_pair(name, **kw)
    x = _clips(len(kw))
    got = tl(ptt.to_tensor(x))
    want = jl(paddle.to_tensor(x))
    _close(got, want)


def test_feature_layers_are_differentiable():
    _, tl = _feature_pair('MFCC', sr=SR, n_mfcc=13, n_fft=256, n_mels=32)
    x = ptt.to_tensor(_clips(3, b=1, seconds=0.25))
    x.stop_gradient = False
    (g,) = ptt.grad(tl(x).sum(), [x])
    assert np.isfinite(_np(g)).all() and float(np.abs(_np(g)).sum()) > 0


def test_wav_backend_crosses_both_ways(tmp_path):
    x = np.clip(_clips(4, b=2, seconds=0.1) * 0.5, -1, 1)
    taudio.save(str(tmp_path / 't.wav'), ptt.to_tensor(x), SR)
    jaudio.save(str(tmp_path / 'j.wav'), paddle.to_tensor(x), SR)
    with open(tmp_path / 't.wav', 'rb') as a, \
            open(tmp_path / 'j.wav', 'rb') as b:
        assert a.read() == b.read()
    tw, tsr = taudio.load(str(tmp_path / 'j.wav'))
    jw, jsr = jaudio.load(str(tmp_path / 't.wav'))
    assert tsr == jsr == SR
    np.testing.assert_array_equal(_np(tw), _np(jw))
    np.testing.assert_allclose(_np(tw), x, atol=1.0 / 16384)
    part, _ = taudio.load(str(tmp_path / 't.wav'), frame_offset=10,
                          num_frames=20, channels_first=False)
    np.testing.assert_array_equal(_np(part), _np(tw).T[10:30])
    with pytest.raises(NotImplementedError):
        taudio.save(str(tmp_path / 'x.wav'), x, SR, bits_per_sample=24)


@pytest.mark.parametrize('cls', ['TESS', 'ESC50'])
def test_synthetic_datasets_match_jax(cls):
    for mode in ('train', 'dev'):
        t = getattr(taudio.datasets, cls)(mode=mode)
        j = getattr(jaudio.datasets, cls)(mode=mode)
        assert len(t) == len(j)
        np.testing.assert_array_equal(t.waveforms, j.waveforms)
        np.testing.assert_array_equal(t.labels, j.labels)
    kw = dict(feat_type='logmelspectrogram', sr=16000, n_fft=256,
              n_mels=32)
    t = getattr(taudio.datasets, cls)(mode='dev', **kw)
    j = getattr(jaudio.datasets, cls)(mode='dev', **kw)
    (tf, tl), (jf, jl) = t[3], j[3]
    assert tl == jl
    _close(tf, jf)
    with pytest.raises(RuntimeError, match='offline'):
        getattr(taudio.datasets, cls)(archive='x.zip')
