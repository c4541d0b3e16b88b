"""paddle.audio.functional (counterpart of `paddle_tpu/audio/functional.py`;
upstream: python/paddle/audio/functional/{window.py, functional.py}):
windows, mel filterbanks, the DCT basis (numpy on the host, returned as
Tensors on the current place) and `power_to_db`, an op on torch tensors
through `tensor.apply_op` (differentiable).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import framework
from ..ops._helpers import defop
from ..tensor import Tensor

__all__ = ['get_window', 'hz_to_mel', 'mel_to_hz', 'mel_frequencies',
           'fft_frequencies', 'compute_fbank_matrix', 'power_to_db',
           'create_dct']


def _tensor(arr: np.ndarray) -> Tensor:
    """A host array as a Tensor on the current place, its dtype kept."""
    return Tensor(torch.as_tensor(np.ascontiguousarray(arr),
                                  device=framework.current_device()))


def _window_values(window, n, fftbins, dtype):
    if isinstance(window, (tuple, list)):
        window, *params = window
    else:
        params = []
    # periodic ("fftbins") windows are length-(n+1) symmetric windows
    # with the last sample dropped
    m = n + 1 if fftbins else n
    k = np.arange(m, dtype=np.float64)
    if window in ('hann', 'hanning'):
        w = 0.5 - 0.5 * np.cos(2 * math.pi * k / (m - 1))
    elif window == 'hamming':
        w = 0.54 - 0.46 * np.cos(2 * math.pi * k / (m - 1))
    elif window == 'blackman':
        w = (0.42 - 0.5 * np.cos(2 * math.pi * k / (m - 1))
             + 0.08 * np.cos(4 * math.pi * k / (m - 1)))
    elif window == 'bartlett':
        w = 1.0 - np.abs(2 * k / (m - 1) - 1.0)
    elif window == 'bohman':
        x = np.abs(2 * k / (m - 1) - 1.0)
        w = (1 - x) * np.cos(math.pi * x) + np.sin(math.pi * x) / math.pi
    elif window in ('rect', 'boxcar', 'ones'):
        w = np.ones(m)
    elif window == 'gaussian':
        std = params[0] if params else 7.0
        x = k - (m - 1) / 2.0
        w = np.exp(-0.5 * (x / std) ** 2)
    elif window == 'exponential':
        tau = params[0] if params else 1.0
        x = np.abs(k - (m - 1) / 2.0)
        w = np.exp(-x / tau)
    elif window == 'triang':
        x = np.abs(2 * k - (m - 1))
        w = 1.0 - x / (m + (m % 2))
    elif window == 'cosine':
        w = np.sin(math.pi * (k + 0.5) / m)
    elif window == 'taylor':
        # 4-term Taylor window with 30 dB sidelobe level (scipy default)
        nbar, sll = 4, 30.0
        b = 10 ** (sll / 20)
        a = np.arccosh(np.asarray(b, np.float64)) / math.pi
        s2 = nbar ** 2 / (a ** 2 + (nbar - 0.5) ** 2)
        ma = np.arange(1, nbar, dtype=np.float64)
        num = np.stack([
            np.prod(1 - (mi ** 2 / s2) / (a ** 2 + (ma - 0.5) ** 2))
            for mi in ma])
        den = np.stack([
            np.prod(np.where(ma != mi, 1 - mi ** 2 / ma ** 2, 1.0))
            for mi in ma])
        fm = num / den
        x = (k - (m - 1) / 2.0) / m
        w = 1 + 2 * np.sum(
            fm[:, None] * np.cos(2 * math.pi * ma[:, None] * x[None, :]),
            axis=0)
        w = w / np.max(w)
    else:
        raise ValueError(f'unsupported window {window!r}')
    if fftbins:
        w = w[:-1]
    return w.astype(dtype)


def get_window(window, win_length, fftbins=True, dtype='float64'):
    """Window of `win_length` samples (paddle.audio.functional.get_window)."""
    return _tensor(_window_values(window, int(win_length), fftbins,
                                  np.dtype(dtype)))


_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = 1000.0 / (200.0 / 3)
_LOGSTEP = math.log(6.4) / 27.0


def _hz_to_mel(f: np.ndarray, htk: bool) -> np.ndarray:
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, log above
    mel = (f - 0.0) / (200.0 / 3)
    return np.where(f >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10)
                                          / _MIN_LOG_HZ) / _LOGSTEP, mel)


def _mel_to_hz(m: np.ndarray, htk: bool) -> np.ndarray:
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f = (200.0 / 3) * m
    return np.where(m >= _MIN_LOG_MEL,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), f)


def _convert(fn, value, htk):
    """`fn` over a scalar (a float back) or a Tensor (a float64 Tensor
    back)."""
    if isinstance(value, Tensor):
        return _tensor(fn(np.asarray(value.numpy(), np.float64), htk))
    return float(fn(np.asarray(value, np.float64), htk))


def hz_to_mel(freq, htk=False):
    return _convert(_hz_to_mel, freq, htk)


def mel_to_hz(mel, htk=False):
    return _convert(_mel_to_hz, mel, htk)


def _mel_frequencies(n_mels, f_min, f_max, htk) -> np.ndarray:
    lo = float(_hz_to_mel(np.asarray(f_min, np.float64), htk))
    hi = float(_hz_to_mel(np.asarray(f_max, np.float64), htk))
    return _mel_to_hz(np.linspace(lo, hi, n_mels), htk)


def mel_frequencies(n_mels=64, f_min=0.0, f_max=11025.0, htk=False,
                    dtype='float32'):
    return _tensor(_mel_frequencies(n_mels, f_min, f_max, htk)
                   .astype(np.dtype(dtype)))


def fft_frequencies(sr, n_fft, dtype='float32'):
    return _tensor(np.linspace(0, sr / 2, 1 + n_fft // 2,
                               dtype=np.dtype(dtype)))


def _fbank_values(sr, n_fft, n_mels, f_min, f_max, htk, norm, dtype):
    f_max = f_max or sr / 2.0
    fft_f = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_f = _mel_frequencies(n_mels + 2, f_min, f_max, htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_f[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    if norm == 'slaney':
        enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
        weights = weights * enorm[:, None]
    return weights.astype(np.dtype(dtype))


def compute_fbank_matrix(sr, n_fft, n_mels=64, f_min=0.0, f_max=None,
                         htk=False, norm='slaney', dtype='float32'):
    """Triangular mel filterbank [n_mels, 1 + n_fft//2] (matches
    paddle.audio.functional.compute_fbank_matrix / librosa.filters.mel)."""
    return _tensor(_fbank_values(sr, n_fft, n_mels, f_min, f_max, htk, norm,
                                 dtype))


def power_to_db(spect, ref_value=1.0, amin=1e-10, top_db=80.0):
    """10*log10(spect/ref) clipped to top_db below the peak of the whole
    tensor (not per example, as upstream). An op on the tape: it runs
    inside LogMelSpectrogram.forward."""
    def f(x):
        db = 10.0 * torch.log10(torch.clamp(x, min=amin))
        db = db - 10.0 * math.log10(max(amin, ref_value))
        if top_db is not None:
            db = torch.maximum(db, db.max() - top_db)
        return db
    return defop(f, name='power_to_db')(spect)


def _dct_values(n_mfcc, n_mels, norm, dtype):
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)
    basis = np.cos(math.pi / n_mels * (n[:, None] + 0.5) * k[None, :])
    if norm == 'ortho':
        scale = np.full((n_mfcc,), math.sqrt(2.0 / n_mels))
        scale[0] = math.sqrt(1.0 / n_mels)
        basis = basis * scale[None, :]
    else:
        basis = basis * 2.0
    return basis.astype(np.dtype(dtype))


def create_dct(n_mfcc, n_mels, norm='ortho', dtype='float32'):
    """DCT-II basis [n_mels, n_mfcc] (paddle.audio.functional.create_dct)."""
    return _tensor(_dct_values(n_mfcc, n_mels, norm, dtype))
