"""paddle.audio.features (counterpart of `paddle_tpu/audio/features.py`;
upstream: python/paddle/audio/features/layers.py): Spectrogram,
MelSpectrogram, LogMelSpectrogram and MFCC as nn.Layers over the port's
`signal.stft` and the functional filterbanks (differentiable). The
buffers keep the JAX package's names (`window`, `fbank_matrix`,
`dct_matrix`), so the two packages' `state_dict` keys match.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import framework, signal
from ..nn.layer import Layer
from . import functional as AF

__all__ = ['Spectrogram', 'MelSpectrogram', 'LogMelSpectrogram', 'MFCC']


def _buffer(arr: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(arr, device=framework.current_device())


class Spectrogram(Layer):
    def __init__(self, n_fft=512, hop_length=None, win_length=None,
                 window='hann', power=2.0, center=True, pad_mode='reflect',
                 dtype='float32'):
        super().__init__()
        self.n_fft, self.power, self.center = n_fft, power, center
        self.hop_length = hop_length or n_fft // 4
        self.win_length = win_length or n_fft
        self.pad_mode = pad_mode
        self.register_buffer('window', _buffer(AF._window_values(
            window, self.win_length, True, np.dtype(dtype))))

    def forward(self, x):
        spec = signal.stft(x, self.n_fft, self.hop_length, self.win_length,
                           window=self.window, center=self.center,
                           pad_mode=self.pad_mode)
        mag = spec.abs()
        return mag.pow(self.power) if self.power != 1.0 else mag


class MelSpectrogram(Layer):
    def __init__(self, sr=22050, n_fft=512, hop_length=None, win_length=None,
                 window='hann', power=2.0, center=True, pad_mode='reflect',
                 n_mels=64, f_min=50.0, f_max=None, htk=False, norm='slaney',
                 dtype='float32'):
        super().__init__()
        self._spectrogram = Spectrogram(n_fft, hop_length, win_length, window,
                                        power, center, pad_mode, dtype)
        self.n_mels = n_mels
        self.register_buffer('fbank_matrix', _buffer(AF._fbank_values(
            sr, n_fft, n_mels, f_min, f_max, htk, norm, dtype)))

    def forward(self, x):
        spec = self._spectrogram(x)  # [..., freq, frames]
        return self.fbank_matrix @ spec


class LogMelSpectrogram(Layer):
    def __init__(self, sr=22050, n_fft=512, hop_length=None, win_length=None,
                 window='hann', power=2.0, center=True, pad_mode='reflect',
                 n_mels=64, f_min=50.0, f_max=None, htk=False, norm='slaney',
                 ref_value=1.0, amin=1e-10, top_db=None, dtype='float32'):
        super().__init__()
        self._melspectrogram = MelSpectrogram(
            sr, n_fft, hop_length, win_length, window, power, center,
            pad_mode, n_mels, f_min, f_max, htk, norm, dtype)
        self.ref_value, self.amin, self.top_db = ref_value, amin, top_db

    def forward(self, x):
        return AF.power_to_db(self._melspectrogram(x), self.ref_value,
                              self.amin, self.top_db)


class MFCC(Layer):
    def __init__(self, sr=22050, n_mfcc=40, n_fft=512, hop_length=None,
                 win_length=None, window='hann', power=2.0, center=True,
                 pad_mode='reflect', n_mels=64, f_min=50.0, f_max=None,
                 htk=False, norm='slaney', ref_value=1.0, amin=1e-10,
                 top_db=None, dtype='float32'):
        super().__init__()
        self._log_melspectrogram = LogMelSpectrogram(
            sr, n_fft, hop_length, win_length, window, power, center,
            pad_mode, n_mels, f_min, f_max, htk, norm, ref_value, amin,
            top_db, dtype)
        self.register_buffer('dct_matrix', _buffer(AF._dct_values(
            n_mfcc, n_mels, 'ortho', dtype)))

    def forward(self, x):
        logmel = self._log_melspectrogram(x)  # [B, n_mels, frames]
        return (logmel.transpose(1, 2) @ self.dct_matrix).transpose(1, 2)
