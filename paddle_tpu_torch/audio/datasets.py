"""paddle.audio.datasets (a copy of `paddle_tpu/audio/datasets.py`;
upstream: python/paddle/audio/datasets/): offline build, so synthetic
deterministic stand-ins with real shapes, the same seeds and sizes as
the JAX package's (see vision.datasets for the pattern). Samples are
host arrays; a feature type runs its layer on the current place.
"""
from __future__ import annotations

import numpy as np

from ..io import Dataset

__all__ = ['TESS', 'ESC50']


class _SyntheticAudio(Dataset):
    """Class-dependent tones + noise so classifiers can fit."""

    def __init__(self, n, num_classes, sample_rate, duration, feat_type='raw',
                 seed=0, **feat_kwargs):
        rng = np.random.RandomState(seed)
        t = np.arange(int(sample_rate * duration)) / sample_rate
        self.labels = rng.randint(0, num_classes, n).astype(np.int64)
        freqs = 220.0 * (2.0 ** (np.arange(num_classes) / 2.0))
        sig = np.sin(2 * np.pi * freqs[self.labels][:, None] * t[None, :])
        self.waveforms = (sig + 0.05 * rng.randn(n, t.size)) \
            .astype(np.float32)
        self.feat_type = feat_type
        self.feat_kwargs = feat_kwargs

    def _features(self, wav):
        if self.feat_type == 'raw':
            return wav
        from ..ops.creation import to_tensor
        from . import features as feat_layers
        layer = {'spectrogram': feat_layers.Spectrogram,
                 'melspectrogram': feat_layers.MelSpectrogram,
                 'logmelspectrogram': feat_layers.LogMelSpectrogram,
                 'mfcc': feat_layers.MFCC}[self.feat_type](**self.feat_kwargs)
        return layer(to_tensor(wav[None, :])).numpy()[0]

    def __getitem__(self, i):
        return self._features(self.waveforms[i]), self.labels[i]

    def __len__(self):
        return len(self.waveforms)


class TESS(_SyntheticAudio):
    """Toronto emotional speech set surface (7 emotion classes)."""

    def __init__(self, mode='train', n_folds=5, split=1, feat_type='raw',
                 archive=None, **kwargs):
        if archive is not None:
            raise RuntimeError('offline build: archives unavailable; '
                               'the synthetic stand-in is used instead')
        n = 200 if mode == 'train' else 50
        super().__init__(n, 7, 16000, 0.5, feat_type,
                         seed=0 if mode == 'train' else 1, **kwargs)


class ESC50(_SyntheticAudio):
    """ESC-50 environmental sounds surface (50 classes)."""

    def __init__(self, mode='train', split=1, feat_type='raw', archive=None,
                 **kwargs):
        if archive is not None:
            raise RuntimeError('offline build: archives unavailable; '
                               'the synthetic stand-in is used instead')
        n = 400 if mode == 'train' else 100
        super().__init__(n, 50, 16000, 0.5, feat_type,
                         seed=0 if mode == 'train' else 1, **kwargs)
