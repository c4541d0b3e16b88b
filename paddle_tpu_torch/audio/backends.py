"""paddle.audio.{load,save} via the stdlib `wave` module (a copy of
`paddle_tpu/audio/backends.py`; 16-bit PCM WAV; upstream:
python/paddle/audio/backends/ delegating to soundfile, which is not a
dependency here, so WAV is the supported container). `load` returns its
waveform on the current place.
"""
from __future__ import annotations

import wave

import numpy as np
import torch

from .. import framework
from ..tensor import Tensor

__all__ = ['load', 'save']


def load(filepath, frame_offset=0, num_frames=-1, normalize=True,
         channels_first=True):
    """Returns (waveform Tensor [C, T] (channels_first) float32 in [-1, 1],
    sample_rate)."""
    with wave.open(str(filepath), 'rb') as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        w.setpos(frame_offset)
        count = n - frame_offset if num_frames < 0 else num_frames
        raw = w.readframes(count)
    if width != 2:
        raise NotImplementedError('only 16-bit PCM WAV is supported')
    data = np.frombuffer(raw, dtype='<i2').reshape(-1, ch)
    out = data.astype(np.float32) / 32768.0 if normalize \
        else data.astype(np.float32)
    out = out.T if channels_first else out
    return Tensor(torch.as_tensor(np.ascontiguousarray(out),
                                  device=framework.current_device())), sr


def save(filepath, src, sample_rate, channels_first=True, bits_per_sample=16):
    if bits_per_sample != 16:
        raise NotImplementedError('only 16-bit PCM WAV is supported')
    if isinstance(src, Tensor):
        data = src.numpy()
    elif isinstance(src, torch.Tensor):
        data = src.detach().cpu().numpy()
    else:
        data = np.asarray(src)
    if data.ndim == 1:
        data = data[None, :]
    if channels_first:
        data = data.T  # -> [T, C]
    pcm = np.clip(data, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype('<i2')
    with wave.open(str(filepath), 'wb') as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(pcm.tobytes())
