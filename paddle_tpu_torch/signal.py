"""paddle.signal (counterpart of `paddle_tpu/signal.py`): `frame`,
`overlap_add`, `stft` and `istft` built on frame extraction and
`torch.fft`, each an op through `tensor.apply_op` (differentiable). The
same framing, padding, window and envelope as the JAX package's, so
that both give one result; not `torch.stft`."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from .ops._helpers import defop

__all__ = ['stft', 'istft', 'frame', 'overlap_add']

# jnp.pad's mode names, as torch's F.pad calls them
_PAD_MODES = {'reflect': 'reflect', 'constant': 'constant',
              'edge': 'replicate', 'replicate': 'replicate',
              'wrap': 'circular', 'circular': 'circular'}


def _starts(num: int, hop: int, length: int, device) -> torch.Tensor:
    """[num, length] sample indices of `num` frames `hop` apart."""
    return (torch.arange(num, device=device)[:, None] * hop
            + torch.arange(length, device=device)[None, :])


def frame(x, frame_length, hop_length, axis=-1, name=None):
    """Slice overlapping frames along `axis` (the last): [..., n] ->
    [..., frame_length, num_frames]."""
    def f(v):
        if axis not in (-1, v.dim() - 1):
            raise NotImplementedError('frame supports the last axis only')
        num = 1 + (v.shape[-1] - frame_length) // hop_length
        return v[..., _starts(num, hop_length, frame_length, v.device).t()]
    return defop(f, name='frame')(x)


def overlap_add(x, hop_length, axis=-1, name=None):
    """Inverse of frame: sum overlapping [..., frame_length, num_frames]
    back to a signal."""
    def f(v):
        fl, num = v.shape[-2], v.shape[-1]
        out_len = fl + hop_length * (num - 1)
        idx = _starts(num, hop_length, fl, v.device).t().reshape(-1)
        flat = v.reshape(v.shape[:-2] + (-1,))
        out = v.new_zeros(v.shape[:-2] + (out_len,))
        return out.index_add(-1, idx, flat)
    return defop(f, name='overlap_add')(x)


def _padded_window(win, wl: int, n_fft: int):
    if wl < n_fft:                  # centre-pad the window to n_fft
        lp = (n_fft - wl) // 2
        win = TF.pad(win, (lp, n_fft - wl - lp))
    return win


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode='reflect', normalized=False,
         onesided=True, name=None):
    """Short-time Fourier transform ([B, T] -> [B, n_fft//2+1, frames]
    complex, as paddle.signal.stft)."""
    hop = hop_length or n_fft // 4
    wl = win_length or n_fft

    def f(v, *w):
        win = w[0] if w else torch.ones(wl, dtype=v.dtype, device=v.device)
        win = _padded_window(win, wl, n_fft)
        sig = v
        if center:
            lead = sig.shape[:-1]
            sig = TF.pad(sig.reshape(-1, 1, sig.shape[-1]),
                         (n_fft // 2, n_fft // 2),
                         mode=_PAD_MODES[pad_mode]).reshape(*lead, -1)
        num = 1 + (sig.shape[-1] - n_fft) // hop
        frames = sig[..., _starts(num, hop, n_fft, v.device)] * win
        spec = (torch.fft.rfft(frames, dim=-1) if onesided
                else torch.fft.fft(frames, dim=-1))
        if normalized:
            spec = spec / math.sqrt(n_fft)
        return spec.transpose(-1, -2)           # [..., freq, frames]
    args = (x,) if window is None else (x, window)
    return defop(f, name='stft')(*args)


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """Inverse STFT with window-envelope normalization (as
    paddle.signal.istft for windows that satisfy COLA)."""
    hop = hop_length or n_fft // 4
    wl = win_length or n_fft

    def f(v, *w):
        win = w[0] if w else torch.ones(wl, dtype=torch.float32,
                                        device=v.device)
        win = _padded_window(win, wl, n_fft)
        spec = v.transpose(-1, -2)              # [..., frames, freq]
        if normalized:
            spec = spec * math.sqrt(n_fft)
        frames = (torch.fft.irfft(spec, n=n_fft, dim=-1) if onesided
                  else torch.fft.ifft(spec, dim=-1).real)
        frames = frames * win
        num = frames.shape[-2]
        out_len = n_fft + hop * (num - 1)
        idx = _starts(num, hop, n_fft, v.device).reshape(-1)
        sig = frames.new_zeros(frames.shape[:-2] + (out_len,)).index_add(
            -1, idx, frames.reshape(frames.shape[:-2] + (-1,)))
        env = frames.new_zeros(out_len).index_add(
            0, idx, (win * win).to(frames.dtype).repeat(num))
        sig = sig / torch.clamp(env, min=1e-10)
        if center:
            sig = sig[..., n_fft // 2:]
            if length is None:
                sig = sig[..., :sig.shape[-1] - n_fft // 2]
        if length is not None:
            sig = sig[..., :length]
        return sig
    args = (x,) if window is None else (x, window)
    return defop(f, name='istft')(*args)
