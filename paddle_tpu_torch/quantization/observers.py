"""Activation observers and calibration (counterpart of
`paddle_tpu/quantization/observers.py`; upstream:
python/paddle/quantization/observers/): AbsmaxObserver,
AbsmaxChannelObserver, AVGObserver, EMAObserver, HistObserver,
KLObserver, MSEObserver.

Observers run during eager calibration passes and keep their statistics
on the host in numpy, as the JAX package's do (the same arithmetic, so
the same scales); the deployed artifact is a per-tensor fp32 activation
scale baked into `QuantedLinear`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..nn.layer import Layer
from ..tensor import to_torch


def _host(x) -> np.ndarray:
    """An observed activation as an f32 numpy array."""
    v = to_torch(x)
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)

__all__ = ['BaseObserver', 'AbsmaxObserver', 'AbsmaxChannelObserver',
           'AVGObserver', 'HistObserver', 'KLObserver', 'MSEObserver',
           'EMAObserver']

_QMAX = 127.0


class BaseObserver(Layer):
    """Records activation statistics during calibration; `scales()`
    yields the per-tensor quantization scale (absmax / 127 semantics)."""

    def __init__(self, quant_bits: int = 8):
        super().__init__()
        self.qmax = float(2 ** (quant_bits - 1) - 1)
        self._seen = False

    def forward(self, x):
        self._observe(_host(x))
        self._seen = True
        return x

    def _observe(self, a: np.ndarray):
        raise NotImplementedError

    def _absmax(self) -> float:
        raise NotImplementedError

    def scales(self) -> float:
        if not self._seen:
            raise RuntimeError(
                f'{type(self).__name__} has seen no calibration data')
        amax = float(self._absmax())
        return amax / self.qmax if amax > 0 else 1.0


class AbsmaxObserver(BaseObserver):
    """Running max of |x| (upstream observers/abs_max.py)."""

    def __init__(self, quant_bits: int = 8):
        super().__init__(quant_bits)
        self._max = 0.0

    def _observe(self, a):
        self._max = max(self._max, float(np.max(np.abs(a))))

    def _absmax(self):
        return self._max


class AbsmaxChannelObserver(BaseObserver):
    """Per-CHANNEL running absmax (upstream analogue:
    abs_max_channel_wise weight semantics, applied to activations):
    tracks max |x| over every axis EXCEPT `channel_axis`, and `scales()`
    returns an ARRAY of per-channel scales instead of a float.

    Observing a [page_size, H, D] page slab with channel_axis=1 yields
    the per-head scales `quantization.kv_page_scales` computes for the
    paged KV pool's int8 pages."""

    def __init__(self, quant_bits: int = 8, channel_axis: int = -1):
        super().__init__(quant_bits)
        self.channel_axis = int(channel_axis)
        self._max = None

    def _observe(self, a):
        ax = self.channel_axis % a.ndim
        reduce_axes = tuple(i for i in range(a.ndim) if i != ax)
        m = np.max(np.abs(a), axis=reduce_axes)
        self._max = m if self._max is None else np.maximum(self._max, m)

    def _absmax(self):
        return self._max

    def scales(self) -> np.ndarray:
        if not self._seen:
            raise RuntimeError(
                f'{type(self).__name__} has seen no calibration data')
        amax = np.asarray(self._absmax(), np.float32)
        return np.where(amax > 0, amax / self.qmax,
                        1.0).astype(np.float32)


class AVGObserver(BaseObserver):
    """Mean of per-batch absmax (upstream observers/avg.py) — robust to
    a single outlier batch."""

    def __init__(self, quant_bits: int = 8):
        super().__init__(quant_bits)
        self._sum = 0.0
        self._n = 0

    def _observe(self, a):
        self._sum += float(np.max(np.abs(a)))
        self._n += 1

    def _absmax(self):
        return self._sum / max(self._n, 1)


class EMAObserver(BaseObserver):
    """Exponential moving average of per-batch absmax."""

    def __init__(self, quant_bits: int = 8, momentum: float = 0.9):
        super().__init__(quant_bits)
        self.momentum = momentum
        self._ema = None

    def _observe(self, a):
        m = float(np.max(np.abs(a)))
        self._ema = m if self._ema is None \
            else self.momentum * self._ema + (1 - self.momentum) * m

    def _absmax(self):
        return self._ema


class _HistogramMixin(BaseObserver):
    """Shared |x| histogram with growable range (rebinning on overflow)."""

    def __init__(self, quant_bits: int = 8, bins: int = 2048):
        super().__init__(quant_bits)
        self.bins = bins
        self._hist = np.zeros(bins, np.float64)
        self._range = 0.0

    def _observe(self, a):
        amax = float(np.max(np.abs(a)))
        if amax == 0.0:
            return
        if amax > self._range:
            new_range = amax * 1.25
            if self._range > 0:
                # rebin old counts into the wider range
                old_edges = np.linspace(0, self._range, self.bins + 1)
                centers = (old_edges[:-1] + old_edges[1:]) / 2
                idx = np.minimum(
                    (centers / new_range * self.bins).astype(int),
                    self.bins - 1)
                nh = np.zeros(self.bins, np.float64)
                np.add.at(nh, idx, self._hist)
                self._hist = nh
            self._range = new_range
        h, _ = np.histogram(np.abs(a), bins=self.bins,
                            range=(0.0, self._range))
        self._hist += h


class HistObserver(_HistogramMixin):
    """Percentile-of-histogram scale (upstream observers/hist.py)."""

    def __init__(self, quant_bits: int = 8, bins: int = 2048,
                 percent: float = 0.9999):
        super().__init__(quant_bits, bins)
        self.percent = percent

    def _absmax(self):
        c = np.cumsum(self._hist)
        if c[-1] == 0:
            return 0.0
        k = int(np.searchsorted(c, self.percent * c[-1]))
        return (k + 1) / self.bins * self._range


class KLObserver(_HistogramMixin):
    """TensorRT-style KL-divergence threshold search (upstream
    observers/kl.py): pick the clip point whose quantized distribution
    is closest (min KL) to the observed one."""

    def _absmax(self):
        hist = self._hist
        total = hist.sum()
        if total == 0:
            return 0.0
        nlevels = int(self.qmax) + 1  # 128 magnitude levels
        best_kl, best_i = np.inf, self.bins
        start = max(nlevels, self.bins // 16)
        for i in range(start, self.bins + 1, max(1, self.bins // 256)):
            # reference P: first i bins with the clipped tail dumped into
            # the last bin; candidate Q: the UN-dumped first i bins
            # quantized to nlevels and expanded — Q lacking the outlier
            # mass is exactly what penalizes aggressive clipping
            p = hist[:i].copy()
            p[-1] += hist[i:].sum()
            if p.sum() == 0:
                continue
            raw = hist[:i]
            idx = (np.arange(i) * nlevels // i)
            counts = np.bincount(
                idx, weights=(raw > 0).astype(np.float64),
                minlength=nlevels)
            sums = np.bincount(idx, weights=raw, minlength=nlevels)
            # spread each level's mass evenly over its nonzero bins
            q = np.where(raw > 0,
                         sums[idx] / np.maximum(counts[idx], 1), 0.0)
            pn = p / p.sum()
            qs = q.sum()
            if qs == 0:
                continue
            qn = q / qs
            mask = pn > 0
            kl = float(np.sum(pn[mask] * np.log(
                pn[mask] / np.maximum(qn[mask], 1e-12))))
            if kl < best_kl:
                best_kl, best_i = kl, i
        return best_i / self.bins * self._range


class MSEObserver(_HistogramMixin):
    """Scale minimizing quantization MSE over the observed histogram
    (upstream observers/mse.py): grid-search clip thresholds, score by
    sum(hist * (bin_center - dequant(quant(bin_center)))^2)."""

    def _absmax(self):
        if self._hist.sum() == 0:
            return 0.0
        edges = np.linspace(0, self._range, self.bins + 1)
        centers = (edges[:-1] + edges[1:]) / 2
        best_mse, best_t = np.inf, self._range
        for frac in np.linspace(0.2, 1.0, 40):
            t = frac * self._range
            scale = t / self.qmax
            q = np.clip(np.round(centers / scale), -self.qmax,
                        self.qmax) * scale
            mse = float(np.sum(self._hist * (centers - q) ** 2))
            if mse < best_mse:
                best_mse, best_t = mse, t
        return best_t
