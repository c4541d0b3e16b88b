"""Quantization (counterpart of `paddle_tpu.quantization`).

- The int8 KV-page helpers of the paged pool (`paddle_tpu/quantization/
  __init__.py:45-67`): one f32 scale per (page, kv head), the absmax
  over the page's rows and head_dim divided by 127 (an all-zero page
  gets 1.0); quantizing rounds half to even (`torch.round`, as
  `jnp.round` does) and clips to +-127; dequantizing multiplies in f32,
  then casts.
- Post-training quantization (`PTQ`): per-output-channel absmax int8
  weights of Linear layers (`QuantedLinear`: int8 weight and f32 scales
  as buffers, dequantized into the compute dtype and multiplied by
  `torch.matmul` at call time, as the JAX package does in XLA outside
  any Pallas kernel), weight-only or with an activation scale calibrated
  by an observer (`observers`) and baked in by `convert`.
- Quant-aware training (`QAT`): `FakeQuantAbsMax` rounds a Linear's
  weight to int8 in the forward and passes the gradient straight
  through (`v + (q - v).detach()`); `convert` gives `QuantedLinear`s.
"""
from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from ..nn.common_layers import Linear
from ..nn.layer import Layer
from ..tensor import apply_op
from . import observers as observers  # noqa: F401  (the upstream path)
from .observers import (AbsmaxChannelObserver, AbsmaxObserver, AVGObserver,
                        BaseObserver, EMAObserver, HistObserver, KLObserver,
                        MSEObserver)

__all__ = ['QuantConfig', 'PTQ', 'QAT', 'QuantedLinear',
           'FakeQuantAbsMax', 'quanted_state_bytes', 'observers',
           'AbsmaxObserver', 'AbsmaxChannelObserver', 'AVGObserver',
           'EMAObserver', 'HistObserver', 'KLObserver', 'MSEObserver',
           'kv_page_scales', 'kv_quantize_page', 'kv_dequantize_page']

_KV_QMAX = 127.0


def kv_page_scales(page: torch.Tensor, qmax: float = _KV_QMAX):
    """Per-(page, head) scales [..., H] of pages [..., ps, H, D]."""
    amax = page.float().abs().amax(dim=(-3, -1))
    return torch.where(amax > 0, amax / qmax, torch.ones_like(amax))


def kv_quantize_page(page: torch.Tensor, scales: torch.Tensor,
                     qmax: float = _KV_QMAX) -> torch.Tensor:
    """Pages [..., ps, H, D] as int8 at `scales` [..., H]."""
    q = torch.round(page.float() / scales[..., None, :, None])
    return q.clamp(-qmax, qmax).to(torch.int8)


def kv_dequantize_page(q: torch.Tensor, scales: torch.Tensor,
                       dtype) -> torch.Tensor:
    """int8 pages [..., ps, H, D] at `scales` [..., H], back in `dtype`."""
    return (q.float() * scales[..., None, :, None]).to(dtype)


_OBSERVERS = {'abs_max': AbsmaxObserver, 'avg': AVGObserver,
              'ema': EMAObserver, 'hist': HistObserver,
              'kl': KLObserver, 'mse': MSEObserver}


class QuantConfig:
    """Which layers to quantize (upstream: paddle.quantization.QuantConfig
    with activation/weight quanter factories).

    activation: None (weight-only) or an observer: a name from
    {'abs_max','avg','ema','hist','kl','mse'}, an observer class, an
    instance (a prototype each layer copies) or a zero-argument factory.
    With an activation observer, PTQ.quantize inserts calibration
    observers; after calibration batches, PTQ.convert bakes each
    observed scale into the deployed layer."""

    def __init__(self, activation=None, weight='abs_max_channel_wise'):
        self.activation = activation
        self.weight = weight
        self._types = (Linear,)

    def make_observer(self):
        a = self.activation
        if a is None:
            return None
        if isinstance(a, str):
            if a not in _OBSERVERS:
                raise ValueError(
                    f'unknown activation observer {a!r}; '
                    f'choose from {sorted(_OBSERVERS)}')
            return _OBSERVERS[a]()
        if isinstance(a, BaseObserver):
            # a prototype: each quantized layer keeps its own statistics
            return copy.deepcopy(a)
        return a() if callable(a) else a

    def add_type_config(self, layer_types, activation=None, weight=None):
        if not isinstance(layer_types, (list, tuple)):
            layer_types = [layer_types]
        self._types = tuple(set(self._types) | set(layer_types))
        return self


def _absmax_scales(w: np.ndarray, axis: int = 0) -> np.ndarray:
    """Per-output-channel absmax scale mapping to int8 [-127, 127]."""
    amax = np.max(np.abs(w), axis=axis, keepdims=True)
    return np.where(amax == 0, 1.0, amax / 127.0).astype(np.float32)


_COMPUTE = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


class QuantedLinear(Layer):
    """Linear with int8 weights and per-output-channel f32 scales (the
    quantized nn.Linear that PTQ.convert produces). `weight_int8` [in,
    out] and `weight_scale` [1, out] are buffers (in the state dict under
    the JAX package's names); `act_scale`, a calibrated per-tensor scale
    or None, is an attribute, as in the JAX package."""

    def __init__(self, in_features: int, out_features: int,
                 has_bias: bool = True, compute_dtype='float32', *,
                 device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.compute_dtype = compute_dtype
        self.register_buffer('weight_int8', torch.zeros(
            (in_features, out_features), dtype=torch.int8, device=device))
        self.register_buffer('weight_scale', torch.ones(
            (1, out_features), dtype=torch.float32, device=device))
        self.bias = None
        self.act_scale: Optional[float] = None

    @classmethod
    def from_linear(cls, lin: Linear,
                    act_scale: Optional[float] = None) -> 'QuantedLinear':
        weight = lin.weight.detach()
        w = weight.float().cpu().numpy()
        q = cls(w.shape[0], w.shape[1], has_bias=lin.bias is not None,
                device=weight.device)
        scales = _absmax_scales(w)
        wq = np.clip(np.round(w / scales), -127, 127).astype(np.int8)
        q.weight_int8 = torch.from_numpy(wq).to(weight.device)
        q.weight_scale = torch.from_numpy(scales).to(weight.device)
        if lin.bias is not None:
            q.bias = lin.bias
        q.compute_dtype = ('bfloat16' if weight.dtype == torch.bfloat16
                           else 'float32')
        q.act_scale = act_scale
        return q

    def forward(self, x):
        cd = _COMPUTE[self.compute_dtype]
        act_scale = self.act_scale

        def run(xv, wq, sc, *maybe_bias):
            if act_scale is not None:
                # the deployed activation quantization: scale, round and
                # clip at the calibrated per-tensor scale
                xv = torch.clamp(torch.round(xv / act_scale), -127, 127) \
                    * torch.tensor(act_scale, dtype=xv.dtype,
                                   device=xv.device)
            w = wq.to(cd) * sc.to(cd)
            y = torch.matmul(xv.to(cd), w)
            if maybe_bias:
                y = y + maybe_bias[0].to(y.dtype)
            return y
        args = (x, self.weight_int8, self.weight_scale)
        if self.bias is not None:
            args = args + (self.bias,)
        return apply_op(run, *args, _name='quanted_linear')


class FakeQuantAbsMax(Layer):
    """QAT fake-quantizer: rounds to int8 (per column absmax) in the
    forward, identity in the backward (the straight-through estimator)."""

    def __init__(self, quant_bits: int = 8):
        super().__init__()
        self.qmax = float(2 ** (quant_bits - 1) - 1)

    def forward(self, x):
        def fq(v):
            amax = v.abs().amax(dim=0, keepdim=True)
            scale = torch.where(amax == 0, torch.ones_like(amax),
                                amax / self.qmax)
            q = torch.clamp(torch.round(v / scale), -self.qmax,
                            self.qmax) * scale
            return v + (q - v).detach()
        return apply_op(fq, x, _name='fake_quant_absmax')


class _QATLinear(Layer):
    def __init__(self, lin: Linear, quanter: FakeQuantAbsMax):
        super().__init__()
        self.inner = lin
        self.quanter = quanter

    def forward(self, x):
        from ..nn import functional as F
        return F.linear(x, self.quanter(self.inner.weight), self.inner.bias)


def _replace_layers(model: Layer, predicate, factory) -> int:
    n = 0
    for holder in list(model.modules()):
        for name, child in list(holder.named_children()):
            if predicate(child):
                setattr(holder, name, factory(child))
                n += 1
    return n


def _quantizable(types):
    return lambda layer: type(layer) in types and isinstance(layer, Linear)


class _ObservedLinear(Layer):
    """Calibration-time wrapper: records activation statistics, then runs
    the original float layer (observe, then quantize)."""

    def __init__(self, lin: Linear, observer):
        super().__init__()
        self.inner = lin
        self.observer = observer

    def forward(self, x):
        self.observer(x)
        return self.inner(x)


class PTQ:
    """Post-training quantization (upstream:
    paddle.quantization.PTQ.quantize/convert).

    Weight-only (config.activation=None): quantize() returns the int8
    model at once. With an activation observer: quantize() inserts
    observers; run calibration batches through the returned model, then
    convert() bakes the observed scales into QuantedLinear's activation
    fake-quant."""

    def __init__(self, config: Optional[QuantConfig] = None):
        self.config = config or QuantConfig()

    def quantize(self, model: Layer, inplace: bool = False) -> Layer:
        cfg = self.config
        if cfg.activation is not None:
            factory = (lambda lin:
                       _ObservedLinear(lin, cfg.make_observer()))
        else:
            factory = QuantedLinear.from_linear
        if _quantizable(cfg._types)(model):
            # the model is the quantizable layer: no parent to rebind
            if inplace:
                raise ValueError('cannot quantize a bare Linear inplace; '
                                 'use the returned layer')
            return factory(model)
        m = model if inplace else copy.deepcopy(model)
        if _replace_layers(m, _quantizable(cfg._types), factory) == 0:
            raise ValueError('PTQ.quantize found no quantizable layers '
                             f'(config types: {cfg._types})')
        return m

    def convert(self, model: Layer, inplace: bool = False) -> Layer:
        """Replace calibration observers with quantized layers (the
        identity for weight-only PTQ, which quantizes at quantize())."""
        def deploy(o):
            return QuantedLinear.from_linear(o.inner, o.observer.scales())
        if isinstance(model, _ObservedLinear):
            return deploy(model)
        m = model if inplace else copy.deepcopy(model)
        _replace_layers(m, lambda layer: isinstance(layer, _ObservedLinear),
                        deploy)
        return m


class QAT:
    """Quant-aware training: wraps Linear weights in fake-quant
    straight-through nodes; `convert` turns the trained model into
    QuantedLinears."""

    def __init__(self, config: Optional[QuantConfig] = None):
        self.config = config or QuantConfig()

    def quantize(self, model: Layer, inplace: bool = False) -> Layer:
        if _quantizable(self.config._types)(model):
            if inplace:
                raise ValueError('cannot quantize a bare Linear inplace; '
                                 'use the returned layer')
            return _QATLinear(copy.deepcopy(model), FakeQuantAbsMax())
        m = model if inplace else copy.deepcopy(model)
        if _replace_layers(m, _quantizable(self.config._types),
                           lambda lin: _QATLinear(lin,
                                                  FakeQuantAbsMax())) == 0:
            raise ValueError('QAT.quantize found no quantizable layers')
        return m

    def convert(self, model: Layer, inplace: bool = False) -> Layer:
        m = model if inplace else copy.deepcopy(model)
        _replace_layers(m, lambda layer: isinstance(layer, _QATLinear),
                        lambda q: QuantedLinear.from_linear(q.inner))
        return m


def quanted_state_bytes(model: Layer) -> int:
    """Device bytes of the quantized weight state (int8 weights and their
    scales), for compression reporting."""
    return sum(layer.weight_int8.nbytes + layer.weight_scale.nbytes
               for layer in model.modules()
               if isinstance(layer, QuantedLinear))
