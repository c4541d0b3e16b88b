"""paddle.nn.utils (counterpart of `paddle_tpu/nn/utils.py`): weight and
spectral normalization as forward-pre-hooks, and parameters to and from
one vector.

`weight_norm` keeps `<name>_g` (the norm over every dim but `dim`,
keepdims) and `<name>_v` as the trainable parameters and recomputes
w = v * (g / |v|) (the norm in f32) before every call, so gradients
reach g and v through torch's autograd. `spectral_norm` keeps
`<name>_orig` and the power iteration's `<name>_u` / `<name>_v` buffers;
before every call it runs the iteration on the device in f32 without a
gradient, and divides the weight by sigma = u W v (with a gradient
through W). The JAX package draws u and v from numpy's RandomState(0);
here they come from `generator` (default: the framework's generator of
the weight's device), so a test copies them across.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..tensor import Parameter, Tensor, apply_op
from .layer import Layer

__all__ = ['weight_norm', 'remove_weight_norm', 'spectral_norm',
           'parameters_to_vector', 'vector_to_parameters']


def _norm_axes(ndim, dim):
    if dim is None:
        return tuple(range(ndim))
    return tuple(i for i in range(ndim) if i != dim)


def weight_norm(layer: Layer, name: str = 'weight', dim: int = 0) -> Layer:
    """w = g * v / |v|, with g and v trainable."""
    w = getattr(layer, name)
    if not isinstance(w, Parameter):
        raise ValueError(f'{name!r} is not a Parameter of '
                         f'{type(layer).__name__}')
    axes = _norm_axes(w.dim(), dim)
    with torch.no_grad():
        g0 = w.double().square().sum(dim=axes, keepdim=True).sqrt() \
            .to(w.dtype)
        v0 = w.detach().clone()
    layer.add_parameter(name + '_g', Parameter(g0))
    layer.add_parameter(name + '_v', Parameter(v0))
    del layer._parameters[name]

    def hook(mod, inputs):
        v = getattr(mod, name + '_v')
        g = getattr(mod, name + '_g')
        norm = v.float().square().sum(dim=axes, keepdim=True).sqrt() \
            .to(v.dtype)
        mod.__dict__[name] = v * (g / norm)
    layer.__dict__['_wn_hook_' + name] = \
        layer.register_forward_pre_hook(hook)
    hook(layer, ())
    return layer


def remove_weight_norm(layer: Layer, name: str = 'weight') -> Layer:
    helper = layer.__dict__.pop('_wn_hook_' + name, None)
    if helper is None:
        raise ValueError(f'no weight_norm hook on {type(layer).__name__}')
    helper.remove()
    g = layer._parameters.pop(name + '_g')
    v = layer._parameters.pop(name + '_v')
    with torch.no_grad():
        gv, vv = g.double(), v.double()
        axes = tuple(i for i in range(vv.dim()) if gv.shape[i] == 1) \
            if gv.dim() == vv.dim() else tuple(range(vv.dim()))
        norm = vv.square().sum(dim=axes, keepdim=True).sqrt()
        w = (vv * (gv / norm)).to(v.dtype)
    layer.__dict__.pop(name, None)
    layer.add_parameter(name, Parameter(w))
    return layer


def _unit(n: int, generator, device) -> torch.Tensor:
    if generator is None:
        from .. import framework
        generator = framework.default_generator(device)
    u = torch.randn(n, generator=generator, device=generator.device)
    return (u / u.norm()).to(device)


def _power_iteration(mat, u, v, iters: int, eps: float) -> tuple:
    """u and v after `iters` (at least 1) rounds over mat [h, w], f32,
    without a gradient."""
    with torch.no_grad():
        for _ in range(max(iters, 1)):
            v = mat.t() @ u
            v = v / (v.norm() + eps)
            u = mat @ v
            u = u / (u.norm() + eps)
    return u, v


def _as_matrix(w: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)


def spectral_norm(layer: Layer, name: str = 'weight',
                  n_power_iterations: int = 1, eps: float = 1e-12,
                  dim: int = 0,
                  generator: Optional[torch.Generator] = None) -> Layer:
    """w_sn = w / sigma_max(w), sigma estimated by power iteration; u and
    v persist as buffers."""
    w = getattr(layer, name)
    if not isinstance(w, Parameter):
        raise ValueError(f'{name!r} is not a Parameter')
    h = w.shape[dim]
    layer.register_buffer(name + '_u', _unit(h, generator, w.device))
    layer.register_buffer(name + '_v', _unit(w.numel() // h, generator,
                                             w.device))
    layer.add_parameter(name + '_orig', Parameter(w.detach().clone()))
    del layer._parameters[name]

    def hook(mod, inputs):
        w_p = getattr(mod, name + '_orig')
        u, v = _power_iteration(_as_matrix(w_p.detach().float(), dim),
                                getattr(mod, name + '_u'),
                                getattr(mod, name + '_v'),
                                n_power_iterations, eps)
        mod._buffers[name + '_u'] = u
        mod._buffers[name + '_v'] = v
        sigma = u @ _as_matrix(w_p, dim).to(u.dtype) @ v
        mod.__dict__[name] = w_p / sigma
    layer.__dict__['_sn_hook_' + name] = \
        layer.register_forward_pre_hook(hook)
    hook(layer, ())
    return layer


def parameters_to_vector(parameters, name=None):
    return apply_op(lambda *ps: torch.cat([p.reshape(-1) for p in ps]),
                    *parameters, _name='concat')


def vector_to_parameters(vec, parameters, name=None) -> None:
    """Copy consecutive pieces of `vec` into the parameters, in place."""
    v = vec.value if isinstance(vec, Tensor) else vec
    offset = 0
    with torch.no_grad():
        for p in parameters:
            n = p.numel()
            p.copy_(v[offset:offset + n].reshape(p.shape))
            offset += n


class SpectralNorm(Layer):
    """Layer form (paddle.nn.SpectralNorm): forward(weight) returns the
    spectrally normalized weight, by power iteration over the buffers
    `weight_u` / `weight_v`."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        from .. import framework
        self.dim = dim
        self.power_iters = power_iters
        self.eps = eps
        h = int(weight_shape[dim])
        w = 1
        for s in weight_shape:
            w *= int(s)
        dev = framework.current_device() if device is None \
            else framework.resolve_device(device)
        self.register_buffer('weight_u', _unit(h, generator, dev))
        self.register_buffer('weight_v', _unit(w // h, generator, dev))

    def forward(self, weight):
        u, v = _power_iteration(_as_matrix(weight.detach().float(),
                                           self.dim),
                                self.weight_u, self.weight_v,
                                self.power_iters, self.eps)
        self._buffers['weight_u'] = u
        self._buffers['weight_v'] = v
        sigma = u @ _as_matrix(weight, self.dim).to(u.dtype) @ v
        return weight / sigma
