"""`Layer`: the port's module base (counterpart of `paddle_tpu/nn/layer.py`).

A `torch.nn.Module` whose parameters are created directly on their
device and dtype, with Paddle's layouts, so that `state_dict()` has the
JAX package's key names and shapes (`llama.layers.0.self_attn.q_proj.weight`
is `[in, out]` in both) and weights copy across by name. Parameters are
the port's `Parameter` (a `torch.nn.Parameter`), trainable as Paddle's
are (`stop_gradient=False`); the serving engine runs under
`torch.inference_mode`.

Calling a Layer with eager `Tensor`s unwraps them, runs the module on
torch tensors and wraps its outputs as Tensors (plain torch in, plain
torch out); `to()` takes Paddle's dtype names and 'gpu' devices, as
`amp.decorate` calls it.

`create_parameter` takes Paddle's form (`shape, attr=None, dtype=None,
is_bias=False, default_initializer=None`, with `ParamAttr`'s name,
initializer, trainable and learning_rate) and the port's keywords
`device=` and `generator=`. A parameter made without a device lies on
the current place (`framework.current_device()`: `cuda` unless
`set_device('cpu')` was called, raising without a card); its random
draws come from `generator`, else the framework's generator of that
device. `init_kwargs` gives a model constructor's layers their
`device`, `dtype` and `generator`.

Inside a `LazyGuard`, `create_parameter` allocates nothing: each
parameter lies on torch's `meta` device with its initializer, device and
generator recorded, and `Parameter.initialize()` materializes it on that
device (the JAX package's `LazyGuard`, whose parameters hold a
ShapeDtypeStruct until `initialize()`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .. import dtype as _dtype
from .. import framework
from ..dtype import _NAME_TO_DTYPE, convert_dtype
from ..tensor import Parameter, _unwrap, _wrap
from . import initializer as I

_LAZY_GUARDS: list = []


class LazyGuard:
    """Defer parameter materialization (upstream paddle.LazyGuard):
    layers built inside the guard allocate no memory for their
    parameters, which lie on the `meta` device until each one's
    `initialize()` fills it, on the device it was made for, from its
    recorded initializer and generator."""

    def __enter__(self):
        _LAZY_GUARDS.append(self)
        return self

    def __exit__(self, *exc):
        _LAZY_GUARDS.pop()
        return False


def _torch_arg(a):
    """A Paddle dtype name or 'gpu[:N]' device as torch takes it."""
    if isinstance(a, str):
        if a in _NAME_TO_DTYPE:
            return convert_dtype(a)
        name, _, idx = a.partition(':')
        if name == 'gpu':
            return torch.device('cuda', int(idx or 0))
    return a


class ParamAttr:
    """Parameter configuration (Paddle's `paddle.ParamAttr`): name,
    initializer, learning-rate multiplier, regularizer, trainable."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None or isinstance(attr, ParamAttr):
            return attr
        if attr is False:
            return False
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f'cannot convert {attr!r} to ParamAttr')


def init_kwargs(device, dtype, generator) -> dict:
    """The `device`, `dtype` and `generator` a model constructor hands
    its layers: device None is `cuda` (raising without a card), as every
    entry point of the port."""
    return {'device': framework.resolve_device(device),
            'dtype': _dtype.to_torch_dtype(dtype), 'generator': generator}


def _initializer(attr, default_initializer, is_bias):
    if attr is not None and attr.initializer is not None:
        return attr.initializer
    if default_initializer is not None:
        return default_initializer
    if I._global_default(is_bias) is not None:
        return I._global_default(is_bias)
    return I.Constant(0.0) if is_bias else I.XavierUniform()


class Layer(nn.Module):

    def __call__(self, *args, **kwargs):
        found = [False]
        args = _unwrap(args, found)
        if kwargs:
            kwargs = _unwrap(kwargs, found)
        out = super().__call__(*args, **kwargs)
        return _wrap(out) if found[0] else out

    def to(self, *args, **kwargs):
        return super().to(*[_torch_arg(a) for a in args],
                          **{k: _torch_arg(v) for k, v in kwargs.items()})

    def create_parameter(self, shape: Sequence[int], attr=None, dtype=None,
                         is_bias: bool = False, default_initializer=None, *,
                         device=None,
                         generator: Optional[torch.Generator] = None
                         ) -> Optional[Parameter]:
        """A parameter of `shape` in `dtype` (default: the framework's)
        on `device` (default: the current place), filled by, in order:
        `attr`'s initializer, `default_initializer`, the global
        initializer, zeros for a bias, else Xavier-uniform (Paddle's
        defaults). None when `attr` is False. Random draws come from
        `generator`, else the framework's generator of the device."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dt = convert_dtype(dtype) if dtype is not None \
            else framework.get_default_dtype()
        dev = framework.current_device() if device is None \
            else framework.resolve_device(device)
        init = _initializer(attr, default_initializer, is_bias)
        shape = tuple(int(s) for s in shape)
        if _LAZY_GUARDS:
            p = Parameter(torch.empty(shape, device='meta', dtype=dt),
                          name=(attr.name if attr else None) or '')
            p.defer_init(lambda t: init.fill_(t, generator), dev)
        else:
            t = torch.empty(shape, device=dev, dtype=dt)
            init.fill_(t, generator)
            p = Parameter(t, name=(attr.name if attr else None) or '')
        if attr is not None:
            p.trainable = attr.trainable
            p.optimize_attr = {'learning_rate': attr.learning_rate}
            p.regularizer = attr.regularizer
        return p

    def add_parameter(self, name: str, parameter) -> Parameter:
        self.register_parameter(name, parameter)
        return parameter
