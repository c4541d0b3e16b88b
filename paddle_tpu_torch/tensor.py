"""Tensor: the eager API's array type, backed by a torch tensor
(counterpart of `paddle_tpu/tensor.py`).

`Tensor` wraps a torch tensor (`.value`), as the JAX `Tensor` wraps a
jax.Array; it is not a `torch.Tensor` subclass, because Paddle's methods
reuse torch's names with other meanings (`transpose(perm)`,
`split(num_or_sections)`, `max(axis)`, `shape` as a list), and a
subclass would catch torch's own calls and the port's modules' with
them. Autograd is torch's: `stop_gradient` is the inverse of the value's
`requires_grad`, `.grad` wraps the value's, and there is no tape of the
port's own. "In-place" APIs rebind the handle to a new value (`_rebind`),
as the JAX package does, so a value that a recorded op saved for the
backward is never written over.

`Parameter` is a `torch.nn.Parameter` subclass, so the port's modules
keep plain torch parameters and pay nothing per op (Parameter's
`__torch_function__` is disabled); it adds the Paddle names torch lacks.

Every eager op runs through `apply_op`, the port's one choke point: it
unwraps Tensors, applies the AMP cast policy by op name (set by
`paddle_tpu_torch.amp`), runs the torch function, wraps the outputs only
when an input was a Tensor (plain torch in, plain torch out: the serving
and training paths keep their types) and runs the numerics hook (set by
`debug.enable_check_numerics`). There is no counterpart of the JAX
package's dispatch cache (`_dispatch`): torch runs eager ops without
tracing.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import framework
from .dtype import convert_dtype, dtype_name

# set by paddle_tpu_torch.amp at import: (values, op_name) -> values,
# the auto_cast white/black-list policy at the op choke point
_amp_cast_hook = None

# set by debug.enable_check_numerics: (outputs, op_name) -> None
_numerics_hook = None

# set by paddle_tpu_torch.static while a program records: (fn, op_name,
# args, kwargs, outputs) -> None, the op as `apply_op` ran it (torch
# values, before the AMP cast) for `Executor.run` to replay
_record_hook = None

_PRINT_OPTIONS = {'precision': 4, 'threshold': 40, 'edgeitems': 3,
                  'linewidth': 80}


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Repr formatting for Tensor (paddle.set_printoptions; sci_mode is
    accepted for the signature, numpy picks the notation)."""
    for k, v in (('precision', precision), ('threshold', threshold),
                 ('edgeitems', edgeitems), ('linewidth', linewidth)):
        if v is not None:
            _PRINT_OPTIONS[k] = int(v)


def _host(value: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array (bf16 read as f32, which holds
    it exactly)."""
    v = value.detach()
    if v.dtype == torch.bfloat16:
        v = v.float()
    return v.cpu().resolve_conj().numpy()


class Tensor:
    __slots__ = ('_value', 'name', 'persistable', '__weakref__')
    __array_priority__ = 100      # numpy scalars defer to our operators

    def __init__(self, value, stop_gradient=None, name: str = ''):
        if isinstance(value, Tensor):
            value = value._value
        elif not isinstance(value, torch.Tensor):
            value = torch.as_tensor(value)
        self._value = value
        self.name = name
        self.persistable = False
        if stop_gradient is not None:
            self.stop_gradient = stop_gradient

    # -- the torch value ----------------------------------------------------
    @property
    def value(self) -> torch.Tensor:
        return self._value

    # -- metadata -----------------------------------------------------------
    @property
    def shape(self):
        return list(self._value.shape)

    @property
    def ndim(self):
        return self._value.dim()

    @property
    def dtype(self):
        return self._value.dtype

    @property
    def size(self):
        return self._value.numel()

    def numel(self):
        return self._value.numel()

    def dim(self):
        return self._value.dim()

    @property
    def place(self):
        return framework.place_of(self._value.device)

    @property
    def is_leaf(self):
        return self._value.grad_fn is None

    # -- autograd -----------------------------------------------------------
    @property
    def stop_gradient(self) -> bool:
        return not self._value.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, flag) -> None:
        v = self._value
        if flag:
            if v.grad_fn is not None:       # cut a non-leaf off the graph
                self._value = v.detach()
            elif v.requires_grad:
                v.requires_grad_(False)
        elif not v.requires_grad and (v.is_floating_point()
                                      or v.is_complex()):
            v.requires_grad_(True)

    @property
    def grad(self):
        v = self._value
        if v.grad_fn is not None and not v.retains_grad:
            return None                   # a non-leaf keeps no gradient
        return None if v.grad is None else Tensor(v.grad)

    @grad.setter
    def grad(self, g) -> None:
        self._value.grad = None if g is None else to_torch(g)

    def backward(self, grad_tensor=None, retain_graph=False):
        from . import autograd
        autograd.backward([self], [grad_tensor], retain_graph=retain_graph)

    def register_hook(self, hook):
        """Run `hook(grad) -> grad | None` on this tensor's whole gradient
        of each backward (Paddle's Tensor.register_hook). Returns a
        handle with .remove()."""
        def run(g):
            res = hook(Tensor(g))
            return None if res is None else to_torch(res)
        return self._value.register_hook(run)

    def clear_grad(self):
        self._value.grad = None

    clear_gradient = clear_grad

    def detach(self):
        return Tensor(self._value.detach(), name=self.name)

    def detach_(self):
        self._value = self._value.detach()
        return self

    def clone(self):
        return apply_op(torch.clone, self, _name='clone')

    def _rebind(self, result: 'Tensor'):
        """Adopt an op result in place (the functional backing of the
        mutating APIs). A leaf that requires grad, updated outside the
        graph (under no_grad), stays such a leaf and keeps its
        gradient, as in the JAX package."""
        new = to_torch(result)
        old = self._value
        if (old.requires_grad and old.grad_fn is None
                and not new.requires_grad and new.is_floating_point()):
            new = new.detach().requires_grad_(True)
            if old.grad is not None and old.grad.shape == new.shape \
                    and old.grad.dtype == new.dtype:
                new.grad = old.grad
        self._value = new
        return self

    # -- conversion ---------------------------------------------------------
    def numpy(self):
        return _host(self._value)

    def item(self):
        return self._value.item()

    def tolist(self):
        return self._value.tolist()

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __bool__(self):
        return bool(self.item())

    def __len__(self):
        if self.ndim == 0:
            raise TypeError('len() of a 0-d tensor')
        return self._value.shape[0]

    def __index__(self):
        return int(self.item())

    def __array__(self, dtype=None, copy=None):
        a = _host(self._value)
        return a.astype(dtype) if dtype is not None else a

    # -- dtype and device ---------------------------------------------------
    def astype(self, dtype):
        dt = convert_dtype(dtype)
        return apply_op(lambda x: x.to(dt), self, _name='astype')

    def cast(self, dtype):
        return self.astype(dtype)

    def to(self, *args, **kwargs):
        out = self
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, framework.Place):
                dev = a.torch_device()
            elif isinstance(a, str) and (a in ('cpu', 'gpu', 'cuda')
                                         or ':' in a):
                name, _, idx = a.partition(':')
                dev = (framework.CPUPlace(0) if name == 'cpu' else
                       framework.CUDAPlace(int(idx or 0))).torch_device()
            else:
                out = out.astype(a)
                continue
            out = apply_op(lambda x, d=dev: x.to(d), out, _name='to')
        return out

    def cpu(self):
        return self.to('cpu')

    def cuda(self, device_id=None, blocking=True):
        return self.to(f'gpu:{device_id or 0}')

    def pin_memory(self):
        return Tensor(self._value.pin_memory())

    def contiguous(self):
        return apply_op(lambda x: x.contiguous(), self, _name='contiguous')

    # -- indexing -----------------------------------------------------------
    def __getitem__(self, idx):
        dev = self._value.device
        return apply_op(lambda x: x[_index(idx, dev)], self, _name='getitem')

    def __setitem__(self, idx, value):
        dev = self._value.device

        def put(x, *v):
            y = x.clone()
            y[_index(idx, dev)] = (v[0].to(x.dtype) if v else
                                   torch.as_tensor(np.asarray(value),
                                                   dtype=x.dtype, device=dev))
            return y
        args = (self, value) if isinstance(value, (Tensor, torch.Tensor)) \
            else (self,)
        self._rebind(apply_op(put, *args, _name='setitem'))

    # -- printing -----------------------------------------------------------
    def __repr__(self):
        body = np.array2string(
            _host(self._value), precision=_PRINT_OPTIONS['precision'],
            threshold=_PRINT_OPTIONS['threshold'],
            edgeitems=_PRINT_OPTIONS['edgeitems'],
            max_line_width=_PRINT_OPTIONS['linewidth'])
        return (f'Tensor(shape={self.shape}, dtype={dtype_name(self.dtype)}, '
                f'place={self.place}, stop_gradient={self.stop_gradient},\n'
                f'       {body})')

    __str__ = __repr__

    def __hash__(self):
        return id(self)


def _index(idx, device):
    """A Paddle index as a torch one: Tensors unwrapped, lists of ints and
    numpy arrays as index tensors on `device`."""
    if isinstance(idx, Tensor):
        return idx._value.to(device)
    if isinstance(idx, torch.Tensor):
        return idx.to(device)
    if isinstance(idx, tuple):
        return tuple(_index(i, device) for i in idx)
    if isinstance(idx, np.ndarray):
        return torch.as_tensor(idx, device=device)
    if isinstance(idx, list):
        if idx and not any(isinstance(i, (slice, type(None),
                                          type(Ellipsis))) for i in idx):
            return torch.as_tensor(np.asarray(
                [to_torch(i).item() if isinstance(i, (Tensor, torch.Tensor))
                 else i for i in idx]), device=device)
        return [_index(i, device) for i in idx]
    return idx


class Parameter(torch.nn.Parameter):
    """A trainable leaf (Paddle's Parameter): a `torch.nn.Parameter` with
    the names torch lacks (`stop_gradient`, `name`, `trainable`,
    `persistable`, `clear_grad`, `astype`) and `numpy()` through the
    host. Its ops are torch's and give plain torch tensors."""

    def __new__(cls, data=None, requires_grad=True, name=''):
        p = super().__new__(cls, data, requires_grad)
        p.__dict__['_pname'] = name
        return p

    @property
    def name(self):
        return self.__dict__.get('_pname', '')

    @name.setter
    def name(self, value):
        self.__dict__['_pname'] = value

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, flag) -> None:
        self.requires_grad_(not flag)

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, flag) -> None:
        self.requires_grad_(bool(flag))

    persistable = True

    def defer_init(self, fill, device) -> None:
        """Record how `initialize()` materializes this `meta` parameter:
        `fill(t)` writes its values into an empty tensor on `device`
        (`nn.LazyGuard`)."""
        self.__dict__['_lazy_init'] = (fill, torch.device(device))

    @property
    def is_lazy(self) -> bool:
        return '_lazy_init' in self.__dict__

    def initialize(self):
        """Materialize a parameter made under `LazyGuard` on its device,
        from its recorded initializer and generator; a no-op for one made
        eagerly. Returns the parameter."""
        lazy = self.__dict__.pop('_lazy_init', None)
        if lazy is not None:
            fill, device = lazy
            t = torch.empty(self.shape, dtype=self.dtype, device=device)
            fill(t)
            # a meta tensor cannot take another device's data in place:
            # swap this object's contents with a materialized twin's, so
            # every module that holds the parameter sees the new one
            twin = Parameter(t, self.requires_grad)
            twin.__dict__.update(self.__dict__)
            torch.utils.swap_tensors(self, twin)
        return self

    def clear_grad(self):
        self.grad = None

    clear_gradient = clear_grad

    def astype(self, dtype):
        return Tensor(self.to(convert_dtype(dtype)))

    def numpy(self):
        return _host(self)


# ---------------------------------------------------------------------------
# The op choke point
# ---------------------------------------------------------------------------

def _unwrap(obj, found):
    if isinstance(obj, Tensor):
        found[0] = True
        return obj._value
    if isinstance(obj, list):
        return [_unwrap(o, found) for o in obj]
    if type(obj) is tuple:
        return tuple(_unwrap(o, found) for o in obj)
    if isinstance(obj, dict):
        return {k: _unwrap(v, found) for k, v in obj.items()}
    return obj


def _leaves(obj, out):
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _leaves(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _leaves(o, out)
    return out


def _replace(obj, it):
    if isinstance(obj, torch.Tensor):
        return next(it)
    if isinstance(obj, list):
        return [_replace(o, it) for o in obj]
    if type(obj) is tuple:
        return tuple(_replace(o, it) for o in obj)
    if isinstance(obj, dict):
        return {k: _replace(v, it) for k, v in obj.items()}
    return obj


def _wrap(obj):
    if isinstance(obj, torch.Tensor):
        return Tensor(obj)
    if isinstance(obj, list):
        return [_wrap(o) for o in obj]
    if isinstance(obj, tuple):
        return type(obj)(_wrap(o) for o in obj) if type(obj) is tuple \
            else type(obj)(*[_wrap(o) for o in obj])
    return obj


def apply_op(fn: Callable, *args, _name: str = '', **kwargs):
    """Run the torch function `fn` over (args, kwargs), Tensors unwrapped
    (in nested lists, tuples and dicts too), the AMP cast policy applied
    to every torch tensor input by `_name`; outputs wrapped as Tensors
    only when some input was a Tensor. While a static program records
    (`static.program_guard`), the op is recorded for its replay."""
    found = [False]
    args = _unwrap(args, found)
    if kwargs:
        kwargs = _unwrap(kwargs, found)
    raw_args, raw_kwargs = args, kwargs
    if _amp_cast_hook is not None:
        vals = _leaves((args, kwargs), [])
        if vals:
            cast = _amp_cast_hook(vals, _name)
            if cast is not vals:
                args, kwargs = _replace((args, kwargs), iter(cast))
    out = fn(*args, **kwargs)
    if _record_hook is not None:
        _record_hook(fn, _name, raw_args, raw_kwargs, out)
    if found[0]:
        out = _wrap(out)
    if _numerics_hook is not None:
        _numerics_hook(out, _name)
    return out


def to_torch(x):
    """Unwrap Tensor -> torch tensor (anything else passes through)."""
    return x._value if isinstance(x, Tensor) else x


def wrap(x, stop_gradient=True):
    return Tensor(x if isinstance(x, torch.Tensor) else torch.as_tensor(x),
                  stop_gradient=stop_gradient)
