"""paddle.static (counterpart of `paddle_tpu/static/__init__.py`):
Program, program_guard, data, Executor, and `static.nn`'s layer helpers.

There is no graph IR, and the port has no tape of closures (its autograd
is torch's): a program is the list of ops that ran through
`tensor.apply_op` while it recorded. `program_guard` (and `data` outside
one, into the default main program until `disable_static`) installs
`tensor._record_hook`, which keeps each op whose inputs reach a
placeholder of the program: its function, name, torch arguments (before
the AMP cast) and outputs; an op off that path (a parameter's creation)
is not kept. With no program recording, the hook is None and costs
`apply_op` one test. `static.data` declares a named placeholder, built
at extent 1 for None / -1 dims (as in the JAX package; the ops must be
batch-polymorphic), zeros in its dtype on the current place.

`Executor.run(program, feed, fetch_list)` replays the recorded ops that
the fetches depend on, in the order they ran, on the feeds (cast to each
placeholder's dtype and device), each through `apply_op` under its name
(so under the AMP policy in force and through the same wrappers: on the
card a program launches the port's kernels). Tensors a recorded op read
that no op of the program made (parameters, constants) are read as they
are then. The replay plan is cached per feed signature and fetch list,
as the JAX package caches its jitted replay; the JAX errors are kept (a
ValueError on an empty fetch_list, a TypeError on a fetch that is not a
Tensor, a KeyError naming the declared feeds).

Static-graph training (optimizer.minimize inside a program) is out, as
in the JAX package: training is eager plus jit.TrainStep.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import framework, tensor as _tensor
from ..dtype import to_torch_dtype
from ..jit import InputSpec  # noqa: F401  (paddle.static.InputSpec parity)
from ..tensor import Tensor, apply_op

__all__ = ['Program', 'program_guard', 'default_main_program',
           'default_startup_program', 'data', 'Executor', 'global_scope',
           'nn', 'InputSpec', 'enable_static', 'disable_static',
           'in_static_mode']


class _Mode(threading.local):
    def __init__(self):
        self.static = False


_mode = _Mode()


def enable_static(place=None):
    """`place` is accepted for upstream's signature (the place is global,
    `paddle.set_device`)."""
    _mode.static = True


def disable_static(place=None):
    _mode.static = False
    _record_into(None)


def in_static_mode() -> bool:
    return _mode.static


class _Op:
    __slots__ = ('fn', 'name', 'args', 'kwargs', 'out')

    def __init__(self, fn, name, args, kwargs, out):
        self.fn, self.name = fn, name
        self.args, self.kwargs, self.out = args, kwargs, out


def _tensor_leaves(obj, out: list) -> list:
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _tensor_leaves(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _tensor_leaves(o, out)
    return out


def _substitute(obj, values: dict):
    if isinstance(obj, torch.Tensor):
        return values.get(id(obj), obj)
    if isinstance(obj, list):
        return [_substitute(o, values) for o in obj]
    if type(obj) is tuple:
        return tuple(_substitute(o, values) for o in obj)
    if isinstance(obj, dict):
        return {k: _substitute(v, values) for k, v in obj.items()}
    return obj


class Program:
    """A named collection of placeholders and the ops recorded from them
    (upstream: framework.Program / ProgramDesc)."""

    def __init__(self):
        self.placeholders: Dict[str, Tensor] = {}
        self._ops: List[_Op] = []
        # id of a torch value -> the op that made it (None: a placeholder);
        # every recorded value stays referenced, so no id is reused
        self._made: Dict[int, Optional[_Op]] = {}
        self._plans: Dict[Any, list] = {}

    def clone(self, for_test: bool = False) -> 'Program':
        return self  # the recorded ops do not change

    def all_parameters(self):
        return []

    def _place(self, name: str, t: Tensor) -> None:
        self.placeholders[name] = t
        self._made[id(t.value)] = None

    def _record(self, fn, name, args, kwargs, out) -> None:
        if not any(id(t) in self._made
                   for t in _tensor_leaves((args, kwargs), [])):
            return
        op = _Op(fn, name, args, kwargs, out)
        self._ops.append(op)
        for t in _tensor_leaves(out, []):
            self._made[id(t)] = op

    def _plan(self, fetch_values) -> list:
        """The recorded ops the fetches depend on, in recording order."""
        need, stack = set(), [id(v) for v in fetch_values]
        while stack:
            op = self._made.get(stack.pop())
            if op is None or id(op) in need:
                continue
            need.add(id(op))
            stack.extend(id(t) for t in _tensor_leaves(
                (op.args, op.kwargs), []))
        return [op for op in self._ops if id(op) in need]


class _ProgramStack(threading.local):
    def __init__(self):
        self.main = Program()
        self.startup = Program()
        self.stack: List[Program] = []


_programs = _ProgramStack()


def _record_into(program: Optional[Program]) -> None:
    _tensor._record_hook = None if program is None else program._record


def default_main_program() -> Program:
    return _programs.stack[-1] if _programs.stack else _programs.main


def default_startup_program() -> Program:
    return _programs.startup


class program_guard:
    """Record into `main_program` while the block runs."""

    def __init__(self, main_program: Program,
                 startup_program: Optional[Program] = None):
        self.main = main_program
        self.startup = startup_program

    def __enter__(self):
        self._outer = _tensor._record_hook
        _programs.stack.append(self.main)
        _record_into(self.main)
        return self.main

    def __exit__(self, *exc):
        _programs.stack.pop()
        _tensor._record_hook = self._outer
        return False


def data(name: str, shape, dtype='float32', lod_level=0) -> Tensor:
    """Declare a named feed placeholder (upstream: paddle.static.data):
    zeros at the declared shape, None / -1 dims at extent 1, on the
    current place. Outside a program_guard the default main program
    records from here on."""
    build_shape = tuple(1 if (d is None or int(d) < 0) else int(d)
                        for d in shape)
    t = Tensor(torch.zeros(build_shape, dtype=to_torch_dtype(dtype),
                           device=framework.current_device()))
    t.name = name
    prog = default_main_program()
    prog._place(name, t)
    if not _programs.stack:
        _record_into(prog)
    return t


def global_scope():
    """Scope shim: variables live on Tensors, not in a C++ scope."""
    return None


def _numpy(v: torch.Tensor) -> np.ndarray:
    v = v.detach()
    if v.dtype == torch.bfloat16:
        v = v.float()
    return v.cpu().numpy()


class Executor:
    """Runs a recorded program (upstream: paddle/fluid/executor.py; here
    the replay of its recorded ops, planned once per feed signature)."""

    def __init__(self, place=None):
        self.place = place

    def run(self, program: Optional[Program] = None, feed=None,
            fetch_list=None, return_numpy: bool = True):
        prog = program or default_main_program()
        feed = feed or {}
        if not fetch_list:
            raise ValueError('Executor.run needs a non-empty fetch_list')
        fetches = list(fetch_list)
        for f in fetches:
            if not isinstance(f, Tensor):
                raise TypeError(
                    f'fetch_list entries must be Tensors built from '
                    f'static.data placeholders, got {type(f).__name__}')
        names = sorted(feed)
        unknown = [n for n in names if n not in prog.placeholders]
        if unknown:
            raise KeyError(
                f'feed names {unknown} were never declared via '
                f'static.data in this program '
                f'(declared: {sorted(prog.placeholders)})')
        values = {}
        for n in names:
            ph = prog.placeholders[n].value
            values[id(ph)] = torch.as_tensor(
                np.asarray(feed[n]) if not isinstance(feed[n], (
                    torch.Tensor, Tensor)) else _tensor.to_torch(feed[n])
            ).to(device=ph.device, dtype=ph.dtype)
        key = (tuple(names), tuple((tuple(v.shape), str(v.dtype))
                                   for v in values.values()),
               tuple(id(f) for f in fetches))
        plan = prog._plans.get(key)
        if plan is None:
            plan = prog._plans[key] = prog._plan([f.value for f in fetches])
        hook, _tensor._record_hook = _tensor._record_hook, None
        try:
            for op in plan:
                out = apply_op(op.fn, *_substitute(op.args, values),
                               _name=op.name,
                               **_substitute(op.kwargs, values))
                for old, new in zip(_tensor_leaves(op.out, []),
                                    _tensor_leaves(out, [])):
                    values[id(old)] = new
        finally:
            _tensor._record_hook = hook
        outs = [values.get(id(f.value), f.value) for f in fetches]
        if return_numpy:
            return [_numpy(o) for o in outs]
        return [Tensor(o) for o in outs]


class _StaticNN:
    """paddle.static.nn (upstream: python/paddle/static/nn/): the classic
    static-graph layer helpers. Each call builds the same nn layer on the
    current place and applies it at once: under program_guard its ops are
    recorded like any other."""

    @staticmethod
    def fc(x, size, num_flatten_dims=1, activation=None, name=None):
        from .. import nn as _nn
        v = x if isinstance(x, Tensor) else Tensor(x)
        in_dim = int(np.prod(v.shape[num_flatten_dims:]))
        if v.ndim > num_flatten_dims + 1:
            v = v.reshape(list(v.shape[:num_flatten_dims]) + [-1])
        out = _nn.Linear(in_dim, size)(v)
        if activation:
            out = getattr(_nn.functional, activation)(out)
        return out

    @staticmethod
    def batch_norm(input, is_test=False, momentum=0.9, epsilon=1e-5,
                   data_layout='NCHW', name=None):
        from .. import nn as _nn
        ch = input.shape[1 if data_layout == 'NCHW' else -1]
        layer = _nn.BatchNorm(ch, momentum=momentum, epsilon=epsilon,
                              data_format=data_layout)
        if is_test:
            layer.eval()
        return layer(input)

    @staticmethod
    def conv2d(input, num_filters, filter_size, stride=1, padding=0,
               dilation=1, groups=1, act=None, name=None):
        from .. import nn as _nn
        layer = _nn.Conv2D(input.shape[1], num_filters, filter_size,
                           stride=stride, padding=padding,
                           dilation=dilation, groups=groups)
        out = layer(input)
        if act:
            out = getattr(_nn.functional, act)(out)
        return out

    @staticmethod
    def embedding(input, size, is_sparse=False, padding_idx=None,
                  name=None):
        from .. import nn as _nn
        return _nn.Embedding(size[0], size[1],
                             padding_idx=padding_idx)(input)


nn = _StaticNN()
