"""`paddle.jit` (counterpart of `paddle_tpu/jit/__init__.py`):
`to_static`, `save`/`load` and `TrainStep`.

The JAX package traces a layer into one XLA program (`to_static`, the
forward, loss, gradient and update of `TrainStep`) and exports it as
StableHLO (`save`). PyTorch runs eagerly, so the port runs the same
code as it stands, with no `torch.compile`: the kernels under the model
are what runs on the card.

- `functional_state` / `functional_call` / `functional_method` pull a
  layer's state out as {name: tensor} dicts (trainable, frozen,
  buffers) and run it with other state bound in
  (`torch.func.functional_call`).
- `to_static` returns a `StaticLayer`, which checks its `InputSpec`s,
  keys each call on its hashable static kwargs (the JAX program cache's
  key, noted once per key as `paddle_jit_cache_entries{kind=
  "to_static"}`; an unhashable one raises the JAX `TypeError`) and
  runs the target eagerly.
- `save(layer, path, input_spec)` writes `<path>.pdiparams.npz` with the
  JAX keys (`param::<name>`, `buffer::<name>`; bf16 and fp16 widened to
  f32, which npz stores), `<path>.pdmodel.json` (format
  `"torch.export"`, the trainable/frozen split, each entry's dtype, the
  input spec and the device) and `<path>.pdmodel.pt2`: the eval forward
  under `torch.no_grad()`, exported by `torch.export` as the JAX
  `infer_fn(params, frozen, buffers, *args)`, the state passed in as
  inputs, so the npz stays the only copy of the weights. A None dim of
  an `InputSpec` is a `torch.export.Dim`, one symbol per axis shared by
  every argument (the batch of an encoder's and a decoder's ids).
  The kernels' wrappers record their export ops there
  (`ops/kernels.py`), so the loaded program launches the same kernels
  on the card and the plain versions on the CPU; a kernel without an
  op raises during the export.
- `load(path)` returns a `TranslatedLayer` (no Python class needed)
  over the program and the npz's state; `load(path, layer=...)`
  restores the npz into `layer` alone, so it reads a JAX `jit.save`'s
  npz, and the JAX `load(path, layer=...)` reads the port's. A JAX
  StableHLO artifact loaded without a layer raises
  `ProgramDeserializeError` naming its format.

`TrainStep` is the JAX step's sequence run as it stands. An optimizer
built with `offload='host'` keeps its slots in pinned host memory and
streams the update through HBM (`optimizer/offload.py`), as the JAX
step's offload path runs its `OffloadEngine` after the jitted gradient
step. `opt_state()` and `load_opt_state()` read and write the
optimizer's state in the JAX step's `_opt_state` layout, which the
fault-tolerant step's snapshots and `hapi.Model`'s checkpoints hold.

Observability, as the JAX step reports: each call runs under the
`train.step` span (the goodput ledger's `step_compute`), the first call
notes `paddle_jit_cache_entries{kind="train_step"}` (the JAX step's one
trace), and every call is booked in the program catalog as `train_step`
of kind `train` with its host seconds and an analytic count of its
work (`observability.cost`).
"""
from __future__ import annotations

import functools
import json
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import framework
from .. import observability as _obs
from ..dtype import dtype_name, to_torch_dtype
from ..observability import cost as _cost
from ..tensor import Tensor, _unwrap, _wrap
from ..weights import _copy_by_name


class InputSpec:
    """Shape and dtype of a forward argument (upstream:
    `paddle.static.InputSpec`); a None dim is dynamic."""

    def __init__(self, shape, dtype='float32', name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name

    def __repr__(self):
        return f'InputSpec(shape={self.shape}, dtype={self.dtype})'


class ProgramDeserializeError(RuntimeError):
    """A saved program could not be loaded (a JAX StableHLO artifact, or a
    damaged file); carries the path and the reason."""

    def __init__(self, path: str, reason: str):
        self.path = path
        self.reason = reason
        super().__init__(f'cannot deserialize program artifact {path}: '
                         f'{reason}')


def functional_state(layer: torch.nn.Module):
    """(params, frozen, buffers): the layer's trainable parameters, its
    other parameters and its buffers as flat {name: tensor} dicts."""
    params = {n: p for n, p in layer.named_parameters() if p.requires_grad}
    frozen = {n: p for n, p in layer.named_parameters()
              if not p.requires_grad}
    buffers = dict(layer.named_buffers())
    return params, frozen, buffers


class _Method(torch.nn.Module):
    """Calls `method` of a layer held as submodule `m`, so that
    `torch.func.functional_call` binds state into any of its methods."""

    def __init__(self, layer, method: str):
        super().__init__()
        self.m = layer
        self.method = method

    def forward(self, *args, **kwargs):
        return getattr(self.m, self.method)(*args, **kwargs)


def functional_call(layer: torch.nn.Module, params, frozen, buffers, args,
                    kwargs):
    """Run the layer's forward with the given state bound in; returns
    (output, buffers after the call), the buffers' in-place updates (a
    BatchNorm's running statistics) landing in the tensors passed."""
    return functional_method(layer, '__call__', params, frozen, buffers,
                             args, kwargs)


def functional_method(layer: torch.nn.Module, method: str, params, frozen,
                      buffers, args, kwargs):
    """`functional_call` of any method of the layer (an encoder-decoder's
    `encode`)."""
    state = {**params, **frozen, **buffers}
    if method == '__call__':
        out = torch.func.functional_call(layer, state, tuple(args), kwargs)
    else:
        out = torch.func.functional_call(
            _Method(layer, method), {f'm.{k}': v for k, v in state.items()},
            tuple(args), kwargs)
    return out, {n: state[n] for n in buffers}


def _static_key(static_kwargs: dict):
    try:
        key = tuple(sorted(
            (k, type(v).__name__, v) for k, v in static_kwargs.items()))
        hash(key)
    except TypeError:
        raise TypeError(
            f'to_static kwargs must be Tensors/arrays (traced) or '
            f'hashable python values (compile-time constants); got '
            f'{ {k: type(v).__name__ for k, v in static_kwargs.items()} }'
        ) from None
    return key


class StaticLayer:
    """A layer (or function) made by `to_static`: each call checks the
    `InputSpec`s and runs the target eagerly. A call's non-tensor kwargs
    are its static key, as the JAX program cache keys a compiled program
    on them: a new key is noted once (`paddle_jit_cache_entries{kind=
    "to_static"}`), an unhashable one raises. Attributes pass through to
    the target."""

    def __init__(self, fn_or_layer, input_spec=None):
        self._target = fn_or_layer
        self._input_spec = input_spec
        self._keys = set()

    def _check_spec(self, args):
        if not self._input_spec:
            return
        for i, (spec, a) in enumerate(zip(self._input_spec, args)):
            shape = tuple(a.shape) if hasattr(a, 'shape') \
                else tuple(np.shape(a))
            if len(shape) != len(spec.shape) or any(
                    s is not None and s != d
                    for s, d in zip(spec.shape, shape)):
                raise ValueError(
                    f'input {i} shape {shape} does not match InputSpec '
                    f'{spec.shape} (None dims are dynamic)')

    def __call__(self, *args, **kwargs):
        self._check_spec(args)
        static = {k: v for k, v in kwargs.items()
                  if not isinstance(v, (Tensor, torch.Tensor, np.ndarray))}
        key = _static_key(static)
        if key not in self._keys:
            self._keys.add(key)
            _obs.note_jit_cache_entry('to_static')
        return self._target(*args, **kwargs)

    # passthroughs so a converted layer still looks like one
    def __getattr__(self, name):
        return getattr(self._target, name)


def to_static(function=None, input_spec=None, full_graph=True, **kwargs):
    """A `StaticLayer` over a layer or a function (as a decorator too)."""
    def deco(f):
        wrapper = StaticLayer(f, input_spec)
        if not isinstance(f, torch.nn.Module):
            functools.update_wrapper(wrapper, f,
                                     assigned=('__name__', '__doc__'),
                                     updated=())
        return wrapper
    return deco(function) if function is not None else deco


def not_to_static(fn):
    fn.__jit_skip__ = True
    return fn


def enable_to_static(flag=True):
    """A no-op: `to_static` always runs its target (eagerly)."""


def ignore_module(modules):
    """Upstream `paddle.jit.ignore_module` marks modules whose calls
    to_static does not transcribe; nothing is transcribed here, so it
    records nothing."""
    return None


class _InferFn(torch.nn.Module):
    """The exported program's calling convention, the JAX `infer_fn`:
    forward(params, frozen, buffers, *args) runs the target with that
    state bound in. The target is held outside the module tree, so the
    program holds none of its weights."""

    def __init__(self, target):
        super().__init__()
        self.__dict__['_target'] = target

    def forward(self, params, frozen, buffers, *args):
        return functional_call(self._target, params, frozen, buffers, args,
                               {})[0]


def _sample_dims(input_spec):
    """(example shapes, dynamic shapes) of the specs: a None dim at axis a
    is one `torch.export.Dim` shared by every argument, its example
    size 2 (export specializes sizes 0 and 1)."""
    dims, shapes, dynamic = {}, [], []
    for spec in input_spec:
        shape, dyn = [], {}
        for a, d in enumerate(spec.shape):
            if d is None:
                dyn[a] = dims.setdefault(a, torch.export.Dim(f'dim{a}'))
                shape.append(2)
            else:
                shape.append(int(d))
        shapes.append(shape)
        dynamic.append(dyn or None)
    return shapes, dynamic


def _npz_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as npz stores it: bf16 and fp16 widened to f32 (exact;
    the manifest keeps the dtype)."""
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


def save(layer, path, input_spec=None, **config):
    """Save a (Static)Layer's eval forward: `<path>.pdiparams.npz`,
    `<path>.pdmodel.json` and `<path>.pdmodel.pt2` (module docstring).
    `jit.load(path)` rebuilds a callable from these files alone."""
    target = layer._target if isinstance(layer, StaticLayer) else layer
    if input_spec is None and isinstance(layer, StaticLayer):
        input_spec = layer._input_spec
    if not input_spec:
        raise ValueError('jit.save needs input_spec (shapes/dtypes of the '
                         'forward arguments) to trace the program')
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    arrays = {f'param::{n}': _npz_array(p)
              for n, p in target.named_parameters()}
    arrays.update({f'buffer::{n}': _npz_array(b)
                   for n, b in target.named_buffers()})
    np.savez(path + '.pdiparams.npz', **arrays)
    params, frozen, buffers = functional_state(target)
    state = {**params, **frozen, **buffers}
    device = (next(iter(state.values())).device if state
              else framework.current_device())
    shapes, dynamic = _sample_dims(input_spec)
    samples = tuple(torch.zeros(shape, dtype=to_torch_dtype(s.dtype),
                                device=device)
                    for shape, s in zip(shapes, input_spec))
    # the program is the eval forward (dropout off, BatchNorm's running
    # statistics), as upstream jit.save writes
    was_training = target.training
    target.eval()
    try:
        with torch.no_grad():
            detached = [{n: t.detach() for n, t in d.items()}
                        for d in (params, frozen, buffers)]
            program = torch.export.export(
                _InferFn(target), (*detached, *samples),
                dynamic_shapes=(*({n: None for n in d} for d in detached),
                                tuple(dynamic)))
        # the example inputs hold the state: the npz is its only copy
        program.example_inputs = None
        torch.export.save(program, path + '.pdmodel.pt2')
    finally:
        if was_training:
            target.train()
    manifest = {
        'class': type(target).__name__,
        'format': 'torch.export',
        # the program's inputs split the state into (trainable, frozen,
        # buffers) dicts; load rebuilds the same dicts
        'trainable': sorted(params),
        'frozen': sorted(frozen),
        'dtypes': {n: dtype_name(t.dtype) for n, t in state.items()},
        'device': device.type,
        'input_spec': [
            {'shape': list(s.shape), 'dtype': dtype_name(s.dtype)}
            for s in input_spec],
    }
    with open(path + '.pdmodel.json', 'w') as f:
        json.dump(manifest, f)


class TranslatedLayer:
    """What `jit.load(path)` gives without the original class (upstream
    `paddle.jit.TranslatedLayer`): the exported program over the saved
    state, callable like the layer's eval forward (torch tensors in,
    torch tensors out; port Tensors in, Tensors out)."""

    def __init__(self, program, params, frozen, buffers, manifest):
        self._program = program
        self._module = program.module()
        self._params = params
        self._frozen = frozen
        self._buffers = buffers
        self._manifest = manifest

    @property
    def input_spec(self):
        return [InputSpec(s['shape'], s['dtype'])
                for s in self._manifest.get('input_spec', [])]

    def named_parameters(self):
        yield from {**self._params, **self._frozen}.items()

    def eval(self):
        return self

    def __call__(self, *args):
        found = [False]
        vals = _unwrap(args, found)
        device = torch.device(self._manifest.get('device', 'cpu'))
        vals = tuple(
            torch.as_tensor(v if isinstance(v, torch.Tensor)
                            else np.asarray(v), device=device).to(
                to_torch_dtype(spec['dtype']))
            for v, spec in zip(vals, self._manifest['input_spec']))
        with torch.no_grad():
            out = self._module(self._params, self._frozen, self._buffers,
                               *vals)
        return _wrap(out) if found[0] else out


def _reject(path: str, exc: Exception) -> ProgramDeserializeError:
    """A damaged program file: the JAX load's event and counter, then the
    typed error."""
    _obs.emit('program_cache_reject', path=path, reason='deserialize',
              error=type(exc).__name__)
    if _obs.enabled():
        _obs.get_registry().counter(
            'paddle_program_cache_rejects_total',
            'persisted entries rejected at load',
            ('reason',)).labels(reason='deserialize').inc()
    return ProgramDeserializeError(path, f'{type(exc).__name__}: {exc}')


def load(path, layer=None):
    """Load a `jit.save` artifact. With `layer`, restore the npz's state
    into it (every name must match; a JAX `jit.save`'s npz too) and
    return it as a StaticLayer. Without, load the exported program and
    return a `TranslatedLayer`: no Python class needed."""
    data = np.load(path + '.pdiparams.npz')
    if layer is not None:
        target = layer._target if isinstance(layer, StaticLayer) else layer
        _copy_by_name({k.split('::', 1)[1]: data[k] for k in data.files},
                      target.state_dict(),
                      f'{path}.pdiparams.npz does not match the layer')
        return layer if isinstance(layer, StaticLayer) else StaticLayer(layer)
    pt2 = path + '.pdmodel.pt2'
    if not os.path.exists(pt2):
        hlo = path + '.pdmodel.stablehlo'
        if os.path.exists(hlo):
            raise ProgramDeserializeError(
                hlo, 'a JAX StableHLO program (format "stablehlo"); this '
                'package loads "torch.export" programs: pass layer= to '
                'restore the weights from the npz')
        raise ValueError(f'{pt2} not found: pass the layer instance to '
                         f'restore into')
    try:
        program = torch.export.load(pt2)
    except Exception as exc:  # any failure to read the file is this one
        raise _reject(pt2, exc) from exc
    with open(path + '.pdmodel.json') as f:
        manifest = json.load(f)
    device = torch.device(manifest.get('device', 'cpu'))
    dtypes = manifest.get('dtypes', {})
    frozen_names = set(manifest.get('frozen', []))
    params, frozen, buffers = {}, {}, {}
    for k in data.files:
        kind, name = k.split('::', 1)
        t = torch.from_numpy(np.array(data[k])).to(device)
        if name in dtypes:
            t = t.to(to_torch_dtype(dtypes[name]))
        if kind == 'buffer':
            buffers[name] = t
        elif name in frozen_names:
            frozen[name] = t
        else:
            params[name] = t
    return TranslatedLayer(program, params, frozen, buffers, manifest)



def _to_device(value, device: torch.device):
    if value is None:
        return None
    if isinstance(value, tuple):
        return tuple(_to_device(v, device) for v in value)
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.as_tensor(np.asarray(value), device=device)


class TrainStep:
    """One training step of `layer`: `step(inputs, labels)` runs the
    forward (`layer(*inputs)` for a tuple, else `layer(inputs)`),
    `loss_fn(output, labels)`, the backward and `optimizer`'s update of
    every trainable parameter of `layer` (named by `named_parameters()`,
    as the JAX step names its parameter tree), then drops the grads.
    Numpy or tensor inputs go to the layer's device. Returns the loss as
    a detached device tensor, without waiting for the device."""

    def __init__(self, layer: torch.nn.Module, loss_fn: Callable,
                 optimizer):
        self.layer = layer
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._params = [(n, p) for n, p in layer.named_parameters()
                        if p.requires_grad]
        if not self._params:
            raise ValueError('TrainStep: the layer has no trainable '
                             'parameters')
        self.device = self._params[0][1].device
        self._n_calls = 0

    def __call__(self, inputs, labels) -> torch.Tensor:
        t0 = time.perf_counter()
        with _obs.span('train.step'):
            inputs = _to_device(inputs, self.device)
            labels = _to_device(labels, self.device)
            with torch.enable_grad():
                out = self.layer(*inputs) if isinstance(inputs, tuple) \
                    else self.layer(inputs)
                loss = self.loss_fn(out, labels)
                del out
                loss.backward()
            self.optimizer.update(self._params)
            for _, p in self._params:
                p.grad = None
        if self._n_calls == 0:
            _obs.note_jit_cache_entry('train_step')
        self._n_calls += 1
        if _obs.enabled():
            cat = _cost.get_catalog()
            cat.note_invocation('train_step', time.perf_counter() - t0,
                                kind='train')
            cat.note_cost('train_step', *self._cost(inputs), kind='train')
        return loss.detach()

    def opt_state(self) -> dict:
        """The optimizer's state in the JAX step's `_opt_state` layout:
        {'step': updates so far, 'slots': {parameter name: {slot name:
        tensor}}}, parameters without slots yet left out. The tensors are
        the optimizer's own (on the card, or the host buffers of an
        offloaded optimizer, its copies settled): a caller that keeps
        them copies them."""
        opt = self.optimizer
        opt._settle()
        return {'step': opt._step_count,
                'slots': {n: opt._slots[p] for n, p in self._params
                          if p in opt._slots}}

    def load_opt_state(self, state) -> None:
        """Copy `state` (`opt_state()`'s layout, with tensors or numpy
        arrays: a JAX step's `_opt_state` on the host loads too) into the
        optimizer's slots in place, made first where missing, so no slot
        moves. None, or no slots: the state before the first update."""
        opt = self.optimizer
        if state is None or not state.get('slots'):
            opt.reset_state()
            return
        opt._settle()
        opt._prepare_slots([p for _, p in self._params])
        for n, p in self._params:
            if n in state['slots']:
                _copy_by_name(state['slots'][n], opt._slots_for(p),
                              f'optimizer slots of {n} do not match')
        opt._step_count = int(np.asarray(state['step']))

    def _cost(self, inputs) -> tuple:
        """Analytic (FLOPs, bytes) of one step. A layer with a
        transformer config (`observability.cost.TransformerCost`) over
        [B, S] token ids: 3 forward passes' FLOPs (the forward, and the
        backward's two) with causal attention over S, and its weights
        read by the forward and the backward; any other layer: 6 FLOPs
        per trainable parameter per input row. Both add the update's
        traffic: parameters read and written, gradients read, and two
        fp32 moments read and written. Activations are not counted: the
        bytes are a lower bound."""
        x = inputs[0] if isinstance(inputs, tuple) else inputs
        n = sum(p.numel() for _, p in self._params)
        pbytes = sum(p.numel() * p.element_size() for _, p in self._params)
        update = 3 * pbytes + 16 * n
        cfg = getattr(self.layer, 'config', None)
        if getattr(cfg, 'intermediate_size', None) is not None \
                and x.dim() == 2 and not x.is_floating_point():
            b, s = x.shape
            fwd = _cost.TransformerCost(cfg, self._params[0][1]
                                        .element_size())
            flops, nbytes = fwd.forward(b * s, b * s * (s + 1) // 2,
                                        0, b * s)
            return 3 * flops, 2 * nbytes + pbytes + update
        rows = x.numel() if not x.is_floating_point() else \
            x.numel() // max(x.shape[-1], 1)
        return 6.0 * n * rows, 2 * pbytes + pbytes + update


__all__ = ['InputSpec', 'ProgramDeserializeError', 'StaticLayer',
           'TrainStep', 'TranslatedLayer', 'enable_to_static',
           'functional_call', 'functional_method', 'functional_state',
           'ignore_module', 'load', 'not_to_static', 'save', 'to_static']
