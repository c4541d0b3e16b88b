"""Eager autograd on torch's engine (counterpart of `paddle_tpu/autograd.py`).

The JAX package records a `jax.vjp` per op on a tape of its own; the
port's Tensors carry torch tensors, so torch's autograd records and runs
the graph, and this module gives it Paddle's surface: grad mode,
`backward`, `grad` (to any order with `create_graph`), `PyLayer` on
`torch.autograd.Function`, and `jacobian`/`hessian` of computed
outputs.
"""
from __future__ import annotations

import torch

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def _values(ts):
    from .tensor import to_torch
    return [to_torch(t) for t in ts]


def _seed(out: torch.Tensor, g, what: str):
    """The output gradient: `g`, or ones for a one-element output."""
    from .tensor import to_torch
    if g is not None:
        g = to_torch(g)
        return g if isinstance(g, torch.Tensor) else torch.as_tensor(
            g, dtype=out.dtype, device=out.device)
    if out.numel() != 1:
        raise RuntimeError(
            'grad can be implicitly created only for scalar outputs; pass '
            f'{what} for non-scalar outputs')
    return torch.ones_like(out)


def backward(outputs, grad_tensors=None, retain_graph=False):
    """Accumulate the gradients of `outputs` into the leaves' `.grad`
    (Paddle's paddle.autograd.backward). Outputs that stop the gradient
    are skipped."""
    if not isinstance(outputs, (list, tuple)):
        outputs = [outputs]
    if grad_tensors is None:
        grad_tensors = [None] * len(outputs)
    elif not isinstance(grad_tensors, (list, tuple)):
        grad_tensors = [grad_tensors]
    outs, grads = [], []
    for o, g in zip(_values(outputs), grad_tensors):
        if not o.requires_grad:
            continue
        outs.append(o)
        grads.append(_seed(o, g, 'grad_tensors'))
    if outs:
        torch.autograd.backward(outs, grads, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: the gradients of `outputs` with respect to `inputs`,
    leaving every `.grad` untouched. With `create_graph` the results are
    differentiable again, to any order. The tensors of `no_grad_vars`
    are held constant: no gradient flows back through them (the JAX
    package cuts its tape there), which is a hook that zeroes each one's
    gradient during this call."""
    if no_grad_vars is not None and not isinstance(no_grad_vars,
                                                   (list, tuple)):
        no_grad_vars = [no_grad_vars]
    cut = [v.register_hook(torch.zeros_like)
           for v in _values(no_grad_vars or []) if v.requires_grad]
    try:
        return _grad(outputs, inputs, grad_outputs, retain_graph,
                     create_graph, allow_unused)
    finally:
        for handle in cut:
            handle.remove()


def _grad(outputs, inputs, grad_outputs, retain_graph, create_graph,
          allow_unused):
    from .tensor import Tensor
    single = not isinstance(inputs, (list, tuple))
    ins = _values([inputs] if single else inputs)
    outs_l = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    if grad_outputs is None:
        grad_outputs = [None] * len(outs_l)
    elif not isinstance(grad_outputs, (list, tuple)):
        grad_outputs = [grad_outputs]
    outs, seeds = [], []
    for o, g in zip(_values(outs_l), grad_outputs):
        if o.requires_grad:
            outs.append(o)
            seeds.append(_seed(o, g, 'grad_outputs'))
    res = [None] * len(ins)
    if outs:
        res = list(torch.autograd.grad(
            outs, ins, seeds, retain_graph=retain_graph,
            create_graph=create_graph, allow_unused=True))
    if not allow_unused and any(r is None for r in res):
        raise RuntimeError('one of the inputs was not used in the graph; '
                           'set allow_unused=True to return None for it')
    res = [None if r is None else Tensor(r) for r in res]
    return res[0] if single else res


# ---------------------------------------------------------------------------
# PyLayer: a user-written forward and backward (Paddle's
# paddle.autograd.PyLayer), on torch.autograd.Function
# ---------------------------------------------------------------------------

class PyLayerContext:
    """Passed as `ctx` to PyLayer.forward and backward."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *tensors):
        self._saved = tuple(tensors)

    def saved_tensor(self):
        return list(self._saved)


class _Slot:
    """Where a Tensor argument sits in a PyLayer call's arguments."""

    def __init__(self, i):
        self.i = i


def _place(obj, fill):
    if isinstance(obj, _Slot):
        return fill[obj.i]
    if isinstance(obj, (list, tuple)):
        return type(obj)(_place(o, fill) for o in obj)
    return obj


class _PyLayerFunction(torch.autograd.Function):
    """One PyLayer call: `spec` = (the PyLayer class, its arguments with
    the Tensors replaced by slots, its context, a dict for the Python
    output), then the Tensors' values."""

    @staticmethod
    def forward(ctx, spec, *vals):
        from .tensor import Tensor, to_torch
        cls, (args, kwargs), pyctx, holder = spec
        ts = [Tensor(v) for v in vals]
        out = cls.forward(pyctx, *_place(args, ts),
                          **{k: _place(v, ts) for k, v in kwargs.items()})
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        for o in outs:
            if not isinstance(o, Tensor):
                raise TypeError('PyLayer.forward must return Tensor(s)')
        holder['out'] = out
        ctx.spec, ctx.n_in = spec, len(vals)
        return tuple(to_torch(o) for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        from .tensor import Tensor, to_torch
        cls, _, pyctx, _ = ctx.spec
        gin = cls.backward(pyctx, *[Tensor(g) for g in grads])
        gin = gin if isinstance(gin, (tuple, list)) else (gin,)
        if len(gin) != ctx.n_in:
            raise RuntimeError(f'{cls.__name__}.backward returned {len(gin)} '
                               f'grads for {ctx.n_in} Tensor inputs')
        return (None,) + tuple(None if g is None else to_torch(g)
                               for g in gin)


class PyLayer:
    """A custom op with a hand-written gradient:

        class Cube(PyLayer):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x * x * x
            @staticmethod
            def backward(ctx, grad):
                x, = ctx.saved_tensor()
                return 3 * x * x * grad

        y = Cube.apply(x)

    `forward` runs with grad recording off (its ops are not
    differentiated: `backward` is the gradient); the Tensor arguments
    are the inputs the gradient flows to, and `backward` returns one
    gradient (or None) for each of them. Under `paddle.grad(...,
    create_graph=True)` the ops of `backward` are recorded, so a second
    derivative goes through it."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        from .tensor import Tensor
        tensors = []

        def slot(obj):
            if isinstance(obj, Tensor):
                tensors.append(obj)
                return _Slot(len(tensors) - 1)
            if isinstance(obj, (list, tuple)):
                return type(obj)(slot(o) for o in obj)
            return obj
        call = (slot(args), {k: slot(v) for k, v in kwargs.items()})
        holder = {}
        outs = _PyLayerFunction.apply(
            (cls, call, PyLayerContext(), holder),
            *[t.value for t in tensors])
        wrapped = [Tensor(o) for o in outs]
        out = holder['out']
        if isinstance(out, (tuple, list)):
            return type(out)(wrapped)
        return wrapped[0]


# ---------------------------------------------------------------------------
# jacobian / hessian of computed outputs (Paddle's paddle.autograd)
# ---------------------------------------------------------------------------

def _jac_rows(y: torch.Tensor, xs, create_graph=False):
    """[y.numel, x.numel] for each x: one gradient per element of y."""
    flat = y.reshape(-1)
    rows = [[] for _ in xs]
    for i in range(flat.numel()):
        gs = torch.autograd.grad(flat[i], xs, retain_graph=True,
                                 create_graph=create_graph,
                                 allow_unused=True)
        for r, g, x in zip(rows, gs, xs):
            r.append(torch.zeros_like(x).reshape(-1) if g is None
                     else g.reshape(-1))
    return [torch.stack(r) if r else torch.zeros(0, x.numel(), dtype=x.dtype,
                                                  device=x.device)
            for r, x in zip(rows, xs)]


def _reachable(y: torch.Tensor, xs) -> bool:
    """Whether the gradient of y reaches any of xs."""
    if not y.requires_grad:
        return False
    gs = torch.autograd.grad(y.sum(), xs, retain_graph=True,
                             allow_unused=True)
    return any(g is not None for g in gs)


def jacobian(ys, xs, batch_axis=None):
    """paddle.autograd.jacobian: the dense Jacobian of computed `ys` with
    respect to `xs`, [ys.numel, xs.numel]; with batch_axis=0 the
    per-sample diagonal [B, ys.numel / B, xs.numel / B]. Lists give
    (tuples of) results as in Paddle."""
    from .tensor import Tensor
    if batch_axis not in (None, 0):
        raise NotImplementedError('batch_axis must be None or 0')
    ys_l = [ys] if not isinstance(ys, (list, tuple)) else list(ys)
    xs_l = [xs] if not isinstance(xs, (list, tuple)) else list(xs)
    xv = _values(xs_l)
    rows = []
    for y in _values(ys_l):
        if not _reachable(y, xv):
            raise RuntimeError('xs is not reachable from ys on the tape')
        jacs = _jac_rows(y, xv)
        out = []
        for j, x in zip(jacs, xv):
            if batch_axis == 0:
                by, bx = y.shape[0], x.shape[0]
                j4 = j.reshape(by, y.numel() // by, bx, x.numel() // bx)
                j = torch.diagonal(j4, dim1=0, dim2=2).permute(2, 0, 1)
            out.append(Tensor(j))
        rows.append(out[0] if not isinstance(xs, (list, tuple))
                    else tuple(out))
    return rows[0] if not isinstance(ys, (list, tuple)) else tuple(rows)


def hessian(ys, xs, batch_axis=None):
    """paddle.autograd.hessian: the Hessian of a one-element `ys` with
    respect to `xs`, [[x_i.numel, x_j.numel]] blocks."""
    from .tensor import Tensor
    y = _values([ys])[0]
    if y.numel() != 1:
        raise ValueError('hessian requires a scalar ys Tensor')
    if batch_axis is not None:
        raise NotImplementedError('hessian supports batch_axis=None only')
    xs_l = [xs] if not isinstance(xs, (list, tuple)) else list(xs)
    xv = _values(xs_l)
    gs = torch.autograd.grad(y.reshape(()), xv, create_graph=True,
                             allow_unused=True)
    if any(g is None for g in gs):
        raise RuntimeError('xs is not reachable from ys on the tape')
    blocks = [_jac_rows(g, xv) for g in gs]
    out = tuple(tuple(Tensor(b.detach()) for b in row) for row in blocks)
    return out[0][0] if not isinstance(xs, (list, tuple)) else out
