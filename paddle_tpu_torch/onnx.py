"""paddle.onnx (counterpart of `paddle_tpu/onnx.py`; upstream:
python/paddle/onnx/export.py, which delegates to paddle2onnx's
Paddle-IR graph walk).

The layer's eval forward is traced once by `torch.export`, as
`paddle.jit.save` traces it (`jit._InferFn`: the state passed in as
inputs), lowered to core ATen (`run_decompositions`) but for `linear`,
`matmul` and `einsum`, and each ATen op is mapped to ONNX nodes: `mm` /
`bmm` / `matmul` to MatMul, `addmm` and `linear` (a 2-D input) to Gemm,
`einsum` to Einsum, `convolution` to Conv, indexing to Gather, softmax,
layer norm and GELU to their elementwise subgraphs. Parameters and
buffers become initializers (bf16 ones stored as fp32 and cast back),
so the ModelProto is self-contained. An op without a mapping raises,
naming it.

While exporting, the port's kernel wrappers record their export ops
(`ops/kernels.py`): `paddle_tpu_torch::rms_norm_fwd`,
`::flash_attention_fwd` and `::softmax_ce_fwd`. Each is lowered to the
ONNX subgraph of its plain version: RMSNorm normalizes in fp32 and casts
to x's dtype before the weight multiply; attention takes its logits and
softmax in fp32, masks causally aligned bottom-right and folds GQA heads
as [HKV, G]; CE gives (nll, lse) in fp32, nll = lse for a label outside
[0, V).

The `onnx` package is only needed for protobuf assembly; when it cannot
be imported, `export` raises a gate pointing at `paddle.jit.save`,
whose torch.export artifact is the port's portable format. The
converter itself runs through `_onnx_api`, any object with the onnx
helper surface (`helper`, `numpy_helper`, `TensorProto`).
"""
from __future__ import annotations

import math
import operator
from typing import Any, Dict, List

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = ['export']


def export(layer, path, input_spec=None, opset_version=13, **configs):
    """Write `layer`'s eval forward as an ONNX ModelProto at `path`.

    input_spec: list of InputSpec (or example Tensors/ndarrays). Dynamic
    (None) dims are materialized at size 1 and exported as symbolic dims;
    graphs with internal reshapes (e.g. attention head splits) bake the
    example sizes into the reshape targets, so models with reshapes
    should be exported with static shapes.
    """
    onnx_api = configs.pop('_onnx_api', None)
    if onnx_api is None:
        try:
            import onnx as onnx_api  # noqa: F811
        except ImportError as e:
            raise RuntimeError(
                'paddle.onnx.export requires the `onnx` package, which is '
                'not available in this build. Use paddle.jit.save(layer, '
                'path, input_spec) instead: it writes a self-contained '
                'torch.export program + params artifact that '
                'paddle.jit.load runs on the card or the CPU without the '
                'original model class.') from e
    if not 13 <= int(opset_version) <= 17:
        # the emitted node forms (ReduceSum axes-as-input, Reduce* axes
        # attribute, Einsum, Where) are exactly the opset 13-17 dialect
        raise ValueError(
            f'paddle.onnx.export emits opset 13-17 semantics; '
            f'got opset_version={opset_version}')
    model = build_model(layer, input_spec, opset_version, onnx_api)
    out_path = path if str(path).endswith('.onnx') else str(path) + '.onnx'
    with open(out_path, 'wb') as f:
        f.write(model.SerializeToString())
    return out_path


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def _example_inputs(input_spec, device):
    from .jit import InputSpec
    from .dtype import to_torch_dtype
    from .tensor import Tensor
    samples, dyn_axes = [], []
    for spec in input_spec:
        if isinstance(spec, InputSpec):
            shape = [1 if s is None else int(s) for s in spec.shape]
            dyn = [i for i, s in enumerate(spec.shape) if s is None]
            t = torch.zeros(shape, dtype=to_torch_dtype(spec.dtype),
                            device=device)
        else:
            v = spec.value if isinstance(spec, Tensor) else spec
            t = torch.as_tensor(np.asarray(v) if not isinstance(
                v, torch.Tensor) else v).to(device)
            dyn = []
        samples.append(t)
        dyn_axes.append(dyn)
    return samples, dyn_axes


def _decompositions() -> dict:
    """Core ATen's decompositions but for the contractions ONNX has
    nodes for (`linear` -> Gemm, `matmul` -> MatMul, `einsum` -> Einsum)."""
    table = torch.export.default_decompositions()
    for op in (torch.ops.aten.linear.default, torch.ops.aten.matmul.default,
               torch.ops.aten.einsum.default):
        table.pop(op, None)
    return table


def build_model(layer, input_spec, opset_version, onnx_api):
    """Trace layer -> torch.export graph (core ATen) -> ONNX GraphProto ->
    ModelProto."""
    from . import framework
    from .jit import StaticLayer, _InferFn, functional_state

    if input_spec is None:
        raise ValueError('paddle.onnx.export needs input_spec')
    target = layer._target if isinstance(layer, StaticLayer) else layer
    params, frozen, buffers = functional_state(target)
    state = {**params, **frozen, **buffers}
    device = (next(iter(state.values())).device if state
              else framework.current_device())
    samples, dyn_axes = _example_inputs(input_spec, device)
    was_training = target.training
    target.eval()
    try:
        with torch.no_grad():
            detached = [{n: t.detach() for n, t in d.items()}
                        for d in (params, frozen, buffers)]
            program = torch.export.export(_InferFn(target),
                                          (*detached, *samples))
        program = program.run_decompositions(_decompositions())
    finally:
        if was_training:
            target.train()

    # the user inputs arrive as placeholders in pytree order: the state
    # dicts' entries, then the forward's arguments
    values = pytree.tree_leaves((*detached, *samples))
    names = pytree.tree_leaves(
        (*({n: n for n in d} for d in detached),
         *(f'x{i}' for i in range(len(samples)))))
    n_state = len(values) - len(samples)
    conv = _Converter(onnx_api)
    placeholders = [n for n in program.graph.nodes if n.op == 'placeholder']
    user = 0
    for node, spec in zip(placeholders, program.graph_signature.input_specs):
        kind = spec.kind.name
        if kind == 'USER_INPUT':
            if user < n_state:
                conv.add_initializer(names[user], values[user], node)
            else:
                conv.add_input(names[user], node,
                               dyn_axes[user - n_state])
            user += 1
        elif kind == 'CONSTANT_TENSOR':
            conv.add_initializer(conv.fresh('const'),
                                 program.constants[spec.target], node)
        else:               # a parameter or buffer lifted by the export
            conv.add_initializer(spec.target,
                                 program.state_dict[spec.target], node)
    conv.convert(program.graph)
    out_node = next(n for n in program.graph.nodes if n.op == 'output')
    outs = pytree.tree_leaves(out_node.args[0])
    return conv.finish(outs, opset_version)


# ---------------------------------------------------------------------------
# ATen graph -> ONNX graph
# ---------------------------------------------------------------------------

_DTYPE_TO_ONNX = {
    torch.float32: 'FLOAT', torch.float64: 'DOUBLE',
    torch.float16: 'FLOAT16', torch.bfloat16: 'BFLOAT16',
    torch.int64: 'INT64', torch.int32: 'INT32', torch.int16: 'INT16',
    torch.int8: 'INT8', torch.uint8: 'UINT8', torch.bool: 'BOOL',
}

_UNARY = {
    'exp': 'Exp', 'log': 'Log', 'tanh': 'Tanh', 'abs': 'Abs',
    'neg': 'Neg', 'sqrt': 'Sqrt', 'sign': 'Sign', 'floor': 'Floor',
    'ceil': 'Ceil', 'sin': 'Sin', 'cos': 'Cos', 'erf': 'Erf',
    'sigmoid': 'Sigmoid', 'reciprocal': 'Reciprocal', 'round': 'Round',
    'logical_not': 'Not', 'bitwise_not': 'Not', 'isinf': 'IsInf',
    'isnan': 'IsNaN',
}

_BINARY = {
    'add': 'Add', 'sub': 'Sub', 'mul': 'Mul', 'div': 'Div', 'pow': 'Pow',
    'maximum': 'Max', 'minimum': 'Min', 'logical_and': 'And',
    'logical_or': 'Or', 'logical_xor': 'Xor', 'bitwise_and': 'And',
    'bitwise_or': 'Or', 'bitwise_xor': 'Xor',
}

_COMPARE = {'eq': 'Equal', 'gt': 'Greater', 'ge': 'GreaterOrEqual',
            'lt': 'Less', 'le': 'LessOrEqual'}

_RESHAPES = {'view', 'reshape', 'unsqueeze', 'squeeze', 'flatten',
             'view_as'}

_IDENTITY = {'clone', 'contiguous', 'lift_fresh_copy', 'alias', 'dropout',
             'feature_dropout'}

# the ops `_Converter._aten` maps by table
_TABLED = (set(_UNARY) | set(_BINARY) | set(_COMPARE) | {'ne'} | _RESHAPES
           | _IDENTITY)

_NO_OUTPUT = {'_assert_tensor_metadata', '_assert_async',
              '_assert_scalar', 'sym_constrain_range_for_size'}

# what an unmasked logit is set to under the causal mask (the plain
# version's fill, fp32 min)
_NEG_INF = float(torch.finfo(torch.float32).min)


def _meta(node):
    return node.meta['val']


def _shape(node):
    return [int(s) for s in _meta(node).shape]


def _args(node) -> Dict[str, Any]:
    """The node's arguments by schema name, defaults filled in."""
    schema = node.target._schema
    out = {}
    for i, a in enumerate(schema.arguments):
        if i < len(node.args) and not a.kwarg_only:
            out[a.name] = node.args[i]
        elif a.name in node.kwargs:
            out[a.name] = node.kwargs[a.name]
        elif a.has_default_value():
            out[a.name] = a.default_value
        else:
            out[a.name] = None
    return out


def _axes(dims, rank):
    if dims is None:
        return list(range(rank))
    if isinstance(dims, int):
        dims = [dims]
    return [int(d) % rank for d in dims]


class _Converter:
    def __init__(self, onnx_api):
        self.api = onnx_api
        self.nodes: List[Any] = []
        self.initializers: List[Any] = []
        self.inputs: List[Any] = []
        self.names: Dict[Any, Any] = {}  # fx Node -> value name(s)
        self._ctr = 0

    # -- naming -------------------------------------------------------------
    def fresh(self, hint='v'):
        self._ctr += 1
        return f'{hint}_{self._ctr}'

    def _elem_type(self, dtype):
        key = _DTYPE_TO_ONNX.get(dtype)
        if key is None:
            raise NotImplementedError(
                f'paddle.onnx.export: dtype {dtype} has no ONNX mapping')
        return getattr(self.api.TensorProto, key)

    # -- graph pieces -------------------------------------------------------
    def add_input(self, name, node, dyn_axes=()):
        shape = [f'dyn_{i}' if i in dyn_axes else s
                 for i, s in enumerate(_shape(node))]
        self.inputs.append(self.api.helper.make_tensor_value_info(
            name, self._elem_type(_meta(node).dtype), shape))
        self.names[node] = name

    def add_initializer(self, name, value, node=None):
        t = value.detach().cpu() if isinstance(value, torch.Tensor) \
            else torch.as_tensor(value)
        if t.dtype == torch.bfloat16:
            # numpy has no bf16 container: store fp32 and Cast back to
            # BFLOAT16 so the graph stays type-consistent where the
            # traced computation runs in bf16
            self.initializers.append(self.api.numpy_helper.from_array(
                t.float().numpy(), name + '_fp32'))
            out = self.node('Cast', [name + '_fp32'],
                            to=self.api.TensorProto.BFLOAT16)
        else:
            self.initializers.append(self.api.numpy_helper.from_array(
                np.ascontiguousarray(t.numpy()), name))
            out = name
        if node is not None:
            self.names[node] = out
        return out

    def node(self, op, ins, n_out=1, **attrs):
        outs = [self.fresh(op.lower()) for _ in range(n_out)]
        self.nodes.append(self.api.helper.make_node(op, ins, outs, **attrs))
        return outs[0] if n_out == 1 else outs

    def const(self, value, dtype, hint='c'):
        return self.add_initializer(self.fresh(hint),
                                    torch.tensor(value, dtype=dtype))

    def const_i64(self, values, hint='shape'):
        return self.const(list(values), torch.int64, hint)

    def operand(self, a, dtype=None):
        """The value name of an argument (an fx Node or a Python scalar),
        cast to `dtype` where given and different."""
        if isinstance(a, torch.fx.Node):
            name = self.names[a]
            if dtype is not None and _meta(a).dtype != dtype:
                name = self.cast(name, dtype)
            return name
        return self.const(a, dtype if dtype is not None else
                          torch.get_default_dtype(), 'scalar')

    def cast(self, name, dtype):
        return self.node('Cast', [name], to=self._elem_type(dtype))

    def reduce_sum(self, x, axes, keepdims):
        return self.node('ReduceSum', [x, self.const_i64(axes, 'axes')],
                         keepdims=int(keepdims))

    def reduce_mean(self, x, axes, keepdims, shape, dtype):
        count = int(np.prod([shape[a] for a in axes])) if axes else 1
        return self.node('Div', [self.reduce_sum(x, axes, keepdims),
                                 self.const(float(count), dtype, 'count')])

    def softmax(self, x, axis, log=False):
        m = self.node('ReduceMax', [x], axes=[axis], keepdims=1)
        d = self.node('Sub', [x, m])
        e = self.node('Exp', [d])
        s = self.reduce_sum(e, [axis], True)
        if log:
            return self.node('Sub', [d, self.node('Log', [s])])
        return self.node('Div', [e, s])

    # -- conversion ---------------------------------------------------------
    def convert(self, graph):
        for node in graph.nodes:
            if node.op == 'call_function':
                self._call(node)

    def _call(self, node):
        tgt = node.target
        if tgt is operator.getitem:
            src, idx = node.args
            self.names[node] = self.names[src][idx]
            return
        if not isinstance(tgt, torch._ops.OpOverload):
            raise NotImplementedError(
                f'paddle.onnx.export: `{tgt}` has no ONNX mapping; export '
                f'this submodule with paddle.jit.save (torch.export) '
                f'instead')
        ns, _, op = tgt._schema.name.partition('::')
        if op in _NO_OUTPUT:
            return
        prefix = {'aten': '_aten_', 'paddle_tpu_torch': '_kernel_'}.get(ns)
        handler = getattr(self, f'{prefix}{op}', None) if prefix else None
        if ns == 'aten' and not any(
                isinstance(a, torch.fx.Node)
                for a in pytree.tree_leaves((node.args, node.kwargs))):
            out = self._fold(node)
        elif handler is None and not (ns == 'aten' and op in _TABLED):
            raise NotImplementedError(
                f'paddle.onnx.export: op `{ns}::{op}` has no ONNX mapping; '
                f'export this submodule with paddle.jit.save (torch.export) '
                f'instead')
        elif ns == 'paddle_tpu_torch':
            out = handler(node, _args(node))
        else:
            out = self._aten(node, op, handler)
        self.names[node] = out

    def _fold(self, node):
        """An op of constants only (full, arange, scalar_tensor, ...):
        evaluated once on the CPU and kept as an initializer."""
        kwargs = dict(node.kwargs)
        if 'device' in kwargs:
            kwargs['device'] = 'cpu'
        value = node.target(*node.args, **kwargs)
        return self.add_initializer(self.fresh('folded'), value)

    def _aten(self, node, op, handler):
        a = _args(node)
        out_dtype = _meta(node).dtype if isinstance(
            _meta(node), torch.Tensor) else None
        if handler is not None:
            return handler(node, a)
        x = a.get('self', a.get('input'))
        if op in _UNARY:
            return self.node(_UNARY[op], [self.operand(x)])
        if op in _BINARY:
            other = a['other'] if 'other' in a else a.get('exponent')
            ins = [self.operand(x, out_dtype),
                   self.operand(other, out_dtype)]
            alpha = a.get('alpha', 1)
            if op in ('add', 'sub') and alpha not in (None, 1):
                ins[1] = self.node('Mul', [ins[1],
                                           self.const(alpha, out_dtype)])
            if op == 'div' and a.get('rounding_mode') is not None:
                if a['rounding_mode'] != 'floor' \
                        or not out_dtype.is_floating_point:
                    raise NotImplementedError(
                        f'paddle.onnx.export: div rounding_mode='
                        f'{a["rounding_mode"]!r} has no ONNX mapping; use '
                        f'paddle.jit.save (torch.export) instead')
                return self.node('Floor', [self.node('Div', ins)])
            return self.node(_BINARY[op], ins)
        if op in _COMPARE or op == 'ne':
            other = a['other']
            dt = (torch.promote_types(_meta(x).dtype, _meta(other).dtype)
                  if isinstance(other, torch.fx.Node) else _meta(x).dtype)
            ins = [self.operand(x, dt), self.operand(other, dt)]
            if op == 'ne':
                return self.node('Not', [self.node('Equal', ins)])
            return self.node(_COMPARE[op], ins)
        if op in _RESHAPES:
            return self.node('Reshape', [self.operand(x),
                                         self.const_i64(_shape(node))])
        # _IDENTITY
        return self.node('Identity', [self.operand(x)])

    # -- elementwise ----------------------------------------------------------
    def _aten_rsqrt(self, node, a):
        return self.node('Reciprocal',
                         [self.node('Sqrt', [self.operand(a['self'])])])

    def _aten_log1p(self, node, a):
        x = self.operand(a['self'])
        return self.node('Log', [self.node(
            'Add', [x, self.const(1.0, _meta(node).dtype)])])

    def _aten_relu(self, node, a):
        return self.node('Max', [self.operand(a['self']),
                                 self.const(0, _meta(node).dtype)])

    def _aten_gelu(self, node, a):
        dt = _meta(node).dtype
        x = self.operand(a['self'])
        half = self.node('Mul', [x, self.const(0.5, dt)])
        if a['approximate'] == 'tanh':
            cube = self.node('Mul', [x, self.node('Mul', [x, x])])
            inner = self.node('Add', [x, self.node(
                'Mul', [cube, self.const(0.044715, dt)])])
            t = self.node('Tanh', [self.node(
                'Mul', [inner, self.const(math.sqrt(2.0 / math.pi), dt)])])
        else:
            t = self.node('Erf', [self.node(
                'Mul', [x, self.const(1.0 / math.sqrt(2.0), dt)])])
        return self.node('Mul', [half, self.node(
            'Add', [t, self.const(1.0, dt)])])

    def _aten_where(self, node, a):
        dt = _meta(node).dtype
        return self.node('Where', [self.operand(a['condition']),
                                   self.operand(a['self'], dt),
                                   self.operand(a['other'], dt)])

    def _aten_clamp(self, node, a):
        dt = _meta(node).dtype
        x = self.operand(a['self'], dt)
        if a['min'] is not None:
            x = self.node('Max', [x, self.operand(a['min'], dt)])
        if a['max'] is not None:
            x = self.node('Min', [x, self.operand(a['max'], dt)])
        return x

    def _aten__to_copy(self, node, a):
        x = a['self']
        if _meta(x).dtype == _meta(node).dtype:
            return self.node('Identity', [self.operand(x)])
        return self.cast(self.operand(x), _meta(node).dtype)

    # -- layout -------------------------------------------------------------
    def _aten_permute(self, node, a):
        rank = len(_shape(a['self']))
        return self.node('Transpose', [self.operand(a['self'])],
                         perm=_axes(a['dims'], rank))

    def _aten_expand(self, node, a):
        return self.node('Expand', [self.operand(a['self']),
                                    self.const_i64(_shape(node))])

    def _aten_cat(self, node, a):
        dt = _meta(node).dtype
        rank = len(_shape(node))
        return self.node('Concat', [self.operand(t, dt)
                                    for t in a['tensors']],
                         axis=int(a['dim']) % rank)

    def _aten_slice(self, node, a):
        x = a['self']
        shape = _shape(x)
        dim = int(a['dim']) % len(shape)
        size = shape[dim]
        start = 0 if a['start'] is None else int(a['start'])
        end = size if a['end'] is None else int(a['end'])
        start = max(0, min(size, start + size if start < 0 else start))
        end = max(0, min(size, end + size if end < 0 else end))
        return self.node('Slice', [
            self.operand(x), self.const_i64([start], 'starts'),
            self.const_i64([end], 'ends'), self.const_i64([dim], 'axes'),
            self.const_i64([int(a['step'])], 'steps')])

    def _aten_split_with_sizes(self, node, a):
        x = a['self']
        shape = _shape(x)
        dim = int(a['dim']) % len(shape)
        outs, start = [], 0
        for size in a['split_sizes']:
            outs.append(self.node('Slice', [
                self.operand(x), self.const_i64([start], 'starts'),
                self.const_i64([start + int(size)], 'ends'),
                self.const_i64([dim], 'axes')]))
            start += int(size)
        return outs

    def _aten_select(self, node, a):
        x = a['self']
        shape = _shape(x)
        dim = int(a['dim']) % len(shape)
        i = int(a['index']) % shape[dim]
        sl = self.node('Slice', [
            self.operand(x), self.const_i64([i], 'starts'),
            self.const_i64([i + 1], 'ends'), self.const_i64([dim], 'axes')])
        return self.node('Reshape', [sl, self.const_i64(_shape(node))])

    def _aten_index(self, node, a):
        idx = list(a['indices'])
        live = [i for i, t in enumerate(idx) if t is not None]
        if len(live) != 1:
            raise NotImplementedError(
                'paddle.onnx.export: advanced indexing by more than one '
                'tensor has no ONNX mapping; use paddle.jit.save '
                '(torch.export) instead')
        return self.node('Gather', [self.operand(a['self']),
                                    self.operand(idx[live[0]])],
                         axis=live[0])

    def _aten_index_select(self, node, a):
        rank = len(_shape(a['self']))
        return self.node('Gather', [self.operand(a['self']),
                                    self.operand(a['index'])],
                         axis=int(a['dim']) % rank)

    # -- contractions -------------------------------------------------------
    def _aten_mm(self, node, a):
        dt = _meta(node).dtype
        return self.node('MatMul', [self.operand(a['self'], dt),
                                    self.operand(a['mat2'], dt)])

    _aten_bmm = _aten_mm

    def _aten_matmul(self, node, a):
        dt = _meta(node).dtype
        return self.node('MatMul', [self.operand(a['self'], dt),
                                    self.operand(a['other'], dt)])

    def _aten_addmm(self, node, a):
        dt = _meta(node).dtype
        return self.node('Gemm', [self.operand(a['mat1'], dt),
                                  self.operand(a['mat2'], dt),
                                  self.operand(a['self'], dt)],
                         alpha=float(a['alpha']), beta=float(a['beta']))

    def _aten_linear(self, node, a):
        dt = _meta(node).dtype
        x, w = self.operand(a['input'], dt), self.operand(a['weight'], dt)
        if len(_shape(a['input'])) == 2:
            ins = [x, w] + ([self.operand(a['bias'], dt)]
                            if a['bias'] is not None else [])
            return self.node('Gemm', ins, transB=1)
        y = self.node('MatMul', [x, self.node('Transpose', [w],
                                              perm=[1, 0])])
        if a['bias'] is not None:
            y = self.node('Add', [y, self.operand(a['bias'], dt)])
        return y

    def _aten_einsum(self, node, a):
        dt = _meta(node).dtype
        return self.node('Einsum', [self.operand(t, dt)
                                    for t in a['tensors']],
                         equation=a['equation'].replace(' ', ''))

    def _aten_convolution(self, node, a):
        if a['transposed']:
            raise NotImplementedError(
                'paddle.onnx.export: transposed convolution is not mapped; '
                'use paddle.jit.save (torch.export) for this layer')
        nd = len(_shape(a['weight'])) - 2
        rep = lambda v: ([int(v)] * nd if isinstance(v, int)  # noqa: E731
                         else [int(s) for s in v])
        pads = rep(a['padding'])
        ins = [self.operand(a['input']), self.operand(a['weight'])]
        if a['bias'] is not None:
            ins.append(self.operand(a['bias']))
        return self.node('Conv', ins, strides=rep(a['stride']),
                         dilations=rep(a['dilation']), pads=pads + pads,
                         group=int(a['groups']))

    # -- reductions ---------------------------------------------------------
    def _reduce_args(self, node, a, dim_key='dim'):
        x = a['self']
        rank = len(_shape(x))
        dims = a.get(dim_key)
        return x, _axes(dims if dims not in ((), []) else None, rank)

    def _aten_sum(self, node, a):
        x, axes = self._reduce_args(node, a)
        return self.reduce_sum(self.operand(x, _meta(node).dtype), axes,
                               a.get('keepdim', False))

    def _aten_mean(self, node, a):
        x, axes = self._reduce_args(node, a)
        dt = _meta(node).dtype
        return self.reduce_mean(self.operand(x, dt), axes,
                                a.get('keepdim', False), _shape(x), dt)

    def _aten_amax(self, node, a):
        x, axes = self._reduce_args(node, a)
        return self.node('ReduceMax', [self.operand(x)], axes=axes,
                         keepdims=int(a['keepdim']))

    def _aten_amin(self, node, a):
        x, axes = self._reduce_args(node, a)
        return self.node('ReduceMin', [self.operand(x)], axes=axes,
                         keepdims=int(a['keepdim']))

    def _aten_argmax(self, node, a):
        x = a['self']
        rank = len(_shape(x))
        ins = [self.operand(x)]
        if a['dim'] is None:
            ins = [self.node('Reshape', [ins[0], self.const_i64([-1])])]
            dim = 0
        else:
            dim = int(a['dim']) % rank
        return self.node('ArgMax', ins, axis=dim, keepdims=int(a['keepdim']))

    def _aten__softmax(self, node, a):
        rank = len(_shape(a['self']))
        return self.softmax(self.operand(a['self'], _meta(node).dtype),
                            int(a['dim']) % rank)

    def _aten__log_softmax(self, node, a):
        rank = len(_shape(a['self']))
        return self.softmax(self.operand(a['self'], _meta(node).dtype),
                            int(a['dim']) % rank, log=True)

    def _aten_native_layer_norm(self, node, a):
        """(y, mean, rstd): mean and variance over the normalized dims in
        the output's dtype."""
        x, dt = a['input'], _meta(node)[0].dtype
        shape = _shape(x)
        axes = list(range(len(shape) - len(a['normalized_shape']),
                          len(shape)))
        xv = self.operand(x, dt)
        mean = self.reduce_mean(xv, axes, True, shape, dt)
        d = self.node('Sub', [xv, mean])
        var = self.reduce_mean(self.node('Mul', [d, d]), axes, True, shape,
                               dt)
        rstd = self.node('Reciprocal', [self.node('Sqrt', [self.node(
            'Add', [var, self.const(float(a['eps']), dt)])])])
        y = self.node('Mul', [d, rstd])
        if a['weight'] is not None:
            y = self.node('Mul', [y, self.operand(a['weight'], dt)])
        if a['bias'] is not None:
            y = self.node('Add', [y, self.operand(a['bias'], dt)])
        return [y, mean, rstd]

    # -- the port's kernel export ops ----------------------------------------
    def _kernel_rms_norm_fwd(self, node, a):
        """RMSNorm's plain version: normalize in fp32, cast to x's dtype,
        then multiply by the weight in x's dtype."""
        x = a['x']
        shape = _shape(x)
        dt = _meta(x).dtype
        xf = self.operand(x, torch.float32)
        ms = self.reduce_mean(self.node('Mul', [xf, xf]), [len(shape) - 1],
                              True, shape, torch.float32)
        rstd = self.node('Reciprocal', [self.node('Sqrt', [self.node(
            'Add', [ms, self.const(float(a['eps']), torch.float32)])])])
        y = self.node('Mul', [xf, rstd])
        if dt != torch.float32:
            y = self.cast(y, dt)
        return self.node('Mul', [y, self.operand(a['weight'], dt)])

    def _kernel_flash_attention_fwd(self, node, a):
        """Attention's plain version over q [B, Sq, H, D], k / v
        [B, Sk, HKV, D]: GQA heads folded as [HKV, G], fp32 logits and
        softmax, the causal mask aligned bottom-right, probabilities cast
        to q's dtype before PV."""
        if a['seqused_k'] is not None:
            raise NotImplementedError(
                'paddle.onnx.export: flash_attention_fwd with seqused_k has '
                'no ONNX mapping; use paddle.jit.save (torch.export)')
        q, k, v = a['q'], a['k'], a['v']
        b, sq, h, d = _shape(q)
        sk, hkv = _shape(k)[1], _shape(k)[2]
        g = h // hkv
        dt = _meta(q).dtype
        qg = self.node('Reshape', [self.operand(q, torch.float32),
                                   self.const_i64([b, sq, hkv, g, d])])
        logits = self.node('Einsum', [qg, self.operand(k, torch.float32)],
                           equation='bqhgd,bkhd->bhgqk')
        logits = self.node('Mul', [logits, self.const(
            1.0 / math.sqrt(d), torch.float32)])
        if a['causal']:
            masked = (np.arange(sk)[None, :]
                      > np.arange(sq)[:, None] + (sk - sq))
            logits = self.node('Where', [
                self.add_initializer(self.fresh('causal'),
                                     torch.from_numpy(masked)),
                self.const(_NEG_INF, torch.float32), logits])
        probs = self.softmax(logits, 4)
        if dt != torch.float32:
            probs = self.cast(probs, dt)
        out = self.node('Einsum', [probs, self.operand(v, dt)],
                        equation='bhgqk,bkhd->bqhgd')
        return self.node('Reshape', [out, self.const_i64([b, sq, h, d])])

    def _kernel_softmax_ce_fwd(self, node, a):
        """CE's plain version: (nll [N], lse [N]) in fp32 over logits
        [N, V] and int labels [N]; a label outside [0, V) has no target
        logit (nll = lse)."""
        logits, labels = a['logits'], a['labels']
        n, v = _shape(logits)
        xf = self.operand(logits, torch.float32)
        m = self.node('ReduceMax', [xf], axes=[1], keepdims=1)
        s = self.reduce_sum(self.node('Exp', [self.node('Sub', [xf, m])]),
                            [1], False)
        lse = self.node('Add', [self.node('Log', [s]), self.node(
            'Reshape', [m, self.const_i64([n])])])
        lab = self.node('Reshape', [self.operand(labels, torch.int64),
                                    self.const_i64([n, 1])])
        hit = self.node('Equal', [lab, self.const(
            [list(range(v))], torch.int64, 'classes')])
        target = self.reduce_sum(
            self.node('Where', [hit, xf, self.const(0.0, torch.float32)]),
            [1], False)
        return [self.node('Sub', [lse, target]), lse]

    # -- assembly -----------------------------------------------------------
    def finish(self, out_nodes, opset_version):
        outputs, seen = [], set()
        for nd in out_nodes:
            name = self.names[nd]
            if name in seen or name in {i.name for i in self.inputs}:
                name = self.node('Identity', [name])
            seen.add(name)
            outputs.append(self.api.helper.make_tensor_value_info(
                name, self._elem_type(_meta(nd).dtype), _shape(nd)))
        graph = self.api.helper.make_graph(
            self.nodes, 'paddle_tpu_torch', self.inputs, outputs,
            initializer=self.initializers)
        return self.api.helper.make_model(
            graph, opset_imports=[
                self.api.helper.make_opsetid('', opset_version)])
