"""`onnx` and `hub` of the port against the JAX package's, on the CPU.

ONNX: the same layers, the port's weights carried across from the JAX
layer's `state_dict`, go through both packages' `build_model` with the
JAX tests' in-memory double of the onnx API (`FAKE_ONNX`) and their
numpy evaluator of the emitted graph (`_run_graph`, imported from
tests/test_onnx_export.py). The port emits MatMul, Gemm and Gather,
which that evaluator does not hold: `_run` evaluates those three itself
and hands every other node to `_run_graph`, one node at a time. Each
graph's evaluation must equal its package's forward (rtol 1e-5, atol
1e-5 of the output's scale) and the two packages' forwards must agree
within the same tolerance. The port's kernel export ops (RMSNorm, flash
attention, CE) are lowered to their plain versions' subgraphs and held
to the port's forward.

Hub: a temporary local hubconf.py whose entry points build port models.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as tnn
from paddle_tpu.jit import InputSpec as JSpec
from paddle_tpu.onnx import build_model as jbuild
from paddle_tpu_torch import hub as thub
from paddle_tpu_torch import onnx as tonnx
from paddle_tpu_torch.jit import InputSpec as TSpec
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.weights import from_jax_state
from test_onnx_export import (FAKE_ONNX, _Graph, _Init, _Model,
                              _run_graph, _ValueInfo)

TOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def _cpu_place():
    ptt.set_device('cpu')
    yield
    ptt.set_device('gpu')


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _run(model, feeds):
    """Evaluate the graph: MatMul, Gemm and Gather here, every other node
    by the JAX tests' evaluator as a one-node graph over the values so
    far."""
    env = {i.name: np.asarray(i.array) for i in model.graph.initializer}
    for vi, arr in zip(model.graph.input, feeds):
        env[vi.name] = np.asarray(arr)
    for nd in model.graph.node:
        x, a = [env[n] for n in nd.input], nd.attrs
        if nd.op_type == 'MatMul':
            r = np.matmul(x[0], x[1])
        elif nd.op_type == 'Gemm':
            lhs = x[0].T if a.get('transA') else x[0]
            rhs = x[1].T if a.get('transB') else x[1]
            r = a.get('alpha', 1.0) * (lhs @ rhs)
            if len(x) > 2:
                r = r + a.get('beta', 1.0) * x[2]
            r = r.astype(x[0].dtype)
        elif nd.op_type == 'Gather':
            r = np.take(x[0], x[1], axis=a.get('axis', 0))
        else:
            one = _Graph([nd], 'node', [],
                         [_ValueInfo(o, None, None) for o in nd.output],
                         [_Init(env[n], n) for n in nd.input])
            r = _run_graph(_Model(one, None), [])[0]
        env[nd.output[0]] = r
    return [env[o.name] for o in model.graph.output]


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


class _RMSBlock:
    """Linear -> RMSNorm -> Linear, in either package."""

    @staticmethod
    def make(nn):
        class Block(nn.Layer):
            def __init__(self):
                super().__init__()
                self.up = nn.Linear(8, 16)
                self.norm = nn.RMSNorm(16)
                self.down = nn.Linear(16, 4)

            def forward(self, x):
                return self.down(self.norm(self.up(x)))
        return Block()


LAYERS = [
    ('linear', lambda nn: nn.Linear(6, 4), [None, 6], (3, 6)),
    ('mlp_gelu_layernorm',
     lambda nn: nn.Sequential(nn.Linear(8, 16), nn.GELU(), nn.LayerNorm(16),
                              nn.Linear(16, 5), nn.Softmax()),
     [4, 8], (4, 8)),
    ('conv_net',
     lambda nn: nn.Sequential(nn.Conv2D(3, 8, 3, padding=1), nn.ReLU(),
                              nn.Conv2D(8, 4, 3, stride=2)),
     [None, 3, 8, 8], (2, 3, 8, 8)),
    ('multihead_attention', lambda nn: nn.MultiHeadAttention(16, 4),
     [2, 5, 16], (2, 5, 16)),
    ('rms_norm_block', _RMSBlock.make, [3, 8], (3, 8)),
]


@pytest.mark.parametrize('case', LAYERS, ids=[c[0] for c in LAYERS])
def test_graph_equals_forward_in_both_packages(case):
    name, make, spec, shape = case
    jl = make(jnn)
    jl.eval()
    tl = from_jax_state(_state(jl), make(tnn))
    tl.eval()
    x = np.random.default_rng(len(name)).standard_normal(shape).astype(
        np.float32)
    jmodel = jbuild(jl, [JSpec(spec)], 13, FAKE_ONNX)
    tmodel = tonnx.build_model(tl, [TSpec(spec)], 13, FAKE_ONNX)
    want_j = jl(paddle.to_tensor(x)).numpy()
    with torch.no_grad():
        want_t = tl(torch.from_numpy(x)).numpy()
    _close(_run(jmodel, [x])[0], want_j)
    _close(_run(tmodel, [x])[0], want_t)
    _close(want_t, want_j)
    assert any(n.op_type in ('MatMul', 'Gemm', 'Conv')
               for n in tmodel.graph.node)
    # parameters embedded as initializers under their state_dict names
    inits = {i.name for i in tmodel.graph.initializer}
    assert set(tl.state_dict()) <= inits
    if spec[0] is None:
        assert tmodel.graph.input[0].shape[0] == 'dyn_0'
    if name == 'rms_norm_block':
        assert not any(n.op_type.startswith('paddle')
                       for n in tmodel.graph.node)


class _Attention(tnn.Layer):
    def __init__(self, causal):
        super().__init__()
        self.causal = causal

    def forward(self, q, k, v):
        return K.flash_attention_fwd(q, k, v, causal=self.causal)


class _CE(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.head = tnn.Linear(6, 10)

    def forward(self, x, labels):
        return TF.cross_entropy(self.head(x), labels, reduction='none')


def _export_ops(layer, specs):
    from paddle_tpu_torch.jit import _InferFn
    samples = [torch.zeros([1 if d is None else d for d in s.shape],
                           dtype=getattr(torch, s.dtype)) for s in specs]
    prog = torch.export.export(_InferFn(layer), ({}, {}, {}, *samples)
                               if not list(layer.parameters()) else
                               ({n: p.detach() for n, p in
                                 layer.named_parameters()}, {}, {},
                                *samples))
    return {str(n.target) for n in prog.graph.nodes
            if n.op == 'call_function'}


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('sq,sk,h,hkv', [(5, 7, 4, 2), (6, 6, 4, 4),
                                          (3, 9, 6, 1)])
def test_flash_attention_export_op_lowered(causal, sq, sk, h, hkv):
    """The flash export op becomes the plain version's subgraph: GQA
    folded as [HKV, G], causal aligned bottom-right."""
    layer = _Attention(causal)
    specs = [TSpec([2, sq, h, 8]), TSpec([2, sk, hkv, 8]),
             TSpec([2, sk, hkv, 8])]
    assert 'paddle_tpu_torch.flash_attention_fwd.default' in \
        _export_ops(layer, specs)
    rng = np.random.default_rng(sq * 10 + sk)
    feeds = [rng.standard_normal([2, n, heads, 8]).astype(np.float32)
             for n, heads in ((sq, h), (sk, hkv), (sk, hkv))]
    model = tonnx.build_model(layer, specs, 13, FAKE_ONNX)
    with torch.no_grad():
        want = layer(*[torch.from_numpy(f) for f in feeds]).numpy()
    _close(_run(model, feeds)[0], want)


def test_rms_norm_export_op_keeps_the_rounding_order():
    """bf16 activations and weight: the graph casts the fp32
    normalization to bf16 before the weight multiply, the plain
    version's order (the evaluator runs bf16 as fp32, so the values are
    held at bf16 precision and the order is read off the graph)."""
    norm = tnn.RMSNorm(16).to(dtype='bfloat16')
    with torch.no_grad():
        norm.weight.copy_(torch.linspace(0.5, 1.5, 16))

    class Wrap(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.norm = norm

        def forward(self, v):
            return self.norm(v.to(torch.bfloat16)).float()
    w = Wrap()
    x = np.random.default_rng(3).standard_normal((3, 16)).astype(np.float32)
    model = tonnx.build_model(w, [TSpec([3, 16])], 13, FAKE_ONNX)
    made = {o: n for n in model.graph.node for o in n.output}
    out = made[model.graph.output[0].name]          # the cast to f32
    mul = made[out.input[0]]
    assert mul.op_type == 'Mul'
    first = made[mul.input[0]]
    assert first.op_type == 'Cast' and \
        first.attrs['to'] == FAKE_ONNX.TensorProto.BFLOAT16
    with torch.no_grad():
        want = w(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(_run(model, [x])[0], want, rtol=2e-2,
                               atol=2e-2)
    for init in model.graph.initializer:
        assert str(init.array.dtype) != 'bfloat16'


def test_cross_entropy_export_op_lowered():
    layer = _CE()
    specs = [TSpec([4, 6]), TSpec([4], 'int64')]
    assert 'paddle_tpu_torch.softmax_ce_fwd.default' in \
        _export_ops(layer, specs)
    model = tonnx.build_model(layer, specs, 13, FAKE_ONNX)
    x = np.random.default_rng(4).standard_normal((4, 6)).astype(np.float32)
    labels = np.array([1, 9, -100, 0])
    with torch.no_grad():
        want = layer(torch.from_numpy(x), torch.from_numpy(labels)).numpy()
    got = _run(model, [x, labels])[0]
    _close(got, want)
    assert got[2] == 0.0


class _Contractions(tnn.Layer):
    """torch's linear on 2-D and 3-D inputs, addmm and einsum."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(7)
        self.w = torch.nn.Parameter(torch.randn(5, 6, generator=g))
        self.b = torch.nn.Parameter(torch.randn(5, generator=g))

    def forward(self, x, y):
        h = torch.nn.functional.linear(x, self.w, self.b)          # Gemm
        z = torch.nn.functional.linear(y, self.w)                  # MatMul
        m = torch.addmm(self.b, x, self.w.t(), beta=0.5, alpha=2.0)
        return h + m, torch.einsum('bsf,bf->bs', z, h)


def test_contractions_map_to_gemm_matmul_einsum():
    layer = _Contractions()
    specs = [TSpec([3, 6]), TSpec([3, 4, 6])]
    model = tonnx.build_model(layer, specs, 13, FAKE_ONNX)
    ops = [n.op_type for n in model.graph.node]
    assert ops.count('Gemm') == 2 and 'Einsum' in ops and 'MatMul' in ops
    rng = np.random.default_rng(8)
    feeds = [rng.standard_normal((3, 6)).astype(np.float32),
             rng.standard_normal((3, 4, 6)).astype(np.float32)]
    with torch.no_grad():
        want = layer(*[torch.from_numpy(f) for f in feeds])
    for got, w in zip(_run(model, feeds), want):
        _close(got, w.numpy())


class _OpZoo(tnn.Layer):
    """The elementwise, reduction, layout and gather ops the converter
    maps, beside the layers above."""

    def __init__(self):
        super().__init__()
        self.emb = tnn.Embedding(10, 4)

    def forward(self, x, ids):
        a = torch.rsqrt(x.abs() + 1.0) + torch.log1p(x.clamp(0.0, 2.0))
        b = torch.log_softmax(x, dim=-1) - x.mean(dim=-1, keepdim=True)
        c = torch.where(x > 0.5, x.amax(dim=0), x.amin(dim=0))
        d = torch.cat([x[1], x[:, 2]], dim=0)[None, :]
        e = (x != 0.25).float() * torch.floor_divide(x, 0.3)
        g = self.emb(ids).sum(dim=-1) + torch.index_select(x, 0, ids[0])[
            :, 0]
        return (a * b + c + e, d, x.argmax(dim=-1), g,
                torch.nn.functional.gelu(x, approximate='tanh'))


def test_op_zoo_graph_equals_forward():
    layer = _OpZoo()
    specs = [TSpec([3, 3]), TSpec([3, 3], 'int64')]
    model = tonnx.build_model(layer, specs, 13, FAKE_ONNX)
    assert 'Gather' in {n.op_type for n in model.graph.node}
    rng = np.random.default_rng(9)
    feeds = [rng.standard_normal((3, 3)).astype(np.float32),
             rng.integers(0, 3, (3, 3))]
    with torch.no_grad():
        want = layer(*[torch.from_numpy(f) for f in feeds])
    got = _run(model, feeds)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w.numpy())


def test_llama_graph_equals_forward():
    """A tiny Llama (embedding gather, rotary, GQA attention, RMSNorm,
    SwiGLU) as one graph."""
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
    m = LlamaForCausalLM(LlamaConfig.tiny(), device='cpu',
                         generator=torch.Generator().manual_seed(0)).eval()
    model = tonnx.build_model(m, [TSpec([2, 8], 'int64')], 13, FAKE_ONNX)
    ids = np.random.default_rng(5).integers(0, 100, (2, 8))
    with torch.no_grad():
        want = m(torch.from_numpy(ids))
    want = want[0] if isinstance(want, (tuple, list)) else want
    _close(_run(model, [ids])[0], want.numpy())


def test_bf16_params_exported_as_fp32():
    m = tnn.Linear(4, 4)
    m.to(dtype='bfloat16')

    class Wrap(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.inner = m

        def forward(self, v):
            return self.inner(v.to(torch.bfloat16)).float()
    w = Wrap()
    x = np.random.default_rng(6).standard_normal((2, 4)).astype(np.float32)
    model = tonnx.build_model(w, [TSpec([None, 4])], 13, FAKE_ONNX)
    with torch.no_grad():
        want = w(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(_run(model, [x])[0], want, rtol=2e-2,
                               atol=2e-2)
    for init in model.graph.initializer:
        assert str(init.array.dtype) != 'bfloat16'


def test_gate_without_onnx(tmp_path, monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, 'onnx', None)
    with pytest.raises(RuntimeError, match='paddle.jit.save'):
        tonnx.export(tnn.Linear(2, 2), str(tmp_path / 'm'),
                     input_spec=[TSpec([1, 2])])


def test_export_writes_file_with_api(tmp_path):
    p = tonnx.export(tnn.Linear(2, 2), str(tmp_path / 'm'),
                     input_spec=[TSpec([1, 2])], _onnx_api=FAKE_ONNX)
    assert p.endswith('.onnx')
    with open(p, 'rb') as f:
        assert f.read() == b'fake'
    with pytest.raises(ValueError, match='opset'):
        tonnx.export(tnn.Linear(2, 2), str(tmp_path / 'm'),
                     input_spec=[TSpec([1, 2])], opset_version=11,
                     _onnx_api=FAKE_ONNX)


def test_unmapped_op_message_names_the_op():
    class Weird(tnn.Layer):
        def forward(self, x):
            return ptt.cumsum(x, axis=0)

    with pytest.raises(NotImplementedError,
                       match='cumsum.*paddle.jit.save'):
        tonnx.build_model(Weird(), [TSpec([3, 3])], 13, FAKE_ONNX)
    with pytest.raises(ValueError, match='input_spec'):
        tonnx.build_model(Weird(), None, 13, FAKE_ONNX)


# -- hub ---------------------------------------------------------------------

_HUBCONF = '''
import paddle_tpu_torch.nn as nn


def mlp(width=4):
    """A two-layer MLP of the port."""
    return nn.Sequential(nn.Linear(width, 8), nn.ReLU(), nn.Linear(8, 2))


def _private():
    return None
'''


def test_hub_local_builds_a_port_model(tmp_path):
    (tmp_path / 'hubconf.py').write_text(_HUBCONF)
    repo = str(tmp_path)
    assert thub.list(repo) == ['mlp']
    assert 'two-layer MLP' in thub.help(repo, 'mlp')
    m = thub.load(repo, 'mlp', width=3)
    assert isinstance(m, tnn.Layer)
    assert tuple(m(torch.zeros(2, 3)).shape) == (2, 2)
    with pytest.raises(ValueError, match='no callable entry point'):
        thub.load(repo, 'missing')
    with pytest.raises(RuntimeError, match="source='local'"):
        thub.load('org/repo', 'mlp', source='github')
    with pytest.raises(FileNotFoundError):
        thub.list(str(tmp_path / 'empty'))
