"""`flops`, `summary`, `Model.summary`, `LazyGuard` and the small rest of
`utils` (`unique_name`, `try_import`, `deprecated`) in the port against
the JAX package's, on the CPU.

- `flops` (with and without `custom_ops`, with `print_detail`) and
  `summary` give the JAX numbers, dicts and printed tables on LeNet, a
  4-block ResNet and an MLP; a causal LM under `summary(input_size=)`
  (float zeros into an embedding) fails in both packages with the same
  error.
- `LazyGuard`: parameters on `meta`, no allocation, `initialize()` gives
  the eager layer's shapes, dtypes, devices and values (the same
  generator); with numpy weights copied in, the same forward as the JAX
  layer built under its guard.
"""
import importlib
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.vision as jvision
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.vision as tvision
from paddle_tpu.hapi import Model as JaxModel
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.utils import deprecated as jax_deprecated
from paddle_tpu.utils import try_import as jax_try_import
from paddle_tpu.utils import unique_name as jax_unique_name
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.utils import deprecated, try_import, unique_name
from paddle_tpu_torch.weights import from_jax_state


@pytest.fixture(autouse=True, scope='module')
def _on_the_cpu():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ptt.set_device('cpu')
    yield
    torch.set_num_threads(n)


class JaxMLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(12, 32)
        self.act = jnn.ReLU()
        self.norm = jnn.LayerNorm(32)
        self.fc2 = jnn.Linear(32, 5)

    def forward(self, x):
        return self.fc2(self.norm(self.act(self.fc1(x))))


class TorchMLP(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(12, 32)
        self.act = tnn.ReLU()
        self.norm = tnn.LayerNorm(32)
        self.fc2 = tnn.Linear(32, 5)

    def forward(self, x):
        return self.fc2(self.norm(self.act(self.fc1(x))))


NETS = {
    'lenet': (jvision.models.LeNet, tvision.models.LeNet, [2, 1, 28, 28]),
    'resnet': (lambda: jvision.ResNet(jvision.models.BasicBlock,
                                      [1, 1, 1, 1], num_classes=10),
               lambda: tvision.ResNet(tvision.models.BasicBlock,
                                      [1, 1, 1, 1], num_classes=10),
               [1, 3, 16, 16]),
    'mlp': (JaxMLP, TorchMLP, [4, 12]),
}


@pytest.mark.parametrize('name', list(NETS))
def test_flops_and_summary_match_jax(name, capsys):
    jcls, tcls, shape = NETS[name]
    jnet, tnet = jcls(), tcls()
    capsys.readouterr()
    want = paddle.flops(jnet, shape, print_detail=True)
    jout = capsys.readouterr().out
    got = ptt.flops(tnet, shape, print_detail=True)
    assert got == want > 0
    assert capsys.readouterr().out == jout
    jsum = paddle.summary(jnet, tuple(shape))
    jtable = capsys.readouterr().out
    assert ptt.summary(tnet, tuple(shape)) == jsum
    assert capsys.readouterr().out == jtable
    # the hapi entry is the same function, as in the JAX package
    assert ptt.Model(tnet).summary(input_size=tuple(shape)) == jsum
    assert capsys.readouterr().out == jtable


def test_custom_ops_override_the_table():
    jnet, tnet = JaxMLP(), TorchMLP()
    jops = {jnn.Linear: lambda layer, i, o: 7}
    tops = {tnn.Linear: lambda layer, i, o: 7}
    base = ptt.flops(tnet, [4, 12])
    got = ptt.flops(tnet, [4, 12], custom_ops=tops)
    assert got == paddle.flops(jnet, [4, 12], custom_ops=jops) == \
        base - 2 * 4 * (12 * 32 + 32 * 5) + 14


def test_summary_of_a_causal_lm_fails_like_jax():
    """`summary(input_size=(2, 16))` feeds float zeros, which an
    embedding refuses in both packages (the same ValueError)."""
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device='cpu')
    msgs = []
    for call in (lambda: JaxModel(jm).summary(input_size=(2, 16)),
                 lambda: ptt.Model(tm).summary(input_size=(2, 16))):
        with pytest.raises(ValueError, match='integer') as err:
            call()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# LazyGuard
# ---------------------------------------------------------------------------

def _gen():
    return torch.Generator().manual_seed(4)


def test_lazy_guard_defers_every_parameter():
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    with ptt.LazyGuard():
        lazy = LlamaForCausalLM(cfg, device='cpu', generator=_gen())
        emb = tnn.Embedding(10, 4, padding_idx=2, device='cpu')
    params = list(lazy.parameters()) + list(emb.parameters())
    assert all(p.device.type == 'meta' and p.is_lazy for p in params)
    assert not LlamaForCausalLM(cfg, device='cpu').llama.norm.weight.is_lazy
    for p in params:
        assert p.initialize() is p and not p.is_lazy
    eager = LlamaForCausalLM(cfg, device='cpu', generator=_gen())
    for (name, a), b in zip(lazy.named_parameters(), eager.parameters()):
        assert a.device == b.device and a.dtype == b.dtype, name
        assert a.shape == b.shape and torch.equal(a, b), name
        assert isinstance(a, ptt.Parameter) and a.requires_grad
    assert not emb.weight[2].any() and emb.weight.device.type == 'cpu'
    eager.llama.norm.weight.initialize()          # eager: a no-op
    ids = torch.randint(1, 128, (2, 9), generator=_gen())
    with torch.no_grad():
        assert torch.equal(lazy(ids), eager(ids))


def test_lazy_layer_with_jax_weights_matches_the_jax_layer():
    """A Linear and an MLP built under each package's guard, initialized,
    then given the same numpy weights: the same forward."""
    with paddle.LazyGuard():
        jnet = JaxMLP()
    with ptt.LazyGuard():
        tnet = TorchMLP()
    for p in jnet.parameters():
        p.initialize()
    for p in tnet.parameters():
        p.initialize()
    rng = np.random.RandomState(0)
    state = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in jnet.state_dict().items()}
    jnet.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    from_jax_state(state, tnet)
    x = rng.randn(3, 12).astype(np.float32)
    want = jnet(paddle.to_tensor(x)).numpy()
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# unique_name, try_import, deprecated
# ---------------------------------------------------------------------------

def test_unique_name_sequences_match_jax():
    out = []
    for mod in (jax_unique_name, unique_name):
        with mod.guard():
            names = [mod.generate('fc'), mod.generate('fc'),
                     mod.generate('conv')]
            with mod.guard('pre_'):
                names.append(mod.generate('fc'))
            with mod.guard(b'b_'):
                names.append(mod.generate('fc'))
            names.append(mod.generate('fc'))
        old = mod.switch()
        names.append(mod.generate('x'))
        mod.switch(old)
        out.append(names)
    assert out[0] == out[1] == ['fc_0', 'fc_1', 'conv_0', 'pre_fc_0',
                                'b_fc_0', 'fc_2', 'x_0']


def test_try_import_and_deprecated_match_jax():
    assert try_import('json') is importlib.import_module('json')
    msgs = []
    for fn in (jax_try_import, try_import):
        with pytest.raises(ImportError) as err:
            fn('no_such_module_here')
        msgs.append(str(err.value))
        with pytest.raises(ImportError, match='custom'):
            fn('no_such_module_here', 'custom hint')
    assert msgs[0] == msgs[1]
    got = []
    for deco in (jax_deprecated, deprecated):
        @deco(update_to='new_api', since='2.0', reason='renamed')
        def old_api(x):
            return x + 1
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter('always')
            assert old_api(1) == 2
        got.append([str(w.message) for w in seen
                    if w.category is DeprecationWarning])
    assert got[0] == got[1] == [
        'API old_api is deprecated since 2.0; use new_api instead '
        '(renamed)']
