"""The port's `jit` (paddle_tpu_torch/jit/__init__.py) against the JAX
package's, on the CPU: `functional_state` / `functional_call` /
`functional_method`, `to_static` (InputSpec checks, the static-kwarg key
and its cache-entry note, passthroughs), and `save`/`load`: the eval
forward exported by `torch.export` with the state as inputs, loaded
without the class (a dynamic batch, bf16 state, a T5 whose program
records the RMSNorm and flash export ops), the npz crossing both ways
with the JAX `jit.save`/`load`, a JAX StableHLO artifact refused by
name, and a kernel without an export op refusing the export.

Outputs of a loaded program equal the eager forward bit for bit (the
same ops on the same inputs); against JAX, outputs agree to rtol 1e-5
(fp32 sums in another order)."""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu import jit as jjit
from paddle_tpu import nn as jnn
from paddle_tpu.nlp import t5 as jt5
from paddle_tpu_torch import jit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.nlp import T5Config, T5Model
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.weights import from_jax_state


@pytest.fixture(autouse=True, scope='module')
def _cpu_place():
    ptt.set_device('cpu')
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    ptt.set_device('gpu')


def _mlp(pkg=tnn):
    return pkg.Sequential(pkg.Linear(4, 16), pkg.Tanh(), pkg.Dropout(0.5),
                          pkg.LayerNorm(16), pkg.Linear(16, 2))


def _jax_mlp_state(seed=0):
    paddle.seed(seed)
    jm = _mlp(jnn)
    return jm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _x(shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def test_functional_state_call_and_method():
    m = _mlp()
    m[4].weight.requires_grad_(False)
    params, frozen, buffers = jit.functional_state(m)
    assert set(frozen) == {'4.weight'} and '0.weight' in params
    assert buffers == {}
    m.eval()
    x = torch.from_numpy(_x((3, 4)))
    zeros = {n: torch.zeros_like(p) for n, p in params.items()}
    out, _ = jit.functional_call(m, zeros, frozen, buffers, (x,), {})
    assert torch.equal(out, torch.zeros(3, 2))      # LayerNorm of zeros
    assert torch.equal(jit.functional_call(m, params, frozen, buffers,
                                           (x,), {})[0], m(x))
    t5 = T5Model(T5Config.tiny(), device='cpu').eval()
    p, f, b = jit.functional_state(t5)
    ids = torch.randint(2, 96, (2, 5))
    enc, _ = jit.functional_method(t5, 'encode', p, f, b, (ids,), {})
    assert torch.equal(enc, t5.encode(ids))


def test_functional_call_returns_updated_buffers():
    bn = tnn.BatchNorm1D(3)
    _, _, buffers = jit.functional_state(bn)
    buffers = {n: t.clone() for n, t in buffers.items()}
    x = torch.from_numpy(_x((8, 3)))
    _, new = jit.functional_call(bn, dict(bn.named_parameters()), {},
                                 buffers, (x,), {})
    assert not torch.equal(new['_mean'], torch.zeros(3))
    assert torch.equal(bn._mean, torch.zeros(3))    # the layer's own: intact


def test_to_static_layer_and_function_match_eager():
    m = _mlp().eval()
    x = torch.from_numpy(_x((3, 4)))
    static = jit.to_static(m, input_spec=[jit.InputSpec([None, 4])])
    assert torch.equal(static(x), m(x))
    assert static.training is False and static.state_dict == m.state_dict
    with pytest.raises(ValueError, match='does not match InputSpec'):
        static(torch.zeros(3, 5))

    @jit.to_static
    def f(a, b):
        return a * b + torch.relu(a)
    assert f.__name__ == 'f'
    assert torch.equal(f(x, x), x * x + torch.relu(x))


def test_to_static_keys_static_kwargs_as_jax_does():
    """One cache-entry note per static-kwarg key (as the JAX program
    cache compiles one program per key); an unhashable kwarg raises the
    JAX TypeError."""
    obs.enable()
    reg = obs.get_registry()

    def entries():
        return reg.value('paddle_jit_cache_entries', kind='to_static')

    @jit.to_static
    def g(a, scale=1.0):
        return a * scale
    before = entries()
    x = torch.ones(2)
    g(x), g(x), g(x, scale=2.0), g(x, scale=2.0), g(x, scale=x)
    assert entries() == before + 2
    with pytest.raises(TypeError, match='hashable python values'):
        g(x, scale=[1.0])

    @jjit.to_static
    def jg(a, scale=1.0):
        return a * scale
    with pytest.raises(TypeError, match='hashable python values'):
        jg(paddle.ones([2]), scale=[1.0])


def test_save_needs_an_input_spec(tmp_path):
    with pytest.raises(ValueError, match='needs input_spec'):
        jit.save(_mlp(), str(tmp_path / 'm'))


def test_save_load_without_the_class(tmp_path):
    """The eval forward (dropout off) of a layer left in train mode, a
    dynamic batch: the loaded program equals eager at batches 2, 5 and 1,
    with port Tensors in and out as well."""
    m = _mlp()
    path = str(tmp_path / 'mlp')
    static = jit.to_static(m, input_spec=[jit.InputSpec([None, 4])])
    jit.save(static, path)
    assert m.training
    man = json.load(open(path + '.pdmodel.json'))
    assert man['format'] == 'torch.export' and man['device'] == 'cpu'
    assert man['input_spec'] == [{'shape': [None, 4], 'dtype': 'float32'}]
    loaded = jit.load(path)
    assert loaded.eval() is loaded
    assert [s.shape for s in loaded.input_spec] == [(None, 4)]
    assert {n for n, _ in loaded.named_parameters()} == \
        {n for n, _ in m.named_parameters()}
    m.eval()
    for b in (2, 5, 1):
        x = torch.from_numpy(_x((b, 4), b))
        assert torch.equal(loaded(x), m(x))
    out = loaded(ptt.to_tensor(_x((3, 4))))
    assert isinstance(out, ptt.Tensor)
    assert torch.equal(out.value, m(torch.from_numpy(_x((3, 4)))))


def test_saved_program_holds_no_weights(tmp_path):
    import zipfile
    m = _mlp()
    jit.save(m, str(tmp_path / 'm'), input_spec=[jit.InputSpec([2, 4])])
    names = zipfile.ZipFile(tmp_path / 'm.pdmodel.pt2').namelist()
    sizes = {n: zipfile.ZipFile(tmp_path / 'm.pdmodel.pt2').getinfo(n)
             .file_size for n in names}
    assert all(size == 0 for n, size in sizes.items()
               if 'sample_inputs' in n or '/weights/' in n
               and n.endswith('.pt'))
    assert max(s for n, s in sizes.items() if 'constants' in n) < 64


def test_bf16_state_round_trips(tmp_path):
    """npz holds bf16 widened to f32; the manifest's dtypes restore it."""
    m = _mlp().to(dtype='bfloat16').eval()
    path = str(tmp_path / 'bf')
    jit.save(m, path, input_spec=[jit.InputSpec([None, 4], 'bfloat16')])
    assert np.load(path + '.pdiparams.npz')['param::0.weight'].dtype == \
        np.float32
    loaded = jit.load(path)
    x = torch.from_numpy(_x((3, 4))).bfloat16()
    assert dict(loaded.named_parameters())['0.weight'].dtype == \
        torch.bfloat16
    assert torch.equal(loaded(x), m(x))


def test_t5_export_records_the_kernel_ops(tmp_path):
    """T5 at d_kv 64: the exported program holds the RMSNorm and flash
    export ops (the unmasked cross-attention), and no plain attention in
    their place; loaded without the class it equals eager at batches 2
    and 3 (a symbol shared by the encoder's and the decoder's batch)."""
    m = T5Model(T5Config.tiny(d_kv=64), device='cpu',
                generator=torch.Generator().manual_seed(1)).eval()
    path = str(tmp_path / 't5')
    jit.save(m, path, input_spec=[jit.InputSpec([None, 8], 'int32'),
                                  jit.InputSpec([None, 5], 'int32')])
    loaded = jit.load(path)
    ops = [str(n.target) for n in loaded._program.graph.nodes
           if n.op == 'call_function']
    n_norms = 2 * 2 + 3 * 2 + 2
    assert ops.count('paddle_tpu_torch.rms_norm_fwd.default') == n_norms
    assert ops.count('paddle_tpu_torch.flash_attention_fwd.default') == 2
    for b in (2, 3):
        ids = torch.randint(2, 96, (b, 8), dtype=torch.int32)
        dec = torch.randint(2, 96, (b, 5), dtype=torch.int32)
        got = loaded(ids, dec)
        with torch.no_grad():
            want = m(ids, dec)
        assert all(torch.equal(a, w) for a, w in zip(got, want))


def test_npz_crosses_both_ways_with_jax(tmp_path):
    """The port's npz restores into a JAX layer (`load(path, layer=)`)
    and the JAX `jit.save`'s npz into a port layer: equal outputs."""
    jm, state = _jax_mlp_state()
    tm = from_jax_state(state, _mlp()).eval()
    jm.eval()
    x = _x((3, 4))
    jit.save(tm, str(tmp_path / 'port'), input_spec=[jit.InputSpec([3, 4])])
    paddle.seed(5)
    other = _mlp(jnn).eval()
    jjit.load(str(tmp_path / 'port'), layer=other)
    np.testing.assert_allclose(other(paddle.to_tensor(x)).numpy(),
                               jm(paddle.to_tensor(x)).numpy(), rtol=1e-5)
    jjit.save(jm, str(tmp_path / 'jax'), input_spec=[jjit.InputSpec([3, 4])])
    fresh = _mlp().eval()
    restored = jit.load(str(tmp_path / 'jax'), layer=fresh)
    assert isinstance(restored, jit.StaticLayer)
    np.testing.assert_allclose(fresh(torch.from_numpy(x)).detach().numpy(),
                               jm(paddle.to_tensor(x)).numpy(), rtol=1e-5)


def test_jax_artifacts_and_damaged_programs_raise_typed(tmp_path):
    jm, _ = _jax_mlp_state()
    jjit.save(jm, str(tmp_path / 'jax'), input_spec=[jjit.InputSpec([3, 4])])
    with pytest.raises(jit.ProgramDeserializeError, match='stablehlo'):
        jit.load(str(tmp_path / 'jax'))
    jit.save(_mlp(), str(tmp_path / 'bad'),
             input_spec=[jit.InputSpec([3, 4])])
    (tmp_path / 'bad.pdmodel.pt2').write_bytes(b'not a program')
    with pytest.raises(jit.ProgramDeserializeError):
        jit.load(str(tmp_path / 'bad'))
    (tmp_path / 'bad.pdmodel.pt2').unlink()
    with pytest.raises(ValueError, match='pass the layer'):
        jit.load(str(tmp_path / 'bad'))


class _Decode(torch.nn.Module):
    """A forward that reaches the paged kernel, which has no export op."""

    def forward(self, q, pages, table, lengths):
        return K.paged_attention(q, pages, pages, table, lengths)


def test_a_kernel_without_an_export_op_refuses_the_export(tmp_path):
    spec = [jit.InputSpec([2, 4, 64]), jit.InputSpec([3, 16, 4, 64]),
            jit.InputSpec([2, 1], 'int32'), jit.InputSpec([2], 'int32')]
    with pytest.raises(RuntimeError, match='paged_attention has no export'):
        jit.save(_Decode(), str(tmp_path / 'd'), input_spec=spec)
    # outside an export the wrapper takes its plain version on the CPU
    q = torch.zeros(2, 4, 64)
    out = _Decode()(q, torch.zeros(3, 16, 4, 64),
                    torch.ones(2, 1, dtype=torch.int32),
                    torch.ones(2, dtype=torch.int32))
    assert out.shape == q.shape
