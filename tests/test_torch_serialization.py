"""The port's `save`/`load` (paddle_tpu_torch.serialization) against the
JAX package's, on the CPU.

A tree with f32, bf16, fp8, int8 and int64 leaves (as tensors and as
arrays), scalars of every kind, nested lists and tuples and typed dict
keys is saved by one package and loaded by the other, both ways: every
array must come back bit for bit with its dtype and shape, and the
structure (containers, key types, scalars) must be equal. The port
reads bf16/fp8 leaves as torch tensors (numpy has no such dtypes
without ml_dtypes); the return types are held to the module docstring.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serialization as jser
from paddle_tpu_torch import serialization as ser

TORCH = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
         'float8_e4m3fn': torch.float8_e4m3fn, 'int8': torch.int8,
         'int64': torch.int64}
ML = {'bfloat16': ml_dtypes.bfloat16,
      'float8_e4m3fn': ml_dtypes.float8_e4m3fn}


def _leaves(seed=0):
    """{name: (dtype name, f64/int numpy values)}: the arrays of the tree."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((3, 4))
    return {'f32': ('float32', x), 'bf16': ('bfloat16', x[:2]),
            'f8': ('float8_e4m3fn', x[0]),
            'i8': ('int8', rng.randint(-128, 128, (2, 3))),
            'i64': ('int64', rng.randint(-2 ** 40, 2 ** 40, (4,)))}


def _port_leaf(dtype, values, kind):
    t = torch.from_numpy(np.asarray(values, np.float64
                                    if dtype.startswith(('f', 'b'))
                                    else np.int64)).to(TORCH[dtype])
    if kind == 'tensor' or dtype in ML:
        return t        # numpy cannot hold bf16/fp8 without ml_dtypes
    return t.numpy()


def _jax_leaf(dtype, values, kind):
    a = np.asarray(values).astype(ML.get(dtype, dtype))
    return paddle.to_tensor(a) if kind == 'tensor' else a


def _tree(make):
    """The same tree for either package, leaves from `make(dtype, values,
    kind)`: typed keys, nested list/tuple, every scalar kind."""
    lv = _leaves()
    return {
        'model': {n: make(d, v, 'tensor') for n, (d, v) in lv.items()},
        'arrays': [make(d, v, 'ndarray') for d, v in lv.values()],
        3: (1, 2.5, True, 'text', None),
        True: [[make('float32', np.ones((2,)), 'ndarray')], ()],
        1.5: {'nested': ({'deep': make('int8', [[1, -2]], 'tensor')},)},
        'step': 7, 'lr': 3e-4, 'name': 'run', 'none': None,
        'np_scalar': np.float32(0.5),
    }


def _bits(leaf):
    """(dtype name, shape, raw bytes) of an array leaf of either package."""
    if isinstance(leaf, torch.Tensor):
        name = str(leaf.dtype).replace('torch.', '')
        ints = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[leaf.element_size()]
        return name, tuple(leaf.shape), \
            leaf.contiguous().view(ints).numpy().tobytes()
    a = np.asarray(leaf.numpy() if isinstance(leaf, paddle.Tensor) else leaf)
    return a.dtype.name, a.shape, a.tobytes()


def _canon(x):
    """A comparable form of a loaded tree: containers with their types,
    dict keys with theirs, arrays by `_bits`, scalars by type and value."""
    if isinstance(x, dict):
        return ('dict', sorted(((type(k).__name__, repr(k)), _canon(v))
                               for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [_canon(v) for v in x])
    if isinstance(x, (torch.Tensor, np.ndarray, paddle.Tensor)):
        return ('array',) + _bits(x)
    if isinstance(x, np.generic):
        x = x.item()          # a numpy scalar is saved as its Python value
    return ('scalar', type(x).__name__, x)


@pytest.mark.parametrize('return_numpy', [False, True])
@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_files_cross_load_bit_equal(tmp_path, writer, return_numpy):
    path = str(tmp_path / 'tree.npz')
    # (the JAX package's tensors narrow int64 to int32 at creation, so
    # its tree's int64 tensor leaf is saved as int32)
    saved = _tree(_port_leaf if writer == 'port' else _jax_leaf)
    (ser if writer == 'port' else jser).save(saved, path)
    got = ser.load(path, return_numpy=return_numpy, device='cpu')
    want = jser.load(path, return_numpy=True)
    assert _canon(got) == _canon(want) == _canon(saved)


def test_return_types_follow_the_docstring(tmp_path):
    """return_numpy=False: tensor leaves as torch tensors on `device`,
    array leaves as numpy, bf16/fp8 arrays as CPU tensors;
    return_numpy=True: numpy everywhere except bf16/fp8 (CPU tensors)."""
    path = str(tmp_path / 'tree.npz')
    ser.save(_tree(_port_leaf), path)
    tree = ser.load(path, device='cpu')
    assert all(isinstance(v, torch.Tensor) and v.device.type == 'cpu'
               for v in tree['model'].values())
    arrays = dict(zip(_leaves(), tree['arrays']))
    for name, leaf in arrays.items():
        want = torch.Tensor if name in ('bf16', 'f8') else np.ndarray
        assert isinstance(leaf, want), name
    host = ser.load(path, return_numpy=True)
    for name, leaf in host['model'].items():
        want = torch.Tensor if name in ('bf16', 'f8') else np.ndarray
        assert isinstance(leaf, want), name
    assert host['model']['bf16'].dtype == torch.bfloat16
    assert host['np_scalar'] == 0.5 and isinstance(host['np_scalar'], float)


def test_tensor_leaves_default_to_the_card(tmp_path, monkeypatch):
    """`load` puts tensor leaves on `cuda` unless asked otherwise, so
    without a card it raises there; `return_numpy=True` stays on the
    host."""
    path = str(tmp_path / 'tree.npz')
    ser.save({'w': torch.ones(2)}, path)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ser.load(path)
    assert isinstance(ser.load(path, return_numpy=True)['w'], np.ndarray)


@pytest.mark.parametrize('bad', ['key', 'leaf'])
def test_unserializable_input_raises_like_jax(tmp_path, bad):
    obj = {(1, 2): 0} if bad == 'key' else {'x': object()}
    for save in (ser.save, jser.save):
        with pytest.raises(TypeError, match='paddle.save'):
            save(obj, str(tmp_path / 'bad.npz'))


def test_missing_file_and_sharded_calls(tmp_path):
    with pytest.raises(FileNotFoundError):
        ser.load(str(tmp_path / 'absent.npz'))
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        ser.save_sharded({'w': torch.ones(2)}, str(tmp_path / 'sh'))
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        ser.load_sharded(str(tmp_path / 'sh'))
