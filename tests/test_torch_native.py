"""The port's native host pieces against the JAX package's, on the CPU:
sharded checkpoints (`serialization.save_sharded` / `load_sharded` over
`utils/ckpt_native.py`, the port's copy of the C++ shard writer), the
`CheckpointManager(backend='native')`, and the DataLoader's native
collator (`io/native.py`, the port's copy of the C++ staging runtime).

- A sharded directory round-trips in the port, and one written by either
  package loads in the other, bf16 included (raw 2-byte values under the
  JAX manifest's dtype names; the manifests of the same state are equal).
- A native-backend checkpoint step saved by one package restores in the
  other.
- The libraries are built under the port's `build/host/`, never loaded
  from the JAX package's `csrc/build/`.
- The native collator's batches equal the Python collator's and the JAX
  loader's; a collator that fails to start is counted under
  `io.native_collator` and the loader collates in Python; a loader
  dropped mid-epoch leaves no thread behind.
"""
import json
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as jio
from paddle_tpu import serialization as jser
from paddle_tpu.utils.checkpoint import CheckpointManager as JaxManager
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import serialization as ser
from paddle_tpu_torch.io import native
from paddle_tpu_torch.utils import CheckpointManager, ckpt_native, host_lib


def _port_state(seed=0):
    rng = np.random.RandomState(seed)
    return {'w': torch.from_numpy(rng.randn(64, 33).astype(np.float32)),
            'w16': torch.from_numpy(rng.randn(5, 7).astype(
                np.float32)).bfloat16(),
            'layers': [{'b': torch.arange(9, dtype=torch.int32)},
                       (np.arange(4, dtype=np.int32), 'tag')],
            'step': 3, 'lr': 0.25, 'none': None}


def _jax_state(seed=0):
    """The same tree in the JAX package's types (bf16 as ml_dtypes)."""
    t = _port_state(seed)
    return {'w': paddle.to_tensor(t['w'].numpy()),
            'w16': paddle.to_tensor(t['w16'].float().numpy().astype(
                ml_dtypes.bfloat16)),
            'layers': [{'b': paddle.to_tensor(t['layers'][0]['b'].numpy())},
                       (t['layers'][1][0], 'tag')],
            'step': 3, 'lr': 0.25, 'none': None}


def _bits(leaf):
    """(dtype name, raw bytes) of a leaf of either package."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace('torch.', ''), \
            leaf.contiguous().view(torch.uint8).numpy().tobytes()
    a = np.asarray(getattr(leaf, 'numpy', lambda: leaf)())
    return a.dtype.name, a.tobytes()


def _same_tree(got, want):
    assert _bits(got['w']) == _bits(want['w'])
    assert _bits(got['w16']) == _bits(want['w16'])
    assert _bits(got['layers'][0]['b']) == _bits(want['layers'][0]['b'])
    assert _bits(got['layers'][1][0]) == _bits(want['layers'][1][0])
    assert isinstance(got['layers'][1], tuple) and \
        got['layers'][1][1] == 'tag'
    assert (got['step'], got['lr'], got['none']) == (3, 0.25, None)


def test_libraries_build_under_the_ports_build_dir():
    assert ckpt_native.available() and native.available()
    for lib in (ckpt_native.LIB, native.LIB):
        assert lib.path.parent == host_lib.BUILD_DIR
        assert lib.path.parent.name == 'host' and lib.path.exists()
        assert 'csrc' not in lib.path.parts
        assert lib.src.parent.parts[-3:] == ('paddle_tpu_torch', 'csrc',
                                             'host')


def test_sharded_round_trip_in_the_port(tmp_path):
    state = _port_state()
    ser.save_sharded(state, str(tmp_path / 'd'), n_shards=3)
    manifest = json.loads((tmp_path / 'd' / 'manifest.json').read_text())
    assert manifest['n_shards'] == 3
    back = ser.load_sharded(str(tmp_path / 'd'), device='cpu')
    _same_tree(back, state)
    assert back['w16'].dtype == torch.bfloat16
    host = ser.load_sharded(str(tmp_path / 'd'), return_numpy=True)
    assert isinstance(host['w'], np.ndarray)
    assert host['w16'].dtype == torch.bfloat16    # no numpy bf16 here


@pytest.mark.parametrize('n_shards', [1, 4, 8])
def test_sharded_directories_cross_both_ways(tmp_path, n_shards):
    """The port reads the JAX package's directory and the JAX package
    reads the port's, bit for bit; both write the same manifest for the
    same state (dtype names, shard balancing, offsets)."""
    ser.save_sharded(_port_state(), str(tmp_path / 'port'), n_shards)
    jser.save_sharded(_jax_state(), str(tmp_path / 'jax'), n_shards)
    for name in ('manifest.json', 'tree.json'):
        assert json.loads((tmp_path / 'port' / name).read_text()) == \
            json.loads((tmp_path / 'jax' / name).read_text())
    manifest = json.loads((tmp_path / 'port' / 'manifest.json').read_text())
    assert manifest['arrays']['a1']['dtype'] == '<u2'   # bf16, raw 2 bytes
    _same_tree(ser.load_sharded(str(tmp_path / 'jax'), device='cpu'),
               _port_state())
    _same_tree(jser.load_sharded(str(tmp_path / 'port')), _jax_state())
    for k in range(manifest['n_shards']):
        name = f'shard_{k}.bin'
        assert (tmp_path / 'port' / name).read_bytes() == \
            (tmp_path / 'jax' / name).read_bytes()


def test_native_checkpoint_manager_crosses_both_ways(tmp_path):
    port = CheckpointManager(str(tmp_path / 'p'), backend='native')
    jax = JaxManager(str(tmp_path / 'j'), backend='native')
    assert port.backend == jax.backend == 'native'
    port.save(5, _port_state())
    jax.save(5, _jax_state())
    meta = [json.loads((tmp_path / d / 'step_5' / '_COMMITTED').read_text())
            for d in ('p', 'j')]
    assert meta[0]['backend'] == meta[1]['backend'] == 'native'
    assert sorted(meta[0]['checksums']) == sorted(meta[1]['checksums'])
    _same_tree(JaxManager(str(tmp_path / 'p'), backend='native').restore(),
               _jax_state())
    _same_tree(CheckpointManager(str(tmp_path / 'j')).restore(),
               _port_state())
    assert port.verify(5) and port.all_steps() == [5]


class _Rows(tio.Dataset):
    """Flat numeric samples: a float image, a uint8 patch and an int
    label (the native collator's path)."""

    def __init__(self, n=24):
        rng = np.random.RandomState(1)
        self.x = rng.randn(n, 3, 5, 5).astype(np.float32)
        self.u = rng.randint(0, 256, (n, 4, 4)).astype(np.uint8)
        self.y = rng.randint(0, 10, (n,))

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.u[i], int(self.y[i])


class _JaxRows(jio.Dataset):
    def __init__(self):
        self.rows = _Rows()

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


def test_native_collator_batches_equal_python_and_jax():
    native_loader = tio.DataLoader(_Rows(), batch_size=5, num_workers=2)
    assert native_loader._native is not None
    python_loader = tio.DataLoader(_Rows(), batch_size=5, num_workers=0)
    assert python_loader._native is None
    jax_loader = jio.DataLoader(_JaxRows(), batch_size=5, num_workers=2)
    got, want, ref = (list(dl) for dl in (native_loader, python_loader,
                                          jax_loader))
    assert len(got) == len(want) == len(ref) == 5
    for g, w, j in zip(got, want, ref):
        assert isinstance(g, tuple) and len(g) == 3
        for a, b, c in zip(g, w, j):
            assert isinstance(a, torch.Tensor) and a.dtype == b.dtype
            assert torch.equal(a, b)
            np.testing.assert_array_equal(a.numpy(), np.asarray(c.numpy()))


def test_a_failed_native_collator_is_counted(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError('no staging')
    was = obs.enabled()
    obs.enable()
    reg = obs.get_registry()
    before = reg.value('paddle_suppressed_errors_total',
                       site='io.native_collator')
    monkeypatch.setattr(native, 'DecoderPool', broken)
    try:
        loader = tio.DataLoader(_Rows(), batch_size=6, num_workers=2)
        assert loader._native is None
        assert reg.value('paddle_suppressed_errors_total',
                         site='io.native_collator') == before + 1
        assert [tuple(t.shape) for t in next(iter(loader))] == [
            (6, 3, 5, 5), (6, 4, 4), (6,)]
    finally:
        if not was:
            obs.disable()


def test_a_loader_dropped_mid_epoch_leaves_no_thread():
    """The worker threads of an iterator dropped after one batch all end,
    and the decoder pool's C++ team is joined by `close()`."""
    import gc
    before = set(threading.enumerate())
    loader = tio.DataLoader(_Rows(48), batch_size=4, num_workers=2)
    it = iter(loader)
    next(it)
    workers = set(threading.enumerate()) - before
    assert workers
    pool = loader._native.pool
    del it, loader
    gc.collect()
    for t in workers:
        t.join(timeout=5.0)
    assert not any(t.is_alive() for t in workers)
    pool.close()                       # joins the C++ team (idempotent)
    pool.close()
    assert pool._h is None
