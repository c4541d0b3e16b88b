"""The port's retry classifier and `CheckpointManager`
(paddle_tpu_torch.resilience.retry, paddle_tpu_torch.utils.checkpoint)
against the JAX package's, on the CPU.

- `is_transient` over a table of exceptions (markers, types, chained
  causes, FatalError, programming errors) equals the JAX function's
  answer, except on CUDA errors, which the port never retries: the JAX
  answer is recorded beside each (CUDA's "launch timed out" and "busy or
  unavailable" texts match the JAX markers 'timed out' and
  'unavailable').
- `call_with_retry`, `RetryPolicy` and the flags it reads behave as the
  JAX ones.
- `CheckpointManager`: save/restore, retention, the save interval, an
  async save that a later in-place update does not tear, a failed async
  write surfacing, a corrupt payload (verify False, restore falls back),
  the dataloader cursor, transient I/O retried, and checkpoints written
  by either package restored by the other bit for bit. The JAX manager
  is pinned to backend='npz' (with orbax installed, backend=None would
  pick orbax).
"""
import importlib
import socket

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import flags as jflags
from paddle_tpu.utils.checkpoint import CheckpointManager as JaxManager
from paddle_tpu_torch import flags
from paddle_tpu_torch.serving import engine as port_engine
from paddle_tpu_torch.utils import CheckpointManager
from paddle_tpu_torch.utils import checkpoint as ckpt

# the modules (both packages export a function `retry` beside them)
retry = importlib.import_module('paddle_tpu_torch.resilience.retry')
jretry = importlib.import_module('paddle_tpu.resilience.retry')


# ---------------------------------------------------------------------------
# the transient classifier
# ---------------------------------------------------------------------------

def _chain(outer, inner, suppress=False):
    """`outer` raised from `inner` (or with `inner` as suppressed
    context)."""
    try:
        try:
            raise inner
        except BaseException:
            if suppress:
                raise outer from None
            raise outer from inner
    except BaseException as e:
        return e


def _context(outer, inner):
    """`outer` raised while handling `inner` (implicit __context__)."""
    try:
        try:
            raise inner
        except BaseException:
            raise outer
    except BaseException as e:
        return e


class _AcceleratorError(RuntimeError):
    pass


_AcceleratorError.__name__ = 'AcceleratorError'   # torch's CUDA error type

_CASES = {
    'transient-marker-type': lambda m: m.TransientError('x'),
    'fatal-with-marker': lambda m: m.FatalError('UNAVAILABLE'),
    'connection-reset': lambda m: ConnectionResetError('peer'),
    'broken-pipe': lambda m: BrokenPipeError(),
    'timeout-type': lambda m: TimeoutError(),
    'socket-timeout': lambda m: socket.timeout('slow'),
    'interrupted': lambda m: InterruptedError(),
    'resource-exhausted': lambda m: RuntimeError(
        'RESOURCE_EXHAUSTED: out of host memory'),
    'deadline': lambda m: OSError('DEADLINE_EXCEEDED while reading'),
    'try-again': lambda m: OSError('Resource temporarily unavailable, try '
                                   'again'),
    'plain-runtime': lambda m: RuntimeError('shape mismatch'),
    'value-error-with-marker': lambda m: ValueError('unavailable'),
    'key-error-with-marker': lambda m: KeyError('timed out'),
    'type-error': lambda m: TypeError('bad arg'),
    'assertion': lambda m: AssertionError('aborted'),
    'keyboard': lambda m: KeyboardInterrupt(),
    'system-exit': lambda m: SystemExit(1),
    'wrapped-transient': lambda m: _chain(RuntimeError('replica failed'),
                                          ConnectionError('reset')),
    'wrapped-fatal': lambda m: _chain(RuntimeError('unavailable'),
                                      m.FatalError('no')),
    'suppressed-transient': lambda m: _chain(
        RuntimeError('wrapper'), ConnectionError('reset'), suppress=True),
    'context-transient': lambda m: _context(ValueError('parse'),
                                            TimeoutError()),
    'programming-error-wrapping-transient': lambda m: _chain(
        TypeError('bad'), RuntimeError('UNAVAILABLE')),
}

# CUDA errors: (exception, the JAX function's answer)
_CUDA_CASES = {
    'launch-timed-out': lambda: RuntimeError(
        'CUDA error: the launch timed out and was terminated'),
    'device-unavailable': lambda: RuntimeError(
        'CUDA error: CUDA-capable device(s) is/are busy or unavailable'),
    'accelerator-error-type': lambda: _AcceleratorError(
        'device unavailable'),
    'wrapped-cuda': lambda: _chain(
        RuntimeError('request failed'),
        RuntimeError('CUDA error: the launch timed out and was terminated')),
}


@pytest.mark.parametrize('case', sorted(_CASES))
def test_is_transient_equals_jax(case):
    got = retry.is_transient(_CASES[case](retry))
    want = jretry.is_transient(_CASES[case](jretry))
    assert got == want


@pytest.mark.parametrize('case', sorted(_CUDA_CASES))
def test_cuda_errors_are_never_transient(case):
    """A CUDA error leaves the context dead: the port never retries it,
    where the JAX classifier (which has no CUDA) reads its text against
    the markers and says True."""
    exc = _CUDA_CASES[case]()
    assert retry.is_cuda_error(next(retry.exception_chain(exc))) == \
        (case != 'wrapped-cuda')
    assert retry.is_transient(exc) is False
    assert jretry.is_transient(exc) is True


def test_engine_device_fault_uses_the_same_rule():
    for case, make in _CUDA_CASES.items():
        exc = make()
        assert port_engine._device_fault(exc) == retry.is_cuda_error(exc)
    assert not port_engine._device_fault(RuntimeError('unavailable'))


def test_register_transient_and_chain_walk_like_jax():
    class Throttled(Exception):
        pass

    for mod in (retry, jretry):
        assert not mod.is_transient(Throttled('slow down'))
        assert mod.register_transient(Throttled) is Throttled
        assert mod.is_transient(_chain(RuntimeError('x'), Throttled()))
    e = _chain(RuntimeError('a'), ValueError('b'))
    assert [type(x).__name__ for x in retry.exception_chain(e)] == \
        [type(x).__name__ for x in jretry.exception_chain(e)] == \
        ['RuntimeError', 'ValueError']


def test_call_with_retry_and_policy_like_jax():
    for mod in (retry, jretry):
        sleeps, calls = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise mod.TransientError('blip')
            return 'ok'

        pol = mod.RetryPolicy(max_retries=3, base_delay=0.5, jitter=0.0,
                              sleep=sleeps.append)
        assert mod.call_with_retry(flaky, policy=pol) == 'ok'
        assert sleeps == [0.5, 1.0] and len(calls) == 3
        with pytest.raises(ValueError):
            mod.call_with_retry(lambda: (_ for _ in ()).throw(
                ValueError('unavailable')), policy=pol)
        calls.clear()
        budget = mod.RetryPolicy(max_retries=1, base_delay=0.0,
                                 sleep=sleeps.append)
        with pytest.raises(mod.TransientError):
            mod.call_with_retry(flaky, policy=budget)
        assert len(calls) == 2
        wrapped = mod.retry(pol)(flaky)
        calls.clear()
        assert wrapped() == 'ok'
        assert [mod.RetryPolicy(base_delay=1.0, max_delay=3.0,
                                jitter=0.0).delay(a)
                for a in range(4)] == [1.0, 2.0, 3.0, 3.0]


def test_flags_registry_like_jax():
    # the JAX registry also holds flags its other modules register
    assert set(flags.get_flags()) <= set(jflags.get_flags())
    assert flags.get_flags(['ft_max_retries', 'ft_retry_base_delay',
                            'ft_retry_max_delay']) == {
        'FLAGS_ft_max_retries': 3, 'FLAGS_ft_retry_base_delay': 0.1,
        'FLAGS_ft_retry_max_delay': 30.0}
    old = flags.get_flags('ft_max_retries')
    try:
        flags.set_flags({'FLAGS_ft_max_retries': 7})
        assert retry.RetryPolicy().max_retries == 7
        assert jretry.RetryPolicy().max_retries == old['FLAGS_ft_max_retries']
    finally:
        flags.set_flags(old)
    for mod in (flags, jflags):
        with pytest.raises(ValueError, match='not registered'):
            mod.get_flags('FLAGS_no_such_flag')
        with pytest.raises(TypeError):
            mod.set_flags([('FLAGS_ft_max_retries', 1)])


# ---------------------------------------------------------------------------
# the checkpoint manager
# ---------------------------------------------------------------------------

def _port_tree(seed):
    rng = np.random.RandomState(seed)
    return {'params': {'w': torch.from_numpy(
                rng.standard_normal((4, 3)).astype(np.float32)),
                       'w16': torch.from_numpy(rng.standard_normal(
                           (2, 5)).astype(np.float32)).bfloat16()},
            'opt_state': [np.arange(3, dtype=np.int64) + seed],
            'step': seed, 'lr': 0.5, 'tag': 'run'}


def _jax_tree(seed):
    """The same tree in the JAX package's types."""
    t = _port_tree(seed)
    return {'params': {'w': paddle.to_tensor(t['params']['w'].numpy()),
                       'w16': paddle.to_tensor(
                           t['params']['w16'].float().numpy().astype(
                               ml_dtypes.bfloat16))},
            'opt_state': t['opt_state'], 'step': seed, 'lr': 0.5,
            'tag': 'run'}


def _host(leaf):
    """(dtype name, raw bytes) of a restored host leaf of either package."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace('torch.', ''), \
            leaf.view(torch.int16 if leaf.element_size() == 2 else
                      torch.int32).numpy().tobytes()
    a = np.asarray(leaf)
    return a.dtype.name, a.tobytes()


def _flat(tree):
    return {'w': _host(tree['params']['w']),
            'w16': _host(tree['params']['w16']),
            'opt': _host(tree['opt_state'][0]),
            'step': _host(tree['step']), 'lr': _host(tree['lr']),
            'tag': tree['tag']}


def test_save_restore_and_host_leaves(tmp_path):
    mgr = CheckpointManager(str(tmp_path / 'c'))
    assert mgr.backend == 'npz' and mgr.latest_step() is None
    assert mgr.save(1, _port_tree(1))
    tree = mgr.restore()
    want = _port_tree(1)
    assert isinstance(tree['params']['w'], np.ndarray)
    assert tree['params']['w16'].dtype == torch.bfloat16
    assert torch.equal(tree['params']['w16'], want['params']['w16'])
    np.testing.assert_array_equal(tree['params']['w'],
                                  want['params']['w'].numpy())
    assert tree['step'].shape == () and int(tree['step']) == 1
    assert tree['tag'] == 'run'
    assert mgr.verify(1) and mgr.all_steps() == [1]


def test_retention_interval_and_missing_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path / 'c'), max_to_keep=2,
                            save_interval_steps=2)
    assert not mgr.save(3, _port_tree(3))        # off the interval
    for s in (2, 4, 6, 8):
        assert mgr.save(s, _port_tree(s))
    assert mgr.save(9, _port_tree(9), force=True)
    assert mgr.all_steps() == [8, 9] and mgr.latest_step() == 9
    with pytest.raises(FileNotFoundError):
        mgr.restore(step=4)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / 'empty')).restore()


@pytest.mark.parametrize('backend', ['orbax', 'native', 'npz'])
def test_backends(tmp_path, backend):
    """'npz' is the port's default backend and 'native' the sharded one
    over the host shard writer (a step saved and restored); 'orbax' raises
    as the JAX manager does without orbax."""
    if backend == 'native':
        mgr = CheckpointManager(str(tmp_path), backend=backend)
        assert mgr.backend == 'native'
        mgr.save(1, {'w': torch.arange(4.0), 'step': 1})
        tree = mgr.restore()
        assert np.array_equal(tree['w'], np.arange(4.0, dtype=np.float32))
        assert (tmp_path / 'step_1' / 'tree_sharded').is_dir()
    elif backend == 'orbax':
        with pytest.raises(RuntimeError, match='orbax'):
            CheckpointManager(str(tmp_path), backend=backend)
    else:
        assert CheckpointManager(str(tmp_path), backend=backend).backend == \
            'npz'


def test_async_save_takes_its_host_copy_before_the_writer(tmp_path):
    """An in-place update right after `save` returns (what a train loop
    does next) must not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path / 'c'), async_save=True)
    tree = _port_tree(5)
    w = tree['params']['w']
    before = w.clone()
    mgr.save(5, tree)
    w.add_(100.0)
    mgr.wait_until_finished()
    np.testing.assert_array_equal(mgr.restore()['params']['w'],
                                  before.numpy())


def test_async_write_failure_surfaces(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path / 'c'), async_save=True,
                            retry_policy=retry.RetryPolicy(max_retries=0))

    def broken(obj, path):
        raise OSError('disk full')

    monkeypatch.setattr(ckpt.serialization, 'save', broken)
    mgr.save(1, _port_tree(1))
    with pytest.raises(RuntimeError, match='NOT committed') as ei:
        mgr.wait_until_finished()
    assert 'disk full' in str(ei.value.__cause__)
    assert mgr.all_steps() == []


def test_transient_write_is_retried(tmp_path, monkeypatch):
    real = ckpt.serialization.save
    calls = []

    def flaky(obj, path):
        calls.append(path)
        if len(calls) == 1:
            raise ConnectionResetError('mount dropped')
        real(obj, path)

    monkeypatch.setattr(ckpt.serialization, 'save', flaky)
    mgr = CheckpointManager(str(tmp_path / 'c'), retry_policy=retry.
                            RetryPolicy(base_delay=0.0, sleep=lambda s: None))
    mgr.save(1, _port_tree(1))
    assert len(calls) == 2 and mgr.all_steps() == [1] and mgr.verify(1)


@pytest.mark.parametrize('reader', ['port', 'jax'])
def test_corrupt_payload_falls_back_to_previous_step(tmp_path, reader):
    mgr = CheckpointManager(str(tmp_path / 'c'))
    mgr.save(1, _port_tree(1))
    mgr.save(2, _port_tree(2))
    payload = tmp_path / 'c' / 'step_2' / 'tree.npz'
    raw = bytearray(payload.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    payload.write_bytes(bytes(raw))
    other = mgr if reader == 'port' else JaxManager(str(tmp_path / 'c'),
                                                    backend='npz')
    assert not other.verify(2) and other.verify(1)
    assert _flat(other.restore()) == _flat(mgr.restore(step=1))
    assert int(np.asarray(other.restore(step=2)['step'])) == 1
    (tmp_path / 'c' / 'step_1' / 'tree.npz').write_bytes(b'torn')
    with pytest.raises(RuntimeError, match='checksum'):
        mgr.restore()


def test_dataloader_cursor_rides_the_sidecar(tmp_path):
    class Loader:
        def __init__(self):
            self.cursor = {'epoch': 2, 'batch_idx': 17}

        def state_dict(self):
            return dict(self.cursor)

        def set_state_dict(self, state):
            self.cursor = dict(state)

    mgr = CheckpointManager(str(tmp_path / 'c'))
    mgr.save(1, _port_tree(1), dataloader=Loader())
    fresh = Loader()
    fresh.cursor = {}
    mgr.restore(dataloader=fresh)
    assert fresh.cursor == {'epoch': 2, 'batch_idx': 17}


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_checkpoints_cross_restore_bit_equal(tmp_path, writer):
    """A checkpoint written by either package restores in both, every
    leaf bit-equal (bf16 included), the steps and checksums alike."""
    d = str(tmp_path / 'c')
    if writer == 'port':
        w = CheckpointManager(d, max_to_keep=2)
        trees = {s: _port_tree(s) for s in (1, 2, 3)}
    else:
        w = JaxManager(d, max_to_keep=2, backend='npz')
        trees = {s: _jax_tree(s) for s in (1, 2, 3)}
    for s, t in trees.items():
        w.save(s, t)
    port, jax_mgr = CheckpointManager(d), JaxManager(d, backend='npz')
    assert port.all_steps() == jax_mgr.all_steps() == [2, 3]
    assert all(port.verify(s) and jax_mgr.verify(s) for s in (2, 3))
    for s in (2, 3):
        got = _flat(port.restore(step=s))
        assert got == _flat(jax_mgr.restore(step=s)) == _flat(_port_tree(s))
