"""`static` of the port against the JAX package's, on the CPU.

The same programs are built in both packages (placeholders, the same
weights, the same ops) and run by each `Executor` on the same seeded
feeds. The port records a program's ops at `tensor.apply_op` and replays
them through the same wrappers, so a replay calls the kernels' wrappers
(counted here; their plain versions on the CPU, the kernels on the card:
tests/test_torch_cuda.py, chip_smoke.py phase 14). Tolerance: f32 rtol
1e-5, atol 1e-6 of the output's scale.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch import tensor as ttensor
from paddle_tpu_torch.ops import kernels as K


@pytest.fixture(autouse=True)
def _cpu_place_and_dynamic_mode():
    ptt.set_device('cpu')
    yield
    paddle.disable_static()
    ptt.disable_static()
    ptt.set_device('gpu')


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=1e-6 * scale)


def _both(build, feeds, fetch_count=1):
    """Build the program with `build(pkg)` (under each package's
    program_guard) and run each package's Executor on every feed dict;
    returns ([JAX outputs per feed], [port outputs per feed], the port's
    program)."""
    outs, progs = [], []
    for pkg in (paddle, ptt):
        pkg.enable_static()
        main = pkg.static.Program()
        with pkg.static.program_guard(main):
            fetches = build(pkg)
        exe = pkg.static.Executor()
        outs.append([exe.run(main, feed=f, fetch_list=fetches)
                     for f in feeds])
        progs.append(main)
        pkg.disable_static()
    return outs[0], outs[1], progs[1]


def test_mode_switch_matches_jax():
    for pkg in (paddle, ptt):
        assert pkg.in_dynamic_mode()
        pkg.enable_static()
        assert not pkg.in_dynamic_mode() and pkg.static.in_static_mode()
        pkg.disable_static()
        assert pkg.in_dynamic_mode()


def test_program_replays_at_other_batch_sizes():
    """relu(x @ w - 1) with x [None, 4]: built at extent 1, replayed at
    batch 2 and 5, equal to the JAX Executor's; one plan per feed
    signature."""
    w = np.eye(4, 3, dtype=np.float32) * 2.0

    def build(pkg):
        x = pkg.static.data('x', [None, 4], 'float32')
        assert list(x.shape) == [1, 4]
        return [pkg.nn.functional.relu(
            pkg.matmul(x, pkg.to_tensor(w)) - 1.0)]
    feeds = [{'x': np.arange(8, dtype=np.float32).reshape(2, 4)},
             {'x': np.ones((5, 4), np.float32)},
             {'x': np.arange(8, dtype=np.float32).reshape(2, 4) + 1}]
    jout, tout, prog = _both(build, feeds)
    for j, t in zip(jout, tout):
        _close(t[0], j[0])
    assert tout[1][0].shape == (5, 3)
    assert len(prog._plans) == 2          # (2, 4) twice, (5, 4) once


def _llama_like(pkg, x, width, heads, rng_state):
    """fc -> RMSNorm -> causal attention, the weights from numpy."""
    rng = np.random.default_rng(rng_state)
    h = pkg.static.nn.fc(x, width, num_flatten_dims=2)
    gamma = pkg.to_tensor(rng.standard_normal(width).astype(np.float32))
    h = pkg.nn.functional.rms_norm(h, gamma, epsilon=1e-6)
    q = pkg.reshape(h, [-1, x.shape[1], heads, width // heads])
    return [pkg.nn.functional.scaled_dot_product_attention(q, q, q,
                                                           is_causal=True),
            h]


def test_fc_rms_norm_attention_program_matches_jax_and_calls_kernels():
    """A program of static.nn.fc, F.rms_norm and causal attention (head
    dim 64, the flash path) with the fc weights copied from the JAX
    program: equal outputs, and each replay calls the RMSNorm and flash
    wrappers once (the kernels on the card)."""
    seq, width, heads = 6, 128, 2

    def build(pkg):
        x = pkg.static.data('x', [None, seq, 32])
        if pkg is ptt:
            # the JAX fc's weights (drawn first) for the port's fc
            real = ptt.nn.Linear

            def linear(i, o):
                lin = real(i, o)
                with torch.no_grad():
                    lin.weight.copy_(torch.from_numpy(build.w))
                    lin.bias.copy_(torch.from_numpy(build.b))
                return lin
            ptt.nn.Linear = linear
            try:
                return _llama_like(pkg, x, width, heads, 1)
            finally:
                ptt.nn.Linear = real
        real = paddle.nn.Linear

        def keep(i, o):
            lin = real(i, o)
            build.w, build.b = lin.weight.numpy(), lin.bias.numpy()
            return lin
        paddle.nn.Linear = keep
        try:
            return _llama_like(pkg, x, width, heads, 1)
        finally:
            paddle.nn.Linear = real
    rng = np.random.default_rng(0)
    feeds = [{'x': rng.standard_normal((b, seq, 32)).astype(np.float32)}
             for b in (2, 3)]
    calls = {'rms': 0, 'flash': 0}
    rms, flash = K.rms_norm, K.flash_attention
    K.rms_norm = lambda *a, **k: calls.__setitem__(
        'rms', calls['rms'] + 1) or rms(*a, **k)
    K.flash_attention = lambda *a, **k: calls.__setitem__(
        'flash', calls['flash'] + 1) or flash(*a, **k)
    try:
        jout, tout, _ = _both(build, feeds)
    finally:
        K.rms_norm, K.flash_attention = rms, flash
    # one call each while recording, then one per replay
    assert calls == {'rms': 3, 'flash': 3}
    for j, t in zip(jout, tout):
        for a, b in zip(t, j):
            _close(a, b)


def test_executor_with_a_layer_equals_eager():
    """A program over a Linear built outside it: the replay reads the
    layer's weights as they are, equal to the eager forward."""
    ptt.seed(3)
    lin = ptt.nn.Linear(6, 2)
    ptt.enable_static()
    main = tstatic.Program()
    with tstatic.program_guard(main):
        x = tstatic.data('x', [None, 6])
        y = ptt.nn.functional.softmax(lin(x))
    feed = np.random.RandomState(0).randn(3, 6).astype(np.float32)
    out, = tstatic.Executor().run(main, feed={'x': feed}, fetch_list=[y])
    ptt.disable_static()
    want = ptt.nn.functional.softmax(lin(ptt.to_tensor(feed))).numpy()
    _close(out, want)
    assert len(main._ops) == 2            # the linear and the softmax


def test_default_program_and_multiple_fetches_match_jax():
    outs = []
    for pkg in (paddle, ptt):
        pkg.enable_static()
        x = pkg.static.data('inp', [None, 2])
        a = x * 2.0
        b = a.sum()
        outs.append(pkg.static.Executor().run(
            feed={'inp': np.ones((4, 2), np.float32)}, fetch_list=[a, b]))
        pkg.disable_static()
    for t, j in zip(*outs[::-1]):
        _close(t, j)
    np.testing.assert_allclose(outs[1][1], 16.0)


def test_return_numpy_false_gives_tensors():
    ptt.enable_static()
    main = tstatic.Program()
    with tstatic.program_guard(main):
        x = tstatic.data('x', [2, 2])
        y = x + 1.0
    out, = tstatic.Executor().run(main, feed={'x': np.zeros((2, 2))},
                                  fetch_list=[y], return_numpy=False)
    assert isinstance(out, ptt.Tensor) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.ones((2, 2)))


def test_errors_match_jax():
    for pkg in (paddle, ptt):
        pkg.enable_static()
        main = pkg.static.Program()
        with pkg.static.program_guard(main):
            x = pkg.static.data('x', [None, 2])
            y = x + 1.0
        exe = pkg.static.Executor()
        with pytest.raises(KeyError, match='never declared'):
            exe.run(main, feed={'wrong': np.ones((1, 2))}, fetch_list=[y])
        with pytest.raises(ValueError, match='fetch_list'):
            exe.run(main, feed={'x': np.ones((1, 2))}, fetch_list=[])
        with pytest.raises(TypeError, match='fetch_list'):
            exe.run(main, feed={'x': np.ones((1, 2))}, fetch_list=['y'])
        pkg.disable_static()


def test_recording_stops_outside_the_program():
    """program_guard records only inside its block; with no program
    recording, `apply_op`'s hook is None."""
    ptt.enable_static()
    main = tstatic.Program()
    with tstatic.program_guard(main):
        x = tstatic.data('x', [None, 2])
        y = x * 3.0
        assert ttensor._record_hook is not None
    n = len(main._ops)
    assert ttensor._record_hook is None
    _ = y + 1.0
    assert len(main._ops) == n == 1
    ptt.disable_static()
    assert ttensor._record_hook is None


@pytest.mark.parametrize('helper', ['batch_norm', 'conv2d', 'embedding'])
def test_static_nn_helpers_replay(helper):
    """static.nn's batch_norm (eval), conv2d and embedding in a program:
    the replay equals the same layer's eager call on the feed."""
    rng = np.random.default_rng(4)
    ptt.enable_static()
    main = tstatic.Program()
    with tstatic.program_guard(main):
        if helper == 'embedding':
            x = tstatic.data('x', [None, 5], 'int64')
            y = tstatic.nn.embedding(x, [10, 4])
            feed = rng.integers(0, 10, (3, 5))
        elif helper == 'conv2d':
            x = tstatic.data('x', [None, 3, 8, 8])
            y = tstatic.nn.conv2d(x, 4, 3, padding=1, act='relu')
            feed = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
        else:
            x = tstatic.data('x', [None, 3, 4, 4])
            y = tstatic.nn.batch_norm(x, is_test=True)
            feed = rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
    out, = tstatic.Executor().run(main, feed={'x': feed}, fetch_list=[y])
    ptt.disable_static()
    assert out.shape[0] == feed.shape[0]
    assert np.all(np.isfinite(out))
    assert len(main._ops) >= 1
