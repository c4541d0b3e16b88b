"""The port's eager autograd (torch's engine behind Paddle's surface)
against the JAX package's tape, on the CPU.

`backward` with and without `retain_graph` (a second backward without
it raises in both), accumulation over two backwards, `register_hook`
(the hook sees the whole gradient, and its result replaces it),
`stop_gradient` set on a non-leaf, `grad` (no `.grad` touched,
`allow_unused`, `create_graph` to second and third order), `PyLayer`
(saved tensors, two inputs, a None gradient, a second derivative through
its backward), `jacobian` (batch_axis None and 0, lists) and `hessian`,
values against the JAX package's on seeded numpy inputs. Tolerance f32
rtol 1e-5, atol 1e-6.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu_torch as ptt

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope='module')
def _cpu_place():
    ptt.set_device('cpu')
    yield
    ptt.set_device('gpu')


def _a(seed=0, shape=(3, 4)):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _both(fn):
    """fn(P) run on each package; their results as numpy, JAX's first."""
    out = []
    for P in (paddle, ptt):
        r = fn(P)
        out.append([None if x is None else np.asarray(x.numpy())
                    for x in (r if isinstance(r, (list, tuple)) else [r])])
    return out


def _close(pair):
    want, got = pair
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('retain', [False, True])
def test_backward_with_and_without_retain_graph(retain):
    a = _a()

    def run(P):
        x = P.to_tensor(a, stop_gradient=False)
        y = (P.tanh(x) * x).sum()
        y.backward(retain_graph=retain)
        if retain:
            y.backward()              # accumulates into x.grad
        else:
            with pytest.raises(RuntimeError):
                y.backward()
        return x.grad
    _close(_both(run))


def test_gradients_accumulate_and_clear():
    a = _a()

    def run(P):
        x = P.to_tensor(a, stop_gradient=False)
        (x * x).sum().backward()
        (3.0 * x).sum().backward()
        g = x.grad
        x.clear_grad()
        assert x.grad is None
        return g
    _close(_both(run))


def test_backward_of_a_non_scalar_needs_grad_tensors():
    a = _a()

    def run(P):
        x = P.to_tensor(a, stop_gradient=False)
        y = x * 2.0
        with pytest.raises(RuntimeError, match='scalar'):
            y.backward()
        P.autograd.backward([y], [P.to_tensor(a)])
        return x.grad
    _close(_both(run))


def test_hooks_see_the_whole_gradient_and_can_replace_it():
    a = _a()

    def run(P):
        x = P.to_tensor(a, stop_gradient=False)
        seen = []
        h = x.register_hook(lambda g: seen.append(g.numpy()) or g * 0.5)
        (x * x + x).sum().backward()     # two paths into x
        h.remove()
        (x * 1.0).sum().backward()
        return [P.to_tensor(seen[0]), x.grad]
    _close(_both(run))


def test_stop_gradient_on_a_non_leaf():
    a = _a()

    def run(P):
        x = P.to_tensor(a, stop_gradient=False)
        y = x * 2.0
        y.stop_gradient = True
        z = (y * x).sum()
        z.backward()
        return x.grad
    _close(_both(run))


def test_grad_leaves_dot_grad_and_checks_unused():
    a, b = _a(0), _a(1)

    def run(P):
        x = P.to_tensor(a, stop_gradient=False)
        w = P.to_tensor(b, stop_gradient=False)
        u = P.to_tensor(b, stop_gradient=False)
        y = (P.sin(x) * w).sum()
        gx, gw = P.grad(y, [x, w], retain_graph=True)
        assert x.grad is None and w.grad is None
        with pytest.raises(RuntimeError, match='allow_unused'):
            P.grad(y, [x, u], retain_graph=True)
        gu = P.grad(y, [u], allow_unused=True)[0]
        assert gu is None
        return [gx, gw]
    _close(_both(run))


def test_grad_create_graph_to_third_order():
    a = _a(2, (5,))

    def run(P):
        x = P.to_tensor(a, stop_gradient=False)
        y = (x ** 3 * P.exp(0.1 * x)).sum()
        (g1,) = P.grad(y, [x], create_graph=True)
        (g2,) = P.grad(g1.sum(), [x], create_graph=True)
        (g3,) = P.grad(g2.sum(), [x])
        return [g1, g2, g3]
    _close(_both(run))


def _cube(P):
    class Cube(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k=1.0):
            ctx.save_for_backward(x)
            ctx.k = k
            return x * x * x * k

        @staticmethod
        def backward(ctx, grad):
            x, = ctx.saved_tensor()
            return 3 * x * x * grad * ctx.k
    return Cube


def _scaled_pair(P):
    class Pair(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, y):
            ctx.save_for_backward(x, y)
            return x * y, x + y

        @staticmethod
        def backward(ctx, g_prod, g_sum):
            x, y = ctx.saved_tensor()
            return g_prod * y + g_sum, None     # no gradient for y
    return Pair


def test_pylayer_custom_gradient():
    a, b = _a(0), _a(1)

    def run(P):
        x = P.to_tensor(a, stop_gradient=False)
        y = P.to_tensor(b, stop_gradient=False)
        c = _cube(P).apply(x, k=2.0)
        p, s = _scaled_pair(P).apply(x, y)
        (c.sum() + (p * s).sum()).backward()
        return [c, p, s, x.grad, y.grad]
    _close(_both(run))


def test_pylayer_second_derivative_through_its_backward():
    a = _a(3, (4,))

    def run(P):
        x = P.to_tensor(a, stop_gradient=False)
        y = _cube(P).apply(x).sum()
        (g,) = P.grad(y, [x], create_graph=True)
        (h,) = P.grad(g.sum(), [x])
        return [g, h]
    _close(_both(run))


def test_pylayer_must_return_tensors():
    class Bad(ptt.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            return 3

        @staticmethod
        def backward(ctx, g):
            return g
    with pytest.raises(TypeError, match='Tensor'):
        Bad.apply(ptt.to_tensor(_a(), stop_gradient=False))


@pytest.mark.parametrize('batch_axis', [None, 0])
def test_jacobian_matches_jax(batch_axis):
    a, w = _a(4, (3, 4)), _a(5, (4, 2))

    def run(P):
        x = P.to_tensor(a, stop_gradient=False)
        W = P.to_tensor(w, stop_gradient=False)
        y = P.tanh(P.matmul(x, W))
        j = P.autograd.jacobian(y, x, batch_axis=batch_axis)
        jl = P.autograd.jacobian([y, y * 2.0], [x, W]) \
            if batch_axis is None else []
        return [j] + [t for row in jl for t in row]
    _close(_both(run))


def test_hessian_matches_jax():
    a, b = _a(6, (3,)), _a(7, (2,))

    def run(P):
        x = P.to_tensor(a, stop_gradient=False)
        z = P.to_tensor(b, stop_gradient=False)
        y = (x ** 3).sum() * (z ** 2).sum() + (P.sin(x) ** 2).sum()
        hxx = P.autograd.hessian(y, x)
        blocks = P.autograd.hessian(y, [x, z])
        return [hxx] + [t for row in blocks for t in row]
    _close(_both(run))


def test_no_grad_enable_grad_and_set_grad_enabled():
    x = ptt.to_tensor(_a(), stop_gradient=False)
    with ptt.no_grad():
        assert not ptt.is_grad_enabled()
        assert (x * 2).stop_gradient
        with ptt.enable_grad():
            assert not (x * 2).stop_gradient
    with ptt.set_grad_enabled(False):
        assert (x * 2).stop_gradient

    @ptt.no_grad()
    def f(t):
        return t * 2
    assert f(x).stop_gradient and ptt.is_grad_enabled()
