"""The port's eager `Tensor` against the JAX package's, on the CPU.

Attributes, `shape` as a list, printing, indexing and `__setitem__`, the
in-place forms' rebind (after the old value was saved for a backward,
whose gradient must stay the one of the old value), `to_tensor`'s dtype
rules, places and the default dtype, `Parameter`, and `apply_op`'s
wrapping rule (plain torch in, plain torch out). Values from seeded
numpy inputs; f32 tolerance rtol 1e-5, atol 1e-6. Dtypes map through
`test_torch_ops.same_dtype` (the JAX package narrows 64-bit types).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu_torch.tensor import apply_op
from test_torch_ops import same_dtype

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope='module')
def _cpu_place():
    ptt.set_device('cpu')
    yield
    ptt.set_device('gpu')


def _x(seed=0, shape=(3, 4)):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def test_attributes_match_jax():
    a = _x()
    j, t = paddle.to_tensor(a), ptt.to_tensor(a)
    assert t.shape == j.shape == [3, 4] and isinstance(t.shape, list)
    assert t.ndim == j.ndim and t.size == j.size and t.numel() == j.numel()
    assert t.dim() == 2 and len(t) == 3
    assert t.stop_gradient and j.stop_gradient and t.is_leaf
    assert same_dtype(j.dtype, t.dtype)
    assert t.place == ptt.CPUPlace(0) and t.place != ptt.CUDAPlace(0)
    np.testing.assert_array_equal(t.numpy(), j.numpy())
    assert t.tolist() == np.asarray(j.numpy()).tolist()
    s = ptt.to_tensor(2.5)
    assert float(s) == 2.5 and int(s) == 2 and bool(s) and s.item() == 2.5
    with pytest.raises(TypeError):
        len(s)
    assert np.asarray(t).shape == (3, 4)


def test_printing_follows_the_print_options():
    t = ptt.to_tensor(np.float32([[1.123456, 2.0]]))
    r = repr(t)
    assert r.startswith('Tensor(shape=[1, 2], dtype=float32, '
                        'place=Place(cpu:0), stop_gradient=True,')
    assert '1.1235' in r
    ptt.set_printoptions(precision=2)
    try:
        assert '1.12' in repr(t) and '1.123' not in repr(t)
    finally:
        ptt.set_printoptions(precision=4)
    assert str(t) == repr(t)
    b = ptt.to_tensor(np.ones((2, 2), np.float32)).astype('bfloat16')
    assert 'dtype=bfloat16' in repr(b)


@pytest.mark.parametrize('index', [
    1, -1, (1, 2), slice(1, 3), (slice(None), 2), (Ellipsis, 1), [0, 2],
    (None, 1), 'tensor', 'mask'])
def test_indexing_matches_jax(index):
    a = _x()
    j = paddle.to_tensor(a, stop_gradient=False)
    t = ptt.to_tensor(a, stop_gradient=False)
    if index == 'tensor':
        ij, it = paddle.to_tensor(np.int32([2, 0])), ptt.to_tensor(
            np.int32([2, 0]))
    elif index == 'mask':
        m = a > 0
        ij, it = paddle.to_tensor(m), ptt.to_tensor(m)
    else:
        ij = it = index
    gj, gt = j[ij], t[it]
    np.testing.assert_allclose(gt.numpy(), gj.numpy(), rtol=RTOL, atol=ATOL)
    gj.sum().backward()
    gt.sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), j.grad.numpy())


@pytest.mark.parametrize('value', ['scalar', 'tensor'])
def test_setitem_rebinds_like_jax(value):
    a = _x()
    j = paddle.to_tensor(a, stop_gradient=False)
    t = ptt.to_tensor(a, stop_gradient=False)
    v = np.float32([7.0, 8.0, 9.0, 10.0])
    jw, tw = j * 2.0, t * 2.0
    if value == 'scalar':
        jw[1] = 5.0
        tw[1] = 5.0
    else:
        jw[1] = paddle.to_tensor(v)
        tw[1] = ptt.to_tensor(v)
    np.testing.assert_allclose(tw.numpy(), jw.numpy())
    (jw * jw).sum().backward()
    (tw * tw).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), j.grad.numpy(), rtol=RTOL)


def test_inplace_rebind_after_a_recorded_use():
    """`x.add_(1)` after `y = x * x` was recorded: the backward of y still
    uses the old x (a rebind, not a write over a saved value)."""
    a = _x()
    for P in (paddle, ptt):
        w = P.to_tensor(a, stop_gradient=False)
        x = w * 1.0
        y = x * x
        x.add_(1.0)
        x.scale_(2.0)
        (y.sum() + x.sum()).backward()
        np.testing.assert_allclose(w.grad.numpy(), 2 * a + 2.0, rtol=RTOL)
        np.testing.assert_allclose(x.numpy(), 2 * (a + 1.0), rtol=RTOL)


def test_leaf_update_under_no_grad_keeps_a_trainable_leaf():
    """The canonical loop: `w -= lr * w.grad` under no_grad, then reuse."""
    X = _x(1, (16, 3))
    y = X @ np.float32([[2.0], [-1.0], [0.5]])
    outs = {}
    for P in (paddle, ptt):
        w = P.zeros([3, 1])
        w.stop_gradient = False
        Xt, yt = P.to_tensor(X), P.to_tensor(y)
        for _ in range(30):
            loss = ((P.matmul(Xt, w) - yt) ** 2).mean()
            loss.backward()
            with P.no_grad():
                w -= 0.1 * w.grad
            w.clear_grad()
        assert not w.stop_gradient and w.is_leaf and w.grad is None
        outs[P.__name__] = (w.numpy(), float(loss))
    np.testing.assert_allclose(outs['paddle_tpu_torch'][0],
                               outs['paddle_tpu'][0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(outs['paddle_tpu_torch'][1],
                               outs['paddle_tpu'][1], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize('data,dtype', [
    (3, None), (2 ** 40, None), (2.5, None), (True, None),
    ([1.0, 2.0], None), (np.float64([1.0, 2.0]), None),
    (np.int32([1, 2]), None), (np.int64([1, 2]), None),
    (np.float16([1.0]), None), ([1, 2], 'float32'), (1.5, 'int32'),
    (np.float32([1.5]), 'bfloat16'), ([1, 0], 'bool'),
    (np.float32([1.0]), 'float64')])
def test_to_tensor_dtype_rules_match_jax(data, dtype):
    t = ptt.to_tensor(data, dtype=dtype)
    if isinstance(data, int) and not isinstance(data, bool) \
            and abs(data) > 2 ** 31 - 1:
        # the JAX package names INT64 here, which x64 narrows to int32, so
        # the value overflows there; the port gives int64
        assert t.dtype == torch.int64 and t.item() == data
        return
    j = paddle.to_tensor(data, dtype=dtype)
    if dtype == 'float64':
        assert t.dtype == torch.float64      # 64-bit stays 64-bit
    else:
        assert same_dtype(j.dtype, t.dtype), (j.dtype, t.dtype)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy(),
                                                        t.numpy().dtype))


def test_default_dtype_and_places():
    assert ptt.get_default_dtype() == torch.float32
    ptt.set_default_dtype('float64')
    try:
        assert ptt.to_tensor(1.5).dtype == torch.float64
        assert ptt.zeros([2]).dtype == torch.float64
    finally:
        ptt.set_default_dtype('float32')
    assert ptt.get_device() == 'cpu:0' and ptt.get_place() == ptt.CPUPlace(0)
    with ptt.device_guard('gpu:1'):
        assert ptt.get_device() == 'gpu:1'
    assert ptt.get_device() == 'cpu:0'
    for bad in ('tpu', 'xla:0'):
        with pytest.raises(ValueError, match='CUDAPlace'):
            ptt.set_device(bad)
    with pytest.raises(ValueError, match='CUDAPlace'):
        ptt.TPUPlace(0)
    with pytest.raises(ValueError, match='unknown device'):
        ptt.set_device('npu')
    assert ptt.iinfo('int16').max == 32767 and ptt.finfo('float16').max \
        == 65504.0
    assert ptt.dtype.dtype_name(torch.bfloat16) == 'bfloat16'
    assert ptt.dtype.convert_dtype('half') == torch.float16
    t = ptt.to_tensor(np.float32([1.0]), place='cpu')
    assert t.cpu().place == ptt.CPUPlace(0)


def test_creation_lands_on_the_current_place(monkeypatch):
    """Without a card the default place raises, as the port's entry
    points do; set_device('cpu') puts creations on the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with ptt.device_guard('gpu'):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ptt.zeros([2])
    assert ptt.ones([2]).place == ptt.CPUPlace(0)


def test_parameter_adds_the_paddle_names():
    layer = ptt.nn.Linear(3, 2, device='cpu', dtype=torch.float32)
    p = layer.weight
    assert isinstance(p, ptt.Parameter) and isinstance(p, torch.nn.Parameter)
    assert not p.stop_gradient and p.trainable and p.persistable
    p.stop_gradient = True
    assert not p.requires_grad and not p.trainable
    p.trainable = True
    p.name = 'fc.w'
    assert p.name == 'fc.w'
    assert type(p * 2) is torch.Tensor          # torch's ops, plain outputs
    assert p.numpy().shape == (3, 2)
    h = p.astype('bfloat16')
    assert isinstance(h, ptt.Tensor) and h.dtype == torch.bfloat16
    (layer(ptt.ones([1, 3])) ** 2).sum().backward()
    assert p.grad is not None
    p.clear_grad()
    assert p.grad is None


def test_apply_op_wraps_only_when_a_tensor_came_in():
    x = torch.ones(2, 3)
    out = apply_op(torch.add, x, x, _name='add')
    assert type(out) is torch.Tensor
    out = apply_op(lambda a, b: (a + b, [a * b]), ptt.to_tensor(x.numpy()),
                   x, _name='pair')
    assert isinstance(out[0], ptt.Tensor) and isinstance(out[1][0],
                                                         ptt.Tensor)
    layer = ptt.nn.Linear(3, 2, device='cpu', dtype=torch.float32)
    assert type(layer(x)) is torch.Tensor
    assert isinstance(layer(ptt.to_tensor(x.numpy())), ptt.Tensor)


def test_detach_clone_astype_and_grad_hooks():
    a = _x()
    t = ptt.to_tensor(a, stop_gradient=False)
    c = t.clone()
    d = c.detach()
    assert not c.stop_gradient and d.stop_gradient
    h = t.astype('float16')
    assert h.dtype == torch.float16
    np.testing.assert_allclose(h.numpy(), a.astype(np.float16))
    assert t.value.data_ptr() != c.value.data_ptr()
    e = c * 1.0
    e.stop_gradient = True          # a non-leaf cut off the graph
    assert e.is_leaf and e.stop_gradient
