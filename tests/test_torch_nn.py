"""The port's `nn` (paddle_tpu_torch/nn) against the JAX package's, on the
CPU: every functional entry of the slice (forward, and the gradient of a
seeded cotangent for its float inputs), the layers (with weights carried
by `from_jax_state`), Paddle's constructors and `ParamAttr`, the
initializers, the randomness (statistics and seeds: the two packages
draw different numbers), the transformer layers, `paddle.grad(
no_grad_vars=)`, the head_dim rule of the attention kernels and the
plain D = 64 kernels against the Pallas oracles in interpret mode.

Tolerance: 1e-5 relative (and 1e-6 absolute) in f32, unless a test says
why not. Inputs are made from a seed with numpy and handed to both."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as tnn
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn import initializer as JI
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import initializer as TI
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.weights import from_jax_state

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _np_out(x):
    if isinstance(x, (tuple, list)):
        return [_np_out(t) for t in x]
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.numpy())


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


# ---------------------------------------------------------------------------
# the functional library: (id, entry, inputs from a rng, kwargs, indices of
# the inputs whose gradient is compared)
# ---------------------------------------------------------------------------

def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pos(rng, *shape):
    return rng.uniform(0.05, 0.95, shape).astype(np.float32)


def _ints(rng, hi, *shape):
    return rng.integers(0, hi, shape).astype(np.int64)


X = lambda r: [_x(r, 3, 4, 5)]
ACT = [('relu', {}), ('relu6', {}), ('gelu', {}),
       ('gelu', {'approximate': True}), ('silu', {}), ('sigmoid', {}),
       ('tanh', {}), ('leaky_relu', {'negative_slope': 0.2}), ('elu', {}),
       ('selu', {}), ('celu', {'alpha': 0.7}), ('hardswish', {}),
       ('hardsigmoid', {}), ('hardtanh', {'min': -0.5, 'max': 0.7}),
       ('hardshrink', {}), ('softshrink', {}), ('tanhshrink', {}),
       ('mish', {}), ('softplus', {'beta': 2.0, 'threshold': 3.0}),
       ('softsign', {}), ('logsigmoid', {}), ('glu', {'axis': 1}),
       ('softmax', {'axis': 1}), ('log_softmax', {}),
       ('thresholded_relu', {'threshold': 0.3}),
       ('maxout', {'groups': 2, 'axis': 1}),
       ('rrelu', {'training': False}), ('normalize', {'axis': 2}),
       ('normalize', {'p': 1, 'axis': 1}),
       ('dropout', {'p': 0.0}), ('dropout', {'p': 0.5, 'training': False}),
       ('alpha_dropout', {'p': 0.3, 'training': False}),
       ('local_response_norm', {'size': 3})]
CASES = [(f'{name}-{i}', name, X, kw, (0,))
         for i, (name, kw) in enumerate(ACT)]
CASES += [
    ('prelu', 'prelu', lambda r: [_x(r, 2, 4, 3), _pos(r, 4)], {}, (0, 1)),
    ('prelu_nhwc', 'prelu', lambda r: [_x(r, 2, 3, 4), _pos(r, 4)],
     {'data_format': 'NHWC'}, (0, 1)),
    ('linear', 'linear', lambda r: [_x(r, 2, 3, 4), _x(r, 4, 5),
                                    _x(r, 5)], {}, (0, 1, 2)),
    ('embedding', 'embedding', lambda r: [_ints(r, 7, 3, 4), _x(r, 7, 5)],
     {'padding_idx': 2}, (1,)),
    ('one_hot', 'one_hot', lambda r: [_ints(r, 6, 3, 4)],
     {'num_classes': 6}, ()),
    ('label_smooth', 'label_smooth', lambda r: [np.eye(5, dtype=np.float32)
                                                [_ints(r, 5, 4)]],
     {'epsilon': 0.2}, (0,)),
    ('cosine_similarity', 'cosine_similarity',
     lambda r: [_x(r, 3, 6), _x(r, 3, 6)], {}, (0, 1)),
    ('sequence_mask', 'sequence_mask', lambda r: [_ints(r, 6, 4)],
     {'maxlen': 7}, ()),
    ('bilinear', 'bilinear', lambda r: [_x(r, 3, 4), _x(r, 3, 5),
                                        _x(r, 2, 4, 5), _x(r, 2)], {},
     (0, 1, 2, 3)),
    ('pairwise_distance', 'pairwise_distance',
     lambda r: [_x(r, 4, 6), _x(r, 4, 6)], {'keepdim': True}, (0, 1)),
    ('pdist', 'pdist', lambda r: [_x(r, 5, 3)], {}, (0,)),
    ('layer_norm', 'layer_norm', lambda r: [_x(r, 2, 3, 8), 8, _x(r, 8),
                                            _x(r, 8)], {}, (0, 2, 3)),
    ('layer_norm_2d', 'layer_norm', lambda r: [_x(r, 2, 3, 4), (3, 4)],
     {}, (0,)),
    ('group_norm', 'group_norm', lambda r: [_x(r, 2, 6, 3, 2), 3, _x(r, 6),
                                            _x(r, 6)], {}, (0, 2, 3)),
    ('group_norm_nhwc', 'group_norm', lambda r: [_x(r, 2, 3, 2, 6), 2],
     {'data_format': 'NHWC'}, (0,)),
    ('instance_norm', 'instance_norm', lambda r: [_x(r, 2, 3, 5, 4)], {},
     (0,)),
    ('batch_norm_eval', 'batch_norm',
     lambda r: [_x(r, 4, 3, 5), _x(r, 3), _pos(r, 3), _x(r, 3), _x(r, 3)],
     {}, (0, 3, 4)),
    # losses
    ('ce_fused', 'cross_entropy',
     lambda r: [_x(r, 6, 9), np.array([1, 3, -100, 8, 0, 2])], {}, (0,)),
    ('ce_sum_n1', 'cross_entropy',
     lambda r: [_x(r, 6, 9), _ints(r, 9, 6, 1)], {'reduction': 'sum'}, (0,)),
    ('ce_soft', 'cross_entropy',
     lambda r: [_x(r, 4, 5), np.full((4, 5), 0.2, np.float32)],
     {'soft_label': True, 'label_smoothing': 0.1}, (0,)),
    ('ce_weight', 'cross_entropy',
     lambda r: [_x(r, 6, 5), np.array([1, 3, -100, 4, 0, 2]), _pos(r, 5)],
     {}, (0,)),
    ('ce_smooth_axis', 'cross_entropy',
     lambda r: [_x(r, 2, 5, 3), _ints(r, 5, 2, 3)],
     {'axis': 1, 'label_smoothing': 0.2, 'reduction': 'none'}, (0,)),
    ('ce_no_softmax', 'cross_entropy',
     lambda r: [_pos(r, 4, 5), _ints(r, 5, 4)], {'use_softmax': False},
     (0,)),
    ('softmax_with_ce', 'softmax_with_cross_entropy',
     lambda r: [_x(r, 4, 6), _ints(r, 6, 4, 1)], {}, (0,)),
    ('nll', 'nll_loss', lambda r: [_x(r, 5, 4), np.array([0, 3, -100, 1, 2])],
     {}, (0,)),
    ('nll_weight', 'nll_loss', lambda r: [_x(r, 5, 4), _ints(r, 4, 5),
                                          _pos(r, 4)],
     {'reduction': 'sum'}, (0,)),
    ('bce', 'binary_cross_entropy', lambda r: [_pos(r, 3, 4), _pos(r, 3, 4),
                                               _pos(r, 3, 4)], {}, (0,)),
    ('bce_logits', 'binary_cross_entropy_with_logits',
     lambda r: [_x(r, 3, 4), _pos(r, 3, 4)], {}, (0,)),
    ('bce_logits_pos', 'binary_cross_entropy_with_logits',
     lambda r: [_x(r, 3, 4), _pos(r, 3, 4), _pos(r, 3, 4)],
     {'reduction': 'sum'}, (0,)),
    ('mse', 'mse_loss', lambda r: [_x(r, 3, 4), _x(r, 3, 4)], {}, (0, 1)),
    ('l1', 'l1_loss', lambda r: [_x(r, 3, 4), _x(r, 3, 4)],
     {'reduction': 'none'}, (0,)),
    ('smooth_l1', 'smooth_l1_loss', lambda r: [_x(r, 3, 4), _x(r, 3, 4)],
     {'delta': 0.7}, (0,)),
    ('kl_div', 'kl_div', lambda r: [_x(r, 3, 4), _pos(r, 3, 4)],
     {'reduction': 'batchmean'}, (0,)),
    ('kl_div_log', 'kl_div', lambda r: [_x(r, 3, 4), _x(r, 3, 4)],
     {'log_target': True}, (0, 1)),
    ('margin_ranking', 'margin_ranking_loss',
     lambda r: [_x(r, 6), _x(r, 6), np.sign(_x(r, 6))], {'margin': 0.1},
     (0, 1)),
    ('hinge_embedding', 'hinge_embedding_loss',
     lambda r: [_x(r, 6), np.array([1, -1, 1, -1, -1, 1], np.float32)], {},
     (0,)),
    ('sigmoid_focal', 'sigmoid_focal_loss',
     lambda r: [_x(r, 3, 4), (_pos(r, 3, 4) > 0.5).astype(np.float32),
                np.array([2.0], np.float32)], {}, (0,)),
    ('square_error', 'square_error_cost', lambda r: [_x(r, 3, 4),
                                                     _x(r, 3, 4)], {}, (0,)),
    ('soft_margin', 'soft_margin_loss',
     lambda r: [_x(r, 3, 4), np.sign(_x(r, 3, 4))], {}, (0,)),
    ('multi_label_soft_margin', 'multi_label_soft_margin_loss',
     lambda r: [_x(r, 3, 4), (_pos(r, 3, 4) > 0.5).astype(np.float32),
                _pos(r, 4)], {}, (0,)),
    ('triplet', 'triplet_margin_loss',
     lambda r: [_x(r, 4, 5), _x(r, 4, 5), _x(r, 4, 5)], {'swap': True},
     (0, 1, 2)),
    ('triplet_distance', 'triplet_margin_with_distance_loss',
     lambda r: [_x(r, 4, 5), _x(r, 4, 5), _x(r, 4, 5)], {'margin': 0.5},
     (0,)),
    ('gaussian_nll', 'gaussian_nll_loss',
     lambda r: [_x(r, 3, 4), _x(r, 3, 4), _pos(r, 3, 4)], {'full': True},
     (0, 2)),
    ('poisson_nll', 'poisson_nll_loss',
     lambda r: [_x(r, 3, 4), _ints(r, 5, 3, 4).astype(np.float32)],
     {'full': True}, (0,)),
    ('poisson_nll_raw', 'poisson_nll_loss',
     lambda r: [_pos(r, 3, 4), _pos(r, 3, 4)], {'log_input': False}, (0,)),
    ('dice', 'dice_loss', lambda r: [_pos(r, 2, 3, 4), _ints(r, 4, 2, 3, 1)],
     {}, (0,)),
    ('npair', 'npair_loss', lambda r: [_x(r, 4, 3), _x(r, 4, 3),
                                       np.array([0, 1, 0, 2])], {}, (0, 1)),
    ('ctc', 'ctc_loss', lambda r: [_x(r, 7, 2, 5), np.array([[1, 2, 2],
                                                             [3, 1, 0]]),
                                   np.array([7, 5]), np.array([3, 2])],
     {}, (0,)),
    ('ctc_sum_norm', 'ctc_loss', lambda r: [_x(r, 6, 2, 4),
                                            np.array([[1, 2], [3, 0]]),
                                            np.array([6, 6]),
                                            np.array([2, 1])],
     {'reduction': 'sum', 'norm_by_times': True}, (0,)),
    ('cosine_embedding', 'cosine_embedding_loss',
     lambda r: [_x(r, 4, 5), _x(r, 4, 5), np.array([1, -1, 1, -1])],
     {'margin': 0.2}, (0, 1)),
    ('multi_margin', 'multi_margin_loss',
     lambda r: [_x(r, 4, 5), _ints(r, 5, 4), 2, 1.0, _pos(r, 5)], {},
     (0,)),
    ('log_loss', 'log_loss', lambda r: [_pos(r, 4, 1), _pos(r, 4, 1)], {},
     (0,)),
    ('hsigmoid', 'hsigmoid_loss',
     lambda r: [_x(r, 4, 3), _ints(r, 6, 4), 6, _x(r, 5, 3), _x(r, 5)],
     {}, (0, 3, 4)),
    ('hsigmoid_custom', 'hsigmoid_loss',
     lambda r: [_x(r, 2, 3), _ints(r, 4, 2), 4, _x(r, 3, 3), None,
                np.array([[0, 1, -1], [0, 2, -1]]),
                np.array([[1, 0, 0], [0, 1, 0]])], {}, (0, 3)),
    ('margin_ce', 'margin_cross_entropy',
     lambda r: [np.tanh(_x(r, 4, 6)), _ints(r, 6, 4)], {'scale': 8.0},
     (0,)),
    ('adaptive_log_softmax', 'adaptive_log_softmax_with_loss',
     lambda r: [_x(r, 5, 4), np.array([0, 2, 4, 6, 7]), _x(r, 4, 5),
                [(_x(r, 4, 2), _x(r, 2, 3)), (_x(r, 4, 1), _x(r, 1, 2))],
                [3, 6]], {}, (0,)),
    ('sdpa_mask', 'scaled_dot_product_attention',
     lambda r: [_x(r, 2, 5, 4, 16), _x(r, 2, 7, 2, 16), _x(r, 2, 7, 2, 16),
                _pos(r, 2, 1, 5, 7) > 0.3], {}, (0, 1, 2)),
    ('sdpa_causal', 'scaled_dot_product_attention',
     lambda r: [_x(r, 1, 6, 2, 64), _x(r, 1, 6, 2, 64), _x(r, 1, 6, 2, 64)],
     {'is_causal': True}, (0, 1, 2)),
    ('gather_tree', 'gather_tree',
     lambda r: [_ints(r, 9, 4, 2, 3), _ints(r, 3, 4, 2, 3)], {}, ()),
]


def _tensors(arrays, lib, grads):
    out = []
    for i, a in enumerate(arrays):
        if isinstance(a, np.ndarray):
            if lib == 'jax':
                t = paddle.to_tensor(a, stop_gradient=i not in grads)
            else:
                t = torch.from_numpy(a.copy()).requires_grad_(i in grads)
            out.append(t)
        elif isinstance(a, list) and a and isinstance(a[0], tuple):
            out.append([tuple(_tensors(list(p), lib, ()) )
                        for p in a])
        else:
            out.append(a)
    return out


def _loss(out, cot, lib):
    first = out[0] if isinstance(out, (tuple, list)) else out
    c = paddle.to_tensor(cot) if lib == 'jax' else torch.from_numpy(cot)
    return (first * c).sum()


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_functional_matches_jax(case):
    """Forward of every entry, and the gradients of sum(out * cot) for
    the listed inputs (a seeded cotangent), against the JAX entry."""
    cid, name, make, kw, grads = case
    arrays = make(np.random.default_rng(len(cid)))
    jt = _tensors(arrays, 'jax', grads)
    tt = _tensors(arrays, 'torch', grads)
    jout = getattr(JF, name)(*jt, **kw)
    tout = getattr(TF, name)(*tt, **kw)
    jv, tv = _np_out(jout), _np_out(tout)
    for got, want in zip(tv if isinstance(tv, list) else [tv],
                         jv if isinstance(jv, list) else [jv]):
        assert np.shape(got) == np.shape(want)
        _close(got, want)
    if not grads:
        return
    first = jv[0] if isinstance(jv, list) else jv
    cot = np.random.default_rng(99).standard_normal(
        np.shape(first)).astype(np.float32)
    _loss(jout, cot, 'jax').backward()
    _loss(tout, cot, 'torch').backward()
    for i in grads:
        _close(tt[i].grad.numpy(), np.asarray(jt[i].grad.numpy()),
               rtol=1e-4, atol=1e-5)


def test_functional_entries_cover_the_slice():
    """Every entry of the JAX module but `alltoall` (which waits for
    `distributed/`) has its port counterpart, the vision entries and the
    pools included."""
    deferred = {'alltoall'}
    names = {n for n in dir(JF) if not n.startswith('_')
             and callable(getattr(JF, n)) and getattr(
                 getattr(JF, n), '__module__', '') == JF.__name__}
    missing = sorted(n for n in names - deferred if not hasattr(TF, n))
    assert missing == []


def test_batch_norm_training_updates_running_stats_like_jax():
    """Training batch norm: the batch statistics normalize, and the
    running mean and (unbiased) variance move with Paddle's momentum
    (running = 0.9 running + 0.1 batch), in place, as the JAX package."""
    rng = np.random.default_rng(3)
    x, rm, rv = _x(rng, 6, 3, 4), _x(rng, 3), _pos(rng, 3)
    jm, jv = paddle.to_tensor(rm), paddle.to_tensor(rv)
    tm, tv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    want = JF.batch_norm(paddle.to_tensor(x), jm, jv, training=True,
                         momentum=0.8)
    got = TF.batch_norm(torch.from_numpy(x), tm, tv, training=True,
                        momentum=0.8)
    _close(got.numpy(), want.numpy())
    _close(tm.numpy(), jm.numpy())
    _close(tv.numpy(), jv.numpy())
    assert not np.allclose(tm.numpy(), rm)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_paddle_linear_constructor_on_the_current_place():
    """`nn.Linear(4, 8)` takes Paddle's constructor: a bias by default,
    Xavier-uniform weights in [in, out], on the current place; without a
    card it raises unless the place is the CPU."""
    with ptt.device_guard('gpu'), pytest.raises(RuntimeError,
                                                match='no CUDA device'):
        tnn.Linear(4, 8)
    with ptt.device_guard('cpu'):
        lin = tnn.Linear(4, 8)
        assert lin.weight.shape == (4, 8) and lin.bias.shape == (8,)
        assert lin.weight.device.type == 'cpu'
        assert float(lin.weight.abs().max()) <= math.sqrt(6 / 12) + 1e-6
        assert float(lin.bias.abs().max()) == 0.0
        assert tnn.Linear(4, 8, bias_attr=False).bias is None
        assert tnn.Linear(4, 8, bias=False).bias is None
        emb = tnn.Embedding(10, 4, padding_idx=3)
        assert float(emb.weight[3].abs().max()) == 0.0
        assert list(emb(torch.tensor([3])).shape) == [1, 4]


def test_param_attr_name_initializer_trainable():
    with ptt.device_guard('cpu'):
        lin = tnn.Linear(3, 2, weight_attr=ptt.ParamAttr(
            name='fc.w', initializer=TI.Constant(0.5), learning_rate=2.0,
            trainable=False), bias_attr=TI.Constant(-1.0))
        assert lin.weight.name == 'fc.w' and not lin.weight.trainable
        assert lin.weight.optimize_attr['learning_rate'] == 2.0
        assert torch.equal(lin.weight, torch.full((3, 2), 0.5))
        assert torch.equal(lin.bias, torch.full((2,), -1.0))
        layer = tnn.Layer()
        p = layer.create_parameter([2, 3], dtype='float64', is_bias=True)
        assert p.dtype == torch.float64 and float(p.abs().sum()) == 0.0
        assert layer.create_parameter([2], attr=False) is None


def _layer_pair(jax_layer, port_layer):
    return jax_layer, from_jax_state(_state(jax_layer), port_layer)


CPU = {'device': 'cpu'}
LAYERS = [
    ('LayerNorm', lambda: jnn.LayerNorm(6), lambda: tnn.LayerNorm(6, **CPU),
     (3, 6)),
    ('GroupNorm', lambda: jnn.GroupNorm(2, 4),
     lambda: tnn.GroupNorm(2, 4, **CPU), (2, 4, 3)),
    ('BatchNorm1D', lambda: jnn.BatchNorm1D(4),
     lambda: tnn.BatchNorm1D(4, **CPU), (5, 4, 3)),
    ('BatchNorm2D', lambda: jnn.BatchNorm2D(4),
     lambda: tnn.BatchNorm2D(4, **CPU), (2, 4, 3, 2)),
    ('BatchNorm3D', lambda: jnn.BatchNorm3D(2),
     lambda: tnn.BatchNorm3D(2, **CPU), (2, 2, 3, 2, 2)),
    ('InstanceNorm2D', lambda: jnn.InstanceNorm2D(3),
     lambda: tnn.InstanceNorm2D(3, **CPU), (2, 3, 4, 2)),
    ('LocalResponseNorm', lambda: jnn.LocalResponseNorm(3),
     lambda: tnn.LocalResponseNorm(3), (2, 5, 3)),
    ('PReLU', lambda: jnn.PReLU(4), lambda: tnn.PReLU(4, **CPU), (2, 4, 3)),
    ('Linear', lambda: jnn.Linear(5, 3), lambda: tnn.Linear(5, 3, **CPU),
     (2, 5)),
    ('Flatten', lambda: jnn.Flatten(), lambda: tnn.Flatten(), (2, 3, 4)),
    ('Identity', lambda: jnn.Identity(), lambda: tnn.Identity(), (2, 3)),
    ('GELU', lambda: jnn.GELU(), lambda: tnn.GELU(), (2, 3)),
    ('LeakyReLU', lambda: jnn.LeakyReLU(0.3), lambda: tnn.LeakyReLU(0.3),
     (2, 3)),
    ('Softmax', lambda: jnn.Softmax(axis=0), lambda: tnn.Softmax(axis=0),
     (2, 3)),
    ('Maxout', lambda: jnn.Maxout(2), lambda: tnn.Maxout(2), (2, 4, 3)),
    ('Dropout-eval', lambda: jnn.Dropout(0.5).eval(),
     lambda: tnn.Dropout(0.5).eval(), (2, 3)),
    ('RReLU-eval', lambda: jnn.RReLU().eval(), lambda: tnn.RReLU().eval(),
     (2, 3)),
    ('Sequential', lambda: jnn.Sequential(jnn.Linear(3, 4), jnn.ReLU(),
                                          jnn.Linear(4, 2)),
     lambda: tnn.Sequential(tnn.Linear(3, 4, **CPU), tnn.ReLU(),
                            tnn.Linear(4, 2, **CPU)), (2, 3)),
    ('Sequential-named', lambda: jnn.Sequential(('a', jnn.Linear(3, 4)),
                                                ('b', jnn.Tanh())),
     lambda: tnn.Sequential(('a', tnn.Linear(3, 4, **CPU)),
                            ('b', tnn.Tanh())), (2, 3)),
]


@pytest.mark.parametrize('case', LAYERS, ids=[c[0] for c in LAYERS])
def test_layer_matches_jax(case):
    """Each layer with the JAX layer's weights (and buffers): the same
    `state_dict` keys and shapes, the same forward, in training mode for
    the norms (BatchNorm's running statistics compared after it too)."""
    _, make_j, make_t, shape = case
    jl, tl = _layer_pair(make_j(), make_t())
    assert {k: v.shape for k, v in _state(jl).items()} == {
        k: tuple(v.shape) for k, v in tl.state_dict().items()}
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32)
    _close(tl(torch.from_numpy(x)).detach().numpy(),
           jl(paddle.to_tensor(x)).numpy())
    for k, v in _state(jl).items():
        _close(tl.state_dict()[k].numpy(), v)


def test_containers_register_like_jax():
    with ptt.device_guard('cpu'):
        ll = tnn.LayerList([tnn.Linear(2, 2), tnn.Linear(2, 3)])
        ll.append(tnn.Linear(3, 1))
        ld = tnn.LayerDict({'x': tnn.Linear(2, 2)})
        ld['y'] = tnn.ReLU()
        pl = tnn.ParameterList([ll[0].weight, ll[1].bias])
    jll = jnn.LayerList([jnn.Linear(2, 2), jnn.Linear(2, 3)])
    jll.append(jnn.Linear(3, 1))
    assert sorted(ll.state_dict()) == sorted(jll.state_dict())
    assert len(ll) == 3 and isinstance(ll[-1], tnn.Linear)
    assert list(ld.keys()) == ['x', 'y'] and 'y' in ld
    assert len(pl) == 2 and sorted(dict(pl.named_parameters())) == ['0',
                                                                     '1']


def test_batchnorm_buffers_cross_by_name_and_train_like_jax():
    """`from_jax_state` carries BatchNorm's `_mean` and `_variance`; two
    training forwards move them as the JAX layer does."""
    jl = jnn.BatchNorm1D(3, momentum=0.7)
    rng = np.random.default_rng(4)
    st = _state(jl)
    st['_mean'], st['_variance'] = _x(rng, 3), _pos(rng, 3)
    jl.set_state_dict({k: paddle.to_tensor(v) for k, v in st.items()})
    tl = from_jax_state(st, tnn.BatchNorm1D(3, momentum=0.7, **CPU))
    assert {'_mean', '_variance'} <= set(tl.state_dict())
    for _ in range(2):
        x = _x(rng, 8, 3)
        _close(tl(torch.from_numpy(x)).detach().numpy(),
               jl(paddle.to_tensor(x)).numpy())
    _close(tl._mean.numpy(), np.asarray(jl._mean.numpy()))
    _close(tl._variance.numpy(), np.asarray(jl._variance.numpy()))


LOSSES = [
    ('CrossEntropyLoss', {}, lambda r: [_x(r, 5, 4), _ints(r, 4, 5)]),
    ('MSELoss', {}, lambda r: [_x(r, 3, 2), _x(r, 3, 2)]),
    ('L1Loss', {'reduction': 'sum'}, lambda r: [_x(r, 3, 2), _x(r, 3, 2)]),
    ('BCELoss', {}, lambda r: [_pos(r, 3, 2), _pos(r, 3, 2)]),
    ('BCEWithLogitsLoss', {}, lambda r: [_x(r, 3, 2), _pos(r, 3, 2)]),
    ('NLLLoss', {}, lambda r: [_x(r, 5, 4), _ints(r, 4, 5)]),
    ('KLDivLoss', {}, lambda r: [_x(r, 3, 2), _pos(r, 3, 2)]),
    ('SmoothL1Loss', {}, lambda r: [_x(r, 3, 2), _x(r, 3, 2)]),
    ('MarginRankingLoss', {}, lambda r: [_x(r, 4), _x(r, 4),
                                         np.sign(_x(r, 4))]),
    ('HingeEmbeddingLoss', {}, lambda r: [_x(r, 4),
                                          np.array([1, -1, 1, -1.0],
                                                   np.float32)]),
    ('SoftMarginLoss', {}, lambda r: [_x(r, 4), np.sign(_x(r, 4))]),
    ('MultiLabelSoftMarginLoss', {}, lambda r: [_x(r, 3, 2),
                                                _pos(r, 3, 2)]),
    ('TripletMarginLoss', {}, lambda r: [_x(r, 3, 4), _x(r, 3, 4),
                                         _x(r, 3, 4)]),
    ('PoissonNLLLoss', {}, lambda r: [_x(r, 3, 2), _pos(r, 3, 2)]),
    ('GaussianNLLLoss', {}, lambda r: [_x(r, 3, 2), _x(r, 3, 2),
                                       _pos(r, 3, 2)]),
    ('CTCLoss', {}, lambda r: [_x(r, 5, 2, 4), np.array([[1, 2], [3, 3]]),
                               np.array([5, 4]), np.array([2, 2])]),
    ('CosineEmbeddingLoss', {}, lambda r: [_x(r, 3, 4), _x(r, 3, 4),
                                           np.array([1, -1, 1])]),
    ('MultiMarginLoss', {}, lambda r: [_x(r, 3, 4), _ints(r, 4, 3)]),
]


@pytest.mark.parametrize('case', LOSSES, ids=[c[0] for c in LOSSES])
def test_loss_layer_matches_jax(case):
    name, kw, make = case
    arrays = make(np.random.default_rng(len(name)))
    want = getattr(jnn, name)(**kw)(*[paddle.to_tensor(a) for a in arrays])
    got = getattr(tnn, name)(**kw)(*[torch.from_numpy(a) for a in arrays])
    _close(got.numpy(), want.numpy())


@pytest.mark.parametrize('name', ['HSigmoidLoss',
                                  'AdaptiveLogSoftmaxWithLoss'])
def test_loss_layers_with_parameters_match_jax(name):
    rng = np.random.default_rng(7)
    if name == 'HSigmoidLoss':
        jl, tl = jnn.HSigmoidLoss(4, 6), tnn.HSigmoidLoss(4, 6, **CPU)
        args = [_x(rng, 3, 4), _ints(rng, 6, 3)]
    else:
        jl = jnn.AdaptiveLogSoftmaxWithLoss(4, 8, [3, 6])
        tl = tnn.AdaptiveLogSoftmaxWithLoss(4, 8, [3, 6], **CPU)
        args = [_x(rng, 5, 4), np.array([0, 2, 4, 6, 7])]
    from_jax_state(_state(jl), tl)
    want = _np_out(jl(*[paddle.to_tensor(a) for a in args]))
    got = _np_out(tl(*[torch.from_numpy(a) for a in args]))
    for g, w in zip(got if isinstance(got, list) else [got],
                    want if isinstance(want, list) else [want]):
        _close(g, w)
    if name == 'AdaptiveLogSoftmaxWithLoss':
        x = paddle.to_tensor(args[0])
        _close(tl.log_prob(torch.from_numpy(args[0])).detach().numpy(),
               jl.log_prob(x).numpy())
        assert tl.predict(torch.from_numpy(args[0])).tolist() == \
            np.asarray(jl.predict(x).numpy()).tolist()


# ---------------------------------------------------------------------------
# transformer layers
# ---------------------------------------------------------------------------

def _set_jax(jl, state):
    jl.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})


@pytest.mark.parametrize('normalize_before', [False, True])
def test_transformer_encoder_layer_forward_and_grads_match_jax(
        normalize_before):
    paddle.seed(5)
    jl = jnn.TransformerEncoderLayer(16, 4, 32, dropout=0.0,
                                     activation='gelu',
                                     normalize_before=normalize_before)
    tl = from_jax_state(_state(jl), tnn.TransformerEncoderLayer(
        16, 4, 32, dropout=0.0, activation='gelu',
        normalize_before=normalize_before, **CPU))
    rng = np.random.default_rng(1)
    x, mask = _x(rng, 2, 5, 16), _pos(rng, 2, 1, 5, 5) > 0.2
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_()
    jy = jl(jx, src_mask=paddle.to_tensor(mask))
    ty = tl(tx, src_mask=torch.from_numpy(mask))
    _close(ty.detach().numpy(), jy.numpy())
    cot = _x(rng, 2, 5, 16)
    (jy * paddle.to_tensor(cot)).sum().backward()
    (ty * torch.from_numpy(cot)).sum().backward()
    _close(tx.grad.numpy(), jx.grad.numpy(), rtol=1e-4, atol=1e-5)
    jgrads = dict(jl.named_parameters())
    for name, p in tl.named_parameters():
        _close(p.grad.numpy(), jgrads[name].grad.numpy(), rtol=1e-4,
               atol=1e-5)


def test_multi_head_attention_caches_match_jax():
    """Incremental `Cache` (concatenated keys) and the cross-attention
    `StaticCache`, as the JAX layer builds them."""
    paddle.seed(6)
    jl = jnn.MultiHeadAttention(16, 2)
    tl = from_jax_state(_state(jl), tnn.MultiHeadAttention(16, 2, **CPU))
    rng = np.random.default_rng(2)
    q, mem = _x(rng, 2, 3, 16), _x(rng, 2, 4, 16)
    jc = jl.gen_cache(paddle.to_tensor(q))
    tc = tl.gen_cache(torch.from_numpy(q))
    assert isinstance(tc, tnn.transformer.Cache) and tc.k.shape[1] == 0
    for step in range(2):
        x = _x(rng, 2, 1, 16)
        jo, jc = jl(paddle.to_tensor(x), cache=jc)
        to, tc = tl(torch.from_numpy(x), cache=tc)
        _close(to.detach().numpy(), jo.numpy())
        assert tc.k.shape[1] == step + 1
    js = jl.gen_cache(paddle.to_tensor(mem), paddle.to_tensor(mem))
    ts = tl.gen_cache(torch.from_numpy(mem), torch.from_numpy(mem))
    assert isinstance(ts, tnn.transformer.StaticCache)
    _close(tl(torch.from_numpy(q), cache=ts).detach().numpy(),
           jl(paddle.to_tensor(q), cache=js).numpy())


def test_transformer_and_decoder_caches_match_jax():
    paddle.seed(7)
    jt = jnn.Transformer(16, 2, 2, 2, 32, dropout=0.0,
                         normalize_before=True)
    tt = from_jax_state(_state(jt), tnn.Transformer(
        16, 2, 2, 2, 32, dropout=0.0, normalize_before=True, **CPU))
    rng = np.random.default_rng(3)
    src, tgt = _x(rng, 2, 5, 16), _x(rng, 2, 4, 16)
    mask = np.asarray(jnn.Transformer.generate_square_subsequent_mask(
        4).numpy())
    tmask = tnn.Transformer.generate_square_subsequent_mask(4, device='cpu')
    _close(tmask.numpy(), mask)
    want = jt(paddle.to_tensor(src), paddle.to_tensor(tgt),
              tgt_mask=paddle.to_tensor(mask)).numpy()
    got = tt(torch.from_numpy(src), torch.from_numpy(tgt),
             tgt_mask=tmask).detach().numpy()
    _close(got, want)
    mem_j = jt.encoder(paddle.to_tensor(src))
    mem_t = tt.encoder(torch.from_numpy(src))
    jc, tc = jt.decoder.gen_cache(mem_j), tt.decoder.gen_cache(mem_t)
    for i in range(2):
        x = tgt[:, i:i + 1]
        jo, jc = jt.decoder(paddle.to_tensor(x), mem_j, cache=jc)
        to, tc = tt.decoder(torch.from_numpy(x), mem_t, cache=tc)
        _close(to.detach().numpy(), jo.numpy())


# ---------------------------------------------------------------------------
# initializers and randomness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('make', [
    lambda I: I.Constant(0.25), lambda I: I.Dirac(),
    lambda I: I.Assign(np.arange(24, dtype=np.float32).reshape(2, 3, 2, 2)),
    lambda I: I.Bilinear()], ids=['Constant', 'Dirac', 'Assign', 'Bilinear'])
def test_deterministic_initializers_equal_jax(make):
    shape = (2, 3, 2, 2)
    want = np.asarray(make(JI)(shape, 'float32'))
    got = make(TI)(shape, 'float32', device='cpu').numpy()
    np.testing.assert_array_equal(got, want)


def _draw(init, shape=(400, 300), seed=0):
    g = torch.Generator().manual_seed(seed)
    return init(shape, 'float32', device='cpu', generator=g).numpy()


@pytest.mark.parametrize('name,init,std,bound', [
    ('Normal', TI.Normal(0.5, 2.0), 2.0, None),
    ('TruncatedNormal', TI.TruncatedNormal(0.0, 2.0), 2.0 * 0.8796, 4.0),
    ('Uniform', TI.Uniform(-0.5, 1.5), 2.0 / math.sqrt(12), None),
    ('XavierNormal', TI.XavierNormal(), math.sqrt(2 / 700), None),
    ('XavierUniform', TI.XavierUniform(), math.sqrt(6 / 700) / math.sqrt(3),
     math.sqrt(6 / 700)),
    ('KaimingNormal', TI.KaimingNormal(), math.sqrt(2 / 400), None),
    ('KaimingUniform', TI.KaimingUniform(), math.sqrt(2 / 400), math.sqrt(
        6 / 400)),
])
def test_random_initializers_statistics_and_seed(name, init, std, bound):
    """The JAX initializers' distributions (their moments within 3% on
    120k draws, the bounds exact) from torch generators: one seed gives
    the same draws, another different ones."""
    a = _draw(init)
    assert abs(a.std() - std) < 0.03 * std
    if bound is not None:
        assert np.abs(a - (0.5 if name == 'Normal' else 0.0)).max() <= bound
    np.testing.assert_array_equal(a, _draw(init))
    assert not np.array_equal(a, _draw(init, seed=1))


def test_orthogonal_gain_and_calculate_gain():
    a = _draw(TI.Orthogonal(gain=2.0), shape=(6, 10))
    np.testing.assert_allclose(a @ a.T, 4.0 * np.eye(6), atol=1e-5)
    for nl in ('tanh', 'relu', 'leaky_relu', 'selu', 'linear'):
        assert TI.calculate_gain(nl) == JI.calculate_gain(nl)


def test_global_initializer_applies_to_new_layers():
    TI.set_global_initializer(TI.Constant(0.125), TI.Constant(2.0))
    try:
        lin = tnn.Linear(2, 3, **CPU)
        assert float(lin.weight[0, 0]) == 0.125 and float(lin.bias[0]) == 2
    finally:
        TI.set_global_initializer(None)
    assert float(tnn.Linear(2, 3, **CPU).bias.abs().sum()) == 0.0


def test_dropout_statistics_and_seed():
    """Keep rate 1 - p, kept values scaled by 1 / (1 - p) (or not, in
    the other mode), whole slices along `axis`; `paddle.seed` makes the
    masks repeat."""
    x = torch.ones(200, 300)
    ptt.seed(3)
    y = TF.dropout(x, p=0.3)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    ptt.seed(3)
    assert torch.equal(TF.dropout(x, p=0.3), y)
    z = TF.dropout(x, p=0.5, mode='downscale_in_infer')
    assert set(z.unique().tolist()) <= {0.0, 1.0}
    cols = TF.dropout(torch.ones(4, 500), p=0.5, axis=1)
    assert torch.equal(cols[0], cols[3])
    d2 = TF.dropout2d(torch.ones(2, 50, 3, 3), p=0.5)
    assert torch.equal(d2.amin(dim=(2, 3)), d2.amax(dim=(2, 3)))


def test_alpha_dropout_rrelu_and_gumbel_statistics():
    ptt.seed(4)
    x = torch.randn(400, 500)
    y = TF.alpha_dropout(x, p=0.2)
    assert abs(float(y.mean())) < 0.02 and abs(float(y.std()) - 1) < 0.02
    r = TF.rrelu(-torch.ones(100, 100), 0.1, 0.4)
    assert float(r.min()) >= -0.4 and float(r.max()) <= -0.1
    assert abs(float(r.mean()) + 0.25) < 0.01
    g = TF.gumbel_softmax(torch.zeros(2000, 4), temperature=0.5)
    torch.testing.assert_close(g.sum(-1), torch.ones(2000))
    assert (g.argmax(-1).bincount(minlength=4).float() / 2000 - 0.25).abs()\
        .max() < 0.04
    h = TF.gumbel_softmax(torch.zeros(3, 4), hard=True)
    assert torch.equal(h.sum(-1), torch.ones(3)) and set(
        h.unique().tolist()) == {0.0, 1.0}


# ---------------------------------------------------------------------------
# attention: the head_dim rule and the plain D = 64 kernels
# ---------------------------------------------------------------------------

def test_unmasked_attention_below_head_dim_64_takes_the_plain_version(
        monkeypatch):
    """The shape rule of `paddle_tpu/ops/pallas.py:95`: D < 64 never
    reaches the flash kernels, on any device; D = 64 and 128 do."""
    seen = []
    real = K.flash_attention
    monkeypatch.setattr(K, 'flash_attention',
                        lambda q, *a, **k: seen.append(q.shape[-1])
                        or real(q, *a, **k))
    for d in (16, 32, 63, 64, 128):
        q = torch.randn(1, 3, 2, d)
        TF.scaled_dot_product_attention(q, q, q, is_causal=True)
    assert seen == [64, 128]
    assert [K.flash_head_dim_ok(d) for d in (32, 64, 96, 128)] == \
        [False, True, True, True]
    assert K.HEAD_DIMS == (64, 128)


def _flash_case(seed, b=1, sq=128, sk=128, h=4, hkv=2, d=64):
    rng = np.random.default_rng(seed)
    return (_x(rng, b, sq, h, d), _x(rng, b, sk, hkv, d),
            _x(rng, b, sk, hkv, d), _x(rng, b, sq, h, d))


@pytest.mark.parametrize('causal', [False, True])
def test_flash_plain_d64_matches_pallas_interpret(causal):
    """[1, 128, 4 heads, 2 kv heads, 64], f32: the forward with its LSE,
    dq and dk/dv plain versions against the Pallas forward and backward
    kernels in interpret mode. Tolerance rtol 2e-4, atol 2e-5 (fp32 sums
    in another order)."""
    q, k, v, g = _flash_case(int(causal))
    rep = q.shape[2] // k.shape[2]
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = K.flash_attention_fwd(tq, tk, tv, causal=causal,
                                     return_lse=True)
    dq, dk, dv = K.flash_attention_bwd(tq, tk, tv, out, lse, tg,
                                       causal=causal)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    jout, jlse = pk.flash_attention_fwd(jq, jk, jv, causal=causal,
                                        interpret=True, return_lse=True)
    _close(out.numpy(), np.asarray(jout), 2e-4, 2e-5)
    _close(lse.numpy(), np.asarray(jlse)[..., 0], 2e-4, 2e-5)
    tr = lambda x: x.transpose(0, 2, 1, 3)
    jdq, jdk, jdv = pk.flash_attention_bwd(
        tr(jq), tr(jnp.repeat(jk, rep, axis=2)),
        tr(jnp.repeat(jv, rep, axis=2)), tr(jout), jlse, tr(jg),
        causal=causal, interpret=True)
    fold = lambda x: np.asarray(tr(x)).reshape(1, 128, 2, rep, 64).sum(3)
    _close(dq.numpy(), np.asarray(tr(jdq)), 2e-4, 2e-5)
    _close(dk.numpy(), fold(jdk), 2e-4, 2e-5)
    _close(dv.numpy(), fold(jdv), 2e-4, 2e-5)


@pytest.mark.parametrize('hkv', [4, 2])
def test_paged_plain_d64_matches_pallas_interpret(hkv):
    """The paged plain version at head_dim 64 against the Pallas paged
    kernel in interpret mode and its JAX reference (GQA groups 1 and 2,
    a length-1 slot, a full one). Tolerance rtol 2e-4, atol 2e-5."""
    rng = np.random.default_rng(hkv)
    n, h, ps, p, pages = 3, 4, 8, 4, 13
    q = _x(rng, n, h, 64)
    kp, vp = _x(rng, pages, ps, hkv, 64), _x(rng, pages, ps, hkv, 64)
    table = rng.integers(1, pages, (n, p)).astype(np.int32)
    lengths = np.array([1, 17, 32], np.int32)
    args = tuple(map(jnp.asarray, (q, kp, vp, table, lengths)))
    got = K.paged_attention(*map(torch.from_numpy,
                                 (q, kp, vp, table, lengths))).numpy()
    _close(got, np.asarray(pk.paged_attention(*args, interpret=True)),
           2e-4, 2e-5)
    _close(got, np.asarray(pk.paged_attention_reference(*args)), 2e-4,
           2e-5)


# ---------------------------------------------------------------------------
# paddle.grad(no_grad_vars=)
# ---------------------------------------------------------------------------

def test_grad_no_grad_vars_matches_jax():
    """y = x * w, z = sum(y * y + x * y): with `y` held constant dz/dx
    is y (through the `x * y` term alone), where the full gradient is
    3 y w; the two packages agree on both, with a list and with a single
    tensor for `no_grad_vars`."""
    rng = np.random.default_rng(8)
    xv, wv = _x(rng, 4), _x(rng, 4)
    res = {}
    with ptt.device_guard('cpu'):
        for lib, P in (('jax', paddle), ('torch', ptt)):
            x = P.to_tensor(xv, stop_gradient=False)
            w = P.to_tensor(wv, stop_gradient=False)
            y = x * w
            z = (y * y + x * y).sum()
            full = P.grad(z, [x, w], retain_graph=True)
            cut = P.grad(z, [x], retain_graph=True, no_grad_vars=[y])
            # the port also takes one tensor for no_grad_vars
            single = P.grad(z, x, retain_graph=True,
                            no_grad_vars=y if P is ptt else [y])
            res[lib] = [np.asarray(t.numpy())
                        for t in full + cut + [single]]
    for got, want in zip(res['torch'], res['jax']):
        _close(got, want)
    assert not np.allclose(res['torch'][0], res['torch'][2])


def test_bf16_layer_norm_follows_the_jax_order():
    """bf16 LayerNorm takes mean and variance in bf16, the JAX order
    (torch's fused op accumulates in fp32): against the JAX CPU result
    at most two bf16 ulps of the output's scale apart, on at most 5% of
    elements, rel_norm below
    2e-3 (measured 2.6% and 1.2e-3; the fused op differs on 53%, 4.3e-3:
    ROADMAP Queue 3)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 768)).astype(np.float32) * 3 + 1
    w = (1 + 0.1 * rng.standard_normal(768)).astype(np.float32)
    b = (0.1 * rng.standard_normal(768)).astype(np.float32)
    want = np.asarray(JF.layer_norm(
        *(paddle.to_tensor(a).astype('bfloat16') for a in (x,)), 768,
        paddle.to_tensor(w).astype('bfloat16'),
        paddle.to_tensor(b).astype('bfloat16')).astype('float32').numpy())
    got = TF.layer_norm(torch.from_numpy(x).bfloat16(), 768,
                        torch.from_numpy(w).bfloat16(),
                        torch.from_numpy(b).bfloat16()).float().numpy()
    diff = np.abs(got - want)
    # two bf16 ulps at the output's largest magnitude (measured 1.5)
    assert diff.max() <= 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 6)
    assert (diff > 0).mean() <= 0.05
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-3
