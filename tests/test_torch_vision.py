"""The port's `vision` and `nn.utils` against the JAX package's, on the
CPU: one constructor of each model family (eval and train forward, the
JAX weights and BatchNorm buffers carried by `from_jax_state`), a
`Model` training step of a tiny ResNet (loss, updated parameters, BN
buffers), the detection ops, the transforms and the synthetic datasets
(the same arrays from the same seed), the refusals of `pretrained=True`
and `download=True`, weight / spectral normalization and parameter
vectors, and CE's plain version at a classifier's 1000 classes against
the JAX package's `_ce_xla`.

Tolerance: f32, a model's outputs by relative norm (|port - jax| /
|jax|) 1e-4, the ops rtol 1e-5 and atol 1e-5, unless a test says why.
Inputs are made from a seed with numpy and handed to both."""
import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.vision as jvision
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.vision as tvision
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.weights import from_jax_state

MODEL_TOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def _cpu_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ptt.set_device('cpu')
    yield
    ptt.set_device('gpu')
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.numpy())


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _no_dropout(model):
    for m in model.sublayers() if hasattr(model, 'sublayers') \
            else model.modules():
        if type(m).__name__ == 'Dropout':
            m.p = 0.0


# (constructor, input size, input channels): one of each family
ZOO = [('LeNet', 28, 1), ('resnet18', 32, 3), ('resnext50_32x4d', 32, 3),
       ('vgg16', 32, 3), ('mobilenet_v1', 32, 3), ('mobilenet_v2', 32, 3),
       ('mobilenet_v3_small', 32, 3), ('shufflenet_v2_x0_25', 32, 3),
       ('squeezenet1_1', 48, 3), ('densenet121', 32, 3),
       ('googlenet', 64, 3), ('inception_v3', 75, 3), ('alexnet', 64, 3)]
ZOO_BATCH = 16
# Train mode normalizes by the batch's statistics, var = E[x^2] - mean^2
# in both packages, over the batch alone on the 1 x 1 maps of the last
# stage. There the random-init features of different images agree to 3-4
# digits, and the cancellation amplifies f32 rounding: at a batch of 16
# inception_v3's logits part by 1.1e-3 and resnext50_32x4d's by 1.8e-4 by
# relative norm (at a batch of 2, by 0.3 and 0.54), where eval mode's part
# by 5e-7. The running statistics that train mode updates carry the same
# error: inception_v3's part by 1.2e-5 where they are ~0.02 (atol 1e-4).
TRAIN_MODEL_TOL = 2e-3


def _numpy_draws(monkeypatch):
    """`jax.random`'s uniform, normal and truncated normal drawn by numpy
    from a seed while a JAX model is built: the same distributions, with
    no XLA program compiled for each parameter's shape (which took most
    of a zoo model's build). The port takes the drawn weights as they
    are, so only their shapes and scale matter here."""
    import jax
    rng = np.random.default_rng(0)

    def draw(f):
        return lambda *a, **kw: jnp.asarray(f(*a, **kw).astype(np.float32))

    monkeypatch.setattr(jax.random, 'uniform', draw(
        lambda k, shape=(), dtype=None, minval=0.0, maxval=1.0:
        rng.uniform(float(minval), float(maxval), shape)))
    monkeypatch.setattr(jax.random, 'normal', draw(
        lambda k, shape=(), dtype=None: rng.standard_normal(shape)))
    monkeypatch.setattr(jax.random, 'truncated_normal', draw(
        lambda k, lower, upper, shape=(), dtype=None: np.clip(
            rng.standard_normal(shape), float(lower), float(upper))))


def _jax_forward(model, x):
    """The JAX model's forward as one `jax.jit` of the package's own
    `jit.functional_call` (what `to_static` compiles), in the model's
    current mode: (outputs, moved buffers written back into the model).
    One XLA program a mode in place of a compile for each op."""
    import jax
    from paddle_tpu.jit import functional_call, functional_state
    params, frozen, buffers = functional_state(model)
    out, new = jax.jit(lambda p, f, b, v: functional_call(
        model, p, f, b, (v,), {}))(params, frozen, buffers, jnp.asarray(x))
    bufs = dict(model.named_buffers())
    for name, value in new.items():
        bufs[name]._data = value
    return out


@pytest.mark.parametrize('case', ZOO, ids=[c[0] for c in ZOO])
def test_zoo_forward_matches_jax(case, monkeypatch):
    """Eval forward (running BN statistics) within 1e-4 and train forward
    (batch statistics, dropout at 0 in both) within TRAIN_MODEL_TOL of
    each family at 10 classes, by relative norm, a batch of ZOO_BATCH,
    with the JAX weights: the same `state_dict` keys, every output, and
    the BN running statistics moved alike. The JAX forward runs jitted
    (`_jax_forward`), its weights drawn by numpy (`_numpy_draws`)."""
    name, size, ch = case
    paddle.seed(1)
    kw = {} if name == 'LeNet' else {'num_classes': 10}
    with monkeypatch.context() as m:
        _numpy_draws(m)
        jm = getattr(jvision, name)(**kw)
    tm = getattr(tvision, name)(**kw)
    assert sorted(tm.state_dict()) == sorted(jm.state_dict())
    from_jax_state(_state(jm), tm)
    x = np.random.default_rng(len(name)).standard_normal(
        (ZOO_BATCH, ch, size, size)).astype(np.float32)
    for train in (False, True):
        jm.train() if train else jm.eval()
        tm.train(train)
        if train:
            _no_dropout(jm)
            _no_dropout(tm)
        jo, to = _jax_forward(jm, x), tm(torch.from_numpy(x))
        jo = tuple(jo) if isinstance(jo, (tuple, list)) else (jo,)
        to = to if isinstance(to, tuple) else (to,)
        assert len(to) == len(jo)
        for got, want in zip(to, jo):
            assert tuple(got.shape) == tuple(want.shape)
            assert _rel(_np(got), np.asarray(want)) <= (
                TRAIN_MODEL_TOL if train else MODEL_TOL)
    js, ts = _state(jm), {k: v.numpy() for k, v in tm.state_dict().items()}
    for k in js:
        if k.endswith(('_mean', '_variance')):
            _close(ts[k], js[k], rtol=1e-3, atol=1e-4)


def test_models_take_a_device_and_refuse_pretrained():
    """`device=` places every layer (buffers too); `pretrained=True`
    raises the JAX package's ValueError in every constructor."""
    m = tvision.mobilenet_v2(num_classes=4, device='cpu')
    assert {t.device.type for t in m.state_dict().values()} == {'cpu'}
    for name in ('resnet50', 'vgg16', 'mobilenet_v2', 'alexnet',
                 'densenet121', 'googlenet', 'inception_v3', 'mobilenet_v1',
                 'mobilenet_v3_large', 'shufflenet_v2_x1_0',
                 'squeezenet1_0', 'wide_resnet50_2', 'resnext101_64x4d'):
        with pytest.raises(ValueError) as jerr:
            getattr(jvision, name)(pretrained=True)
        with pytest.raises(ValueError) as terr:
            getattr(tvision, name)(pretrained=True)
        assert str(terr.value) == str(jerr.value)


def test_exports_match_jax():
    names = {n for n in dir(jvision) if not n.startswith('_')}
    assert names - {n for n in dir(tvision)} == set()
    jops = {n for n in jvision.ops.__all__}
    assert jops - set(tvision.ops.__all__) == set()


def test_tiny_resnet_model_step_matches_jax(monkeypatch):
    """One `Model.train_batch` step of a 4-block ResNet (Momentum 0.9,
    weight decay 1e-4, lr 0.05, batch 8 at 64 x 64, BN in train mode) in
    both packages, and in the port in float64, from the same weights: the
    loss within 1e-5 (relative) and the BN running statistics (rtol 1e-5,
    atol 1e-6) of JAX's; every parameter within 1e-5 of the port's float64
    step (relative norm), and within 5e-3 of JAX's. The JAX step's own f32
    error sets that limit: from these weights (drawn by numpy,
    `_numpy_draws`) it lies 2.4e-3 from the float64 step on `bn1.bias`
    (2.7e-3 at most) and 1.2e-4 on `conv1.weight`, where the port's lies
    1.8e-6 and 3.5e-7 (the BN gradients alone agree to 5e-7,
    `test_batch_norm_training_gradients_match_jax`)."""
    paddle.seed(2)
    with monkeypatch.context() as m:
        _numpy_draws(m)
        jnet = jvision.ResNet(jvision.models.BasicBlock, [1, 1, 1, 1],
                              num_classes=10)
    tnet = tvision.ResNet(tvision.models.BasicBlock, [1, 1, 1, 1],
                          num_classes=10)
    from_jax_state(_state(jnet), tnet)
    exact = copy.deepcopy(tnet).double()
    models = []
    for lib, net in ((paddle, jnet), (ptt, tnet), (ptt, exact)):
        m = lib.Model(net)
        m.prepare(lib.optimizer.Momentum(
            learning_rate=0.05, momentum=0.9, parameters=net.parameters(),
            weight_decay=1e-4), (jnn if lib is paddle
                                 else tnn).CrossEntropyLoss())
        models.append(m)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 3, 64, 64)).astype(np.float32)
    y = rng.integers(0, 10, (8, 1)).astype(np.int64)
    jl = models[0].train_batch([paddle.to_tensor(x)], paddle.to_tensor(y))
    tl = models[1].train_batch([torch.from_numpy(x)], torch.from_numpy(y))
    models[2].train_batch([torch.from_numpy(x).double()],
                          torch.from_numpy(y))
    assert abs(tl[0] - float(np.asarray(jl[0]))) <= 1e-5 * abs(tl[0])
    js = _state(jnet)
    ts = {k: v.detach().numpy() for k, v in tnet.state_dict().items()}
    es = {k: v.detach().numpy() for k, v in exact.state_dict().items()}
    for k, want in js.items():
        if k.endswith(('_mean', '_variance')):
            _close(ts[k], want, rtol=1e-5, atol=1e-6)
        else:
            assert _rel(ts[k], es[k]) <= 1e-5, k
            assert _rel(ts[k], want) <= 5e-3, k


def test_batch_norm_training_gradients_match_jax():
    """Train-mode BatchNorm's gradients (x, weight, bias) of sum(out *
    cot) against the JAX function's (rtol 1e-4, atol 1e-5)."""
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((8, 6, 5, 5)) + 5).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    jt = [paddle.to_tensor(a, stop_gradient=False) for a in (x, w, b)]
    tt = [torch.from_numpy(a.copy()).requires_grad_() for a in (x, w, b)]
    jo = JF.batch_norm(jt[0], paddle.to_tensor(np.zeros(6, np.float32)),
                       paddle.to_tensor(np.ones(6, np.float32)), jt[1],
                       jt[2], training=True)
    to = tnn.functional.batch_norm(tt[0], torch.zeros(6), torch.ones(6),
                                   tt[1], tt[2], training=True)
    (jo * paddle.to_tensor(cot)).sum().backward()
    (to * torch.from_numpy(cot)).sum().backward()
    for a, b_ in zip(tt, jt):
        _close(a.grad.numpy(), _np(b_.grad), rtol=1e-4)


# ---------------------------------------------------------------------------
# vision.ops
# ---------------------------------------------------------------------------

def _boxes(rng, n, span=60.0):
    xy = rng.uniform(0, span, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(2, span / 3, (n, 2))],
                          1).astype(np.float32)


def test_box_iou_and_nms_match_jax():
    rng = np.random.default_rng(4)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    _close(_np(tvision.ops.box_iou(torch.from_numpy(a), torch.from_numpy(b))),
           _np(jvision.ops.box_iou(paddle.to_tensor(a), paddle.to_tensor(b))))
    boxes = _boxes(rng, 120)
    scores = rng.uniform(0, 1, 120).astype(np.float32)
    scores[5] = scores[6]                       # a tie: kept by index
    cats = rng.integers(0, 4, 120)
    for kw in ({}, {'score_threshold': 0.4}, {'top_k': 9},
               {'category_idxs': cats, 'score_threshold': 0.2}):
        want = jvision.ops.nms(
            paddle.to_tensor(boxes), paddle.to_tensor(scores), 0.4,
            **{k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()})
        got = tvision.ops.nms(
            torch.from_numpy(boxes), torch.from_numpy(scores), 0.4,
            **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()})
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize('kw', [{'sampling_ratio': 2}, {'aligned': False},
                                {'sampling_ratio': 3,
                                 'spatial_scale': 0.5}])
def test_roi_align_and_pool_match_jax(kw):
    """RoIAlign's bilinear samples (corners clamped into the map) and
    RoIPool's max over 8 x 8 rounded cells, two images, boxes crossing
    the border."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 12, 10)).astype(np.float32)
    rois = _boxes(rng, 6, span=14.0)
    num = np.array([2, 4], np.int32)
    j = [paddle.to_tensor(a) for a in (x, rois, num)]
    t = [torch.from_numpy(a) for a in (x, rois, num)]
    _close(_np(tvision.ops.roi_align(*t, 3, **kw)),
           _np(jvision.ops.roi_align(*j, 3, **kw)))
    scale = kw.get('spatial_scale', 1.0)
    _close(_np(tvision.ops.roi_pool(*t, (2, 3), spatial_scale=scale)),
           _np(jvision.ops.roi_pool(*j, (2, 3), spatial_scale=scale)))


@pytest.mark.parametrize('with_mask', [False, True])
def test_deform_conv2d_matches_jax(with_mask):
    """Offsets past the map's edge, stride 2, dilation 2, a mask (v2) and
    a bias; gradients of x, offset and weight (rtol 1e-4, atol 1e-5)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 9, 8)).astype(np.float32)
    w = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    off = (2 * rng.standard_normal((2, 18, 4, 3))).astype(np.float32)
    mask = rng.uniform(0, 1, (2, 9, 4, 3)).astype(np.float32)
    kw = dict(stride=2, padding=1, dilation=2)
    jt = [paddle.to_tensor(a, stop_gradient=False) for a in (x, off, w)]
    tt = [torch.from_numpy(a).requires_grad_() for a in (x, off, w)]
    jo = jvision.ops.deform_conv2d(
        *jt, paddle.to_tensor(bias),
        mask=paddle.to_tensor(mask) if with_mask else None, **kw)
    to = tvision.ops.deform_conv2d(
        *tt, torch.from_numpy(bias),
        mask=torch.from_numpy(mask) if with_mask else None, **kw)
    _close(_np(to), _np(jo))
    jo.sum().backward()
    to.sum().backward()
    for a, b in zip(tt, jt):
        _close(a.grad.numpy(), _np(b.grad), rtol=1e-4)
    with pytest.raises(NotImplementedError):
        tvision.ops.deform_conv2d(*tt, groups=2)
    layer = tvision.ops.DeformConv2D(3, 4, 3, padding=1)
    assert tuple(layer.weight.shape) == (4, 3, 3, 3)


def test_box_coder_matches_jax():
    rng = np.random.default_rng(7)
    prior, target = _boxes(rng, 6), _boxes(rng, 6)
    var = rng.uniform(0.1, 0.3, (6, 4)).astype(np.float32)
    for code in ('encode_center_size', 'decode_center_size'):
        for norm in (True, False):
            args = (prior, var, target if code.startswith('encode')
                    else rng.standard_normal((6, 4)).astype(np.float32))
            _close(_np(tvision.ops.box_coder(*map(torch.from_numpy, args),
                                             code, norm)),
                   _np(jvision.ops.box_coder(*map(paddle.to_tensor, args),
                                             code, norm)), rtol=1e-5)


# ---------------------------------------------------------------------------
# transforms, datasets, image
# ---------------------------------------------------------------------------

def _pipelines(T):
    return [
        T.Compose([T.Resize((20, 24)), T.CenterCrop(16), T.ToTensor(),
                   T.Normalize([0.5, 0.4, 0.3], [0.2, 0.3, 0.4])]),
        T.Compose([T.RandomResizedCrop(12), T.RandomHorizontalFlip(0.7),
                   T.RandomVerticalFlip(0.7), T.ColorJitter(0.3, 0.3, 0.3,
                                                            0.1)]),
        T.Compose([T.Pad(3, padding_mode='reflect'), T.RandomCrop(18),
                   T.RandomRotation(30), T.Grayscale(3)]),
        T.Compose([T.RandomAffine(15, translate=(0.1, 0.1),
                                  scale=(0.9, 1.1), shear=5),
                   T.RandomPerspective(prob=1.0), T.Transpose(),
                   T.RandomErasing(prob=1.0)]),
        T.Compose([T.BrightnessTransform(0.4), T.ContrastTransform(0.4),
                   T.SaturationTransform(0.4), T.HueTransform(0.2)]),
    ]


def test_transforms_give_the_jax_arrays():
    """Every transform (the random ones after the same numpy seed) and
    the functional forms give the same arrays as the JAX package's."""
    img = np.random.default_rng(8).integers(0, 256, (22, 26, 3)).astype(
        np.uint8)
    jT, tT = jvision.transforms, tvision.transforms
    for i, (jp, tp) in enumerate(zip(_pipelines(jT), _pipelines(tT))):
        np.random.seed(100 + i)
        want = jp(img.copy())
        np.random.seed(100 + i)
        got = tp(img.copy())
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for fn, args in (('hflip', ()), ('vflip', ()), ('to_grayscale', (3,)),
                     ('rotate', (20,)), ('pad', (2,)),
                     ('crop', (2, 3, 10, 12)),
                     ('adjust_brightness', (1.3,)),
                     ('adjust_contrast', (0.7,)), ('adjust_hue', (0.1,)),
                     ('resize', ((9, 11),)), ('center_crop', (10,))):
        np.testing.assert_array_equal(
            np.asarray(getattr(tT, fn)(img.copy(), *args)),
            np.asarray(getattr(jT, fn)(img.copy(), *args)))


def test_datasets_synthetic_arrays_and_refusals(tmp_path):
    """`backend='synthetic'` MNIST / Cifar10 / Cifar100 give the JAX
    package's arrays from the same seed, through a transform too;
    `download=True` raises its RuntimeError; DatasetFolder / ImageFolder
    list and load a folder of images alike."""
    jD, tD = jvision.datasets, tvision.datasets
    for name in ('MNIST', 'Cifar10', 'Cifar100'):
        for mode in ('train', 'test'):
            jd = getattr(jD, name)(mode=mode, backend='synthetic',
                                   transform=jvision.transforms.ToTensor())
            td = getattr(tD, name)(mode=mode, backend='synthetic',
                                   transform=tvision.transforms.ToTensor())
            assert len(td) == len(jd)
            for i in (0, len(jd) - 1):
                np.testing.assert_array_equal(td[i][0], jd[i][0])
                assert td[i][1] == jd[i][1]
        with pytest.raises(RuntimeError) as jerr:
            getattr(jD, name)(download=True)
        with pytest.raises(RuntimeError) as terr:
            getattr(tD, name)(download=True)
        assert str(terr.value) == str(jerr.value)
    from PIL import Image
    rng = np.random.default_rng(9)
    for cls in ('cat', 'dog'):
        os.makedirs(tmp_path / cls)
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (6, 5, 3)).astype(
                np.uint8)).save(tmp_path / cls / f'{i}.png')
    for name in ('DatasetFolder', 'ImageFolder'):
        jd, td = getattr(jD, name)(str(tmp_path)), \
            getattr(tD, name)(str(tmp_path))
        assert len(td) == len(jd) == 4
        np.testing.assert_array_equal(np.asarray(td[3][0]),
                                      np.asarray(jd[3][0]))
    assert tD.DatasetFolder(str(tmp_path)).class_to_idx == {'cat': 0,
                                                            'dog': 1}
    assert tvision.get_image_backend() == jvision.get_image_backend()


# ---------------------------------------------------------------------------
# nn.utils
# ---------------------------------------------------------------------------

def test_weight_norm_matches_jax():
    """g and v as parameters (keys and shapes), the same forward and the
    same gradients to g and v; `remove_weight_norm` restores the weight."""
    paddle.seed(4)
    jl, tl = jnn.Conv2D(3, 4, 3), tnn.Conv2D(3, 4, 3)
    from_jax_state(_state(jl), tl)
    jnn.utils.weight_norm(jl, dim=0)
    tnn.utils.weight_norm(tl, dim=0)
    js, ts = _state(jl), {k: v.detach().numpy()
                          for k, v in tl.state_dict().items()}
    assert {k: v.shape for k, v in ts.items()} == \
        {k: v.shape for k, v in js.items()}
    for k in js:
        _close(ts[k], js[k])
    x = np.random.default_rng(10).standard_normal((2, 3, 6, 6)).astype(
        np.float32)
    jo, to = jl(paddle.to_tensor(x)), tl(torch.from_numpy(x))
    _close(_np(to), _np(jo))
    jo.sum().backward()
    to.sum().backward()
    for p in ('weight_g', 'weight_v'):
        _close(getattr(tl, p).grad.numpy(), _np(getattr(jl, p).grad),
               rtol=1e-4)
    jnn.utils.remove_weight_norm(jl)
    tnn.utils.remove_weight_norm(tl)
    assert 'weight_g' not in tl.state_dict()
    _close(tl.weight.detach().numpy(), _np(jl.weight))
    with pytest.raises(ValueError):
        tnn.utils.remove_weight_norm(tl)


def test_spectral_norm_matches_jax_from_the_same_u():
    """The power iteration's u and v come from the port's generator; with
    the JAX buffers copied across, the normalized weight, the buffers
    after two calls and the SpectralNorm layer agree."""
    paddle.seed(5)
    jl, tl = jnn.Linear(6, 5), tnn.Linear(6, 5)
    from_jax_state(_state(jl), tl)
    jnn.utils.spectral_norm(jl, n_power_iterations=2)
    tnn.utils.spectral_norm(tl, n_power_iterations=2,
                            generator=torch.Generator().manual_seed(0))
    assert set(tl.state_dict()) == set(jl.state_dict())
    from_jax_state(_state(jl), tl)
    x = np.random.default_rng(11).standard_normal((3, 6)).astype(np.float32)
    for _ in range(2):
        _close(_np(tl(torch.from_numpy(x))), _np(jl(paddle.to_tensor(x))))
    for k in ('weight_u', 'weight_v'):
        _close(tl.state_dict()[k].numpy(), _state(jl)[k])
    w = np.random.default_rng(12).standard_normal((4, 3, 2)).astype(
        np.float32)
    jsn = jnn.SpectralNorm((4, 3, 2), dim=1, power_iters=3)
    tsn = tnn.SpectralNorm((4, 3, 2), dim=1, power_iters=3)
    from_jax_state(_state(jsn), tsn)
    _close(_np(tsn(torch.from_numpy(w))), _np(jsn(paddle.to_tensor(w))))


def test_parameters_vector_roundtrip_like_jax():
    paddle.seed(6)
    jl, tl = jnn.Linear(3, 2), tnn.Linear(3, 2)
    from_jax_state(_state(jl), tl)
    jv = jnn.utils.parameters_to_vector(jl.parameters())
    tv = tnn.utils.parameters_to_vector(list(tl.parameters()))
    _close(_np(tv), _np(jv))
    new = np.arange(8, dtype=np.float32)
    jnn.utils.vector_to_parameters(paddle.to_tensor(new), jl.parameters())
    tnn.utils.vector_to_parameters(torch.from_numpy(new), tl.parameters())
    for k, v in _state(jl).items():
        _close(tl.state_dict()[k].numpy(), v)


# ---------------------------------------------------------------------------
# CE at a classifier's width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n', [64, 256])
def test_ce_plain_at_1000_classes_matches_ce_xla(n):
    """The CE kernels' plain version (nll and lse, then dlogits) at [N,
    1000] with ignored rows against the JAX package's `_ce_xla` and its
    gradient (rtol 1e-5, atol 1e-6)."""
    import jax
    rng = np.random.default_rng(n)
    x = (3 * rng.standard_normal((n, 1000))).astype(np.float32)
    lab = rng.integers(0, 1000, n).astype(np.int32)
    valid = np.ones(n, bool)
    valid[::7] = False
    safe = np.where(valid, lab, 0).astype(np.int32)
    nll, lse = K.softmax_cross_entropy_fwd_reference(
        torch.from_numpy(x), torch.from_numpy(safe))
    want = np.asarray(JF._ce_xla(jnp.asarray(x), jnp.asarray(safe),
                                 jnp.asarray(valid)))
    _close(np.where(valid, nll.numpy(), 0.0), want, rtol=1e-5, atol=1e-6)
    g = np.where(valid, rng.standard_normal(n), 0.0).astype(np.float32)
    dx = K.softmax_cross_entropy_bwd_reference(
        torch.from_numpy(x), torch.from_numpy(safe), lse,
        torch.from_numpy(g))
    _, vjp = jax.vjp(lambda v: JF._ce_xla(v, jnp.asarray(safe),
                                          jnp.asarray(valid)),
                     jnp.asarray(x))
    _close(dx.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), rtol=1e-5,
           atol=1e-6)
