"""The port's vision functional entries and their layers against the JAX
package's, on the CPU: convolutions (string and pair padding, groups,
dilation, NHWC, the transposes with output_padding), pooling (ceil_mode,
exclusive, the index mask and max_unpool2d, adaptive bins), padding,
unfold / fold, affine_grid / grid_sample, the layout shuffles and
interpolate in every mode, up and down. Forward, and the gradients of a
seeded cotangent through torch's autograd against `jax.grad` of the JAX
entry.

Tolerance: f32, rtol 1e-4 and atol 1e-5 (the two packages sum a
convolution or a resize in other orders), unless a test says why not.
Inputs are made from a seed with numpy and handed to both."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as tnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.weights import from_jax_state

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope='module')
def _cpu_one_thread():
    """Layers made on the CPU, torch on one thread beside JAX's pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ptt.set_device('cpu')
    yield
    ptt.set_device('gpu')
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(t) for t in x]
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.numpy())


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _u(rng, lo, hi, *shape):
    return rng.uniform(lo, hi, shape).astype(np.float32)


IMG = lambda r: [_x(r, 2, 3, 9, 8)]
CASES = [
    # convolutions: (id, entry, inputs, kwargs, inputs whose grad is held)
    ('conv1d', 'conv1d', lambda r: [_x(r, 2, 4, 9), _x(r, 6, 4, 3),
                                    _x(r, 6)],
     {'stride': 2, 'padding': 1}, (0, 1, 2)),
    ('conv1d_nlc_same', 'conv1d', lambda r: [_x(r, 2, 9, 4),
                                             _x(r, 6, 4, 3)],
     {'padding': 'SAME', 'data_format': 'NLC'}, (0, 1)),
    ('conv2d', 'conv2d', lambda r: [_x(r, 2, 3, 9, 8), _x(r, 4, 3, 3, 3),
                                    _x(r, 4)], {'padding': 1}, (0, 1, 2)),
    ('conv2d_same_stride2', 'conv2d', lambda r: [_x(r, 1, 3, 9, 8),
                                                 _x(r, 4, 3, 3, 3)],
     {'stride': 2, 'padding': 'SAME'}, (0, 1)),
    ('conv2d_same_even_k', 'conv2d', lambda r: [_x(r, 1, 3, 8, 7),
                                                _x(r, 4, 3, 4, 2)],
     {'stride': 3, 'padding': 'same'}, (0, 1)),
    ('conv2d_groups_dilation', 'conv2d',
     lambda r: [_x(r, 2, 4, 10, 10), _x(r, 6, 2, 3, 3), _x(r, 6)],
     {'groups': 2, 'dilation': 2, 'padding': [1, 2]}, (0, 1, 2)),
    ('conv2d_depthwise_pairs', 'conv2d',
     lambda r: [_x(r, 2, 4, 8, 8), _x(r, 4, 1, 3, 3)],
     {'groups': 4, 'padding': [1, 0, 2, 1], 'stride': 2}, (0, 1)),
    ('conv2d_nhwc_valid', 'conv2d', lambda r: [_x(r, 2, 8, 8, 3),
                                               _x(r, 4, 3, 3, 3)],
     {'data_format': 'NHWC', 'padding': 'VALID'}, (0, 1)),
    ('conv3d', 'conv3d', lambda r: [_x(r, 1, 2, 5, 6, 5),
                                    _x(r, 3, 2, 3, 3, 3), _x(r, 3)],
     {'padding': 1, 'stride': (1, 2, 1)}, (0, 1, 2)),
    ('conv1d_transpose', 'conv1d_transpose',
     lambda r: [_x(r, 2, 4, 5), _x(r, 4, 3, 3), _x(r, 3)],
     {'stride': 2, 'padding': 1, 'output_padding': 1}, (0, 1, 2)),
    ('conv2d_transpose', 'conv2d_transpose',
     lambda r: [_x(r, 2, 4, 5, 4), _x(r, 4, 3, 3, 3), _x(r, 3)],
     {'stride': 2, 'padding': 1, 'output_padding': 1}, (0, 1, 2)),
    ('conv2d_transpose_groups', 'conv2d_transpose',
     lambda r: [_x(r, 1, 4, 5, 5), _x(r, 4, 2, 3, 3)],
     {'groups': 2, 'dilation': 2, 'padding': [1, 0, 2, 1]}, (0, 1)),
    ('conv2d_transpose_opad_past_pad', 'conv2d_transpose',
     lambda r: [_x(r, 1, 2, 4, 3), _x(r, 2, 3, 2, 2), _x(r, 3)],
     {'stride': 3, 'output_padding': 2}, (0, 1, 2)),
    ('conv2d_transpose_nhwc', 'conv2d_transpose',
     lambda r: [_x(r, 1, 4, 5, 2), _x(r, 2, 3, 3, 3)],
     {'stride': 2, 'data_format': 'NHWC'}, (0, 1)),
    ('conv3d_transpose', 'conv3d_transpose',
     lambda r: [_x(r, 1, 2, 3, 4, 3), _x(r, 2, 2, 2, 2, 2)],
     {'stride': 2}, (0, 1)),
    # pooling
    ('max_pool1d', 'max_pool1d', lambda r: [_x(r, 2, 3, 9)],
     {'kernel_size': 3, 'stride': 2, 'padding': 1}, (0,)),
    ('max_pool2d_ceil', 'max_pool2d', IMG,
     {'kernel_size': 3, 'stride': 2, 'padding': 1, 'ceil_mode': True},
     (0,)),
    ('max_pool2d_k2', 'max_pool2d', lambda r: [_x(r, 2, 3, 8, 8)],
     {'kernel_size': 2}, (0,)),
    ('max_pool3d_ceil', 'max_pool3d', lambda r: [_x(r, 1, 2, 5, 6, 5)],
     {'kernel_size': 2, 'stride': 2, 'ceil_mode': True}, (0,)),
    ('avg_pool1d_exclusive', 'avg_pool1d', lambda r: [_x(r, 2, 3, 9)],
     {'kernel_size': 3, 'stride': 2, 'padding': 1}, (0,)),
    ('avg_pool1d_with_pad', 'avg_pool1d', lambda r: [_x(r, 2, 3, 9)],
     {'kernel_size': 3, 'stride': 2, 'padding': 1, 'exclusive': False},
     (0,)),
    ('avg_pool2d_exclusive_ceil', 'avg_pool2d', IMG,
     {'kernel_size': 3, 'stride': 2, 'padding': 1, 'ceil_mode': True},
     (0,)),
    ('avg_pool2d_with_pad_ceil', 'avg_pool2d', IMG,
     {'kernel_size': 3, 'stride': 2, 'padding': 1, 'ceil_mode': True,
      'exclusive': False}, (0,)),
    ('avg_pool2d_with_pad', 'avg_pool2d', IMG,
     {'kernel_size': 3, 'stride': 2, 'padding': 1, 'exclusive': False},
     (0,)),
    ('avg_pool3d', 'avg_pool3d', lambda r: [_x(r, 1, 2, 5, 6, 5)],
     {'kernel_size': 2, 'stride': 2, 'padding': 1}, (0,)),
    ('adaptive_avg_pool1d', 'adaptive_avg_pool1d',
     lambda r: [_x(r, 2, 3, 10)], {'output_size': 4}, (0,)),
    ('adaptive_avg_pool2d', 'adaptive_avg_pool2d',
     lambda r: [_x(r, 2, 3, 9, 7)], {'output_size': (4, 3)}, (0,)),
    ('adaptive_avg_pool3d', 'adaptive_avg_pool3d',
     lambda r: [_x(r, 1, 2, 5, 6, 7)], {'output_size': (2, 3, 4)}, (0,)),
    ('adaptive_max_pool1d', 'adaptive_max_pool1d',
     lambda r: [_x(r, 2, 3, 10)], {'output_size': 3}, (0,)),
    ('adaptive_max_pool2d', 'adaptive_max_pool2d',
     lambda r: [_x(r, 2, 3, 9, 7)], {'output_size': (4, 3)}, (0,)),
    ('max_pool2d_with_index', 'max_pool2d_with_index', IMG,
     {'kernel_size': 3, 'stride': 2, 'padding': 1, 'ceil_mode': True},
     (0,)),
    # padding
    ('pad_constant', 'pad', lambda r: [_x(r, 2, 3, 4, 5), [1, 2, 0, 1]],
     {'value': 0.5}, (0,)),
    ('pad_reflect', 'pad', lambda r: [_x(r, 2, 3, 4, 5), [2, 1, 1, 3]],
     {'mode': 'reflect'}, (0,)),
    ('pad_replicate', 'pad', lambda r: [_x(r, 2, 3, 4, 5), [1, 2, 3, 0]],
     {'mode': 'replicate'}, (0,)),
    ('pad_circular', 'pad', lambda r: [_x(r, 2, 3, 4, 5), [2, 2, 1, 1]],
     {'mode': 'circular'}, (0,)),
    ('pad_every_dim', 'pad', lambda r: [_x(r, 2, 3, 4), [0, 1, 1, 1, 2, 1]],
     {'mode': 'reflect'}, (0,)),
    ('zeropad2d', 'zeropad2d', lambda r: [_x(r, 2, 3, 4, 5), [1, 2, 0, 1]],
     {}, (0,)),
    ('zeropad2d_nhwc', 'zeropad2d', lambda r: [_x(r, 2, 4, 5, 3), 2],
     {'data_format': 'NHWC'}, (0,)),
    # patches, sampling, layout
    ('unfold', 'unfold', lambda r: [_x(r, 2, 3, 6, 5)],
     {'kernel_sizes': [2, 3], 'paddings': 1, 'dilations': [1, 2]}, (0,)),
    ('unfold_pairs', 'unfold', lambda r: [_x(r, 1, 2, 6, 6)],
     {'kernel_sizes': 3, 'strides': 2, 'paddings': [1, 0, 2, 1]}, (0,)),
    ('fold', 'fold', lambda r: [_x(r, 2, 12, 42)],
     {'output_sizes': (5, 6), 'kernel_sizes': 2, 'paddings': 1}, (0,)),
    ('affine_grid', 'affine_grid', lambda r: [_x(r, 2, 2, 3)],
     {'out_shape': [2, 3, 4, 5]}, (0,)),
    ('affine_grid_half_pixel', 'affine_grid', lambda r: [_x(r, 2, 2, 3)],
     {'out_shape': [2, 3, 4, 5], 'align_corners': False}, (0,)),
    ('grid_sample_zeros', 'grid_sample',
     lambda r: [_x(r, 2, 3, 5, 6), _u(r, -1.3, 1.3, 2, 4, 3, 2)], {},
     (0, 1)),
    ('grid_sample_border', 'grid_sample',
     lambda r: [_x(r, 2, 3, 5, 6), _u(r, -1.3, 1.3, 2, 4, 3, 2)],
     {'padding_mode': 'border', 'align_corners': False}, (0, 1)),
    ('grid_sample_reflection', 'grid_sample',
     lambda r: [_x(r, 2, 3, 5, 6), _u(r, -2.5, 2.5, 2, 4, 3, 2)],
     {'padding_mode': 'reflection'}, (0, 1)),
    ('grid_sample_reflection_half', 'grid_sample',
     lambda r: [_x(r, 2, 3, 5, 6), _u(r, -2.5, 2.5, 2, 4, 3, 2)],
     {'padding_mode': 'reflection', 'align_corners': False}, (0, 1)),
    ('grid_sample_nearest', 'grid_sample',
     lambda r: [_x(r, 2, 3, 5, 6), _u(r, -1.3, 1.3, 2, 4, 3, 2)],
     {'mode': 'nearest'}, (0,)),
    ('temporal_shift', 'temporal_shift', lambda r: [_x(r, 4, 8, 3, 3)],
     {'seg_num': 2}, (0,)),
    ('temporal_shift_nhwc', 'temporal_shift', lambda r: [_x(r, 6, 3, 3, 8)],
     {'seg_num': 3, 'shift_ratio': 0.125, 'data_format': 'NHWC'}, (0,)),
    ('pixel_shuffle', 'pixel_shuffle', lambda r: [_x(r, 2, 8, 3, 3)],
     {'upscale_factor': 2}, (0,)),
    ('pixel_unshuffle', 'pixel_unshuffle', lambda r: [_x(r, 2, 2, 6, 4)],
     {'downscale_factor': 2}, (0,)),
    ('channel_shuffle', 'channel_shuffle', lambda r: [_x(r, 2, 6, 3, 3)],
     {'groups': 3}, (0,)),
    ('channel_shuffle_nhwc', 'channel_shuffle',
     lambda r: [_x(r, 2, 3, 3, 6)], {'groups': 2, 'data_format': 'NHWC'},
     (0,)),
    # interpolate: jax.image.resize, up and down
    ('nearest_up', 'interpolate', lambda r: [_x(r, 2, 3, 4, 5)],
     {'size': (9, 7)}, (0,)),
    ('nearest_down', 'interpolate', lambda r: [_x(r, 2, 3, 7, 9)],
     {'size': (3, 2)}, (0,)),
    ('nearest_scale', 'interpolate', lambda r: [_x(r, 1, 2, 3, 5)],
     {'scale_factor': 2}, (0,)),
    ('bilinear_up', 'interpolate', lambda r: [_x(r, 2, 3, 4, 5)],
     {'size': (9, 7), 'mode': 'bilinear'}, (0,)),
    ('bilinear_down', 'interpolate', lambda r: [_x(r, 2, 3, 9, 11)],
     {'size': (4, 3), 'mode': 'bilinear'}, (0,)),
    ('bilinear_align_up', 'interpolate', lambda r: [_x(r, 2, 3, 4, 5)],
     {'size': (9, 7), 'mode': 'bilinear', 'align_corners': True}, (0,)),
    ('bilinear_align_down', 'interpolate', lambda r: [_x(r, 2, 3, 9, 11)],
     {'size': (4, 3), 'mode': 'bilinear', 'align_corners': True}, (0,)),
    ('bicubic_up', 'interpolate', lambda r: [_x(r, 2, 3, 4, 5)],
     {'size': (9, 7), 'mode': 'bicubic'}, (0,)),
    ('bicubic_down', 'interpolate', lambda r: [_x(r, 2, 3, 9, 11)],
     {'size': (4, 3), 'mode': 'bicubic'}, (0,)),
    ('bicubic_align', 'interpolate', lambda r: [_x(r, 2, 3, 4, 5)],
     {'size': (3, 8), 'mode': 'bicubic', 'align_corners': True}, (0,)),
    ('linear_1d_down', 'interpolate', lambda r: [_x(r, 2, 3, 11)],
     {'size': 4, 'mode': 'linear'}, (0,)),
    ('trilinear_up', 'interpolate', lambda r: [_x(r, 1, 2, 3, 4, 2)],
     {'scale_factor': 2, 'mode': 'trilinear'}, (0,)),
    ('upsample_bilinear_mixed', 'upsample', lambda r: [_x(r, 1, 2, 6, 3)],
     {'size': (3, 7), 'mode': 'bilinear'}, (0,)),
]


def _tensors(arrays, lib, grads):
    out = []
    for i, a in enumerate(arrays):
        if isinstance(a, np.ndarray):
            out.append(paddle.to_tensor(a, stop_gradient=i not in grads)
                       if lib == 'jax' else
                       torch.from_numpy(a.copy()).requires_grad_(i in grads))
        else:
            out.append(a)
    return out


def _loss(out, cot, lib):
    first = out[0] if isinstance(out, (tuple, list)) else out
    c = paddle.to_tensor(cot) if lib == 'jax' else torch.from_numpy(cot)
    return (first * c).sum()


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_vision_functional_matches_jax(case):
    """Forward of every vision entry, and the gradients of sum(out * cot)
    for the listed inputs, against the JAX entry (rtol 1e-4, atol 1e-5;
    gradients atol 1e-4: a resize or a pool's backward sums many
    contributions in another order)."""
    cid, name, make, kw, grads = case
    arrays = make(np.random.default_rng(len(cid)))
    jt = _tensors(arrays, 'jax', grads)
    tt = _tensors(arrays, 'torch', grads)
    jout = getattr(JF, name)(*jt, **kw)
    tout = getattr(TF, name)(*tt, **kw)
    jv, tv = _np(jout), _np(tout)
    for got, want in zip(tv if isinstance(tv, list) else [tv],
                         jv if isinstance(jv, list) else [jv]):
        assert np.shape(got) == np.shape(want)
        _close(got, want)
    first = jv[0] if isinstance(jv, list) else jv
    cot = np.random.default_rng(99).standard_normal(
        np.shape(first)).astype(np.float32)
    _loss(jout, cot, 'jax').backward()
    _loss(tout, cot, 'torch').backward()
    for i in grads:
        _close(tt[i].grad.numpy(), np.asarray(jt[i].grad.numpy()),
               rtol=1e-4, atol=1e-4)


def test_max_unpool2d_inverts_the_index_mask_like_jax():
    """`max_pool2d(return_mask=True)` gives the flat H * W index of each
    window's first maximum; `max_unpool2d` scatters the values back there
    (zeros elsewhere), with the default and an explicit output size."""
    x = np.random.default_rng(7).standard_normal((2, 3, 8, 6)).astype(
        np.float32)
    jo, jm = JF.max_pool2d(paddle.to_tensor(x), 2, return_mask=True)
    to, tm = TF.max_pool2d(torch.from_numpy(x), 2, return_mask=True)
    assert tm.dtype == torch.int32
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm.numpy()))
    for out_size in (None, [2, 3, 9, 7]):
        want = JF.max_unpool2d(jo, jm, 2, output_size=out_size).numpy()
        got = TF.max_unpool2d(to, tm, 2, output_size=out_size).numpy()
        np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(NotImplementedError):
        TF.max_unpool2d(to, tm, 2, data_format='NHWC')


def test_vision_entries_refuse_what_jax_refuses():
    """String padding in a pool, SAME padding in a transpose, an unknown
    grid_sample padding mode or interpolate mode raise ValueError in both
    packages."""
    x = np.zeros((1, 2, 4, 4), np.float32)
    w = np.zeros((2, 2, 3, 3), np.float32)
    for mod, t in ((JF, paddle.to_tensor), (TF, torch.from_numpy)):
        with pytest.raises(ValueError):
            mod.max_pool2d(t(x), 2, padding='SAME')
        with pytest.raises(ValueError):
            mod.conv2d_transpose(t(x), t(w), padding='SAME')
        with pytest.raises(ValueError):
            mod.grid_sample(t(x), t(np.zeros((1, 2, 2, 2), np.float32)),
                            padding_mode='wrap')
        with pytest.raises(ValueError):
            mod.interpolate(t(x), size=(2, 2), mode='area')


# ---------------------------------------------------------------------------
# layers, weights carried by from_jax_state
# ---------------------------------------------------------------------------

LAYERS = [
    ('Conv1D', (4, 6, 3), {'stride': 2, 'padding': 1}, (2, 4, 9)),
    ('Conv2D', (3, 4, 3), {'padding': 'SAME', 'groups': 1, 'dilation': 2},
     (2, 3, 9, 8)),
    ('Conv2D', (4, 4, 3), {'groups': 4, 'bias_attr': False, 'stride': 2},
     (2, 4, 9, 8)),
    ('Conv2D', (3, 4, (3, 1)), {'data_format': 'NHWC', 'padding': (1, 0)},
     (2, 7, 6, 3)),
    # padding_mode is kept and not read, in both packages: zeros
    ('Conv2D', (3, 4, 3), {'padding': 1, 'padding_mode': 'reflect'},
     (1, 3, 6, 5)),
    ('Conv3D', (2, 3, 2), {'stride': 2}, (1, 2, 5, 6, 5)),
    ('Conv1DTranspose', (4, 3, 3), {'stride': 2, 'output_padding': 1},
     (2, 4, 5)),
    ('Conv2DTranspose', (4, 6, 3), {'stride': 2, 'padding': 1,
                                    'groups': 2}, (2, 4, 5, 4)),
    ('Conv3DTranspose', (2, 2, 2), {'stride': 2}, (1, 2, 3, 3, 2)),
    ('MaxPool1D', (3,), {'stride': 2, 'padding': 1}, (2, 3, 9)),
    ('MaxPool2D', (3, 2, 1), {'ceil_mode': True}, (2, 3, 9, 8)),
    ('MaxPool3D', (2,), {}, (1, 2, 4, 6, 4)),
    ('AvgPool1D', (3, 2, 1), {}, (2, 3, 9)),
    ('AvgPool2D', (3, 2, 1), {'ceil_mode': True}, (2, 3, 9, 8)),
    ('AvgPool3D', (2, 2), {}, (1, 2, 4, 6, 4)),
    ('AdaptiveAvgPool1D', (4,), {}, (2, 3, 10)),
    ('AdaptiveAvgPool2D', ((3, 2),), {}, (2, 3, 9, 7)),
    ('AdaptiveAvgPool3D', ((2, 2, 3),), {}, (1, 2, 5, 6, 7)),
    ('AdaptiveMaxPool1D', (3,), {}, (2, 3, 10)),
    ('AdaptiveMaxPool2D', ((3, 2),), {}, (2, 3, 9, 7)),
    ('Upsample', (), {'scale_factor': 2, 'mode': 'bilinear'}, (1, 2, 3, 4)),
    ('UpsamplingBilinear2D', (), {'size': (5, 3)}, (1, 2, 3, 4)),
    ('UpsamplingNearest2D', (), {'scale_factor': 3}, (1, 2, 3, 4)),
    ('PixelShuffle', (2,), {}, (1, 8, 3, 2)),
    ('PixelUnshuffle', (2,), {}, (1, 2, 4, 6)),
    ('ChannelShuffle', (2,), {}, (1, 6, 3, 2)),
    ('Pad1D', (2,), {'mode': 'reflect'}, (2, 3, 5)),
    ('Pad2D', ([1, 0, 2, 1],), {'mode': 'replicate'}, (2, 3, 4, 5)),
    ('Pad3D', (1,), {'value': 0.25}, (1, 2, 3, 4, 5)),
    ('ZeroPad2D', ([1, 2, 0, 1],), {}, (2, 3, 4, 5)),
    ('Unfold', (2,), {'strides': 2}, (1, 2, 6, 6)),
    ('Fold', ((4, 4), 2), {'strides': 2}, (1, 8, 4)),
]


@pytest.mark.parametrize('case', LAYERS, ids=[f'{c[0]}-{i}' for i, c in
                                              enumerate(LAYERS)])
def test_vision_layer_matches_jax(case):
    """Each layer of the slice, built with the same arguments in both
    packages, the JAX layer's weights copied into the port's by name:
    equal `state_dict` keys and shapes, and equal outputs."""
    name, args, kw, shape = case
    jl = getattr(jnn, name)(*args, **kw)
    tl = getattr(tnn, name)(*args, **kw)
    jstate = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in jstate.items()} == \
        {k: tuple(v.shape) for k, v in tl.state_dict().items()}
    from_jax_state(jstate, tl)
    x = np.random.default_rng(len(name)).standard_normal(shape).astype(
        np.float32)
    _close(_np(tl(torch.from_numpy(x))), _np(jl(paddle.to_tensor(x))))


def test_max_unpool_layer_matches_jax():
    x = np.random.default_rng(8).standard_normal((1, 2, 6, 6)).astype(
        np.float32)
    jo, jm = jnn.MaxPool2D(2, return_mask=True)(paddle.to_tensor(x))
    to, tm = tnn.MaxPool2D(2, return_mask=True)(torch.from_numpy(x))
    want = jnn.MaxUnPool2D(2)(jo, jm).numpy()
    got = tnn.MaxUnPool2D(2)(to, tm).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize('cls,transpose', [('Conv2D', False),
                                           ('Conv2DTranspose', True)])
def test_conv_initializer_draws_like_jax(cls, transpose):
    """Kaiming-uniform weights (negative slope sqrt(5): bound
    sqrt(1 / fan_in), fan_in = in / groups x kernel) and a zero bias, in
    Paddle's layouts: the same shapes and bounds in both packages, the
    port's draws spread over the bound (std within 5% of bound / sqrt 3)."""
    ptt.seed(3)
    paddle.seed(3)
    tl = getattr(tnn, cls)(32, 64, 3, groups=2)
    jl = getattr(jnn, cls)(32, 64, 3, groups=2)
    tw, jw = tl.weight.detach().numpy(), np.asarray(jl.weight.numpy())
    assert tw.shape == jw.shape == ((32, 32, 3, 3) if transpose
                                    else (64, 16, 3, 3))
    bound = np.sqrt(1.0 / (16 * 9))
    for w in (tw, jw):
        assert np.abs(w).max() <= bound + 1e-7
        assert abs(w.std() / (bound / np.sqrt(3)) - 1) < 0.05
    assert not tl.bias.detach().numpy().any()
