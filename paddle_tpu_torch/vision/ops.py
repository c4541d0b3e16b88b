"""paddle.vision.ops (counterpart of `paddle_tpu/vision/ops.py`): box
IoU, NMS, RoIAlign, RoIPool, deformable convolution and the box coder,
as the JAX functions compute them.

`nms` computes the IoU matrix on the boxes' device and runs the
sequential suppression on the host over its rows (the kept list has a
size known only there), highest score first (a stable sort, ties by
index), per category when `category_idxs` is given (boxes shifted apart
by category), `score_threshold` and `top_k` applied after. `roi_align`,
`roi_pool` and `deform_conv2d` are gathers with the JAX bilinear rule:
corners clamped into the map, weights clamped to [0, 1]; RoIAlign
averages `sampling_ratio` (default 2) samples a side per bin, half-pixel
aligned when `aligned`; RoIPool takes the max over a fixed 8 x 8 grid of
rounded cells per bin. They compute in f32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..nn.layer import Layer
from ..tensor import Tensor, apply_op, to_torch

__all__ = ['nms', 'roi_align', 'roi_pool', 'deform_conv2d', 'box_iou',
           'box_coder', 'DeformConv2D']


def _iou_matrix(boxes):
    """[N, 4] xyxy -> [N, N] IoU."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    union = area[:, None] + area[None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def box_iou(boxes1, boxes2):
    """Pairwise IoU of two box sets ([N, 4] x [M, 4] -> [N, M])."""
    def f(a, b):
        return _iou_matrix(torch.cat([a, b], dim=0))[:a.shape[0],
                                                      a.shape[0]:]
    return apply_op(f, boxes1, boxes2, _name='box_iou')


def nms(boxes, scores=None, iou_threshold=0.3, score_threshold=None,
        category_idxs=None, categories=None, top_k=None):
    """Hard NMS; the kept indices (int32) by descending score."""
    wrap = any(isinstance(t, Tensor) for t in (boxes, scores, category_idxs))
    bv = to_torch(boxes).float()
    sv = to_torch(scores).float() if scores is not None \
        else torch.zeros(bv.shape[0], device=bv.device)
    valid = (sv >= score_threshold) if score_threshold is not None \
        else torch.ones(bv.shape[0], dtype=torch.bool, device=bv.device)
    if category_idxs is not None:
        cv = to_torch(category_idxs).to(bv.device)
        span = (bv.max() - bv.min()) + 1.0
        bv = bv + cv[:, None].float() * span
    order = torch.argsort(-sv, stable=True)
    over = (_iou_matrix(bv[order]) > iou_threshold).cpu().numpy()
    keep = np.ones(bv.shape[0], bool)
    for i in range(1, bv.shape[0]):
        keep[i] = not np.any(over[i, :i] & keep[:i])
    order_h = order.cpu().numpy()
    kept = order_h[keep & valid.cpu().numpy()[order_h]]
    if top_k is not None:
        kept = kept[:top_k]
    out = torch.as_tensor(kept.astype(np.int32), device=bv.device)
    return Tensor(out) if wrap else out


def _gather_bilinear(flat, img, y, x, height, width):
    """Bilinear samples of the maps flat [N * H * W, C] at (y, x) of
    image `img` (all of one shape S): [*S, C]."""
    y0 = torch.clamp(torch.floor(y), 0, height - 1)
    x0 = torch.clamp(torch.floor(x), 0, width - 1)
    y1 = torch.clamp(y0 + 1, 0, height - 1)
    x1 = torch.clamp(x0 + 1, 0, width - 1)
    wy = torch.clamp(y - y0, 0, 1).unsqueeze(-1)
    wx = torch.clamp(x - x0, 0, 1).unsqueeze(-1)
    base = img * (height * width)

    def at(yy, xx):
        return flat[(base + yy.long() * width + xx.long())]
    return (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1) * (1 - wy) * wx
            + at(y1, x0) * wy * (1 - wx) + at(y1, x1) * wy * wx)


def _roi_images(nper, count, device):
    return torch.repeat_interleave(
        torch.arange(nper.shape[0], device=device), nper.to(device).long(),
        output_size=count)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True):
    """RoIAlign: the mean of ratio x ratio bilinear samples per output
    bin -> [R, C, ph, pw]."""
    ph, pw = (output_size, output_size) if isinstance(output_size, int) \
        else output_size

    def f(xv, rois, nper):
        xv, rois = xv.float(), rois.float()
        n, c, h, w = xv.shape
        dev = xv.device
        img = _roi_images(nper, rois.shape[0], dev)
        off = 0.5 if aligned else 0.0
        ratio = sampling_ratio if sampling_ratio > 0 else 2
        x1, y1, x2, y2 = (rois * spatial_scale).unbind(-1)
        rw = torch.clamp(x2 - x1, min=1e-4)
        rh = torch.clamp(y2 - y1, min=1e-4)
        bin_h, bin_w = (rh / ph)[:, None, None, None, None], \
            (rw / pw)[:, None, None, None, None]
        iy = torch.arange(ph, device=dev)[None, :, None, None, None]
        ix = torch.arange(pw, device=dev)[None, None, :, None, None]
        sy = torch.arange(ratio, device=dev)[None, None, None, :, None]
        sx = torch.arange(ratio, device=dev)[None, None, None, None, :]
        yy = y1[:, None, None, None, None] - off \
            + (iy + (sy + 0.5) / ratio) * bin_h
        xx = x1[:, None, None, None, None] - off \
            + (ix + (sx + 0.5) / ratio) * bin_w
        yy, xx = torch.broadcast_tensors(yy, xx)
        flat = xv.permute(0, 2, 3, 1).reshape(n * h * w, c)
        samp = _gather_bilinear(flat, img[:, None, None, None, None], yy, xx,
                                h, w)              # [R, ph, pw, r, r, C]
        return samp.mean(dim=(3, 4)).permute(0, 3, 1, 2)
    return apply_op(f, x, boxes, boxes_num, _name='roi_align')


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0):
    """RoIPool: the max over a fixed 8 x 8 grid of rounded cells per bin
    (exact for bins up to 8 cells a side) -> [R, C, ph, pw]."""
    ph, pw = (output_size, output_size) if isinstance(output_size, int) \
        else output_size

    def f(xv, rois, nper):
        xv, rois = xv.float(), rois.float()
        n, c, h, w = xv.shape
        dev = xv.device
        img = _roi_images(nper, rois.shape[0], dev)
        ratio = 8
        x1, y1, x2, y2 = torch.round(rois * spatial_scale).unbind(-1)
        rw = torch.clamp(x2 - x1 + 1, min=1.0)[:, None, None, None, None]
        rh = torch.clamp(y2 - y1 + 1, min=1.0)[:, None, None, None, None]
        iy = torch.arange(ph, device=dev)[None, :, None, None, None]
        ix = torch.arange(pw, device=dev)[None, None, :, None, None]
        sy = torch.arange(ratio, device=dev)[None, None, None, :, None]
        sx = torch.arange(ratio, device=dev)[None, None, None, None, :]
        yy = torch.round(y1[:, None, None, None, None]
                         + (iy + sy / (ratio - 1)) * (rh / ph))
        xx = torch.round(x1[:, None, None, None, None]
                         + (ix + sx / (ratio - 1)) * (rw / pw))
        yy, xx = torch.broadcast_tensors(yy, xx)
        yi = torch.clamp(yy, 0, h - 1).long()
        xi = torch.clamp(xx, 0, w - 1).long()
        flat = xv.permute(0, 2, 3, 1).reshape(n * h * w, c)
        samp = flat[img[:, None, None, None, None] * (h * w) + yi * w + xi]
        return samp.amax(dim=(3, 4)).permute(0, 3, 1, 2)
    return apply_op(f, x, boxes, boxes_num, _name='roi_pool')


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None):
    """Deformable convolution v1 (v2 with `mask`): the input sampled
    bilinearly at the offset taps, then one product with the kernel."""
    if groups != 1 or deformable_groups != 1:
        raise NotImplementedError('deform_conv2d supports groups=1, '
                                  'deformable_groups=1')
    stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
    padding = (padding, padding) if isinstance(padding, int) \
        else tuple(padding)
    dilation = (dilation, dilation) if isinstance(dilation, int) \
        else tuple(dilation)
    has_mask, has_bias = mask is not None, bias is not None

    def f(xv, ov, wv, *rest):
        mv = rest[0] if has_mask else None
        bv = rest[1 if has_mask else 0] if has_bias else None
        xv = xv.float()
        n, c, _, _ = xv.shape
        out_c, _, kh, kw = wv.shape
        xp = torch.nn.functional.pad(xv, (padding[1], padding[1],
                                          padding[0], padding[0]))
        hp, wp = xp.shape[-2:]
        ho = (hp - (dilation[0] * (kh - 1) + 1)) // stride[0] + 1
        wo = (wp - (dilation[1] * (kw - 1) + 1)) // stride[1] + 1
        dev = xv.device
        oy = ov[:, 0::2].reshape(n, kh, kw, ho, wo)
        ox = ov[:, 1::2].reshape(n, kh, kw, ho, wo)
        base_y = (torch.arange(ho, device=dev) * stride[0])[None, None, :,
                                                            None] \
            + (torch.arange(kh, device=dev) * dilation[0])[:, None, None,
                                                           None]
        base_x = (torch.arange(wo, device=dev) * stride[1])[None, None,
                                                            None, :] \
            + (torch.arange(kw, device=dev) * dilation[1])[None, :, None,
                                                           None]
        yy = base_y + oy
        xx = base_x + ox
        flat = xp.permute(0, 2, 3, 1).reshape(n * hp * wp, c)
        img = torch.arange(n, device=dev)[:, None, None, None, None]
        cols = _gather_bilinear(flat, img, yy, xx, hp, wp)
        cols = cols.permute(0, 5, 1, 2, 3, 4)       # [N, C, kh, kw, Ho, Wo]
        if has_mask:
            cols = cols * mv.reshape(n, 1, kh, kw, ho, wo)
        cols = cols.reshape(n, c * kh * kw, ho * wo)
        out = torch.einsum('ok,nkp->nop', wv.reshape(out_c, -1).float(),
                           cols).reshape(n, out_c, ho, wo)
        if has_bias:
            out = out + bv.reshape(1, -1, 1, 1)
        return out

    args = [x, offset, weight]
    if mask is not None:
        args.append(mask)
    if bias is not None:
        args.append(bias)
    return apply_op(f, *args, _name='deform_conv2d')


def box_coder(prior_box, prior_box_var, target_box,
              code_type='encode_center_size', box_normalized=True):
    """Encode or decode boxes against priors (SSD's center-size code)."""
    def f(pb, pbv, tb):
        pb, pbv, tb = pb.float(), pbv.float(), tb.float()
        norm = 0.0 if box_normalized else 1.0
        pw = pb[:, 2] - pb[:, 0] + norm
        ph = pb[:, 3] - pb[:, 1] + norm
        pcx = pb[:, 0] + pw * 0.5
        pcy = pb[:, 1] + ph * 0.5
        if code_type == 'encode_center_size':
            tw = tb[:, 2] - tb[:, 0] + norm
            th = tb[:, 3] - tb[:, 1] + norm
            tcx = tb[:, 0] + tw * 0.5
            tcy = tb[:, 1] + th * 0.5
            return torch.stack([(tcx - pcx) / pw / pbv[:, 0],
                                (tcy - pcy) / ph / pbv[:, 1],
                                torch.log(tw / pw) / pbv[:, 2],
                                torch.log(th / ph) / pbv[:, 3]], dim=1)
        dcx = tb[:, 0] * pbv[:, 0] * pw + pcx
        dcy = tb[:, 1] * pbv[:, 1] * ph + pcy
        dw = torch.exp(tb[:, 2] * pbv[:, 2]) * pw
        dh = torch.exp(tb[:, 3] * pbv[:, 3]) * ph
        return torch.stack([dcx - dw * 0.5 + norm * 0.5,
                            dcy - dh * 0.5 + norm * 0.5,
                            dcx + dw * 0.5 - norm * 0.5,
                            dcy + dh * 0.5 - norm * 0.5], dim=1)
    return apply_op(f, prior_box, prior_box_var, target_box,
                    _name='box_coder')


class DeformConv2D(Layer):
    """Layer form of `deform_conv2d`: weight [out, in / groups, kh, kw]
    and a bias, Paddle's default initializers."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        ks = (kernel_size, kernel_size) if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.deformable_groups, self.groups = deformable_groups, groups
        init = dict(device=device, dtype=dtype, generator=generator)
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups) + ks, attr=weight_attr,
            **init)
        self.bias = self.create_parameter(
            (out_channels,), attr=bias_attr, is_bias=True, **init)

    def forward(self, x, offset, mask=None):
        return deform_conv2d(
            x, offset, self.weight, self.bias, stride=self.stride,
            padding=self.padding, dilation=self.dilation,
            deformable_groups=self.deformable_groups, groups=self.groups,
            mask=mask)
