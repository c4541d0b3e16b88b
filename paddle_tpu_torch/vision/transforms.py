"""paddle.vision.transforms, a copy of `paddle_tpu/vision/transforms.py`
(host code: the port keeps its own copy and imports nothing of the JAX
package).

Numpy-based: transforms run in DataLoader workers on the host; only the
final batch reaches the device. Images are HWC uint8/float arrays; ToTensor converts to CHW
float32 in [0, 1].
"""
from __future__ import annotations

import numbers
from typing import List, Sequence, Tuple, Union

import numpy as np

from ..tensor import Tensor


def _is_chw(img):
    """Heuristic for channel-first layout (what ToTensor emits): a
    leading 1/3/4-channel dim with a non-channel-sized trailing dim."""
    return (img.ndim == 3 and img.shape[0] in (1, 3, 4)
            and img.shape[2] not in (1, 3, 4))


def _as_hwc(img):
    img = img.numpy() if isinstance(img, Tensor) else np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)

    def _apply_image(self, img):
        raise NotImplementedError


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class ToTensor(BaseTransform):
    def __init__(self, data_format='CHW'):
        self.data_format = data_format

    def _apply_image(self, img):
        img = _as_hwc(img)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        else:
            img = img.astype(np.float32)
        if self.data_format == 'CHW':
            img = np.transpose(img, (2, 0, 1))
        return img


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format='CHW', to_rgb=False):
        self.mean = np.asarray(
            [mean] if isinstance(mean, numbers.Number) else mean,
            np.float32)
        self.std = np.asarray(
            [std] if isinstance(std, numbers.Number) else std, np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        img = np.asarray(img, np.float32)
        if self.data_format == 'CHW':
            shape = (-1, 1, 1)
        else:
            shape = (1, 1, -1)
        return (img - self.mean.reshape(shape)) / self.std.reshape(shape)


class Resize(BaseTransform):
    """Nearest/bilinear resize on HWC arrays (pure numpy)."""

    def __init__(self, size, interpolation='bilinear'):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.interpolation = interpolation

    def _apply_image(self, img):
        img = _as_hwc(img)
        h, w = img.shape[:2]
        th, tw = self.size
        if (h, w) == (th, tw):
            return img
        if self.interpolation == 'nearest':
            ri = (np.arange(th) * h / th).astype(int).clip(0, h - 1)
            ci = (np.arange(tw) * w / tw).astype(int).clip(0, w - 1)
            return img[ri][:, ci]
        # bilinear
        ys = (np.arange(th) + 0.5) * h / th - 0.5
        xs = (np.arange(tw) + 0.5) * w / tw - 0.5
        y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
        y1 = np.clip(y0 + 1, 0, h - 1)
        x1 = np.clip(x0 + 1, 0, w - 1)
        wy = np.clip(ys - y0, 0, 1)[:, None, None]
        wx = np.clip(xs - x0, 0, 1)[None, :, None]
        f = img.astype(np.float32)
        out = ((f[y0][:, x0] * (1 - wy) + f[y1][:, x0] * wy) * (1 - wx)
               + (f[y0][:, x1] * (1 - wy) + f[y1][:, x1] * wy) * wx)
        return out.astype(img.dtype) if img.dtype == np.uint8 \
            else out


class CenterCrop(BaseTransform):
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        img = _as_hwc(img)
        h, w = img.shape[:2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return img[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=0, pad_if_needed=False):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding
        self.pad_if_needed = pad_if_needed

    def _apply_image(self, img):
        img = _as_hwc(img)
        if self.padding:
            p = self.padding
            img = np.pad(img, ((p, p), (p, p), (0, 0)))
        h, w = img.shape[:2]
        th, tw = self.size
        if self.pad_if_needed and (h < th or w < tw):
            ph, pw = max(th - h, 0), max(tw - w, 0)
            img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
            h, w = img.shape[:2]
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return img[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        img = _as_hwc(img)
        if np.random.rand() < self.prob:
            return img[:, ::-1].copy()
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        img = _as_hwc(img)
        if np.random.rand() < self.prob:
            return img[::-1].copy()
        return img


def to_tensor(img, data_format='CHW'):
    return ToTensor(data_format)(img)


def normalize(img, mean, std, data_format='CHW'):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation='bilinear'):
    return Resize(size, interpolation)(img)


def hflip(img):
    return _as_hwc(img)[:, ::-1].copy()


def center_crop(img, output_size):
    return CenterCrop(output_size)(img)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode='constant'):
        if isinstance(padding, numbers.Number):
            padding = (padding,) * 4
        elif len(padding) == 2:
            padding = (padding[0], padding[1], padding[0], padding[1])
        self.padding = tuple(padding)  # left, top, right, bottom
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        img = _as_hwc(img)
        l, t, r, b = self.padding
        spec = ((t, b), (l, r), (0, 0))
        if self.padding_mode == 'constant':
            return np.pad(img, spec, constant_values=self.fill)
        return np.pad(img, spec, mode=self.padding_mode)


class ColorJitter(BaseTransform):
    """Random brightness/contrast/saturation/hue on HWC images (each
    factor sampled like upstream: U[max(0,1-f), 1+f]; hue in [-h, h])."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    @staticmethod
    def _factor(f):
        # upstream accepts float f -> U[max(0,1-f), 1+f], or an explicit
        # (min, max) range
        if isinstance(f, (tuple, list)):
            return np.random.uniform(f[0], f[1])
        return np.random.uniform(max(0.0, 1 - f), 1 + f)

    def _apply_image(self, img):
        img = _as_hwc(img)
        was_u8 = img.dtype == np.uint8
        f = img.astype(np.float32) / (255.0 if was_u8 else 1.0)
        if self.brightness:
            f = f * self._factor(self.brightness)
        if self.contrast:
            mean = f.mean()
            f = (f - mean) * self._factor(self.contrast) + mean
        if self.saturation:
            grey = f.mean(axis=2, keepdims=True)
            f = (f - grey) * self._factor(self.saturation) + grey
        if self.hue and f.shape[2] == 3:
            # cheap hue rotation: roll channels by a blended amount
            h = self.hue if isinstance(self.hue, (tuple, list)) \
                else (-self.hue, self.hue)
            theta = np.random.uniform(h[0], h[1]) * 2 * np.pi
            cos_t, sin_t = np.cos(theta), np.sin(theta)
            one3 = 1.0 / 3.0
            sq3 = np.sqrt(1.0 / 3.0)
            m = (cos_t * np.eye(3)
                 + (1 - cos_t) * np.full((3, 3), one3)
                 + sin_t * sq3 * np.array([[0, -1, 1],
                                           [1, 0, -1],
                                           [-1, 1, 0]], np.float32))
            f = f @ m.T.astype(np.float32)
        f = np.clip(f, 0, 1)
        return (f * 255).astype(np.uint8) if was_u8 else f


class RandomRotation(BaseTransform):
    """Rotate by a random angle in [-degrees, degrees] (bilinear, same
    output size, zero fill) — pure numpy inverse-mapping."""

    def __init__(self, degrees, interpolation='bilinear', fill=0):
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = tuple(degrees)
        self.fill = fill

    def _apply_image(self, img):
        img = _as_hwc(img)
        angle = np.deg2rad(np.random.uniform(*self.degrees))
        h, w = img.shape[:2]
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        cos_a, sin_a = np.cos(angle), np.sin(angle)
        # inverse rotation as a 3x3 (x, y, 1) map into _warp_inverse
        inv = np.array(
            [[cos_a, -sin_a, cx - cos_a * cx + sin_a * cy],
             [sin_a, cos_a, cy - sin_a * cx - cos_a * cy],
             [0.0, 0.0, 1.0]], np.float32)
        return _warp_inverse(img, inv, self.fill)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1):
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        img = _as_hwc(img)
        grey = img.astype(np.float32).mean(axis=2, keepdims=True)
        if self.num_output_channels == 3:
            grey = np.repeat(grey, 3, axis=2)
        return grey.astype(img.dtype) if img.dtype == np.uint8 else grey


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation='bilinear'):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        img = _as_hwc(img)
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(*np.log(self.ratio)))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                i = np.random.randint(0, h - ch + 1)
                j = np.random.randint(0, w - cw + 1)
                crop = img[i:i + ch, j:j + cw]
                return Resize(self.size, self.interpolation)(crop)
        return Resize(self.size, self.interpolation)(
            CenterCrop(min(h, w))(img))


def pad(img, padding, fill=0, padding_mode='constant'):
    return Pad(padding, fill, padding_mode)(img)


def rotate(img, angle, interpolation='bilinear', fill=0):
    t = RandomRotation((angle, angle), interpolation, fill)
    return t._apply_image(img)


def to_grayscale(img, num_output_channels=1):
    return Grayscale(num_output_channels)(img)


def vflip(img):
    return _as_hwc(img)[::-1].copy()


class Transpose(BaseTransform):
    """HWC ndarray -> CHW (upstream paddle.vision.transforms.Transpose;
    default order (2, 0, 1))."""

    def __init__(self, order=(2, 0, 1)):
        self.order = tuple(order)

    def _apply_image(self, img):
        return np.transpose(_as_hwc(img), self.order)


class BrightnessTransform(BaseTransform):
    """Single-factor brightness jitter (upstream transforms of the same
    name): value in [max(0,1-v), 1+v] like ColorJitter's one channel."""

    def __init__(self, value):
        self.value = value

    def _apply_image(self, img):
        return ColorJitter(brightness=self.value)._apply_image(img)


class ContrastTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def _apply_image(self, img):
        return ColorJitter(contrast=self.value)._apply_image(img)


class SaturationTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def _apply_image(self, img):
        return ColorJitter(saturation=self.value)._apply_image(img)


class HueTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def _apply_image(self, img):
        return ColorJitter(hue=self.value)._apply_image(img)


class RandomErasing(BaseTransform):
    """Erase a random rectangle (upstream RandomErasing / arXiv
    1708.04896): area ratio in `scale`, aspect in `ratio`, filled with
    `value` (or per-pixel noise when value='random')."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False):
        self.prob = prob
        self.scale, self.ratio = scale, ratio
        self.value = value
        self.inplace = inplace

    def _apply_image(self, img):
        img = np.asarray(img)
        chw = _is_chw(img)  # post-ToTensor layout: erase spatially
        if chw:
            img = np.transpose(img, (1, 2, 0))
        img = _as_hwc(img)
        if np.random.uniform() >= self.prob:
            return np.transpose(img, (2, 0, 1)) if chw else img
        h, w = img.shape[:2]
        area = h * w
        out = img if self.inplace else img.copy()
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(*np.log(self.ratio)))
            eh = int(round(np.sqrt(target * ar)))
            ew = int(round(np.sqrt(target / ar)))
            if eh < h and ew < w:
                i = np.random.randint(0, h - eh + 1)
                j = np.random.randint(0, w - ew + 1)
                if isinstance(self.value, str):  # 'random'
                    patch = np.random.uniform(
                        0, 255 if img.dtype == np.uint8 else 1.0,
                        (eh, ew) + img.shape[2:])
                    out[i:i + eh, j:j + ew] = patch.astype(img.dtype)
                else:
                    out[i:i + eh, j:j + ew] = self.value
                break
        return np.transpose(out, (2, 0, 1)) if chw else out


def _warp_inverse(img, inv3x3, fill=0):
    """Bilinear warp by an inverse 3x3 projective map (dest -> src),
    shared by RandomAffine / RandomPerspective."""
    img = _as_hwc(img)
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ones = np.ones_like(xx)
    src = inv3x3 @ np.stack([xx.ravel(), yy.ravel(), ones.ravel()])
    sx = (src[0] / np.maximum(np.abs(src[2]), 1e-9) * np.sign(src[2]))
    sy = (src[1] / np.maximum(np.abs(src[2]), 1e-9) * np.sign(src[2]))
    sx, sy = sx.reshape(h, w), sy.reshape(h, w)
    # epsilon tolerance: float32 homography math can put border pixels a
    # hair outside [0, size-1] and they must not drop to fill
    tol = 1e-3
    valid = (sy >= -tol) & (sy <= h - 1 + tol) \
        & (sx >= -tol) & (sx <= w - 1 + tol)
    sy = sy.clip(0, h - 1)
    sx = sx.clip(0, w - 1)
    y0 = np.floor(sy).astype(int)
    x0 = np.floor(sx).astype(int)
    wy = (sy - y0)[..., None]
    wx = (sx - x0)[..., None]
    y0c, x0c = y0.clip(0, h - 1), x0.clip(0, w - 1)
    y1c, x1c = (y0 + 1).clip(0, h - 1), (x0 + 1).clip(0, w - 1)
    f = img.astype(np.float32)
    out = ((f[y0c, x0c] * (1 - wy) + f[y1c, x0c] * wy) * (1 - wx)
           + (f[y0c, x1c] * (1 - wy) + f[y1c, x1c] * wy) * wx)
    out = np.where(valid[..., None], out, np.float32(fill))
    return out.astype(img.dtype) if img.dtype == np.uint8 else out


class RandomAffine(BaseTransform):
    """Random rotation + translation + scale + shear (upstream
    RandomAffine), realized as one inverse-mapped bilinear warp."""

    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation='bilinear', fill=0, center=None):
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = tuple(degrees)
        self.translate = translate
        self.scale_range = scale
        self.shear = shear
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        img = _as_hwc(img)
        h, w = img.shape[:2]
        angle = np.deg2rad(np.random.uniform(*self.degrees))
        tx = ty = 0.0
        if self.translate is not None:
            tx = np.random.uniform(-self.translate[0],
                                   self.translate[0]) * w
            ty = np.random.uniform(-self.translate[1],
                                   self.translate[1]) * h
        s = np.random.uniform(*self.scale_range) \
            if self.scale_range is not None else 1.0
        shx = shy = 0.0
        if self.shear is not None:
            sh = self.shear
            if isinstance(sh, numbers.Number):
                sh = (-sh, sh)
            shx = np.deg2rad(np.random.uniform(sh[0], sh[1]))
            if len(sh) == 4:
                shy = np.deg2rad(np.random.uniform(sh[2], sh[3]))
        cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if self.center is None \
            else (self.center[1], self.center[0])
        cos_a, sin_a = np.cos(angle), np.sin(angle)
        # forward: T(center) @ R @ Shear @ S @ T(-center) + t
        rs = np.array([[cos_a, -sin_a], [sin_a, cos_a]], np.float32) @ \
            np.array([[1, np.tan(shx)], [np.tan(shy), 1]], np.float32) * s
        fwd = np.eye(3, dtype=np.float32)
        fwd[:2, :2] = rs
        fwd[0, 2] = cx + tx - rs[0, 0] * cx - rs[0, 1] * cy
        fwd[1, 2] = cy + ty - rs[1, 0] * cx - rs[1, 1] * cy
        inv = np.linalg.inv(fwd)
        return _warp_inverse(img, inv.astype(np.float32), self.fill)


class RandomPerspective(BaseTransform):
    """Random 4-point perspective warp (upstream RandomPerspective)."""

    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation='bilinear', fill=0):
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.fill = fill

    @staticmethod
    def _solve_homography(src, dst):
        """3x3 H with H @ src_i ~ dst_i (both [4, 2], x-y order)."""
        a = []
        for (x, y), (u, v) in zip(src, dst):
            a.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
            a.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
        _, _, vt = np.linalg.svd(np.asarray(a, np.float64))
        hmat = vt[-1].reshape(3, 3)
        return (hmat / hmat[2, 2]).astype(np.float32)

    def _apply_image(self, img):
        img = _as_hwc(img)
        if np.random.uniform() >= self.prob:
            return img
        h, w = img.shape[:2]
        d = self.distortion_scale
        dx, dy = w * d / 2.0, h * d / 2.0
        corners = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1],
                            [0, h - 1]], np.float32)
        jitter = np.random.uniform(0, 1, (4, 2)).astype(np.float32) * \
            np.array([dx, dy], np.float32)
        signs = np.array([[1, 1], [-1, 1], [-1, -1], [1, -1]], np.float32)
        dst = corners + jitter * signs
        # inverse map: dest corners -> source corners
        inv = self._solve_homography(dst, corners)
        return _warp_inverse(img, inv, self.fill)


def crop(img, top, left, height, width):
    return _as_hwc(img)[top:top + height, left:left + width].copy()


def erase(img, i, j, h, w, v, inplace=False):
    img = np.asarray(img)
    if _is_chw(img):  # channel-first: erase the spatial rectangle
        out = img if inplace else img.copy()
        out[:, i:i + h, j:j + w] = v
        return out
    img = _as_hwc(img)
    out = img if inplace else img.copy()
    out[i:i + h, j:j + w] = v
    return out


def adjust_brightness(img, brightness_factor):
    return ColorJitter(
        brightness=(brightness_factor, brightness_factor))._apply_image(img)


def adjust_contrast(img, contrast_factor):
    return ColorJitter(
        contrast=(contrast_factor, contrast_factor))._apply_image(img)


def adjust_hue(img, hue_factor):
    return ColorJitter(hue=(hue_factor, hue_factor))._apply_image(img)
