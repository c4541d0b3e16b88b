"""paddle.vision.image, a copy of `paddle_tpu/vision/image.py`:
image IO with a pluggable backend. Backends: 'pil' (decode via Pillow,
returned as HWC uint8 ndarray — this framework's transform currency)
and 'cv2' when OpenCV is importable."""
from __future__ import annotations

import numpy as np

_BACKEND = 'pil'


def set_image_backend(backend: str):
    global _BACKEND
    if backend not in ('pil', 'cv2'):
        raise ValueError(f"backend must be 'pil' or 'cv2', got {backend!r}")
    if backend == 'cv2':
        try:
            import cv2  # noqa: F401
        except ImportError as e:
            raise ImportError('cv2 backend requested but OpenCV is not '
                              'installed') from e
    _BACKEND = backend


def get_image_backend() -> str:
    return _BACKEND


def image_load(path, backend=None):
    """Load an image file as HWC uint8 (RGB for color images)."""
    backend = backend or _BACKEND
    if backend == 'cv2':
        import cv2
        # IMREAD_COLOR: always 3-channel 8-bit — same contract as pil
        # (alpha dropped, 16-bit downconverted)
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f'cv2 failed to read {path!r}')
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert('RGB') if im.mode not in ('L', 'RGB')
                          else im)
