"""paddle.vision.datasets, a copy of `paddle_tpu/vision/datasets.py` (host
code over the port's `io.Dataset`).

Offline build: `download=True` is rejected (zero egress). Each dataset
reads the standard on-disk format when a local copy exists, and exposes
`mode='synthetic'`-style fallback via `backend='synthetic'` — a
deterministic generated stand-in with the real shapes/dtypes so training
pipelines and tests run without the archives.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
from typing import Callable, Optional

import numpy as np

from ..io import Dataset


class _SyntheticImages(Dataset):
    def __init__(self, n, shape, num_classes, transform=None, seed=0):
        rng = np.random.RandomState(seed)
        self.labels = rng.randint(0, num_classes, n).astype(np.int64)
        # class-dependent mean so models can actually fit the data
        base = rng.rand(num_classes, *shape).astype(np.float32)
        noise = rng.rand(n, *shape).astype(np.float32) * 0.3
        self.images = (base[self.labels] * 0.7 + noise)
        self.images = (self.images * 255).astype(np.uint8)
        self.transform = transform

    def __getitem__(self, i):
        img = self.images[i]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[i]

    def __len__(self):
        return len(self.images)


def _reject_download(download):
    if download:
        raise RuntimeError(
            'downloads are disabled in this offline build; place the '
            'dataset files locally and pass image_path/data_file, or use '
            'backend="synthetic"')


class MNIST(Dataset):
    """MNIST idx-format reader with synthetic fallback."""

    def __init__(self, image_path=None, label_path=None, mode='train',
                 transform: Optional[Callable] = None, download=False,
                 backend=None):
        _reject_download(download)
        self.transform = transform
        if backend == 'synthetic' or image_path is None:
            n = 256 if mode == 'train' else 64
            self._syn = _SyntheticImages(n, (28, 28), 10, transform)
            self.images, self.labels = None, None
            return
        self._syn = None
        with gzip.open(image_path, 'rb') if image_path.endswith('.gz') \
                else open(image_path, 'rb') as f:
            magic, n, rows, cols = struct.unpack('>IIII', f.read(16))
            self.images = np.frombuffer(
                f.read(), np.uint8).reshape(n, rows, cols)
        with gzip.open(label_path, 'rb') if label_path.endswith('.gz') \
                else open(label_path, 'rb') as f:
            struct.unpack('>II', f.read(8))
            self.labels = np.frombuffer(f.read(), np.uint8) \
                .astype(np.int64)

    def __getitem__(self, i):
        if self._syn is not None:
            return self._syn[i]
        img = self.images[i]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[i]

    def __len__(self):
        return len(self._syn) if self._syn is not None else len(self.images)


class Cifar10(Dataset):
    """CIFAR-10 python-pickle format reader with synthetic fallback."""

    _num_classes = 10
    _label_key = b'labels'

    def _members(self, mode):
        return [f'data_batch_{i}' for i in range(1, 6)] \
            if mode == 'train' else ['test_batch']

    def __init__(self, data_file=None, mode='train',
                 transform: Optional[Callable] = None, download=False,
                 backend=None):
        _reject_download(download)
        self.transform = transform
        if backend == 'synthetic' or data_file is None:
            n = 256 if mode == 'train' else 64
            self._syn = _SyntheticImages(n, (32, 32, 3),
                                         self._num_classes, transform,
                                         seed=1)
            return
        self._syn = None
        images, labels = [], []
        names = self._members(mode)
        with tarfile.open(data_file) as tf:
            for member in tf.getmembers():
                if os.path.basename(member.name) in names:
                    d = pickle.load(tf.extractfile(member),
                                    encoding='bytes')
                    images.append(np.asarray(d[b'data']))
                    labels.extend(d[self._label_key])
        if not images:
            raise FileNotFoundError(
                f'no members {names} found in {data_file!r}')
        self.images = np.concatenate(images).reshape(-1, 3, 32, 32) \
            .transpose(0, 2, 3, 1)
        self.labels = np.asarray(labels, np.int64)

    def __getitem__(self, i):
        if self._syn is not None:
            return self._syn[i]
        img = self.images[i]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[i]

    def __len__(self):
        return len(self._syn) if self._syn is not None else len(self.images)


class Cifar100(Cifar10):
    """CIFAR-100: 'train'/'test' archive members, fine labels, 100
    classes."""

    _num_classes = 100
    _label_key = b'fine_labels'

    def _members(self, mode):
        return ['train'] if mode == 'train' else ['test']


IMG_EXTENSIONS = ('.jpg', '.jpeg', '.png', '.ppm', '.bmp', '.pgm',
                  '.tif', '.tiff', '.webp')


def _scan_files(root, extensions, is_valid_file):
    """Deterministic recursive file scan shared by DatasetFolder and
    ImageFolder; default filter = extension allowlist."""
    if is_valid_file is None:
        exts = tuple(e.lower() for e in (extensions or IMG_EXTENSIONS))

        def is_valid_file(p):
            return p.lower().endswith(exts)
    out = []
    for dirpath, _, files in sorted(os.walk(root)):
        for fn in sorted(files):
            p = os.path.join(dirpath, fn)
            if is_valid_file(p):
                out.append(p)
    return out


def _default_loader(path):
    from . import image as _image
    return _image.image_load(path)


class DatasetFolder(Dataset):
    """Generic folder-of-class-subdirs dataset (upstream
    paddle.vision.datasets.DatasetFolder): root/class_x/xxx.ext -> label
    by sorted class-dir order."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or _default_loader
        self.transform = transform
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise RuntimeError(f'no class folders under {root!r}')
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            for p in _scan_files(os.path.join(root, c), extensions,
                                 is_valid_file):
                self.samples.append((p, self.class_to_idx[c]))
        if not self.samples:
            raise RuntimeError(f'no valid files under {root!r}')

    def __getitem__(self, i):
        path, label = self.samples[i]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Flat (unlabeled) image folder (upstream
    paddle.vision.datasets.ImageFolder): returns [img] per sample."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or _default_loader
        self.transform = transform
        self.samples = _scan_files(root, extensions, is_valid_file)
        if not self.samples:
            raise RuntimeError(f'no valid files under {root!r}')

    def __getitem__(self, i):
        img = self.loader(self.samples[i])
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)
