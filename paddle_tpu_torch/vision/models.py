"""paddle.vision.models (counterpart of `paddle_tpu/vision/models.py`):
LeNet, ResNet / ResNeXt / Wide-ResNet, VGG, MobileNetV2, and the
families of `zoo_extra` re-exported.

The same layers, names and `state_dict` keys as the JAX models (NCHW),
so weights copy across by name (`weights.from_jax_state`), BatchNorm's
`_mean` / `_variance` included. Every model class and constructor takes
`device=`: its layers are made there; without it they are made on the
current place, the card unless `set_device('cpu')` was called.
`pretrained=True` raises ValueError, as in the JAX package: no weights
are fetched.
"""
from __future__ import annotations

import contextlib
import functools
from typing import List

from .. import framework, nn


@contextlib.contextmanager
def _placed(device):
    """Make layers on `device` inside the block (None: the current
    place)."""
    if device is None:
        yield
        return
    dev = framework.resolve_device(device)
    with framework.device_guard(
            'cpu' if dev.type == 'cpu' else f'gpu:{dev.index or 0}'):
        yield


def placed(init):
    """A model's __init__ taking `device=`, its layers made there."""
    @functools.wraps(init)
    def wrapper(self, *args, device=None, **kwargs):
        with _placed(device):
            init(self, *args, **kwargs)
    return wrapper


# ---------------------------------------------------------------------------
# LeNet
# ---------------------------------------------------------------------------

class LeNet(nn.Layer):
    @placed
    def __init__(self, num_classes=10):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1), nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0), nn.ReLU(),
            nn.MaxPool2D(2, 2))
        self.fc = nn.Sequential(
            nn.Linear(400, 120), nn.Linear(120, 84),
            nn.Linear(84, num_classes))

    def forward(self, x):
        x = self.features(x)
        x = x.flatten(1)
        return self.fc(x)


# ---------------------------------------------------------------------------
# ResNet
# ---------------------------------------------------------------------------

class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride,
                               padding=1, bias_attr=False)
        self.bn1 = nn.BatchNorm2D(planes)
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1,
                               bias_attr=False)
        self.bn2 = nn.BatchNorm2D(planes)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False)
        self.bn1 = nn.BatchNorm2D(width)
        self.conv2 = nn.Conv2D(width, width, 3, stride=stride, padding=1,
                               groups=groups, bias_attr=False)
        self.bn2 = nn.BatchNorm2D(width)
        self.conv3 = nn.Conv2D(width, planes * 4, 1, bias_attr=False)
        self.bn3 = nn.BatchNorm2D(planes * 4)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Layer):
    @placed
    def __init__(self, block, depth_cfg: List[int], num_classes=1000,
                 with_pool=True, groups=1, width_per_group=64):
        super().__init__()
        self.inplanes = 64
        self.groups = groups
        self.base_width = width_per_group
        self.conv1 = nn.Conv2D(3, 64, 7, stride=2, padding=3,
                               bias_attr=False)
        self.bn1 = nn.BatchNorm2D(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, 2, padding=1)
        self.layer1 = self._make_layer(block, 64, depth_cfg[0])
        self.layer2 = self._make_layer(block, 128, depth_cfg[1], stride=2)
        self.layer3 = self._make_layer(block, 256, depth_cfg[2], stride=2)
        self.layer4 = self._make_layer(block, 512, depth_cfg[3], stride=2)
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        self.num_classes = num_classes
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes)

    def _make_layer(self, block, planes, n, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False),
                nn.BatchNorm2D(planes * block.expansion))
        extra = {} if block is BasicBlock else {
            'groups': self.groups, 'base_width': self.base_width}
        layers = [block(self.inplanes, planes, stride, downsample, **extra)]
        self.inplanes = planes * block.expansion
        for _ in range(1, n):
            layers.append(block(self.inplanes, planes, **extra))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


_RESNET_CFG = {
    18: (BasicBlock, [2, 2, 2, 2]),
    34: (BasicBlock, [3, 4, 6, 3]),
    50: (BottleneckBlock, [3, 4, 6, 3]),
    101: (BottleneckBlock, [3, 4, 23, 3]),
    152: (BottleneckBlock, [3, 8, 36, 3]),
}


def _resnet(depth, pretrained=False, **kwargs):
    if pretrained:
        raise ValueError('pretrained weights are unavailable offline; '
                         'load a local state_dict instead')
    block, cfg = _RESNET_CFG[depth]
    return ResNet(block, cfg, **kwargs)


def resnet18(pretrained=False, **kw):
    return _resnet(18, pretrained, **kw)


def resnet34(pretrained=False, **kw):
    return _resnet(34, pretrained, **kw)


def resnet50(pretrained=False, **kw):
    return _resnet(50, pretrained, **kw)


def resnet101(pretrained=False, **kw):
    return _resnet(101, pretrained, **kw)


def resnet152(pretrained=False, **kw):
    return _resnet(152, pretrained, **kw)


def resnext50_32x4d(pretrained=False, **kw):
    return _resnet(50, pretrained, groups=32, width_per_group=4, **kw)


def resnext50_64x4d(pretrained=False, **kw):
    return _resnet(50, pretrained, groups=64, width_per_group=4, **kw)


def resnext101_32x4d(pretrained=False, **kw):
    return _resnet(101, pretrained, groups=32, width_per_group=4, **kw)


def resnext101_64x4d(pretrained=False, **kw):
    return _resnet(101, pretrained, groups=64, width_per_group=4, **kw)


def resnext152_32x4d(pretrained=False, **kw):
    return _resnet(152, pretrained, groups=32, width_per_group=4, **kw)


def resnext152_64x4d(pretrained=False, **kw):
    return _resnet(152, pretrained, groups=64, width_per_group=4, **kw)


def wide_resnet50_2(pretrained=False, **kw):
    return _resnet(50, pretrained, width_per_group=128, **kw)


def wide_resnet101_2(pretrained=False, **kw):
    return _resnet(101, pretrained, width_per_group=128, **kw)


# ---------------------------------------------------------------------------
# VGG
# ---------------------------------------------------------------------------

_VGG16_CFG = [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M',
              512, 512, 512, 'M', 512, 512, 512, 'M']


class VGG(nn.Layer):
    @placed
    def __init__(self, features, num_classes=1000):
        super().__init__()
        self.features = features
        self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
            nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(),
            nn.Linear(4096, num_classes))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.classifier(x.flatten(1))


def _make_vgg_features(cfg, batch_norm=False):
    layers, c_in = [], 3
    for v in cfg:
        if v == 'M':
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(c_in, v, 3, padding=1))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v))
            layers.append(nn.ReLU())
            c_in = v
    return nn.Sequential(*layers)


def vgg16(pretrained=False, batch_norm=False, device=None, **kw):
    if pretrained:
        raise ValueError('pretrained weights are unavailable offline')
    with _placed(device):
        return VGG(_make_vgg_features(_VGG16_CFG, batch_norm), **kw)


# ---------------------------------------------------------------------------
# MobileNetV2
# ---------------------------------------------------------------------------

class _InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers += [nn.Conv2D(inp, hidden, 1, bias_attr=False),
                       nn.BatchNorm2D(hidden), nn.ReLU6()]
        layers += [
            nn.Conv2D(hidden, hidden, 3, stride=stride, padding=1,
                      groups=hidden, bias_attr=False),
            nn.BatchNorm2D(hidden), nn.ReLU6(),
            nn.Conv2D(hidden, oup, 1, bias_attr=False),
            nn.BatchNorm2D(oup)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    @placed
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        cfg = [
            # t, c, n, s
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        inp = int(32 * scale)
        features = [nn.Conv2D(3, inp, 3, stride=2, padding=1,
                              bias_attr=False),
                    nn.BatchNorm2D(inp), nn.ReLU6()]
        for t, c, n, s in cfg:
            oup = int(c * scale)
            for i in range(n):
                features.append(_InvertedResidual(
                    inp, oup, s if i == 0 else 1, t))
                inp = oup
        last = int(1280 * max(1.0, scale))
        features += [nn.Conv2D(inp, last, 1, bias_attr=False),
                     nn.BatchNorm2D(last), nn.ReLU6()]
        self.features = nn.Sequential(*features)
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(last, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kw):
    if pretrained:
        raise ValueError('pretrained weights are unavailable offline')
    return MobileNetV2(scale=scale, **kw)


# extended zoo families live in zoo_extra.py; re-exported here so
# `from paddle.vision.models import densenet121` works as upstream
from .zoo_extra import (  # noqa: E402,F401
    AlexNet, DenseNet, GoogLeNet, InceptionV3, MobileNetV1, MobileNetV3,
    ShuffleNetV2, SqueezeNet, alexnet, densenet121, densenet161,
    densenet169, densenet201, googlenet, inception_v3, mobilenet_v1,
    mobilenet_v3_large, mobilenet_v3_small, shufflenet_v2_x0_25,
    shufflenet_v2_x0_5, shufflenet_v2_x1_0, shufflenet_v2_x1_5,
    shufflenet_v2_x2_0, squeezenet1_0, squeezenet1_1)
