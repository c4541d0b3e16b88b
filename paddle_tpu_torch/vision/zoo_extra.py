"""The rest of the vision zoo (counterpart of
`paddle_tpu/vision/zoo_extra.py`): AlexNet, SqueezeNet, DenseNet,
GoogLeNet (with its two auxiliary heads), InceptionV3, ShuffleNetV2,
MobileNetV1 and MobileNetV3, with the JAX layers and `state_dict` keys.
Every factory refuses `pretrained=True`; every model takes `device=`
(`models.placed`)."""
from __future__ import annotations

from typing import List

import torch

from .. import nn
from ..nn import functional as F
from .models import placed


def paddle_concat(xs, axis):
    return torch.cat(xs, dim=axis)


def _no_pretrained(pretrained):
    if pretrained:
        raise ValueError('pretrained weights are unavailable offline; '
                         'load a local state_dict instead')


def _conv_bn(in_c, out_c, k, stride=1, padding=0, groups=1, act='relu'):
    layers = [nn.Conv2D(in_c, out_c, k, stride=stride, padding=padding,
                        groups=groups, bias_attr=False),
              nn.BatchNorm2D(out_c)]
    if act == 'relu':
        layers.append(nn.ReLU())
    elif act == 'hardswish':
        layers.append(nn.Hardswish())
    return nn.Sequential(*layers)


# ---------------------------------------------------------------------------
# AlexNet
# ---------------------------------------------------------------------------

class AlexNet(nn.Layer):
    @placed
    def __init__(self, num_classes=1000, dropout=0.5):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, 2))
        self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
        self.classifier = nn.Sequential(
            nn.Dropout(dropout), nn.Linear(256 * 36, 4096), nn.ReLU(),
            nn.Dropout(dropout), nn.Linear(4096, 4096), nn.ReLU(),
            nn.Linear(4096, num_classes))

    def forward(self, x):
        return self.classifier(self.avgpool(self.features(x)).flatten(1))


def alexnet(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return AlexNet(**kw)


# ---------------------------------------------------------------------------
# SqueezeNet
# ---------------------------------------------------------------------------

class _Fire(nn.Layer):
    def __init__(self, in_c, squeeze, e1, e3):
        super().__init__()
        self.squeeze = nn.Sequential(nn.Conv2D(in_c, squeeze, 1), nn.ReLU())
        self.expand1 = nn.Sequential(nn.Conv2D(squeeze, e1, 1), nn.ReLU())
        self.expand3 = nn.Sequential(nn.Conv2D(squeeze, e3, 3, padding=1),
                                     nn.ReLU())

    def forward(self, x):
        s = self.squeeze(x)
        return paddle_concat([self.expand1(s), self.expand3(s)], axis=1)


class SqueezeNet(nn.Layer):
    @placed
    def __init__(self, version='1.0', num_classes=1000, dropout=0.5):
        super().__init__()
        if version == '1.0':
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, 2),
                _Fire(96, 16, 64, 64), _Fire(128, 16, 64, 64),
                _Fire(128, 32, 128, 128), nn.MaxPool2D(3, 2),
                _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
                _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256),
                nn.MaxPool2D(3, 2), _Fire(512, 64, 256, 256))
        else:  # 1.1: pools moved earlier, smaller stem
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, 2),
                _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64),
                nn.MaxPool2D(3, 2),
                _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128),
                nn.MaxPool2D(3, 2),
                _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
                _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256))
        self.classifier = nn.Sequential(
            nn.Dropout(dropout), nn.Conv2D(512, num_classes, 1), nn.ReLU(),
            nn.AdaptiveAvgPool2D((1, 1)))

    def forward(self, x):
        return self.classifier(self.features(x)).flatten(1)


def squeezenet1_0(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return SqueezeNet('1.0', **kw)


def squeezenet1_1(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return SqueezeNet('1.1', **kw)


# ---------------------------------------------------------------------------
# DenseNet
# ---------------------------------------------------------------------------

class _DenseLayer(nn.Layer):
    def __init__(self, in_c, growth, bn_size):
        super().__init__()
        self.norm1 = nn.BatchNorm2D(in_c)
        self.conv1 = nn.Conv2D(in_c, bn_size * growth, 1, bias_attr=False)
        self.norm2 = nn.BatchNorm2D(bn_size * growth)
        self.conv2 = nn.Conv2D(bn_size * growth, growth, 3, padding=1,
                               bias_attr=False)

    def forward(self, x):
        out = self.conv1(F.relu(self.norm1(x)))
        out = self.conv2(F.relu(self.norm2(out)))
        return paddle_concat([x, out], axis=1)


class _Transition(nn.Layer):
    def __init__(self, in_c, out_c):
        super().__init__()
        self.norm = nn.BatchNorm2D(in_c)
        self.conv = nn.Conv2D(in_c, out_c, 1, bias_attr=False)
        self.pool = nn.AvgPool2D(2, 2)

    def forward(self, x):
        return self.pool(self.conv(F.relu(self.norm(x))))


class DenseNet(nn.Layer):
    @placed
    def __init__(self, layers_cfg: List[int], growth=32, num_init=64,
                 bn_size=4, num_classes=1000):
        super().__init__()
        feats = [nn.Conv2D(3, num_init, 7, stride=2, padding=3,
                           bias_attr=False),
                 nn.BatchNorm2D(num_init), nn.ReLU(),
                 nn.MaxPool2D(3, 2, padding=1)]
        c = num_init
        for i, n in enumerate(layers_cfg):
            for _ in range(n):
                feats.append(_DenseLayer(c, growth, bn_size))
                c += growth
            if i != len(layers_cfg) - 1:
                feats.append(_Transition(c, c // 2))
                c //= 2
        feats += [nn.BatchNorm2D(c), nn.ReLU()]
        self.features = nn.Sequential(*feats)
        self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        self.classifier = nn.Linear(c, num_classes)

    def forward(self, x):
        return self.classifier(self.avgpool(self.features(x)).flatten(1))


_DENSENET_CFG = {121: ([6, 12, 24, 16], 32, 64),
                 161: ([6, 12, 36, 24], 48, 96),
                 169: ([6, 12, 32, 32], 32, 64),
                 201: ([6, 12, 48, 32], 32, 64)}


def _densenet(depth, pretrained, **kw):
    _no_pretrained(pretrained)
    cfg, growth, init = _DENSENET_CFG[depth]
    return DenseNet(cfg, growth=growth, num_init=init, **kw)


def densenet121(pretrained=False, **kw):
    return _densenet(121, pretrained, **kw)


def densenet161(pretrained=False, **kw):
    return _densenet(161, pretrained, **kw)


def densenet169(pretrained=False, **kw):
    return _densenet(169, pretrained, **kw)


def densenet201(pretrained=False, **kw):
    return _densenet(201, pretrained, **kw)


# ---------------------------------------------------------------------------
# GoogLeNet (Inception v1)
# ---------------------------------------------------------------------------

class _Inception(nn.Layer):
    def __init__(self, in_c, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = _conv_bn(in_c, c1, 1)
        self.b2 = nn.Sequential(_conv_bn(in_c, c3r, 1),
                                _conv_bn(c3r, c3, 3, padding=1))
        self.b3 = nn.Sequential(_conv_bn(in_c, c5r, 1),
                                _conv_bn(c5r, c5, 5, padding=2))
        self.b4 = nn.Sequential(nn.MaxPool2D(3, 1, padding=1),
                                _conv_bn(in_c, proj, 1))

    def forward(self, x):
        return paddle_concat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)],
                        axis=1)


class _GoogLeNetAux(nn.Layer):
    def __init__(self, in_c, num_classes):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D((4, 4))
        self.conv = _conv_bn(in_c, 128, 1)
        self.fc1 = nn.Linear(128 * 16, 1024)
        self.fc2 = nn.Linear(1024, num_classes)
        self.dropout = nn.Dropout(0.7)

    def forward(self, x):
        x = self.conv(self.pool(x)).flatten(1)
        return self.fc2(self.dropout(F.relu(self.fc1(x))))


class GoogLeNet(nn.Layer):
    """Returns (out, aux1, aux2) like the upstream model."""

    @placed
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.stem = nn.Sequential(
            _conv_bn(3, 64, 7, stride=2, padding=3), nn.MaxPool2D(3, 2),
            _conv_bn(64, 64, 1), _conv_bn(64, 192, 3, padding=1),
            nn.MaxPool2D(3, 2))
        self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32)
        self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2D(3, 2)
        self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64)
        self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64)
        self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64)
        self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64)
        self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, 2)
        self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128)
        self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128)
        self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        self.dropout = nn.Dropout(0.4)
        self.fc = nn.Linear(1024, num_classes)
        self.aux1 = _GoogLeNetAux(512, num_classes)
        self.aux2 = _GoogLeNetAux(528, num_classes)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.i3b(self.i3a(x)))
        x = self.i4a(x)
        a1 = self.aux1(x)
        x = self.i4d(self.i4c(self.i4b(x)))
        a2 = self.aux2(x)
        x = self.pool4(self.i4e(x))
        x = self.i5b(self.i5a(x))
        out = self.fc(self.dropout(self.avgpool(x).flatten(1)))
        return out, a1, a2


def googlenet(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return GoogLeNet(**kw)


# ---------------------------------------------------------------------------
# Inception v3
# ---------------------------------------------------------------------------

class _InceptionA(nn.Layer):
    def __init__(self, in_c, pool_feat):
        super().__init__()
        self.b1 = _conv_bn(in_c, 64, 1)
        self.b5 = nn.Sequential(_conv_bn(in_c, 48, 1),
                                _conv_bn(48, 64, 5, padding=2))
        self.b3 = nn.Sequential(_conv_bn(in_c, 64, 1),
                                _conv_bn(64, 96, 3, padding=1),
                                _conv_bn(96, 96, 3, padding=1))
        self.bp = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _conv_bn(in_c, pool_feat, 1))

    def forward(self, x):
        return paddle_concat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)],
                        axis=1)


class _InceptionB(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b3 = _conv_bn(in_c, 384, 3, stride=2)
        self.b3d = nn.Sequential(_conv_bn(in_c, 64, 1),
                                 _conv_bn(64, 96, 3, padding=1),
                                 _conv_bn(96, 96, 3, stride=2))
        self.pool = nn.MaxPool2D(3, 2)

    def forward(self, x):
        return paddle_concat([self.b3(x), self.b3d(x), self.pool(x)], axis=1)


class _InceptionC(nn.Layer):
    def __init__(self, in_c, c7):
        super().__init__()
        self.b1 = _conv_bn(in_c, 192, 1)
        self.b7 = nn.Sequential(
            _conv_bn(in_c, c7, 1),
            _conv_bn(c7, c7, (1, 7), padding=(0, 3)),
            _conv_bn(c7, 192, (7, 1), padding=(3, 0)))
        self.b7d = nn.Sequential(
            _conv_bn(in_c, c7, 1),
            _conv_bn(c7, c7, (7, 1), padding=(3, 0)),
            _conv_bn(c7, c7, (1, 7), padding=(0, 3)),
            _conv_bn(c7, c7, (7, 1), padding=(3, 0)),
            _conv_bn(c7, 192, (1, 7), padding=(0, 3)))
        self.bp = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _conv_bn(in_c, 192, 1))

    def forward(self, x):
        return paddle_concat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)],
                        axis=1)


class _InceptionD(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b3 = nn.Sequential(_conv_bn(in_c, 192, 1),
                                _conv_bn(192, 320, 3, stride=2))
        self.b7 = nn.Sequential(
            _conv_bn(in_c, 192, 1),
            _conv_bn(192, 192, (1, 7), padding=(0, 3)),
            _conv_bn(192, 192, (7, 1), padding=(3, 0)),
            _conv_bn(192, 192, 3, stride=2))
        self.pool = nn.MaxPool2D(3, 2)

    def forward(self, x):
        return paddle_concat([self.b3(x), self.b7(x), self.pool(x)], axis=1)


class _InceptionE(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b1 = _conv_bn(in_c, 320, 1)
        self.b3_stem = _conv_bn(in_c, 384, 1)
        self.b3_a = _conv_bn(384, 384, (1, 3), padding=(0, 1))
        self.b3_b = _conv_bn(384, 384, (3, 1), padding=(1, 0))
        self.b3d_stem = nn.Sequential(_conv_bn(in_c, 448, 1),
                                      _conv_bn(448, 384, 3, padding=1))
        self.b3d_a = _conv_bn(384, 384, (1, 3), padding=(0, 1))
        self.b3d_b = _conv_bn(384, 384, (3, 1), padding=(1, 0))
        self.bp = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _conv_bn(in_c, 192, 1))

    def forward(self, x):
        s = self.b3_stem(x)
        d = self.b3d_stem(x)
        return paddle_concat(
            [self.b1(x),
             paddle_concat([self.b3_a(s), self.b3_b(s)], axis=1),
             paddle_concat([self.b3d_a(d), self.b3d_b(d)], axis=1),
             self.bp(x)], axis=1)


class InceptionV3(nn.Layer):
    @placed
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.stem = nn.Sequential(
            _conv_bn(3, 32, 3, stride=2), _conv_bn(32, 32, 3),
            _conv_bn(32, 64, 3, padding=1), nn.MaxPool2D(3, 2),
            _conv_bn(64, 80, 1), _conv_bn(80, 192, 3), nn.MaxPool2D(3, 2))
        self.blocks = nn.Sequential(
            _InceptionA(192, 32), _InceptionA(256, 64), _InceptionA(288, 64),
            _InceptionB(288),
            _InceptionC(768, 128), _InceptionC(768, 160),
            _InceptionC(768, 160), _InceptionC(768, 192),
            _InceptionD(768),
            _InceptionE(1280), _InceptionE(2048))
        self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        self.dropout = nn.Dropout(0.5)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        return self.fc(self.dropout(self.avgpool(x).flatten(1)))


def inception_v3(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return InceptionV3(**kw)


# ---------------------------------------------------------------------------
# ShuffleNetV2
# ---------------------------------------------------------------------------

def _channel_shuffle(x, groups):
    return F.channel_shuffle(x, groups)


class _ShuffleUnit(nn.Layer):
    def __init__(self, in_c, out_c, stride):
        super().__init__()
        self.stride = stride
        branch_c = out_c // 2
        if stride > 1:
            self.branch1 = nn.Sequential(
                nn.Conv2D(in_c, in_c, 3, stride=stride, padding=1,
                          groups=in_c, bias_attr=False),
                nn.BatchNorm2D(in_c),
                _conv_bn(in_c, branch_c, 1))
            b2_in = in_c
        else:
            self.branch1 = None
            b2_in = in_c // 2
        self.branch2 = nn.Sequential(
            _conv_bn(b2_in, branch_c, 1),
            nn.Conv2D(branch_c, branch_c, 3, stride=stride, padding=1,
                      groups=branch_c, bias_attr=False),
            nn.BatchNorm2D(branch_c),
            _conv_bn(branch_c, branch_c, 1))

    def forward(self, x):
        if self.stride == 1:
            x1, x2 = x[:, :x.shape[1] // 2], x[:, x.shape[1] // 2:]
            out = paddle_concat([x1, self.branch2(x2)], axis=1)
        else:
            out = paddle_concat([self.branch1(x), self.branch2(x)], axis=1)
        return _channel_shuffle(out, 2)


_SHUFFLE_CFG = {
    '0.25': ([4, 8, 4], [24, 24, 48, 96, 512]),
    '0.5': ([4, 8, 4], [24, 48, 96, 192, 1024]),
    '1.0': ([4, 8, 4], [24, 116, 232, 464, 1024]),
    '1.5': ([4, 8, 4], [24, 176, 352, 704, 1024]),
    '2.0': ([4, 8, 4], [24, 244, 488, 976, 2048]),
}


class ShuffleNetV2(nn.Layer):
    @placed
    def __init__(self, scale='1.0', num_classes=1000, act='relu'):
        super().__init__()
        repeats, channels = _SHUFFLE_CFG[str(scale)]
        self.stem = nn.Sequential(
            _conv_bn(3, channels[0], 3, stride=2, padding=1),
            nn.MaxPool2D(3, 2, padding=1))
        stages = []
        in_c = channels[0]
        for i, reps in enumerate(repeats):
            out_c = channels[i + 1]
            stages.append(_ShuffleUnit(in_c, out_c, 2))
            for _ in range(reps - 1):
                stages.append(_ShuffleUnit(out_c, out_c, 1))
            in_c = out_c
        self.stages = nn.Sequential(*stages)
        self.tail = _conv_bn(in_c, channels[-1], 1)
        self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        self.fc = nn.Linear(channels[-1], num_classes)

    def forward(self, x):
        x = self.tail(self.stages(self.stem(x)))
        return self.fc(self.avgpool(x).flatten(1))


def shufflenet_v2_x0_25(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return ShuffleNetV2('0.25', **kw)


def shufflenet_v2_x0_5(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return ShuffleNetV2('0.5', **kw)


def shufflenet_v2_x1_0(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return ShuffleNetV2('1.0', **kw)


def shufflenet_v2_x1_5(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return ShuffleNetV2('1.5', **kw)


def shufflenet_v2_x2_0(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return ShuffleNetV2('2.0', **kw)


# ---------------------------------------------------------------------------
# MobileNetV1 / MobileNetV3
# ---------------------------------------------------------------------------

class MobileNetV1(nn.Layer):
    @placed
    def __init__(self, scale=1.0, num_classes=1000):
        super().__init__()

        def c(ch):
            return max(8, int(ch * scale))
        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 \
            + [(512, 1024, 2), (1024, 1024, 1)]
        layers = [_conv_bn(3, c(32), 3, stride=2, padding=1)]
        for in_c, out_c, s in cfg:
            layers += [
                nn.Conv2D(c(in_c), c(in_c), 3, stride=s, padding=1,
                          groups=c(in_c), bias_attr=False),
                nn.BatchNorm2D(c(in_c)), nn.ReLU(),
                _conv_bn(c(in_c), c(out_c), 1)]
        self.features = nn.Sequential(*layers)
        self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        self.fc = nn.Linear(c(1024), num_classes)

    def forward(self, x):
        return self.fc(self.avgpool(self.features(x)).flatten(1))


def mobilenet_v1(pretrained=False, scale=1.0, **kw):
    _no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kw)


class _SqueezeExcite(nn.Layer):
    def __init__(self, c, r=4):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D((1, 1))
        self.fc1 = nn.Conv2D(c, c // r, 1)
        self.fc2 = nn.Conv2D(c // r, c, 1)

    def forward(self, x):
        s = self.pool(x)
        s = F.hardsigmoid(self.fc2(F.relu(self.fc1(s))))
        return x * s


class _MBV3Block(nn.Layer):
    def __init__(self, in_c, exp, out_c, k, stride, se, act):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if exp != in_c:
            layers.append(_conv_bn(in_c, exp, 1, act=act))
        layers += [nn.Conv2D(exp, exp, k, stride=stride, padding=k // 2,
                             groups=exp, bias_attr=False),
                   nn.BatchNorm2D(exp),
                   nn.Hardswish() if act == 'hardswish' else nn.ReLU()]
        if se:
            layers.append(_SqueezeExcite(exp))
        layers.append(_conv_bn(exp, out_c, 1, act=None))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return out + x if self.use_res else out


_MBV3_SMALL = [  # k, exp, out, se, act, stride
    (3, 16, 16, True, 'relu', 2), (3, 72, 24, False, 'relu', 2),
    (3, 88, 24, False, 'relu', 1), (5, 96, 40, True, 'hardswish', 2),
    (5, 240, 40, True, 'hardswish', 1), (5, 240, 40, True, 'hardswish', 1),
    (5, 120, 48, True, 'hardswish', 1), (5, 144, 48, True, 'hardswish', 1),
    (5, 288, 96, True, 'hardswish', 2), (5, 576, 96, True, 'hardswish', 1),
    (5, 576, 96, True, 'hardswish', 1)]
_MBV3_LARGE = [
    (3, 16, 16, False, 'relu', 1), (3, 64, 24, False, 'relu', 2),
    (3, 72, 24, False, 'relu', 1), (5, 72, 40, True, 'relu', 2),
    (5, 120, 40, True, 'relu', 1), (5, 120, 40, True, 'relu', 1),
    (3, 240, 80, False, 'hardswish', 2), (3, 200, 80, False, 'hardswish', 1),
    (3, 184, 80, False, 'hardswish', 1), (3, 184, 80, False, 'hardswish', 1),
    (3, 480, 112, True, 'hardswish', 1), (3, 672, 112, True, 'hardswish', 1),
    (5, 672, 160, True, 'hardswish', 2), (5, 960, 160, True, 'hardswish', 1),
    (5, 960, 160, True, 'hardswish', 1)]


class MobileNetV3(nn.Layer):
    @placed
    def __init__(self, cfg, last_c, num_classes=1000):
        super().__init__()
        layers = [_conv_bn(3, 16, 3, stride=2, padding=1, act='hardswish')]
        in_c = 16
        for k, exp, out_c, se, act, s in cfg:
            layers.append(_MBV3Block(in_c, exp, out_c, k, s, se, act))
            in_c = out_c
        exp_last = cfg[-1][1]
        layers.append(_conv_bn(in_c, exp_last, 1, act='hardswish'))
        self.features = nn.Sequential(*layers)
        self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        self.classifier = nn.Sequential(
            nn.Linear(exp_last, last_c), nn.Hardswish(),
            nn.Dropout(0.2), nn.Linear(last_c, num_classes))

    def forward(self, x):
        return self.classifier(self.avgpool(self.features(x)).flatten(1))


def mobilenet_v3_small(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return MobileNetV3(_MBV3_SMALL, 1024, **kw)


def mobilenet_v3_large(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return MobileNetV3(_MBV3_LARGE, 1280, **kw)
