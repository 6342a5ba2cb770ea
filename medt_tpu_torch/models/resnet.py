"""The classification ResNet family (NCHW).

Port of ``medt_tpu/models/resnet.py`` (reference lib/models/resnet.py:
1-287): BasicBlock and Bottleneck residual stages, a 7x7/s2 stem and a
3x3/s2 max pool, global average pooling and a linear head; ``resnet26`` is
the reference's nonstandard [1, 2, 4, 1] bottleneck net. Parameters carry
the reference's names (``conv1``, ``bn1``, ``layer{i}.{b}.conv{1,2,3}``,
``bn{1,2,3}``, ``downsample.{0,1}``, ``fc``), so a JAX variable tree
carried by :func:`..utils.weights.export_for_model` loads with
``load_state_dict(strict=True)``. The convolutions draw from the
reference's default law through a ``torch.Generator``; the head is a
plain ``nn.Linear`` drawn the same way.
"""
from __future__ import annotations

from typing import Optional, Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import BatchNorm, conv1x1, conv2d, max_pool_3x3_s2
from ..ops.initializers import uniform_by_fan


def _downsample(inplanes: int, out: int, stride: int, init: dict,
                device) -> nn.Sequential:
    return nn.Sequential(conv1x1(inplanes, out, stride=stride, **init),
                         BatchNorm(out, device=device))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        init = dict(generator=generator, device=device)
        self.conv1 = conv2d(inplanes, planes, 3, stride=stride,
                            use_bias=False, **init)
        self.bn1 = BatchNorm(planes, device=device)
        self.conv2 = conv2d(planes, planes, 3, use_bias=False, **init)
        self.bn2 = BatchNorm(planes, device=device)
        self.downsample = None
        if stride != 1 or inplanes != planes * self.expansion:
            self.downsample = _downsample(inplanes, planes * self.expansion,
                                          stride, init, device)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, *,
                 dilation: int = 1,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        init = dict(generator=generator, device=device)
        self.conv1 = conv1x1(inplanes, planes, **init)
        self.bn1 = BatchNorm(planes, device=device)
        self.conv2 = conv2d(planes, planes, 3, stride=stride, use_bias=False,
                            dilation=dilation, **init)
        self.bn2 = BatchNorm(planes, device=device)
        self.conv3 = conv1x1(planes, planes * self.expansion, **init)
        self.bn3 = BatchNorm(planes * self.expansion, device=device)
        self.downsample = None
        if stride != 1 or inplanes != planes * self.expansion:
            self.downsample = _downsample(inplanes, planes * self.expansion,
                                          stride, init, device)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


def linear(in_features: int, out_features: int, *,
           generator: Optional[torch.Generator] = None,
           device=None) -> nn.Linear:
    """``nn.Linear`` drawn from the reference's default law (U(+-1/sqrt
    fan_in), weight and bias)."""
    fc = nn.Linear(in_features, out_features, device=device)
    uniform_by_fan(fc.weight, in_features, generator)
    uniform_by_fan(fc.bias, in_features, generator)
    return fc


class ResNet(nn.Module):
    """(N, 3, H, W) -> (N, num_classes) logits."""

    def __init__(self, block: Type[nn.Module], layers: Sequence[int],
                 num_classes: int = 1000, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        init = dict(generator=generator, device=device)
        self.conv1 = conv2d(3, 64, 7, stride=2, use_bias=False, **init)
        self.bn1 = BatchNorm(64, device=device)
        inplanes = 64
        for i, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                 layers)):
            stage = []
            for b in range(blocks):
                stride = 2 if i > 0 and b == 0 else 1
                stage.append(block(inplanes, planes, stride, **init))
                inplanes = planes * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*stage))
        self.fc = linear(inplanes, num_classes, **init)

    def forward(self, x):
        x = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))))
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
        return self.fc(x.mean(dim=(2, 3)))


def resnet18(**kw):
    return ResNet(BasicBlock, (2, 2, 2, 2), **kw)


def resnet34(**kw):
    return ResNet(BasicBlock, (3, 4, 6, 3), **kw)


def resnet26(**kw):
    """Nonstandard [1, 2, 4, 1] bottleneck net (reference resnet.py:
    252-254)."""
    return ResNet(Bottleneck, (1, 2, 4, 1), **kw)


def resnet50(**kw):
    return ResNet(Bottleneck, (3, 4, 6, 3), **kw)


def resnet101(**kw):
    return ResNet(Bottleneck, (3, 4, 23, 3), **kw)


def resnet152(**kw):
    return ResNet(Bottleneck, (3, 8, 36, 3), **kw)
