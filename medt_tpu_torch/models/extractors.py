"""Dense-prediction feature extractors (NCHW).

Port of ``medt_tpu/models/extractors.py`` (reference extractors.py:1-373,
PSPNet-style backbones): a dilated ResNet that keeps output stride 8 by
trading the last two stages' strides for dilations 2 and 4, a SqueezeNet
(Fire modules) and a DenseNet-121-shaped extractor. Each returns
``(features, shallow_features)``, as JAX's do. Parameter names follow the
JAX trees as the weight carrier translates them (``layer{i}.{b}`` for the
dilated ResNet's blocks, ``fire{n}.squeeze`` ..., ``block{i}_layer{j}``
and ``trans{i}_{bn,conv}`` for the DenseNet).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import BatchNorm, avg_pool, conv1x1, conv2d, max_pool_3x3_s2
from .resnet import Bottleneck


class DilatedResNet(nn.Module):
    """ResNet backbone at output stride 8: stages 3 and 4 take dilation 2
    and 4 instead of stride 2; ``shallow`` is stage 1's output."""

    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3), *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        init = dict(generator=generator, device=device)
        self.conv1 = conv2d(3, 64, 7, stride=2, use_bias=False, **init)
        self.bn1 = BatchNorm(64, device=device)
        inplanes = 64
        cfg = [(64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4)]
        for i, ((planes, stride, dilation), blocks) in enumerate(
                zip(cfg, layers)):
            stage = []
            for b in range(blocks):
                stage.append(Bottleneck(inplanes, planes,
                                        stride if b == 0 else 1,
                                        dilation=dilation, **init))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*stage))

    def forward(self, x):
        x = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))))
        shallow = x = self.layer1(x)
        for i in range(1, 4):
            x = getattr(self, f"layer{i + 1}")(x)
        return x, shallow


class Fire(nn.Module):
    """SqueezeNet Fire module: a 1x1 squeeze, then 1x1 and 3x3 expands
    concatenated, each conv with bias and ReLU."""

    def __init__(self, inplanes: int, squeeze: int, expand: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        init = dict(generator=generator, device=device)
        self.squeeze = conv2d(inplanes, squeeze, 1, padding=0, **init)
        self.expand1x1 = conv2d(squeeze, expand, 1, padding=0, **init)
        self.expand3x3 = conv2d(squeeze, expand, 3, **init)

    def forward(self, x):
        s = F.relu(self.squeeze(x))
        return F.relu(torch.cat([self.expand1x1(s), self.expand3x3(s)],
                                dim=1))


# (squeeze, expand) of fire2 .. fire9; a max pool after fire3
_FIRES = ((16, 64), (16, 64), (32, 128), (32, 128), (48, 192), (48, 192),
          (64, 256), (64, 256))


class SqueezeNetExtractor(nn.Module):
    """``shallow`` is fire3's output (stride 4); the features stride 8."""

    def __init__(self, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        init = dict(generator=generator, device=device)
        self.conv1 = conv2d(3, 64, 3, stride=2, **init)
        cin = 64
        for n, (squeeze, expand) in enumerate(_FIRES, start=2):
            setattr(self, f"fire{n}", Fire(cin, squeeze, expand, **init))
            cin = 2 * expand

    def forward(self, x):
        x = max_pool_3x3_s2(F.relu(self.conv1(x)))
        x = self.fire3(self.fire2(x))
        shallow = x
        x = max_pool_3x3_s2(x)
        for n in range(4, 10):
            x = getattr(self, f"fire{n}")(x)
        return x, shallow


class DenseLayer(nn.Module):
    """BN, ReLU, 1x1 conv to 4 * growth, BN, ReLU, 3x3 conv to growth;
    the result concatenated after the input."""

    def __init__(self, inplanes: int, growth: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        init = dict(generator=generator, device=device)
        self.bn1 = BatchNorm(inplanes, device=device)
        self.conv1 = conv1x1(inplanes, 4 * growth, **init)
        self.bn2 = BatchNorm(4 * growth, device=device)
        self.conv2 = conv2d(4 * growth, growth, 3, use_bias=False, **init)

    def forward(self, x):
        y = self.conv1(F.relu(self.bn1(x)))
        y = self.conv2(F.relu(self.bn2(y)))
        return torch.cat([x, y], dim=1)


class DenseNetExtractor(nn.Module):
    """DenseNet-121-shaped: only the first transition pools, so the
    features keep output stride 8; ``shallow`` is block 0's output."""

    def __init__(self, block_config: Sequence[int] = (6, 12, 24, 16),
                 growth: int = 32, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        init = dict(generator=generator, device=device)
        self.block_config = tuple(block_config)
        self.conv0 = conv2d(3, 64, 7, stride=2, use_bias=False, **init)
        self.bn0 = BatchNorm(64, device=device)
        cin = 64
        for i, n_layers in enumerate(self.block_config):
            for j in range(n_layers):
                setattr(self, f"block{i}_layer{j}",
                        DenseLayer(cin, growth, **init))
                cin += growth
            if i != len(self.block_config) - 1:
                setattr(self, f"trans{i}_bn", BatchNorm(cin, device=device))
                setattr(self, f"trans{i}_conv",
                        conv1x1(cin, cin // 2, **init))
                cin //= 2

    def forward(self, x):
        x = max_pool_3x3_s2(F.relu(self.bn0(self.conv0(x))))
        shallow = None
        last = len(self.block_config) - 1
        for i, n_layers in enumerate(self.block_config):
            for j in range(n_layers):
                x = getattr(self, f"block{i}_layer{j}")(x)
            if i == 0:
                shallow = x
            if i != last:
                x = getattr(self, f"trans{i}_conv")(
                    F.relu(getattr(self, f"trans{i}_bn")(x)))
                if i == 0:
                    x = avg_pool(x, 2)
        return x, shallow


EXTRACTOR_REGISTRY = {
    "resnet101_dilated": lambda **kw: DilatedResNet((3, 4, 23, 3), **kw),
    "resnet50_dilated": lambda **kw: DilatedResNet((3, 4, 6, 3), **kw),
    "squeezenet": SqueezeNetExtractor,
    "densenet": DenseNetExtractor,
}
