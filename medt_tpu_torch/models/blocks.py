"""Axial bottleneck blocks (NCHW).

Port of the dense path of ``medt_tpu/models/blocks.py`` (reference
axialnet.py:262-391): conv1x1 down to ``width`` -> BN -> ReLU -> height
attention -> width attention (carrying the stride) -> ReLU -> conv1x1 up to
``planes*2`` -> BN -> residual add (through a strided 1x1 + BN downsample
where shapes change) -> ReLU. The JAX package's lanes-resident activation
layout is a TPU device layout and is not ported. The reference's wopos
block also builds a ``conv1`` its forward never calls; it is not
reproduced (its weights are dead keys of reference state dicts).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import AxialAttention, BatchNorm, conv1x1


class AxialBlock(nn.Module):
    """Residual bottleneck around a (height, width) axial-attention pair.

    ``attn`` holds the AxialAttention options shared by a whole model
    (mode, gate_init, trainable_gates, use_fused, plain_cores)."""

    expansion = 2

    def __init__(self, inplanes: int, planes: int, span: int, stride: int = 1,
                 groups: int = 8, *, attn: dict,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        width = planes  # base width 64 in every model
        out_planes = planes * self.expansion
        init = dict(generator=generator, device=device)
        self.conv_down = conv1x1(inplanes, width, **init)
        self.bn1 = BatchNorm(width, device=device)
        self.hight_block = AxialAttention(width, width, span, groups=groups,
                                          axis="h", **attn, **init)
        self.width_block = AxialAttention(width, width, span, groups=groups,
                                          axis="w", stride=stride, **attn,
                                          **init)
        self.conv_up = conv1x1(width, out_planes, **init)
        self.bn2 = BatchNorm(out_planes, device=device)
        self.downsample = None
        if stride != 1 or inplanes != out_planes:
            self.downsample = nn.Sequential(
                conv1x1(inplanes, out_planes, stride=stride, **init),
                BatchNorm(out_planes, device=device))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv_down(x)))
        out = self.width_block(self.hight_block(out))
        out = self.bn2(self.conv_up(F.relu(out)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class AxialStage(nn.Sequential):
    """The reference's ``_make_layer`` (axialnet.py:443-469): the first
    block carries the stride and the downsample; the span halves after a
    strided block; later blocks take ``planes*2`` inputs."""

    def __init__(self, inplanes: int, planes: int, blocks: int, span: int,
                 stride: int = 1, groups: int = 8, *, attn: dict,
                 generator: Optional[torch.Generator] = None, device=None):
        layers = []
        for i in range(blocks):
            layers.append(AxialBlock(
                inplanes, planes, span, stride=stride if i == 0 else 1,
                groups=groups, attn=attn,
                generator=generator, device=device))
            inplanes = planes * AxialBlock.expansion
            if i == 0 and stride != 1:
                span //= 2
        super().__init__(*layers)
        self.out_planes = planes * AxialBlock.expansion
