"""ResAxialAttentionUNet — the single-branch axial-attention U-Net (NCHW).

Port of ``medt_tpu/models/axial_unet.py`` (reference axialnet.py:397-507):
a 3-conv stem (7x7/s2 -> 3x3 -> 3x3), four axial stages of [1, 2, 4, 1]
blocks, a conv decoder with bilinear x2 upsampling and additive skips, and
a 1x1 head emitting raw logits. Spans follow the reference schedule
``img_size // {2, 2, 4, 8}``, halved inside a stage after its strided block.

The reference registers the stem's layers at the top level of the model
(``conv1``, ``bn1``, ... and ``conv1_p``, ... for MedT's local branch), so
the stem here is a pair of functions over its parent module rather than a
submodule: that keeps the reference's ``state_dict`` keys.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import BatchNorm, conv2d, upsample_bilinear_2x
from .blocks import AxialStage

# every model of the registry: reference axialnet.py:714-728
LAYERS = (1, 2, 4, 1)
GROUPS = 8
S = 0.125  # width scale


def add_conv_stem(parent: nn.Module, imgchan: int, inplanes: int,
                  suffix: str = "", mid: int = 128, *,
                  generator: Optional[torch.Generator] = None, device=None):
    """Register the stem (``ConvStem`` in JAX) on ``parent``:
    imgchan -> inplanes (7x7/s2) -> mid -> inplanes."""
    init = dict(generator=generator, device=device)
    chans = ((imgchan, inplanes, 7, 2), (inplanes, mid, 3, 1),
             (mid, inplanes, 3, 1))
    for i, (cin, cout, ksize, stride) in enumerate(chans, start=1):
        conv = conv2d(cin, cout, ksize, stride=stride, use_bias=False, **init)
        setattr(parent, f"conv{i}{suffix}", conv)
        setattr(parent, f"bn{i}{suffix}", BatchNorm(cout, device=device))


def conv_stem(parent: nn.Module, x: torch.Tensor, suffix: str = ""):
    """Run the stem registered by :func:`add_conv_stem`."""
    for i in (1, 2, 3):
        conv = getattr(parent, f"conv{i}{suffix}")
        bn = getattr(parent, f"bn{i}{suffix}")
        x = F.relu(bn(conv(x)))
    return x


def up_block(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Decoder step (``_up_block`` in JAX): conv -> bilinear x2 -> ReLU."""
    return F.relu(upsample_bilinear_2x(conv(x)))


class ResAxialAttentionUNet(nn.Module):
    """Encoder/decoder axial-attention U-Net emitting raw NCHW logits."""

    def __init__(self, img_size: int = 128, imgchan: int = 3,
                 num_classes: int = 2, *, attn: dict,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        s = S
        init = dict(generator=generator, device=device)
        inplanes = int(64 * s)
        planes = [int(128 * s), int(256 * s), int(512 * s), int(1024 * s)]
        spans = [img_size // 2, img_size // 2, img_size // 4, img_size // 8]
        strides = [1, 2, 2, 2]
        add_conv_stem(self, imgchan, inplanes, **init)
        for i in range(4):
            stage = AxialStage(inplanes, planes[i], LAYERS[i], spans[i],
                               stride=strides[i], groups=GROUPS, attn=attn,
                               **init)
            setattr(self, f"layer{i + 1}", stage)
            inplanes = stage.out_planes
        c = [int(1024 * 2 * s), int(1024 * s), int(512 * s), int(256 * s),
             int(128 * s)]
        self.decoder1 = conv2d(c[0], c[0], 3, stride=2, **init)
        self.decoder2 = conv2d(c[0], c[1], 3, **init)
        self.decoder3 = conv2d(c[1], c[2], 3, **init)
        self.decoder4 = conv2d(c[2], c[3], 3, **init)
        self.decoder5 = conv2d(c[3], c[4], 3, **init)
        self.adjust = conv2d(c[4], num_classes, 1, padding=0, **init)

    def forward(self, x):
        x = conv_stem(self, x)
        x1 = self.layer1(x)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        x4 = self.layer4(x3)
        # decoder1: its stride-2 conv and the x2 upsample cancel out
        d = up_block(self.decoder1, x4) + x4
        d = up_block(self.decoder2, d) + x3
        d = up_block(self.decoder3, d) + x2
        d = up_block(self.decoder4, d) + x1
        d = up_block(self.decoder5, d)
        return self.adjust(F.relu(d))
