"""ResAxialAttentionUNet — the single-branch axial-attention U-Net (NCHW).

Port of ``medt_tpu/models/axial_unet.py`` (reference axialnet.py:397-507):
a 3-conv stem (7x7/s2 -> 3x3 -> 3x3), four axial stages of [1, 2, 4, 1]
blocks, a conv decoder with bilinear x2 upsampling and additive skips, and
a 1x1 head emitting raw logits. Spans follow the reference schedule
``img_size // {2, 2, 4, 8}``, halved inside a stage after its strided block.

The zoo's options (``medt_tpu/models/axial_unet.py:55-184``):
``use_attention=False`` (a strided 3x3 conv in place of each block's
attention pair), ``stem_mode="single"`` (one 7x7/s2 conv + BN + ReLU,
``stem_conv``/``stem_bn``), ``final_softmax`` (a softmax over the classes
at the head), ``num_stages=2`` (two stages and two decoder steps, the zoo's
shallow net) and ``deep_supervision`` (one 3x3 ``inter{i}`` + ReLU + 1x1
``inte{i}`` head per encoder stage at that stage's own scale; the forward
then returns ``(logits, (aux1, ..., aux4))`` in both modes, as JAX's does).

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
    """Encoder/decoder axial-attention U-Net emitting raw NCHW logits (or
    their softmax with ``final_softmax``; a tuple with
    ``deep_supervision``)."""

    def __init__(self, img_size: int = 128, imgchan: int = 3,
                 num_classes: int = 2, *, attn: dict,
                 use_attention: bool = True, stem_mode: str = "triple",
                 final_softmax: bool = False, num_stages: int = 4,
                 deep_supervision: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if stem_mode not in ("triple", "single"):
            raise ValueError(f"unknown stem_mode {stem_mode!r}")
        if num_stages not in (2, 4):
            raise ValueError(f"num_stages must be 2 or 4, got {num_stages}")
        if deep_supervision and num_stages != 4:
            raise ValueError("deep_supervision needs num_stages=4")
        s = S
        init = dict(generator=generator, device=device)
        self.stem_mode, self.num_stages = stem_mode, num_stages
        self.final_softmax = final_softmax
        self.deep_supervision = deep_supervision
        inplanes = int(64 * s)
        planes = [int(128 * s), int(256 * s), int(512 * s), int(1024 * s)]
        spans = [img_size // 2, img_size // 2, img_size // 4, img_size // 8]
        strides = [1, 2, 2, 2]
        if stem_mode == "triple":
            add_conv_stem(self, imgchan, inplanes, **init)
        else:  # zoo unetplus stem (model_codes.py:1112-1115)
            self.stem_conv = conv2d(imgchan, inplanes, 7, stride=2,
                                    use_bias=False, **init)
            self.stem_bn = BatchNorm(inplanes, device=device)
        skips = []
        for i in range(num_stages):
            stage = AxialStage(inplanes, planes[i], LAYERS[i], spans[i],
                               stride=strides[i], groups=GROUPS, attn=attn,
                               use_attention=use_attention, **init)
            setattr(self, f"layer{i + 1}", stage)
            inplanes = stage.out_planes
            skips.append(inplanes)
        c = [int(1024 * 2 * s), int(1024 * s), int(512 * s), int(256 * s),
             int(128 * s)]
        if num_stages == 4:
            self.decoder1 = conv2d(c[0], c[0], 3, stride=2, **init)
            self.decoder2 = conv2d(c[0], c[1], 3, **init)
            self.decoder3 = conv2d(c[1], c[2], 3, **init)
        self.decoder4 = conv2d(c[2], c[3], 3, **init)
        self.decoder5 = conv2d(c[3], c[4], 3, **init)
        self.adjust = conv2d(c[4], num_classes, 1, padding=0, **init)
        if deep_supervision:
            for i, ch in enumerate(skips, start=1):
                setattr(self, f"inter{i}", conv2d(ch, ch, 3, **init))
                setattr(self, f"inte{i}", conv2d(ch, num_classes, 1,
                                                 padding=0, **init))

    def _head(self, logits):
        return torch.softmax(logits, dim=1) if self.final_softmax else logits

    def forward(self, x):
        if self.stem_mode == "triple":
            x = conv_stem(self, x)
        else:
            x = F.relu(self.stem_bn(self.stem_conv(x)))
        x1 = self.layer1(x)
        x2 = self.layer2(x1)
        if self.num_stages == 2:  # zoo shallow net (model_codes.py:2097)
            d = up_block(self.decoder4, x2) + x1
            d = up_block(self.decoder5, d)
            return self._head(self.adjust(F.relu(d)))
        x3 = self.layer3(x2)
        x4 = self.layer4(x3)
        # decoder1: its stride-2 conv and the x2 upsample cancel out
        d = up_block(self.decoder1, x4) + x4
        d = up_block(self.decoder2, d) + x3
        d = up_block(self.decoder3, d) + x2
        d = up_block(self.decoder4, d) + x1
        d = up_block(self.decoder5, d)
        logits = self._head(self.adjust(F.relu(d)))
        if not self.deep_supervision:
            return logits
        aux = tuple(
            self._head(getattr(self, f"inte{i}")(
                F.relu(getattr(self, f"inter{i}")(skip))))
            for i, skip in enumerate((x1, x2, x3, x4), start=1))
        return logits, aux
