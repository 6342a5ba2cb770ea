"""The zoo's axial-attention classifiers and its conv autoencoder (NCHW).

Port of ``medt_tpu/models/classifiers.py``:

* ``AxialAttentionNet`` (``:24-84``; reference lib/models/model_codes.py:
  834-937): a 7x7/s2 conv stem and a 3x3/s2 max pool, four axial stages
  (the port's :class:`.blocks.AxialStage`, mode "full") at widths
  int({128, 256, 512, 1024} * s) with spans base, base, base / 2, base / 4
  for base = img_size // 4 (56, 56, 28, 14 at 224 px), global average
  pooling and a linear ``fc``. The factories axial26s, axial50s (s = 0.5),
  axial50m (0.75) and axial50l (1.0) follow model_codes.py:2259-2277. The
  group planes of layers 1-4 are 8, 16, 32, 64 at s = 0.5, 12, 24, 48, 96
  at s = 0.75 and 16, 32, 64, 128 at s = 1.0; under ``use_fused`` every
  one of them runs on the kernels (gp 12 and up on the wide ones). As in
  JAX, ``use_fused`` is off by default.
* ``ConvAutoencoder`` (``:89-110``; model_codes.py:2224-2256): a 3-level
  encoder of stride-2 3x3 convs + BN + ReLU, a decoder of 3x3 convs + BN +
  bilinear x2 + ReLU, and a 3x3 output conv followed by one more bilinear
  x2, back at the input size.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import (BatchNorm, conv2d, max_pool_3x3_s2, set_compute_dtype,
                   upsample_bilinear_2x)
from .blocks import AxialStage
from .resnet import linear


class AxialAttentionNet(nn.Module):
    """(N, 3, img_size, img_size) -> (N, num_classes) logits."""

    def __init__(self, layers: Sequence[int] = (1, 2, 4, 1),
                 num_classes: int = 1000, groups: int = 8, s: float = 0.5,
                 img_size: int = 224, use_fused: bool = False,
                 plain_cores: bool = False,
                 dtype: Optional[torch.dtype] = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        init = dict(generator=generator, device=device)
        inplanes = int(64 * s)
        self.conv1 = conv2d(3, inplanes, 7, stride=2, use_bias=False, **init)
        self.bn1 = BatchNorm(inplanes, device=device)
        # span schedule scaled off the post-stem extent (56 at 224 px)
        base = img_size // 4
        stage_cfg = [(int(128 * s), 1, base), (int(256 * s), 2, base),
                     (int(512 * s), 2, base // 2),
                     (int(1024 * s), 2, base // 4)]
        attn = dict(mode="full", use_fused=use_fused, plain_cores=plain_cores)
        for i, ((planes, stride, span), blocks) in enumerate(
                zip(stage_cfg, layers)):
            stage = AxialStage(inplanes, planes, blocks, span, stride=stride,
                               groups=groups, attn=attn, **init)
            setattr(self, f"layer{i + 1}", stage)
            inplanes = stage.out_planes
        self.fc = linear(inplanes, num_classes, **init)
        if dtype is not None:
            set_compute_dtype(self, dtype)

    def forward(self, x):
        x = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))))
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
        # global average pool, then the head on float32 parameters
        return self.fc(x.float().mean(dim=(2, 3)))


def axial26s(**kw):
    kw.setdefault("s", 0.5)
    return AxialAttentionNet(layers=(1, 2, 4, 1), **kw)


def axial50s(**kw):
    kw.setdefault("s", 0.5)
    return AxialAttentionNet(layers=(3, 4, 6, 3), **kw)


def axial50m(**kw):
    kw.setdefault("s", 0.75)
    return AxialAttentionNet(layers=(3, 4, 6, 3), **kw)


def axial50l(**kw):
    kw.setdefault("s", 1.0)
    return AxialAttentionNet(layers=(3, 4, 6, 3), **kw)


class ConvAutoencoder(nn.Module):
    """Small conv autoencoder: (N, imgchan, H, W) -> (N, out_channels, H, W)
    for H and W divisible by 8."""

    def __init__(self, imgchan: int = 3, widths: Sequence[int] = (16, 32, 64),
                 out_channels: int = 3, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        init = dict(generator=generator, device=device)
        self.widths = tuple(widths)
        cin = imgchan
        for i, w in enumerate(self.widths):
            setattr(self, f"enc{i}", conv2d(cin, w, 3, stride=2,
                                            use_bias=False, **init))
            setattr(self, f"enc_bn{i}", BatchNorm(w, device=device))
            cin = w
        for i, w in enumerate(reversed(self.widths[:-1])):
            setattr(self, f"dec{i}", conv2d(cin, w, 3, use_bias=False,
                                            **init))
            setattr(self, f"dec_bn{i}", BatchNorm(w, device=device))
            cin = w
        self.dec_out = conv2d(self.widths[0], out_channels, 3, **init)

    def forward(self, x):
        for i in range(len(self.widths)):
            x = F.relu(getattr(self, f"enc_bn{i}")(getattr(self, f"enc{i}")(x)))
        for i in range(len(self.widths) - 1):
            x = getattr(self, f"dec_bn{i}")(getattr(self, f"dec{i}")(x))
            x = F.relu(upsample_bilinear_2x(x))
        return upsample_bilinear_2x(self.dec_out(x))
