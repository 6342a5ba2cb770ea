"""Pooling and resampling (NCHW).

Port of ``medt_tpu/ops/pooling.py:15-32``: average pooling with window ==
stride (the reference's ``nn.AvgPool2d(stride, stride)`` after a strided
axial attention) and bilinear x2 upsampling with half-pixel centers
(``align_corners=False``, the reference decoder's ``F.interpolate``); and
the classifiers' stem pool, JAX's ``nn.max_pool((3, 3), (2, 2), ((1, 1),
(1, 1)))``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def avg_pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Average pool with window == stride, accumulated in float32."""
    return F.avg_pool2d(x.float(), stride, stride).to(x.dtype)


def upsample_bilinear_2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 upsample, ``align_corners=False``."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 max pool, stride 2, padding 1 (padded values never win), as the
    ResNet and axial-classifier stems pool."""
    return F.max_pool2d(x, 3, stride=2, padding=1)
