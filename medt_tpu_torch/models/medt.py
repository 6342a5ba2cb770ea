"""MedT / LoGo — the dual-branch (global + local) axial U-Net (NCHW).

Port of ``medt_tpu/models/medt.py`` (reference axialnet.py:509-711):

* global branch: stem -> layer1 -> layer2 -> decoder4 (+ skip) -> decoder5,
  at full resolution;
* local branch: a full 4-stage axial U-Net over a ``patch_grid`` x
  ``patch_grid`` grid of patches, folded into the batch
  (:func:`space_to_batch`) so it runs once instead of the reference's
  16 sequential passes — identical in eval mode; in train mode its BNs take
  joint batch statistics over all patches, the JAX package's default.
  ``sequential_bn_parity`` (default off, as in JAX) gives the reference's
  train mode exactly (reference axialnet.py:661-700): one local pass per
  patch in row-major order, each normalising with its own batch moments
  and making its own running-statistics update, in sequence;
* fusion: add -> 3x3 ``decoderf`` -> ReLU -> 1x1 ``adjust`` -> raw logits.

Reference quirk kept: the local stem is built after the global stages
changed ``inplanes``, so it is ``imgchan -> int(256*s)*2 -> 128 ->
int(256*s)*2`` wide (reference axialnet.py:557-566).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv2d
from .axial_unet import (GROUPS, LAYERS, S, add_conv_stem, conv_stem,
                         up_block)
from .blocks import AxialStage


def space_to_batch(x: torch.Tensor, grid: int) -> torch.Tensor:
    """(N, C, H, W) -> (N*grid*grid, C, H/grid, W/grid), row-major patches
    with the batch major."""
    n, c, h, w = x.shape
    ph, pw = h // grid, w // grid
    x = x.reshape(n, c, grid, ph, grid, pw).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(n * grid * grid, c, ph, pw)


def batch_to_space(x: torch.Tensor, grid: int) -> torch.Tensor:
    """Inverse of :func:`space_to_batch`."""
    nb, c, ph, pw = x.shape
    n = nb // (grid * grid)
    x = x.reshape(n, grid, grid, c, ph, pw).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(n, c, grid * ph, grid * pw)


class MedTNet(nn.Module):
    """Global + local axial segmentation network emitting raw logits.
    ``global_mode``/``local_mode`` pick the attention variant per branch:
    MedT = ("gated", "wopos"), logo = ("full", "full")."""

    def __init__(self, img_size: int = 128, imgchan: int = 3,
                 num_classes: int = 2, patch_grid: int = 4,
                 global_mode: str = "gated", local_mode: str = "wopos",
                 sequential_bn_parity: bool = False, *,
                 attn: dict, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.sequential_bn_parity = sequential_bn_parity
        s = S
        bottom = img_size // (patch_grid * 2 * 8)
        if bottom < 2:
            raise ValueError(
                f"img_size={img_size} with patch_grid={patch_grid} bottoms "
                f"the local branch at {bottom}px (< 2); use img_size >= "
                f"{patch_grid * 32} or a smaller patch_grid")
        self.patch_grid = patch_grid
        init = dict(generator=generator, device=device)
        planes = [int(128 * s), int(256 * s), int(512 * s), int(1024 * s)]
        g_attn = dict(attn, mode=global_mode)
        l_attn = dict(attn, mode=local_mode)

        # global branch
        add_conv_stem(self, imgchan, int(64 * s), **init)
        self.layer1 = AxialStage(int(64 * s), planes[0], LAYERS[0],
                                 img_size // 2, groups=GROUPS, attn=g_attn,
                                 **init)
        self.layer2 = AxialStage(self.layer1.out_planes, planes[1], LAYERS[1],
                                 img_size // 2, stride=2, groups=GROUPS,
                                 attn=g_attn, **init)
        self.decoder4 = conv2d(int(512 * s), int(256 * s), 3, **init)
        self.decoder5 = conv2d(int(256 * s), int(128 * s), 3, **init)

        # local branch (wide stem: the reference's inplanes quirk)
        inplanes = self.layer2.out_planes
        add_conv_stem(self, imgchan, inplanes, "_p", **init)
        span = img_size // patch_grid // 2
        spans = [span, span, span // 2, span // 4]
        for i, stride in enumerate((1, 2, 2, 2)):
            stage = AxialStage(inplanes, planes[i], LAYERS[i], spans[i],
                               stride=stride, groups=GROUPS, attn=l_attn,
                               **init)
            setattr(self, f"layer{i + 1}_p", stage)
            inplanes = stage.out_planes
        c = [int(1024 * 2 * s), int(1024 * s), int(512 * s), int(256 * s),
             int(128 * s)]
        self.decoder1_p = conv2d(c[0], c[0], 3, stride=2, **init)
        self.decoder2_p = conv2d(c[0], c[1], 3, **init)
        self.decoder3_p = conv2d(c[1], c[2], 3, **init)
        self.decoder4_p = conv2d(c[2], c[3], 3, **init)
        self.decoder5_p = conv2d(c[3], c[4], 3, **init)

        # fusion
        self.decoderf = conv2d(c[4], c[4], 3, **init)
        self.adjust = conv2d(c[4], num_classes, 1, padding=0, **init)

    def forward(self, x):
        g = conv_stem(self, x)
        g1 = self.layer1(g)
        g2 = self.layer2(g1)
        g = up_block(self.decoder4, g2) + g1
        g = up_block(self.decoder5, g)

        xp = space_to_batch(x, self.patch_grid)
        if self.sequential_bn_parity and self.training:
            # patch p of every image is xp[b*P + p]: one pass per patch
            grid2 = self.patch_grid ** 2
            per_patch = xp.reshape(-1, grid2, *xp.shape[1:])
            outs = [self._local(per_patch[:, p]) for p in range(grid2)]
            d = torch.stack(outs, dim=1).reshape(-1, *outs[0].shape[1:])
        else:
            d = self._local(xp)
        x_loc = batch_to_space(d, self.patch_grid)

        fused = F.relu(self.decoderf(g + x_loc))
        return self.adjust(F.relu(fused))

    def _local(self, xp):
        """The local branch on a batch of patches."""
        p = conv_stem(self, xp, "_p")
        p1 = self.layer1_p(p)
        p2 = self.layer2_p(p1)
        p3 = self.layer3_p(p2)
        p4 = self.layer4_p(p3)
        d = up_block(self.decoder1_p, p4) + p4
        d = up_block(self.decoder2_p, d) + p3
        d = up_block(self.decoder3_p, d) + p2
        d = up_block(self.decoder4_p, d) + p1
        return up_block(self.decoder5_p, d)
