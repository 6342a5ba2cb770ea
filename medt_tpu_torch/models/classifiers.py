"""The zoo's conv autoencoder (NCHW).

Port of ``ConvAutoencoder`` in ``medt_tpu/models/classifiers.py:89-110``
(reference model_codes.py:2224-2256): a 3-level encoder of stride-2 3x3
convs + BN + ReLU, a decoder of 3x3 convs + BN + bilinear x2 + ReLU, and a
3x3 output conv followed by one more bilinear x2, back at the input size.
The axial-attention classifiers of that module are not ported yet
(ROADMAP.md, section 1, item 5).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import BatchNorm, conv2d, upsample_bilinear_2x


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
