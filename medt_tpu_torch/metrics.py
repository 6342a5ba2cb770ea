"""Decoding logits into masks.

Port of ``logits_to_foreground`` (``medt_tpu/metrics.py:100-112``), on NCHW
logits. The rest of the metrics module comes with a later slice
(ROADMAP.md, 'Port: sliding window, serve CLI, data, metrics sweep, DDP,
zoo').
"""
from __future__ import annotations

import torch


def logits_to_foreground(logits: torch.Tensor, threshold: float = 0.5,
                         mode: str = "threshold") -> torch.Tensor:
    """(N, C, H, W) logits -> (N, H, W) int32 foreground map.

    ``threshold`` reproduces the reference's quirk of thresholding the RAW
    logit of channel 1 at 0.5 (reference train.py:188-213, test.py:109-146);
    ``argmax`` is the corrected decision rule."""
    if mode == "threshold":
        return (logits[:, 1] >= threshold).to(torch.int32)
    if mode == "argmax":
        return torch.argmax(logits, dim=1).to(torch.int32)
    raise ValueError(mode)
