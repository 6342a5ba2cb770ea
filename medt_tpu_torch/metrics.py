"""Segmentation metrics and the decoding of logits into masks.

Port of ``medt_tpu/metrics.py:18-148``: PyTorch versions of the reference's
Python metrics (reference metrics.py:23-91) and of its offline MATLAB
grading (``performancemetrics_*.m``). Logits and outputs are NCHW here (the
port's layout; the JAX functions take NHWC); labels are (N, H, W) integer
maps. The functions run on whatever device their inputs lie on.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

EPSILON = 1e-32


def _onehot_nchw(gt: torch.Tensor, n_classes: int, dtype) -> torch.Tensor:
    return F.one_hot(gt.long(), n_classes).permute(0, 3, 1, 2).to(dtype)


def classwise_iou(output: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Soft IoU per class over raw NCHW outputs (reference metrics.py:23-35:
    intersection = output * onehot(gt), no argmax — a quirk kept)."""
    onehot = _onehot_nchw(gt, output.shape[1], output.dtype)
    axes = (0, 2, 3)
    intersection = (output * onehot).sum(dim=axes)
    union = (output + onehot).sum(dim=axes) - intersection
    return (intersection + EPSILON) / (union + EPSILON)


def classwise_f1(output: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-class F1 of the argmax over the NCHW class axis (reference
    metrics.py:38-57)."""
    eps = 1e-20
    n_classes = output.shape[1]
    pred_oh = _onehot_nchw(torch.argmax(output, dim=1), n_classes,
                           torch.float32)
    gt_oh = _onehot_nchw(gt, n_classes, torch.float32)
    axes = (0, 2, 3)
    tp = (pred_oh * gt_oh).sum(dim=axes)
    selected = pred_oh.sum(dim=axes)
    relevant = gt_oh.sum(dim=axes)
    precision = (tp + eps) / (selected + eps)
    recall = (tp + eps) / (relevant + eps)
    return 2 * precision * recall / (precision + recall)


def jaccard_index(output, gt, weights=None):
    """Kept for API parity: the reference's weighted wrapper computes
    weights, ignores them and returns the classwise scores (reference
    metrics.py:60-91)."""
    del weights
    return classwise_iou(output, gt)


def f1_score(output, gt, weights=None):
    del weights
    return classwise_f1(output, gt)


def accuracy(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy of (N, classes) scores (reference lib/utils.py:58-61)."""
    pred = torch.argmax(output, dim=1)
    return (pred == target).float().mean()


def binary_seg_scores(pred_fg: torch.Tensor, gt_fg: torch.Tensor,
                      empty_score_one: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-image (F1, IoU, pixel accuracy) of the foreground class, the
    MATLAB grading protocol (reference performancemetrics_glas.m:30-88):
    F1 = 2tp / (2tp + fp + fn), IoU = tp / union, accuracy tp / (tp + fp).
    ``empty_score_one`` scores images with tp == 0 as 1.0, as the original
    scripts do (glas.m:72-76). ``pred_fg``/``gt_fg``: (N, H, W) boolean or
    {0, 1} maps; returns three (N,) tensors."""
    pred = pred_fg.float()
    gt = gt_fg.float()
    axes = (1, 2)
    tp = (pred * gt).sum(dim=axes)
    fp = (pred * (1 - gt)).sum(dim=axes)
    fn = ((1 - pred) * gt).sum(dim=axes)
    union = tp + fp + fn
    f1 = 2 * tp / torch.clamp(2 * tp + fp + fn, min=1e-12)
    iou = tp / torch.clamp(union, min=1e-12)
    pa = tp / torch.clamp(tp + fp, min=1e-12)
    if empty_score_one:
        empty = tp == 0
        f1, iou, pa = (torch.where(empty, torch.ones_like(t), t)
                       for t in (f1, iou, pa))
    return f1, iou, pa


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
