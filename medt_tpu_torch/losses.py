"""Segmentation losses.

Port of ``medt_tpu/losses.py:16-66``. ``log_nll_loss`` is the reference's
``LogNLLLoss``, which despite its name is plain mean cross-entropy on raw
logits (its log line is commented out, reference metrics.py:9-20). Logits
are NCHW here (the port's layout), labels (N, H, W) integers.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def log_nll_loss(logits: torch.Tensor, labels: torch.Tensor,
                 weight: Optional[Sequence[float]] = None,
                 ignore_index: int = -100) -> torch.Tensor:
    """Mean cross-entropy over all pixels, ``F.cross_entropy`` semantics:
    with ``weight`` the mean is ``sum(w_y * ce) / sum(w_y)``; pixels
    labelled ``ignore_index`` drop out. Computed as the JAX function does,
    with a one-hot pick, which also fixes what happens to a label outside
    ``0..classes-1`` (``F.cross_entropy`` raises on one): its one-hot row is
    zero, so without ``weight`` it adds its logsumexp to the mean at weight
    1, and with ``weight`` its weight is 0 and it drops out."""
    logits = logits.float()
    labels = labels.long()  # uint8 labels must not wrap in the compare
    n_classes = logits.shape[1]
    onehot = F.one_hot(labels.clamp(0, n_classes - 1), n_classes)
    inside = (labels >= 0) & (labels < n_classes)
    onehot = (onehot * inside[..., None]).permute(0, 3, 1, 2).float()
    ce = torch.logsumexp(logits, dim=1) - (logits * onehot).sum(dim=1)
    valid = (labels != ignore_index).float()
    if weight is not None:
        w = torch.as_tensor(weight, dtype=torch.float32, device=logits.device)
        w = (onehot * w[None, :, None, None]).sum(dim=1) * valid
    else:
        w = valid
    return (ce * w).sum() / torch.clamp(w.sum(), min=1e-12)


def deep_supervision_loss(outputs, labels: torch.Tensor,
                          aux_weight: float = 0.4,
                          weight: Optional[Sequence[float]] = None,
                          ignore_index: int = -100) -> torch.Tensor:
    """Main cross-entropy plus ``aux_weight`` times the mean of the per-scale
    auxiliary ones. ``outputs`` is ``(logits, aux_heads)``; each auxiliary
    head is scored against the label nearest-downsampled to its size."""
    logits, aux = outputs
    loss = log_nll_loss(logits, labels, weight, ignore_index)
    if not aux:
        return loss
    aux_total = 0.0
    for a in aux:
        f = labels.shape[1] // a.shape[2]
        lab = labels[:, ::f, ::f] if f > 1 else labels
        aux_total = aux_total + log_nll_loss(a, lab, weight, ignore_index)
    return loss + aux_weight * aux_total / len(aux)
