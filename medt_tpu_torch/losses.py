"""Segmentation and classification losses.

Port of ``medt_tpu/losses.py:16-82``. ``log_nll_loss`` is the reference's
``LogNLLLoss``, which despite its name is plain mean cross-entropy on raw
logits (its log line is commented out, reference metrics.py:9-20). Logits
are NCHW here (the port's layout), labels (N, H, W) integers. The
classification losses (the label-smoothed cross-entropy of reference
lib/utils.py:33-55) take (N, classes) logits and (N,) labels, computed in
float32 as JAX computes them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .parallel import sync


def log_nll_loss(logits: torch.Tensor, labels: torch.Tensor,
                 weight: Optional[Sequence[float]] = None,
                 ignore_index: int = -100) -> torch.Tensor:
    """Mean cross-entropy over all pixels, ``F.cross_entropy`` semantics:
    with ``weight`` the mean is ``sum(w_y * ce) / sum(w_y)``; pixels
    labelled ``ignore_index`` drop out. Computed as the JAX function does,
    with a one-hot pick, which also fixes what happens to a label outside
    ``0..classes-1`` (``F.cross_entropy`` raises on one): its one-hot row is
    zero, so without ``weight`` it adds its logsumexp to the mean at weight
    1, and with ``weight`` its weight is 0 and it drops out.

    In a process group of more than one rank the normaliser (the pixel
    count, or the sum of class weights) is the joint batch's, so each rank
    returns its rows' part of the joint batch's loss (a rank with no rows:
    an exact 0 that stays in the graph), and the parts sum to it."""
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
    norm = w.sum()
    if sync.active():   # the joint batch's normaliser: this rank's share
        norm = sync.all_reduce_sum(norm, sync.step_group())
    return (ce * w).sum() / torch.clamp(norm, min=1e-12)


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


def label_smoothing(logits: torch.Tensor, labels: torch.Tensor,
                    eta: float = 0.1) -> torch.Tensor:
    """One-hot targets smoothed to ``(1 - eta) + eta / C`` on the label and
    ``eta / C`` elsewhere, float32 (reference lib/utils.py:33-46)."""
    n_classes = logits.shape[-1]
    onehot = F.one_hot(labels.long(), n_classes).float()
    return onehot * (1.0 - eta) + eta / n_classes


def cross_entropy_for_onehot(logits: torch.Tensor,
                             target: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of ``-sum(target * log_softmax(logits))``
    (reference lib/utils.py:49-50)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.mean(torch.sum(-target * logp, dim=-1))


def cross_entropy_with_label_smoothing(logits: torch.Tensor,
                                       labels: torch.Tensor,
                                       eta: float = 0.1) -> torch.Tensor:
    return cross_entropy_for_onehot(logits,
                                    label_smoothing(logits, labels, eta))
