"""Batch normalization over multi-axis feature layouts, torch semantics.

Port of ``medt_tpu/ops/norms.py:46-77``. The attention BNs normalize over
stacked feature layouts — ``bn_similarity`` over (3, g) (or (g,) without
positions) and ``bn_output`` over (g, gp, 2) (or (g, gp)) — which a plain
``nn.BatchNorm*`` cannot express. Parameters are stored flat, exactly as the
reference's ``nn.BatchNorm1d/2d`` store them, and reshaped row-major onto the
feature axes at use: that row-major order *is* the reference's channel
layout (e.g. the per-channel sv/sve interleave of ``bn_output``).

Train mode normalizes with the biased batch variance, computed as JAX
does (E[x^2] - mean^2 in float32, clamped at 0), and pushes the unbiased
variance n/(n-1) into the running estimate with torch's momentum 0.1
(``running = 0.9*running + 0.1*batch``). Statistics are taken and applied
in float32 whatever the activation dtype. In a process group of more than
one rank they are the joint batch's: each rank's per-feature sums and
count are summed over the ranks (:mod:`..parallel.sync`), as JAX's BNs are
synced across the ``data`` axis by construction.
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence, Tuple, Union

import torch
from torch import nn

from ..parallel import sync
from .attn_core import fold_train_affine

Axes = Union[int, Sequence[int]]

MOMENTUM = 0.1
# > 0 while a checkpointed forward is recomputed (frozen_running_stats):
# process-wide, as the recompute runs on autograd's device thread
_FROZEN = [0]


def _canonical_axes(rank: int, axes: Axes) -> Tuple[int, ...]:
    if isinstance(axes, int):
        axes = (axes,)
    return tuple(sorted(a % rank for a in axes))


def _bshape(x: torch.Tensor, feature_axes: Tuple[int, ...]):
    shape = [1] * x.dim()
    for a in feature_axes:
        shape[a] = x.shape[a]
    return shape


def batch_norm_eval(x, weight, bias, mean, var, feature_axes: Axes,
                    eps: float = 1e-5):
    """Eval-mode BN of ``x`` with per-feature parameters over ``feature_axes``.

    The parameters may be flat or already shaped like the features; they
    are read row-major over the feature axes in increasing order."""
    feature_axes = _canonical_axes(x.dim(), feature_axes)
    shape = _bshape(x, feature_axes)
    a, b = fold_train_affine(weight.float(), bias.float(), mean.float(),
                             var.float(), eps)
    y = x.float() * a.reshape(shape) + b.reshape(shape)
    return y.to(x.dtype)


def _train_norm(x, weight, bias, feature_axes: Axes, eps: float):
    """Train-mode BN: ``(y, batch_mean, biased batch_var, count)`` per
    feature. In a process group of more than one rank the per-feature sums
    and the count are summed over the ranks first, so the moments are the
    joint batch's (:mod:`..parallel.sync`)."""
    feature_axes = _canonical_axes(x.dim(), feature_axes)
    reduce = tuple(a for a in range(x.dim()) if a not in feature_axes)
    xf = x.float()
    n = math.prod(x.shape[a] for a in reduce)
    if sync.active():
        sums, n = sync.sum_over_ranks(
            torch.stack([xf.sum(dim=reduce), (xf * xf).sum(dim=reduce)]), n)
        mean = sums[0] / n
        var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
    else:
        mean = xf.mean(dim=reduce)
        var = torch.clamp((xf * xf).mean(dim=reduce) - mean * mean, min=0.0)
    shape = _bshape(x, feature_axes)
    y = (xf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + eps)
    y = y * weight.float().reshape(shape) + bias.float().reshape(shape)
    return y.to(x.dtype), mean, var, n


def batch_norm_train(x, weight, bias, feature_axes: Axes, eps: float = 1e-5):
    """Train-mode BN: ``(y, batch_mean, batch_var_unbiased)``, the moments
    per feature (the joint batch's in a process group); the caller owns the
    running-stat update."""
    y, mean, var, n = _train_norm(x, weight, bias, feature_axes, eps)
    return y, mean, var * (n / max(n - 1.0, 1.0))


@torch.no_grad()
def update_running(running: torch.Tensor, batch: torch.Tensor,
                   momentum: float = MOMENTUM):
    """``running = (1 - momentum)*running + momentum*batch``, in place; a
    no-op under :func:`frozen_running_stats`."""
    if _FROZEN[0]:
        return
    running.mul_(1.0 - momentum).add_(momentum * batch.detach())


@contextlib.contextmanager
def frozen_running_stats():
    """Hold every running statistic: the recompute of a rematerialised
    forward runs the train-mode BNs again, and JAX takes the statistics of
    the first pass only (``batch_stats`` leave the primal)."""
    _FROZEN[0] += 1
    try:
        yield
    finally:
        _FROZEN[0] -= 1


class BatchNorm(nn.Module):
    """Torch-semantics BN with flat reference-named state.

    ``weight``/``bias`` parameters and ``running_mean``/``running_var``
    buffers, each ``(num_features,)`` — the reference's ``state_dict`` keys
    (no ``num_batches_tracked``: nothing here reads it). ``forward`` takes the
    feature axes of the layout it normalizes; the default is NCHW channels.
    """

    def __init__(self, num_features: int, eps: float = 1e-5, *,
                 device=None):
        super().__init__()
        self.num_features = int(num_features)
        self.eps = eps
        f32 = dict(device=device, dtype=torch.float32)
        self.weight = nn.Parameter(torch.ones(num_features, **f32))
        self.bias = nn.Parameter(torch.zeros(num_features, **f32))
        self.register_buffer("running_mean", torch.zeros(num_features, **f32))
        self.register_buffer("running_var", torch.ones(num_features, **f32))

    def affine(self):
        """(a, b), flat: this BN in eval mode is ``a*x + b``."""
        return fold_train_affine(self.weight, self.bias, self.running_mean,
                                 self.running_var, self.eps)

    def forward(self, x, feature_axes: Axes = 1):
        if self.training:
            y, mean, var, n = _train_norm(x, self.weight, self.bias,
                                          feature_axes, self.eps)
            if n == 1:
                # as torch's BatchNorm: no unbiased variance from one value
                # (the joint batch's count in a process group)
                raise ValueError("Expected more than 1 value per channel "
                                 f"when training, got input {tuple(x.shape)}")
            update_running(self.running_mean, mean.reshape(-1))
            update_running(self.running_var,
                           (var * (n / max(n - 1.0, 1.0))).reshape(-1))
            return y
        return batch_norm_eval(x, self.weight, self.bias, self.running_mean,
                               self.running_var, feature_axes, self.eps)
