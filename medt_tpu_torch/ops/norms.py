"""Eval-mode batch normalization over multi-axis feature layouts.

Port of ``medt_tpu/ops/norms.py:68-77``. The attention BNs normalize over
stacked feature layouts — ``bn_similarity`` over (3, g) (or (g,) without
positions) and ``bn_output`` over (g, gp, 2) (or (g, gp)) — which a plain
``nn.BatchNorm*`` cannot express. Parameters are stored flat, exactly as the
reference's ``nn.BatchNorm1d/2d`` store them, and reshaped row-major onto the
feature axes at use: that row-major order *is* the reference's channel
layout (e.g. the per-channel sv/sve interleave of ``bn_output``).

Statistics are applied in float32 whatever the activation dtype. Train mode
(batch statistics, running-stat updates) belongs to the training slice of
the port and raises here.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
from torch import nn

from .attn_core import fold_train_affine

Axes = Union[int, Sequence[int]]

TRAIN_BN_TODO = ("train-mode BatchNorm is not ported yet (ROADMAP.md, "
                 "'Port: training slice')")


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
            raise NotImplementedError(TRAIN_BN_TODO)
        return batch_norm_eval(x, self.weight, self.bias, self.running_mean,
                               self.running_var, feature_axes, self.eps)
