"""Optimizers with the reference's update rules.

Port of ``medt_tpu/training/optimizers.py``. The reference trains with
``torch.optim.Adam(lr, weight_decay=1e-5)`` (reference train.py:111-112):
L2 added to the gradient before the Adam moments, not AdamW — which is
exactly torch's Adam. ``sgd`` mirrors the classification facade
(reference lib/build_optimizer.py:4-11).

Only parameters that require a gradient go to the optimizer: the frozen
gates (``f_qr``, ... with ``requires_grad=False``) are constants, as in
JAX, where they are not parameters at all. A schedule (step -> lr) is
applied by :func:`..state.train_step` before each update.
"""
from __future__ import annotations

from typing import Iterable

import torch


def _trainable(params: Iterable[torch.nn.Parameter]):
    return [p for p in params if p.requires_grad]


def adam_l2(params, lr: float, weight_decay: float = 1e-5, b1: float = 0.9,
            b2: float = 0.999, eps: float = 1e-8) -> torch.optim.Optimizer:
    """torch.optim.Adam semantics (L2 coupled into the gradient)."""
    return torch.optim.Adam(_trainable(params), lr=lr, betas=(b1, b2),
                            eps=eps, weight_decay=weight_decay)


def sgd(params, lr: float, momentum: float = 0.9, weight_decay: float = 0.0,
        nesterov: bool = False) -> torch.optim.Optimizer:
    """torch.optim.SGD semantics."""
    return torch.optim.SGD(_trainable(params), lr=lr, momentum=momentum,
                           weight_decay=weight_decay, nesterov=nesterov)


OPTIMIZER_REGISTRY = {"adam": adam_l2, "sgd": sgd}


def build_optimizer(name: str, params, lr: float, **kwargs):
    return OPTIMIZER_REGISTRY[name](params, lr, **kwargs)
