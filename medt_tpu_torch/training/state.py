"""Train state and the train/eval steps.

Port of ``medt_tpu/training/state.py:57-116``: one :func:`train_step` runs
the forward in train mode (BN on batch statistics, running statistics
updated in place), the loss, the backward, the schedule and the optimizer
update. Metrics stay on the device: nothing in the step waits for the card
(no ``.item()``, no host copy), as in JAX, where the reference's
per-step ``.cpu().numpy()`` (train.py:142-149) is exactly the sync a
device loop must not make.

``train_step(..., remat=True)`` is JAX's ``jax.checkpoint(forward)``: the
whole model forward runs under ``torch.utils.checkpoint`` (non-reentrant),
so the backward recomputes it from the input instead of keeping its
activations. The recompute runs the train-mode BNs a second time on the
same batch; it holds the running statistics (``frozen_running_stats``),
so they take one update a step, as in JAX.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..losses import deep_supervision_loss, log_nll_loss
from ..ops.norms import frozen_running_stats


@dataclass
class TrainState:
    """The model (its parameters and BN statistics), the optimizer over its
    trainable parameters, the count of steps taken and an optional
    ``step -> lr`` schedule."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    schedule: Optional[Callable[[int], float]] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def normalize(image, device) -> torch.Tensor:
    """NHWC uint8 (or float) images -> NCHW float32 on ``device``; uint8 is
    moved as bytes and divided by 255 there."""
    if isinstance(image, np.ndarray):
        image = torch.from_numpy(np.ascontiguousarray(image))
    image = image.to(device, non_blocking=True)
    if image.dtype == torch.uint8:
        image = image.float() / 255.0
    return image.float().permute(0, 3, 1, 2)


def _labels(label, device) -> torch.Tensor:
    if isinstance(label, np.ndarray):
        label = torch.from_numpy(np.ascontiguousarray(label))
    return label.to(device, non_blocking=True)


def _recompute_contexts():
    """checkpoint's (forward, recompute) contexts: the recompute holds the
    running statistics."""
    return contextlib.nullcontext(), frozen_running_stats()


def train_step(state: TrainState, batch: Mapping, *,
               remat: bool = False) -> dict:
    """One optimization step on ``batch = {"image": (N, H, W, C) uint8 or
    float, "label": (N, H, W) int}``. Updates ``state`` in place and
    returns ``{"loss": <0-d device tensor>}``. ``remat`` recomputes the
    forward in the backward (JAX's ``remat``)."""
    model, device = state.model, state.device
    model.train()
    image = normalize(batch["image"], device)
    if remat:
        out = checkpoint(model, image, use_reentrant=False,
                         context_fn=_recompute_contexts)
    else:
        out = model(image)
    labels = _labels(batch["label"], device)
    if isinstance(out, tuple):  # deep supervision: (logits, aux heads)
        loss = deep_supervision_loss(out, labels)
    else:
        loss = log_nll_loss(out, labels)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if state.schedule is not None:
        lr = float(state.schedule(state.step))
        for group in state.optimizer.param_groups:
            group["lr"] = lr
    state.optimizer.step()
    state.step += 1
    return {"loss": loss.detach()}


def eval_step(state: TrainState, batch: Mapping) -> torch.Tensor:
    """Forward on the running BN statistics: raw NCHW logits. The model's
    train/eval mode is restored afterwards."""
    model = state.model
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return model(normalize(batch["image"], state.device))
    finally:
        model.train(was_training)
