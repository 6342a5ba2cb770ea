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

Data parallel (a model wrapped in ``DistributedDataParallel``, one rank per
device, each with its rows of the global batch): the step computes the
one-process step on the joint batch, as JAX's step under its mesh does.
It runs its forward and backward inside ``sync.data_parallel_step``, so
the BNs and the similarity-BN moments take the joint batch's statistics
(:mod:`..parallel.sync`); each rank's loss is its rows' part of the joint
batch's loss, and the backward runs on that part times the world size, so
DDP's average of the ranks' gradients is the joint loss's gradient. The
returned loss is summed over the ranks: the joint batch's, on every rank.
Under ``remat`` the recompute (which syncs its BN statistics again, in the
same order on every rank) runs under DDP's ``no_sync``, so DDP's bucket
bookkeeping sees one forward a step.

Under a mesh with a model axis (``TrainState.mesh``, :mod:`..parallel.
mesh`), :func:`data_parallel` splits the attention layers by group over
the model axis and wraps the model in DDP over the data axis alone (not
at all when the data axis has one rank); the ranks of one data index step
on the same rows, the statistics and the loss are summed over the data
axis, and after the backward the gradients of the replicated parameters
used inside the split layers are summed over the model axis
(``kernel_sharding.sum_partial_grads``) before the update.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Callable, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel
from torch.utils.checkpoint import checkpoint

from ..losses import deep_supervision_loss, log_nll_loss
from ..ops.norms import frozen_running_stats
from ..parallel import sync
from ..parallel.kernel_sharding import shard_model, sum_partial_grads
from ..parallel.mesh import Mesh


@dataclass
class TrainState:
    """The model (its parameters and BN statistics), the optimizer over its
    trainable parameters, the count of steps taken, an optional ``step ->
    lr`` schedule, and the mesh :func:`data_parallel` laid the model over
    (None: the default process group's data axis, or one process)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    schedule: Optional[Callable[[int], float]] = None
    mesh: Optional[Mesh] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def module(self) -> nn.Module:
        """The model itself, out of its ``DistributedDataParallel``
        wrapper if it has one (what validation and checkpoints use)."""
        return unwrap(self.model)


def data_parallel(model: nn.Module, mesh: Optional[Mesh] = None
                  ) -> nn.Module:
    """``model`` (its weights one-card, the same on every rank) laid over
    ``mesh``: its attention layers split over the model axis
    (``kernel_sharding.shard_model``) when it has more than one rank, then
    wrapped in ``DistributedDataParallel`` over the data axis when that
    has more than one rank, else ``model`` itself. Without a mesh, the
    data axis is the default process group. Buffers are not broadcast
    before each forward: the synced running statistics are equal on every
    rank already. (``broadcast_buffers`` is the keyword both torch 2.11,
    on the card, and 2.13 take; 2.13 warns that it prefers
    ``forward_sync_buffers``.)"""
    if mesh is not None and mesh.tp > 1:
        shard_model(model, mesh.model_axis())
    if (mesh.dp if mesh is not None else _group_size()) <= 1:
        return model
    device = next(model.parameters()).device
    ids = [device.index] if device.type == "cuda" else None
    return DistributedDataParallel(
        model, device_ids=ids, broadcast_buffers=False,
        process_group=mesh.data_group if mesh is not None else None)


def unwrap(model: nn.Module) -> nn.Module:
    """``model`` out of its ``DistributedDataParallel`` wrapper."""
    return model.module if isinstance(model, DistributedDataParallel) \
        else model


def _group_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


def data_world(model: nn.Module, mesh: Optional[Mesh] = None) -> int:
    """The ranks of the data axis a step of ``model`` spans: the size of a
    DDP model's process group, else 1. A bare model on a data axis of more
    than one rank (the mesh's, or the default group without a mesh) would
    step on its own rows' gradient alone, so it raises."""
    if isinstance(model, DistributedDataParallel):
        return torch.distributed.get_world_size(model.process_group)
    if (mesh.dp if mesh is not None else _group_size()) > 1:
        raise ValueError("on a data axis of more than one rank the model "
                         "must be wrapped in DistributedDataParallel")
    return 1


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


@contextlib.contextmanager
def _recompute(model: nn.Module):
    """The recompute holds the running statistics and, for a DDP model,
    runs under ``no_sync`` (its forward would otherwise reset DDP's
    bookkeeping inside the backward)."""
    with frozen_running_stats():
        if isinstance(model, DistributedDataParallel):
            with model.no_sync():
                yield
        else:
            yield


def _recompute_contexts(model: nn.Module):
    """checkpoint's (forward, recompute) contexts."""
    return contextlib.nullcontext(), _recompute(model)


def train_step(state: TrainState, batch: Mapping, *, remat: bool = False,
               joint_rows: Optional[int] = None) -> dict:
    """One optimization step on ``batch = {"image": (N, H, W, C) uint8 or
    float, "label": (N, H, W) int}``. Updates ``state`` in place and
    returns ``{"loss": <0-d device tensor>}``. ``remat`` recomputes the
    forward in the backward (JAX's ``remat``). For a DDP model in a group
    of more than one rank, ``batch`` is this rank's rows and
    ``joint_rows`` the joint batch's row count (every rank's together);
    the ranks of one data index pass the same rows."""
    model, device = state.model, state.device
    world = data_world(model, state.mesh)
    group = state.mesh.data_group if state.mesh is not None else None
    if world == 1:
        step = contextlib.nullcontext()
    elif joint_rows is None:
        raise ValueError("a data-parallel step needs joint_rows, the rows "
                         "of the joint batch")
    else:
        step = sync.data_parallel_step(len(batch["image"]), joint_rows,
                                       group)
    model.train()
    with step:
        image = normalize(batch["image"], device)
        if remat:
            out = checkpoint(model, image, use_reentrant=False,
                             context_fn=functools.partial(
                                 _recompute_contexts, model))
        else:
            out = model(image)
        labels = _labels(batch["label"], device)
        if isinstance(out, tuple):  # deep supervision: (logits, aux heads)
            loss = deep_supervision_loss(out, labels)
        else:
            loss = log_nll_loss(out, labels)
        state.optimizer.zero_grad(set_to_none=True)
        # DDP averages the ranks' gradients; each loss is a part of the
        # joint one
        (loss * world if world > 1 else loss).backward()
    sum_partial_grads(state.module)
    if state.schedule is not None:
        lr = float(state.schedule(state.step))
        for group in state.optimizer.param_groups:
            group["lr"] = lr
    state.optimizer.step()
    state.step += 1
    loss = loss.detach()
    return {"loss": sync.all_reduce_sum(loss, group) if world > 1 else loss}


def eval_step(state: TrainState, batch: Mapping) -> torch.Tensor:
    """Forward on the running BN statistics: raw NCHW logits (of the model
    out of its DDP wrapper, on this process alone). The model's train/eval
    mode is restored afterwards."""
    model = state.module
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return model(normalize(batch["image"], state.device))
    finally:
        model.train(was_training)
