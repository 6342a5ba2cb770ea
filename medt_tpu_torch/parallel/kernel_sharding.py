"""The model axis: attention layers split by group over ranks.

Port of ``medt_tpu/parallel/kernel_sharding.py`` for its ``model`` axis.
JAX runs each attention core as a ``shard_map`` island: every device runs
the same kernel on its local ``(g/tp, S)`` block, no collective inside the
kernel, and XLA's collectives around it. The port does the same with one
process a rank. A split layer (:func:`shard_model`) holds only its own
``g/tp`` groups (:mod:`.partitioning`) and computes them with the same
kernels at the local geometry. Around them, the region:

* :func:`copy_in`: the layer's input is replicated over the model axis, so
  going forward it is the identity; going backward each rank's input
  gradient covers only its groups' channels, and the ranks' parts are
  summed over the model group;
* :func:`gather_out`: going forward the ranks' output channels are
  gathered (group-major, so concatenated in rank order); going backward
  each rank takes its own channels of the gradient, which every rank of
  the model group computed alike from the replicated layers after it;
* :func:`sum_partial_grads`: the replicated parameters used inside the
  region (``relative``, the trainable gates, ``gate_fc*``) get only their
  own groups' part of the gradient on each rank; their gradients are summed
  over the model group before the optimizer's update, so every rank of
  the axis holds them bit-equal (in JAX, ``shard_map`` sums these
  cotangents: its ``_TABLE = P()``).

A layer whose group count the axis does not divide stays whole on every
rank, with no collective, as JAX drops its mesh there (``g % tp``,
``medt_tpu/ops/axial_attention.py:437-440``). The statistics of a split
layer are its own groups', summed over the data axis alone
(:mod:`.sync`).

The axis belongs to each split layer (``layer.model_axis``), not to the
process: JAX keeps its kernel mesh in module state and guards it with
``kernel_mesh_scope`` so that an in-process caller does not inherit it; a
layer the port did not split computes whole, whatever ran before it.
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist
from torch import nn

from .mesh import ModelAxis
from .partitioning import CUT_MODULES, split_layers


def splits(groups: int, tp: int) -> bool:
    """Whether the model axis of ``tp`` ranks splits a layer of ``groups``
    groups (JAX's rule: else the layer runs whole)."""
    return tp > 1 and groups % tp == 0


class CopyIn(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        total = grad.contiguous().clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=ctx.group)
        return total, None


class GatherOut(torch.autograd.Function):
    """The ranks' parts along ``dim`` gathered in rank order; the gradient
    cut back to this rank's part."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis, ctx.size = dim, axis, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(parts, x, group=axis.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        part = grad.narrow(ctx.dim, ctx.axis.index * ctx.size, ctx.size)
        return part.contiguous(), None, None


def copy_in(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Enter a split layer: ``x`` as it is, its gradient summed over the
    model group."""
    return CopyIn.apply(x, axis.group)


def gather_out(x: torch.Tensor, axis: ModelAxis, dim: int = 1
               ) -> torch.Tensor:
    """Leave a split layer: the ranks' channels gathered along ``dim``."""
    return GatherOut.apply(x, dim, axis)


def shard_model(model: nn.Module, axis: ModelAxis) -> List[str]:
    """Split every attention layer of ``model`` (its weights one-card, the
    same on every rank) whose group count ``axis`` divides: each keeps this
    rank's groups. Returns the names of the layers it split; the others
    stay whole. Split before the optimizer and any DDP wrapper take the
    parameters."""
    from ..ops.axial_attention import AxialAttention

    names = []
    for name, module in model.named_modules():
        if isinstance(module, AxialAttention) \
                and splits(module.groups, axis.size):
            module.split_groups(axis)
            names.append(name)
    return names


def partial_grad_params(model: nn.Module) -> List[nn.Parameter]:
    """The trainable replicated parameters used inside the split layers
    of ``model``: each rank's gradient of them is its own groups' part."""
    params = []
    for _, layer in split_layers(model):
        for key, p in layer.named_parameters():
            if p.requires_grad and key.split(".")[0] not in CUT_MODULES:
                params.append(p)
    return params


def sum_partial_grads(model: nn.Module):
    """Sum the gradients of :func:`partial_grad_params` over the model
    group, in one collective. Every rank of the group calls it after the
    backward and before the optimizer's update."""
    params = partial_grad_params(model)
    if not params:
        return
    group = next(split_layers(model))[1].model_axis.group
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p).clone()
        offset += p.numel()
