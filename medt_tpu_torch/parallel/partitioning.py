"""Which tensors of an attention layer the model axis cuts, and how.

Port of ``medt_tpu/parallel/partitioning.py``. The model axis splits the
attention groups (heads) of every ``AxialAttention`` whose group count it
divides; rank ``index`` of ``tp`` holds groups ``index * g/tp`` to
``(index + 1) * g/tp - 1``. The layer's channel layouts are group-major,
so each cut tensor is cut along its first dimension, by these rows
(:func:`attention_rows`):

* ``qkv_transform.weight`` ``(2*out, in, 1)`` and ``bn_qkv`` ``(2*out,)``:
  the ``2*gp`` channels of each group, contiguous;
* ``bn_similarity``: ``(3, g)`` row-major (qk, qr, kr of every group), so a
  rank's channels are the strided set ``t*g + j``; ``(g,)`` without
  positions;
* ``bn_output``: ``(g, gp, 2)`` (or ``(g, gp)`` without positions),
  contiguous.

Everything else is replicated on every rank of the axis: the relative
position table ``relative`` ``(2gp, 2*span-1)`` that every group shares,
the gates, the data gates' ``gate_fc*``, and every conv, stem and decoder.

:func:`shard_state_dict` cuts a one-card state dict for a rank of a model
with split layers, :func:`gather_state_dict` puts the ranks' parts back
together (a collective over each layer's model group), so a checkpoint is
a one-card state dict whatever the mesh, as JAX's global arrays are.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

# the tensors of a split layer that the model axis cuts, by their module
CUT_MODULES = ("qkv_transform", "bn_qkv", "bn_similarity", "bn_output")


def attention_rows(key: str, groups: int, gp: int, has_pos: bool, tp: int,
                   index: int) -> Optional[torch.Tensor]:
    """The rows of a one-card attention layer's tensor ``key`` (its name
    in the layer: ``"bn_qkv.weight"``, ...) that rank ``index`` of ``tp``
    holds, or None for a replicated tensor."""
    module = key.split(".")[0]
    if module not in CUT_MODULES:
        return None
    local = groups // tp
    first = torch.arange(local) + index * local
    if module == "bn_similarity":
        if not has_pos:
            return first
        return torch.cat([t * groups + first for t in range(3)])
    per_group = {"qkv_transform": 2 * gp, "bn_qkv": 2 * gp,
                 "bn_output": 2 * gp if has_pos else gp}[module]
    return (first[:, None] * per_group
            + torch.arange(per_group)[None, :]).reshape(-1)


def split_layers(model: nn.Module) -> Iterator[Tuple[str, nn.Module]]:
    """``(name, layer)`` of every attention layer of ``model`` that the
    model axis splits."""
    for name, module in model.named_modules():
        if getattr(module, "model_axis", None) is not None:
            yield name, module


def cut_tensors(model: nn.Module) -> Dict[str, Tuple[str, nn.Module]]:
    """``state dict key -> (its key in the layer, the layer)`` for every
    tensor of ``model`` that the model axis cuts."""
    out = {}
    for name, layer in split_layers(model):
        prefix = f"{name}." if name else ""
        for key, _ in list(layer.named_parameters()) + list(
                layer.named_buffers()):
            if key.split(".")[0] in CUT_MODULES:
                out[prefix + key] = (key, layer)
    return out


def layer_rows(layer: nn.Module, key: str, index: int) -> torch.Tensor:
    """The rows of the split ``layer``'s tensor ``key`` that rank
    ``index`` of its model axis holds."""
    return attention_rows(key, layer.full_groups, layer.gp, layer.has_pos,
                          layer.model_axis.size, index)


def shard_state_dict(state_dict: Mapping[str, torch.Tensor],
                     model: nn.Module) -> dict:
    """A one-card state dict cut for this rank of ``model`` (whose split
    layers know their rank); a model with none takes it as it is."""
    cut = cut_tensors(model)
    out = {}
    for key, value in state_dict.items():
        if key in cut:
            local, layer = cut[key]
            value = value[layer_rows(layer, local, layer.model_axis.index)
                          .to(value.device)]
        out[key] = value
    return out


def gather_state_dict(model: nn.Module,
                      tensors: Optional[Mapping[str, torch.Tensor]] = None
                      ) -> dict:
    """``tensors`` (default: ``model.state_dict()``; any dict under its
    keys, such as its gradients) with every cut tensor put back together
    from the ranks of its layer's model group, in the one-card shape. Every
    rank of the group calls it, with the same keys."""
    tensors = model.state_dict() if tensors is None else tensors
    cut = cut_tensors(model)
    out = {}
    for key, value in tensors.items():
        if key not in cut:
            out[key] = value
            continue
        local, layer = cut[key]
        axis = layer.model_axis
        parts = [torch.empty_like(value) for _ in range(axis.size)]
        dist.all_gather(parts, value.contiguous(), group=axis.group)
        full = value.new_empty((value.shape[0] * axis.size,)
                               + tuple(value.shape[1:]))
        for index, part in enumerate(parts):
            full[layer_rows(layer, local, index).to(full.device)] = part
        out[key] = full
    return out
