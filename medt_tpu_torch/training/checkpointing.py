"""Checkpoints with ``torch.save``.

Port of ``medt_tpu/training/checkpointing.py`` (Orbax in JAX):

* ``save_checkpoint`` writes ``<direc>/<name>/ckpt.pth`` and a rolling
  ``<direc>/final_model/ckpt.pth`` (reference train.py:216-217), holding the
  model's reference-format state dict, the optimizer state (when given) and
  the step;
* ``latest_checkpoint`` finds the newest numeric epoch directory under
  ``<direc>`` (or ``final_model`` when there is none), for resuming;
* ``restore_checkpoint`` reads such a file, or a reference ``.pth`` file (a
  bare state dict, ``torch.save(model.state_dict())``): DataParallel's
  ``module.`` prefix is stripped (reference lib/utils.py:163-167; JAX
  ``utils/torch_import.py:40``) and the keys nothing computes with are
  dropped (:func:`..utils.weights.is_dead_reference_key`), then the model
  loads it with ``strict=True``.

Data parallel: the coordinator (rank 0) alone writes, the module out of its
``DistributedDataParallel`` wrapper, so the keys carry no ``module.``
prefix, and every rank waits at a barrier until the file is there; every
rank restores onto its own card. A checkpoint of a data-parallel run loads
into a one-card run and the reverse, as JAX's Orbax checkpoints are
parallelism-agnostic. Under a mesh's model axis the ranks of each data
index gather their split attention layers' parts (parameters, statistics
and the optimizer's state) into the one-card state dict first
(:func:`..parallel.gather_state_dict`), so the file is a one-card run's in
the reference's key naming; restoring cuts it again for each rank
(:func:`..parallel.shard_state_dict`).
"""
from __future__ import annotations

import os
from typing import Mapping, Optional

import torch
from torch import nn

from ..parallel.distributed import barrier, is_coordinator
from ..parallel.partitioning import (
    cut_tensors,
    gather_state_dict,
    shard_state_dict,
)
from ..utils.weights import is_dead_reference_key
from .state import unwrap

FINAL_NAME = "final_model"
CKPT_FILE = "ckpt.pth"
_FORMAT = "medt_tpu_torch.checkpoint/1"


def _write(path: str, payload: dict):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)   # a reader never sees half a file


def _optimizer_cut(optimizer: torch.optim.Optimizer, model: nn.Module,
                   state: dict) -> dict:
    """``(index in the optimizer's state, field) -> state dict key`` of
    every tensor of ``state`` (an optimizer state dict) kept per element
    of a parameter the model axis cuts (Adam's moments, SGD's momentum;
    not the step count)."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    cut = cut_tensors(model)
    names = {id(p): k for k, p in model.named_parameters() if k in cut}
    return {(index, field): names[id(params[index])]
            for index, fields in state["state"].items()
            if id(params[index]) in names
            for field, value in fields.items()
            if torch.is_tensor(value) and value.dim()}


def _map_optimizer(optimizer, model, state: dict, fn) -> dict:
    """``state`` (an optimizer state dict) with ``fn({key: tensor})``
    applied to its tensors of cut parameters, field by field."""
    cut = _optimizer_cut(optimizer, model, state)
    out = {**state, "state": {i: dict(f) for i, f in state["state"].items()}}
    for field in sorted({f for _, f in cut}):
        mine = {(i, f): k for (i, f), k in cut.items() if f == field}
        mapped = fn({k: state["state"][i][f] for (i, f), k in mine.items()})
        for (i, f), k in mine.items():
            out["state"][i][f] = mapped[k]
    return out


def save_checkpoint(direc: str, name, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None, *,
                    step: int = 0, also_final: bool = True) -> str:
    """Save under ``<direc>/<name>/ckpt.pth`` (and ``final_model``);
    returns the path. In a process group every rank calls it: the ranks of
    a split model gather its parts, the coordinator writes, the others
    wait for it."""
    path = os.path.join(os.path.abspath(direc), str(name), CKPT_FILE)
    model = unwrap(model)
    split = bool(cut_tensors(model))
    state_dict = gather_state_dict(model) if split else None
    opt_state = None
    if optimizer is not None:
        opt_state = optimizer.state_dict()
        if split:
            opt_state = _map_optimizer(
                optimizer, model, opt_state,
                lambda t: gather_state_dict(model, t))
    if is_coordinator():
        if state_dict is None:
            state_dict = model.state_dict()
        payload = {"format": _FORMAT, "step": int(step),
                   "state_dict": {k: v.detach().cpu()
                                  for k, v in state_dict.items()}}
        if optimizer is not None:
            payload["optimizer"] = opt_state
        _write(path, payload)
        if also_final:
            _write(os.path.join(os.path.abspath(direc), FINAL_NAME,
                                CKPT_FILE), payload)
    barrier()
    return path


def _resolve(path: str) -> str:
    if os.path.isdir(path):
        path = os.path.join(path, CKPT_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    return path


def _reference_state_dict(state_dict: Mapping) -> dict:
    """A reference state dict as the port's models load it: ``module.``
    stripped, dead keys dropped."""
    if state_dict and all(k.startswith("module.") for k in state_dict):
        state_dict = {k[len("module."):]: v for k, v in state_dict.items()}
    return {k: v for k, v in state_dict.items()
            if not is_dead_reference_key(k)}


def restore_checkpoint(path: str, model: nn.Module,
                       optimizer: Optional[torch.optim.Optimizer] = None
                       ) -> int:
    """Load a checkpoint (a ``ckpt.pth`` file, its directory, or a reference
    ``.pth`` file) into ``model`` (strict) and, when given and saved, into
    ``optimizer``; a model split over a model axis takes this rank's part.
    Returns the saved step (0 for a reference file). The tensors are read
    onto the model's device."""
    model = unwrap(model)
    device = next(model.parameters()).device
    payload = torch.load(_resolve(path), map_location=device,
                         weights_only=True)
    if isinstance(payload, Mapping) and payload.get("format") == _FORMAT:
        state_dict, step = payload["state_dict"], payload["step"]
        if optimizer is not None and "optimizer" in payload:
            optimizer.load_state_dict(_map_optimizer(
                optimizer, model, payload["optimizer"],
                lambda t: shard_state_dict(t, model)))
    else:
        state_dict, step = payload, 0
    model.load_state_dict(shard_state_dict(
        _reference_state_dict(state_dict), model), strict=True)
    return int(step)


def latest_checkpoint(direc: str) -> Optional[str]:
    """The newest numeric epoch checkpoint directory under ``direc``, else
    its ``final_model``, else None (JAX ``latest_checkpoint``; the
    reference's resume_model, lib/utils.py:133-141)."""
    if not os.path.isdir(direc):
        return None
    epochs = [d for d in os.listdir(direc) if d.isdigit()
              and os.path.isfile(os.path.join(direc, d, CKPT_FILE))]
    if not epochs:
        final = os.path.join(direc, FINAL_NAME)
        return final if os.path.isfile(os.path.join(final, CKPT_FILE)) \
            else None
    return os.path.join(direc, max(epochs, key=int))
