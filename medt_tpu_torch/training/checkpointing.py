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
parallelism-agnostic.
"""
from __future__ import annotations

import os
from typing import Mapping, Optional

import torch
from torch import nn

from ..parallel.distributed import barrier, is_coordinator
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


def save_checkpoint(direc: str, name, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None, *,
                    step: int = 0, also_final: bool = True) -> str:
    """Save under ``<direc>/<name>/ckpt.pth`` (and ``final_model``);
    returns the path. In a process group every rank calls it: the
    coordinator writes, the others wait for it."""
    path = os.path.join(os.path.abspath(direc), str(name), CKPT_FILE)
    if is_coordinator():
        model = unwrap(model)
        payload = {"format": _FORMAT, "step": int(step),
                   "state_dict": {k: v.detach().cpu()
                                  for k, v in model.state_dict().items()}}
        if optimizer is not None:
            payload["optimizer"] = optimizer.state_dict()
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
    ``optimizer``. Returns the saved step (0 for a reference file). The
    tensors are read onto the model's device."""
    model = unwrap(model)
    device = next(model.parameters()).device
    payload = torch.load(_resolve(path), map_location=device,
                         weights_only=True)
    if isinstance(payload, Mapping) and payload.get("format") == _FORMAT:
        state_dict, step = payload["state_dict"], payload["step"]
        if optimizer is not None and "optimizer" in payload:
            optimizer.load_state_dict(payload["optimizer"])
    else:
        state_dict, step = payload, 0
    model.load_state_dict(_reference_state_dict(state_dict), strict=True)
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
