"""Checkpoints with ``torch.save``.

Port of ``medt_tpu/training/checkpointing.py`` (Orbax in JAX):

* ``save_checkpoint`` writes ``<direc>/<name>/ckpt.pth`` and a rolling
  ``<direc>/final_model/ckpt.pth`` (reference train.py:216-217), holding the
  model's reference-format state dict, the optimizer state (when given) and
  the step;
* ``restore_checkpoint`` reads such a file, or a reference ``.pth`` file (a
  bare state dict, ``torch.save(model.state_dict())``): DataParallel's
  ``module.`` prefix is stripped (reference lib/utils.py:163-167; JAX
  ``utils/torch_import.py:40``) and the keys nothing computes with are
  dropped (:func:`..utils.weights.is_dead_reference_key`), then the model
  loads it with ``strict=True``.
"""
from __future__ import annotations

import os
from typing import Mapping, Optional

import torch
from torch import nn

from ..utils.weights import is_dead_reference_key

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
    returns the path."""
    payload = {"format": _FORMAT, "step": int(step),
               "state_dict": {k: v.detach().cpu()
                              for k, v in model.state_dict().items()}}
    if optimizer is not None:
        payload["optimizer"] = optimizer.state_dict()
    path = os.path.join(os.path.abspath(direc), str(name), CKPT_FILE)
    _write(path, payload)
    if also_final:
        _write(os.path.join(os.path.abspath(direc), FINAL_NAME, CKPT_FILE),
               payload)
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
    ``optimizer``. Returns the saved step (0 for a reference file)."""
    payload = torch.load(_resolve(path), map_location="cpu",
                         weights_only=True)
    if isinstance(payload, Mapping) and payload.get("format") == _FORMAT:
        state_dict, step = payload["state_dict"], payload["step"]
        if optimizer is not None and "optimizer" in payload:
            optimizer.load_state_dict(payload["optimizer"])
    else:
        state_dict, step = payload, 0
    model.load_state_dict(_reference_state_dict(state_dict), strict=True)
    return int(step)
