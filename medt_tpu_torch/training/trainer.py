"""The training loop.

Port of ``medt_tpu/training/trainer.py`` (the reference's flat script loop,
train.py:126-217): one :func:`..state.train_step` per batch with the loss
summed on the device (no per-step host sync: the reference thresholds
logits on the CPU every step and drops the result, train.py:142-149), a
prefetching loader whose batches are copied from pinned memory, and every
``save_freq`` epochs a validation pass (foreground F1 and IoU, and the
reference's mask PNGs ``<direc>/<epoch>/<name>``, train.py:205-213) and a
checkpoint (``<direc>/<epoch>/ckpt.pth`` and the rolling ``final_model``,
train.py:216-217). ``--resume`` restores the model, the optimizer state and
the step from the newest epoch checkpoint and starts at the epoch after it.
``train_log.jsonl`` and ``train_log.csv`` hold one row per epoch.

``--dtype bfloat16`` builds the model with bf16 activations around float32
parameters (``Config.compute_dtype``, as JAX's ``setup_state`` maps it),
and ``--remat`` passes ``remat=True`` to every step, as JAX's trainer
does.

What is not ported, and raises instead: the TPU mesh and multi-host code
(more than one visible card; ROADMAP.md, 'Data-parallel training and
multi-GPU serving'). JAX's Mosaic preflight, which disables a
Pallas kernel family that fails to lower and retraces onto XLA, has no
counterpart: on the card a kernel fault raises. The staircase schedule
("linear") gets its own three arguments (JAX passes it four).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data import (
    DataLoader,
    ImageToImage2D,
    JointTransform2D,
    to_device,
    write_mask_png,
)
from ..device import resolve_device
from ..metrics import binary_seg_scores, logits_to_foreground
from ..models import build_model, main_logits
from ..utils import Logger, ThroughputMeter, chk_mkdir, profiler_trace
from .checkpointing import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from .optimizers import adam_l2, sgd
from .schedules import SCHEDULE_REGISTRY
from .state import TrainState, eval_step, train_step


def build_tx(cfg: Config, model: torch.nn.Module, steps_per_epoch: int):
    """``(optimizer, schedule)``: Adam-L2 or SGD over the trainable
    parameters at ``--learning_rate``, and the ``step -> lr`` schedule
    (None for the constant rate)."""
    lr = cfg.learning_rate
    schedule = None
    if cfg.lr_schedule == "cosine":
        schedule = SCHEDULE_REGISTRY["cosine"](lr, steps_per_epoch,
                                               cfg.epochs, cfg.warmup_epochs)
    elif cfg.lr_schedule == "linear":
        schedule = SCHEDULE_REGISTRY["linear"](lr, steps_per_epoch,
                                               cfg.warmup_epochs)
    elif cfg.lr_schedule != "constant":
        raise ValueError(f"unknown --lr_schedule {cfg.lr_schedule!r}")
    if cfg.optimizer == "adam":
        optimizer = adam_l2(model.parameters(), lr,
                            weight_decay=cfg.weight_decay)
    else:
        optimizer = sgd(model.parameters(), lr, momentum=cfg.momentum,
                        weight_decay=cfg.weight_decay)
    return optimizer, schedule


def _check_one_card(device: torch.device):
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"{torch.cuda.device_count()} cards are visible; the port trains "
            "on one (data-parallel training is not ported yet: ROADMAP.md, "
            "'Data-parallel training and multi-GPU serving'). Make one "
            "visible with CUDA_VISIBLE_DEVICES.")


def setup_state(cfg: Config, steps_per_epoch: int, device) -> TrainState:
    """The configured model (weights from ``--seed``) on ``device`` (None:
    the card), with its optimizer and schedule. ``--trainable_gates yes``
    trains the attention gates; ``--dtype bfloat16`` computes in bf16."""
    model = build_model(cfg.modelname, img_size=cfg.imgsize,
                        imgchan=cfg.imgchan, use_fused=cfg.use_fused,
                        seed=cfg.seed, device=resolve_device(device),
                        trainable_gates=cfg.trainable_gates == "yes",
                        dtype=cfg.compute_dtype)
    optimizer, schedule = build_tx(cfg, model, steps_per_epoch)
    return TrainState(model, optimizer, schedule=schedule)


def validate(cfg: Config, state: TrainState, val_loader: DataLoader,
             epoch: int) -> dict:
    """Validation pass: the mask PNGs under ``<direc>/<epoch>/`` and the
    mean foreground F1 and IoU (of the main logits of a deep-supervision
    model, whose tuple JAX's validation cannot take)."""
    fulldir = os.path.join(cfg.direc, str(epoch))
    chk_mkdir(fulldir)
    f1s, ious = [], []
    for batch in val_loader:
        dev = to_device(batch, state.device)
        logits = main_logits(eval_step(state, dev))
        fg = logits_to_foreground(logits, mode=cfg.pred_mode)
        f1, iou, _ = binary_seg_scores(fg, dev["label"] > 0)
        f1s.append(f1)
        ious.append(iou)
        fg_np = fg.cpu().numpy()
        for i, name in enumerate(batch["name"]):
            write_mask_png(os.path.join(fulldir, name), fg_np[i])
    return {"val_f1": float(torch.cat(f1s).mean()),
            "val_iou": float(torch.cat(ious).mean())}


def _loader(cfg: Config, path: str, train: bool) -> DataLoader:
    """Byte batches of the PNG set at ``path``: shuffled at ``--batch_size``
    with random flips for training, in order at batch 1 for validation."""
    tf = JointTransform2D(crop=cfg.crop_tuple, p_flip=0.5 if train else 0,
                          color_jitter_params=None, long_mask=True,
                          output_dtype="uint8")
    ds = ImageToImage2D(path, tf, gray=cfg.gray == "yes")
    return DataLoader(ds, cfg.batch_size if train else 1, shuffle=train,
                      num_workers=cfg.workers, seed=cfg.seed)


def run_training(cfg: Config, state: Optional[TrainState] = None,
                 train_loader: Optional[DataLoader] = None,
                 val_loader: Optional[DataLoader] = None,
                 device=None) -> TrainState:
    """Train for ``cfg.epochs`` epochs (from ``cfg.start_epoch``, or after
    the newest checkpoint with ``--resume``). A caller may pass its own
    state (its model's device is used) and loaders; otherwise they are
    built from ``cfg`` on ``device`` (None: the card)."""
    np.random.seed(cfg.seed)  # the reference seeds numpy and torch to 3000
    if train_loader is None:
        train_loader = _loader(cfg, cfg.train_dataset, train=True)
    if val_loader is None and cfg.val_dataset:
        val_loader = _loader(cfg, cfg.val_dataset, train=False)
    steps_per_epoch = max(len(train_loader), 1)
    if state is None:
        state = setup_state(cfg, steps_per_epoch, device)
    device = state.device
    _check_one_card(device)

    start_epoch = cfg.start_epoch
    if cfg.resume:
        newest = latest_checkpoint(cfg.direc)
        if newest is not None:
            state.step = restore_checkpoint(newest, state.model,
                                            state.optimizer)
            base = os.path.basename(newest)
            start_epoch = int(base) + 1 if base.isdigit() else start_epoch
            print(f"resumed from {newest} at epoch {start_epoch}")

    logger = Logger(verbose=True,
                    jsonl_path=os.path.join(cfg.direc, "train_log.jsonl"))
    with profiler_trace(cfg.profile_dir):
        for epoch in range(start_epoch, cfg.epochs):
            meter = ThroughputMeter()
            # the loss is summed on the card: a float() per step would wait
            # for it every step
            epoch_loss = torch.zeros((), device=device)
            n_batches = 0
            for batch in train_loader:
                metrics = train_step(state, to_device(batch, device),
                                     remat=cfg.remat)
                epoch_loss = epoch_loss + metrics["loss"]
                n_batches += 1
                meter.update(len(batch["name"]))
            entry = {
                "epoch": epoch,
                "loss": float(epoch_loss) / max(n_batches, 1),
                "imgs_per_sec": round(meter.imgs_per_sec, 2),
            }
            if epoch % cfg.save_freq == 0:
                if val_loader is not None:
                    entry.update(validate(cfg, state, val_loader, epoch))
                save_checkpoint(cfg.direc, epoch, state.model,
                                state.optimizer, step=state.step)
            logger.log(entry)
    logger.to_csv(os.path.join(cfg.direc, "train_log.csv"))
    return state
