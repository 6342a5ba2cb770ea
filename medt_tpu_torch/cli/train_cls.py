"""Classification training driver.

Port of ``medt_tpu/cli/train_cls.py``, the driver of the reference's
registry-style classification API (SURVEY.md section 1): cross-entropy,
label-smoothed when ``--label_smoothing > 0`` (reference lib/utils.py:
33-55), SGD with momentum and L2 weight decay (or Adam-L2) under a
per-step schedule (lib/utils.py:7-30), top-1 accuracy (lib/utils.py:
58-61), a checkpoint every ``--save_freq`` epochs and at the last one.
Its flags are JAX's, one for one:

    python -m medt_tpu_torch.cli.train_cls --model resnet26 \\
        --train_dataset <imagefolder> --val_dataset <imagefolder> \\
        --epochs 90 --batch_size 256 --lr 0.1

It runs on the card; an in-process caller may pass ``device="cpu"``. The
schedule is stepped once per batch, as optax steps it. ``--lr_schedule
linear`` is the reference's 30/60/90-epoch staircase (JAX's driver passes
that schedule one argument too many and raises).

``--distributed`` shards the ImageFolder sets by process (JAX's per-host
sharding) but the step is not data-parallel: no gradient is averaged and
no BN is synced across ranks. So in a world of more than one rank it
raises (ROADMAP.md section 1, item 5); ``cli.train`` trains
data-parallel.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.nn.functional as F

from .. import builders
from ..device import resolve_device
from ..losses import cross_entropy_with_label_smoothing
from ..metrics import Metric, accuracy
from ..parallel import launched_world
from ..training.checkpointing import save_checkpoint
from ..training.schedules import SCHEDULE_REGISTRY
from ..training.state import TrainState, normalize
from ..utils import Logger


def _labels(batch, device) -> torch.Tensor:
    return torch.from_numpy(batch["label"]).to(device).long()


def make_steps(label_smoothing: float):
    """(train_step, eval_step): ``train_step(state, batch)`` updates
    ``state`` in place and returns ``{"loss", "acc"}`` as 0-d device
    tensors; ``eval_step(state, batch)`` returns the top-1 accuracy on the
    running BN statistics. ``batch`` is the loader's dict (``image``
    (N, H, W, 3) normalised float32, ``label`` (N,) int)."""

    def loss_of(logits, labels):
        if label_smoothing > 0:
            return cross_entropy_with_label_smoothing(logits, labels,
                                                      eta=label_smoothing)
        return F.cross_entropy(logits.float(), labels)

    def train_step(state: TrainState, batch) -> dict:
        model, device = state.model, state.device
        model.train()
        logits = model(normalize(batch["image"], device))
        labels = _labels(batch, device)
        loss = loss_of(logits, labels)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if state.schedule is not None:
            lr = float(state.schedule(state.step))
            for group in state.optimizer.param_groups:
                group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), "acc": accuracy(logits.detach(),
                                                       labels)}

    def eval_step(state: TrainState, batch) -> torch.Tensor:
        model = state.model
        model.eval()
        with torch.no_grad():
            logits = model(normalize(batch["image"], state.device))
        return accuracy(logits, _labels(batch, state.device))

    return train_step, eval_step


def _schedule(args, steps_per_epoch: int):
    if args.lr_schedule == "constant":
        return None
    if args.lr_schedule == "linear":
        return SCHEDULE_REGISTRY["linear"](args.lr, steps_per_epoch,
                                           args.warmup_epochs)
    return SCHEDULE_REGISTRY[args.lr_schedule](
        args.lr, steps_per_epoch, args.epochs, args.warmup_epochs)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="medt_tpu_torch classification "
                                            "train")
    p.add_argument("--model", default="resnet26")
    p.add_argument("--train_dataset", required=True)
    p.add_argument("--val_dataset", required=True)
    p.add_argument("--num_classes", type=int, default=1000)
    p.add_argument("--imgsize", type=int, default=224)
    p.add_argument("--epochs", type=int, default=90)
    p.add_argument("--warmup_epochs", type=int, default=0)
    p.add_argument("--batch_size", "-b", type=int, default=256)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--lr_schedule", default="cosine",
                   choices=["cosine", "linear", "constant"])
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", "--wd", type=float, default=1e-4)
    p.add_argument("--optimizer", default="sgd")
    p.add_argument("--label_smoothing", type=float, default=0.0)
    p.add_argument("--workers", "-j", type=int, default=8)
    p.add_argument("--work_dirs", default="./cls_run")
    p.add_argument("--save_freq", type=int, default=10)
    p.add_argument("--distributed", action="store_true")
    return p.parse_args(argv)


def main(argv=None, device=None) -> TrainState:
    """Parse ``argv`` and train; returns the final ``TrainState``. Each
    epoch's entry (loss, acc and, at a checkpoint epoch, val_acc) is
    printed and appended to ``<work_dirs>/train_log.jsonl``."""
    args = parse_args(argv)
    if args.distributed and (launched_world() or 1) > 1:
        raise NotImplementedError(
            f"--distributed in a world of {launched_world()} ranks: the "
            "classification step is not data-parallel yet (ROADMAP.md "
            "section 1, item 5, 'Data-parallel training and multi-GPU "
            "serving'); run one process")
    device = resolve_device(device)
    train_loader, val_loader = builders.build_dataloader(args)
    model = builders.build_model(args, device=device)
    steps_per_epoch = max(len(train_loader), 1)
    state = TrainState(model, builders.build_optimizer(args,
                                                       model.parameters()),
                       schedule=_schedule(args, steps_per_epoch))
    train_step, eval_step = make_steps(args.label_smoothing)
    logger = Logger(verbose=True, jsonl_path=os.path.join(
        args.work_dirs, "train_log.jsonl"))
    for epoch in range(args.epochs):
        loss_m, acc_m = Metric(), Metric()
        for batch in train_loader:
            m = train_step(state, batch)
            n = len(batch["name"])
            loss_m.update(m["loss"], n)
            acc_m.update(m["acc"], n)
        entry = {"epoch": epoch, "loss": loss_m.average, "acc": acc_m.average}
        if epoch % args.save_freq == 0 or epoch == args.epochs - 1:
            val_m = Metric()
            for batch in val_loader:
                val_m.update(eval_step(state, batch), len(batch["name"]))
            entry["val_acc"] = val_m.average
            save_checkpoint(args.work_dirs, epoch, state.model,
                            state.optimizer, step=state.step)
        logger.log(entry)
    return state


if __name__ == "__main__":
    main()
