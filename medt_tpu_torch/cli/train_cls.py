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

``--distributed`` trains data-parallel over the ranks of a process group
(torchrun's, or one a caller initialised): the flag's stated purpose in
JAX, "the TPU-native replacement for the reference's DistributedSampler"
(``medt_tpu/builders.py``), with a data axis that reduces gradients and BN
statistics globally. ``--batch_size`` keeps JAX's meaning, the rows each
process loads a step, so the joint batch is ``world * batch_size``: every
rank draws from one shuffled order and takes its rows of each joint batch
(``DataLoader(shard=...)``), so every rank takes the same number of
steps. The model is wrapped in ``DistributedDataParallel``
(``training.state.data_parallel``) and each step runs inside
``parallel.data_parallel_step``, so the BN statistics, the similarity-BN
moments and the loss are the joint batch's, the one-process step's on
it. Top-1 accuracy is a count summed over the ranks, for training and for
validation, which covers the validation set once, split the same way;
the coordinator alone writes the log and the checkpoints. (JAX's driver
shards the sets per process but steps each process on its own rows,
averaging no gradient across them.)
"""
from __future__ import annotations

import argparse
import contextlib
import os

import torch
import torch.nn.functional as F
from torch.nn.parallel import DistributedDataParallel

from .. import builders
from ..device import resolve_device
from ..losses import cross_entropy_with_label_smoothing, label_smoothing
from ..metrics import Metric
from ..parallel import sync
from ..training.checkpointing import save_checkpoint
from ..training.schedules import SCHEDULE_REGISTRY
from ..training.state import TrainState, data_parallel, data_world, normalize
from ..utils import Logger


def _labels(batch, device) -> torch.Tensor:
    return torch.from_numpy(batch["label"]).to(device).long()


def _correct(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The count of top-1 hits (reference lib/utils.py:58-61), a 0-d
    float32 tensor."""
    return (torch.argmax(logits, dim=1) == labels).float().sum()


def make_steps(label_smoothing_eta: float):
    """(train_step, eval_step): ``train_step(state, batch, joint_rows=None)``
    updates ``state`` in place and returns ``{"loss", "acc"}`` as 0-d
    device tensors; for a DDP-wrapped model ``batch`` is this rank's rows
    of a joint batch of ``joint_rows``, and both are the joint batch's
    (summed over the ranks). ``eval_step(state, batch)`` returns the count
    of top-1 hits on the running BN statistics. ``batch`` is the loader's
    dict (``image`` (N, H, W, 3) normalised float32, ``label`` (N,)
    int)."""

    def loss_of(logits, labels):
        if label_smoothing_eta > 0:
            return cross_entropy_with_label_smoothing(
                logits, labels, eta=label_smoothing_eta)
        return F.cross_entropy(logits.float(), labels)

    def row_losses(logits, labels):
        if label_smoothing_eta > 0:
            target = label_smoothing(logits, labels, label_smoothing_eta)
            return torch.sum(-target * torch.log_softmax(logits.float(),
                                                         dim=-1), dim=-1)
        return F.cross_entropy(logits.float(), labels, reduction="none")

    def train_step(state: TrainState, batch, joint_rows=None) -> dict:
        model, device = state.model, state.device
        world = data_world(model) \
            if isinstance(model, DistributedDataParallel) else 1
        rows = len(batch["label"])
        joint = rows if world == 1 else joint_rows
        if joint is None:
            raise ValueError("a data-parallel step needs joint_rows, the "
                             "rows of the joint batch")
        step = contextlib.nullcontext() if world == 1 \
            else sync.data_parallel_step(rows, joint)
        model.train()
        with step:
            logits = model(normalize(batch["image"], device))
            labels = _labels(batch, device)
            if world == 1:
                loss = loss_of(logits, labels)
            else:   # this rank's part of the joint batch's mean
                loss = row_losses(logits, labels).sum() / joint
            state.optimizer.zero_grad(set_to_none=True)
            # DDP averages the ranks' gradients of their parts
            (loss * world if world > 1 else loss).backward()
        if state.schedule is not None:
            lr = float(state.schedule(state.step))
            for group in state.optimizer.param_groups:
                group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        loss, correct = loss.detach(), _correct(logits.detach(), labels)
        if world > 1:
            loss, correct = sync.all_reduce_sum(loss), \
                sync.all_reduce_sum(correct)
        return {"loss": loss, "acc": correct / joint}

    def eval_step(state: TrainState, batch) -> torch.Tensor:
        model = state.module
        model.eval()
        with torch.no_grad():
            logits = model(normalize(batch["image"], state.device))
        return _correct(logits, _labels(batch, state.device))

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
    printed and appended to ``<work_dirs>/train_log.jsonl``. Under
    ``--distributed`` every rank of the process group calls it."""
    args = parse_args(argv)
    device = resolve_device(device)
    train_loader, val_loader = builders.build_dataloader(args)
    model = builders.build_model(args, device=device)
    world = train_loader.shard[1] if train_loader.shard else 1
    if world > 1:
        model = data_parallel(model)
    steps_per_epoch = max(len(train_loader), 1)
    state = TrainState(model, builders.build_optimizer(args,
                                                       model.parameters()),
                       schedule=_schedule(args, steps_per_epoch))
    train_step, eval_step = make_steps(args.label_smoothing)
    logger = Logger(verbose=True, jsonl_path=os.path.join(
        args.work_dirs, "train_log.jsonl"))

    def joint_rows(loader, k, batch):
        return loader.joint_rows(k) if world > 1 else len(batch["name"])

    for epoch in range(args.epochs):
        loss_m, acc_m = Metric(), Metric()
        for k, batch in enumerate(train_loader):
            n = joint_rows(train_loader, k, batch)
            m = train_step(state, batch, joint_rows=n)
            loss_m.update(m["loss"], n)
            acc_m.update(m["acc"], n)
        entry = {"epoch": epoch, "loss": loss_m.average, "acc": acc_m.average}
        if epoch % args.save_freq == 0 or epoch == args.epochs - 1:
            val_m = Metric()
            for k, batch in enumerate(val_loader):
                n = joint_rows(val_loader, k, batch)
                correct = eval_step(state, batch) if len(batch["label"]) \
                    else torch.zeros((), device=device)
                if world > 1:
                    correct = sync.all_reduce_sum(correct)
                val_m.update(correct / n, n)
            entry["val_acc"] = val_m.average
            save_checkpoint(args.work_dirs, epoch, state.model,
                            state.optimizer, step=state.step)
        logger.log(entry)
    return state


if __name__ == "__main__":
    main()
