"""What each rank of the two-rank gloo world of
``test_torch_port_parallel.py`` runs (``cli.train`` and
``cli.train_cls --distributed``).

Spawned ranks import this module by name, so it imports the port alone
(no JAX, no test file). Every case takes the rank's rows of a global
batch (``parallel.shard_batch``) and returns what the test holds against
one process on the joint batch; :func:`one_process` runs the same case on
the whole batch without a process group.
"""
import contextlib
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from medt_tpu_torch import builders
from medt_tpu_torch.cli import train as cli_train
from medt_tpu_torch.cli import train_cls
from medt_tpu_torch.data import blob_batch
from medt_tpu_torch.models import build_model, classifiers
from medt_tpu_torch.ops import AxialAttention, BatchNorm
from medt_tpu_torch.parallel import (
    data_parallel_step,
    host_shard,
    rank_rows,
    shard_batch,
)
from medt_tpu_torch.training import (
    TrainState,
    adam_l2,
    data_parallel,
    restore_checkpoint,
    sgd,
    train_step,
)

MODEL, IMG, LR = "gatedaxialunet", 32, 0.05
# (name, global rows, optimizer, remat): the whole steps of the world
STEPS = (("rows4", 4, "sgd", False), ("rows3", 3, "adam", False),
         ("rows1", 1, "adam", False), ("remat", 4, "sgd", True))
# (name, global rows): the modules, each with a rank of one row and one
# of two (3 rows) or one rank with no row (1 row)
MODULE_ROWS = (3, 1)
# the classification steps: axial26s at 32 px, s 0.25, on the fused path
# (plain cores on the CPU), SGD as train_cls builds it, at these joint
# batches (3: a rank of one row and one of two)
CLS_ROWS, CLS_IMG, CLS_CLASSES, CLS_SMOOTHING = (4, 3), 32, 5, 0.1


def _rows(t: torch.Tensor) -> torch.Tensor:
    rank, world = host_shard()
    return shard_batch({"image": t}, rank, world)["image"]


def _step(rows: int):
    """The data-parallel step's context for a module case at ``rows``
    global rows, as ``train_step`` enters it (nothing on one process)."""
    rank, world = host_shard()
    if world == 1:
        return contextlib.nullcontext()
    mine = rank_rows(rows, rank, world)
    return data_parallel_step(mine.stop - mine.start, rows)


def _summed(grads: dict) -> dict:
    """Parameter gradients summed over the ranks (the modules run without
    DDP); as they are in one process."""
    if host_shard()[1] > 1:
        for g in grads.values():
            dist.all_reduce(g)
    return grads


def _module(kind: str, device):
    gen = torch.Generator().manual_seed(7)
    if kind == "bn":
        bn = BatchNorm(6, device=device)
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=gen)
            bn.bias.uniform_(-0.5, 0.5, generator=gen)
        return bn, (6, 5, 3)
    # attention sites: the lanes route (span 8), its position-free
    # variant, the stripe route (span 32 under 128 stripes), the plain path
    span, mode, fused = {"lanes": (8, "gated", True),
                         "wopos": (8, "wopos", True),
                         "stripe": (32, "gated", True),
                         "plain": (8, "gated", False)}[kind]
    att = AxialAttention(8, 16, span, groups=2, mode=mode, use_fused=fused,
                         generator=gen, device=device)
    return att, (8, span, 3)


MODULES = ("bn", "lanes", "wopos", "stripe", "plain")


def module_case(kind: str, rows: int, device) -> dict:
    """One train-mode forward and backward of a module on this process's
    rows of a seeded batch of ``rows``: the output and input gradient of
    those rows, the parameter gradients summed over the ranks, the running
    statistics. The objective is sum(out * c) for a seeded c."""
    module, shape = _module(kind, device)
    module.train()
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(rows,) + shape).astype(np.float32))
    out_channels = 6 if kind == "bn" else 16
    c = torch.from_numpy(rng.normal(size=(rows, out_channels) + shape[1:])
                         .astype(np.float32))
    x = _rows(x).to(device).requires_grad_(True)
    with _step(rows):
        out = module(x)
        (out * _rows(c).to(device)).sum().backward()
    grads = {k: p.grad.clone() for k, p in module.named_parameters()
             if p.grad is not None}
    return {"out": out.detach(), "dx": x.grad,
            "grads": _summed(grads),
            "stats": {k: b.clone() for k, b in module.named_buffers()
                      if "running" in k}}


def bare_case(device, rows=None) -> dict:
    """``BatchNorm`` in train mode outside a data-parallel step, on this
    process's rows of the 3-row batch of :func:`module_case` (``rows``: a
    slice of it instead): the running statistics, its own rows'."""
    bn, shape = _module("bn", device)
    bn.train()
    x = torch.from_numpy(np.random.default_rng(11).normal(
        size=(3,) + shape).astype(np.float32))
    with torch.no_grad():
        bn((_rows(x) if rows is None else x[rows]).to(device))
    return {k: b.clone() for k, b in bn.named_buffers() if "running" in k}


def _cls_model(device):
    return classifiers.axial26s(img_size=CLS_IMG, s=0.25,
                                num_classes=CLS_CLASSES, use_fused=True,
                                generator=torch.Generator().manual_seed(4),
                                device=device)


def cls_step_case(rows: int, device, image=None) -> dict:
    """One ``cli.train_cls`` step (label smoothing, SGD) of axial26s on
    this process's rows of a seeded joint batch of ``rows`` (``image``:
    that batch's images, perturbed): the loss, the accuracy, the
    gradients and the parameters after the update."""
    rng = np.random.default_rng(21)
    images = rng.normal(size=(rows, CLS_IMG, CLS_IMG, 3)).astype(np.float32)
    labels = rng.integers(0, CLS_CLASSES, rows)
    model = _cls_model(device)
    if host_shard()[1] > 1:
        model = data_parallel(model)
    opt = builders.build_optimizer(SimpleNamespace(lr=0.1), model.parameters())
    state = TrainState(model, opt)
    rank, world = host_shard()
    batch = shard_batch({"image": images if image is None else image,
                         "label": labels}, rank, world)
    train_step, _ = train_cls.make_steps(CLS_SMOOTHING)
    m = train_step(state, batch, joint_rows=rows)
    module = state.module
    return {"loss": float(m["loss"]), "acc": float(m["acc"]),
            "grads": {k: p.grad.clone() for k, p in module.named_parameters()
                      if p.grad is not None},
            "stats": {k: b.clone() for k, b in module.named_buffers()
                      if "running" in k},
            "params": {k: p.detach().clone()
                       for k, p in module.named_parameters()}}


def train_cls_run(argv) -> dict:
    """``cli.train_cls.main(argv, device="cpu")`` (joining the world under
    ``--distributed``): the steps it took and its final weights."""
    state = train_cls.main(argv, device="cpu")
    return {"steps": state.step,
            "state_dict": {k: v.clone()
                           for k, v in state.module.state_dict().items()}}


def step_case(before: dict, rows: int, optimizer: str, remat: bool, device,
              image=None) -> dict:
    """One ``train_step`` of gatedaxialunet 32 px (``use_fused``: plain
    cores on the CPU) from ``before`` on this process's rows of a global
    blob batch of ``rows`` (``image``: that batch's images, perturbed):
    the loss, the gradients, the running statistics and the parameters
    after the update."""
    images, masks = blob_batch(rows, IMG, seed=3)
    model = build_model(MODEL, img_size=IMG, use_fused=True, device=device)
    model.load_state_dict(before, strict=True)
    model = data_parallel(model)
    opt = (sgd if optimizer == "sgd" else adam_l2)(model.parameters(), LR)
    state = TrainState(model, opt)
    rank, world = host_shard()
    batch = shard_batch({"image": images if image is None else image,
                         "label": masks}, rank, world)
    loss = train_step(state, batch, remat=remat, joint_rows=rows)["loss"]
    module = state.module
    return {"loss": float(loss),
            "grads": {k: p.grad.clone() for k, p in module.named_parameters()
                      if p.requires_grad},
            "stats": {k: b.clone() for k, b in module.named_buffers()
                      if "running" in k},
            "params": {k: p.detach().clone()
                       for k, p in module.named_parameters()}}


def one_process(before: dict, device="cpu") -> dict:
    """Every case on one process (no process group), on the joint batch."""
    return cases(device, before)


def cases(device, before: dict, cli_argv=None, checkpoint=None,
          cls_argv=None) -> dict:
    """Every two-rank case on this rank: the modules, the steps, the
    classification steps, in a world a bare BN; with ``cli_argv``,
    ``cli.train.main(cli_argv, device="cpu")`` joining the world; with
    ``checkpoint`` (a one-card run's), the step it restores into a
    DDP-wrapped model and the weights that model then holds; with
    ``cls_argv``, ``cli.train_cls.main(cls_argv, device="cpu")``."""
    out = {"modules": {(k, r): module_case(k, r, device) for k in MODULES
                       for r in MODULE_ROWS},
           "steps": {name: step_case(before, rows, opt, remat, device)
                     for name, rows, opt, remat in STEPS},
           "cls_steps": {rows: cls_step_case(rows, device)
                         for rows in CLS_ROWS}}
    if host_shard()[1] > 1:
        out.update(bare=bare_case(device))
    if cls_argv is not None:
        out["train_cls"] = train_cls_run(cls_argv)
    if cli_argv is not None:
        cli_train.main(cli_argv, device="cpu")
    if checkpoint is not None:
        model = data_parallel(build_model(MODEL, img_size=IMG, device=device))
        out["restored_step"] = restore_checkpoint(checkpoint, model)
        out["restored"] = {k: v.clone()
                           for k, v in model.module.state_dict().items()}
    return out
