"""What each rank of the gloo worlds of ``test_torch_port_tp.py`` runs.

Spawned ranks import this module by name, so it imports the port alone
(no JAX, no test file). Each world is a ``(dp, tp)`` mesh
(``parallel.make_mesh``): the ranks of one data index take the same rows
of a global batch, and the attention layers are split by group over the
model axis (``state.data_parallel``). Every case returns what the test
holds against one process on the whole batch (:func:`one_process`):
outputs, input gradients, and the parameters, gradients and running
statistics gathered into their one-card shapes
(``parallel.gather_state_dict``).
"""
import contextlib

import numpy as np
import torch

from medt_tpu_torch.cli import train as cli_train
from medt_tpu_torch.data import blob_batch
from medt_tpu_torch.models import build_model
from medt_tpu_torch.ops import AxialAttention
from medt_tpu_torch.parallel import (
    data_parallel_step,
    gather_state_dict,
    host_shard,
    join_mesh,
    make_mesh,
    rank_rows,
    shard_batch,
    shard_model,
    sum_partial_grads,
)
from medt_tpu_torch.parallel.partitioning import cut_tensors
from medt_tpu_torch.training import (
    TrainState,
    adam_l2,
    data_parallel,
    restore_checkpoint,
    sgd,
    train_step,
)
from medt_tpu_torch.training.checkpointing import _map_optimizer
from medt_tpu_torch.training.state import unwrap

MODEL, IMG, LR = "gatedaxialunet", 32, 0.05
# (name, global rows, optimizer, remat): the whole steps of each world
STEPS = (("rows4", 4, "sgd", False), ("rows4adam", 4, "adam", False),
         ("rows1", 1, "adam", False), ("remat", 4, "sgd", True))
# attention sites: (span, mode, use_fused, groups, trainable gates); 16
# output planes, so gp 4 at 4 groups and gp 8 at 2
MODULES = {
    "lanes": (8, "gated", True, 4, False),       # lanes route, positions
    "wopos": (8, "wopos", True, 4, False),       # lanes route, no positions
    "stripe": (32, "gated", True, 4, False),     # stripe route (< 128 stripes)
    "plain": (8, "gated", False, 4, False),      # plain path
    "gates": (8, "gated", True, 2, True),        # trainable gates, fused
    "sig": (32, "gated_sig", True, 4, True),     # sigmoid gates, stripe route
    "data": (8, "gated_data", True, 4, False),   # per-sample gates: plain
    "odd": (8, "gated", True, 3, False),         # 3 groups: whole on 2 ranks
}
MODULE_ROWS = 3


def world_mesh(dp: int, tp: int):
    """This rank's mesh of the world's ``(dp, tp)`` grid."""
    return join_mesh(make_mesh(host_shard()[1], dp, tp))


def _module(kind: str, device):
    span, mode, fused, groups, trainable = MODULES[kind]
    gen = torch.Generator().manual_seed(7)
    out = 12 if groups == 3 else 16
    return AxialAttention(8, out, span, groups=groups, mode=mode,
                          use_fused=fused, trainable_gates=trainable,
                          generator=gen, device=device), (8, span, 3)


def module_case(kind: str, device, mesh=None, noise: int = 0) -> dict:
    """One train-mode forward and backward of an attention site, split
    over ``mesh``'s model axis (None: one process), on the data index's
    rows of a seeded batch of MODULE_ROWS, then an eval-mode forward of the
    whole batch: the outputs, the input gradient, the parameter gradients
    (the replicated ones summed over the model axis) and the running
    statistics in their one-card shapes. The objective is sum(out * c)
    for a seeded c. ``noise`` k > 0 perturbs the batch by a relative 1e-6
    (seed k): the float32 spread of the one-process case."""
    module, shape = _module(kind, device)
    if mesh is not None:
        shard_model(module, mesh.model_axis())
    module.train()
    rng = np.random.default_rng(11)
    rows = MODULE_ROWS
    x = rng.normal(size=(rows,) + shape)
    if noise:
        x = x * (1.0 + 1e-6 * np.random.default_rng(noise)
                 .standard_normal(x.shape))
    x = torch.from_numpy(x.astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(rows, module.out_planes * (
        mesh.tp if mesh is not None and module.model_axis else 1))
        + shape[1:]).astype(np.float32))
    if mesh is not None and mesh.dp > 1:
        part = rank_rows(rows, mesh.data_index, mesh.dp)
        x, c = x[part], c[part]
        step = data_parallel_step(len(x), rows, mesh.data_group)
    else:
        step = contextlib.nullcontext()
    xin = x.to(device).requires_grad_(True)
    with step:
        out = module(xin)
        (out * c.to(device)).sum().backward()
    if mesh is not None:
        sum_partial_grads(module)
    grads = {k: p.grad.clone() for k, p in module.named_parameters()
             if p.grad is not None}
    module.eval()
    with torch.no_grad():
        evaluated = module(x.to(device))
    if mesh is not None:
        grads = gather_state_dict(module, grads)
    state = gather_state_dict(module) if mesh is not None \
        else module.state_dict()
    return {"out": out.detach(), "dx": xin.grad, "eval": evaluated,
            "grads": grads, "split": module.model_axis is not None,
            "stats": {k: v.clone() for k, v in state.items()
                      if "running" in k},
            "route": module.last_route}


def step_case(before: dict, rows: int, optimizer: str, remat: bool, device,
              mesh=None, image=None) -> dict:
    """One ``train_step`` of gatedaxialunet 32 px (``use_fused``: plain
    cores on the CPU) from ``before`` on the data index's rows of a global
    blob batch of ``rows`` (``image``: that batch's images, perturbed):
    the loss, the gradients, the running statistics and the parameters
    after the update in their one-card shapes, and this rank's own
    replicated parameters."""
    images, masks = blob_batch(rows, IMG, seed=3)
    model = build_model(MODEL, img_size=IMG, use_fused=True, device=device)
    model.load_state_dict(before, strict=True)
    model = data_parallel(model, mesh)
    opt = (sgd if optimizer == "sgd" else adam_l2)(model.parameters(), LR)
    state = TrainState(model, opt, mesh=mesh)
    batch = {"image": images if image is None else image, "label": masks}
    if mesh is not None:
        batch = shard_batch(batch, mesh.data_index, mesh.dp)
    loss = train_step(state, batch, remat=remat, joint_rows=rows)["loss"]
    module = state.module
    grads = {k: p.grad.clone() for k, p in module.named_parameters()
             if p.requires_grad}
    cut = cut_tensors(module)
    out = {"loss": float(loss),
           "replicated": {k: p.detach().clone()
                          for k, p in module.named_parameters()
                          if k not in cut},
           "split": len({k.rsplit(".", 2)[0] for k in cut})}
    if mesh is not None:
        grads = gather_state_dict(module, grads)
    full = gather_state_dict(module) if mesh is not None \
        else module.state_dict()
    params = dict(module.named_parameters())
    out.update(grads=grads,
               stats={k: v.clone() for k, v in full.items()
                      if "running" in k},
               params={k: v.clone() for k, v in full.items()
                       if k in params})
    return out


def restore_case(checkpoint: str, device, mesh) -> dict:
    """A one-card checkpoint restored into this rank's split, DDP-wrapped
    model and its Adam-L2 optimizer, both gathered back into one-card
    state dicts."""
    model = data_parallel(build_model(MODEL, img_size=IMG, device=device),
                          mesh)
    opt = adam_l2(model.parameters(), LR)
    step = restore_checkpoint(checkpoint, model, opt)
    module = unwrap(model)
    return {"step": step, "model": gather_state_dict(module),
            "optimizer": _map_optimizer(
                opt, module, opt.state_dict(),
                lambda t: gather_state_dict(module, t))}


def one_process(before: dict, device="cpu") -> dict:
    """The modules (and each on two perturbed batches) and the steps on
    one process, on the whole batch."""
    return {"modules": {k: module_case(k, device) for k in MODULES},
            "module_spread": {k: [module_case(k, device, noise=n)
                                  for n in (1, 2)] for k in MODULES},
            "steps": {name: step_case(before, rows, opt, remat, device)
                      for name, rows, opt, remat in STEPS}}


def cases(device, dp: int, tp: int, before: dict, modules: bool,
          cli_argv=None, checkpoint=None) -> dict:
    """This rank's cases in a ``(dp, tp)`` world: its mesh, the steps,
    with ``modules`` the attention sites, with ``cli_argv``
    ``cli.train.main(cli_argv, device="cpu")`` joining the world, with
    ``checkpoint`` (a one-card run's) its restore into this rank."""
    torch.set_num_threads(1)
    mesh = world_mesh(dp, tp)
    out = {"data_index": mesh.data_index, "model_index": mesh.model_index,
           "steps": {name: step_case(before, rows, opt, remat, device,
                                     mesh)
                     for name, rows, opt, remat in STEPS}}
    if modules:
        out["modules"] = {k: module_case(k, device, mesh) for k in MODULES}
    if cli_argv is not None:
        cli_train.main(cli_argv, device="cpu")
    if checkpoint is not None:
        out["restored"] = restore_case(checkpoint, device, mesh)
    return out
