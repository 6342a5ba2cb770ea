"""The mesh: the data axis (``--dp``) and the model axis (``--tp``).

Port of ``medt_tpu/parallel/mesh.py`` for its ``data`` and ``model`` axes.
JAX's mesh is a grid of devices in one program; here a run is one process
per rank (``torchrun``, or :func:`..launch.run_data_parallel`), and the
mesh is a grid of ranks:

* :func:`make_mesh` lays the ``world`` ranks out as a ``(dp, tp)`` grid,
  node-major (torchrun numbers the ranks node by node). A row holds the
  ``tp`` ranks of one data index, which split every attention layer's
  groups between them; a column holds the ``dp`` ranks of one model index,
  which split each batch between them. ``--num_slices`` counts the nodes
  (JAX's TPU slices): the data axis may span them, the model axis may not,
  so ``dp`` must be a multiple of it;
* :func:`join_mesh` gives this rank its :class:`Mesh`: its data and model
  indices and one process group per axis;
* :func:`shard_batch` (:func:`rank_rows`) gives a data index its rows of
  the global batch; the ranks of one row load the same rows.

``--dp`` defaults to every visible card (divided by ``--tp``), as JAX's
mesh spans every device. JAX's default mesh shards the width first
(``auto_mesh_shape``: 2 devices -> (1, 2, 1)); the port keeps the data
axis alone by default until the seq axis is ported (:data:`MESH_TODO`).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from .distributed import TORCHRUN_VARS

MESH_TODO = ("the port's mesh has the data and model axes (--dp, --tp); "
             "width sharding over the seq axis is ROADMAP.md section 1, "
             "'The mesh's seq axis'")


def launched_world() -> Optional[int]:
    """The world size of the process group this process is already in, or
    of the one torchrun started it for; None outside both."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if all(v in os.environ for v in TORCHRUN_VARS):
        return int(os.environ["WORLD_SIZE"])
    return None


def node_count() -> int:
    """The nodes torchrun spread this world over (``WORLD_SIZE`` over
    ``LOCAL_WORLD_SIZE``), else 1: what ``--num_slices`` pins."""
    env = os.environ
    if "WORLD_SIZE" in env and "LOCAL_WORLD_SIZE" in env:
        return max(int(env["WORLD_SIZE"]) // int(env["LOCAL_WORLD_SIZE"]), 1)
    return 1


def make_mesh(world: int, dp: Optional[int] = None,
              tp: Optional[int] = None,
              slices: Optional[int] = None) -> np.ndarray:
    """The ``(dp, tp)`` grid of the ranks ``0..world-1``, node-major (JAX's
    ``make_mesh(...).devices`` at ``sp=1``). ``tp`` None is 1, ``dp`` None
    the rest of the world; ``slices`` None counts torchrun's nodes. Raises
    ``ValueError`` when ``dp * tp`` is not the world, or when ``dp`` is not
    a multiple of the slices (JAX's message)."""
    tp = tp or 1
    if dp is None:
        if world % tp:
            raise ValueError(f"--tp {tp} does not divide the {world} ranks")
        dp = world // tp
    if dp * tp != world:
        raise ValueError(f"--dp {dp} x --tp {tp} = {dp * tp} ranks, but the "
                         f"run has {world}")
    slices = slices or node_count()
    if dp % slices:
        raise ValueError(
            f"data axis ({dp}) must be a multiple of the slice count "
            f"({slices}) — seq/model axes may not span the DCN")
    return np.arange(world).reshape(dp, tp)


@dataclass(frozen=True)
class ModelAxis:
    """This rank's place on the model axis: ``size`` ranks split each
    attention layer's groups, this one holds part ``index``; ``group`` is
    their process group."""

    size: int
    index: int
    group: Any


@dataclass(frozen=True)
class Mesh:
    """This rank's mesh: the grid of ranks, its position, and the process
    group of each axis. ``data_group`` is None when the data axis is the
    whole world (the default group); ``model_group`` None when ``tp`` is
    1."""

    grid: np.ndarray
    rank: int
    data_group: Any = None
    model_group: Any = None

    @property
    def dp(self) -> int:
        return self.grid.shape[0]

    @property
    def tp(self) -> int:
        return self.grid.shape[1]

    @property
    def data_index(self) -> int:
        return int(np.argwhere(self.grid == self.rank)[0, 0])

    @property
    def model_index(self) -> int:
        return int(np.argwhere(self.grid == self.rank)[0, 1])

    def model_axis(self) -> ModelAxis:
        return ModelAxis(self.tp, self.model_index, self.model_group)


def join_mesh(grid: np.ndarray) -> Mesh:
    """This rank's :class:`Mesh` over ``grid`` (:func:`make_mesh`). Every
    rank of the process group calls it: each axis's groups are made in the
    same order on every rank, as ``new_group`` asks."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    if grid.shape[1] == 1:
        return Mesh(grid, rank)
    data_group = model_group = None
    for column in grid.T:
        group = dist.new_group([int(r) for r in column])
        if rank in column:
            data_group = group
    for row in grid:
        group = dist.new_group([int(r) for r in row])
        if rank in row:
            model_group = group
    return Mesh(grid, rank, data_group, model_group)


def _on_cpu(device) -> bool:
    return device is not None and torch.device(device).type == "cpu"


def check_mesh(dp: Optional[int], device=None, tp: Optional[int] = None,
               slices: Optional[int] = None) -> int:
    """The number of ranks of the run, or ``SystemExit`` for a mesh it
    cannot take: in a process group (torchrun's, or a caller's) ``--dp``
    times ``--tp`` must be the world size; started here, more ranks than
    visible cards (JAX's message). On the CPU (``device="cpu"``) any count
    runs, as that many gloo ranks. ``--num_slices`` must divide the data
    axis (:func:`make_mesh`)."""
    world = launched_world()
    if world is not None:
        if tp is None and dp not in (None, world):
            raise SystemExit(f"--dp {dp} but the process group has {world} "
                             "ranks")
    elif _on_cpu(device):
        world = (dp or 1) * (tp or 1)
    else:
        visible = torch.cuda.device_count()
        world = dp * (tp or 1) if dp else max(visible, tp or 1, 1)
        if world > max(visible, 1):
            ranks = (f"--dp {dp}" if tp is None else f"--tp {tp}"
                     if dp is None else f"--dp {dp} x --tp {tp} = {world} "
                     "ranks")
            raise SystemExit(f"{ranks} but only {visible} devices visible")
    try:
        make_mesh(world, dp, tp, slices)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    return world


def data_devices(dp: Optional[int], device=None,
                 tp: Optional[int] = None) -> list:
    """The devices of a run of ``dp * tp`` ranks started in this process:
    that many ``"cpu"`` on the CPU, else the cards ``cuda:0..``; ``dp``
    None takes every visible card (one data rank on the CPU)."""
    world = check_mesh(dp, device, tp)
    if _on_cpu(device):
        return ["cpu"] * world
    return [f"cuda:{i}" for i in range(world)]


def rank_rows(n: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows of a global batch of ``n`` (JAX: the batch over
    the ``data`` axis): ``np.array_split``'s parts, so the first
    ``n % world`` ranks take one row more and a rank past the last row
    takes none."""
    base, extra = divmod(n, world)
    start = rank * base + min(rank, extra)
    return slice(start, start + base + (rank < extra))


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s rows of a global batch (:func:`rank_rows`): every
    value (arrays, tensors, the list of names) cut along its first axis."""
    rows = rank_rows(len(batch["image"]), rank, world)
    return {key: value[rows] for key, value in batch.items()}
