"""The data axis: ``--dp`` ranks, one per card, and each rank's rows.

Port of the data axis of ``medt_tpu/parallel/mesh.py``. JAX's mesh spans
``jax.devices()`` and shards each batch over its ``data`` axis; here a
data-parallel run is one process per card (``torchrun``, or
:func:`..launch.run_data_parallel`), and :func:`shard_batch` gives each rank
its rows of the global batch. ``--dp`` defaults to every visible card, as
JAX's mesh does. The ``seq`` and ``model`` axes (``--sp``, ``--tp``,
``--num_slices``) are not ported (:data:`MESH_TODO`).
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .distributed import TORCHRUN_VARS

MESH_TODO = ("the port's mesh has the data axis only (--dp); width sharding, "
             "group tensor parallelism and --num_slices are ROADMAP.md "
             "section 1, 'The mesh's seq and model axes'")


def launched_world() -> Optional[int]:
    """The world size of the process group this process is already in, or
    of the one torchrun started it for; None outside both."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if all(v in os.environ for v in TORCHRUN_VARS):
        return int(os.environ["WORLD_SIZE"])
    return None


def _on_cpu(device) -> bool:
    return device is not None and torch.device(device).type == "cpu"


def check_dp(dp: Optional[int], device=None):
    """Raise ``SystemExit`` for a ``--dp`` the run cannot take: in a process
    group (torchrun's, or a caller's) it must equal the world size; started
    here, more ranks than visible cards (JAX's message). On the CPU
    (``device="cpu"``) any count runs, as that many gloo ranks."""
    world = launched_world()
    if world is not None:
        if dp not in (None, world):
            raise SystemExit(f"--dp {dp} but the process group has {world} "
                             "ranks")
        return
    if dp is None or dp == 1 or _on_cpu(device):
        return
    visible = torch.cuda.device_count()
    if dp > visible:
        raise SystemExit(f"--dp {dp} but only {visible} devices visible")


def data_devices(dp: Optional[int], device=None) -> list:
    """The devices of a ``--dp`` run started in this process: ``dp`` times
    ``"cpu"`` on the CPU, else the cards ``cuda:0..dp-1``; ``dp`` None
    takes every visible card (one rank on the CPU)."""
    check_dp(dp, device)
    if _on_cpu(device):
        return ["cpu"] * (dp or 1)
    n = dp or max(torch.cuda.device_count(), 1)
    return [f"cuda:{i}" for i in range(n)]


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
