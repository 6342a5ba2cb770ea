"""Process-group bootstrap.

Port of ``medt_tpu/parallel/distributed.py``: where JAX's
``initialize_multihost`` joins the hosts of a slice with
``jax.distributed.initialize``, :func:`initialize_distributed` joins the
world that ``torchrun`` describes in its environment (NCCL, one rank per
card). :func:`host_shard` and :func:`is_coordinator` are the rank and world
size that data sharding and the coordinator's writes read
(``host_shard``; ``medt_tpu/training/checkpointing.py::is_coordinator``).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

# the variables torchrun sets for each rank it starts
TORCHRUN_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR")


def initialize_distributed() -> bool:
    """Join torchrun's world: ``init_process_group("nccl")`` with this
    rank's card (``LOCAL_RANK``) made the current one. A no-op, returning
    False, unless torchrun's variables are set with ``WORLD_SIZE`` above 1;
    True when this process is in a process group (also one a caller
    initialised before)."""
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ
    if not all(v in env for v in TORCHRUN_VARS) \
            or int(env["WORLD_SIZE"]) <= 1:
        return False
    torch.cuda.set_device(int(env["LOCAL_RANK"]))
    dist.init_process_group("nccl")
    return True


def host_shard() -> tuple:
    """``(rank, world size)`` of the initialised process group, else
    ``(0, 1)``."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_coordinator() -> bool:
    """True on the process that writes the run's files (logs, masks,
    checkpoints): rank 0, or the only process."""
    return host_shard()[0] == 0


def barrier():
    """Wait for every rank of the process group; a no-op without one."""
    if host_shard()[1] > 1:
        dist.barrier()
