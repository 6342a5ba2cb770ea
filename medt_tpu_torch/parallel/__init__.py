"""Data-parallel training and multi-card serving.

Port of ``medt_tpu/parallel/`` for its data axis. JAX shards each batch
over the ``data`` axis of a mesh and GSPMD computes the unsharded function,
so a data-parallel step equals the one-device step on the joint batch, BN
statistics included. The port keeps that rule with one process per card:

* :mod:`.distributed`: joining torchrun's world, the rank and world size,
  the coordinator;
* :mod:`.mesh`: ``--dp`` and its devices, each rank's rows of the global
  batch (:func:`shard_batch`);
* :mod:`.sync`: the sums over the ranks of every train-mode statistic (the
  BNs, the similarity-BN moment sums, the loss normaliser) inside a
  data-parallel train step, so the ranks' statistics are the joint
  batch's;
* :mod:`.launch`: one spawned rank per device (:func:`run_data_parallel`).

The trainer wraps the model in ``DistributedDataParallel``; the serving
engine holds one replica per device (``InferenceEngine(devices=...)``).
"""
from .distributed import (
    barrier,
    host_shard,
    initialize_distributed,
    is_coordinator,
)
from .launch import run_data_parallel
from .mesh import (
    check_dp,
    data_devices,
    launched_world,
    rank_rows,
    shard_batch,
)
from .sync import (
    active,
    all_reduce_sum,
    data_parallel_step,
    sum_over_ranks,
)

__all__ = [
    "active",
    "all_reduce_sum",
    "barrier",
    "check_dp",
    "data_parallel_step",
    "data_devices",
    "host_shard",
    "initialize_distributed",
    "is_coordinator",
    "launched_world",
    "rank_rows",
    "run_data_parallel",
    "shard_batch",
    "sum_over_ranks",
]
