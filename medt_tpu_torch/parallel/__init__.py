"""Data- and model-parallel training and multi-card serving.

Port of ``medt_tpu/parallel/`` for its data and model axes. JAX shards
each batch over the ``data`` axis of a mesh, the attention groups over its
``model`` axis, and GSPMD computes the unsharded function, so a parallel
step equals the one-device step on the joint batch, BN statistics
included. The port keeps that rule with one process per rank:

* :mod:`.distributed`: joining torchrun's world, the rank and world size,
  the coordinator;
* :mod:`.mesh`: the ``(dp, tp)`` grid of ranks, its process groups, the
  devices of ``--dp``/``--tp``, each data index's rows of the global batch
  (:func:`shard_batch`);
* :mod:`.sync`: the sums over the data axis of every train-mode statistic
  (the BNs, the similarity-BN moment sums, the loss normaliser) inside a
  data-parallel train step, so the ranks' statistics are the joint
  batch's;
* :mod:`.partitioning` and :mod:`.kernel_sharding`: the attention layers
  split by group over the model axis, their region's collectives, and the
  one-card state dict of a split model;
* :mod:`.launch`: one spawned rank per device (:func:`run_data_parallel`).

The trainer wraps the model in ``DistributedDataParallel`` over the data
axis; the serving engine holds one replica per device
(``InferenceEngine(devices=...)``). The ``seq`` axis (width sharding) is
not ported (:data:`.mesh.MESH_TODO`).
"""
from .distributed import (
    barrier,
    host_shard,
    initialize_distributed,
    is_coordinator,
)
from .kernel_sharding import shard_model, sum_partial_grads
from .launch import run_data_parallel
from .mesh import (
    Mesh,
    ModelAxis,
    check_mesh,
    data_devices,
    join_mesh,
    launched_world,
    make_mesh,
    rank_rows,
    shard_batch,
)
from .partitioning import gather_state_dict, shard_state_dict
from .sync import (
    active,
    all_reduce_sum,
    data_parallel_step,
    sum_over_ranks,
)

__all__ = [
    "Mesh",
    "ModelAxis",
    "active",
    "all_reduce_sum",
    "barrier",
    "check_mesh",
    "data_parallel_step",
    "data_devices",
    "gather_state_dict",
    "host_shard",
    "initialize_distributed",
    "is_coordinator",
    "join_mesh",
    "launched_world",
    "make_mesh",
    "rank_rows",
    "run_data_parallel",
    "shard_batch",
    "shard_model",
    "shard_state_dict",
    "sum_over_ranks",
    "sum_partial_grads",
]
