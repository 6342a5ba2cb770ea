"""Sums over the ranks of a data-parallel step.

The port's counterpart of the global reductions GSPMD inserts under the
JAX package's mesh (``medt_tpu/parallel/__init__.py``: "BN is therefore
cross-replica-synced by construction") and of the per-shard moment
partials summed before use (``medt_tpu/parallel/kernel_sharding.py``).
Every train-mode statistic (the BN moments, the similarity-BN moment
sums, the loss normaliser) is a sum over the batch. Inside
:func:`data_parallel_step`, which the train step of a model wrapped in
``DistributedDataParallel`` enters, each rank sums its own rows and
:func:`sum_over_ranks` adds the ranks' sums before they become a mean and
a variance, so a data-parallel step computes the one-process step on the
joint batch. The step, not the process group, switches the sums on: a
bare model in a group (or anything run outside the step) normalises with
its own rows, and every single-process path runs exactly as before, bit
for bit. Each rank of the step issues the same sums in the same order (the
same modules run on every rank, whatever its row count, a rank with no
rows included), so the collectives pair up.

Under a mesh with a model axis (:mod:`.mesh`) the ranks of one data index
hold the same rows, so the sums run over the data axis's group alone
(``data_parallel_step(..., group=mesh.data_group)``); the statistics of an
attention layer split over the model axis are its own groups' on each
rank (:mod:`.kernel_sharding`).
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

# (this rank's rows, the joint batch's rows, the ranks, their process group)
# of the data-parallel step being taken, else None. Process-wide, not per
# thread: a CUDA backward (and a remat recompute inside it) runs on
# autograd's own threads.
_STEP: Optional[Tuple[int, int, int, Any]] = None


@contextlib.contextmanager
def data_parallel_step(rows: int, joint_rows: int, group=None):
    """Within, the train-mode statistics are summed over the ranks of
    ``group`` (None: the default process group), the data axis: a step on
    ``rows`` rows of a joint batch of ``joint_rows``. Enter it around the
    forward and the backward."""
    global _STEP
    outer, _STEP = _STEP, (int(rows), int(joint_rows),
                           dist.get_world_size(group), group)
    try:
        yield
    finally:
        _STEP = outer


def active() -> bool:
    """True inside :func:`data_parallel_step`: the train-mode statistics
    are then summed over the ranks."""
    return _STEP is not None


def step_group():
    """The process group of the data-parallel step being taken (None: the
    default group)."""
    return _STEP[3] if _STEP is not None else None


class AllReduceSum(torch.autograd.Function):
    """``x`` summed over the ranks of ``group``; the backward sums the
    cotangent over them too (the gradient of a sum that every rank
    reads)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        total = x.contiguous().clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total

    @staticmethod
    def backward(ctx, grad):
        total = grad.contiguous().clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=ctx.group)
        return total, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group`` (None: the
    default group)."""
    return AllReduceSum.apply(x, group)


def sum_over_ranks(sums: torch.Tensor, count: int):
    """``(sums, count)`` summed over the ranks when :func:`active`, else as
    given: the per-feature sums of this rank's rows (differentiable) and the
    number of values they sum. The joint count is worked out on the host:
    every rank's count is its rows times the same count per row, so it is
    ``count * joint_rows / rows``, and the collective carries the sums
    alone. When the joint batch has fewer rows than there are ranks, some
    rank holds none and cannot divide: then every rank's collective also
    carries its count (in float64, exact), and a rank without rows reads
    the joint count back, waiting for it with no work of its own to
    queue."""
    if not active():
        return sums, count
    rows, joint, world, group = _STEP
    if rows and count % rows:
        raise ValueError(f"a count of {count} over {rows} rows: a batch "
                         "statistic's count must be a whole count per row")
    if rows and joint >= world:     # every rank holds rows
        return all_reduce_sum(sums, group), count // rows * joint
    # the count is filled in on the device: a tensor made from a host list
    # is a copy from pageable memory, which waits for the card's stream
    packed = torch.cat([sums.reshape(-1).double(), torch.full(
        (1,), float(count), dtype=torch.float64, device=sums.device)])
    total = all_reduce_sum(packed, group)
    sums = total[:-1].to(sums.dtype).view(sums.shape)
    if rows == 0:
        return sums, int(total[-1].item())
    return sums, count // rows * joint
