"""Start a data-parallel world from one process.

What ``torchrun`` (or ``torch.multiprocessing.spawn``) is to a process
group, and JAX's single-process mesh is to the JAX package:
:func:`run_data_parallel` spawns one rank per device, joins them in a
process group over a free localhost port, makes each rank's card the
current one, runs the caller's function on every rank and destroys the
group. The CLIs pass ``cuda:0..N-1`` with ``nccl`` (``N = dp * tp`` for
a mesh, :func:`.mesh.data_devices`); a CPU caller passes ``["cpu"] * N``
with ``gloo``, and a caller may put several ranks on one card with
``gloo``. The rank target lives here, so a spawned
rank imports this package and the caller's function's module, nothing
else of the caller's process.

A rank that raises fails the whole run: the other ranks are terminated
and the exception is raised in the caller.
"""
from __future__ import annotations

import datetime
import os
import socket
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, devices: Sequence[str], backend: str,
               port: int, timeout_s: Optional[float], outdir: str,
               args: tuple):
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:   # CPU ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(devices)))
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=len(devices), **kwargs)
    try:
        result = fn(device, *args)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(outdir, f"rank{rank}.pt"))


def run_data_parallel(fn: Callable, devices: Sequence[str], backend: str,
                      args: tuple = (),
                      timeout_s: Optional[float] = None) -> list:
    """Run ``fn(device, *args)`` on one spawned rank per entry of
    ``devices`` (``"cuda:i"`` or ``"cpu"``; one card may appear twice with
    ``gloo``) in a process group of ``backend``; returns the ranks' results
    in rank order (saved with ``torch.save``, so tensors come back as they
    were). ``fn`` must be importable by name; ``timeout_s`` bounds each
    collective (None: torch's default)."""
    with tempfile.TemporaryDirectory(prefix="medt-dp-") as outdir:
        mp.spawn(_rank_main, nprocs=len(devices), join=True,
                 args=(fn, list(devices), backend, free_port(), timeout_s,
                       outdir, tuple(args)))
        return [torch.load(os.path.join(outdir, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(len(devices))]
