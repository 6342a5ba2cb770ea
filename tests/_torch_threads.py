"""One intra-op thread for PyTorch in the port's CPU tests.

The tier-1 run gives every xdist worker a file at a time, six workers on
an 8-core host. PyTorch's default pool (a thread per core in every
worker) oversubscribes the host many times over, and at the tests' small
shapes even one process alone runs faster on one thread: a MedT-64 remat
step against JAX took 38 s with the default pool and 22 s on one thread,
alone on the host, and 291 s with the default pool inside the six-worker
run. Importing this module (every ``tests/test_torch_*.py`` does) sets
the pool to one thread for the worker's process; a test that needs more
(the data-parallel ranks) sets its own, and :func:`default_pool` gives a
block PyTorch's own pool back.
"""
import contextlib

import torch

DEFAULT_THREADS = torch.get_num_threads()
torch.set_num_threads(1)


@contextlib.contextmanager
def default_pool():
    """Run the block on PyTorch's default intra-op pool (the summation
    order a test's measured tolerances were taken with), then one thread
    again."""
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(1)
