"""PyTorch / CUDA port of medt_tpu for the NVIDIA H100.

The JAX package ``medt_tpu`` stays the reference; this package imports
nothing of it and no JAX. Forward attention runs on hand-written CUDA
kernels (``csrc/``, built by ``kernels/build.py`` with plain ``nvcc`` and
loaded through ``ctypes``); every kernel has a plain PyTorch version beside
it, which is what runs on CPU tensors.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
