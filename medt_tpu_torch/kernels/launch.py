"""What every kernel wrapper does around a ``ctypes`` call: check its
tensors, pass pointers and the current stream, raise on the returned CUDA
error."""
from __future__ import annotations

import ctypes

import torch


def check_tensor(name: str, tname: str, t: torch.Tensor, shape, device):
    """``t`` must be a contiguous float32 tensor of ``shape`` on ``device``,
    a CUDA device."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: {tname} must lie on qkv's CUDA device, "
                         f"got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: {tname} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {tname} shape {tuple(t.shape)} != "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {tname} must be contiguous")


def check_rows(name: str, tname: str, t: torch.Tensor, shape, device):
    """A stripe-major operand ``(S, g, rows, L)``: ``shape``, float32, on
    ``device``, a CUDA device, with rows of L contiguous floats (the stripe
    and group strides are free, so it may be a view of a fused qkv)."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: {tname} must lie on q's CUDA device, got "
                         f"{t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: {tname} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {tname} shape {tuple(t.shape)} != "
                         f"{tuple(shape)}")
    if t.stride(3) != 1 or t.stride(2) != shape[3]:
        raise ValueError(f"{name}: {tname} rows must be contiguous, got "
                         f"strides {t.stride()}")


def strides(*ts: torch.Tensor) -> list:
    """The stripe and group strides (in elements) of each operand."""
    return [st for t in ts for st in (t.stride(0), t.stride(1))]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """The current stream of ``device``: kernels launch on the caller's."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
