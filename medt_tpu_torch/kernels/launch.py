"""What every kernel wrapper does around a ``ctypes`` call: check its
tensors, pass pointers and the current stream, make the tensors' card the
current one for the call, raise on the returned CUDA error, count the
launch."""
from __future__ import annotations

import ctypes
import threading

import torch


F32 = (torch.float32,)
# the fused qkv of the lanes-family and moments kernels, which have a bf16
# entry point beside the float32 one
QKV_DTYPES = (torch.float32, torch.bfloat16)


def check_tensor(name: str, tname: str, t: torch.Tensor, shape, device,
                 dtypes=F32):
    """``t`` must be a contiguous tensor of ``shape`` and one of ``dtypes``
    (float32 by default) on ``device``, a CUDA device."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: {tname} must lie on qkv's CUDA device, "
                         f"got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: {tname} must be "
                        f"{' or '.join(str(d) for d in dtypes)}, got "
                        f"{t.dtype}")
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


def widened(t: torch.Tensor) -> torch.Tensor:
    """A plain version's working copy of qkv: bf16 (or half) upcast to
    float32, which is exact; float32 and float64 as they are."""
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t


def entry(name: str, qkv: torch.Tensor) -> str:
    """The C entry point of kernel ``name`` for ``qkv``'s dtype:
    ``medt_<name>``, or ``medt_<name>_bf16`` for bf16 qkv."""
    return f"medt_{name}_bf16" if qkv.dtype == torch.bfloat16 \
        else f"medt_{name}"


# the counts are read-modify-written by every thread that launches (the
# serving engine's worker, a caller's threads)
_COUNT_LOCK = threading.Lock()


def count_launch(fn, qkv: torch.Tensor):
    """Add a launch to wrapper ``fn``'s count for ``qkv``'s dtype:
    ``fn.launches`` (float32) or ``fn.launches_bf16``."""
    with _COUNT_LOCK:
        if qkv.dtype == torch.bfloat16:
            fn.launches_bf16 += 1
        else:
            fn.launches += 1


def counts_of(wrappers) -> dict:
    """Launch counts by name; a wrapper with a bf16 entry point also under
    ``<name>_bf16``."""
    out = {}
    for fn in wrappers:
        out[fn.__name__] = fn.launches
        if hasattr(fn, "launches_bf16"):
            out[fn.__name__ + "_bf16"] = fn.launches_bf16
    return out


def reset_counts(wrappers):
    for fn in wrappers:
        fn.launches = 0
        if hasattr(fn, "launches_bf16"):
            fn.launches_bf16 = 0


def strides(*ts: torch.Tensor) -> list:
    """The stripe and group strides (in elements) of each operand."""
    return [st for t in ts for st in (t.stride(0), t.stride(1))]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """The current stream of ``device``: kernels launch on the caller's."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch(wrapper, kernel, qkv: torch.Tensor, *args):
    """Call the C entry point ``kernel`` with ``args`` and the current
    stream of ``qkv``'s card, with that card the current one meanwhile (the
    launch and a shared-memory opt-in act on the current card, whatever
    the stream says); raise on the CUDA error it returns, else add one to
    ``wrapper``'s count for ``qkv``'s dtype. The one place a kernel is
    launched and counted."""
    device = qkv.device
    with torch.cuda.device(device):
        err = kernel(*args, stream(device))
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__}: kernel launch failed with "
                           f"CUDA error {err}")
    count_launch(wrapper, qkv)
