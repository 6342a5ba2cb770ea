"""Build the port's CUDA kernels with plain ``nvcc`` and load them with
``ctypes``.

Every ``*.cu`` source under ``medt_tpu_torch/csrc/`` compiles in ONE ``nvcc``
command into one shared library with an ``extern "C"`` interface. No PyTorch
header is included and no ``torch.utils.cpp_extension`` is involved, so a
cold build takes seconds, and there is no lock file that a cut-off build
could leave behind.

The library goes to ``medt_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the sources and the flags: a source edit builds a new
library. It is written under a temporary name and renamed into place only
when ``nvcc`` succeeded, so a build that was cut off can never be loaded.
The build runs at first use: the first kernel call, or an explicit
:func:`build`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# (name, argtypes): every pointer and the stream are c_void_p, ints c_int
SIGNATURES = {
    "medt_lanes_attn_fwd": [_P] * 7 + [_I] * 5 + [_P],
    "medt_flash_lanes_fwd": [_P] * 9 + [_I] * 5 + [_P],
    "medt_lanes_attn_bwd": [_P] * 15 + [_I] * 7 + [_P],
    "medt_flash_lanes_bwd": [_P] * 17 + [_I] * 7 + [_P],
    "medt_moment_sums_fwd": [_P] * 7 + [_I] * 6 + [_P],
    "medt_moment_sums_bwd": [_P] * 10 + [_I] * 6 + [_P],
}


class BuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise BuildError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


class BuildResult:
    """Where the library is, how long the build took (0 when it was already
    built) and what nvcc printed (register and shared-memory use)."""

    def __init__(self, path: Path, seconds: float, log: str):
        self.path, self.seconds, self.log = path, seconds, log


def build(timeout: float = 600.0) -> BuildResult:
    """Compile every source into ``_build/libmedt_kernels-<hash>.so`` unless
    that library already exists."""
    digest = source_hash()
    target = BUILD_DIR / f"libmedt_kernels-{digest}.so"
    if target.exists():
        return BuildResult(target, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for stale in BUILD_DIR.glob(".tmp-*"):  # left by an earlier cut build
        stale.unlink(missing_ok=True)
    tmp = BUILD_DIR / f".tmp-{os.getpid()}-{digest}.so"
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *cu]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired as e:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"nvcc timed out after {timeout} s") from e
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, target)
    return BuildResult(target, seconds, log)


class _Library:
    """The loaded library, built and bound once per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(build().path))
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib


_LIBRARY = _Library()


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    return _LIBRARY.get()
