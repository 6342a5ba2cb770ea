"""Build the port's CUDA kernels with plain ``nvcc`` and load them with
``ctypes``.

Every ``*.cu`` source under ``medt_tpu_torch/csrc/`` compiles in its own
plain ``nvcc -c`` command, all started together, and one more ``nvcc``
links the objects into one shared library with an ``extern "C"``
interface: a cold build takes as long as its slowest source. No PyTorch
header is included and no ``torch.utils.cpp_extension`` is involved, and
there is no lock file that a cut-off build could leave behind.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# (name, argtypes): every pointer and the stream are c_void_p, ints c_int,
# strides (in elements) c_longlong
SIGNATURES = {
    "medt_lanes_attn_fwd": [_P] * 7 + [_I] * 5 + [_P],
    "medt_flash_lanes_fwd": [_P] * 9 + [_I] * 5 + [_P],
    "medt_flash2_lanes_fwd": [_P] * 9 + [_I] * 5 + [_P],
    "medt_lanes_attn_bwd": [_P] * 12 + [_I] * 7 + [_P],
    "medt_flash_lanes_bwd": [_P] * 17 + [_I] * 7 + [_P],
    "medt_flash2_lanes_bwd": [_P] * 17 + [_I] * 7 + [_P],
    "medt_moment_sums_fwd": [_P] * 7 + [_I] * 6 + [_P],
    "medt_moment_sums_bwd": [_P] * 9 + [_I] * 6 + [_P],
    "medt_axial_eval_fwd": [_P] * 9 + [_L] * 6 + [_I] * 5 + [_P],
    "medt_stripe_attn_fwd": [_P] * 9 + [_L] * 6 + [_I] * 5 + [_P],
    "medt_stripe_attn_bwd": [_P] * 16 + [_L] * 6 + [_I] * 7 + [_P],
    # the lanes and flash contracts at the wide widths, every even gp up
    # to 128 outside 2, 4, 8 and 16 (csrc/axial_wide.cu, axial_wide_bwd.cu)
    "medt_wide_attn_fwd": [_P] * 9 + [_I] * 6 + [_P],
    "medt_wide_attn_bwd": [_P] * 18 + [_I] * 7 + [_P],
    # the flash2 contract at the wide widths, spans up to 256
    # (csrc/axial_wide_long_fwd.cu, axial_wide_long_bwd.cu)
    "medt_wide_long_fwd": [_P] * 9 + [_I] * 5 + [_P],
    "medt_wide_long_bwd": [_P] * 17 + [_I] * 7 + [_P],
    # the moments forward's partial slots for (g, gp, L, S), -1 if refused
    "medt_moment_sums_fwd_slots": [_I] * 4,
}
# the bf16 entry points of rows 1-8 (qkv, and dqkv, in bf16) take the
# float32 ones' arguments
SIGNATURES.update({
    f"{name}_bf16": SIGNATURES[name] for name in (
        "medt_lanes_attn_fwd", "medt_flash_lanes_fwd", "medt_flash2_lanes_fwd",
        "medt_lanes_attn_bwd", "medt_flash_lanes_bwd", "medt_flash2_lanes_bwd",
        "medt_moment_sums_fwd", "medt_moment_sums_bwd", "medt_wide_attn_fwd",
        "medt_wide_attn_bwd", "medt_wide_long_fwd", "medt_wide_long_bwd")})


class BuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
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
    built), how long each source's compile took (empty then) and what nvcc
    printed (register and shared-memory use)."""

    def __init__(self, path: Path, seconds: float, log: str,
                 source_seconds: Optional[dict] = None):
        self.path, self.seconds, self.log = path, seconds, log
        self.source_seconds = source_seconds or {}


def _run(cmd, timeout: float):
    """One nvcc command: (return code, output, seconds)."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired:
        return (None, f"nvcc timed out after {timeout} s: {' '.join(cmd)}",
                time.perf_counter() - t0)
    return proc.returncode, proc.stdout + proc.stderr, \
        time.perf_counter() - t0


def build(timeout: float = 600.0) -> BuildResult:
    """Compile every source into ``_build/libmedt_kernels-<hash>.so`` unless
    that library already exists: one ``nvcc -c`` per source in parallel,
    then one link."""
    digest = source_hash()
    target = BUILD_DIR / f"libmedt_kernels-{digest}.so"
    if target.exists():
        return BuildResult(target, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for stale in BUILD_DIR.glob(".tmp-*"):  # left by an earlier cut build
        if stale.is_dir():
            shutil.rmtree(stale, ignore_errors=True)
        else:
            stale.unlink(missing_ok=True)
    tmp = BUILD_DIR / f".tmp-{os.getpid()}-{digest}.so"
    objdir = BUILD_DIR / f".tmp-{os.getpid()}-{digest}.o"
    nvcc = nvcc_path()
    objdir.mkdir()
    cu = [p for p in _sources() if p.suffix == ".cu"]
    objs = [str(objdir / f"{p.stem}.o") for p in cu]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", str(p), "-o", o]
                for p, o in zip(cu, objs)]
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(max_workers=len(compiles)) as pool:
            results = list(pool.map(lambda c: _run(c, timeout), compiles))
        log = "".join(out for _, out, _ in results)
        source_seconds = {p.name: sec for p, (_, _, sec) in zip(cu, results)}
        failed = [(rc, out) for rc, out, _ in results if rc != 0]
        if not failed:
            rc, out, _ = _run([nvcc, *LINK_FLAGS, "-o", str(tmp), *objs],
                              timeout)
            log += out
            if rc != 0:
                failed = [(rc, out)]
        if failed:
            tmp.unlink(missing_ok=True)
            raise BuildError("nvcc failed ("
                             f"{', '.join(str(rc) for rc, _ in failed)}):\n"
                             + "\n".join(out for _, out in failed))
        os.replace(tmp, target)
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
    return BuildResult(target, time.perf_counter() - t0, log, source_seconds)


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
