#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``medt_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing one JSON line with ``phase`` and ``seconds`` (since
the start of the script) as it ends:

1. ``device``  — the card (nvidia-smi name and power limit); TF32 off.
2. ``build``   — every kernel source compiled by one plain ``nvcc``
   command into a ``ctypes``-loaded library.
3. ``kernels`` — each kernel held against its plain PyTorch version on the
   card at every geometry the serving path gives it (MedT 128 at batch 16),
   with CUDA-event times of kernel and plain version.
4. ``serve``   — the port's ``InferenceEngine`` serving MedT 128 at batch
   16 from a seeded random init: threaded ``submit`` at two priorities plus
   full-batch ``predict_batch`` calls; the launch counters must show every
   forward went through the kernels (16 lanes + 6 flash launches); the
   engine's logits are held against the same model on plain cores.

Then: the per-kernel JSON summary, the card's ``nvidia-smi`` line, and, as
the last line, ``{"ok": true, "device": ...}``. Any failed phase ends the
script with a non-zero exit code and without the ``ok`` line. Without CUDA,
or outside a checkout of the repository, it exits non-zero at once.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

T0 = time.perf_counter()
REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): device memory
# bandwidth and dense float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

KERNEL_ATOL = 1e-4   # sv/sve: float32, another summation order in exp/sum
ML_RTOL = 1e-5       # m, l: plus a relative term (l sums up to 64 exps)
LOGITS_ATOL = 1e-3   # whole model, kernels vs plain cores

SOURCE = "medt_tpu_torch/csrc/axial_lanes_fwd.cu"
REPLACES = {
    "lanes_attn_fwd": "medt_tpu/ops/pallas_axial_lanes.py:333",
    "flash_lanes_fwd": "medt_tpu/ops/pallas_axial_lanes.py:705",
}
# (kernel, span, gp, stripes, has_pos, launches per MedT-128 forward at
# batch 16); g = 8 everywhere. The two rows with 0 launches are the other
# has_pos variant of each kernel (logo, gatedaxialunet need them).
GEOMETRIES = [
    ("flash_lanes_fwd", 64, 2, 1024, True, 2),
    ("flash_lanes_fwd", 64, 4, 1024, True, 2),
    ("flash_lanes_fwd", 32, 4, 512, True, 2),
    ("flash_lanes_fwd", 64, 4, 1024, False, 0),
    ("lanes_attn_fwd", 16, 2, 4096, False, 2),
    ("lanes_attn_fwd", 16, 4, 4096, False, 2),
    ("lanes_attn_fwd", 8, 4, 2048, False, 2),
    ("lanes_attn_fwd", 8, 8, 2048, False, 2),
    ("lanes_attn_fwd", 4, 8, 1024, False, 6),
    ("lanes_attn_fwd", 4, 16, 1024, False, 2),
    ("lanes_attn_fwd", 16, 2, 4096, True, 0),
]
GROUPS = 8
BATCH = 16
IMG = 128


class PhaseFailed(RuntimeError):
    pass


def emit(phase: str, **fields):
    line = {"phase": phase, "seconds": round(time.perf_counter() - T0, 3)}
    line.update(fields)
    print(json.dumps(line), flush=True)


def check(cond: bool, message: str):
    if not cond:
        raise PhaseFailed(message)


# ---- 1. device -------------------------------------------------------------

def phase_device(torch):
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    smi = out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, torch_name=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, tf32="off (cudnn and matmul)")
    return smi, name


# ---- 2. build ---------------------------------------------------------------

def phase_build():
    from medt_tpu_torch.kernels.build import build, library

    result = build()
    library()  # load and bind
    emit("build", nvcc_seconds=round(result.seconds, 3),
         library=str(result.path.relative_to(REPO)),
         ptxas=ptxas_summary(result.log))


def ptxas_summary(log: str) -> dict:
    """``-Xptxas -v`` per kernel instance: {"gp=G pos=P ml=M": "..."}."""
    out, label = {}, None
    for line in log.splitlines():
        m = re.search(r"kernelILi(\d+)ELb(\d)ELb(\d)E", line)
        if "Compiling entry" in line and m:
            label = "gp={} pos={} ml={}".format(*m.groups())
            out[label] = ""
        elif label and ("registers" in line or "spill" in line):
            text = line.split(":", 1)[-1].strip()
            out[label] = f"{out[label]}; {text}" if out[label] else text
    return out


# ---- 3. kernels -------------------------------------------------------------

def core_inputs(torch, gen, gp, L, S, has_pos):
    """Seeded inputs at a serving geometry, on the card, scaled like the
    model's: BN'd qkv ~ N(0, 1), tables ~ N(0, 1/gp), sim affine ~ 1."""
    from medt_tpu_torch.ops.attn_core import pack_sim_affine

    dev = "cuda"
    c = gp // 2

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    qkv = randn(GROUPS, 2 * gp, L, S)
    if has_pos:
        tab = gp ** -0.5
        qemb, kemb_t, vemb = (randn(c, L, L, scale=tab),
                              randn(c, L, L, scale=tab),
                              randn(gp, L, L, scale=tab))
        a = 0.5 + torch.rand((3, GROUPS), generator=gen, device=dev)
        aff = pack_sim_affine(GROUPS, a, randn(3, GROUPS, scale=0.1), "full")
    else:
        qemb = kemb_t = vemb = torch.zeros((0, L, L), device=dev)
        a = 0.5 + torch.rand((GROUPS,), generator=gen, device=dev)
        aff = pack_sim_affine(GROUPS, a, randn(GROUPS, scale=0.1), "wopos")
    return qkv, qemb, kemb_t, vemb, aff


def time_ms(torch, fn, reps: int = 15, inner: int = 5) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` back-to-back
    calls, per call, after a warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def work(kernel, gp, L, S, has_pos):
    """(bytes, operations) the function must move and do: each input read
    once, each output written once; operations per (group, query, key,
    stripe): qk 2c + affine 2 [+ qr 2c + kr 2c + affines 4 + adds 2],
    max 1, exp 1, sum 1, sv 2gp [+ sve 2gp]; per output element 1 divide;
    online rescaling not counted."""
    c = gp // 2
    tables = (2 * c + gp) * L * L if has_pos else 0
    outputs = GROUPS * gp * L * S * (2 if has_pos else 1)
    if kernel == "flash_lanes_fwd":
        outputs += 2 * GROUPS * L * S
    nbytes = 4 * (GROUPS * 2 * gp * L * S + tables + GROUPS * 8 + outputs)
    per_pair = 2 * c + 2 + 3 + 2 * gp
    if has_pos:
        per_pair += 4 * c + 6 + 2 * gp
    ops = GROUPS * L * L * S * per_pair + GROUPS * gp * L * S * (
        2 if has_pos else 1)
    return nbytes, ops


def phase_kernels(torch):
    from medt_tpu_torch.ops import axial_lanes

    fns = {"lanes_attn_fwd": (axial_lanes.lanes_attn_fwd,
                              axial_lanes.lanes_attn_plain),
           "flash_lanes_fwd": (axial_lanes.flash_lanes_fwd,
                               axial_lanes.flash_lanes_plain)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for kernel, L, gp, S, has_pos, per_fwd in GEOMETRIES:
        fn, plain = fns[kernel]
        args = core_inputs(torch, gen, gp, L, S, has_pos)
        got = fn(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        err = max(float((o - w).abs().max()) for o, w in zip(got[:2],
                                                             want[:2]))
        ok = err <= KERNEL_ATOL and all(bool(torch.isfinite(o).all())
                                        for o in got)
        for o, w in zip(got[2:], want[2:]):  # flash: m, l
            ok = ok and bool(((o - w).abs()
                              <= KERNEL_ATOL + ML_RTOL * w.abs()).all())
        ms = time_ms(torch, lambda: fn(*args))
        plain_ms = time_ms(torch, lambda: plain(*args), reps=10, inner=1)
        nbytes, ops = work(kernel, gp, L, S, has_pos)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
        row = {"kernel": kernel, "span": L, "gp": gp, "S": S, "g": GROUPS,
               "has_pos": has_pos, "launches_per_forward": per_fwd,
               "max_abs_err": err, "ok": ok, "ms": ms, "plain_ms": plain_ms,
               "bytes": nbytes, "ops": ops,
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        rows.append(row)
        print(json.dumps({"geometry": row}), flush=True)
        del args, got, want
    failed = [r for r in rows if not r["ok"]]
    emit("kernels", geometries=len(rows), tolerance=KERNEL_ATOL,
         failed=len(failed))
    check(not failed, f"kernel disagrees with its plain version: {failed}")
    return rows


# ---- 4. serve --------------------------------------------------------------

def phase_serve(torch):
    import numpy as np

    from medt_tpu_torch.models import build_model
    from medt_tpu_torch.ops import axial_lanes
    from medt_tpu_torch.serving import InferenceEngine

    variables = build_model("MedT", img_size=IMG, seed=0,
                            device="cpu").state_dict()
    engine = InferenceEngine("MedT", IMG, variables=variables,
                             batch_size=BATCH, max_wait_ms=5.0)
    engine.warmup()
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, size=(IMG, IMG, 3), dtype=np.uint8)
              for _ in range(64)]

    # -- the main path, counted -------------------------------------------
    axial_lanes.reset_launch_counts()
    batches0 = engine.batches_run
    engine.start()
    futures, lock = [], threading.Lock()

    def client(k):
        for i in range(k, 48, 4):  # 4 threads x 12 requests
            fut = engine.submit(images[i], priority=0 if i % 3 else 5)
            with lock:
                futures.append(fut)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in threads), "client threads hung")
    masks = [f.result(timeout=300) for f in futures]
    engine.stop()
    stats = engine.stats()

    full = images[:BATCH]
    masks += engine.predict_batch(full)
    iters = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        masks += engine.predict_batch(full)   # ends in a device->host copy
    elapsed = time.perf_counter() - t0
    counts = axial_lanes.launch_counts()
    forwards = engine.batches_run - batches0
    # -- end of the counted run ----------------------------------------------

    check(len(masks) == 48 + BATCH * (iters + 1), "missing masks")
    check(all(m.shape == (IMG, IMG) and m.dtype == np.uint8 for m in masks),
          "masks must be (128, 128) uint8")
    check(all(set(np.unique(m).tolist()) <= {0, 1} for m in masks),
          "masks must hold 0/1")
    expect = {"lanes_attn_fwd": 16 * forwards, "flash_lanes_fwd": 6 * forwards}
    check(counts == expect, f"launch counts {counts} != {expect} for "
                            f"{forwards} forwards")

    plain = InferenceEngine("MedT", IMG, variables=variables,
                            batch_size=BATCH, plain_cores=True)
    got = engine.logits(full)
    want = plain.logits(full)
    torch.cuda.synchronize()
    check(tuple(got.shape) == (BATCH, 2, IMG, IMG), f"logits {got.shape}")
    check(bool(torch.isfinite(got).all()), "non-finite logits")
    logits_err = float((got - want).abs().max())
    check(logits_err <= LOGITS_ATOL,
          f"logits vs plain cores: {logits_err} > {LOGITS_ATOL}")
    lat = stats.get("latency_ms", {})
    emit("serve", model="MedT", img=IMG, batch=BATCH, forwards=forwards,
         launches=counts, submitted=48, priorities=[0, 5],
         images_per_s=BATCH * iters / elapsed,
         batch_ms=elapsed / iters * 1e3,
         latency_p50_ms=lat.get("p50"), latency_p99_ms=lat.get("p99"),
         logits_max_abs_err=logits_err,
         logits_max_abs=float(want.abs().max()), tolerance=LOGITS_ATOL)
    return counts


def summary(rows, counts):
    kernels = []
    for name in ("lanes_attn_fwd", "flash_lanes_fwd"):
        mine = [r for r in rows if r["kernel"] == name]
        served = [r for r in mine if r["launches_per_forward"]]
        b = sum(r["bytes"] / HBM_BYTES_PER_S * r["launches_per_forward"]
                for r in served)
        o = sum(r["ops"] / F32_FLOPS_PER_S * r["launches_per_forward"]
                for r in served)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            # times: one MedT-128 batch-16 forward's launches of the kernel
            "ms": sum(r["ms"] * r["launches_per_forward"] for r in served),
            "plain_ms": sum(r["plain_ms"] * r["launches_per_forward"]
                            for r in served),
            "bound_ms": sum(r["bound_ms"] * r["launches_per_forward"]
                            for r in served),
            "bound_by": "bytes" if b >= o else "operations",
            "library_ms": None,
        })
    return {"kernels": kernels}


def main() -> int:
    if not (REPO / "medt_tpu_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(medt_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    phase = "device"
    try:
        smi, name = phase_device(torch)
        phase = "build"
        phase_build()
        phase = "kernels"
        rows = phase_kernels(torch)
        phase = "serve"
        counts = phase_serve(torch)
    except Exception as e:  # report the phase, then fail without "ok"
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}")
        return 1
    print(json.dumps(summary(rows, counts)), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
