#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``medt_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing one JSON line with ``phase`` and ``seconds`` (since
the start of the script) as it ends:

1. ``device``  — the card (nvidia-smi name and power limit); TF32 off.
2. ``build``   — every kernel source compiled by one plain ``nvcc``
   command into a ``ctypes``-loaded library.
3. ``kernels`` — each kernel held against its plain PyTorch version on the
   card at every geometry the serving, training and batch-1 paths give it
   (MedT 128 at batch 16 and at batch 1; both has_pos variants of each;
   gatedaxialunet's batch-1 geometries for the eval kernel), with
   CUDA-event times of kernel and plain version and the bound of each.
4. ``serve``   — the port's ``InferenceEngine`` serving MedT 128 at batch
   16 from a seeded random init: threaded ``submit`` at two priorities plus
   full-batch ``predict_batch`` calls; the launch counters must show every
   forward went through the kernels (16 lanes + 6 flash launches); the
   engine's logits are held against the same model on plain cores.
5. ``predict`` — the batch-1 evaluation path: ``cli.test`` over 32
   synthetic 128x128 image/mask PNG pairs and ``cli.predict`` over three
   unlabelled images (128x128, 256x192 and 96x112: the window route for the
   last two), in process, from a seeded MedT-128 checkpoint written by
   ``save_checkpoint``; every batch-1 forward launches the eval kernel 14
   times and the lanes kernel 8 times; ``metrics.json`` holds 32 finite
   scores; each mask has its image's size; the batch-1 logits are held
   against plain cores; batch-1 images/s and p50 per-image ms (host clock
   from the batch on the host to the mask on the host; the rate leaves out
   the first image).
6. ``train``   — ``train_step`` of MedT 128 at full width, batch 16, Adam-L2,
   on a synthetic blob batch: counted, 3 warm-up and 10 timed steps (ms
   per step, images/s) and 20 more steps on the same batch, whose loss
   must fall; every step launches 16 + 6 forward, 16 + 6 backward and
   22 + 22 moments kernels. Then one step on the kernels against the same
   step on plain cores from identical weights, with cuDNN deterministic:
   the loss, every gradient and the running statistics.
7. ``tf32``    — what TF32 does to MedT 128 against TF32 off: batch-16 and
   batch-1 logits, one train-mode forward and backward (loss, gradients),
   and the time of each.

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
# backward and moments: each output a sum over up to S*L terms (S*L*L for
# the sums), so per tensor atol 1e-4 + 1e-4 * max|plain|
SUM_RTOL = 1e-4
LOGITS_ATOL = 1e-3   # whole model, kernels vs plain cores
# train step, kernels vs plain cores, per tensor: 1e-5 + 1e-4 * max|plain|
# plus STEP_NOISE_FACTOR times the spread of the plain step itself when
# its input is perturbed by STEP_INPUT_NOISE (relative): the train-mode
# network amplifies float32 rounding, as tests/test_torch_port_training.py
# explains
STEP_INPUT_NOISE = 1e-6
STEP_NOISE_FACTOR = 4.0

SOURCES = {
    "lanes_attn_fwd": "medt_tpu_torch/csrc/axial_lanes_fwd.cu",
    "flash_lanes_fwd": "medt_tpu_torch/csrc/axial_lanes_fwd.cu",
    "lanes_attn_bwd": "medt_tpu_torch/csrc/axial_lanes_bwd.cu",
    "flash_lanes_bwd": "medt_tpu_torch/csrc/axial_lanes_bwd.cu",
    "moment_sums_fwd": "medt_tpu_torch/csrc/moments.cu",
    "moment_sums_bwd": "medt_tpu_torch/csrc/moments.cu",
    "axial_eval_fwd": "medt_tpu_torch/csrc/axial_eval_fwd.cu",
}
REPLACES = {
    "lanes_attn_fwd": "medt_tpu/ops/pallas_axial_lanes.py:333",
    "flash_lanes_fwd": "medt_tpu/ops/pallas_axial_lanes.py:705",
    "lanes_attn_bwd": "medt_tpu/ops/pallas_axial_lanes.py:381",
    "flash_lanes_bwd": "medt_tpu/ops/pallas_axial_lanes.py:759",
    "moment_sums_fwd": "medt_tpu/ops/pallas_moments.py:189",
    "moment_sums_bwd": "medt_tpu/ops/pallas_moments.py:310",
    "axial_eval_fwd": "medt_tpu/ops/pallas_axial.py:165",
}
# The attention sites of MedT 128 at batch 16, g = 8 everywhere:
# (span, gp, stripes, has_pos, sites). Global branch (gated, positions):
# flash; local branch (wopos): lanes. One train step runs each site's
# forward core, backward core, moments forward and moments backward once;
# one forward (serving) runs its forward core once.
SITES = [
    (64, 2, 1024, True, 2), (64, 4, 1024, True, 2), (32, 4, 512, True, 2),
    (16, 2, 4096, False, 2), (16, 4, 4096, False, 2), (8, 4, 2048, False, 2),
    (8, 8, 2048, False, 2), (4, 8, 1024, False, 6), (4, 16, 1024, False, 2),
]
# the other has_pos variant of each kernel (logo, gatedaxialunet run it)
OTHER_VARIANT = {"flash": (64, 4, 1024, False), "lanes": (16, 2, 4096, True)}
# The eval kernel's sites in one MedT-128 batch-1 forward (14 of the 22;
# the other 8 run the lanes kernel): (span, gp, stripes, has_pos, sites);
# then gatedaxialunet-128's batch-1 geometries (sites 0: not on MedT's path)
EVAL_SITES = [
    (4, 8, 64, False, 6), (4, 16, 64, False, 2), (32, 4, 32, True, 2),
    (64, 2, 64, True, 2), (64, 4, 64, True, 2),
    (16, 8, 16, True, 0), (16, 16, 16, True, 0), (32, 8, 32, True, 0),
]
# lanes sites of the same batch-1 forward: (8, 4, 128), (8, 8, 128),
# (16, 2, 256), (16, 4, 256), two each
BATCH1_LAUNCHES = {"axial_eval_fwd": 14, "lanes_attn_fwd": 8}


def _geometries():
    """(kernel, span, gp, stripes, has_pos, launches per forward or per
    train step): launches 0 marks an other-variant row."""
    rows = []
    for fwd, bwd, family in (("flash_lanes_fwd", "flash_lanes_bwd", "flash"),
                             ("lanes_attn_fwd", "lanes_attn_bwd", "lanes")):
        mine = [site for site in SITES if (site[0] > 16) == (family == "flash")]
        for kernel in (fwd, bwd):
            rows += [(kernel, *site) for site in mine]
            rows.append((kernel, *OTHER_VARIANT[family], 0))
    for kernel in ("moment_sums_fwd", "moment_sums_bwd"):
        rows += [(kernel, *site) for site in SITES]
        rows += [(kernel, *v, 0) for v in OTHER_VARIANT.values()]
    rows += [("axial_eval_fwd", *site) for site in EVAL_SITES]
    return rows


GEOMETRIES = _geometries()
KERNELS = list(SOURCES)
GROUPS = 8
BATCH = 16
IMG = 128
TRAIN_LR = 1e-3


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
    """``-Xptxas -v`` per kernel instance: {"<kernel><template args>": "..."}
    with registers, spills and shared memory."""
    out, label = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"'(_Z\w+)'", line)
            name = m.group(1) if m else line
            k = re.search(r"(\d+)([a-z][a-z_]*?_kernel)(I\w*?EE)?", name)
            label = (k.group(2) + (k.group(3) or "")) if k else name
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
    once, each output written once. Operations per (group, query, key,
    stripe) pair, float32, counting multiply and add apart:
    forward: qk 2c + affine 2 [+ qr 2c + kr 2c + affines 4 + adds 2], max,
    exp, sum 3, sv 2gp [+ sve 2gp]; per output element 1 divide; online
    rescaling not counted. The eval kernel: the same pairs, and per output
    element its 1/l scaling and output affine. Backward: the forward's logits and exp again
    (the softmax is recomputed or rebuilt from m, l), dsim 2gp [+ 2gp],
    dlog 2, dv 2gp, dq 2c [+ 2c], dk 2c [+ 2c], daff sums 3 [+ 4], table
    gradients [2c + 2c + 2gp]. Moments per (group, position, stripe):
    q/k sums 2c, pair products 2c(c+1) [+ r terms 4c, e terms 2c(c+1)];
    the backward's dq/dk 4c^2 + 4c [+ 4c^2 + 4c] and table terms
    [2c + 2c^2], plus its per-stripe sums."""
    c = gp // 2
    g = GROUPS
    qkv = g * 2 * gp * L * S
    tables = (2 * c + gp) * L * L if has_pos else 0
    sv = g * gp * L * S
    row = g * L * S
    pairs = g * L * L * S
    logit_ops = 2 * c + 2 + (4 * c + 6 if has_pos else 0)
    if kernel == "axial_eval_fwd":
        # + the (g, 4, gp) output affine in; per output element the 1/l
        # scaling and the affine (pos: 2 + 5, without: 1 + 3)
        nbytes = 4 * (qkv + tables + g * 8 + g * 4 * gp + sv)
        ops = pairs * (logit_ops + 3 + 2 * gp * (2 if has_pos else 1)) \
            + sv * (7 if has_pos else 4)
    elif kernel in ("lanes_attn_fwd", "flash_lanes_fwd"):
        outputs = sv * (2 if has_pos else 1)
        if kernel == "flash_lanes_fwd":
            outputs += 2 * row
        nbytes = 4 * (qkv + tables + g * 8 + outputs)
        ops = pairs * (logit_ops + 3 + 2 * gp * (2 if has_pos else 1)) \
            + sv * (2 if has_pos else 1)
    elif kernel in ("lanes_attn_bwd", "flash_lanes_bwd"):
        grads_in = sv * (2 if has_pos else 1)
        saved = 2 * row + grads_in if kernel == "flash_lanes_bwd" else 0
        nbytes = 4 * (qkv + tables + g * 8 + grads_in + saved       # in
                      + qkv + tables + g * 8)                        # out
        per_pair = logit_ops + 2 + 2 * gp + 2 + 2 * gp + 4 * c + 3
        if has_pos:
            per_pair += 2 * gp + 4 * c + 4 + 4 * c + 2 * gp
        ops = pairs * per_pair
    else:
        mtables = (2 * c + 2 * c * c) * L if has_pos else 0
        qk = g * gp * L * S
        per_pos = 2 * c + 2 * c * (c + 1)
        if has_pos:
            per_pos += 4 * c + 2 * c * (c + 1)
        if kernel == "moment_sums_fwd":
            nbytes = 4 * (qk + mtables + g * 8)
            ops = g * L * S * per_pos
        else:
            nbytes = 4 * (qk + mtables + g * 8 + qkv + mtables)
            per_pos += 4 * c * c + 4 * c
            if has_pos:
                per_pos += 4 * c * c + 4 * c + 2 * c + 2 * c * c
            ops = g * L * S * per_pos
    return nbytes, ops


def moment_inputs(torch, gen, gp, L, S, has_pos):
    """The moments core's inputs at a site: the qkv and its tables, built
    from position tables as the attention builds them."""
    qkv, qemb, kemb_t, _, _ = core_inputs(torch, gen, gp, L, S, has_pos)
    if not has_pos:
        zr = torch.zeros((0, L), device="cuda")
        ze = torch.zeros((0, 0, L), device="cuda")
        return qkv, zr, ze, zr, ze
    kemb = kemb_t.transpose(1, 2)
    return (qkv, qemb.sum(2).contiguous(),
            torch.einsum("cij,dij->cdi", qemb, qemb).contiguous(),
            kemb.sum(2).contiguous(),
            torch.einsum("cji,dji->cdj", kemb, kemb).contiguous())


def eval_inputs(torch, gen, gp, L, S, has_pos):
    """The eval kernel's operands at a batch-1 site: q, k, v as views of one
    stripe-major (S, g, 2gp, L) qkv (as the model passes them), the tables
    (zero-size without positions) and both affines."""
    qkv, qemb, kemb_t, vemb, aff = core_inputs(torch, gen, gp, L, S, has_pos)
    c = gp // 2
    st = qkv.permute(3, 0, 1, 2).contiguous()
    out_aff = 0.5 + torch.rand((GROUPS, 4, gp), generator=gen, device="cuda")
    if not has_pos:
        out_aff[:, 2:] = 0.0
    kemb = kemb_t.transpose(1, 2).contiguous() if has_pos else kemb_t
    return (st[:, :, :c], st[:, :, c:gp], st[:, :, gp:], qemb, kemb, vemb,
            aff, out_aff)


def kernel_calls(torch, gen, kernel, gp, L, S, has_pos):
    """(kernel call, plain call, per-output relative tolerance?) with the
    inputs of one geometry bound."""
    from medt_tpu_torch.ops import axial_eval, axial_lanes, moments

    g = GROUPS
    if kernel == "axial_eval_fwd":
        ins = eval_inputs(torch, gen, gp, L, S, has_pos)
        return (lambda: (axial_eval.axial_eval_fwd(*ins),),
                lambda: (axial_eval.axial_attention_fused_plain(*ins),))
    if kernel.startswith("moment"):
        ins = moment_inputs(torch, gen, gp, L, S, has_pos)
        if kernel == "moment_sums_fwd":
            return (lambda: (moments.moment_sums_fwd(*ins),),
                    lambda: (moments.moment_sums_plain(*ins),))
        ct = torch.randn((g, 8), generator=gen, device="cuda")
        return (lambda: moments.moment_sums_bwd(*ins, ct),
                lambda: moments.moment_sums_bwd_plain(*ins, ct))
    args = core_inputs(torch, gen, gp, L, S, has_pos)
    if kernel == "lanes_attn_fwd":
        return (lambda: axial_lanes.lanes_attn_fwd(*args),
                lambda: axial_lanes.lanes_attn_plain(*args))
    if kernel == "flash_lanes_fwd":
        return (lambda: axial_lanes.flash_lanes_fwd(*args),
                lambda: axial_lanes.flash_lanes_plain(*args))
    dsv = torch.randn((g, gp, L, S), generator=gen, device="cuda")
    dsve = torch.randn((g, gp, L, S), generator=gen, device="cuda")
    if kernel == "lanes_attn_bwd":
        return (lambda: axial_lanes.lanes_attn_bwd(*args, dsv, dsve),
                lambda: axial_lanes.lanes_attn_bwd_plain(*args, dsv, dsve))
    sv, sve, m, l = axial_lanes.flash_lanes_plain(*args)
    saved = (m, l, sv, sve)
    return (lambda: axial_lanes.flash_lanes_bwd(*args, *saved, dsv, dsve),
            lambda: axial_lanes.flash_lanes_bwd_plain(*args, *saved, dsv,
                                                      dsve))


def compare(torch, kernel, got, want):
    """(max |got - want| over the outputs, within tolerance?)"""
    err, ok = 0.0, True
    for i, (o, w) in enumerate(zip(got, want)):
        if not w.numel():
            continue
        d = float((o - w).abs().max())
        err = max(err, d)
        ok = ok and bool(torch.isfinite(o).all())
        if kernel.endswith("_fwd") and not kernel.startswith("moment"):
            if i < 2:   # sv, sve (the eval kernel: its output)
                ok = ok and d <= KERNEL_ATOL
            else:       # flash: m, l
                ok = ok and bool(((o - w).abs()
                                  <= KERNEL_ATOL + ML_RTOL * w.abs()).all())
        else:
            ok = ok and d <= 1e-4 + SUM_RTOL * float(w.abs().max())
    return err, ok


def phase_kernels(torch):
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for kernel, L, gp, S, has_pos, per_call in GEOMETRIES:
        fn, plain = kernel_calls(torch, gen, kernel, gp, L, S, has_pos)
        got, again, want = fn(), fn(), plain()
        torch.cuda.synchronize()
        err, ok = compare(torch, kernel, got, want)
        repeatable = all(torch.equal(a, b) for a, b in zip(got, again))
        ms = time_ms(torch, fn)
        plain_ms = time_ms(torch, plain, reps=5, inner=1)
        nbytes, ops = work(kernel, gp, L, S, has_pos)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
        row = {"kernel": kernel, "span": L, "gp": gp, "S": S, "g": GROUPS,
               "has_pos": has_pos, "launches_per_call": per_call,
               "max_abs_err": err, "ok": ok and repeatable,
               "repeatable": repeatable, "ms": ms, "plain_ms": plain_ms,
               "bytes": nbytes, "ops": ops,
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        rows.append(row)
        print(json.dumps({"geometry": row}), flush=True)
        del fn, plain, got, again, want
    failed = [r for r in rows if not r["ok"]]
    emit("kernels", geometries=len(rows), tolerance={
        "forward": KERNEL_ATOL, "backward_and_moments_rtol": SUM_RTOL},
         failed=len(failed))
    check(not failed, f"kernel disagrees with its plain version: {failed}")
    return rows


# ---- 4. serve --------------------------------------------------------------

def phase_serve(torch):
    import numpy as np

    from medt_tpu_torch import ops
    from medt_tpu_torch.models import build_model
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
    ops.reset_launch_counts()
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
    counts = ops.launch_counts()
    forwards = engine.batches_run - batches0
    # -- end of the counted run ----------------------------------------------

    check(len(masks) == 48 + BATCH * (iters + 1), "missing masks")
    check(all(m.shape == (IMG, IMG) and m.dtype == np.uint8 for m in masks),
          "masks must be (128, 128) uint8")
    check(all(set(np.unique(m).tolist()) <= {0, 1} for m in masks),
          "masks must hold 0/1")
    expect = {name: 0 for name in counts}
    expect.update(lanes_attn_fwd=16 * forwards, flash_lanes_fwd=6 * forwards)
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


# ---- 5. predict ---------------------------------------------------------------

PREDICT_IMAGES = 32
UNLABELLED = {"a_128x128.png": (128, 128), "b_256x192.png": (256, 192),
              "c_96x112.png": (96, 112)}


def phase_predict(torch):
    """The batch-1 evaluation path: ``cli.test`` over 32 labelled PNG pairs
    and ``cli.predict`` over three unlabelled images (one of the model's
    size, a larger and a smaller one: the window route), in process on the
    card, from a seeded MedT-128 checkpoint written with the port's
    ``save_checkpoint``. Every batch-1 forward must launch the eval kernel
    14 times and the lanes kernel 8 times; the batch-1 logits on the
    kernels are held against the same checkpoint on plain cores."""
    import shutil

    import numpy as np

    from medt_tpu_torch import ops
    from medt_tpu_torch.cli import predict as cli_predict
    from medt_tpu_torch.cli import test as cli_test
    from medt_tpu_torch.config import parse_config
    from medt_tpu_torch.data import make_png_dataset, read_png, write_png
    from medt_tpu_torch.data.transforms import to_float01
    from medt_tpu_torch.models import build_model
    from medt_tpu_torch.training import save_checkpoint

    root = REPO / "_smoke"
    shutil.rmtree(root, ignore_errors=True)
    labelled = make_png_dataset(str(root / "labelled"), PREDICT_IMAGES, IMG,
                                seed=0)
    rng = np.random.default_rng(1)
    (root / "unlabelled" / "img").mkdir(parents=True)
    for name, shape in UNLABELLED.items():
        write_png(str(root / "unlabelled" / "img" / name),
                  rng.integers(0, 256, size=shape + (3,), dtype=np.uint8))
    save_checkpoint(str(root / "ckpt"), 0,
                    build_model("MedT", img_size=IMG, seed=0, device="cpu"))
    common = ["--modelname", "MedT", "--imgsize", str(IMG), "--loaddirec",
              str(root / "ckpt" / "final_model"), "--workers", "2"]
    test_argv = ["--val_dataset", labelled, "--direc",
                 str(root / "test_out")] + common
    predict_argv = ["--val_dataset", str(root / "unlabelled"), "--direc",
                    str(root / "predict_out")] + common

    # -- the main path, counted: cli.test at batch 1 -------------------------
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = cli_test.main(test_argv)
    test_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    # -- end of the counted run -------------------------------------------------
    expect = {name: 0 for name in counts}
    expect.update({k: v * PREDICT_IMAGES for k, v in BATCH1_LAUNCHES.items()})
    check(counts == expect, f"cli.test launch counts {counts} != {expect}")
    metrics = json.loads((root / "test_out" / "metrics.json").read_text())
    check(metrics["images"] == PREDICT_IMAGES and
          len(metrics["per_image_f1"]) == PREDICT_IMAGES,
          f"metrics.json has {metrics['images']} images")
    scores = metrics["per_image_f1"] + metrics["per_image_iou"] + [
        metrics["mean_f1"], metrics["mean_iou"]]
    check(all(np.isfinite(scores)), "non-finite scores in metrics.json")
    masks = sorted((root / "test_out").glob("*.png"))
    check(len(masks) == PREDICT_IMAGES and all(
        read_png(str(m), gray=True).shape == (IMG, IMG) for m in masks),
        "cli.test must write one 128x128 mask per image")

    # cli.predict: one batch-1 forward for the 128x128 image, one batch-16
    # window forward each for the larger (6 tiles) and the smaller image
    ops.reset_launch_counts()
    written = dict(cli_predict.main(predict_argv))
    pcounts = ops.launch_counts()
    pexpect = {name: 0 for name in pcounts}
    pexpect.update(axial_eval_fwd=14, lanes_attn_fwd=8 + 2 * 16,
                   flash_lanes_fwd=2 * 6)
    check(pcounts == pexpect, f"cli.predict launch counts {pcounts} != "
                              f"{pexpect}")
    for name, shape in UNLABELLED.items():
        got = read_png(str(root / "predict_out" / name), gray=True)
        check(written.get(name) == shape and got.shape == shape,
              f"{name}: mask {got.shape} for an image of {shape}")

    # batch-1 logits on the kernels vs on plain cores, same checkpoint
    cfg = parse_config(test_argv)
    image = read_png(str(Path(labelled) / "img" / "000.png"))
    x = torch.from_numpy(to_float01(image)).cuda().permute(2, 0, 1)[None]
    with torch.inference_mode():
        got = cli_test.load_model(cfg, "cuda")(x)
        want = cli_test.load_model(cfg, "cuda", plain_cores=True)(x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), "non-finite batch-1 logits")
    check(err <= LOGITS_ATOL, f"batch-1 logits vs plain cores: {err} > "
                              f"{LOGITS_ATOL}")
    per_image = result["per_image_ms"]
    emit("predict", model="MedT", img=IMG, batch=1, images=PREDICT_IMAGES,
         launches=counts, predict_launches=pcounts,
         images_per_s=(len(per_image) - 1) / (sum(per_image[1:]) / 1e3),
         per_image_ms_p50=statistics.median(per_image),
         per_image_ms_max=max(per_image),
         cli_test_wall_s=test_s, mean_f1=metrics["mean_f1"],
         mean_iou=metrics["mean_iou"],
         window_masks={k: list(v) for k, v in written.items()},
         logits_max_abs_err=err, logits_max_abs=float(want.abs().max()),
         tolerance=LOGITS_ATOL)
    shutil.rmtree(root, ignore_errors=True)
    return counts


# ---- 6. train ---------------------------------------------------------------

PER_STEP = {"lanes_attn_fwd": 16, "flash_lanes_fwd": 6, "lanes_attn_bwd": 16,
            "flash_lanes_bwd": 6, "moment_sums_fwd": 22, "moment_sums_bwd": 22}


def phase_train(torch):
    import numpy as np

    from medt_tpu_torch import ops
    from medt_tpu_torch.data import blob_batch
    from medt_tpu_torch.models import build_model
    from medt_tpu_torch.training import TrainState, adam_l2, train_step

    variables = build_model("MedT", img_size=IMG, seed=0,
                            device="cpu").state_dict()
    images, masks = blob_batch(BATCH, IMG, seed=0)
    batch = {"image": images, "label": masks}

    def fresh(plain):
        model = build_model("MedT", img_size=IMG, use_fused=True,
                            plain_cores=plain, device="cuda")
        model.load_state_dict(variables, strict=True)
        return TrainState(model, adam_l2(model.parameters(), TRAIN_LR))

    def one_step(plain, image):
        state = fresh(plain)
        loss = float(train_step(state, {"image": image, "label": masks})
                     ["loss"])
        m = state.model
        grads = {k: p.grad.detach().clone() for k, p in m.named_parameters()
                 if p.requires_grad}
        stats = {k: b.detach().clone() for k, b in m.named_buffers()
                 if k.endswith(("running_mean", "running_var"))}
        return state, loss, grads, stats

    # -- the main path, counted: 3 warm-up, 10 timed, 20 more steps ------------
    state = fresh(False)
    ops.reset_launch_counts()
    loss0 = train_step(state, batch)["loss"]
    for _ in range(2):
        train_step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        train_step(state, batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 10
    losses = [train_step(state, batch)["loss"] for _ in range(20)]
    losses = torch.stack(losses).tolist()
    counts = ops.launch_counts()
    # -- end of the counted run ----------------------------------------------
    del state

    # -- one step on the kernels vs the same step on plain cores ------------
    torch.backends.cudnn.deterministic = True
    _, loss_k, grads_k, stats_k = one_step(False, images)
    _, loss_p, grads_p, stats_p = one_step(True, images)
    x = images.astype(np.float32) / 255.0
    rng = np.random.default_rng(1)
    spread = [one_step(True, (x * (1.0 + STEP_INPUT_NOISE
                                   * rng.standard_normal(x.shape)))
                       .astype(np.float32))[1:] for _ in range(2)]
    torch.backends.cudnn.deterministic = False

    def held(name, got, want, others):
        runs = [want] + others
        noise = max(float((a - b).abs().max()) for i, a in enumerate(runs)
                    for b in runs[i + 1:])
        err = float((got - want).abs().max())
        tol = (1e-5 + 1e-4 * float(want.abs().max())
               + STEP_NOISE_FACTOR * noise)
        return {"name": name, "err": err, "tol": tol, "ok": err <= tol and
                bool(torch.isfinite(got).all())}

    checks = [held("loss", torch.tensor(loss_k), torch.tensor(loss_p),
                   [torch.tensor(s[0]) for s in spread])]
    checks += [held(k, grads_k[k], grads_p[k], [s[1][k] for s in spread])
               for k in grads_p]
    checks += [held(k, stats_k[k], stats_p[k], [s[2][k] for s in spread])
               for k in stats_p]
    bad = [c for c in checks if not c["ok"]]
    worst = max(checks, key=lambda c: c["err"] / c["tol"])

    steps = 33
    expect = {name: 0 for name in counts}
    expect.update({k: v * steps for k, v in PER_STEP.items()})
    emit("train", model="MedT", img=IMG, batch=BATCH, optimizer="adam_l2",
         lr=TRAIN_LR, loss_kernels=loss_k, loss_plain=loss_p,
         parity_tensors=len(checks), parity_failed=len(bad),
         parity_worst=worst, steps_counted=steps, launches=counts,
         ms_per_step=step_s * 1e3, images_per_s=BATCH / step_s,
         loss_step0=float(loss0), loss_first=losses[0],
         loss_last=losses[-1],
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(not bad, f"train step on kernels vs plain cores: {bad[:5]}")
    check(counts == expect, f"launch counts {counts} != {expect} for "
                            f"{steps} steps")
    check(all(np.isfinite(losses)), "non-finite loss")
    check(np.mean(losses[-5:]) < np.mean(losses[:5]),
          f"loss did not fall over 20 steps: {losses}")
    return counts


# ---- TF32 ---------------------------------------------------------------------

def set_tf32(torch, on: bool):
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def phase_tf32(torch):
    """What TF32 (PyTorch's default for cuDNN convolutions) does to MedT 128
    on the card, against TF32 off: the logits of one batch-16 and one
    batch-1 eval forward, and one train-mode forward and backward at batch
    16 (loss, every gradient), with the times of each. Measured on the
    model itself, so the entry points' own TF32 setting does not enter."""
    import numpy as np

    from medt_tpu_torch.data import blob_batch
    from medt_tpu_torch.losses import log_nll_loss
    from medt_tpu_torch.models import build_model
    from medt_tpu_torch.training.state import normalize

    variables = build_model("MedT", img_size=IMG, seed=0,
                            device="cpu").state_dict()
    images, masks = blob_batch(BATCH, IMG, seed=0)
    x = normalize(images, "cuda")
    labels = torch.from_numpy(masks).cuda()
    model = build_model("MedT", img_size=IMG, use_fused=True, device="cuda")

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / reps * 1e3

    def eval_logits(batch):
        model.load_state_dict(variables, strict=True)
        model.eval()
        with torch.inference_mode():
            return model(x[:batch]).clone()

    def train_grads():
        model.load_state_dict(variables, strict=True)
        model.train()
        model.zero_grad(set_to_none=True)
        loss = log_nll_loss(model(x), labels)
        loss.backward()
        return loss.detach(), {k: p.grad.detach().clone()
                               for k, p in model.named_parameters()
                               if p.grad is not None}

    result = {}
    for on in (False, True):
        set_tf32(torch, on)
        b16, ms16 = timed(lambda: eval_logits(BATCH), 5)
        b1, ms1 = timed(lambda: eval_logits(1), 5)
        (loss, grads), ms_train = timed(train_grads, 3)
        result[on] = dict(b16=b16, b1=b1, loss=loss, grads=grads,
                          ms=(ms16, ms1, ms_train))
    set_tf32(torch, False)
    off, on = result[False], result[True]
    grad_err = {k: float((on["grads"][k] - g).abs().max())
                for k, g in off["grads"].items()}
    rel = {k: e / max(float(off["grads"][k].abs().max()), 1e-30)
           for k, e in grad_err.items()}
    worst = max(rel, key=rel.get)
    emit("tf32", model="MedT", img=IMG,
         logits_b16_max_abs_diff=float((on["b16"] - off["b16"]).abs().max()),
         logits_b16_max_abs=float(off["b16"].abs().max()),
         logits_b1_max_abs_diff=float((on["b1"] - off["b1"]).abs().max()),
         loss_off=float(off["loss"]), loss_on=float(on["loss"]),
         grad_max_abs_diff=max(grad_err.values()),
         grad_worst_relative={"name": worst, "relative": rel[worst]},
         grads_compared=len(grad_err),
         eval_b16_ms={"off": off["ms"][0], "on": on["ms"][0]},
         eval_b1_ms={"off": off["ms"][1], "on": on["ms"][1]},
         train_fwd_bwd_ms={"off": off["ms"][2], "on": on["ms"][2]},
         parity_tolerance=LOGITS_ATOL)
    check(all(np.isfinite(float(t["loss"])) for t in result.values()),
          "non-finite loss")


def summary(rows, serve_counts, train_counts, predict_counts):
    """One entry per kernel; times per call of its main path: one MedT-128
    batch-16 forward (serving) for the forward cores, one train step for
    the backward and moments kernels, one batch-1 forward (``cli.test``)
    for the eval kernel."""
    kernels = []
    for name in KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        used = [r for r in mine if r["launches_per_call"]]
        n = [r["launches_per_call"] for r in used]
        b = sum(r["bytes"] / HBM_BYTES_PER_S * k for r, k in zip(used, n))
        o = sum(r["ops"] / F32_FLOPS_PER_S * k for r, k in zip(used, n))
        if name == "axial_eval_fwd":
            counts = predict_counts
        elif name.endswith("fwd") and not name.startswith("moment"):
            counts = serve_counts
        else:
            counts = train_counts
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["ms"] * k for r, k in zip(used, n)),
            "plain_ms": sum(r["plain_ms"] * k for r, k in zip(used, n)),
            "bound_ms": sum(r["bound_ms"] * k for r, k in zip(used, n)),
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
        serve_counts = phase_serve(torch)
        phase = "predict"
        predict_counts = phase_predict(torch)
        phase = "train"
        train_counts = phase_train(torch)
        phase = "tf32"
        phase_tf32(torch)
    except Exception as e:  # report the phase, then fail without "ok"
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}")
        return 1
    print(json.dumps(summary(rows, serve_counts, train_counts,
                             predict_counts)), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
