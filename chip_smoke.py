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
   (MedT 128 at batch 16 and at batch 1, the lanes forward's batch-1 sites
   included; both has_pos variants of each;
   gatedaxialunet's batch-1 geometries for the eval kernel; medt_512 at
   batch 4: flash2, flash, lanes and moments; flash2 without positions at
   one more geometry; the stripe kernels at the batch-1 and batch-2 train
   sites of MedT and gatedaxialunet at 128 and 64 px and at span 64, gp 8,
   and the stripe forward at the edges of its warp-over-keys body),
   with CUDA-event times of kernel and plain version and the bound of each.
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
8. ``serve512`` — ``InferenceEngine("medt_512", 512, batch_size=4)`` from a
   seeded init: threaded ``submit`` plus timed full batches; every forward
   launches 6 flash2 + 8 flash + 8 lanes kernels; logits against plain
   cores; images/s.
9. ``predict512`` — ``cli.test`` at ``--imgsize 512`` over 4 synthetic
   512x512 PNG pairs from a seeded medt_512 checkpoint: 6 + 8 + 8
   launches per image, 4 finite scores, p50 ms per image.
10. ``train512`` — ``train_step`` of medt_512 at batch 4 (``bench.py``'s
   ``M512_BATCH``), Adam-L2: 2 warm-up and 5 timed steps, 20 more whose
   loss must fall; every step launches 6 + 8 + 8 forward, 6 + 8 + 8
   backward and 22 + 22 moments kernels. Then one step on the kernels
   against one on plain cores at batch 1 (at batch 4 the plain flash2
   backward would hold several 2.1 GB logits-shaped tensors), held as the
   ``train`` phase holds MedT 128.
11. ``logo512`` — one batch-1 eval forward of logo_512 (positions in both
   branches) on the kernels against plain cores, with its launch counts.
12. ``train1`` — the training CLI at its default batch 1: ``cli.train``
   in process, MedT 128 over 16 synthetic 128x128 PNG pairs with 4 for
   validation, 2 epochs at ``--save_freq 1``, then ``--resume`` for a third
   epoch under ``--profile_dir``. Every step launches 6 + 6 stripe, 16 + 16
   lanes and 16 + 16 moments kernels, every validation forward 14 eval and
   8 lanes kernels; one mask per validation image per epoch at its size, a
   checkpoint per epoch, finite loss, F1 and IoU in ``train_log.jsonl`` and
   ``.csv``, the resumed run at epoch 2 with the optimizer step restored, a
   trace file; ms per step and images/s. Then one MedT-128 batch-1 step on
   the kernels against plain cores and one gatedaxialunet-128 batch-1 step
   (8 + 8 stripe launches) likewise, held as ``train`` holds its step.
   The run's epoch masks and labels stay under ``_smoke/`` for the sweep.
13. ``http`` — ``cli.serve.make_server`` on an ephemeral port over
   ``InferenceEngine("MedT", 128, loaddirec=<a seeded checkpoint>,
   batch_size=16, window_stride=64)``: 32 concurrent 128x128 PNG POSTs
   from 8 client threads at two ``X-Priority`` values, then 2 POSTs of a
   256x192 PNG (the window route: 6 tiles in one batch), counted; every
   forward launches 16 lanes + 6 flash kernels. Each response mask equals
   ``predict_batch`` (or ``predict``) of its image; ``/healthz``, a 404, a
   400 on a body that is not a PNG and a 503 with ``Retry-After`` from a
   full queue; any other status fails the phase. Requests/s, client p50
   and max ms of the 32, as observations (the rate and tail over a window
   of hundreds of requests: ``python -m medt_tpu_torch.profile_http``).
14. ``zoo`` — each kernel at the zoo paths' geometries that no earlier
   phase holds, against its plain version; gated_sig-128 (sigmoid gates
   folded into the fused train route) trained at batch 16 (8 + 8 flash,
   8 + 8 lanes, 16 + 16 moments launches per step) and at batch 1 (8 + 8
   stripe, 8 + 8 lanes, 8 + 8 moments): counted and timed steps, then one
   step on the kernels against plain cores; axialunet_wopos-128 eval
   forwards at batch 16 (8 flash + 8 lanes) and 1 (16 eval) against plain
   cores at ``LOGITS_ATOL``; gated_data, convnet_ablation, mix_net_gated_d,
   unetplusplus (its deep-supervision tuple), shallow and autoencoder: a
   batch-1 forward and a train step each, finite, of the right shapes,
   with no kernel launch (JAX runs them without kernels); then
   ``evaluation.sweep.sweep_checkpoint_grid`` over ``train1``'s epochs 0-2
   against its labels.

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
# The train phases' loss check. Each phase trains on one repeated batch;
# within a few steps Adam at lr 1e-3 overfits it, and from then on single
# steps spike at random (up to 5x the step-0 loss, on plain cores too). So
# the fall is measured from the step-0 loss, on the median of the counted
# loss steps, which spikes in fewer than half of them cannot move: the
# median must lie below LOSS_FALL times the step-0 loss.
LOSS_FALL = 0.5

SOURCES = {
    "lanes_attn_fwd": "medt_tpu_torch/csrc/axial_lanes_fwd.cu",
    "flash_lanes_fwd": "medt_tpu_torch/csrc/axial_flash_fwd.cu",
    "lanes_attn_bwd": "medt_tpu_torch/csrc/axial_lanes_bwd.cu",
    "flash_lanes_bwd": "medt_tpu_torch/csrc/axial_flash_bwd.cu",
    "moment_sums_fwd": "medt_tpu_torch/csrc/moments.cu",
    "moment_sums_bwd": "medt_tpu_torch/csrc/moments.cu",
    "axial_eval_fwd": "medt_tpu_torch/csrc/axial_eval_fwd.cu",
    "flash2_lanes_fwd": "medt_tpu_torch/csrc/axial_flash2_fwd.cu",
    "flash2_lanes_bwd": "medt_tpu_torch/csrc/axial_flash2_bwd.cu",
    "stripe_attn_fwd": "medt_tpu_torch/csrc/axial_stripe_fwd.cu",
    "stripe_attn_bwd": "medt_tpu_torch/csrc/axial_stripe_bwd.cu",
}
REPLACES = {
    "lanes_attn_fwd": "medt_tpu/ops/pallas_axial_lanes.py:333",
    "flash_lanes_fwd": "medt_tpu/ops/pallas_axial_lanes.py:705",
    "lanes_attn_bwd": "medt_tpu/ops/pallas_axial_lanes.py:381",
    "flash_lanes_bwd": "medt_tpu/ops/pallas_axial_lanes.py:759",
    "moment_sums_fwd": "medt_tpu/ops/pallas_moments.py:189",
    "moment_sums_bwd": "medt_tpu/ops/pallas_moments.py:310",
    "axial_eval_fwd": "medt_tpu/ops/pallas_axial.py:165",
    "flash2_lanes_fwd": "medt_tpu/ops/pallas_axial_lanes.py:1152",
    "flash2_lanes_bwd": "medt_tpu/ops/pallas_axial_lanes.py:1239",
    "stripe_attn_fwd": "medt_tpu/ops/pallas_axial_train.py:265",
    "stripe_attn_bwd": "medt_tpu/ops/pallas_axial_train.py:306",
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
# the lanes sites of the same batch-1 forward (the other 8 of the 22),
# (span, gp, stripes, has_pos, sites): fewer than two blocks per SM of
# whole query rows, so the lanes forward splits its rows into chunks there
LANES_B1_SITES = [
    (8, 4, 128, False, 2), (8, 8, 128, False, 2), (16, 2, 256, False, 2),
    (16, 4, 256, False, 2),
]
BATCH1_LAUNCHES = {"axial_eval_fwd": 14, "lanes_attn_fwd": 8}

# The attention sites of medt_512 at batch 4 (bench.py's M512_BATCH), g = 8:
# (span, gp, stripes, has_pos, sites). Global branch (gated, positions):
# flash2; local branch (wopos): flash and lanes. At batch 1 the stripes are
# a quarter, so no site reaches the eval kernel.
SITES_512 = [
    (256, 2, 1024, True, 2), (256, 4, 1024, True, 2), (128, 4, 512, True, 2),
    (64, 2, 4096, False, 2), (64, 4, 4096, False, 2), (32, 4, 2048, False, 2),
    (32, 8, 2048, False, 2), (16, 8, 1024, False, 6), (16, 16, 1024, False, 2),
]
# flash2 off the 512 path: the smallest span it takes, both variants
FLASH2_OTHER = [(96, 2, 256, True), (96, 2, 256, False)]
# launches per medt_512 forward (any batch) and per train step
M512_FORWARD = {"flash2_lanes_fwd": 6, "flash_lanes_fwd": 8,
                "lanes_attn_fwd": 8}
M512_STEP = {**M512_FORWARD, "flash2_lanes_bwd": 6, "flash_lanes_bwd": 8,
             "lanes_attn_bwd": 8, "moment_sums_fwd": 22,
             "moment_sums_bwd": 22}


# The stripe kernels' geometries, g = 8: (span, gp, stripes, sites per
# MedT-128 batch-1 train step). The first three are MedT-128's global branch
# at batch 1; then gatedaxialunet-128's fourth at batch 1, the batch-2 sites
# of MedT and gatedaxialunet at 128 px, gatedaxialunet-64's at batch 1, and
# span 64 at gp 8 off every path. Each with and without positions (the
# global branch has positions; only those count on the path).
STRIPE_SITES = [
    (64, 2, 64, 2), (64, 4, 64, 2), (32, 4, 32, 2), (32, 8, 32, 0),
    (32, 4, 64, 0), (32, 8, 64, 0), (32, 2, 32, 0), (64, 8, 64, 0),
]
# The stripe forward off every path, at the edges of its warp-over-keys
# body (csrc/stripe_attn_fwd.cuh), g = 8: (span, gp, stripes, has_pos).
# Spans that fill no span bucket (the odd ones take 4-byte copies) at
# ragged stripe counts, both variants; S = 1; gp 16 at span 64; stripe
# counts that leave the last block of pairs half full at each span bucket
# (blocks of fewer warps among them: the grids under 66 blocks).
STRIPE_EDGES = [
    (L, gp, S, pos) for L, gp, S in ((17, 4, 37), (33, 8, 21), (48, 2, 19),
                                     (63, 16, 5))
    for pos in (True, False)
] + [
    (40, 4, 1, True), (64, 8, 1, True), (64, 16, 64, True),
    (64, 16, 33, False), (4, 4, 527, True), (8, 4, 527, False),
    (16, 4, 527, True), (32, 4, 263, True), (32, 8, 263, False),
    (64, 2, 131, False), (64, 4, 33, True), (64, 8, 17, True),
]
# launches per MedT-128 batch-1 train step: the 6 global sites on the stripe
# kernels, the 16 local sites on the lanes kernel and the moments kernel
# (the stripe sites take their moments from einsums); per validation
# forward (batch 1, eval): BATCH1_LAUNCHES
MEDT_B1_STEP = {"stripe_attn_fwd": 6, "stripe_attn_bwd": 6,
                "lanes_attn_fwd": 16, "lanes_attn_bwd": 16,
                "moment_sums_fwd": 16, "moment_sums_bwd": 16}
# gatedaxialunet-128 at batch 1: 8 stripe sites, 8 lanes sites (span 16
# with 16 stripes)
UNET_B1_STEP = {"stripe_attn_fwd": 8, "stripe_attn_bwd": 8,
                "lanes_attn_fwd": 8, "lanes_attn_bwd": 8,
                "moment_sums_fwd": 8, "moment_sums_bwd": 8}


def _family(span: int) -> str:
    return "lanes" if span <= 16 else "flash" if span <= 64 else "flash2"


def _geometries():
    """(kernel, span, gp, stripes, has_pos, launches per forward or per
    train step, path): launches 0 marks a row off the path; path "medt128"
    (MedT 128 at batch 16, or batch 1 for the eval kernel) or "medt512"
    (medt_512 at batch 4) or "medt128b1" (MedT 128 trained at batch 1) or
    "medt128b1fwd" (the lanes sites of one MedT 128 batch-1 forward)."""
    rows = []
    for fwd, bwd, family in (("flash_lanes_fwd", "flash_lanes_bwd", "flash"),
                             ("lanes_attn_fwd", "lanes_attn_bwd", "lanes")):
        mine = [site for site in SITES if _family(site[0]) == family]
        for kernel in (fwd, bwd):
            rows += [(kernel, *site, "medt128") for site in mine]
            rows.append((kernel, *OTHER_VARIANT[family], 0, "medt128"))
    for kernel in ("moment_sums_fwd", "moment_sums_bwd"):
        rows += [(kernel, *site, "medt128") for site in SITES]
        rows += [(kernel, *v, 0, "medt128") for v in OTHER_VARIANT.values()]
    rows += [("axial_eval_fwd", *site, "medt128") for site in EVAL_SITES]
    rows += [("lanes_attn_fwd", *site, "medt128b1fwd")
             for site in LANES_B1_SITES]
    for direction in ("fwd", "bwd"):
        for site in SITES_512:
            family = _family(site[0])
            name = {"lanes": "lanes_attn", "flash": "flash_lanes",
                    "flash2": "flash2_lanes"}[family]
            rows.append((f"{name}_{direction}", *site, "medt512"))
        rows += [(f"flash2_lanes_{direction}", *v, 0, "medt512")
                 for v in FLASH2_OTHER]
    for kernel in ("moment_sums_fwd", "moment_sums_bwd"):
        rows += [(kernel, *site, "medt512") for site in SITES_512]
    for kernel in ("stripe_attn_fwd", "stripe_attn_bwd"):
        rows += [(kernel, L, gp, S, pos, n if pos else 0, "medt128b1")
                 for L, gp, S, n in STRIPE_SITES for pos in (True, False)]
    rows += [("stripe_attn_fwd", *edge, 0, "medt128b1")
             for edge in STRIPE_EDGES]
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


def kernel_label(mangled: str) -> str:
    """``<name><template args>`` of a mangled kernel name: the first
    length-prefixed identifier that ends in ``_kernel`` (names may hold
    digits, as flash2's do), else the mangled name."""
    for i in range(len(mangled)):
        digits = re.match(r"\d+", mangled[i:])
        if not digits:
            continue
        start = i + digits.end()
        ident = mangled[start:start + int(digits.group())]
        if ident.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", ident):
            args = re.match(r"I\w*?EE", mangled[start + len(ident):])
            return ident + (args.group() if args else "")
    return mangled


def ptxas_summary(log: str) -> dict:
    """``-Xptxas -v`` per kernel instance: {"<kernel><template args>": "..."}
    with registers, spills and shared memory."""
    out, label = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"'(_Z\w+)'", line)
            label = kernel_label(m.group(1)) if m else line
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
    element its 1/l scaling and output affine. The stripe kernels count as
    the lanes ones (the same work; q, k, v are the qkv's rows, stripe-major).
    Backward: the forward's logits and exp again
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
    elif kernel in ("lanes_attn_fwd", "flash_lanes_fwd", "flash2_lanes_fwd",
                    "stripe_attn_fwd"):
        outputs = sv * (2 if has_pos else 1)
        if kernel not in ("lanes_attn_fwd", "stripe_attn_fwd"):
            outputs += 2 * row
        nbytes = 4 * (qkv + tables + g * 8 + outputs)
        ops = pairs * (logit_ops + 3 + 2 * gp * (2 if has_pos else 1)) \
            + sv * (2 if has_pos else 1)
    elif kernel in ("lanes_attn_bwd", "flash_lanes_bwd", "flash2_lanes_bwd",
                    "stripe_attn_bwd"):
        grads_in = sv * (2 if has_pos else 1)
        saved = 2 * row + grads_in if kernel not in (
            "lanes_attn_bwd", "stripe_attn_bwd") else 0
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


def stripe_inputs(torch, gen, gp, L, S, has_pos):
    """The stripe kernels' operands at a site: q, k, v as views of one
    stripe-major (S, g, 2gp, L) qkv (as the attention passes them), the
    tables (kemb in [c, j, i]; zero-size without positions) and the
    affine."""
    qkv, qemb, kemb_t, vemb, aff = core_inputs(torch, gen, gp, L, S, has_pos)
    c = gp // 2
    st = qkv.permute(3, 0, 1, 2).contiguous()
    kemb = kemb_t.transpose(1, 2).contiguous() if has_pos else kemb_t
    return (st[:, :, :c], st[:, :, c:gp], st[:, :, gp:], qemb, kemb, vemb,
            aff)


def kernel_calls(torch, gen, kernel, gp, L, S, has_pos):
    """(kernel call, plain call, per-output relative tolerance?) with the
    inputs of one geometry bound."""
    from medt_tpu_torch.ops import (axial_eval, axial_lanes, axial_train,
                                    moments)

    g = GROUPS
    if kernel.startswith("stripe"):
        ins = stripe_inputs(torch, gen, gp, L, S, has_pos)
        if kernel == "stripe_attn_fwd":
            return (lambda: axial_train.stripe_attn_fwd(*ins),
                    lambda: axial_train.attn_core_plain(*ins,
                                                        has_pos=has_pos))
        dsv = torch.randn((S, g, gp, L), generator=gen, device="cuda")
        dsve = torch.randn((S, g, gp, L), generator=gen, device="cuda")
        return (lambda: axial_train.stripe_attn_bwd(*ins, dsv, dsve),
                lambda: axial_train.fused_attn_bwd_plain(*ins, dsv, dsve))
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
    if kernel in ("flash_lanes_fwd", "flash2_lanes_fwd"):
        fwd = getattr(axial_lanes, kernel)
        plain = getattr(axial_lanes, kernel.replace("_fwd", "_plain"))
        return lambda: fwd(*args), lambda: plain(*args)
    dsv = torch.randn((g, gp, L, S), generator=gen, device="cuda")
    dsve = torch.randn((g, gp, L, S), generator=gen, device="cuda")
    if kernel == "lanes_attn_bwd":
        return (lambda: axial_lanes.lanes_attn_bwd(*args, dsv, dsve),
                lambda: axial_lanes.lanes_attn_bwd_plain(*args, dsv, dsve))
    bwd = getattr(axial_lanes, kernel)
    plain = getattr(axial_lanes, kernel.replace("_bwd", "_bwd_plain"))
    sv, sve, m, l = axial_lanes.flash_lanes_plain(*args)
    saved = (m, l, sv, sve)
    return (lambda: bwd(*args, *saved, dsv, dsve),
            lambda: plain(*args, *saved, dsv, dsve))


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
    for kernel, L, gp, S, has_pos, per_call, path in GEOMETRIES:
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
               "has_pos": has_pos, "path": path,
               "launches_per_call": per_call,
               "max_abs_err": err, "ok": ok and repeatable,
               "repeatable": repeatable, "ms": ms, "plain_ms": plain_ms,
               "bytes": nbytes, "ops": ops,
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        rows.append(row)
        print(json.dumps({"geometry": row}), flush=True)
        del fn, plain, got, again, want
        torch.cuda.empty_cache()  # the 512 rows' plain versions are large
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
    model = build_model("MedT", img_size=IMG, use_fused=True, device="cuda")
    model.load_state_dict(variables, strict=True)
    state = TrainState(model, adam_l2(model.parameters(), TRAIN_LR))

    # -- the main path, counted: 3 warm-up, 10 timed, 20 more steps ------------
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
    del state, model

    # -- one step on the kernels vs the same step on plain cores ------------
    loss_k, loss_p, checks = step_parity(torch, "MedT", IMG, images, masks,
                                         variables)
    bad = [c for c in checks if not c["ok"]]
    worst = max(checks, key=lambda c: c["err"] / c["tol"])

    steps = 33
    expect = launches_of(counts, PER_STEP, steps)
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


# ---- 8-11. the 512 px models ---------------------------------------------------

M512, IMG512, BATCH512 = "medt_512", 512, 4   # bench.py: M512_BATCH = 4
PREDICT512_IMAGES = 4


def loss_fell(loss0: float, losses) -> bool:
    """The train phases' loss check (LOSS_FALL)."""
    return statistics.median(losses) < LOSS_FALL * loss0


def launches_of(counts: dict, per_call: dict, calls: int) -> dict:
    """The launch counts ``calls`` main-path calls must give: ``per_call``
    times ``calls``, every other wrapper 0."""
    expect = {name: 0 for name in counts}
    expect.update({k: v * calls for k, v in per_call.items()})
    return expect


def phase_serve512(torch):
    """medt_512 served at batch 4: threaded submits, then timed full
    batches; 6 flash2 + 8 flash + 8 lanes launches per forward; logits on
    the kernels vs plain cores."""
    import numpy as np

    from medt_tpu_torch import ops
    from medt_tpu_torch.models import build_model
    from medt_tpu_torch.serving import InferenceEngine

    variables = build_model(M512, seed=0, device="cpu").state_dict()
    engine = InferenceEngine(M512, IMG512, variables=variables,
                             batch_size=BATCH512, max_wait_ms=5.0)
    engine.warmup()
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, size=(IMG512, IMG512, 3), dtype=np.uint8)
              for _ in range(8)]

    # -- the main path, counted ------------------------------------------------
    ops.reset_launch_counts()
    batches0 = engine.batches_run
    engine.start()
    futures, lock = [], threading.Lock()

    def client(k):
        for i in range(k, 8, 2):  # 2 threads x 4 requests
            fut = engine.submit(images[i], priority=0 if i % 3 else 5)
            with lock:
                futures.append(fut)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in threads), "client threads hung")
    masks = [f.result(timeout=300) for f in futures]
    engine.stop()
    full = images[:BATCH512]
    masks += engine.predict_batch(full)
    iters = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        masks += engine.predict_batch(full)   # ends in a device->host copy
    elapsed = time.perf_counter() - t0
    counts = ops.launch_counts()
    forwards = engine.batches_run - batches0
    # -- end of the counted run ----------------------------------------------

    check(len(masks) == 8 + BATCH512 * (iters + 1), "missing masks")
    check(all(m.shape == (IMG512, IMG512) and m.dtype == np.uint8
              for m in masks), "masks must be (512, 512) uint8")
    expect = launches_of(counts, M512_FORWARD, forwards)
    check(counts == expect, f"launch counts {counts} != {expect} for "
                            f"{forwards} forwards")
    plain = InferenceEngine(M512, IMG512, variables=variables,
                            batch_size=BATCH512, plain_cores=True)
    got = engine.logits(full)
    want = plain.logits(full)
    torch.cuda.synchronize()
    check(tuple(got.shape) == (BATCH512, 2, IMG512, IMG512),
          f"logits {got.shape}")
    check(bool(torch.isfinite(got).all()), "non-finite logits")
    err = float((got - want).abs().max())
    check(err <= LOGITS_ATOL, f"logits vs plain cores: {err} > {LOGITS_ATOL}")
    emit("serve512", model=M512, img=IMG512, batch=BATCH512,
         forwards=forwards, launches=counts, submitted=8,
         images_per_s=BATCH512 * iters / elapsed,
         batch_ms=elapsed / iters * 1e3, logits_max_abs_err=err,
         logits_max_abs=float(want.abs().max()), tolerance=LOGITS_ATOL)
    del engine, plain
    torch.cuda.empty_cache()
    return counts


def phase_predict512(torch):
    """``cli.test`` at 512 px over 4 PNG pairs from a seeded medt_512
    checkpoint: 6 + 8 + 8 launches per batch-1 forward."""
    import shutil

    import numpy as np

    from medt_tpu_torch import ops
    from medt_tpu_torch.cli import test as cli_test
    from medt_tpu_torch.data import make_png_dataset
    from medt_tpu_torch.models import build_model
    from medt_tpu_torch.training import save_checkpoint

    root = REPO / "_smoke"
    shutil.rmtree(root, ignore_errors=True)
    labelled = make_png_dataset(str(root / "labelled"), PREDICT512_IMAGES,
                                IMG512, seed=0)
    save_checkpoint(str(root / "ckpt"), 0,
                    build_model(M512, seed=0, device="cpu"))
    argv = ["--val_dataset", labelled, "--direc", str(root / "test_out"),
            "--modelname", M512, "--imgsize", str(IMG512), "--loaddirec",
            str(root / "ckpt" / "final_model"), "--workers", "2"]

    # -- the main path, counted: cli.test at batch 1 -------------------------
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = cli_test.main(argv)
    wall_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    # -- end of the counted run -------------------------------------------------
    expect = launches_of(counts, M512_FORWARD, PREDICT512_IMAGES)
    check(counts == expect, f"cli.test launch counts {counts} != {expect}")
    metrics = json.loads((root / "test_out" / "metrics.json").read_text())
    scores = metrics["per_image_f1"] + metrics["per_image_iou"]
    check(metrics["images"] == PREDICT512_IMAGES and
          len(metrics["per_image_f1"]) == PREDICT512_IMAGES and
          all(np.isfinite(scores)), f"metrics.json: {metrics}")
    per_image = result["per_image_ms"]
    emit("predict512", model=M512, img=IMG512, batch=1,
         images=PREDICT512_IMAGES, launches=counts,
         per_image_ms_p50=statistics.median(per_image),
         per_image_ms=per_image, cli_test_wall_s=wall_s,
         mean_f1=metrics["mean_f1"], mean_iou=metrics["mean_iou"])
    shutil.rmtree(root, ignore_errors=True)
    return counts


def held(torch, name, got, want, others):
    """A train-step tensor on the kernels against plain cores: within
    1e-5 + 1e-4 * max|plain| plus STEP_NOISE_FACTOR times the plain step's
    own spread over ``others`` (runs on a perturbed input)."""
    runs = [want] + others
    noise = max(float((a - b).abs().max()) for i, a in enumerate(runs)
                for b in runs[i + 1:])
    err = float((got - want).abs().max())
    tol = 1e-5 + 1e-4 * float(want.abs().max()) + STEP_NOISE_FACTOR * noise
    return {"name": name, "err": err, "tol": tol, "ok": err <= tol and
            bool(torch.isfinite(got).all())}


def step_parity(torch, name, img, images, masks, variables):
    """One train step on the kernels against the same step on plain cores
    from identical weights (cuDNN deterministic): the loss, every gradient
    and the running statistics."""
    import numpy as np

    from medt_tpu_torch.models import build_model
    from medt_tpu_torch.training import TrainState, adam_l2, train_step

    def one_step(plain, image):
        model = build_model(name, img_size=img, use_fused=True,
                            plain_cores=plain, device="cuda")
        model.load_state_dict(variables, strict=True)
        state = TrainState(model, adam_l2(model.parameters(), TRAIN_LR))
        loss = float(train_step(state, {"image": image, "label": masks})
                     ["loss"])
        grads = {k: p.grad.detach().clone()
                 for k, p in model.named_parameters() if p.requires_grad}
        stats = {k: b.detach().clone() for k, b in model.named_buffers()
                 if k.endswith(("running_mean", "running_var"))}
        return loss, grads, stats

    torch.backends.cudnn.deterministic = True
    loss_k, grads_k, stats_k = one_step(False, images)
    loss_p, grads_p, stats_p = one_step(True, images)
    x = images.astype(np.float32) / 255.0
    rng = np.random.default_rng(1)
    spread = [one_step(True, (x * (1.0 + STEP_INPUT_NOISE
                                   * rng.standard_normal(x.shape)))
                       .astype(np.float32)) for _ in range(2)]
    torch.backends.cudnn.deterministic = False
    checks = [held(torch, "loss", torch.tensor(loss_k), torch.tensor(loss_p),
                   [torch.tensor(s[0]) for s in spread])]
    checks += [held(torch, k, grads_k[k], grads_p[k],
                    [s[1][k] for s in spread]) for k in grads_p]
    checks += [held(torch, k, stats_k[k], stats_p[k],
                    [s[2][k] for s in spread]) for k in stats_p]
    return loss_k, loss_p, checks


def phase_train512(torch):
    """medt_512 trained at batch 4: counted warm-up, timed and loss steps
    with exact launch counts; then kernels vs plain cores at batch 1."""
    import numpy as np

    from medt_tpu_torch import ops
    from medt_tpu_torch.data import blob_batch
    from medt_tpu_torch.models import build_model
    from medt_tpu_torch.training import TrainState, adam_l2, train_step

    variables = build_model(M512, seed=0, device="cpu").state_dict()
    images, masks = blob_batch(BATCH512, IMG512, seed=0)
    batch = {"image": images, "label": masks}
    model = build_model(M512, use_fused=True, device="cuda")
    model.load_state_dict(variables, strict=True)
    state = TrainState(model, adam_l2(model.parameters(), TRAIN_LR))
    torch.cuda.reset_peak_memory_stats()

    # -- the main path, counted: 2 warm-up, 5 timed, 20 more steps -------------
    ops.reset_launch_counts()
    loss0 = train_step(state, batch)["loss"]
    train_step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        train_step(state, batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 5
    losses = torch.stack([train_step(state, batch)["loss"]
                          for _ in range(20)]).tolist()
    counts = ops.launch_counts()
    # -- end of the counted run ----------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del state, model
    torch.cuda.empty_cache()

    one_image, one_mask = blob_batch(1, IMG512, seed=1)
    loss_k, loss_p, checks = step_parity(torch, M512, IMG512, one_image,
                                         one_mask, variables)
    bad = [c for c in checks if not c["ok"]]
    worst = max(checks, key=lambda c: c["err"] / c["tol"])
    steps = 27
    expect = launches_of(counts, M512_STEP, steps)
    emit("train512", model=M512, img=IMG512, batch=BATCH512,
         optimizer="adam_l2", lr=TRAIN_LR, steps_counted=steps,
         launches=counts, ms_per_step=step_s * 1e3,
         images_per_s=BATCH512 / step_s, loss_step0=float(loss0),
         loss_first=losses[0], loss_last=losses[-1],
         loss_median=statistics.median(losses), loss_fall=LOSS_FALL,
         peak_memory_gb=peak_gb, parity_batch=1, loss_kernels=loss_k,
         loss_plain=loss_p, parity_tensors=len(checks),
         parity_failed=len(bad), parity_worst=worst)
    check(not bad, f"train step on kernels vs plain cores: {bad[:5]}")
    check(counts == expect, f"launch counts {counts} != {expect} for "
                            f"{steps} steps")
    check(all(np.isfinite(losses)), "non-finite loss")
    check(loss_fell(float(loss0), losses),
          f"the median of 20 loss steps is not below {LOSS_FALL} x the "
          f"step-0 loss {float(loss0)}: {losses}")
    return counts


def phase_logo512(torch):
    """One batch-1 eval forward of logo_512 (positions in both branches, so
    the with-position flash and lanes variants at the local geometries) on
    the kernels against plain cores."""
    import numpy as np

    from medt_tpu_torch import ops
    from medt_tpu_torch.models import build_model

    variables = build_model("logo_512", seed=0, device="cpu").state_dict()
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(1, 3, IMG512, IMG512)).astype(np.float32)).cuda()
    out = {}
    for plain in (False, True):
        model = build_model("logo_512", use_fused=True, plain_cores=plain,
                            device="cuda")
        model.load_state_dict(variables, strict=True)
        ops.reset_launch_counts()
        with torch.inference_mode():
            out[plain] = model(x)
        torch.cuda.synchronize()
        if not plain:
            counts = ops.launch_counts()
    got, want = out[False], out[True]
    err = float((got - want).abs().max())
    expect = launches_of(counts, M512_FORWARD, 1)
    emit("logo512", model="logo_512", img=IMG512, batch=1, launches=counts,
         logits_max_abs_err=err, logits_max_abs=float(want.abs().max()),
         tolerance=LOGITS_ATOL)
    check(counts == expect, f"launch counts {counts} != {expect}")
    check(bool(torch.isfinite(got).all()), "non-finite logits")
    check(err <= LOGITS_ATOL, f"logits vs plain cores: {err} > {LOGITS_ATOL}")
    return counts


# ---- 12. the training CLI at batch 1 ------------------------------------------

TRAIN1_IMAGES, TRAIN1_VAL = 16, 4


def phase_train1(torch):
    """``cli.train`` at its default batch 1 (MedT 128): 2 epochs at
    ``--save_freq 1``, then ``--resume`` for a third under
    ``--profile_dir``; exact launch counts; the files it writes; then
    batch-1 train steps of MedT 128 and gatedaxialunet 128 on the kernels
    against plain cores."""
    import shutil

    import numpy as np

    from medt_tpu_torch import ops
    from medt_tpu_torch.cli import train as cli_train
    from medt_tpu_torch.data import blob_batch, make_png_dataset, read_png
    from medt_tpu_torch.models import build_model

    root = REPO / "_smoke"
    shutil.rmtree(root, ignore_errors=True)
    train_dir = make_png_dataset(str(root / "train"), TRAIN1_IMAGES, IMG,
                                 seed=0)
    val_dir = make_png_dataset(str(root / "val"), TRAIN1_VAL, IMG, seed=1)
    out, prof = root / "out", root / "prof"
    argv = ["--train_dataset", train_dir, "--val_dataset", val_dir,
            "--modelname", "MedT", "--imgsize", str(IMG), "--save_freq",
            "1", "--direc", str(out), "--workers", "2"]

    # -- the main path, counted: two epochs, then a resumed third -------------
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state = cli_train.main(argv + ["--epochs", "2"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    steps = state.step
    ops.reset_launch_counts()
    resumed = cli_train.main(argv + ["--epochs", "3", "--resume",
                                     "--profile_dir", str(prof)])
    torch.cuda.synchronize()
    resumed_counts = ops.launch_counts()
    # -- end of the counted run ----------------------------------------------
    del state

    def expected(counts, steps, forwards):
        expect = launches_of(counts, MEDT_B1_STEP, steps)
        for k, v in BATCH1_LAUNCHES.items():
            expect[k] += v * forwards
        return expect

    check(steps == 2 * TRAIN1_IMAGES, f"{steps} steps in two epochs")
    check(counts == expected(counts, steps, 2 * TRAIN1_VAL),
          f"launch counts {counts} for {steps} steps")
    check(resumed.step == 3 * TRAIN1_IMAGES,
          f"the resumed run ended at step {resumed.step}")
    check(resumed_counts == expected(resumed_counts, TRAIN1_IMAGES,
                                     TRAIN1_VAL),
          f"resumed launch counts {resumed_counts}")
    for epoch in range(3):
        masks = sorted((out / str(epoch)).glob("*.png"))
        check(len(masks) == TRAIN1_VAL and all(
            read_png(str(m), gray=True).shape == (IMG, IMG) for m in masks),
            f"epoch {epoch}: masks {[m.name for m in masks]}")
        check((out / str(epoch) / "ckpt.pth").is_file(),
              f"no checkpoint for epoch {epoch}")
    check((out / "final_model" / "ckpt.pth").is_file(), "no final_model")
    log = [json.loads(line) for line in
           (out / "train_log.jsonl").read_text().splitlines()]
    check([e["epoch"] for e in log] == [0, 1, 2],
          f"train_log.jsonl epochs {[e['epoch'] for e in log]}")
    check(all(np.isfinite([e["loss"], e["val_f1"], e["val_iou"]]).all()
              for e in log), f"non-finite scores: {log}")
    csv_rows = (out / "train_log.csv").read_text().splitlines()
    row = dict(zip(csv_rows[0].split(","), csv_rows[-1].split(",")))
    check(len(csv_rows) == 2 and row["epoch"] == "2" and all(
        np.isfinite(float(row[k])) for k in ("loss", "val_f1", "val_iou")),
        f"train_log.csv of the resumed run: {csv_rows}")
    traces = list(prof.glob("*.json"))
    check(len(traces) == 1 and traces[0].stat().st_size > 0,
          f"profile_dir holds {traces}")

    # -- batch-1 steps on the kernels vs plain cores --------------------------
    parity = {}
    one_image, one_mask = blob_batch(1, IMG, seed=1)
    for name, per_step in (("MedT", MEDT_B1_STEP),
                           ("gatedaxialunet", UNET_B1_STEP)):
        variables = build_model(name, img_size=IMG, seed=0,
                                device="cpu").state_dict()
        ops.reset_launch_counts()
        loss_k, loss_p, checks = step_parity(torch, name, IMG, one_image,
                                             one_mask, variables)
        step_counts = ops.launch_counts()   # the plain steps launch nothing
        bad = [c for c in checks if not c["ok"]]
        parity[name] = {
            "loss_kernels": loss_k, "loss_plain": loss_p,
            "tensors": len(checks), "failed": len(bad),
            "worst": max(checks, key=lambda c: c["err"] / c["tol"]),
            "launches": step_counts}
        check(not bad, f"{name} batch-1 step on kernels vs plain cores: "
                       f"{bad[:5]}")
        check(step_counts == launches_of(step_counts, per_step, 1),
              f"{name} batch-1 step launches {step_counts}")
    rates = [e["imgs_per_sec"] for e in log]
    emit("train1", model="MedT", img=IMG, batch=1, images=TRAIN1_IMAGES,
         val_images=TRAIN1_VAL, steps_counted=steps, launches=counts,
         resumed_launches=resumed_counts, wall_s_two_epochs=wall_s,
         imgs_per_sec_by_epoch=rates, ms_per_step=1e3 / rates[1],
         images_per_s=rates[1], log=log,
         trace_bytes=traces[0].stat().st_size, parity=parity)
    # the run's epoch masks and labels stay for the zoo phase's sweep
    return counts


# ---- 13. the HTTP front -----------------------------------------------------

HTTP_REQUESTS, HTTP_CLIENTS = 32, 8
HTTP_WINDOW = (256, 192)        # the window route: 6 tiles at stride 64
HTTP_STRIDE = 64
MEDT_FORWARD = {"lanes_attn_fwd": 16, "flash_lanes_fwd": 6}


def _http(port, path, body=None, headers=None):
    """(status, headers, body, seconds) of one request, errors included."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers=headers or {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            out = (r.status, dict(r.headers), r.read())
    except urllib.error.HTTPError as e:
        out = (e.code, dict(e.headers), e.read())
    return out + (time.perf_counter() - t0,)


def _serving(make_server, engine):
    server = make_server(engine, 0)   # an ephemeral port
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def phase_http(torch):
    """``cli.serve`` over ``InferenceEngine("MedT", 128, loaddirec=...)``
    at batch 16 with window stride 64: 32 concurrent 128x128 POSTs from 8
    client threads at two priorities, then 2 POSTs of a 256x192 PNG (the
    window route), counted; every forward at batch 16 launches 16 lanes + 6
    flash kernels. Each 128 px mask equals ``predict_batch`` of its image,
    each window mask ``predict``; ``/healthz``, 404, 400 on a body that is
    not a PNG, and 503 with ``Retry-After`` from a full queue. Any other
    status than the expected one fails the phase (the handler turns a
    kernel failure into a 400)."""
    import shutil

    import numpy as np

    from medt_tpu_torch import ops
    from medt_tpu_torch.cli.serve import make_server
    from medt_tpu_torch.data.png import decode_png, encode_png
    from medt_tpu_torch.models import build_model
    from medt_tpu_torch.serving import InferenceEngine
    from medt_tpu_torch.training import save_checkpoint

    root = REPO / "_smoke" / "http"
    shutil.rmtree(root, ignore_errors=True)
    save_checkpoint(str(root / "ckpt"), 0,
                    build_model("MedT", img_size=IMG, seed=0, device="cpu"))
    ckpt = str(root / "ckpt" / "final_model")
    engine = InferenceEngine("MedT", IMG, loaddirec=ckpt, batch_size=BATCH,
                             window_stride=HTTP_STRIDE, max_wait_ms=5.0)
    engine.warmup()
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, size=(IMG, IMG, 3), dtype=np.uint8)
              for _ in range(HTTP_REQUESTS)]
    bodies = [encode_png(im) for im in images]
    big = rng.integers(0, 256, size=HTTP_WINDOW + (3,), dtype=np.uint8)
    server, thread = _serving(make_server, engine)
    port = server.server_address[1]
    replies = [None] * HTTP_REQUESTS
    try:
        # -- the main path, counted ------------------------------------------
        ops.reset_launch_counts()
        batches0 = engine.batches_run

        def client(k):
            for i in range(k, HTTP_REQUESTS, HTTP_CLIENTS):
                replies[i] = _http(port, "/predict", bodies[i],
                                   {"X-Priority": "0" if i % 3 else "5"})

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(HTTP_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        burst_s = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "client threads hung")
        forwards = engine.batches_run - batches0
        burst_counts = ops.launch_counts()
        window = [_http(port, "/predict", encode_png(big))
                  for _ in range(2)]
        counts = ops.launch_counts()
        # -- end of the counted run ------------------------------------------

        bad = [(i, r[0], r[2][:200]) for i, r in enumerate(replies)
               if r is None or r[0] != 200]
        bad += [("window", r[0], r[2][:200]) for r in window if r[0] != 200]
        check(not bad, f"unexpected statuses: {bad}")
        check(burst_counts == launches_of(burst_counts, MEDT_FORWARD,
                                          forwards),
              f"launch counts {burst_counts} for {forwards} forwards")
        check(counts == launches_of(counts, MEDT_FORWARD, forwards + 2),
              f"launch counts {counts} for {forwards} + 2 forwards")
        masks = [decode_png(r[2], gray=True) for r in replies]
        want = engine.predict_batch(images)
        differ = [i for i, (m, w) in enumerate(zip(masks, want))
                  if not np.array_equal(m, w * 255)]
        check(not differ, f"responses {differ} differ from predict_batch")
        big_want = engine.predict(big) * 255
        for r in window:
            got = decode_png(r[2], gray=True)
            check(got.shape == HTTP_WINDOW and np.array_equal(got, big_want),
                  f"window response {got.shape} differs from predict")

        status, _, body, _ = _http(port, "/healthz")
        health = json.loads(body) if status == 200 else {}
        check(status == 200 and health.get("status") == "ok" and
              {"batches_run", "images_run", "batch_size", "imgsize",
               "latency_ms"} <= set(health), f"/healthz: {status} {body}")
        status, _, body, _ = _http(port, "/nowhere")
        check(status == 404, f"GET /nowhere: {status} {body[:200]}")
        status, _, body, _ = _http(port, "/predict", b"not a png")
        check(status == 400, f"a body that is not a PNG: {status}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
        engine.stop()

    full = InferenceEngine("MedT", IMG, loaddirec=ckpt, batch_size=BATCH,
                           max_queue=0)
    server, thread = _serving(make_server, full)
    try:
        status, headers, body, _ = _http(server.server_address[1],
                                         "/predict", bodies[0])
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
        full.stop()
    check(status == 503 and headers.get("Retry-After") == "1",
          f"a full queue: {status} {headers} {body[:200]}")
    lat = sorted(r[3] * 1e3 for r in replies)
    emit("http", model="MedT", img=IMG, batch=BATCH, requests=HTTP_REQUESTS,
         clients=HTTP_CLIENTS, priorities=[0, 5], forwards=forwards,
         launches=counts, requests_per_s=HTTP_REQUESTS / burst_s,
         client_p50_ms=statistics.median(lat), client_max_ms=lat[-1],
         window_image=list(HTTP_WINDOW), window_stride=HTTP_STRIDE,
         window_ms=[r[3] * 1e3 for r in window],
         engine_latency_ms=health.get("latency_ms"))
    shutil.rmtree(root, ignore_errors=True)
    return counts


# ---- 14. the segmentation zoo and the best-checkpoint sweep ---------------------

# launches per gated_sig-128 train step (its sigmoid gates fold into the
# tables of the fused train route): at batch 16, 8 flash and 8 lanes sites,
# each with the moments kernel; at batch 1, gatedaxialunet's UNET_B1_STEP
GATED_SIG_B16_STEP = {"flash_lanes_fwd": 8, "flash_lanes_bwd": 8,
                      "lanes_attn_fwd": 8, "lanes_attn_bwd": 8,
                      "moment_sums_fwd": 16, "moment_sums_bwd": 16}
# launches per axialunet_wopos-128 eval forward: at batch 16 8 flash and 8
# lanes sites; at batch 1 every site has fewer than 128 stripes
WOPOS_B16_FORWARD = {"flash_lanes_fwd": 8, "lanes_attn_fwd": 8}
WOPOS_B1_FORWARD = {"axial_eval_fwd": 16}
# the geometries of those paths that no earlier phase holds, g = 8:
# (kernel, span, gp, stripes, has_pos)
ZOO_GEOMETRIES = [
    (k, *site) for k in ("flash_lanes_fwd", "flash_lanes_bwd",
                         "moment_sums_fwd", "moment_sums_bwd")
    for site in ((32, 8, 512, True),)
] + [
    (k, *site) for k in ("lanes_attn_fwd", "lanes_attn_bwd",
                         "moment_sums_fwd", "moment_sums_bwd")
    for site in ((16, 8, 256, True), (16, 16, 256, True),
                 (16, 8, 16, True), (16, 16, 16, True))
] + [
    ("flash_lanes_fwd", *site) for site in ((64, 2, 1024, False),
                                            (32, 4, 512, False),
                                            (32, 8, 512, False))
] + [
    ("lanes_attn_fwd", *site) for site in ((16, 8, 256, False),
                                           (16, 16, 256, False))
] + [
    ("axial_eval_fwd", *site) for site in (
        (64, 2, 64, False), (64, 4, 64, False), (32, 4, 32, False),
        (32, 8, 32, False), (16, 8, 16, False), (16, 16, 16, False))
]
# run once (batch-1 eval forward, train step at batch 2) with no kernel
# launch: JAX runs these on its XLA path too
ZOO_PLAIN = ("gated_data", "convnet_ablation", "mix_net_gated_d",
             "unetplusplus", "shallow", "autoencoder")
ZOO_STEPS = 3   # timed steps per gated_sig batch


def _zoo_geometries(torch):
    """Each kernel at the zoo's geometries against its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for kernel, L, gp, S, has_pos in ZOO_GEOMETRIES:
        fn, plain = kernel_calls(torch, gen, kernel, gp, L, S, has_pos)
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err, ok = compare(torch, kernel, got, want)
        rows.append({"kernel": kernel, "span": L, "gp": gp, "S": S,
                     "has_pos": has_pos, "max_abs_err": err, "ok": ok})
    return rows


def _gated_sig_steps(torch, batch):
    """Counted: ZOO_STEPS + 1 gated_sig train steps at ``batch`` (the
    first a warm-up); then one step on the kernels vs plain cores."""
    from medt_tpu_torch import ops
    from medt_tpu_torch.data import blob_batch
    from medt_tpu_torch.models import build_model
    from medt_tpu_torch.training import TrainState, adam_l2, train_step

    variables = build_model("gated_sig", img_size=IMG, seed=0,
                            device="cpu").state_dict()
    images, masks = blob_batch(batch, IMG, seed=0)
    model = build_model("gated_sig", img_size=IMG, use_fused=True,
                        device="cuda")
    model.load_state_dict(variables, strict=True)
    state = TrainState(model, adam_l2(model.parameters(), TRAIN_LR))
    ops.reset_launch_counts()
    losses = [train_step(state, {"image": images, "label": masks})["loss"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ZOO_STEPS):
        losses.append(train_step(state, {"image": images, "label": masks})
                      ["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / ZOO_STEPS * 1e3
    counts = ops.launch_counts()
    del state, model
    loss_k, loss_p, checks = step_parity(torch, "gated_sig", IMG, images,
                                         masks, variables)
    bad = [c for c in checks if not c["ok"]]
    return counts, {
        "batch": batch, "ms_per_step": step_ms,
        "losses": torch.stack(losses).tolist(), "loss_kernels": loss_k,
        "loss_plain": loss_p, "tensors": len(checks), "failed": len(bad),
        "worst": max(checks, key=lambda c: c["err"] / c["tol"]),
        "bad": bad[:5]}


def _wopos_forwards(torch):
    """axialunet_wopos-128 eval forwards at batch 16 and 1 on the kernels
    (counted) against plain cores."""
    import numpy as np

    from medt_tpu_torch import ops
    from medt_tpu_torch.models import build_model

    variables = build_model("axialunet_wopos", img_size=IMG, seed=0,
                            device="cpu").state_dict()
    out = {}
    for batch, per_call in ((BATCH, WOPOS_B16_FORWARD),
                            (1, WOPOS_B1_FORWARD)):
        x = torch.from_numpy(np.random.default_rng(batch).uniform(
            size=(batch, 3, IMG, IMG)).astype(np.float32)).cuda()
        got = {}
        for plain in (False, True):
            model = build_model("axialunet_wopos", img_size=IMG,
                                use_fused=True, plain_cores=plain,
                                device="cuda")
            model.load_state_dict(variables, strict=True)
            with torch.inference_mode():
                model(x)                          # warm-up
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                got[plain] = model(x)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            if not plain:
                counts, kernel_ms = ops.launch_counts(), ms
        err = float((got[False] - got[True]).abs().max())
        check(counts == launches_of(counts, per_call, 1),
              f"axialunet_wopos batch {batch}: launch counts {counts}")
        check(bool(torch.isfinite(got[False]).all()),
              f"axialunet_wopos batch {batch}: non-finite logits")
        check(err <= LOGITS_ATOL, f"axialunet_wopos batch {batch}: logits "
                                  f"vs plain cores {err} > {LOGITS_ATOL}")
        out[batch] = {"launches": counts, "forward_ms": kernel_ms,
                      "plain_forward_ms": ms, "logits_max_abs_err": err}
    return out


def _plain_zoo(torch):
    """The zoo models JAX runs without kernels: one batch-1 eval forward
    and one train step at batch 2 each, with use_fused on; finite outputs
    of the right shapes and no kernel launch."""
    import numpy as np

    from medt_tpu_torch import ops
    from medt_tpu_torch.data import blob_batch
    from medt_tpu_torch.models import build_model
    from medt_tpu_torch.training import TrainState, adam_l2, train_step

    images, masks = blob_batch(2, IMG, seed=2)
    x = torch.from_numpy(images[:1]).cuda().permute(0, 3, 1, 2).float() / 255
    out = {}
    for name in ZOO_PLAIN:
        model = build_model(name, img_size=IMG, use_fused=True, seed=0,
                            device="cuda")
        ops.reset_launch_counts()
        with torch.inference_mode():
            y = model(x)
        state = TrainState(model, adam_l2(model.parameters(), TRAIN_LR))
        loss = float(train_step(state, {"image": images, "label": masks})
                     ["loss"])
        counts = ops.launch_counts()
        main = y[0] if isinstance(y, tuple) else y
        shape = (1, 3 if name == "autoencoder" else 2, IMG, IMG)
        check(tuple(main.shape) == shape, f"{name}: output {main.shape}")
        check(bool(torch.isfinite(main).all()) and np.isfinite(loss),
              f"{name}: non-finite output or loss {loss}")
        check(not any(counts.values()), f"{name}: kernel launches {counts}")
        row = {"loss": loss, "shape": list(main.shape)}
        if name == "unetplusplus":
            check(isinstance(y, tuple) and len(y[1]) == 4, "unetplusplus "
                  "must give (logits, 4 auxiliary heads)")
            aux = [list(a.shape) for a in y[1]]
            check(aux == [[1, 2, IMG // f, IMG // f] for f in (2, 4, 8, 16)]
                  and all(bool(torch.isfinite(a).all()) for a in y[1]),
                  f"unetplusplus auxiliary heads {aux}")
            row["aux_shapes"] = aux
        out[name] = row
        del state, model
    return out


def phase_zoo(torch):
    """The zoo on the card: each kernel at the zoo's new geometries against
    its plain version; gated_sig-128 train steps at batch 16 and 1 on the
    fused train route (counted, timed, held against plain cores);
    axialunet_wopos-128 forwards at batch 16 and 1; the six models JAX runs
    without kernels; then ``evaluation.sweep`` over ``train1``'s epochs."""
    import math
    import shutil

    from medt_tpu_torch.evaluation.sweep import sweep_checkpoint_grid

    geometries = _zoo_geometries(torch)
    failed = [r for r in geometries if not r["ok"]]
    check(not failed, f"kernel disagrees with its plain version: {failed}")

    steps = {}
    counts = {}
    for batch, per_step in ((BATCH, GATED_SIG_B16_STEP), (1, UNET_B1_STEP)):
        # -- the main path, counted: the gated_sig steps at this batch ------
        step_counts, steps[batch] = _gated_sig_steps(torch, batch)
        # -- end of the counted run ------------------------------------------
        check(not steps[batch]["bad"], f"gated_sig batch {batch} step on "
              f"kernels vs plain cores: {steps[batch]['bad']}")
        check(step_counts == launches_of(step_counts, per_step,
                                         ZOO_STEPS + 1),
              f"gated_sig batch {batch}: launch counts {step_counts}")
        check(all(math.isfinite(v) for v in steps[batch]["losses"]),
              f"gated_sig batch {batch}: non-finite loss")
        for k, v in step_counts.items():
            counts[k] = counts.get(k, 0) + v
    wopos = _wopos_forwards(torch)
    for row in wopos.values():
        for k, v in row["launches"].items():
            counts[k] = counts.get(k, 0) + v
    plain = _plain_zoo(torch)

    root = REPO / "_smoke"
    grid = sweep_checkpoint_grid(str(root / "out"),
                                 str(root / "val" / "labelcol"))
    per_epoch = grid["per_epoch"]
    check(sorted(per_epoch) == [0, 1, 2] and all(
        s["images"] == TRAIN1_VAL for s in per_epoch.values()),
        f"sweep over train1's epochs: {per_epoch}")
    check(grid["best_epoch"] in (0, 1, 2) and all(
        0.0 <= s[k] <= 1.0 for s in per_epoch.values()
        for k in ("f1", "miou", "pa")), f"sweep scores: {grid}")
    # the same masks and labels under the same protocol: the validation
    # F1 and IoU that train1's log holds
    log = [json.loads(line) for line in
           (root / "out" / "train_log.jsonl").read_text().splitlines()]
    check(all(abs(per_epoch[e["epoch"]]["f1"] - e["val_f1"]) <= 1e-6 and
              abs(per_epoch[e["epoch"]]["miou"] - e["val_iou"]) <= 1e-6
              for e in log), f"sweep {per_epoch} vs train1's log {log}")
    shutil.rmtree(root, ignore_errors=True)
    emit("zoo", img=IMG, geometries=geometries, gated_sig=steps,
         axialunet_wopos=wopos, plain_models=plain, launches=counts,
         sweep=grid, tolerance=LOGITS_ATOL)
    return counts


def summary(rows, counts):
    """One entry per kernel; times per call of its main path: one MedT-128
    batch-16 forward (serving) for the lanes and flash forward cores, one
    MedT-128 train step for their backward and the moments kernels, one
    batch-1 forward (``cli.test``) for the eval kernel, one medt_512
    batch-4 forward (``serve512``) for the flash2 forward, one medt_512
    train step for its backward and one MedT-128 batch-1 train step
    (``train1``) for the stripe kernels. ``counts`` holds each phase's
    launch counts by phase name."""
    kernels = []
    for name in KERNELS:
        flash2 = name.startswith("flash2")
        stripe = name.startswith("stripe")
        path = "medt512" if flash2 else "medt128b1" if stripe else "medt128"
        mine = [r for r in rows if r["kernel"] == name and r["path"] == path]
        used = [r for r in mine if r["launches_per_call"]]
        n = [r["launches_per_call"] for r in used]
        b = sum(r["bytes"] / HBM_BYTES_PER_S * k for r, k in zip(used, n))
        o = sum(r["ops"] / F32_FLOPS_PER_S * k for r, k in zip(used, n))
        forward = name.endswith("fwd") and not name.startswith("moment")
        if name == "axial_eval_fwd":
            phase = "predict"
        elif stripe:
            phase = "train1"
        elif flash2:
            phase = "serve512" if forward else "train512"
        else:
            phase = "serve" if forward else "train"
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": counts[phase][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["kernel"] == name),
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
    counts = {}
    try:
        smi, name = phase_device(torch)
        phase = "build"
        phase_build()
        phase = "kernels"
        rows = phase_kernels(torch)
        for phase, fn in (("serve", phase_serve), ("predict", phase_predict),
                          ("train", phase_train), ("tf32", phase_tf32),
                          ("serve512", phase_serve512),
                          ("predict512", phase_predict512),
                          ("train512", phase_train512),
                          ("logo512", phase_logo512),
                          ("train1", phase_train1), ("http", phase_http),
                          ("zoo", phase_zoo)):
            counts[phase] = fn(torch)
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
