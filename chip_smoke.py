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
   Then the bf16 entry points of rows 1-8 (bf16 qkv in, bf16 dqkv out) at
   the MedT-128 batch-16 geometries, both has_pos variants, and flash2's
   at one medt_512 geometry: each held against the float32 kernel on the
   upcast input (whether the bits are equal; at least JAX's
   ``test_bf16_kernels.py`` tolerances) and against its plain version,
   timed beside its float32 twin in this call, its bound with 2-byte qkv.
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
15. ``bf16`` — MedT 128 with bf16 activations (float32 parameters):
   ``InferenceEngine(..., batch_size=16, dtype=torch.bfloat16)`` served
   batches, counted (16 lanes + 6 flash bf16 launches a forward, no
   float32 lanes-family launch), their logits against the same bf16 model
   on plain cores and against the float32 model; the batch-16 train step
   (Adam-L2), counted (16 + 6 forward, 16 + 6 backward, 22 + 22 moments
   bf16 launches a step), 3 warm-up and 10 timed steps beside the float32
   step's time in this call, 20 more whose loss must fall, parameters and
   statistics float32 after; one step on the kernels against plain cores
   (``step_parity`` with bf16's 2^-8 in place of float32's terms).
16. ``remat`` — ``train_step(remat=True)`` of MedT 128 at batch 16 in
   float32 against a plain step from identical weights: loss, parameters
   after an SGD step, running statistics equal (one update); every forward
   launch twice and every backward launch once; ms per step and peak
   memory of both.
17. ``bf16_cli`` — ``cli.train --dtype bfloat16 --remat`` at batch 1, one
   epoch in process over 8 synthetic PNG pairs, one of them written
   Adam7-interlaced by this script: exact launch counts (the stripe and
   eval sites in float32, the lanes and moments sites in bf16), a finite
   loss, a checkpoint, a mask of each image's size.
18. ``cls`` — the classification harness: each kernel at axial26s's
   geometries (224 px, s = 0.5: gp 8 to 64; spans 56, 28, 14; the batch-8
   train and eval and batch-1 eval and train sites) against its plain
   version, with CUDA-event times and bounds per call; axial26s (1000
   classes, float32, ``use_fused``) at batch 8 under JAX's train_cls
   defaults (SGD, momentum 0.9, L2 1e-4, lr 0.1, label smoothing 0.1):
   one step against plain cores (loss, every parameter after the update,
   every running statistic), a counted warm-up and 5 timed steps on one
   batch at lr 0.01 (8 + 8 flash, 8 + 8 lanes, 16 + 16 moments launches a
   step; the last loss below 0.75 of the first), wall and device ms per
   step; eval forwards at batch 8
   (8 flash + 8 eval) and batch 1 (16 eval) and a batch-1 step (4 + 4
   stripe, 4 + 4 flash, 8 + 8 lanes, 12 + 12 moments) against plain
   cores, each site's route as ``last_route`` shows it; then ``python -m
   medt_tpu_torch.cli.train_cls`` with resnet18 at 224 px, one epoch over
   an ImageFolder of 2 x 8 PNGs per split: a finite loss, a ``val_acc``
   and a checkpoint.
19. ``cls_wide`` — the classifiers at the wide group planes: each kernel
   at each geometry of axial50m's batch-8 calls (gp 12, 24, 48, 96) and
   axial50l's batch-1 calls (gp 16 to 128) against its plain version, the
   bf16 entry points at axial50m's batch-8 step geometries against their
   float32 twins (bit-equal); axial50m (224 px, 1000 classes, float32,
   ``use_fused``) at batch 8: one SGD step against plain cores, a counted
   warm-up and 5 timed steps at lr 0.01 (16 + 16 flash, 16 + 16 lanes,
   32 + 32 moments launches a step; the median of the 5 losses below 0.75
   of the first), wall and device ms, an eval forward (16 flash + 16
   eval) against plain cores;
   axial50l at batch 1: an eval forward (32 eval) and a train step (6 + 6
   stripe at gp 16, 10 + 10 flash: its gp-32 span-56 sites too, 16 + 16
   lanes, 26 + 26 moments) against plain cores; axial50m in bf16: one
   step, counted under the ``_bf16`` names, finite loss.
   Each wide kernel and bf16 entry point adds an entry ``<name>_wide`` to
   the summary line.
20. ``cls_hires`` — axial50m and axial50l at 384 px (the usual fine-tuning
   resolution; spans 96, 96, 48, 24, so layer 1 and layer 2's first block
   attend along span 96 at gp 12 and 24, or 16 and 32, on the flash2
   route, the long-span wide kernels at every gp outside 2, 4, 8 and 16):
   each kernel of the span-96 sites (flash2 forward and backward, the
   moments forward and backward) at axial50m's batch-8 and batch-1 and
   axial50l's batch-1 stripe counts against its plain version, and the
   flash2 forward and backward over spans 80, 128, 192 and 256 at gp 6,
   10, 12, 32, 64 and 128 with and without positions (32 stripes); the
   bf16 entry points at axial50m's span-96 step sites against their
   float32 twins (bit-equal); axial50m (1000 classes, float32,
   ``use_fused``, published widths and depth, built by its factory at
   ``img_size=384``) at batch 8: one SGD step against plain cores, a
   counted warm-up and 5 timed steps at lr 0.005 (8 + 8 flash2, 20 + 20
   flash, 4 + 4 lanes, 32 + 32 moments launches a step), then 7 runs more
   from the same weights on the batch perturbed by 1e-6 (relative): the
   median of each run's 5 losses over its first, averaged over the 8
   runs, below 0.75; wall and device ms, an eval forward
   (8 flash2, 20 flash, 4 eval) against plain cores; axial50l at batch 1:
   an eval forward (8 flash2, 24 eval) and a train step against plain
   cores; axial50m in bf16: one counted step. The summary line gains the
   ``flash2_lanes_{fwd,bwd}[_bf16]_wide`` entries.
21. ``dp`` — data parallel on the one card: two gloo ranks on ``cuda:0``
   (``parallel.run_data_parallel``; MedT 128, Adam-L2, the kernels, the
   same seeded weights on both) take a DDP train step at global batch 16
   (8 rows a rank) and at global batch 1 (one rank holds the row, the
   other none); each rank's loss, gradients after DDP's average and
   running statistics are held against the one-process step on the joint
   batch under ``step_parity``'s rule, and each rank's launch counts must
   be exact, worked out from ``fused_route`` at its own stripe count (a
   rank with no rows launches nothing); ms per step per rank (two ranks
   share the card's SMs and copy every collective through the host: no
   speed). This process as an NCCL world of one: a DDP step against the
   undistributed step (whether the bits are equal). ``torchrun
   --nproc_per_node 1 -m medt_tpu_torch.cli.train`` for one epoch over 4
   PNG pairs, run beside the rest: its checkpoint loads strictly into a
   one-card model. ``InferenceEngine(devices=["cuda:0", "cuda:0"])`` at
   batch 16: masks equal to one replica's, launches 2 x (16 lanes + 6
   flash) a batch (8 rows a replica).
22. ``tp`` — the model axis on the one card: MedT 128 (Adam-L2, the
   kernels) on the ``(dp, tp)`` meshes (1, 2) and (2, 2), gloo ranks on
   ``cuda:0``, at global batch 16 and 1; every attention layer split over
   the two model ranks (g 8 -> 4 a rank), DDP over the data axis. Each
   rank's loss, gradients and running statistics (gathered into their
   one-card shapes) against the one-process step under ``step_parity``'s
   rule; the model ranks' losses equal; each rank's exact launch counts
   (the one-process call's at its rows; every site at g 4); the batch-16
   step's checkpoint, gathered over the model axis, loads strictly into a
   one-card model and holds the ranks' weights. ms of one step per rank
   after the counted one (the ranks share the card's SMs and copy every
   collective through the host: no speed). The two-rank world also runs
   the ``cls_dp`` case, ``cli.train_cls --distributed`` (its record under
   ``cls_dp``): axial26s at 224 px (``use_fused``, label smoothing, JAX's
   SGD defaults) at 4 rows a rank of a joint batch of 8 against the
   one-process step at 8 (loss, accuracy, gradients after DDP's average,
   running statistics) with exact launch counts; then one epoch of the
   CLI with resnet18 at 4 rows a rank over an ImageFolder of 14 + 10 PNGs
   against the one-process run at batch 8: the same steps, one log with
   its ``val_acc``, a checkpoint that loads strictly into a one-card
   model.

Then: the per-kernel JSON summary, the card's ``nvidia-smi`` line, and, as
the last line, ``{"ok": true, "device": ...}``. Any failed phase ends the
script with a non-zero exit code and without the ``ok`` line. Without CUDA,
or outside a checkout of the repository, it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import json
import math
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


# the card's name and power limit (nvidia-smi), set by phase_device: every
# later phase line carries it beside its times
CARD = None


def emit(phase: str, **fields):
    line = {"phase": phase, "seconds": round(time.perf_counter() - T0, 3)}
    if CARD is not None:
        line["card"] = CARD
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
    global CARD
    CARD = smi
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
         nvcc_source_seconds={k: round(v, 3) for k, v in
                              result.source_seconds.items()},
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


def work(kernel, gp, L, S, has_pos, qkv_bytes=4):
    """(bytes, operations) the function must move and do: each input read
    once, each output written once; qkv (and dqkv) at ``qkv_bytes`` bytes
    an element (2 for the bf16 entry points), everything else float32. Operations per (group, query, key,
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
        nbytes = qkv_bytes * qkv + 4 * (tables + g * 8 + g * 4 * gp + sv)
        ops = pairs * (logit_ops + 3 + 2 * gp * (2 if has_pos else 1)) \
            + sv * (7 if has_pos else 4)
    elif kernel in ("lanes_attn_fwd", "flash_lanes_fwd", "flash2_lanes_fwd",
                    "stripe_attn_fwd"):
        outputs = sv * (2 if has_pos else 1)
        if kernel not in ("lanes_attn_fwd", "stripe_attn_fwd"):
            outputs += 2 * row
        nbytes = qkv_bytes * qkv + 4 * (tables + g * 8 + outputs)
        ops = pairs * (logit_ops + 3 + 2 * gp * (2 if has_pos else 1)) \
            + sv * (2 if has_pos else 1)
    elif kernel in ("lanes_attn_bwd", "flash_lanes_bwd", "flash2_lanes_bwd",
                    "stripe_attn_bwd"):
        grads_in = sv * (2 if has_pos else 1)
        saved = 2 * row + grads_in if kernel not in (
            "lanes_attn_bwd", "stripe_attn_bwd") else 0
        nbytes = (2 * qkv_bytes * qkv                                # qkv, dqkv
                  + 4 * (tables + g * 8 + grads_in + saved           # in
                         + tables + g * 8))                          # out
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
            nbytes = qkv_bytes * qk + 4 * (mtables + g * 8)
            ops = g * L * S * per_pos
        else:
            nbytes = qkv_bytes * (qk + qkv) + 4 * (mtables + g * 8 + mtables)
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


def kernel_calls(torch, gen, kernel, gp, L, S, has_pos, cast=None):
    """(kernel call, plain call) with the inputs of one geometry bound;
    ``cast`` (for the lanes-family and moments kernels) maps the qkv
    operand, as the bf16 rows pass it in bf16."""
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
        if cast is not None:
            ins = (cast(ins[0]), *ins[1:])
        if kernel == "moment_sums_fwd":
            return (lambda: (moments.moment_sums_fwd(*ins),),
                    lambda: (moments.moment_sums_plain(*ins),))
        ct = torch.randn((g, 8), generator=gen, device="cuda")
        return (lambda: moments.moment_sums_bwd(*ins, ct),
                lambda: moments.moment_sums_bwd_plain(*ins, ct))
    args = core_inputs(torch, gen, gp, L, S, has_pos)
    if cast is not None:
        args = (cast(args[0]), *args[1:])
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
    rows += bf16_rows(torch)
    failed = [r for r in rows if not r["ok"]]
    emit("kernels", geometries=len(rows), tolerance={
        "forward": KERNEL_ATOL, "backward_and_moments_rtol": SUM_RTOL,
        "bf16_vs_float32_twin": BF16_TWIN_TOL,
        "bf16_dqkv_vs_plain": "the above plus one bf16 unit in the last "
                              "place (2^-7 relative) of each element"},
         failed=len(failed))
    check(not failed, f"kernel disagrees with its plain version: {failed}")
    return rows


# bf16 I/O (kernel rows 1-8): every bf16 entry point at the MedT-128
# batch-16 geometries (both has_pos variants) and flash2 at one medt_512
# batch-4 geometry (off the bf16 path, which is MedT-128's)
BF16_KERNELS = ("lanes_attn_fwd", "flash_lanes_fwd", "flash2_lanes_fwd",
                "lanes_attn_bwd", "flash_lanes_bwd", "flash2_lanes_bwd",
                "moment_sums_fwd", "moment_sums_bwd")
BF16_FLASH2_SITE = (256, 2, 1024, True)
# against the float32 kernel on the upcast input, at least JAX's
# tests/test_bf16_kernels.py tolerances: outputs, table and daff gradients
# rtol = atol = 1e-6; dqkv (bf16) rtol 1e-2, atol 1e-6
BF16_TWIN_TOL = {"rtol": 1e-6, "atol": 1e-6, "dqkv_rtol": 1e-2}
# one bf16 rounding, relative: bf16 keeps 8 significant bits
BF16_ULP = 2.0 ** -8


def _bf16_geometries():
    """(kernel, span, gp, stripes, has_pos, launches per call, path) of the
    bf16 rows, as _geometries() gives the float32 ones."""
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
    rows += [(f"flash2_lanes_{d}", *BF16_FLASH2_SITE, 0, "medt512")
             for d in ("fwd", "bwd")]
    return rows


def bf16_compare(torch, kernel, got, twin):
    """A bf16 entry point's outputs against the float32 kernel's on the
    upcast qkv: (every output bit-equal, within BF16_TWIN_TOL, max |diff|).
    A backward's first output is dqkv, whose bits must be the float32
    dqkv rounded once to bf16."""
    bits, ok, err = True, True, 0.0
    dqkv_first = kernel.endswith("_bwd")
    for i, (o, w) in enumerate(zip(got, twin)):
        if not w.numel():
            continue
        if dqkv_first and i == 0:
            ok = ok and o.dtype == torch.bfloat16
            bits = bits and torch.equal(o, w.to(torch.bfloat16))
            rtol = BF16_TWIN_TOL["dqkv_rtol"]
        else:
            bits = bits and torch.equal(o, w)
            rtol = BF16_TWIN_TOL["rtol"]
        d = (o.float() - w).abs()
        err = max(err, float(d.max()))
        ok = ok and bool((d <= BF16_TWIN_TOL["atol"] + rtol * w.abs()).all())
    return bits, ok, err


def bf16_plain_compare(torch, kernel, got, want):
    """compare() for a bf16 entry point against its plain version on the
    same bf16 input; the bf16 dqkv of a backward may differ from the plain
    one by one more bf16 unit in the last place of each element, at most
    2^-7 of it (both are float32 sums, in other orders, rounded once, and
    may round to the two sides of a bf16 value)."""
    if not kernel.endswith("_bwd"):
        return compare(torch, kernel, got, want)
    g0, w0 = got[0].float(), want[0].float()
    d = (g0 - w0).abs()
    ok = bool(torch.isfinite(g0).all()) and bool((
        d <= 1e-4 + SUM_RTOL * float(w0.abs().max())
        + BF16_ULP * 2 * w0.abs()).all())
    err_rest, ok_rest = compare(torch, kernel, got[1:], want[1:])
    return max(float(d.max()), err_rest), ok and ok_rest


def bf16_row(torch, kernel, L, gp, S, has_pos, seed, reps=15, inner=5):
    """A bf16 entry point at one geometry against the float32 kernel on
    the upcast input (bits and BF16_TWIN_TOL) and against its plain
    version; CUDA-event times of the bf16 kernel and its float32 twin in
    this call, and the bound with 2-byte qkv. ``ok`` does not ask for the
    bits: ``bits_equal_float32_twin`` reports them."""
    def calls(cast):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return kernel_calls(torch, gen, kernel, gp, L, S, has_pos, cast)

    fn, plain = calls(lambda t: t.to(torch.bfloat16))
    twin, _ = calls(lambda t: t.to(torch.bfloat16).float())
    got, again, want, ref = fn(), fn(), plain(), twin()
    torch.cuda.synchronize()
    bits, twin_ok, twin_err = bf16_compare(torch, kernel, got, ref)
    err, ok = bf16_plain_compare(torch, kernel, got, want)
    repeatable = all(torch.equal(a, b) for a, b in zip(got, again))
    nbytes, ops = work(kernel, gp, L, S, has_pos, qkv_bytes=2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return {"kernel": f"{kernel}_bf16", "span": L, "gp": gp, "S": S,
            "g": GROUPS, "has_pos": has_pos, "max_abs_err": err,
            "bits_equal_float32_twin": bits,
            "max_abs_diff_float32_twin": twin_err,
            "ok": ok and twin_ok and repeatable, "repeatable": repeatable,
            "ms": time_ms(torch, fn, reps, inner),
            "float32_ms": time_ms(torch, twin, reps, inner),
            "plain_ms": time_ms(torch, plain, reps=min(reps, 5), inner=1),
            "bytes": nbytes, "ops": ops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bf16_rows(torch):
    """Each bf16 entry point whose float32 kernel GEOMETRIES holds, held
    against the float32 kernel on the upcast input and against its plain
    version (bf16_row)."""
    kernels = {g[0] for g in GEOMETRIES}
    rows = []
    for seed, (kernel, L, gp, S, has_pos, per_call, path) in enumerate(
            _bf16_geometries()):
        if kernel not in kernels:
            continue
        row = bf16_row(torch, kernel, L, gp, S, has_pos, 1000 + seed)
        row.update(path=path, launches_per_call=per_call)
        rows.append(row)
        print(json.dumps({"geometry": row}), flush=True)
    torch.cuda.empty_cache()
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


def held(torch, name, got, want, others, rel_tol=1e-4):
    """A train-step tensor on the kernels against plain cores: within
    1e-5 + rel_tol * max|plain| plus STEP_NOISE_FACTOR times the plain
    step's own spread over ``others`` (runs on a perturbed input)."""
    runs = [want] + others
    noise = max(float((a - b).abs().max()) for i, a in enumerate(runs)
                for b in runs[i + 1:])
    err = float((got - want).abs().max())
    tol = 1e-5 + rel_tol * float(want.abs().max()) + STEP_NOISE_FACTOR * noise
    return {"name": name, "err": err, "tol": tol, "ok": err <= tol and
            bool(torch.isfinite(got).all())}


def step_parity(torch, name, img, images, masks, variables, dtype=None,
                input_noise=STEP_INPUT_NOISE, rel_tol=1e-4):
    """One train step on the kernels against the same step on plain cores
    from identical weights (cuDNN deterministic): the loss, every gradient
    and the running statistics. ``dtype`` is the compute dtype; the spread
    runs perturb the input by ``input_noise`` (relative), and ``rel_tol``
    is held()'s relative term."""
    import numpy as np

    from medt_tpu_torch.models import build_model
    from medt_tpu_torch.training import TrainState, adam_l2, train_step

    def one_step(plain, image):
        model = build_model(name, img_size=img, use_fused=True,
                            plain_cores=plain, device="cuda", dtype=dtype)
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
    spread = [one_step(True, (x * (1.0 + input_noise
                                   * rng.standard_normal(x.shape)))
                       .astype(np.float32)) for _ in range(2)]
    torch.backends.cudnn.deterministic = False
    checks = [held(torch, "loss", torch.tensor(loss_k), torch.tensor(loss_p),
                   [torch.tensor(s[0]) for s in spread], rel_tol)]
    checks += [held(torch, k, grads_k[k], grads_p[k],
                    [s[1][k] for s in spread], rel_tol) for k in grads_p]
    checks += [held(torch, k, stats_k[k], stats_p[k],
                    [s[2][k] for s in spread], rel_tol) for k in stats_p]
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


# ---- 15-17. bf16 activations and remat ----------------------------------------

# launches per MedT-128 batch-16 forward and train step in bf16: the
# lanes-family and moments kernels through their bf16 entry points only
BF16_FORWARD = {"lanes_attn_fwd_bf16": 16, "flash_lanes_fwd_bf16": 6}
BF16_STEP = {**BF16_FORWARD, "lanes_attn_bwd_bf16": 16,
             "flash_lanes_bwd_bf16": 6, "moment_sums_fwd_bf16": 22,
             "moment_sums_bwd_bf16": 22}
# a remat step recomputes the forward in the backward: every forward
# launch twice, every backward launch once
REMAT_STEP = {k: (2 if k.endswith("_fwd") else 1) * v
              for k, v in PER_STEP.items()}
# The bf16 step's parity bound, derived from the float32 one (held()):
# 1e-5 + BF16_ULP * max|plain| plus STEP_NOISE_FACTOR times the plain bf16
# step's spread when its input is perturbed by one bf16 rounding (BF16_ULP,
# relative): bf16 rounds 2^16 times coarser than float32, so the float32
# bound's 1e-4 relative term and 1e-6 input noise become bf16's 2^-8.
BF16_SERVE_FORWARDS = 10


def _timed_steps(torch, state, batch, warm=3, timed=10, remat=False):
    """(ms per step, loss of the first step) over ``timed`` steps after
    ``warm`` warm-up steps."""
    from medt_tpu_torch.training import train_step

    loss0 = train_step(state, batch, remat=remat)["loss"]
    for _ in range(warm - 1):
        train_step(state, batch, remat=remat)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        train_step(state, batch, remat=remat)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / timed * 1e3, float(loss0)


def phase_bf16(torch):
    """MedT 128 in bf16 (float32 parameters): a served batch of
    ``InferenceEngine(..., dtype=torch.bfloat16)`` against the same bf16
    model on plain cores and against the float32 model; the batch-16
    train step (counted, timed beside float32, 20 loss steps, float32
    parameters after); one step on the kernels against plain cores."""
    import numpy as np

    from medt_tpu_torch import ops
    from medt_tpu_torch.data import blob_batch
    from medt_tpu_torch.models import build_model
    from medt_tpu_torch.serving import InferenceEngine
    from medt_tpu_torch.training import TrainState, adam_l2, train_step

    bf16 = torch.bfloat16
    variables = build_model("MedT", img_size=IMG, seed=0,
                            device="cpu").state_dict()
    images, masks = blob_batch(BATCH, IMG, seed=0)
    batch = {"image": images, "label": masks}
    served = list(images)

    # -- the main path, counted: served batches in bf16 ----------------------
    engine = InferenceEngine("MedT", IMG, variables=variables,
                             batch_size=BATCH, dtype=bf16)
    engine.logits(served)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(BF16_SERVE_FORWARDS):
        logits_bf16 = engine.logits(served)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) / BF16_SERVE_FORWARDS * 1e3
    serve_counts = ops.launch_counts()
    # -- end of the counted run ----------------------------------------------
    engines = {
        "plain_bf16": InferenceEngine("MedT", IMG, variables=variables,
                                      batch_size=BATCH, dtype=bf16,
                                      plain_cores=True),
        "float32": InferenceEngine("MedT", IMG, variables=variables,
                                   batch_size=BATCH)}
    logits = {k: e.logits(served).float() for k, e in engines.items()}
    e32 = engines["float32"]
    e32.logits(served)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(BF16_SERVE_FORWARDS):
        e32.logits(served)
    torch.cuda.synchronize()
    serve32_ms = (time.perf_counter() - t0) / BF16_SERVE_FORWARDS * 1e3
    del engine, engines, e32
    vs_plain = float((logits_bf16.float() - logits["plain_bf16"]).abs().max())
    vs_f32 = float((logits_bf16.float() - logits["float32"]).abs().max())
    plain_vs_f32 = float((logits["plain_bf16"] - logits["float32"])
                         .abs().max())
    serve_tol = LOGITS_ATOL + 2.0 * plain_vs_f32

    # -- the main path, counted: bf16 train steps at batch 16 ----------------
    model = build_model("MedT", img_size=IMG, use_fused=True, device="cuda",
                        dtype=bf16)
    model.load_state_dict(variables, strict=True)
    state = TrainState(model, adam_l2(model.parameters(), TRAIN_LR))
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, loss0 = _timed_steps(torch, state, batch)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = torch.stack([train_step(state, batch)["loss"]
                          for _ in range(20)]).tolist()
    step_counts = ops.launch_counts()
    # -- end of the counted run ----------------------------------------------
    dtypes = sorted({str(p.dtype) for p in model.parameters()} |
                    {str(b.dtype) for b in model.buffers()
                     if b.is_floating_point()})
    del state, model
    model = build_model("MedT", img_size=IMG, use_fused=True, device="cuda")
    model.load_state_dict(variables, strict=True)
    state = TrainState(model, adam_l2(model.parameters(), TRAIN_LR))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step32_ms, _ = _timed_steps(torch, state, batch)
    peak32_gb = torch.cuda.max_memory_allocated() / 1e9
    del state, model

    loss_k, loss_p, checks = step_parity(torch, "MedT", IMG, images, masks,
                                         variables, dtype=bf16,
                                         input_noise=BF16_ULP,
                                         rel_tol=BF16_ULP)
    bad = [c for c in checks if not c["ok"]]
    steps = 33
    emit("bf16", model="MedT", img=IMG, batch=BATCH, dtype="bfloat16",
         serve={"ms_per_batch": serve_ms, "float32_ms_per_batch": serve32_ms,
                "images_per_s": BATCH / serve_ms * 1e3,
                "float32_images_per_s": BATCH / serve32_ms * 1e3,
                "forwards_counted": BF16_SERVE_FORWARDS,
                "launches": serve_counts,
                "logits_max_abs_diff_vs_plain_bf16": vs_plain,
                "logits_max_abs_diff_vs_float32": vs_f32,
                "plain_bf16_vs_float32": plain_vs_f32,
                "tolerance_vs_plain": serve_tol},
         train={"ms_per_step": step_ms, "float32_ms_per_step": step32_ms,
                "images_per_s": BATCH / step_ms * 1e3,
                "float32_images_per_s": BATCH / step32_ms * 1e3,
                "peak_memory_gb": peak_gb,
                "float32_peak_memory_gb": peak32_gb,
                "steps_counted": steps, "launches": step_counts,
                "loss_step0": loss0, "loss_first": losses[0],
                "loss_last": losses[-1], "state_dtypes": dtypes},
         parity={"loss_kernels": loss_k, "loss_plain": loss_p,
                 "tensors": len(checks), "failed": len(bad),
                 "worst": max(checks, key=lambda c: c["err"] / c["tol"]),
                 "input_noise": BF16_ULP, "rel_tol": BF16_ULP})
    check(serve_counts == launches_of(serve_counts, BF16_FORWARD,
                                      BF16_SERVE_FORWARDS),
          f"bf16 served launch counts {serve_counts}")
    check(logits_bf16.dtype == bf16 and tuple(logits_bf16.shape) ==
          (BATCH, 2, IMG, IMG) and bool(torch.isfinite(logits_bf16).all()),
          f"bf16 logits {logits_bf16.dtype} {tuple(logits_bf16.shape)}")
    check(vs_plain <= serve_tol, f"bf16 logits vs plain cores {vs_plain} > "
                                 f"{serve_tol}")
    check(step_counts == launches_of(step_counts, BF16_STEP, steps),
          f"bf16 step launch counts {step_counts} for {steps} steps")
    check(dtypes == ["torch.float32"], f"parameters and statistics {dtypes}")
    check(all(np.isfinite(losses)), "non-finite bf16 loss")
    check(np.mean(losses[-5:]) < np.mean(losses[:5]),
          f"bf16 loss did not fall over 20 steps: {losses}")
    check(not bad, f"bf16 step on kernels vs plain cores: {bad[:5]}")
    counts = dict(serve_counts)
    for k, v in step_counts.items():
        counts[k] = counts.get(k, 0) + v
    return counts


def phase_remat(torch):
    """``train_step(remat=True)`` of MedT 128 at batch 16 in float32: one
    step against a plain step from identical weights with cuDNN
    deterministic (loss rtol 1e-6, every parameter atol 1e-5 after an SGD
    step, running statistics equal: one update); exact launch counts
    (forward twice, backward once); ms per step and peak memory of both.
    The parameters after an Adam-L2 step are reported, not held: its first
    step is about lr * sign(grad), and the gradients of the convolutions'
    biases ahead of a train-mode BN are rounding noise, which the card's
    upsample backward (atomic adds) changes from run to run, so two plain
    Adam steps differ by up to 2 lr there as well."""
    from medt_tpu_torch import ops
    from medt_tpu_torch.data import blob_batch
    from medt_tpu_torch.models import build_model
    from medt_tpu_torch.training import (TrainState, adam_l2, sgd,
                                         train_step)

    variables = build_model("MedT", img_size=IMG, seed=0,
                            device="cpu").state_dict()
    images, masks = blob_batch(BATCH, IMG, seed=0)
    batch = {"image": images, "label": masks}

    def fresh(opt="adam"):
        model = build_model("MedT", img_size=IMG, use_fused=True,
                            device="cuda")
        model.load_state_dict(variables, strict=True)
        tx = (adam_l2(model.parameters(), TRAIN_LR) if opt == "adam"
              else sgd(model.parameters(), TRAIN_LR))
        return TrainState(model, tx)

    def one_step(opt, remat):
        state = fresh(opt)
        ops.reset_launch_counts()
        loss = float(train_step(state, batch, remat=remat)["loss"])
        return loss, ops.launch_counts(), {
            k: t.detach().clone() for k, t in state.model.state_dict().items()}

    def max_diff(a, b, keys):
        return max(float((a[k] - b[k]).abs().max()) for k in keys)

    torch.backends.cudnn.deterministic = True
    loss_p, _, sd_p = one_step("sgd", False)
    loss_r, counts, sd_r = one_step("sgd", True)
    adam = [one_step("adam", remat)[2] for remat in (False, False, True)]
    torch.backends.cudnn.deterministic = False
    stats = [k for k in sd_p if k.endswith(("running_mean", "running_var"))]
    params = [k for k in sd_p
              if k not in stats and sd_p[k].is_floating_point()]
    param_err = max_diff(sd_r, sd_p, params)
    stats_equal = all(torch.equal(sd_r[k], sd_p[k]) for k in stats)
    fresh_sd = fresh().model.state_dict()
    moved = sum(not torch.equal(sd_r[k], fresh_sd[k]) for k in stats)

    timing = {}
    for remat in (False, True):
        state = fresh()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, _ = _timed_steps(torch, state, batch, remat=remat)
        timing["remat" if remat else "plain"] = {
            "ms_per_step": ms,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        del state
    emit("remat", model="MedT", img=IMG, batch=BATCH, optimizer="sgd",
         loss_plain=loss_p, loss_remat=loss_r, param_max_abs_diff=param_err,
         running_stats_equal=stats_equal, running_stats=len(stats),
         running_stats_moved=moved, launches=counts,
         expected_launches=REMAT_STEP,
         adam_param_max_abs_diff={
             "remat_vs_plain": max_diff(adam[2], adam[0], params),
             "plain_vs_plain": max_diff(adam[1], adam[0], params)},
         **timing)
    check(abs(loss_r - loss_p) <= 1e-6 * abs(loss_p),
          f"remat loss {loss_r} vs {loss_p}")
    check(param_err <= 1e-5, f"remat parameters differ by {param_err}")
    check(stats_equal and moved == len(stats),
          f"running statistics: equal {stats_equal}, {moved} of "
          f"{len(stats)} moved by the step")
    check(counts == launches_of(counts, REMAT_STEP, 1),
          f"remat step launch counts {counts} != {REMAT_STEP}")
    return counts


BF16_CLI_IMAGES = 8
# cli.train --dtype bfloat16 --remat at batch 1: the global branch's
# stripe sites stay float32 (forward twice under remat), the lanes and
# moments sites take bf16; each validation forward (eval) runs the eval
# kernel in float32 and the lanes kernel in bf16
BF16_B1_STEP = {"stripe_attn_fwd": 12, "stripe_attn_bwd": 6,
                "lanes_attn_fwd_bf16": 32, "lanes_attn_bwd_bf16": 16,
                "moment_sums_fwd_bf16": 32, "moment_sums_bwd_bf16": 16}
BF16_B1_FORWARD = {"axial_eval_fwd": 14, "lanes_attn_fwd_bf16": 8}


def write_adam7_png(path, image):
    """An (H, W, 3) uint8 RGB image as an Adam7-interlaced 8-bit PNG, every
    pass's rows unfiltered (filter 0)."""
    import struct
    import zlib

    import numpy as np

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body +
                struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    h, w, _ = image.shape
    raw = b""
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                           (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        sub = np.ascontiguousarray(image[y0::dy, x0::dx])
        for row in sub.reshape(sub.shape[0], -1):
            raw += b"\0" + row.tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) +
                chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def phase_bf16_cli(torch):
    """``cli.train --dtype bfloat16 --remat`` at its default batch 1, one
    epoch in process over 8 synthetic PNG pairs, one image written
    Adam7-interlaced: exact launch counts, a finite loss, a checkpoint and
    one mask per image of its size."""
    import math
    import shutil

    from medt_tpu_torch import ops
    from medt_tpu_torch.cli import train as cli_train
    from medt_tpu_torch.data import make_png_dataset, read_png

    root = REPO / "_smoke" / "bf16"
    shutil.rmtree(root, ignore_errors=True)
    data = make_png_dataset(str(root / "data"), BF16_CLI_IMAGES, IMG, seed=2)
    first = root / "data" / "img" / "000.png"
    image = read_png(str(first))[..., ::-1].copy()       # BGR -> RGB
    write_adam7_png(str(first), image)
    check(first.read_bytes()[28] == 1 and (read_png(str(first))[..., ::-1]
                                           == image).all(),
          "the Adam7 image does not read back as its pixels")
    out = root / "out"
    argv = ["--train_dataset", data, "--val_dataset", data, "--modelname",
            "MedT", "--imgsize", str(IMG), "--epochs", "1", "--save_freq",
            "1", "--direc", str(out), "--dtype", "bfloat16", "--remat"]

    # -- the main path, counted: one epoch ------------------------------------
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state = cli_train.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    # -- end of the counted run ----------------------------------------------
    expect = launches_of(counts, BF16_B1_STEP, BF16_CLI_IMAGES)
    for k, v in BF16_B1_FORWARD.items():
        expect[k] += v * BF16_CLI_IMAGES
    dtypes = sorted({str(p.dtype) for p in state.model.parameters()})
    log = [json.loads(line) for line in
           (out / "train_log.jsonl").read_text().splitlines()]
    masks = sorted((out / "0").glob("*.png"))
    emit("bf16_cli", model="MedT", img=IMG, batch=1, dtype="bfloat16",
         remat=True, images=BF16_CLI_IMAGES, adam7_image=first.name,
         steps=state.step, launches=counts, wall_s=wall_s, log=log,
         parameter_dtypes=dtypes)
    check(counts == expect, f"launch counts {counts} != {expect}")
    check(state.step == BF16_CLI_IMAGES, f"{state.step} steps")
    check(dtypes == ["torch.float32"], f"parameters {dtypes}")
    check(len(log) == 1 and math.isfinite(log[0]["loss"]),
          f"train_log.jsonl {log}")
    check((out / "0" / "ckpt.pth").is_file(), "no checkpoint")
    check(len(masks) == BF16_CLI_IMAGES and all(
        read_png(str(m), gray=True).shape == (IMG, IMG) for m in masks),
        f"masks {[m.name for m in masks]}")
    shutil.rmtree(REPO / "_smoke", ignore_errors=True)
    return counts


# ---- 18. cls: the classification harness --------------------------------------

# axial26s at 224 px (s = 0.5, g = 8, mode "full": every site has
# positions): (span, gp, stripes per image, sites) and the route of each
# site in a batch-8 train step, a batch-8 eval forward, a batch-1 eval
# forward and a batch-1 train step; layers 3 and 4 run at gp 32 and 64
CLS_ROUTES = {
    (56, 8, 56, 2): ("flash", "flash", "eval", "stripe"),
    (56, 16, 56, 2): ("flash", "flash", "eval", "stripe"),
    (28, 16, 28, 2): ("flash", "flash", "eval", "flash"),
    (28, 32, 28, 2): ("flash", "flash", "eval", "flash"),
    (14, 32, 14, 6): ("lanes", "eval", "eval", "lanes"),
    (14, 64, 14, 2): ("lanes", "eval", "eval", "lanes"),
}
# (call, batch, training), in CLS_ROUTES's column order
CLS_CALLS = (("b8_step", 8, True), ("b8_forward", 8, False),
             ("b1_forward", 1, False), ("b1_step", 1, True))
ROUTE_KERNELS = {"eval": ("axial_eval_fwd",),
                 "lanes": ("lanes_attn_fwd", "lanes_attn_bwd"),
                 "flash": ("flash_lanes_fwd", "flash_lanes_bwd"),
                 "flash2": ("flash2_lanes_fwd", "flash2_lanes_bwd"),
                 "stripe": ("stripe_attn_fwd", "stripe_attn_bwd")}
# JAX's train_cls defaults: SGD, momentum 0.9, L2 1e-4, lr 0.1; label
# smoothing 0.1
CLS_IMG, CLS_CLASSES, CLS_LR, CLS_MOMENTUM, CLS_WD, CLS_SMOOTHING = (
    224, 1000, 0.1, 0.9, 1e-4, 0.1)
CLS_STEPS = 5
# The counted steps' learning check: SGD as above at CLS_LEARN_LR, the
# last of the CLS_STEPS losses after the first below CLS_LOSS_FALL of the
# step-0 loss. At JAX's lr 0.1 (set for its default batch of 256) SGD on
# one batch of 8 drops the loss once and then climbs (axial26s at 224 px
# on the H100: 6.78, then 4.90, 5.99, 6.20, 6.68, 7.15; on plain cores
# alike, as the held first step shows), so the fall is taken at lr 0.01,
# where it is steady (axial26s at 64 px on the CPU: 7.19 to 2.92 in 5).
CLS_LEARN_LR = 0.01
CLS_LOSS_FALL = 0.75
# axial50m (cls_wide) at the same lr falls for three steps and then climbs
# (H100: 7.09, then 5.09, 3.79, 3.76, 4.35, 4.48 and, on another run, 5.12,
# 3.83, 3.16, 4.52, 5.03; SGD with momentum 0.9 on one repeated batch), so
# its check takes the median of the CLS_STEPS losses, as train512's
# loss_fell does, against the same CLS_LOSS_FALL
# the port's kernels in a profiled axial26s step, by the name of the CUDA
# kernel (the first that a kernel's name contains): the gp <= 16 designs,
# then the wide ones (the long-span flash2 kernels: the forward and the
# backward's row pass, which also sums the table gradients, and column
# pass; rows 1 and 3 share wide_fwd_kernel, rows 2 and 4 the wide
# backward's row, column and table kernels; the moments names first, as
# "wide_tab_kernel" is part of "moments_wide_tab_kernel")
CLS_OWN_KERNELS = (
    "long_fwd_kernel", "long_row_kernel", "long_col_kernel",
    "moments_wide_fwd_kernel", "moments_wide_dqk_kernel",
    "moments_wide_tab_kernel", "wide_fwd_kernel", "wide_row_kernel",
    "wide_col_kernel", "wide_tab_kernel", "axial_lanes_fwd_kernel",
    "lanes_bwd_kernel",
    "tiled_fwd_kernel", "tiled_bwd_row_kernel", "tiled_bwd_col_kernel",
    "bwd_finalize_kernel", "moments_fwd_kernel", "moments_finalize_kernel",
    "moments_bwd_kernel", "tab_finalize_kernel")
CLS_CLI_PER_CLASS = 8


def route_kernels(route: str, training: bool) -> tuple:
    """The kernels one site on ``route`` launches: the route's forward
    and, training, its backward and, on the lanes, flash and flash2
    routes, the moments forward and backward."""
    kernels = ROUTE_KERNELS[route][:2 if training else 1]
    if training and route in ("lanes", "flash", "flash2"):
        kernels += ("moment_sums_fwd", "moment_sums_bwd")
    return kernels


def cls_geometries(routes=None, calls=None):
    """{call: [(kernel, span, gp, stripes, launches per call)]} of a
    classifier's paths (``routes``: CLS_ROUTES, axial26s's, by default;
    ``calls``: the names of CLS_CALLS to take, all by default): a route's
    forward (and, training, its backward and, on the lanes and flash
    routes, the moments forward and backward) once per site."""
    out = {}
    for col, (call, batch, training) in enumerate(CLS_CALLS):
        if calls is not None and call not in calls:
            continue
        rows = []
        for (L, gp, per_image, sites), route in (routes or CLS_ROUTES).items():
            rows += [(k, L, gp, per_image * batch, sites)
                     for k in route_kernels(route[col], training)]
        out[call] = rows
    return out


def cls_launches(call: str, routes=None) -> dict:
    """Launches per call of ``call``, by kernel."""
    out = {}
    for kernel, *_, n in cls_geometries(routes, (call,))[call]:
        out[kernel] = out.get(kernel, 0) + n
    return out


def cls_routes_seen(model) -> dict:
    """{(route, span, gp): sites} of the last forward, from each
    AxialAttention's ``last_route``."""
    from medt_tpu_torch.ops import AxialAttention

    seen = {}
    for m in model.modules():
        if isinstance(m, AxialAttention) and m.last_route is not None:
            route, L, _, gp, _, _ = m.last_route
            seen[(route, L, gp)] = seen.get((route, L, gp), 0) + 1
    return seen


def cls_routes_expected(col: int, routes=None) -> dict:
    return {(route[col], L, gp): n
            for (L, gp, _, n), route in (routes or CLS_ROUTES).items()}


def _cls_kernel_rows(torch, routes=None, calls=None, path="axial26s",
                     seed=2):
    """Each kernel at each geometry of a classifier's paths (axial26s's by
    default) against its plain version: CUDA-event times of kernel and
    plain version and the bound; then per call and kernel the launches,
    ms, plain ms and bound summed over its sites."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {}
    for call, geo in cls_geometries(routes, calls).items():
        for kernel, L, gp, S, _ in geo:
            key = (kernel, L, gp, S)
            if key in rows:
                continue
            fn, plain = kernel_calls(torch, gen, kernel, gp, L, S, True)
            got, again, want = fn(), fn(), plain()
            torch.cuda.synchronize()
            err, ok = compare(torch, kernel, got, want)
            repeatable = all(torch.equal(a, b) for a, b in zip(got, again))
            nbytes, ops = work(kernel, gp, L, S, True)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
            rows[key] = {
                "kernel": kernel, "span": L, "gp": gp, "S": S, "g": GROUPS,
                "has_pos": True, "max_abs_err": err,
                "ok": ok and repeatable, "repeatable": repeatable,
                "ms": time_ms(torch, fn, reps=7, inner=3),
                "plain_ms": time_ms(torch, plain, reps=3, inner=1),
                "bytes": nbytes, "ops": ops,
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            print(json.dumps({"geometry": {**rows[key], "path": path}}),
                  flush=True)
            del fn, plain, got, again, want
    torch.cuda.empty_cache()
    return list(rows.values()), _per_call(rows, cls_geometries(routes, calls))


def _per_call(rows, geometries):
    """Per call and kernel of ``geometries``: the launches, and the ms,
    plain ms and bound of ``rows`` (by (kernel, span, gp, stripes)) summed
    over its sites."""
    per_call = {}
    for call, geo in geometries.items():
        mine = per_call[call] = {}
        for kernel, L, gp, S, n in geo:
            r = rows[(kernel, L, gp, S)]
            k = mine.setdefault(kernel, {"launches": 0, "ms": 0.0,
                                         "plain_ms": 0.0, "bound_ms": 0.0,
                                         "bytes_ms": 0.0, "ops_ms": 0.0})
            k["launches"] += n
            for f in ("ms", "plain_ms", "bound_ms"):
                k[f] += r[f] * n
            k["bytes_ms"] += r["bytes"] / HBM_BYTES_PER_S * 1e3 * n
            k["ops_ms"] += r["ops"] / F32_FLOPS_PER_S * 1e3 * n
        for k in mine.values():
            k["bound_by"] = "bytes" if k.pop("bytes_ms") >= k.pop("ops_ms") \
                else "operations"
    return per_call


def _cls_args(model="axial26s", **kw):
    import argparse

    return argparse.Namespace(model=model, num_classes=CLS_CLASSES, **kw)


def _cls_model(variables, plain: bool, model="axial26s", dtype=None,
               img=CLS_IMG):
    """A classifier (axial26s by default) on the card under ``use_fused``
    (``plain``: plain cores) with ``variables`` loaded, built by
    ``builders.build_model``; with ``dtype`` (its compute dtype) or at
    another ``img`` than 224 px (neither of which ``build_model`` takes)
    by the model's factory."""
    from medt_tpu_torch import builders
    from medt_tpu_torch.models import classifiers

    if dtype is None and img == CLS_IMG:
        net = builders.build_model(_cls_args(model), device="cuda",
                                   use_fused=True, plain_cores=plain)
    else:
        net = getattr(classifiers, model)(
            num_classes=CLS_CLASSES, img_size=img, use_fused=True,
            plain_cores=plain, dtype=dtype, device="cuda").eval()
    net.load_state_dict(variables, strict=True)
    return net


def _cls_state(torch, variables, plain: bool, lr: float = CLS_LR,
               model="axial26s", dtype=None, img=CLS_IMG):
    from medt_tpu_torch.training import TrainState, sgd

    net = _cls_model(variables, plain, model, dtype, img)
    return TrainState(net, sgd(net.parameters(), lr, momentum=CLS_MOMENTUM,
                               weight_decay=CLS_WD))


def cls_step_parity(torch, variables, images, labels,
                    input_noise=STEP_INPUT_NOISE, rel_tol=1e-4,
                    model="axial26s", img=CLS_IMG):
    """One SGD step of a classifier (axial26s by default; label smoothing
    0.1) on the kernels against
    the same step on plain cores from identical weights (cuDNN
    deterministic), held as held() holds the segmentation steps: the loss,
    every parameter after the update and every running statistic; the
    gradients are reported beside them. Returns (loss on the kernels, on
    plain cores, checks, gradient checks, launches of the kernel step)."""
    import numpy as np

    from medt_tpu_torch import ops
    from medt_tpu_torch.cli.train_cls import make_steps

    train_step, _ = make_steps(CLS_SMOOTHING)

    def one_step(plain, image):
        state = _cls_state(torch, variables, plain, model=model, img=img)
        loss = float(train_step(state, {"image": image, "label": labels})
                     ["loss"])
        net = state.model
        grads = {k: p.grad.detach().clone()
                 for k, p in net.named_parameters() if p.requires_grad}
        params = {k: p.detach().clone() for k, p in net.named_parameters()}
        stats = {k: b.detach().clone() for k, b in net.named_buffers()
                 if k.endswith(("running_mean", "running_var"))}
        return loss, grads, params, stats

    torch.backends.cudnn.deterministic = True
    ops.reset_launch_counts()
    loss_k, grads_k, params_k, stats_k = one_step(False, images)
    counts = ops.launch_counts()
    loss_p, grads_p, params_p, stats_p = one_step(True, images)
    rng = np.random.default_rng(1)
    spread = [one_step(True, (images * (1.0 + input_noise * rng
                                        .standard_normal(images.shape)))
                       .astype(np.float32)) for _ in range(2)]
    torch.backends.cudnn.deterministic = False
    checks = [held(torch, "loss", torch.tensor(loss_k), torch.tensor(loss_p),
                   [torch.tensor(s[0]) for s in spread], rel_tol)]
    checks += [held(torch, k, params_k[k], params_p[k],
                    [s[2][k] for s in spread], rel_tol) for k in params_p]
    checks += [held(torch, k, stats_k[k], stats_p[k],
                    [s[3][k] for s in spread], rel_tol) for k in stats_p]
    grad_checks = [held(torch, k, grads_k[k], grads_p[k],
                        [s[1][k] for s in spread], rel_tol) for k in grads_p]
    return loss_k, loss_p, checks, grad_checks, counts


def _parity_summary(loss_k, loss_p, checks, grads, counts=None):
    """A step parity's record (losses, tensors held, the worst tensor and
    gradient against its bound, launches if given) and its failed
    checks."""
    bad = [c for c in checks if not c["ok"]]
    out = {"loss_kernels": loss_k, "loss_plain": loss_p,
           "tensors": len(checks), "failed": len(bad),
           "worst": max(checks, key=lambda c: c["err"] / c["tol"]),
           "gradients_worst": max(grads, key=lambda c: c["err"] / c["tol"]),
           "gradients_beyond_bound": sum(not c["ok"] for c in grads)}
    if counts is not None:
        out["launches"] = counts
    return out, bad


def _cls_forward_parity(torch, variables, images, col, model="axial26s",
                        routes=None, img=CLS_IMG):
    """An eval forward of a classifier (axial26s by default) on the
    kernels (counted) against plain cores at LOGITS_ATOL, its routes
    against column ``col`` of ``routes`` (CLS_ROUTES by default)."""
    from medt_tpu_torch import ops
    from medt_tpu_torch.training.state import normalize

    x = normalize(images, "cuda")
    out = {}
    for plain in (False, True):
        net = _cls_model(variables, plain, model, img=img).eval()
        ops.reset_launch_counts()
        with torch.no_grad():
            out[plain] = net(x)
        torch.cuda.synchronize()
        if not plain:
            counts = ops.launch_counts()
            seen = cls_routes_seen(net)
    err = float((out[False] - out[True]).abs().max())
    return {"max_abs_err": err, "ok": err <= LOGITS_ATOL and bool(
        torch.isfinite(out[False]).all()), "launches": counts,
        "routes_ok": seen == cls_routes_expected(col, routes)}


def _cls_cli(torch):
    """``python -m medt_tpu_torch.cli.train_cls`` on the card over an
    ImageFolder of 2 classes x CLS_CLI_PER_CLASS 256x256 PNGs per split:
    resnet18 at 224 px, one epoch at batch 4."""
    import shutil

    import numpy as np

    from medt_tpu_torch.data.png import write_png

    root = REPO / "_smoke" / "cls"
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(3)
    for split in ("train", "val"):
        for c in ("class_a", "class_b"):
            (root / split / c).mkdir(parents=True)
            for i in range(CLS_CLI_PER_CLASS):
                write_png(str(root / split / c / f"{i:02d}.png"),
                          rng.integers(0, 256, (256, 256, 3), dtype=np.uint8))
    out = root / "out"
    cmd = [sys.executable, "-m", "medt_tpu_torch.cli.train_cls", "--model",
           "resnet18", "--num_classes", "2", "--imgsize", "224", "--epochs",
           "1", "-b", "4", "--train_dataset", str(root / "train"),
           "--val_dataset", str(root / "val"), "--work_dirs", str(out),
           "--workers", "4"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=str(REPO), capture_output=True, text=True,
                          timeout=600)
    wall_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"cli.train_cls exited {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    log = [json.loads(line) for line in
           (out / "train_log.jsonl").read_text().splitlines()]
    ckpt = out / "0" / "ckpt.pth"
    check(len(log) == 1 and math.isfinite(log[0]["loss"])
          and 0.0 <= log[0].get("val_acc", -1.0) <= 1.0,
          f"train_log.jsonl {log}")
    check(ckpt.is_file() and (out / "final_model" / "ckpt.pth").is_file(),
          "no checkpoint")
    ckpt_bytes = ckpt.stat().st_size
    shutil.rmtree(root, ignore_errors=True)
    return {"model": "resnet18", "img": 224, "batch": 4, "epochs": 1,
            "images_per_split": 2 * CLS_CLI_PER_CLASS, "log": log,
            "wall_s": wall_s, "checkpoint_bytes": ckpt_bytes}


def profiled_step_ms(torch, train_step, state, batch, steps=2):
    """Device kernel ms per step over ``steps`` profiled train steps, and
    the port's kernels' share by CUDA kernel name (CLS_OWN_KERNELS, each
    event counted once)."""
    from torch.profiler import ProfilerActivity, profile

    from medt_tpu_torch.profile_serve import _device_us

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            train_step(state, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _device_us(e) > 0
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    device_ms = sum(_device_us(e) for e in kernels) / steps / 1e3 \
        if kernels else "not measured"
    own_ms = {}
    for e in kernels:
        name = next((n for n in CLS_OWN_KERNELS if n in e.key), None)
        if name is not None:
            own_ms[name] = own_ms.get(name, 0.0) + _device_us(e) / steps / 1e3
    return device_ms, own_ms


def phase_cls(torch):
    """The classification harness on the card: each kernel at axial26s's
    geometries against its plain version; axial26s at 224 px, 1000
    classes, float32, use_fused, batch 8 with JAX's SGD defaults: one step
    against plain cores, then counted steps with a falling loss and their
    wall and device times; eval forwards at batch 8 and 1 and a batch-1
    step against plain cores, each with exact launch counts and routes;
    then cli.train_cls on resnet18 over an ImageFolder."""
    import numpy as np

    from medt_tpu_torch import builders, ops
    from medt_tpu_torch.cli.train_cls import make_steps

    rows, per_call = _cls_kernel_rows(torch)
    failed = [r for r in rows if not r["ok"]]
    check(not failed, f"kernel disagrees with its plain version: {failed}")

    variables = builders.build_model(_cls_args(), device="cpu",
                                     seed=0).state_dict()
    rng = np.random.default_rng(0)
    images = rng.standard_normal((8, CLS_IMG, CLS_IMG, 3)).astype(np.float32)
    labels = rng.integers(0, CLS_CLASSES, 8).astype(np.int32)

    # -- batch 8: one step against plain cores -------------------------------
    loss_k, loss_p, checks, grads, step_counts = cls_step_parity(
        torch, variables, images, labels)
    parity, bad = _parity_summary(loss_k, loss_p, checks, grads)
    check(not bad, f"axial26s step on kernels vs plain cores: {bad[:5]}")
    check(step_counts == launches_of(step_counts, cls_launches("b8_step"), 1),
          f"axial26s b8 step launches {step_counts}")

    # -- the main path, counted: a warm-up step, then CLS_STEPS timed -------
    train_step, _ = make_steps(CLS_SMOOTHING)
    state = _cls_state(torch, variables, plain=False, lr=CLS_LEARN_LR)
    batch = {"image": images, "label": labels}
    ops.reset_launch_counts()
    loss0 = float(train_step(state, batch)["loss"])
    routes = cls_routes_seen(state.model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [train_step(state, batch)["loss"] for _ in range(CLS_STEPS)]
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / CLS_STEPS * 1e3
    counts = ops.launch_counts()
    # -- end of the counted run ----------------------------------------------
    losses = torch.stack(losses).tolist()
    device_ms, own_ms = profiled_step_ms(torch, train_step, state, batch)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del state
    torch.cuda.empty_cache()
    check(counts == launches_of(counts, cls_launches("b8_step"),
                                CLS_STEPS + 1),
          f"axial26s launches {counts} for {CLS_STEPS + 1} steps")
    check(routes == cls_routes_expected(0), f"axial26s routes {routes}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    check(losses[-1] < CLS_LOSS_FALL * loss0,
          f"loss did not fall: {loss0} {losses}")

    # -- eval forwards at batch 8 and 1, a batch-1 step ----------------------
    forwards = {"b8_forward": _cls_forward_parity(torch, variables, images,
                                                  1),
                "b1_forward": _cls_forward_parity(torch, variables,
                                                  images[:1], 2)}
    for call, r in forwards.items():
        check(r["ok"] and r["routes_ok"], f"axial26s {call}: {r}")
        check(r["launches"] == launches_of(r["launches"], cls_launches(call),
                                           1), f"axial26s {call}: {r}")
    loss1_k, loss1_p, checks1, grads1, counts1 = cls_step_parity(
        torch, variables, images[:1], labels[:1])
    parity_b1, bad1 = _parity_summary(loss1_k, loss1_p, checks1, grads1,
                                      counts1)
    check(not bad1, f"axial26s batch-1 step vs plain cores: {bad1[:5]}")
    check(counts1 == launches_of(counts1, cls_launches("b1_step"), 1),
          f"axial26s b1 step launches {counts1}")

    cli = _cls_cli(torch)
    emit("cls", model="axial26s", img=CLS_IMG, classes=CLS_CLASSES,
         batch=8, optimizer="sgd", lr=CLS_LR, momentum=CLS_MOMENTUM,
         weight_decay=CLS_WD, label_smoothing=CLS_SMOOTHING,
         geometries=len(rows), kernels_per_call=per_call,
         launches_per_call={c: cls_launches(c) for c, *_ in CLS_CALLS},
         step_parity=parity, launches=counts, steps_counted=CLS_STEPS + 1,
         learn_lr=CLS_LEARN_LR, loss_step0=loss0, losses=losses,
         wall_ms_per_step=wall_ms,
         device_kernel_ms_per_step=device_ms,
         port_kernels_device_ms_per_step=own_ms,
         port_kernels_device_ms_total=sum(own_ms.values()),
         images_per_s=8 / wall_ms * 1e3, peak_memory_gb=peak_gb,
         forwards=forwards, b1_step_parity=parity_b1, train_cls=cli,
         tolerance={"forward": KERNEL_ATOL,
                    "backward_and_moments_rtol": SUM_RTOL,
                    "logits": LOGITS_ATOL})
    return counts


# ---- 19. cls_wide: axial50m and axial50l on the wide kernels -----------------

# (span, gp, stripes per image, sites) of axial50m (s = 0.75) and axial50l
# (s = 1.0) at 224 px and the route of each site in CLS_CALLS's four calls
# (a batch-8 train step, a batch-8 eval forward, a batch-1 eval forward, a
# batch-1 train step). Every gp but axial50l's 16 runs the wide kernels; a
# batch-1 train site at span 56 takes the flash route at a gp the stripe
# kernels do not take (fused_route).
CLS_WIDE_ROUTES = {
    "axial50m": {
        (56, 12, 56, 6): ("flash", "flash", "eval", "flash"),
        (56, 24, 56, 2): ("flash", "flash", "eval", "flash"),
        (28, 24, 28, 6): ("flash", "flash", "eval", "flash"),
        (28, 48, 28, 2): ("flash", "flash", "eval", "flash"),
        (14, 48, 14, 10): ("lanes", "eval", "eval", "lanes"),
        (14, 96, 14, 2): ("lanes", "eval", "eval", "lanes"),
        (7, 96, 7, 4): ("lanes", "eval", "eval", "lanes"),
    },
    "axial50l": {
        (56, 16, 56, 6): ("flash", "flash", "eval", "stripe"),
        (56, 32, 56, 2): ("flash", "flash", "eval", "flash"),
        (28, 32, 28, 6): ("flash", "flash", "eval", "flash"),
        (28, 64, 28, 2): ("flash", "flash", "eval", "flash"),
        (14, 64, 14, 10): ("lanes", "eval", "eval", "lanes"),
        (14, 128, 14, 2): ("lanes", "eval", "eval", "lanes"),
        (7, 128, 7, 4): ("lanes", "eval", "eval", "lanes"),
    },
}
# the calls each model runs in the phase: axial50m at batch 8, axial50l at
# batch 1
CLS_WIDE_CALLS = {"axial50m": ("b8_step", "b8_forward"),
                  "axial50l": ("b1_forward", "b1_step")}
# the wide kernels' entries of the summary line: the wrapper, the source
# of its wide kernel, and the call of the phase that is its main path
WIDE_SOURCES = {
    "lanes_attn_fwd": "medt_tpu_torch/csrc/axial_wide.cu",
    "lanes_attn_bwd": "medt_tpu_torch/csrc/axial_wide_bwd.cu",
    "flash_lanes_fwd": "medt_tpu_torch/csrc/axial_wide.cu",
    "flash_lanes_bwd": "medt_tpu_torch/csrc/axial_wide_bwd.cu",
    "moment_sums_fwd": "medt_tpu_torch/csrc/moments_wide.cu",
    "moment_sums_bwd": "medt_tpu_torch/csrc/moments_wide.cu",
    "axial_eval_fwd": "medt_tpu_torch/csrc/axial_eval_fwd.cu",
}


def _cls_wide_bf16_rows(torch, routes, call):
    """Each bf16 entry point at each geometry of ``call`` (bf16_row), held
    to its float32 twin bit for bit; then per kernel the launches, ms,
    float32 ms, plain ms and bound with 2-byte qkv summed over the call's
    sites."""
    geo = cls_geometries(routes, (call,))
    rows = {}
    for seed, (kernel, L, gp, S, _) in enumerate(geo[call]):
        key = (kernel, L, gp, S)
        if kernel not in BF16_KERNELS or key in rows:
            continue
        row = bf16_row(torch, kernel, L, gp, S, True, 2000 + seed, reps=7,
                       inner=3)
        row["ok"] = row["ok"] and row["bits_equal_float32_twin"]
        rows[key] = row
        print(json.dumps({"geometry": {**row, "path": "axial50m"}}),
              flush=True)
    torch.cuda.empty_cache()
    bf16_geo = {call: [g for g in geo[call] if g[0] in BF16_KERNELS]}
    per_call = _per_call(rows, bf16_geo)[call]
    for kernel, k in per_call.items():
        k["float32_ms"] = sum(rows[(kk, L, gp, S)]["float32_ms"] * n
                              for kk, L, gp, S, n in bf16_geo[call]
                              if kk == kernel)
    return list(rows.values()), per_call


def phase_cls_wide(torch):
    """axial50m and axial50l at 224 px (1000 classes, ``use_fused``) on
    the wide kernels: each kernel at each geometry of axial50m's batch-8
    calls and axial50l's batch-1 calls against its plain version, and the
    bf16 entry points at axial50m's batch-8 step geometries against their
    float32 twins; axial50m at batch 8: one SGD step against plain cores,
    a counted warm-up and CLS_STEPS timed steps at CLS_LEARN_LR with a
    falling loss, an eval forward against plain cores; axial50l at batch
    1: an eval forward and a train step against plain cores; axial50m in
    bf16: one counted step with a finite loss. Every call's launches and
    routes exact."""
    import numpy as np

    from medt_tpu_torch import builders, ops
    from medt_tpu_torch.cli.train_cls import make_steps

    rows, per_call = [], {}
    for model, calls in CLS_WIDE_CALLS.items():
        r, pc = _cls_kernel_rows(torch, CLS_WIDE_ROUTES[model], calls, model,
                                 seed=len(rows) + 3)
        rows += r
        per_call.update({f"{model}_{c}": v for c, v in pc.items()})
    m_routes, l_routes = CLS_WIDE_ROUTES["axial50m"], CLS_WIDE_ROUTES[
        "axial50l"]
    bf16_rows, bf16_per_call = _cls_wide_bf16_rows(torch, m_routes,
                                                   "b8_step")
    failed = [r for r in rows + bf16_rows if not r["ok"]]
    check(not failed, f"kernel disagrees with its plain version or its "
                      f"float32 twin: {failed}")

    rng = np.random.default_rng(0)
    images = rng.standard_normal((8, CLS_IMG, CLS_IMG, 3)).astype(np.float32)
    labels = rng.integers(0, CLS_CLASSES, 8).astype(np.int32)

    # -- axial50m, batch 8: one step against plain cores ---------------------
    var_m = builders.build_model(_cls_args("axial50m"), device="cpu",
                                 seed=0).state_dict()
    loss_k, loss_p, checks, grads, step_counts = cls_step_parity(
        torch, var_m, images, labels, model="axial50m")
    parity, bad = _parity_summary(loss_k, loss_p, checks, grads)
    check(not bad, f"axial50m step on kernels vs plain cores: {bad[:5]}")
    b8_step = cls_launches("b8_step", m_routes)
    check(step_counts == launches_of(step_counts, b8_step, 1),
          f"axial50m b8 step launches {step_counts}")

    # -- the main path, counted: a warm-up step, then CLS_STEPS timed -------
    train_step, _ = make_steps(CLS_SMOOTHING)
    state = _cls_state(torch, var_m, plain=False, lr=CLS_LEARN_LR,
                       model="axial50m")
    batch = {"image": images, "label": labels}
    ops.reset_launch_counts()
    loss0 = float(train_step(state, batch)["loss"])
    routes = cls_routes_seen(state.model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [train_step(state, batch)["loss"] for _ in range(CLS_STEPS)]
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / CLS_STEPS * 1e3
    counts = ops.launch_counts()
    # -- end of the counted run ----------------------------------------------
    losses = torch.stack(losses).tolist()
    device_ms, own_ms = profiled_step_ms(torch, train_step, state, batch)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del state
    torch.cuda.empty_cache()
    check(counts == launches_of(counts, b8_step, CLS_STEPS + 1),
          f"axial50m launches {counts} for {CLS_STEPS + 1} steps")
    check(routes == cls_routes_expected(0, m_routes),
          f"axial50m routes {routes}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    check(statistics.median(losses) < CLS_LOSS_FALL * loss0,
          f"loss did not fall: {loss0} {losses}")
    forwards = {"axial50m_b8_forward": _cls_forward_parity(
        torch, var_m, images, 1, "axial50m", m_routes)}

    # -- axial50l, batch 1: an eval forward and a train step -----------------
    var_l = builders.build_model(_cls_args("axial50l"), device="cpu",
                                 seed=0).state_dict()
    forwards["axial50l_b1_forward"] = _cls_forward_parity(
        torch, var_l, images[:1], 2, "axial50l", l_routes)
    for call, r in forwards.items():
        model, c = call.split("_", 1)
        check(r["ok"] and r["routes_ok"], f"{call}: {r}")
        check(r["launches"] == launches_of(
            r["launches"], cls_launches(c, CLS_WIDE_ROUTES[model]), 1),
            f"{call}: {r}")
    loss1_k, loss1_p, checks1, grads1, counts1 = cls_step_parity(
        torch, var_l, images[:1], labels[:1], model="axial50l")
    parity_b1, bad1 = _parity_summary(loss1_k, loss1_p, checks1, grads1,
                                      counts1)
    check(not bad1, f"axial50l batch-1 step vs plain cores: {bad1[:5]}")
    check(counts1 == launches_of(counts1, cls_launches("b1_step", l_routes),
                                 1), f"axial50l b1 step launches {counts1}")

    # -- axial50m in bf16: one counted step ----------------------------------
    state = _cls_state(torch, var_m, plain=False, lr=CLS_LEARN_LR,
                       model="axial50m", dtype=torch.bfloat16)
    ops.reset_launch_counts()
    loss_bf16 = float(train_step(state, batch)["loss"])
    torch.cuda.synchronize()
    counts_bf16 = ops.launch_counts()
    del state
    torch.cuda.empty_cache()
    want_bf16 = launches_of(counts_bf16, {f"{k}_bf16": v
                                          for k, v in b8_step.items()}, 1)
    check(math.isfinite(loss_bf16), f"axial50m bf16 loss {loss_bf16}")
    check(counts_bf16 == want_bf16, f"axial50m bf16 launches {counts_bf16}")

    emit("cls_wide", models=list(CLS_WIDE_CALLS), img=CLS_IMG,
         classes=CLS_CLASSES, optimizer="sgd", lr=CLS_LR,
         momentum=CLS_MOMENTUM, weight_decay=CLS_WD,
         label_smoothing=CLS_SMOOTHING, geometries=len(rows),
         bf16_geometries=len(bf16_rows), kernels_per_call=per_call,
         bf16_kernels_per_call=bf16_per_call,
         launches_per_call={f"{m}_{c}": cls_launches(c, CLS_WIDE_ROUTES[m])
                            for m, calls in CLS_WIDE_CALLS.items()
                            for c in calls},
         step_parity=parity, launches=counts, steps_counted=CLS_STEPS + 1,
         learn_lr=CLS_LEARN_LR, loss_step0=loss0, losses=losses,
         wall_ms_per_step=wall_ms, images_per_s=8 / wall_ms * 1e3,
         device_kernel_ms_per_step=device_ms,
         port_kernels_device_ms_per_step=own_ms,
         port_kernels_device_ms_total=sum(own_ms.values()),
         peak_memory_gb=peak_gb, forwards=forwards,
         b1_step_parity=parity_b1, bf16_step={
             "loss": loss_bf16, "launches": counts_bf16},
         tolerance={"forward": KERNEL_ATOL,
                    "backward_and_moments_rtol": SUM_RTOL,
                    "logits": LOGITS_ATOL,
                    "bf16_vs_float32_twin": "bit-equal"})
    return {"b8_steps": counts, "b8_forward":
            forwards["axial50m_b8_forward"]["launches"],
            "bf16_step": counts_bf16, "rows": rows, "bf16_rows": bf16_rows,
            "per_call": per_call, "bf16_per_call": bf16_per_call}


def wide_summary(wide):
    """The summary line's entries of the wide kernels (every gp outside 2,
    4, 8 and 16), one per wrapper that runs one, and one per bf16 entry
    point: times per call of its main path in ``cls_wide``, axial50m at
    batch 8 (a train step, or an eval forward for the eval kernel; the
    bf16 entry points a bf16 step), where every site is wide; launches
    from that path's counted run."""
    entries = []
    for name, source in WIDE_SOURCES.items():
        for bf16 in (False, True):
            if bf16 and name not in BF16_KERNELS:
                continue
            if bf16:
                k = wide["bf16_per_call"][name]
                launches = wide["bf16_step"].get(f"{name}_bf16", 0)
                mine = [r for r in wide["bf16_rows"]
                        if r["kernel"] == f"{name}_bf16"]
            else:
                call = "axial50m_b8_forward" if name == "axial_eval_fwd" \
                    else "axial50m_b8_step"
                k = wide["per_call"][call][name]
                counted = wide["b8_forward"] if name == "axial_eval_fwd" \
                    else wide["b8_steps"]
                launches = counted.get(name, 0)
                mine = [r for r in wide["rows"] if r["kernel"] == name
                        and r["gp"] not in (2, 4, 8, 16)]
            entry = {
                "name": f"{name}{'_bf16' if bf16 else ''}_wide",
                "route": "cuda", "source": source,
                "replaces": REPLACES[name], "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": None, "gp": sorted({r["gp"] for r in mine})}
            if bf16:
                entry["float32_ms"] = k["float32_ms"]
            entries.append(entry)
    return entries


# ---- 20. cls_hires: axial50m and axial50l at 384 px ------------------------

HIRES_IMG = 384
# The counted steps' learning rate at 384 px: SGD with momentum 0.9 on one
# repeated batch at CLS_LEARN_LR overshoots there, and the median of the
# CLS_STEPS losses fell below CLS_LOSS_FALL of the first in one run
# (H100: 6.79, then 5.99, 4.34, 4.18, 4.15, 5.29) and missed it in
# another (5.97, 4.09, 5.10, 4.56, 5.66: median 5.10 against 5.09); at
# half of it the first five steps fell in turn (6.83, then 5.91, 5.37,
# 4.71, 3.28, 3.76, with TF32 convolutions)
HIRES_LEARN_LR = 0.005
# The learning check at 384 px holds the mean over HIRES_LEARN_RUNS runs of
# the median of the CLS_STEPS losses over the step-0 loss against
# CLS_LOSS_FALL: the counted run, and HIRES_LEARN_RUNS - 1 runs more from
# the same weights, each on the batch times 1 + STEP_INPUT_NOISE * n (n
# standard normal, drawn anew a run). One run's ratio is a draw and not a
# measurement: the first SGD step inflates the attention logits' scale,
# which the similarity BN leaves free, by orders of magnitude on every
# implementation, and from there the float32 rounding of the first
# backward (cuDNN's included) decides the 5-step curve, so that a single
# run missed CLS_LOSS_FALL now and then on plain cores and on the kernels
# of every tree measured (``train_losses.py --model axial50m-384``).
HIRES_LEARN_RUNS = 8
# (span, gp, stripes per image, sites) of axial50m and axial50l at 384 px
# (base span 96) and each site's route in CLS_CALLS's four calls: spans 96
# take flash2 in both modes at any stripe count (gp 12, 24, 32 on the
# long-span wide kernels, axial50l's gp 16 on the narrow flash2); spans 48
# and 24 take flash (eval under 128 stripes; a batch-1 train site at span
# 48 would take the stripe route at gp 16 and takes flash at these
# widths); span 12 lanes (eval at both eval batches: 96 and 12 stripes).
CLS_HIRES_ROUTES = {
    "axial50m": {
        (96, 12, 96, 6): ("flash2",) * 4,
        (96, 24, 96, 2): ("flash2",) * 4,
        (48, 24, 48, 6): ("flash", "flash", "eval", "flash"),
        (48, 48, 48, 2): ("flash", "flash", "eval", "flash"),
        (24, 48, 24, 10): ("flash", "flash", "eval", "flash"),
        (24, 96, 24, 2): ("flash", "flash", "eval", "flash"),
        (12, 96, 12, 4): ("lanes", "eval", "eval", "lanes"),
    },
    "axial50l": {
        (96, 16, 96, 6): ("flash2",) * 4,
        (96, 32, 96, 2): ("flash2",) * 4,
        (48, 32, 48, 6): ("flash", "flash", "eval", "flash"),
        (48, 64, 48, 2): ("flash", "flash", "eval", "flash"),
        (24, 64, 24, 10): ("flash", "flash", "eval", "flash"),
        (24, 128, 24, 2): ("flash", "flash", "eval", "flash"),
        (12, 128, 12, 4): ("lanes", "eval", "eval", "lanes"),
    },
}
# axial50m at batch 8 (its main path: a train step and an eval forward),
# axial50l at batch 1; the kernels are also held at axial50m's batch-1
# stripe count
CLS_HIRES_CALLS = {"axial50m": ("b8_step", "b8_forward"),
                   "axial50l": ("b1_forward", "b1_step")}
HIRES_KERNEL_CALLS = {"axial50m": ("b8_step", "b8_forward", "b1_step"),
                      "axial50l": ("b1_forward", "b1_step")}
# the long-span kernels off the models' paths: spans 80-256 at every
# register bucket, with and without positions, at HIRES_SWEEP_STRIPES
HIRES_SWEEP = [(L, gp, pos) for L in (80, 128, 192, 256)
               for gp in (6, 10, 12, 32, 64, 128) for pos in (True, False)]
HIRES_SWEEP_STRIPES = 32
LONG_SOURCES = {"flash2_lanes_fwd": "medt_tpu_torch/csrc/axial_wide_long_fwd.cu",
                "flash2_lanes_bwd": "medt_tpu_torch/csrc/axial_wide_long_bwd.cu"}


def long_routes(routes):
    """The sites of a routes table at spans over 64 (the flash2 route)."""
    return {k: v for k, v in routes.items() if k[0] > 64}


def _hires_sweep_rows(torch):
    """The flash2 forward and backward at every HIRES_SWEEP geometry
    against their plain versions, with CUDA-event times and bounds."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    rows = []
    S = HIRES_SWEEP_STRIPES
    for L, gp, pos in HIRES_SWEEP:
        for kernel in ("flash2_lanes_fwd", "flash2_lanes_bwd"):
            fn, plain = kernel_calls(torch, gen, kernel, gp, L, S, pos)
            got, again, want = fn(), fn(), plain()
            torch.cuda.synchronize()
            err, ok = compare(torch, kernel, got, want)
            repeatable = all(torch.equal(a, b) for a, b in zip(got, again))
            nbytes, ops = work(kernel, gp, L, S, pos)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
            row = {"kernel": kernel, "span": L, "gp": gp, "S": S,
                   "g": GROUPS, "has_pos": pos, "path": "sweep",
                   "max_abs_err": err, "ok": ok and repeatable,
                   "repeatable": repeatable,
                   "ms": time_ms(torch, fn, reps=3, inner=2),
                   "plain_ms": time_ms(torch, plain, reps=2, inner=1),
                   "bytes": nbytes, "ops": ops,
                   "bound_ms": max(t_bytes, t_ops) * 1e3,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            rows.append(row)
            print(json.dumps({"geometry": row}), flush=True)
            del fn, plain, got, again, want
    torch.cuda.empty_cache()
    return rows


def _hires_variables(torch, model):
    """Seeded weights of ``model`` at HIRES_IMG (its position tables have
    2 * span - 1 columns, so the 224 px weights do not load), on the
    CPU."""
    from medt_tpu_torch.models import classifiers

    net = getattr(classifiers, model)(
        num_classes=CLS_CLASSES, img_size=HIRES_IMG,
        generator=torch.Generator().manual_seed(0), device="cpu")
    return net.state_dict()


def hires_learn_runs(torch, train_step, variables, images, labels, runs):
    """The learning check's runs after the counted one: axial50m-384 on the
    kernels from ``variables`` at HIRES_LEARN_LR, each on the batch times
    1 + STEP_INPUT_NOISE * n (n drawn anew a run), a step and then
    CLS_STEPS steps; each run's median loss over its step-0 loss."""
    import numpy as np

    rng = np.random.default_rng(2)
    out = []
    for _ in range(runs):
        image = (images * (1.0 + STEP_INPUT_NOISE * rng.standard_normal(
            images.shape))).astype(np.float32)
        batch = {"image": image, "label": labels}
        state = _cls_state(torch, variables, plain=False, lr=HIRES_LEARN_LR,
                           model="axial50m", img=HIRES_IMG)
        loss0 = float(train_step(state, batch)["loss"])
        losses = torch.stack([train_step(state, batch)["loss"]
                              for _ in range(CLS_STEPS)]).tolist()
        check(all(math.isfinite(v) for v in losses),
              f"non-finite loss {losses}")
        out.append(statistics.median(losses) / loss0)
        del state
        torch.cuda.empty_cache()
    return out


def phase_cls_hires(torch):
    """axial50m and axial50l at 384 px (1000 classes, ``use_fused``,
    published widths and depth, built by their factories) on the kernels:
    each kernel of the long-span (span 96) sites of axial50m's batch-8 and
    batch-1 and axial50l's batch-1 calls against its plain version, and a
    sweep of the flash2 forward and backward over spans 80-256 and gp
    6-128; the bf16 entry points at axial50m's span-96 step sites against
    their float32 twins (bit-equal); axial50m at batch 8: one SGD step
    against plain
    cores, a counted warm-up and CLS_STEPS timed steps at HIRES_LEARN_LR,
    then HIRES_LEARN_RUNS - 1 runs more on a perturbed batch, with a
    falling loss on average, wall and device ms, an eval forward against plain
    cores; axial50l at batch 1: an eval forward and a train step against
    plain cores; axial50m in bf16: one counted step. Every call's
    launches and routes exact."""
    import numpy as np

    from medt_tpu_torch import ops
    from medt_tpu_torch.cli.train_cls import make_steps

    rows, per_call = [], {}
    for model, calls in HIRES_KERNEL_CALLS.items():
        r, pc = _cls_kernel_rows(torch, long_routes(CLS_HIRES_ROUTES[model]),
                                 calls, f"{model}_{HIRES_IMG}",
                                 seed=len(rows) + 31)
        rows += r
        per_call.update({f"{model}_{c}": v for c, v in pc.items()})
    sweep = _hires_sweep_rows(torch)
    m_routes = CLS_HIRES_ROUTES["axial50m"]
    l_routes = CLS_HIRES_ROUTES["axial50l"]
    bf16_rows, bf16_per_call = _cls_wide_bf16_rows(
        torch, long_routes(m_routes), "b8_step")
    failed = [r for r in rows + sweep + bf16_rows if not r["ok"]]
    check(not failed, f"kernel disagrees with its plain version or its "
                      f"float32 twin: {failed}")

    rng = np.random.default_rng(0)
    images = rng.standard_normal((8, HIRES_IMG, HIRES_IMG, 3)).astype(
        np.float32)
    labels = rng.integers(0, CLS_CLASSES, 8).astype(np.int32)
    hires = dict(img=HIRES_IMG)

    # -- axial50m, batch 8: one step against plain cores ---------------------
    var_m = _hires_variables(torch, "axial50m")
    loss_k, loss_p, checks, grads, step_counts = cls_step_parity(
        torch, var_m, images, labels, model="axial50m", **hires)
    parity, bad = _parity_summary(loss_k, loss_p, checks, grads)
    check(not bad, f"axial50m-384 step on kernels vs plain cores: {bad[:5]}")
    b8_step = cls_launches("b8_step", m_routes)
    check(step_counts == launches_of(step_counts, b8_step, 1),
          f"axial50m-384 b8 step launches {step_counts}")

    # -- the main path, counted: a warm-up step, then CLS_STEPS timed -------
    train_step, _ = make_steps(CLS_SMOOTHING)
    state = _cls_state(torch, var_m, plain=False, lr=HIRES_LEARN_LR,
                       model="axial50m", **hires)
    batch = {"image": images, "label": labels}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    loss0 = float(train_step(state, batch)["loss"])
    routes = cls_routes_seen(state.model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [train_step(state, batch)["loss"] for _ in range(CLS_STEPS)]
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / CLS_STEPS * 1e3
    counts = ops.launch_counts()
    # -- end of the counted run ----------------------------------------------
    losses = torch.stack(losses).tolist()
    device_ms, own_ms = profiled_step_ms(torch, train_step, state, batch)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del state
    torch.cuda.empty_cache()
    check(counts == launches_of(counts, b8_step, CLS_STEPS + 1),
          f"axial50m-384 launches {counts} for {CLS_STEPS + 1} steps")
    check(routes == cls_routes_expected(0, m_routes),
          f"axial50m-384 routes {routes}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    learn = [statistics.median(losses) / loss0] + hires_learn_runs(
        torch, train_step, var_m, images, labels, HIRES_LEARN_RUNS - 1)
    check(statistics.mean(learn) < CLS_LOSS_FALL,
          f"loss did not fall: step 0 {loss0}, counted {losses}; median over "
          f"step-0 loss of the {len(learn)} runs {learn}")
    forwards = {"axial50m_b8_forward": _cls_forward_parity(
        torch, var_m, images, 1, "axial50m", m_routes, **hires)}

    # -- axial50l, batch 1: an eval forward and a train step -----------------
    var_l = _hires_variables(torch, "axial50l")
    forwards["axial50l_b1_forward"] = _cls_forward_parity(
        torch, var_l, images[:1], 2, "axial50l", l_routes, **hires)
    for call, r in forwards.items():
        model, c = call.split("_", 1)
        check(r["ok"] and r["routes_ok"], f"{call}: {r}")
        check(r["launches"] == launches_of(
            r["launches"], cls_launches(c, CLS_HIRES_ROUTES[model]), 1),
            f"{call}: {r}")
    loss1_k, loss1_p, checks1, grads1, counts1 = cls_step_parity(
        torch, var_l, images[:1], labels[:1], model="axial50l", **hires)
    parity_b1, bad1 = _parity_summary(loss1_k, loss1_p, checks1, grads1,
                                      counts1)
    check(not bad1, f"axial50l-384 batch-1 step vs plain cores: {bad1[:5]}")
    check(counts1 == launches_of(counts1, cls_launches("b1_step", l_routes),
                                 1), f"axial50l-384 b1 step launches {counts1}")

    # -- axial50m in bf16: one counted step ----------------------------------
    state = _cls_state(torch, var_m, plain=False, lr=HIRES_LEARN_LR,
                       model="axial50m", dtype=torch.bfloat16, **hires)
    ops.reset_launch_counts()
    loss_bf16 = float(train_step(state, batch)["loss"])
    torch.cuda.synchronize()
    counts_bf16 = ops.launch_counts()
    del state
    torch.cuda.empty_cache()
    want_bf16 = launches_of(counts_bf16, {f"{k}_bf16": v
                                          for k, v in b8_step.items()}, 1)
    check(math.isfinite(loss_bf16), f"axial50m-384 bf16 loss {loss_bf16}")
    check(counts_bf16 == want_bf16,
          f"axial50m-384 bf16 launches {counts_bf16}")

    emit("cls_hires", models=list(CLS_HIRES_CALLS), img=HIRES_IMG,
         classes=CLS_CLASSES, optimizer="sgd", lr=CLS_LR,
         momentum=CLS_MOMENTUM, weight_decay=CLS_WD,
         label_smoothing=CLS_SMOOTHING, geometries=len(rows),
         sweep_geometries=len(sweep), bf16_geometries=len(bf16_rows),
         sweep_worst=max(sweep, key=lambda r: r["max_abs_err"]),
         kernels_per_call=per_call, bf16_kernels_per_call=bf16_per_call,
         launches_per_call={f"{m}_{c}": cls_launches(c, CLS_HIRES_ROUTES[m])
                            for m, calls in CLS_HIRES_CALLS.items()
                            for c in calls},
         step_parity=parity, launches=counts, steps_counted=CLS_STEPS + 1,
         learn_lr=HIRES_LEARN_LR, loss_step0=loss0, losses=losses,
         learn_runs=learn, learn_mean=statistics.mean(learn),
         wall_ms_per_step=wall_ms, images_per_s=8 / wall_ms * 1e3,
         device_kernel_ms_per_step=device_ms,
         port_kernels_device_ms_per_step=own_ms,
         port_kernels_device_ms_total=sum(own_ms.values()),
         peak_memory_gb=peak_gb, forwards=forwards,
         b1_step_parity=parity_b1, bf16_step={
             "loss": loss_bf16, "launches": counts_bf16},
         tolerance={"forward": KERNEL_ATOL,
                    "backward_and_moments_rtol": SUM_RTOL,
                    "logits": LOGITS_ATOL,
                    "bf16_vs_float32_twin": "bit-equal"})
    return {"b8_steps": counts, "bf16_step": counts_bf16, "rows": rows,
            "sweep": sweep, "bf16_rows": bf16_rows, "per_call": per_call,
            "bf16_per_call": bf16_per_call}


def hires_summary(hires):
    """The summary line's entries of the long-span wide kernels (the flash2
    wrappers at a wide gp), float32 and bf16: times per axial50m-384
    batch-8 train step (every span-96 site wide; the bf16 entry points in
    the bf16 step), launches from that path's counted run."""
    entries = []
    for name, source in LONG_SOURCES.items():
        for bf16 in (False, True):
            suffix = "_bf16" if bf16 else ""
            if bf16:
                k = hires["bf16_per_call"][name]
                launches = hires["bf16_step"].get(f"{name}_bf16", 0)
                mine = [r for r in hires["bf16_rows"]
                        if r["kernel"] == f"{name}_bf16"]
            else:
                k = hires["per_call"]["axial50m_b8_step"][name]
                launches = hires["b8_steps"].get(name, 0)
                mine = [r for r in hires["rows"] + hires["sweep"]
                        if r["kernel"] == name
                        and r["gp"] not in (2, 4, 8, 16)]
            entry = {
                "name": f"{name}{suffix}_wide", "route": "cuda",
                "source": source, "replaces": REPLACES[name],
                "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": None, "spans": sorted({r["span"] for r in mine}),
                "gp": sorted({r["gp"] for r in mine})}
            if bf16:
                entry["float32_ms"] = k["float32_ms"]
            entries.append(entry)
    return entries


# ---- 21. data parallel -------------------------------------------------------

DP_BATCH = 16        # global; 8 a rank on two ranks
DP_TIMED = 3         # timed steps per rank after the counted one
DP_TIMEOUT_S = 300   # a collective that waits longer fails the run
TORCHRUN_IMAGES = 4


def dp_step(torch, device, variables, images, masks, ddp=None, timed=0,
            synced=None):
    """One MedT-128 train step on the kernels (Adam-L2, cuDNN
    deterministic) from ``variables``: in a process group of more than one
    rank on this rank's rows of the global batch, DDP-wrapped; ``ddp``
    wraps the model in DDP whatever the group's size. ``synced`` runs the
    steps inside ``parallel.data_parallel_step`` whatever the group's size:
    ``"host"`` with this rank's rows (each statistic's joint count worked
    out on the host), ``"read"`` as a rank with no rows (each count packed
    beside the sums and read back from the collective). Its loss,
    gradients, running statistics, launch counts and the sites' routes;
    then ``timed`` more steps, timed."""
    from medt_tpu_torch import ops
    from medt_tpu_torch.models import build_model
    from medt_tpu_torch.ops import AxialAttention
    from medt_tpu_torch.parallel import (data_parallel_step, host_shard,
                                         shard_batch)
    from medt_tpu_torch.training import (TrainState, adam_l2,
                                         data_parallel, train_step)

    def copy(t):    # later steps update the model's tensors in place
        return t.detach().to("cpu", copy=True)

    torch.backends.cudnn.allow_tf32 = False   # off, as phase_device sets it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    model = build_model("MedT", img_size=IMG, use_fused=True, device=device)
    model.load_state_dict(variables, strict=True)
    model = ddp(model) if ddp else data_parallel(model)
    state = TrainState(model, adam_l2(model.parameters(), TRAIN_LR))
    rank, world = host_shard()
    batch = shard_batch({"image": images, "label": masks}, rank, world)
    def ctx():
        if synced is None:
            return contextlib.nullcontext()
        return data_parallel_step(
            len(batch["image"]) if synced == "host" else 0, len(images))

    ops.reset_launch_counts()
    with ctx():
        loss = train_step(state, batch, joint_rows=len(images))["loss"]
    torch.cuda.synchronize()
    module = state.module
    out = {"loss": float(loss), "launches": ops.launch_counts(),
           "rows": len(batch["image"]),
           "grads": {k: copy(p.grad) for k, p in module.named_parameters()
                     if p.requires_grad},
           "stats": {k: copy(b) for k, b in module.named_buffers()
                     if k.endswith(("running_mean", "running_var"))},
           "sites": [m.last_route for m in module.modules()
                     if isinstance(m, AxialAttention)]}
    if timed:
        t0 = time.perf_counter()
        with ctx():
            for _ in range(timed):
                train_step(state, batch, joint_rows=len(images))
        torch.cuda.synchronize()
        out["ms_per_step"] = (time.perf_counter() - t0) / timed * 1e3
    torch.backends.cudnn.deterministic = False
    return out


def _dp_gloo_rank(device, variables, batches):
    """A rank of the two-rank gloo world on one card: the step at each
    global batch of ``batches``."""
    import torch

    return [dp_step(torch, device, variables, images, masks, timed=DP_TIMED)
            for images, masks in batches]


def nccl_world_of_one(torch, variables, images, masks):
    """This process as an NCCL world of one: one step of a DDP-wrapped
    model, and the same step undistributed twice (whether two such steps
    share their bits says whether a bit comparison can speak of DDP).
    Then, timed beside the DDP step, the step with every train-mode
    statistic summed through NCCL (``parallel.sync``, 213 collectives a
    MedT-128 step): with the joint counts worked out on the host (each
    collective the sums alone), and with the counts packed beside the
    sums and read back (what a rank without rows does), each held against
    the undistributed step."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from medt_tpu_torch.parallel.launch import free_port

    plain = [dp_step(torch, "cuda:0", variables, images, masks)
             for _ in range(2)]
    t0 = time.perf_counter()
    dist.init_process_group("nccl", rank=0, world_size=1,
                            init_method=f"tcp://127.0.0.1:{free_port()}")
    try:
        def wrap(m):
            return DistributedDataParallel(m, device_ids=[0])

        ddp = dp_step(torch, "cuda:0", variables, images, masks, ddp=wrap,
                      timed=DP_TIMED)
        synced = {how: dp_step(torch, "cuda:0", variables, images, masks,
                               ddp=wrap, timed=DP_TIMED, synced=how)
                  for how in ("host", "read")}
    finally:
        dist.destroy_process_group()
    return {"seconds": time.perf_counter() - t0, "loss": ddp["loss"],
            "bits_equal_plain": same_bits(torch, ddp, plain[0]),
            "plain_bits_equal_each_other": same_bits(torch, *plain),
            "parity": _dp_held(torch, ddp, plain[0], plain),
            "ms_per_step": {"ddp": ddp["ms_per_step"],
                            "synced_counts_on_host":
                                synced["host"]["ms_per_step"],
                            "synced_counts_read":
                                synced["read"]["ms_per_step"]},
            "synced_parity": {how: _dp_held(torch, r, plain[0], plain)
                              for how, r in synced.items()}}


def same_bits(torch, a, b) -> bool:
    """Whether two steps' losses, gradients and statistics are bit-equal."""
    return a["loss"] == b["loss"] and all(
        torch.equal(a[w][k], b[w][k]) for w in ("grads", "stats")
        for k in b[w])


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def dp_launches(sites, batch, rows, training=True) -> dict:
    """The launches a rank's call makes at ``rows`` rows: each site's
    route at the rank's stripe count (the one-process call's stripes at
    ``batch`` rows scaled to ``rows``; none at 0 stripes), a route's
    forward, and in training its backward and, on the lanes family, the
    moments kernels."""
    from medt_tpu_torch.ops.axial_attention import fused_route

    out = {}
    for _, span, _, gp, stripes, _ in sites:
        local = stripes // batch * rows
        if not local:
            continue
        for k in route_kernels(fused_route(span, local, training, gp),
                               training):
            out[k] = out.get(k, 0) + 1
    return out


def _dp_held(torch, got, want, others):
    """``got`` against ``want`` under step_parity's rule, ``others`` the
    one-process step on perturbed inputs (the float32 spread)."""
    checks = [held(torch, "loss", torch.tensor(got["loss"]),
                   torch.tensor(want["loss"]),
                   [torch.tensor(o["loss"]) for o in others])]
    for what in ("grads", "stats"):
        checks += [held(torch, k, got[what][k], want[what][k],
                        [o[what][k] for o in others]) for k in want[what]]
    bad = [c for c in checks if not c["ok"]]
    return {"tensors": len(checks), "failed": bad[:5],
            "worst": max(checks, key=lambda c: c["err"] / c["tol"])}


def _torchrun_start(root):
    """Start ``cli.train`` under torchrun with one process, one epoch over
    TORCHRUN_IMAGES PNG pairs: ``(process, output dir, start time)``."""
    from medt_tpu_torch.data import make_png_dataset

    data = make_png_dataset(str(root / "torchrun"), TORCHRUN_IMAGES, IMG,
                            seed=4)
    out = root / "torchrun_out"
    run = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "medt_tpu_torch.cli.train",
         "--train_dataset", data, "--val_dataset", data, "--modelname",
         "MedT", "--imgsize", str(IMG), "--epochs", "1", "--save_freq", "1",
         "--direc", str(out), "--workers", "2"],
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return run, out, time.perf_counter()


def _torchrun_result(torch, run, out, t0):
    """Wait for the torchrun epoch: it exits 0 and its checkpoint loads
    strictly into a one-card model."""
    import numpy as np

    from medt_tpu_torch.models import build_model
    from medt_tpu_torch.training import restore_checkpoint

    try:
        _, err = run.communicate(timeout=600)
    finally:
        if run.poll() is None:
            run.kill()
            run.communicate()
    wall = time.perf_counter() - t0
    check(run.returncode == 0, f"torchrun exited {run.returncode}: "
                               f"{err[-2000:]}")
    ckpts = sorted(p.relative_to(out).as_posix()
                   for p in out.rglob("ckpt.pth"))
    check(ckpts == ["0/ckpt.pth", "final_model/ckpt.pth"],
          f"torchrun checkpoints {ckpts}")
    model = build_model("MedT", img_size=IMG, use_fused=True, device="cuda")
    step = restore_checkpoint(str(out / "0"), model)
    check(step == TORCHRUN_IMAGES, f"checkpoint at step {step}")
    log = json.loads((out / "train_log.jsonl").read_text())
    check(np.isfinite(log["loss"]), f"torchrun loss {log}")
    return {"wall_s": wall, "checkpoints": ckpts, "step": step, "log": log}


def phase_dp(torch):
    """Data parallel on one card: two gloo ranks on cuda:0 (MedT-128,
    Adam-L2, the kernels) at global batch 16 and 1 against the one-process
    step, with each rank's exact launch counts; this process as an NCCL
    world of one; one torchrun epoch; the engine's two replicas against
    one."""
    import shutil

    import numpy as np

    from medt_tpu_torch import ops
    from medt_tpu_torch.data import blob_batch
    from medt_tpu_torch.models import build_model
    from medt_tpu_torch.parallel import run_data_parallel
    from medt_tpu_torch.serving import InferenceEngine

    variables = build_model("MedT", img_size=IMG, seed=0,
                            device="cpu").state_dict()
    batches = [blob_batch(n, IMG, seed=0) for n in (DP_BATCH, 1)]
    root = REPO / "_smoke" / "dp"
    shutil.rmtree(root, ignore_errors=True)

    # -- started first, the torchrun epoch runs beside what follows ----------
    started = _torchrun_start(root)
    try:
        # -- the one-process steps and their float32 spread ----------------
        rng = np.random.default_rng(1)
        wants = []
        for images, masks in batches:
            x = images.astype(np.float32) / 255.0
            noisy = [(x * (1.0 + STEP_INPUT_NOISE * rng.standard_normal(
                x.shape))).astype(np.float32) for _ in range(2)]
            wants.append([dp_step(torch, "cuda", variables, im, masks)
                          for im in [images] + noisy])
        nccl = nccl_world_of_one(torch, variables, *batches[0])
        for name, parity in [("ddp", nccl["parity"]),
                             *nccl["synced_parity"].items()]:
            check(not parity["failed"],
                  f"NCCL world of one ({name}) vs one process: {parity}")

        # -- the two ranks, counted in their own processes -----------------
        t0 = time.perf_counter()
        ranks = run_data_parallel(
            _dp_gloo_rank, ["cuda:0", "cuda:0"], "gloo",
            args=(variables, batches), timeout_s=DP_TIMEOUT_S)
        world_s = time.perf_counter() - t0
        results = {}
        for col, (want, *others) in enumerate(wants):
            n = len(batches[col][0])
            per_rank = []
            for rank, res in enumerate(r[col] for r in ranks):
                expect = launches_of(want["launches"], dp_launches(
                    want["sites"], n, res["rows"]), 1)
                parity = _dp_held(torch, res, want, others)
                per_rank.append({"rank": rank, "rows": res["rows"],
                                 "launches": nonzero(res["launches"]),
                                 "launches_ok": res["launches"] == expect,
                                 "ms_per_step": res["ms_per_step"],
                                 "parity": parity})
                check(not parity["failed"], f"batch {n} rank {rank} vs "
                      f"one process: {parity['failed']}")
                check(res["launches"] == expect, f"batch {n} rank {rank} "
                      f"launches {res['launches']} != {expect}")
            check(ranks[0][col]["loss"] == ranks[1][col]["loss"],
                  f"batch {n}: the ranks' losses differ")
            results[f"batch{n}"] = {"loss_ranks": ranks[0][col]["loss"],
                                    "loss_one_process": want["loss"],
                                    "one_process_launches":
                                        nonzero(want["launches"]),
                                    "ranks": per_rank}

        # -- the engine: two replicas on cuda:0 against one ----------------
        served = list(batches[0][0])
        engines = [InferenceEngine("MedT", IMG, variables=variables,
                                   batch_size=DP_BATCH, **kw)
                   for kw in ({"device": "cuda"},
                              {"devices": ["cuda:0", "cuda:0"]})]
        one_masks = engines[0].predict_batch(served)
        ops.reset_launch_counts()
        two_masks = engines[1].predict_batch(served)
        torch.cuda.synchronize()
        engine_counts = ops.launch_counts()
        per_replica = dp_launches(wants[0][0]["sites"], DP_BATCH,
                                  DP_BATCH // 2, training=False)
        engine_expect = launches_of(engine_counts, {
            k: 2 * v for k, v in per_replica.items()}, 1)
        logits_err = float((engines[1].logits(served)
                            - engines[0].logits(served)).abs().max())
        same = all(np.array_equal(a, b)
                   for a, b in zip(one_masks, two_masks))
        del engines
        torchrun = _torchrun_result(torch, *started)
    finally:    # a failed phase stops what it started
        if started[0].poll() is None:
            started[0].kill()
            started[0].communicate()
    shutil.rmtree(root, ignore_errors=True)

    emit("dp", model="MedT", img=IMG, optimizer="adam_l2", lr=TRAIN_LR,
         gloo_world={"devices": ["cuda:0", "cuda:0"], "seconds": world_s,
                     **results},
         ms_per_step_note="two ranks share one card's SMs and copy every "
                          "collective through the host (gloo): the figure "
                          "is no speed",
         nccl_world_of_one=nccl,
         torchrun=torchrun,
         engine={"devices": ["cuda:0", "cuda:0"], "batch": DP_BATCH,
                 "launches": nonzero(engine_counts),
                 "per_replica": per_replica,
                 "masks_equal": same, "logits_max_abs_err": logits_err})
    check(same, "two-replica masks differ from one replica's")
    check(engine_counts == engine_expect,
          f"engine launches {engine_counts} != {engine_expect}")
    return results[f"batch{DP_BATCH}"]["ranks"][0]["launches"]


# ---- 22. tp: the model axis -------------------------------------------------

TP_WORLDS = ((1, 2), (2, 2))    # (dp, tp), gloo ranks on cuda:0
TP_TIMED = 1                    # timed steps per rank after the counted one


def tp_step(torch, device, variables, images, masks, mesh=None, timed=0,
            ckpt=None):
    """One MedT-128 train step on the kernels (Adam-L2, cuDNN
    deterministic) from ``variables`` on ``mesh`` (None: one process): the
    attention layers split over its model axis, DDP over its data axis,
    this data index's rows of the global batch. Its loss, gradients and
    running statistics in their one-card shapes (gathered over the model
    axis), launch counts, rows and the sites' routes (``g`` the local
    group count); with ``ckpt`` (a directory) then the checkpoint of the
    step, gathered (the coordinator writes ``<ckpt>/0``) and the
    parameters after the update; then ``timed`` more steps, timed."""
    from medt_tpu_torch import ops
    from medt_tpu_torch.models import build_model
    from medt_tpu_torch.ops import AxialAttention
    from medt_tpu_torch.parallel import gather_state_dict, shard_batch
    from medt_tpu_torch.training import (TrainState, adam_l2,
                                         data_parallel, save_checkpoint,
                                         train_step)

    def copy(tensors):   # later steps update the model's tensors in place
        return {k: t.detach().to("cpu", copy=True)
                for k, t in tensors.items()}

    torch.backends.cudnn.allow_tf32 = False   # off, as phase_device sets it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    model = build_model("MedT", img_size=IMG, use_fused=True, device=device)
    model.load_state_dict(variables, strict=True)
    model = data_parallel(model, mesh)
    state = TrainState(model, adam_l2(model.parameters(), TRAIN_LR),
                       mesh=mesh)
    batch = {"image": images, "label": masks}
    if mesh is not None:
        batch = shard_batch(batch, mesh.data_index, mesh.dp)
    ops.reset_launch_counts()
    loss = train_step(state, batch, joint_rows=len(images))["loss"]
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    module = state.module
    grads = {k: p.grad for k, p in module.named_parameters()
             if p.requires_grad}
    stats = {k: b for k, b in module.named_buffers()
             if k.endswith(("running_mean", "running_var"))}
    if mesh is not None:
        grads, stats = (gather_state_dict(module, t) for t in (grads, stats))
    out = {"loss": float(loss), "launches": launches,
           "rows": len(batch["image"]), "grads": copy(grads),
           "stats": copy(stats),
           "sites": [m.last_route for m in module.modules()
                     if isinstance(m, AxialAttention)]}
    if ckpt is not None:
        save_checkpoint(ckpt, 0, state.model, state.optimizer, step=1,
                        also_final=False)
        params = dict(module.named_parameters())
        full = gather_state_dict(module) if mesh is not None \
            else module.state_dict()
        out["params"] = copy({k: v for k, v in full.items() if k in params})
    if timed:
        t0 = time.perf_counter()
        for _ in range(timed):
            train_step(state, batch, joint_rows=len(images))
        torch.cuda.synchronize()
        out["ms_per_step"] = (time.perf_counter() - t0) / timed * 1e3
    torch.backends.cudnn.deterministic = False
    return out


def _tp_gloo_rank(device, dp, tp, variables, batches, ckpt, cls_case=None):
    """A rank of a ``(dp, tp)`` gloo world on one card: the step at each
    global batch of ``batches``, the first one checkpointed under
    ``ckpt``; then, given ``cls_case`` (``_cls_dp_rank``'s arguments), the
    ``cls_dp`` case in the same world (one spawn of ranks fewer)."""
    import torch

    from medt_tpu_torch.parallel import host_shard, join_mesh, make_mesh

    mesh = join_mesh(make_mesh(host_shard()[1], dp, tp))
    out = {"data_index": mesh.data_index, "model_index": mesh.model_index,
           "steps": [tp_step(torch, device, variables, images, masks, mesh,
                             timed=TP_TIMED, ckpt=ckpt if col == 0 else None)
                     for col, (images, masks) in enumerate(batches)]}
    if cls_case is not None:
        out["cls_dp"] = _cls_dp_rank(device, *cls_case)
    return out


def phase_tp(torch):
    """The model axis on one card: MedT-128 (Adam-L2, the kernels) on the
    (dp, tp) meshes (1, 2) and (2, 2), gloo ranks on cuda:0, at global
    batch 16 and 1: each rank's step (gradients and statistics gathered
    into their one-card shapes) against the one-process step, the model
    ranks' losses equal, each rank's exact launch counts (the one-process
    call's at its rows, every site at g/tp groups), and the checkpoint of
    the batch-16 step gathered into a one-card state dict that loads
    strictly into a one-card model and holds the ranks' weights. The
    two-rank world also runs the ``cls_dp`` case (``cls_dp_prepare``,
    ``cls_dp_check``)."""
    import shutil

    import numpy as np

    from medt_tpu_torch.data import blob_batch
    from medt_tpu_torch.models import build_model
    from medt_tpu_torch.parallel import run_data_parallel
    from medt_tpu_torch.training import restore_checkpoint

    variables = build_model("MedT", img_size=IMG, seed=0,
                            device="cpu").state_dict()
    batches = [blob_batch(n, IMG, seed=0) for n in (DP_BATCH, 1)]
    root = REPO / "_smoke" / "tp"
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(1)
    wants = []
    for images, masks in batches:
        x = images.astype(np.float32) / 255.0
        noisy = [(x * (1.0 + STEP_INPUT_NOISE * rng.standard_normal(
            x.shape))).astype(np.float32) for _ in range(2)]
        wants.append([tp_step(torch, "cuda", variables, im, masks)
                      for im in [images] + noisy])
    cls = cls_dp_prepare(torch)
    worlds = {}
    for dp, tp in TP_WORLDS:
        ckpt = root / f"dp{dp}_tp{tp}"
        t0 = time.perf_counter()
        ranks = run_data_parallel(
            _tp_gloo_rank, ["cuda:0"] * (dp * tp), "gloo",
            args=(dp, tp, variables, batches, str(ckpt),
                  cls["case"] if dp * tp == 2 else None),
            timeout_s=DP_TIMEOUT_S)
        world_s = time.perf_counter() - t0
        if dp * tp == 2:
            cls_dp = cls_dp_check(torch, cls, [r["cls_dp"] for r in ranks])
        results = {}
        for col, (want, *others) in enumerate(wants):
            n = len(batches[col][0])
            per_rank = []
            for rank, r in enumerate(ranks):
                res = r["steps"][col]
                expect = launches_of(want["launches"], dp_launches(
                    want["sites"], n, res["rows"]), 1)
                local_g = {site[2] for site in res["sites"]
                           if site is not None and res["rows"]}
                parity = _dp_held(torch, res, want, others)
                per_rank.append({"rank": rank, "data_index":
                                 r["data_index"], "model_index":
                                 r["model_index"], "rows": res["rows"],
                                 "launches": nonzero(res["launches"]),
                                 "launches_ok": res["launches"] == expect,
                                 "local_groups": sorted(local_g),
                                 "ms_per_step": res["ms_per_step"],
                                 "parity": parity})
                check(not parity["failed"], f"tp {dp}x{tp} batch {n} rank "
                      f"{rank} vs one process: {parity['failed']}")
                check(res["launches"] == expect, f"tp {dp}x{tp} batch {n} "
                      f"rank {rank} launches {res['launches']} != {expect}")
                check(local_g <= {GROUPS // tp}, f"tp {dp}x{tp} batch {n} "
                      f"rank {rank} ran sites at g {local_g}")
            for a in ranks:
                for b in ranks:
                    if a["data_index"] == b["data_index"]:
                        check(a["steps"][col]["loss"]
                              == b["steps"][col]["loss"],
                              f"tp {dp}x{tp} batch {n}: the model ranks' "
                              "losses differ")
            results[f"batch{n}"] = {"loss_ranks": ranks[0]["steps"][col]
                                    ["loss"], "loss_one_process":
                                    want["loss"], "ranks": per_rank}
        model = build_model("MedT", img_size=IMG, use_fused=True,
                            device="cuda")
        step = restore_checkpoint(str(ckpt / "0"), model)
        check(step == 1, f"tp {dp}x{tp} checkpoint at step {step}")
        weights = ranks[0]["steps"][0]["params"]
        same = all(torch.equal(p.detach().cpu(), weights[k])
                   for k, p in model.named_parameters())
        check(same, f"tp {dp}x{tp}: the checkpoint is not the ranks' "
                    "weights")
        worlds[f"dp{dp}_tp{tp}"] = {
            "devices": ["cuda:0"] * (dp * tp), "world_seconds": world_s,
            "checkpoint": {"step": step, "loads_one_card_strict": True,
                           "equals_ranks_weights": same},
            **results}
        del model
    shutil.rmtree(root, ignore_errors=True)
    emit("tp", model="MedT", img=IMG, optimizer="adam_l2", lr=TRAIN_LR,
         groups=GROUPS, worlds=worlds,
         one_process_launches={f"batch{len(b[0])}": nonzero(w[0]["launches"])
                               for b, w in zip(batches, wants)},
         ms_per_step_note="the ranks share one card's SMs and copy every "
                          "collective through the host (gloo): the figure "
                          "is no speed",
         cls_dp=cls_dp)
    return worlds


# ---- 22, the cls_dp case: cli.train_cls --distributed ----------------------

CLS_DP_BATCH = 8            # joint; 4 rows a rank on two ranks
CLS_DP_PER_CLASS = (7, 5)   # train, val images per class (2 classes)


def cls_dp_step(torch, device, variables, images, labels):
    """One ``cli.train_cls`` step (label smoothing, SGD as JAX's defaults)
    of axial26s at 224 px on the kernels from ``variables`` (cuDNN
    deterministic): in a process group of more than one rank DDP-wrapped,
    on this rank's rows of the joint batch. Its loss, accuracy,
    gradients, running statistics, launch counts, rows and the sites'
    routes."""
    from medt_tpu_torch import builders, ops
    from medt_tpu_torch.cli.train_cls import make_steps
    from medt_tpu_torch.ops import AxialAttention
    from medt_tpu_torch.parallel import host_shard, shard_batch
    from medt_tpu_torch.training import TrainState, data_parallel, sgd

    torch.backends.cudnn.allow_tf32 = False   # off, as phase_device sets it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    net = builders.build_model(_cls_args(), device=device, use_fused=True)
    net.load_state_dict(variables, strict=True)
    rank, world = host_shard()
    model = data_parallel(net) if world > 1 else net
    state = TrainState(model, sgd(model.parameters(), CLS_LR,
                                  momentum=CLS_MOMENTUM,
                                  weight_decay=CLS_WD))
    batch = shard_batch({"image": images, "label": labels}, rank, world)
    train_step, _ = make_steps(CLS_SMOOTHING)
    ops.reset_launch_counts()
    m = train_step(state, batch, joint_rows=len(images))
    torch.cuda.synchronize()
    out = {"loss": float(m["loss"]), "acc": float(m["acc"]),
           "launches": ops.launch_counts(), "rows": len(batch["image"]),
           "grads": {k: p.grad.detach().to("cpu", copy=True)
                     for k, p in net.named_parameters() if p.requires_grad},
           "stats": {k: b.detach().to("cpu", copy=True)
                     for k, b in net.named_buffers()
                     if k.endswith(("running_mean", "running_var"))},
           "sites": [m.last_route for m in net.modules()
                     if isinstance(m, AxialAttention)]}
    torch.backends.cudnn.deterministic = False
    return out


def _cls_dp_argv(root, work_dirs, batch, extra=()):
    return ["--model", "resnet18", "--num_classes", "2", "--imgsize",
            str(CLS_IMG), "--epochs", "1", "-b", str(batch),
            "--train_dataset", str(root / "train"), "--val_dataset",
            str(root / "val"), "--work_dirs", str(work_dirs), "--workers",
            "4", *extra]


def _cls_dp_rank(device, variables, images, labels, root):
    """A rank of the two-rank gloo world on one card: the axial26s step on
    its rows, then one ``cli.train_cls --distributed`` epoch (resnet18, 4
    rows a rank) and the steps it took."""
    import torch

    from medt_tpu_torch.cli import train_cls

    # a spawned rank starts with PyTorch's defaults: TF32 off, as
    # phase_device sets it for this process (cls_dp_step sets it too)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    step = cls_dp_step(torch, device, variables, images, labels)
    state = train_cls.main(_cls_dp_argv(Path(root), Path(root) / "dp2",
                                        CLS_DP_BATCH // 2,
                                        ["--distributed"]), device=device)
    return {"step": step, "cli_steps": state.step}


def cls_dp_prepare(torch):
    """The ``cls_dp`` case's inputs and one-process runs: a seeded axial26s
    and joint batch of 8, the one-process step on it and on two
    1e-6-perturbed copies (the float32 spread), an ImageFolder of 14 + 10
    PNGs and the one-process CLI epoch over it (resnet18 at batch 8);
    ``case`` holds ``_cls_dp_rank``'s arguments."""
    import shutil

    import numpy as np

    from medt_tpu_torch import builders
    from medt_tpu_torch.cli import train_cls
    from medt_tpu_torch.data.png import write_png

    variables = builders.build_model(_cls_args(), device="cpu",
                                     seed=0).state_dict()
    rng = np.random.default_rng(5)
    images = rng.standard_normal((CLS_DP_BATCH, CLS_IMG, CLS_IMG, 3)) \
        .astype(np.float32)
    labels = rng.integers(0, CLS_CLASSES, CLS_DP_BATCH).astype(np.int32)
    root = REPO / "_smoke" / "cls_dp"
    shutil.rmtree(root, ignore_errors=True)
    for split, n in zip(("train", "val"), CLS_DP_PER_CLASS):
        for c in ("class_a", "class_b"):
            (root / split / c).mkdir(parents=True)
            for i in range(n):
                write_png(str(root / split / c / f"{i:02d}.png"),
                          rng.integers(0, 256, (256, 256, 3),
                                       dtype=np.uint8))
    wants = [cls_dp_step(torch, "cuda", variables, im, labels)
             for im in [images] + [(images * (1.0 + STEP_INPUT_NOISE * rng
                                              .standard_normal(images.shape)))
                                   .astype(np.float32) for _ in range(2)]]
    one = train_cls.main(_cls_dp_argv(root, root / "dp1", CLS_DP_BATCH),
                         device="cuda")
    return {"root": root, "wants": wants, "one_steps": one.step,
            "case": (variables, images, labels, str(root))}


def cls_dp_check(torch, prepared, ranks) -> dict:
    """``cli.train_cls --distributed`` on one card, the two ranks'
    ``_cls_dp_rank`` results against ``cls_dp_prepare``'s one-process
    runs: the axial26s step at 224 px on the kernels, 4 rows a rank of a
    joint batch of 8, against the one-process step at 8 (loss, accuracy,
    gradients after DDP's average, running statistics) with each rank's
    exact launch counts; then the CLI epoch with resnet18 at 4 rows a
    rank: the one-process run's steps, one log whose val_acc is the
    one-process run's, one checkpoint that loads strictly into a one-card
    model. Its record."""
    import argparse
    import shutil

    from medt_tpu_torch import builders
    from medt_tpu_torch.training import restore_checkpoint

    root = prepared["root"]
    want, *others = prepared["wants"]
    per_rank = []
    for rank, r in enumerate(ranks):
        res = r["step"]
        expect = launches_of(want["launches"], dp_launches(
            want["sites"], CLS_DP_BATCH, res["rows"]), 1)
        parity = _dp_held(torch, res, want, others)
        per_rank.append({"rank": rank, "rows": res["rows"],
                         "loss": res["loss"], "acc": res["acc"],
                         "launches": nonzero(res["launches"]),
                         "launches_ok": res["launches"] == expect,
                         "parity": parity, "cli_steps": r["cli_steps"]})
        check(not parity["failed"], f"cls_dp rank {rank} vs one process: "
                                    f"{parity['failed']}")
        check(res["launches"] == expect, f"cls_dp rank {rank} launches "
                                         f"{res['launches']} != {expect}")
        check((res["loss"], res["acc"]) == (ranks[0]["step"]["loss"],
                                            ranks[0]["step"]["acc"]),
              "cls_dp: the ranks' losses differ")
        check(res["acc"] == want["acc"], f"cls_dp rank {rank} accuracy "
                                         f"{res['acc']} != {want['acc']}")
        check(r["cli_steps"] == prepared["one_steps"],
              f"cls_dp rank {rank} took {r['cli_steps']} steps, one process "
              f"{prepared['one_steps']}")

    def log(d):
        return [json.loads(line) for line in
                (root / d / "train_log.jsonl").read_text().splitlines()]

    (got,), (mine,) = log("dp2"), log("dp1")
    check(got["val_acc"] == mine["val_acc"],
          f"cls_dp val_acc {got['val_acc']} != one process {mine['val_acc']}")
    check(abs(got["loss"] - mine["loss"]) <= 1e-3 * abs(mine["loss"]),
          f"cls_dp loss {got['loss']} vs one process {mine['loss']}")
    net = builders.build_model(argparse.Namespace(
        model="resnet18", num_classes=2), device="cuda")
    step = restore_checkpoint(str(root / "dp2" / "final_model"), net)
    check(step == prepared["one_steps"], f"cls_dp checkpoint at step {step}")
    shutil.rmtree(root, ignore_errors=True)
    return {"model": "axial26s", "img": CLS_IMG, "batch": CLS_DP_BATCH,
            "devices": ["cuda:0", "cuda:0"],
            "loss_one_process": want["loss"], "acc_one_process": want["acc"],
            "one_process_launches": nonzero(want["launches"]),
            "ranks": per_rank,
            "train_cls": {"model": "resnet18", "images": {
                "train": 2 * CLS_DP_PER_CLASS[0],
                "val": 2 * CLS_DP_PER_CLASS[1]},
                "batch_per_rank": CLS_DP_BATCH // 2,
                "steps": prepared["one_steps"], "log_distributed": got,
                "log_one_process": mine, "checkpoint_step": step}}


def summary(rows, counts):
    """One entry per kernel; times per call of its main path: one MedT-128
    batch-16 forward (serving) for the lanes and flash forward cores, one
    MedT-128 train step for their backward and the moments kernels, one
    batch-1 forward (``cli.test``) for the eval kernel, one medt_512
    batch-4 forward (``serve512``) for the flash2 forward, one medt_512
    train step for its backward and one MedT-128 batch-1 train step
    (``train1``) for the stripe kernels. ``counts`` holds each phase's
    launch counts by phase name. A bf16 entry point's main path is the
    ``bf16`` phase (a served MedT-128 batch-16 forward, a train step); the
    flash2 ones, which no bf16 path of this card's smoke runs (0
    launches), give their one medt_512 geometry's time per launch."""
    kernels = []
    for name in KERNELS + [f"{k}_bf16" for k in BF16_KERNELS]:
        bf16 = name.endswith("_bf16")
        base = name[:-len("_bf16")] if bf16 else name
        flash2 = name.startswith("flash2")
        stripe = name.startswith("stripe")
        path = "medt512" if flash2 else "medt128b1" if stripe else "medt128"
        mine = [r for r in rows if r["kernel"] == name and r["path"] == path]
        used = [r for r in mine if r["launches_per_call"]]
        n = [r["launches_per_call"] for r in used]
        if not used:    # off every path this smoke runs: per launch
            used, n = mine, [1] * len(mine)
        b = sum(r["bytes"] / HBM_BYTES_PER_S * k for r, k in zip(used, n))
        o = sum(r["ops"] / F32_FLOPS_PER_S * k for r, k in zip(used, n))
        forward = base.endswith("fwd") and not name.startswith("moment")
        if bf16:
            phase = "bf16"
        elif name == "axial_eval_fwd":
            phase = "predict"
        elif stripe:
            phase = "train1"
        elif flash2:
            phase = "serve512" if forward else "train512"
        else:
            phase = "serve" if forward else "train"
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[base],
            "replaces": REPLACES[base],
            "launches": counts[phase].get(name, 0),
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["kernel"] == name),
            "ms": sum(r["ms"] * k for r, k in zip(used, n)),
            "plain_ms": sum(r["plain_ms"] * k for r, k in zip(used, n)),
            "bound_ms": sum(r["bound_ms"] * k for r, k in zip(used, n)),
            "bound_by": "bytes" if b >= o else "operations",
            "library_ms": None,
        })
        if bf16:
            kernels[-1]["float32_ms"] = sum(r["float32_ms"] * k
                                            for r, k in zip(used, n))
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
                          ("zoo", phase_zoo), ("bf16", phase_bf16),
                          ("remat", phase_remat),
                          ("bf16_cli", phase_bf16_cli), ("cls", phase_cls),
                          ("cls_wide", phase_cls_wide),
                          ("cls_hires", phase_cls_hires), ("dp", phase_dp),
                          ("tp", phase_tp)):
            counts[phase] = fn(torch)
    except Exception as e:  # report the phase, then fail without "ok"
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}")
        return 1
    line = summary(rows, counts)
    line["kernels"] += wide_summary(counts["cls_wide"])
    line["kernels"] += hires_summary(counts["cls_hires"])
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
