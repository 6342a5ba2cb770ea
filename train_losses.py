#!/usr/bin/env python3
"""Replay the loss steps of ``chip_smoke.py``'s train phases on one card.

    python3 train_losses.py [--model medt_512|MedT|axial50m-384] [--runs 1]
                            [--plain] [--lr LR] [--parity-at 17 26 ...]
                            [--inputs 1] [--root DIR]

Trains as the smoke's ``train512`` phase does (``--model medt_512``, the
default: batch 4 at 512 px, 2 warm-up + 5 timed + 20 loss steps) or its
``train`` phase (``--model MedT``: batch 16 at 128 px, 3 + 10 + 20 steps):
from the seeded init (``build_model(seed=0)``) on ``blob_batch(batch, img,
seed=0)`` with Adam-L2 at the smoke's lr 1e-3 (or ``--lr``; 0 gives a run
that cannot learn), TF32 off, on the kernels or on plain cores
(``--plain``), ``--runs`` times from the same init. For each run it reports
the losses and both loss checks on them: the smoke's (``loss_fell``: the
median of the 20 loss steps below ``LOSS_FALL`` times the step-0 loss) and
the one it replaced (the mean of the last 5 of the 20 below the mean of
their first 5), with the count of runs that pass each. Before each step of
``--parity-at`` (first run only) it runs the smoke's own ``step_parity``
from the run's current weights: one step on the kernels against one on
plain cores on the smoke's batch-1 parity input, the loss, every gradient
and the running statistics held by ``held``.

``--model axial50m-384`` replays the ``cls_hires`` phase's counted steps
instead: axial50m at 384 px from the smoke's seeded weights, SGD at
``HIRES_LEARN_LR`` (or ``--lr``) on its batch of 8, a step and then
``CLS_STEPS`` steps queued without a wait between them, as the smoke runs
them; ``--inputs K`` runs also on K - 1 copies of the batch perturbed by
``STEP_INPUT_NOISE`` (relative, as the step parities' spread runs are),
each ``--runs`` times, and counts the runs that pass the smoke's check
(the median of the losses below ``CLS_LOSS_FALL`` times the step-0 loss)
and the mean of that ratio, which the smoke holds over its runs; each run
also reports, per step, the largest batch variance of the similarity
logits over the attention sites. With ``--accuracy`` the first run keeps
the inputs of every attention site at steps 0 and 2 and holds the
moments (mean and variance) and the attention core (sv, sve) on the
kernels and on plain float32 cores against plain float64, per site and at
the worst. ``--root`` runs the ``chip_smoke.py`` and package of another
tree (a parent unpacked by ``git archive``). Prints one JSON object. Needs
a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
LOSS_STEPS = 20   # the counted loss steps at the end of each phase


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("medt_512", "MedT",
                                            "axial50m-384"),
                        default="medt_512")
    parser.add_argument("--runs", type=int, default=1)
    parser.add_argument("--plain", action="store_true",
                        help="plain PyTorch cores instead of the kernels")
    parser.add_argument("--lr", type=float, default=None,
                        help="the learning rate (default: the smoke's)")
    parser.add_argument("--parity-at", type=int, nargs="*", default=[],
                        help="steps before which to hold kernels vs plain")
    parser.add_argument("--inputs", type=int, default=1,
                        help="axial50m-384: the batch and K - 1 perturbed "
                             "copies")
    parser.add_argument("--accuracy", action="store_true",
                        help="axial50m-384: hold each site's kernels "
                             "against float64 on the first run's inputs")
    parser.add_argument("--root", default=str(HERE),
                        help="the tree whose smoke and package to run")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("train_losses: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke as smoke
    if args.model == "axial50m-384":
        return hires(torch, smoke, args)
    from medt_tpu_torch.data import blob_batch
    from medt_tpu_torch.models import build_model
    from medt_tpu_torch.training import TrainState, adam_l2, train_step

    if args.model == "medt_512":   # the train512 phase
        img, batch_size, steps = smoke.IMG512, smoke.BATCH512, 27
    else:                          # the train phase
        img, batch_size, steps = smoke.IMG, smoke.BATCH, 33
    lr = smoke.TRAIN_LR if args.lr is None else args.lr
    smoke.set_tf32(torch, False)
    variables = build_model(args.model, img_size=img, seed=0,
                            device="cpu").state_dict()
    images, masks = blob_batch(batch_size, img, seed=0)
    batch = {"image": images, "label": masks}
    one_image, one_mask = blob_batch(1, img, seed=1)
    runs, parity = [], []
    for run in range(args.runs):
        model = build_model(args.model, img_size=img, use_fused=True,
                            plain_cores=args.plain, device="cuda")
        model.load_state_dict(variables, strict=True)
        state = TrainState(model, adam_l2(model.parameters(), lr))
        losses = []
        for step in range(steps):
            if run == 0 and step in args.parity_at:
                weights = {k: v.detach().clone()
                           for k, v in model.state_dict().items()}
                loss_k, loss_p, checks = smoke.step_parity(
                    torch, args.model, img, one_image, one_mask, weights)
                worst = max(checks, key=lambda c: c["err"] / c["tol"])
                parity.append({
                    "step": step, "loss_kernels": loss_k, "loss_plain": loss_p,
                    "tensors": len(checks),
                    "failed": [c["name"] for c in checks if not c["ok"]],
                    "worst": {**worst, "err_over_tol":
                              worst["err"] / worst["tol"]}})
            losses.append(float(train_step(state, batch)["loss"]))
        counted = losses[-LOSS_STEPS:]
        runs.append({
            "losses": losses,
            "median_over_loss0": statistics.median(counted) / losses[0],
            "fell": smoke.loss_fell(losses[0], counted),
            "old_check": sum(counted[-5:]) < sum(counted[:5])})
        del state, model
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "model": args.model, "lr": lr, "plain": args.plain,
                      "loss_fall": smoke.LOSS_FALL,
                      "passed": sum(r["fell"] for r in runs),
                      "passed_old_check": sum(r["old_check"] for r in runs),
                      "runs": runs, "parity": parity}), flush=True)
    return 0


def hires(torch, smoke, args) -> int:
    """The cls_hires phase's counted steps, ``args.runs`` times on each of
    ``args.inputs`` inputs."""
    import numpy as np
    from medt_tpu_torch.cli.train_cls import make_steps
    from medt_tpu_torch.ops import axial_attention as aa

    smoke.set_tf32(torch, False)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((8, smoke.HIRES_IMG, smoke.HIRES_IMG, 3)
                                 ).astype(np.float32)
    labels = rng.integers(0, smoke.CLS_CLASSES, 8).astype(np.int32)
    noise = np.random.default_rng(1)
    inputs = [images] + [(images * (1.0 + smoke.STEP_INPUT_NOISE * noise
                                    .standard_normal(images.shape)))
                         .astype(np.float32) for _ in range(args.inputs - 1)]
    variables = smoke._hires_variables(torch, "axial50m")
    train_step, _ = make_steps(smoke.CLS_SMOOTHING)
    lr = smoke.HIRES_LEARN_LR if args.lr is None else args.lr
    moments, core = aa.logit_moments_lanes_fused, aa.lanes_family_core
    seen, kept = [], []

    def moments_seen(*a, plain=False):
        if len(a) > 3:
            a, plain = a[:3], a[3]
        out = moments(*a, plain=plain)
        seen.append(out[1].max())
        if keep:
            kept.append(("moments", step, [t.detach().clone() for t in a]))
        return out

    def core_seen(*a, plain=False):
        if keep:
            kept.append(("core", step, [t.detach().clone() for t in a]))
        return core(*a, plain=plain)

    aa.logit_moments_lanes_fused, aa.lanes_family_core = moments_seen, \
        core_seen
    runs = []
    for i, image in enumerate(inputs):
        batch = {"image": image, "label": labels}
        for _ in range(args.runs):
            state = smoke._cls_state(torch, variables, plain=args.plain,
                                     lr=lr, model="axial50m",
                                     img=smoke.HIRES_IMG)
            losses, var_max = [], []
            for step in range(smoke.CLS_STEPS + 1):
                keep = args.accuracy and not runs and step in (0, 2)
                seen.clear()
                losses.append(train_step(state, batch)["loss"])
                var_max.append(torch.stack(seen).max())
            loss0, *losses = torch.stack(losses).tolist()
            runs.append({
                "input": i, "loss0": loss0, "losses": losses,
                "median_over_loss0": statistics.median(losses) / loss0,
                "fell": statistics.median(losses)
                < smoke.CLS_LOSS_FALL * loss0,
                "logit_var_max": torch.stack(var_max).tolist()})
            del state
            torch.cuda.empty_cache()
    aa.logit_moments_lanes_fused, aa.lanes_family_core = moments, core
    ratios = [r["median_over_loss0"] for r in runs]
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "model": args.model, "root": args.root,
                      "lr": lr, "plain": args.plain,
                      "loss_fall": smoke.CLS_LOSS_FALL,
                      "passed": sum(r["fell"] for r in runs),
                      "mean_ratio": statistics.mean(ratios),
                      "runs": runs,
                      "accuracy": accuracy(torch, kept)}), flush=True)
    return 0


def accuracy(torch, kept):
    """Each kept site's moments and core on the kernels and on plain
    float32 cores against plain float64: the moments' mean error over the
    float64 standard deviation and variance error over the float64
    variance (each + BN eps 1e-5), the core's max |error| over max |sv|
    and max |sve|; per site and the worst per (kind, step, path)."""
    from medt_tpu_torch.ops import axial_attention as aa
    from medt_tpu_torch.ops import moments as mom

    sites, worst = [], {}
    with torch.no_grad():
        for kind, step, args in kept:
            wide = [t.double() for t in args]
            rec = {"kind": kind, "step": step, "shape": list(args[0].shape)}
            if kind == "moments":
                m64, v64, _ = mom.logit_moments_lanes_fused(*wide, True)
                den = v64 + 1e-5
                rec["var"] = float(v64.max())
                for path, plain in (("kernels", False), ("plain32", True)):
                    m, v, _ = mom.logit_moments_lanes_fused(*args, plain)
                    rec[path] = [
                        float(((m - m64).abs() / den.sqrt()).max()),
                        float(((v - v64).abs() / den).max())]
            else:
                want = aa.lanes_family_core(*wide, plain=True)
                for path, plain in (("kernels", False), ("plain32", True)):
                    got = aa.lanes_family_core(*args, plain=plain)
                    rec[path] = [float((g - w).abs().max() / w.abs().max())
                                 for g, w in zip(got[:2], want[:2])]
            sites.append(rec)
            for path in ("kernels", "plain32"):
                key = f"{kind}_step{step}_{path}"
                worst[key] = [max(a, b) for a, b in
                              zip(worst.get(key, [0.0, 0.0]), rec[path])]
    return {"worst": worst, "sites": sites} if sites else None


if __name__ == "__main__":
    sys.exit(main())
