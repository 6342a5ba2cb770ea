#!/usr/bin/env python3
"""Replay the loss steps of ``chip_smoke.py``'s train phases on one card.

    python3 train_losses.py [--model medt_512|MedT] [--runs 1] [--plain]
                            [--lr LR] [--parity-at 17 26 ...]

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
and the running statistics held by ``held``. Prints one JSON object. Needs
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
    parser.add_argument("--model", choices=("medt_512", "MedT"),
                        default="medt_512")
    parser.add_argument("--runs", type=int, default=1)
    parser.add_argument("--plain", action="store_true",
                        help="plain PyTorch cores instead of the kernels")
    parser.add_argument("--lr", type=float, default=None,
                        help="Adam's learning rate (default: the smoke's)")
    parser.add_argument("--parity-at", type=int, nargs="*", default=[],
                        help="steps before which to hold kernels vs plain")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("train_losses: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as smoke
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


if __name__ == "__main__":
    sys.exit(main())
