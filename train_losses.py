#!/usr/bin/env python3
"""Replay ``chip_smoke.py``'s train512 loss steps on one card, run by run.

    python3 train_losses.py [--runs 1] [--plain] [--parity-at 17 26 ...]

Trains medt_512 at batch 4 as the smoke's ``train512`` phase does: from the
seeded init (``build_model(seed=0)``) on ``blob_batch(4, 512, seed=0)``
with Adam-L2 at lr 1e-3, TF32 off, 27 steps (2 warm-up, 5 timed, 20 loss
steps), on the kernels or on plain cores (``--plain``), ``--runs`` times
from the same init. For each run it reports the losses and whether they
fell as that phase requires (the mean of the last 5 of the last 20 steps
below the mean of their first 5). Before each step of ``--parity-at``
(first run only) it runs the smoke's own ``step_parity`` from the run's
current weights: one step on the kernels against one on plain cores on the
smoke's batch-1 parity input, the loss, every gradient and the running
statistics held by ``held``. Prints one JSON object. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
STEPS = 27   # the train512 phase: 2 warm-up + 5 timed + 20 loss steps


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=1)
    parser.add_argument("--plain", action="store_true",
                        help="plain PyTorch cores instead of the kernels")
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

    smoke.set_tf32(torch, False)
    variables = build_model(smoke.M512, seed=0, device="cpu").state_dict()
    images, masks = blob_batch(smoke.BATCH512, smoke.IMG512, seed=0)
    batch = {"image": images, "label": masks}
    one_image, one_mask = blob_batch(1, smoke.IMG512, seed=1)
    runs, parity = [], []
    for run in range(args.runs):
        model = build_model(smoke.M512, use_fused=True,
                            plain_cores=args.plain, device="cuda")
        model.load_state_dict(variables, strict=True)
        state = TrainState(model, adam_l2(model.parameters(), smoke.TRAIN_LR))
        losses = []
        for step in range(STEPS):
            if run == 0 and step in args.parity_at:
                weights = {k: v.detach().clone()
                           for k, v in model.state_dict().items()}
                loss_k, loss_p, checks = smoke.step_parity(
                    torch, smoke.M512, smoke.IMG512, one_image, one_mask,
                    weights)
                worst = max(checks, key=lambda c: c["err"] / c["tol"])
                parity.append({
                    "step": step, "loss_kernels": loss_k, "loss_plain": loss_p,
                    "tensors": len(checks),
                    "failed": [c["name"] for c in checks if not c["ok"]],
                    "worst": {**worst, "err_over_tol":
                              worst["err"] / worst["tol"]}})
            losses.append(float(train_step(state, batch)["loss"]))
        last = losses[-20:]
        runs.append({"losses": losses,
                     "falls": sum(last[-5:]) < sum(last[:5])})
        del state, model
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "plain": args.plain, "runs": runs,
                      "parity": parity}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
