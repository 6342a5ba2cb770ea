#!/usr/bin/env python3
"""Walls of three training and serving paths, a tree against this one, on one card.

    python3 compare_walls.py --root DIR [--pairs N] [--out FILE]

Runs N pairs of processes, alternating which tree goes first (DIR then this
checkout, then this checkout then DIR, ...). Each process imports its own
tree's ``medt_tpu_torch`` and times, with a host clock around work that ends
in ``torch.cuda.synchronize()`` (profiler off, TF32 off, seeded weights):

* ``medt128_b1_step_ms``: the MedT-128 train step at batch 1, what
  ``cli.train`` runs by default (10 steps after 3 warm-up steps);
* ``medt512_b4_step_ms``: the medt_512 train step at batch 4 (5 after 3);
* ``medt512_served_b4_ms``: ``InferenceEngine("medt_512", 512,
  batch_size=4).predict_batch`` of 4 images (10 after 3).

Prints and writes one JSON object: every run, and per tree and metric the
median, the quartiles and, for this checkout, the pairs it won. Compare two
versions only inside one call: walls vary between machines. Needs a card;
exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
METRICS = ("medt128_b1_step_ms", "medt512_b4_step_ms", "medt512_served_b4_ms")


def measure(root: Path) -> dict:
    """One process's walls for the tree at ``root``."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from medt_tpu_torch.data import blob_batch
    from medt_tpu_torch.models import build_model
    from medt_tpu_torch.serving import InferenceEngine
    from medt_tpu_torch.training import TrainState, adam_l2, train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def steps(name, img, batch, n):
        model = build_model(name, img_size=img, use_fused=True, seed=0,
                            device="cuda")
        state = TrainState(model, adam_l2(model.parameters(), 1e-3))
        images, masks = blob_batch(batch, img, seed=0)
        b = {"image": images, "label": masks}
        for _ in range(3):
            train_step(state, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            train_step(state, b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    out = {"root": str(root),
           "medt128_b1_step_ms": steps("MedT", 128, 1, 10),
           "medt512_b4_step_ms": steps("medt_512", 512, 4, 5)}
    sd = build_model("medt_512", seed=0, device="cpu").state_dict()
    engine = InferenceEngine("medt_512", 512, variables=sd, batch_size=4)
    engine.warmup()
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, size=(512, 512, 3), dtype=np.uint8)
              for _ in range(4)]
    for _ in range(3):
        engine.predict_batch(images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        engine.predict_batch(images)   # ends in a device-to-host copy
    out["medt512_served_b4_ms"] = (time.perf_counter() - t0) / 10 * 1e3
    return out


def quartiles(xs):
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True,
                        help="the other tree (e.g. the parent, unpacked)")
    parser.add_argument("--pairs", type=int, default=4)
    parser.add_argument("--out", default=None, help="JSON file to write")
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        print(json.dumps(measure(Path(args.child))), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("compare_walls: no CUDA device", file=sys.stderr)
        return 2
    other = Path(args.root).resolve()
    trees = {"other": other, "this": HERE}
    runs = []
    for i in range(args.pairs):
        order = ("other", "this") if i % 2 == 0 else ("this", "other")
        pair = {}
        for tag in order:
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()),
                 "--root", str(other), "--child", str(trees[tag])],
                capture_output=True, text=True, timeout=1200)
            if proc.returncode != 0:
                print(proc.stderr[-2000:], file=sys.stderr)
                return 1
            pair[tag] = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(pair)
    summary = {}
    for m in METRICS:
        summary[m] = {tag: quartiles([p[tag][m] for p in runs])
                      for tag in trees}
        summary[m]["this_won"] = sum(p["this"][m] < p["other"][m]
                                     for p in runs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"card": smi or torch.cuda.get_device_name(0), "other": str(other),
           "pairs": args.pairs, "summary": summary, "runs": runs}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out))
    print(json.dumps({"card": out["card"], "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
