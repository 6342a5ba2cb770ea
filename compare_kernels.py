#!/usr/bin/env python3
"""Time the port's flash2 kernels in a given tree, on one card.

    python3 compare_kernels.py [--root DIR] [--out FILE]

Runs the ``device``, ``build`` and ``kernels`` phases of ``DIR/chip_smoke.py``
(default: this checkout) against ``DIR``'s own ``medt_tpu_torch`` package,
for the flash2 geometries: each kernel held against its plain version (the
smoke's tolerances, the same bits twice), its CUDA-event time, plain time
and bound. Then, for each backward
geometry, a ``torch.profiler`` window over a few calls splits its device
time by CUDA kernel (row pass, column pass, reductions). Prints and writes
one JSON object with the rows, the per-call sums over the main path
(``launches_per_call`` times ms), the split and the card.

To compare a change with its parent on the same card, unpack the parent
into a directory that ``.gitignore`` lists and run both in one command, in
turns::

    git archive HEAD | tar -x -C _archive/parent    # before the change
    python3 compare_kernels.py --root _archive/parent --out a.json
    python3 compare_kernels.py --out b.json

Needs a card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
FAMILY = "flash2"   # kernel-name prefix of the geometries to run


def split_by_kernel(torch, fn, calls: int = 5) -> dict:
    """Device ms per call of ``fn``, by CUDA kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = float(getattr(e, "device_time_total",
                           getattr(e, "cuda_time_total", 0.0)))
        if us > 0:
            out[e.key[:80]] = us / calls / 1e3
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(HERE),
                        help="tree whose chip_smoke.py and package to run")
    parser.add_argument("--out", default=None, help="JSON file to write")
    args = parser.parse_args(argv)
    root = Path(args.root).resolve()
    if not (root / "chip_smoke.py").is_file():
        print(f"compare_kernels: no chip_smoke.py in {root}", file=sys.stderr)
        return 2
    # the tree's own smoke script and package, not this checkout's
    sys.path = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke

    smoke.GEOMETRIES = [g for g in smoke.GEOMETRIES
                        if g[0].startswith(FAMILY)]
    smi, name = smoke.phase_device(torch)
    smoke.phase_build()
    try:
        rows = smoke.phase_kernels(torch)
    except smoke.PhaseFailed as e:
        print(f"compare_kernels: {e}", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(1)
    split = []
    for r in rows:
        if not r["kernel"].endswith("_bwd"):
            continue
        fn, _ = smoke.kernel_calls(torch, gen, r["kernel"], r["gp"],
                                   r["span"], r["S"], r["has_pos"])
        split.append({"kernel": r["kernel"], "span": r["span"], "gp": r["gp"],
                      "S": r["S"], "has_pos": r["has_pos"],
                      "launches_per_call": r["launches_per_call"],
                      "ms_by_kernel": split_by_kernel(torch, fn)})
        del fn
        torch.cuda.empty_cache()
    per_call = {}
    for r in rows:
        k = r["launches_per_call"]
        if not k:
            continue
        acc = per_call.setdefault(r["kernel"], {"ms": 0.0, "plain_ms": 0.0,
                                                "bound_ms": 0.0})
        for key in acc:
            acc[key] += r[key] * k
    for acc in per_call.values():
        acc["x_bound"] = acc["ms"] / acc["bound_ms"]
    out = {"root": str(root), "card": smi, "torch_name": name,
           "per_main_path_call": per_call, "rows": rows, "bwd_split": split}
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(json.dumps({"card": smi, "root": str(root),
                      "per_main_path_call": per_call}), flush=True)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
