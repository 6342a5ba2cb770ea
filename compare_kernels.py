#!/usr/bin/env python3
"""Time one or more families of the port's kernels in a given tree, on one card.

    python3 compare_kernels.py [--root DIR] [--sites DIR2]
                               [--family lanes flash flash2 moments
                                         stripe eval wide long]
                               [--out FILE]

Runs the ``device``, ``build`` and ``kernels`` phases of ``DIR/chip_smoke.py``
(default: this checkout) against ``DIR``'s own ``medt_tpu_torch`` package,
for the geometries (those of ``DIR2/chip_smoke.py`` where given) of the
kernel families named by ``--family`` (default flash2): each kernel held against its plain version (the smoke's
tolerances, the same bits twice), its CUDA-event time over back-to-back
wrapper calls, plain time and bound. With ``flash`` it also runs the flash2
forward and backward (which compute the flash contract at any span up to
256) at every flash forward and backward geometry, as the baseline a flash
design has to beat (rows with ``path`` ``"<path>:flash2"``); ``moments``
runs the moments forward and backward, ``stripe`` the stripe train core's
forward and backward, ``eval`` the batch-1 eval kernel; the lanes,
flash, flash2 and moments families also run their bf16 entry points
(kernels ``<name>_bf16``, the smoke's bf16 rows). ``wide`` runs every
kernel at the wide group planes (gp 12-128) at the geometries of the
smoke's ``cls_wide`` phase (``CLS_WIDE_ROUTES``): axial50m's batch-8 step
and forward and axial50l's batch-1 forward and step (rows 1-4, 7-9, and
row 11's wide route, the flash kernels at axial50l's batch-1 train sites),
one row per site and path (``path`` ``"axial50m_b8_step"`` and so on), and
the bf16 entry points at axial50m's batch-8 step geometries; and the wide
forwards (rows 1, 3, 7, 9) at the ``cls_hires`` phase's calls (axial50m
and axial50l at 384 px, ``CLS_HIRES_ROUTES``; path
``"axial50m384_b8_step"`` and so on): the attention forwards at spans 48,
24 and 12 and the moments forward at every site, the span-96 ones
included. ``long`` runs the long-span wide kernels (rows 5 and 6, the
flash2 forward and backward at a wide gp) at the span-96 sites of the
smoke's ``cls_hires`` calls (``CLS_HIRES_ROUTES`` through
``long_routes``): axial50m-384's batch-8 step and forward and
axial50l-384's batch-1 step (rows 10-11's long-span sites; path
``axial50m384_b8_step`` and so on), beside them the moments backward at
those sites (row 8 at span 96) and the flash forward and backward at
axial50l's batch-1 step at 224 px, span 56 (rows 10-11's wide route; path
``axial50l_b1_step``), and the flash2 pair at one ``HIRES_SWEEP`` geometry
per register bucket (span 128, gp 12, 32, 64, 128, 32 stripes; path
``sweep``). The per-call sums over each path are each wide kernel's time
over that call. Then, for each
geometry, on inputs seeded by the geometry alone, a ``torch.profiler``
window over a few calls splits its device time by CUDA kernel (row pass,
column pass, reductions) and a host clock times the
wrapper's enqueue alone (``host_ms``: checks, allocations, the ``ctypes``
call and the launches, the card left to run), and ``out_sha256`` hashes its
outputs on those seeded inputs (two trees give the same bits where the
hashes agree), and ``peak_alloc_mb`` is what one call allocates at its
peak (outputs and scratch). Writes one JSON object with the rows, the
per-call sums over each main path (``launches_per_call`` times ms, per kernel and path),
the split and the card; prints the card, the per-call sums and, per site,
the events, device and host ms with the output hash.

To compare a change with its parent on the same card, unpack the parent
into a directory that ``.gitignore`` lists and run both in one command, in
turns::

    git archive HEAD | tar -x -C _archive/parent    # before the change
    python3 compare_kernels.py --root _archive/parent --sites . --out a.json
    python3 compare_kernels.py --out b.json

(``--sites .`` times the parent at this checkout's geometries, sites that
the parent's own list may lack included.)

Needs a card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import re
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FAMILIES = ("lanes", "flash", "flash2", "moments", "stripe", "eval",
            "wide", "long")


def family(kernel: str) -> str:
    """``lanes_attn_bwd`` -> ``lanes``, ``flash2_lanes_fwd`` -> ``flash2``,
    ``moment_sums_bwd`` -> ``moments``, ``stripe_attn_bwd`` -> ``stripe``,
    ``axial_eval_fwd`` -> ``eval``."""
    first = kernel.split("_")[0]
    return {"moment": "moments", "axial": "eval"}.get(first, first)


def split_by_kernel(torch, fn, calls: int = 5) -> dict:
    """Device ms per call of ``fn``, by CUDA kernel name (namespaces and
    argument lists dropped, template arguments kept)."""
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
            key = re.sub(r"\(anonymous namespace\)::|\w+::", "", e.key)
            key = re.sub(r"\((?!anonymous).*\)$", "", key)[:120]
            out[key] = out.get(key, 0.0) + us / calls / 1e3
    return out


def host_ms(torch, fn, calls: int = 20) -> float:
    """Host ms per call of ``fn`` enqueued back to back, the card left to
    run: what the wrapper costs the host (fewer calls than the launch
    queue holds, so the host never waits for the card)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def peak_alloc_mb(torch, fn) -> float:
    """MiB that one call of ``fn`` allocates at its peak over what was
    allocated before it: the wrapper's outputs and scratch."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def out_sha256(torch, outputs) -> str:
    """sha256 of a kernel call's outputs' bytes, in order (as bytes, which
    numpy takes in every dtype, bf16 too)."""
    h = hashlib.sha256()
    for t in outputs:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def row_seed(row) -> int:
    """The seed of a row's inputs: a function of its kernel and geometry
    alone, so that two runs (two trees, two family lists) hash the same
    inputs."""
    key = "{kernel}:{span}:{gp}:{S}:{has_pos}".format(**row)
    return int(hashlib.sha256(key.encode()).hexdigest()[:8], 16)


def flash2_baseline(geometries) -> list:
    """The flash2 forward and backward at every flash forward and backward
    geometry."""
    return [(g[0].replace("flash_", "flash2_"), *g[1:6], f"{g[6]}:flash2")
            for g in geometries
            if g[0] in ("flash_lanes_fwd", "flash_lanes_bwd")]


# the wide forwards (csrc/wide_attn.cuh's body and the wide moments
# forward) that ``wide`` also times at the 384 px sites
WIDE_FORWARDS = ("lanes_attn_fwd", "flash_lanes_fwd", "axial_eval_fwd",
                 "moment_sums_fwd")


def _site_rows(smoke, routes, calls, path, keep):
    """One row per kernel and site of a classifier's ``calls`` on
    ``routes`` whose (kernel, span) ``keep`` takes, launches summed over
    the call's sites of that geometry; narrow gp left out."""
    rows = []
    for call, sites in smoke.cls_geometries(routes, calls).items():
        seen = {}
        for kernel, L, gp, S, n in sites:
            if gp in (2, 4, 8, 16) or not keep(kernel, L):
                continue
            key = (kernel, L, gp, S)
            seen[key] = seen.get(key, 0) + n
        rows += [(k, L, gp, S, True, n, f"{path}_{call}")
                 for (k, L, gp, S), n in seen.items()]
    return rows


def wide_geometries(smoke) -> list:
    """(kernel, span, gp, stripes, has_pos, launches per call, path) of the
    smoke's ``cls_wide`` calls (every wide kernel; path
    ``<model>_<call>``) and of its ``cls_hires`` calls (path
    ``<model>384_<call>``): the wide forwards at the spans up to 64 and the
    moments forward at the span-96 sites."""
    rows = []
    for model, calls in smoke.CLS_WIDE_CALLS.items():
        rows += _site_rows(smoke, smoke.CLS_WIDE_ROUTES[model], calls, model,
                           lambda k, L: True)
    for model, calls in smoke.CLS_HIRES_CALLS.items():
        rows += _site_rows(
            smoke, smoke.CLS_HIRES_ROUTES[model], calls, f"{model}384",
            lambda k, L: k in WIDE_FORWARDS and (
                L <= 64 or k == "moment_sums_fwd"))
    return rows


# the kernels that ``long`` times at the 384 px span-96 sites: rows 5, 6
# and 8
LONG_KERNELS = ("flash2_lanes_fwd", "flash2_lanes_bwd", "moment_sums_bwd")
LONG_CALLS = {"axial50m": ("b8_step", "b8_forward"), "axial50l": ("b1_step",)}
# one HIRES_SWEEP geometry per register bucket of c = gp / 2
LONG_SWEEP = [(128, gp, True) for gp in (12, 32, 64, 128)]


def long_geometries(smoke) -> list:
    """(kernel, span, gp, stripes, has_pos, launches per call, path) of
    the long-span wide kernels and row 8 at the smoke's ``cls_hires``
    span-96 calls (path ``<model>384_<call>``), rows 10-11's wide route at
    axial50l's 224 px batch-1 step (span 56) and the flash2 pair at
    LONG_SWEEP (path ``sweep``, no launches)."""
    rows = []
    for model, calls in LONG_CALLS.items():
        rows += _site_rows(
            smoke, smoke.long_routes(smoke.CLS_HIRES_ROUTES[model]), calls,
            f"{model}384", lambda k, L: k in LONG_KERNELS)
    rows += _site_rows(smoke, smoke.CLS_WIDE_ROUTES["axial50l"], ("b1_step",),
                       "axial50l", lambda k, L: k.startswith("flash_lanes")
                       and L == 56)
    rows += [(k, L, gp, smoke.HIRES_SWEEP_STRIPES, pos, 0, "sweep")
             for L, gp, pos in LONG_SWEEP
             for k in ("flash2_lanes_fwd", "flash2_lanes_bwd")]
    return rows


def wide_bf16_geometries(smoke) -> list:
    """The bf16 entry points' rows at axial50m's batch-8 step geometries."""
    return [r for r in wide_geometries(smoke)
            if r[6] == "axial50m_b8_step" and r[0] in smoke.BF16_KERNELS]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(HERE),
                        help="tree whose chip_smoke.py and package to run")
    parser.add_argument("--family", nargs="+", choices=FAMILIES,
                        default=["flash2"],
                        help="kernel families whose geometries to run")
    parser.add_argument("--sites", default=None,
                        help="tree whose chip_smoke.py geometries to run "
                             "(default: --root's own), so that two trees "
                             "are timed at the same sites")
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

    geometries = smoke.GEOMETRIES
    if args.sites:
        spec = importlib.util.spec_from_file_location(
            "sites_smoke", Path(args.sites).resolve() / "chip_smoke.py")
        sites = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sites)
        geometries = sites.GEOMETRIES
    chosen = [g for g in geometries if family(g[0]) in args.family]
    if "flash" in args.family:
        chosen += flash2_baseline(chosen)
    site_smoke = sites if args.sites else smoke
    if "wide" in args.family or "long" in args.family:
        bf16 = [g for g in smoke._bf16_geometries()
                if family(g[0]) in args.family]
        if "wide" in args.family:
            chosen += wide_geometries(site_smoke)
            bf16 += wide_bf16_geometries(site_smoke)
        if "long" in args.family:
            long_rows = long_geometries(site_smoke)
            chosen += long_rows
            # the bf16 entry points of rows 5 and 6 at axial50m-384's step
            bf16 += [r for r in long_rows if r[6] == "axial50m384_b8_step"
                     and r[0].startswith("flash2")]
        smoke._bf16_geometries = lambda: bf16
    smoke.GEOMETRIES = chosen
    smi, name = smoke.phase_device(torch)
    smoke.phase_build()
    try:
        rows = smoke.phase_kernels(torch)
    except smoke.PhaseFailed as e:
        print(f"compare_kernels: {e}", file=sys.stderr)
        return 1
    split = []
    for r in rows:
        gen = torch.Generator(device="cuda").manual_seed(row_seed(r))
        kernel, extra = r["kernel"], {}
        if kernel.endswith("_bf16"):    # a bf16 entry point: bf16 qkv
            kernel = kernel[:-len("_bf16")]
            extra["cast"] = lambda t: t.to(torch.bfloat16)
        fn, _ = smoke.kernel_calls(torch, gen, kernel, r["gp"], r["span"],
                                   r["S"], r["has_pos"], **extra)
        by_kernel = split_by_kernel(torch, fn)
        if not by_kernel:  # the profiler kept no events: once more
            by_kernel = split_by_kernel(torch, fn)
        r["device_ms"] = sum(by_kernel.values())
        r["host_ms"] = host_ms(torch, fn)
        r["peak_alloc_mb"] = peak_alloc_mb(torch, fn)
        r["out_sha256"] = out_sha256(torch, fn())
        split.append({"kernel": r["kernel"], "span": r["span"], "gp": r["gp"],
                      "S": r["S"], "has_pos": r["has_pos"], "path": r["path"],
                      "launches_per_call": r["launches_per_call"],
                      "device_ms": r["device_ms"], "host_ms": r["host_ms"],
                      "peak_alloc_mb": r["peak_alloc_mb"],
                      "ms_by_kernel": by_kernel})
        del fn
        torch.cuda.empty_cache()
    per_call = {}
    for r in rows:
        k = r["launches_per_call"]
        if not k:
            continue
        acc = per_call.setdefault(f"{r['kernel']}@{r['path']}", {
            "ms": 0.0, "device_ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0,
            "bound_ms": 0.0})
        for key in acc:
            acc[key] += r[key] * k
    for acc in per_call.values():
        acc["x_bound"] = acc["ms"] / acc["bound_ms"]
        acc["device_x_bound"] = acc["device_ms"] / acc["bound_ms"]
    out = {"root": str(root), "card": smi, "torch_name": name,
           "families": args.family, "per_main_path_call": per_call,
           "rows": rows, "split": split}
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    sites = [{k: r[k] for k in ("kernel", "span", "gp", "S", "has_pos",
                                 "path", "launches_per_call", "ms",
                                 "device_ms", "host_ms", "peak_alloc_mb",
                                 "out_sha256")}
             for r in rows]
    print(json.dumps({"card": smi, "root": str(root),
                      "per_main_path_call": per_call, "sites": sites}),
          flush=True)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
