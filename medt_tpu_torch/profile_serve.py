"""Where a served batch's time goes on the card.

    python -m medt_tpu_torch.profile_serve [--batch 1] [--model medt_512 --img 512]
        [--dtype bfloat16]

Serves full MedT-128 batches of 16 (or of ``--batch``: at 1, the batch-1
evaluation path of the test and predict CLIs, whose attention runs the
eval and lanes kernels; or another ``--model`` at ``--img``, by default
the model's own size) through ``InferenceEngine`` (seeded random weights;
bf16 activations with ``--dtype bfloat16``) and prints one JSON object: the wall time per batch
(host clock, profiler off), then, from a ``torch.profiler`` window over as
many batches, the device's summed kernel time per batch, its busy share of
that wall time, the share of the port's attention kernels and the top
kernels by device time. Needs a card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


# the port's attention kernels, by (a part of) the names nvcc gives them
# with their namespaces dropped (the eval kernel is
# csrc/stripe_attn_fwd.cuh's, named by its epilogue; the flash and flash2
# forwards are csrc/tiled_fwd.cuh's)
PORT_KERNELS = ("axial_lanes_fwd_kernel",
                "stripe_attn_fwd_kernel<EvalEpilogue", "tiled_fwd_kernel")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--model", default="MedT")
    parser.add_argument("--img", type=int, default=None,
                        help="image size (default: the model's own)")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"),
                        default="float32")
    args = parser.parse_args(argv)
    batch, model = args.batch, args.model
    iters = 5 if batch >= 16 else 20
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    from .models import DEFAULT_IMG_SIZE, build_model
    from .serving import InferenceEngine

    img = args.img or DEFAULT_IMG_SIZE.get(model, 128)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    variables = build_model(model, img_size=img, seed=0,
                            device="cpu").state_dict()
    engine = InferenceEngine(model, img, variables=variables,
                             batch_size=batch,
                             dtype=getattr(torch, args.dtype))
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, size=(img, img, 3),
                           dtype=np.uint8) for _ in range(batch)]
    for _ in range(3):
        engine.predict_batch(images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        engine.predict_batch(images)   # ends in a device->host copy
    wall = (time.perf_counter() - t0) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            engine.predict_batch(images)
        wall_profiled = (time.perf_counter() - t0) / iters
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _device_us(e) > 0]
    total_us = sum(_device_us(e) for e in kernels) / iters
    names = [re.sub(r"\(anonymous namespace\)::|\w+::", "", e.key)
             for e in kernels]
    attn_us = sum(_device_us(e) for e, key in zip(kernels, names)
                  if any(k in key for k in PORT_KERNELS)) / iters
    top = sorted(kernels, key=_device_us, reverse=True)[:15]
    out = {
        "device": torch.cuda.get_device_name(0), "model": model,
        "img": img, "batch": batch, "iters": iters, "dtype": args.dtype,
        "wall_ms_per_batch": wall * 1e3,
        "wall_ms_per_batch_profiled": wall_profiled * 1e3,
        "device_kernel_ms_per_batch": (total_us / 1e3) if kernels
        else "not measured",
        "device_busy_share": (total_us / 1e6 / wall) if kernels
        else "not measured",
        "attention_kernels_ms_per_batch": attn_us / 1e3,
        "kernel_launches_per_batch": sum(e.count for e in kernels)
        / iters,
        "top": [{"name": e.key[:90], "ms_per_batch":
                 _device_us(e) / 1e3 / iters,
                 "calls_per_batch": e.count / iters} for e in top],
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
