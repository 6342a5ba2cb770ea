"""Where a served batch's time goes on the card.

    python -m medt_tpu_torch.profile_serve

Serves full MedT-128 batches of 16 through ``InferenceEngine`` (seeded
random weights) and prints one JSON object: the wall time per batch
(host clock, profiler off), then, from a ``torch.profiler`` window over as
many batches, the device's summed kernel time per batch, its busy share of
that wall time, the share of the port's attention kernels and the top
kernels by device time. Needs a card; exits non-zero without one.
"""
from __future__ import annotations

import json
import sys
import time


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


MODEL, IMG, BATCH, ITERS = "MedT", 128, 16, 5


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    from .models import build_model
    from .serving import InferenceEngine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    variables = build_model(MODEL, img_size=IMG, seed=0,
                            device="cpu").state_dict()
    engine = InferenceEngine(MODEL, IMG, variables=variables,
                             batch_size=BATCH)
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, size=(IMG, IMG, 3),
                           dtype=np.uint8) for _ in range(BATCH)]
    for _ in range(3):
        engine.predict_batch(images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        engine.predict_batch(images)   # ends in a device->host copy
    wall = (time.perf_counter() - t0) / ITERS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            engine.predict_batch(images)
        wall_profiled = (time.perf_counter() - t0) / ITERS
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _device_us(e) > 0]
    total_us = sum(_device_us(e) for e in kernels) / ITERS
    attn_us = sum(_device_us(e) for e in kernels
                  if "axial_lanes_fwd_kernel" in e.key) / ITERS
    top = sorted(kernels, key=_device_us, reverse=True)[:15]
    out = {
        "device": torch.cuda.get_device_name(0), "model": MODEL,
        "img": IMG, "batch": BATCH, "iters": ITERS,
        "wall_ms_per_batch": wall * 1e3,
        "wall_ms_per_batch_profiled": wall_profiled * 1e3,
        "device_kernel_ms_per_batch": (total_us / 1e3) if kernels
        else "not measured",
        "device_busy_share": (total_us / 1e6 / wall) if kernels
        else "not measured",
        "attention_kernels_ms_per_batch": attn_us / 1e3,
        "kernel_launches_per_batch": sum(e.count for e in kernels)
        / ITERS,
        "top": [{"name": e.key[:90], "ms_per_batch":
                 _device_us(e) / 1e3 / ITERS,
                 "calls_per_batch": e.count / ITERS} for e in top],
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
