"""Where a training step's time goes on the card.

    python -m medt_tpu_torch.profile_train [--model medt_512 --img 512 --batch 4]
        [--dtype bfloat16] [--remat] [--sync ddp|host|read]

Trains MedT 128 at batch 16 (or ``--model`` at ``--img``, by default the
model's own size, and ``--batch``; full width, seeded random weights,
Adam-L2, float32 with TF32 off, or bf16 activations with ``--dtype
bfloat16``, the forward recomputed in the backward with ``--remat``) on a
synthetic blob batch and prints one JSON object. ``--sync`` makes the
process an NCCL world of one and wraps the model in
``DistributedDataParallel``: ``ddp`` alone, ``host`` with every train-mode
statistic summed through NCCL as a data-parallel step sums it
(``parallel.sync``, each joint count worked out on the host), ``read``
with each count packed beside the sums and read back, as a rank without
rows does. The JSON object holds the wall time per step
(host clock, profiler off) and the peak of allocated device memory over
those steps, then, from a
``torch.profiler`` window over as many steps, the device's summed kernel
time per step, its busy share of that wall time, the kernel launches per
step, the port's own kernels (attention cores forward and backward,
moments) per step and the top kernels by device time. Needs a card; exits
non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time

from .profile_serve import _device_us

ITERS, LR = 5, 1e-3
# the port's hand-written kernels, by (a part of) the names nvcc gives
# them with their namespaces dropped: the stripe forward is
# csrc/stripe_attn_fwd.cuh's kernel, named by its epilogue; the flash and
# flash2 forwards and backwards are csrc/tiled_fwd.cuh's and
# csrc/tiled_bwd.cuh's, named by their tile policies
OWN_KERNELS = ("axial_lanes_fwd_kernel", "lanes_bwd_kernel",
               "tiled_fwd_kernel<FlashFwdTiles",
               "tiled_fwd_kernel<Flash2FwdTiles",
               "tiled_bwd_row_kernel<FlashTiles",
               "tiled_bwd_col_kernel<FlashTiles",
               "tiled_bwd_row_kernel<Flash2Tiles",
               "tiled_bwd_col_kernel<Flash2Tiles", "bwd_finalize_kernel",
               "moments_fwd_kernel", "moments_finalize_kernel",
               "moments_bwd_kernel", "tab_finalize_kernel",
               "stripe_attn_fwd_kernel<TrainEpilogue",
               "stripe_bwd_kernel")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="MedT")
    parser.add_argument("--img", type=int, default=None,
                        help="image size (default: the model's own)")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--dtype", choices=("float32", "bfloat16"),
                        default="float32")
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--sync", choices=("off", "ddp", "host", "read"),
                        default="off")
    args = parser.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    from . import ops
    from .data import blob_batch
    from .models import DEFAULT_IMG_SIZE, build_model
    from .parallel import data_parallel_step
    from .parallel.launch import free_port
    from .training import TrainState, adam_l2, train_step

    name, batch_size = args.model, args.batch
    img = args.img or DEFAULT_IMG_SIZE.get(name, 128)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else None
    model = build_model(name, img_size=img, use_fused=True, seed=0,
                        device="cuda", dtype=dtype)
    if args.sync != "off":
        dist = torch.distributed
        dist.init_process_group("nccl", rank=0, world_size=1,
                                init_method=f"tcp://127.0.0.1:{free_port()}")
        model = torch.nn.parallel.DistributedDataParallel(model,
                                                          device_ids=[0])
    state = TrainState(model, adam_l2(model.parameters(), LR))
    images, masks = blob_batch(batch_size, img, seed=0)
    batch = {"image": images, "label": masks}

    def step():
        if args.sync in ("host", "read"):
            with data_parallel_step(batch_size if args.sync == "host" else 0,
                                    batch_size):
                train_step(state, batch, remat=args.remat)
        else:
            train_step(state, batch, remat=args.remat)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / ITERS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    own_launches = {k: v / ITERS for k, v in ops.launch_counts().items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            step()
        torch.cuda.synchronize()
        wall_profiled = (time.perf_counter() - t0) / ITERS
    # device-side ranges of record_function annotations (the optimizer's
    # "Optimizer.step#Adam.step") span kernels counted on their own
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _device_us(e) > 0
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    total_us = sum(_device_us(e) for e in kernels) / ITERS
    names = [re.sub(r"\(anonymous namespace\)::|\w+::", "", e.key)
             for e in kernels]
    own = {name: sum(_device_us(e) for e, key in zip(kernels, names)
                     if name in key) / ITERS / 1e3 for name in OWN_KERNELS}
    top = sorted(kernels, key=_device_us, reverse=True)[:15]
    out = {
        "device": torch.cuda.get_device_name(0), "model": name,
        "img": img, "batch": batch_size, "iters": ITERS,
        "optimizer": "adam_l2", "dtype": args.dtype, "remat": args.remat,
        "sync": args.sync,
        "wall_ms_per_step": wall * 1e3, "peak_memory_gb": peak_gb,
        "images_per_s": batch_size / wall,
        "wall_ms_per_step_profiled": wall_profiled * 1e3,
        "device_kernel_ms_per_step": (total_us / 1e3) if kernels
        else "not measured",
        "device_busy_share": (total_us / 1e6 / wall) if kernels
        else "not measured",
        "kernel_launches_per_step": sum(e.count for e in kernels) / ITERS,
        "port_kernel_wrapper_calls_per_step": own_launches,
        "port_kernels_ms_per_step": own,
        "port_kernels_ms_per_step_total": sum(own.values()),
        "top": [{"name": e.key[:90], "ms_per_step":
                 _device_us(e) / 1e3 / ITERS,
                 "calls_per_step": e.count / ITERS} for e in top],
    }
    print(json.dumps(out), flush=True)
    if args.sync != "off":
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
