"""Training CLI.

Port of ``medt_tpu/cli/train.py``; the flags mirror the reference
(train.py, cmd.txt) and the JAX package (``config.py``):

    python -m medt_tpu_torch.cli.train --train_dataset <dir> \\
        --val_dataset <dir> --modelname MedT --imgsize 128 --epochs 400 \\
        --learning_rate 1e-3 --save_freq 10 --direc ./results

It trains at ``--batch_size`` 1 unless told otherwise, as the reference
does. It runs on the card; an in-process caller may pass ``device="cpu"``.

Data and model parallel, as JAX's trainer spans every visible device:
``--dp N`` (default: every visible card, over ``--tp``) trains on N data
ranks, and ``--tp M`` splits every attention layer's groups over M ranks
of each (``dp * M`` ranks, one a card), spawned by
:func:`..parallel.run_data_parallel` (NCCL; on the CPU, with
``device="cpu"``, gloo ranks). Under ``torchrun --nproc_per_node N -m
medt_tpu_torch.cli.train ...`` it joins torchrun's world instead, and
``--dp`` times ``--tp`` must equal its size; ``--num_slices`` pins the
nodes the data axis spans. ``--batch_size`` is the global batch.
"""
from __future__ import annotations

from ..config import Config, parse_config
from ..device import resolve_device
from ..parallel import (
    data_devices,
    initialize_distributed,
    launched_world,
    run_data_parallel,
)
from ..training.trainer import run_training


def main(argv=None, device=None):
    """Parse ``argv`` and train; returns the final ``TrainState``, or None
    when it spawned the ranks of a parallel run (each rank's state stays
    in its process)."""
    cfg = parse_config(argv, description="medt_tpu_torch train",
                       device=device)
    if not cfg.train_dataset:
        raise SystemExit("--train_dataset is required")
    if launched_world() is not None:    # torchrun's world, or a caller's
        initialize_distributed()
        return run_training(cfg, device=resolve_device(device))
    devices = data_devices(cfg.dp, device, cfg.tp)
    if len(devices) == 1:
        return run_training(cfg, device=resolve_device(device))
    backend = "gloo" if devices[0] == "cpu" else "nccl"
    run_data_parallel(_train_rank, devices, backend, args=(cfg,))
    return None


def _train_rank(device, cfg: Config):
    """One rank of a spawned parallel run."""
    run_training(cfg, device=device)


if __name__ == "__main__":
    main()
