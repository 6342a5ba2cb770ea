"""Training CLI.

Port of ``medt_tpu/cli/train.py``; the flags mirror the reference
(train.py, cmd.txt) and the JAX package (``config.py``):

    python -m medt_tpu_torch.cli.train --train_dataset <dir> \\
        --val_dataset <dir> --modelname MedT --imgsize 128 --epochs 400 \\
        --learning_rate 1e-3 --save_freq 10 --direc ./results

It trains at ``--batch_size`` 1 unless told otherwise, as the reference
does. It runs on the card; an in-process caller may pass ``device="cpu"``.
"""
from __future__ import annotations

from ..config import parse_config
from ..device import resolve_device
from ..training.trainer import run_training


def main(argv=None, device=None):
    """Parse ``argv`` and train; returns the final ``TrainState``."""
    cfg = parse_config(argv, description="medt_tpu_torch train")
    if not cfg.train_dataset:
        raise SystemExit("--train_dataset is required")
    return run_training(cfg, device=resolve_device(device))


if __name__ == "__main__":
    main()
