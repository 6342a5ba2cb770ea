"""End-to-end learning check of the training CLI on synthetic blobs.

    python -m medt_tpu_torch.learn_blobs [--out DIR]

Writes 8 training and 8 validation blob PNG pairs at 128x128
(``data.synthetic.make_png_dataset``, seeds 0 and 1), trains MedT on them
with ``cli.train`` at its defaults (batch 1, Adam-L2, lr 1e-3, weights
from seed 3000) for 45 epochs with the argmax decision rule and a
validation pass every epoch, and prints one JSON object: the best validation F1 and IoU with
their epochs, the last epoch's, the wall time and the card. The JAX
package's result on such a set is in BASELINE.md (val F1 0.949 / mIoU
0.905 at epoch 45). Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

EPOCHS = 45
IMAGES = 8


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="_smoke/learn_blobs")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("learn_blobs: no CUDA device", file=sys.stderr)
        return 2
    from .cli import train as cli_train
    from .data import make_png_dataset

    shutil.rmtree(args.out, ignore_errors=True)
    train_dir = make_png_dataset(os.path.join(args.out, "train"),
                                 IMAGES, 128, seed=0)
    val_dir = make_png_dataset(os.path.join(args.out, "val"), IMAGES, 128,
                               seed=1)
    direc = os.path.join(args.out, "run")
    t0 = time.perf_counter()
    cli_train.main(["--train_dataset", train_dir, "--val_dataset", val_dir,
                    "--modelname", "MedT", "--imgsize", "128", "--epochs",
                    str(EPOCHS), "--save_freq", "1", "--pred_mode",
                    "argmax", "--direc", direc, "--workers", "2"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(os.path.join(direc, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    best_f1 = max(log, key=lambda e: e["val_f1"])
    best_iou = max(log, key=lambda e: e["val_iou"])
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "model": "MedT",
        "img": 128, "batch": 1, "train_images": IMAGES,
        "val_images": IMAGES, "epochs": EPOCHS,
        "best_val_f1": best_f1["val_f1"], "best_f1_epoch": best_f1["epoch"],
        "best_val_iou": best_iou["val_iou"],
        "best_iou_epoch": best_iou["epoch"], "last": log[-1],
        "wall_s": wall, "steps": EPOCHS * IMAGES,
        "loss_first": log[0]["loss"], "loss_last": log[-1]["loss"],
        "imgs_per_sec_by_epoch": [e["imgs_per_sec"] for e in log]}),
        flush=True)
    shutil.rmtree(args.out, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
