"""Prediction CLI: masks for an unlabelled PNG directory.

Port of ``medt_tpu/cli/predict.py`` (the reference's ``Image2D`` set,
reference utils.py:179-231). An image of exactly ``--imgsize`` runs at
batch 1; any other size goes through the sliding window with a stride of
half the window (larger images tiled, smaller ones reflect-padded up to
it). One mask PNG per image, of the image's size, under ``--direc``.

    python -m medt_tpu_torch.cli.predict --val_dataset <dir> \\
        --modelname MedT --imgsize 128 --loaddirec ./results/final_model \\
        --direc ./preds

A deep-supervision model's main logits make the mask. It runs on the
card; an in-process caller may pass ``device="cpu"``.
"""
from __future__ import annotations

import os

import torch

from ..config import parse_config
from ..data import Image2D
from ..data.png import write_mask_png
from ..device import resolve_device
from ..evaluation.sliding_window import sliding_window_inference
from ..metrics import logits_to_foreground
from ..models import main_logits
from ..utils import chk_mkdir
from .test import load_model


def main(argv=None, device=None) -> list:
    """Write the masks; returns ``[(name, (H, W)), ...]`` of what was
    written."""
    cfg = parse_config(argv, description="medt_tpu_torch predict")
    if not cfg.val_dataset or not cfg.loaddirec:
        raise SystemExit("--val_dataset and --loaddirec are required")
    device = resolve_device(device)
    ds = Image2D(cfg.val_dataset, gray=cfg.gray == "yes")
    model = load_model(cfg, device)

    def forward(x):
        return main_logits(model(x))

    chk_mkdir(cfg.direc)
    written = []
    with torch.inference_mode():
        for i in range(len(ds)):
            image, name = ds[i]                      # (H, W, C) float32
            if image.shape[:2] == (cfg.imgsize, cfg.imgsize):
                x = torch.from_numpy(image).to(device).permute(2, 0, 1)
                logits = forward(x[None])[0]
            else:
                logits = sliding_window_inference(
                    image, forward, window=cfg.imgsize,
                    stride=max(cfg.imgsize // 2, 1), device=device)
            fg = logits_to_foreground(logits[None], mode=cfg.pred_mode)[0]
            mask = fg.cpu().numpy()
            write_mask_png(os.path.join(cfg.direc, name), mask)
            written.append((name, mask.shape))
    print(f"wrote {len(ds)} masks to {cfg.direc}")
    return written


if __name__ == "__main__":
    main()
