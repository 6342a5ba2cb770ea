"""Scoring CLI: a checkpoint over a labelled PNG set, one image at a time.

Port of ``medt_tpu/cli/test.py`` (the reference's test.py, with its
undefined ``args.aug`` read fixed and its discarded metrics kept): the
same flags (``config.py``), one mask PNG per image under ``--direc`` and a
``metrics.json`` with ``per_image_f1``, ``per_image_iou``, ``mean_f1``,
``mean_iou`` and ``images``. The model runs at batch 1, as the reference's
loader does; a deep-supervision model's main logits make the mask.

    python -m medt_tpu_torch.cli.test --val_dataset <dir> --modelname MedT \\
        --imgsize 128 --loaddirec ./results/final_model --direc ./preds

It runs on the card; an in-process caller may pass ``device="cpu"``.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..config import parse_config
from ..data import DataLoader, ImageToImage2D, JointTransform2D, to_device
from ..data.png import write_mask_png
from ..device import resolve_device
from ..metrics import binary_seg_scores, logits_to_foreground
from ..models import build_model, main_logits
from ..training.checkpointing import restore_checkpoint
from ..utils import chk_mkdir


def load_model(cfg, device, plain_cores: bool = False):
    """The configured model on ``device``, restored from ``--loaddirec``,
    in eval mode."""
    model = build_model(cfg.modelname, img_size=cfg.imgsize,
                        imgchan=cfg.imgchan, use_fused=cfg.use_fused,
                        plain_cores=plain_cores, device=device)
    restore_checkpoint(cfg.loaddirec, model)
    return model.eval()


def main(argv=None, device=None) -> dict:
    """Score the set; returns the summary of ``metrics.json`` plus
    ``per_image_ms`` (host clock per image, from its batch on the host to
    its mask back on the host)."""
    cfg = parse_config(argv, description="medt_tpu_torch test")
    if not cfg.val_dataset or not cfg.loaddirec:
        raise SystemExit("--val_dataset and --loaddirec are required")
    device = resolve_device(device)

    tf_val = JointTransform2D(crop=cfg.crop_tuple, p_flip=0,
                              color_jitter_params=None, long_mask=True)
    ds = ImageToImage2D(cfg.val_dataset, tf_val, gray=cfg.gray == "yes")
    loader = DataLoader(ds, 1, shuffle=False, num_workers=cfg.workers,
                        seed=cfg.seed)
    model = load_model(cfg, device)

    chk_mkdir(cfg.direc)
    f1s, ious, per_image_ms = [], [], []
    with torch.inference_mode():
        for batch in loader:
            t0 = time.perf_counter()
            dev = to_device(batch, device)
            logits = main_logits(
                model(dev["image"].permute(0, 3, 1, 2).float()))
            fg = logits_to_foreground(logits, mode=cfg.pred_mode)
            f1, iou, _ = binary_seg_scores(fg, dev["label"] > 0)
            fg_np = fg.cpu().numpy()
            per_image_ms.append((time.perf_counter() - t0) * 1e3)
            f1s.extend(f1.tolist())
            ious.extend(iou.tolist())
            for i, name in enumerate(batch["name"]):
                write_mask_png(os.path.join(cfg.direc, name), fg_np[i])

    summary = {"mean_f1": float(np.mean(f1s)),
               "mean_iou": float(np.mean(ious)), "images": len(f1s)}
    print(json.dumps(summary))
    with open(os.path.join(cfg.direc, "metrics.json"), "w") as f:
        json.dump({"per_image_f1": f1s, "per_image_iou": ious, **summary}, f)
    return {**summary, "per_image_ms": per_image_ms}


if __name__ == "__main__":
    main()
