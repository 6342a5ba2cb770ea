"""Best-checkpoint grid evaluation: the MATLAB grading protocol.

Port of ``medt_tpu/evaluation/sweep.py`` (``performancemetrics_*.m``): for
each saved epoch directory of predicted masks, the per-image foreground
F1, IoU and pixel accuracy against the label directory, and the epoch with
the best mean F1 (reference performancemetrics_glas.m:15-88).

* predictions are binarized at ``> pred_thresh`` (130 glas, 127 monuseg),
  labels at ``> gt_thresh``;
* ``empty_score_one`` scores an image with no true positive as 1.0, as the
  original scripts do (glas.m:72-76); off by default;
* an epoch directory with no PNG that the label directory also holds
  scores nan over 0 images and is never the best.

PNGs are read with the port's own decoder (:func:`..data.png.read_png`,
gray): on gray masks it gives the bytes of JAX's ``cv2.imread(path, 0)``,
and on colour labels libpng's fixed-point ``rgb_to_gray``. The scores come
from :func:`..metrics.binary_seg_scores` on ``device`` (``None``: the
card).

    python -m medt_tpu_torch.evaluation.sweep --pred_root <results_dir> \\
        --label_dir <dataset>/labelcol [--empty_score_one]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.png import read_png
from ..device import resolve_device
from ..metrics import binary_seg_scores


def evaluate_png_dir(pred_dir: str, label_dir: str, *,
                     pred_thresh: int = 127, gt_thresh: int = 127,
                     empty_score_one: bool = False,
                     device=None) -> Dict[str, float]:
    """Mean per-image F1/IoU/PA of the ``pred_dir`` masks against the
    ``label_dir`` masks of the same names."""
    names = sorted(
        n for n in os.listdir(pred_dir)
        if n.lower().endswith(".png")
        and os.path.exists(os.path.join(label_dir, n)))
    if not names:
        return {"f1": float("nan"), "miou": float("nan"), "pa": float("nan"),
                "images": 0}
    device = resolve_device(device)
    pred = np.stack([read_png(os.path.join(pred_dir, n), gray=True)
                     > pred_thresh for n in names])
    gt = np.stack([read_png(os.path.join(label_dir, n), gray=True)
                   > gt_thresh for n in names])
    f1, iou, pa = binary_seg_scores(torch.from_numpy(pred).to(device),
                                    torch.from_numpy(gt).to(device),
                                    empty_score_one=empty_score_one)
    return {"f1": float(f1.mean()), "miou": float(iou.mean()),
            "pa": float(pa.mean()), "images": len(names)}


def sweep_checkpoint_grid(pred_root: str, label_dir: str,
                          epochs: Optional[List[int]] = None,
                          **kwargs) -> Dict:
    """Evaluate every numeric epoch directory under ``pred_root`` (or the
    given ``epochs``); ``{"per_epoch", "best_epoch", "best"}``."""
    if epochs is None:
        epochs = sorted(
            int(d) for d in os.listdir(pred_root)
            if d.isdigit() and os.path.isdir(os.path.join(pred_root, d)))
    results = {}
    best = None
    for ep in epochs:
        scores = evaluate_png_dir(os.path.join(pred_root, str(ep)),
                                  label_dir, **kwargs)
        results[ep] = scores
        if scores["images"] and (best is None
                                 or scores["f1"] > results[best]["f1"]):
            best = ep
    return {"per_epoch": results, "best_epoch": best,
            "best": results.get(best)}


def main(argv=None, device=None) -> Dict:
    p = argparse.ArgumentParser(description="best-checkpoint F1/mIoU sweep")
    p.add_argument("--pred_root", required=True)
    p.add_argument("--label_dir", required=True)
    p.add_argument("--pred_thresh", type=int, default=127)
    p.add_argument("--gt_thresh", type=int, default=127)
    p.add_argument("--empty_score_one", action="store_true")
    args = p.parse_args(argv)
    out = sweep_checkpoint_grid(
        args.pred_root, args.label_dir, pred_thresh=args.pred_thresh,
        gt_thresh=args.gt_thresh, empty_score_one=args.empty_score_one,
        device=device)
    print(json.dumps(out, indent=2, default=str))
    return out


if __name__ == "__main__":
    main()
