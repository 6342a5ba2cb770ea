"""Synthetic segmentation data, numpy only.

Port of ``medt_tpu/data/synthetic.py``: :func:`blob_batch` makes in memory
the blob images and masks that :func:`make_png_dataset` writes as PNG
files through :mod:`.png` (the JAX writer draws the same arrays and saves
them with PIL); :class:`InMemoryDataset` for loader-free runs.
"""
from __future__ import annotations

import os

import numpy as np

from .png import write_png


def blob_batch(n: int = 8, img_size: int = 64, chans: int = 3,
               seed: int = 0):
    """``(images, masks)``: (n, H, W, chans) uint8 images of one bright disc
    on a noisy background each, and their (n, H, W) int64 0/1 masks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:img_size, 0:img_size]
    images = np.empty((n, img_size, img_size, chans), np.uint8)
    masks = np.empty((n, img_size, img_size), np.int64)
    for i in range(n):
        cx, cy = rng.integers(8, img_size - 8, size=2)
        r = int(rng.integers(4, img_size // 4))
        mask = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
        noise = rng.integers(0, 80, size=(img_size, img_size), dtype=np.uint8)
        img = np.where(mask, 200, 60).astype(np.uint8) + noise // 4
        if chans == 3:
            img = np.stack([img, img // 2, 255 - img], axis=-1)
        images[i] = img.reshape(img_size, img_size, chans)
        masks[i] = mask
    return images, masks


def make_png_dataset(root: str, n: int = 8, img_size: int = 64,
                     gray: bool = False, seed: int = 0) -> str:
    """Write a blob-segmentation set under ``root``: ``img/NNN.png`` (RGB,
    or gray) and ``labelcol/NNN.png`` (0/255 masks)."""
    images, masks = blob_batch(n, img_size, 1 if gray else 3, seed)
    for sub in ("img", "labelcol"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        write_png(os.path.join(root, "img", f"{i:03d}.png"), images[i])
        write_png(os.path.join(root, "labelcol", f"{i:03d}.png"),
                  (masks[i] * 255).astype(np.uint8))
    return root


class InMemoryDataset:
    """Pre-generated arrays with the (image, mask, name) protocol."""

    def __init__(self, n: int = 8, img_size: int = 64, chans: int = 3,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        self.images = rng.normal(size=(n, img_size, img_size, chans)).astype(
            np.float32)
        self.masks = rng.integers(0, 2, size=(n, img_size, img_size)).astype(
            np.int32)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx, rng=None):
        return self.images[idx], self.masks[idx], f"{idx:03d}.png"
