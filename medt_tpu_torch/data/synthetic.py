"""Synthetic segmentation data, numpy only.

Port of ``medt_tpu/data/synthetic.py`` without its PNG writer (it needs
PIL): :class:`InMemoryDataset` and :func:`blob_batch`, the blob images and
masks that the JAX PNG writer draws, made in memory so that a smoke run's
loss can fall.
"""
from __future__ import annotations

import numpy as np


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
