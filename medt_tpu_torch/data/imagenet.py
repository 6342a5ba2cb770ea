"""Folder-per-class classification dataset (ImageNet-style).

Port of ``medt_tpu/data/imagenet.py`` (reference lib/datasets/
imagenet1k.py:6-56): the ImageFolder layout ``<root>/<class>/<image>``, a
RandomResizedCrop + horizontal flip train transform, a Resize(256 *
size / 224) + CenterCrop eval transform, and per-channel normalisation.
``shard = (index, count)`` keeps every count-th sample from index on, as
JAX's per-host reader slices the set; the classification driver does not
use it (its ranks would take unequal step counts) and shards each joint
batch in the loader instead (``DataLoader(shard=...)``).

The crops draw from the numpy ``Generator`` in JAX's order (scale, log
ratio, then the crop's row and column, up to ten tries; then the flip), so
a seed gives JAX's crop box and flip. Reads follow the port's rule
(:mod:`.dataset`): ``.png`` through the port's own decoder, any other
format through cv2, else PIL, each imported at the first such read; an
``ImportError`` names the format when neither imports. The resize is the
port's own, :func:`resize_linear`: it reproduces cv2's ``INTER_LINEAR``
on uint8 (half-pixel centres, 11-bit fixed-point weights, cv2's rounding)
on every machine, where JAX calls cv2, else PIL.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from .dataset import _imread

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# cv2's fixed-point resize weights: INTER_RESIZE_COEF_BITS = 11
_COEF_SCALE = np.float32(2048)


def _linear_taps(src: int, dst: int, clamp: bool):
    """(first tap, second tap, first weight, second weight) per output
    position, as cv2 computes them: ``f = (d + 0.5) * src / dst - 0.5`` in
    double, rounded to float; the weights ``1 - frac`` and ``frac`` scaled
    by 2048 in float and rounded half to even. Along x (``clamp``) a
    position past either edge takes the edge pixel at weight 2048; along
    y the weights keep their fraction and only the rows are clamped."""
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * (src / dst)
         - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        edge = (s < 0) | (s >= src - 1)
        f[edge] = 0.0
        s = np.clip(s, 0, src - 1)
    w0 = np.rint((np.float32(1) - f) * _COEF_SCALE).astype(np.int64)
    w1 = np.rint(f * _COEF_SCALE).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of a uint8 (H, W) or (H, W, C) image to ``size`` =
    (height, width), bit for bit cv2's ``resize(..., INTER_LINEAR)``: the
    horizontal pass in integers (weights of 2048), the vertical one as
    cv2's vector path rounds it, ``((r0 >> 4) * b0 >> 16) + ((r1 >> 4) *
    b1 >> 16) + 2 >> 2``; an exact 2x downscale is cv2's 2x2 box average,
    ``(a + b + c + d + 2) >> 2``, as cv2 switches to it there."""
    h, w = size
    H, W = img.shape[:2]
    x = img.astype(np.int64)
    if (H, W) == (h, w):
        return img.copy()
    if (H, W) == (2 * h, 2 * w):
        s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    xs0, xs1, a0, a1 = _linear_taps(W, w, clamp=True)
    ys0, ys1, b0, b1 = _linear_taps(H, h, clamp=False)
    trail = (1,) * (img.ndim - 2)
    rows = x[:, xs0] * a0.reshape(1, -1, *trail) \
        + x[:, xs1] * a1.reshape(1, -1, *trail)
    b0 = b0.reshape(-1, 1, *trail)
    b1 = b1.reshape(-1, 1, *trail)
    out = (((rows[ys0] >> 4) * b0) >> 16) + (((rows[ys1] >> 4) * b1) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def random_resized_crop(img, size: int, rng, scale=(0.08, 1.0),
                        ratio=(3 / 4, 4 / 3)):
    """A crop of random area and aspect ratio, resized to ``size`` square;
    after ten rejected draws, the centred square."""
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*scale)
        ar = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            i = int(rng.integers(0, h - ch + 1))
            j = int(rng.integers(0, w - cw + 1))
            return resize_linear(img[i:i + ch, j:j + cw], (size, size))
    m = min(h, w)
    i, j = (h - m) // 2, (w - m) // 2
    return resize_linear(img[i:i + m, j:j + m], (size, size))


def center_crop(img, size: int):
    """Resize to ``256 * size // 224`` square, then the centred ``size``
    square."""
    img = resize_linear(img, (256 * size // 224, 256 * size // 224))
    h, w = img.shape[:2]
    i, j = (h - size) // 2, (w - size) // 2
    return img[i:i + size, j:j + size]


class ImageFolderDataset:
    """<root>/<class_name>/<file> -> (image (size, size, 3) float32
    normalised, class index int32, file name)."""

    def __init__(self, root: str, img_size: int = 224, train: bool = True,
                 shard: Optional[Tuple[int, int]] = None):
        self.root = root
        self.img_size = img_size
        self.train = train
        self.classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples = [
            (os.path.join(root, c, f), self.class_to_idx[c])
            for c in self.classes
            for f in sorted(os.listdir(os.path.join(root, c)))
        ]
        if shard is not None:
            index, count = shard
            self.samples = self.samples[index::count]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int, rng=None):
        rng = rng if rng is not None else np.random.default_rng()
        path, label = self.samples[idx]
        img = _imread(path, gray=False)[..., ::-1]     # BGR -> RGB
        if self.train:
            img = random_resized_crop(img, self.img_size, rng)
            if rng.random() < 0.5:
                img = img[:, ::-1]
        else:
            img = center_crop(img, self.img_size)
        img = img.astype(np.float32) / 255.0
        img = (img - IMAGENET_MEAN) / IMAGENET_STD
        return np.ascontiguousarray(img), np.int32(label), os.path.basename(path)
