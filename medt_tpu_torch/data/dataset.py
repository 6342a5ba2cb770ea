"""Datasets over the reference's on-disk contract.

Port of ``medt_tpu/data/dataset.py``. Directory layout (reference
utils.py:112-121, the live scripts reading ``img/`` and ``labelcol/``,
utils.py:130-131): paired PNGs, the mask named by the image's stem +
".png" (utils.py:154). Images decode through :mod:`.png` (numpy + zlib,
bit-exact with the JAX package's libpng decoder), BGR as cv2 reads them.

Binarisation policies (a documented quirk pair, SURVEY.md §2 #3/#4):

* ``rgb``  mode: mask thresholded **before** the dim fixes with
  ``<=127 -> 0, >127 -> 1``   (reference utils.py:156-157)
* ``gray`` mode: image read single-channel, mask thresholded **after**
  the dim fixes with ``<127 -> 0, >=127 -> 1``  (reference
  utils_gray.py:151-160 — value 127 maps to 1 here but 0 in rgb mode).
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np

from .png import read_png
from .transforms import to_float01


def _imread(path: str, gray: bool) -> np.ndarray:
    if not path.lower().endswith(".png"):
        raise ValueError(f"the port reads PNG files only, got {path}")
    return read_png(path, gray=gray)


def _ensure_hwc(img: np.ndarray) -> np.ndarray:
    return img[..., None] if img.ndim == 2 else img


class ImageToImage2D:
    """Paired (image, mask, filename) dataset.

    ``cache="auto"`` keeps decoded (image, binarised mask) pairs in RAM when
    the estimated total fits ``cache_budget_mb``: the sets are small and
    training runs hundreds of epochs, so decoding once is enough. Random
    transforms still run per access; only the decode and binarisation are
    cached."""

    def __init__(self, dataset_path: str,
                 joint_transform: Optional[Callable] = None,
                 gray: bool = False, one_hot_mask: int = 0,
                 cache: str = "auto", cache_budget_mb: int = 2048):
        if cache not in ("auto", "on", "off"):
            raise ValueError(f"cache must be auto/on/off, got {cache!r}")
        self.dataset_path = dataset_path
        self.input_path = os.path.join(dataset_path, "img")
        self.output_path = os.path.join(dataset_path, "labelcol")
        self.images_list: List[str] = sorted(os.listdir(self.input_path))
        self.gray = gray
        self.one_hot_mask = one_hot_mask
        self.joint_transform = joint_transform
        self._cache_budget = cache_budget_mb << 20
        self._cache = {}
        self._cache_enabled: Optional[bool] = None if cache == "auto" else (
            cache == "on")

    def __len__(self):
        return len(self.images_list)

    def _decode(self, name: str):
        image = _imread(os.path.join(self.input_path, name), self.gray)
        mask_name = name[:-3] + "png"  # stem + .png (reference utils.py:154)
        mask = _imread(os.path.join(self.output_path, mask_name), True)
        if self.gray:
            image = _ensure_hwc(image)
            mask = np.where(mask >= 127, 1, 0).astype(np.uint8)
        else:
            mask = np.where(mask > 127, 1, 0).astype(np.uint8)
            image = _ensure_hwc(image)
        return image, mask

    def __getitem__(self, idx: int, rng=None):
        name = self.images_list[idx]
        cached = self._cache.get(idx)
        if cached is not None:
            image, mask = cached
        else:
            image, mask = self._decode(name)
            if self._cache_enabled is None:  # auto: decide from first item
                per_item = image.nbytes + mask.nbytes
                self._cache_enabled = (
                    per_item * len(self.images_list) <= self._cache_budget)
            if self._cache_enabled:
                self._cache[idx] = (image, mask)

        if self.joint_transform is not None:
            image, mask = self.joint_transform(image, mask, rng=rng)
        else:
            image, mask = to_float01(image), mask.astype(np.int32)
        if self.one_hot_mask:
            mask = np.eye(self.one_hot_mask, dtype=np.float32)[mask]
        return image, mask, name


class Image2D:
    """Image-only dataset for prediction (reference utils.py:179-231)."""

    def __init__(self, dataset_path: str, transform: Optional[Callable] = None,
                 gray: bool = False):
        self.input_path = os.path.join(dataset_path, "img")
        self.images_list = sorted(os.listdir(self.input_path))
        self.transform = transform
        self.gray = gray

    def __len__(self):
        return len(self.images_list)

    def __getitem__(self, idx: int):
        name = self.images_list[idx]
        image = _ensure_hwc(_imread(os.path.join(self.input_path, name),
                                    self.gray))
        if self.transform is not None:
            image = self.transform(image)
        else:
            image = to_float01(image)
        return image, name
