"""Joint image/mask augmentation (numpy).

Port of ``medt_tpu/data/transforms.py``, a numpy copy: random crop,
horizontal flip, optional colour jitter (image only), optional random
affine, and long-mask label encoding, driven by an explicit
``np.random.Generator`` so a seed gives the JAX package's samples exactly.
The JAX package's native colour jitter (``native/medt_io.cpp``) is left
out: the numpy chain here is its reference and draws the same factors.

Images come out float32 in [0, 1] channel-last (HWC), as in JAX; the
port's models take NCHW, and the loader's consumer transposes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


def to_float01(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC in [0,1] (torchvision to_tensor scaling)."""
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return img.astype(np.float32)


def _rand_crop_params(rng, h, w, ch, cw):
    i = int(rng.integers(0, h - ch + 1)) if h > ch else 0
    j = int(rng.integers(0, w - cw + 1)) if w > cw else 0
    return i, j


def _adjust_brightness(img, factor):
    return np.clip(img * factor, 0.0, 1.0)


def _adjust_contrast(img, factor):
    mean = img.mean()
    return np.clip((img - mean) * factor + mean, 0.0, 1.0)


def _adjust_saturation(img, factor):
    gray = img.mean(axis=-1, keepdims=True)
    return np.clip((img - gray) * factor + gray, 0.0, 1.0)


def _rgb_to_hsv(rgb):
    """Vectorized RGB->HSV on float [0,1] HWC arrays (colorsys semantics)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = np.max(rgb, axis=-1)
    minc = np.min(rgb, axis=-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    safe = np.maximum(delta, 1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = np.where(r == maxc, bc - gc,
                 np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    return np.stack([h, s, v], axis=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int64) % 6
    choices = [
        np.stack([v, t, p], -1), np.stack([q, v, p], -1),
        np.stack([p, v, t], -1), np.stack([p, q, v], -1),
        np.stack([t, p, v], -1), np.stack([v, p, q], -1),
    ]
    out = np.select([i[..., None] == k for k in range(6)], choices)
    return out


def _adjust_hue(img, factor):
    """Shift hue by ``factor`` (in turns, torchvision convention |f| <= 0.5).

    Float-precision HSV round trip (the reference's PIL path quantizes H to
    uint8; we keep full precision — documented divergence).
    """
    if img.shape[-1] != 3 or factor == 0.0:
        return img
    hsv = _rgb_to_hsv(img)
    hsv[..., 0] = (hsv[..., 0] + factor) % 1.0
    return np.clip(_hsv_to_rgb(hsv), 0.0, 1.0).astype(img.dtype)


def random_affine_params(rng, size, degrees=(-90.0, 90.0),
                         translate=(1.0, 1.0), scale_ranges=(2.0, 2.0),
                         shears=(-45.0, 45.0)):
    """Sample (angle, (tx, ty), scale, shear) exactly as the reference's
    ``T.RandomAffine(180).get_params((-90, 90), (1, 1), (2, 2), (-45, 45),
    crop)`` call (reference utils.py:88)."""
    h, w = size
    angle = float(rng.uniform(*degrees))
    tx = int(round(float(rng.uniform(-translate[0] * w, translate[0] * w))))
    ty = int(round(float(rng.uniform(-translate[1] * h, translate[1] * h))))
    scale = float(rng.uniform(*scale_ranges))
    shear = float(rng.uniform(*shears))
    return angle, (tx, ty), scale, shear


def _inverse_affine_matrix(center, angle, translate, scale, shear):
    """Inverse affine map (output pixel -> input pixel), torchvision's
    center-rotate-shear-scale-translate composition."""
    rot = np.radians(angle)
    sx, sy = np.radians(shear), 0.0
    cx, cy = center
    tx, ty = translate
    a = np.cos(rot - sy) / np.cos(sy)
    b = -np.cos(rot - sy) * np.tan(sx) / np.cos(sy) - np.sin(rot)
    c = np.sin(rot - sy) / np.cos(sy)
    d = -np.sin(rot - sy) * np.tan(sx) / np.cos(sy) + np.cos(rot)
    m = [d / scale, -b / scale, 0.0, -c / scale, a / scale, 0.0]
    m[2] += m[0] * (-cx - tx) + m[1] * (-cy - ty)
    m[5] += m[3] * (-cx - tx) + m[4] * (-cy - ty)
    m[2] += cx
    m[5] += cy
    return m


def affine_nearest(arr, angle, translate=(0, 0), scale=1.0, shear=0.0,
                   fill=0.0):
    """Joint-transform affine warp: one inverse-map nearest resample.

    Nearest keeps masks label-valued (the PIL default resample the reference
    relies on, reference utils.py:89); works on HW or HWC arrays.
    """
    h, w = arr.shape[:2]
    cy, cx = h * 0.5, w * 0.5
    m = _inverse_affine_matrix((cx, cy), angle, translate, scale, shear)
    ys, xs = np.mgrid[0:h, 0:w]
    # map output pixel centers through the inverse matrix
    src_x = m[0] * (xs + 0.5) + m[1] * (ys + 0.5) + m[2]
    src_y = m[3] * (xs + 0.5) + m[4] * (ys + 0.5) + m[5]
    ix = np.floor(src_x).astype(np.int64)
    iy = np.floor(src_y).astype(np.int64)
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    ix = np.clip(ix, 0, w - 1)
    iy = np.clip(iy, 0, h - 1)
    out = arr[iy, ix]
    if arr.ndim == 3:
        out = np.where(valid[..., None], out, np.asarray(fill, arr.dtype))
    else:
        out = np.where(valid, out, np.asarray(fill, arr.dtype))
    return out


@dataclass
class JointTransform2D:
    """Applies the same geometric transform to image and mask.

    Args mirror the reference (utils.py:60-68): ``crop`` (size tuple or
    None), ``p_flip``, ``color_jitter_params`` (brightness, contrast,
    saturation, hue), ``p_random_affine`` (full joint RandomAffine — the
    reference samples angle in (-90, 90), translate up to the full extent,
    scale exactly 2, shear in (-45, 45), reference utils.py:88-89; applied
    to image and mask with one nearest-resample inverse warp),
    ``long_mask`` (int labels instead of float mask).
    """

    crop: Optional[Tuple[int, int]] = (32, 32)
    p_flip: float = 0.5
    color_jitter_params: Optional[Tuple[float, float, float, float]] = (
        0.1, 0.1, 0.1, 0.1)
    p_random_affine: float = 0.0
    long_mask: bool = False
    # "uint8" keeps byte images end to end when no color jitter is active:
    # crop/flip/affine are dtype-agnostic, and the uint8 -> f32/255
    # normalization moves to the device (training/state.py::normalize) —
    # 4x fewer bytes over the host->device link per batch
    output_dtype: str = "float32"

    def __call__(self, image: np.ndarray, mask: np.ndarray, rng=None):
        rng = rng if rng is not None else np.random.default_rng()
        keep_uint8 = (self.output_dtype == "uint8"
                      and image.dtype == np.uint8
                      and not self.color_jitter_params)
        if not keep_uint8:
            image = to_float01(image)
        if image.ndim == 2:
            image = image[..., None]
        if mask.ndim == 3:
            mask = mask[..., 0]

        if self.crop:
            ch, cw = self.crop
            i, j = _rand_crop_params(rng, image.shape[0], image.shape[1], ch, cw)
            image = image[i:i + ch, j:j + cw]
            mask = mask[i:i + ch, j:j + cw]

        if rng.random() < self.p_flip:
            image = image[:, ::-1]
            mask = mask[:, ::-1]

        if self.color_jitter_params:
            b, c, s, h = self.color_jitter_params
            # factors sampled up front in a fixed order (the JAX package's
            # native and numpy paths consume identical rng draws)
            fb = 1.0 + rng.uniform(-b, b)
            fc = 1.0 + rng.uniform(-c, c)
            if image.shape[-1] == 3:
                fs = 1.0 + rng.uniform(-s, s)
                fh = float(rng.uniform(-h, h))
            else:
                fs, fh = 1.0, 0.0
            image = _adjust_brightness(image, fb)
            image = _adjust_contrast(image, fc)
            if image.shape[-1] == 3:
                image = _adjust_saturation(image, fs)
                image = _adjust_hue(image, fh)

        if self.p_random_affine and rng.random() < self.p_random_affine:
            angle, tr, scale, shear = random_affine_params(
                rng, image.shape[:2])
            image = affine_nearest(image, angle, tr, scale, shear)
            mask = affine_nearest(mask, angle, tr, scale, shear)

        image = np.ascontiguousarray(
            image, np.uint8 if keep_uint8 else np.float32)
        if self.long_mask:
            # in byte-pipeline mode int labels also ship as uint8 (class
            # ids are tiny); the device step widens them
            mask = np.ascontiguousarray(
                mask, np.uint8 if (self.output_dtype == "uint8"
                                   and mask.dtype == np.uint8) else np.int32)
        else:
            mask = np.ascontiguousarray(to_float01(mask), np.float32)
        return image, mask
