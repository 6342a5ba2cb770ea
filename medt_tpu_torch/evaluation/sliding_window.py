"""Batched sliding-window inference for images of another size.

Port of ``medt_tpu/evaluation/sliding_window.py``: a model trained at
``window`` resolution segments an image of any size. Windows are cut with
one gather, run in fixed batches of ``batch_size`` (the last one
zero-padded, so every forward has the same shapes), and blended back with
one ``index_add_`` over precomputed flat indices, divided by how many
windows cover each pixel. An image smaller than the window is first
reflect-padded up to it on the host with ``np.pad(mode="reflect")``, which
also takes a pad as large as the image or larger (``F.pad`` refuses one).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device


def window_grid(size: int, window: int, stride: int) -> np.ndarray:
    """Start offsets covering [0, size) with the last window right-aligned."""
    if size <= window:
        return np.array([0])
    starts = list(range(0, size - window + 1, stride))
    if starts[-1] != size - window:
        starts.append(size - window)
    return np.array(starts)


def sliding_window_inference(image: np.ndarray,
                             apply_fn: Callable[[torch.Tensor], torch.Tensor],
                             window: int, stride: Optional[int] = None,
                             batch_size: int = 16,
                             device=None) -> torch.Tensor:
    """Segment one (H, W, C) host image over (window, window) tiles.

    ``apply_fn`` maps (B, C, window, window) NCHW tiles on ``device`` to
    (B, K, window, window) logits; ``stride`` defaults to ``window``
    (non-overlapping tiles); ``device=None`` means the card. Returns the
    (K, H, W) blended logits on ``device`` (JAX returns (H, W, K))."""
    device = resolve_device(device)
    stride = stride or window
    image = np.asarray(image)
    h0, w0, _ = image.shape
    ph, pw = max(window - h0, 0), max(window - w0, 0)
    if ph or pw:
        image = np.pad(image, ((0, ph), (0, pw), (0, 0)), mode="reflect")
    h, w, c = image.shape

    ys = window_grid(h, window, stride)
    xs = window_grid(w, window, stride)
    d = np.arange(window)
    rows = ys[:, None] + d[None, :]                 # (Ty, window)
    cols = xs[:, None] + d[None, :]                 # (Tx, window)

    x = torch.from_numpy(np.ascontiguousarray(image)).to(device)
    # one gather: (Ty, window, Tx, window, C) -> (T, C, window, window)
    tiles = x[torch.as_tensor(rows, device=device)][
        :, :, torch.as_tensor(cols, device=device)]
    tiles = tiles.permute(0, 2, 4, 1, 3).reshape(-1, c, window, window)
    n_tiles = tiles.shape[0]

    outs = []
    for i in range(0, n_tiles, batch_size):
        chunk = tiles[i:i + batch_size]
        n = chunk.shape[0]
        if n < batch_size:  # one batch shape for every forward
            chunk = torch.cat([chunk, chunk.new_zeros(
                (batch_size - n,) + tuple(chunk.shape[1:]))])
        outs.append(apply_fn(chunk)[:n])
    logits = torch.cat(outs)                        # (T, K, window, window)
    k = logits.shape[1]

    # flat target pixel of every tile pixel, built once on the host
    flat = (rows[:, None, :, None] * w + cols[None, :, None, :]).reshape(-1)
    count = np.bincount(flat, minlength=h * w).astype(np.float32)
    acc = torch.zeros((k, h * w), dtype=torch.float32, device=device)
    acc.index_add_(1, torch.as_tensor(flat, device=device),
                   logits.float().permute(1, 0, 2, 3).reshape(k, -1))
    blended = acc / torch.as_tensor(count, device=device)
    return blended.reshape(k, h, w)[:, :h0, :w0]
