"""Prefetching batch loader.

Port of ``medt_tpu/data/loader.py``: samples are decoded and augmented in a
thread pool, collated into dense NHWC numpy batches and queued ahead of the
consumer; each sample's ``np.random.Generator`` is seeded by (seed, epoch,
index), so a seed gives the JAX loader's batches in the same order
regardless of worker scheduling.

In place of JAX's ``prefetch_to_device``, :func:`to_device` moves a batch
with ``non_blocking`` copies from pinned host memory, so the copy overlaps
the device work already queued.
"""
from __future__ import annotations

import inspect
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch


def collate(samples):
    """Stack (image, mask, name) samples into a batch dict."""
    images = np.stack([s[0] for s in samples])
    masks = np.stack([s[1] for s in samples])
    names = [s[2] for s in samples]
    return {"image": images, "label": masks, "name": names}


def to_device(batch: dict, device) -> dict:
    """The batch's arrays as tensors on ``device``: on a card, copied from
    pinned memory without blocking the host; names stay as they are."""
    device = torch.device(device)
    out = {}
    for key, value in batch.items():
        if isinstance(value, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(value))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[key] = t
        else:
            out[key] = value
    return out


class DataLoader:
    """Iterable over shuffled, prefetched batches.

    Args:
      dataset: object with ``__len__`` and ``__getitem__(idx, rng=...)``.
      batch_size: samples per batch (the last one may be short, as in the
        reference).
      shuffle: reshuffle each epoch.
      num_workers: decode threads (0 = synchronous).
      seed: base seed; per-sample rng = seed + epoch * len + idx.
      prefetch: max batches queued ahead.
    """

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 3000, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0
        try:
            params = inspect.signature(dataset.__getitem__).parameters
            self._rng_kwarg = "rng" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params.values())
        except (TypeError, ValueError):
            self._rng_kwarg = False

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _fetch(self, idx: int) -> tuple:
        if not self._rng_kwarg:
            return self.dataset[idx]
        rng = np.random.default_rng(
            self.seed + self.epoch * len(self.dataset) + idx)
        return self.dataset.__getitem__(idx, rng=rng)

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, n, self.batch_size)]

        if self.num_workers <= 0:
            for b in batches:
                yield collate([self._fetch(int(i)) for i in b])
            self.epoch += 1
            return

        out: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                for b in batches:
                    if stop.is_set():
                        return
                    samples = list(pool.map(self._fetch, [int(i) for i in b]))
                    while not stop.is_set():  # the consumer may have quit
                        try:
                            out.put(collate(samples), timeout=0.5)
                            break
                        except queue.Full:
                            continue
            out.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()
        self.epoch += 1
