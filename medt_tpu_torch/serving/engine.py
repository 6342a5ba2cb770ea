"""Batched inference engine of the port.

Port of ``medt_tpu/serving/engine.py``:

* fixed-shape batching: requests are padded up to ``batch_size`` so every
  forward runs the same shapes (on the card: the same kernel launches);
* dynamic micro-batching: ``submit`` enqueues single images and a worker
  thread coalesces the queue into batches, waiting at most ``max_wait_ms``
  for peers;
* priorities: lower ``priority`` is served first, FIFO within a priority;
* backpressure: ``submit`` raises :class:`QueueFullError` at ``max_queue``
  pending requests;
* uint8 images travel to the device as bytes and are normalized there
  (f32 / 255, the training pipeline's convention).

Images are (H, W, C) arrays as in the JAX engine (C = 1 with ``gray``);
the model sees NCHW. ``predict`` sends an image of any other size than
``imgsize`` through the sliding window (larger ones tiled, smaller ones
reflect-padded up to the window) at ``window_stride`` (default: the
window, non-overlapping tiles), as the JAX engine does. The weights come
from ``loaddirec`` (a checkpoint of the port's ``save_checkpoint`` or a
reference ``.pth``) or from ``variables``. A model that returns a
deep-supervision tuple serves its main logits.

Several cards (JAX's ``mesh``, whose first axis shards each compiled
batch): ``devices=[...]`` holds one replica of the model per device, the
same weights on each. Every fixed-shape batch, and every tile batch of the
sliding window, is split into equal parts, one a replica, and the logits
are gathered on the first device; ``batch_size`` must divide by the
replica count. The replicas run one after another from the calling
thread: on separate cards their device work overlaps, their host dispatch
does not.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..evaluation.sliding_window import sliding_window_inference
from ..metrics import logits_to_foreground
from ..models import build_model, main_logits
from ..training.checkpointing import restore_checkpoint


class QueueFullError(RuntimeError):
    """submit() backpressure: the bounded request queue is at capacity."""


class InferenceEngine:
    """Fixed-shape batched segmentation inference with dynamic batching.

    Args:
      modelname: a factory name of ``medt_tpu_torch.models``.
      imgsize: the model's resolution (the batch shape).
      loaddirec: a checkpoint to restore (a ``ckpt.pth`` file, its
        directory, or a reference ``.pth`` file); or
      variables: a reference-format state dict (numpy arrays or tensors),
        loaded with ``load_state_dict(strict=True)``.
      batch_size: the fixed batch; requests are padded up to it.
      gray: single-channel images (the model is built with one input
        channel).
      use_fused: the fused attention path (the CUDA kernels on the card;
        ``--use_pallas`` of the serve CLI).
      decision: "threshold" (reference quirk) or "argmax".
      window_stride: the sliding window's stride for images of another
        size (default: ``imgsize``, non-overlapping tiles).
      max_wait_ms: coalescing window of the micro-batching worker.
      max_queue: pending ``submit`` requests before QueueFullError.
      plain_cores: run the attention cores' plain versions on the card (the
        reference the kernels are held against).
      dtype: the compute dtype (``torch.bfloat16``: bf16 activations around
        float32 weights, as JAX's engine ``dtype``); the logits come back
        in it.
      device: ``None`` means the card, and raises without one.
      devices: one replica per entry (``"cuda:0"``, ``"cuda:1"``, ... or
        ``"cpu"``; one card may appear twice); overrides ``device``, and
        the first one is ``self.device``, where the logits land.
    """

    def __init__(self, modelname: str, imgsize: int,
                 loaddirec: Optional[str] = None,
                 variables: Optional[Mapping] = None, batch_size: int = 16,
                 gray: bool = False, use_fused: bool = True,
                 decision: str = "threshold",
                 window_stride: Optional[int] = None,
                 max_wait_ms: float = 5.0, max_queue: int = 1024,
                 plain_cores: bool = False,
                 dtype: torch.dtype = torch.float32, device=None,
                 devices: Optional[Sequence] = None):
        devices = [torch.device(d) for d in devices] if devices \
            else [resolve_device(device)]
        self.device = devices[0]
        if variables is None and loaddirec is None:
            raise ValueError("need loaddirec or variables")
        self.imgsize = int(imgsize)
        self.batch_size = int(batch_size)
        if self.batch_size % len(devices):
            raise ValueError(
                f"batch_size {self.batch_size} must divide by the mesh "
                f"'data' axis ({len(devices)})")
        self.channels = 1 if gray else 3
        self.decision = decision
        self.window_stride = int(window_stride or imgsize)
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue = int(max_queue)

        self.replicas = [build_model(
            modelname, img_size=self.imgsize, imgchan=self.channels,
            use_fused=use_fused, plain_cores=plain_cores, dtype=dtype,
            device=d) for d in devices]
        self.model = self.replicas[0]
        if variables is None:
            restore_checkpoint(loaddirec, self.model)
        else:
            self.model.load_state_dict(
                {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                    else v) for k, v in variables.items()},
                strict=True)
        for replica in self.replicas[1:]:
            replica.load_state_dict(self.model.state_dict(), strict=True)

        # (priority, seq, image, future): priority first, then FIFO
        self._queue: "queue.PriorityQueue" = queue.PriorityQueue()
        self._seq = itertools.count()
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._forward_lock = threading.Lock()  # one forward at a time
        self.batches_run = 0
        self.images_run = 0
        self._latencies: deque = deque(maxlen=1024)  # seconds, last N

    # ---- synchronous API ---------------------------------------------------

    def logits(self, images: Sequence[np.ndarray]) -> torch.Tensor:
        """Raw (B, classes, S, S) logits of up to ``batch_size`` images,
        padded to the fixed batch; stays on the device."""
        chunk = [self._check(im) for im in images]
        if not 1 <= len(chunk) <= self.batch_size:
            raise ValueError(f"1..{self.batch_size} images per batch, got "
                             f"{len(chunk)}")
        chunk += [chunk[-1]] * (self.batch_size - len(chunk))
        x = torch.from_numpy(np.stack(chunk)).to(self.device)
        x = x.permute(0, 3, 1, 2)
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        with self._forward_lock, torch.inference_mode():
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """The model's logits; the main logits of a deep-supervision tuple
        (JAX: ``medt_tpu/serving/engine.py:124-131``). With several
        replicas each takes an equal part of the batch and the logits are
        gathered on ``self.device``."""
        if len(self.replicas) == 1:
            return main_logits(self.model(x))
        parts = x.chunk(len(self.replicas))
        return torch.cat([
            main_logits(m(p.to(next(m.parameters()).device))).to(self.device)
            for m, p in zip(self.replicas, parts)])

    def warmup(self):
        """One forward ahead of the first request."""
        zeros = np.zeros((self.imgsize, self.imgsize, self.channels),
                         np.uint8)
        self.logits([zeros])
        for replica in self.replicas:
            device = next(replica.parameters()).device
            if device.type == "cuda":
                torch.cuda.synchronize(device)

    def predict_batch(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Segment (S, S, C) images at the model's resolution, in padded
        fixed-shape chunks: one (S, S) uint8 {0, 1} mask per image."""
        masks: List[np.ndarray] = []
        for i in range(0, len(images), self.batch_size):
            chunk = images[i:i + self.batch_size]
            fg = logits_to_foreground(self.logits(chunk), mode=self.decision)
            masks.extend(fg.to(torch.uint8).cpu().numpy()[:len(chunk)])
            with self._lock:
                self.batches_run += 1
                self.images_run += len(chunk)
        return masks

    def predict(self, image: np.ndarray) -> np.ndarray:
        """Segment one (H, W, C) image of any size: at the model's
        resolution as a batch, otherwise through the sliding window at
        ``window_stride``."""
        if image.ndim == 2:
            image = image[..., None]
        h, w = image.shape[:2]
        if (h, w) == (self.imgsize, self.imgsize):
            return self.predict_batch([image])[0]
        if image.shape[2] != self.channels:
            raise ValueError(f"images have {self.channels} channels; got "
                             f"{image.shape}")
        x = image.astype(np.float32)
        if image.dtype == np.uint8:
            x = x / np.float32(255.0)
        with self._forward_lock, torch.inference_mode():
            logits = sliding_window_inference(
                x, self._forward, window=self.imgsize,
                stride=self.window_stride, batch_size=self.batch_size,
                device=self.device)
            fg = logits_to_foreground(logits[None], mode=self.decision)[0]
        with self._lock:
            self.images_run += 1
        return fg.to(torch.uint8).cpu().numpy()

    # ---- dynamic micro-batching --------------------------------------------

    def start(self):
        """Start the coalescing worker for ``submit``."""
        if self._worker is not None:
            return
        self._stop.clear()
        self._worker = threading.Thread(target=self._serve_loop, daemon=True)
        self._worker.start()

    def stop(self):
        if self._worker is None:
            return
        self._stop.set()
        # the sentinel sorts ahead of every real entry: stop is prompt even
        # under a deep low-priority backlog
        self._queue.put((float("-inf"), -1, None, None))
        self._worker.join()
        self._worker = None

    def submit(self, image: np.ndarray,
               priority: int = 0) -> "Future[np.ndarray]":
        """Enqueue one image; returns a Future of its mask. Lower
        ``priority`` is served first."""
        if self._worker is None:
            raise RuntimeError("engine not started; call start()")
        if self._queue.qsize() >= self.max_queue:
            raise QueueFullError(
                f"serving queue at capacity ({self.max_queue})")
        fut: "Future[np.ndarray]" = Future()
        t0 = time.perf_counter()
        fut.add_done_callback(
            lambda f: self._latencies.append(time.perf_counter() - t0))
        self._queue.put((priority, next(self._seq), self._check(image), fut))
        return fut

    def stats(self) -> dict:
        """Counters plus request-latency percentiles (enqueue -> result,
        last 1024 ``submit`` requests), in milliseconds."""
        out = {"batches_run": self.batches_run, "images_run": self.images_run,
               "batch_size": self.batch_size, "imgsize": self.imgsize}
        lat = sorted(self._latencies)
        if lat:
            def pct(p):
                return lat[min(len(lat) - 1, int(p / 100.0 * len(lat)))] * 1e3
            out["latency_ms"] = {"count": len(lat), "p50": pct(50),
                                 "p90": pct(90), "p99": pct(99)}
        return out

    def _serve_loop(self):
        while not self._stop.is_set():
            item = self._queue.get()
            if item[2] is None:
                continue
            batch = [item]
            while len(batch) < self.batch_size:
                try:
                    nxt = self._queue.get(timeout=self.max_wait_ms / 1e3)
                except queue.Empty:
                    break
                if nxt[2] is None:
                    break
                batch.append(nxt)
            futures = [b[3] for b in batch]
            try:
                masks = self.predict_batch([b[2] for b in batch])
            except Exception as e:  # the worker must outlive a bad batch
                for f in futures:
                    f.set_exception(e)
                continue
            for f, m in zip(futures, masks):
                f.set_result(m)

    # ---- helpers ------------------------------------------------------------

    def _check(self, image: np.ndarray) -> np.ndarray:
        if image.ndim == 2:
            image = image[..., None]
        s, c = self.imgsize, self.channels
        if image.shape != (s, s, c):
            raise ValueError(
                f"batches take ({s}, {s}, {c}) images; got {image.shape}")
        return image
