"""Logging helpers.

Port of ``medt_tpu/utils/logging.py``: ``chk_mkdir``, ``Logger``
(dict-of-lists with CSV export, reference utils.py:245-261, plus JSONL
streaming) and ``ThroughputMeter`` (the reference's per-batch timer is
commented out, reference train.py:183-186). The JAX package's
``profiler_trace`` comes with the port's trainer.
"""
from __future__ import annotations

import csv
import json
import os
import time
from collections import defaultdict
from typing import Optional


def chk_mkdir(*paths: str) -> None:
    """Create directories if missing (reference utils.py:233-242)."""
    for path in paths:
        os.makedirs(path, exist_ok=True)


class Logger:
    """Accumulates scalar logs; exports CSV; optionally streams JSONL."""

    def __init__(self, verbose: bool = False, jsonl_path: Optional[str] = None):
        self.logs = defaultdict(list)
        self.verbose = verbose
        self.jsonl_path = jsonl_path
        if jsonl_path:
            chk_mkdir(os.path.dirname(os.path.abspath(jsonl_path)))

    def log(self, entries: dict) -> None:
        for key, value in entries.items():
            self.logs[key].append(value)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(entries, default=float) + "\n")
        if self.verbose:
            print(entries)

    def get_logs(self):
        return self.logs

    def to_csv(self, path: str) -> None:
        keys = list(self.logs.keys())
        rows = zip(*(self.logs[k] for k in keys)) if keys else []
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(keys)
            writer.writerows(rows)


class ThroughputMeter:
    """imgs/sec + steps/sec with a sliding window."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._imgs = 0
        self._steps = 0

    def update(self, n_imgs: int):
        self._imgs += n_imgs
        self._steps += 1

    @property
    def imgs_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._imgs / dt if dt > 0 else 0.0

    @property
    def steps_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else 0.0
