"""Learning-rate schedules: plain ``step -> lr`` functions.

Port of ``medt_tpu/training/schedules.py`` (the reference's
``adjust_learning_rate``, lib/utils.py:7-30): linear warmup by fractional
epoch, then a per-step cosine decay ("cosine") or the 30/60/90-epoch
staircase ("linear"); the segmentation script's constant rate
("constant"). ``step`` counts the updates made before this one.
"""
from __future__ import annotations

import math


def constant(base_lr: float):
    return lambda step: float(base_lr)


def warmup_cosine(base_lr: float, steps_per_epoch: int, total_epochs: int,
                  warmup_epochs: int = 0):
    """Cosine decay over the post-warmup steps (lib/utils.py:20-26)."""
    warmup_steps = warmup_epochs * steps_per_epoch
    total_steps = max((total_epochs - warmup_epochs) * steps_per_epoch, 1)

    def sched(step: int) -> float:
        if step < warmup_steps:
            return base_lr * (step + 1.0) / max(float(warmup_steps), 1.0)
        t = min(max((step - warmup_steps) / float(total_steps), 0.0), 1.0)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * t))

    return sched


def warmup_staircase(base_lr: float, steps_per_epoch: int,
                     warmup_epochs: int = 0):
    """x1 / x0.1 / x0.01 / x0.001 at 30/60/90 epochs past the warmup
    (lib/utils.py:11-19)."""
    warmup_steps = warmup_epochs * steps_per_epoch

    def sched(step: int) -> float:
        if step < warmup_steps:
            return base_lr * (step + 1.0) / max(float(warmup_steps), 1.0)
        epoch = (step - warmup_steps) / float(steps_per_epoch)
        factor = (1.0 if epoch < 30 else 1e-1 if epoch < 60
                  else 1e-2 if epoch < 90 else 1e-3)
        return base_lr * factor

    return sched


SCHEDULE_REGISTRY = {
    "constant": constant,
    "cosine": warmup_cosine,
    "linear": warmup_staircase,
}
