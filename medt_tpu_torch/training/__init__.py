"""Training of the port: optimizers, schedules, the train step,
checkpoints."""
from .checkpointing import restore_checkpoint, save_checkpoint
from .optimizers import OPTIMIZER_REGISTRY, adam_l2, build_optimizer, sgd
from .schedules import (
    SCHEDULE_REGISTRY,
    constant,
    warmup_cosine,
    warmup_staircase,
)
from .state import TrainState, eval_step, normalize, train_step

__all__ = [
    "OPTIMIZER_REGISTRY",
    "SCHEDULE_REGISTRY",
    "TrainState",
    "adam_l2",
    "build_optimizer",
    "constant",
    "eval_step",
    "normalize",
    "restore_checkpoint",
    "save_checkpoint",
    "sgd",
    "train_step",
    "warmup_cosine",
    "warmup_staircase",
]
