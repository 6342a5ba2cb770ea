"""The port's op library: norms, pooling, convs, attention and its kernels."""
from . import axial_eval, axial_lanes, axial_train, moments
from .attn_core import relative_logit_index
from .axial_attention import (
    MODE_FULL,
    MODE_GATED,
    MODE_GATED_DATA,
    MODE_GATED_SIG,
    MODE_WOPOS,
    AxialAttention,
)
from .convs import Conv2d, conv1x1, conv2d, set_compute_dtype
from .norms import BatchNorm, batch_norm_eval, batch_norm_train
from .pooling import avg_pool, max_pool_3x3_s2, upsample_bilinear_2x


def reset_launch_counts():
    """Set every kernel wrapper's launch count to 0."""
    axial_lanes.reset_launch_counts()
    moments.reset_launch_counts()
    axial_eval.reset_launch_counts()
    axial_train.reset_launch_counts()


def launch_counts() -> dict:
    """Launches of every kernel wrapper since the last reset, by name."""
    return {**axial_lanes.launch_counts(), **moments.launch_counts(),
            **axial_eval.launch_counts(), **axial_train.launch_counts()}


__all__ = [
    "AxialAttention",
    "BatchNorm",
    "Conv2d",
    "MODE_FULL",
    "MODE_GATED",
    "MODE_GATED_DATA",
    "MODE_GATED_SIG",
    "MODE_WOPOS",
    "avg_pool",
    "batch_norm_eval",
    "batch_norm_train",
    "conv1x1",
    "conv2d",
    "launch_counts",
    "max_pool_3x3_s2",
    "relative_logit_index",
    "reset_launch_counts",
    "set_compute_dtype",
    "upsample_bilinear_2x",
]
