"""The port's op library: norms, pooling, convs, attention and its kernels."""
from .axial_attention import (
    MODE_FULL,
    MODE_GATED,
    MODE_GATED_DATA,
    MODE_GATED_SIG,
    MODE_WOPOS,
    AxialAttention,
    relative_logit_index,
)
from .convs import conv1x1, conv2d
from .norms import BatchNorm, batch_norm_eval
from .pooling import avg_pool, upsample_bilinear_2x

__all__ = [
    "AxialAttention",
    "BatchNorm",
    "MODE_FULL",
    "MODE_GATED",
    "MODE_GATED_DATA",
    "MODE_GATED_SIG",
    "MODE_WOPOS",
    "avg_pool",
    "batch_norm_eval",
    "conv1x1",
    "conv2d",
    "relative_logit_index",
    "upsample_bilinear_2x",
]
