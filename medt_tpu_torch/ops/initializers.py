"""Parameter initialization laws of the reference, driven by a
``torch.Generator``.

Port of ``medt_tpu/ops/initializers.py``. The reference relies on torch's
default conv init, ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for weight and
bias, plus two custom rules (reference axialnet.py:94-97):
``qkv_transform.weight ~ N(0, 1/in_planes)`` and
``relative ~ N(0, 1/group_planes)`` — :func:`normal_by_fan`.

Draws differ from the JAX package's (different generators); only the laws
are the same. Tests that compare the two carry weights across instead.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def normal_by_fan(tensor: torch.Tensor, fan: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """In place: ``N(0, sqrt(1/fan))``."""
    with torch.no_grad():
        draw = torch.randn(tensor.shape, generator=generator,
                           dtype=torch.float32)
        tensor.copy_(draw * math.sqrt(1.0 / fan))
    return tensor


def uniform_by_fan(tensor: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """In place: ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` — torch's default
    conv weight and bias law (kaiming_uniform with a=sqrt(5))."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        draw = torch.rand(tensor.shape, generator=generator,
                          dtype=torch.float32)
        tensor.copy_(draw * (2 * bound) - bound)
    return tensor
