"""Convolutions with the reference's default initialization.

Port of ``medt_tpu/ops/convs.py``: torch-style ``Conv2d`` with explicit
symmetric padding (``kernel_size // 2`` by default: "same" at stride 1, the
reference's floor-division output size at stride 2), weights and bias drawn
from ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` through a ``torch.Generator``.
These convolutions lie outside every Pallas kernel of the JAX package, so
they stay ``torch.nn.Conv2d``: :class:`Conv2d` only adds a compute dtype.

The compute dtype (:func:`set_compute_dtype`; ``build_model(dtype=...)``)
is JAX's ``dtype=..., param_dtype=float32``: the parameters stay float32
masters, and a module with ``compute_dtype`` set casts its input and its
weights to it at the call and returns that dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .initializers import uniform_by_fan


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` when it is set (None:
    the parameters' float32)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(cd)
        return self._conv_forward(x.to(cd), self.weight.to(cd), bias)


def set_compute_dtype(module: nn.Module,
                      dtype: Optional[torch.dtype]) -> nn.Module:
    """Set the compute dtype of every submodule that has one (the convs and
    the attention modules); the parameters keep their float32."""
    for m in module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return module


def conv2d(in_features: int, features: int, kernel_size: int,
           stride: int = 1, padding: Optional[int] = None,
           use_bias: bool = True, *, dilation: int = 1,
           generator: Optional[torch.Generator] = None,
           device=None) -> Conv2d:
    """A :class:`Conv2d` drawn from the reference's default law; padding
    ``(kernel_size // 2) * dilation`` by default."""
    if padding is None:
        padding = (kernel_size // 2) * dilation
    conv = Conv2d(in_features, features, kernel_size, stride=stride,
                  padding=padding, dilation=dilation, bias=use_bias,
                  device=device, dtype=torch.float32)
    fan_in = in_features * kernel_size * kernel_size
    uniform_by_fan(conv.weight, fan_in, generator)
    if use_bias:
        uniform_by_fan(conv.bias, fan_in, generator)
    return conv


def conv1x1(in_features: int, features: int, stride: int = 1, *,
            generator: Optional[torch.Generator] = None,
            device=None) -> Conv2d:
    """1x1 conv, no bias (reference axialnet.py:14-16)."""
    return conv2d(in_features, features, 1, stride=stride, padding=0,
                  use_bias=False, generator=generator, device=device)
