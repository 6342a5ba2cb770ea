"""Model registry of the port.

Port of ``medt_tpu/models/__init__.py:49-72``: the four live models, all
at layers [1, 2, 4, 1], 8 groups and width scale s = 0.125, with the
reference's frozen gates (0.1, 0.1, 0.1, 1.0) in the gated modes. The
zoo comes later (ROADMAP.md, 'Port: sliding window, serve CLI, data,
metrics sweep, DDP, zoo').
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from ..device import resolve_device
from .axial_unet import ResAxialAttentionUNet
from .blocks import AxialBlock, AxialStage
from .medt import MedTNet, batch_to_space, space_to_batch


def _unet(mode: str) -> Callable[..., nn.Module]:
    return lambda attn, **kw: ResAxialAttentionUNet(
        attn=dict(attn, mode=mode), **kw)


MODEL_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    # ungated axial U-Net (reference axialnet.py:714-716)
    "axialunet": _unet("full"),
    # gated axial U-Net (reference 'gated', axialnet.py:718-720)
    "gatedaxialunet": _unet("gated"),
    # gated global branch + position-free local branch (axialnet.py:722-724)
    "MedT": lambda **kw: MedTNet(global_mode="gated", local_mode="wopos",
                                 **kw),
    # plain axial blocks in both branches (axialnet.py:726-728)
    "logo": lambda **kw: MedTNet(global_mode="full", local_mode="full", **kw),
}


def build_model(name: str, *, img_size: int = 128, imgchan: int = 3,
                num_classes: int = 2, use_fused: bool = False,
                plain_cores: bool = False, seed: int = 0, device=None,
                **kwargs) -> nn.Module:
    """Build a model by its reference-CLI name, in eval mode, on ``device``
    (``None`` means the card, and raises without one). Weights are drawn
    from the reference's laws with a ``torch.Generator`` seeded by
    ``seed``. ``use_fused`` runs the attention cores (CUDA kernels on the
    card); ``plain_cores`` makes those cores run their plain versions."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{sorted(MODEL_REGISTRY)}")
    device = resolve_device(device)
    attn = dict(use_fused=use_fused, plain_cores=plain_cores)
    generator = torch.Generator().manual_seed(seed)
    model = MODEL_REGISTRY[name](
        img_size=img_size, imgchan=imgchan, num_classes=num_classes,
        attn=attn, generator=generator, device=device, **kwargs)
    return model.eval()


__all__ = [
    "AxialBlock",
    "AxialStage",
    "MODEL_REGISTRY",
    "MedTNet",
    "ResAxialAttentionUNet",
    "batch_to_space",
    "build_model",
    "space_to_batch",
]
