"""Model registry of the port.

Port of ``medt_tpu/models/__init__.py:27-72`` and ``:105-119``: the four
base models (axialunet, gatedaxialunet, MedT, logo) and the two 512 px
MoNuSeg models (medt_512, logo_512), all at layers [1, 2, 4, 1], 8 groups
and width scale s = 0.125, with the reference's frozen gates (0.1, 0.1,
0.1, 1.0) in the gated modes. The rest of JAX's zoo is not ported yet
(ROADMAP.md, section 1, item 9).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from .axial_unet import ResAxialAttentionUNet
from .blocks import AxialBlock, AxialStage
from .medt import MedTNet, batch_to_space, space_to_batch


def _unet(mode: str) -> Callable[..., nn.Module]:
    return lambda attn, **kw: ResAxialAttentionUNet(
        attn=dict(attn, mode=mode), **kw)


def _medt(global_mode: str, local_mode: str) -> Callable[..., nn.Module]:
    return lambda **kw: MedTNet(global_mode=global_mode,
                                local_mode=local_mode, **kw)


MODEL_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    # ungated axial U-Net (reference axialnet.py:714-716)
    "axialunet": _unet("full"),
    # gated axial U-Net (reference 'gated', axialnet.py:718-720)
    "gatedaxialunet": _unet("gated"),
    # gated global branch + position-free local branch (axialnet.py:722-724)
    "MedT": _medt("gated", "wopos"),
    # plain axial blocks in both branches (axialnet.py:726-728)
    "logo": _medt("full", "full"),
    # the 512 px MoNuSeg MedT: 4x4 grid of 128 px patches (mix_512,
    # model_codes.py:1894-2096)
    "medt_512": _medt("gated", "wopos"),
    # the 512 px logo (mix_net_512, model_codes.py:2306-2308)
    "logo_512": _medt("full", "full"),
}
# each factory's own image size where it is not 128 (JAX: the *_512
# factories' setdefault)
DEFAULT_IMG_SIZE = {"medt_512": 512, "logo_512": 512}


def build_model(name: str, *, img_size: Optional[int] = None,
                imgchan: int = 3, num_classes: int = 2, use_fused: bool = False,
                plain_cores: bool = False, seed: int = 0, device=None,
                **kwargs) -> nn.Module:
    """Build a model by its reference-CLI name, in eval mode, on ``device``
    (``None`` means the card, and raises without one). ``img_size=None``
    takes the factory's own size (128; 512 for the ``*_512`` models); an
    explicit size is always honoured. Weights are drawn from the
    reference's laws with a ``torch.Generator`` seeded by ``seed``. ``use_fused`` runs the attention cores (CUDA kernels on the
    card); ``plain_cores`` makes those cores run their plain versions."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{sorted(MODEL_REGISTRY)}")
    if img_size is None:
        img_size = DEFAULT_IMG_SIZE.get(name, 128)
    device = resolve_device(device)
    attn = dict(use_fused=use_fused, plain_cores=plain_cores)
    generator = torch.Generator().manual_seed(seed)
    model = MODEL_REGISTRY[name](
        img_size=img_size, imgchan=imgchan, num_classes=num_classes,
        attn=attn, generator=generator, device=device, **kwargs)
    return model.eval()


__all__ = [
    "AxialBlock",
    "DEFAULT_IMG_SIZE",
    "AxialStage",
    "MODEL_REGISTRY",
    "MedTNet",
    "ResAxialAttentionUNet",
    "batch_to_space",
    "build_model",
    "space_to_batch",
]
