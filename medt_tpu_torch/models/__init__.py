"""Model registry of the port.

Port of ``medt_tpu/models/__init__.py``: the four base models (axialunet,
gatedaxialunet, MedT, logo), the two 512 px MoNuSeg models (medt_512,
logo_512) and the segmentation zoo (``:77-163``: gated_sig, gated_data,
convnet_ablation, mix_net_gated_d, axialunet_wopos, unetplusplus, shallow,
autoencoder), all at layers [1, 2, 4, 1], 8 groups and width scale
s = 0.125, with the reference's frozen gates (0.1, 0.1, 0.1, 1.0) in the
gated modes and (0.1, 0.1, 0.1, 5.0) under gated_sig's sigmoid. The
zoo's classifiers (``AxialAttentionNet``, the ResNets) are not ported yet
(ROADMAP.md, section 1, item 5).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from .axial_unet import ResAxialAttentionUNet
from .blocks import AxialBlock, AxialStage
from .classifiers import ConvAutoencoder
from .medt import MedTNet, batch_to_space, space_to_batch


def _unet(mode: str, gate_init=None, **options) -> Callable[..., nn.Module]:
    """A U-Net factory: attention ``mode``, its default gates, and the zoo's
    U-Net options (``use_attention``, ``stem_mode``, ...)."""
    def factory(attn, **kw):
        attn = dict(attn, mode=mode)
        if gate_init is not None:
            attn["gate_init"] = gate_init
        return ResAxialAttentionUNet(attn=attn, **options, **kw)
    return factory


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
    # ---- the zoo (reference lib/models/model_codes.py) ----
    # sigmoid-squashed gates, frozen at (0.1, 0.1, 0.1, 5.0) unless
    # trainable_gates (model_codes.py:215-314, 241-244)
    "gated_sig": _unet("gated_sig", gate_init=(0.1, 0.1, 0.1, 5.0)),
    # per-sample gates from a GAP -> MLP head (model_codes.py:316-444)
    "gated_data": _unet("gated_data"),
    # attention-free ablation: AxialBlockmod (model_codes.py:661-716)
    "convnet_ablation": _unet("full", use_attention=False),
    # data-gated blocks in both branches of the dual-branch net
    # (model_codes.py:2306-2308 passing one block class to mix :1229-1236)
    "mix_net_gated_d": _medt("gated_data", "gated_data"),
    # position-free U-Net (resxialunet_wopos, model_codes.py:2287-2289)
    "axialunet_wopos": _unet("wopos"),
    # single-conv stem, softmax head, deep supervision (unetplus,
    # model_codes.py:1091-1227, factory :2295-2297)
    "unetplusplus": _unet("full", use_attention=False, stem_mode="single",
                          final_softmax=True, deep_supervision=True),
    # two stages (ResAxialAttentionUNetshallow, model_codes.py:2097-2222)
    "shallow": _unet("full", use_attention=False, num_stages=2),
    # conv autoencoder (model_codes.py:2224-2256): no image size, classes
    # or attention options
    "autoencoder": lambda attn, img_size, num_classes, **kw: ConvAutoencoder(
        **kw),
}
# each factory's own image size where it is not 128 (JAX: the *_512
# factories' setdefault)
DEFAULT_IMG_SIZE = {"medt_512": 512, "logo_512": 512}


def main_logits(out):
    """The main logits of a model's output: the first element of a
    deep-supervision ``(logits, aux)`` tuple, else the output itself."""
    return out[0] if isinstance(out, tuple) else out


def build_model(name: str, *, img_size: Optional[int] = None,
                imgchan: int = 3, num_classes: int = 2, use_fused: bool = False,
                plain_cores: bool = False, seed: int = 0, device=None,
                trainable_gates: bool = False, **kwargs) -> nn.Module:
    """Build a model by its reference-CLI name, in eval mode, on ``device``
    (``None`` means the card, and raises without one). ``img_size=None``
    takes the factory's own size (128; 512 for the ``*_512`` models); an
    explicit size is always honoured. Weights are drawn from the
    reference's laws with a ``torch.Generator`` seeded by ``seed``. ``use_fused`` runs the attention cores (CUDA kernels on the
    card); ``plain_cores`` makes those cores run their plain versions.
    ``trainable_gates`` trains the attention gates (the reference freezes
    them)."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{sorted(MODEL_REGISTRY)}")
    if img_size is None:
        img_size = DEFAULT_IMG_SIZE.get(name, 128)
    device = resolve_device(device)
    attn = dict(use_fused=use_fused, plain_cores=plain_cores,
                trainable_gates=trainable_gates)
    generator = torch.Generator().manual_seed(seed)
    model = MODEL_REGISTRY[name](
        img_size=img_size, imgchan=imgchan, num_classes=num_classes,
        attn=attn, generator=generator, device=device, **kwargs)
    return model.eval()


__all__ = [
    "AxialBlock",
    "ConvAutoencoder",
    "DEFAULT_IMG_SIZE",
    "AxialStage",
    "MODEL_REGISTRY",
    "MedTNet",
    "ResAxialAttentionUNet",
    "batch_to_space",
    "build_model",
    "main_logits",
    "space_to_batch",
]
