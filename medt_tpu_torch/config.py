"""Typed configuration shared by the port's CLIs.

Port of ``medt_tpu/config.py``: the same dataclass, flags and defaults, so
one argv works for the JAX package's CLIs and the port's. The reference's
two drifting argparse blocks (train.py:30-64 vs test.py:28-58, whose drift
leaves test.py reading an ``--aug`` flag it never defines) become one.
Flags the reference parses but ignores are honoured: ``--workers``,
``--weight-decay``.

What differs in the port: ``--use_pallas yes`` selects its fused attention
(``use_fused``, CUDA kernels on the card). ``--dp N`` is the data axis:
``cli.train`` trains on N ranks, ``cli.serve`` serves from N replicas
(more than the visible cards raises, as JAX's serve CLI does). ``--tp M``
is the model axis: ``cli.train`` splits every attention layer's groups
over M ranks a data index, on ``dp * M`` ranks in all (under torchrun,
``dp * M`` must equal the world size), and ``--num_slices`` pins the
number of nodes the data axis spans (:func:`.parallel.make_mesh`). The
seq axis (``--sp``) takes only 1, and ``--platform`` (JAX's backend
override) is rejected. ``--dtype
bfloat16`` computes the activations in bf16 with float32 parameters
(:attr:`Config.compute_dtype`, JAX's ``setup_state`` mapping), and
``--remat`` recomputes the forward in the backward.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from .parallel.mesh import MESH_TODO, check_mesh


@dataclass
class Config:
    # data
    train_dataset: Optional[str] = None
    val_dataset: Optional[str] = None
    crop: Optional[int] = None
    imgsize: int = 128
    gray: str = "no"                 # "yes" -> single channel + gray thresholds
    workers: int = 8                 # honored (unlike the reference)
    # model
    modelname: str = "MedT"
    # training
    epochs: int = 400
    start_epoch: int = 0
    batch_size: int = 1
    learning_rate: float = 1e-3
    momentum: float = 0.9            # used by --optimizer sgd
    weight_decay: float = 1e-5       # honored (unlike the reference)
    optimizer: str = "adam"
    lr_schedule: str = "constant"    # constant | cosine | linear
    warmup_epochs: int = 0
    save_freq: int = 10
    seed: int = 3000                 # reference pins this (train.py:118-121)
    # io
    direc: str = "./medt"
    loaddirec: Optional[str] = None
    resume: bool = False
    # evaluation / output semantics
    pred_mode: str = "threshold"     # reference quirk: logits>=0.5 on channel 1
    # ("argmax" = corrected decision rule)
    # performance
    use_pallas: str = "yes"          # the port's fused attention (use_fused)
    remat: bool = False              # rematerialize fwd in bwd
    dtype: str = "float32"           # float32 | bfloat16 compute
    # the released reference FREEZES its attention gates (axialnet.py:124-127);
    # "yes" trains them instead — the paper's described setting
    trainable_gates: str = "no"
    aug: str = "off"
    profile_dir: Optional[str] = None
    # the mesh: the data axis (--dp; None: every visible card for
    # training, over --tp), the model axis (--tp) and the nodes the data
    # axis spans (--num_slices); the seq axis (--sp) takes only 1
    dp: Optional[int] = None
    sp: Optional[int] = None
    tp: Optional[int] = None
    num_slices: Optional[int] = None
    # serving (cli/serve.py)
    port: int = 8900
    # the JAX package's backend override: the port rejects it (its CLIs
    # run on the card; in-process callers pass main(..., device="cpu"))
    platform: Optional[str] = None

    @property
    def use_fused(self) -> bool:
        return self.use_pallas == "yes"

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        """``build_model``'s dtype: bf16 for ``--dtype bfloat16``, else None
        (float32), as JAX's ``setup_state`` maps the flag."""
        return torch.bfloat16 if self.dtype == "bfloat16" else None

    @property
    def imgchan(self) -> int:
        return 1 if self.gray == "yes" else 3

    @property
    def crop_tuple(self):
        return (self.crop, self.crop) if self.crop is not None else None


def add_args(parser: argparse.ArgumentParser) -> None:
    for field in dataclasses.fields(Config):
        name = "--" + field.name
        aliases = []
        if field.name == "workers":
            aliases = ["-j"]
        if field.name == "batch_size":
            aliases = ["-b"]
        if field.name == "weight_decay":
            aliases = ["--wd", "--weight-decay"]
        if field.name == "start_epoch":
            aliases = ["--start-epoch"]
        kwargs = {"default": field.default}
        if field.type in ("int", "Optional[int]"):
            kwargs["type"] = int
        elif field.type in ("float", "Optional[float]"):
            kwargs["type"] = float
        elif field.type == "bool":
            kwargs["action"] = "store_true"
            kwargs.pop("default")
        else:
            kwargs["type"] = str
        parser.add_argument(name, *aliases, **kwargs)


def parse_config(argv=None, description: str = "medt_tpu_torch",
                 device=None) -> Config:
    """Parse ``argv`` into a :class:`Config`. ``device`` is where the run
    goes (None: the card), which ``--dp`` and ``--tp`` are checked against
    (:func:`.parallel.check_mesh`)."""
    parser = argparse.ArgumentParser(description=description)
    add_args(parser)
    ns = parser.parse_args(argv)
    cfg = Config(**{f.name: getattr(ns, f.name)
                    for f in dataclasses.fields(Config)})
    if cfg.sp not in (None, 1):
        parser.error(f"--sp {cfg.sp}: {MESH_TODO}")
    for name in ("dp", "tp", "num_slices"):
        if getattr(cfg, name) is not None and getattr(cfg, name) < 1:
            parser.error(f"--{name} {getattr(cfg, name)}: at least one")
    check_mesh(cfg.dp, device, cfg.tp, cfg.num_slices)
    if cfg.platform:
        parser.error("--platform is the JAX package's backend override; the "
                     "port's CLIs run on the card (in-process callers pass "
                     "main(argv, device='cpu'))")
    return cfg
