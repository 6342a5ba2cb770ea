"""Typed configuration shared by the port's CLIs.

Port of ``medt_tpu/config.py``: the same dataclass, flags and defaults, so
one argv works for the JAX package's CLIs and the port's. The reference's
two drifting argparse blocks (train.py:30-64 vs test.py:28-58, whose drift
leaves test.py reading an ``--aug`` flag it never defines) become one.
Flags the reference parses but ignores are honoured: ``--workers``,
``--weight-decay``.

What differs in the port: ``--use_pallas yes`` selects its fused attention
(``use_fused``, CUDA kernels on the card). The flags that only the JAX
package's TPU mesh reads (``--dp``, ``--sp``, ``--tp``, ``--num_slices``)
are accepted and any value other than 1 is rejected with a message;
``--platform`` (JAX's backend override) and ``--dtype bfloat16`` are
rejected likewise.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional


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
    remat: bool = False              # rematerialize fwd in bwd (bigger batches)
    dtype: str = "float32"           # float32 only in the port
    # the released reference FREEZES its attention gates (axialnet.py:124-127);
    # "yes" trains them instead — the paper's described setting
    trainable_gates: str = "no"
    aug: str = "off"
    profile_dir: Optional[str] = None
    # the JAX package's TPU mesh: accepted, and only 1 is taken
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


_MESH_FLAGS = ("dp", "sp", "tp", "num_slices")


def parse_config(argv=None, description: str = "medt_tpu_torch") -> Config:
    parser = argparse.ArgumentParser(description=description)
    add_args(parser)
    ns = parser.parse_args(argv)
    cfg = Config(**{f.name: getattr(ns, f.name)
                    for f in dataclasses.fields(Config)})
    for name in _MESH_FLAGS:
        if getattr(cfg, name) not in (None, 1):
            parser.error(f"--{name} {getattr(cfg, name)}: the port runs on "
                         "one card (the TPU mesh flags take only 1)")
    if cfg.platform:
        parser.error("--platform is the JAX package's backend override; the "
                     "port's CLIs run on the card (in-process callers pass "
                     "main(argv, device='cpu'))")
    if cfg.dtype != "float32":
        parser.error(f"--dtype {cfg.dtype}: the port computes in float32")
    return cfg
