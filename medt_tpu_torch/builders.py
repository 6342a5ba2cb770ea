"""Builder facade: args-driven factories.

Port of ``medt_tpu/builders.py`` (the reference's ``lib`` package API,
lib/__init__.py:1-7): ``build_model(args)``, ``build_dataloader(args)``,
``build_optimizer(args, params)`` and the running-average ``Metric`` that
the classification driver ``medt_tpu_torch.cli.train_cls`` consumes.
``args`` is any object with attributes (an argparse Namespace or a
Config).

As in JAX, ``build_model`` builds a classifier with ``num_classes`` alone,
so the axial classifiers take their own 224 px span schedule whatever
``--imgsize`` says, and with ``use_fused`` off unless the caller asks for
it (the card's kernels run only under ``use_fused=True``).
"""
from __future__ import annotations

from typing import Any

import torch

from .data.imagenet import ImageFolderDataset
from .data.loader import DataLoader
from .device import resolve_device
from .metrics import Metric
from .models import MODEL_REGISTRY
from .models import build_model as build_segmentation_model
from .models import classifiers as _classifiers
from .models import resnet as _resnet
from .parallel.distributed import host_shard, initialize_distributed
from .training.optimizers import adam_l2, sgd

# classification model names resolve like the reference's
# ``models.__dict__[args.model]`` (lib/build_model.py:4-6)
CLASSIFIER_REGISTRY = {
    "resnet18": _resnet.resnet18,
    "resnet26": _resnet.resnet26,
    "resnet34": _resnet.resnet34,
    "resnet50": _resnet.resnet50,
    "resnet101": _resnet.resnet101,
    "resnet152": _resnet.resnet152,
    "axial26s": _classifiers.axial26s,
    "axial50s": _classifiers.axial50s,
    "axial50m": _classifiers.axial50m,
    "axial50l": _classifiers.axial50l,
}


def build_model(args: Any, *, device=None, seed: int = 0,
                use_fused: bool = False,
                plain_cores: bool = False) -> torch.nn.Module:
    """Resolve ``args.model`` (or ``args.modelname``) against the
    classifiers first, then the segmentation registry; the model in eval
    mode on ``device`` (None: the card), its weights drawn with a
    ``torch.Generator`` seeded by ``seed``. ``use_fused`` and
    ``plain_cores`` reach the attention models (the ResNets have no
    attention)."""
    name = getattr(args, "model", None) or getattr(args, "modelname")
    device = resolve_device(device)
    if name in CLASSIFIER_REGISTRY:
        kwargs = dict(generator=torch.Generator().manual_seed(seed),
                      device=device)
        if hasattr(args, "num_classes"):
            kwargs["num_classes"] = args.num_classes
        if name.startswith("axial"):
            kwargs.update(use_fused=use_fused, plain_cores=plain_cores)
        return CLASSIFIER_REGISTRY[name](**kwargs).eval()
    if name in MODEL_REGISTRY:
        return build_segmentation_model(
            name, img_size=getattr(args, "imgsize", 128),
            num_classes=getattr(args, "num_classes", 2), use_fused=use_fused,
            plain_cores=plain_cores, seed=seed, device=device)
    raise KeyError(
        f"unknown model {name!r}; classifiers: {sorted(CLASSIFIER_REGISTRY)}; "
        f"segmentation: {sorted(MODEL_REGISTRY)}"
    )


def _shard(args: Any):
    """(rank, world size) of the initialised process group under
    ``args.distributed``, else None."""
    if not getattr(args, "distributed", False):
        return None
    if not initialize_distributed():
        raise RuntimeError("--distributed needs an initialised "
                           "torch.distributed process group "
                           "(init_process_group, or torchrun's) before the "
                           "loaders are built")
    return host_shard()


def build_dataloader(args: Any):
    """(train_loader, val_loader) over ImageFolder datasets. Under
    ``args.distributed`` ``batch_size`` is the rows a process loads a
    step: each loader cuts joint batches of ``world * batch_size`` from
    one order, the same on every rank, and yields this rank's rows of each
    (``DataLoader(shard=(rank, world))``), so every rank takes the same
    number of steps."""
    shard = _shard(args)
    img_size = getattr(args, "imgsize", 224)
    train_ds = ImageFolderDataset(args.train_dataset, img_size, train=True)
    val_ds = ImageFolderDataset(args.val_dataset, img_size, train=False)
    workers = getattr(args, "workers", 4)
    batch = getattr(args, "batch_size", 32) * (shard[1] if shard else 1)
    return (
        DataLoader(train_ds, batch, shuffle=True, num_workers=workers,
                   shard=shard),
        DataLoader(val_ds, batch, shuffle=False, num_workers=workers,
                   shard=shard),
    )


def build_optimizer(args: Any, params) -> torch.optim.Optimizer:
    """SGD (momentum, L2 weight decay; lib/build_optimizer.py:4-11) by
    default, else Adam with L2. ``args.lr`` may be a ``step -> lr``
    schedule: the optimizer starts at its first value, and the train step
    applies the schedule before each update."""
    name = getattr(args, "optimizer", "sgd")
    lr = getattr(args, "lr", None) or getattr(args, "learning_rate", 0.1)
    if callable(lr):
        lr = float(lr(0))
    wd = getattr(args, "weight_decay", 1e-4)
    if name == "sgd":
        return sgd(params, lr, momentum=getattr(args, "momentum", 0.9),
                   weight_decay=wd)
    return adam_l2(params, lr, weight_decay=wd)


__all__ = ["CLASSIFIER_REGISTRY", "Metric", "build_dataloader", "build_model",
           "build_optimizer"]
