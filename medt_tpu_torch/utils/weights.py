"""Carry weights from the JAX package's variable trees into the port.

A numpy-only re-implementation of ``export_state_dict`` and
``export_for_model`` (``medt_tpu/utils/torch_import.py:178-246``): it turns
the JAX package's ``params``/``batch_stats`` trees — nested mappings of
numpy arrays, e.g. ``jax.tree_util.tree_map(np.asarray, variables)`` — into
a state dict in the reference's key naming, which the port's models load
with ``load_state_dict(strict=True)``.

Layout translation (JAX -> reference):
  * conv kernels HWIO -> OIHW; the qkv dense kernel (in, 2*out) -> conv1d
    (2*out, in, 1); linear (in, out) -> (out, in);
  * BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var,
    structured attention BN features flattened row-major (that order is
    the reference's per-channel layout);
  * ``attn_h``/``attn_w`` -> ``hight_block``/``width_block``,
    ``downsample_{conv,bn}`` -> ``downsample.{0,1}``, ``qkv`` ->
    ``qkv_transform``, ``stem[_p]/convN`` -> ``convN[_p]``; the zoo's
    single-conv stem ``stem_conv``/``stem_bn`` keeps its own top-level
    names (JAX's translator sends every part that starts with ``stem``
    down its stem branch and fails on these one-part paths);
  * every ``relative`` table gains its derived ``flatten_index`` buffer;
    gated factories gain their frozen gate constants.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_LEAF_PARAM = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_LEAF_STATS = {"mean": "running_mean", "var": "running_var"}
_ATTN_FLAT = re.compile(
    r"^(bn_qkv|bn_similarity|bn_output)_(scale|bias|mean|var)$")
_RENAME = {"attn_h": "hight_block", "attn_w": "width_block",
           "downsample_conv": "downsample.0", "downsample_bn": "downsample.1",
           "qkv": "qkv_transform"}

# frozen gate constants per gated factory (reference axialnet.py:124-127;
# gated_sig uses f_sv = 5.0, model_codes.py:241-244)
FROZEN_GATES = {
    "gatedaxialunet": (0.1, 0.1, 0.1, 1.0),
    "gated": (0.1, 0.1, 0.1, 1.0),
    "MedT": (0.1, 0.1, 0.1, 1.0),
    "medt_512": (0.1, 0.1, 0.1, 1.0),
    "gated_sig": (0.1, 0.1, 0.1, 5.0),
}
_GATE_NAMES = ("f_qr", "f_kr", "f_sve", "f_sv")


def _translate(path: Tuple[str, ...]) -> str:
    """JAX tree path -> reference state-dict key."""
    *parts, leaf = path
    m = _ATTN_FLAT.match(leaf)
    if m:
        bn, kind = m.groups()
        leaf_key = f"{bn}.{_LEAF_PARAM.get(kind) or _LEAF_STATS[kind]}"
    else:
        leaf_key = _LEAF_PARAM.get(leaf) or _LEAF_STATS.get(leaf) or leaf
    if parts and parts[0] in ("stem", "stem_p"):
        # the stem flattens into the top level: stem_p/bn2 -> bn2_p
        suffix = "_p" if parts[0] == "stem_p" else ""
        return f"{parts[1]}{suffix}.{leaf_key}"
    names = []
    for p in parts:
        if re.match(r"layer\d+_block\d+$", p):  # classification ResNet stage
            stage, blk = p.split("_block")
            names.append(f"{stage}.{blk}")
        elif re.match(r"block\d+$", p):
            names.append(p[5:])
        else:
            names.append(_RENAME.get(p, p))
    return ".".join(names + [leaf_key])


def _untransform(val: np.ndarray, path: Tuple[str, ...]) -> np.ndarray:
    leaf = path[-1]
    if leaf == "kernel":
        if val.ndim == 4:                 # conv HWIO -> OIHW
            return val.transpose(3, 2, 0, 1)
        if "qkv" in path:                 # dense (I, O) -> conv1d (O, I, 1)
            return val.T[:, :, None]
        if val.ndim == 2:                 # linear (I, O) -> (O, I)
            return val.T
    if val.ndim > 1 and (leaf in ("scale", "bias", "mean", "var")
                         or _ATTN_FLAT.match(leaf)):
        return val.reshape(-1)
    return val


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    """Depth-first (path, leaf) pairs in key order."""
    for key in tree:
        val = tree[key]
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _leaves(val, path)
        else:
            yield path, np.asarray(val)


def export_state_dict(params: Mapping, batch_stats: Mapping
                      ) -> Dict[str, np.ndarray]:
    """JAX ``params``/``batch_stats`` trees -> reference-format state dict."""
    out: Dict[str, np.ndarray] = {}
    for tree in (params, batch_stats):
        for path, leaf in _leaves(tree):
            key = _translate(path)
            if key in out:
                raise KeyError(f"duplicate export key {key} from {path}")
            out[key] = _untransform(leaf, path)
            if path[-1] == "relative":
                span = (leaf.shape[1] + 1) // 2
                r = np.arange(span, dtype=np.int64)
                idx = (r[:, None] - r[None, :] + span - 1).reshape(-1)
                out[key[:-len("relative")] + "flatten_index"] = idx
    return out


def export_for_model(modelname: str, params: Mapping, batch_stats: Mapping
                     ) -> Dict[str, np.ndarray]:
    """:func:`export_state_dict` plus the frozen gates the named gated
    factory carries next to every position-bearing attention module."""
    out = export_state_dict(params, batch_stats)
    gates = FROZEN_GATES.get(modelname)
    if gates is None:
        return out
    for key in [k for k in out if k.split(".")[-1] == "relative"]:
        prefix = key[:-len("relative")]
        for name, val in zip(_GATE_NAMES, gates):
            out.setdefault(prefix + name, np.asarray(val, np.float32))
    return out


def to_state_dict(arrays: Mapping[str, np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
    """numpy state dict -> torch tensors (CPU), ready for
    ``load_state_dict``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in arrays.items()}


def is_dead_reference_key(key: str) -> bool:
    """Keys of reference state dicts that nothing computes with and the port
    does not carry: BN ``num_batches_tracked`` counters, MedT's unused
    ``adjust_p`` and the wopos blocks' never-called ``conv1``
    (reference axialnet.py:358)."""
    return (key.endswith("num_batches_tracked") or key.startswith("adjust_p.")
            or ("_p." in key and ".conv1." in key))
