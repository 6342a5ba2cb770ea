"""Fused eval attention: the CUDA kernel, its plain version and the fold.

Port of ``medt_tpu/ops/pallas_axial.py``: :func:`axial_attention_fused`
(the Pallas kernel, ``pl.pallas_call`` at ``:165``) and
:func:`fused_eval_attention` (its BN/gate fold, ``:198``). Eval only: the
similarity and output BNs use their running statistics, so both fold into
affines, and the frozen (or trained) gates fold into the position tables
and the sv scale::

    q, k    (S, g, c, L)   stripe-major: S = batch x orthogonal extent
    v       (S, g, gp, L)
    q_emb   (c, L, L)      [c, i, j]
    k_emb   (c, L, L)      [c, j, i]: kr reads it transposed, as in Pallas
    v_emb   (gp, L, L)     [p, i, j]
    sim_affine (g, 8)      attn_core.pack_sim_affine layout
    out_affine (g, 4, gp)  [sv scale, sv shift, sve scale, sve shift]
    -> (S, g, gp, L)       (sv*a0+b0) + (sve*a1+b1)

The position-free mode passes zero tables and zero qr/kr/sve affines (the
Pallas contract) or zero-size ``(0, L, L)`` tables, which skip the position
terms and give the same result.

On CUDA tensors :func:`axial_attention_fused` launches
``csrc/axial_eval_fwd.cu`` through :func:`axial_eval_fwd`; on CPU tensors,
or with ``plain=True``, it runs :func:`axial_attention_fused_plain`. There
is no fallback from a CUDA tensor to the plain version. The kernel takes
the stripe-major layout with free stripe and group strides, so
:func:`fused_eval_attention` hands it three views of one fused
``(S, g, 2gp, L)`` qkv tensor without splitting it. There is no backward:
asking for a gradient raises. At the wide widths (every even gp up to 128
outside 2, 4, 8 and 16) the same entry point runs ``csrc/wide_attn.cuh``'s
body (a block stages its stripes' k and v rows and its rows' tables in
chunks of 4 channels or planes; a thread takes 2 or 4 query rows of one
stripe); any other
gp raises ``ValueError`` (``axial_lanes.check_gp``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..kernels.build import library
from ..kernels.launch import (check_rows, check_tensor, launch, ptr,
                              strides)
from .attn_core import (attend, attn_logits, fold_train_affine,
                        pack_sim_affine, relative_logit_index)
from .axial_lanes import check_gp

EVAL_MAX_SPAN = 64


def _has_pos(q_emb: torch.Tensor) -> bool:
    return q_emb.shape[0] > 0


def axial_attention_fused_plain(q, k, v, q_emb, k_emb, v_emb, sim_affine,
                                out_affine):
    """Plain PyTorch version of the eval kernel (einsums on the same
    operands): ``(S, g, gp, L)``."""
    has_pos = _has_pos(q_emb)
    logits = attn_logits(q, k, q_emb, k_emb, sim_affine, has_pos)
    sv, sve = attend(logits, v, v_emb, has_pos)
    oa = out_affine[None, :, :, :, None]                 # (1, g, 4, gp, 1)
    return (sv * oa[:, :, 0] + oa[:, :, 1]) + (sve * oa[:, :, 2]
                                               + oa[:, :, 3])


def axial_eval_fwd(q, k, v, q_emb, k_emb, v_emb, sim_affine, out_affine):
    """Launch the eval kernel on CUDA tensors: ``(S, g, gp, L)``."""
    name = "axial_eval_fwd"
    if q.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be (S, g, rows, L)")
    S, g, c, L = q.shape
    gp = v.shape[2]
    check_gp(name, gp)
    if c != gp // 2:
        raise ValueError(f"{name}: q has {c} rows for gp={gp}")
    if not 1 <= L <= EVAL_MAX_SPAN:
        raise ValueError(f"{name}: span {L} outside 1..{EVAL_MAX_SPAN}")
    dev = q.device
    for tname, t, shape in (("q", q, (S, g, c, L)), ("k", k, (S, g, c, L)),
                            ("v", v, (S, g, gp, L))):
        check_rows(name, tname, t, shape, dev)
    has_pos = _has_pos(q_emb)
    tables = {"q_emb": (q_emb, (c, L, L)), "k_emb": (k_emb, (c, L, L)),
              "v_emb": (v_emb, (gp, L, L))}
    for tname, (t, shape) in tables.items():
        if has_pos:
            check_tensor(name, tname, t, shape, dev)
        elif t.numel():
            raise ValueError(f"{name}: {tname} must be empty when q_emb is")
    check_tensor(name, "sim_affine", sim_affine, (g, 8), dev)
    check_tensor(name, "out_affine", out_affine, (g, 4, gp), dev)
    out = torch.empty((S, g, gp, L), dtype=torch.float32, device=dev)
    if S == 0:      # no stripes: an empty output, no launch
        return out
    launch(axial_eval_fwd, library().medt_axial_eval_fwd, q,
           ptr(q), ptr(k), ptr(v), ptr(q_emb), ptr(k_emb), ptr(v_emb),
           ptr(sim_affine), ptr(out_affine), ptr(out), *strides(q, k, v),
           S, g, gp, L, int(has_pos))
    return out


axial_eval_fwd.launches = 0


class AxialEvalCore(torch.autograd.Function):
    """The eval kernel (or its plain version) as an autograd leaf with no
    backward: eval mode only."""

    @staticmethod
    def forward(ctx, q, k, v, q_emb, k_emb, v_emb, sim_affine, out_affine,
                plain):
        fn = axial_attention_fused_plain if plain else axial_eval_fwd
        return fn(q, k, v, q_emb, k_emb, v_emb, sim_affine, out_affine)

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError(
            "axial_attention_fused is eval-only and has no backward; train "
            "mode runs the lanes/flash cores")


def axial_attention_fused(q, k, v, q_emb, k_emb, v_emb, sim_affine,
                          out_affine, plain: bool = False):
    """The Pallas contract of ``axial_attention_fused``: the kernel on CUDA
    tensors, the plain version on CPU tensors or when ``plain`` is set."""
    plain = plain or q.device.type == "cpu"
    return AxialEvalCore.apply(q, k, v, q_emb, k_emb, v_emb, sim_affine,
                               out_affine, plain)


def fused_eval_attention(qkv, relative, sim_scale, sim_bias, sim_mean,
                         sim_var, out_scale, out_bias, out_mean, out_var, *,
                         gp: int, span: int, mode: str = "gated",
                         gates: Optional[Sequence] = (0.1, 0.1, 0.1, 1.0),
                         eps: float = 1e-5, plain: bool = False,
                         index: Optional[torch.Tensor] = None):
    """Fold the BN running statistics and the gates, then run the core.

    Unlike the JAX function, which takes ``(S, L, g, 2gp)`` and returns
    ``(S, L, g, gp)``, ``qkv`` is stripe-major ``(S, g, 2gp, L)`` (the
    post-``bn_qkv`` projection) and the result ``(S, g, gp, L)``: the
    layout the kernel reads. ``relative`` is the ``(2gp, 2*span-1)`` table
    (None for wopos); ``sim_*`` are ``(3, g)`` (``(g,)`` for wopos) and
    ``out_*`` ``(g, gp, 2)`` (``(g, gp)`` for wopos). ``gates`` is
    (f_qr, f_kr, f_sve, f_sv) for "gated" and ignored otherwise; ``index``
    is the flattened ``relative_logit_index(span)`` on ``relative``'s
    device, computed when not given."""
    S, g, _, L = qkv.shape
    c = gp // 2
    q, k, v = qkv[:, :, :c], qkv[:, :, c:gp], qkv[:, :, gp:]
    if mode == "wopos":
        a, b = fold_train_affine(sim_scale, sim_bias, sim_mean, sim_var, eps)
        sim_affine = pack_sim_affine(g, a, b, "wopos")
        o_sc, o_sh = fold_train_affine(out_scale, out_bias, out_mean,
                                       out_var, eps)          # (g, gp)
        zero = torch.zeros_like(o_sc)
        out_affine = torch.stack([o_sc, o_sh, zero, zero], dim=1)
        q_emb = k_emb = v_emb = qkv.new_zeros((0, L, L))
    else:
        if mode == "full" or gates is None:
            gates = (1.0, 1.0, 1.0, 1.0)
        f_qr, f_kr, f_sve, f_sv = gates
        if index is None:
            index = torch.as_tensor(relative_logit_index(span).reshape(-1),
                                    device=relative.device)
        all_emb = relative[:, index].reshape(2 * gp, L, L).float()
        q_emb = (all_emb[:c] * f_qr).contiguous()
        k_emb = (all_emb[c:gp] * f_kr).contiguous()
        v_emb = (all_emb[gp:] * f_sve).contiguous()
        a, b = fold_train_affine(sim_scale, sim_bias, sim_mean, sim_var, eps)
        sim_affine = pack_sim_affine(g, a, b, mode)
        o_sc, o_sh = fold_train_affine(out_scale, out_bias, out_mean,
                                       out_var, eps)          # (g, gp, 2)
        out_affine = torch.stack([o_sc[..., 0] * f_sv, o_sh[..., 0],
                                  o_sc[..., 1], o_sh[..., 1]], dim=1).float()
    return axial_attention_fused(q, k, v, q_emb, k_emb, v_emb,
                                 sim_affine.contiguous(),
                                 out_affine.contiguous(), plain)


_WRAPPERS = (axial_eval_fwd,)


def reset_launch_counts():
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}
