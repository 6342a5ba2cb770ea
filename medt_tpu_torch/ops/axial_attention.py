"""Axial attention along one spatial axis of an NCHW tensor.

Port of ``medt_tpu/ops/axial_attention.py``, train and eval mode. Semantics
(reference axialnet.py:19-258 and the zoo's gated_sig/gated_data variants):

  1. qkv 1x1 projection (no bias) + BN over the 2*out_planes channels;
  2. per group: q (gp/2), k (gp/2), v (gp) channels;
  3. a learned relative position table (2gp, 2*span-1) gathered into
     per-(query, key) embeddings (the reference's ``flatten_index``);
  4. logits qk, qr, kr, optional scalar gates on qr/kr, stacked BN over
     (3, groups), summed, softmax over keys;
  5. outputs sv and sve, optional gates, BN over (groups, gp, 2), summed;
  6. optional average-pool downsample when stride > 1.

Two paths, as in JAX:

* the **fused path** (``use_fused``, modes full/gated/wopos, and gated_sig
  in train mode: ``FUSED_EVAL_MODES``/``FUSED_TRAIN_MODES``;
  ``_fused_train_attention`` in JAX): the gates fold into the position
  tables *before* the similarity BN (they precede it in the reference),
  the BN folds into the ``(g, 8)`` similarity affine — from its running
  statistics in eval, from the batch moments of the logits in train mode
  (:mod:`.moments`, factorised so no logits tensor is formed; the running
  statistics then take the unbiased variance) — and the attention core
  runs on the fused ``(g, 2gp, L, S)`` qkv: a CUDA kernel on the card,
  chosen by span (:func:`lanes_family_core`), differentiable through its
  backward kernel. ``f_sv`` scales ``sv`` after the core and the output BN
  is applied per half (``_bn_apply_split`` in JAX). Autograd assembles the
  BN-coupled backward around the cores: dqkv gets one term from the core
  and one from the moments.
* the **stripe route** of the fused path: in train mode, at spans 32..64
  with fewer than 128 stripes (the global branch of a train step at batch
  1 and 2), the site runs the stripe-major train core (:mod:`.axial_train`,
  ``fused_attn_core`` in JAX) on a stripe-major q/k/v split, with the
  similarity-BN moments from the stripe-major einsums of :mod:`.moments`
  (as JAX computes them there, with XLA and not with the moments kernel);
  the output BN is applied per half in the stripe-major layout.
* the **eval route** of the fused path: in eval mode, at spans <= 64 with
  fewer than 128 stripes (batch-1 evaluation), the site runs the fused eval
  kernel (:mod:`.axial_eval`, ``fused_eval_attention`` in JAX) on a
  stripe-major qkv, with both BNs and the gates folded into it, as JAX
  routes such sites to its eval kernel where the lanes family refuses them.
  The TPU admission checks (VMEM budgets, flash's ``gp * span <= 256``,
  ``fused_train_supported``) are not ported; :func:`fused_route` is the
  whole rule.
* the **plain path** (``_jnp_attention`` in JAX), for the other modes
  (gated_sig in eval mode, gated_data in both),
  whenever ``use_fused`` is off, and on the fused path at spans over 256
  (route ``"plain"``: no kernel takes them, and JAX runs XLA attention
  there), in both modes.

Parameters carry the reference's names and shapes (``qkv_transform.weight``
(2*out, in, 1), ``bn_qkv``, ``bn_similarity``, ``bn_output``, ``relative``,
``flatten_index``, ``f_qr``/``f_kr``/``f_sve``/``f_sv``), so reference
state dicts load with ``load_state_dict``. The released reference freezes
the gates (``requires_grad=False``); ``trainable_gates`` makes them
trainable.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attn_core import fold_train_affine, pack_sim_affine, relative_logit_index
from .axial_eval import EVAL_MAX_SPAN, fused_eval_attention
from .axial_lanes import (
    FLASH2_MAX_SPAN,
    FLASH_MAX_SPAN,
    LANES_MAX_SPAN,
    flash2_lanes_core,
    flash_lanes_core,
    lanes_attn_core,
)
from .axial_train import STRIPE_MAX_SPAN, fused_attn_core
from .initializers import normal_by_fan, uniform_by_fan
from .moments import (
    logit_moments,
    logit_moments_lanes_fused,
    qk_moments,
    qk_moments_lanes_fused,
)
from .norms import (
    BatchNorm,
    batch_norm_eval,
    batch_norm_train,
    update_running,
)
from .pooling import avg_pool

MODE_FULL = "full"
MODE_GATED = "gated"
MODE_WOPOS = "wopos"
MODE_GATED_SIG = "gated_sig"
MODE_GATED_DATA = "gated_data"

_MODES = (MODE_FULL, MODE_GATED, MODE_WOPOS, MODE_GATED_SIG, MODE_GATED_DATA)
# the modes the fused path takes in each mode of the module (JAX's
# fused_eval_mode and fused_train_ok): gated_sig's sigmoid gates fold into
# the tables in train mode only, as in JAX; gated_data's per-sample gates
# cannot fold into the tables every sample shares, so it stays plain in both
FUSED_EVAL_MODES = (MODE_FULL, MODE_GATED, MODE_WOPOS)
FUSED_TRAIN_MODES = FUSED_EVAL_MODES + (MODE_GATED_SIG,)
GATE_NAMES = ("f_qr", "f_kr", "f_sve", "f_sv")

SPAN_TODO = ("fused attention at span {span} > 256 has no kernel (flash2 "
             "takes spans up to 256); fused_route sends such a site to the "
             "plain attention before it reaches the core")


# a site with fewer stripes than the lanes family's blocks hold takes the
# eval kernel in eval mode and, at spans 32..64, the stripe kernel in train
# mode (JAX: lanes_supported and flash_supported need S >= 128; its stripe
# kernel takes spans >= FUSED_TRAIN_MIN_SPAN = 32)
LANES_MIN_STRIPES = 128
STRIPE_MIN_SPAN = 32


def fused_route(span: int, stripes: int, training: bool) -> str:
    """The core a fused-path site runs: "eval", "stripe", "lanes", "flash"
    or "flash2" (spans 65..256, in both modes at any stripe count); longer
    spans take "plain", the module's plain attention, in both modes. No
    kernel of either package takes them: JAX sends them to XLA attention
    (train mode admits span <= 256, eval mode the flash2 or eval-kernel
    admission)."""
    if span > FLASH2_MAX_SPAN:
        return "plain"
    few = stripes < LANES_MIN_STRIPES
    if not training and span <= EVAL_MAX_SPAN and few:
        return "eval"
    if training and STRIPE_MIN_SPAN <= span <= STRIPE_MAX_SPAN and few:
        return "stripe"
    if span <= LANES_MAX_SPAN:
        return "lanes"
    if span <= FLASH_MAX_SPAN:
        return "flash"
    return "flash2"


def lanes_family_core(qkv, qemb, kemb_t, vemb, sim_affine,
                      plain: bool = False):
    """Route the fused core by span: <= 16 the lanes kernel, 17..64 the
    flash kernel, 65..256 the flash2 kernel; longer spans raise (the
    route, :func:`fused_route`, never brings them here).
    Differentiable; flash and flash2 save m and l for their backward.
    ``plain`` runs the plain versions (forward and backward) on whatever
    device the input lies on — an explicit choice, never a fallback."""
    span = qkv.shape[2]
    if span <= LANES_MAX_SPAN:
        return lanes_attn_core(qkv, qemb, kemb_t, vemb, sim_affine, plain)
    if span <= FLASH_MAX_SPAN:
        return flash_lanes_core(qkv, qemb, kemb_t, vemb, sim_affine, plain)
    if span <= FLASH2_MAX_SPAN:
        return flash2_lanes_core(qkv, qemb, kemb_t, vemb, sim_affine, plain)
    raise NotImplementedError(SPAN_TODO.format(span=span))


class AxialAttention(nn.Module):
    """Multi-head self-attention along one axis of an NCHW tensor.

    ``axis="h"`` attends along the height (stripes over the width), ``"w"``
    along the width. ``plain_cores`` makes the fused path run the kernels'
    plain versions even on the card (the reference the kernels are held
    against). After a fused-path forward, ``last_route`` holds
    ``(route, span, g, gp, stripes, has_pos)`` of that call."""

    def __init__(self, in_planes: int, out_planes: int, span: int,
                 groups: int = 8, stride: int = 1, axis: str = "h",
                 mode: str = MODE_GATED,
                 gate_init: Tuple[float, float, float, float] = (
                     0.1, 0.1, 0.1, 1.0),
                 trainable_gates: bool = False, use_fused: bool = False,
                 plain_cores: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if mode not in _MODES:
            raise ValueError(f"unknown attention mode {mode!r}")
        if axis not in ("h", "w"):
            raise ValueError(f"axis must be 'h' or 'w', got {axis!r}")
        if out_planes % groups:
            raise ValueError("out_planes must divide by groups")
        gp = out_planes // groups
        if gp % 2:
            raise ValueError("group planes must be even to split q/k")
        self.in_planes, self.out_planes = in_planes, out_planes
        self.span, self.groups, self.gp = span, groups, gp
        self.stride, self.axis, self.mode = stride, axis, mode
        self.use_fused, self.plain_cores = use_fused, plain_cores
        self.last_route: Optional[tuple] = None

        self.qkv_transform = nn.Conv1d(in_planes, 2 * out_planes, 1,
                                       bias=False, device=device)
        normal_by_fan(self.qkv_transform.weight, in_planes, generator)
        self.bn_qkv = BatchNorm(2 * out_planes, device=device)
        if mode == MODE_WOPOS:
            self.bn_similarity = BatchNorm(groups, device=device)
            self.bn_output = BatchNorm(out_planes, device=device)
        else:
            self.bn_similarity = BatchNorm(3 * groups, device=device)
            self.bn_output = BatchNorm(2 * out_planes, device=device)
            self.relative = nn.Parameter(torch.empty(
                (2 * gp, 2 * span - 1), dtype=torch.float32, device=device))
            normal_by_fan(self.relative, gp, generator)
            index = torch.as_tensor(relative_logit_index(span).reshape(-1),
                                    dtype=torch.int64, device=device)
            self.register_buffer("flatten_index", index)
        if mode in (MODE_GATED, MODE_GATED_SIG):
            for name, value in zip(GATE_NAMES, gate_init):
                setattr(self, name, nn.Parameter(
                    torch.tensor(float(value), device=device),
                    requires_grad=trainable_gates))
        if mode == MODE_GATED_DATA:
            hidden = max(in_planes // 4, 4)
            self.gate_fc1 = nn.Linear(in_planes, hidden, device=device)
            self.gate_fc2 = nn.Linear(hidden, 4, device=device)
            for fc in (self.gate_fc1, self.gate_fc2):
                uniform_by_fan(fc.weight, fc.in_features, generator)
                uniform_by_fan(fc.bias, fc.in_features, generator)

    # ---- helpers -----------------------------------------------------------

    def _gates(self, x: torch.Tensor):
        """(f_qr, f_kr, f_sve, f_sv), or None for full/wopos. gated_data
        gives per-sample gates shaped (n, 1, 1, 1, 1)."""
        if self.mode in (MODE_FULL, MODE_WOPOS):
            return None
        if self.mode == MODE_GATED_DATA:
            h = F.relu(self.gate_fc1(x.mean(dim=(2, 3))))
            gates = torch.sigmoid(self.gate_fc2(h))          # (n, 4)
            return tuple(gates[:, i].reshape(-1, 1, 1, 1, 1)
                         for i in range(4))
        gates = tuple(getattr(self, name) for name in GATE_NAMES)
        if self.mode == MODE_GATED_SIG:
            gates = tuple(torch.sigmoid(v) for v in gates)
        return gates

    def _tables(self):
        """Gathered (q_emb, k_emb, v_emb): (c, L, L), (c, L, L), (gp, L, L)."""
        c, gp, L = self.gp // 2, self.gp, self.span
        all_emb = self.relative[:, self.flatten_index].reshape(2 * gp, L, L)
        return all_emb[:c], all_emb[c:gp], all_emb[gp:]

    def _folded_tables(self):
        """The fused paths' tables with the gates folded in, and the sv
        gate (None for the full mode). The gates precede each BN in the
        reference, so folding them into the tables keeps the affine and the
        moments exact."""
        q_emb, k_emb, v_emb = self._tables()
        gates = self._gates(None)
        if gates is None:
            return q_emb, k_emb, v_emb, None
        f_qr, f_kr, f_sve, f_sv = gates
        return q_emb * f_qr, k_emb * f_kr, v_emb * f_sve, f_sv

    def _output_bn_split(self, sv, sve, feature_axes):
        """BN over stack([sv, sve], -1) with (..., 2)-minor parameters,
        computed per half and summed (``_bn_apply_split`` in JAX); in train
        mode each half normalises with its own batch moments and updates
        its half of the running statistics."""
        bn = self.bn_output
        g, gp = self.groups, self.gp
        halves = [t.view(g, gp, 2) for t in (
            bn.weight, bn.bias, bn.running_mean, bn.running_var)]
        out = 0
        for half, x in enumerate((sv, sve)):
            w, b, m, v = (t[..., half] for t in halves)
            if self.training:
                y, mean, var = batch_norm_train(x, w, b, feature_axes, bn.eps)
                update_running(m, mean)
                update_running(v, var)
            else:
                y = batch_norm_eval(x, w, b, m, v, feature_axes, bn.eps)
            out = out + y
        return out

    # ---- forward ------------------------------------------------------------

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_in = x
        if self.axis == "w":
            x = x.transpose(2, 3)  # attend along dim 2 below
        n, _, L, _ = x.shape
        if L != self.span:
            raise ValueError(f"span {self.span} != attended extent {L}")
        qkv = F.conv2d(x, self.qkv_transform.weight[..., None])
        qkv = self.bn_qkv(qkv)                            # (n, 2out, L, m)

        fused_modes = (FUSED_TRAIN_MODES if self.training
                       else FUSED_EVAL_MODES)
        if self.use_fused and self.mode in fused_modes:
            stripes = n * qkv.shape[3]
            route = fused_route(L, stripes, self.training)
            self.last_route = (route, L, self.groups, self.gp, stripes,
                               self.mode != MODE_WOPOS)
            if route == "eval":
                out = self._eval_attention(qkv)
            elif route == "stripe":
                out = self._stripe_attention(qkv)
            elif route == "plain":
                out = self._plain_attention(qkv, x_in)
            else:
                out = self._fused_attention(qkv)
        else:
            out = self._plain_attention(qkv, x_in)

        if self.axis == "w":
            out = out.transpose(2, 3)
        if self.stride > 1:
            out = avg_pool(out, self.stride)
        return out

    def _sim_affine(self, moments):
        """The similarity BN as the ``(g, 8)`` affine: running statistics in
        eval; in train mode the batch moments of the logits, ``moments()``
        -> (mean, biased var, count) (the running statistics then take the
        unbiased variance)."""
        g = self.groups
        bn = self.bn_similarity
        if not self.training:
            a, b = bn.affine()
        else:
            mean, var, count = moments()
            shape = mean.shape
            a, b = fold_train_affine(bn.weight.view(shape),
                                     bn.bias.view(shape), mean, var, bn.eps)
            update_running(bn.running_mean, mean.reshape(-1))
            update_running(bn.running_var, (var * (
                count / max(count - 1.0, 1.0))).reshape(-1))
        if self.mode == MODE_WOPOS:
            return pack_sim_affine(g, a, b, MODE_WOPOS)
        return pack_sim_affine(g, a.reshape(3, g), b.reshape(3, g), self.mode)

    def _fused_attention(self, qkv: torch.Tensor) -> torch.Tensor:
        """Fused path: the affine fold around the lanes-family core."""
        n, _, L, m = qkv.shape
        g, gp = self.groups, self.gp
        S = n * m
        qkv_l4 = qkv.permute(1, 2, 0, 3).reshape(g, 2 * gp, L, S) \
            .float().contiguous()
        plain = self.plain_cores
        if self.mode == MODE_WOPOS:
            aff = self._sim_affine(lambda: qk_moments_lanes_fused(qkv_l4,
                                                                  plain))
            empty = qkv_l4.new_zeros((0, L, L))
            sv, _ = lanes_family_core(qkv_l4, empty, empty, empty, aff,
                                      plain=plain)
            y = self.bn_output(sv, feature_axes=(0, 1))
        else:
            q_emb, k_emb, v_emb, f_sv = self._folded_tables()
            aff = self._sim_affine(lambda: logit_moments_lanes_fused(
                qkv_l4, q_emb, k_emb, plain))
            sv, sve = lanes_family_core(
                qkv_l4, q_emb.contiguous(), k_emb.transpose(1, 2).contiguous(),
                v_emb.contiguous(), aff, plain=plain)
            if f_sv is not None:
                sv = sv * f_sv
            y = self._output_bn_split(sv, sve, (0, 1))
        out = y.reshape(self.out_planes, L, n, m).permute(2, 0, 1, 3)
        return out.to(qkv.dtype)

    def _stripe_attention(self, qkv: torch.Tensor) -> torch.Tensor:
        """Stripe route (train mode; JAX's non-lanes branch of
        ``_fused_train_attention``): q, k and v as views of one stripe-major
        copy of qkv, the moments from the stripe-major einsums, the stripe
        core, then the output BN per half on ``(S, g, gp, L)``."""
        n, _, L, m = qkv.shape
        g, gp, c = self.groups, self.gp, self.gp // 2
        stripes = qkv.permute(0, 3, 1, 2).float().contiguous() \
            .view(n * m, g, 2 * gp, L)
        q, k, v = stripes[:, :, :c], stripes[:, :, c:gp], stripes[:, :, gp:]
        if self.mode == MODE_WOPOS:
            aff = self._sim_affine(lambda: qk_moments(q, k))
            empty = q.new_zeros((0, L, L))
            sv, _ = fused_attn_core(q, k, v, empty, empty, empty, aff,
                                    plain=self.plain_cores)
            y = self.bn_output(sv, feature_axes=(1, 2))
        else:
            q_emb, k_emb, v_emb, f_sv = self._folded_tables()
            aff = self._sim_affine(lambda: logit_moments(q, k, q_emb, k_emb))
            sv, sve = fused_attn_core(q, k, v, q_emb.contiguous(),
                                      k_emb.contiguous(), v_emb.contiguous(),
                                      aff, plain=self.plain_cores)
            if f_sv is not None:
                sv = sv * f_sv
            y = self._output_bn_split(sv, sve, (1, 2))
        out = y.reshape(n, m, self.out_planes, L).permute(0, 2, 3, 1)
        return out.to(qkv.dtype)

    def _eval_attention(self, qkv: torch.Tensor) -> torch.Tensor:
        """Eval route: both BNs and the gates folded into the eval kernel,
        on a stripe-major copy of qkv."""
        n, _, L, m = qkv.shape
        g, gp = self.groups, self.gp
        stripes = qkv.permute(0, 3, 1, 2).contiguous() \
            .view(n * m, g, 2 * gp, L)
        sim, outb = self.bn_similarity, self.bn_output
        if self.mode == MODE_WOPOS:
            sim_shape, out_shape, relative = (g,), (g, gp), None
        else:
            sim_shape, out_shape, relative = (3, g), (g, gp, 2), self.relative
        out = fused_eval_attention(
            stripes.float(), relative,
            *(t.view(sim_shape) for t in (sim.weight, sim.bias,
                                          sim.running_mean, sim.running_var)),
            *(t.view(out_shape) for t in (outb.weight, outb.bias,
                                          outb.running_mean, outb.running_var)),
            gp=gp, span=L, mode=self.mode, gates=self._gates(None),
            eps=sim.eps, plain=self.plain_cores,
            index=getattr(self, "flatten_index", None))   # (S, g, gp, L)
        out = out.reshape(n, m, self.out_planes, L).permute(0, 2, 3, 1)
        return out.to(qkv.dtype)

    def _plain_attention(self, qkv: torch.Tensor, x_in: torch.Tensor):
        """Plain path (``_jnp_attention`` in JAX), every mode."""
        n, _, L, m = qkv.shape
        g, gp, c = self.groups, self.gp, self.gp // 2
        qkv5 = qkv.reshape(n, g, 2 * gp, L, m)
        q, k, v = qkv5[:, :, :c], qkv5[:, :, c:gp], qkv5[:, :, gp:]
        qk = torch.einsum("ngcim,ngcjm->ngmij", q, k)
        if self.mode == MODE_WOPOS:
            gates = None
            logits = self.bn_similarity(qk, feature_axes=1)
        else:
            q_emb, k_emb, v_emb = self._tables()
            qr = torch.einsum("ngcim,cij->ngmij", q, q_emb)
            kr = torch.einsum("ngcjm,cji->ngmij", k, k_emb)
            gates = self._gates(x_in)
            if gates is not None:
                f_qr, f_kr, f_sve, f_sv = gates
                qr, kr = qr * f_qr, kr * f_kr
            stacked = torch.stack([qk, qr, kr], dim=1)   # (n, 3, g, m, i, j)
            logits = self.bn_similarity(stacked, feature_axes=(1, 2)).sum(1)
        sim = torch.softmax(logits.float(), dim=-1)
        sv = torch.einsum("ngmij,ngpjm->ngpim", sim, v)
        if self.mode == MODE_WOPOS:
            out = self.bn_output(sv, feature_axes=(1, 2))
        else:
            sve = torch.einsum("ngmij,pij->ngpim", sim, v_emb)
            if gates is not None:
                sv, sve = sv * f_sv, sve * f_sve
            stacked = torch.stack([sv, sve], dim=-1)     # (n, g, p, i, m, 2)
            out = self.bn_output(stacked, feature_axes=(1, 2, 5)).sum(-1)
        return out.reshape(n, self.out_planes, L, m).to(qkv.dtype)
