"""The stripe-major train core: CUDA kernels, plain versions and autograd.

Port of ``medt_tpu/ops/pallas_axial_train.py::fused_attn_core``: the
forward (``pl.pallas_call`` at ``:265``, body ``_fwd_kernel``) and its
backward ``_fused_bwd_rule`` (``:306``, body ``_bwd_kernel``). Same
contract as the JAX function::

    q, k       (S, g, c, L)   stripe-major: S = batch x orthogonal extent
    v          (S, g, gp, L)
    qemb       (c, L, L)      [c, i, j]
    kemb       (c, L, L)      [c, j, i]: kr reads it transposed
    vemb       (gp, L, L)     [p, i, j]
    sim_affine (g, 8)         attn_core.pack_sim_affine layout
    -> sv, sve (S, g, gp, L)

The tables are shared by every group, with the gates folded in. The
backward gives ``(dq, dk, dv, dqemb, dkemb, dvemb, daff)`` from ``(dsv,
dsve)``, with ``daff`` per group ``[sum dlog*qk, sum dlog, sum dlog*qr, sum
dlog, sum dlog*kr, sum dlog, 0, 0]`` (``pallas_axial_train.py:141-145``);
like the JAX kernel it recomputes the softmax from the saved inputs.

Without positions JAX passes zero tables (``sve`` then comes out zero). The
port takes those too, or zero-size ``(0, L, L)`` tables as the lanes
wrappers do: the kernels then skip the position terms, ``sve`` is zero,
the tables take no gradient and ``daff`` has only its qk and bias columns
(columns 2..5 are zero, as in the lanes backward).

On CUDA tensors :func:`fused_attn_core` launches ``csrc/axial_stripe_fwd.cu``
and ``csrc/axial_stripe_bwd.cu`` through :func:`stripe_attn_fwd` and
:func:`stripe_attn_bwd`, which check device, dtype, shape and contiguity and
raise on anything else (q, k and v may be views of one stripe-major qkv:
their stripe and group strides are free); on CPU tensors, or with ``plain=True``, it runs
:func:`..attn_core.attn_core_plain` and :func:`fused_attn_bwd_plain`. There
is no fallback from a CUDA tensor to a plain version. The TPU admission
rules (``_pick_block``, ``_VMEM_BUDGET``, ``fused_train_supported``) are
not ported: :func:`..axial_attention.fused_route` decides where it runs.
"""
from __future__ import annotations

import math

import torch

from ..kernels.build import library
from ..kernels.launch import (check_rows, check_tensor, launch, ptr,
                              strides)
from .attn_core import attn_core_plain
from .axial_lanes import NARROW_GP, check_gp

STRIPE_MAX_SPAN = 64
# the stripe kernels' group planes; axial_attention.fused_route sends a
# train site of any other width to the wide flash kernels, which compute
# the same function on the lanes layout
STRIPE_GP = NARROW_GP
# The backward's block (csrc/axial_stripe_bwd.cu: kWideGp, span_bucket,
# chunk_stripes): a block owns one group and a chunk of 4 stripes with
# positions at spans over 32 below BWD_WIDE_GP group planes, else 2; its
# partials have one slot per block
BWD_WIDE_GP = 8


def bwd_chunk_stripes(gp: int, L: int, has_pos: bool) -> int:
    """Stripes per block of a stripe backward launch."""
    return 4 if has_pos and L > 32 and gp < BWD_WIDE_GP else 2


def _has_pos(qemb: torch.Tensor) -> bool:
    return qemb.shape[0] > 0


def fused_attn_bwd_plain(q, k, v, qemb, kemb, vemb, sim_affine, dsv, dsve):
    """Plain version of the backward (``_bwd_kernel``): the softmax
    recomputed from the logits; ``(dq, dk, dv, dqemb, dkemb, dvemb, daff)``.
    Zero-size tables give zero-size table gradients."""
    has_pos = _has_pos(qemb)
    a = sim_affine[:, :, None, None]                     # (g, 8, 1, 1)
    qk = torch.einsum("sgci,sgcj->sgij", q, k)
    logits = qk * a[:, 0] + a[:, 1]
    if has_pos:
        qr = torch.einsum("sgci,cij->sgij", q, qemb)
        kr = torch.einsum("sgcj,cji->sgij", k, kemb)
        logits = logits + (qr * a[:, 2] + a[:, 3]) + (kr * a[:, 4] + a[:, 5])
    sim = torch.softmax(logits, dim=-1)
    dv = torch.einsum("sgpi,sgij->sgpj", dsv, sim)
    dsim = torch.einsum("sgpi,sgpj->sgij", dsv, v)
    if has_pos:
        dsim = dsim + torch.einsum("sgpi,pij->sgij", dsve, vemb)
    dlog = sim * (dsim - (sim * dsim).sum(dim=-1, keepdim=True))
    db = dlog.sum(dim=(0, 2, 3))
    zero = torch.zeros_like(db)
    d_qk = dlog * a[:, 0]
    dq = torch.einsum("sgij,sgcj->sgci", d_qk, k)
    dk = torch.einsum("sgij,sgci->sgcj", d_qk, q)
    sum_qk = (dlog * qk).sum(dim=(0, 2, 3))
    if not has_pos:
        daff = torch.stack([sum_qk, db] + [zero] * 6, dim=1)
        return dq, dk, dv, qemb, kemb, vemb, daff
    d_qr = dlog * a[:, 2]
    d_kr = dlog * a[:, 4]
    dq = dq + torch.einsum("sgij,cij->sgci", d_qr, qemb)
    dk = dk + torch.einsum("sgij,cji->sgcj", d_kr, kemb)
    dqemb = torch.einsum("sgij,sgci->cij", d_qr, q)
    dkemb = torch.einsum("sgij,sgcj->cji", d_kr, k)
    dvemb = torch.einsum("sgpi,sgij->pij", dsve, sim)
    daff = torch.stack([sum_qk, db, (dlog * qr).sum(dim=(0, 2, 3)), db,
                        (dlog * kr).sum(dim=(0, 2, 3)), db, zero, zero],
                       dim=1)
    return dq, dk, dv, dqemb, dkemb, dvemb, daff


# ---- kernel wrappers --------------------------------------------------------

def _check(q, k, v, qemb, kemb, vemb, sim_affine, name: str, **extra):
    """Validate what a kernel takes; returns (S, g, gp, L, has_pos).
    q, k and v may be stripe-major views (rows of L contiguous floats);
    the rest, and the further (S, g, gp, L) operands ``extra`` names, are
    dense."""
    if q.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be (S, g, rows, L)")
    S, g, c, L = q.shape
    gp = v.shape[2]
    check_gp(name, gp, narrow_only=True)
    if c != gp // 2:
        raise ValueError(f"{name}: q has {c} rows for gp={gp}")
    if not 1 <= L <= STRIPE_MAX_SPAN:
        raise ValueError(f"{name}: span {L} outside 1..{STRIPE_MAX_SPAN}")
    has_pos = _has_pos(qemb)
    for tname, t, shape in (("q", q, (S, g, c, L)), ("k", k, (S, g, c, L)),
                            ("v", v, (S, g, gp, L))):
        check_rows(name, tname, t, shape, q.device)
    shapes = {"sim_affine": (sim_affine, (g, 8))}
    tables = {"qemb": (qemb, (c, L, L)), "kemb": (kemb, (c, L, L)),
              "vemb": (vemb, (gp, L, L))}
    if has_pos:
        shapes.update(tables)
    else:
        for tname, (t, _) in tables.items():
            if t.numel():
                raise ValueError(f"{name}: {tname} must be empty when qemb is")
    shapes.update({tname: (t, (S, g, gp, L)) for tname, t in extra.items()})
    for tname, (t, shape) in shapes.items():
        check_tensor(name, tname, t, shape, q.device)
    return S, g, gp, L, has_pos


def stripe_attn_fwd(q, k, v, qemb, kemb, vemb, sim_affine):
    """Launch the forward kernel on CUDA tensors: ``(sv, sve)``; without
    positions ``sve`` is a zero view that allocates one element."""
    name = "stripe_attn_fwd"
    S, g, gp, L, has_pos = _check(q, k, v, qemb, kemb, vemb, sim_affine,
                                  name)
    sv = torch.empty((S, g, gp, L), dtype=torch.float32, device=q.device)
    sve = torch.empty_like(sv) if has_pos else sv   # not written w/o pos
    if S:           # no stripes (a rank with no rows): empty outputs
        launch(stripe_attn_fwd, library().medt_stripe_attn_fwd, q,
               ptr(q), ptr(k), ptr(v), ptr(qemb), ptr(kemb), ptr(vemb),
               ptr(sim_affine), ptr(sv), ptr(sve), *strides(q, k, v), S, g,
               gp, L, int(has_pos))
    if not has_pos:
        sve = torch.zeros((), dtype=sv.dtype, device=sv.device).expand(
            sv.shape)
    return sv, sve


stripe_attn_fwd.launches = 0


def bwd_buffers(device, S: int, g: int, gp: int, L: int,
                has_pos: bool) -> dict:
    """The backward's outputs and partials, in two allocations: dq, dk (S,
    g, c, L) and dv (S, g, gp, L); then dtables (2gp, L, L) (empty without
    positions), daff (g, 8), the table partials (n_tab, 2gp, L, L) and the
    daff partials (n_aff, g, 4), with n_aff = ceil(S / bwd_chunk_stripes(gp,
    L, has_pos)) blocks per group and n_tab = g * n_aff with positions, else
    0."""
    c = gp // 2
    n_aff = -(-S // bwd_chunk_stripes(gp, L, has_pos))
    n_tab = g * n_aff if has_pos else 0
    rows = 2 * gp if has_pos else 0
    shapes = {"dq": (S, g, c, L), "dk": (S, g, c, L), "dv": (S, g, gp, L),
              "dtables": (rows, L, L), "daff": (g, 8),
              "tab_part": (n_tab, rows, L, L), "aff_part": (n_aff, g, 4)}
    out = {}
    for names in (("dq", "dk", "dv"),
                  ("dtables", "daff", "tab_part", "aff_part")):
        sizes = [math.prod(shapes[n]) for n in names]
        buf = torch.empty((sum(sizes),), dtype=torch.float32, device=device)
        for n, view in zip(names, buf.split(sizes)):
            out[n] = view.view(shapes[n])
    return out


def stripe_attn_bwd(q, k, v, qemb, kemb, vemb, sim_affine, dsv, dsve):
    """Launch the backward kernel and its finalize on CUDA tensors: ``(dq,
    dk, dv, dqemb, dkemb, dvemb, daff)``. ``dsve`` is ignored (and may be
    any tensor) without positions. Scratch: the partials of
    :func:`bwd_buffers`."""
    name = "stripe_attn_bwd"
    extra = {"dsv": dsv}
    if _has_pos(qemb):
        extra["dsve"] = dsve
    S, g, gp, L, has_pos = _check(q, k, v, qemb, kemb, vemb, sim_affine,
                                  name, **extra)
    c = gp // 2
    b = bwd_buffers(q.device, S, g, gp, L, has_pos)
    if S == 0:      # no stripes: empty dq, dk, dv, zero table gradients
        b["dtables"].zero_()
        b["daff"].zero_()
    else:
        launch(stripe_attn_bwd, library().medt_stripe_attn_bwd, q,
               ptr(q), ptr(k), ptr(v), ptr(qemb), ptr(kemb), ptr(vemb),
               ptr(sim_affine), ptr(dsv), ptr(dsve if has_pos else dsv),
               ptr(b["dq"]), ptr(b["dk"]), ptr(b["dv"]), ptr(b["dtables"]),
               ptr(b["daff"]), ptr(b["tab_part"]), ptr(b["aff_part"]),
               *strides(q, k, v), S, g, gp, L, int(has_pos),
               b["tab_part"].shape[0], b["aff_part"].shape[0])
    dq, dk, dv, dtables, daff = (b[key] for key in
                                 ("dq", "dk", "dv", "dtables", "daff"))
    if not has_pos:
        return dq, dk, dv, qemb, kemb, vemb, daff        # zero-size tables
    return dq, dk, dv, dtables[:c], dtables[c:gp], dtables[gp:], daff


stripe_attn_bwd.launches = 0


# ---- autograd ---------------------------------------------------------------

class FusedAttnCore(torch.autograd.Function):
    """``fused_attn_core`` with its backward (``_fused_fwd_rule``/
    ``_fused_bwd_rule``): saves the inputs and recomputes the softmax."""

    @staticmethod
    def forward(ctx, q, k, v, qemb, kemb, vemb, sim_affine, plain=False):
        ctx.plain = plain or q.device.type == "cpu"
        ctx.has_pos = _has_pos(qemb)
        if ctx.plain:
            sv, sve = attn_core_plain(q, k, v, qemb, kemb, vemb, sim_affine,
                                      ctx.has_pos)
        else:
            sv, sve = stripe_attn_fwd(q, k, v, qemb, kemb, vemb, sim_affine)
        ctx.save_for_backward(q, k, v, qemb, kemb, vemb, sim_affine)
        if not ctx.has_pos:
            ctx.mark_non_differentiable(sve)
        return sv, sve

    @staticmethod
    def backward(ctx, dsv, dsve):
        q, k, v, qemb, kemb, vemb, aff = ctx.saved_tensors
        shape = (q.shape[0], q.shape[1], v.shape[2], q.shape[3])
        dsv = q.new_zeros(shape) if dsv is None else dsv.contiguous()
        if not ctx.has_pos:
            dsve = dsv
        else:
            dsve = q.new_zeros(shape) if dsve is None else dsve.contiguous()
        fn = fused_attn_bwd_plain if ctx.plain else stripe_attn_bwd
        dq, dk, dv, dqemb, dkemb, dvemb, daff = fn(q, k, v, qemb, kemb, vemb,
                                                   aff, dsv, dsve)
        if not ctx.has_pos:
            dqemb = dkemb = dvemb = None
        return dq, dk, dv, dqemb, dkemb, dvemb, daff, None


def fused_attn_core(q, k, v, qemb, kemb, vemb, sim_affine, plain=False):
    """Spans up to 64, differentiable: the kernels on CUDA tensors, the
    plain versions on CPU tensors or when ``plain`` is set."""
    return FusedAttnCore.apply(q, k, v, qemb, kemb, vemb, sim_affine, plain)


_WRAPPERS = (stripe_attn_fwd, stripe_attn_bwd)


def reset_launch_counts():
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}
