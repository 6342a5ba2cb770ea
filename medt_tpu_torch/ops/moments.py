"""Similarity-BN batch moments of the train-mode attention.

Port of ``medt_tpu/ops/pallas_moments.py`` (``moment_sums_core`` forward
and backward, ``logit_moments_lanes_fused``, ``qk_moments_lanes_fused``)
and of the stripe-major ``logit_moments``/``qk_moments`` of
``medt_tpu/ops/pallas_axial_train.py:388-435``.

In train mode the similarity BN normalises the qk, qr and kr logits with
their batch moments over every (query, key, stripe). Those moments factor
into sums over q and k alone, so no (S, g, L, L) logits tensor is formed::

    moment_sums(qkv, r_q, e_q, r_k, e_k) -> (g, 8)
        [s1_qk, s2_qk, s1_qr, s2_qr, s1_kr, s2_kr, 0, 0]

on the q/k rows of the fused ``(g, 2gp, L, S)`` qkv, with the tables
``r_q[c, i] = sum_j qemb[c, i, j]``, ``e_q[c, d, i] = sum_j qemb[c, i, j]
qemb[d, i, j]`` (``r_k``, ``e_k`` likewise on kemb in ``[c, j, i]``
coordinates); zero-size ``(0, L)`` / ``(0, 0, L)`` tables for the
position-free mode.

:func:`moment_sums` is differentiable (:class:`MomentSums`) and dispatches
like the attention cores: plain PyTorch on CPU tensors (or with ``plain``),
the kernels of ``csrc/moments.cu`` through :func:`moment_sums_fwd` and
:func:`moment_sums_bwd` on CUDA tensors, never a fallback (over no
stripes: zero sums, no launch). In a process group of more than one rank
the sums and their count are summed over the ranks before they become
moments (:mod:`..parallel.sync`), on every route.

qkv may be bf16 (JAX's bf16 kernel I/O): each kernel has a bf16 entry
point that converts each value where it is read and keeps the float32
kernel's arithmetic, so the sums equal the float32 kernel's on the upcast
qkv and the backward's dqkv, written in bf16, is its gradient rounded once
(launches in ``.launches_bf16``). The tables and sums stay float32. The
plain versions take bf16 qkv as its exact upcast and round dqkv once.

At the wide widths (every even gp up to 128 outside 2, 4, 8 and 16:
``axial_lanes.is_wide``) the entry points, float32 and bf16, run kernels
of their own (``csrc/moments_wide.cu``: ``moments_wide_fwd_kernel``, and
``moments_wide_dqk_kernel`` with ``moments_wide_tab_kernel`` for the
backward) under the same finalizes; the forward's partials have a slot
per block of its tile, a count that the kernel library gives
(:func:`fwd_slots`), the backward's table partials a slot per split of
the stripes (:func:`wide_bwd_slots`), and the backward takes spans
up to ``BWD_MAX_SPAN`` (256) as the narrow widths do (above about 160
its dq/dk kernel forms each stripe's (L, L) w in tiles of rows).
"""
from __future__ import annotations

import torch

from ..kernels.build import library
from ..kernels.launch import (
    QKV_DTYPES,
    check_tensor,
    counts_of,
    entry,
    launch,
    ptr,
    reset_counts,
    widened,
)
from ..parallel import sync
from .axial_lanes import check_gp, is_wide


def _split_qk(qkv):
    gp = qkv.shape[1] // 2
    c = gp // 2
    return qkv[:, :c], qkv[:, c:gp]


def _has_pos(r_q) -> bool:
    return r_q.shape[0] > 0


def moment_sums_plain(qkv, r_q, e_q, r_k, e_k):
    """Plain version of the moments kernel: the (g, 8) sums."""
    q, k = _split_qk(widened(qkv))                         # (g, c, L, S)
    qs, ks = q.sum(dim=2), k.sum(dim=2)                   # (g, c, S)
    qq = torch.einsum("gcls,gdls->gcds", q, q)
    kk = torch.einsum("gcls,gdls->gcds", k, k)
    s1_qk = (qs * ks).sum(dim=(1, 2))
    s2_qk = (qq * kk).sum(dim=(1, 2, 3))
    zero = torch.zeros_like(s1_qk)
    if _has_pos(r_q):
        s1_qr = torch.einsum("gcls,cl->g", q, r_q)
        s2_qr = torch.einsum("gcls,cdl,gdls->g", q, e_q, q)
        s1_kr = torch.einsum("gcls,cl->g", k, r_k)
        s2_kr = torch.einsum("gcls,cdl,gdls->g", k, e_k, k)
    else:
        s1_qr = s2_qr = s1_kr = s2_kr = zero
    return torch.stack([s1_qk, s2_qk, s1_qr, s2_qr, s1_kr, s2_kr, zero, zero],
                       dim=1)


def moment_sums_bwd_plain(qkv, r_q, e_q, r_k, e_k, ct):
    """Plain version of the moments backward (``_moments_bwd_kernel``):
    ``(dqkv, dr_q, de_q, dr_k, de_k)`` for the cotangent ``ct`` (g, 8);
    the v rows of dqkv are zero (dqkv in qkv's dtype)."""
    dtype = qkv.dtype
    qkv = widened(qkv)
    q, k = _split_qk(qkv)
    g, c, L, S = q.shape
    qs, ks = q.sum(dim=2), k.sum(dim=2)
    qq = torch.einsum("gcls,gdls->gcds", q, q)
    kk = torch.einsum("gcls,gdls->gcds", k, k)
    col = [ct[:, i, None, None, None] for i in range(6)]  # (g, 1, 1, 1)
    dq = col[0] * ks[:, :, None, :] + 2.0 * col[1] * torch.einsum(
        "gcds,gdls->gcls", kk, q)
    dk = col[0] * qs[:, :, None, :] + 2.0 * col[1] * torch.einsum(
        "gcds,gdls->gcls", qq, k)
    if _has_pos(r_q):
        e_q2 = e_q + e_q.transpose(0, 1)
        e_k2 = e_k + e_k.transpose(0, 1)
        dq = dq + col[2] * r_q[None, :, :, None] + col[3] * torch.einsum(
            "cdl,gdls->gcls", e_q2, q)
        dk = dk + col[4] * r_k[None, :, :, None] + col[5] * torch.einsum(
            "cdl,gdls->gcls", e_k2, k)
        dr_q = torch.einsum("g,gcls->cl", ct[:, 2], q)
        de_q = torch.einsum("g,gcls,gdls->cdl", ct[:, 3], q, q)
        dr_k = torch.einsum("g,gcls->cl", ct[:, 4], k)
        de_k = torch.einsum("g,gcls,gdls->cdl", ct[:, 5], k, k)
    else:
        dr_q, de_q, dr_k, de_k = r_q, e_q, r_k, e_k       # zero-size
    dqkv = torch.cat([dq, dk, torch.zeros_like(qkv[:, 2 * c:])], dim=1)
    return dqkv.to(dtype), dr_q, de_q, dr_k, de_k


def _check(qkv, r_q, e_q, r_k, e_k, name, **extra):
    """Validate what a moments kernel takes; returns (g, gp, L, S,
    has_pos)."""
    if qkv.dim() != 4:
        raise ValueError(f"{name}: qkv must be (g, 2gp, L, S), got "
                         f"{tuple(qkv.shape)}")
    g, r2, L, S = qkv.shape
    gp = r2 // 2
    c = gp // 2
    check_gp(name, r2 / 2 if r2 % 2 else gp)
    has_pos = _has_pos(r_q)
    shapes = {"qkv": (qkv, (g, r2, L, S))}
    tables = {"r_q": (r_q, (c, L)), "e_q": (e_q, (c, c, L)),
              "r_k": (r_k, (c, L)), "e_k": (e_k, (c, c, L))}
    if has_pos:
        shapes.update(tables)
    else:
        for tname, (t, _) in tables.items():
            if t.numel():
                raise ValueError(f"{name}: {tname} must be empty when r_q is")
    shapes.update(extra)
    for tname, (t, shape) in shapes.items():
        check_tensor(name, tname, t, shape, qkv.device,
                     QKV_DTYPES if tname == "qkv" else (torch.float32,))
    return g, gp, L, S, has_pos


# stripes per block of the moments forward (csrc/moments.cu: kFwdStripes)
FWD_STRIPES = 32


def fwd_slots(gp: int, L: int, S: int, g: int) -> int:
    """Partial slots of a moments forward launch, one per block: blocks of
    FWD_STRIPES stripes, or at a wide gp of the wide forward's tile, whose
    count the kernel library gives (csrc/moments.cu:
    medt_moment_sums_fwd_slots)."""
    if not is_wide(gp) or S == 0:
        return g * -(-S // FWD_STRIPES)
    n_part = library().medt_moment_sums_fwd_slots(g, gp, L, S)
    if n_part < 0:
        raise ValueError(f"moment_sums_fwd: no kernel for g {g}, gp {gp}, "
                         f"L {L}, S {S}")
    return n_part


def fwd_buffers(qkv, g, gp, L, S):
    """The forward's (g, 8) sums and, in the same allocation, its tile
    partials (n_part, 6), one per block (fwd_slots): ``(out, part,
    n_part)``."""
    n_part = fwd_slots(gp, L, S, g)
    buf = torch.empty((g * 8 + n_part * 6,), dtype=torch.float32,
                      device=qkv.device)
    return buf[:g * 8].view(g, 8), buf[g * 8:].view(n_part, 6), n_part


def moment_sums_fwd(qkv, r_q, e_q, r_k, e_k):
    """Launch the moments kernel and its finalize on CUDA tensors: the
    (g, 8) sums."""
    g, gp, L, S, has_pos = _check(qkv, r_q, e_q, r_k, e_k, "moment_sums_fwd")
    out, part, n_part = fwd_buffers(qkv, g, gp, L, S)
    if S == 0:      # no stripes (a rank with no rows): zero sums, no launch
        return out.zero_()
    launch(moment_sums_fwd,
           getattr(library(), entry("moment_sums_fwd", qkv)), qkv,
           ptr(qkv), ptr(r_q), ptr(e_q), ptr(r_k), ptr(e_k), ptr(out),
           ptr(part), g, gp, L, S, int(has_pos), n_part)
    return out


# The moments backward's tile (csrc/moments.cu: kSlabFloats, kMinTile,
# kMaxTile, kMinBlocks, kMaxBwdSpan and bwd_tile): a block owns one group
# and TS stripes, TS the largest of 32, 16, 8 whose q/k slab (2c x L x TS
# floats) fits the budget and whose grid has at least 132 blocks; its table
# partials have one slot per block
BWD_SLAB_FLOATS = 16384
BWD_MIN_TILE = 8
BWD_MAX_TILE = 32
BWD_MIN_BLOCKS = 132
BWD_MAX_SPAN = 256


def bwd_tile(c: int, L: int, S: int, g: int) -> int:
    """Stripes per block of a moments backward launch."""
    ts = BWD_MAX_TILE
    while ts > BWD_MIN_TILE and (2 * c * L * ts > BWD_SLAB_FLOATS
                                 or g * -(-S // ts) < BWD_MIN_BLOCKS):
        ts //= 2
    return ts


# The wide widths' backward (csrc/moments_wide.cuh: kWideMinBlocks,
# kWideTabStripes, wide_bwd_slots): its table partials
# have one slot per split of the stripes, splits added until the (span x 2
# x splits) grid reaches 264 blocks, each at least 32 stripes
WIDE_MIN_BLOCKS = 264
WIDE_TAB_STRIPES = 32


def wide_bwd_slots(L: int, S: int) -> int:
    """Table-partial slots of a moments backward launch at a wide gp."""
    return min(-(-WIDE_MIN_BLOCKS // (2 * L)), -(-S // WIDE_TAB_STRIPES))


def bwd_slots(gp: int, L: int, S: int, g: int) -> int:
    """Table-partial slots of a moments backward launch with positions."""
    if is_wide(gp):
        return wide_bwd_slots(L, S)
    return g * -(-S // bwd_tile(gp // 2, L, S, g))


def bwd_buffers(qkv, g, gp, L, S, has_pos):
    """dqkv (in qkv's dtype) and, in one more allocation, dtables (2c + 2c^2, L) then the
    table partials (n_part, 2c + 2c^2, L), both empty without positions:
    ``(dqkv, dtables, part, n_part)``."""
    c = gp // 2
    rows = 2 * c + 2 * c * c if has_pos else 0
    n_part = bwd_slots(gp, L, S, g) if has_pos else 0
    f32 = dict(dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty(tuple(qkv.shape), dtype=qkv.dtype, device=qkv.device)
    tables = torch.empty(((1 + n_part) * rows * L,), **f32)
    dtables = tables[:rows * L].view(rows, L)
    part = tables[rows * L:].view(n_part, rows, L)
    return dqkv, dtables, part, n_part


def moment_sums_bwd(qkv, r_q, e_q, r_k, e_k, ct):
    """Launch the moments backward on CUDA tensors (spans up to 256):
    ``(dqkv, dr_q, de_q, dr_k, de_k)``."""
    g, gp, L, S, has_pos = _check(
        qkv, r_q, e_q, r_k, e_k, "moment_sums_bwd",
        ct=(ct, (qkv.shape[0], 8)))
    if L > BWD_MAX_SPAN:
        raise ValueError(f"moment_sums_bwd: span {L} > {BWD_MAX_SPAN}")
    c = gp // 2
    dqkv, dtables, part, n_part = bwd_buffers(qkv, g, gp, L, S, has_pos)
    if S == 0:      # no stripes: empty dqkv, zero table gradients
        dtables.zero_()
    else:
        launch(moment_sums_bwd,
               getattr(library(), entry("moment_sums_bwd", qkv)), qkv,
               ptr(qkv), ptr(r_q), ptr(e_q), ptr(r_k), ptr(e_k), ptr(ct),
               ptr(dqkv), ptr(dtables), ptr(part), g, gp, L, S, int(has_pos),
               n_part)
    if not has_pos:
        return dqkv, r_q, e_q, r_k, e_k                   # zero-size
    cc = c * c
    dr_q = dtables[:c]
    de_q = dtables[c:c + cc].reshape(c, c, L)
    dr_k = dtables[c + cc:2 * c + cc]
    de_k = dtables[2 * c + cc:].reshape(c, c, L)
    return dqkv, dr_q, de_q, dr_k, de_k


class MomentSums(torch.autograd.Function):
    """``moment_sums_core`` with its backward (``_sums_fwd_rule``/
    ``_sums_bwd_rule``): saves the inputs."""

    @staticmethod
    def forward(ctx, qkv, r_q, e_q, r_k, e_k, plain=False):
        ctx.plain = plain or qkv.device.type == "cpu"
        ctx.save_for_backward(qkv, r_q, e_q, r_k, e_k)
        if ctx.plain:
            return moment_sums_plain(qkv, r_q, e_q, r_k, e_k)
        return moment_sums_fwd(qkv, r_q, e_q, r_k, e_k)

    @staticmethod
    def backward(ctx, ct):
        qkv, r_q, e_q, r_k, e_k = ctx.saved_tensors
        fn = moment_sums_bwd_plain if ctx.plain else moment_sums_bwd
        grads = fn(qkv, r_q, e_q, r_k, e_k, ct.contiguous())
        assert grads[0].dtype == qkv.dtype, (grads[0].dtype, qkv.dtype)
        if not _has_pos(r_q):
            return grads[0], None, None, None, None, None
        return (*grads, None)


def moment_sums(qkv, r_q, e_q, r_k, e_k, plain=False):
    """Differentiable moment sums (g, 8): the kernels on CUDA tensors, the
    plain versions on CPU tensors or when ``plain`` is set."""
    return MomentSums.apply(qkv, r_q, e_q, r_k, e_k, plain)


def _logit_stats(sums, n: int, has_pos: bool):
    """Mean and biased variance of the logits from their (g, 8) sums and
    count ``n``, summed over the ranks first in a process group of more
    than one rank (:mod:`..parallel.sync`): rows qk/qr/kr, each (3, g),
    with positions, else qk alone, each (g,); and the count."""
    sums, n = sync.sum_over_ranks(sums, n)
    if has_pos:
        mean = torch.stack([sums[:, 0], sums[:, 2], sums[:, 4]]) / n
        msq = torch.stack([sums[:, 1], sums[:, 3], sums[:, 5]]) / n
    else:
        mean, msq = sums[:, 0] / n, sums[:, 1] / n
    return mean, torch.clamp(msq - mean * mean, min=0.0), n


def logit_moments_lanes_fused(qkv, qemb, kemb, plain=False):
    """Batch mean and biased variance (each (3, g), rows qk/qr/kr) of the
    similarity logits, and their count S*L*L. ``qemb``/``kemb``: (c, L, L)
    gate-folded tables in the ``all_emb`` coordinates (kr reads kemb as
    [c, j, i])."""
    _, _, L, S = qkv.shape
    r_q = qemb.sum(dim=2)                                 # (c, i)
    e_q = torch.einsum("cij,dij->cdi", qemb, qemb)        # (c, c, i)
    r_k = kemb.sum(dim=2)                                 # (c, j)
    e_k = torch.einsum("cji,dji->cdj", kemb, kemb)        # (c, c, j)
    sums = moment_sums(qkv, r_q.contiguous(), e_q.contiguous(),
                       r_k.contiguous(), e_k.contiguous(), plain)
    return _logit_stats(sums, S * L * L, has_pos=True)


def qk_moments_lanes_fused(qkv, plain=False):
    """Position-free variant: mean and biased variance (each (g,)) of the
    qk logits, and their count."""
    _, _, L, S = qkv.shape
    zr = qkv.new_zeros((0, L), dtype=torch.float32)
    ze = qkv.new_zeros((0, 0, L), dtype=torch.float32)
    sums = moment_sums(qkv, zr, ze, zr, ze, plain)
    return _logit_stats(sums, S * L * L, has_pos=False)


def _qk_sums(q, k):
    """The qk logits' sum and sum of squares (each (g,)) on stripe-major
    q, k (S, g, c, L)."""
    qs, ks = q.sum(dim=3), k.sum(dim=3)
    s1 = torch.einsum("sgc,sgc->g", qs, ks)
    qq = torch.einsum("sgcl,sgdl->sgcd", q, q)
    kk = torch.einsum("sgcl,sgdl->sgcd", k, k)
    return s1, torch.einsum("sgcd,sgcd->g", qq, kk)


def logit_moments(q, k, qemb, kemb):
    """Stripe-major version (``pallas_axial_train.logit_moments``): q, k
    (S, g, c, L); returns mean, biased var (3, g) and the count."""
    S, g, c, L = q.shape
    s1_qk, s2_qk = _qk_sums(q, k)
    r_q = qemb.sum(dim=2)
    s1_qr = torch.einsum("sgci,ci->g", q, r_q)
    e_q = torch.einsum("cij,dij->icd", qemb, qemb)
    s2_qr = torch.einsum("sgci,icd,sgdi->g", q, e_q, q)
    r_k = kemb.sum(dim=2)
    s1_kr = torch.einsum("sgcj,cj->g", k, r_k)
    e_k = torch.einsum("cji,dji->jcd", kemb, kemb)
    s2_kr = torch.einsum("sgcj,jcd,sgdj->g", k, e_k, k)
    zero = torch.zeros_like(s1_qk)
    sums = torch.stack([s1_qk, s2_qk, s1_qr, s2_qr, s1_kr, s2_kr, zero, zero],
                       dim=1)
    return _logit_stats(sums, S * L * L, has_pos=True)


def qk_moments(q, k):
    """Stripe-major position-free version (``pallas_axial_train.
    qk_moments``): mean, biased var (g,) and the count."""
    S, g, c, L = q.shape
    s1, s2 = _qk_sums(q, k)
    zero = torch.zeros_like(s1)
    sums = torch.stack([s1, s2] + [zero] * 6, dim=1)
    return _logit_stats(sums, S * L * L, has_pos=False)


_WRAPPERS = (moment_sums_fwd, moment_sums_bwd)


def reset_launch_counts():
    reset_counts(_WRAPPERS)


def launch_counts() -> dict:
    return counts_of(_WRAPPERS)


for _fn in _WRAPPERS:
    _fn.launches = _fn.launches_bf16 = 0
