"""Lanes-attention cores: CUDA kernels, their plain versions and autograd.

Port of ``medt_tpu/ops/pallas_axial_lanes.py``: ``lanes_attn_core`` (spans
<= 16), ``flash_lanes_core`` (spans 17..64) and ``flash2_lanes_core``
(spans 65..256), forward and backward. Same contract as the JAX
functions::

    qkv     (g, 2gp, L, S)  rows [0:c]=q, [c:gp]=k, [gp:2gp]=v, c = gp//2
    qemb    (c, L, L)       zero-size (0, L, L) tables without positions
    kemb_t  (c, L, L)       swapped: kemb_t[c, i, j] = kemb[c, j, i]
    vemb    (gp, L, L)
    sim_affine (g, 8)       attn_core.pack_sim_affine layout
    -> sv, sve (g, gp, L, S); sve is zero without positions

and the backward gives ``(dqkv, dqemb, dkemb_t, dvemb, daff)`` from
``(dsv, dsve)``. As in JAX, the lanes backward recomputes the softmax from
the logits, and the flash and flash2 backwards rebuild it from the
forward's saved row max ``m`` and denominator ``l`` with delta taken from
the saved ``sv, sve``. flash2 computes the same function as flash, so
their plain versions are one function.

:func:`lanes_attn_core`, :func:`flash_lanes_core` and
:func:`flash2_lanes_core` are differentiable (autograd Functions
:class:`LanesAttnCore`, :class:`FlashLanesCore`, :class:`Flash2LanesCore`)
and dispatch on where their input lies: on CPU tensors they run the plain
PyTorch versions beside them; on CUDA tensors they launch the kernels of
``csrc/axial_lanes_{fwd,bwd}.cu``, ``csrc/axial_flash_{fwd,bwd}.cu`` and
``csrc/axial_flash2_{fwd,bwd}.cu`` (the flash and flash2 forwards are one
tiled kernel, ``csrc/tiled_fwd.cuh``, and their backwards one tiled kernel
pair, ``csrc/tiled_bwd.cuh``, each under two tile policies) through
their wrappers (:func:`lanes_attn_fwd`, :func:`flash_lanes_fwd`,
:func:`flash2_lanes_fwd`, :func:`lanes_attn_bwd`, :func:`flash_lanes_bwd`,
:func:`flash2_lanes_bwd`), which check device, dtype, shape and
contiguity and raise on anything else. There is no
fallback from a CUDA tensor to a plain version: only an explicit ``plain``
argument runs the plain versions on the card. Each wrapper counts its
launches in ``.launches``; a call over no stripes (S = 0: a rank of a
data-parallel step that holds no rows) has nothing to compute and returns
empty outputs and zero table gradients without a launch or a count.

qkv may be float32 or bf16 (JAX's bf16 kernel I/O): every kernel has a
bf16 entry point beside its float32 one (``medt_<name>_bf16``), which
converts each value where it is read and keeps every float32 operation
and its order, so its outputs equal the float32 kernel's on the upcast
qkv; the backward writes dqkv in bf16, the float32 gradient rounded once
at the store. Its launches count in ``.launches_bf16``. Every other
operand (tables, affine, sv, sve, m, l, dsv, dsve) and every other output
is float32. The plain versions take bf16 qkv as its exact float32 upcast
and round dqkv once. The TPU kernels' blocking (``_JB_*``, ``Sb``, VMEM
budgets) is not ported: the kernels size themselves for the H100.

Group planes: the lanes and flash kernels take every even gp from 2 to
128 (``MAX_GP``), as the Pallas kernels do. At gp 2, 4, 8 and 16
(``NARROW_GP``) they run the designs above; at every other width
(:func:`is_wide`: the axial-attention classifiers' gp 12 to 128) their
wrappers launch ``csrc/axial_wide.cu`` (the forward: one query row a
thread, the value channels in chunks of 16) or ``csrc/axial_wide_bwd.cu``
(the backward: register-tiled row and column passes over a (g, L, L, S)
scratch of p and dlog, the table gradients as products over the stripes),
in float32 or bf16, and count the launch as their own. The flash2
wrappers take the same widths: at a wide gp they launch the long-span
wide kernels, ``csrc/axial_wide_long_fwd.cu`` (two query rows a thread,
the key tiles staged by cp.async, the softmax online, the accumulators in
registers) and ``csrc/axial_wide_long_bwd.cu`` with ``_col.cu`` (a row
pass that also sums the table gradients into a bounded number of partial
slots, :func:`long_bwd_slices`, and a column pass, both rebuilding p from
m and l: no (g, L, L, S) scratch), at spans up to 256
(``csrc/wide_long.cuh``). Any other gp raises
``ValueError`` (:func:`check_gp`).
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
from .attn_core import attend, attn_logits

LANES_MAX_SPAN = 16
FLASH_MAX_SPAN = 64
FLASH2_MAX_SPAN = 256
# the first designs' widths; every other even gp up to MAX_GP takes the
# wide kernels
NARROW_GP = (2, 4, 8, 16)
MAX_GP = 128
GP_OPEN = ("ROADMAP.md section 2: the stripe kernels keep gp <= 16 (a "
           "wider train site takes the flash route), and no kernel takes an "
           "odd gp or one over 128")


def is_wide(gp: int) -> bool:
    """Whether a width runs the wide kernels (every even gp up to 128
    outside ``NARROW_GP``)."""
    return gp not in NARROW_GP


def check_gp(name: str, gp, narrow_only: bool = False):
    """Raise ``ValueError`` unless a kernel takes ``gp`` group planes: an
    even gp from 2 to ``MAX_GP`` (the lanes, flash and flash2 kernels at
    every span they take); with ``narrow_only`` (the stripe kernels) one
    of ``NARROW_GP``."""
    if gp != int(gp) or gp % 2 or not 2 <= gp <= MAX_GP:
        raise ValueError(f"{name}: group planes gp={gp}: the kernels take "
                         f"an even gp from 2 to {MAX_GP}; {GP_OPEN}")
    if narrow_only and gp not in NARROW_GP:
        raise ValueError(f"{name}: group planes gp={gp} not in {NARROW_GP}; "
                         f"{GP_OPEN}")


def _has_pos(qemb: torch.Tensor) -> bool:
    return qemb.shape[0] > 0


def _to_stripes(qkv: torch.Tensor):
    """(g, 2gp, L, S) -> q (S, g, c, L), k (S, g, c, L), v (S, g, gp, L)."""
    gp = qkv.shape[1] // 2
    c = gp // 2
    t = qkv.permute(3, 0, 1, 2)
    return t[:, :, :c], t[:, :, c:gp], t[:, :, gp:]


def _plain(qkv, qemb, kemb_t, vemb, sim_affine):
    has_pos = _has_pos(qemb)
    q, k, v = _to_stripes(widened(qkv))
    kemb = kemb_t.transpose(1, 2) if has_pos else kemb_t
    logits = attn_logits(q, k, qemb, kemb, sim_affine, has_pos)
    sv, sve = attend(logits, v, vemb, has_pos)
    back = (1, 2, 3, 0)  # (S, g, gp, L) -> (g, gp, L, S)
    return logits, sv.permute(back).contiguous(), \
        sve.permute(back).contiguous()


def lanes_attn_plain(qkv, qemb, kemb_t, vemb, sim_affine):
    """Plain PyTorch version of the lanes kernel: ``(sv, sve)``."""
    _, sv, sve = _plain(qkv, qemb, kemb_t, vemb, sim_affine)
    return sv, sve


def flash_lanes_plain(qkv, qemb, kemb_t, vemb, sim_affine):
    """Plain PyTorch version of the flash kernel: ``(sv, sve, m, l)`` with
    ``m`` the row max of the logits and ``l`` the softmax denominator,
    each (g, L, S)."""
    logits, sv, sve = _plain(qkv, qemb, kemb_t, vemb, sim_affine)
    m = logits.amax(dim=-1)                              # (S, g, L)
    l = torch.exp(logits - m[..., None]).sum(dim=-1)
    return sv, sve, m.permute(1, 2, 0).contiguous(), \
        l.permute(1, 2, 0).contiguous()


# ---- plain backward versions ------------------------------------------------
#
# Layout (g, ., L, S) throughout; the (L, L) pair tensors are (g, i, j, S).

def _bwd_logits(qkv, qemb, kemb_t, aff, has_pos):
    """q, k, v and the logit terms qk, qr, kr (g, i, j, S) and logits."""
    gp = qkv.shape[1] // 2
    c = gp // 2
    q, k, v = qkv[:, :c], qkv[:, c:gp], qkv[:, gp:]
    a = aff[:, :, None, None, None]                      # (g, 8, 1, 1, 1)
    qk = torch.einsum("gcis,gcjs->gijs", q, k)
    logits = qk * a[:, 0] + a[:, 1]
    qr = kr = None
    if has_pos:
        qr = torch.einsum("gcis,cij->gijs", q, qemb)
        kr = torch.einsum("gcjs,cij->gijs", k, kemb_t)
        logits = logits + (qr * a[:, 2] + a[:, 3]) + (kr * a[:, 4] + a[:, 5])
    return q, k, v, qk, qr, kr, logits


def _bwd_from_probs(q, k, v, qk, qr, kr, sim, dlog_of, qemb, kemb_t, vemb,
                    aff, dsv, dsve, has_pos):
    """Every gradient from the probabilities ``sim`` (g, i, j, S); ``dlog_of``
    maps dsim to the logits' gradient (the softmax backward)."""
    a = aff
    dsim = torch.einsum("gpis,gpjs->gijs", dsv, v)
    if has_pos:
        dsim = dsim + torch.einsum("gpis,pij->gijs", dsve, vemb)
    dlog = dlog_of(dsim)
    a0 = a[:, 0, None, None, None]
    dv = torch.einsum("gpis,gijs->gpjs", dsv, sim)
    dq = torch.einsum("gijs,gcjs->gcis", dlog * a0, k)
    dk = torch.einsum("gijs,gcis->gcjs", dlog * a0, q)
    db = dlog.sum(dim=(1, 2, 3))
    zero = torch.zeros_like(db)
    if has_pos:
        d_qr = dlog * a[:, 2, None, None, None]
        d_kr = dlog * a[:, 4, None, None, None]
        dq = dq + torch.einsum("gijs,cij->gcis", d_qr, qemb)
        dk = dk + torch.einsum("gijs,cij->gcjs", d_kr, kemb_t)
        dqemb = torch.einsum("gijs,gcis->cij", d_qr, q)
        dkemb_t = torch.einsum("gijs,gcjs->cij", d_kr, k)
        dvemb = torch.einsum("gijs,gpis->pij", sim, dsve)
        daff = torch.stack([(dlog * qk).sum(dim=(1, 2, 3)), db,
                            (dlog * qr).sum(dim=(1, 2, 3)), db,
                            (dlog * kr).sum(dim=(1, 2, 3)), db, zero, zero],
                           dim=1)
    else:
        dqemb, dkemb_t, dvemb = qemb, kemb_t, vemb  # zero-size
        daff = torch.stack([(dlog * qk).sum(dim=(1, 2, 3)), db] + [zero] * 6,
                           dim=1)
    dqkv = torch.cat([dq, dk, dv], dim=1)
    return dqkv, dqemb, dkemb_t, dvemb, daff


def _in_dtype(qkv, grads):
    """The backward's gradients with dqkv rounded once to qkv's dtype."""
    dqkv, *rest = grads
    return (dqkv.to(qkv.dtype), *rest)


def lanes_attn_bwd_plain(qkv, qemb, kemb_t, vemb, sim_affine, dsv, dsve):
    """Plain version of the lanes backward (``_bwd_kernel``): the softmax
    recomputed from the logits; ``(dqkv, dqemb, dkemb_t, dvemb, daff)``."""
    has_pos = _has_pos(qemb)
    q, k, v, qk, qr, kr, logits = _bwd_logits(widened(qkv), qemb, kemb_t,
                                              sim_affine, has_pos)
    sim = torch.softmax(logits, dim=2)
    return _in_dtype(qkv, _bwd_from_probs(
        q, k, v, qk, qr, kr, sim,
        lambda dsim: sim * (dsim - (sim * dsim).sum(dim=2, keepdim=True)),
        qemb, kemb_t, vemb, sim_affine, dsv, dsve, has_pos))


def flash_lanes_bwd_plain(qkv, qemb, kemb_t, vemb, sim_affine, m, l, sv, sve,
                          dsv, dsve):
    """Plain version of the flash backward (``_flash_bwd_kernel``):
    probabilities from the saved ``(m, l)``, delta from the saved outputs
    ``delta = sum_p dsv*sv + dsve*sve``."""
    has_pos = _has_pos(qemb)
    q, k, v, qk, qr, kr, logits = _bwd_logits(widened(qkv), qemb, kemb_t,
                                              sim_affine, has_pos)
    sim = torch.exp(logits - m[:, :, None, :]) * (1.0 / l)[:, :, None, :]
    delta = (dsv * sv).sum(dim=1)
    if has_pos:
        delta = delta + (dsve * sve).sum(dim=1)
    return _in_dtype(qkv, _bwd_from_probs(
        q, k, v, qk, qr, kr, sim,
        lambda dsim: sim * (dsim - delta[:, :, None, :]),
        qemb, kemb_t, vemb, sim_affine, dsv, dsve, has_pos))


# flash2 computes the flash function (the lanes contract with m and l); its
# plain versions are the flash ones, which take any span
flash2_lanes_plain = flash_lanes_plain
flash2_lanes_bwd_plain = flash_lanes_bwd_plain


# ---- kernel wrappers --------------------------------------------------------

def _check(qkv, qemb, kemb_t, vemb, sim_affine, max_span: int, name: str,
           **extra):
    """Validate what a kernel takes; returns (g, gp, L, S, has_pos).
    ``extra`` names further operands: ``"gp"``-shaped (g, gp, L, S) or
    ``"row"``-shaped (g, L, S) tensors, given as (tensor, kind)."""
    if qkv.dim() != 4:
        raise ValueError(f"{name}: qkv must be (g, 2gp, L, S), got "
                         f"{tuple(qkv.shape)}")
    g, r2, L, S = qkv.shape
    gp = r2 // 2
    c = gp // 2
    has_pos = _has_pos(qemb)
    check_gp(name, r2 / 2 if r2 % 2 else gp)
    if not 1 <= L <= max_span:
        raise ValueError(f"{name}: span {L} outside 1..{max_span}")
    tables = {"qemb": (qemb, (c, L, L)), "kemb_t": (kemb_t, (c, L, L)),
              "vemb": (vemb, (gp, L, L))}
    shapes = {"qkv": (qkv, (g, r2, L, S)), "sim_affine": (sim_affine, (g, 8))}
    if has_pos:
        shapes.update(tables)
    else:
        for tname, (t, _) in tables.items():
            if t.numel():
                raise ValueError(f"{name}: {tname} must be empty when qemb is")
    kinds = {"gp": (g, gp, L, S), "row": (g, L, S)}
    for tname, (t, kind) in extra.items():
        shapes[tname] = (t, kinds[kind])
    for tname, (t, shape) in shapes.items():
        check_tensor(name, tname, t, shape, qkv.device,
                     QKV_DTYPES if tname == "qkv" else (torch.float32,))
    return g, gp, L, S, has_pos


def _zeros_like_view(t: torch.Tensor) -> torch.Tensor:
    """A zero tensor of ``t``'s shape that allocates one element."""
    return torch.zeros((), dtype=t.dtype, device=t.device).expand(t.shape)


def _no_stripes_fwd(qkv, g, gp, L, save_ml: bool):
    """A forward over no stripes (a rank of a data-parallel step that holds
    no rows): empty outputs, no launch and no count."""
    sv = torch.empty((g, gp, L, 0), dtype=torch.float32, device=qkv.device)
    if not save_ml:
        return sv, torch.empty_like(sv)
    m = torch.empty((g, L, 0), dtype=torch.float32, device=qkv.device)
    return sv, torch.empty_like(sv), m, torch.empty_like(m)


def _wide_fwd(wrapper, qkv, qemb, kemb_t, vemb, sim_affine, g, gp, L, S,
              has_pos, save_ml: bool):
    """The forward at a wide gp (``medt_wide_attn_fwd``, or its bf16 entry
    point), counted as a launch of ``wrapper``: ``(sv, sve)``, and ``m, l``
    with ``save_ml``."""
    dev = qkv.device
    sv = torch.empty((g, gp, L, S), dtype=torch.float32, device=dev)
    sve = torch.empty_like(sv) if has_pos else sv
    m = torch.empty((g, L, S), dtype=torch.float32, device=dev) \
        if save_ml else sv
    l = torch.empty_like(m) if save_ml else sv
    launch(wrapper, getattr(library(), entry("wide_attn_fwd", qkv)), qkv,
           ptr(qkv), ptr(qemb), ptr(kemb_t), ptr(vemb), ptr(sim_affine),
           ptr(sv), ptr(sve), ptr(m), ptr(l), g, gp, L, S, int(has_pos),
           int(save_ml))
    sve = sve if has_pos else _zeros_like_view(sv)
    return (sv, sve, m, l) if save_ml else (sv, sve)


def lanes_attn_fwd(qkv, qemb, kemb_t, vemb, sim_affine):
    """Launch the lanes kernel (spans <= 16) on CUDA tensors."""
    g, gp, L, S, has_pos = _check(qkv, qemb, kemb_t, vemb, sim_affine,
                                  LANES_MAX_SPAN, "lanes_attn_fwd")
    if S == 0:
        return _no_stripes_fwd(qkv, g, gp, L, save_ml=False)
    if is_wide(gp):
        return _wide_fwd(lanes_attn_fwd, qkv, qemb, kemb_t, vemb, sim_affine,
                         g, gp, L, S, has_pos, save_ml=False)
    sv = torch.empty((g, gp, L, S), dtype=torch.float32, device=qkv.device)
    sve = torch.empty_like(sv) if has_pos else sv  # not written without pos
    launch(lanes_attn_fwd, getattr(library(), entry("lanes_attn_fwd", qkv)),
           qkv, ptr(qkv), ptr(qemb), ptr(kemb_t), ptr(vemb),
           ptr(sim_affine), ptr(sv), ptr(sve), g, gp, L, S, int(has_pos))
    return sv, (sve if has_pos else _zeros_like_view(sv))


def _streamed_fwd(wrapper, max_span: int, qkv, qemb, kemb_t, vemb,
                  sim_affine):
    """Launch the forward kernel of ``wrapper`` (``medt_<its name>``),
    which also saves m and l: ``(sv, sve, m, l)``."""
    name = wrapper.__name__
    g, gp, L, S, has_pos = _check(qkv, qemb, kemb_t, vemb, sim_affine,
                                  max_span, name)
    if S == 0:
        return _no_stripes_fwd(qkv, g, gp, L, save_ml=True)
    if is_wide(gp) and max_span > FLASH_MAX_SPAN:
        return _long_fwd(wrapper, qkv, qemb, kemb_t, vemb, sim_affine, g, gp,
                         L, S, has_pos)
    if is_wide(gp):
        return _wide_fwd(wrapper, qkv, qemb, kemb_t, vemb, sim_affine, g,
                         gp, L, S, has_pos, save_ml=True)
    dev = qkv.device
    sv = torch.empty((g, gp, L, S), dtype=torch.float32, device=dev)
    sve = torch.empty_like(sv) if has_pos else sv
    m = torch.empty((g, L, S), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    launch(wrapper, getattr(library(), entry(name, qkv)), qkv,
           ptr(qkv), ptr(qemb), ptr(kemb_t), ptr(vemb), ptr(sim_affine),
           ptr(sv), ptr(sve), ptr(m), ptr(l), g, gp, L, S, int(has_pos))
    return sv, (sve if has_pos else _zeros_like_view(sv)), m, l


def flash_lanes_fwd(qkv, qemb, kemb_t, vemb, sim_affine):
    """Launch the flash kernel (spans <= 64) on CUDA tensors:
    ``(sv, sve, m, l)``."""
    return _streamed_fwd(flash_lanes_fwd, FLASH_MAX_SPAN, qkv, qemb, kemb_t,
                         vemb, sim_affine)


def flash2_lanes_fwd(qkv, qemb, kemb_t, vemb, sim_affine):
    """Launch the flash2 kernel (spans <= 256) on CUDA tensors:
    ``(sv, sve, m, l)``."""
    return _streamed_fwd(flash2_lanes_fwd, FLASH2_MAX_SPAN, qkv, qemb,
                         kemb_t, vemb, sim_affine)


# The lanes backward's tile (csrc/axial_lanes_bwd.cu: kThreads, kGridBlocks,
# span_bucket): a block of 256 threads is one (query or key, stripe) pair
# each of a chunk of 256 / LP stripes, LP the span rounded up to 4, 8 or 16;
# with positions a block walks several chunks, at most ceil(1056 / g)
# blocks per group
LANES_THREADS = 256
LANES_GRID_BLOCKS = 1056

# The tiled flash and flash2 backwards' row-pass tile, one for both
# (csrc/tiled_bwd.cuh: kRowStripes; Flash2Tiles::kRowQueries): stripes per
# block, which is also the stripes per slot of the table partials, and
# query rows per block by gp
ROW_STRIPES = 128
ROW_QUERIES = {2: 8, 4: 8, 8: 4, 16: 2}


def lanes_blocks(g: int, L: int, S: int, has_pos: bool) -> int:
    """Blocks per group of a lanes backward launch (its partial slots)."""
    lp = 4 if L <= 4 else 8 if L <= 8 else 16
    chunks = -(-S // (LANES_THREADS // lp))
    return min(chunks, -(-LANES_GRID_BLOCKS // g)) if has_pos else chunks


def bwd_partials(kind: str, g: int, gp: int, L: int, S: int,
                 has_pos: bool):
    """``(n_tab, n_aff, scratch_rows)`` of a backward launch of ``kind``
    (``"lanes"``, or ``"tiled"`` for flash and flash2): its table-partial
    slots (0 without positions), daff-partial slots and (g, L, S) scratch
    rows."""
    if kind == "lanes":
        blocks = lanes_blocks(g, L, S, has_pos)
        return (g * blocks if has_pos else 0), blocks, 0
    chunks = -(-S // ROW_STRIPES)
    return (g * chunks if has_pos else 0), -(-L // ROW_QUERIES[gp]) * chunks, 2


def _bwd_buffers(qkv, kind: str, g, gp, L, S, has_pos):
    """Outputs and scratch of a backward launch of ``kind`` in three
    allocations: dqkv (in qkv's dtype); dtables (2gp, L, L) then daff (g, 8); the scratch
    rows (delta and the row normaliser, (2, g, L, S), tiled only), then the table partials (n_tab, 2gp, L, L) and the daff partials
    (n_aff, g, 4). ``(buffers, n_tab, n_aff)``."""
    n_tab, n_aff, rows = bwd_partials(kind, g, gp, L, S, has_pos)
    f32 = dict(dtype=torch.float32, device=qkv.device)
    e = 2 * gp * L * L if has_pos else 0
    out = torch.empty(e + g * 8, **f32)
    n_rows, n_tabs = rows * g * L * S, n_tab * e
    scratch = torch.empty(n_rows + n_tabs + n_aff * g * 4, **f32)
    b = dict(dqkv=torch.empty((g, 2 * gp, L, S), dtype=qkv.dtype,
                              device=qkv.device),
             dtables=out[:e].view(2 * gp if has_pos else 0, L, L),
             daff=out[e:].view(g, 8),
             scratch=scratch[:n_rows].view(rows, g, L, S),
             tab_part=scratch[n_rows:n_rows + n_tabs].view(
                 n_tab, 2 * gp if has_pos else 0, L, L),
             aff_part=scratch[n_rows + n_tabs:].view(n_aff, g, 4))
    return b, n_tab, n_aff


def _split_tables(dtables, gp, has_pos):
    if not has_pos:
        return dtables, dtables, dtables  # zero-size
    c = gp // 2
    return dtables[:c], dtables[c:gp], dtables[gp:]


def _no_stripes_bwd(qkv, g, gp, L, has_pos):
    """A backward over no stripes: an empty dqkv, zero table and affine
    gradients, no launch and no count."""
    e = 2 * gp * L * L if has_pos else 0
    out = torch.zeros(e + g * 8, dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty((g, 2 * gp, L, 0), dtype=qkv.dtype, device=qkv.device)
    dtables = out[:e].view(2 * gp if has_pos else 0, L, L)
    return (dqkv, *_split_tables(dtables, gp, has_pos), out[e:].view(g, 8))


# The wide backward's row pass (csrc/axial_wide_bwd.cu: kLanes, kMaxWarps,
# kKeyWindow, kTileBudget, rows_per_thread, row_keys, row_warps): a block
# owns 32 stripes, a window of min(8, round4(L)) keys and the query rows
# of up to 4 warps, each thread 4, 2, 2 or 1 rows by register bucket of c,
# as many warps as keep its (2gp, rows, window) table tile within the
# budget; one daff slot per block
WIDE_LANES = 32
WIDE_MAX_WARPS = 4
WIDE_KEY_WINDOW = 8
WIDE_TILE_BUDGET = 112 * 1024


def wide_row_keys(L: int) -> int:
    """Keys of a wide backward row-pass block."""
    return min(-(-L // 4) * 4, WIDE_KEY_WINDOW)


def wide_row_queries(gp: int, L: int) -> int:
    """Query rows of a wide backward row-pass block (its warps times the
    rows a thread holds)."""
    c = gp // 2
    ri = 4 if c <= 8 else 2 if c <= 32 else 1
    per = 2 * gp * ri * wide_row_keys(L) * 4
    return max(1, min(WIDE_MAX_WARPS, WIDE_TILE_BUDGET // per)) * ri


def _wide_bwd_slots(gp: int, L: int, S: int) -> int:
    """daff partial slots of a backward at a wide gp: one per row-pass
    block of ``wide_row_queries`` rows x ``wide_row_keys`` keys x 32
    stripes."""
    return (-(-L // wide_row_queries(gp, L)) * -(-L // wide_row_keys(L))
            * -(-S // WIDE_LANES))


def wide_bwd_scratch(g: int, gp: int, L: int, S: int, has_pos: bool,
                     lanes: bool) -> int:
    """Floats of a wide backward's scratch: p and dlog (g, L, L, S) each,
    the lanes contract's m, l and delta (3, g, L, S), the table partials
    (g, 2gp, L, L) with positions and the daff partials."""
    e = 2 * gp * L * L if has_pos else 0
    return (2 * g * L * L * S + (3 * g * L * S if lanes else 0) + g * e
            + _wide_bwd_slots(gp, L, S) * g * 4)


def _wide_bwd(wrapper, qkv, qemb, kemb_t, vemb, sim_affine, saved, dsv,
              dsve, g, gp, L, S, has_pos):
    """The backward at a wide gp (``medt_wide_attn_bwd``, or its bf16 entry
    point, which writes dqkv in bf16), counted as a launch of ``wrapper``:
    the lanes contract when ``saved`` is None, else the flash contract from
    the forward's ``(m, l, sv, sve)``. ``(dqkv, dqemb, dkemb_t, dvemb,
    daff)``."""
    dev = qkv.device
    f32 = dict(dtype=torch.float32, device=dev)
    e = 2 * gp * L * L if has_pos else 0
    n_aff = _wide_bwd_slots(gp, L, S)
    out = torch.empty(e + g * 8, **f32)
    lanes = saved is None
    pairs = g * L * L * S
    p_end = pairs + (3 * g * L * S if lanes else 0)   # p, then the stats
    scratch = torch.empty(wide_bwd_scratch(g, gp, L, S, has_pos, lanes),
                          **f32)
    dqkv = torch.empty((g, 2 * gp, L, S), dtype=qkv.dtype, device=dev)
    m, l, sv, sve = saved if saved is not None else (dsv,) * 4
    launch(wrapper, getattr(library(), entry("wide_attn_bwd", qkv)), qkv,
           ptr(qkv), ptr(qemb), ptr(kemb_t), ptr(vemb), ptr(sim_affine),
           ptr(m), ptr(l), ptr(sv), ptr(sve if has_pos else sv), ptr(dsv),
           ptr(dsve if has_pos else dsv), ptr(dqkv), ptr(out), ptr(out[e:]),
           ptr(scratch), ptr(scratch[p_end:]),
           ptr(scratch[p_end + pairs:]),
           ptr(scratch[p_end + pairs + g * e:]), g, gp, L, S, int(has_pos),
           int(saved is not None), n_aff)
    dtables = out[:e].view(2 * gp if has_pos else 0, L, L)
    return (dqkv, *_split_tables(dtables, gp, has_pos), out[e:].view(g, 8))


def long_bwd_slots(L: int, S: int) -> int:
    """daff partial slots a flash2 backward at a wide gp may write
    (csrc/wide_long.cuh: slot_capacity): one per row-pass row tile and 32
    stripes, at most one per query row and 32 stripes."""
    return L * -(-S // WIDE_LANES)


# the long-span row pass (csrc/wide_long.cuh): warps a block, the blocks it
# aims for, the most floats of table partial slots
LONG_WARPS = 4
LONG_TARGET_BLOCKS = 264
LONG_MAX_PART_FLOATS = 1 << 26


def long_bwd_slices(g: int, gp: int, L: int, S: int) -> int:
    """Table partial slots of a flash2 backward at a wide gp with positions
    (csrc/wide_long.cuh: row_slices): the row pass's slices of the g *
    ceil(S/32) (group, stripe-tile) units, enough for 264 blocks over its
    row tiles (4 warps of 2 query rows up to c = 14, else of 1), no more
    than the units, no more than 2^26 floats of slots, at least one."""
    c = gp // 2
    rb = LONG_WARPS * (2 if c <= 14 else 1)
    units = g * -(-S // WIDE_LANES)
    ns = -(-LONG_TARGET_BLOCKS // -(-L // rb))
    ns = min(ns, LONG_MAX_PART_FLOATS // (2 * gp * L * L), units)
    return max(ns, 1)


def long_bwd_scratch(g: int, gp: int, L: int, S: int,
                     has_pos: bool) -> dict:
    """Floats of a flash2 backward's scratch at a wide gp, by part: delta
    (g, L, S), the daff slots (:func:`long_bwd_slots`, g, 4) and, with
    positions, the table partial slots (:func:`long_bwd_slices`, 2gp, L,
    L)."""
    return {"delta": g * L * S, "aff": long_bwd_slots(L, S) * g * 4,
            "tables": (long_bwd_slices(g, gp, L, S) * 2 * gp * L * L
                       if has_pos else 0)}


def _long_fwd(wrapper, qkv, qemb, kemb_t, vemb, sim_affine, g, gp, L, S,
              has_pos):
    """The flash2 forward at a wide gp (``medt_wide_long_fwd``, or its bf16
    entry point), counted as a launch of ``wrapper``: ``(sv, sve, m, l)``."""
    dev = qkv.device
    sv = torch.empty((g, gp, L, S), dtype=torch.float32, device=dev)
    sve = torch.empty_like(sv) if has_pos else sv
    m = torch.empty((g, L, S), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    launch(wrapper, getattr(library(), entry("wide_long_fwd", qkv)), qkv,
           ptr(qkv), ptr(qemb), ptr(kemb_t), ptr(vemb), ptr(sim_affine),
           ptr(sv), ptr(sve), ptr(m), ptr(l), g, gp, L, S, int(has_pos))
    return sv, (sve if has_pos else _zeros_like_view(sv)), m, l


def _long_bwd(wrapper, qkv, qemb, kemb_t, vemb, sim_affine, saved, dsv,
              dsve, g, gp, L, S, has_pos):
    """The flash2 backward at a wide gp (``medt_wide_long_bwd``, or its
    bf16 entry point, which writes dqkv in bf16) from the forward's
    ``(m, l, sv, sve)``, counted as a launch of ``wrapper``: ``(dqkv,
    dqemb, dkemb_t, dvemb, daff)``."""
    dev = qkv.device
    f32 = dict(dtype=torch.float32, device=dev)
    e = 2 * gp * L * L if has_pos else 0
    n_aff = long_bwd_slots(L, S)
    n_tab = long_bwd_slices(g, gp, L, S) if has_pos else 0
    out = torch.empty(e + g * 8, **f32)
    part = long_bwd_scratch(g, gp, L, S, has_pos)
    scratch = torch.empty(sum(part.values()), **f32)
    aff_at, tab_at = part["delta"], part["delta"] + part["aff"]
    dqkv = torch.empty((g, 2 * gp, L, S), dtype=qkv.dtype, device=dev)
    m, l, sv, sve = saved
    launch(wrapper, getattr(library(), entry("wide_long_bwd", qkv)), qkv,
           ptr(qkv), ptr(qemb), ptr(kemb_t), ptr(vemb), ptr(sim_affine),
           ptr(m), ptr(l), ptr(sv), ptr(sve if has_pos else sv), ptr(dsv),
           ptr(dsve if has_pos else dsv), ptr(dqkv), ptr(out), ptr(out[e:]),
           ptr(scratch), ptr(scratch[aff_at:]), ptr(scratch[tab_at:]), g, gp,
           L, S, int(has_pos), n_aff, n_tab)
    dtables = out[:e].view(2 * gp if has_pos else 0, L, L)
    return (dqkv, *_split_tables(dtables, gp, has_pos), out[e:].view(g, 8))


def lanes_attn_bwd(qkv, qemb, kemb_t, vemb, sim_affine, dsv, dsve):
    """Launch the lanes backward (spans <= 16) on CUDA tensors:
    ``(dqkv, dqemb, dkemb_t, dvemb, daff)``. ``dsve`` is ignored (and may
    be any tensor) without positions."""
    extra = {"dsv": (dsv, "gp")}
    if _has_pos(qemb):
        extra["dsve"] = (dsve, "gp")
    g, gp, L, S, has_pos = _check(qkv, qemb, kemb_t, vemb, sim_affine,
                                  LANES_MAX_SPAN, "lanes_attn_bwd", **extra)
    if S == 0:
        return _no_stripes_bwd(qkv, g, gp, L, has_pos)
    if is_wide(gp):
        return _wide_bwd(lanes_attn_bwd, qkv, qemb, kemb_t, vemb, sim_affine,
                         None, dsv, dsve, g, gp, L, S, has_pos)
    b, n_tab, n_aff = _bwd_buffers(qkv, "lanes", g, gp, L, S, has_pos)
    launch(lanes_attn_bwd, getattr(library(), entry("lanes_attn_bwd", qkv)),
           qkv, ptr(qkv), ptr(qemb), ptr(kemb_t), ptr(vemb),
           ptr(sim_affine), ptr(dsv), ptr(dsve if has_pos else dsv),
           ptr(b["dqkv"]), ptr(b["dtables"]), ptr(b["daff"]),
           ptr(b["tab_part"]), ptr(b["aff_part"]), g, gp, L, S, int(has_pos),
           n_tab, n_aff)
    return (b["dqkv"], *_split_tables(b["dtables"], gp, has_pos), b["daff"])


def _streamed_bwd(wrapper, max_span: int, qkv, qemb, kemb_t, vemb,
                  sim_affine, m, l, sv, sve, dsv, dsve):
    """Launch the tiled backward of ``wrapper`` (``medt_<its name>``) from
    the forward's saved ``(m, l, sv, sve)``: ``(dqkv, dqemb, dkemb_t,
    dvemb, daff)``."""
    name = wrapper.__name__
    extra = {"m": (m, "row"), "l": (l, "row"), "sv": (sv, "gp"),
             "dsv": (dsv, "gp")}
    if _has_pos(qemb):
        extra.update(sve=(sve, "gp"), dsve=(dsve, "gp"))
    g, gp, L, S, has_pos = _check(qkv, qemb, kemb_t, vemb, sim_affine,
                                  max_span, name, **extra)
    if S == 0:
        return _no_stripes_bwd(qkv, g, gp, L, has_pos)
    if is_wide(gp) and max_span > FLASH_MAX_SPAN:
        return _long_bwd(wrapper, qkv, qemb, kemb_t, vemb, sim_affine,
                         (m, l, sv, sve), dsv, dsve, g, gp, L, S, has_pos)
    if is_wide(gp):
        return _wide_bwd(wrapper, qkv, qemb, kemb_t, vemb, sim_affine,
                         (m, l, sv, sve), dsv, dsve, g, gp, L, S, has_pos)
    b, n_tab, n_aff = _bwd_buffers(qkv, "tiled", g, gp, L, S, has_pos)
    launch(wrapper, getattr(library(), entry(name, qkv)), qkv,
           ptr(qkv), ptr(qemb), ptr(kemb_t), ptr(vemb), ptr(sim_affine),
           ptr(m), ptr(l), ptr(sv), ptr(sve if has_pos else sv), ptr(dsv),
           ptr(dsve if has_pos else dsv), ptr(b["dqkv"]), ptr(b["dtables"]),
           ptr(b["daff"]), ptr(b["scratch"]), ptr(b["tab_part"]),
           ptr(b["aff_part"]), g, gp, L, S, int(has_pos), n_tab, n_aff)
    return (b["dqkv"], *_split_tables(b["dtables"], gp, has_pos), b["daff"])


def flash_lanes_bwd(qkv, qemb, kemb_t, vemb, sim_affine, m, l, sv, sve, dsv,
                    dsve):
    """Launch the flash backward (spans <= 64) on CUDA tensors, from the
    forward's saved ``(m, l, sv, sve)``: ``(dqkv, dqemb, dkemb_t, dvemb,
    daff)``. ``sve``/``dsve`` are ignored without positions."""
    return _streamed_bwd(flash_lanes_bwd, FLASH_MAX_SPAN, qkv, qemb, kemb_t,
                         vemb, sim_affine, m, l, sv, sve, dsv, dsve)


def flash2_lanes_bwd(qkv, qemb, kemb_t, vemb, sim_affine, m, l, sv, sve,
                     dsv, dsve):
    """Launch the flash2 backward (spans <= 256) on CUDA tensors, from the
    forward's saved ``(m, l, sv, sve)``: ``(dqkv, dqemb, dkemb_t, dvemb,
    daff)``. ``sve``/``dsve`` are ignored without positions. The table
    partials it allocates are (g * ceil(S/128), 2gp, L, L) floats at gp 2,
    4, 8 and 16; at a wide gp :func:`long_bwd_slices` slots of the same
    size, a number that does not grow with S (:func:`long_bwd_scratch`)."""
    return _streamed_bwd(flash2_lanes_bwd, FLASH2_MAX_SPAN, qkv, qemb,
                         kemb_t, vemb, sim_affine, m, l, sv, sve, dsv, dsve)


# ---- autograd ----------------------------------------------------------------

def _runs_plain(qkv: torch.Tensor, plain: bool) -> bool:
    return plain or qkv.device.type == "cpu"


def _grads_in(qkv, dsv, dsve, has_pos):
    """Upstream gradients as contiguous tensors of the outputs' shape
    (zeros for an output nothing used)."""
    g, r2, L, S = qkv.shape

    def dense(t):
        if t is None:
            return qkv.new_zeros((g, r2 // 2, L, S), dtype=torch.float32)
        return t.contiguous()

    dsv = dense(dsv)
    return dsv, (dense(dsve) if has_pos else dsv)


def _table_grads(qkv, grads, has_pos):
    """Zero-size tables (wopos) take no gradient. dqkv comes in qkv's
    dtype, as the kernel or the plain version wrote it (not left for
    autograd to cast)."""
    dqkv, dqemb, dkemb_t, dvemb, daff = grads
    assert dqkv.dtype == qkv.dtype, (dqkv.dtype, qkv.dtype)
    if not has_pos:
        return dqkv, None, None, None, daff
    return grads


class LanesAttnCore(torch.autograd.Function):
    """``lanes_attn_core`` with its backward (``_fwd_rule``/``_bwd_rule``):
    saves the inputs and recomputes the softmax."""

    @staticmethod
    def forward(ctx, qkv, qemb, kemb_t, vemb, sim_affine, plain=False):
        ctx.plain = _runs_plain(qkv, plain)
        ctx.has_pos = _has_pos(qemb)
        if ctx.plain:
            sv, sve = lanes_attn_plain(qkv, qemb, kemb_t, vemb, sim_affine)
        else:
            sv, sve = lanes_attn_fwd(qkv, qemb, kemb_t, vemb, sim_affine)
        ctx.save_for_backward(qkv, qemb, kemb_t, vemb, sim_affine)
        if not ctx.has_pos:
            ctx.mark_non_differentiable(sve)
        return sv, sve

    @staticmethod
    def backward(ctx, dsv, dsve):
        qkv, qemb, kemb_t, vemb, aff = ctx.saved_tensors
        dsv, dsve = _grads_in(qkv, dsv, dsve, ctx.has_pos)
        fn = lanes_attn_bwd_plain if ctx.plain else lanes_attn_bwd
        grads = fn(qkv, qemb, kemb_t, vemb, aff, dsv, dsve)
        return (*_table_grads(qkv, grads, ctx.has_pos), None)


def _streamed_forward(ctx, fwd_kernel, fwd_plain, qkv, qemb, kemb_t, vemb,
                      sim_affine, plain):
    """Forward of a core that saves m and l: runs it, saves the inputs and
    the forward's m, l, sv, sve."""
    ctx.plain = _runs_plain(qkv, plain)
    ctx.has_pos = _has_pos(qemb)
    fwd = fwd_plain if ctx.plain else fwd_kernel
    sv, sve, m, l = fwd(qkv, qemb, kemb_t, vemb, sim_affine)
    ctx.save_for_backward(qkv, qemb, kemb_t, vemb, sim_affine, m, l, sv, sve)
    if not ctx.has_pos:
        ctx.mark_non_differentiable(sve)
    return sv, sve


def _streamed_backward(ctx, bwd_kernel, bwd_plain, dsv, dsve):
    qkv, qemb, kemb_t, vemb, aff, m, l, sv, sve = ctx.saved_tensors
    dsv, dsve = _grads_in(qkv, dsv, dsve, ctx.has_pos)
    fn = bwd_plain if ctx.plain else bwd_kernel
    grads = fn(qkv, qemb, kemb_t, vemb, aff, m, l, sv, sve, dsv, dsve)
    return (*_table_grads(qkv, grads, ctx.has_pos), None)


class FlashLanesCore(torch.autograd.Function):
    """``flash_lanes_core`` with its backward (``_flash_fwd_rule``/
    ``_flash_bwd_rule``): saves the inputs and the forward's m, l, sv, sve."""

    @staticmethod
    def forward(ctx, qkv, qemb, kemb_t, vemb, sim_affine, plain=False):
        return _streamed_forward(ctx, flash_lanes_fwd, flash_lanes_plain,
                                 qkv, qemb, kemb_t, vemb, sim_affine, plain)

    @staticmethod
    def backward(ctx, dsv, dsve):
        return _streamed_backward(ctx, flash_lanes_bwd,
                                  flash_lanes_bwd_plain, dsv, dsve)


class Flash2LanesCore(torch.autograd.Function):
    """``flash2_lanes_core`` with its backward (``_flash2_fwd_rule``/
    ``_flash2_bwd_rule``): saves the inputs and the forward's m, l, sv,
    sve, as JAX does."""

    @staticmethod
    def forward(ctx, qkv, qemb, kemb_t, vemb, sim_affine, plain=False):
        return _streamed_forward(ctx, flash2_lanes_fwd, flash2_lanes_plain,
                                 qkv, qemb, kemb_t, vemb, sim_affine, plain)

    @staticmethod
    def backward(ctx, dsv, dsve):
        return _streamed_backward(ctx, flash2_lanes_bwd,
                                  flash2_lanes_bwd_plain, dsv, dsve)


def lanes_attn_core(qkv, qemb, kemb_t, vemb, sim_affine, plain=False):
    """Spans <= 16, differentiable: the kernels on CUDA tensors, the plain
    versions on CPU tensors or when ``plain`` is set."""
    return LanesAttnCore.apply(qkv, qemb, kemb_t, vemb, sim_affine, plain)


def flash_lanes_core(qkv, qemb, kemb_t, vemb, sim_affine, plain=False):
    """Spans 17..64, differentiable: the kernels on CUDA tensors, the plain
    versions on CPU tensors or when ``plain`` is set."""
    return FlashLanesCore.apply(qkv, qemb, kemb_t, vemb, sim_affine, plain)


def flash2_lanes_core(qkv, qemb, kemb_t, vemb, sim_affine, plain=False):
    """Spans 65..256, every even gp up to 128, differentiable: the kernels
    on CUDA tensors, the plain versions on CPU tensors or when ``plain``
    is set."""
    return Flash2LanesCore.apply(qkv, qemb, kemb_t, vemb, sim_affine, plain)


_WRAPPERS = (lanes_attn_fwd, flash_lanes_fwd, flash2_lanes_fwd,
             lanes_attn_bwd, flash_lanes_bwd, flash2_lanes_bwd)


def reset_launch_counts():
    reset_counts(_WRAPPERS)


def launch_counts() -> dict:
    return counts_of(_WRAPPERS)


for _fn in _WRAPPERS:
    _fn.launches = _fn.launches_bf16 = 0
