"""The attention kernels at every group width the JAX kernels take.

The port's kernels take every even gp from 2 to 128: the designs for gp 2,
4, 8 and 16, and the wide kernels (``csrc/wide_attn.cuh``,
``csrc/axial_wide.cu``, the wide moments kernels of ``csrc/moments.cu``)
at every other width, float32 and bf16, so that axial50m (gp 12, 24, 48,
96) and axial50l (16, 32, 64, 128) run on them under ``use_fused``.

On the CPU, against the JAX package (inputs from numpy with a seed; JAX is
imported by the ``jx`` fixture, so that this file also collects on the
card's machine, which has no JAX):

* the plain lanes core, forward and every gradient, against the Pallas
  ``lanes_attn_core`` and its custom VJP in interpret mode at gp 12 and
  96: outputs at atol 1e-5, gradients at 1e-5 + 1e-5 * max|want|;
* the plain moments core against the Pallas ``moment_sums_core``
  (interpret mode) forward and backward at gp 12; at gp 96 against JAX's
  XLA forms of the same sums (the stripe-major ``logit_moments`` and the
  backward ``_sums_bwd_xla``), since the interpret-mode Pallas kernel
  unrolls its c(c+1)/2 pair terms in Python and one call at gp 96 ran for
  over three minutes on the CPU; the sums at 1e-5 + 1e-5 * max|want|, the
  mean and variance at gp 96 at rtol 1e-4 (each a difference of sums over
  S * L * L terms that XLA adds in another order);
* the plain eval core against the Pallas ``axial_attention_fused``
  (interpret mode) at gp 12 and 96, atol 1e-5;
* the stripe route at span 32 and gp 12, 24 and 32: a train site there
  under 128 stripes takes the flash route in the port (the stripe kernels
  stop at gp 16), so the port's ``flash_lanes_core`` on the lanes layout
  is held against JAX's stripe kernel ``fused_attn_core`` (interpret
  mode), forward and all seven gradients (daff, a sum over S * L * L
  products each a sum over c channels, at 1e-4 + 1e-4 * max|want|), and
  at gp 12 its forward against JAX's ``flash_lanes_core`` (interpret mode;
  JAX's flash backward refuses these stripe counts in its block pick);
* ``AxialAttentionNet(layers=(1, 1, 1, 1))`` at s = 0.75 and 1.0, 32 px,
  batch 2, ``use_fused=True`` (every gp of axial50m and of axial50l, on
  the eval route in eval mode and the lanes route in train mode, plain
  cores on the CPU) against JAX's same model on its plain path
  (``use_fused=False``), with the weights carried by the bridge: one
  train step's logits, loss, input and parameter gradients and every BN
  running statistic, as tests/test_torch_port_cls.py holds the ResNets'
  steps (the eval route at these widths is held by the eval-core test);
* the wide moments forward's partial slots: ``ops/moments.py::fwd_slots``
  takes their count from the kernel library's rule
  (``csrc/moments.cu::medt_moment_sums_fwd_slots``);
* ``check_gp``: an odd gp, gp 130 and the stripe kernels at gp 32 raise,
  gp 12 and 128 pass and the wrappers (flash2's too) take them with bf16
  qkv; ``AxialAttention`` on
  the fused path at gp 6, 24 and 128, float32 and bf16 compute, on the
  eval, lanes and (in the stripe route's place) flash routes.

On the card (marked ``cuda``; skipped without one): each wide kernel
against its plain version at gp 12, 24, 48, 96 and 128 under
tests/test_torch_port_cuda.py's tolerances, the same bits on a second run,
one launch counted per call, and each bf16 entry point against its float32
twin on the upcast qkv, bit for bit (dqkv: the float32 dqkv rounded once);
the forwards' tile edges (stripe counts that leave a tile part full,
spans 7 and 64, gp 6, 66 and 128, without positions, the moments forward
at span 96); the same for the long-span wide kernels (the flash2 wrappers
at a wide gp,
``csrc/wide_long.cuh``) and the wide moments kernels at spans 80-256:
axial50m's and axial50l's span-96 sites at 384 px and a sweep over spans
80, 128, 192 and 256 at gp 6, 10, 12, 32, 64 and 128.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one PyTorch thread)

from medt_tpu_torch.models.classifiers import AxialAttentionNet
from medt_tpu_torch.ops import AxialAttention, axial_eval, axial_lanes, moments
from medt_tpu_torch.ops.axial_attention import fused_route
from test_torch_port_cuda import (  # noqa: F401  (cuda_device: a fixture)
    _close,
    _grads_in,
    core_inputs,
    cuda_device,
    eval_inputs,
    moment_inputs,
)

F32 = np.float32
NAMES = ("dq", "dk", "dv", "dqemb", "dkemb", "dvemb", "daff")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's functions (the CPU tests only: the card's machine
    has no JAX package to hold the port against)."""
    import types

    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    pallas_axial = pytest.importorskip("medt_tpu.ops.pallas_axial")
    pallas_axial_lanes = pytest.importorskip("medt_tpu.ops.pallas_axial_lanes")
    pallas_moments = pytest.importorskip("medt_tpu.ops.pallas_moments")
    pallas_axial_train = pytest.importorskip("medt_tpu.ops.pallas_axial_train")

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, lanes=pallas_axial_lanes.lanes_attn_core,
        flash=pallas_axial_lanes.flash_lanes_core,
        moments=pallas_moments.moment_sums_core,
        moments_bwd_xla=pallas_moments._sums_bwd_xla,
        logit_moments=pallas_axial_train.logit_moments,
        stripe=pallas_axial_train.fused_attn_core,
        eval=pallas_axial.axial_attention_fused)


def _np(t):
    return t.detach().cpu().numpy()


def _vjp(jx, fn, args, cts):
    """JAX's outputs of ``fn`` and its VJP of ``cts``, under one jit (the
    persistent compile cache then serves later runs)."""
    jnp = jx.jnp

    @jx.jax.jit
    def run(args, cts):
        out, vjp = jx.jax.vjp(fn, *args)
        return out, vjp(cts)

    return run([jnp.asarray(a) for a in args],
               jx.jax.tree_util.tree_map(jnp.asarray, cts))


def _tight(got, want, name):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    tol = 1e-5 + 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=name)


def _lanes_args(seed, g, gp, L, S):
    rng = np.random.default_rng(seed)
    c = gp // 2

    def t(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(F32)

    aff = np.abs(t(g, 8)) * np.array([1, 0, 1, 0, 1, 0, 0, 0], F32) \
        + t(g, 8, scale=0.1) * np.array([0, 1, 0, 1, 0, 1, 0, 0], F32)
    return [t(g, 2 * gp, L, S), t(c, L, L, scale=gp ** -0.5),
            t(c, L, L, scale=gp ** -0.5), t(gp, L, L, scale=gp ** -0.5),
            aff.astype(F32)]


# ---- the cores against the Pallas functions -----------------------------------

@pytest.mark.parametrize("gp", [12, 96])
def test_lanes_core_matches_pallas(jx, gp):
    """Forward and the five gradients (dqkv, the three tables, daff)."""
    g, L, S = 1, 3, 8
    args = _lanes_args(60 + gp, g, gp, L, S)
    rng = np.random.default_rng(61)
    dsv, dsve = (rng.normal(size=(g, gp, L, S)).astype(F32) for _ in range(2))
    (sv_w, sve_w), want = _vjp(jx, jx.lanes, args, (dsv, dsve))
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
    sv, sve = axial_lanes.lanes_attn_core(*leaves)
    np.testing.assert_allclose(_np(sv), sv_w, atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(sve), sve_w, atol=1e-5, rtol=0)
    ((sv * torch.from_numpy(dsv)).sum()
     + (sve * torch.from_numpy(dsve)).sum()).backward()
    for name, leaf, w in zip(("dqkv", "dqemb", "dkemb_t", "dvemb", "daff"),
                             leaves, want):
        _tight(leaf.grad, w, name)


def _moment_args(seed, g, gp, L, S):
    """qkv, the (c, L, L) tables qemb and kemb, and the moments' r_q, e_q,
    r_k, e_k built from them as the attention builds them."""
    rng = np.random.default_rng(seed)
    c = gp // 2
    qkv = rng.normal(size=(g, 2 * gp, L, S)).astype(F32)
    qemb, kemb = (rng.normal(size=(c, L, L)).astype(F32) * gp ** -0.5
                  for _ in range(2))
    tables = [qemb.sum(2), np.einsum("cij,dij->cdi", qemb, qemb),
              kemb.sum(2), np.einsum("cji,dji->cdj", kemb, kemb)]
    return qkv, qemb, kemb, [t.astype(F32) for t in tables]


@pytest.mark.parametrize("gp", [12, 96])
def test_moments_core_matches_jax(jx, gp):
    """The (g, 8) sums and the backward (dqkv, dr_q, de_q, dr_k, de_k):
    against the Pallas ``moment_sums_core`` and its VJP at gp 12; at gp 96
    the sums as JAX's stripe-major ``logit_moments`` (the moments' mean and
    variance) and the backward against ``_sums_bwd_xla``."""
    g, L, S = 1, 4, 128
    qkv, qemb, kemb, tables = _moment_args(70 + gp, g, gp, L, S)
    ct = np.random.default_rng(71).normal(size=(g, 8)).astype(F32)
    jnp = jx.jnp
    if gp == 12:
        sums_w, want = _vjp(jx, jx.moments, [qkv, *tables], ct)
        got = moments.moment_sums(torch.from_numpy(qkv),
                                  *map(torch.from_numpy, tables))
        _tight(got, sums_w, "sums")
    else:
        c = gp // 2
        st = qkv.transpose(3, 0, 1, 2)                 # (S, g, 2gp, L)

        @jx.jax.jit
        def xla(q, k, qemb, kemb, qkv, tables, ct):
            mean, var, _ = jx.logit_moments(q, k, qemb, kemb)
            return mean, var, jx.moments_bwd_xla((qkv, *tables), ct)

        mean_w, var_w, want = xla(
            *map(jnp.asarray, (st[:, :, :c], st[:, :, c:gp], qemb, kemb,
                               qkv)), [jnp.asarray(t) for t in tables],
            jnp.asarray(ct))
        mean, var, n = moments.logit_moments_lanes_fused(
            torch.from_numpy(qkv), torch.from_numpy(qemb),
            torch.from_numpy(kemb))
        assert n == L * L * S
        for name, o, w in (("mean", mean, mean_w), ("var", var, var_w)):
            np.testing.assert_allclose(_np(o), np.asarray(w), rtol=1e-4,
                                       atol=1e-5, err_msg=name)
    got = moments.moment_sums_bwd_plain(
        torch.from_numpy(qkv), *map(torch.from_numpy, tables),
        torch.from_numpy(ct))
    for name, o, w in zip(("dqkv", "dr_q", "de_q", "dr_k", "de_k"), got,
                          want):
        _tight(o, w, name)


@pytest.mark.parametrize("gp", [12, 96])
def test_eval_core_matches_pallas(jx, gp):
    args = [_np(t) for t in eval_inputs(80 + gp, g=2, gp=gp, L=4, S=6,
                                        has_pos=True)]
    want = np.asarray(jx.jax.jit(jx.eval)(*map(jx.jnp.asarray, args)))
    got = axial_eval.axial_attention_fused(*map(torch.from_numpy, args))
    assert got.shape == (6, 2, gp, 4)
    np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("gp", [12, 24, 32])
def test_stripe_route_matches_fused_attn_core(jx, gp):
    """A train site at span 32 with 2 stripes takes the flash route at
    these widths: the port's flash core on the lanes layout against JAX's
    stripe kernel (forward, and the gradients of q, k, v, the tables and
    the affine) and, at gp 12, against JAX's flash kernel (forward)."""
    g, L, S = 1, 32, 2
    assert fused_route(L, S, True, gp) == "flash"
    qkv, qemb, kemb_t, vemb, aff = _lanes_args(90 + gp, g, gp, L, S)
    c = gp // 2
    kemb = np.ascontiguousarray(kemb_t.transpose(0, 2, 1))   # [c, j, i]
    st = qkv.transpose(3, 0, 1, 2)                           # (S, g, 2gp, L)
    stripe = [np.ascontiguousarray(a) for a in (
        st[:, :, :c], st[:, :, c:gp], st[:, :, gp:])] + [qemb, kemb, vemb,
                                                         aff]
    rng = np.random.default_rng(91)
    dsv, dsve = (rng.normal(size=(S, g, gp, L)).astype(F32) for _ in range(2))
    (sv_w, sve_w), want = _vjp(jx, jx.stripe, stripe, (dsv, dsve))

    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in stripe]
    q, k, v, tq, tk, tv, ta = leaves
    lanes = torch.cat([q, k, v], dim=2).permute(1, 2, 3, 0).contiguous()
    sv, sve = axial_lanes.flash_lanes_core(
        lanes, tq, tk.transpose(1, 2).contiguous(), tv, ta)
    if gp == 12:
        flash = jx.jax.jit(jx.flash)(*map(jx.jnp.asarray, (
            qkv, qemb, kemb_t, vemb, aff)))
        for o, w in zip((sv, sve), flash):
            np.testing.assert_allclose(_np(o), w, atol=1e-5, rtol=0)
    sv, sve = sv.permute(3, 0, 1, 2), sve.permute(3, 0, 1, 2)
    np.testing.assert_allclose(_np(sv), sv_w, atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(sve), sve_w, atol=1e-5, rtol=0)
    ((sv * torch.from_numpy(dsv)).sum()
     + (sve * torch.from_numpy(dsve)).sum()).backward()
    for name, leaf, w in zip(NAMES[:-1], leaves, want):
        _tight(leaf.grad, w, name)
    np.testing.assert_allclose(_np(ta.grad), np.asarray(want[-1]), rtol=0,
                               atol=1e-4 + 1e-4 * float(np.abs(want[-1])
                                                       .max()),
                               err_msg="daff")


# ---- axial50m- and axial50l-shaped models ---------------------------------------

@pytest.mark.parametrize("s,gps", [(0.75, {12, 24, 48, 96}),
                                   (1.0, {16, 32, 64, 128})])
def test_axial_net_wide_gp_matches_jax(jx, s, gps):
    """One train step (logits, loss, input and parameter gradients,
    running statistics) of the fused model on plain cores against JAX's
    model on its plain path; every site on the lanes route."""
    from medt_tpu.models import classifiers as jcls
    from test_torch_port_cls import (assert_step, carried, held, jax_run,
                                     port_train, variables_of)

    kw = dict(layers=(1, 1, 1, 1), s=s, img_size=32, num_classes=10)
    jmodel = jcls.AxialAttentionNet(**kw)
    rng = np.random.default_rng(int(s * 100))
    x = rng.normal(size=(2, 32, 32, 3)).astype(F32)
    labels = np.array([4, 7], np.int64)
    variables = variables_of(jmodel, x, seed=int(s * 100) + 1)
    logits, loss, gparams, gx, stats = jax_run(jmodel, variables, x, labels,
                                               eval_mode=False)
    sd = carried("axial50m", variables["params"], variables["batch_stats"])
    models = []

    def make():
        models.append(AxialAttentionNet(**kw, use_fused=True, device="cpu"))
        models[-1].load_state_dict(sd, strict=True)
        return models[-1]

    runs = port_train(make, x, labels)
    sites = [m for m in models[0].modules() if isinstance(m, AxialAttention)]
    assert {m.gp for m in sites} == gps
    assert {m.last_route[0] for m in sites} == {"lanes"}
    held(runs, "logits", logits, 0.0, 1e-4)
    assert_step(runs, "axial", loss, gx, gparams, stats)


# ---- the width rule ---------------------------------------------------------------

def test_check_gp_rule():
    """Odd gp, gp over 128 and the stripe kernels above 16 raise naming
    the roadmap entry; gp 12 and 128 pass, and the wrappers, flash2's
    among them since its long-span wide kernels, take them with bf16 qkv
    (their checks pass; the CPU tensor is refused after them)."""
    for gp in (7, 13, 130):
        with pytest.raises(ValueError, match="ROADMAP"):
            axial_lanes.check_gp("lanes_attn_fwd", gp)
    with pytest.raises(ValueError, match="ROADMAP"):
        axial_lanes.check_gp("stripe_attn_fwd", 32, narrow_only=True)
    for gp in (12, 128):
        axial_lanes.check_gp("lanes_attn_fwd", gp)
        axial_lanes.check_gp("flash2_lanes_fwd", gp)
        qkv, *rest = core_inputs(95, g=2, gp=gp, L=4, S=8, has_pos=True)
        for fn in (axial_lanes.lanes_attn_fwd, axial_lanes.flash_lanes_fwd,
                   axial_lanes.flash2_lanes_fwd):
            with pytest.raises(ValueError, match="CUDA"):
                fn(qkv.bfloat16(), *rest)
        with pytest.raises(ValueError, match="CUDA"):
            moments.moment_sums_fwd(
                *[t.bfloat16() if i == 0 else t for i, t in enumerate(
                    moment_inputs(96, 2, gp, 4, 8, True))])
    assert not axial_lanes.is_wide(16) and axial_lanes.is_wide(12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gp", [6, 24, 128])
def test_fused_attention_takes_wide_gp_on_every_route(gp, dtype):
    """``AxialAttention(use_fused=True)`` at a wide gp, float32 and bf16
    compute, on the eval route (eval, span 4), the lanes route (train, span
    4) and, where the stripe route would take a narrow gp (train, span 32,
    2 stripes), the flash route: finite outputs of the input's shape."""
    rng = np.random.default_rng(gp)
    op = AxialAttention(8, 8 * gp, 4, groups=8, mode="full", use_fused=True,
                        device="cpu")
    op.compute_dtype = dtype
    x = torch.from_numpy(rng.normal(size=(1, 8, 4, 3)).astype(F32))
    for train, route in ((False, "eval"), (True, "lanes")):
        y = op.train(train)(x)
        assert op.last_route[0] == route and y.dtype == dtype
        assert y.shape == (1, 8 * gp, 4, 3) and torch.isfinite(y).all()
    op = AxialAttention(8, 8 * gp, 32, groups=8, mode="full",
                        use_fused=True, device="cpu").train()
    op.compute_dtype = dtype
    y = op(torch.from_numpy(rng.normal(size=(1, 8, 32, 2)).astype(F32)))
    assert op.last_route[0] == "flash" and torch.isfinite(y).all()


# ---- on the card --------------------------------------------------------------------

# (kernel, span, gp, stripes, has_pos): each kernel at gp 12, 24, 48, 96
# and 128, at a site of axial50m or axial50l or a ragged stripe count,
# both variants
WIDE_GEOMETRIES = [
    ("lanes", 14, 12, 112, True), ("lanes", 7, 24, 37, False),
    ("lanes", 14, 48, 112, True), ("lanes", 7, 96, 56, True),
    ("lanes", 14, 128, 14, True),
    ("flash", 56, 12, 448, True), ("flash", 56, 24, 56, True),
    ("flash", 28, 48, 224, True), ("flash", 28, 96, 9, False),
    ("flash", 28, 128, 28, True),
    ("moments", 56, 12, 448, True), ("moments", 28, 24, 224, True),
    ("moments", 28, 48, 41, False), ("moments", 14, 96, 112, True),
    ("moments", 7, 128, 7, True),
    ("eval", 56, 12, 56, True), ("eval", 28, 24, 5, False),
    ("eval", 14, 48, 112, True), ("eval", 14, 96, 14, True),
    ("eval", 7, 128, 7, True),
    # the forwards' tiles (csrc/wide_attn.cuh: 8, 16 or 32 stripes a block,
    # 2 or 4 rows a thread, the value planes split across blocks at small
    # grids) and the moments forward's (csrc/moments_wide.cuh:
    # wide_fwd_tile): stripe counts that leave a tile part full (7, 33,
    # 56), spans 7 and 64, gp 6, 66 and 128, without positions, the
    # stripe-major layout's views (strides free) at the same edges, and
    # the moments forward at span 96 and at (7, 96)
    ("lanes", 7, 6, 33, True), ("lanes", 13, 66, 7, False),
    ("lanes", 16, 128, 56, True),
    ("flash", 64, 6, 33, True), ("flash", 64, 66, 56, False),
    ("flash", 64, 128, 7, True), ("flash", 33, 24, 56, False),
    ("eval", 64, 6, 33, False), ("eval", 64, 128, 7, True),
    ("eval", 7, 66, 56, True), ("eval", 33, 24, 33, True),
    ("moments", 96, 12, 56, True), ("moments", 96, 24, 33, False),
    ("moments", 7, 96, 56, True), ("moments", 64, 6, 7, True),
    ("moments", 64, 128, 33, True), ("moments", 7, 66, 56, False),
]


def _card_calls(kernel, L, gp, S, has_pos, device, cast=None):
    """[(wrapper, args, plain call)] of one geometry; ``cast`` maps qkv."""
    cast = cast or (lambda t: t)
    if kernel == "eval":
        args = eval_inputs(41, g=8, gp=gp, L=L, S=S, has_pos=has_pos,
                           device=device)
        return [(axial_eval.axial_eval_fwd, args,
                 lambda: (axial_eval.axial_attention_fused_plain(*args),))]
    if kernel == "moments":
        ins = moment_inputs(42, 8, gp, L, S, has_pos, device=device)
        ins = [cast(ins[0])] + ins[1:]
        ct = torch.from_numpy(np.random.default_rng(43).normal(size=(8, 8))
                              .astype(F32)).to(device)
        return [(moments.moment_sums_fwd, ins,
                 lambda: (moments.moment_sums_plain(*ins),)),
                (moments.moment_sums_bwd, (*ins, ct),
                 lambda: moments.moment_sums_bwd_plain(*ins, ct))]
    args = core_inputs(44, g=8, gp=gp, L=L, S=S, has_pos=has_pos,
                       device=device)
    args = (cast(args[0]), *args[1:])
    dsv, dsve = _grads_in(45, 8, gp, L, S, device)
    if kernel == "lanes":
        return [(axial_lanes.lanes_attn_fwd, args,
                 lambda: axial_lanes.lanes_attn_plain(*args)),
                (axial_lanes.lanes_attn_bwd, (*args, dsv, dsve),
                 lambda: axial_lanes.lanes_attn_bwd_plain(*args, dsv, dsve))]
    sv, sve, m, l = axial_lanes.flash_lanes_plain(*args)
    saved = (m, l, sv, sve)
    fwd, bwd = (getattr(axial_lanes, f"{kernel}_lanes_{d}")
                for d in ("fwd", "bwd"))
    return [(fwd, args, lambda: axial_lanes.flash_lanes_plain(*args)),
            (bwd, (*args, *saved, dsv, dsve),
             lambda: axial_lanes.flash_lanes_bwd_plain(*args, *saved, dsv,
                                                       dsve))]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,L,gp,S,has_pos", WIDE_GEOMETRIES)
def test_wide_kernels_match_plain_on_card(cuda_device, kernel, L, gp, S,
                                          has_pos):
    """Forward and backward (the eval kernel: forward only) against the
    plain versions; the same bits on a second run; one launch a call."""
    for fn, fargs, plain in _card_calls(kernel, L, gp, S, has_pos,
                                        cuda_device):
        before = fn.launches
        got, again = fn(*fargs), fn(*fargs)
        if isinstance(got, torch.Tensor):
            got, again = (got,), (again,)
        want = plain()
        torch.cuda.synchronize()
        assert fn.launches == before + 2, fn.__name__
        for i, (o, a, w) in enumerate(zip(got, again, want)):
            name = f"{fn.__name__}[{i}] gp {gp}"
            if fn.__name__.endswith("_fwd") and kernel != "moments":
                rtol = 1e-5 if i >= 2 else 0.0   # flash: m and l
                torch.testing.assert_close(o, w, atol=1e-4, rtol=rtol,
                                           msg=name)
            else:
                _close(o, w, name)
            assert torch.equal(o, a), f"{name} differs between two runs"


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,L,gp,S,has_pos", [
    g for g in WIDE_GEOMETRIES if g[0] != "eval"])
def test_wide_bf16_equals_float32_twin_on_card(cuda_device, kernel, L, gp,
                                               S, has_pos):
    """A bf16 entry point's outputs are the float32 kernel's on the upcast
    qkv, bit for bit; its dqkv is the float32 dqkv rounded once; its
    launches count under ``launches_bf16``."""
    bf16 = _card_calls(kernel, L, gp, S, has_pos, cuda_device,
                       cast=lambda t: t.bfloat16())
    twin = _card_calls(kernel, L, gp, S, has_pos, cuda_device,
                       cast=lambda t: t.bfloat16().float())
    for (fn, fargs, _), (_, targs, _) in zip(bf16, twin):
        before = fn.launches_bf16
        got, want = fn(*fargs), fn(*targs)
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        torch.cuda.synchronize()
        assert fn.launches_bf16 == before + 1, fn.__name__
        for i, (o, w) in enumerate(zip(got, want)):
            name = f"{fn.__name__}[{i}] gp {gp}"
            if fn.__name__.endswith("_bwd") and i == 0:
                assert o.dtype == torch.bfloat16, name
                w = w.to(torch.bfloat16)
            assert torch.equal(o, w), name


# ---- the redesigned wide backwards (rows 2, 4, 11's route and 8) ------------

CSRC = Path(__file__).resolve().parent.parent / "medt_tpu_torch" / "csrc"


def _const(text, name):
    """The value of ``constexpr int name = <int> [* <int>];`` in a source."""
    m = re.search(rf"constexpr int {name} = (\d+)(?: \* (\d+))?;", text)
    return int(m.group(1)) * int(m.group(2) or 1)


def test_wide_row_tile_follows_the_kernel():
    """The wrapper's daff slots and scratch follow the row pass's own tile
    rule, read here from csrc/axial_wide_bwd.cu: a block of 32 stripes, a
    window of min(kKeyWindow, round4(L)) keys and up to kMaxWarps warps of
    4, 2, 2 or 1 query rows by register bucket, as many warps as keep the
    (2gp, rows, window) table tile within kTileBudget bytes; one daff slot
    a block. Every axial50m and axial50l site gets 4 warps."""
    src = (CSRC / "axial_wide_bwd.cu").read_text()
    lanes, warps, window, budget = (_const(src, n) for n in (
        "kLanes", "kMaxWarps", "kKeyWindow", "kTileBudget"))
    assert (lanes, warps, window, budget) == (
        axial_lanes.WIDE_LANES, axial_lanes.WIDE_MAX_WARPS,
        axial_lanes.WIDE_KEY_WINDOW, axial_lanes.WIDE_TILE_BUDGET)
    assert "return cm <= 8 ? 4 : cm <= 32 ? 2 : 1;" in src
    assert "return round4(L) < kKeyWindow ? round4(L) : kKeyWindow;" in src
    assert "2 * gp * ri * kw * (int)sizeof(float)" in src

    def rows(gp, L):
        c = gp // 2
        bucket = 8 if c <= 8 else 16 if c <= 16 else 32 if c <= 32 else 64
        ri = 4 if bucket <= 8 else 2 if bucket <= 32 else 1
        kw = min((L + 3) & ~3, window)
        w = budget // (2 * gp * ri * kw * 4)
        return min(max(w, 1), warps) * ri, kw

    for gp in range(6, 130, 2):
        if gp in axial_lanes.NARROW_GP:
            continue
        for L in (1, 7, 13, 14, 28, 56, 57, 64):
            qb, kw = rows(gp, L)
            assert axial_lanes.wide_row_queries(gp, L) == qb
            assert axial_lanes.wide_row_keys(L) == kw
            for S in (1, 33, 448):
                assert axial_lanes._wide_bwd_slots(gp, L, S) == (
                    -(-L // qb) * -(-L // kw) * -(-S // lanes))
    sites = {(56, 12): 16, (56, 24): 8, (28, 24): 8, (28, 48): 8,
             (14, 48): 8, (14, 96): 4, (7, 96): 4, (56, 32): 8,
             (28, 32): 8, (28, 64): 8, (14, 64): 8, (14, 128): 4,
             (7, 128): 4}
    for (L, gp), qb in sites.items():
        assert axial_lanes.wide_row_queries(gp, L) == qb, (L, gp)
    # scratch: p and dlog (g, L, L, S), the lanes stats, table and daff
    # partials; 90 MB at axial50m's widest train site
    g, gp, L, S = 8, 12, 56, 448
    n_aff = -(-L // 16) * -(-L // 8) * -(-S // 32)
    assert axial_lanes._wide_bwd_slots(gp, L, S) == n_aff == 392
    assert axial_lanes.wide_bwd_scratch(g, gp, L, S, True, False) == (
        2 * g * L * L * S + g * 2 * gp * L * L + n_aff * g * 4)
    assert 2 * g * L * L * S * 4 / 2 ** 20 == 85.75
    assert axial_lanes.wide_bwd_scratch(g, 48, 14, 112, False, True) == (
        2 * g * 14 * 14 * 112 + 3 * g * 14 * 112
        + axial_lanes._wide_bwd_slots(48, 14, 112) * g * 4)


def test_wide_moments_slots_follow_the_kernel():
    """The wide moments backward's table partials have one slot per split
    of the stripes (csrc/moments_wide.cuh: kWideMinBlocks,
    kWideTabStripes): splits until the (span, 2, splits)
    grid reaches kWideMinBlocks blocks, each at least kWideTabStripes
    stripes; narrow widths keep their per-block slots; a wide gp takes
    the narrow widths' span cap (csrc/moments.cu: kMaxBwdSpan)."""
    src = (CSRC / "moments_wide.cuh").read_text()
    assert (_const(src, "kWideMinBlocks"), _const(src, "kWideTabStripes"),
            _const((CSRC / "moments.cu").read_text(), "kMaxBwdSpan")) == (
        moments.WIDE_MIN_BLOCKS, moments.WIDE_TAB_STRIPES,
        moments.BWD_MAX_SPAN)
    for L, S in [(56, 448), (28, 224), (14, 112), (7, 56), (7, 7),
                 (64, 3584), (1, 1), (13, 100)]:
        want = min(-(-264 // (2 * L)), -(-S // 32))
        assert moments.wide_bwd_slots(L, S) == want
        for gp in (12, 96, 128):
            assert moments.bwd_slots(gp, L, S, 8) == want
            qkv = torch.empty((8, 2 * gp, L, S), device="meta")
            _, dtables, part, n_part = moments.bwd_buffers(qkv, 8, gp, L, S,
                                                           True)
            c = gp // 2
            assert part.shape == (want, 2 * c + 2 * c * c, L)
    assert moments.bwd_slots(16, 56, 448, 8) == 8 * -(-448 // moments.bwd_tile(
        8, 56, 448, 8))
    assert moments.wide_bwd_slots(56, 448) == 3
    assert moments.wide_bwd_slots(7, 56) == 2


def test_wide_moments_fwd_tile_follows_the_kernel(monkeypatch):
    """The wide moments forward's partials have one slot per block of its
    tile, a count that the kernel library exports
    (csrc/moments.cu: medt_moment_sums_fwd_slots, the rule its entry
    points check n_part against): fwd_buffers asks it at a wide gp, and
    sizes the narrow widths' partials itself, one slot per 32 stripes
    (kFwdStripes), as it does without stripes."""
    src = (CSRC / "moments.cu").read_text()
    slots = src[src.index("int medt_moment_sums_fwd_slots("):]
    slots = slots[:slots.index("\n}\n")]
    fwd = src[src.index("int moments_fwd("):]
    fwd = fwd[:fwd.index("\n}\n")]
    for body in (slots, fwd):
        assert "const int ts = fwd_tile(g, gp, L, S);" in body
    assert "return g * ((S + ts - 1) / ts);" in slots
    assert "n_part != g * tiles" in fwd
    tile = src[src.index("int fwd_tile("):]
    assert "medt_moments::wide_fwd_tile(gp / 2, L, S, g)" in \
        tile[:tile.index("\n}\n")]
    assert _const(src, "kFwdStripes") == moments.FWD_STRIPES

    asked = []

    class Library:
        def medt_moment_sums_fwd_slots(self, g, gp, L, S):
            asked.append((g, gp, L, S))
            return -1 if gp == 66 else g * (S // 4 + 1)

    monkeypatch.setattr(moments, "library", Library)
    for gp, L, S, want in [(12, 56, 448, 8 * 113), (96, 7, 56, 8 * 15),
                           (16, 56, 448, 8 * 14), (12, 56, 0, 0),
                           (2, 301, 33, 8 * 2)]:
        qkv = torch.empty((8, 2 * gp, L, S), device="meta")
        out, part, n_part = moments.fwd_buffers(qkv, 8, gp, L, S)
        assert n_part == want == part.shape[0], (gp, L, S, n_part)
        assert out.shape == (8, 8) and part.shape == (n_part, 6)
        assert part.storage_offset() == out.numel()
    assert asked == [(8, 12, 56, 448), (8, 96, 7, 56)]
    with pytest.raises(ValueError, match="no kernel"):
        moments.fwd_buffers(torch.empty((8, 132, 7, 9), device="meta"),
                            8, 66, 7, 9)


# (kernel, span, gp, stripes, has_pos): every register-bucket edge (gp 6,
# 18, 32, 34, 64, 66, 126, 128), ragged spans (13, 57) and stripe counts,
# both contracts, with and without positions, and axial50m's span-56 site
# at batch 64 (3584 stripes)
WIDE_BWD_GEOMETRIES = [
    ("lanes", 13, 6, 37, True), ("lanes", 13, 6, 37, False),
    ("lanes", 16, 18, 100, True), ("lanes", 7, 32, 33, False),
    ("lanes", 13, 34, 45, True), ("lanes", 16, 64, 70, True),
    ("lanes", 9, 66, 31, False), ("lanes", 13, 126, 35, True),
    ("lanes", 14, 128, 112, True),
    ("flash", 57, 6, 45, True), ("flash", 64, 18, 40, False),
    ("flash", 57, 32, 33, True), ("flash", 28, 34, 50, False),
    ("flash", 64, 64, 31, True), ("flash", 17, 66, 40, True),
    ("flash", 40, 126, 9, True), ("flash", 64, 128, 35, True),
    ("flash", 56, 12, 3584, True),
    ("moments", 57, 6, 45, True), ("moments", 13, 18, 100, False),
    ("moments", 28, 32, 70, True), ("moments", 13, 34, 45, True),
    ("moments", 64, 64, 40, True), ("moments", 7, 66, 40, True),
    ("moments", 14, 126, 33, True), ("moments", 64, 128, 37, True),
    ("moments", 56, 12, 3584, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,L,gp,S,has_pos", WIDE_BWD_GEOMETRIES)
def test_wide_backward_on_card(cuda_device, kernel, L, gp, S, has_pos):
    """The wide attention backward (lanes and flash contracts) and moments
    backward against their plain versions (1e-4 + 1e-4 max|plain|), the
    same bits on a second run, and the bf16 entry point equal to the
    float32 kernel on the upcast qkv (dqkv rounded once)."""
    f32 = _card_calls(kernel, L, gp, S, has_pos, cuda_device)[-1]
    fn, fargs, plain = f32
    got, again, want = fn(*fargs), fn(*fargs), plain()
    torch.cuda.synchronize()
    for i, (o, a, w) in enumerate(zip(got, again, want)):
        name = f"{fn.__name__}[{i}] L {L} gp {gp} S {S}"
        _close(o, w, name)
        assert torch.equal(o, a), f"{name} differs between two runs"
    bf16 = _card_calls(kernel, L, gp, S, has_pos, cuda_device,
                       cast=lambda t: t.bfloat16())[-1]
    twin = _card_calls(kernel, L, gp, S, has_pos, cuda_device,
                       cast=lambda t: t.bfloat16().float())[-1]
    got, ref = bf16[0](*bf16[1]), twin[0](*twin[1])
    torch.cuda.synchronize()
    assert got[0].dtype == torch.bfloat16
    assert torch.equal(got[0], ref[0].to(torch.bfloat16)), "bf16 dqkv"
    for i, (o, w) in enumerate(zip(got[1:], ref[1:]), 1):
        assert torch.equal(o, w), f"bf16 {fn.__name__}[{i}]"


# ---- the long-span wide kernels (rows 5-6 and rows 10-11's long-span sites)
# and the wide moments backward above span 64 (row 8) --------------------------

# (kernel, span, gp, stripes, has_pos): axial50m's span-96 sites at 384 px
# (gp 12 and 24 at batch 8 and 1), axial50l's gp-32 site at batch 1, and a
# sweep over spans 80, 128, 192 and 256 at gp 6, 10, 12, 32, 64 and 128
# (every register bucket) with and without positions, at ragged stripe
# counts; the moments at the same sites and at the sweep's corners
LONG_GEOMETRIES = [
    ("flash2", 96, 12, 768, True), ("flash2", 96, 24, 768, True),
    ("flash2", 96, 12, 96, True), ("flash2", 96, 24, 96, True),
    ("flash2", 96, 32, 96, True),
] + [("flash2", L, gp, S, pos)
     for L, S in ((80, 45), (128, 33), (192, 20), (256, 9))
     for gp in (6, 10, 12, 32, 64, 128) for pos in (True, False)] + [
    ("moments", 96, 12, 768, True), ("moments", 96, 24, 768, True),
    ("moments", 96, 32, 96, True), ("moments", 80, 10, 45, False),
    ("moments", 128, 64, 33, True), ("moments", 192, 128, 20, True),
    ("moments", 256, 6, 9, True), ("moments", 256, 128, 9, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,L,gp,S,has_pos", LONG_GEOMETRIES)
def test_long_wide_kernels_on_card(cuda_device, kernel, L, gp, S, has_pos):
    """The flash2 wrappers at a wide gp (the long-span wide kernels) and
    the wide moments kernels at spans 80-256 against their plain versions
    (forward: atol 1e-4, m and l plus rtol 1e-5; backward and moments 1e-4
    + 1e-4 max|plain|), the same bits on a second run, one launch a call,
    and each bf16 entry point equal to its float32 twin on the upcast qkv
    (dqkv: the float32 dqkv rounded once), counted under launches_bf16."""
    calls = _card_calls(kernel, L, gp, S, has_pos, cuda_device)
    bf16 = _card_calls(kernel, L, gp, S, has_pos, cuda_device,
                       cast=lambda t: t.bfloat16())
    twin = _card_calls(kernel, L, gp, S, has_pos, cuda_device,
                       cast=lambda t: t.bfloat16().float())
    for (fn, fargs, plain), (_, bargs, _), (_, targs, _) in zip(calls, bf16,
                                                                twin):
        before = fn.launches
        got, again = fn(*fargs), fn(*fargs)
        if isinstance(got, torch.Tensor):
            got, again = (got,), (again,)
        want = plain()
        torch.cuda.synchronize()
        assert fn.launches == before + 2, fn.__name__
        for i, (o, a, w) in enumerate(zip(got, again, want)):
            name = f"{fn.__name__}[{i}] L {L} gp {gp} S {S}"
            if fn.__name__ == "flash2_lanes_fwd":
                rtol = 1e-5 if i >= 2 else 0.0   # m and l
                torch.testing.assert_close(o, w, atol=1e-4, rtol=rtol,
                                           msg=name)
            else:
                _close(o, w, name)
            assert torch.equal(o, a), f"{name} differs between two runs"
        before = fn.launches_bf16
        got, ref = fn(*bargs), fn(*targs)
        if isinstance(got, torch.Tensor):
            got, ref = (got,), (ref,)
        torch.cuda.synchronize()
        assert fn.launches_bf16 == before + 1, fn.__name__
        for i, (o, w) in enumerate(zip(got, ref)):
            if fn.__name__.endswith("_bwd") and i == 0:
                assert o.dtype == torch.bfloat16
                w = w.to(torch.bfloat16)
            assert torch.equal(o, w), f"bf16 {fn.__name__}[{i}] L {L} gp {gp}"
