"""The long-span sites at wide group planes, and the axial classifiers at
384 px, against the JAX package on the CPU.

At 384 px, layer 1 and the first block of layer 2 of the axial
classifiers attend along span 96 at gp 12 and 24 (axial50m) or 16 and 32
(axial50l): the flash2 route, whose kernels take every even gp from 2 to
128 at spans 65-256 (the long-span wide kernels, ``csrc/wide_long.cuh``,
at every gp outside 2, 4, 8 and 16). On the CPU the port runs their plain
versions, which its autograd Functions send CPU tensors to. Inputs come
from numpy with a seed; float32 on both sides, another summation order.
What is held, and at what tolerance:

* (a) the port's ``flash2_lanes_core`` at (span 96, gp 12) and (128, gp 6),
  g = 1, 128 stripes, with positions, against JAX's Pallas ``_flash2_fwd``
  (interpret mode): sv and sve at atol 1e-5, m and l at atol 1e-5 plus
  rtol 1e-5; and the five gradients against ``jax.vjp`` of
  ``flash2_lanes_core`` at 1e-5 + 1e-4 * max|want| each (the rule of
  tests/test_torch_port_flash2.py);
* (b) the same core at (96, gp 24), 8 stripes, serving rows 10-11's
  contract: against JAX's stripe kernel ``fused_attn_core`` (interpret
  mode), which JAX runs at such a site, outputs at atol 1e-5 and the
  seven gradients at 1e-5 + 1e-5 * max|want| (daff, a sum over S * L * L
  products, at 1e-4 + 1e-4 * max|want|), the rules of
  tests/test_torch_port_wide.py;
* (c) the moments core at (96, gp 12) and (96, gp 24): the (g, 8) sums and
  the backward (dqkv and the four table gradients) against the Pallas
  ``moment_sums_core`` and its VJP (interpret mode), 1e-5 + 1e-5 *
  max|want|;
* (d) ROADMAP section 3 item 1's site: ``AxialAttention(64, 256,
  span=128, groups=8, use_fused=True)`` (gp 32, the flash2 route) in
  train and eval mode against JAX's module on the same weights: outputs
  at atol 1e-4; in train mode the input and parameter gradients at rtol
  1e-3 / atol 1e-5 and the BN running statistics at rtol 1e-5, each plus
  4 times the port's own spread under a 1e-6 relative input perturbation
  (tests/test_torch_port_cls.py's ``held``);
* (e) the slice as a whole at a narrow width with the classifiers' widths
  per group: ``AxialAttentionNet(layers=(1, 1, 1, 1), s=0.1875,
  groups=2, img_size=384, num_classes=10)`` (gp 12 and 24 at span 96,
  on the flash2 route) on the weights the bridge carries from JAX's
  model, against JAX's model on its plain path (``use_fused=False``) at
  batch 1: eval logits at atol 1e-4, one train step's loss, input and
  parameter gradients and running statistics under
  tests/test_torch_port_cls.py's rules (at batch 2, 1.8M logits a
  span-96 similarity BN channel, JAX's float32 running variance there
  lies 1.5e-5 relative from both the port's float32 and its float64
  plain run, which agree to 1e-7: JAX's CPU summation, past rtol 1e-5);
* the host rules of the long-span kernels: the flash2 backward's daff
  slots follow ``csrc/wide_long.cuh``, the wide moments backward takes
  spans up to 256, and every even gp from 2 to 128 passes ``check_gp``
  on the flash2 route at spans 65-256.

PyTorch runs on one thread (tests/_torch_threads.py).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one PyTorch thread)

from medt_tpu.models import classifiers as jcls
from medt_tpu.ops import pallas_axial_lanes as jlanes
from medt_tpu.ops import pallas_axial_train as jtrain
from medt_tpu.ops import pallas_moments as jmoments
from medt_tpu.ops.axial_attention import AxialAttention as JaxAxialAttention
from medt_tpu_torch.models.classifiers import AxialAttentionNet
from medt_tpu_torch.ops import AxialAttention, axial_lanes, moments
from medt_tpu_torch.ops.axial_attention import fused_route
from medt_tpu_torch.utils import weights
from test_torch_port_cls import (GRAD_RTOL, GRAD_ATOL, INPUT_NOISE,
                                 assert_step, carried, held, jax_run,
                                 port_train, variables_of)
from test_torch_port_train_ops import assert_close

F32 = np.float32
CSRC = Path(__file__).resolve().parent.parent / "medt_tpu_torch" / "csrc"


def _np(t):
    return t.detach().cpu().numpy()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _tight(got, want, name, rel=1e-5):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    tol = rel + rel * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=name)


def _core_args(seed, g, gp, L, S):
    """Fused qkv, the three tables (kemb_t [c, i, j]) and the affine, with
    positions, scaled as the model's."""
    rng = np.random.default_rng(seed)
    c = gp // 2

    def t(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(F32)

    aff = np.abs(t(g, 8)) * np.array([1, 0, 1, 0, 1, 0, 0, 0], F32) \
        + t(g, 8, scale=0.1) * np.array([0, 1, 0, 1, 0, 1, 0, 0], F32)
    return [t(g, 2 * gp, L, S), t(c, L, L, scale=gp ** -0.5),
            t(c, L, L, scale=gp ** -0.5), t(gp, L, L, scale=gp ** -0.5),
            aff.astype(F32)]


def _vjp(fn, args, cts):
    """JAX's outputs of ``fn`` and its VJP of ``cts``, under one jit."""
    @jax.jit
    def run(args, cts):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(cts)

    return run([jnp.asarray(a) for a in args],
               jax.tree_util.tree_map(jnp.asarray, cts))


# ---- (a) the flash2 core at wide gp against the Pallas flash2 ----------------

@pytest.mark.parametrize("L,gp", [(96, 12), (128, 6)])
def test_flash2_wide_core_matches_pallas(L, gp):
    """sv, sve, m and l of the port's plain flash2 forward against the
    Pallas ``_flash2_fwd``, and the five gradients through the port's
    autograd Function against ``jax.vjp`` of ``flash2_lanes_core``."""
    g, S = 1, 128
    assert jlanes.flash2_supported(L, g, gp, S)
    assert axial_lanes.is_wide(gp)
    args = _core_args(100 + L + gp, g, gp, L, S)
    want = jlanes._flash2_fwd(*map(jnp.asarray, args))
    got = axial_lanes.flash2_lanes_plain(*map(torch.from_numpy, args))
    for name, o, w in zip(("sv", "sve", "m", "l"), got, want):
        np.testing.assert_allclose(_np(o), np.asarray(w), atol=1e-5,
                                   rtol=1e-5 if name in ("m", "l") else 0.0,
                                   err_msg=name)
    rng = np.random.default_rng(L * gp)
    dsv, dsve = (rng.normal(size=(g, gp, L, S)).astype(F32)
                 for _ in range(2))
    (sv_w, sve_w), grads = _vjp(jlanes.flash2_lanes_core, args, (dsv, dsve))
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
    sv, sve = axial_lanes.flash2_lanes_core(*leaves)
    assert_close(sv, sv_w, "sv")
    assert_close(sve, sve_w, "sve")
    ((sv * torch.from_numpy(dsv)).sum()
     + (sve * torch.from_numpy(dsve)).sum()).backward()
    for name, leaf, w in zip(("dqkv", "dqemb", "dkemb_t", "dvemb", "daff"),
                             leaves, grads):
        assert_close(leaf.grad, w, name)


# ---- (b) rows 10-11's long-span contract ---------------------------------------

def test_flash2_wide_core_serves_fused_attn_core():
    """At (span 96, gp 24) JAX's flash2 admits no site and its stripe
    kernel does; the port's flash2 core on the lanes layout against
    ``fused_attn_core`` on the stripe layout: outputs and the gradients
    of q, k, v, the three tables and the affine."""
    g, gp, L, S = 1, 24, 96, 8
    c = gp // 2
    assert jtrain.fused_train_supported(L, g, gp)
    assert not jlanes.flash2_supported(L, g, gp, 128)
    assert fused_route(L, S, True, gp) == "flash2"
    qkv, qemb, kemb_t, vemb, aff = _core_args(120, g, gp, L, S)
    kemb = np.ascontiguousarray(kemb_t.transpose(0, 2, 1))    # [c, j, i]
    st = qkv.transpose(3, 0, 1, 2)                            # (S, g, 2gp, L)
    stripe = [np.ascontiguousarray(a) for a in (
        st[:, :, :c], st[:, :, c:gp], st[:, :, gp:])] + [qemb, kemb, vemb,
                                                         aff]
    rng = np.random.default_rng(121)
    dsv, dsve = (rng.normal(size=(S, g, gp, L)).astype(F32) for _ in range(2))
    (sv_w, sve_w), want = _vjp(jtrain.fused_attn_core, stripe, (dsv, dsve))

    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in stripe]
    q, k, v, tq, tk, tv, ta = leaves
    lanes = torch.cat([q, k, v], dim=2).permute(1, 2, 3, 0).contiguous()
    sv, sve = axial_lanes.flash2_lanes_core(
        lanes, tq, tk.transpose(1, 2).contiguous(), tv, ta)
    sv, sve = sv.permute(3, 0, 1, 2), sve.permute(3, 0, 1, 2)
    np.testing.assert_allclose(_np(sv), sv_w, atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(sve), sve_w, atol=1e-5, rtol=0)
    ((sv * torch.from_numpy(dsv)).sum()
     + (sve * torch.from_numpy(dsve)).sum()).backward()
    for name, leaf, w in zip(("dq", "dk", "dv", "dqemb", "dkemb", "dvemb"),
                             leaves, want):
        _tight(leaf.grad, w, name)
    _tight(ta.grad, want[-1], "daff", rel=1e-4)


# ---- (c) the moments at span 96 --------------------------------------------------

@pytest.mark.parametrize("gp", [12, 24])
def test_moments_span96_match_pallas(gp):
    """The (g, 8) moment sums and their backward (dqkv, dr_q, de_q, dr_k,
    de_k) of the port's plain versions against the Pallas
    ``moment_sums_core`` and its VJP at span 96."""
    g, L, S = 1, 96, 128
    c = gp // 2
    rng = np.random.default_rng(130 + gp)
    qkv = rng.normal(size=(g, 2 * gp, L, S)).astype(F32)
    qemb, kemb = (rng.normal(size=(c, L, L)).astype(F32) * gp ** -0.5
                  for _ in range(2))
    tables = [t.astype(F32) for t in (
        qemb.sum(2), np.einsum("cij,dij->cdi", qemb, qemb), kemb.sum(2),
        np.einsum("cji,dji->cdj", kemb, kemb))]
    ct = rng.normal(size=(g, 8)).astype(F32)
    sums_w, want = _vjp(jmoments.moment_sums_core, [qkv, *tables], ct)
    ins = [torch.from_numpy(a) for a in (qkv, *tables)]
    _tight(moments.moment_sums(*ins), sums_w, "sums")
    got = moments.moment_sums_bwd_plain(*ins, torch.from_numpy(ct))
    for name, o, w in zip(("dqkv", "dr_q", "de_q", "dr_k", "de_k"), got,
                          want):
        _tight(o, w, name)


# ---- (d) the fault's site: gp 32 at span 128 --------------------------------------

def test_wide_site_at_span_128_matches_jax():
    """``AxialAttention(64, 256, span=128, groups=8, use_fused=True)``: gp
    32 on the flash2 route (it raised before its kernels took wide gp) in
    eval and train mode against JAX's module on the same weights."""
    cin, out_planes, span, m, n = 64, 256, 128, 2, 1
    rng = np.random.default_rng(140)
    x = rng.normal(size=(n, span, m, cin)).astype(F32)
    kw = dict(in_planes=cin, out_planes=out_planes, span=span, groups=8,
              axis="h", mode="full")
    jop = JaxAxialAttention(use_fused=False, **kw)
    variables = variables_of(jop, x, seed=141)
    dy = rng.normal(size=(n, span, m, out_planes)).astype(F32)

    @jax.jit
    def run(variables, x):
        out = jop.apply(variables, x, train=False)

        def f(params, x):
            y, mut = jop.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               x, train=True, mutable=["batch_stats"])
            return jnp.sum(y * dy), (y, mut["batch_stats"])
        (_, (y, stats)), grads = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(variables["params"], x)
        return out, y, stats, grads

    out, y, stats, (gparams, gx) = run(variables, jnp.asarray(x))
    sd = weights.to_state_dict(weights.export_state_dict(
        variables["params"], variables["batch_stats"]))
    top = AxialAttention(cin, out_planes, span, groups=8, axis="h",
                         mode="full", use_fused=True, device="cpu")
    top.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = top.eval()(_nchw(x))
    assert top.last_route[0] == "flash2" and top.gp == 32
    np.testing.assert_allclose(_np(got).transpose(0, 2, 3, 1),
                               np.asarray(out), atol=1e-4, rtol=0)
    runs = []
    for k in range(3):    # the input, then two perturbed copies
        xi = x if k == 0 else (x * (1.0 + INPUT_NOISE * rng.standard_normal(
            x.shape))).astype(F32)
        top.load_state_dict(sd, strict=True)
        top.zero_grad(set_to_none=True)
        xt = _nchw(xi).requires_grad_(True)
        got = top.train()(xt)
        (got * _nchw(dy)).sum().backward()
        runs.append({"out": _np(got).transpose(0, 2, 3, 1),
                     "input": _np(xt.grad),
                     **{f"grad.{k}": _np(p.grad)
                        for k, p in top.named_parameters()
                        if p.requires_grad},
                     **{f"stat.{k}": _np(b) for k, b in top.named_buffers()
                        if k.endswith(("running_mean", "running_var"))}})
    assert top.last_route[0] == "flash2"
    held(runs, "out", np.asarray(y), 0.0, 1e-4)
    held(runs, "input", np.asarray(gx).transpose(0, 3, 1, 2), GRAD_RTOL,
         GRAD_ATOL)
    want = weights.export_state_dict(
        jax.tree_util.tree_map(np.asarray, gparams), {})
    grads = [k for k in runs[0] if k.startswith("grad.")]
    assert grads
    for k in grads:
        held(runs, k, want[k[len("grad."):]], GRAD_RTOL, GRAD_ATOL)
    want = weights.export_state_dict({}, jax.tree_util.tree_map(
        np.asarray, stats))
    assert {f"stat.{k}" for k in want} == {k for k in runs[0]
                                          if k.startswith("stat.")}
    for k, w in want.items():
        held(runs, f"stat.{k}", w, 1e-5, 1e-7)


# ---- (e) the slice: the classifier at 384 px ------------------------------------

def test_axial_net_384_matches_jax():
    """``AxialAttentionNet(layers=(1, 1, 1, 1), s=0.1875, groups=2,
    img_size=384)``: the span schedule (96, 96, 48, 24), gp 12 and 24 on
    the flash2 route at span 96; eval logits and one train step against
    JAX's model on its plain path."""
    kw = dict(layers=(1, 1, 1, 1), s=0.1875, groups=2, img_size=384,
              num_classes=10)
    jmodel = jcls.AxialAttentionNet(**kw)
    rng = np.random.default_rng(150)
    x = rng.normal(size=(1, 384, 384, 3)).astype(F32)
    labels = np.array([6], np.int64)
    variables = variables_of(jmodel, x, seed=151)
    sd = carried("axial50m", variables["params"], variables["batch_stats"])
    logits, loss, gparams, gx, stats = jax_run(jmodel, variables, x, labels)

    models = []

    def make():
        models.append(AxialAttentionNet(**kw, use_fused=True, device="cpu"))
        models[-1].load_state_dict(sd, strict=True)
        return models[-1]

    def routes(model):
        return {(m.span, m.gp, m.last_route[0]) for m in model.modules()
                if isinstance(m, AxialAttention)}

    with torch.no_grad():
        got = make().eval()(_nchw(x))
    np.testing.assert_allclose(_np(got), logits, atol=1e-4, rtol=0)
    # batch 1: 48 stripes at span 48, 24 at span 24 (eval under 128)
    assert routes(models[0]) == {(96, 12, "flash2"), (96, 24, "flash2"),
                                 (48, 48, "eval"), (24, 96, "eval")}
    runs = port_train(make, x, labels)
    assert routes(models[1]) == {(96, 12, "flash2"), (96, 24, "flash2"),
                                 (48, 48, "flash"), (24, 96, "flash")}
    assert_step(runs, "axial", loss, gx, gparams, stats)


def test_long_span_scratch_is_bounded():
    """The flash2 backward's scratch at a wide gp (``long_bwd_scratch``):
    delta (g, L, S), the daff slots and, with positions, ``long_bwd_slices``
    table partial slots of 2gp L^2 floats, at axial50m-384's sites (span
    96, gp 12 and 24, 768 stripes: 22 slots, 19.5 and 38.9 MB), axial50l-
    384's batch-1 site (96, gp 32, 96 stripes: 11 slots, 26.0 MB) and the
    largest geometry (span 256, gp 128, g 8, 2048 stripes: 4 slots, 268 MB),
    where the slots stop at 2^26 floats and no longer grow with the stripes;
    no more slots than (group, 32-stripe) units, one at the least."""
    mb = 4 / 1e6
    for (g, gp, L, S), slots, tables_mb in [
            ((8, 12, 96, 768), 22, 19.46), ((8, 24, 96, 768), 22, 38.93),
            ((8, 32, 96, 96), 11, 25.95), ((8, 128, 256, 2048), 4, 268.44)]:
        part = axial_lanes.long_bwd_scratch(g, gp, L, S, True)
        assert axial_lanes.long_bwd_slices(g, gp, L, S) == slots
        assert part["delta"] == g * L * S
        assert part["aff"] == axial_lanes.long_bwd_slots(L, S) * g * 4
        assert part["tables"] == slots * 2 * gp * L * L
        assert abs(part["tables"] * mb - tables_mb) < 0.01
        assert axial_lanes.long_bwd_scratch(g, gp, L, S, False)["tables"] == 0
    for S in (2048, 4096, 1 << 16):
        assert (axial_lanes.long_bwd_scratch(8, 128, 256, S, True)["tables"]
                <= axial_lanes.LONG_MAX_PART_FLOATS)
    for g, gp, L, S in [(1, 12, 96, 1), (2, 6, 65, 33), (8, 32, 96, 96),
                        (1, 128, 256, 1)]:
        assert 1 <= axial_lanes.long_bwd_slices(g, gp, L, S) <= g * -(-S // 32)


# ---- the host rules ----------------------------------------------------------------

def test_long_span_host_rules():
    """The flash2 backward at a wide gp allocates the daff slots that
    csrc/wide_long.cuh's slot_capacity gives (one per query row and 32
    stripes at most) and the table partial slots that its row_slices gives
    (mirrored by ``long_bwd_slices`` from the source's constants: 4 warps
    of 2 query rows up to c = 14, else 1, 264 blocks, at most 2^26 floats);
    the wide moments backward takes spans up to 256
    (csrc/moments.cu's cap for every width); every even gp from 2 to 128 passes check_gp,
    and the fused route sends spans 65-256 to flash2 in both modes."""
    src = (CSRC / "wide_long.cuh").read_text()
    assert re.search(r"constexpr int kStripes = 32;", src)
    assert re.search(r"constexpr int kMaxSpan = 256;", src)
    assert "return L * ((S + kStripes - 1) / kStripes);" in src
    for L, S in [(96, 768), (96, 96), (256, 2048), (80, 45), (65, 1)]:
        assert axial_lanes.long_bwd_slots(L, S) == L * -(-S // 32)
    warps = int(re.search(r"constexpr int kWarps = (\d+);", src).group(1))
    target = int(re.search(r"constexpr int kTargetBlocks = (\d+);",
                           src).group(1))
    cap = re.search(r"constexpr long long kMaxPartFloats = 1LL << (\d+);",
                    src)
    assert (warps, target, 1 << int(cap.group(1))) == (
        axial_lanes.LONG_WARPS, axial_lanes.LONG_TARGET_BLOCKS,
        axial_lanes.LONG_MAX_PART_FLOATS)
    assert "constexpr int row_rows(int c) { return c <= 14 ? 2 : 1; }" in src
    assert "const int rb = kWarps * row_rows(gp / 2);" in src
    mom = (CSRC / "moments.cu").read_text()
    assert "constexpr int kMaxBwdSpan = 256;" in mom
    assert moments.BWD_MAX_SPAN == 256
    for gp in range(2, 130, 2):
        axial_lanes.check_gp("flash2_lanes_fwd", gp)
    for L in (65, 96, 128, 256):
        for stripes, training in ((1, True), (96, False), (768, True)):
            assert fused_route(L, stripes, training, 24) == "flash2"
    assert fused_route(257, 96, True, 24) == "plain"
