"""The port's stripe-major train core against the JAX package, on the CPU.

What is held (inputs from numpy with a seed):

* the plain forward (``attn_core_plain``) and the explicit plain backward
  (``fused_attn_bwd_plain``, through the port's autograd) against the Pallas
  ``fused_attn_core`` and ``jax.vjp`` of it, in interpret mode (its
  ``_interpret_default`` on the CPU), at spans 32 and 64 with gp 2, 4 and 8,
  g = 2 and 8, with positions and without (zero tables, JAX's contract;
  and zero-size tables, the port's): forward at atol 1e-5, every gradient
  at 1e-5 + 1e-5 * max|want|;
* the explicit backward against ``torch.autograd`` of ``attn_core_plain``
  in float64 (atol 1e-10: one function, differentiated two ways);
* the route of every attention site of a train-mode forward against JAX's
  ``kernel_registry`` (``jax.eval_shape``, no compile): MedT-128 at batch 1
  and gatedaxialunet-128 at batches 1 and 2 run the stripe core where JAX
  runs its stripe kernel and flash where JAX runs flash; the one stated
  difference is the sites of span <= 16 with fewer than 128 stripes,
  where JAX takes its XLA einsums and the port keeps its lanes kernel;
* ``AxialAttention`` in train mode on the stripe route (span 32, batch 1)
  against JAX, with positions and without: output, input gradient, every
  parameter gradient and the running statistics, as
  tests/test_torch_port_train_attention.py holds the other routes;
* one whole ``train_step`` of gatedaxialunet at 64 px and batch 1, whose
  span-32 sites are stripe in both, against JAX ``train_step``, held as
  tests/test_torch_port_training.py holds its whole steps.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one PyTorch thread)

from medt_tpu.models import build_model as jax_build_model
from medt_tpu.ops import kernel_registry
from medt_tpu.ops import pallas_axial_train as jtrain
from medt_tpu.ops.axial_attention import AxialAttention as JaxAxialAttention
from medt_tpu_torch.models import build_model
from medt_tpu_torch.ops import axial_train
from medt_tpu_torch.ops.attn_core import attn_core_plain
from medt_tpu_torch.ops.axial_attention import AxialAttention, fused_route
from medt_tpu_torch.utils.weights import export_state_dict, to_state_dict
from test_torch_port_ops import GATES, _carry, random_variables
from test_torch_port_train_ops import F32, assert_close
from test_torch_port_training import check_train_step


def stripe_inputs(seed, g, gp, L, S, pos):
    """q, k, v, qemb, kemb, vemb, aff as float32 numpy arrays. ``pos``:
    "yes" (random tables), "zero" (zero tables, JAX's position-free
    contract) or "empty" (zero-size tables)."""
    rng = np.random.default_rng(seed)
    c = gp // 2
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(F32)  # noqa
    q, k, v = f(S, g, c, L), f(S, g, c, L), f(S, g, gp, L)
    if pos == "yes":
        tables = [f(c, L, L, scale=gp ** -0.5), f(c, L, L, scale=gp ** -0.5),
                  f(gp, L, L, scale=gp ** -0.5)]
        a, b = 0.5 + rng.uniform(size=(3, g)), 0.1 * rng.normal(size=(3, g))
        aff = np.asarray(jtrain.pack_sim_affine(
            g, jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32),
            "full"))
    else:
        n = 0 if pos == "empty" else 1
        tables = [np.zeros((c * n, L, L), F32), np.zeros((c * n, L, L), F32),
                  np.zeros((gp * n, L, L), F32)]
        a, b = 0.5 + rng.uniform(size=(g,)), 0.1 * rng.normal(size=(g,))
        aff = np.asarray(jtrain.pack_sim_affine(
            g, jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32),
            "wopos"))
    return [q, k, v, *tables, aff]


def _tight(got, want, name):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    tol = 1e-5 + 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=name)


# (span, gp, stripes): the batch-1 and batch-2 geometries at a test size
CORE_GEOMETRIES = [(32, 4, 8), (64, 2, 4), (32, 8, 4)]
NAMES = ("dq", "dk", "dv", "dqemb", "dkemb", "dvemb", "daff")


@pytest.mark.parametrize("pos", ["yes", "zero"])
@pytest.mark.parametrize("g", [2, 8])
@pytest.mark.parametrize("L,gp,S", CORE_GEOMETRIES)
def test_stripe_core_matches_pallas(L, gp, S, g, pos):
    """Forward and all seven gradients against the Pallas core and its
    custom VJP; with zero tables the zero-size variant of the port is held
    too (sv and dq, dk, dv equal; sve zero; no table gradients; daff's qk
    and bias columns)."""
    args = stripe_inputs(10 * L + gp + g, g, gp, L, S, pos)
    rng = np.random.default_rng(L + S)
    dsv = rng.normal(size=(S, g, gp, L)).astype(F32)
    dsve = rng.normal(size=(S, g, gp, L)).astype(F32)
    (sv_w, sve_w), vjp = jax.vjp(jtrain.fused_attn_core,
                                 *map(jnp.asarray, args))
    want = vjp((jnp.asarray(dsv), jnp.asarray(dsve)))

    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
    sv, sve = axial_train.fused_attn_core(*leaves)
    np.testing.assert_allclose(sv.detach().numpy(), sv_w, atol=1e-5, rtol=0)
    np.testing.assert_allclose(sve.detach().numpy(), sve_w, atol=1e-5,
                               rtol=0)
    ((sv * torch.from_numpy(dsv)).sum()
     + (sve * torch.from_numpy(dsve)).sum()).backward()
    for name, leaf, w in zip(NAMES, leaves, want):
        _tight(leaf.grad, w, name)
    if pos == "yes":
        return

    empty = stripe_inputs(10 * L + gp + g, g, gp, L, S, "empty")
    leaves = [torch.from_numpy(a.copy()).requires_grad_(a.size > 0)
              for a in empty]
    sv, sve = axial_train.fused_attn_core(*leaves)
    np.testing.assert_allclose(sv.detach().numpy(), sv_w, atol=1e-5, rtol=0)
    assert not sve.requires_grad and not sve.any()
    (sv * torch.from_numpy(dsv)).sum().backward()
    for name, leaf, w in zip(NAMES[:3], leaves, want):
        _tight(leaf.grad, w, name)
    assert all(leaf.grad is None for leaf in leaves[3:6])
    daff = leaves[6].grad
    _tight(daff[:, :2], np.asarray(want[6])[:, :2], "daff")
    assert not daff[:, 2:].any()


@pytest.mark.parametrize("pos", ["yes", "zero", "empty"])
def test_explicit_stripe_backward_matches_autograd_f64(pos):
    """``fused_attn_bwd_plain`` vs autograd through ``attn_core_plain``,
    float64."""
    S, g, gp, L = 6, 2, 4, 40
    args = [torch.from_numpy(a.astype(np.float64))
            for a in stripe_inputs(31, g, gp, L, S, pos)]
    leaves = [a.clone().requires_grad_(a.numel() > 0) for a in args]
    rng = np.random.default_rng(32)
    dsv, dsve = (torch.from_numpy(rng.normal(size=(S, g, gp, L)))
                 for _ in range(2))
    has_pos = pos != "empty"
    sv, sve = attn_core_plain(*leaves, has_pos=has_pos)
    ((sv * dsv).sum() + (sve * dsve).sum()).backward()
    got = axial_train.fused_attn_bwd_plain(*args, dsv, dsve)
    for name, leaf, gr in zip(NAMES, leaves, got):
        if not leaf.numel():
            assert gr.numel() == 0, name
            continue
        torch.testing.assert_close(gr, leaf.grad, atol=1e-10, rtol=1e-10,
                                   msg=name)


def test_stripe_route_rule():
    assert fused_route(64, 64, training=True) == "stripe"
    assert fused_route(32, 127, training=True) == "stripe"
    assert fused_route(32, 128, training=True) == "flash"
    assert fused_route(31, 32, training=True) == "flash"
    assert fused_route(16, 16, training=True) == "lanes"
    assert fused_route(96, 8, training=True) == "flash2"
    assert fused_route(64, 64, training=False) == "eval"


# ---- routes: train mode, the port's sites against JAX's kernel_registry ----

ATTENTION_FAMILIES = ("lanes", "flash", "flash2", "stripe", "eval")


def _jax_train_routes(name, img, batch, monkeypatch):
    """(family, span, g, gp, S, has_pos) of every attention-core site of a
    train-mode forward (eval_shape: no compute)."""
    sites = []
    monkeypatch.setattr(
        kernel_registry, "record",
        lambda family, **kw: sites.append(
            (family, kw["span"], kw["g"], kw["gp"], kw["S"], kw["has_pos"])))
    model = jax_build_model(name, img_size=img, use_fused=True)
    x = jax.ShapeDtypeStruct((batch, img, img, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x, train=False), x)
    sites.clear()
    jax.eval_shape(lambda v, x: model.apply(v, x, train=True,
                                            mutable=["batch_stats"]),
                   shapes, x)
    return [s for s in sites if s[0] in ATTENTION_FAMILIES]


def _port_train_routes(name, img, batch):
    model = build_model(name, img_size=img, use_fused=True,
                        plain_cores=True, device="meta").train()
    with torch.no_grad():
        model(torch.zeros((batch, 3, img, img), device="meta"))
    return [m.last_route for m in model.modules()
            if isinstance(m, AxialAttention)]


# stripe sites per train step: (span, gp, stripes) -> sites
STRIPE_SITES = {
    ("MedT", 1): {(64, 2, 64): 2, (64, 4, 64): 2, (32, 4, 32): 2},
    ("gatedaxialunet", 1): {(64, 2, 64): 2, (64, 4, 64): 2, (32, 4, 32): 2,
                            (32, 8, 32): 2},
    ("gatedaxialunet", 2): {(32, 4, 64): 2, (32, 8, 64): 2},
}


@pytest.mark.parametrize("name,batch", sorted(STRIPE_SITES))
def test_train_routes_match_jax_registry(name, batch, monkeypatch):
    port = collections.Counter(_port_train_routes(name, 128, batch))
    jax_sites = collections.Counter(
        _jax_train_routes(name, 128, batch, monkeypatch))
    kept_lanes = collections.Counter({
        r: n for r, n in port.items()
        if r[0] == "lanes" and r[1] <= 16 and r[4] < 128})
    assert port - kept_lanes == jax_sites
    assert not any(r[0] == "lanes" for r in jax_sites if r[4] < 128)
    stripe = {(L, gp, S): n for (r, L, g, gp, S, pos), n in port.items()
              if r == "stripe"}
    assert stripe == STRIPE_SITES[name, batch]
    assert all(pos and g == 8 for r, L, g, gp, S, pos in port
               if r == "stripe")


# ---- AxialAttention in train mode on the stripe route -----------------------

@pytest.mark.parametrize("mode,axis,stride", [
    ("gated", "h", 1), ("full", "w", 2), ("wopos", "h", 1)])
def test_axial_attention_stripe_route_matches_jax(mode, axis, stride):
    """Span 32, batch 1, 32 stripes: JAX runs its stripe kernel (interpret
    mode), the port the stripe core. Tolerances as in
    tests/test_torch_port_train_attention.py: 1e-5 + 1e-4 * max|want| per
    tensor, the similarity BN's bias gradient (0 in exact arithmetic) at
    the scale of its weight gradient."""
    n, cin, out, groups, span, m = 1, 6, 16, 2, 32, 32
    hw = (span, m) if axis == "h" else (m, span)
    rng = np.random.default_rng(70)
    x = rng.normal(size=(n, *hw, cin)).astype(F32)
    ct = rng.normal(size=(n, hw[0] // stride, hw[1] // stride, out)) \
        .astype(F32)
    kw = dict(in_planes=cin, out_planes=out, span=span, groups=groups,
              stride=stride, axis=axis, mode=mode, gate_init=GATES)
    jop = JaxAxialAttention(use_fused=True, **kw)
    shapes = jax.eval_shape(
        lambda x: jop.init(jax.random.PRNGKey(0), x, train=False), x)
    variables = random_variables(shapes, seed=71)

    def loss(params, x):
        y, mut = jop.apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, x,
                           train=True, mutable=["batch_stats"])
        return jnp.sum(y * ct), (y, mut["batch_stats"])

    with kernel_registry.recording() as rec:
        (_, (y, stats)), (gparams, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                                jnp.asarray(x))
    assert {geo.family for geo in rec} >= {"stripe"}

    top = AxialAttention(cin, out, span, groups=groups, stride=stride,
                         axis=axis, mode=mode, gate_init=GATES,
                         use_fused=True, device="cpu")
    top.load_state_dict(_carry(variables, mode, GATES), strict=True)
    top.train()
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    yt = top(xt)
    assert top.last_route[0] == "stripe"
    (yt * torch.from_numpy(ct.transpose(0, 3, 1, 2).copy())).sum().backward()

    assert_close(yt.permute(0, 2, 3, 1), y, "output")
    assert_close(xt.grad.permute(0, 2, 3, 1), gx, "input gradient")
    grads = to_state_dict(export_state_dict(
        jax.tree_util.tree_map(np.asarray, gparams), {}))
    for name, p in top.named_parameters():
        if not p.requires_grad:
            assert p.grad is None
            continue
        if name == "bn_similarity.bias":
            scale = float(grads["bn_similarity.weight"].abs().max())
            np.testing.assert_allclose(
                p.grad.numpy(), grads[name].numpy(),
                atol=1e-5 + 1e-4 * scale, rtol=0, err_msg=name)
            continue
        assert_close(p.grad, grads[name], name)
    running = to_state_dict(export_state_dict(
        {}, jax.tree_util.tree_map(np.asarray, stats)))
    held = 0
    for name, b in top.named_buffers():
        if name in running:
            assert_close(b, running[name], name)
            held += 1
    assert held >= 6


# ---- the whole step at batch 1 ----------------------------------------------

def test_train_step_matches_jax_gatedaxialunet_64_batch1():
    """Its four span-32 sites (32 stripes) run the stripe core. At batch 1
    the loss itself is ill-conditioned in float32 (every train-mode BN of
    the 4x4 and 2x2 stages normalises over a handful of values): a 1e-6
    relative perturbation of the input moves the port's loss by up to 7e-4
    of its 2.94, while the stripe, flash and plain routes of the port agree
    to 3e-6. So the loss is held like every other tensor of the step: the
    tolerance plus four times its own float32 spread."""
    assert collections.Counter(
        r[0] for r in _port_train_routes("gatedaxialunet", 64, 1))["stripe"] \
        == 4
    assert check_train_step("gatedaxialunet", 64, batch=1,
                            loss_spread=True) > 100
