"""The port's train-mode ops against the JAX package, on CPU.

Inputs are made with numpy from a seed. What is held, per tensor at
|got - want| <= 1e-5 + 1e-4 * max|want| (float32 on both sides, another
summation order):

* the plain backward versions of the lanes and flash cores, through the
  port's autograd, against ``jax.vjp`` of the Pallas functions (interpret
  mode on CPU, as the JAX tests run them), with and without positions;
* the moments core, forward and backward, against ``jax.vjp`` of
  ``moment_sums_core``;
* each explicit plain backward against ``torch.autograd`` of its plain
  forward in float64 (atol 1e-10: the same function, differentiated two
  ways);
* train-mode BN against ``batch_norm_train``.

``AxialAttention`` in train mode is held in
tests/test_torch_port_train_attention.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one PyTorch thread)

from medt_tpu.ops import norms as jnorms
from medt_tpu.ops import pallas_axial_train as jtrain
from medt_tpu.ops.pallas_axial_lanes import flash_lanes_core as jax_flash
from medt_tpu.ops.pallas_axial_lanes import lanes_attn_core as jax_lanes
from medt_tpu.ops.pallas_moments import moment_sums_core as jax_moments
from medt_tpu_torch.ops import axial_lanes, moments
from medt_tpu_torch.ops.norms import BatchNorm, batch_norm_train
from test_torch_port_ops import core_inputs

F32 = np.float32


def assert_close(got, want, name=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    tol = 1e-5 + 1e-4 * (float(np.abs(want).max()) if want.size else 0.0)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=name)


def _leaves(arrays, grad=True):
    return [torch.from_numpy(np.array(a)).requires_grad_(grad and a.size > 0)
            for a in arrays]


# ---- attention cores: backward against jax.vjp --------------------------------

CORE_CASES = [
    ("lanes", 4, 8, True), ("lanes", 8, 4, False), ("lanes", 16, 2, True),
    ("lanes", 16, 4, False), ("flash", 32, 4, True), ("flash", 32, 2, False),
    ("flash", 64, 2, True), ("flash", 64, 4, False),
]


@pytest.mark.parametrize("kernel,L,gp,has_pos", CORE_CASES)
def test_core_backward_matches_pallas_vjp(kernel, L, gp, has_pos):
    """All five gradients of the lanes/flash cores (the plain versions the
    port's autograd runs on CPU) vs the Pallas backward."""
    S = 128 if L > 16 else 256
    args = core_inputs(20 + L, g=2, gp=gp, L=L, S=S, has_pos=has_pos)
    rng = np.random.default_rng(L + gp)
    dsv = rng.normal(size=(2, gp, L, S)).astype(F32)
    dsve = rng.normal(size=(2, gp, L, S)).astype(F32)
    jcore = jax_lanes if kernel == "lanes" else jax_flash
    out, vjp = jax.vjp(jcore, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(dsv), jnp.asarray(dsve)))

    leaves = _leaves(args)
    core = (axial_lanes.lanes_attn_core if kernel == "lanes"
            else axial_lanes.flash_lanes_core)
    sv, sve = core(*leaves)
    assert_close(sv, out[0], "sv")
    loss = (sv * torch.from_numpy(dsv)).sum()
    if has_pos:
        assert_close(sve, out[1], "sve")
        loss = loss + (sve * torch.from_numpy(dsve)).sum()
    loss.backward()
    names = ("dqkv", "dqemb", "dkemb_t", "dvemb", "daff")
    for name, leaf, w in zip(names, leaves, want):
        if leaf.numel():
            assert_close(leaf.grad, w, name)
        else:
            assert leaf.grad is None and np.asarray(w).size == 0, name


def _f64(args):
    return [torch.from_numpy(np.array(a, np.float64)) for a in args]


@pytest.mark.parametrize("kernel,has_pos", [
    ("lanes", True), ("lanes", False), ("flash", True), ("flash", False)])
def test_explicit_core_backward_matches_autograd_f64(kernel, has_pos):
    """The explicit plain backward (what the kernel computes) vs autograd
    through the plain forward, in float64."""
    L = 8 if kernel == "lanes" else 24
    args = _f64(core_inputs(30, g=2, gp=4, L=L, S=40, has_pos=has_pos))
    leaves = [a.clone().requires_grad_(a.numel() > 0) for a in args]
    rng = np.random.default_rng(31)
    dsv, dsve = (torch.from_numpy(rng.normal(size=(2, 4, L, 40)))
                 for _ in range(2))
    if kernel == "lanes":
        sv, sve = axial_lanes.lanes_attn_plain(*leaves)
        got = axial_lanes.lanes_attn_bwd_plain(*args, dsv, dsve)
    else:
        sv, sve, m, l = axial_lanes.flash_lanes_plain(*leaves)
        got = axial_lanes.flash_lanes_bwd_plain(
            *args, m.detach(), l.detach(), sv.detach(), sve.detach(), dsv,
            dsve)
    loss = (sv * dsv).sum() + ((sve * dsve).sum() if has_pos else 0)
    loss.backward()
    for leaf, g in zip(leaves, got):
        if leaf.numel():
            torch.testing.assert_close(g, leaf.grad, atol=1e-10, rtol=1e-10)
        else:
            assert g.numel() == 0


# ---- moments ----------------------------------------------------------------

def moment_inputs(seed, g, gp, L, S, has_pos):
    rng = np.random.default_rng(seed)
    c = gp // 2
    qkv = rng.normal(size=(g, 2 * gp, L, S)).astype(F32)
    if not has_pos:
        zr, ze = np.zeros((0, L), F32), np.zeros((0, 0, L), F32)
        return [qkv, zr, ze, zr, ze]
    qemb, kemb = (rng.normal(size=(c, L, L)).astype(F32) for _ in range(2))
    return [qkv, qemb.sum(2), np.einsum("cij,dij->cdi", qemb, qemb),
            kemb.sum(2), np.einsum("cji,dji->cdj", kemb, kemb)]


@pytest.mark.parametrize("gp,L,has_pos", [
    (4, 8, True), (2, 32, True), (8, 4, False), (16, 4, False)])
def test_moment_sums_match_pallas_vjp(gp, L, has_pos):
    ins = moment_inputs(40 + gp, g=2, gp=gp, L=L, S=128, has_pos=has_pos)
    out, vjp = jax.vjp(jax_moments, *map(jnp.asarray, ins))
    ct = np.random.default_rng(41).normal(size=(2, 8)).astype(F32)
    want = vjp(jnp.asarray(ct))
    leaves = _leaves(ins)
    sums = moments.moment_sums(*leaves)
    assert_close(sums, out, "sums")
    (sums * torch.from_numpy(ct)).sum().backward()
    for name, leaf, w in zip(("dqkv", "dr_q", "de_q", "dr_k", "de_k"),
                             leaves, want):
        if leaf.numel():
            assert_close(leaf.grad, w, name)
        else:
            assert leaf.grad is None, name


@pytest.mark.parametrize("has_pos", [True, False])
def test_explicit_moments_backward_matches_autograd_f64(has_pos):
    ins = _f64(moment_inputs(42, g=2, gp=4, L=6, S=20, has_pos=has_pos))
    leaves = [a.clone().requires_grad_(a.numel() > 0) for a in ins]
    ct = torch.from_numpy(np.random.default_rng(43).normal(size=(2, 8)))
    (moments.moment_sums_plain(*leaves) * ct).sum().backward()
    got = moments.moment_sums_bwd_plain(*ins, ct)
    for leaf, g in zip(leaves, got):
        if leaf.numel():
            torch.testing.assert_close(g, leaf.grad, atol=1e-10, rtol=1e-10)


def test_factorised_moments_match_jax():
    """logit/qk moments, lanes-layout (through the sums core) and
    stripe-major, vs the JAX functions; mean and biased variance (3, g),
    and the count."""
    rng = np.random.default_rng(44)
    g, gp, L, S = 2, 4, 8, 128
    c = gp // 2
    qkv = rng.normal(size=(g, 2 * gp, L, S)).astype(F32)
    qemb, kemb = (rng.normal(size=(c, L, L)).astype(F32) for _ in range(2))
    from medt_tpu.ops import pallas_moments as jm
    jq = jnp.asarray(qkv)
    want = jm.logit_moments_lanes_fused(jq, jnp.asarray(qemb),
                                        jnp.asarray(kemb))
    got = moments.logit_moments_lanes_fused(*map(torch.from_numpy,
                                                 (qkv, qemb, kemb)))
    for w, o in zip(want[:2], got[:2]):
        assert_close(o, w)
    assert got[2] == want[2] == S * L * L
    want = jm.qk_moments_lanes_fused(jq)
    got = moments.qk_moments_lanes_fused(torch.from_numpy(qkv))
    for w, o in zip(want[:2], got[:2]):
        assert_close(o, w)

    stripes = qkv.transpose(3, 0, 1, 2)                   # (S, g, 2gp, L)
    q, k = stripes[:, :, :c], stripes[:, :, c:gp]
    want = jtrain.logit_moments(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(qemb), jnp.asarray(kemb))
    got = moments.logit_moments(*map(torch.from_numpy,
                                     (q.copy(), k.copy(), qemb, kemb)))
    for w, o in zip(want[:2], got[:2]):
        assert_close(o, w)
    want = jtrain.qk_moments(jnp.asarray(q), jnp.asarray(k))
    got = moments.qk_moments(torch.from_numpy(q.copy()),
                             torch.from_numpy(k.copy()))
    for w, o in zip(want[:2], got[:2]):
        assert_close(o, w)


# ---- train-mode BN --------------------------------------------------------------

@pytest.mark.parametrize("feature_axes,fshape", [
    ((1,), (6,)), ((1, 2), (3, 4)), ((1, 2, 5), (2, 3, 2)),
])
def test_batch_norm_train_matches_jax(feature_axes, fshape):
    """Output, batch mean and unbiased variance; the module's running
    statistics after one step (momentum 0.1)."""
    rng = np.random.default_rng(45)
    shape = [3, 1, 1, 5, 4, 1]
    for a, n in zip(feature_axes, fshape):
        shape[a] = n
    shape = [s if s > 1 or i in feature_axes else 2
             for i, s in enumerate(shape)]
    x = (2.0 + rng.normal(size=shape)).astype(F32)
    scale, bias = (rng.normal(size=fshape).astype(F32) for _ in range(2))
    want = jnorms.batch_norm_train(jnp.asarray(x), jnp.asarray(scale),
                                   jnp.asarray(bias), feature_axes)
    got = batch_norm_train(torch.from_numpy(x),
                           torch.from_numpy(scale.reshape(-1)),
                           torch.from_numpy(bias.reshape(-1)), feature_axes)
    for name, w, o in zip(("y", "mean", "var"), want, got):
        assert_close(o, w, name)

    bn = BatchNorm(int(np.prod(fshape)), device="cpu").train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale.reshape(-1)))
        bn.bias.copy_(torch.from_numpy(bias.reshape(-1)))
        bn.running_var.fill_(0.5)
        y = bn(torch.from_numpy(x), feature_axes)
    assert_close(y, want[0], "module y")
    assert_close(bn.running_mean, 0.1 * np.asarray(want[1]).reshape(-1))
    assert_close(bn.running_var,
                 0.45 + 0.1 * np.asarray(want[2]).reshape(-1))
