"""The port's flash2 core (spans 65..256) against the JAX package, on CPU.

Inputs are made with numpy from a seed, at the sizes of JAX's own non-slow
flash2 test (tests/test_pallas.py: span 128, g 2, gp 4, 128 stripes), with
and without positions, and at span 96 (gp 2). JAX runs
``flash2_lanes_core`` in interpret mode, as its tests do on the CPU; the
port runs its plain versions, which its autograd Function sends CPU
tensors to. Float32 on both sides, another summation order:

* forward: sv and sve at atol 1e-5; the row max m and denominator l at
  atol 1e-5 plus rtol 1e-5 (l sums up to 256 exps);
* backward: dqkv, dqemb, dkemb_t, dvemb and daff through the port's
  autograd against ``jax.vjp``, per tensor at 1e-5 + 1e-4 * max|want|;
* the explicit plain backward against autograd of the plain forward, in
  float64 (atol 1e-10: one function differentiated two ways).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one PyTorch thread)

from medt_tpu.ops import pallas_axial_lanes as jlanes
from medt_tpu_torch.ops import axial_lanes
from test_torch_port_ops import core_inputs
from test_torch_port_train_ops import F32, assert_close

# (span, gp, stripes, has_pos)
FLASH2_CASES = [(128, 4, 128, True), (128, 4, 128, False), (96, 2, 128, True)]


def _inputs(L, gp, S, has_pos):
    return core_inputs(40 + L + gp, g=2, gp=gp, L=L, S=S, has_pos=has_pos)


@pytest.mark.parametrize("L,gp,S,has_pos", FLASH2_CASES)
def test_flash2_plain_forward_matches_pallas(L, gp, S, has_pos):
    args = _inputs(L, gp, S, has_pos)
    assert jlanes.flash2_supported(L, 2, gp, S)
    want = jlanes._flash2_fwd(*map(jnp.asarray, args))
    got = axial_lanes.flash2_lanes_plain(
        *(torch.from_numpy(np.array(a)) for a in args))
    for name, o, w in zip(("sv", "sve", "m", "l"), got, want):
        w = np.asarray(w)
        if name == "sve" and not has_pos:  # both zero
            np.testing.assert_array_equal(o.numpy(), w)
            continue
        rtol = 1e-5 if name in ("m", "l") else 0.0
        np.testing.assert_allclose(o.numpy(), w, atol=1e-5, rtol=rtol,
                                   err_msg=name)


@pytest.mark.parametrize("L,gp,S,has_pos", FLASH2_CASES)
def test_flash2_core_backward_matches_pallas_vjp(L, gp, S, has_pos):
    """All five gradients of the port's ``flash2_lanes_core`` (its plain
    versions, through its autograd Function) vs the Pallas backward."""
    args = _inputs(L, gp, S, has_pos)
    rng = np.random.default_rng(L * gp)
    dsv = rng.normal(size=(2, gp, L, S)).astype(F32)
    dsve = rng.normal(size=(2, gp, L, S)).astype(F32)
    out, vjp = jax.vjp(jlanes.flash2_lanes_core, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(dsv), jnp.asarray(dsve)))

    leaves = [torch.from_numpy(np.array(a)).requires_grad_(a.size > 0)
              for a in args]
    sv, sve = axial_lanes.flash2_lanes_core(*leaves)
    assert_close(sv, out[0], "sv")
    loss = (sv * torch.from_numpy(dsv)).sum()
    if has_pos:
        assert_close(sve, out[1], "sve")
        loss = loss + (sve * torch.from_numpy(dsve)).sum()
    loss.backward()
    for name, leaf, w in zip(("dqkv", "dqemb", "dkemb_t", "dvemb", "daff"),
                             leaves, want):
        if leaf.numel():
            assert_close(leaf.grad, w, name)
        else:
            assert leaf.grad is None and np.asarray(w).size == 0, name


@pytest.mark.parametrize("has_pos", [True, False])
def test_flash2_explicit_backward_matches_autograd_f64(has_pos):
    """What the backward kernel computes (the explicit plain backward from
    the saved m, l, sv, sve) vs autograd through the plain forward."""
    L, gp, S = 80, 4, 24
    args = [torch.from_numpy(np.array(a, np.float64)) for a in
            core_inputs(45, g=2, gp=gp, L=L, S=S, has_pos=has_pos)]
    leaves = [a.clone().requires_grad_(a.numel() > 0) for a in args]
    rng = np.random.default_rng(46)
    dsv, dsve = (torch.from_numpy(rng.normal(size=(2, gp, L, S)))
                 for _ in range(2))
    sv, sve, m, l = axial_lanes.flash2_lanes_plain(*leaves)
    got = axial_lanes.flash2_lanes_bwd_plain(
        *args, m.detach(), l.detach(), sv.detach(), sve.detach(), dsv, dsve)
    loss = (sv * dsv).sum() + ((sve * dsve).sum() if has_pos else 0)
    loss.backward()
    for leaf, g in zip(leaves, got):
        if leaf.numel():
            torch.testing.assert_close(g, leaf.grad, atol=1e-10, rtol=1e-10)
        else:
            assert g.numel() == 0
