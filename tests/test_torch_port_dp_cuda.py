"""The kernel wrappers over no stripes, on the card.

A rank of a data-parallel step may hold no rows (global batch 1 on two
ranks), and then every attention site it runs has zero stripes. Each
wrapper returns empty outputs and zero table, affine and moment sums there
without a launch (a grid of 0 blocks is a CUDA error) and without a count.
This file imports neither JAX nor the JAX package, so it runs on the
card's machine (``python -m pytest tests/test_torch_port_dp_cuda.py
--noconftest``); every test is marked ``cuda`` and skips without a card.
"""
import pytest
import torch
import _torch_threads  # noqa: F401  (one PyTorch thread)

from medt_tpu_torch import ops
from medt_tpu_torch.ops import axial_eval, axial_lanes, axial_train, moments
from test_torch_port_cuda import core_inputs

G = 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _no_launch():
    return not any(ops.launch_counts().values())


def _zero(*ts):
    return all(not t.numel() or not bool(t.abs().sum()) for t in ts)


@pytest.mark.cuda
@pytest.mark.parametrize("core,L,gp,has_pos", [
    ("lanes", 8, 4, True), ("lanes", 16, 2, False), ("lanes", 8, 32, True),
    ("flash", 32, 4, True), ("flash", 64, 64, False), ("flash2", 128, 4, True),
    ("flash2", 96, 8, False)])
def test_lanes_family_over_no_stripes(cuda_device, core, L, gp, has_pos):
    qkv, qemb, kemb_t, vemb, aff = core_inputs(
        3, g=G, gp=gp, L=L, S=0, has_pos=has_pos, device=cuda_device)
    fwd = getattr(axial_lanes, {"lanes": "lanes_attn_fwd",
                                "flash": "flash_lanes_fwd",
                                "flash2": "flash2_lanes_fwd"}[core])
    bwd = getattr(axial_lanes, fwd.__name__.replace("_fwd", "_bwd"))
    ops.reset_launch_counts()
    out = fwd(qkv, qemb, kemb_t, vemb, aff)
    assert [tuple(t.shape) for t in out[:2]] == [(G, gp, L, 0)] * 2
    assert all(tuple(t.shape) == (G, L, 0) for t in out[2:])
    dsv = torch.zeros((G, gp, L, 0), device=cuda_device)
    saved = () if core == "lanes" else (out[2], out[3], out[0], out[1])
    dqkv, dqemb, dkemb_t, dvemb, daff = bwd(qkv, qemb, kemb_t, vemb, aff,
                                            *saved, dsv, dsv)
    assert dqkv.shape == qkv.shape and dqkv.dtype == qkv.dtype
    assert [t.shape for t in (dqemb, dkemb_t, dvemb)] == \
        [t.shape for t in (qemb, kemb_t, vemb)]
    assert daff.shape == (G, 8) and _zero(dqemb, dkemb_t, dvemb, daff)
    assert _no_launch()


@pytest.mark.cuda
@pytest.mark.parametrize("has_pos", [True, False])
def test_moments_over_no_stripes(cuda_device, has_pos):
    gp, L = 8, 16
    c = gp // 2
    qkv = torch.zeros((G, 2 * gp, L, 0), device=cuda_device)
    n = c if has_pos else 0
    r = torch.ones((n, L), device=cuda_device)
    e = torch.ones((n, n, L), device=cuda_device)
    ops.reset_launch_counts()
    sums = moments.moment_sums_fwd(qkv, r, e, r, e)
    ct = torch.ones((G, 8), device=cuda_device)
    dqkv, *dtables = moments.moment_sums_bwd(qkv, r, e, r, e, ct)
    assert sums.shape == (G, 8) and _zero(sums)
    assert dqkv.shape == qkv.shape and _zero(*dtables)
    assert [t.shape for t in dtables] == [r.shape, e.shape] * 2
    assert _no_launch()


@pytest.mark.cuda
@pytest.mark.parametrize("has_pos", [True, False])
def test_eval_and_stripe_over_no_stripes(cuda_device, has_pos):
    gp, L = 8, 32
    c = gp // 2
    rows = torch.zeros((0, G, 2 * gp, L), device=cuda_device)
    q, k, v = rows[:, :, :c], rows[:, :, c:gp], rows[:, :, gp:]
    n = L if has_pos else 0
    tables = [torch.ones((c if has_pos else 0, n, n), device=cuda_device),
              torch.ones((c if has_pos else 0, n, n), device=cuda_device),
              torch.ones((gp if has_pos else 0, n, n), device=cuda_device)]
    aff = torch.ones((G, 8), device=cuda_device)
    ops.reset_launch_counts()
    out = axial_eval.axial_eval_fwd(q, k, v, *tables, aff,
                                    torch.ones((G, 4, gp),
                                               device=cuda_device))
    assert out.shape == (0, G, gp, L)
    sv, sve = axial_train.stripe_attn_fwd(q, k, v, *tables, aff)
    assert sv.shape == sve.shape == (0, G, gp, L)
    dsv = torch.zeros((0, G, gp, L), device=cuda_device)
    dq, dk, dv, *dtabs, daff = axial_train.stripe_attn_bwd(
        q, k, v, *tables, aff, dsv, dsv)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert [t.shape for t in dtabs] == [t.shape for t in tables]
    assert daff.shape == (G, 8) and _zero(*dtabs, daff)
    assert _no_launch()
