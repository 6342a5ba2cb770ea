"""The port's ops against the JAX package, on CPU.

Same inputs, made with numpy from a seed, go through the JAX function and
its port: the forward lanes-attention cores (JAX: the Pallas kernels in
interpret mode, as the JAX tests run them on CPU; port: the plain PyTorch
versions that CPU tensors dispatch to), the attention-core glue, eval BN,
pooling, and AxialAttention's fused and plain eval paths on weights carried
across by ``medt_tpu_torch.utils.weights``. Tolerance 1e-5 absolute: both
sides compute in float32 and differ only in summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one PyTorch thread)

from medt_tpu.ops import norms as jnorms
from medt_tpu.ops import pooling as jpool
from medt_tpu.ops.axial_attention import AxialAttention as JaxAxialAttention
from medt_tpu.ops.pallas_axial_lanes import _flash_fwd as jax_flash_fwd
from medt_tpu.ops.pallas_axial_lanes import lanes_attn_core as jax_lanes_core
from medt_tpu.ops.pallas_axial_train import attn_core_xla
from medt_tpu.ops.pallas_axial_train import pack_sim_affine as jax_pack
from medt_tpu_torch.ops import attn_core, axial_lanes
from medt_tpu_torch.ops.axial_attention import (AxialAttention,
                                                 lanes_family_core)
from medt_tpu_torch.ops.norms import BatchNorm, batch_norm_eval
from medt_tpu_torch.ops.pooling import avg_pool, upsample_bilinear_2x
from medt_tpu_torch.utils.weights import export_state_dict, to_state_dict

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def core_inputs(seed, g, gp, L, S, has_pos):
    """Numpy inputs of a lanes-family core: qkv, qemb, kemb_t, vemb, aff."""
    rng = np.random.default_rng(seed)
    c = gp // 2
    f = np.float32
    qkv = rng.normal(size=(g, 2 * gp, L, S)).astype(f)
    if has_pos:
        qemb = rng.normal(size=(c, L, L)).astype(f)
        kemb_t = rng.normal(size=(c, L, L)).astype(f)
        vemb = rng.normal(size=(gp, L, L)).astype(f)
        a = np.abs(rng.normal(size=(3, g))).astype(f) * 0.5
        b = rng.normal(size=(3, g)).astype(f) * 0.1
        aff = np.asarray(jax_pack(g, jnp.asarray(a), jnp.asarray(b), "full"))
    else:
        qemb = kemb_t = vemb = np.zeros((0, L, L), f)
        a = np.abs(rng.normal(size=(g,))).astype(f) * 0.5
        b = rng.normal(size=(g,)).astype(f) * 0.1
        aff = np.asarray(jax_pack(g, jnp.asarray(a), jnp.asarray(b), "wopos"))
    return qkv, qemb, kemb_t, vemb, aff


# ---- forward lanes-attention cores ---------------------------------------

@pytest.mark.parametrize("has_pos", [True, False])
def test_lanes_core_matches_pallas(has_pos):
    args = core_inputs(0, g=2, gp=4, L=8, S=128, has_pos=has_pos)
    want = jax_lanes_core(*map(jnp.asarray, args))
    got = axial_lanes.lanes_attn_core(*map(_t, args))
    for w, o in zip(want, got):
        assert o.shape == (2, 4, 8, 128)
        np.testing.assert_allclose(_np(o), np.asarray(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("has_pos", [True, False])
def test_flash_core_matches_pallas(has_pos):
    """sv, sve and the saved (m, l) of the key-streamed forward."""
    args = core_inputs(1, g=2, gp=4, L=32, S=128, has_pos=has_pos)
    want = jax_flash_fwd(*map(jnp.asarray, args))
    got = axial_lanes.flash_lanes_plain(*map(_t, args))
    for w, o in zip(want, got):
        np.testing.assert_allclose(_np(o), np.asarray(w), atol=ATOL,
                                   rtol=1e-6)
    sv, sve = axial_lanes.flash_lanes_core(*map(_t, args))
    np.testing.assert_array_equal(_np(sv), _np(got[0]))
    np.testing.assert_array_equal(_np(sve), _np(got[1]))


def test_attn_core_plain_matches_xla():
    """The stripe-major plain core and the affine glue vs JAX."""
    rng = np.random.default_rng(2)
    S, g, c, gp, L = 6, 2, 2, 4, 8
    f = np.float32
    q, k = (rng.normal(size=(S, g, c, L)).astype(f) for _ in range(2))
    v = rng.normal(size=(S, g, gp, L)).astype(f)
    qemb, kemb = (rng.normal(size=(c, L, L)).astype(f) for _ in range(2))
    vemb = rng.normal(size=(gp, L, L)).astype(f)
    scale, bias, mean = (rng.normal(size=(3, g)).astype(f) for _ in range(3))
    var = rng.uniform(0.5, 1.5, size=(3, g)).astype(f)

    from medt_tpu.ops.pallas_axial_train import fold_train_affine
    ja, jb = fold_train_affine(*map(jnp.asarray, (scale, bias, mean, var)))
    ta, tb = attn_core.fold_train_affine(*map(_t, (scale, bias, mean, var)))
    np.testing.assert_allclose(_np(ta), np.asarray(ja), atol=1e-6)
    np.testing.assert_allclose(_np(tb), np.asarray(jb), atol=1e-6)
    for mode, sl in (("gated", slice(None)), ("wopos", 0)):
        want = jax_pack(g, jnp.asarray(_np(ta)[sl]), jnp.asarray(_np(tb)[sl]),
                        mode)
        got = attn_core.pack_sim_affine(g, ta[sl], tb[sl], mode)
        np.testing.assert_array_equal(_np(got), np.asarray(want))

    aff = attn_core.pack_sim_affine(g, ta, tb, "gated")
    for has_pos in (True, False):
        want = attn_core_xla(*map(jnp.asarray, (q, k, v, qemb, kemb, vemb)),
                             jnp.asarray(_np(aff)), has_pos=has_pos)
        got = attn_core.attn_core_plain(*map(_t, (q, k, v, qemb, kemb, vemb)),
                                        aff, has_pos=has_pos)
        for w, o in zip(want, got):
            np.testing.assert_allclose(_np(o), np.asarray(w), atol=ATOL)


# ---- norms and pooling -----------------------------------------------------

@pytest.mark.parametrize("feature_axes,fshape", [
    ((1,), (6,)), ((1, 2), (3, 4)), ((1, 2, 5), (2, 3, 2)),
])
def test_batch_norm_eval_matches_jax(feature_axes, fshape):
    rng = np.random.default_rng(3)
    shape = [2, 1, 1, 5, 4, 1]
    for a, n in zip(feature_axes, fshape):
        shape[a] = n
    shape = [s if s > 1 or i in feature_axes else 2
             for i, s in enumerate(shape)]
    x = rng.normal(size=shape).astype(np.float32)
    scale, bias, mean = (rng.normal(size=fshape).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.5, 1.5, size=fshape).astype(np.float32)
    want = jnorms.batch_norm_eval(*map(jnp.asarray,
                                       (x, scale, bias, mean, var)),
                                  feature_axes)
    got = batch_norm_eval(*map(_t, (x, scale.reshape(-1), bias.reshape(-1),
                                    mean.reshape(-1), var.reshape(-1))),
                          feature_axes)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_batch_norm_module_raises_in_train_mode():
    """Train mode runs (tests/test_torch_port_train_ops.py holds it); like
    torch's BatchNorm it raises on one value per channel, where the
    unbiased running variance is undefined."""
    bn = BatchNorm(4, device="cpu")
    assert bn(torch.zeros(2, 4, 3, 3)).shape == (2, 4, 3, 3)
    with pytest.raises(ValueError, match="more than 1 value per channel"):
        bn(torch.zeros(1, 4, 1, 1))


def test_pooling_matches_jax():
    x = np.random.default_rng(4).normal(size=(2, 6, 8, 3)).astype(np.float32)
    xt = _t(x.transpose(0, 3, 1, 2))
    np.testing.assert_allclose(
        _np(avg_pool(xt, 2)).transpose(0, 2, 3, 1),
        np.asarray(jpool.avg_pool_2x(jnp.asarray(x), 2)), atol=1e-6)
    np.testing.assert_allclose(
        _np(upsample_bilinear_2x(xt)).transpose(0, 2, 3, 1),
        np.asarray(jpool.upsample_bilinear_2x(jnp.asarray(x))), atol=1e-6)


# ---- AxialAttention eval: fused and plain paths -----------------------------

def random_variables(shapes, seed):
    """Random values for a JAX variable tree of ShapeDtypeStructs: weights
    on the reference's init scale, BN statistics away from (0, 1) so any
    folding error shows."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = s.shape
        if name.endswith("var"):
            return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
        if name.endswith("scale"):
            return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
        if name.endswith(("bias", "mean")):
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        if name.startswith("f_"):
            return np.float32(rng.uniform(0.2, 1.0))
        fan = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        return (rng.normal(size=shape) / np.sqrt(fan)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _carry(variables, mode=None, gate_init=None):
    sd = export_state_dict(variables["params"], variables["batch_stats"])
    if mode == "gated" and "f_qr" not in sd:  # frozen gates: constants
        for name, val in zip(("f_qr", "f_kr", "f_sve", "f_sv"), gate_init):
            sd[name] = np.asarray(val, np.float32)
    return to_state_dict(sd)


GATES = (0.1, 0.2, 0.3, 0.7)
# (mode, trainable gates, axis, stride, span, stripes along the other axis)
ATTN_CASES = [
    (mode, trainable, axis, stride, 8, 64)
    for mode, trainable in (("full", False), ("gated", False),
                            ("gated", True), ("wopos", False))
    for axis, stride in (("h", 1), ("w", 2))
] + [("gated", False, "h", 1, 32, 128), ("wopos", False, "w", 2, 32, 128)]


@pytest.mark.parametrize("mode,trainable,axis,stride,span,m", ATTN_CASES)
def test_axial_attention_eval_matches_jax(mode, trainable, axis, stride,
                                          span, m):
    """Fused and plain eval paths of the port vs JAX use_fused=True/False.
    With n*m >= 128 stripes JAX's fused path runs its lanes (span 8) or
    flash (span 32) Pallas kernel in interpret mode."""
    n, cin, out, groups = 1 if span == 32 else 2, 6, 8, 2
    hw = (span, m) if axis == "h" else (m, span)
    x = np.random.default_rng(5).normal(
        size=(n, *hw, cin)).astype(np.float32)
    kw = dict(in_planes=cin, out_planes=out, span=span, groups=groups,
              stride=stride, axis=axis, mode=mode, gate_init=GATES,
              trainable_gates=trainable)
    op = JaxAxialAttention(use_fused=False, **kw)
    shapes = jax.eval_shape(
        lambda x: op.init(jax.random.PRNGKey(0), x, train=False), x)
    variables = random_variables(shapes, seed=6)
    sd = _carry(variables, mode, GATES)
    xt = _t(x.transpose(0, 3, 1, 2))
    for fused in (True, False):
        jop = JaxAxialAttention(use_fused=fused, **kw)
        want = jax.jit(lambda v, x: jop.apply(v, x, train=False))(
            variables, jnp.asarray(x))
        top = AxialAttention(cin, out, span, groups=groups, stride=stride,
                             axis=axis, mode=mode, gate_init=GATES,
                             trainable_gates=trainable, use_fused=fused,
                             device="cpu").eval()
        top.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got = top(xt)
        np.testing.assert_allclose(_np(got).transpose(0, 2, 3, 1),
                                   np.asarray(want), atol=ATOL, rtol=0,
                                   err_msg=f"use_fused={fused}")


@pytest.mark.parametrize("mode", ["gated_sig", "gated_data"])
def test_axial_attention_plain_zoo_modes_match_jax(mode):
    """The two zoo modes that only the plain path runs."""
    x = np.random.default_rng(7).normal(size=(2, 8, 8, 6)).astype(np.float32)
    kw = dict(in_planes=6, out_planes=8, span=8, groups=2, axis="w",
              mode=mode, gate_init=GATES, trainable_gates=True)
    op = JaxAxialAttention(use_fused=False, **kw)
    shapes = jax.eval_shape(
        lambda x: op.init(jax.random.PRNGKey(0), x, train=False), x)
    variables = random_variables(shapes, seed=8)
    want = op.apply(variables, jnp.asarray(x), train=False)
    top = AxialAttention(6, 8, 8, groups=2, axis="w", mode=mode,
                         gate_init=GATES, trainable_gates=True,
                         device="cpu").eval()
    top.load_state_dict(_carry(variables), strict=True)
    with torch.no_grad():
        got = top(_t(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(_np(got).transpose(0, 2, 3, 1),
                               np.asarray(want), atol=ATOL, rtol=0)


def test_fused_path_raises_past_span_64():
    """Past span 64 the fused path runs the flash2 core, up to span 256;
    past 256 it runs the module's plain attention (route "plain"), in
    both modes, and gives what the plain path gives; only the core itself,
    which the route no longer reaches there, raises."""
    top = AxialAttention(4, 8, 96, groups=2, mode="wopos", use_fused=True,
                         device="cpu").eval()
    with torch.no_grad():
        out = top(torch.zeros(1, 4, 96, 2))
    assert out.shape == (1, 8, 96, 2) and top.last_route[0] == "flash2"
    x = torch.from_numpy(np.random.default_rng(30).normal(
        size=(1, 4, 272, 2)).astype(np.float32))
    top = AxialAttention(4, 8, 272, groups=2, mode="wopos", use_fused=True,
                         device="cpu")
    plain = AxialAttention(4, 8, 272, groups=2, mode="wopos",
                           use_fused=False, device="cpu")
    plain.load_state_dict(top.state_dict())
    for train in (False, True):
        top.train(train)
        plain.train(train)
        with torch.no_grad():
            out = top(x)
            want = plain(x)
        assert out.shape == (1, 8, 272, 2) and top.last_route[0] == "plain"
        torch.testing.assert_close(out, want, atol=0, rtol=0)
    empty = torch.zeros((0, 272, 272))
    with pytest.raises(NotImplementedError, match="256"):
        lanes_family_core(torch.zeros(2, 8, 272, 2), empty, empty, empty,
                          torch.zeros(2, 8))
