"""The port's AxialAttention in train mode against the JAX package, on CPU.

Modes wopos, gated and full, the fused path (its lanes, flash or flash2
core and the moments core; the plain versions that CPU tensors dispatch to) and the
plain path, on weights carried by ``medt_tpu_torch.utils.weights``: the
output, the input gradient, every parameter gradient and the running
statistics after one call, per tensor at |got - want| <= 1e-5 + 1e-4 *
max|want|. JAX runs ``use_fused`` with its own admission (at these stripe
counts its XLA einsum path or its Pallas kernels in interpret mode; the
math is the same).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one PyTorch thread)

from medt_tpu.ops.axial_attention import AxialAttention as JaxAxialAttention
from medt_tpu_torch.ops.axial_attention import AxialAttention
from medt_tpu_torch.utils.weights import export_state_dict, to_state_dict
from test_torch_port_ops import GATES, _carry, random_variables
from test_torch_port_train_ops import F32, assert_close


# (mode, fused, axis, stride, span, m): spans 8 (lanes), 32 (flash) and 96,
# 128 (flash2; at m 64 JAX too runs its flash2 kernel, in interpret mode)
TRAIN_ATTN_CASES = [
    ("wopos", True, "h", 1, 8, 64), ("wopos", False, "w", 2, 8, 64),
    ("gated", True, "w", 2, 8, 64), ("gated", False, "h", 1, 8, 64),
    ("full", True, "h", 1, 32, 64), ("full", False, "w", 1, 8, 64),
    ("gated", True, "h", 1, 32, 64),
    ("gated", True, "h", 1, 128, 8), ("full", True, "w", 2, 96, 8),
    ("wopos", True, "h", 1, 128, 8), ("gated", True, "w", 1, 128, 64),
]


@pytest.mark.parametrize("mode,fused,axis,stride,span,m", TRAIN_ATTN_CASES)
def test_axial_attention_train_matches_jax(mode, fused, axis, stride, span,
                                           m):
    """Output, input gradient, every parameter gradient and the running
    statistics after one train-mode call. The similarity BN's bias
    gradient is 0 in exact arithmetic (softmax is shift-invariant), so both
    sides hold rounding noise of a sum over S*L*L terms: it is held at the
    scale of its weight gradient (the same sums)."""
    check_train_call(mode, fused, axis, stride, span, m)


def check_train_call(mode, fused, axis, stride, span, m, n=2):
    """One train-mode call of the port's AxialAttention against JAX's, as
    :func:`test_axial_attention_train_matches_jax` states; returns the
    port's module."""
    cin, out, groups = 6, 8, 2
    hw = (span, m) if axis == "h" else (m, span)
    rng = np.random.default_rng(50)
    x = rng.normal(size=(n, *hw, cin)).astype(F32)
    ct = rng.normal(size=(n, hw[0] // stride, hw[1] // stride, out)) \
        .astype(F32)
    kw = dict(in_planes=cin, out_planes=out, span=span, groups=groups,
              stride=stride, axis=axis, mode=mode, gate_init=GATES)
    jop = JaxAxialAttention(use_fused=fused, **kw)
    shapes = jax.eval_shape(
        lambda x: jop.init(jax.random.PRNGKey(0), x, train=False), x)
    variables = random_variables(shapes, seed=51)

    def loss(params, x):
        y, mut = jop.apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, x,
                           train=True, mutable=["batch_stats"])
        return jnp.sum(y * ct), (y, mut["batch_stats"])

    (_, (y, stats)), (gparams, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))

    top = AxialAttention(cin, out, span, groups=groups, stride=stride,
                         axis=axis, mode=mode, gate_init=GATES,
                         use_fused=fused, device="cpu")
    top.load_state_dict(_carry(variables, mode, GATES), strict=True)
    top.train()
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    yt = top(xt)
    (yt * torch.from_numpy(ct.transpose(0, 3, 1, 2).copy())).sum().backward()

    assert_close(yt.permute(0, 2, 3, 1), y, "output")
    assert_close(xt.grad.permute(0, 2, 3, 1), gx, "input gradient")
    grads = to_state_dict(export_state_dict(
        jax.tree_util.tree_map(np.asarray, gparams), {}))
    for name, p in top.named_parameters():
        if not p.requires_grad:  # frozen gates: constants in JAX
            assert name.split(".")[-1].startswith("f_") and p.grad is None
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
    for name, b in top.named_buffers():
        if name in running:
            assert_close(b, running[name], name)
    return top


# (mode, axis, stripes along the other axis): span 272, past flash2's 256
SPAN_272_CASES = [("wopos", "h", 2), ("gated", "w", 3)]


@pytest.mark.parametrize("mode,axis,m", SPAN_272_CASES)
def test_axial_attention_above_span_256_matches_jax(mode, axis, m):
    """At span 272 no kernel of either package applies: the port's fused
    path takes route "plain" (the module's plain attention) in both modes,
    as JAX's router sends the site to XLA attention. Eval mode: the output
    at 1e-5 + 1e-4 * max|want|; train mode: one forward and backward held
    as :func:`test_axial_attention_train_matches_jax` holds its cases
    (output, input and parameter gradients, running statistics)."""
    span, n, cin, out, groups = 272, 1, 6, 8, 2
    top = check_train_call(mode, True, axis, 1, span, m, n=n)
    assert top.last_route[0] == "plain"
    hw = (span, m) if axis == "h" else (m, span)
    x = np.random.default_rng(52).normal(size=(n, *hw, cin)).astype(F32)
    kw = dict(in_planes=cin, out_planes=out, span=span, groups=groups,
              axis=axis, mode=mode, gate_init=GATES)
    jop = JaxAxialAttention(use_fused=True, **kw)
    shapes = jax.eval_shape(
        lambda x: jop.init(jax.random.PRNGKey(0), x, train=False), x)
    variables = random_variables(shapes, seed=53)
    want = jop.apply(variables, jnp.asarray(x), train=False)
    top = AxialAttention(cin, out, span, groups=groups, axis=axis, mode=mode,
                         gate_init=GATES, use_fused=True, device="cpu")
    top.load_state_dict(_carry(variables, mode, GATES), strict=True)
    top.eval()
    with torch.no_grad():
        got = top(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert top.last_route[0] == "plain"
    assert_close(got.permute(0, 2, 3, 1), want, "eval output")
