"""bf16 activations of the port against the JAX package, on CPU.

* Kernel rows 1-8 in bf16: the plain versions of the lanes, flash and
  flash2 cores and of the moments core (what the port runs on CPU tensors;
  on the card their bf16 entry points compute the same function), forward
  and backward, against ``jax.vjp`` of the Pallas functions in interpret
  mode on bf16 qkv, at ``tests/test_bf16_kernels.py``'s shapes. What is
  held: the port's bf16 forward equals its float32 forward on the upcast
  qkv (rtol = atol = 1e-6, that test's forward tolerance) and JAX's bf16
  forward at the port's float32 parity rule (1e-5 + 1e-4 * max|want|:
  float32 arithmetic on both sides, another summation order); dqkv is bf16
  on both sides, within rtol 1e-2 (atol 1e-6; that test's gradient
  tolerance, about two bf16 roundings) of JAX's bf16 dqkv and of the
  port's float32 gradient; the table and daff gradients at the parity
  rule.
* A bf16 train step (SGD) of axialunet 32 px and of MedT 32 px (patch grid
  1), batch 2, from the same carried weights as JAX's bf16 model on its
  fused path (the train-mode forward of JAX's ``train_step``, compiled
  alone: its backward's compile would take most of a minute on this
  CPU): the loss and the train-mode logits satisfy |port_bf16 - jax_bf16|
  <= 2 |jax_bf16 - jax_f32| + 1e-3, each side its mean over eight inputs
  (bf16 rounds at other places in the two frameworks, so the gap is held
  against bf16's own effect; see the test for why one input is not
  enough); the port's step loss is its forward's, and its parameters and
  running statistics stay float32.
The compute dtype's plumbing (every registry name, the engine, the config
and the trainer) is in tests/test_torch_port_bf16_models.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one PyTorch thread)

from medt_tpu.models import build_model as jax_build_model
from medt_tpu.ops.pallas_axial_lanes import flash2_lanes_core as jax_flash2
from medt_tpu.ops.pallas_axial_lanes import flash_lanes_core as jax_flash
from medt_tpu.ops.pallas_axial_lanes import lanes_attn_core as jax_lanes
from medt_tpu.ops.pallas_moments import moment_sums_core as jax_moments
from medt_tpu.parallel import kernel_mesh_scope, set_kernel_mesh
from medt_tpu_torch.data import blob_batch
from medt_tpu_torch.losses import log_nll_loss
from medt_tpu_torch.models import build_model
from medt_tpu_torch.ops import axial_lanes, moments
from medt_tpu_torch.training import TrainState, sgd, train_step
from test_torch_port_models import carried, jax_variables
from test_torch_port_ops import core_inputs
from test_torch_port_train_ops import assert_close, moment_inputs

F32 = np.float32
BF16 = torch.bfloat16


def _bf16_qkv(qkv):
    """The same bf16 qkv for both packages: (jax array, torch tensor)."""
    j = jnp.asarray(qkv).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(BF16)


def _grad_close(got, want, name):
    """bf16 gradients: rtol 1e-2, atol 1e-6 (tests/test_bf16_kernels.py)."""
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, F32), rtol=1e-2, atol=1e-6,
                               err_msg=name)


CORES = {"lanes": (jax_lanes, axial_lanes.lanes_attn_core),
         "flash": (jax_flash, axial_lanes.flash_lanes_core),
         "flash2": (jax_flash2, axial_lanes.flash2_lanes_core)}


@pytest.mark.parametrize("kernel,g,gp,L,S,has_pos", [
    ("lanes", 2, 4, 8, 256, True), ("lanes", 2, 4, 8, 256, False),
    ("flash", 2, 4, 32, 256, True), ("flash2", 1, 4, 128, 128, True)])
def test_core_bf16_matches_pallas(kernel, g, gp, L, S, has_pos):
    """Rows 1-6: a lanes-family core on bf16 qkv, forward and backward."""
    jcore, core = CORES[kernel]
    qkv, *rest = core_inputs(50 + L, g=g, gp=gp, L=L, S=S, has_pos=has_pos)
    rng = np.random.default_rng(51 + L)
    dsv = rng.normal(size=(g, gp, L, S)).astype(F32)
    dsve = rng.normal(size=(g, gp, L, S)).astype(F32)
    jq, tq = _bf16_qkv(qkv)
    out, vjp = jax.vjp(jcore, jq, *map(jnp.asarray, rest))
    want = vjp((jnp.asarray(dsv), jnp.asarray(dsve)))
    assert want[0].dtype == jnp.bfloat16

    def port(q):
        leaves = [q.clone().requires_grad_(True)] + [
            torch.from_numpy(np.array(a)).requires_grad_(a.size > 0)
            for a in rest]
        sv, sve = core(*leaves)
        loss = (sv * torch.from_numpy(dsv)).sum()
        if has_pos:
            loss = loss + (sve * torch.from_numpy(dsve)).sum()
        loss.backward()
        return sv, sve, leaves

    sv, sve, leaves = port(tq)
    sv32, sve32, leaves32 = port(tq.float())
    assert sv.dtype == torch.float32 and leaves[0].grad.dtype == BF16
    for got, got32, w, name in ((sv, sv32, out[0], "sv"),
                                (sve, sve32, out[1], "sve")):
        if name == "sve" and not has_pos:
            continue
        torch.testing.assert_close(got, got32, rtol=1e-6, atol=1e-6)
        assert_close(got, w, name)
    _grad_close(leaves[0].grad, want[0], "dqkv vs JAX")
    _grad_close(leaves[0].grad, leaves32[0].grad, "dqkv vs float32")
    for name, leaf, w in zip(("dqemb", "dkemb_t", "dvemb", "daff"),
                             leaves[1:], want[1:]):
        if leaf.numel():
            assert_close(leaf.grad, w, name)


@pytest.mark.parametrize("has_pos", [True, False])
def test_moments_bf16_matches_pallas(has_pos):
    """Rows 7-8: the moments core on bf16 qkv, forward and backward."""
    qkv, *tables = moment_inputs(60, g=2, gp=4, L=8, S=256, has_pos=has_pos)
    jq, tq = _bf16_qkv(qkv)
    out, vjp = jax.vjp(jax_moments, jq, *map(jnp.asarray, tables))
    ct = np.random.default_rng(61).normal(size=(2, 8)).astype(F32)
    want = vjp(jnp.asarray(ct))
    assert want[0].dtype == jnp.bfloat16

    def port(q):
        leaves = [q.clone().requires_grad_(True)] + [
            torch.from_numpy(np.array(a)).requires_grad_(a.size > 0)
            for a in tables]
        sums = moments.moment_sums(*leaves)
        (sums * torch.from_numpy(ct)).sum().backward()
        return sums, leaves

    sums, leaves = port(tq)
    sums32, leaves32 = port(tq.float())
    assert sums.dtype == torch.float32 and leaves[0].grad.dtype == BF16
    torch.testing.assert_close(sums, sums32, rtol=1e-6, atol=1e-6)
    assert_close(sums, out, "sums")
    _grad_close(leaves[0].grad, want[0], "dqkv vs JAX")
    _grad_close(leaves[0].grad, leaves32[0].grad, "dqkv vs float32")
    assert not leaves[0].grad[:, 4:].float().any()      # the v rows
    for name, leaf, w in zip(("dr_q", "de_q", "dr_k", "de_k"), leaves[1:],
                             want[1:]):
        if leaf.numel():
            assert_close(leaf.grad, w, name)


def test_plain_backwards_round_dqkv_once():
    """The plain backward versions on bf16 qkv: their float32 dqkv on the
    upcast, rounded once to bf16."""
    qkv, *rest = core_inputs(70, g=2, gp=4, L=8, S=64, has_pos=True)
    rng = np.random.default_rng(71)
    dsv, dsve = (torch.from_numpy(rng.normal(size=(2, 4, 8, 64)).astype(F32))
                 for _ in range(2))
    t = [torch.from_numpy(np.array(a)) for a in rest]
    q = torch.from_numpy(qkv).to(BF16)
    got = axial_lanes.lanes_attn_bwd_plain(q, *t, dsv, dsve)
    want = axial_lanes.lanes_attn_bwd_plain(q.float(), *t, dsv, dsve)
    assert got[0].dtype == BF16
    assert torch.equal(got[0], want[0].to(BF16))
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    m_in = [torch.from_numpy(np.array(a)) for a in moment_inputs(
        72, g=2, gp=4, L=8, S=64, has_pos=True)]
    ct = torch.from_numpy(rng.normal(size=(2, 8)).astype(F32))
    got = moments.moment_sums_bwd_plain(m_in[0].to(BF16), *m_in[1:], ct)
    want = moments.moment_sums_bwd_plain(m_in[0].to(BF16).float(),
                                         *m_in[1:], ct)
    assert got[0].dtype == BF16 and torch.equal(got[0], want[0].to(BF16))


# ---- a bf16 train step against JAX's -------------------------------------------

# inputs of the train-step comparison: the blob batch, and the same batch
# perturbed by one bf16 rounding (2^-8, relative) with these seeds
BF16_INPUT_SEEDS = (None, 1, 2, 3, 4, 5, 6, 7)


def _inputs(images):
    x = images.astype(F32) / 255.0
    out = []
    for seed in BF16_INPUT_SEEDS:
        if seed is None:
            out.append(x)
        else:
            rng = np.random.default_rng(seed)
            out.append((x * (1.0 + 2.0 ** -8 * rng.standard_normal(x.shape)))
                       .astype(F32))
    return out


@pytest.mark.parametrize("name,kw", [("axialunet", {}),
                                     ("MedT", {"patch_grid": 1})])
def test_bf16_train_step_matches_jax(name, kw):
    """At batch 2 the train-mode network's deepest BNs normalise a few
    values each, so it amplifies any rounding: one bf16 rounding of the
    input moves the loss by up to 0.05 and the logits by up to 1.2, and
    JAX's own bf16 loss moves by up to 0.04 with where its compiler rounds
    (under ``jit`` XLA keeps fusions' intermediates in float32, its
    default ``xla_allow_excess_precision``). On one input, port_bf16 -
    jax_bf16 and bf16's effect jax_bf16 - jax_f32 are each such a random
    move, so each side of the bound is its mean over
    ``BF16_INPUT_SEEDS``' eight inputs: mean |port_bf16 - jax_bf16| <=
    2 mean |jax_bf16 - jax_f32| + 1e-3, for the loss and for the
    train-mode logits (max |.| per input). JAX runs under ``jit``, as its
    ``train_step`` does."""
    img = 32
    variables = jax_variables(name, img, seed=0, **kw)
    images, masks = blob_batch(2, img, seed=3)
    labels = torch.from_numpy(masks)
    sd = carried(name, variables)
    inputs = _inputs(images)
    fns = {}
    for dt in (jnp.bfloat16, None):
        jm = jax_build_model(name, img_size=img, use_fused=True, dtype=dt,
                             **kw)
        fns["f32" if dt is None else "bf16"] = jax.jit(
            lambda v, x, jm=jm: jm.apply(
                v, x, train=True, mutable=["batch_stats"])[0])

    def port_model():
        model = build_model(name, img_size=img, use_fused=True,
                            device="cpu", dtype=BF16, **kw)
        model.load_state_dict(sd, strict=True)
        return model.train()

    gaps, effects = [], []
    with kernel_mesh_scope():       # JAX's unsharded step (see
        set_kernel_mesh(None)       # tests/test_torch_port_training.py)
        for x in inputs:
            out = {dt: np.asarray(f(variables, jnp.asarray(x))
                                  .astype(jnp.float32)).transpose(0, 3, 1, 2)
                   for dt, f in fns.items()}
            with torch.no_grad():
                logits = port_model()(torch.from_numpy(x).permute(0, 3, 1, 2))
            assert logits.dtype == BF16
            out["port"] = logits.float().numpy()
            loss = {k: float(log_nll_loss(torch.from_numpy(v), labels))
                    for k, v in out.items()}

            def diff(a, b):
                return (abs(loss[a] - loss[b]), np.abs(out[a] - out[b]).max())

            gaps.append(diff("port", "bf16"))
            effects.append(diff("bf16", "f32"))
    gap, effect = np.mean(gaps, axis=0), np.mean(effects, axis=0)
    assert (gap <= 2 * effect + 1e-3).all(), (gaps, effects)
    assert (effect > 0).all()   # bf16 moved JAX's outputs: the bound is bf16's

    # the step: its loss is the forward's, and everything stays float32
    model = port_model()
    with torch.no_grad():
        logits = model(torch.from_numpy(inputs[0]).permute(0, 3, 1, 2))
    stepped = port_model()
    state = TrainState(stepped, sgd(stepped.parameters(), 0.05))
    loss = float(train_step(state, {"image": images, "label": masks})
                 ["loss"])
    assert loss == float(log_nll_loss(logits, labels))
    dtypes = {t.dtype for t in stepped.state_dict().values()
              if t.is_floating_point()}
    assert dtypes == {torch.float32}
    assert all(p.grad.dtype == torch.float32
               for p in stepped.parameters() if p.grad is not None)
