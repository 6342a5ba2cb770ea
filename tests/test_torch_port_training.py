"""The port's training slice against the JAX package, on CPU.

* ``log_nll_loss`` (class weights, ``ignore_index``) and
  ``deep_supervision_loss`` at atol 1e-6;
* ``adam_l2`` and ``sgd`` against the optax chains over 3 steps on
  identical gradients (atol 1e-6), the schedules at atol 1e-7;
* the synthetic blob batch, ``eval_step`` and a falling loss;
* the whole slice: one ``train_step`` of gatedaxialunet 32 px from the same
  weights as JAX ``train_step`` (``sgd``, so the update is linear in the
  gradients): the loss at 1e-5 + 1e-4*|want|; every parameter and running
  statistic after the step at 1e-5 + 1e-4*max|want| plus four times the
  port's own float32 sensitivity (see :func:`check_train_step`).
  tests/test_torch_port_train_medt.py runs the same check on MedT.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import _torch_threads  # noqa: F401  (one PyTorch thread)

from medt_tpu import losses as jlosses
from medt_tpu.models import build_model as jax_build_model
from medt_tpu.parallel import kernel_mesh_scope, set_kernel_mesh
from medt_tpu.training import optimizers as joptim
from medt_tpu.training import schedules as jsched
from medt_tpu.training.state import TrainState as JaxTrainState
from medt_tpu.training.state import train_step as jax_train_step
from medt_tpu_torch.data import InMemoryDataset, blob_batch
from medt_tpu_torch.losses import deep_supervision_loss, log_nll_loss
from medt_tpu_torch.models import build_model
from medt_tpu_torch.training import (
    TrainState,
    adam_l2,
    build_optimizer,
    eval_step,
    schedules,
    sgd,
    train_step,
)
from test_torch_port_models import carried, jax_variables

F32 = np.float32


# ---- losses -------------------------------------------------------------------

def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("weight,ignore", [
    (None, -100), ((0.3, 1.7, 1.0), -100), (None, 2), ((0.5, 2.0, 1.0), 1)])
def test_log_nll_loss_matches_jax(weight, ignore):
    rng = np.random.default_rng(60)
    logits = rng.normal(size=(2, 5, 6, 3)).astype(F32)
    labels = rng.integers(0, 3, size=(2, 5, 6)).astype(np.int32)
    labels[0, 0, :2] = -100
    want = jlosses.log_nll_loss(
        jnp.asarray(logits), jnp.asarray(labels),
        None if weight is None else jnp.asarray(weight, jnp.float32), ignore)
    got = log_nll_loss(_nchw(logits), torch.from_numpy(labels), weight, ignore)
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=0)


def test_log_nll_loss_out_of_class_labels():
    """Labels [0, 1, 1, 5] on 2 classes: without ``weight`` the label 5
    adds its logsumexp to the mean at weight 1 (the JAX value); with
    ``weight`` it drops out."""
    logits = np.array([[0.3, -0.2], [1.1, 0.4], [-0.5, 0.9], [0.2, 0.7]],
                      F32).reshape(1, 4, 1, 2)          # NHWC, H = 4
    labels = np.array([0, 1, 1, 5], np.int32).reshape(1, 4, 1)
    want = jlosses.log_nll_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = log_nll_loss(_nchw(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=0)
    flat = logits.reshape(4, 2).astype(np.float64)
    lse = np.log(np.exp(flat).sum(-1))
    ce = lse[:3] - flat[np.arange(3), [0, 1, 1]]
    np.testing.assert_allclose(float(got), (ce.sum() + lse[3]) / 4,
                               atol=1e-6, rtol=0)
    weighted = log_nll_loss(_nchw(logits), torch.from_numpy(labels),
                            (1.0, 1.0))
    np.testing.assert_allclose(float(weighted), ce.mean(), atol=1e-6, rtol=0)


def test_deep_supervision_loss_matches_jax():
    rng = np.random.default_rng(61)
    logits = rng.normal(size=(2, 8, 8, 2)).astype(F32)
    aux = [rng.normal(size=(2, s, s, 2)).astype(F32) for s in (4, 2)]
    labels = rng.integers(0, 2, size=(2, 8, 8)).astype(np.int32)
    want = jlosses.deep_supervision_loss(
        (jnp.asarray(logits), tuple(map(jnp.asarray, aux))),
        jnp.asarray(labels))
    got = deep_supervision_loss((_nchw(logits), tuple(map(_nchw, aux))),
                                torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=0)


# ---- optimizers and schedules ---------------------------------------------------

def _run_optimizers(jax_tx, make_torch, steps=3):
    rng = np.random.default_rng(62)
    params = {"w": rng.normal(size=(4, 3)).astype(F32),
              "b": rng.normal(size=(3,)).astype(F32)}
    grads = [{k: rng.normal(size=v.shape).astype(F32)
              for k, v in params.items()} for _ in range(steps)]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = jax_tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    frozen = torch.nn.Parameter(torch.ones(2), requires_grad=False)
    opt = make_torch([tp["w"], frozen, tp["b"]])
    assert all(p is not frozen for g in opt.param_groups
               for p in g["params"])
    for g in grads:
        upd, opt_state = jax_tx.update({k: jnp.asarray(v)
                                        for k, v in g.items()},
                                       opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), atol=1e-6, rtol=0)


def test_adam_l2_matches_optax():
    _run_optimizers(joptim.adam_l2(1e-2, weight_decay=1e-2),
                    lambda ps: adam_l2(ps, 1e-2, weight_decay=1e-2))


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_matches_optax(nesterov):
    _run_optimizers(
        joptim.sgd(0.1, momentum=0.9, weight_decay=1e-3, nesterov=nesterov),
        lambda ps: build_optimizer("sgd", ps, 0.1, momentum=0.9,
                                   weight_decay=1e-3, nesterov=nesterov))


@pytest.mark.parametrize("name,args", [
    ("constant", (0.01,)), ("cosine", (0.1, 10, 5, 1)),
    ("cosine", (0.1, 10, 5, 0)), ("linear", (0.1, 4, 2))])
def test_schedules_match_jax(name, args):
    want = jsched.SCHEDULE_REGISTRY[name](*args)
    got = schedules.SCHEDULE_REGISTRY[name](*args)
    for step in (0, 1, 7, 9, 10, 11, 25, 49, 50, 119, 121, 239, 241, 500):
        np.testing.assert_allclose(got(step), float(want(step)), atol=1e-7,
                                   rtol=1e-6, err_msg=f"step {step}")


# ---- data, eval, a falling loss -----------------------------------------------------

def test_synthetic_data():
    images, masks = blob_batch(3, 32, seed=4)
    assert images.shape == (3, 32, 32, 3) and images.dtype == np.uint8
    assert masks.shape == (3, 32, 32) and set(np.unique(masks)) == {0, 1}
    again, _ = blob_batch(3, 32, seed=4)
    np.testing.assert_array_equal(images, again)
    ds = InMemoryDataset(n=2, img_size=8)
    img, mask, name = ds[1]
    assert img.shape == (8, 8, 3) and mask.shape == (8, 8) and name == "001.png"


def test_train_step_lowers_the_loss_and_eval_step():
    """Adam on one fixed blob batch: the loss falls over 4 steps; the
    schedule sets the rate; eval_step gives logits and keeps the mode."""
    images, masks = blob_batch(2, 32, seed=5)
    model = build_model("gatedaxialunet", img_size=32, use_fused=True,
                        seed=1, device="cpu")
    state = TrainState(model, adam_l2(model.parameters(), 1e-3),
                       schedule=schedules.constant(2e-3))
    losses = [float(train_step(state, {"image": images, "label": masks})
                    ["loss"]) for _ in range(4)]
    assert state.step == 4
    assert state.optimizer.param_groups[0]["lr"] == 2e-3
    assert losses[-1] < losses[0], losses
    logits = eval_step(state, {"image": images})
    assert logits.shape == (2, 2, 32, 32) and model.training


# ---- the whole slice ----------------------------------------------------------------

LR = 0.05
# relative perturbation of the input image that measures how far float32
# rounding alone moves the step (8 units in the last place of float32)
INPUT_NOISE = 1e-6
NOISE_FACTOR = 4.0


def check_train_step(name, img, batch=2, loss_spread=False, remat=False,
                     **kw):
    """One train_step of the port vs JAX ``train_step`` (sgd, lr 0.05) on a
    batch of ``batch`` synthetic blob images, from the same random weights.

    At these sizes the train-mode network is far from well conditioned:
    every BN renormalises, and a perturbation of one unit in the last place
    of the input moves some deep gradients by tens of percent. So besides
    the stated tolerance each tensor may differ by ``NOISE_FACTOR`` times
    the port's own change when its input image is perturbed by
    ``INPUT_NOISE`` (relative; the largest spread of three runs, two of
    them perturbed) — the spread that float32 rounding alone gives the
    step. Well-conditioned tensors are held to the tolerance.
    ``loss_spread`` holds the loss by the same rule; otherwise it is held
    to the tolerance alone. ``remat`` runs both steps with ``remat=True``
    (the forward recomputed in the backward)."""
    variables = jax_variables(name, img, seed=0, **kw)
    jax_model = jax_build_model(name, img_size=img, use_fused=True, **kw)
    jstate = JaxTrainState.create(
        apply_fn=jax_model.apply, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=joptim.sgd(LR))
    images, masks = blob_batch(batch, img, seed=3)
    # the reference is JAX's unsharded step: a kernel mesh that an earlier
    # test in this process left installed (JAX's setup_state installs one
    # over the 8 CPU devices) would run its kernels as shard_map islands,
    # which moves MedT's step by up to 0.19 in a local-branch weight
    with kernel_mesh_scope():
        set_kernel_mesh(None)
        new, metrics = jax.jit(functools.partial(
            jax_train_step, remat=remat))(
            jstate, {"image": jnp.asarray(images),
                     "label": jnp.asarray(masks)})
    want = carried(name, jax.tree_util.tree_map(
        np.asarray, {"params": new.params, "batch_stats": new.batch_stats}))
    before = carried(name, variables)

    def port_step(image):
        model = build_model(name, img_size=img, use_fused=True,
                            device="cpu", **kw)
        model.load_state_dict(before, strict=True)
        state = TrainState(model, sgd(model.parameters(), LR))
        loss = train_step(state, {"image": image, "label": masks},
                          remat=remat)["loss"]
        return float(loss), model.state_dict()

    loss, got = port_step(images)
    x = images.astype(F32) / 255.0
    rng = np.random.default_rng(9)
    noisy_runs = [port_step((x * (1.0 + INPUT_NOISE * rng.standard_normal(
        x.shape))).astype(F32)) for _ in range(2)]
    noisy = [run[1] for run in noisy_runs]

    jloss = float(metrics["loss"])
    losses = [loss] + [run[0] for run in noisy_runs]
    loss_noise = max(losses) - min(losses) if loss_spread else 0.0
    assert abs(loss - jloss) <= 1e-5 + 1e-4 * abs(jloss) \
        + NOISE_FACTOR * loss_noise, (loss, jloss, loss_noise)
    assert set(got) == set(want)
    checked = 0
    for key, w in want.items():
        if not w.dtype.is_floating_point:
            continue
        runs = [got[key]] + [n[key] for n in noisy]
        noise = max(float((a - b).abs().max()) for i, a in enumerate(runs)
                    for b in runs[i + 1:])
        tol = 1e-5 + 1e-4 * float(w.abs().max()) + NOISE_FACTOR * noise
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), atol=tol,
                                   rtol=0, err_msg=key)
        checked += 1
    moved = [k for k, w in want.items() if w.dtype.is_floating_point
             and not torch.equal(w, before[k])]
    assert len(moved) > checked // 2  # the step changed the state
    return checked


def test_train_step_matches_jax_gatedaxialunet():
    assert check_train_step("gatedaxialunet", 32) > 100
