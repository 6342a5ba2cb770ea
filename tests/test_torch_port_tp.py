"""The port's model axis (``--tp``, group tensor parallelism), on the CPU.

JAX's rule is that a step under its mesh computes the unsharded function;
its ``model`` axis splits the attention groups of every layer
(``medt_tpu/parallel/partitioning.py``) and runs the kernels as per-device
islands (``kernel_sharding.py``). Two gloo worlds, each spawned once
(``parallel.run_data_parallel``, one PyTorch thread a rank), run the cases
of ``_torch_tp_ranks.py`` on a ``(dp, tp)`` mesh, each held against one
process on the whole batch:

* the ``(1, 2)`` world: eight ``AxialAttention`` sites in train mode (the
  lanes route with and without positions, the stripe route, the plain
  path, trainable gates on the lanes route and sigmoid gates on the stripe
  route, the data gates, and a layer of 3 groups that 2 ranks leave
  whole) and then in eval mode: outputs, input gradients, every gradient
  in its one-card shape (``relative`` and the gates included: the
  replicated parameters the split layers use) and running statistics at
  1e-5 + 1e-4*max|want| plus four times the one-process case's float32
  spread over two batches perturbed by 1e-6 (a gate's gradient is a sum
  with heavy cancellation: the sigmoid ``f_sve``'s moves 1e-5 of 1e-2);
  ``cli.train --tp 2`` joining the world;
* the ``(1, 2)`` and ``(2, 2)`` worlds: whole ``train_step``s of
  gatedaxialunet 32 px (SGD and Adam-L2 at 4 global rows, Adam-L2 at 1,
  SGD with ``remat``): the loss, and every gradient, running statistic and
  parameter after the update under the DP tests' rule (1e-5 +
  1e-4*max|want| plus four times the one-process step's float32 spread),
  Adam-L2's update as Adam-L2 of the gathered gradients, bit for bit; the
  replicated parameters bit-equal on every rank; the ``(2, 2)`` SGD step
  also against JAX's ``train_step`` on ``make_mesh(4, dp=2, sp=1,
  tp=2)`` (its plain path);
* the ``(2, 2)`` world: a one-card checkpoint (model and Adam state)
  restored into each rank's split, DDP-wrapped model.

Outside the worlds: ``make_mesh``'s grid against JAX's device grid, and
its refusal of a data axis that the slices do not divide.
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one PyTorch thread)

import _torch_tp_ranks as ranks
from medt_tpu.models import build_model as jax_build_model
from medt_tpu.parallel import kernel_mesh_scope, set_kernel_mesh, shard_state
from medt_tpu.parallel import make_mesh as jax_make_mesh
from medt_tpu.parallel import shard_batch as jax_shard_batch
from medt_tpu.training import optimizers as joptim
from medt_tpu.training.state import TrainState as JaxTrainState
from medt_tpu.training.state import train_step as jax_train_step
from medt_tpu_torch.cli import train as cli_train
from medt_tpu_torch.data import blob_batch, make_png_dataset
from medt_tpu_torch.models import build_model
from medt_tpu_torch.parallel import make_mesh, run_data_parallel
from medt_tpu_torch.training import adam_l2, restore_checkpoint
from test_torch_port_models import carried, jax_variables

MODEL, IMG, LR = ranks.MODEL, ranks.IMG, ranks.LR
WORLDS = ((1, 2), (2, 2))
INPUT_NOISE = 1e-6   # as test_torch_port_training.py
NOISE_FACTOR = 4.0


def _cli_argv(root, direc, extra=()):
    return ["--train_dataset", str(root / "train"), "--val_dataset",
            str(root / "val"), "--modelname", MODEL, "--imgsize", str(IMG),
            "--epochs", "1", "--save_freq", "1", "--batch_size", "3",
            "--workers", "0", "--direc", str(direc), *extra]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's ranks' results, the same cases on one process, the
    perturbed one-process steps (the float32 spread) and the CLI runs."""
    before = carried(MODEL, jax_variables(MODEL, IMG, seed=0))
    root = tmp_path_factory.mktemp("tp")
    make_png_dataset(str(root / "train"), n=3, img_size=IMG, seed=5)
    make_png_dataset(str(root / "val"), n=2, img_size=IMG, seed=6)
    cli_train.main(_cli_argv(root, root / "tp1"), device="cpu")
    got = {}
    for dp, tp in WORLDS:
        first = (dp, tp) == WORLDS[0]
        got[dp, tp] = run_data_parallel(
            ranks.cases, ["cpu"] * (dp * tp), "gloo", timeout_s=300,
            args=(dp, tp, before, first,
                  _cli_argv(root, root / "tp2", ["--tp", "2"])
                  if first else None,
                  None if first else str(root / "tp1" / "final_model")))
    one = ranks.one_process(before)
    rng = np.random.default_rng(9)
    spread = {}
    for name, rows, opt, _ in ranks.STEPS:
        if name in ("rows4", "rows1"):
            x = blob_batch(rows, IMG, seed=3)[0].astype(np.float32) / 255.0
            spread[name] = [ranks.step_case(
                before, rows, opt, False, "cpu", image=(x * (
                    1.0 + INPUT_NOISE * rng.standard_normal(x.shape)))
                .astype(np.float32)) for _ in range(2)]
    spread["rows4adam"] = spread["remat"] = spread["rows4"]
    return types.SimpleNamespace(before=before, got=got, one=one,
                                 spread=spread, root=root)


def _held(got: dict, want: dict, runs, what: str):
    """Every float tensor of ``got`` against ``want``: 1e-5 +
    1e-4*max|want| plus NOISE_FACTOR times the spread of the one-process
    ``runs`` (the step and the same step on perturbed inputs)."""
    assert set(got) == set(want)
    for key, w in want.items():
        if not w.dtype.is_floating_point:
            continue
        spread = [r[key] for r in runs]
        noise = max(float((a - b).abs().max())
                    for i, a in enumerate(spread) for b in spread[i + 1:])
        tol = 1e-5 + 1e-4 * float(w.abs().max()) + NOISE_FACTOR * noise
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=0,
                                   atol=tol, err_msg=f"{what} {key}")


@pytest.mark.parametrize("n, dp, tp, slices", [
    (2, 1, 2, None), (4, 2, 2, None), (4, 1, 4, None), (8, 2, 4, None),
    (8, 4, 2, 2), (8, 8, 1, 4), (8, 2, 4, 2)])
def test_make_mesh_matches_jax(n, dp, tp, slices):
    """The rank grid is JAX's device grid at sp=1 (node-major, the model
    axis inside a node)."""
    want = jax_make_mesh(n, dp=dp, sp=1, tp=tp, slices=slices)
    ids = np.vectorize(lambda d: d.id)(want.devices)[:, 0, :]
    np.testing.assert_array_equal(make_mesh(n, dp, tp, slices), ids)
    if slices is None:
        np.testing.assert_array_equal(make_mesh(n, tp=tp), ids)


def test_make_mesh_refuses_a_data_axis_across_slices():
    message = r"data axis \(1\) must be a multiple of the slice count \(2\)"
    with pytest.raises(AssertionError, match=message):
        jax_make_mesh(4, dp=1, sp=1, tp=4, slices=2)
    with pytest.raises(ValueError, match=message):
        make_mesh(4, 1, 4, 2)
    with pytest.raises(ValueError, match=r"--dp 2 x --tp 3 = 6 ranks"):
        make_mesh(4, 2, 3)
    with pytest.raises(ValueError, match=r"--tp 3 does not divide"):
        make_mesh(4, tp=3)


@pytest.mark.parametrize("kind", list(ranks.MODULES))
def test_attention_matches_one_process(worlds, kind):
    """A layer split over two model ranks computes the one-process layer:
    its output, input gradient, every gradient (the replicated ones summed
    over the axis) and running statistic; then its eval forward."""
    want = worlds.one["modules"][kind]
    runs = [want] + worlds.one["module_spread"][kind]
    got = [r["modules"][kind] for r in worlds.got[1, 2]]
    groups = ranks.MODULES[kind][3]
    for rank, r in enumerate(got):
        assert r["split"] == (groups % 2 == 0), rank
        if want["route"] is not None:
            assert r["route"][2] == groups // (2 if r["split"] else 1)
        tensors = ("out", "dx", "eval")
        _held({k: r[k] for k in tensors}, {k: want[k] for k in tensors},
              [{k: o[k] for k in tensors} for o in runs], f"rank {rank}")
        for what in ("grads", "stats"):
            assert want[what]
            for key in want[what]:
                assert torch.equal(r[what][key], got[0][what][key]), key
            _held(r[what], want[what], [o[what] for o in runs],
                  f"rank {rank} {what}")


@pytest.mark.parametrize("name", [s[0] for s in ranks.STEPS])
@pytest.mark.parametrize("mesh", WORLDS)
def test_step_matches_one_process(worlds, mesh, name):
    """A train_step on a (dp, tp) mesh is the one-process step on the
    joint batch; every rank holds the replicated parameters bit-equal."""
    got = [r["steps"][name] for r in worlds.got[mesh]]
    want = worlds.one["steps"]["rows4" if name == "remat" else name]
    runs = [want] + worlds.spread[name]
    r0 = got[0]
    assert r0["split"] == 16     # every attention layer of the model
    for r in got:
        assert r["loss"] == r0["loss"]
        for key, p in r0["replicated"].items():
            assert torch.equal(r["replicated"][key], p), key
    assert abs(r0["loss"] - want["loss"]) <= 1e-5 + 1e-4 * abs(want["loss"])
    for what in ("grads", "stats"):
        _held(r0[what], want[what], [r[what] for r in runs], what)
    if dict((s[0], s[2]) for s in ranks.STEPS)[name] == "sgd":
        _held(r0["params"], want["params"], [r["params"] for r in runs],
              "params")
    else:
        # Adam's first update is about lr*sign(g): held as Adam-L2 of the
        # ranks' own gathered gradients, bit for bit
        model = build_model(MODEL, img_size=IMG, device="cpu")
        model.load_state_dict(worlds.before, strict=True)
        for key, p in model.named_parameters():
            p.grad = r0["grads"].get(key)
        adam_l2(model.parameters(), LR).step()
        for key, p in model.named_parameters():
            assert torch.equal(p.detach(), r0["params"][key]), key


def test_step_matches_jax_tp_mesh(worlds):
    """The (2, 2) SGD step at 4 rows against JAX's train_step on a dp=2,
    tp=2 mesh (its plain path, its attention tensors sharded over
    ``model``): the loss, the parameters after the update and the running
    statistics."""
    variables = jax_variables(MODEL, IMG, seed=0)
    model = jax_build_model(MODEL, img_size=IMG, use_fused=False)
    state = JaxTrainState.create(
        apply_fn=model.apply, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=joptim.sgd(LR))
    images, masks = blob_batch(4, IMG, seed=3)
    with kernel_mesh_scope():
        set_kernel_mesh(None)
        mesh = jax_make_mesh(4, dp=2, sp=1, tp=2)
        new, metrics = jax.jit(jax_train_step)(
            shard_state(state, mesh),
            jax_shard_batch({"image": jnp.asarray(images),
                             "label": jnp.asarray(masks)}, mesh))
    want = {k: w for k, w in carried(MODEL, jax.tree_util.tree_map(
        np.asarray, {"params": new.params, "batch_stats": new.batch_stats}))
        .items() if w.dtype.is_floating_point}
    got = worlds.got[2, 2][0]["steps"]["rows4"]
    jloss = float(metrics["loss"])
    assert abs(got["loss"] - jloss) <= 1e-5 + 1e-4 * abs(jloss)
    port = {**got["params"], **got["stats"]}
    runs = [{**r["params"], **r["stats"]}
            for r in [worlds.one["steps"]["rows4"]] + worlds.spread["rows4"]]
    assert set(port) == set(want)
    _held(port, want, runs, "state after the step")


def _log(direc):
    with open(direc / "train_log.jsonl") as f:
        return [json.loads(line) for line in f]


def test_cli_tp_writes_a_one_card_checkpoint(worlds):
    """``cli.train --tp 2`` in the world: the one-process run's files and
    loss, and one checkpoint per saved epoch, gathered, that loads
    strictly into a one-process model, with an optimizer state of the
    one-card shapes."""
    tp2, tp1 = worlds.root / "tp2", worlds.root / "tp1"
    files = sorted(p.relative_to(tp1).as_posix() for p in tp1.rglob("*"))
    assert sorted(p.relative_to(tp2).as_posix()
                  for p in tp2.rglob("*")) == files
    (got,), (want,) = _log(tp2), _log(tp1)
    assert abs(got["loss"] - want["loss"]) <= 1e-5 + 1e-4 * abs(want["loss"])
    for key in ("val_f1", "val_iou"):
        assert abs(got[key] - want[key]) <= 1e-6, key
    model = build_model(MODEL, img_size=IMG, use_fused=True, device="cpu")
    opt = adam_l2(model.parameters(), LR)
    assert restore_checkpoint(str(tp2 / "0"), model, opt) == 1
    params = [p for group in opt.param_groups for p in group["params"]]
    for index, fields in opt.state_dict()["state"].items():
        for field, value in fields.items():
            if value.dim():
                assert value.shape == params[index].shape, (index, field)
    saved = torch.load(tp2 / "0" / "ckpt.pth", weights_only=True)
    mine = torch.load(tp1 / "0" / "ckpt.pth", weights_only=True)
    for key, w in mine["state_dict"].items():
        assert saved["state_dict"][key].shape == w.shape, key


def test_one_card_checkpoint_restores_into_tp_ranks(worlds):
    """The reverse: the one-process run's checkpoint (weights and Adam-L2
    state) restores into each rank of the (2, 2) world, split and
    DDP-wrapped; gathered back, each rank holds the file's tensors."""
    path = worlds.root / "tp1" / "final_model" / "ckpt.pth"
    saved = torch.load(path, weights_only=True)
    for rank in worlds.got[2, 2]:
        restored = rank["restored"]
        assert restored["step"] == saved["step"] == 1
        assert set(restored["model"]) == set(saved["state_dict"])
        for key, w in saved["state_dict"].items():
            assert torch.equal(restored["model"][key], w), key
        want = saved["optimizer"]["state"]
        assert set(restored["optimizer"]["state"]) == set(want)
        for index, fields in want.items():
            for field, w in fields.items():
                assert torch.equal(
                    restored["optimizer"]["state"][index][field], w), \
                    (index, field)
