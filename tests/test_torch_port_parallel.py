"""The port's data-parallel training and multi-replica serving, on the CPU.

JAX's rule is that a step under its mesh computes the unsharded function:
the same loss, gradients, update and BN running statistics as one device
on the joint batch. One two-rank gloo world (``parallel.
run_data_parallel`` over ``["cpu", "cpu"]``, a module fixture) runs every
two-rank case of ``_torch_dp_ranks.py``; each is held against the same
case on one process on the joint batch:

* ``BatchNorm`` and four ``AxialAttention`` sites in train mode (the lanes
  route with and without positions, the stripe route, the plain path), at
  3 global rows and at 1 (a rank with no rows): outputs, input gradients,
  parameter gradients and running statistics at 1e-5 + 1e-4*max|want|;
* whole ``train_step``s of gatedaxialunet 32 px (``use_fused``, plain cores)
  at 4 (SGD), 3 and 1 (Adam-L2) global rows and with ``remat`` at 4: the
  loss at 1e-5 + 1e-4*|want|, and every gradient, running statistic and
  parameter after the update under the rule of
  ``test_torch_port_training.py::check_train_step`` (1e-5 + 1e-4*max|want|
  plus four times the one-process step's own float32 spread), the two
  ranks' parameters bit-equal after the update; the 4-row step also
  against JAX's ``train_step`` on ``make_mesh(2, dp=2, sp=1, tp=1)`` (its
  plain path; SGD, so the update is the gradient);
* ``cli.train_cls``'s data-parallel step (axial26s at 32 px on the fused
  path, label smoothing, SGD) at joint batches of 4 and 3 rows: the loss
  and the accuracy (the joint batch's on both ranks), and every gradient,
  running statistic and parameter after the update under the steps' rule;
* outside a data-parallel step a bare ``BatchNorm`` in the world takes its
  own rows' statistics;
* ``cli.train.main([... "--dp", "2"], device="cpu")`` joining the world:
  one log, one checkpoint that loads strictly into a one-process model,
  the logged loss the one-process CLI's; and the one-process CLI's
  checkpoint restored strictly into each rank's DDP-wrapped model;
* ``cli.train_cls.main([... "--distributed", "-b", "2"], device="cpu")``
  over an ImageFolder of 9 images: both ranks take the one-process run's
  3 steps (``-b 4``), one log whose ``val_acc`` is the one-process run's,
  one checkpoint that loads strictly into a one-card model.

Outside the world: the loader's per-rank rows, the CLI's spawn of the
ranks (``run_data_parallel`` replaced by a recorder), the engine with two
CPU replicas against one, and the refusals of ``--sp``, of a ``--tp``
that does not divide the world, of ``--num_slices`` over a data axis it
does not divide, and of a ``--dp`` past the visible cards.
"""
import json
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one PyTorch thread)

import _torch_dp_ranks as ranks
from medt_tpu.models import build_model as jax_build_model
from medt_tpu.parallel import (
    kernel_mesh_scope,
    make_mesh,
    set_kernel_mesh,
    shard_state,
)
from medt_tpu.parallel import shard_batch as jax_shard_batch
from medt_tpu.training import optimizers as joptim
from medt_tpu.training.state import TrainState as JaxTrainState
from medt_tpu.training.state import train_step as jax_train_step
from medt_tpu_torch import builders
from medt_tpu_torch.cli import serve as cli_serve
from medt_tpu_torch.cli import train as cli_train
from medt_tpu_torch.data import DataLoader, blob_batch, make_png_dataset
from medt_tpu_torch.models import build_model
from medt_tpu_torch.parallel import rank_rows, run_data_parallel, shard_batch
from medt_tpu_torch.serving import InferenceEngine
from medt_tpu_torch.training import adam_l2, restore_checkpoint
from test_torch_port_cls_data import write_image_folder
from test_torch_port_models import carried, jax_variables

MODEL, IMG, LR = ranks.MODEL, ranks.IMG, ranks.LR
INPUT_NOISE = 1e-6   # as test_torch_port_training.py
NOISE_FACTOR = 4.0


def _cls_argv(root, work_dirs, batch, extra=()):
    return ["--model", "resnet18", "--num_classes", "3", "--imgsize", "64",
            "--epochs", "1", "-b", str(batch), "--train_dataset",
            str(root / "cls"), "--val_dataset", str(root / "cls"),
            "--work_dirs", str(work_dirs), "-j", "0", *extra]


def _cli_argv(root, direc, extra=()):
    return ["--train_dataset", str(root / "train"), "--val_dataset",
            str(root / "val"), "--modelname", MODEL, "--imgsize", str(IMG),
            "--epochs", "1", "--save_freq", "1", "--batch_size", "3",
            "--workers", "0", "--direc", str(direc), *extra]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The two ranks' results, the same cases on one process, the
    perturbed one-process steps (the float32 spread) and the CLI runs."""
    before = carried(MODEL, jax_variables(MODEL, IMG, seed=0))
    root = tmp_path_factory.mktemp("dp")
    make_png_dataset(str(root / "train"), n=3, img_size=IMG, seed=5)
    make_png_dataset(str(root / "val"), n=2, img_size=IMG, seed=6)
    # 9 images: joint batches of 4, 4 and 1 (a rank without rows)
    write_image_folder(root / "cls", per_class=3, size=(36, 40),
                       classes=("a", "b", "c"))
    # as many threads as a rank has: more only contend for the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, min(threads, (os.cpu_count() or 2) // 2)))
    try:
        cli_train.main(_cli_argv(root, root / "dp1"), device="cpu")
        cls_one = ranks.train_cls_run(_cls_argv(root, root / "cls1", 4))
        two = run_data_parallel(
            ranks.cases, ["cpu", "cpu"], "gloo", timeout_s=300,
            args=(before, _cli_argv(root, root / "dp2", ["--dp", "2"]),
                  str(root / "dp1" / "final_model"),
                  _cls_argv(root, root / "cls2", 2, ["--distributed"])))
        one = ranks.one_process(before)
        rng = np.random.default_rng(9)
        spread = {}
        for name, rows, opt, _ in ranks.STEPS[:3]:
            x = blob_batch(rows, IMG, seed=3)[0].astype(np.float32) / 255.0
            spread[name] = [ranks.step_case(
                before, rows, opt, False, "cpu", image=(x * (
                    1.0 + INPUT_NOISE * rng.standard_normal(x.shape)))
                .astype(np.float32)) for _ in range(2)]
        spread["remat"] = spread["rows4"]
        for rows in ranks.CLS_ROWS:
            x = np.random.default_rng(21).normal(
                size=(rows, ranks.CLS_IMG, ranks.CLS_IMG, 3))
            spread["cls", rows] = [ranks.cls_step_case(
                rows, "cpu", image=(x * (1.0 + INPUT_NOISE * rng
                                         .standard_normal(x.shape)))
                .astype(np.float32)) for _ in range(2)]
    finally:
        torch.set_num_threads(threads)
    return types.SimpleNamespace(before=before, two=two, one=one,
                                 spread=spread, root=root, cls_one=cls_one)


def _close(got, want, err_msg):
    tol = 1e-5 + 1e-4 * float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=tol,
                               err_msg=err_msg)


def _held(got: dict, want: dict, runs, what: str):
    """Every float tensor of ``got`` against ``want`` under
    check_train_step's rule: 1e-5 + 1e-4*max|want| plus NOISE_FACTOR times
    the spread of the port's one-process ``runs`` (the joint-batch step
    and the same step on perturbed inputs), each a dict like ``got``."""
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


def test_shard_batch_rows():
    batch = {"image": np.arange(5), "label": torch.arange(5),
             "name": list("abcde")}
    parts = [shard_batch(batch, r, 2) for r in range(2)]
    assert [list(p["image"]) for p in parts] == [[0, 1, 2], [3, 4]]
    assert parts[1]["name"] == ["d", "e"]
    assert parts[1]["label"].tolist() == [3, 4]
    one = {"image": np.zeros((1, 4)), "name": ["a"]}
    empty = shard_batch(one, 1, 2)
    assert empty["image"].shape == (0, 4) and empty["name"] == []


@pytest.mark.parametrize("rows", ranks.MODULE_ROWS)
@pytest.mark.parametrize("kind", ranks.MODULES)
def test_module_matches_one_process(world, kind, rows):
    """Train-mode statistics over two ranks are the joint batch's."""
    r0, r1 = (w["modules"][kind, rows] for w in world.two)
    want = world.one["modules"][kind, rows]
    assert r1["out"].shape[0] == rows // 2    # rank 1: 1 row, or none
    _close(torch.cat([r0["out"], r1["out"]]), want["out"], "out")
    _close(torch.cat([r0["dx"], r1["dx"]]), want["dx"], "dx")
    assert set(r0["grads"]) == set(want["grads"]) and want["grads"]
    for key, w in want["grads"].items():
        assert torch.equal(r0["grads"][key], r1["grads"][key]), key
        _close(r0["grads"][key], w, f"grad {key}")
    for key, w in want["stats"].items():
        assert torch.equal(r0["stats"][key], r1["stats"][key]), key
        _close(r0["stats"][key], w, f"stat {key}")


@pytest.mark.parametrize("name", [s[0] for s in ranks.STEPS])
def test_step_matches_one_process(world, name):
    """A two-rank train_step is the one-process step on the joint batch."""
    r0, r1 = (w["steps"][name] for w in world.two)
    # remat recomputes the same forward: held against the plain 4-row step
    want = world.one["steps"]["rows4" if name == "remat" else name]
    runs = [want] + world.spread[name]
    assert r0["loss"] == r1["loss"]
    assert abs(r0["loss"] - want["loss"]) <= 1e-5 + 1e-4 * abs(want["loss"])
    for key in r0["params"]:
        assert torch.equal(r0["params"][key], r1["params"][key]), key
    for what in ("grads", "stats"):
        _held(r0[what], want[what], [r[what] for r in runs], what)
    if dict((s[0], s[2]) for s in ranks.STEPS)[name] == "sgd":
        _held(r0["params"], want["params"], [r["params"] for r in runs],
              "params")
    else:
        # Adam's first update is about lr*sign(g): a gradient at float32
        # noise level may flip it by 2*lr, so the update is held as Adam-L2
        # of the ranks' own gradients, bit for bit
        model = build_model(MODEL, img_size=IMG, device="cpu")
        model.load_state_dict(world.before, strict=True)
        for key, p in model.named_parameters():
            p.grad = r0["grads"].get(key)
        adam_l2(model.parameters(), LR).step()
        for key, p in model.named_parameters():
            assert torch.equal(p.detach(), r0["params"][key]), key
    moved = [k for k, p in want["params"].items()
             if not torch.equal(p, world.before[k])]
    assert len(moved) > len(want["params"]) // 2


def test_bare_module_in_a_group_takes_its_own_rows(world):
    """Only the data-parallel step sums statistics over the ranks: a bare
    BatchNorm run in the world outside it normalises with its own rows."""
    for rank, got in enumerate(w["bare"] for w in world.two):
        want = ranks.bare_case("cpu", rank_rows(3, rank, 2))
        for key, w in want.items():
            _close(got[key], w, f"rank {rank} {key}")
    assert not torch.equal(world.two[0]["bare"]["running_var"],
                           world.two[1]["bare"]["running_var"])


@pytest.mark.parametrize("rows", ranks.CLS_ROWS)
def test_cls_step_matches_one_process(world, rows):
    """``cli.train_cls``'s step on two ranks is the one-process step on
    the joint batch: its loss and accuracy, gradients, statistics and the
    parameters after the SGD update."""
    r0, r1 = (w["cls_steps"][rows] for w in world.two)
    want = world.one["cls_steps"][rows]
    runs = [want] + world.spread["cls", rows]
    assert (r0["loss"], r0["acc"]) == (r1["loss"], r1["acc"])
    assert abs(r0["loss"] - want["loss"]) <= 1e-5 + 1e-4 * abs(want["loss"])
    assert r0["acc"] == want["acc"]
    for key in r0["params"]:
        assert torch.equal(r0["params"][key], r1["params"][key]), key
    for what in ("grads", "stats", "params"):
        _held(r0[what], want[what], [r[what] for r in runs], what)


def test_train_cls_distributed_takes_equal_steps(world):
    """Over 9 images at 2 rows a rank, each rank takes the one-process
    run's 3 steps at 4 rows (the last joint batch has one row: rank 1
    takes none of it and pairs its collectives all the same)."""
    assert world.cls_one["steps"] == 3
    for rank in world.two:
        assert rank["train_cls"]["steps"] == 3


def test_train_cls_distributed_logs_the_one_process_val_acc(world):
    """One log, written by the coordinator: the loss near the one-process
    run's and the same val_acc over the whole validation set."""
    (got,), (want,) = (_log(world.root / d) for d in ("cls2", "cls1"))
    assert got["val_acc"] == want["val_acc"]
    assert abs(got["loss"] - want["loss"]) <= 1e-3 * abs(want["loss"])


def test_train_cls_distributed_checkpoint_loads_one_card(world):
    """The coordinator's checkpoint loads strictly into a one-card model
    and holds the ranks' final weights."""
    args = types.SimpleNamespace(model="resnet18", num_classes=3)
    model = builders.build_model(args, device="cpu")
    path = world.root / "cls2" / "final_model"
    assert restore_checkpoint(str(path), model) == 3
    for key, w in model.state_dict().items():
        for rank in world.two:
            assert torch.equal(rank["train_cls"]["state_dict"][key], w), key


class _Indexed:
    """A dataset whose sample ``i`` is ``i`` (and its rng's first draw);
    it records every index it loads."""

    def __init__(self, n):
        self.n, self.loaded = n, []

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng=None):
        self.loaded.append(i)
        return (np.full((2, 3), i + rng.random(), np.float32),
                np.full((2,), i, np.int64), f"s{i}")


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_shard_loads_only_its_rows(workers):
    """Each rank's loader yields its rows of every global batch, the same
    values as the unsharded loader's (a rank past the last row: an empty
    batch of the right shapes), and loads no other rank's sample but the
    first of a batch it has no row of (for the shapes)."""
    full = DataLoader(_Indexed(5), 4, seed=2, num_workers=workers)
    want = [list(full) for _ in range(2)]       # two epochs
    for rank in range(2):
        data = _Indexed(5)
        loader = DataLoader(data, 4, seed=2, num_workers=workers,
                            shard=(rank, 2))
        for epoch in range(2):
            got = list(loader)
            assert [loader.joint_rows(k) for k in range(len(got))] == [4, 1]
            for k, (g, w) in enumerate(zip(got, want[epoch])):
                rows = rank_rows(len(w["name"]), rank, 2)
                assert g["name"] == w["name"][rows]
                for key in ("image", "label"):
                    assert g[key].shape[1:] == w[key].shape[1:]
                    np.testing.assert_array_equal(g[key], w[key][rows])
        # rank 0: its 2 rows of each batch, and the 1-row batch's only row;
        # rank 1: its 2 rows, then the 1-row batch's row for the shapes
        assert len(data.loaded) == 2 * 3


def test_step_matches_jax_dp_mesh(world):
    """The 4-row two-rank step against JAX's train_step on a dp=2 mesh
    (its plain path, SGD at the same lr): the loss, the parameters after
    the update and the running statistics."""
    variables = jax_variables(MODEL, IMG, seed=0)
    model = jax_build_model(MODEL, img_size=IMG, use_fused=False)
    state = JaxTrainState.create(
        apply_fn=model.apply, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=joptim.sgd(LR))
    images, masks = blob_batch(4, IMG, seed=3)
    with kernel_mesh_scope():
        set_kernel_mesh(None)
        mesh = make_mesh(2, dp=2, sp=1, tp=1)
        new, metrics = jax.jit(jax_train_step)(
            shard_state(state, mesh),
            jax_shard_batch({"image": jnp.asarray(images),
                             "label": jnp.asarray(masks)}, mesh))
    want = {k: w for k, w in carried(MODEL, jax.tree_util.tree_map(
        np.asarray, {"params": new.params, "batch_stats": new.batch_stats}))
        .items() if w.dtype.is_floating_point}
    got = world.two[0]["steps"]["rows4"]
    jloss = float(metrics["loss"])
    assert abs(got["loss"] - jloss) <= 1e-5 + 1e-4 * abs(jloss)
    port = {**got["params"], **got["stats"]}
    runs = [{**r["params"], **r["stats"]}
            for r in [world.one["steps"]["rows4"]] + world.spread["rows4"]]
    assert set(port) == set(want)
    _held(port, want, runs, "state after the step")


def _log(direc):
    with open(direc / "train_log.jsonl") as f:
        return [json.loads(line) for line in f]


def test_cli_dp_joins_the_world(world):
    """``cli.train --dp 2`` in the world: one log, one checkpoint per saved
    epoch that loads strictly into a one-process model, the one-process
    run's files and loss."""
    dp2, dp1 = world.root / "dp2", world.root / "dp1"
    files = sorted(p.relative_to(dp1).as_posix() for p in dp1.rglob("*"))
    assert sorted(p.relative_to(dp2).as_posix()
                  for p in dp2.rglob("*")) == files
    (got,), (want,) = _log(dp2), _log(dp1)
    assert abs(got["loss"] - want["loss"]) <= 1e-5 + 1e-4 * abs(want["loss"])
    for key in ("val_f1", "val_iou"):
        assert np.isfinite(got[key])
    model = build_model(MODEL, img_size=IMG, use_fused=True, device="cpu")
    assert restore_checkpoint(str(dp2 / "0"), model) == 1
    sd = torch.load(dp2 / "0" / "ckpt.pth", weights_only=True)["state_dict"]
    assert not any(k.startswith("module.") for k in sd)


def test_one_card_checkpoint_restores_into_ddp_ranks(world):
    """The reverse: the one-process run's checkpoint restores strictly
    into each rank's DDP-wrapped model."""
    path = world.root / "dp1" / "final_model" / "ckpt.pth"
    want = torch.load(path, weights_only=True)["state_dict"]
    for rank in world.two:
        assert rank["restored_step"] == 1
        assert set(rank["restored"]) == set(want)
        for key, w in want.items():
            assert torch.equal(rank["restored"][key], w), key


def test_cli_spawns_one_rank_a_device(monkeypatch, tmp_path):
    """Outside a process group ``--dp 2`` spawns two ranks (gloo on the
    CPU) through ``run_data_parallel``; the ranks get the parsed config."""
    calls = []
    monkeypatch.setattr(cli_train, "run_data_parallel",
                        lambda fn, devices, backend, args: calls.append(
                            (fn, devices, backend, args)))
    argv = ["--train_dataset", str(tmp_path), "--dp", "2"]
    assert cli_train.main(argv, device="cpu") is None
    (fn, devices, backend, (cfg,)), = calls
    assert fn is cli_train._train_rank
    assert devices == ["cpu", "cpu"] and backend == "gloo" and cfg.dp == 2


def test_engine_replicas_match_one_replica(world):
    """Two CPU replicas, each half of every batch and of every tile batch,
    against one replica: the same masks, logits at 1e-5."""
    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8)
              for _ in range(3)]
    big = rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)
    engines = [InferenceEngine(MODEL, IMG, variables=world.before,
                               batch_size=4, device="cpu", **kw)
               for kw in ({}, {"devices": ["cpu", "cpu"]})]
    one, two = engines
    assert len(two.replicas) == 2 and two.replicas[1] is not two.model
    _close(two.logits(images), one.logits(images), "logits")
    for a, b in zip(two.predict_batch(images), one.predict_batch(images)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(two.predict(big), one.predict(big))


def test_engine_batch_must_divide_by_replicas(world):
    with pytest.raises(ValueError, match="must divide by the mesh 'data' "
                                         r"axis \(2\)"):
        InferenceEngine(MODEL, IMG, variables=world.before, batch_size=3,
                        devices=["cpu", "cpu"])


@pytest.mark.parametrize("argv, message", [
    (["--sp", "2"], "'The mesh's seq axis'"),
    (["--tp", "3"], "--tp 3 does not divide the 2 ranks"),
    (["--dp", "1", "--tp", "2", "--num_slices", "2"],
     r"data axis \(1\) must be a multiple of the slice count \(2\)")])
def test_mesh_axes_past_data_refused(argv, message, capsys, monkeypatch,
                                     tmp_path):
    """``--sp`` names the seq axis, not ported; ``--tp`` must divide a
    world of 2 (torchrun's variables), and ``--num_slices`` the data
    axis."""
    for key, value in (("WORLD_SIZE", "2"), ("RANK", "0"),
                       ("LOCAL_RANK", "0"), ("MASTER_ADDR", "127.0.0.1")):
        monkeypatch.setenv(key, value)
    with pytest.raises(SystemExit) as raised:
        cli_train.main(["--train_dataset", str(tmp_path), *argv],
                       device="cpu")
    assert re.search(message, str(raised.value.code) + capsys
                     .readouterr().err)


@pytest.mark.parametrize("cli", ["train", "serve"])
def test_dp_past_visible_cards_refused(cli, tmp_path):
    n = torch.cuda.device_count() + 2     # --dp 1 runs anywhere
    argv = ["--train_dataset" if cli == "train" else "--loaddirec",
            str(tmp_path), "--dp", str(n)]
    main = cli_train.main if cli == "train" else cli_serve.main
    with pytest.raises(SystemExit, match=f"--dp {n} but only {n - 2} "
                                         "devices visible"):
        main(argv)
