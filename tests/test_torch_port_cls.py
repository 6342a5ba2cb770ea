"""The port's classification harness against the JAX package, on CPU.

Inputs are made with numpy from a seed; weights are random values on the
JAX variable trees, carried by ``utils.weights.export_for_model`` and
loaded with ``load_state_dict(strict=True)``. What is held:

* axial26s at ``img_size=32``, s = 0.25, 10 classes, batch 2 (group planes
  4 to 32; spans 8, 8, 4, 2): the port with ``use_fused=False`` and with
  ``use_fused=True, plain_cores=True`` (the kernels' plain versions)
  against JAX ``use_fused=False``: eval logits at atol 1e-4; in train mode
  the label-smoothed loss, the input gradient and every parameter
  gradient at rtol 1e-3 / atol 1e-5, and every BN running statistic after
  the step at rtol 1e-5; each train-mode tensor also within 4 times the
  port's own spread under a 1e-6 relative input perturbation (the
  conditioning term of tests/test_torch_port_training.py);
* ``AxialAttention`` alone at gp 32 and 64 (out_planes 256 and 512, 8
  groups, spans 8 and 14) in eval and train mode against JAX's module,
  outputs at atol 1e-4, gradients at rtol 1e-3 / atol 1e-5; and the JAX
  Pallas ``lanes_attn_core`` at gp 32 (interpret mode) against the port's
  plain twin;
* resnet18 and resnet26 at 32 px: one train step's logits, loss, input and
  parameter gradients and running statistics; the three extractors (the
  dilated ResNet and the DenseNet at reduced depth, SqueezeNet) at 32 px:
  features and shallow features at output stride 8; every registry entry
  at full depth loading its JAX tree with strict=True;
* the classification losses, ``Metric`` and ``MetricList``;
* ``builders.build_model``, ``build_dataloader`` and ``build_optimizer``
  (one SGD step against JAX's optax ``sgd`` with L2 weight decay);
* ``cli.train_cls.main(..., device="cpu")`` for one epoch of resnet18 at
  32 px: a finite loss, a ``val_acc`` and a checkpoint.

JAX's functions are jitted once per model (each compile takes seconds).
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import _torch_threads  # noqa: F401  (one PyTorch thread)

from medt_tpu import losses as jlosses
from medt_tpu import metrics as jmetrics
from medt_tpu.models import classifiers as jcls
from medt_tpu.models import extractors as jext
from medt_tpu.models import resnet as jresnet
from medt_tpu.ops.axial_attention import AxialAttention as JaxAxialAttention
from medt_tpu.ops.pallas_axial_lanes import lanes_attn_core as jax_lanes
from medt_tpu.training import optimizers as joptim
from medt_tpu_torch import builders, losses, metrics
from medt_tpu_torch.cli import train_cls
from medt_tpu_torch.models import classifiers, extractors, resnet
from medt_tpu_torch.ops import AxialAttention, axial_lanes
from medt_tpu_torch.utils import weights
from test_torch_port_cls_data import write_image_folder
from test_torch_port_ops import random_variables

SMOOTHING = 0.1
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5
# the train-mode comparisons also allow NOISE_FACTOR times the port's own
# change when its input is perturbed by INPUT_NOISE (relative), as
# tests/test_torch_port_training.py does: at 32 px and batch 2 every
# train-mode BN renormalises over few values (layer 4's over 2), and one
# unit in the last place of the input moves the loss by ~1e-4 relative
INPUT_NOISE, NOISE_FACTOR = 1e-6, 4.0


def _np(t):
    return t.detach().cpu().numpy()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def variables_of(model, x, seed):
    shapes = jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x, train=False), x)
    return random_variables(shapes, seed)


def carried(name, tree, stats=None):
    """A JAX params (and batch_stats) tree as the port's state dict."""
    return weights.to_state_dict(
        weights.export_for_model(name, tree, stats or {}))


def jax_run(model, variables, x, labels, eval_mode=True):
    """Logits (eval mode, or with ``eval_mode=False`` the train-mode
    forward's), and the train-mode loss (label-smoothed), its gradients in
    the parameters and the input, and the new batch stats."""
    def loss_fn(params, x):
        logits, mut = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x,
            train=True, mutable=["batch_stats"])
        return jlosses.cross_entropy_with_label_smoothing(
            logits, labels, SMOOTHING), (logits, mut["batch_stats"])

    @jax.jit
    def run(variables, x):
        (loss, (logits, stats)), grads = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(variables["params"], x)
        if eval_mode:
            logits = model.apply(variables, x, train=False)
        return logits, loss, grads, stats

    logits, loss, (gparams, gx), stats = run(variables, jnp.asarray(x))
    return (np.asarray(logits), float(loss), gparams,
            np.asarray(gx).transpose(0, 3, 1, 2), stats)


def port_eval(model, x):
    with torch.no_grad():
        return _np(model.eval()(_nchw(x)))


def port_train(make_model, x, labels):
    """One train-mode forward and backward of a fresh model on ``x`` and on
    two copies of ``x`` perturbed by INPUT_NOISE (relative): for each run
    ``{"loss", "input", "grad.<param>", "stat.<buffer>"}`` as numpy."""
    rng = np.random.default_rng(9)
    runs = []
    for k in range(3):
        xi = x if k == 0 else (x * (1.0 + INPUT_NOISE * rng.standard_normal(
            x.shape))).astype(np.float32)
        model = make_model().train()
        xt = _nchw(xi).requires_grad_(True)
        logits = model(xt)
        loss = losses.cross_entropy_with_label_smoothing(
            logits, torch.from_numpy(labels), SMOOTHING)
        loss.backward()
        run = {"logits": _np(logits), "loss": np.float32(loss.item()),
               "input": _np(xt.grad)}
        run.update({f"grad.{n}": _np(p.grad)
                    for n, p in model.named_parameters() if p.requires_grad})
        run.update({f"stat.{n}": _np(b) for n, b in model.named_buffers()
                    if n.endswith(("running_mean", "running_var"))})
        runs.append(run)
    return runs


def held(runs, key, want, rtol, atol):
    """``runs[0][key]`` against ``want`` at ``rtol`` and ``atol`` plus
    NOISE_FACTOR times the port's own spread over the runs."""
    vals = [r[key] for r in runs]
    noise = max(float(np.abs(a - b).max()) for i, a in enumerate(vals)
                for b in vals[i + 1:])
    np.testing.assert_allclose(vals[0], want, rtol=rtol,
                               atol=atol + NOISE_FACTOR * noise, err_msg=key)


def assert_step(runs, name, loss, gx, gparams, stats):
    """The train-mode step of ``runs`` against JAX's: the loss, the input
    gradient, every parameter gradient, every running statistic."""
    held(runs, "loss", np.float32(loss), 1e-5, 0.0)
    held(runs, "input", gx, GRAD_RTOL, GRAD_ATOL)
    grads = weights.export_state_dict(jax.tree_util.tree_map(
        np.asarray, gparams), {})
    grads = {k: v for k, v in grads.items()
             if not k.endswith("flatten_index")}
    assert {f"grad.{k}" for k in grads} == {k for k in runs[0]
                                           if k.startswith("grad.")}
    for k, w in grads.items():
        held(runs, f"grad.{k}", w, GRAD_RTOL, GRAD_ATOL)
    want = weights.export_state_dict({}, jax.tree_util.tree_map(
        np.asarray, stats))
    assert {f"stat.{k}" for k in want} == {k for k in runs[0]
                                          if k.startswith("stat.")}
    for k, w in want.items():
        held(runs, f"stat.{k}", w, 1e-5, 1e-7)


# ---- axial26s ---------------------------------------------------------------

@pytest.fixture(scope="module")
def axial26s_jax():
    model = jcls.axial26s(img_size=32, s=0.25, num_classes=10)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    labels = np.array([3, 8], np.int64)
    variables = variables_of(model, x, seed=2)
    return variables, x, labels, jax_run(model, variables, x, labels)


@pytest.mark.parametrize("fused", [False, True])
def test_axial26s_matches_jax(axial26s_jax, fused):
    """Eval logits, the train-mode loss, input and parameter gradients and
    the running statistics after the step; the fused path on the kernels'
    plain versions visits the eval route (eval) and the lanes route (train)
    at gp 4 to 32."""
    variables, x, labels, (logits, loss, gparams, gx, stats) = axial26s_jax
    sd = carried("axial26s", variables["params"], variables["batch_stats"])

    def make():
        model = classifiers.axial26s(img_size=32, s=0.25, num_classes=10,
                                     use_fused=fused, plain_cores=fused,
                                     device="cpu")
        model.load_state_dict(sd, strict=True)
        return model

    model = make()
    np.testing.assert_allclose(port_eval(model, x), logits, atol=1e-4,
                               rtol=0)
    if fused:
        gps = {m.gp for m in model.modules()
               if isinstance(m, AxialAttention)}
        routes = {m.last_route[0] for m in model.modules()
                  if isinstance(m, AxialAttention)}
        assert gps == {4, 8, 16, 32} and routes == {"eval"}
    assert_step(port_train(make, x, labels), "axial26s", loss, gx, gparams,
                stats)


# ---- AxialAttention at gp 32 and 64 -------------------------------------------

@pytest.mark.parametrize("out_planes,span,m", [(256, 8, 16), (512, 14, 9)])
def test_axial_attention_wide_gp_matches_jax(out_planes, span, m):
    """gp 32 and 64: eval output, and in train mode the output, the input
    gradient and every parameter gradient (with the spread term of
    ``held``: a gradient summed over thousands of terms, such as
    bn_qkv.weight's, carries float32 rounding of its largest terms),
    against JAX's module (plain attention); the port's fused path runs the
    kernels' plain versions (eval route: 2 x m stripes under 128; train:
    lanes)."""
    cin, n = 16, 2
    rng = np.random.default_rng(out_planes)
    x = rng.normal(size=(n, span, m, cin)).astype(np.float32)
    kw = dict(in_planes=cin, out_planes=out_planes, span=span, groups=8,
              axis="h", mode="full")
    jop = JaxAxialAttention(use_fused=False, **kw)
    variables = variables_of(jop, x, seed=out_planes + 1)
    dy = rng.normal(size=(n, span, m, out_planes)).astype(np.float32)

    @jax.jit
    def run(variables, x):
        out = jop.apply(variables, x, train=False)

        def f(params, x):
            y, mut = jop.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               x, train=True, mutable=["batch_stats"])
            return jnp.sum(y * dy), y
        (_, y), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            variables["params"], x)
        return out, y, grads

    out, y, (gparams, gx) = run(variables, jnp.asarray(x))
    sd = weights.to_state_dict(weights.export_state_dict(
        variables["params"], variables["batch_stats"]))
    for fused in (True, False):
        top = AxialAttention(cin, out_planes, span, groups=8, axis="h",
                             mode="full", use_fused=fused, device="cpu")
        top.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got = top.eval()(_nchw(x))
        np.testing.assert_allclose(_np(got).transpose(0, 2, 3, 1),
                                   np.asarray(out), atol=1e-4, rtol=0)
        if fused:
            assert top.last_route[0] == "eval" and top.gp == out_planes // 8
        runs = []
        for k in range(3):    # the input, then two perturbed copies
            xi = x if k == 0 else (x * (1.0 + INPUT_NOISE * rng.standard_normal(
                x.shape))).astype(np.float32)
            top.load_state_dict(sd, strict=True)
            top.zero_grad(set_to_none=True)
            xt = _nchw(xi).requires_grad_(True)
            got = top.train()(xt)
            (got * _nchw(dy)).sum().backward()
            runs.append({"out": _np(got).transpose(0, 2, 3, 1),
                         "input": _np(xt.grad),
                         **{f"grad.{n}": _np(p.grad)
                            for n, p in top.named_parameters()
                            if p.requires_grad}})
        if fused:
            assert top.last_route[0] == "lanes"
        held(runs, "out", np.asarray(y), 0.0, 1e-4)
        held(runs, "input", np.asarray(gx).transpose(0, 3, 1, 2), GRAD_RTOL,
             GRAD_ATOL)
        want = weights.export_state_dict(
            jax.tree_util.tree_map(np.asarray, gparams), {})
        for k in runs[0]:
            if k.startswith("grad."):
                held(runs, k, want[k[len("grad."):]], GRAD_RTOL, GRAD_ATOL)


def test_lanes_core_gp32_matches_pallas_interpret():
    """The JAX Pallas ``lanes_attn_core`` at gp 32 (interpret mode, with
    positions) against the port's plain twin of the lanes kernel, sv and
    sve at atol 1e-5."""
    rng = np.random.default_rng(50)
    g, gp, L, S, c = 1, 32, 4, 128, 16

    def t(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    args = [t(g, 2 * gp, L, S), t(c, L, L, scale=0.2), t(c, L, L, scale=0.2),
            t(gp, L, L, scale=0.2),
            np.abs(t(g, 8)) * np.array([1, 0, 1, 0, 1, 0, 0, 0], np.float32)]
    want = jax_lanes(*map(jnp.asarray, args))
    got = axial_lanes.lanes_attn_plain(*map(torch.from_numpy, args))
    for o, w in zip(got, want):
        np.testing.assert_allclose(_np(o), np.asarray(w), atol=1e-5, rtol=0)


# ---- ResNets and extractors ---------------------------------------------------

@pytest.mark.parametrize("name", ["resnet18", "resnet26"])
def test_resnet_matches_jax(name):
    """One train step: the train-mode forward's logits (atol 1e-4), the
    loss, the input and parameter gradients and the running statistics."""
    jmodel = getattr(jresnet, name)(num_classes=10)
    rng = np.random.default_rng(60)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    labels = np.array([1, 9], np.int64)
    variables = variables_of(jmodel, x, seed=61)
    logits, loss, gparams, gx, stats = jax_run(jmodel, variables, x, labels,
                                               eval_mode=False)
    sd = carried(name, variables["params"], variables["batch_stats"])

    def make():
        model = getattr(resnet, name)(num_classes=10, device="cpu")
        model.load_state_dict(sd, strict=True)
        return model

    runs = port_train(make, x, labels)
    held(runs, "logits", logits, 0.0, 1e-4)
    assert_step(runs, name, loss, gx, gparams, stats)


# the extractors at reduced depth: the same modules as the registry's
EXTRACTOR_CASES = {
    "dilated": (lambda: jext.DilatedResNet(layers=(1, 1, 1, 1)),
                lambda: extractors.DilatedResNet((1, 1, 1, 1), device="cpu")),
    "squeezenet": (jext.SqueezeNetExtractor,
                   lambda: extractors.SqueezeNetExtractor(device="cpu")),
    "densenet": (lambda: jext.DenseNetExtractor(block_config=(2, 2, 2, 2),
                                                growth=8),
                 lambda: extractors.DenseNetExtractor((2, 2, 2, 2), 8,
                                                      device="cpu")),
}


@pytest.mark.parametrize("name", sorted(EXTRACTOR_CASES))
def test_extractor_matches_jax(name):
    """Features and shallow features in eval mode at 32 px (output stride
    8: a 4 x 4 map), atol 1e-4; the dilated ResNet and the DenseNet at
    reduced depth (one block a stage; 2 layers a block, growth 8)."""
    make_jax, make_port = EXTRACTOR_CASES[name]
    jmodel = make_jax()
    x = np.random.default_rng(70).normal(size=(1, 32, 32, 3)).astype(
        np.float32)
    variables = variables_of(jmodel, x, seed=71)
    feats, shallow = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    model = make_port().eval()
    model.load_state_dict(carried(name, variables["params"],
                                  variables.get("batch_stats", {})),
                          strict=True)
    with torch.no_grad():
        got_feats, got_shallow = model(_nchw(x))
    assert got_feats.shape[2:] == (4, 4)
    for got, want in ((got_feats, feats), (got_shallow, shallow)):
        np.testing.assert_allclose(_np(got), np.asarray(want).transpose(
            0, 3, 1, 2), atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["resnet50_dilated", "squeezenet",
                                  "densenet"])
def test_extractor_registry_loads_jax_trees(name):
    """A registry entry of each class at its full depth loads the JAX
    tree's state dict with strict=True (shapes included); the registry
    names JAX's four extractors."""
    assert set(extractors.EXTRACTOR_REGISTRY) == set(jext.EXTRACTOR_REGISTRY)
    x = np.zeros((1, 32, 32, 3), np.float32)
    variables = variables_of(jext.EXTRACTOR_REGISTRY[name](), x, seed=72)
    model = extractors.EXTRACTOR_REGISTRY[name](device="cpu")
    model.load_state_dict(carried(name, variables["params"],
                                  variables.get("batch_stats", {})),
                          strict=True)


# ---- losses, metrics ------------------------------------------------------------

def test_losses_and_metrics_match_jax():
    rng = np.random.default_rng(80)
    logits = rng.normal(size=(6, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, 6)
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
    for eta in (0.0, 0.1, 0.3):
        np.testing.assert_allclose(
            _np(losses.label_smoothing(lt, yt, eta)),
            np.asarray(jlosses.label_smoothing(jnp.asarray(logits),
                                               jnp.asarray(labels), eta)),
            rtol=1e-6)
        np.testing.assert_allclose(
            float(losses.cross_entropy_with_label_smoothing(lt, yt, eta)),
            float(jlosses.cross_entropy_with_label_smoothing(
                jnp.asarray(logits), jnp.asarray(labels), eta)), rtol=1e-6)
    target = rng.uniform(size=(6, 5)).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.cross_entropy_for_onehot(lt, torch.from_numpy(target))),
        float(jlosses.cross_entropy_for_onehot(jnp.asarray(logits),
                                               jnp.asarray(target))),
        rtol=1e-6)
    port, ref = metrics.Metric(), jmetrics.Metric()
    assert port.average == ref.average == 0.0
    for v, n in ((0.5, 2), (torch.tensor(0.25), 4), (1.0, 1)):
        port.update(v, n)
        ref.update(float(v), n)
    assert port.average == pytest.approx(ref.average) and port.count == 7
    fns = {"sum": lambda o, y: float(o.sum() - y.sum()),
           "n": lambda o, y: 1.0}
    port_l, ref_l = metrics.MetricList(fns), jmetrics.MetricList(fns)
    for i in range(3):
        o, y = np.full(4, i, np.float32), np.ones(4, np.float32)
        port_l(o, y)
        ref_l(o, y)
    assert port_l.get_results() == ref_l.get_results()
    assert port_l.get_results(normalize=3) == ref_l.get_results(normalize=3)
    port_l.reset()
    assert port_l.get_results() == {"sum": 0.0, "n": 0.0}


# ---- builders and the CLI ---------------------------------------------------------

def test_build_model_resolves_classifiers_then_segmentation():
    """Classifiers by name with num_classes alone (the axial ones at their
    224 px span schedule, as JAX's builder), then the segmentation
    registry; an unknown name raises KeyError; ``device=None`` without a
    card raises instead of running on the CPU."""
    a = argparse.Namespace
    m = builders.build_model(a(model="resnet18", num_classes=7),
                             device="cpu")
    assert not m.training and m.fc.out_features == 7
    ax = builders.build_model(a(model="axial50m", num_classes=3,
                                imgsize=32), device="cpu", use_fused=True)
    spans = sorted({blk.span for blk in ax.modules()
                    if isinstance(blk, AxialAttention)})
    assert spans == [7, 14, 28, 56] and ax.fc.out_features == 3
    gps = sorted({blk.gp for blk in ax.modules()
                  if isinstance(blk, AxialAttention)})
    assert gps == [12, 24, 48, 96]      # s 0.75: each on the wide kernels
    for gp in gps:
        axial_lanes.check_gp("axial50m", gp)
    seg = builders.build_model(a(modelname="axialunet", imgsize=32),
                               device="cpu")
    assert type(seg).__name__ == "ResAxialAttentionUNet"
    with pytest.raises(KeyError):
        builders.build_model(a(model="vgg16"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            builders.build_model(a(model="resnet18", num_classes=2))


def test_build_dataloader_and_its_shard(tmp_path):
    root = write_image_folder(tmp_path, per_class=3, size=(20, 24))
    args = argparse.Namespace(train_dataset=root, val_dataset=root,
                              imgsize=16, batch_size=4, workers=0)
    train, val = builders.build_dataloader(args)
    assert len(train.dataset) == len(val.dataset) == 6
    batch = next(iter(val))
    assert batch["image"].shape == (4, 16, 16, 3)
    assert list(batch["label"]) == [0, 0, 0, 1]
    args.distributed = True
    with pytest.raises(RuntimeError, match="process group"):
        builders.build_dataloader(args)


def test_build_optimizer_sgd_step_matches_optax():
    """One SGD step (momentum 0.9, L2 1e-4, lr 0.1) and a second one (the
    momentum trace) against JAX's optax sgd; Adam-L2 by name."""
    rng = np.random.default_rng(90)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(2)]
    args = argparse.Namespace(optimizer="sgd", lr=0.1, momentum=0.9,
                              weight_decay=1e-4)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = builders.build_optimizer(args, [param])
    tx = joptim.sgd(0.1, momentum=0.9, weight_decay=1e-4)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    for g in grads:
        param.grad = torch.from_numpy(g.copy())
        opt.step()
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        np.testing.assert_allclose(_np(param), np.asarray(jp), rtol=1e-6,
                                   atol=1e-7)
    args.optimizer = "adam"
    assert isinstance(builders.build_optimizer(args, [param]),
                      torch.optim.Adam)


def test_train_cls_cli_one_epoch_on_cpu(tmp_path):
    root = write_image_folder(tmp_path / "data", per_class=4, size=(40, 48))
    out = tmp_path / "out"
    state = train_cls.main(
        ["--model", "resnet18", "--num_classes", "2", "--imgsize", "32",
         "--epochs", "1", "-b", "4", "--train_dataset", root,
         "--val_dataset", root, "--work_dirs", str(out), "-j", "2",
         "--label_smoothing", "0.1"], device="cpu")
    assert state.step == 2
    log = [json.loads(line) for line in
           (out / "train_log.jsonl").read_text().splitlines()]
    assert len(log) == 1 and np.isfinite(log[0]["loss"])
    assert 0.0 <= log[0]["val_acc"] <= 1.0
    assert (out / "0" / "ckpt.pth").is_file()
    assert (out / "final_model" / "ckpt.pth").is_file()
