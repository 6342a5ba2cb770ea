"""The port's batch-1 evaluation path against the JAX package, on the CPU.

* The eval core: the plain ``axial_attention_fused`` against the Pallas
  ``axial_attention_fused`` (interpret mode, as tests/test_pallas.py runs
  it) at the five MedT-128 batch-1 geometries, atol 1e-5; the fold
  (``fused_eval_attention``) against JAX's for full, gated and wopos with
  drifted running statistics and gates.
* The route: which core each attention site of MedT-128 runs at batch 1 and
  at batch 16 equals what JAX's ``kernel_registry`` records.
* Batch-1 eval forwards of MedT 128 and gatedaxialunet 64 through the eval
  route, on weights carried from a JAX variable tree: logits at atol 2e-4
  (the float32 summation-order noise of some hundred layers).
* The test and predict CLIs, JAX's on an orbax checkpoint and the port's on
  the exported ``.pth``, over one PNG set: mean F1 and IoU within 1e-3,
  masks equal wherever JAX's logit margin exceeds 1e-3.
"""
import collections
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medt_tpu.data.synthetic import make_png_dataset
from medt_tpu.models import build_model as jax_build_model
from medt_tpu.ops import kernel_registry
from medt_tpu.ops import pallas_axial as jeval
from medt_tpu_torch.models import build_model
from medt_tpu_torch.ops import axial_eval
from medt_tpu_torch.ops.attn_core import pack_sim_affine
from medt_tpu_torch.ops.axial_attention import AxialAttention, fused_route
from medt_tpu_torch.utils import weights
from test_torch_port_models import carried, jax_variables

G = 8
# MedT-128 at batch 1: (span, gp, stripes, has_pos) of the eval sites
MEDT_B1_EVAL = [(4, 8, 64, False), (4, 16, 64, False), (32, 4, 32, True),
                (64, 2, 64, True), (64, 4, 64, True)]
# the route table of one MedT-128 batch-1 forward: sites per geometry
MEDT_B1_ROUTES = {
    ("eval", 4, 8, 64, False): 6, ("eval", 4, 16, 64, False): 2,
    ("eval", 32, 4, 32, True): 2, ("eval", 64, 2, 64, True): 2,
    ("eval", 64, 4, 64, True): 2,
    ("lanes", 8, 4, 128, False): 2, ("lanes", 8, 8, 128, False): 2,
    ("lanes", 16, 2, 256, False): 2, ("lanes", 16, 4, 256, False): 2,
}


def _core_operands(seed, gp, L, S, has_pos):
    rng = np.random.default_rng(seed)
    c = gp // 2
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(  # noqa
        np.float32)
    q, k, v = f(S, G, c, L), f(S, G, c, L), f(S, G, gp, L)
    if has_pos:
        tables = [f(c, L, L, scale=gp ** -0.5), f(c, L, L, scale=gp ** -0.5),
                  f(gp, L, L, scale=gp ** -0.5)]
        a, b = rng.uniform(0.5, 1.5, (3, G)), f(3, G, scale=0.1)
        aff = pack_sim_affine(G, torch.from_numpy(a), torch.from_numpy(b),
                              "full").numpy()
        oa = rng.uniform(0.5, 1.5, (G, 4, gp)).astype(np.float32)
    else:  # the Pallas contract: zero tables and zero position affines
        tables = [np.zeros((c, L, L), np.float32),
                  np.zeros((c, L, L), np.float32),
                  np.zeros((gp, L, L), np.float32)]
        aff = pack_sim_affine(G, torch.from_numpy(rng.uniform(0.5, 1.5, G)),
                              torch.from_numpy(f(G, scale=0.1)),
                              "wopos").numpy()
        oa = rng.uniform(0.5, 1.5, (G, 4, gp)).astype(np.float32)
        oa[:, 2:] = 0.0
    return [q, k, v] + tables + [aff.astype(np.float32), oa]


@pytest.mark.parametrize("L,gp,S,has_pos", MEDT_B1_EVAL)
def test_plain_eval_core_matches_pallas(L, gp, S, has_pos):
    ops = _core_operands(30 + L + gp, gp, L, S, has_pos)
    want = np.asarray(jeval.axial_attention_fused(*map(jnp.asarray, ops)))
    t = [torch.from_numpy(a) for a in ops]
    got = axial_eval.axial_attention_fused(*t)
    assert got.shape == (S, G, gp, L)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if not has_pos:  # zero-size tables skip the position terms: same result
        empty = torch.zeros((0, L, L))
        got = axial_eval.axial_attention_fused(*t[:3], empty, empty, empty,
                                               *t[6:])
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _bn(rng, shape):
    """Non-trivial (scale, bias, running mean, running var)."""
    return (rng.uniform(0.5, 1.5, shape).astype(np.float32),
            (0.1 * rng.normal(size=shape)).astype(np.float32),
            (0.2 * rng.normal(size=shape)).astype(np.float32),
            rng.uniform(0.5, 2.0, shape).astype(np.float32))


@pytest.mark.parametrize("mode", ["full", "gated", "wopos"])
def test_fused_eval_attention_fold_matches_jax(mode):
    rng = np.random.default_rng(40)
    S, L, gp = 12, 16, 4
    x = rng.normal(size=(S, L, G, 2 * gp)).astype(np.float32)
    pos = mode != "wopos"
    relative = (rng.normal(size=(2 * gp, 2 * L - 1)) / 2).astype(
        np.float32) if pos else None
    sim = _bn(rng, (3, G) if pos else (G,))
    out = _bn(rng, (G, gp, 2) if pos else (G, gp))
    gates = (0.7, -0.3, 1.9, 0.2)
    want = jeval.fused_eval_attention(
        jnp.asarray(x), None if relative is None else jnp.asarray(relative),
        *map(jnp.asarray, sim + out), gp=gp, span=L, mode=mode, gates=gates)
    want = np.asarray(want).transpose(0, 2, 3, 1)      # -> (S, g, gp, L)
    got = axial_eval.fused_eval_attention(
        torch.from_numpy(x.transpose(0, 2, 3, 1).copy()),
        None if relative is None else torch.from_numpy(relative),
        *map(torch.from_numpy, sim + out), gp=gp, span=L, mode=mode,
        gates=tuple(torch.tensor(v) for v in gates))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_eval_core_has_no_backward():
    ops = [torch.from_numpy(a) for a in _core_operands(41, 4, 8, 6, True)]
    ops[0].requires_grad_()
    out = axial_eval.axial_attention_fused(*ops)
    with pytest.raises(RuntimeError, match="eval-only"):
        out.sum().backward()


def test_fused_route_rule():
    assert fused_route(64, 64, training=False) == "eval"
    assert fused_route(64, 127, training=False) == "eval"
    assert fused_route(64, 128, training=False) == "flash"
    assert fused_route(16, 16, training=False) == "eval"
    assert fused_route(16, 256, training=False) == "lanes"
    assert fused_route(64, 64, training=True) == "flash"
    assert fused_route(8, 64, training=True) == "lanes"


# ---- routes: the port's sites against JAX's kernel_registry -------------------

def _jax_routes(batch, monkeypatch):
    """(family, span, g, gp, S, has_pos) of every kernel site of a
    MedT-128 eval forward (eval_shape: no compute)."""
    sites = []
    monkeypatch.setattr(
        kernel_registry, "record",
        lambda family, **kw: sites.append(
            (family, kw["span"], kw["g"], kw["gp"], kw["S"], kw["has_pos"])))
    model = jax_build_model("MedT", img_size=128, use_fused=True)
    x = jax.ShapeDtypeStruct((batch, 128, 128, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x, train=False), x)
    jax.eval_shape(lambda v, x: model.apply(v, x, train=False), shapes, x)
    return sites


def _routes(model):
    """``last_route`` of every attention site of ``model`` (each runs once
    per eval forward)."""
    return [m.last_route for m in model.modules()
            if isinstance(m, AxialAttention)]


def _port_routes(batch):
    """The port's sites on the meta device (shapes only; the plain cores,
    since the route does not depend on them)."""
    model = build_model("MedT", img_size=128, use_fused=True,
                        plain_cores=True, device="meta")
    with torch.no_grad():
        model(torch.zeros((batch, 3, 128, 128), device="meta"))
    return _routes(model)


def test_medt128_batch1_routes_are_the_table():
    counts = collections.Counter((r, L, gp, S, pos)
                                 for r, L, g, gp, S, pos in _port_routes(1))
    assert counts == MEDT_B1_ROUTES


@pytest.mark.parametrize("batch", [1, 16])
def test_medt128_routes_match_jax_registry(batch, monkeypatch):
    port = collections.Counter(_port_routes(batch))
    jax_sites = collections.Counter(_jax_routes(batch, monkeypatch))
    assert sum(port.values()) == 22
    assert port == jax_sites
    if batch == 16:
        assert not any(r == "eval" for r, *_ in port)


# ---- whole models at batch 1 ---------------------------------------------------

@pytest.mark.parametrize("name,img", [("MedT", 128), ("gatedaxialunet", 64)])
def test_batch1_eval_forward_matches_jax(name, img):
    variables = jax_variables(name, img, seed=50)
    x = np.random.default_rng(51).uniform(size=(1, img, img, 3)) \
        .astype(np.float32)
    jmodel = jax_build_model(name, img_size=img, use_fused=True)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(x))).transpose(0, 3, 1, 2)
    model = build_model(name, img_size=img, use_fused=True, device="cpu")
    model.load_state_dict(carried(name, variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert any(r == "eval" for r, *_ in _routes(model))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


# ---- the CLIs, JAX vs port --------------------------------------------------------

CLI_MODEL, CLI_IMG = "gatedaxialunet", 32


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """A PNG set, unlabelled images of three sizes, random JAX weights in an
    orbax checkpoint and the same weights as a reference ``.pth``."""
    from medt_tpu.config import parse_config as jax_parse_config
    from medt_tpu.training.checkpointing import save_checkpoint
    from medt_tpu.training.trainer import setup_state
    from medt_tpu_torch.data import write_png

    root = tmp_path_factory.mktemp("cli")
    data = make_png_dataset(str(root / "set"), n=4, img_size=CLI_IMG, seed=8)
    rng = np.random.default_rng(9)
    os.makedirs(root / "un" / "img")
    for name, shape in (("a.png", (32, 32)), ("b.png", (56, 40)),
                        ("c.png", (24, 20))):
        write_png(str(root / "un" / "img" / name),
                  rng.integers(0, 256, shape + (3,), dtype=np.uint8))
    variables = jax_variables(CLI_MODEL, CLI_IMG, seed=52)
    cfg = jax_parse_config(["--modelname", CLI_MODEL, "--imgsize",
                            str(CLI_IMG)])
    state = setup_state(cfg, steps_per_epoch=1)
    state = state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]))
    save_checkpoint(str(root / "jax_ckpt"), 0, state)
    sd = weights.export_for_model(CLI_MODEL, variables["params"],
                                  variables["batch_stats"])
    torch.save({f"module.{k}": torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, str(root / "ref.pth"))
    return root, data, variables


@functools.partial(jax.jit, static_argnums=())
def _jax_forward(variables, x):
    model = jax_build_model(CLI_MODEL, img_size=CLI_IMG, use_fused=True)
    return model.apply(variables, x, train=False)


def _cli_args(data, ckpt, out):
    return ["--val_dataset", data, "--modelname", CLI_MODEL, "--imgsize",
            str(CLI_IMG), "--loaddirec", ckpt, "--direc", out, "--workers",
            "0", "--pred_mode", "argmax"]


def _jax_margin(variables, image):
    """|logit1 - logit0| of JAX's model on one (H, W, C) image: at batch 1
    for the model's size, else through JAX's sliding window as its predict
    CLI runs it."""
    from medt_tpu.evaluation.sliding_window import sliding_window_inference

    fwd = functools.partial(_jax_forward, variables)
    x = jnp.asarray(image, jnp.float32)
    if image.shape[:2] == (CLI_IMG, CLI_IMG):
        logits = fwd(x[None])[0]
    else:
        logits = sliding_window_inference(x, fwd, window=CLI_IMG,
                                          stride=CLI_IMG // 2)
    return np.abs(np.asarray(logits[..., 1] - logits[..., 0]))


def test_test_cli_matches_jax(cli_setup):
    from medt_tpu.cli import test as jax_test
    from medt_tpu_torch.cli import test as port_test
    from medt_tpu_torch.data import ImageToImage2D, read_png

    root, data, variables = cli_setup
    jax_test.main(_cli_args(data, str(root / "jax_ckpt" / "final_model"),
                            str(root / "jax_test")))
    result = port_test.main(_cli_args(data, str(root / "ref.pth"),
                                      str(root / "port_test")), device="cpu")
    want = json.loads((root / "jax_test" / "metrics.json").read_text())
    got = json.loads((root / "port_test" / "metrics.json").read_text())
    assert set(got) == set(want) and got["images"] == want["images"] == 4
    assert len(result["per_image_ms"]) == 4
    assert abs(got["mean_f1"] - want["mean_f1"]) <= 1e-3
    assert abs(got["mean_iou"] - want["mean_iou"]) <= 1e-3
    assert 0.0 < got["mean_f1"] < 1.0              # the masks are not trivial
    ds = ImageToImage2D(data)
    for i in range(len(ds)):
        image, _, name = ds[i]
        sure = _jax_margin(variables, image) > 1e-3
        g = read_png(str(root / "port_test" / name), gray=True)
        w = read_png(str(root / "jax_test" / name), gray=True)
        np.testing.assert_array_equal(g[sure], w[sure])


def test_predict_cli_matches_jax(cli_setup):
    """Masks of an image of the model's size (batch 1), a larger and a
    smaller one (the window route, stride half the window). JAX's predict
    CLI runs with ``--use_pallas no``: on the CPU its fused path, jitted
    with the variables closed over as constants (how that CLI builds its
    forward), gives logits up to 4.3 away from the same model with the
    variables passed as arguments (eval_step, and the margins here), while
    its plain path does not; the port runs its fused path."""
    from medt_tpu.cli import predict as jax_predict
    from medt_tpu_torch.cli import predict as port_predict
    from medt_tpu_torch.data import read_png

    root, _, variables = cli_setup
    un = str(root / "un")
    jax_predict.main(_cli_args(un, str(root / "jax_ckpt" / "final_model"),
                               str(root / "jax_pred"))
                     + ["--use_pallas", "no"])
    written = port_predict.main(_cli_args(un, str(root / "ref.pth"),
                                          str(root / "port_pred")),
                                device="cpu")
    assert written == [("a.png", (32, 32)), ("b.png", (56, 40)),
                       ("c.png", (24, 20))]
    for name, shape in written:
        g = read_png(str(root / "port_pred" / name), gray=True)
        w = read_png(str(root / "jax_pred" / name), gray=True)
        assert g.shape == w.shape == shape
        image = read_png(str(root / "un" / "img" / name)) / 255.0
        sure = _jax_margin(variables, image.astype(np.float32)) > 1e-3
        assert sure.mean() > 0.9, (name, sure.mean())
        np.testing.assert_array_equal(g[sure], w[sure], err_msg=name)
