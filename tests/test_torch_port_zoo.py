"""The port's segmentation zoo against the JAX package, on the CPU.

* Each of the eight zoo models (gated_sig, gated_data, convnet_ablation,
  mix_net_gated_d, axialunet_wopos, unetplusplus, shallow, autoencoder)
  loads weights carried from a JAX variable tree with
  ``load_state_dict(strict=True)`` and gives JAX's eval output at 32 px,
  batch 2 (mix_net_gated_d at 64 px with patch grid 2, as
  tests/test_zoo.py builds it: ``MedTNet`` refuses a local branch that
  bottoms out under 2 px), both with ``use_fused=True`` (JAX's Pallas
  kernels in interpret mode where it takes them, the port's plain cores),
  at atol 2e-4 as tests/test_torch_port_models.py holds MedT; unetplusplus
  on its softmax output and every auxiliary head.
* The weight carrier on the zoo's trees: JAX's own ``export_for_model``
  cannot carry unetplusplus (its translator sends ``stem_conv`` down the
  stem branch and fails on a one-part path); the port keeps
  ``stem_conv``/``stem_bn`` as top-level names. On every other zoo tree
  the two carriers agree key for key.
* Routes: with ``use_fused=True``, gated_sig's attention sites take a
  kernel route in train mode and the plain path in eval mode (gated_data's
  are in tests/test_torch_port_zoo_gated.py); the train-mode sites equal
  what JAX's
  ``kernel_registry`` records (``jax.eval_shape``, no compile) at 128 px,
  batches 16 and 1, except the sites of span <= 16 under 128 stripes,
  where JAX takes its XLA einsums and the port its lanes kernel
  (tests/test_torch_port_stripe.py states that difference).
* The registry's options: gated_sig's frozen gates and ``trainable_gates``.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one PyTorch thread)

from medt_tpu.models import build_model as jax_build_model
from medt_tpu.ops import kernel_registry
from medt_tpu.parallel import kernel_mesh_scope, set_kernel_mesh
from medt_tpu.utils import torch_import
from medt_tpu_torch.config import parse_config
from medt_tpu_torch.models import MODEL_REGISTRY, build_model
from medt_tpu_torch.ops.axial_attention import AxialAttention
from medt_tpu_torch.training.trainer import setup_state
from medt_tpu_torch.utils import weights
from test_torch_port_models import carried, jax_variables

ATOL = 2e-4
ZOO = [
    ("gated_sig", 32, {}), ("gated_data", 32, {}),
    ("convnet_ablation", 32, {}), ("mix_net_gated_d", 64, {"patch_grid": 2}),
    ("axialunet_wopos", 32, {}), ("unetplusplus", 32, {}),
    ("shallow", 32, {}), ("autoencoder", 32, {}),
]


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("name,img,kw", ZOO, ids=[z[0] for z in ZOO])
def test_zoo_eval_forward_matches_jax(name, img, kw):
    variables = jax_variables(name, img, seed=0, **kw)
    x = np.random.default_rng(1).uniform(size=(2, img, img, 3)) \
        .astype(np.float32)
    jmodel = jax_build_model(name, img_size=img, use_fused=True, **kw)
    with kernel_mesh_scope():
        set_kernel_mesh(None)
        want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
            variables, jnp.asarray(x))
    model = build_model(name, img_size=img, use_fused=True, device="cpu",
                        **kw)
    sd = carried(name, variables)
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    if name == "unetplusplus":
        (got, got_aux), (want, want_aux) = got, want
        assert len(got_aux) == len(want_aux) == 4
        for g, w in zip(got_aux, want_aux):
            assert g.shape == _nchw(w).shape
            np.testing.assert_allclose(g.numpy(), _nchw(w), atol=ATOL,
                                       rtol=0)
        np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-5)
    out_ch = 3 if name == "autoencoder" else 2
    assert got.shape == (2, out_ch, img, img)
    np.testing.assert_allclose(got.numpy(), _nchw(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name,img,kw", [z for z in ZOO
                                         if z[0] != "unetplusplus"],
                         ids=[z[0] for z in ZOO if z[0] != "unetplusplus"])
def test_zoo_weight_carrier_equals_jax_export(name, img, kw):
    variables = jax_variables(name, img, seed=2, **kw)
    want = torch_import.export_for_model(name, variables["params"],
                                         variables["batch_stats"])
    got = weights.export_for_model(name, variables["params"],
                                   variables["batch_stats"])
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)


def test_unetplusplus_stem_keys():
    """JAX's export fails on the single-conv stem; the port carries it
    under its own names, and the deep-supervision heads beside it."""
    variables = jax_variables("unetplusplus", 32, seed=2)
    with pytest.raises(IndexError):
        torch_import.export_for_model("unetplusplus", variables["params"],
                                      variables["batch_stats"])
    sd = weights.export_for_model("unetplusplus", variables["params"],
                                  variables["batch_stats"])
    assert {k for k in sd if k.startswith("stem")} == {
        "stem_conv.weight", "stem_bn.weight", "stem_bn.bias",
        "stem_bn.running_mean", "stem_bn.running_var"}
    np.testing.assert_array_equal(
        sd["stem_conv.weight"],
        np.asarray(variables["params"]["stem_conv"]["kernel"])
        .transpose(3, 2, 0, 1))
    assert {k.split(".")[0] for k in sd if k.startswith("int")} == {
        f"inter{i}" for i in range(1, 5)} | {f"inte{i}" for i in range(1, 5)}
    assert not any(".hight_block." in k for k in sd)
    assert sum(k.endswith("conv_mid.weight") for k in sd) == 8


def test_zoo_registry_names_and_gates():
    zoo = {z[0] for z in ZOO}
    assert zoo <= set(MODEL_REGISTRY)
    frozen = build_model("gated_sig", img_size=32, device="cpu")
    gates = [m for m in frozen.modules() if isinstance(m, AxialAttention)]
    assert len(gates) == 16
    for m in gates:
        assert [float(getattr(m, n)) for n in ("f_qr", "f_kr", "f_sve",
                                               "f_sv")] == [
            pytest.approx(v) for v in (0.1, 0.1, 0.1, 5.0)]
        assert not any(getattr(m, n).requires_grad
                       for n in ("f_qr", "f_kr", "f_sve", "f_sv"))
    trained = build_model("gated_sig", img_size=32, trainable_gates=True,
                          device="cpu")
    assert all(m.f_sv.requires_grad for m in trained.modules()
               if isinstance(m, AxialAttention))
    # the training driver's --trainable_gates yes
    for flag, want in (("yes", True), ("no", False)):
        cfg = parse_config(["--modelname", "gated_sig", "--imgsize", "32",
                            "--trainable_gates", flag])
        state = setup_state(cfg, 1, "cpu")
        gates = [p for n, p in state.model.named_parameters()
                 if n.endswith(".f_qr")]
        assert len(gates) == 16 and all(p.requires_grad == want
                                        for p in gates)
        in_opt = {id(p) for g in state.optimizer.param_groups
                  for p in g["params"]}
        assert all((id(p) in in_opt) == want for p in gates)
    # the autoencoder ignores the image size, the classes and attention
    auto = build_model("autoencoder", img_size=64, num_classes=5,
                       use_fused=True, device="cpu")
    with torch.no_grad():
        assert auto(torch.zeros(1, 3, 16, 16)).shape == (1, 3, 16, 16)


# ---- routes --------------------------------------------------------------------

ATTENTION_FAMILIES = ("lanes", "flash", "flash2", "stripe", "eval")


def _jax_routes(name, img, batch, train, monkeypatch, **kw):
    """(family, span, g, gp, S, has_pos) of every attention-core site JAX's
    ``kernel_registry`` records in one forward (eval_shape: no compute)."""
    sites = []
    monkeypatch.setattr(
        kernel_registry, "record",
        lambda family, **kw: sites.append(
            (family, kw["span"], kw["g"], kw["gp"], kw["S"], kw["has_pos"])))
    model = jax_build_model(name, img_size=img, use_fused=True, **kw)
    x = jax.ShapeDtypeStruct((batch, img, img, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x, train=False), x)
    sites.clear()
    jax.eval_shape(lambda v, x: model.apply(v, x, train=train,
                                            mutable=["batch_stats"]),
                   shapes, x)
    return [s for s in sites if s[0] in ATTENTION_FAMILIES]


def _port_routes(name, img, batch, train, **kw):
    """``last_route`` of every attention site after one forward on the meta
    device (None: the plain path)."""
    model = build_model(name, img_size=img, use_fused=True,
                        plain_cores=True, device="meta", **kw).train(train)
    sites = [m for m in model.modules() if isinstance(m, AxialAttention)]
    for m in sites:
        m.last_route = None
    with torch.no_grad():
        model(torch.zeros((batch, 3, img, img), device="meta"))
    return [m.last_route for m in sites]


@pytest.mark.parametrize("batch", [16, 1])
def test_gated_sig_routes_match_jax(batch, monkeypatch):
    train = collections.Counter(_port_routes("gated_sig", 128, batch, True))
    assert None not in train and sum(train.values()) == 16
    jax_sites = collections.Counter(
        _jax_routes("gated_sig", 128, batch, True, monkeypatch))
    kept_lanes = collections.Counter({
        r: n for r, n in train.items()
        if r[0] == "lanes" and r[1] <= 16 and r[4] < 128})
    assert train - kept_lanes == jax_sites
    families = {r[0] for r in train}
    assert families == ({"flash", "lanes"} if batch == 16
                        else {"stripe", "lanes"})
    # eval mode: the plain path in both packages
    assert set(_port_routes("gated_sig", 128, batch, False)) == {None}
    assert _jax_routes("gated_sig", 128, batch, False, monkeypatch) == []
