"""The port's models against the JAX package and the reference goldens.

* MedT (64 px, patch grid 2, batch 2) on weights carried from a JAX variable
  tree: JAX ``use_fused=True`` (its Pallas kernels in interpret mode) vs the
  port's fused and plain paths, eval logits at atol 2e-4 (the float32
  summation-order noise of some hundred layers, as in
  tests/test_reference_parity.py).
* The port loading the reference's own state dicts (``sd.*`` of
  tests/goldens/*.npz) with ``load_state_dict(strict=True)`` and matching
  their ``__out_eval__`` at atol 2e-4 / rtol 1e-3
  (tests/test_reference_parity.py:53).
* The weight carrier (numpy only) against ``export_for_model``.
* Entry points without a card.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medt_tpu.models import build_model as jax_build_model
from medt_tpu.utils import torch_import
from medt_tpu_torch.models import build_model
from medt_tpu_torch.serving import InferenceEngine
from medt_tpu_torch.utils import weights
from test_torch_port_ops import random_variables

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def jax_variables(name, img, seed, **kw):
    """Random values on the variable tree of a JAX model (eval_shape: no
    init run)."""
    model = jax_build_model(name, img_size=img, **kw)
    x = jnp.zeros((1, img, img, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x, train=False), x)
    return random_variables(shapes, seed)


def carried(name, variables):
    sd = weights.export_for_model(name, variables["params"],
                                  variables["batch_stats"])
    return weights.to_state_dict(sd)


@pytest.fixture(scope="module")
def medt64():
    """JAX MedT 64 px / patch grid 2, fused eval path, on random weights."""
    variables = jax_variables("MedT", 64, seed=0, patch_grid=2)
    x = np.random.default_rng(1).uniform(size=(2, 64, 64, 3)) \
        .astype(np.float32)
    model = jax_build_model("MedT", img_size=64, patch_grid=2,
                            use_fused=True)
    out = jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    return variables, x, np.asarray(out).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("use_fused", [True, False])
def test_medt_matches_jax_fused(medt64, use_fused):
    variables, x, want = medt64
    model = build_model("MedT", img_size=64, patch_grid=2,
                        use_fused=use_fused, device="cpu")
    model.load_state_dict(carried("MedT", variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert got.shape == (2, 2, 64, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


def _golden(name):
    blob = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    sd = {k[3:]: blob[k] for k in blob.files if k.startswith("sd.")}
    live = {k: v for k, v in sd.items()
            if not weights.is_dead_reference_key(k)}
    return blob, weights.to_state_dict(live)


@pytest.mark.parametrize("name,img,use_fused", [
    ("MedT", 128, True), ("MedT", 128, False),
    ("gatedaxialunet", 64, True), ("axialunet", 64, True),
])
def test_reference_golden_eval_output(name, img, use_fused):
    blob, sd = _golden(name)
    model = build_model(name, img_size=img, use_fused=use_fused,
                        device="cpu")
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(blob["__input__"]))
    np.testing.assert_allclose(got.numpy(), blob["__out_eval__"],
                               atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("name,img,use_fused,kw", [
    ("axialunet", 64, True, {}), ("axialunet", 64, False, {}),
    ("gatedaxialunet", 64, True, {}), ("gatedaxialunet", 64, False, {}),
    ("MedT", 128, True, {"sequential_bn_parity": True}),
    ("MedT", 128, False, {"sequential_bn_parity": True}),
])
def test_reference_golden_train_output_and_stats(name, img, use_fused, kw):
    """One train-mode forward on the reference's weights against its
    ``__out_train__`` (atol 5e-4 / rtol 1e-3) and every running statistic
    after it, ``__stats_after__.*`` (atol 2e-3 / rtol 1e-2): the
    tolerances of tests/test_reference_parity.py:68, 106, 132. MedT runs
    the reference's per-patch local passes (``sequential_bn_parity``)."""
    blob, sd = _golden(name)
    model = build_model(name, img_size=img, use_fused=use_fused,
                        device="cpu", **kw)
    model.load_state_dict(sd, strict=True)
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(blob["__input__"]))
    np.testing.assert_allclose(got.numpy(), blob["__out_train__"],
                               atol=5e-4, rtol=1e-3)
    prefix = "__stats_after__."
    want = {k[len(prefix):]: blob[k] for k in blob.files
            if k.startswith(prefix) and not weights.is_dead_reference_key(
                k[len(prefix):])}
    stats = {k: v for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    assert set(stats) == set(want)
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), want[k], atol=2e-3, rtol=1e-2,
                                   err_msg=k)


@pytest.mark.parametrize("name,img,kw", [
    ("MedT", 64, {"patch_grid": 2}), ("gatedaxialunet", 64, {}),
])
def test_weight_carrier_equals_jax_export(name, img, kw):
    variables = jax_variables(name, img, seed=2, **kw)
    want = torch_import.export_for_model(name, variables["params"],
                                         variables["batch_stats"])
    got = weights.export_for_model(name, variables["params"],
                                   variables["batch_stats"])
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("name,kw", [
    ("MedT", {"patch_grid": 2}), ("logo", {"patch_grid": 2}),
    ("gatedaxialunet", {}), ("axialunet", {}),
])
def test_models_load_carried_weights_strictly(name, kw):
    variables = jax_variables(name, 64, seed=3, **kw)
    model = build_model(name, img_size=64, device="cpu", **kw)
    sd = carried(name, variables)
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)
    assert not model.training


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model("MedT")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine("MedT", 128, variables={})
