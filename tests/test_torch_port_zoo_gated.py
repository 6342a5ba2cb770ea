"""The data-gated zoo models against the JAX package, on the CPU.

* One ``train_step`` of gated_data (32 px) and of mix_net_gated_d (64 px,
  patch grid 2, as tests/test_zoo.py builds it) against JAX
  ``train_step`` from the same carried weights (sgd), held as
  tests/test_torch_port_training.py holds gatedaxialunet. Their per-sample
  gates (GAP -> MLP -> sigmoid) cannot fold into the position tables that
  every sample shares, so both packages run them on the plain path.
* Routes: with ``use_fused=True`` every attention site of both models
  takes the plain path in train and in eval mode, and JAX's
  ``kernel_registry`` records no kernel site for them either.
"""
import pytest

from test_torch_port_training import check_train_step
from test_torch_port_zoo import _jax_routes, _port_routes


@pytest.mark.parametrize("name,img,kw,min_checked", [
    ("gated_data", 32, {}, 400),
    ("mix_net_gated_d", 64, {"patch_grid": 2}, 550)])
def test_data_gated_train_step_matches_jax(name, img, kw, min_checked):
    assert check_train_step(name, img, **kw) >= min_checked


@pytest.mark.parametrize("name,kw", [
    ("gated_data", {}), ("mix_net_gated_d", {"patch_grid": 2})])
def test_data_gated_models_stay_plain(name, kw, monkeypatch):
    for train in (True, False):
        assert set(_port_routes(name, 64, 2, train, **kw)) == {None}
        assert _jax_routes(name, 64, 2, train, monkeypatch, **kw) == []
