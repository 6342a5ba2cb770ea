"""``train_step(remat=True)`` of the port, on CPU.

JAX's ``train_step(remat=True)`` runs the forward under ``jax.checkpoint``
(``medt_tpu/training/state.py:66-82``); the port runs it under
``torch.utils.checkpoint`` and holds the running statistics during the
recompute. What is held:

* a remat step against a plain step of the port from identical weights,
  MedT 32 px (patch grid 1) and axialunet 32 px, in float32 and bf16: the
  loss (rtol 1e-6), every parameter (atol 1e-5, JAX's
  ``test_remat_matches_plain_step``) and the running statistics equal,
  each moved by the step: one update, not two;
* the recompute runs every forward core once more and every backward core
  once: the plain versions' calls counted;
* the port's remat step against JAX's remat step (axialunet 32 px, SGD),
  parameters and running statistics, by ``check_train_step``'s rule
  (tests/test_torch_port_training.py).
"""
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one PyTorch thread)

from medt_tpu_torch.data import blob_batch
from medt_tpu_torch.models import build_model
from medt_tpu_torch.ops import axial_lanes, moments
from medt_tpu_torch.training import TrainState, adam_l2, train_step
from test_torch_port_training import check_train_step

MODELS = [("MedT", {"patch_grid": 1}), ("axialunet", {})]


def _step(name, kw, dtype, remat, batch):
    model = build_model(name, img_size=32, use_fused=True, device="cpu",
                        dtype=dtype, seed=4, **kw)
    state = TrainState(model, adam_l2(model.parameters(), 1e-3))
    loss = float(train_step(state, batch, remat=remat)["loss"])
    return loss, {k: t.detach().clone() for k, t in model.state_dict().items()}


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("name,kw", MODELS)
def test_remat_step_matches_plain_step(name, kw, dtype):
    images, masks = blob_batch(2, 32, seed=6)
    batch = {"image": images, "label": masks}
    loss, plain = _step(name, kw, dtype, False, batch)
    loss_r, remat = _step(name, kw, dtype, True, batch)
    before = build_model(name, img_size=32, device="cpu", seed=4,
                         **kw).state_dict()
    np.testing.assert_allclose(loss_r, loss, rtol=1e-6)
    stats = [k for k in plain if k.endswith(("running_mean", "running_var"))]
    assert stats
    for key, want in plain.items():
        if not want.is_floating_point():
            continue
        if key in stats:
            assert torch.equal(remat[key], want), key
            assert not torch.equal(want, before[key]), key   # one update
        else:
            torch.testing.assert_close(remat[key], want, atol=1e-5, rtol=0)


def test_remat_runs_the_forward_cores_twice(monkeypatch):
    """MedT 32 px: under remat every forward core and moments forward runs
    twice a step (the recompute), every backward once."""
    calls = {}

    def counted(module, name):
        fn = getattr(module, name)

        def run(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, run)

    for module, names in ((axial_lanes, ("lanes_attn_plain",
                                         "flash_lanes_plain",
                                         "lanes_attn_bwd_plain",
                                         "flash_lanes_bwd_plain")),
                          (moments, ("moment_sums_plain",
                                     "moment_sums_bwd_plain"))):
        for name in names:
            counted(module, name)
    images, masks = blob_batch(2, 32, seed=6)
    batch = {"image": images, "label": masks}
    per_step = {}
    for remat in (False, True):
        calls.clear()
        _step("MedT", {"patch_grid": 1}, None, remat, batch)
        per_step[remat] = dict(calls)
    plain, remat = per_step[False], per_step[True]
    assert plain["lanes_attn_plain"] > 0 and plain["moment_sums_plain"] > 0
    for name, n in plain.items():
        assert remat[name] == (n if "bwd" in name else 2 * n), (name, plain,
                                                                 remat)


def test_remat_step_matches_jax():
    assert check_train_step("axialunet", 32, remat=True) > 100
