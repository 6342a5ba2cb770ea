"""The compute dtype's plumbing in the port, on CPU.

* ``build_model(dtype=torch.bfloat16)`` for every name of the registry at
  32 px (the two-branch models with a 1x1 patch grid): one train step and
  one eval forward each give finite bf16 outputs, a float32 loss, and
  float32 parameters, statistics and gradients;
* ``InferenceEngine(dtype=torch.bfloat16)`` serves bf16 logits near the
  float32 engine's (eval mode, well conditioned: within 5 % of the
  logits' size) and the sliding window; ``Config.compute_dtype`` maps
  ``--dtype`` as JAX's ``setup_state`` does, and the trainer's
  ``setup_state`` builds the model in it.

The bf16 kernels and train step against JAX are in
tests/test_torch_port_bf16.py.
"""
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one PyTorch thread)

from medt_tpu_torch.config import parse_config
from medt_tpu_torch.data import blob_batch
from medt_tpu_torch.models import MODEL_REGISTRY, build_model, main_logits
from medt_tpu_torch.serving import InferenceEngine
from medt_tpu_torch.training import TrainState, adam_l2, train_step
from medt_tpu_torch.training.trainer import setup_state

BF16 = torch.bfloat16


# every registry name at 32 px (the two-branch models with a 1x1 patch grid)
TWO_BRANCH = ("MedT", "logo", "medt_512", "logo_512", "mix_net_gated_d")


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_build_model_bf16_every_name(name):
    """``build_model(dtype=torch.bfloat16)``: bf16 outputs of a train step
    and an eval forward, float32 parameters, statistics and gradients."""
    kw = {"patch_grid": 1} if name in TWO_BRANCH else {}
    model = build_model(name, img_size=32, use_fused=True, device="cpu",
                        dtype=BF16, seed=2, **kw)
    images, masks = blob_batch(2, 32, seed=8)
    state = TrainState(model, adam_l2(model.parameters(), 1e-3))
    loss = train_step(state, {"image": images, "label": masks})["loss"]
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    model.eval()
    with torch.no_grad():
        out = main_logits(model(torch.rand(1, 3, 32, 32)))
    assert out.dtype == BF16 and torch.isfinite(out.float()).all()
    assert {t.dtype for t in model.state_dict().values()
            if t.is_floating_point()} == {torch.float32}
    assert all(p.grad.dtype == torch.float32 for p in model.parameters()
               if p.grad is not None)


def test_engine_config_and_trainer_take_the_dtype():
    sd = build_model("axialunet", img_size=32, seed=3,
                     device="cpu").state_dict()
    engine = InferenceEngine("axialunet", 32, variables=sd, batch_size=2,
                             dtype=BF16, device="cpu")
    plain = InferenceEngine("axialunet", 32, variables=sd, batch_size=2,
                            device="cpu")
    images = [np.random.default_rng(9).integers(0, 256, (32, 32, 3),
                                                dtype=np.uint8)]
    logits = engine.logits(images)
    assert logits.dtype == BF16 and plain.logits(images).dtype == \
        torch.float32
    # eval mode is well conditioned: bf16 moves the logits by a few bf16
    # roundings of their size
    np.testing.assert_allclose(logits.float().numpy(),
                               plain.logits(images).numpy(), rtol=0,
                               atol=0.05 * float(logits.abs().max()))
    assert engine.predict(np.zeros((40, 36, 3), np.uint8)).shape == (40, 36)
    cfg = parse_config(["--dtype", "bfloat16", "--modelname", "axialunet",
                        "--imgsize", "32"])
    assert cfg.compute_dtype == BF16
    assert parse_config([]).compute_dtype is None
    state = setup_state(cfg, steps_per_epoch=1, device="cpu")
    dtypes = {m.compute_dtype for m in state.model.modules()
              if hasattr(m, "compute_dtype")}
    assert dtypes == {BF16}
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
