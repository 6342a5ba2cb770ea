"""The 512 px slice of the port (medt_512, logo_512) against the JAX
package, on CPU.

* the registry: both models default to 512 px and honour an explicit size,
  as JAX's factories do (tests/test_models.py);
* weights: a JAX variable tree of either model at 512 px carries into the
  port's state dict and loads with ``load_state_dict(strict=True)``, its
  span-256 ``relative`` tables (2gp, 511) included;
* the slice at a cut size: medt_512 at 256 px, whose global branch runs
  span 128 (flash2 in both packages), on weights carried from JAX: the
  batch-1 eval logits at atol 1e-4;
* train mode: one whole ``train_step`` of medt_512 at 64 px, held as
  tests/test_torch_port_training.py holds MedT (why not at 256 px: the
  test's docstring); AxialAttention in train mode through the flash2 core
  is held in tests/test_torch_port_train_attention.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one PyTorch thread)

from medt_tpu.models import build_model as jax_build_model
from medt_tpu_torch.models import build_model
from medt_tpu_torch.ops.axial_attention import AxialAttention
from test_torch_port_models import carried, jax_variables
from test_torch_port_training import check_train_step


def _spans(model):
    return [m.span for m in model.modules() if isinstance(m, AxialAttention)]


def test_512_models_default_to_512_and_honour_an_explicit_size():
    """The global branch attends over half the image: span 256 at 512 px."""
    for name in ("medt_512", "logo_512"):
        assert jax_build_model(name).img_size == 512
        assert max(_spans(build_model(name, device="meta"))) == 256
        assert max(_spans(build_model(name, img_size=128,
                                      device="meta"))) == 64
    assert max(_spans(build_model("MedT", device="meta"))) == 64


@pytest.mark.parametrize("name", ["medt_512", "logo_512"])
def test_512_weights_carry_from_jax(name):
    variables = jax_variables(name, 512, seed=60)
    state = carried(name, variables)
    model = build_model(name, device="cpu")
    model.load_state_dict(state, strict=True)
    rel = model.layer1[0].hight_block.relative
    assert tuple(rel.shape) == (4, 511)  # gp 2 at span 256
    for key, value in model.state_dict().items():  # gates: (1,) -> ()
        torch.testing.assert_close(value.reshape(-1), state[key].reshape(-1),
                                   atol=0, rtol=0, msg=key)


def test_medt512_batch1_eval_at_256_matches_jax():
    variables = jax_variables("medt_512", 256, seed=61)
    x = np.random.default_rng(62).uniform(size=(1, 256, 256, 3)) \
        .astype(np.float32)
    jmodel = jax_build_model("medt_512", img_size=256, use_fused=True)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(x))).transpose(0, 3, 1, 2)
    model = build_model("medt_512", img_size=256, use_fused=True,
                        device="cpu")
    model.load_state_dict(carried("medt_512", variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    routes = {m.last_route[0] for m in model.modules()
              if isinstance(m, AxialAttention)}
    assert "flash2" in routes
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_train_step_matches_jax_medt512():
    """One whole train_step of medt_512 against JAX's, at 64 px with a 2x2
    patch grid (the factory and the step's wiring), held as
    tests/test_torch_port_training.py holds MedT.

    At 256 px, where the global branch runs flash2, the whole step cannot
    be held against JAX on the CPU at that tolerance: XLA's float32 sums on
    the CPU are far less exact than the step is well conditioned. Summing
    2^20 squares, XLA is off by 5.5e-4 of the value and torch by 1.5e-7
    (float64 reference); the local branch's first similarity-BN variance
    at 256 px is off by 2e-4 in JAX and 3e-7 in the port, and the deep
    train-mode network amplifies it: JAX's loss (0.86839) sits 0.54 %
    below a float64 evaluation of the port's step (0.87310), which the
    port's float32 step (0.87307) meets to 4e-5 relative. The flash2 route
    in train mode is held module by module at the strict tolerance
    (tests/test_torch_port_train_attention.py)."""
    assert check_train_step("medt_512", 64, patch_grid=2) > 200
