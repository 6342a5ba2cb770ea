"""The whole training slice on MedT, on CPU: one ``train_step`` of MedT
64 px (patch grid 2, batch 2) from the same weights as JAX ``train_step``,
held as tests/test_torch_port_training.py holds gatedaxialunet (loss,
every parameter and running statistic after an sgd step). MedT's local
branch takes joint batch statistics over all patches in both packages.
"""
from test_torch_port_training import check_train_step
import _torch_threads  # noqa: F401  (one PyTorch thread)


def test_train_step_matches_jax_medt():
    assert check_train_step("MedT", 64, patch_grid=2) > 200
