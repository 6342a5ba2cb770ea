"""One ``train_step`` of five zoo models against JAX ``train_step``, on the
CPU, from the same carried weights (sgd), held as
tests/test_torch_port_training.py holds gatedaxialunet: the loss, every
parameter and running statistic after the step, with ``use_fused=True``
on both sides.

* gated_sig 32 px: its sigmoid gates fold into the tables of the fused
  train route in both packages (JAX's fused glue around its XLA core at
  these stripe counts, the port's lanes core on its plain version);
* axialunet_wopos 32 px: the position-free fused route;
* unetplusplus, convnet_ablation and shallow 32 px: no attention, the
  deep-supervision loss for unetplusplus's ``(logits, aux)`` tuple.
"""
import pytest

from test_torch_port_training import check_train_step


@pytest.mark.parametrize("name,min_checked", [
    ("gated_sig", 400), ("axialunet_wopos", 300), ("unetplusplus", 130),
    ("convnet_ablation", 130), ("shallow", 60)])
def test_zoo_train_step_matches_jax(name, min_checked):
    assert check_train_step(name, 32) >= min_checked
