"""The port's training command line against the JAX package's with the
fused AdamW (``-fused_adamw 1``: on the CPU both packages run the fused
update's plain form, JAX's Pallas kernel in interpret mode): the
``-overfit`` and the length-bucketed accumulation runs of
``test_torch_train_cli.py``, under its fixtures and tolerances
(``tests/_torch_cli_common.py``). Each JAX run is made once per module."""

import pytest

from tests import _torch_cli_common as cc

NAMES = ["overfit_fused", "accum_fused"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return cc.make_world(tmp_path_factory.mktemp("torch_train_fused"))


@pytest.fixture(scope="module")
def jax_runs(world):
    return cc.train_runs(world, NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_train_cli_fused_matches_jax(world, jax_runs, name):
    state = cc.check_train_run(world, jax_runs, name)
    assert state["opt"].fused
