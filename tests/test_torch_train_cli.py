"""The port's training command line (``unimm_torch.cli.train``) against the
JAX package's, in-process on the CPU, fp32, on the synthetic VisDial tree
with the zero-dropout TINY config and one shared start ``.ckpt``
(``tests/_torch_cli_common.py``, which also states the tolerances: weights
to 1e-6 absolute, each moment to 1e-4 of its tensor's largest entry,
counters and the optimizer's and scheduler's dicts equal, val metrics to
1e-5), with the plain AdamW: ``-overfit -num_epochs 1``, and
length-bucketed accumulation (``-batch_multiply 2 -length_buckets 1
-num_epochs 2``: 6 micro-steps, the epoch-1 save halfway through an
accumulation). The fused AdamW's runs are in ``test_torch_train_fused.py``
and the resume with the counters apart in ``test_torch_train_continue.py``,
so each file's JAX runs stay short. Both packages read the same batches
and the same host subsamples (the data modules are byte-equal,
tests/test_torch_data.py), so they must take the same number of steps and
write matching ``.ckpt`` files. Each JAX run is made once per module."""

import pytest

from tests import _torch_cli_common as cc

NAMES = ["overfit", "accum"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return cc.make_world(tmp_path_factory.mktemp("torch_train_cli"))


@pytest.fixture(scope="module")
def jax_runs(world):
    return cc.train_runs(world, NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_train_cli_matches_jax(world, jax_runs, name):
    cc.check_train_run(world, jax_runs, name)
