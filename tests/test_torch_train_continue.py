"""The port's training command line against the JAX package's, as
``test_torch_train_cli.py`` (fixtures and tolerances in
``tests/_torch_cli_common.py``): ``-continue`` from a reference ``.ckpt``
whose Adam count (``step`` 5) differs from its schedule position
(``iter_id`` 7 // ``-batch_multiply`` 2 = 3): both packages restore the
two counters apart, take the same update and write matching ``.ckpt``
files and val metrics."""

import os

import numpy as np
import pytest
import torch

from tests import _torch_cli_common as cc
from unimm_torch.cli import train as t_train
from unimm_tpu.cli import train as j_train

CONTINUE = cc.OVERFIT + ["-num_epochs", "2", "-batch_multiply", "2",
                         "-continue"]


def continued_ckpt(world):
    """The shared start weights with seeded Adam moments, ``step`` 5 and
    ``iter_id`` 7, in the reference layout."""
    blob = cc.load(world["start"])
    rng = np.random.default_rng(11)
    names = [k for k in blob["model_state_dict"]
             if not k.endswith("cls.predictions.decoder.weight")]
    state = {}
    for i, k in enumerate(names):
        shape = blob["model_state_dict"][k].shape
        state[i] = {"step": 5,
                    "exp_avg": torch.from_numpy(rng.normal(
                        0, 1e-3, shape).astype(np.float32)),
                    "exp_avg_sq": torch.from_numpy(np.abs(rng.normal(
                        0, 1e-6, shape)).astype(np.float32))}
    blob["optimizer_state_dict"] = {"state": state, "param_groups": []}
    blob["iter_id"] = 7
    path = os.path.join(world["root"], "continued.ckpt")
    torch.save(blob, path)
    return path


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = cc.make_world(tmp_path_factory.mktemp("torch_train_continue"))
    w["continued"] = continued_ckpt(w)
    return w


@pytest.fixture(scope="module")
def jax_run(world):
    state, save = cc.run(world, j_train.main, CONTINUE + [
        "-start_path", world["continued"]], "continue", "jax")
    return int(np.asarray(state["step"])), save


def test_continue_with_counters_apart_matches_jax(world, jax_run):
    want_step, want_dir = jax_run
    state, got_dir = cc.run(world, t_train.main, CONTINUE + [
        "-start_path", world["continued"]], "continue", "torch")
    # two overfit epochs of one micro-step each from iter_id 7: one update
    assert state["step"] == want_step == 9
    assert (state["opt"].count, state["opt"].sched_count) == (6, 4)
    assert cc.ckpts(got_dir) == cc.ckpts(want_dir) == [
        "visdial_dialog_encoder_8.ckpt", "visdial_dialog_encoder_9.ckpt"]
    for f in cc.ckpts(got_dir):
        cc.assert_ckpts_match(os.path.join(got_dir, f),
                              os.path.join(want_dir, f))
    cc.assert_logs_match(got_dir, want_dir, "Retrieval_Val_Metrics.csv")
