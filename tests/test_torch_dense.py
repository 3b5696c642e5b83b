"""Dense-annotation finetuning in the port against the JAX package, on the
CPU: ``VisdialDatasetDense`` items equal JAX's byte for byte (two epochs,
two dis rates, overfit); ``cli/dense_finetune`` (fp32, the zero-dropout
TINY config, the shared start ``.ckpt`` of ``tests/_torch_cli_common.py``)
for one epoch of the 6 fixture dialogs with ``-batch_multiply 2
-length_buckets 1 -auto_resume`` in both packages: the same step count,
the same ``.ckpt`` file (the final save of the epoch budget) under the
train CLI's tolerances, and the logged loss parts (loss, lm, nsp, rank and
the logging-only ce / qfocal) to 1e-5. The JAX run is made once per
module. The port alone: tests/test_cli.py's dense tests (``:164`` the
overfit run, ``:304`` auto-resume with an idempotent relaunch) and the
slate's GT-first order."""

import os

import numpy as np
import pytest

from tests import _torch_cli_common as cc
from tests import fixtures
from tests.test_torch_data import assert_items_equal
from unimm_torch.cli import dense_finetune as t_dense
from unimm_torch.data import dataset as TD
from unimm_torch.data import features as TF
from unimm_torch.data.tokenizer import WordPieceTokenizer as TTok
from unimm_tpu.cli import dense_finetune as j_dense
from unimm_tpu.data import dataset as JD
from unimm_tpu.data import features as JF
from unimm_tpu.data.tokenizer import WordPieceTokenizer as JTok

EPOCH = ["-num_epochs", "1", "-batch_multiply", "2", "-length_buckets", "1",
         "-auto_resume"]
LOSS_PARTS = ("loss", "lm_loss", "nsp_loss", "rank_loss", "ce_loss",
              "qfocal_loss")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return cc.make_world(tmp_path_factory.mktemp("torch_dense"))


@pytest.fixture(scope="module")
def jax_run(world):
    state, save = cc.run(world, j_dense.main, EPOCH + [
        "-start_path", world["start"]], "epoch", "jax")
    return int(np.asarray(state["step"])), save


@pytest.mark.parametrize("over", [{}, {"train_dis_rate": 0.0},
                                  {"train_dis_rate": 1.0},
                                  {"overfit": True}])
def test_dense_items_equal(world, over):
    params = dict(fixtures.default_params(world["paths"]), num_options=100,
                  **over)
    p = world["paths"]
    t = TD.VisdialDatasetDense(params, TTok.from_vocab_file(p["vocab_path"]),
                               TF.open_features(p["visdial_image_feats"]))
    j = JD.VisdialDatasetDense(params, JTok.from_vocab_file(p["vocab_path"]),
                               JF.open_features(p["visdial_image_feats"]))
    assert len(t) == len(j) > 0
    for epoch in (0, 1):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        for i in range(len(j)):
            assert_items_equal(t[i], j[i])


def test_dense_cli_matches_jax(world, jax_run):
    want_step, want_dir = jax_run
    state, got_dir = cc.run(world, t_dense.main, EPOCH + [
        "-start_path", world["start"]], "epoch", "torch")
    assert state["step"] == want_step == 6
    assert (state["opt"].count, state["opt"].sched_count) == (3, 3)
    assert cc.ckpts(got_dir) == cc.ckpts(want_dir) == [
        "visdial_dialog_encoder_6.ckpt"]
    cc.assert_ckpts_match(os.path.join(got_dir, cc.ckpts(got_dir)[0]),
                          os.path.join(want_dir, cc.ckpts(want_dir)[0]))
    cc.assert_logs_match(got_dir, want_dir, "loss.csv")
    assert sorted({r[1] for r in cc.logged(got_dir, "loss.csv")}) == sorted(
        LOSS_PARTS)


def test_gt_first_order():
    rng = np.random.default_rng(0)
    for gt in (0, 37, 99):
        order = t_dense.gt_first_order(gt, rng)
        assert order[0] == gt and sorted(order) == list(range(100))


def test_dense_finetune_cli(world):
    """tests/test_cli.py:164 on the port."""
    state, _ = cc.run(world, t_dense.main, [
        "-overfit", "-num_epochs", "1", "-batch_multiply", "2"],
        "overfit", "torch")
    assert state["step"] > 0


def test_dense_finetune_auto_resume(world):
    """tests/test_cli.py:304 on the port: the per-epoch .ckpt carries the
    optimizer and the scheduler, an identical -auto_resume relaunch
    restores it and continues, and a relaunch of the complete run does
    nothing (its files' bytes unchanged)."""
    args = ["-num_epochs", "2", "-batch_multiply", "1", "-auto_resume"]
    state1, ckpt_dir = cc.run(world, t_dense.main, args, "ar", "torch")
    assert state1["step"] == 12                   # 2 epochs x 6 dialogs
    cks = cc.ckpts(ckpt_dir)
    # the epoch-boundary save (6) and the final-budget save (12)
    assert cks == ["visdial_dialog_encoder_12.ckpt",
                   "visdial_dialog_encoder_6.ckpt"], cks
    blob = cc.load(os.path.join(ckpt_dir, cks[0]))
    assert "optimizer_state_dict" in blob and "scheduler_state_dict" in blob
    before = {f: open(os.path.join(ckpt_dir, f), "rb").read() for f in cks}
    state2, _ = cc.run(world, t_dense.main, args, "ar", "torch")
    assert state2["step"] == 12
    assert (state2["opt"].count, state2["opt"].sched_count) == (12, 12)
    for f, b in before.items():
        assert open(os.path.join(ckpt_dir, f), "rb").read() == b, f
