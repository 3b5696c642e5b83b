"""Save, barrier and resume of the port's training command line in a
data-parallel world, on the CPU: two gloo ranks
(``tests/_torch_dist_worker.py``, job ``persist``) run ``cli/train.py``
through the world flags for one epoch of the 6 fixture dialogs at a global
batch of 2 images (one a rank; 3 steps) from a start ``.ckpt``, with a
save and the val ranking at the epoch's end, then again with ``-continue``
from the run's native directory (tests/test_cli.py:173-188's drill):

- the step count doubles (3, then 6) and the Adam count is 6 on both
  ranks, whose weights are bit-equal (one SHA-256 over every parameter);
- rank 0 alone wrote: ``step_3`` and ``step_6``, the two ``.ckpt`` files,
  no temporary entry left, and each logged val metric once an eval;
- the in-training val ranking (its chunks' rows split over the ranks)
  equals one process's ``evaluate_split`` on the saved step-3 weights, to
  1e-5 (tests/_torch_cli_common.py's METRIC_ATOL).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from tests import _torch_cli_common as cc
from tests import _torch_dist_worker as W
from tests import fixtures
from unimm_torch import checkpoint as C
from unimm_torch.cli import common, options
from unimm_torch.data.dataset import VisdialDataset
from unimm_torch.data.loader import DataLoader
from unimm_torch.eval import evaluator
from unimm_torch.models import vilbert
from unimm_tpu import checkpoint as j_ckpt
from unimm_tpu.config import VilbertConfig as JConfig
from unimm_tpu.models import vilbert as jv

RUN = ["-num_epochs", "1", "-batch_size", "12", "-sequences_per_image", "6",
       "-num_negative_samples", "1", "-eval_every_epochs", "1",
       "-save_name", "dist"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_dist_persist")
    paths, _, _ = fixtures.write_fixture_tree(str(root), n_train=6, n_val=4)
    model_cfg = str(root / "tiny_nodrop.json")
    with open(model_cfg, "w") as f:
        json.dump(cc.NO_DROP_JSON, f)
    start = str(root / "start.ckpt")
    j_ckpt.save_reference_ckpt(start, jv.init_params(
        jax.random.PRNGKey(7), JConfig.from_json_file(model_cfg).replace(
            max_seq_len=96, initializer_range=cc.START_STD)))
    w = {"root": str(root), "paths": paths, "model_cfg": model_cfg}
    one = cc.argv(w, [])                 # ends with -n_gpus 1
    argv = one[:-1] + ["2"]
    save = os.path.join(str(root), "ckpt", "dist")
    res = W.launch("persist", {
        "out": str(root / "out"), "root": str(root), "argv": argv,
        "first": RUN + ["-start_path", start],
        "second": RUN + ["-continue", "-start_path",
                         os.path.join(save, "native")]})()
    return dict(w, res=res, save=save, one=one)


def test_step_doubles_and_ranks_agree(world):
    infos = [info for _, info in world["res"]]
    assert [i["first_step"] for i in infos] == [3, 3]
    assert [i["second_step"] for i in infos] == [6, 6]
    assert [i["adam_count"] for i in infos] == [6, 6]
    assert infos[0]["weights_sha256"] == infos[1]["weights_sha256"]


def test_rank_zero_wrote_once(world):
    save = world["save"]
    assert sorted(os.listdir(os.path.join(save, "native"))) == [
        "step_3", "step_6"]
    assert cc.ckpts(save) == ["visdial_dialog_encoder_3.ckpt",
                              "visdial_dialog_encoder_6.ckpt"]
    rows = cc.logged(save, "Retrieval_Val_Metrics.csv")
    keys = [r[:2] for r in rows]
    assert len(keys) == len(set(keys)) and {r[0] for r in rows} == {3, 6}


def test_training_eval_equals_one_process(world):
    """The val ranking logged at step 3 (rows split over the ranks) is
    one process's on the step-3 weights."""
    params = options.read_command_line(world["one"] + RUN)
    cfg = common.build_config(params)
    model = vilbert.empty_model(cfg, "cpu")
    C.load_reference_ckpt(os.path.join(world["save"],
                                       "visdial_dialog_encoder_3.ckpt"),
                          model)
    ds = VisdialDataset(params, common.load_tokenizer(params),
                        common.open_reader(params))
    ds.split = "val"
    want = evaluator.evaluate_split(
        model, cfg, DataLoader(ds, 4, drop_last=True, num_workers=1),
        mode="nsp", chunk_size=64, dtype=torch.float32, device="cpu")
    got = {line: y for x, line, y in cc.logged(world["save"],
                                              "Retrieval_Val_Metrics.csv")
           if x == 3}
    assert got.keys() == {"r@1", "r@5", "r@10", "mean", "mrr", "ndcg"}
    for k, v in got.items():
        assert v == pytest.approx(float(want[k]), abs=cc.METRIC_ATOL), k
    assert np.isfinite(list(got.values())).all()
