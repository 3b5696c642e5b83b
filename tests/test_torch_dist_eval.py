"""The port's evaluation in a data-parallel world against the JAX package,
on the CPU: two gloo ranks (``tests/_torch_dist_worker.py``, job ``eval``)
run the evaluation CLIs through the world flags (``-coordinator_address
-num_processes 2 -process_id r -n_gpus 2``) on the synthetic VisDial tree
of ``tests/test_torch_cli.py`` with 5 val and 3 test dialogs, so the
global batches (2 val, 4 test dialogs) leave uneven tails:

- data-sharded (``-eval_data_sharded 1``: val_lm, val, evaluate) and
  serving (every rank iterates the whole split and scores its share of
  every prefix group or chunk: val_lm, val_avg_lm, val): the predictions
  file byte for byte and every rank's metrics to 1e-6 against JAX's
  single-process run of the same CLI;
- the process-sharded loader: each rank's rows and ``valid`` tail mask
  equal JAX's ``DataLoader(process_index=r, process_count=2)`` at global
  batch 2 over 5 dialogs (tests/test_multihost.py:217's case);
- ``allreduce_metrics`` (ranks that observed different rows, and a rank
  that observed none) to 1e-6 against JAX's accumulators fed both ranks'
  rows in one process; ``dump_ranks_merged`` with no world byte for
  byte against JAX's one-process branch (the world's merge is in the
  data-sharded CLI cases above); ``dump_ranks``' writers (rank 0, or every rank
  under ``all_processes``); ``sparse_metrics_from_ranks`` against JAX's.

The checkpoints are drawn at std 0.3 (tests/test_torch_cli.py's reason:
no two options' scores tie within the packages' rounding).
"""

import json
import os

import numpy as np
import pytest

import jax

from tests import _torch_dist_worker as W
from tests import fixtures
from tests.test_cli import TINY_MODEL_JSON
from unimm_torch.eval import evaluator as t_evaluator
from unimm_torch.ops import metrics as t_metrics
from unimm_tpu import checkpoint as j_ckpt
from unimm_tpu.cli import evaluate as j_evaluate
from unimm_tpu.cli import val as j_val
from unimm_tpu.cli import val_avg_lm as j_val_avg_lm
from unimm_tpu.cli import val_lm as j_val_lm
from unimm_tpu.config import VilbertConfig as JConfig
from unimm_tpu.data import features as j_features
from unimm_tpu.data.dataset import VisdialDataset as JDataset
from unimm_tpu.data.loader import DataLoader as JLoader
from unimm_tpu.data.tokenizer import WordPieceTokenizer as JTok
from unimm_tpu.eval import evaluator as j_evaluator
from unimm_tpu.models import vilbert as jv
from unimm_tpu.ops import metrics as j_metrics

# torch run -> (JAX entry point of the single-process oracle, its run)
RUNS = {"lm_sharded": "lm", "lm_serve": "lm", "avg_serve": "avg",
        "val_sharded": "val", "val_serve": "val", "ev_sharded": "ev"}
JAX_RUNS = {"lm": j_val_lm, "avg": j_val_avg_lm, "val": j_val,
            "ev": j_evaluate}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_dist_eval")
    paths, _, _ = fixtures.write_fixture_tree(str(root), n_val=5, n_test=3)
    model_cfg = root / "tiny_model.json"
    model_cfg.write_text(json.dumps(TINY_MODEL_JSON))
    cfg = JConfig.from_json_file(str(model_cfg)).replace(
        max_seq_len=96, initializer_range=0.3)
    ckpts = []
    for seed in (0, 1):
        path = str(root / f"member{seed}.ckpt")
        j_ckpt.save_reference_ckpt(
            path, jv.init_params(jax.random.PRNGKey(seed), cfg))
        ckpts.append(path)
    flags = ("visdial_processed_train", "visdial_processed_val",
             "visdial_processed_test", "visdial_processed_train_dense",
             "visdial_processed_train_dense_annotations",
             "visdial_processed_val_dense_annotations",
             "visdial_image_feats", "vocab_path")
    argv = [a for f in flags for a in ("-" + f, paths[f])] + [
        "-model_config", str(model_cfg), "-max_seq_len", "96",
        "-num_options", "20", "-num_workers", "2", "-eval_chunk", "64",
        "-dtype", "float32", "-save_path", str(root / "ckpt"),
        "-language_weights", "/nonexistent"]
    lm = ["-val_dis", "0", "-start_path", ckpts[0]]
    ens = ["-model_paths", ",".join(ckpts)]
    collect = W.launch("eval", {"out": str(root / "out"), "root": str(root),
                                "argv": argv + ["-n_gpus", "2"],
                                "lm_ckpt": lm, "ens_ckpt": ens,
                                "loader_batch": 2})
    jax_out = {}
    cwd = os.getcwd()
    os.chdir(root)
    try:
        for name, mod in JAX_RUNS.items():
            ck = lm if name in ("lm", "avg") else ens
            jax_out[name] = mod.main(argv + ck + ["-n_gpus", "1",
                                                  "-save_name", "jax_" + name])
    finally:
        os.chdir(cwd)
    return {"root": str(root), "paths": paths, "res": collect(),
            "jax": jax_out}


def read(world, name):
    with open(os.path.join(world["root"], name + "_predictions.txt")) as f:
        return f.read()


@pytest.mark.parametrize("run", list(RUNS))
def test_cli_matches_jax_single_process(world, run):
    want = RUNS[run]
    got_file, want_file = read(world, run), read(world, "jax_" + want)
    assert got_file == want_file
    records = json.loads(got_file)
    if run == "ev_sharded":
        assert len(records) == 3 and {len(r["ranks"]) for r in records} \
            == {100}
        return
    assert len(records) == 5 * 10
    want_m = world["jax"][want]
    for _, info in world["res"]:
        got_m = info["metrics"][run]
        assert got_m.keys() == want_m.keys() and "ndcg" in got_m
        for k in want_m:
            assert got_m[k] == pytest.approx(want_m[k], abs=1e-6), (run, k)


def test_sharded_loader_matches_jax(world):
    """Global batch 2 over 5 dialogs: the last global batch is one dialog,
    padded with its copy on rank 1 and masked by ``valid``."""
    p = world["paths"]
    params = dict(fixtures.default_params(p), num_options=20)
    ds = JDataset(params, JTok.from_vocab_file(p["vocab_path"]),
                  j_features.open_features(p["visdial_image_feats"]))
    ds.split = "val"
    for r, (_, info) in enumerate(world["res"]):
        want = [{"image_id": [int(i) for i in b["image_id"]],
                 "valid": ([bool(v) for v in b["valid"]] if "valid" in b
                           else None)}
                for b in JLoader(ds, 2, num_workers=1, process_index=r,
                                 process_count=2)]
        assert info["loader"] == want
    assert world["res"][1][1]["loader"][-1]["valid"] == [False]


@pytest.mark.parametrize("case", ["both", "empty"])
def test_allreduce_metrics_matches_one_process(world, case):
    sparse, ndcg = j_metrics.SparseGTMetrics(), j_metrics.NDCG()
    for arrays, _ in world["res"]:
        if arrays[f"{case}_scores"].shape[0]:
            sparse.observe(arrays[f"{case}_scores"], arrays[f"{case}_gt"])
            ndcg.observe(arrays[f"{case}_scores"][:, 0],
                         arrays[f"{case}_rel"])
    want = {**sparse.retrieve(), **ndcg.retrieve()}
    for _, info in world["res"]:
        got = info[f"allreduce_{case}"]
        assert got.keys() == want.keys() and len(want) == 56
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-6), k


def test_dump_ranks_writers(world):
    """Serving: rank 0 alone writes (the ranks hold the same records);
    ``all_processes``: each rank its own file."""
    root = world["root"]
    with open(os.path.join(root, "dump_rank0_only.json")) as f:
        assert json.load(f) == [{"image_id": 0, "round_id": 1,
                                 "ranks": [1]}]
    for r in (0, 1):
        with open(os.path.join(root, f"dump_all_{r}.json")) as f:
            assert json.load(f)[0]["image_id"] == r


def test_dump_ranks_merged_one_process_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    recs = [{"image_id": int(i), "round_id": int(r),
             "ranks": [int(x) + 1 for x in rng.permutation(7)]}
            for i, r in zip(rng.permutation(6) + 100, rng.integers(1, 11, 6))]
    got, want = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    assert t_evaluator.dump_ranks_merged(list(recs), got) == \
        j_evaluator.dump_ranks_merged(list(recs), want) == 6
    assert open(got).read() == open(want).read()


def test_sparse_metrics_from_ranks_matches_jax():
    ranks = np.random.default_rng(4).integers(1, 101, 300)
    want = j_metrics.sparse_metrics_from_ranks(ranks)
    got = t_metrics.sparse_metrics_from_ranks(ranks)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-6), k
