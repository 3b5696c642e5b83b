"""The port's evaluation command line against the JAX package's, in-process
on the CPU: both read the same synthetic VisDial tree
(``tests/fixtures.write_fixture_tree``) with ``tests/test_cli.py``'s TINY
model config and argv, fp32, and the same reference-format ``.ckpt`` files
(written by JAX's ``save_reference_ckpt`` from seeded JAX inits) through
``-start_path`` / ``-model_paths``. The port's ``val_lm``, ``val_avg_lm``,
``val`` and ``evaluate`` (``main(argv, device="cpu")``) must write the same
predictions files as JAX's, byte for byte, and return the same metrics to
1e-6; also under ``-gen_prefix 0``, ``-prefix_packed 0`` and
``-prefix_rowblock 32`` / ``96``. One ``val_lm`` run reads the features
from a reference-format LMDB that the port's ``convert_npz_to_lmdb`` wrote
(each package through its own reader).

The checkpoints' weights are drawn at std 0.3. The ensemble CLIs rank by
per-slate min-max normalised NSP probabilities, and the two packages' fp32
probabilities differ by their summation order (<= 8.5e-7 at std 0.3, 3e-7
at 0.2). At TINY's 0.02 a slate's probabilities tie to 1e-7
(``_torch_common.member``'s reason); at 0.2 this config's lie within 0.06
of each other, the normalisation amplifies that rounding to 4e-5 of the
summed score, and one pair of options of 600 lies closer than that and
swaps; at 0.3 no pair lies within twice the packages' distance (2.5e-5),
so equal ranks test the port and not the rounding. Every JAX run is made
once per module (``jax_runs``), and ``-n_gpus 1`` keeps it on one device.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from tests import fixtures
from tests.test_cli import TINY_MODEL_JSON
from unimm_torch.cli import common as t_common
from unimm_torch.cli import evaluate as t_evaluate
from unimm_torch.cli import options as t_options
from unimm_torch.cli import val as t_val
from unimm_torch.cli import val_avg_lm as t_val_avg_lm
from unimm_torch.cli import val_lm as t_val_lm
from unimm_torch.data import features as t_features
from unimm_tpu import checkpoint as j_ckpt
from unimm_tpu.cli import evaluate as j_evaluate
from unimm_tpu.cli import options as j_options
from unimm_tpu.cli import val as j_val
from unimm_tpu.cli import val_avg_lm as j_val_avg_lm
from unimm_tpu.cli import val_lm as j_val_lm
from unimm_tpu.config import VilbertConfig as JConfig
from unimm_tpu.models import vilbert as jv

# run name -> (the entry point, its extra argv); the checkpoint flags are
# added by _argv
RUNS = {
    "val_lm": ("val_lm", ["-val_dis", "0"]),
    "val_lm_lmdb": ("val_lm", ["-val_dis", "0"]),
    "val_lm_flat": ("val_lm", ["-val_dis", "0", "-gen_prefix", "0"]),
    "val_lm_w": ("val_lm", ["-val_dis", "0", "-prefix_packed", "0"]),
    "val_lm_rb32": ("val_lm", ["-val_dis", "0", "-prefix_rowblock", "32"]),
    "val_lm_rb96": ("val_lm", ["-val_dis", "0", "-prefix_rowblock", "96"]),
    "val_avg_lm": ("val_avg_lm", ["-val_dis", "0"]),
    "val": ("val", []),
    "evaluate": ("evaluate", []),
}
ENTRIES = {
    "val_lm": (t_val_lm.main, j_val_lm.main),
    "val_avg_lm": (t_val_avg_lm.main, j_val_avg_lm.main),
    "val": (t_val.main, j_val.main),
    "evaluate": (t_evaluate.main, j_evaluate.main),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    paths, _, _ = fixtures.write_fixture_tree(str(root))
    model_cfg = root / "tiny_model.json"
    model_cfg.write_text(json.dumps(TINY_MODEL_JSON))
    lmdb_path = str(root / "features.lmdb")
    t_features.convert_npz_to_lmdb(paths["visdial_image_feats"], lmdb_path)
    cfg = JConfig.from_json_file(str(model_cfg)).replace(
        max_seq_len=96, initializer_range=0.3)
    ckpts = []
    for seed in (0, 1):
        path = str(root / f"member{seed}.ckpt")
        j_ckpt.save_reference_ckpt(
            path, jv.init_params(jax.random.PRNGKey(seed), cfg))
        ckpts.append(path)
    return {"root": str(root), "paths": paths, "model_cfg": str(model_cfg),
            "lmdb": lmdb_path, "ckpts": ckpts}


def _argv(world, name):
    _, extra = RUNS[name]
    p = world["paths"]
    feats = world["lmdb"] if name == "val_lm_lmdb" else \
        p["visdial_image_feats"]
    ck = (["-model_paths", ",".join(world["ckpts"])]
          if name in ("val", "evaluate") else
          ["-start_path", world["ckpts"][0]])
    return [
        "-visdial_processed_train", p["visdial_processed_train"],
        "-visdial_processed_val", p["visdial_processed_val"],
        "-visdial_processed_test", p["visdial_processed_test"],
        "-visdial_processed_train_dense", p["visdial_processed_train_dense"],
        "-visdial_processed_train_dense_annotations",
        p["visdial_processed_train_dense_annotations"],
        "-visdial_processed_val_dense_annotations",
        p["visdial_processed_val_dense_annotations"],
        "-visdial_image_feats", feats,
        "-vocab_path", p["vocab_path"],
        "-model_config", world["model_cfg"],
        "-max_seq_len", "96", "-num_options", "20",
        "-num_workers", "2", "-eval_chunk", "64", "-dtype", "float32",
        "-save_path", os.path.join(world["root"], "ckpt"),
        "-language_weights", "/nonexistent", "-n_gpus", "1",
    ] + ck + extra


def _run(world, name, side):
    entry = ENTRIES[RUNS[name][0]][side == "jax"]
    save = f"{side}_{name}"
    argv = _argv(world, name) + ["-save_name", save]
    cwd = os.getcwd()
    os.chdir(world["root"])
    try:
        out = entry(argv) if side == "jax" else entry(argv, device="cpu")
    finally:
        os.chdir(cwd)
    with open(os.path.join(world["root"], save + "_predictions.txt")) as f:
        return out, f.read()


@pytest.fixture(scope="module")
def jax_runs(world):
    return {name: _run(world, name, "jax") for name in RUNS}


@pytest.mark.parametrize("name", list(RUNS))
def test_cli_matches_jax(world, jax_runs, name):
    want_metrics, want_file = jax_runs[name]
    got_metrics, got_file = _run(world, name, "torch")
    assert got_file == want_file
    ranks = json.loads(got_file)
    if name == "evaluate":
        assert got_metrics is None and want_metrics is None
        assert len(ranks) == 2 and all(len(r["ranks"]) == 100
                                       for r in ranks)
        return
    assert len(ranks) == 3 * 10 and len(ranks[0]["ranks"]) == 20
    assert got_metrics.keys() == want_metrics.keys() and "ndcg" in got_metrics
    for k in want_metrics:
        assert got_metrics[k] == pytest.approx(want_metrics[k], abs=1e-6), k


def test_layouts_rank_alike(jax_runs):
    """The W layout, the fixed row blocks and the flat path rank as the
    packed default does (exact up to float rounding)."""
    base = [r["ranks"] for r in json.loads(jax_runs["val_lm"][1])]
    for name in ("val_lm_lmdb", "val_lm_flat", "val_lm_w", "val_lm_rb32",
                 "val_lm_rb96"):
        assert [r["ranks"] for r in json.loads(jax_runs[name][1])] == base


@pytest.mark.parametrize("extra", [
    [], ["-save_name", "x", "-max_seq_len", "96", "-prefix_packed", "0"],
    ["-overfit", "-continue", "-prefix_rowblock", "32", "-dtype", "float32",
     "-attention_impl", "xla", "-save_name", "y", "-n_gpus", "1"],
    ["-model_paths", "a.ckpt,b.ckpt", "-save_name", "z", "-mesh_mp", "1",
     "-eval_coalesce", "1", "-auto_resume"],
])
def test_options_parse_to_jax_s_dict(extra):
    """The copied parser gives JAX's dict (the timestamped save_path of a
    run without -save_name aside)."""
    got, want = t_options.read_command_line(extra), \
        j_options.read_command_line(extra)
    if "-save_name" not in extra:
        got.pop("save_path"), want.pop("save_path")
    assert got == want


# what each multi-device flag does alone: -n_gpus 2 and -mesh_mp 2 (an mp
# axis is mp processes) and a coordinator without a world size name the
# flags that launch a world of one process per card; -eval_data_sharded
# without a world changes nothing (the JAX package's rule: it shards only
# across processes)
FLAG_REFUSALS = {
    "-n_gpus": (ValueError, "-coordinator_address host:port "
                            "-num_processes N -process_id r"),
    "-mesh_mp": (ValueError, "-mesh_mp 2 without a world.*"
                             "-coordinator_address host:port "
                             "-num_processes N -process_id r"),
    "-eval_data_sharded": None,
    "-coordinator_address": (ValueError, "-num_processes >= 1"),
}


@pytest.mark.parametrize("flag", [
    ["-n_gpus", "2"], ["-mesh_mp", "2"], ["-eval_data_sharded", "1"],
    ["-coordinator_address", "localhost:1234"]])
def test_unported_flags_name_their_item(flag):
    argv = flag + ["-save_name", "x"]
    refusal = FLAG_REFUSALS[flag[0]]
    if refusal is None:
        assert t_options.read_command_line(argv) == \
            j_options.read_command_line(argv)
        return
    with pytest.raises(refusal[0], match=refusal[1]):
        t_options.read_command_line(argv)


@pytest.mark.parametrize("world", [
    ["-n_gpus", "2", "-coordinator_address", "127.0.0.1:1",
     "-num_processes", "3", "-process_id", "0"],
    ["-n_gpus", "1", "-coordinator_address", "127.0.0.1:1",
     "-num_processes", "2", "-process_id", "1"],
    ["-n_gpus", "3"]])
def test_n_gpus_other_than_the_world_raises(world):
    """-n_gpus is 0 or the world's size: one process drives one card."""
    with pytest.raises(ValueError, match="one process drives one card"):
        t_options.read_command_line(world + ["-save_name", "x"])


def test_world_flags_parse_to_jax_s_dict():
    argv = ["-n_gpus", "2", "-coordinator_address", "127.0.0.1:1",
            "-num_processes", "2", "-process_id", "1",
            "-eval_data_sharded", "1", "-save_name", "x"]
    assert t_options.read_command_line(argv) == \
        j_options.read_command_line(argv)


def test_cli_without_a_card_raises(world):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_val_lm.main(_argv(world, "val_lm") + ["-save_name", "nocard"])


def test_native_checkpoint_directory_names_its_item(world, tmp_path):
    """A directory without a native checkpoint is refused by name (a native
    one loads: tests/test_torch_persist.py)."""
    with pytest.raises(FileNotFoundError, match="no native checkpoint"):
        t_common.load_any_checkpoint(str(tmp_path), None)


def test_reference_ckpt_wrappers_load_alike(world, tmp_path):
    """The ``model_state_dict`` / ``iter_id`` wrapper, a bare state dict and
    a .tar.gz archive holding the bare one give the same weights, equal to
    JAX's load of the wrapper."""
    from unimm_torch.checkpoint import load_reference_ckpt
    from unimm_torch.config import VilbertConfig as TConfig
    from unimm_torch.models import vilbert as tv
    import tarfile

    blob = torch.load(world["ckpts"][0], map_location="cpu",
                      weights_only=False)
    bare = str(tmp_path / "pytorch_model.bin")
    torch.save(blob["model_state_dict"], bare)
    archive = str(tmp_path / "weights.tar.gz")
    with tarfile.open(archive, "w:gz") as t:
        t.add(bare, arcname="model/pytorch_model.bin")
    cfg = TConfig.from_json_file(world["model_cfg"]).replace(max_seq_len=96)
    jcfg = JConfig.from_json_file(world["model_cfg"]).replace(max_seq_len=96)
    jparams, iter_j, n_j, _ = j_ckpt.load_reference_ckpt(
        world["ckpts"][0], jv.init_params(jax.random.PRNGKey(5), jcfg))
    from unimm_torch.checkpoint import state_dict_from_jax
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    for path in (world["ckpts"][0], bare, archive):
        model, iter_id, n, skipped = load_reference_ckpt(
            path, tv.init_model(cfg, seed=5, device="cpu"))
        assert (iter_id, n) == (iter_j, n_j) and n > 0
        sd = model.state_dict()
        for k, v in want.items():
            torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
