"""Shared pieces of the tests that hold the port's training command line
(``unimm_torch.cli.train`` / ``dense_finetune``) against the JAX package's:
the synthetic VisDial tree, ``tests/test_cli.py``'s TINY config with all
five dropout probabilities at 0 (the standard four and
``head_dropout_prob``), a shared start ``.ckpt`` written by JAX's
``save_reference_ckpt`` from a seeded JAX init, the argv, a runner for
either package, and the comparison of two reference ``.ckpt`` files."""

import csv
import json
import os

import numpy as np
import torch

import jax

from tests import fixtures
from tests.test_cli import TINY_MODEL_JSON
from unimm_tpu import checkpoint as j_ckpt
from unimm_tpu.config import VilbertConfig as JConfig
from unimm_tpu.models import vilbert as jv

NO_DROP_JSON = dict(TINY_MODEL_JSON, attention_probs_dropout_prob=0.0,
                    hidden_dropout_prob=0.0, v_hidden_dropout_prob=0.0,
                    v_attention_probs_dropout_prob=0.0, head_dropout_prob=0.0)
# the start weights' std: at TINY's 0.02 a slate's NSP probabilities tie
# to 1e-7 and the two packages' val ranks would follow their rounding
# (tests/test_torch_cli.py's reason; the same std here)
START_STD = 0.3

# tolerances of a .ckpt against JAX's: Adam moves a weight by about lr a
# step; the two packages' fp32 sums differ by their order, so a weight is
# held to WEIGHT_ATOL absolute and each moment to MOMENT_RTOL of its
# tensor's largest entry
WEIGHT_ATOL = 1e-6
MOMENT_RTOL = 1e-4
METRIC_ATOL = 1e-5
# the attention key biases have no gradient (a softmax does not see a
# shift of a whole row of scores), so their moments are the two packages'
# rounding noise (~1e-9 of exp_avg's 0.1): they are held to NOISE_RTOL of
# the largest entry of that moment over the whole model instead
ZERO_GRAD_SUFFIXES = ("key.bias", "key1.bias", "key2.bias")
NOISE_RTOL = 1e-6


# the train CLI's parity runs: -overfit -num_epochs 1, and length-bucketed
# accumulation over 2 epochs (6 train dialogs at 2 images a batch: 3 loader
# batches an epoch, one buffered pair and one epoch-end remainder flush, 6
# micro-steps; the epoch-1 save lands halfway through an accumulation),
# each with the plain and the fused AdamW
OVERFIT = ["-overfit", "-num_epochs", "1", "-batch_size", "12",
           "-sequences_per_image", "6", "-num_negative_samples", "1",
           "-eval_every_epochs", "1"]
ACCUM = ["-num_epochs", "2", "-batch_size", "12", "-sequences_per_image",
         "6", "-num_negative_samples", "1", "-batch_multiply", "2",
         "-length_buckets", "1", "-eval_every_epochs", "100",
         "-save_every_epochs", "1"]
TRAIN_RUNS = {"overfit": OVERFIT + ["-fused_adamw", "0"],
              "overfit_fused": OVERFIT + ["-fused_adamw", "1"],
              "accum": ACCUM + ["-fused_adamw", "0"],
              "accum_fused": ACCUM + ["-fused_adamw", "1"]}


def make_world(root, n_train=6):
    """The fixture tree, the zero-dropout TINY config file and the shared
    start .ckpt under ``root``."""
    paths, _, _ = fixtures.write_fixture_tree(str(root), n_train=n_train)
    model_cfg = os.path.join(str(root), "tiny_nodrop.json")
    with open(model_cfg, "w") as f:
        json.dump(NO_DROP_JSON, f)
    cfg = JConfig.from_json_file(model_cfg).replace(
        max_seq_len=96, initializer_range=START_STD)
    start = os.path.join(str(root), "start.ckpt")
    j_ckpt.save_reference_ckpt(start,
                               jv.init_params(jax.random.PRNGKey(7), cfg))
    return {"root": str(root), "paths": paths, "model_cfg": model_cfg,
            "start": start}


def argv(world, extra):
    p = world["paths"]
    return [
        "-visdial_processed_train", p["visdial_processed_train"],
        "-visdial_processed_val", p["visdial_processed_val"],
        "-visdial_processed_test", p["visdial_processed_test"],
        "-visdial_processed_train_dense", p["visdial_processed_train_dense"],
        "-visdial_processed_train_dense_annotations",
        p["visdial_processed_train_dense_annotations"],
        "-visdial_processed_val_dense_annotations",
        p["visdial_processed_val_dense_annotations"],
        "-visdial_image_feats", p["visdial_image_feats"],
        "-vocab_path", p["vocab_path"],
        "-model_config", world["model_cfg"],
        "-max_seq_len", "96", "-num_options", "20",
        "-num_workers", "2", "-eval_chunk", "64", "-dtype", "float32",
        "-save_path", os.path.join(world["root"], "ckpt"),
        "-language_weights", "/nonexistent", "-n_gpus", "1",
    ] + extra


def run(world, entry, extra, name, side):
    """``entry.main`` of one package on ``argv(world, extra)`` saving as
    ``<side>_<name>``, from the tree's root; returns (the state it returns,
    its save directory)."""
    save = f"{side}_{name}"
    cwd = os.getcwd()
    os.chdir(world["root"])
    try:
        args = argv(world, extra + ["-save_name", save])
        out = entry(args) if side == "jax" else entry(args, device="cpu")
    finally:
        os.chdir(cwd)
    return out, os.path.join(world["root"], "ckpt", save)


def ckpts(directory):
    return sorted(f for f in os.listdir(directory) if f.endswith(".ckpt"))


def load(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def assert_ckpts_match(got_path, want_path):
    """Two reference .ckpt files: the same keys in the same order, iter_id,
    param_groups and scheduler_state_dict equal; weights to WEIGHT_ATOL;
    exp_avg / exp_avg_sq to MOMENT_RTOL of the tensor's largest entry;
    the same Adam count in every ``step``."""
    got, want = load(got_path), load(want_path)
    assert list(got) == list(want)
    assert got["iter_id"] == want["iter_id"]
    assert list(got["model_state_dict"]) == list(want["model_state_dict"])
    for k, w in want["model_state_dict"].items():
        np.testing.assert_allclose(got["model_state_dict"][k].numpy(),
                                   w.numpy(), rtol=0, atol=WEIGHT_ATOL,
                                   err_msg=k)
    if "optimizer_state_dict" not in want:
        return
    go, wo = got["optimizer_state_dict"], want["optimizer_state_dict"]
    assert go["param_groups"] == wo["param_groups"]
    assert got["scheduler_state_dict"] == want["scheduler_state_dict"]
    assert list(go["state"]) == list(wo["state"])
    names = [k for k in want["model_state_dict"]
             if not k.endswith("cls.predictions.decoder.weight")]
    top = {key: max(float(s[key].abs().max()) for s in wo["state"].values())
           for key in ("exp_avg", "exp_avg_sq")}
    for i, w in wo["state"].items():
        g = go["state"][i]
        assert int(g["step"]) == int(w["step"]), i
        noise = names[i].endswith(ZERO_GRAD_SUFFIXES)
        for key in ("exp_avg", "exp_avg_sq"):
            ref = w[key].numpy()
            atol = (NOISE_RTOL * top[key] if noise
                    else MOMENT_RTOL * float(np.abs(ref).max()))
            np.testing.assert_allclose(g[key].numpy(), ref, rtol=0,
                                       atol=atol, err_msg=f"{names[i]} {key}")


def logged(directory, name):
    """The rows of a MetricsLogger CSV (x, line, y) without the time."""
    path = os.path.join(directory, "logs", name)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        rows = list(csv.reader(f))[1:]
    return [(int(r[1]), r[2], float(r[3])) for r in rows]


def assert_logs_match(got_dir, want_dir, name, atol=METRIC_ATOL):
    """The same (x, line) rows in two runs' CSV, in any order (JAX's jitted
    step returns its dict sorted by key), values to ``atol``."""
    got, want = sorted(logged(got_dir, name)), sorted(logged(want_dir, name))
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert want, f"nothing logged in {name}"
    for g, w in zip(got, want):
        assert abs(g[2] - w[2]) <= atol, (g, w)


def train_runs(world, names):
    """JAX's train CLI on each of ``names``: {name: (step, save dir)}."""
    from unimm_tpu.cli import train as j_train
    out = {}
    for name in names:
        state, save = run(world, j_train.main, TRAIN_RUNS[name] + [
            "-start_path", world["start"]], name, "jax")
        out[name] = (int(np.asarray(state["step"])), save)
    return out


def check_train_run(world, jax_runs, name):
    """The port's train CLI on ``name`` against JAX's run: the step count,
    the .ckpt files, the native directory and the logged val metrics."""
    from unimm_torch.cli import train as t_train
    want_step, want_dir = jax_runs[name]
    state, got_dir = run(world, t_train.main, TRAIN_RUNS[name] + [
        "-start_path", world["start"]], name, "torch")
    assert state["step"] == want_step > 0
    assert ckpts(got_dir) == ckpts(want_dir) != []
    for f in ckpts(got_dir):
        assert_ckpts_match(os.path.join(got_dir, f),
                           os.path.join(want_dir, f))
    steps = sorted(int(f.rsplit("_", 1)[1].split(".")[0])
                   for f in ckpts(got_dir))
    assert sorted(os.listdir(os.path.join(got_dir, "native"))) == sorted(
        f"step_{s}" for s in steps)
    if "-overfit" in TRAIN_RUNS[name]:
        assert_logs_match(got_dir, want_dir, "Retrieval_Val_Metrics.csv")
        assert_logs_match(got_dir, want_dir,
                          "Retrieval_Round_Val_Metrics.csv")
    else:
        # 2 epochs x (a pair + a remainder flush): 6 micro-steps, 3 updates
        assert state["step"] == 6
        assert state["opt"].count == state["opt"].sched_count == 3
    return state
