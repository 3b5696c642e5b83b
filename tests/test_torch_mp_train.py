"""The port's -mesh_mp axis against the JAX package and against itself, on
the CPU: four gloo ranks (``tests/_torch_dist_worker.py``, job ``mp``)
form a dp 2 x mp 2 world through the CLI flags, then two worlds of two
(ranks 0-1 at dp 2 x mp 1, ranks 2-3 at dp 1 x mp 2). Each dp index holds
its share of one global batch (test_torch_dist_train.py's uneven halves);
the ranks of an mp group hold the same rows and one model, sharded by the
JAX package's rules (``parallel/mesh.py``):

- one step of the dp 2 x mp 2 world, its gradients gathered whole, matches
  JAX's ``make_train_step`` on ``make_mesh(4, mp=2)`` with ``shard_params``
  at the port's bar (rtol 2e-4 / atol 2e-5); the same step with the losses
  and gradients summed over the world, not the dp group, fails it;
- at dropout 0.1, after 2 steps, (dp 1, mp 2) is bit-equal to one process
  and (dp 2, mp 2) to (dp 2, mp 1); each mp group's replicated tensors are
  bit-equal; seeding dropout by the world rank breaks the first equality;
- each rank holds the bytes the layout says, with no whole tensor kept
  alive behind a slice;
- the CLIs at (dp 1, mp 2): a ``.ckpt`` saved at mp 2 holds the
  one-process file's tensors bit for bit; it resumes at mp 1, and the
  one-process save resumes at mp 2, each resumed epoch bit-equal to the
  one-process run resumed from its own save; ``val_lm``, ``val`` and
  ``evaluate`` serving write the one-process predictions files byte for
  byte; ``dense_finetune`` gives the one-process ``.ckpt``;
- ``train -mesh_mp 2`` in the world of 4 against JAX's in-process ``train
  -n_gpus 4 -mesh_mp 2`` (the fixture tree, the zero-dropout TINY config
  and the shared start ``.ckpt`` of ``tests/_torch_cli_common.py``, held
  to its tolerances).
"""

import dataclasses
import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import _torch_cli_common as cc
from tests import _torch_dist_worker as W
from tests.test_torch_dist_train import (CFG, DROP_CFG, NSP_WEIGHT,
                                         assert_close, flat, to_jax,
                                         torch_tree)
from unimm_torch.checkpoint import state_dict_from_jax
from unimm_torch.cli import dense_finetune as t_dense
from unimm_torch.cli import evaluate as t_evaluate
from unimm_torch.cli import train as t_train
from unimm_torch.cli import val as t_val
from unimm_torch.cli import val_lm as t_val_lm
from unimm_torch.models import vilbert
from unimm_torch.parallel import mesh
from unimm_tpu.cli import train as j_train
from unimm_tpu.models import vilbert as jv
from unimm_tpu.parallel import mesh as pmesh
from unimm_tpu.train import step as jstep

# 6 train dialogs, 2 images (40 sequences) a global batch: 3 steps an
# epoch, one image a dp index; every sequence kept (no subsample), so the
# port's world and JAX's one process see the same global batches
TRAIN = ["-num_epochs", "1", "-batch_size", "40", "-sequences_per_image",
         "20", "-num_negative_samples", "1", "-eval_every_epochs", "100",
         "-save_every_epochs", "1"]
DENSE = ["-num_epochs", "1", "-batch_multiply", "2", "-length_buckets", "1",
         "-auto_resume"]
RANK_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_mp")
    w = cc.make_world(out / "tree")
    params = jv.init_params(jax.random.PRNGKey(3), CFG)
    torch.save(state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          params)),
               str(out / "weights.pt"))
    for name, c in (("cfg", CFG), ("drop_cfg", DROP_CFG)):
        (out / f"{name}.json").write_text(json.dumps(dataclasses.asdict(c)))
    rng = np.random.default_rng(11)
    flats = {"r0f0": flat(rng, 3, 2, 0, 0.1), "r0f1": flat(rng, 3, 2, 0, 0.1),
             "r1f0": flat(rng, 3, 10, None, 0.6),
             "r1f1": flat(rng, 3, 10, None, 0.6)}
    np.savez(str(out / "batches.npz"), **{
        f"{f}_{k}": v for f, b in flats.items() for k, v in b.items()})
    # the one-process save the world resumes from
    with W.rank_threads():
        _, one_save = cc.run(w, t_train.main, TRAIN + [
            "-start_path", w["start"]], "one", "torch")
    spec = {"out": str(out / "out"), "root": w["root"],
            "weights": str(out / "weights.pt"), "cfg": str(out / "cfg.json"),
            "drop_cfg": str(out / "drop_cfg.json"),
            "batches": str(out / "batches.npz"), "nsp_weight": NSP_WEIGHT,
            "ports": [W._free_port(), W._free_port()],
            "argv": cc.argv(w, [])[:-2],            # without -n_gpus 1
            "train": TRAIN + ["-start_path", w["start"]],
            "val_lm": ["-val_dis", "0", "-start_path", w["start"]],
            "ensemble": ["-model_paths", f"{w['start']},{w['start']}"],
            "dense": DENSE + ["-start_path", w["start"]],
            "resume_one": ["-continue", "-start_path",
                           os.path.join(one_save, "native")]}
    collect = W.launch("mp", spec, world=4, timeout=RANK_TIMEOUT_S)
    glob = {k: np.concatenate([flats[f][k] for f in flats])
            for k in flats["r0f0"]}
    return {"collect": collect, "spec": spec, "params": params,
            "global": glob, "tree": w, "one_save": one_save}


@pytest.fixture(scope="module")
def jax_step(world):
    """JAX's gradients of one step on the global batch, dp 2 x mp 2."""
    m = pmesh.make_mesh(4, mp=2)
    params, _ = pmesh.shard_params(world["params"], m)
    tx = optax.identity()
    step = jstep.make_train_step(CFG, tx, dtype=jnp.float32, donate=False,
                                 mesh=m)
    state = jstep.init_state(params, tx, seed=0)
    new, _ = step(state, pmesh.shard_batch(to_jax(world["global"]), m),
                  jnp.asarray(NSP_WEIGHT))
    old, upd = torch_tree(world["params"]), torch_tree(new["params"])
    return {k: upd[k] - old[k] for k in old}


@pytest.fixture(scope="module")
def jax_cli(world):
    """JAX's ``train -n_gpus 4 -mesh_mp 2`` on the fixture tree."""
    return cc.run(world["tree"], j_train.main, world["spec"]["train"] + [
        "-n_gpus", "4", "-mesh_mp", "2"], "dp2mp2", "jax")[1]


@pytest.fixture(scope="module")
def one_process(world):
    """The port's one-process runs: the 2 steps at dropout 0.1 on the
    whole batch, val_lm, val, evaluate, dense_finetune and the resume
    from its own save."""
    w, spec = world["tree"], world["spec"]
    with np.load(spec["batches"]) as z:
        batch = W._global_flat(dict(z), [0, 1])
    with W.rank_threads():
        model, _, _ = W.mp_steps(spec, spec["drop_cfg"], batch, 2, "cpu")
        cc.run(w, t_val_lm.main, spec["val_lm"], "lm", "torch")
        cc.run(w, t_val.main, spec["ensemble"], "val", "torch")
        cc.run(w, t_evaluate.main, spec["ensemble"], "ev", "torch")
        _, dense = cc.run(w, t_dense.main, spec["dense"], "dense", "torch")
        _, from_one = cc.run(w, t_train.main, TRAIN + spec["resume_one"],
                             "from_one", "torch")
    weights = {n: p.detach().numpy().copy()
               for n, p in model.named_parameters()}
    return {"weights": weights, "dense": dense, "from_one": from_one}


@pytest.fixture(scope="module")
def ranks(world, jax_step, jax_cli, one_process):
    """The ranks' results, collected after the oracles ran."""
    return world["collect"]()


def arrays(res, prefix):
    return {k[len(prefix) + 1:]: v for k, v in res[0].items()
            if k.startswith(prefix + "/")}


def assert_bit_equal(got, want):
    assert got.keys() == want.keys() and got
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def ckpt_tensors(path):
    """(iter_id, {name: tensor}) of a reference .ckpt: its weights and
    both moments."""
    blob = cc.load(path)
    out = {k: v for k, v in blob["model_state_dict"].items()}
    for i, s in blob["optimizer_state_dict"]["state"].items():
        out[f"exp_avg/{i}"], out[f"exp_avg_sq/{i}"] = (s["exp_avg"],
                                                       s["exp_avg_sq"])
    return blob["iter_id"], out


def assert_ckpts_bit_equal(got_dir, want_dir):
    assert cc.ckpts(got_dir) == cc.ckpts(want_dir) != []
    for name in cc.ckpts(want_dir):
        (gi, g), (wi, w) = (ckpt_tensors(os.path.join(d, name))
                            for d in (got_dir, want_dir))
        assert gi == wi and list(g) == list(w)
        for k in w:
            assert torch.equal(g[k], w[k]), (name, k)


def test_grid(ranks):
    for r, (_, info) in enumerate(ranks):
        assert info["grid"] == [r // 2, 2, r % 2, 2]
        assert info["sub_grid"] == ([r, 2, 0, 1] if r < 2
                                    else [0, 1, r % 2, 2])


@pytest.mark.parametrize("port", ["dp_group", "world_sum"])
def test_step_gradient_matches_jax(ranks, jax_step, port):
    """The gathered gradient of the dp 2 x mp 2 step is JAX's; summing the
    losses and gradients over the world instead of the dp group fails the
    same check."""
    prefix = {"dp_group": "mp_grad", "world_sum": "world_sum_grad"}[port]
    got = [arrays(res, prefix) for res in ranks]
    for g in got[1:]:
        assert_bit_equal(g, got[0])
    if port == "world_sum":
        with pytest.raises(AssertionError):
            assert_close(got[0], jax_step)
    else:
        assert_close(got[0], jax_step)


@pytest.mark.parametrize("pair", ["dp1mp2_vs_one", "dp2mp2_vs_dp2mp1",
                                  "rank_seed_vs_one"])
def test_bit_equal_at_dropout(ranks, one_process, pair):
    """At dropout 0.1, 2 steps: an mp group of the one-process rows is one
    process, and the mp axis changes nothing at dp 2; dropout seeded by
    the world rank (the wrong port) is not one process."""
    if pair == "dp2mp2_vs_dp2mp1":
        for r in range(4):
            assert_bit_equal(arrays(ranks[r], "dp2mp2"),
                             arrays(ranks[r // 2], "dp2mp1"))
        return
    prefix = "dp1mp2" if pair == "dp1mp2_vs_one" else "rank_seed"
    for r in (2, 3):
        got = arrays(ranks[r], prefix)
        if pair == "rank_seed_vs_one":
            assert got.keys() == one_process["weights"].keys()
            assert any(not np.array_equal(got[k], v)
                       for k, v in one_process["weights"].items())
        else:
            assert_bit_equal(got, one_process["weights"])


def test_replicated_bit_equal_across_mp_group(ranks):
    infos = [info for _, info in ranks]
    assert infos[0]["replicated_sha"] == infos[1]["replicated_sha"]
    assert infos[2]["replicated_sha"] == infos[3]["replicated_sha"]
    assert infos[2]["sub_replicated_sha"] == infos[3]["sub_replicated_sha"]


def test_rank_holds_the_layout_s_bytes(world, ranks):
    """Each rank's parameters take the layout's bytes, storage included
    (no slice keeps its whole tensor alive), and its moments their
    shapes."""
    with torch.device("meta"):
        model = vilbert.VilbertModel(CFG)
    dims = mesh.layout_dims(model, 2)
    whole = sum(p.numel() * 4 for p in model.parameters())
    want = sum((p.numel() // 2 if n in dims else p.numel()) * 4
               for n, p in model.named_parameters())
    assert dims and want < whole
    for _, info in ranks:
        assert info["param_bytes"] == info["storage_bytes"] == want
        assert info["moments_like_params"]


def test_ckpt_at_mp2_is_one_process_s(world, ranks):
    root = world["tree"]["root"]
    assert_ckpts_bit_equal(os.path.join(root, "ckpt", "mp_save"),
                           world["one_save"])


@pytest.mark.parametrize("resume", ["mp2_to_mp1", "mp1_to_mp2"])
def test_resume_across_mp(world, ranks, one_process, resume):
    """A save resumes at the other mp size, bit-equal to the one-process
    run resumed from its own save."""
    root = world["tree"]["root"]
    if resume == "mp1_to_mp2":
        got = os.path.join(root, "ckpt", "mp_from_one")
    else:
        with W.rank_threads():
            _, got = cc.run(world["tree"], t_train.main, TRAIN + [
                "-continue", "-start_path",
                os.path.join(root, "ckpt", "mp_save", "native")],
                "from_mp2", "torch")
    assert_ckpts_bit_equal(got, one_process["from_one"])


@pytest.mark.parametrize("cli", ["lm", "val", "ev"])
def test_serving_predictions_byte_equal(world, ranks, one_process, cli):
    """val_lm, val (an ensemble) and evaluate (the test split) serving at
    -mesh_mp 2 write the one-process predictions file."""
    root = world["tree"]["root"]
    with open(os.path.join(root, f"mp_{cli}_predictions.txt"), "rb") as f:
        got = f.read()
    with open(os.path.join(root, f"torch_{cli}_predictions.txt"),
              "rb") as f:
        want = f.read()
    assert got == want and len(json.loads(want)) > 0


def test_dense_ckpt_is_one_process_s(world, ranks, one_process):
    assert_ckpts_bit_equal(os.path.join(world["tree"]["root"], "ckpt",
                                        "mp_dense"), one_process["dense"])


def test_train_cli_matches_jax(world, ranks, jax_cli):
    got = os.path.join(world["tree"]["root"], "ckpt", "mp_dp2mp2")
    assert cc.ckpts(got) == cc.ckpts(jax_cli) == [
        "visdial_dialog_encoder_3.ckpt"]
    cc.assert_ckpts_match(os.path.join(got, "visdial_dialog_encoder_3.ckpt"),
                          os.path.join(jax_cli,
                                       "visdial_dialog_encoder_3.ckpt"))
