"""The port's data-parallel training step against the JAX package, on the
CPU: two gloo ranks (``tests/_torch_dist_worker.py``, job ``train``, each
joining through the CLI flags) hold their shares of one global batch, and
JAX runs one process on the concatenated batch as the oracle: its
``make_train_step`` and ``make_dense_step`` with ``optax.identity()`` as
the update, so JAX's new weights less its old ones are its gradients.

The two ranks' halves differ on purpose: rank 0 holds only NSP label 0,
two LM labels a sequence and few masked regions; rank 1 mixed NSP labels,
ten LM labels a sequence and many masked regions. JAX divides each loss by
the global batch's counts, so:

- the port's step (each rank's local sum over the world's all-reduced
  counts, gradients summed over the ranks) matches JAX's gradients at the
  port's bar, rtol 2e-4 / atol 2e-5 (tests/test_prefix_kernel.py:65), and
  leaves both ranks' weights bit-equal; its batches hold one row per image
  (``img_index``, as the train CLI stages them), so the masked regions are
  counted a sequence, not an image;
- the same step as a DDP default would run it (each rank's loss over its
  own counts, gradients averaged) fails that same check: the negative
  case of ``test_step_gradient_matches_jax``;
- two length-bucketed morsels a rank under accumulation, their bucket
  lengths and normalisers synced across the ranks, give the same
  gradient (the mean over the morsels is the whole group's gradient);
- the dense step on a 99-row slate padded to 100 (50 rows a rank, the
  last one padding) gathers the NSP logits with their gradient and matches
  JAX's unpadded single-process step, so the padding row adds nothing;
- at dropout 0.1 two ranks given the same rows draw different masks (the
  rank enters the seed); the one-process stream is unchanged.

All on TINY (tests/test_model.py) at weight std 0.2, fp32, attention
"xla", all dropouts 0 but in the dropout case.
"""

import dataclasses
import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import _torch_dist_worker as W
from tests.test_model import TINY, make_batch
from unimm_torch.checkpoint import state_dict_from_jax
from unimm_torch.train import step as tstep
from unimm_tpu.cli import dense_finetune as jdense
from unimm_tpu.models import vilbert as jv
from unimm_tpu.train import step as jstep

NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               v_hidden_dropout_prob=0.0, v_attention_probs_dropout_prob=0.0,
               head_dropout_prob=0.0)
CFG = TINY.replace(initializer_range=0.2, **NO_DROP)
DROP_CFG = TINY.replace(initializer_range=0.2)
NSP_WEIGHT = [1.0, 2.0]
N_REAL = 99                 # the dense slate: padded to 100 over 2 ranks
IMG_KEYS = ("image_feat", "image_loc", "image_mask", "image_target",
            "image_label")
RTOL, ATOL = 2e-4, 2e-5


def flat(rng, n, n_lab, nsp, regions):
    """A flat training batch of ``n`` TINY sequences: mixed dis / gen
    descriptors of varied extent, ``n_lab`` LM labels inside each extent
    (the first sequence's unlikelihood), NSP labels ``nsp`` (None: random)
    and masked regions with probability ``regions``."""
    L, R = CFG.max_seq_len, CFG.max_regions
    b = {k: np.asarray(v) for k, v in make_batch(rng, CFG, B=n).items()}
    b["mode"] = rng.integers(0, 2, n).astype(np.int32)
    b["ctx_end"] = rng.integers(8, 22, n).astype(np.int32)
    b["ans_len"] = rng.integers(1, 8, n).astype(np.int32)
    labels = np.full((n, L), -1, np.int32)
    for i in range(n):
        pos = rng.permutation(np.arange(1, b["ctx_end"][i]))[:n_lab]
        labels[i, pos] = rng.integers(0, CFG.vocab_size, len(pos))
    w = (labels != -1).astype(np.float32)
    w[0][labels[0] != -1] = -1.0
    b.update(mlm_labels=labels, lm_weight=w,
             next_sentence_label=(np.full(n, nsp, np.int32) if nsp is not None
                                  else rng.integers(0, 2, n).astype(np.int32)),
             image_target=rng.dirichlet(np.ones(CFG.v_target_size),
                                        (n, R)).astype(np.float32),
             image_label=np.where(rng.random((n, R)) < regions, 1,
                                  rng.choice([-1, 0], (n, R))).astype(
                                      np.int32))
    for k in IMG_KEYS:                  # one image for the flat's rows
        b[k] = np.repeat(b[k][:1], n, axis=0)
    return b


def slate(rng):
    """A dense slate of N_REAL options of one image: the GT first (NSP
    label 0), the others label 1, and a relevance vector."""
    b = flat(rng, N_REAL, 3, 1, 0.3)
    b["next_sentence_label"][0] = 0
    rel = np.where(rng.random(N_REAL) < 0.1,
                   rng.choice([0.5, 1.0], N_REAL), 0.0).astype(np.float32)
    rel[0] = 1.0
    return b, rel


def torch_tree(tree):
    return {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_dist_train")
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
    sl, rel = slate(rng)
    arrays = {f"{f}_{k}": v for f, b in flats.items() for k, v in b.items()}
    arrays.update({f"slate_{k}": v for k, v in sl.items()})
    arrays["slate_gt_relevance"] = rel
    np.savez(str(out / "batches.npz"), **arrays)
    collect = W.launch("train", {
        "out": str(out), "weights": str(out / "weights.pt"),
        "cfg": str(out / "cfg.json"), "drop_cfg": str(out / "drop_cfg.json"),
        "batches": str(out / "batches.npz"), "nsp_weight": NSP_WEIGHT})
    glob = {k: np.concatenate([flats[f][k] for f in flats])
            for k in flats["r0f0"]}
    return {"collect": collect, "params": params, "global": glob,
            "slate": sl, "rel": rel}


@pytest.fixture(scope="module")
def ranks(world, jax_step, jax_dense):
    """The ranks' results, collected after the JAX oracles ran."""
    return world["collect"]()


@pytest.fixture(scope="module")
def jax_step(world):
    """JAX's gradients and loss parts on the concatenated global batch."""
    tx = optax.identity()
    step = jstep.make_train_step(CFG, tx, dtype=jnp.float32, donate=False)
    state = jstep.init_state(world["params"], tx, seed=0)
    new, m = step(state, to_jax(world["global"]), jnp.asarray(NSP_WEIGHT))
    old, upd = torch_tree(world["params"]), torch_tree(new["params"])
    return {k: upd[k] - old[k] for k in old}, {k: float(v)
                                               for k, v in m.items()}


@pytest.fixture(scope="module")
def jax_dense(world):
    """JAX's dense step on the unpadded slate, one process."""
    tx = optax.identity()
    step = jdense.make_dense_step(CFG, tx, dtype=jnp.float32, n_real=N_REAL)
    params = jax.tree_util.tree_map(jnp.array, world["params"])
    state = {"params": params, "opt_state": tx.init(params),
             "step": jnp.zeros((), jnp.int32),
             "rng": jax.random.PRNGKey(0)}
    old = torch_tree(world["params"])
    new, parts = step(state, to_jax(world["slate"]),
                      jnp.asarray(world["rel"]))
    upd = torch_tree(new["params"])
    return {k: upd[k] - old[k] for k in old}, {k: float(v)
                                               for k, v in parts.items()}


def grads(arrays, prefix):
    return {k[len(prefix) + 1:]: v for k, v in arrays.items()
            if k.startswith(prefix + "/")}


def assert_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def assert_ranks_equal(res, prefix):
    a, b = (grads(r[0], prefix) for r in res)
    assert a.keys() == b.keys() and a
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("port", ["world_denominators", "rank_mean"])
def test_step_gradient_matches_jax(ranks, jax_step, port):
    """The summed gradient equals JAX's on the global batch; the rank-mean
    port (a DDP default) fails the same check on these uneven halves."""
    prefix = {"world_denominators": "step_grad", "rank_mean": "mean_grad"}
    assert_ranks_equal(ranks, prefix[port])
    got = grads(ranks[0][0], prefix[port])
    if port == "rank_mean":
        with pytest.raises(AssertionError):
            assert_close(got, jax_step[0])
    else:
        assert_close(got, jax_step[0])


def test_step_weights_bit_equal_and_losses_global(ranks, jax_step):
    assert_ranks_equal(ranks, "step_param")
    for key in ("loss", "lm_loss", "nsp_loss", "img_loss"):
        for _, info in ranks:
            assert info["step_metrics"][key] == pytest.approx(
                jax_step[1][key], rel=1e-5), key


def test_morsels_match_jax(world, ranks, jax_step):
    """Two morsels a rank, accumulated: the ranks agree on each morsel's
    bucket length and on the group normalisers, and the applied gradient
    is JAX's on the global batch."""
    infos = [info for _, info in ranks]
    assert infos[0]["morsel_lengths"] == infos[1]["morsel_lengths"]
    assert infos[0]["morsel_norms"] == infos[1]["morsel_norms"]
    g = world["global"]
    nsl = g["next_sentence_label"]
    assert infos[0]["morsel_norms"] == [
        (g["lm_weight"] != 0).sum() / 2, (g["image_label"] == 1).sum() / 2,
        (nsl == 0).sum() / 2, (nsl == 1).sum() / 2]
    assert min(infos[0]["morsel_lengths"]) < CFG.max_seq_len
    assert_ranks_equal(ranks, "morsel_grad")
    assert_close(grads(ranks[0][0], "morsel_grad"), jax_step[0])


def test_dense_step_matches_jax(ranks, jax_dense):
    """The padded slate's 50-row blocks, the NSP logits gathered with
    their gradient: JAX's gradient and loss parts on the unpadded slate."""
    assert [info["slate_rows"] for _, info in ranks] == [50, 50]
    assert_ranks_equal(ranks, "dense_grad")
    assert_close(grads(ranks[0][0], "dense_grad"), jax_dense[0])
    for key in ("loss", "lm_loss", "nsp_loss", "rank_loss", "ce_loss",
                "qfocal_loss"):
        for _, info in ranks:
            assert info["dense_parts"][key] == pytest.approx(
                jax_dense[1][key], rel=1e-5, abs=1e-7), key


def test_dropout_streams(ranks):
    """The rank enters the dropout seed: the same rows draw different
    masks on the two ranks; the one-process stream (no rank) is the same
    on both and is the seed the existing tests hold."""
    a, b = (info["dropout_losses"] for _, info in ranks)
    assert a["rank_seed"] != b["rank_seed"]
    assert a["one_process_seed"] == b["one_process_seed"]
    assert tstep.step_seed(5, 7) == tstep.step_seed(5, 7, None) == int(
        np.random.SeedSequence([5, 7]).generate_state(1, np.uint64)[0])
    assert tstep.step_seed(5, 7, 0) != tstep.step_seed(5, 7, 1)
