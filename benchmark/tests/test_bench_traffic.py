"""The traffic generator against the program's synthetic workloads
(``unimm_torch/workload.py``): the same layouts, keys, dtypes and
distributions of sizes; the same seed gives the same inputs, and every
seed the same sizes."""

import numpy as np
import pytest

from benchmark.harness import traffic
from benchmark.harness import spec as spec_mod
from benchmark.tests._tiny import GROWTH, NARROW_MODEL
from unimm_torch import workload
from unimm_torch.config import VilbertConfig

CFG = dict(NARROW_MODEL, max_seq_len=256)
PCFG = VilbertConfig.from_dict(CFG)
SLATES = {"kind": "slates", "dialogs": 8, "rounds": 10, "options": 20,
          "ctx_growth": GROWTH, "ans_range": [2, 9], "loader_batch": 2,
          "coalesce": 2, "size_seed": 5}


def _slate_rule(b, gen: bool):
    """Every option of a slate shares its context; the answer follows it
    (and, generative, its masked copy carrying the labels)."""
    B, R, O, L = b["tokens"].shape
    for d in range(B):
        for r in range(R):
            ce, al = b["ctx_end"][d, r], b["ans_len"][d, r]
            lc = int(ce[0] - al[0]) if gen else None
            for o in range(O):
                t = b["tokens"][d, r, o]
                if gen:
                    a = int(al[o])
                    assert ce[o] - a == lc
                    assert (t[lc + a:lc + 2 * a] == t[lc:lc + a]).all()
                    lab = b["mlm_labels"][d, r, o]
                    assert (lab[lc + a:lc + 2 * a] == t[lc:lc + a]).all()
                    assert (lab[:lc + a] == -1).all()
                    assert (t[lc + 2 * a:] == 0).all()
                else:
                    assert (t[ce[o]:] == 0).all() and (t[:ce[o]] > 0).all()
                assert (t[1:min(ce[:3].min(), 20)]
                        == b["tokens"][d, r, 0, 1:min(ce[:3].min(), 20)]
                        ).all()


@pytest.mark.parametrize("layout", ["gen", "dis"])
def test_slates_layout_like_workload(layout):
    mix = dict(SLATES, layout=layout)
    pool, order = traffic.make(mix, CFG, 12345)
    b = pool[0]
    make = (workload.make_val_batch if layout == "gen"
            else workload.make_dis_batch)
    w = make(np.random.default_rng(0), PCFG, 2, 10, 20,
             ctx_range_fn=workload.realistic_ctx_range(256),
             feat_dim=CFG["v_feature_size"])
    for k in b:
        assert b[k].shape == w[k].shape, k
        assert b[k].dtype == w[k].dtype or k == "image_mask", k
    _slate_rule(b, layout == "gen")
    assert sorted(order.tolist()) == list(range(len(pool) // 2))


@pytest.mark.parametrize("name", ["visdial-val-gen-realistic",
                                  "visdial-val-dis-realistic"])
def test_slate_sizes_follow_workload_distribution(name):
    growth = spec_mod._load_json(
        spec_mod.ROOT / "benchmark" / "traffic" / f"{name}.json")["ctx_growth"]
    mix = dict(SLATES, layout="gen", dialogs=400, options=4,
               ctx_growth=growth)
    lc, a = traffic.slate_sizes(mix, 256)
    fn = workload.realistic_ctx_range(256)
    for r in range(10):
        lo, hi = fn(r)
        assert lc[:, r].min() >= lo and lc[:, r].max() < hi
        assert abs(lc[:, r].mean() - (lo + hi - 1) / 2) < 0.1 * (hi - lo)
    assert a.min() == 2 and a.max() == 8


def test_seed_changes_contents_not_sizes():
    mix = dict(SLATES, layout="gen")
    p1, _ = traffic.make(mix, CFG, 2 ** 33 + 1)
    p1b, _ = traffic.make(mix, CFG, 2 ** 33 + 1)
    p2, _ = traffic.make(mix, CFG, 7)
    assert all((p1[0][k] == p1b[0][k]).all() for k in p1[0])
    assert (p1[0]["ctx_end"] == p2[0]["ctx_end"]).all()
    assert not (p1[0]["tokens"] == p2[0]["tokens"]).all()


def test_train_batch_like_workload():
    mix = {"kind": "train", "batch": 40, "pool": 2, "ctx_range": [60, 200],
           "ans_range": [2, 9], "labels_range": [10, 40],
           "unlikelihood_share": 0.25, "size_seed": 3}
    pool, order = traffic.make(mix, CFG, 99)
    w = workload.make_train_batch(np.random.default_rng(0), PCFG, 40)
    b = pool[0]
    assert sorted(b) == sorted(w)
    for k in b:
        assert b[k].shape == w[k].shape and b[k].dtype == w[k].dtype, k
    n = (b["mlm_labels"] != -1).sum(-1)
    assert n.min() >= 10 and n.max() < 40
    assert (b["lm_weight"][:10][b["mlm_labels"][:10] != -1] == -1).all()
    assert (b["lm_weight"][10:][b["mlm_labels"][10:] != -1] == 1).all()
    assert ((b["mlm_labels"] != -1) <= (np.arange(256) < b["ctx_end"][:, None]
                                         - 1)).all()
    np.testing.assert_allclose(b["image_target"].sum(-1), 1.0, rtol=1e-5)
    assert sorted(order.tolist()) == [0, 1]
