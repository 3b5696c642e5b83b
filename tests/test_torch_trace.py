"""The program's spans and counters (``unimm_torch/utils/trace.py``): off,
they record nothing; on, their nesting, parents, ids and self times; the
eval spans and the scorers' row counters on a tiny CPU config (counted by
hand); the training step's spans; and the ranges under a CPU
``torch.profiler`` session."""

import threading
import time

import numpy as np
import pytest
import torch

from unimm_torch.cli.train import to_device
from unimm_torch.config import VilbertConfig
from unimm_torch.eval import evaluator as tev
from unimm_torch.models import vilbert as tv
from unimm_torch.train import optim as topt
from unimm_torch.train import step as tstep
from unimm_torch.utils import trace

# the JAX suite's TINY shapes (tests/test_model.py), without JAX
CFG = VilbertConfig(
    vocab_size=100, hidden_size=32, num_hidden_layers=2,
    num_attention_heads=2, intermediate_size=64, max_position_embeddings=64,
    v_feature_size=16, v_target_size=11, v_hidden_size=24,
    v_num_hidden_layers=2, v_num_attention_heads=2, v_intermediate_size=48,
    bi_hidden_size=16, bi_num_attention_heads=2, v_biattention_id=(1,),
    t_biattention_id=(1,), max_seq_len=32, max_regions=5)
L = CFG.max_seq_len


@pytest.fixture(autouse=True)
def fresh():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    m = tv.empty_model(CFG, "cpu")
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0.0, 0.2)
    return m


def _order(snap):
    """(name, id) of every recorded span, by start."""
    rows = [(s, n, i) for n, d in snap["spans"].items()
            for s, i in zip(d["start"], d["id"])]
    return [(n, i) for _, n, i in sorted(rows)]


# --- the module --------------------------------------------------------------

def test_off_records_nothing():
    assert trace.span("a") is trace.span("b")
    with trace.span("a") as sid:
        trace.count("c", 5)
    assert sid is None
    assert trace.snapshot() == {"spans": {}, "counts": {}}


def test_nesting_parents_ids_and_self_time():
    trace.enable()
    with trace.span("root") as rid:
        with trace.span("a") as aid:
            time.sleep(0.002)
            with trace.span("b"):
                time.sleep(0.002)
        with trace.span("a"):
            time.sleep(0.001)

        def worker():
            # a thread with no span open: the innermost of the thread
            # that enabled the recorder
            with trace.span("w"):
                pass
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    with trace.span("root") as rid2:
        pass
    with trace.span("step", id=7):
        with trace.span("inner") as iid:
            trace.count("c", np.int64(3))
            trace.count("c")
    snap = trace.snapshot()
    sp = snap["spans"]
    assert aid == rid and rid2 != rid and iid == 7
    assert sp["root"]["parent"] == [None, None]
    assert sp["root"]["id"] == [rid, rid2]
    assert sp["a"]["parent"] == ["root", "root"]
    assert sp["b"]["parent"] == ["a"] and sp["b"]["id"] == [rid]
    assert sp["w"]["parent"] == ["root"] and sp["w"]["id"] == [rid]
    assert sp["inner"]["id"] == [7] and sp["inner"]["parent"] == ["step"]
    assert snap["counts"] == {"c": 4}
    for d in sp.values():
        np.testing.assert_allclose(
            d["dur"], np.subtract(d["end"], d["start"]), rtol=0, atol=0)

    def dur(name, k=0):
        return sp[name]["end"][k] - sp[name]["start"][k]

    kids = dur("a", 0) + dur("a", 1) + dur("w")
    assert sp["root"]["self"][0] == pytest.approx(dur("root") - kids,
                                                  abs=1e-12)
    assert sp["a"]["self"][0] == pytest.approx(dur("a") - dur("b"),
                                               abs=1e-12)
    assert sp["a"]["self"][1] == pytest.approx(dur("a", 1), abs=1e-12)
    assert sp["a"]["self"][0] >= 0.0015


def test_reset_and_disable():
    trace.enable()
    with trace.span("x"):
        trace.count("n", 2)
    trace.disable()
    with trace.span("y"):
        trace.count("n", 2)
    snap = trace.snapshot()
    assert list(snap["spans"]) == ["x"] and snap["counts"] == {"n": 2}
    trace.reset()
    assert trace.snapshot() == {"spans": {}, "counts": {}}


def test_capture_keeps_only_inside_its_block():
    trace.keep("a", 1)
    assert not trace.capturing()
    with trace.capture() as outer:
        trace.keep("a", 1)
        with trace.capture() as inner:
            assert trace.capturing()
            trace.keep("a", 2)
            trace.keep("b", torch.ones(2))
        trace.keep("a", 3)
    trace.keep("a", 4)
    assert not trace.capturing()
    assert outer == {"a": [1, 3]}
    assert inner["a"] == [2] and inner["b"][0].tolist() == [1.0, 1.0]
    # the recorder neither sees nor counts what a capture keeps
    assert trace.snapshot() == {"spans": {}, "counts": {}}


def test_ranges_under_the_profiler():
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        with trace.span("outer"):
            with trace.span("inner"):
                torch.ones(4).add_(1)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "unimm.outer" in names and "unimm.inner" in names
    # the profiler alone leaves the recorder empty
    assert trace.snapshot() == {"spans": {}, "counts": {}}


# --- the scorers -------------------------------------------------------------

def _slates(rng, lcs, ans, mode=1):
    """A [1, R, O] val batch: slate r's context of ``lcs[r]`` tokens and
    option o's answer of ``ans[r][o]`` tokens (encode_gen's layout:
    first copy, masked copy, labels on the copy); ``mode`` 0 makes
    discriminative sequences of extent ``lcs[r] + ans[r][o]``."""
    R, O = len(lcs), len(ans[0])
    tok = np.zeros((1, R, O, L), np.int32)
    seg = np.zeros_like(tok)
    lab = np.full_like(tok, -1)
    ce = np.zeros((1, R, O), np.int32)
    al = np.zeros_like(ce)
    for r, lc in enumerate(lcs):
        ctx = rng.integers(1, CFG.vocab_size, lc)
        for o, a in enumerate(ans[r]):
            tok[0, r, o, :lc] = ctx
            tok[0, r, o, lc:lc + a] = rng.integers(1, CFG.vocab_size, a)
            ce[0, r, o] = lc + a
            if mode == 1:
                tok[0, r, o, lc + a:lc + 2 * a] = tok[0, r, o, lc:lc + a]
                lab[0, r, o, lc + a:lc + 2 * a] = tok[0, r, o, lc:lc + a]
                al[0, r, o] = a
    Rg = CFG.max_regions
    return {"tokens": tok, "segments": seg, "mlm_labels": lab,
            "mode": np.full((1, R, O), mode, np.int32), "ctx_end": ce,
            "ans_len": al,
            "image_feat": rng.normal(size=(1, Rg, CFG.v_feature_size))
            .astype(np.float32),
            "image_loc": rng.normal(size=(1, Rg, 5)).astype(np.float32),
            "image_mask": np.ones((1, Rg), np.float32)}


LCS = [10, 7, 12]
ANS = [[1, 3, 2, 4], [2, 2, 1, 1], [4, 1, 3, 2]]


@pytest.mark.parametrize("packed", [True, False])
def test_prefix_spans_and_rows(model, packed):
    """Three slates in groups of 2 (by context: [7, 10], then [12] and a
    padding copy): context buckets of 12 (multiples of L / 8 = 4); the
    packed layout's P is 256 (row block 64, rounded to 256), the W
    layout's W 16."""
    batch = _slates(np.random.default_rng(0), LCS, ANS)
    ev = tev.RankingEvaluator(CFG, chunk_size=8, dtype=torch.float32,
                              need_nsp=False, prefix_group=2,
                              prefix_packed=packed, device="cpu")
    trace.enable()
    ev.score_slates(model, batch)
    snap = trace.snapshot()
    order = _order(snap)
    did = order[0][1]
    assert {i for _, i in order} == {did}
    # plan, the context rows, the prefill, the answer rows (packed or W),
    # the answer pass
    group = ["eval.plan", "eval.pack", "eval.h2d", "eval.prefill",
             "eval.pack", "eval.h2d", "eval.answer"]
    assert [n for n, _ in order] == (
        ["eval.dispatch", "eval.plan", "eval.h2d", "eval.plan"] + group * 2
        + ["eval.fetch"])
    c = snap["counts"]
    rows = [2 * a for r in ANS for a in r]
    assert c["eval.dispatches"] == 1
    assert c["eval.rows_needed.prefill"] == sum(LCS)
    assert c["eval.rows_launched.prefill"] == 2 * 2 * 12
    assert c["eval.rows_needed.answer"] == sum(rows)
    assert c["eval.rows_launched.answer"] == (2 * 2 * 256 if packed
                                              else 2 * 2 * 4 * 16)
    assert not any(k.endswith(".flat") for k in c)
    assert snap["spans"]["eval.fetch"]["parent"] == [None]


def test_flat_chunk_rows(model):
    """Six discriminative sequences in chunks of 4, sorted by extent
    [3, 5, 9, 11] and [17, 22] plus two padding copies: buckets of 12 and
    24 (multiples of L / 8 = 4)."""
    lcs, ans = [2, 7, 15], [[1, 3], [2, 4], [2, 7]]
    batch = _slates(np.random.default_rng(1), lcs, ans, mode=0)
    ev = tev.RankingEvaluator(CFG, chunk_size=4, dtype=torch.float32,
                              need_lm=False, need_nsp=True, device="cpu")
    trace.enable()
    ev.score_slates(model, batch)
    snap = trace.snapshot()
    names = [n for n, _ in _order(snap)]
    assert names.count("eval.flat_forward") == 2
    assert names[0] == "eval.dispatch" and names[-1] == "eval.fetch"
    c = snap["counts"]
    assert c["eval.rows_needed.flat"] == 3 + 5 + 9 + 11 + 17 + 22
    assert c["eval.rows_launched.flat"] == 4 * 12 + 4 * 24
    assert "eval.rows_needed.prefill" not in c


def test_scores_unchanged_by_the_recorder(model):
    batch = _slates(np.random.default_rng(2), LCS, ANS)
    ev = tev.RankingEvaluator(CFG, chunk_size=8, dtype=torch.float32,
                              need_nsp=False, prefix_group=2, device="cpu")
    off = ev.score_slates(model, batch)
    trace.enable()
    on = ev.score_slates(model, batch)
    for k in off:
        np.testing.assert_array_equal(off[k], on[k])


# --- the training step -------------------------------------------------------

def _train_batch(rng, B=3):
    Rg = CFG.max_regions
    lab = np.full((B, L), -1, np.int32)
    lab[:, 3:9] = rng.integers(0, CFG.vocab_size, (B, 6))
    b = {"tokens": rng.integers(1, CFG.vocab_size, (B, L)),
         "segments": rng.integers(0, 2, (B, L)),
         "mode": np.ones(B, np.int32), "ctx_end": np.full(B, 20),
         "ans_len": np.full(B, 5), "mlm_labels": lab,
         "lm_weight": (lab != -1).astype(np.float32),
         "next_sentence_label": rng.integers(0, 2, B),
         "image_feat": rng.normal(size=(B, Rg, CFG.v_feature_size)),
         "image_loc": rng.normal(size=(B, Rg, 5)),
         "image_mask": (np.arange(Rg) < Rg - 1)[None].repeat(B, 0),
         "image_target": rng.dirichlet(np.ones(CFG.v_target_size), (B, Rg)),
         "image_label": rng.choice([-1, 0, 1], (B, Rg))}
    out = {}
    for k, v in b.items():
        v = np.asarray(v)
        v = v.astype(np.float32 if v.dtype.kind == "f" else np.int32)
        out[k] = torch.from_numpy(v)
    return out, lab


def test_training_step_spans():
    torch.manual_seed(1)
    m = tv.init_model(CFG, seed=0, device="cpu").train().requires_grad_(True)
    state = tstep.init_state(m, topt.make_optimizer(m, topt.OptimConfig()))
    step = tstep.make_train_step_with_fallback(CFG, dtype=torch.float32)
    batch, lab = _train_batch(np.random.default_rng(0))
    trace.enable()
    # the command line's staging of a batch: a root span of its own
    to_device({"x": lab}, "cpu")
    for _ in range(2):
        state, _ = step(state, batch, host_mlm_labels=lab)
    sp = trace.snapshot()["spans"]
    h2d = sp.pop("train.h2d")
    assert h2d["parent"] == [None]
    parents = {
        "train.step": None, "train.vote": "train.step",
        "train.world_norms": "train.step", "train.forward": "train.step",
        "train.mlm_xent": "train.forward",
        "train.backward": "train.step",
        "train.mlm_xent.bwd": "train.backward",
        "train.optim": "train.step",
        "train.optim.allreduce": "train.optim",
        "train.optim.update": "train.optim", "train.metrics": "train.step"}
    assert set(sp) == set(parents)
    for name, parent in parents.items():
        assert sp[name]["parent"] == [parent, parent], name
        assert sp[name]["id"] == [0, 1], name
    order = [n for n, _ in _order(trace.snapshot())]
    assert order[:12] == ["train.h2d",
        "train.step", "train.vote", "train.world_norms", "train.forward",
        "train.mlm_xent", "train.backward", "train.mlm_xent.bwd",
        "train.optim", "train.optim.allreduce", "train.optim.update",
        "train.metrics"]
