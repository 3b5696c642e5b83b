"""The port's prefix-cache scorer and evaluator against the JAX package on
the same weights (TINY config, CPU, fp32): host staging, packed answer-pass
scores against JAX's kernel path and against the port's own flat scorer,
and evaluate_split metrics."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scripts import bench_workload
from tests._torch_common import (TINY, TINY_T, flatten_slates, jax_params,
                                 member, torch_model)
from tests.test_prefix import make_shared_batch
from unimm_torch import workload
from unimm_torch.eval import evaluator as tev
from unimm_torch.eval import prefix as tpx
from unimm_torch.models import unimm as tu
from unimm_tpu.eval import evaluator as jev
from unimm_tpu.eval import prefix as jpx

PBLK_T = TINY_T.replace(attention_impl="pallas_block")


@pytest.fixture(scope="module")
def model():
    return torch_model()


def _ranks_equal(a, b, O):
    assert (np.argsort(-a.reshape(-1, O), axis=-1, kind="stable")
            == np.argsort(-b.reshape(-1, O), axis=-1, kind="stable")).all()


# --- host staging ----------------------------------------------------------

def test_slate_eligibility_matches_jax():
    batch = make_shared_batch(np.random.default_rng(0), TINY, B=2, R=3, O=5)
    batch["tokens"][0, 1, 3, 2] += 1            # broken shared context
    batch["mode"][1, 2, 0] = 0                  # a discriminative option
    batch["mlm_labels"][1, 0, 1, 1] = 7         # a label inside the context
    got, want = tpx.slate_eligibility(batch), jpx.slate_eligibility(batch)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].sum() == 3


@pytest.mark.parametrize("rb", [64, 256])
def test_pack_option_rows_matches_jax(rb):
    n = np.random.default_rng(rb).integers(2, 40, (5, 100))
    got, want = tpx.pack_option_rows(n, rb), jpx.pack_option_rows(n, rb)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_rb_for_matches_jax():
    for rb in (0, 128):
        t = tpx.PrefixScorer(PBLK_T, row_block=rb, device="cpu")
        j = jpx.PrefixScorer(TINY, row_block=rb)
        for Lcb in (32, 192, 224, 256):
            for need in (2, 64, 65, 254):
                assert t._rb_for(Lcb, need) == j._rb_for(Lcb, need)


def test_workload_matches_bench_workload():
    """Same seed, same batches: the copy keeps the RNG draw order."""
    cfg = TINY.replace(max_seq_len=256)
    for fn in (None, workload.realistic_ctx_range(cfg.max_seq_len)):
        kw = dict(B=1, R=3, O=4, ans_range=(2, 4),
                  feat_dim=cfg.v_feature_size, ctx_range_fn=fn)
        got = workload.make_val_batch(np.random.default_rng(9), cfg, **kw)
        jfn = (None if fn is None
               else bench_workload.realistic_ctx_range(cfg.max_seq_len))
        want = bench_workload.make_val_batch(
            np.random.default_rng(9), cfg, **{**kw, "ctx_range_fn": jfn})
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --- scores ----------------------------------------------------------------

def test_scorer_matches_jax_kernel_path(model):
    """The port's packed scorer (kernel wrappers -> plain versions on the
    CPU) against the JAX scorer on its Pallas kernel path (interpret)."""
    batch = make_shared_batch(np.random.default_rng(1), TINY, B=2, R=3, O=6)
    got, ok = tpx.PrefixScorer(PBLK_T, dtype=torch.float32, group=8,
                               device="cpu").score(model, batch)
    want, ok_j = jpx.PrefixScorer(TINY.replace(attention_impl="pallas_block"),
                                  dtype=jnp.float32, group=8).score(
        jax_params(), batch)
    assert ok.all() and ok_j.all()
    for k in ("ll_sum", "ll_mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)
    _ranks_equal(got["ll_sum"], want["ll_sum"], 6)


@pytest.mark.parametrize("seed,truncate,impl,group", [
    (2, False, "pallas_block", 2), (3, True, "pallas_block", 16),
    (4, False, "xla", 3), (5, True, "xla", 1)])
def test_scorer_matches_flat_forward_eval(model, seed, truncate, impl, group):
    """Prefix decomposition == the port's flat full-sequence scorer, also
    when the masked answer copy is truncated at max_seq_len."""
    O = 5
    batch = make_shared_batch(np.random.default_rng(seed), TINY, B=2, R=2,
                              O=O, truncate=truncate)
    got, ok = tpx.PrefixScorer(TINY_T.replace(attention_impl=impl),
                               dtype=torch.float32, group=group,
                               device="cpu").score(model, batch)
    assert ok.all()
    flat = tu.forward_eval(model, TINY_T, flatten_slates(batch),
                           dtype=torch.float32, need_nsp=False)
    np.testing.assert_allclose(got["ll_sum"].reshape(-1),
                               -flat["lm_nll_sum"].numpy(), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got["ll_mean"].reshape(-1),
                               -flat["lm_nll_mean"].numpy(), rtol=2e-4,
                               atol=2e-5)
    _ranks_equal(got["ll_sum"], -flat["lm_nll_sum"].numpy(), O)


@pytest.mark.parametrize("rb", [32, 96])
def test_scorer_row_blocks_match_jax(model, rb):
    """A fixed row block that is not a multiple of 64 (K1's row blocks of
    16-row tails): the port's packed scorer against JAX's at the same row
    block (its Pallas kernel in interpret mode)."""
    batch = make_shared_batch(np.random.default_rng(10 + rb), TINY, B=2, R=3,
                              O=6)
    got, ok = tpx.PrefixScorer(PBLK_T, dtype=torch.float32, group=4,
                               row_block=rb, device="cpu").score(model, batch)
    want, ok_j = jpx.PrefixScorer(TINY.replace(attention_impl="pallas_block"),
                                  dtype=jnp.float32, group=4,
                                  row_block=rb).score(jax_params(), batch)
    assert ok.all() and ok_j.all()
    for k in ("ll_sum", "ll_mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)
    _ranks_equal(got["ll_sum"], want["ll_sum"], 6)


@pytest.mark.parametrize("impl,packed,rb,truncate,O", [
    ("pallas_block", False, 0, False, 6),
    ("pallas_block", False, 0, True, 4),
    ("xla", False, 0, False, 5),
    ("pallas_block", True, 4, False, 6),   # options of > 4 rows: W layout
    ("pallas_block", False, 0, False, 1),
])
def test_w_layout_matches_jax_and_packed(model, impl, packed, rb, truncate,
                                         O):
    """The W-padded answer pass (``packed=False``, or a group whose largest
    option needs more rows than the fixed row block) against JAX's W
    layout on the same weights, and against the port's packed scorer
    (tests/test_prefix.py:89 and :231 hold JAX's against its flat path)."""
    batch = make_shared_batch(np.random.default_rng(20 + O), TINY, B=2, R=3,
                              O=O, truncate=truncate)
    got, ok = tpx.PrefixScorer(TINY_T.replace(attention_impl=impl),
                               dtype=torch.float32, group=4, packed=packed,
                               row_block=rb, device="cpu").score(model, batch)
    want, ok_j = jpx.PrefixScorer(TINY.replace(attention_impl=impl),
                                  dtype=jnp.float32, group=4, packed=packed,
                                  row_block=rb).score(jax_params(), batch)
    packed_t, _ = tpx.PrefixScorer(TINY_T.replace(attention_impl=impl),
                                   dtype=torch.float32, group=4,
                                   device="cpu").score(model, batch)
    assert ok.all() and ok_j.all()
    for ref in (want, packed_t):
        for k in ("ll_sum", "ll_mean"):
            np.testing.assert_allclose(got[k], ref[k], rtol=2e-4, atol=2e-5,
                                       err_msg=k)
        _ranks_equal(got["ll_sum"], ref["ll_sum"], O)


def test_w_layout_dispatch_runs_one_pass_a_group(model, monkeypatch):
    """Which layout each group takes: every group the W layout under
    ``packed=False``; under a fixed row block only the groups whose
    largest option needs more rows."""
    batch = make_shared_batch(np.random.default_rng(30), TINY, B=2, R=2, O=4)
    n = np.minimum(batch["ctx_end"] + batch["ans_len"], TINY.max_seq_len) \
        - (batch["ctx_end"] - batch["ans_len"])
    calls = []
    for name in ("_answer_impl", "_answer_impl_packed"):
        orig = getattr(tpx.PrefixScorer, name)

        def spy(self, *a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(tpx.PrefixScorer, name, spy)
    for packed, rb, want in ((False, 0, ["_answer_impl"] * 4),
                             (True, 0, ["_answer_impl_packed"] * 4)):
        calls.clear()
        tpx.PrefixScorer(PBLK_T, dtype=torch.float32, group=1, packed=packed,
                         row_block=rb, device="cpu").score(model, batch)
        assert calls == want
    calls.clear()
    rb = int(np.median(n.reshape(4, 4).max(-1)))
    tpx.PrefixScorer(PBLK_T, dtype=torch.float32, group=1, row_block=rb,
                     device="cpu").score(model, batch)
    need = np.sort(n.reshape(4, 4).max(-1))
    assert calls.count("_answer_impl") == int((need > rb).sum()) > 0
    assert calls.count("_answer_impl_packed") == int((need <= rb).sum()) > 0


@pytest.mark.parametrize("rows", [64, 12, 100])
def test_make_ffn_passes_rows_unblocked(model, monkeypatch, rows):
    """With the kernels on, the answer pass's FFN hands K2 (``ffn_block``)
    the answer rows as they are, [G, rows, H], also a count no row block
    in (256, ..., 8) divides (12, and the W layout's O * W at odd O);
    without them, or under ``fused_ffn`` off, it takes the plain FFN.
    (K2 on the card at the W layout's rows: tests/test_torch_cuda.py.)"""
    seen = []

    def spy(h, p_inter, p_out, act):
        seen.append(tuple(h.shape))
        return tpx.ffn_block_plain(h, p_inter, p_out, act=act)

    monkeypatch.setattr(tpx, "ffn_block", spy)
    layer = model.bert.encoder.layer[0]
    h = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, rows, TINY.hidden_size)).astype(np.float32))
    want = tpx.ffn_block_plain(h, layer.intermediate, layer.output)
    for cfg, kernel, calls in ((PBLK_T, True, [(2, rows, TINY.hidden_size)]),
                               (PBLK_T, False, []),
                               (PBLK_T.replace(fused_ffn=False), True, [])):
        seen.clear()
        sc = tpx.PrefixScorer(cfg, dtype=torch.float32, device="cpu")
        got = sc._make_ffn(kernel)(layer.intermediate, layer.output, h)
        assert seen == calls
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# --- evaluator -------------------------------------------------------------

def _loader(seed, n=2):
    rng = np.random.default_rng(seed)
    return [workload.with_ranking_targets(
        make_shared_batch(rng, TINY, B=2, R=2, O=6), rng) for _ in range(n)]


def test_evaluate_split_matches_jax(model):
    mode = "ll_sum"
    loader = _loader(7)
    ranks_t, ranks_j = [], []
    got = tev.evaluate_split(model, PBLK_T, loader, mode=mode,
                             dtype=torch.float32, prefix_group=8,
                             ranks_out=ranks_t, progress_every=0,
                             device="cpu")
    want = jev.evaluate_split(jax_params(), TINY, loader, mode=mode,
                              dtype=jnp.float32, prefix_group=8,
                              ranks_out=ranks_j, progress_every=0)
    assert got.keys() == want.keys() and "ndcg" in got
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert ranks_t == ranks_j


def test_ineligible_slates_raise(model):
    """Slates the prefix scorer cannot take no longer raise: score_slates
    sends them through the flat scorer and equals JAX on a mixed batch
    (as tests/test_prefix.py:117 holds JAX's prefix + fallback to its
    all-flat scores), and evaluate_split(mode="nsp") equals JAX."""
    batch = _loader(8, 1)[0]
    batch["tokens"][0, 1, 2, 1] += 1            # breaks one shared context
    batch["mode"][1, 0] = 0                     # one discriminative slate
    batch["ans_len"][1, 0] = 0
    ev = tev.RankingEvaluator(PBLK_T, chunk_size=16, dtype=torch.float32,
                              need_nsp=False, prefix_group=8, device="cpu")
    got = ev.score_slates(model, batch)
    ok = ev._prefix.last_ok
    assert ok.any() and not ok.all()
    want = jev.RankingEvaluator(TINY, chunk_size=16, dtype=jnp.float32,
                                need_nsp=False, prefix_group=8).score_slates(
        jax_params(), batch)
    for k in ("ll_sum", "ll_mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)
    _ranks_equal(got["ll_sum"], want["ll_sum"], 6)

    # NSP ranks need options that do not tie: weights of std 0.2
    params, m = member(0, 0.2)
    ranks_t, ranks_j = [], []
    got = tev.evaluate_split(m, PBLK_T, [batch], mode="nsp", chunk_size=16,
                             dtype=torch.float32, ranks_out=ranks_t,
                             progress_every=0, device="cpu")
    want = jev.evaluate_split(params, TINY, [batch], mode="nsp",
                              chunk_size=16, dtype=jnp.float32,
                              ranks_out=ranks_j, progress_every=0)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert ranks_t == ranks_j
