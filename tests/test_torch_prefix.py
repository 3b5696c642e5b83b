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
                                 torch_model)
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


def test_make_ffn_reblocks_or_raises(model):
    sc = tpx.PrefixScorer(PBLK_T, dtype=torch.float32, device="cpu")
    layer = model.bert.encoder.layer[0]
    h = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 64, TINY.hidden_size)).astype(np.float32))
    torch.testing.assert_close(
        sc._make_ffn(True, 64)(layer.intermediate, layer.output, h),
        sc._make_ffn(False, 64)(layer.intermediate, layer.output, h),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="no row block"):
        sc._make_ffn(True, 12)


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
    batch = _loader(8, 1)[0]
    batch["tokens"][0, 1, 2, 1] += 1            # breaks one shared context
    ev = tev.RankingEvaluator(PBLK_T, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="not eligible"):
        ev.score_slates(model, batch)
    with pytest.raises(NotImplementedError, match="flat"):
        tev.evaluate_split(model, PBLK_T, [batch], mode="nsp", device="cpu")
