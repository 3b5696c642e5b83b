"""The port's flat chunked scorer and discriminative path against the JAX
package on the same weights (TINY config, CPU, fp32): the descriptor mask
bias and attended extent, the plain versions of the attention-block and
co-attention kernels against the Pallas kernels (``interpret=True``), the
flat forward on the kernel path, ``score_flat``, ``evaluate_split(mode=
"nsp")``, ``evaluate_ensemble`` and the discriminative workload."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scripts import bench_workload
from tests._torch_common import (TINY, TINY_T, jax_params, member,
                                 torch_model)
from tests.test_evaluator import make_val_batch
from tests.test_masks import GEN_CASES
from tests.test_prefix import make_shared_batch
from unimm_torch import workload
from unimm_torch.checkpoint import state_dict_from_jax
from unimm_torch.data.dataset import flatten_for_forward
from unimm_torch.eval import evaluator as tev
from unimm_torch.models import unimm as tu
from unimm_torch.models import vilbert as tv
from unimm_torch.ops import attention_block as tatb
from unimm_torch.ops import co_text_block as tco
from unimm_torch.ops import masks as tm
from unimm_tpu.data.dataset import flatten_for_forward as j_flatten
from unimm_tpu.eval import evaluator as jev
from unimm_tpu.models import unimm as ju
from unimm_tpu.models import vilbert as jv
from unimm_tpu.ops import masks as jm
from unimm_tpu.ops import pallas_attention_v2 as pattn2
from unimm_tpu.ops.pallas_attention import _mask_bias

PBLK_T = TINY_T.replace(attention_impl="pallas_block")
TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def model():
    return torch_model()


@pytest.fixture(scope="module")
def members():
    """Two (JAX params, the port's model) pairs, seeds 0 and 1, drawn with
    std 0.2: at TINY's 0.02 the NSP probabilities of a slate's options tie
    to within 1e-7 (exactly, for some), so ranks would hang on float
    noise. At 0.2 the closest two options of the test slates lie 6e-5
    apart and the port differs from JAX by 2e-7 at most."""
    return [member(seed, 0.2) for seed in (0, 1)]


def _dis_batch(seed, B=2, R=2, O=6):
    """A TINY discriminative batch with ranking targets (the workload's
    layout at L 32)."""
    return workload.make_dis_batch(np.random.default_rng(seed), TINY_T, B=B,
                                   R=R, O=O, ctx_range=(3, 27),
                                   ans_range=(1, 6),
                                   feat_dim=TINY.v_feature_size)


def _gen_flat(seed):
    batch = make_val_batch(np.random.default_rng(seed), TINY)
    return flatten_for_forward(batch, train=False, compact_images=True)


def _assert_scores(got, want, tol=TOL):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


# --- descriptor masks -------------------------------------------------------

def _desc_sweep(L):
    """test_masks' generative cases at this length, the same cases cut to
    fit, descriptors truncated at L (ctx_end + ans_len > L), one-token
    contexts and discriminative lengths up to L."""
    rows = [(1, L1, A) for L1, A, _ in GEN_CASES]
    rows += [(1, L - 2, 4), (1, L - 1, 2), (1, L - 4, 4), (1, 3, 2)]
    rows += [(0, n, 0) for n in (1, 2, 17, L // 2, L - 1, L)]
    return np.asarray(rows, np.int32)


@pytest.mark.parametrize("L", [32, 64, 96])
def test_mask_bias_matches_jax(L):
    desc = _desc_sweep(L)
    got = tm.mask_bias(torch.from_numpy(desc), L).numpy()
    want = np.stack([np.asarray(_mask_bias(int(m), int(a), int(b), L))
                     for m, a, b in desc])
    np.testing.assert_array_equal(got, want)
    bias = jm.to_additive(jm.text_attention_mask(desc[:, 0], desc[:, 1],
                                                 desc[:, 2], L))
    np.testing.assert_array_equal(got, np.asarray(bias))


def test_attended_extent_matches_jax():
    rng = np.random.default_rng(0)
    mode = rng.integers(0, 2, 40)
    ce = rng.integers(1, 40, 40)
    al = rng.integers(0, 9, 40)
    labs = np.where(rng.random((40, 32)) < 0.05, 3, -1)
    for lab in (None, labs):
        np.testing.assert_array_equal(
            tm.attended_extent(mode, ce, al, 32, lab),
            jm.attended_extent(mode, ce, al, 32, lab))


# --- the kernels' plain versions against the Pallas kernels -----------------

def test_attention_block_plain_matches_pallas():
    B, H, L, D = 6, 4, 64, 32
    HID = H * D
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, L, HID)).astype(np.float32)
    desc = np.asarray([(0, L, 0), (0, 20, 0), (1, 30, 5), (1, 62, 6),
                       (1, 5, 4), (0, 1, 0)], np.int32)
    jp = jv._init_attention(jax.random.PRNGKey(0), HID, 0.02)
    want = pattn2.fused_attention_block(jnp.asarray(x), jnp.asarray(desc),
                                        jp, num_heads=H, interpret=True)
    attn = tv._attention(HID)
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    attn.load_state_dict(sd, strict=True)
    got = tatb.attention_block(torch.from_numpy(x), torch.from_numpy(desc),
                               attn, num_heads=H)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-6)


def test_co_text_block_plain_matches_pallas(model):
    rng = np.random.default_rng(1)
    B, L, R = 4, 16, TINY.max_regions
    t_x = rng.normal(size=(B, L, TINY.hidden_size)).astype(np.float32)
    v_x = rng.normal(size=(B, R, TINY.v_hidden_size)).astype(np.float32)
    im = (rng.random((B, R)) > 0.3).astype(np.float32)
    im[1] = 0.0                          # every region of one row masked
    want = pattn2.fused_co_text_block(
        jnp.asarray(t_x), jnp.asarray(v_x), jnp.asarray(im),
        jax_params()["bert"]["encoder"]["c_layer"]["0"],
        num_heads=TINY.bi_num_attention_heads, interpret=True)
    got = tco.co_text_block(torch.from_numpy(t_x), torch.from_numpy(v_x),
                            torch.from_numpy(im),
                            model.bert.encoder.c_layer[0],
                            num_heads=TINY.bi_num_attention_heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-6)


def test_new_wrappers_refuse_non_cpu_tensors(model):
    """Off the CPU the two wrappers launch their kernel or raise: here
    (meta tensors) every argument check runs and the device check raises;
    a shape or type the kernels do not take is refused first."""
    meta = tv.cast_floating(model, torch.bfloat16).to("meta")
    attn = meta.bert.encoder.layer[0].attention
    desc = torch.zeros(2, 3, dtype=torch.int32, device="meta")
    x = torch.empty(2, 64, TINY.hidden_size, dtype=torch.bfloat16,
                    device="meta")
    with pytest.raises(ValueError, match="built for width 768"):
        tatb.attention_block(x, desc, attn, num_heads=2)
    attn768 = tv.cast_floating(tv._attention(768), torch.bfloat16).to("meta")
    x768 = torch.empty(2, 64, 768, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="multiple of 32"):
        tatb.attention_block(x768[:, :48], desc, attn768, num_heads=12)
    with pytest.raises(ValueError, match="desc must be int32"):
        tatb.attention_block(x768, desc.long(), attn768, num_heads=12)
    with pytest.raises(ValueError, match="unsupported device meta"):
        tatb.attention_block(x768, desc, attn768, num_heads=12)
    from unimm_torch.config import VilbertConfig
    conn = tv.cast_floating(tv._connection(VilbertConfig()),
                            torch.bfloat16).to("meta")
    v_x = torch.empty(2, 37, 1024, dtype=torch.bfloat16, device="meta")
    im = torch.empty(2, 37, device="meta")
    with pytest.raises(ValueError, match="image_mask must be float32"):
        tco.co_text_block(x768, v_x, im.bfloat16(), conn, num_heads=8)
    with pytest.raises(ValueError, match="at most 64"):
        tco.co_text_block(x768, torch.empty(2, 65, 1024, device="meta",
                                            dtype=torch.bfloat16),
                          torch.empty(2, 65, device="meta"), conn,
                          num_heads=8)
    with pytest.raises(ValueError, match="unsupported device meta"):
        tco.co_text_block(x768, v_x, im, conn, num_heads=8)


# --- the flat forward on the kernel path ------------------------------------

@pytest.mark.parametrize("fused_co", [False, True])
def test_forward_eval_kernel_path_matches_jax(model, fused_co):
    """``pallas_block`` (attention block, FFN and, with fused_co, the
    co-attention text side through their wrappers) against JAX on mixed
    dis / gen sequences."""
    b = make_val_batch(np.random.default_rng(2), TINY, B=1, R=2, O=4)
    b["mode"][0, 1] = 0
    b["ans_len"][0, 1] = 0
    b["mlm_labels"][0, 1] = -1
    b["image_mask"][0, -2:] = 0.0
    flat = flatten_for_forward(b, train=False, compact_images=True)
    cfg = PBLK_T.replace(fused_co=fused_co)
    cast = tv.cast_floating(model, torch.float32)
    got = tu.forward_eval(cast, cfg,
                          {k: torch.from_numpy(v) for k, v in flat.items()},
                          dtype=torch.float32, max_label_positions=8,
                          decoder_bias=model.cls.predictions.bias.float())
    want = ju.forward_eval(jax_params(), TINY,
                           {k: jnp.asarray(v) for k, v in flat.items()},
                           dtype=jnp.float32, max_label_positions=8)
    for k in ("nsp_logits", "lm_nll_sum", "lm_nll_mean"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


# --- score_flat --------------------------------------------------------------

def test_flatten_for_forward_matches_jax():
    batch = _dis_batch(3)
    for compact in (False, True):
        got = flatten_for_forward(batch, train=False, compact_images=compact)
        want = j_flatten(batch, train=False, compact_images=compact)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kw", [{}, dict(train=True, compact_images=False),
                                dict(train=True, compact_images=True)],
                         ids=["default", "train", "train-compact"])
def test_flatten_for_forward_train_matches_jax(kw):
    """With its default arguments (train=True, as JAX's) and with
    train=True under both compact_images settings, flatten_for_forward
    keeps the training image targets and gives JAX's keys and arrays byte
    for byte."""
    batch = dict(_dis_batch(3))
    rng = np.random.default_rng(8)
    B, Rg = batch["image_feat"].shape[:2]
    batch["image_target"] = rng.dirichlet(
        np.ones(TINY.v_target_size), (B, Rg)).astype(np.float32)
    batch["image_label"] = rng.choice([-1, 0, 1], (B, Rg)).astype(np.int32)
    got, want = flatten_for_forward(batch, **kw), j_flatten(batch, **kw)
    assert {"image_target", "image_label"} <= want.keys()
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("kind", ["dis", "gen"])
def test_score_flat_chunk_sizes_match_jax(model, kind):
    """Chunk sizes that pad the last chunk or leave it whole give JAX's
    scores (length buckets on)."""
    if kind == "dis":
        flat = flatten_for_forward(_dis_batch(4), train=False,
                                   compact_images=True)
        need = dict(need_lm=False, need_nsp=True)
    else:
        flat = _gen_flat(5)
        need = dict(need_lm=True, need_nsp=True)
    want = jev.RankingEvaluator(TINY, chunk_size=16, dtype=jnp.float32,
                                **need).score_flat(jax_params(), flat)
    for chunk in (7, 16, 64):
        got = tev.RankingEvaluator(PBLK_T, chunk_size=chunk,
                                   dtype=torch.float32, device="cpu",
                                   **need).score_flat(model, flat)
        _assert_scores(got, want)


def test_score_flat_length_buckets_exact(model):
    """Bucketed scoring equals unbucketed scoring of the port, sequence
    for sequence (rows past the extent are fully masked; the generative
    labels sit inside the extent, as real slates carry them)."""
    shared = make_shared_batch(np.random.default_rng(6), TINY, B=2, R=2, O=5)
    for flat, need_lm in ((flatten_for_forward(shared, train=False,
                                               compact_images=True), True),
                          (flatten_for_forward(_dis_batch(7), train=False,
                                               compact_images=False), False)):
        kw = dict(chunk_size=8, dtype=torch.float32, need_lm=need_lm,
                  device="cpu")
        out_b = tev.RankingEvaluator(PBLK_T, length_buckets=True,
                                     **kw).score_flat(model, flat)
        out_p = tev.RankingEvaluator(PBLK_T, length_buckets=False,
                                     **kw).score_flat(model, flat)
        _assert_scores(out_b, out_p, dict(rtol=2e-5, atol=2e-5))


def test_label_bucket_selection_matches_jax():
    flat = _gen_flat(8)
    many = dict(flat, mlm_labels=np.array(flat["mlm_labels"], copy=True))
    many["mlm_labels"][0, 1:20] = 5
    none = dict(flat, mlm_labels=np.full_like(flat["mlm_labels"], -1))
    for need_nsp in (False, True):
        t = tev.RankingEvaluator(PBLK_T, chunk_size=8, need_nsp=need_nsp,
                                 device="cpu")
        j = jev.RankingEvaluator(TINY, chunk_size=8, need_nsp=need_nsp)
        for f in (flat, many, none):
            assert t._label_bucket(f) == j._label_bucket(f)
    assert t._label_bucket(many) == 32
    dis = tev.RankingEvaluator(PBLK_T, need_lm=False, device="cpu")
    assert dis._label_bucket(flat) == tu.MAX_LABEL_POSITIONS


def test_score_flat_compact_equals_expanded(model):
    batch = _dis_batch(9)
    ev = tev.RankingEvaluator(PBLK_T, chunk_size=16, dtype=torch.float32,
                              need_lm=False, device="cpu")
    out_c = ev.score_flat(model, flatten_for_forward(
        batch, train=False, compact_images=True))
    out_e = ev.score_flat(model, flatten_for_forward(
        batch, train=False, compact_images=False))
    _assert_scores(out_c, out_e, dict(rtol=1e-5, atol=1e-6))


# --- evaluate_split / evaluate_ensemble -------------------------------------

def _dis_loader(seed, n=2):
    return [_dis_batch(seed + i) for i in range(n)]


def test_evaluate_split_nsp_matches_jax(members):
    params, model = members[0]
    loader = _dis_loader(10)
    ranks_t, ranks_j = [], []
    got = tev.evaluate_split(model, PBLK_T, loader, mode="nsp",
                             chunk_size=16, dtype=torch.float32,
                             ranks_out=ranks_t, progress_every=0,
                             device="cpu")
    want = jev.evaluate_split(params, TINY, loader, mode="nsp",
                              chunk_size=16, dtype=jnp.float32,
                              ranks_out=ranks_j, progress_every=0)
    assert got.keys() == want.keys() and "ndcg" in got
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert ranks_t == ranks_j


@pytest.mark.parametrize("test_split", [False, True])
def test_evaluate_ensemble_matches_jax(members, test_split):
    if test_split:
        loader = [_dis_batch(12, B=3, R=1, O=8)]
    else:
        loader = _dis_loader(13)
    ranks_t, ranks_j = [], []
    got = tev.evaluate_ensemble([m for _, m in members], PBLK_T, loader,
                                mode="nsp", chunk_size=16,
                                dtype=torch.float32, ranks_out=ranks_t,
                                test_split=test_split, progress_every=0,
                                device="cpu")
    want = jev.evaluate_ensemble([p for p, _ in members], TINY,
                                 loader, mode="nsp", chunk_size=16,
                                 dtype=jnp.float32, ranks_out=ranks_j,
                                 test_split=test_split, progress_every=0)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert ranks_t == ranks_j and len(ranks_t) > 0


def test_one_cast_per_model(members):
    """The evaluator casts each source model once and reuses the copy
    until the model's parameters change."""
    ev = tev.RankingEvaluator(PBLK_T, dtype=torch.bfloat16, device="cpu")
    model, m2 = (m for _, m in members)
    first = [ev._compute_model(m) for m in (model, m2)]
    assert first[0] is not first[1]
    assert [ev._compute_model(m) for m in (model, m2)] == first
    assert first[0].bert.encoder.layer[0].output.dense.weight.dtype \
        == torch.bfloat16
    with torch.no_grad():
        m2.cls.predictions.bias.add_(0.0)    # bumps the version counter
    assert ev._compute_model(m2) is not first[1]
    assert ev._compute_model(model) is first[0]


def test_minmax_per_slate_matches_jax():
    s = np.random.default_rng(14).normal(size=(2, 3, 10))
    s[0, 0] = 1.5                            # a constant slate
    np.testing.assert_array_equal(tev.minmax_per_slate(s),
                                  jev.minmax_per_slate(s))


def test_dump_ranks_merged_sorts(tmp_path):
    ranks = [{"image_id": 2, "round_id": 1, "ranks": [1, 2]},
             {"image_id": 1, "round_id": 2, "ranks": [2, 1]},
             {"image_id": 1, "round_id": 1, "ranks": [1, 2]}]
    path = tmp_path / "ranks.json"
    assert tev.dump_ranks_merged(ranks, str(path)) == 3
    got = json.loads(path.read_text())
    assert [(e["image_id"], e["round_id"]) for e in got] == [
        (1, 1), (1, 2), (2, 1)]
    tev.dump_ranks(ranks, str(path))
    assert json.loads(path.read_text()) == ranks


def test_make_dis_batch_matches_bench_workload():
    """Same seed, same batches: the copy keeps the RNG draw order."""
    cfg = TINY.replace(max_seq_len=256)
    for fn in (None, workload.realistic_ctx_range(256)):
        kw = dict(B=1, R=3, O=4, feat_dim=cfg.v_feature_size)
        got = workload.make_dis_batch(np.random.default_rng(9), cfg,
                                      ctx_range_fn=fn, **kw)
        jfn = None if fn is None else bench_workload.realistic_ctx_range(256)
        want = bench_workload.make_dis_batch(np.random.default_rng(9), cfg,
                                             ctx_range_fn=jfn, **kw)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
