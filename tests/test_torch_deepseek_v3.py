"""The port's DeepSeek-V3 decoder (Kimi-VL-A3B's language model) against
the benchmark's plain fp32 reference (``benchmark/reference/
deepseek_v3_ref.py``) on the CPU at a small size: two layers (the dense one
and one MoE layer of 8 experts, top 2, two shared), hidden 64, seeded
weights. The full forward's logits, the decoder prefix scorer's ll_sum
(through ``RankingEvaluator.score_slates_async``) against the reference's
uncached forward of every option, the router against the reference's
noaux_tc, and the grouped MoE against a loop over the experts, with an
expert given no row and one given every row."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import deepseek_v3_ref as ref
from unimm_torch.config import DeepseekV3Config
from unimm_torch.eval.decoder_prefix import DecoderPrefixScorer
from unimm_torch.eval.evaluator import RankingEvaluator
from unimm_torch.models import deepseek_v3 as dsv3
from unimm_torch.ops import moe
from unimm_torch.utils import trace

CFG = dict(vocab_size=300, hidden_size=64, intermediate_size=96,
           moe_intermediate_size=32, num_hidden_layers=2,
           num_attention_heads=2, n_shared_experts=2, n_routed_experts=8,
           num_experts_per_tok=2, routed_scaling_factor=2.446,
           kv_lora_rank=32, q_lora_rank=None, qk_nope_head_dim=16,
           qk_rope_head_dim=8, v_head_dim=16, topk_method="noaux_tc",
           n_group=1, topk_group=1, norm_topk_prob=True,
           scoring_func="sigmoid", moe_layer_freq=1, first_k_dense_replace=1,
           hidden_act="silu", rms_norm_eps=1e-5, rope_theta=800000.0,
           rope_scaling=None,
           # a wider init than the cell's 0.02: at hidden 64 that would
           # leave the scores of a slate within rounding of each other
           bench={"init_std": 0.15, "bias_std": 0.05})
SEED = 2 ** 32 + 11
TOL = dict(rtol=1e-4, atol=1e-4)


def _model(cfg=CFG, seed=SEED):
    pcfg = DeepseekV3Config.from_dict(cfg)
    m = dsv3.DecoderModel(pcfg, "cpu", dtype=torch.float32)
    m.load_state_dict(dict(ref.Weights(cfg, seed, "cpu").items()))
    return m


def _slates(seed=5, B=2, R=2, O=5, L=24, Ni=7, cfg=CFG):
    """A decoder slate batch: per dialog 5-7 image tokens, per slate a
    context of 3-8 text tokens, per option 2-4 answer tokens and the end
    token."""
    rng = np.random.default_rng(seed)
    V, H = cfg["vocab_size"], cfg["hidden_size"]
    lc = rng.integers(3, 9, (B, R))
    A = rng.integers(3, 6, (B, R, O))
    tokens = np.zeros((B, R, O, L), np.int32)
    ctx = rng.integers(1, V, (B, R, L))
    for b in range(B):
        for r in range(R):
            for o in range(O):
                n = lc[b, r]
                tokens[b, r, o, :n] = ctx[b, r, :n]
                tokens[b, r, o, n:n + A[b, r, o]] = rng.integers(
                    1, V, A[b, r, o])
    return {"tokens": tokens,
            "ctx_end": np.broadcast_to(lc[..., None], (B, R, O)).astype(
                np.int32).copy(),
            "ans_len": A.astype(np.int32),
            "image_embeds": (0.15 * rng.standard_normal((B, Ni, H))).astype(
                np.float32),
            "image_len": rng.integers(5, Ni + 1, B).astype(np.int32)}


def _ref_ll(cfg, batch, seed=SEED, prec=None, routes=None, stats=None):
    """The reference's ll_sum [B R O] of every option, each a whole
    sequence: image tokens, context, the answer's input tokens."""
    w = ref.Weights(cfg, seed, "cpu")
    emb = w["model.embed_tokens.weight"]
    tokens = batch["tokens"]
    B, R, O, L = tokens.shape
    seqs, labs = [], []
    for b in range(B):
        ni = int(batch["image_len"][b])
        img = torch.from_numpy(batch["image_embeds"][b, :ni])
        for r in range(R):
            for o in range(O):
                lc, a = int(batch["ctx_end"][b, r, o]), int(
                    batch["ans_len"][b, r, o])
                t = torch.from_numpy(tokens[b, r, o, :lc + a].astype(
                    np.int64))
                x = torch.cat([img, emb[t[:-1]]])
                lab = torch.full((x.shape[0],), -1, dtype=torch.long)
                lab[ni + lc - 1:] = t[lc:]
                seqs.append(x)
                labs.append(lab)
    n = max(s.shape[0] for s in seqs)
    X = torch.stack([F.pad(s, (0, 0, 0, n - s.shape[0])) for s in seqs])
    Y = torch.stack([F.pad(y, (0, n - y.shape[0]), value=-1) for y in labs])
    lengths = torch.tensor([s.shape[0] for s in seqs])
    out, st = ref.ll_sum(cfg, w, X, lengths, Y,
                         prec or ref.Precision("fp32"), routes, stats)
    return out.reshape(B * R, O).numpy(), st


def test_config_reads_the_published_keys():
    pcfg = DeepseekV3Config.from_dict({**CFG, "ep_size": 1, "seq_aux": True,
                                       "model_type": "deepseek_v3"})
    assert pcfg.q_head_dim == 24 and pcfg.is_moe(1) and not pcfg.is_moe(0)
    with pytest.raises(ValueError):
        DeepseekV3Config.from_dict({**CFG, "q_lora_rank": 64})


def test_hf_names_load_into_their_slots():
    m = _model()
    w = ref.Weights(CFG, SEED, "cpu")
    names = dsv3.hf_names(m.cfg)
    assert sorted(names) == sorted(n for n, _ in ref.param_shapes(CFG))
    lay = m.layers[1]
    g, u = moe.split_gate_up(lay["w13"][3])
    assert torch.equal(g, w["model.layers.1.mlp.experts.3.gate_proj.weight"])
    assert torch.equal(u, w["model.layers.1.mlp.experts.3.up_proj.weight"])
    g, _ = moe.split_gate_up(lay["shared_w13"][0])
    assert torch.equal(
        g, w["model.layers.1.mlp.shared_experts.gate_proj.weight"])
    with pytest.raises(KeyError):
        m.load("model.layers.0.mlp.gate.weight", torch.zeros(8, 64))


def test_full_forward_logits():
    m = _model()
    w = ref.Weights(CFG, SEED, "cpu")
    rng = np.random.default_rng(1)
    x = torch.from_numpy((0.15 * rng.standard_normal((3, 11, 64))).astype(
        np.float32))
    got = dsv3.forward_logits(m, x)
    h = ref.forward(CFG, w, x, torch.full((3,), 11), ref.Precision("fp32"))
    want = h @ w["lm_head.weight"].t()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("seed", [5, 6])
def test_prefix_scorer_ll_sum_against_uncached_forward(seed):
    m = _model()
    batch = _slates(seed)
    ev = RankingEvaluator(m.cfg, need_lm=True, need_nsp=False,
                          prefix_group=3, device="cpu")
    got = ev.score_slates_async(m, batch)()
    want, _ = _ref_ll(CFG, batch)
    np.testing.assert_allclose(got["ll_sum"].reshape(want.shape), want,
                               rtol=1e-4, atol=2e-4)
    # ll_mean: over the answer's tokens and its end token
    np.testing.assert_allclose(
        got["ll_mean"], got["ll_sum"] / batch["ans_len"].reshape(-1),
        rtol=1e-6)
    # what a capture keeps for the benchmark's check: each group's rows,
    # and the experts of every row at each MoE layer of both passes
    sc = DecoderPrefixScorer(m.cfg, group=3, device="cpu")
    assert not trace.capturing()
    with trace.capture() as kept:
        again = sc.score(m, batch)[0]
    assert not trace.capturing()
    np.testing.assert_array_equal(again["ll_sum"].reshape(-1),
                                  got["ll_sum"])
    rows, routes = kept["eval.rows"], kept["moe.route"]
    assert len(rows) == 2 and len(routes) == 2 * 2
    n_ctx = batch["image_len"][:, None] + batch["ctx_end"][..., 0]
    n_ctx = n_ctx.reshape(-1)
    for i, rec in enumerate(rows):
        n_pre = int(n_ctx[rec["slates"]].sum())
        n_ans = int((batch["ans_len"].reshape(len(n_ctx), -1)[rec["slates"]]
                     - 1).sum())
        assert rec["ctx_rows"].shape == (2, n_pre)
        assert rec["ans_rows"].shape == (3, n_ans)
        assert routes[2 * i].shape == (n_pre, 2)
        assert routes[2 * i + 1].shape == (n_ans, 2)
        assert routes[2 * i].dtype == torch.uint8
    # once the capture is closed, nothing more is kept
    sc.score(m, batch)
    assert len(kept["moe.route"]) == 2 * 2 and len(kept["eval.rows"]) == 2


def test_scorer_refuses_slates_without_a_shared_context():
    m = _model()
    batch = _slates()
    batch["ctx_end"][0, 0, 1] += 1
    with pytest.raises(ValueError):
        DecoderPrefixScorer(m.cfg, device="cpu").score(m, batch)


def test_scorer_counts_its_rows():
    m = _model()
    batch = _slates()
    trace.reset()
    trace.enable()
    try:
        DecoderPrefixScorer(m.cfg, group=4, device="cpu").score(m, batch)
        snap = trace.snapshot()
    finally:
        trace.disable()
        trace.reset()
    c = snap["counts"]
    n_ctx = (batch["image_len"][:, None] + batch["ctx_end"][..., 0]).sum()
    assert c["eval.rows_needed.prefill"] == n_ctx
    assert c["eval.rows_needed.answer"] == (batch["ans_len"] - 1).sum()
    assert c["eval.rows_launched.answer"] >= c["eval.rows_needed.answer"]
    tokens = n_ctx + (batch["ans_len"] - 1).sum()
    assert c["moe.rows_routed"] == tokens * 2
    assert tokens * 2 / 8 <= c["moe.rows_max"] <= tokens * 2
    for name in ("eval.prefill", "eval.answer", "op.moe", "op.moe.route",
                 "op.mla_prefill", "op.mla_answer"):
        assert name in snap["spans"], name


def test_router_is_noaux_tc():
    w = ref.Weights(CFG, SEED, "cpu")
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal((40, 64)).astype(np.float32))
    p = "model.layers.1."
    own, scores, _ = ref.route(CFG, w, p, h, ref.Precision("fp32"))
    idx, wt = moe.route(h, w[p + "mlp.gate.weight"],
                        w[p + "mlp.gate.e_score_correction_bias"], top_k=2,
                        scale=2.446)
    assert torch.equal(idx, own)
    torch.testing.assert_close(wt, ref.route_weights(CFG, scores, own),
                               rtol=1e-6, atol=1e-6)
    # the bias changes the choice, not the weights' scores
    idx0, _ = moe.route(h, w[p + "mlp.gate.weight"], torch.zeros(8),
                        top_k=2, scale=2.446)
    assert not torch.equal(idx0, idx)


def test_grouped_moe_against_a_loop_over_experts():
    rng = np.random.default_rng(4)
    T, H, E, I, k = 37, 64, 8, 32, 2
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(T, H, generator=gen)
    gate = torch.randn(E, I, H, generator=gen) * 0.1
    up = torch.randn(E, I, H, generator=gen) * 0.1
    down = torch.randn(E, H, I, generator=gen) * 0.1
    # expert 0 gets no row, expert 1 every row
    idx = torch.stack([torch.ones(T, dtype=torch.long),
                       torch.from_numpy(rng.integers(2, E, T))], 1)
    wt = torch.rand(T, k, generator=gen)
    got = moe.routed_experts(x, idx, wt, moe.interleave_gate_up(gate, up),
                             down)
    want = torch.zeros(T, H)
    for e in range(E):
        for s in range(k):
            sel = idx[:, s] == e
            y = (F.silu(x[sel] @ gate[e].t()) * (x[sel] @ up[e].t())) @ \
                down[e].t()
            want[sel] += wt[sel, s, None] * y
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    order, counts, row_off, tile_off = moe.plan(idx, E)
    assert counts[0] == 0 and counts[1] == T
    assert row_off.tolist()[:3] == [0, 0, T]
    assert tile_off.tolist()[:3] == [0, 0, 1]


def test_checks_see_a_planted_fault_and_the_fp8_control():
    m = _model()
    batch = _slates(7)
    got = DecoderPrefixScorer(m.cfg, device="cpu").score(m, batch)[0]
    n = batch["ans_len"].reshape(-1, 5)
    want, _ = _ref_ll(CFG, batch)
    ok_gap = np.max(np.abs(got["ll_sum"] - want) / n)
    fp8, _ = _ref_ll(CFG, batch, prec=ref.Precision("fp8"))
    fp8_gap = np.max(np.abs(fp8 - want) / n)
    # a fault: the correction bias left out of the program's choice
    lay = m.layers[1]
    lay["e_score_correction_bias"].zero_()
    bad = DecoderPrefixScorer(m.cfg, device="cpu").score(m, batch)[0]
    bad_gap = np.max(np.abs(bad["ll_sum"] - want) / n)
    assert ok_gap < 1e-4 and 1e-2 < min(fp8_gap, bad_gap)
