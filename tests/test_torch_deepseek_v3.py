"""The port's DeepSeek-V3 decoder (Kimi-VL-A3B's language model) against
the benchmark's plain fp32 reference (``benchmark/reference/
deepseek_v3_ref.py``) on the CPU at a small size: two layers (the dense one
and one MoE layer of 8 experts, top 2, two shared), hidden 64, seeded
weights. The full forward's logits, the decoder prefix scorer's ll_sum
(through ``RankingEvaluator.score_slates_async``) against the reference's
uncached forward of every option, the router against the reference's
noaux_tc, and the grouped MoE against a loop over the experts, with an
expert given no row and one given every row. The absorbed answer pass
(``ops/mla_answer``: its row-tile plan, its plain version, and the
kernel's tile walk emulated in fp32) against the expanded form over whole
sequences."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import deepseek_v3_ref as ref
from unimm_torch.config import DeepseekV3Config
from unimm_torch.eval.decoder_prefix import DecoderPrefixScorer
from unimm_torch.eval.evaluator import RankingEvaluator
from unimm_torch.models import deepseek_v3 as dsv3
from unimm_torch.ops import mla_answer, moe
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
    # the absorbed attention's real (row, key) pairs: each option's k rows
    # see the context and 1 .. k of its own rows
    k = batch["ans_len"] - 1
    nc = (batch["image_len"][:, None] + batch["ctx_end"][..., 0])[..., None]
    assert c["mla.pairs_needed"] == (k * nc + k * (k + 1) // 2).sum()
    assert c["mla.pairs_launched"] >= c["mla.pairs_needed"]
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


def test_mla_plan_on_a_hand_built_group():
    # two slates of three options: 1, 8, 3 rows against a context of 70
    # (two key tiles, the second short), 2, 2, 7 rows against 5
    n_rows = np.array([[1, 8, 3], [2, 2, 7]])
    arrays, c = mla_answer.plan(n_rows, np.array([70, 5]), nh=16)
    assert mla_answer.rows_per_tile(16) == 4
    assert arrays["tiles"].tolist() == [[0, 0, 4], [0, 4, 8], [0, 8, 12],
                                        [1, 12, 16], [1, 16, 20],
                                        [1, 20, 23]]
    assert arrays["first"].tolist() == ([0] + [1] * 8 + [9] * 3 + [12] * 2
                                        + [14] * 2 + [16] * 7)
    assert arrays["n_ctx"].dtype == np.int32
    # sum over options of k n_ctx + k (k + 1) / 2
    assert c["pairs_needed"] == (12 * 70 + 1 + 36 + 6) + (11 * 5 + 3 + 3
                                                          + 28)
    # 4 rows x 64 keys x (cache tiles + the own tile), three row tiles each
    assert c["pairs_launched"] == 4 * 64 * (3 * (2 + 1) + 3 * (1 + 1))
    assert (c["rows_needed"], c["rows_launched"]) == (23, 24)
    assert mla_answer.max_option_rows(16) == 61
    mla_answer.plan(np.array([[61]]), np.array([9]), nh=16)
    with pytest.raises(ValueError):
        mla_answer.plan(np.array([[62]]), np.array([9]), nh=16)
    with pytest.raises(ValueError):
        mla_answer.plan(n_rows, np.array([70, 5]), nh=12)


def _tile_walk(qf, cache, kr, arrays, value_dim):
    """The kernel's walk in fp32: per row tile, its slate's cache tiles up
    to n_ctx, then one own tile from its first row's option's first row,
    each masked from the metadata alone, under an online softmax with p
    rounded to qf.dtype for the product with v."""
    N, nh, C = qf.shape
    rt = mla_answer.rows_per_tile(nh)
    T = mla_answer.KEY_TILE
    out = torch.zeros(N, nh, value_dim)
    for g, n0, n1 in arrays["tiles"].tolist():
        nctx = int(arrays["n_ctx"][g])
        rows = torch.arange(n0, n0 + rt)
        real = rows < n1
        lo = torch.where(real, torch.from_numpy(
            arrays["first"][np.minimum(rows.numpy(), N - 1)]).long(), 1)
        hi = torch.where(real, rows, 0)
        q = torch.zeros(rt, nh, C)
        q[:n1 - n0] = qf[n0:n1].float()
        m = torch.full((rt, nh, 1), float("-inf"))
        l = torch.zeros(rt, nh, 1)
        o = torch.zeros(rt, nh, value_dim)
        base = int(arrays["first"][n0])
        n_cache = -(-nctx // T)
        for t in range(n_cache + 1):
            if t < n_cache:
                keys = torch.zeros(T, C)
                seg = cache[g, T * t:min(T * (t + 1), cache.shape[1])]
                keys[:seg.shape[0]] = seg.float()
                ok = (T * t + torch.arange(T) < nctx)[None, :].expand(rt, T)
            else:
                keys = torch.zeros(T, C)
                seg = kr[base:base + T]
                keys[:seg.shape[0]] = seg.float()
                k = base + torch.arange(T)
                ok = (k[None, :] >= lo[:, None]) & (k[None, :] <= hi[:, None])
            s = torch.einsum("rhc,kc->rhk", q, keys).masked_fill(
                ~ok[:, None, :], float("-inf"))
            mn = torch.maximum(m, s.amax(-1, keepdim=True))
            mu = torch.where(mn == float("-inf"), 0.0, mn)
            alpha = torch.exp(m - mu)
            p = torch.exp(s - mu)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + torch.einsum(
                "rhk,kv->rhv", p.to(qf.dtype).float(), keys[:, :value_dim])
            m = mn
        out[n0:n1] = (o / l)[:n1 - n0]
    return out.to(qf.dtype)


@pytest.mark.parametrize("heads", [2, 16])
def test_absorbed_answer_pass_against_the_expanded_form(heads):
    """Three slates of one group (contexts of 70, 5 and 33 positions: a
    short last key tile, a context inside one tile) with options of 1-8
    rows, so that row tiles straddle options: each option's rows through
    the absorbed form (the plain core and the kernel's tile walk) against
    the expanded form over the whole sequence, context then the option's
    rows, at the same rows."""
    cfg = DeepseekV3Config.from_dict({**CFG, "num_attention_heads": heads})
    gen = torch.Generator().manual_seed(heads)
    nh, dq = heads, cfg.q_head_dim
    H, R = cfg.hidden_size, cfg.kv_lora_rank

    def w(*shape):
        return torch.randn(*shape, generator=gen) * 0.15

    lay = dict(q=w(nh * dq, H), kv_a=w(R + cfg.qk_rope_head_dim, H),
               kv_a_ln=1 + 0.1 * w(R),
               kv_b=w(nh * (cfg.qk_nope_head_dim + cfg.v_head_dim), R),
               o=w(H, nh * cfg.v_head_dim))
    n_ctx = np.array([70, 5, 33])
    n_rows = np.array([[1, 8, 3, 5], [2, 7, 4, 1], [6, 1, 8, 2]])
    G, O = n_rows.shape
    Lcb = 128
    ctx = [w(int(n), H) for n in n_ctx]
    ans = [[w(int(k), H) for k in row] for row in n_rows]
    # the contexts' caches, then the answer rows in option-major order
    slots = torch.cat([g * Lcb + torch.arange(int(n))
                       for g, n in enumerate(n_ctx)])
    _, cache = dsv3.mla_expanded(lay, cfg, torch.cat(ctx), slots, G, Lcb)
    arrays, _ = mla_answer.plan(n_rows, n_ctx, nh)
    rows = mla_answer.AnswerRows.put(arrays, "cpu")
    h = torch.cat([a for row in ans for a in row])
    pos = torch.cat([int(n_ctx[g]) + torch.arange(int(k))
                     for g in range(G) for k in n_rows[g]])
    got = dsv3.mla_absorbed(lay, cfg, h, pos, cache, rows)
    # each whole sequence through the expanded form
    seqs = [torch.cat([ctx[g], a]) for g in range(G) for a in ans[g]]
    L = max(s.shape[0] for s in seqs)
    want, _ = dsv3.mla_expanded(
        lay, cfg, torch.cat(seqs),
        torch.cat([i * L + torch.arange(s.shape[0])
                   for i, s in enumerate(seqs)]), len(seqs), L)
    ends = np.cumsum([s.shape[0] for s in seqs])
    keep = torch.cat([torch.arange(e - k, e) for e, k in
                      zip(ends, n_rows.ravel())])
    torch.testing.assert_close(got, want[keep], rtol=1e-4, atol=1e-4)
    # the attention core alone: the plain version against the tile walk
    qf = torch.randn(h.shape[0], nh, R + cfg.qk_rope_head_dim,
                     generator=gen)
    kr = torch.randn(h.shape[0], qf.shape[2], generator=gen)
    plain = mla_answer.mla_answer(qf, cache, kr, rows, R)
    torch.testing.assert_close(plain, _tile_walk(qf, cache, kr, arrays, R),
                               rtol=1e-5, atol=1e-5)
    # the layouts the kernel must take: a row tile across two options,
    # and a slate whose last key tile is short
    t = arrays["tiles"]
    f = arrays["first"]
    assert (f[t[:, 1]] != f[t[:, 2] - 1]).any()
    assert n_ctx[0] % mla_answer.KEY_TILE
