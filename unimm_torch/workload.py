"""The serving workloads: shared-context generative slates (val_lm) and
discriminative NSP-ranking slates; and the synthetic training batch.

Copies of the JAX package's ``scripts/bench_workload.make_val_batch``,
``make_dis_batch`` and ``realistic_ctx_range`` with the same defaults and
the same per-option RNG draw order, so a seed gives the same batches in
both packages. Per (dialog, round): one shared context of 58-191 tokens;
per option a 2-8 token answer. Generative: the answer appended as the
first copy plus a masked second copy carrying the labels, the layout
encode_gen emits for real VisDial slates. Discriminative: the answer
appended once, mode 0, the layout encode_dis emits.
"""

import numpy as np


def realistic_ctx_range(L):
    """Per-round context ranges following real VisDial dialog growth: the
    round-r context is the caption plus r question/answer pairs, about
    10 + 22 r tokens (~30 at round 1 to ~250 at round 10), +/-15%, capped
    to leave room for the two answer copies."""
    def fn(r):
        base = 10 + 22 * (r + 1)
        lo = max(24, int(base * 0.85))
        hi = min(L - 18, int(base * 1.15))
        return lo, max(lo + 1, hi)
    return fn


def make_dis_batch(rng, cfg, B=2, R=10, O=100, ctx_range=(58, 192),
                   ans_range=(2, 9), feat_dim=None, ctx_range_fn=None):
    """A [B, R, O] discriminative (NSP-ranking) val batch drawn from
    ``rng``: context + one answer copy per option, mode 0, ctx_end = the
    real length, ans_len 0, no labels; the ranking targets
    (gt_option_inds, round_id, gt_relevance, image_id) are drawn after
    the images, as the JAX package draws them."""
    L, Rg = cfg.max_seq_len, cfg.max_regions
    if feat_dim is None:
        feat_dim = 2048
    tokens = np.zeros((B, R, O, L), np.int32)
    segments = np.zeros((B, R, O, L), np.int32)
    ctx_end = np.zeros((B, R, O), np.int32)
    for b in range(B):
        for r in range(R):
            lc = int(rng.integers(*(ctx_range_fn(r) if ctx_range_fn
                                    else ctx_range)))
            ctx = rng.integers(1, cfg.vocab_size, lc).astype(np.int32)
            cs = rng.integers(0, 2, lc).astype(np.int32)
            for o in range(O):
                a = int(rng.integers(*ans_range))
                ans = rng.integers(1, cfg.vocab_size, a).astype(np.int32)
                t1 = min(lc + a, L)
                tokens[b, r, o, :lc] = ctx
                segments[b, r, o, :lc] = cs
                tokens[b, r, o, lc:t1] = ans[:t1 - lc]
                ctx_end[b, r, o] = t1
    return {
        "tokens": tokens, "segments": segments,
        "mode": np.zeros((B, R, O), np.int32),
        "ctx_end": ctx_end, "ans_len": np.zeros((B, R, O), np.int32),
        "mlm_labels": np.full((B, R, O, L), -1, np.int32),
        "image_feat": rng.normal(size=(B, Rg, feat_dim)).astype(np.float32),
        "image_loc": rng.normal(size=(B, Rg, 5)).astype(np.float32),
        "image_mask": np.ones((B, Rg), np.float32),
        "gt_option_inds": rng.integers(0, O, (B, R)).astype(np.int32),
        "round_id": rng.integers(1, R + 1, (B,)).astype(np.int32),
        "gt_relevance": rng.random((B, O)).astype(np.float32),
        "image_id": np.arange(B).astype(np.int64),
    }


def make_val_batch(rng, cfg, B=2, R=10, O=100, ctx_range=(58, 192),
                   ans_range=(2, 9), feat_dim=None, ctx_range_fn=None):
    """A [B, R, O] generative val batch drawn from ``rng``
    (np.random.Generator). ``ctx_range_fn(r) -> (lo, hi)`` overrides
    ctx_range per round (the realistic series)."""
    L, Rg = cfg.max_seq_len, cfg.max_regions
    if feat_dim is None:
        feat_dim = 2048
    tokens = np.zeros((B, R, O, L), np.int32)
    segments = np.zeros((B, R, O, L), np.int32)
    labels = np.full((B, R, O, L), -1, np.int32)
    ctx_end = np.zeros((B, R, O), np.int32)
    ans_len = np.zeros((B, R, O), np.int32)
    for b in range(B):
        for r in range(R):
            lc = int(rng.integers(*(ctx_range_fn(r) if ctx_range_fn
                                    else ctx_range)))
            ctx = rng.integers(1, cfg.vocab_size, lc).astype(np.int32)
            cs = rng.integers(0, 2, lc).astype(np.int32)
            for o in range(O):
                a = int(rng.integers(*ans_range))
                ans = rng.integers(1, cfg.vocab_size, a).astype(np.int32)
                tokens[b, r, o, :lc] = ctx
                segments[b, r, o, :lc] = cs
                t1, t2 = lc + a, min(lc + 2 * a, L)
                tokens[b, r, o, lc:t1] = ans
                tokens[b, r, o, t1:t2] = ans[:t2 - t1]
                labels[b, r, o, t1:t2] = ans[:t2 - t1]
                ctx_end[b, r, o] = t1
                ans_len[b, r, o] = a
    return {
        "tokens": tokens, "segments": segments,
        "mode": np.ones((B, R, O), np.int32),
        "ctx_end": ctx_end, "ans_len": ans_len, "mlm_labels": labels,
        "image_feat": rng.normal(size=(B, Rg, feat_dim)).astype(np.float32),
        "image_loc": rng.normal(size=(B, Rg, 5)).astype(np.float32),
        "image_mask": np.ones((B, Rg), np.float32),
    }


def with_ranking_targets(batch, rng):
    """The batch plus the ranking targets ``evaluate_split`` reads
    (gt_option_inds [B, R], round_id [B], gt_relevance [B, O], image_id
    [B]), drawn from ``rng``; the slates themselves are unchanged."""
    B, R, O = batch["tokens"].shape[:3]
    return {**batch,
            "gt_option_inds": rng.integers(0, O, (B, R)).astype(np.int32),
            "round_id": rng.integers(1, R + 1, (B,)).astype(np.int32),
            "gt_relevance": rng.random((B, O)).astype(np.float32),
            "image_id": np.arange(B).astype(np.int64)}


def make_train_batch(rng, cfg, B=240):
    """A [B]-sequence training batch drawn from ``rng`` (numpy arrays): the
    JAX package's scripts/bench_train.py:make_batch, draw for draw. Mixed
    discriminative / generative descriptors (context 60-199, answer 2-8);
    10-39 MLM labels per sequence at positions inside its extent, weight 1,
    and -1 (unlikelihood) for the first quarter of the batch; random NSP
    labels; Dirichlet region-class targets and image_label in {-1, 0, 1}."""
    L, R = cfg.max_seq_len, cfg.max_regions
    ctx_end = rng.integers(60, 200, B).astype(np.int32)
    ans_len = rng.integers(2, 9, B).astype(np.int32)
    labels = np.full((B, L), -1, np.int32)
    n_lab = rng.integers(10, 40, B)
    for i in range(B):
        hi = max(int(ctx_end[i]) - 2, 12)
        k = min(int(n_lab[i]), hi)
        pos = rng.permutation(hi)[:k] + 1
        labels[i, pos] = rng.integers(0, cfg.vocab_size, k)
    w = np.zeros((B, L), np.float32)
    w[labels != -1] = 1.0
    w[: B // 4][labels[: B // 4] != -1] = -1.0
    return {
        "tokens": rng.integers(1, cfg.vocab_size, (B, L)).astype(np.int32),
        "segments": rng.integers(0, 2, (B, L)).astype(np.int32),
        "mode": rng.integers(0, 2, B).astype(np.int32),
        "ctx_end": ctx_end,
        "ans_len": ans_len,
        "mlm_labels": labels, "lm_weight": w,
        "next_sentence_label": rng.integers(0, 2, B).astype(np.int32),
        "image_feat": rng.normal(size=(B, R, cfg.v_feature_size)).astype(
            np.float32),
        "image_loc": rng.normal(size=(B, R, 5)).astype(np.float32),
        "image_mask": np.ones((B, R), np.int32),
        "image_target": rng.dirichlet(np.ones(cfg.v_target_size),
                                      (B, R)).astype(np.float32),
        "image_label": rng.choice([-1, 0, 1], (B, R)).astype(np.int32),
    }
