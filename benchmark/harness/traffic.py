"""The benchmark's one traffic generator. A mix is a data file under
``benchmark/traffic`` whose ``kind`` picks the shape of its inputs:

* ``slates``: Visual Dialog val slates, [dialogs, rounds, options, L]
  descriptor batches shaped like ``encode_gen`` (``layout`` "gen": the
  answer, then its masked copy carrying the labels, mode 1) or
  ``encode_dis`` output (``layout`` "dis": the answer once, mode 0),
  grouped into loader batches of ``loader_batch`` dialogs;
* ``train``: UniMM-UL training batches of ``batch`` sequences, mixed
  discriminative and generative descriptors with MLM labels (the first
  quarter of a batch unlikelihood), NSP labels and masked-region targets.

The distributions are those of the program's synthetic workloads
(``workload.make_val_batch`` / ``make_dis_batch`` / ``make_train_batch`` and
``realistic_ctx_range``, whose context growth a slate mix states as
data), drawn in bulk. The sizes that set the work
(context and answer lengths, label counts and positions, modes) come from
the mix's fixed ``size_seed``, so every run seed serves the same work; the
run seed draws the contents (tokens, segments, labels, features, targets)
and the order in which the pool is served.
"""

from __future__ import annotations

import numpy as np


def ctx_bounds(growth: dict, r: int, L: int):
    """[lo, hi) of a round-r context (r from 0) under the mix's
    ``ctx_growth``: about ``first + per_round (r + 1)`` tokens, from
    ``low`` to ``high`` times that, at least ``min``, and capped to leave
    ``room`` tokens for the answers."""
    base = growth["first"] + growth["per_round"] * (r + 1)
    lo = max(growth["min"], int(base * growth["low"]))
    hi = min(L - growth["room"], int(base * growth["high"]))
    return lo, max(lo + 1, hi)


def slate_sizes(mix: dict, L: int):
    """(lc [D, R], a [D, R, O]): the shared context length of each slate
    and the answer length of each option, from the mix's ``size_seed``."""
    rng = np.random.default_rng(mix["size_seed"])
    D, R, O = mix["dialogs"], mix["rounds"], mix["options"]
    bounds = np.array([ctx_bounds(mix["ctx_growth"], r, L)
                       for r in range(R)])
    lc = rng.integers(bounds[:, 0], bounds[:, 1], (D, R))
    a = rng.integers(mix["ans_range"][0], mix["ans_range"][1], (D, R, O))
    return lc.astype(np.int64), a.astype(np.int64)


def make_slates(mix: dict, cfg: dict, seed: int):
    """The pool: a list of loader batches (dicts of numpy arrays over
    ``loader_batch`` dialogs) and the seeded serving order of the
    coalesced groups (a permutation of the pool's group indices)."""
    L, Rg, V = cfg["max_seq_len"], cfg["max_regions"], cfg["vocab_size"]
    D, R, O = mix["dialogs"], mix["rounds"], mix["options"]
    lc, a = slate_sizes(mix, L)
    rng = np.random.default_rng([seed, 0])
    ctx = rng.integers(1, V, (D, R, L)).astype(np.int32)
    cseg = rng.integers(0, 2, (D, R, L)).astype(np.int32)
    ans = rng.integers(1, V, (D, R, O, L)).astype(np.int32)
    j = np.arange(L)
    in_ctx = j < lc[..., None]                               # [D, R, L]
    tokens = np.where(in_ctx[:, :, None], ctx[:, :, None], 0)
    segments = np.broadcast_to(np.where(in_ctx, cseg, 0)[:, :, None],
                               (D, R, O, L))
    lc4, a4 = lc[:, :, None, None], a[..., None]
    first = (j >= lc4) & (j < lc4 + a4)
    src = np.clip(j - lc4, 0, L - 1)
    if mix["layout"] == "gen":
        # the answer, then its masked copy (labels) up to L
        second = (j >= lc4 + a4) & (j < np.minimum(lc4 + 2 * a4, L))
        src = np.where(second, j - lc4 - a4, src)
        ans_tok = np.take_along_axis(ans, src, -1)
        tokens = np.where(first | second, ans_tok, tokens)
        labels = np.where(second, ans_tok, -1).astype(np.int32)
        ctx_end = (lc[..., None] + a).astype(np.int32)
        ans_len = a.astype(np.int32)
        mode = np.ones((D, R, O), np.int32)
    else:
        first &= j < L
        ans_tok = np.take_along_axis(ans, src, -1)
        tokens = np.where(first, ans_tok, tokens)
        labels = np.full((D, R, O, L), -1, np.int32)
        ctx_end = np.minimum(lc[..., None] + a, L).astype(np.int32)
        ans_len = np.zeros((D, R, O), np.int32)
        mode = np.zeros((D, R, O), np.int32)
    feat = rng.standard_normal((D, Rg, cfg["v_feature_size"]),
                               dtype=np.float32)
    loc = rng.standard_normal((D, Rg, 5), dtype=np.float32)
    nb = mix["loader_batch"]
    if D % (nb * mix["coalesce"]):
        raise ValueError("dialogs must fill whole coalesced groups")
    pool = []
    for s in range(0, D, nb):
        e = s + nb
        pool.append({
            "tokens": tokens[s:e].astype(np.int32),
            "segments": segments[s:e].astype(np.int32),
            "mode": mode[s:e], "ctx_end": ctx_end[s:e],
            "ans_len": ans_len[s:e], "mlm_labels": labels[s:e],
            "image_feat": feat[s:e], "image_loc": loc[s:e],
            "image_mask": np.ones((nb, Rg), np.float32)})
    n_groups = len(pool) // mix["coalesce"]
    order = rng.permutation(n_groups)
    return pool, order


def train_sizes(mix: dict, L: int, index: int):
    """The sizes of pool batch ``index`` (same for every run seed):
    ctx_end, ans_len, mode, and each row's label positions (a bool
    [B, L] map)."""
    rng = np.random.default_rng([mix["size_seed"], index])
    B = mix["batch"]
    ctx_end = rng.integers(*mix["ctx_range"], B)
    ans_len = rng.integers(*mix["ans_range"], B)
    mode = rng.integers(0, 2, B)
    n_lab = rng.integers(*mix["labels_range"], B)
    where = np.zeros((B, L), bool)
    for i in range(B):
        hi = max(int(ctx_end[i]) - 2, 12)
        k = min(int(n_lab[i]), hi)
        where[i, rng.permutation(hi)[:k] + 1] = True
    return (ctx_end.astype(np.int32), ans_len.astype(np.int32),
            mode.astype(np.int32), where)


def make_train(mix: dict, cfg: dict, seed: int):
    """The pool of ``pool`` training batches (flat dicts of numpy arrays)
    and the seeded order in which the window serves them."""
    L, Rg, V = cfg["max_seq_len"], cfg["max_regions"], cfg["vocab_size"]
    B = mix["batch"]
    rng = np.random.default_rng([seed, 1])
    pool = []
    for i in range(mix["pool"]):
        ctx_end, ans_len, mode, where = train_sizes(mix, L, i)
        labels = np.where(where, rng.integers(0, V, (B, L)),
                          -1).astype(np.int32)
        w = where.astype(np.float32)
        w[: int(B * mix["unlikelihood_share"])] *= -1.0
        e = rng.standard_exponential((B, Rg, cfg["v_target_size"]),
                                     dtype=np.float32)
        pool.append({
            "tokens": rng.integers(1, V, (B, L)).astype(np.int32),
            "segments": rng.integers(0, 2, (B, L)).astype(np.int32),
            "mode": mode, "ctx_end": ctx_end, "ans_len": ans_len,
            "mlm_labels": labels, "lm_weight": w,
            "next_sentence_label": rng.integers(0, 2, B).astype(np.int32),
            "image_feat": rng.standard_normal(
                (B, Rg, cfg["v_feature_size"]), dtype=np.float32),
            "image_loc": rng.standard_normal((B, Rg, 5), dtype=np.float32),
            "image_mask": np.ones((B, Rg), np.int32),
            # Dirichlet(1, ..., 1): normalised exponentials
            "image_target": e / e.sum(-1, keepdims=True),
            "image_label": rng.choice(np.array([-1, 0, 1], np.int32),
                                      (B, Rg)),
        })
    order = rng.permutation(mix["pool"])
    return pool, order


def make(mix: dict, cfg: dict, seed: int):
    """The pool and serving order of mix ``mix`` for run seed ``seed``."""
    if mix["kind"] == "slates":
        return make_slates(mix, cfg, seed)
    if mix["kind"] == "train":
        return make_train(mix, cfg, seed)
    raise ValueError(f"traffic kind {mix['kind']!r}")
