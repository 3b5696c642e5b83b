"""Candidate-ranking evaluation on the prefix-cache path: generative
sequence log-likelihood ranking (reference val_lm.py) and its
token-averaged form (val_avg_lm.py).

The port of the JAX package's ``eval/evaluator.py`` serving loop:
``RankingEvaluator.score_slates(_async)`` scores [B, R, O] val batches
through the prefix-cache scorer; ``evaluate_split`` coalesces loader
batches, keeps ``pipeline_depth`` of them in flight, and accumulates R@k /
MRR / mean rank and NDCG.

Not in this slice: the flat chunked scorer (discriminative ``mode="nsp"``
and the fallback for slates the prefix scorer cannot take) and the mesh /
multi-process arguments. A batch that would need them raises
``NotImplementedError``; nothing quietly takes another path.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from unimm_torch.config import VilbertConfig
from unimm_torch.eval.prefix import PrefixScorer
from unimm_torch.ops import metrics as M

FLAT_NOT_PORTED = ("the flat chunked scorer (discriminative ranking and slates "
             "the prefix scorer cannot take) is not ported yet: ROADMAP.md "
             "queue A, 'flat and discriminative path'")


class RankingEvaluator:
    def __init__(self, cfg: VilbertConfig, *, dtype=torch.bfloat16,
                 bucket_div: int = 8, prefix_group: int = 40,
                 prefix_rowblock: int = 0, device="cuda"):
        """Answer log-likelihood scoring (the reference's need_lm, no NSP)
        through the prefix-cache scorer (eval/prefix.py)."""
        self.cfg = cfg
        self.dtype = dtype
        self._prefix = PrefixScorer(cfg, dtype=dtype, group=prefix_group,
                                    bucket_div=bucket_div,
                                    row_block=prefix_rowblock, device=device)

    def score_slates(self, model, batch) -> dict:
        """Score a [B, R, O] val batch; returns flat [B*R*O] ll_sum /
        ll_mean arrays in the batch's order."""
        return self.score_slates_async(model, batch)()

    def score_slates_async(self, model, batch):
        """Stage and launch a [B, R, O] val batch; return a closure that
        fetches and assembles the flat score dict."""
        B, R, O = np.asarray(batch["tokens"]).shape[:3]
        fin = self._prefix.score_async(model, batch)
        if not self._prefix.last_ok.all():
            raise NotImplementedError(
                f"{int((~self._prefix.last_ok).sum())} slate(s) not eligible "
                f"for prefix scoring; {FLAT_NOT_PORTED}")

        def finalize():
            scores, _ = fin()
            return {k: v.reshape(B * R * O) for k, v in scores.items()}

        return finalize


def _merge_batches(bs: Sequence[dict]) -> dict:
    """Concatenate loader batches along the dialog axis (coalesced serving).
    The 'valid' tail-padding mask is merged treating absent masks as
    all-True."""
    if len(bs) == 1:
        return bs[0]
    keys = set(bs[0]) - {"valid"}
    for b in bs[1:]:
        if set(b) - {"valid"} != keys:
            raise ValueError(
                f"coalesced batches must share keys: {sorted(keys)} vs "
                f"{sorted(set(b) - {'valid'})}")
    out = {k: np.concatenate([np.asarray(b[k]) for b in bs], axis=0)
           for k in keys}
    if any("valid" in b for b in bs):
        out["valid"] = np.concatenate(
            [np.asarray(b["valid"]) if "valid" in b
             else np.ones(np.asarray(b["tokens"]).shape[0], bool)
             for b in bs])
    return out


def _coalesced(loader, n: int):
    """Yield (number of loader batches merged, merged batch), up to n."""
    buf: List[dict] = []
    for b in loader:
        buf.append(b)
        if len(buf) == n:
            yield len(buf), _merge_batches(buf)
            buf = []
    if buf:
        yield len(buf), _merge_batches(buf)


def _serving_loop(loader, dispatch, consume, *, pipeline_depth: int,
                  coalesce: int):
    """Pipelined, coalesced serving loop: group i + depth is staged and
    launched before group i's scores are fetched. ``consume(done, batch,
    fin)`` receives the cumulative loader-batch count after the group."""
    if pipeline_depth < 1:
        raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
    if coalesce < 1:
        raise ValueError(f"coalesce must be >= 1, got {coalesce}")
    pending: List[tuple] = []
    done = 0
    for nb, batch in _coalesced(loader, coalesce):
        done += nb
        pending.append((done, batch, dispatch(batch)))
        if len(pending) > pipeline_depth:
            consume(*pending.pop(0))
    for p in pending:
        consume(*p)


def evaluate_split(model, cfg: VilbertConfig, loader, *, mode: str,
                   dtype=torch.bfloat16, ranks_out: Optional[list] = None,
                   progress_every: int = 10, log=print,
                   prefix_group: int = 40, prefix_rowblock: int = 0,
                   pipeline_depth: int = 1, coalesce: int = 2,
                   device="cuda") -> dict:
    """Run ranking eval over a loader of [B, R, O] val batches.

    mode: 'll_sum' (val_lm) or 'll_mean' (val_avg_lm); 'nsp' needs the flat
    scorer and raises. Batches carry gt_option_inds [B, R], round_id [B],
    gt_relevance [B, O], image_id [B] when ``ranks_out`` is given, and
    optionally a boolean ``valid`` [B] mask of rows to observe. Returns the
    metric dict (R@k / mean / MRR, per round, and NDCG).
    """
    if mode not in ("ll_sum", "ll_mean"):
        raise NotImplementedError(f"mode {mode!r}: {FLAT_NOT_PORTED}")
    ev = RankingEvaluator(cfg, dtype=dtype, prefix_group=prefix_group,
                          prefix_rowblock=prefix_rowblock, device=device)
    sparse = M.SparseGTMetrics()
    ndcg = M.NDCG()
    logged = 0

    def dispatch(batch):
        return ev.score_slates_async(model, batch)

    def consume(done, batch, finalize):
        nonlocal logged
        B, R, O = np.asarray(batch["tokens"]).shape[:3]
        out = finalize()[mode].reshape(B, R, O)
        valid = (np.asarray(batch["valid"]) if "valid" in batch
                 else np.ones(B, bool))
        if ranks_out is not None:
            ranks = M.scores_to_ranks(out)
            for b in range(B):
                if not valid[b]:
                    continue
                for r in range(R):
                    ranks_out.append({
                        "image_id": int(batch["image_id"][b]),
                        "round_id": r + 1,
                        "ranks": [int(x) for x in ranks[b, r]],
                    })
        sparse.observe(out[valid], np.asarray(batch["gt_option_inds"])[valid])
        rid = np.asarray(batch["round_id"]).reshape(B)
        dense_scores = out[np.arange(B), rid - 1]
        ndcg.observe(dense_scores[valid],
                     np.asarray(batch["gt_relevance"])[valid])
        if progress_every and done // progress_every > logged:
            logged = done // progress_every
            cur = {**sparse.retrieve(reset=False),
                   **ndcg.retrieve(reset=False)}
            keys = ("r@1", "r@5", "r@10", "mean", "mrr", "ndcg")
            body = " ".join(f"{k} {cur[k]:.4f}" for k in keys if k in cur)
            log(f"eval batches: {done} " + (body or "(no valid rows yet)"))

    _serving_loop(loader, dispatch, consume,
                  pipeline_depth=pipeline_depth, coalesce=coalesce)
    return {**sparse.retrieve(), **ndcg.retrieve()}
