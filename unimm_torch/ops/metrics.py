"""Retrieval metrics: ranks, R@k / MRR / mean rank, and NDCG.

The port of the JAX package's ``ops/metrics.py`` (reference
utils/visdial_metrics.py semantics), computed with torch on host tensors.
The accumulators keep the observe / retrieve API; ``allreduce_metrics``
merges the accumulators of the ranks of a data-parallel world
(``parallel/dist.py``) through their additive statistics.
"""

from __future__ import annotations

import numpy as np
import torch

from unimm_torch.parallel import dist


def scores_to_ranks(scores):
    """[..., num_options] scores -> 1-based ranks (1 = best), ties broken
    by option order (a stable sort, like the reference's torch.sort)."""
    s = torch.as_tensor(np.asarray(scores))
    order = torch.argsort(-s, dim=-1, stable=True)
    return (torch.argsort(order, dim=-1) + 1).numpy()


def gt_ranks(scores, gt_inds):
    """Rank of the ground-truth option. scores [..., O], gt_inds [...]."""
    ranks = torch.as_tensor(scores_to_ranks(scores))
    idx = torch.as_tensor(np.asarray(gt_inds), dtype=torch.long)
    return torch.gather(ranks, -1, idx[..., None])[..., 0].numpy()


def sparse_metrics_from_ranks(ranks) -> dict:
    """A flat array of GT ranks -> R@1 / R@5 / R@10 / mean rank / MRR."""
    r = np.asarray(ranks, np.float32)
    return {"r@1": float(np.mean(r <= 1, dtype=np.float32)),
            "r@5": float(np.mean(r <= 5, dtype=np.float32)),
            "r@10": float(np.mean(r <= 10, dtype=np.float32)),
            "mean": float(np.mean(r, dtype=np.float32)),
            "mrr": float(np.mean(np.float32(1.0) / r, dtype=np.float32))}


def ndcg_batch(scores, relevance):
    """Per-example NDCG: k = number of options with nonzero relevance; DCG
    over the top-k options in predicted order with log2(i + 2) discounts,
    normalised by the ideal DCG. scores / relevance [B, O] -> [B]."""
    rel = torch.as_tensor(np.asarray(relevance), dtype=torch.float32)
    O = rel.shape[-1]
    ranks = torch.as_tensor(scores_to_ranks(scores))
    pred_order = torch.argsort(ranks, dim=-1, stable=True)
    best_order = torch.argsort(-rel, dim=-1, stable=True)
    k = (rel != 0).sum(-1)
    discounts = 1.0 / torch.log2(torch.arange(O, dtype=torch.float32) + 2.0)
    pos_mask = (torch.arange(O)[None, :] < k[:, None]).float()
    dcg = (torch.gather(rel, -1, pred_order) * discounts * pos_mask).sum(-1)
    idcg = (torch.gather(rel, -1, best_order) * discounts * pos_mask).sum(-1)
    return (dcg / torch.clamp(idcg, min=1e-12)).numpy()


class SparseGTMetrics:
    """Accumulates ground-truth ranks; ``retrieve()`` returns R@k / mean /
    MRR and their per-round variants."""

    def __init__(self):
        self.reset()

    def observe(self, predicted_scores, target_inds):
        """predicted_scores [B, R, O]; target_inds [B, R]. An empty batch is
        a no-op."""
        if np.asarray(predicted_scores).shape[0] == 0:
            return
        ranks = gt_ranks(predicted_scores, target_inds)
        self._ranks_rnd.append(ranks.reshape(ranks.shape[0], -1))

    def stats(self):
        """Sufficient statistics: ([5, R] per-round sums of (r <= 1,
        r <= 5, r <= 10, r, 1 / r), the observed row count); (None, 0)
        before any row. Additive across ranks (``allreduce_metrics``)."""
        if not self._ranks_rnd:
            return None, 0
        r = np.concatenate(self._ranks_rnd, axis=0).astype(np.float64)
        s = np.stack([(r <= 1).sum(0), (r <= 5).sum(0), (r <= 10).sum(0),
                      r.sum(0), (1.0 / r).sum(0)])
        return s, r.shape[0]

    @staticmethod
    def metrics_from_stats(s, n) -> dict:
        """The metrics of ``stats()``'s sums ``s``. ``n``: the observed row
        count, a scalar (every row carries every round) or a per-round
        count [R] (a merge over ranks that observed different round
        counts: each round's sums are divided by its own count, and a
        round no rank observed is left out)."""
        if s is None:
            return {}
        n_round = (np.full(s.shape[1], float(n), np.float64)
                   if np.ndim(n) == 0 else np.asarray(n, np.float64))
        if not n_round.sum():
            return {}
        total = float(n_round.sum())
        metrics = {k: float(v) / total for k, v in zip(
            ("r@1", "r@5", "r@10", "mean", "mrr"), s.sum(axis=1))}
        for rnd in range(s.shape[1]):
            if not n_round[rnd]:
                continue
            for k, v in zip(("r_1", "r_5", "r_10", "mean", "mrr"),
                            s[:, rnd]):
                metrics[f"{k}_round_{rnd + 1}"] = float(v) / n_round[rnd]
        return metrics

    def retrieve(self, reset: bool = True) -> dict:
        metrics = self.metrics_from_stats(*self.stats())
        if reset:
            self.reset()
        return metrics

    def reset(self):
        self._ranks_rnd = []


class NDCG:
    def __init__(self):
        self.reset()

    def observe(self, predicted_scores, target_relevance):
        if np.asarray(predicted_scores).shape[0] == 0:
            return
        vals = ndcg_batch(predicted_scores, target_relevance)
        self._num += float(vals.sum())
        self._den += vals.shape[0]

    def retrieve(self, reset: bool = True) -> dict:
        metrics = {"ndcg": self._num / self._den} if self._den else {}
        if reset:
            self.reset()
        return metrics

    def reset(self):
        self._num = 0.0
        self._den = 0


def allreduce_metrics(sparse: SparseGTMetrics, ndcg: NDCG) -> dict:
    """The metrics of every rank's observations together (data-sharded
    eval: each rank scored a disjoint shard of the split): the additive
    statistics of all ranks are gathered and summed, then ``retrieve``'s
    formulas applied, so the result equals one process having observed
    every row. The accumulators are left as they are. A rank may have
    observed no row at all (its shards were all tail padding): the ranks
    first agree on the largest round count and such a rank contributes
    zeros."""
    s, n = sparse.stats()
    r_max = int(max(dist.allgather_np(
        np.asarray([0 if s is None else s.shape[1]], np.int64)))[0])
    if r_max == 0:
        return {}
    s_pad = np.zeros((5, r_max), np.float64)
    # per-round row counts: a rank that observed fewer rounds adds no
    # count to the rounds it never saw
    n_pad = np.zeros(r_max, np.float64)
    if s is not None:
        s_pad[:, :s.shape[1]] = s
        n_pad[:s.shape[1]] = float(n)
    payload = np.concatenate([s_pad.ravel(), n_pad,
                              [ndcg._num, float(ndcg._den)]])
    g = np.stack(dist.allgather_np(payload)).sum(axis=0)
    metrics = SparseGTMetrics.metrics_from_stats(
        g[:5 * r_max].reshape(5, r_max), g[5 * r_max:6 * r_max])
    num, den = g[-2:]
    if den:
        metrics["ndcg"] = float(num / den)
    return metrics
