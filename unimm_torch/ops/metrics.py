"""Retrieval metrics: ranks, R@k / MRR / mean rank, and NDCG.

The port of the JAX package's ``ops/metrics.py`` (reference
utils/visdial_metrics.py semantics), computed with torch on host tensors.
The accumulators keep the observe / retrieve API; multi-process merging is
not in this slice.
"""

from __future__ import annotations

import numpy as np
import torch


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

    def retrieve(self, reset: bool = True) -> dict:
        metrics = {}
        if self._ranks_rnd:
            r = np.concatenate(self._ranks_rnd, axis=0).astype(np.float64)
            sums = np.stack([(r <= 1).sum(0), (r <= 5).sum(0),
                             (r <= 10).sum(0), r.sum(0), (1.0 / r).sum(0)])
            n = r.shape[0]
            for name, v in zip(("r@1", "r@5", "r@10", "mean", "mrr"),
                               sums.sum(1)):
                metrics[name] = float(v) / (n * r.shape[1])
            for rnd in range(r.shape[1]):
                for name, v in zip(("r_1", "r_5", "r_10", "mean", "mrr"),
                                   sums[:, rnd]):
                    metrics[f"{name}_round_{rnd + 1}"] = float(v) / n
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
