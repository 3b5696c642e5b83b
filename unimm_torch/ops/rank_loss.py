"""Listwise learning-to-rank losses (the allRank-style zoo of the
reference's utils/rank_loss.py), in plain PyTorch and differentiable
through autograd.

The port of the JAX package's ``ops/rank_loss.py``: the NeuralSort +
Sinkhorn NDCG surrogates (``neuralNDCG_transposed`` is the one the dense
finetuning phase optimises, dense_annotation_finetuning.py:288) and the
rest of the zoo (listNet, listMLE, rankNet, approxNDCG, lambdaLoss), with
the JAX package's choices: Sinkhorn runs a fixed ``max_iter`` iterations,
``-inf`` fills that would reach a gradient are masked ``where`` chains
with finite fills, and rankNet's pair selection is a masked mean. Padded
entries carry the relevance ``-1``. The stochastic sort draws its Gumbel
noise from an explicit ``torch.Generator``, or takes the draws as
``gumbel``.
"""

from __future__ import annotations

import torch

DEFAULT_EPS = 1e-8
PADDED_Y_VALUE = -1
NEG_LARGE = -1e8


def _pad_mask(y_true, padded_value_indicator=PADDED_Y_VALUE):
    return y_true == padded_value_indicator


def _f(v, like):
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _log2_discounts(n, like):
    return 1.0 / torch.log2(torch.arange(n, dtype=torch.float32,
                                         device=like.device) + 2.0)


def dcg(y_pred, y_true, ats=None, gain_fn=lambda x: torch.pow(2.0, x) - 1,
        padded_value_indicator=PADDED_Y_VALUE):
    """DCG at ranks (rank_loss.py:18-54). Returns [B, len(ats)]."""
    mask = _pad_mask(y_true, padded_value_indicator)
    y_pred = torch.where(mask, _f(float("-inf"), y_pred), y_pred)
    y_true = torch.where(mask, _f(0.0, y_true), y_true)
    n = y_true.shape[1]
    ats = [n] if ats is None else [min(a, n) for a in ats]
    order = torch.argsort(-y_pred, dim=-1, stable=True)
    true_sorted = torch.gather(y_true, 1, order)
    cum = torch.cumsum(gain_fn(true_sorted) * _log2_discounts(n, y_true),
                       dim=1)
    return cum[:, torch.as_tensor(ats, device=cum.device) - 1]


def sinkhorn_scaling(mat, mask=None, max_iter=50):
    """Fixed-iteration Sinkhorn normalisation (rank_loss.py:55-78)."""
    if mask is not None:
        either = mask[:, None, :] | mask[:, :, None]
        both = mask[:, None, :] & mask[:, :, None]
        mat = torch.where(either, _f(0.0, mat), mat)
        mat = torch.where(both, _f(1.0, mat), mat)
    for _ in range(max_iter):
        mat = mat / torch.clamp(mat.sum(dim=1, keepdim=True),
                                min=DEFAULT_EPS)
        mat = mat / torch.clamp(mat.sum(dim=2, keepdim=True),
                                min=DEFAULT_EPS)
    if mask is not None:
        mat = torch.where(mask[:, None, :] | mask[:, :, None],
                          _f(0.0, mat), mat)
    return mat


def deterministic_neural_sort(s, tau, mask):
    """NeuralSort relaxation (rank_loss.py:79-112). s: [B, n, 1]; mask
    [B, n]; returns approximate permutation matrices [B, n, n]."""
    n = s.shape[1]
    s = torch.where(mask[:, :, None], _f(NEG_LARGE, s), s)
    A_s = torch.abs(s - s.transpose(1, 2))
    either = mask[:, None, :] | mask[:, :, None]
    both = mask[:, None, :] & mask[:, :, None]
    A_s = torch.where(either, _f(0.0, A_s), A_s)
    B = A_s.sum(dim=2, keepdim=True) * torch.ones(
        (1, 1, n), dtype=s.dtype, device=s.device)

    m = mask.sum(dim=1)                                 # padded count a row
    j = torch.arange(n, dtype=torch.float32, device=s.device)[None, :]
    n_eff = (n - m).to(torch.float32)[:, None]
    scaling = torch.where(j < n_eff, n_eff + 1 - 2 * (j + 1),
                          _f(0.0, j))                   # [B, n]

    s0 = torch.where(mask[:, :, None], _f(0.0, s), s)
    C = s0 * scaling[:, None, :]                        # [B, n, n]

    P_max = (C - B).transpose(1, 2)
    P_max = torch.where(either, _f(NEG_LARGE, P_max), P_max)
    P_max = torch.where(both, _f(1.0, P_max), P_max)
    return torch.softmax(P_max / tau, dim=-1)


def sample_gumbel(generator, shape, eps=1e-10, device="cpu"):
    """Standard Gumbel draws of ``shape`` from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u + eps) + eps)


def stochastic_neural_sort(s, n_samples, tau, mask, *, generator=None,
                           beta=1.0, log_scores=True, eps=1e-10,
                           gumbel=None):
    """rank_loss.py:125-153. Returns [n_samples, B, n, n]. The noise is
    ``gumbel`` ([n_samples, B, n, 1] standard Gumbel draws) when given,
    else drawn from ``generator``."""
    B, n = s.shape[0], s.shape[1]
    s_pos = s + torch.abs(s.min())
    if gumbel is None:
        gumbel = sample_gumbel(generator, (n_samples, B, n, 1),
                               device=s.device)
    samples = beta * gumbel.to(s.dtype)
    if log_scores:
        s_pos = torch.log(s_pos + eps)
    s_pert = (s_pos[None] + samples).reshape(n_samples * B, n, 1)
    # sample-major layout (s B + b): tile, not repeat_interleave, so the
    # masks align with the reshape above
    mask_rep = mask.repeat(n_samples, 1)
    P_hat = deterministic_neural_sort(s_pert, tau, mask_rep)
    return P_hat.reshape(n_samples, B, n, n)


def _soft_permutations(y_pred, mask, temperature, stochastic, n_samples,
                       beta, log_scores, max_iter, generator, gumbel):
    if stochastic:
        P_hat = stochastic_neural_sort(
            y_pred[..., None], n_samples, temperature, mask,
            generator=generator, beta=beta, log_scores=log_scores,
            gumbel=gumbel)
    else:
        P_hat = deterministic_neural_sort(y_pred[..., None], temperature,
                                          mask)[None]
    S, n = P_hat.shape[0], y_pred.shape[1]
    P_hat = sinkhorn_scaling(P_hat.reshape(S * y_pred.shape[0], n, n),
                             mask.repeat(S, 1), max_iter=max_iter)
    return P_hat.reshape(S, y_pred.shape[0], n, n)


def _mean_ndcg(ndcg, idcg, S):
    idcg_mask = idcg == 0.0
    ndcg = torch.where(idcg_mask[None], _f(0.0, ndcg), ndcg)
    denom = (~idcg_mask).sum() * S
    out = -ndcg.sum() / torch.clamp(denom, min=1)
    return torch.where(denom == 0, _f(0.0, out), out)


def neuralNDCG_transposed(y_pred, y_true,
                          padded_value_indicator=PADDED_Y_VALUE,
                          temperature=1.0, powered_relevancies=True, k=None,
                          stochastic=False, n_samples=32, beta=0.1,
                          log_scores=True, max_iter=50, generator=None,
                          gumbel=None):
    """The dense-finetuning ranking loss (rank_loss.py:518-581)."""
    n = y_true.shape[1]
    k = n if k is None else k
    mask = _pad_mask(y_true, padded_value_indicator)
    P_hat = _soft_permutations(y_pred, mask, temperature, stochastic,
                               n_samples, beta, log_scores, max_iter,
                               generator, gumbel)
    S = P_hat.shape[0]
    discounts = _log2_discounts(n, y_pred)
    discounts = torch.where(torch.arange(n, device=y_pred.device) < k,
                            discounts, _f(0.0, discounts))
    # expected discounts under the (transposed) soft permutation
    discounts = torch.einsum("sbji,j->sbi", P_hat, discounts)
    gains = torch.pow(2.0, y_true) - 1 if powered_relevancies else y_true
    discounted_gains = gains[None] * discounts
    idcg = dcg(y_pred=y_true, y_true=y_true, ats=[k])[:, 0]
    ndcg = discounted_gains.sum(dim=2) / (idcg[None] + DEFAULT_EPS)
    return _mean_ndcg(ndcg, idcg, S)


def neuralNDCG(y_pred, y_true, padded_value_indicator=PADDED_Y_VALUE,
               temperature=1.0, powered_relevancies=True, k=None,
               stochastic=False, n_samples=32, beta=0.1, log_scores=True,
               generator=None, gumbel=None):
    """rank_loss.py:455-515."""
    n = y_true.shape[1]
    k = n if k is None else k
    mask = _pad_mask(y_true, padded_value_indicator)
    P_hat = _soft_permutations(y_pred, mask, temperature, stochastic,
                               n_samples, beta, log_scores, 50, generator,
                               gumbel)
    S = P_hat.shape[0]
    P_hat = torch.where(mask[None, :, :, None] | mask[None, :, None, :],
                        _f(0.0, P_hat), P_hat)
    y_m = torch.where(mask, _f(0.0, y_true), y_true)[None, ..., None]
    if powered_relevancies:
        y_m = torch.pow(2.0, y_m) - 1.0
    ground_truth = torch.matmul(P_hat, y_m)[..., 0]
    gains = (ground_truth * _log2_discounts(n, y_pred))[:, :, :k]
    idcg = dcg(y_true, y_true, ats=[k])[:, 0]
    ndcg = gains.sum(dim=-1) / (idcg[None] + DEFAULT_EPS)
    return _mean_ndcg(ndcg, idcg, S)


def listNet(y_pred, y_true, eps=DEFAULT_EPS,
            padded_value_indicator=PADDED_Y_VALUE):
    """rank_loss.py:354-378."""
    mask = _pad_mask(y_true, padded_value_indicator)
    y_pred = torch.where(mask, _f(float("-inf"), y_pred), y_pred)
    y_true = torch.where(mask, _f(float("-inf"), y_true), y_true)
    preds_smax = torch.softmax(y_pred, dim=1) + eps
    true_smax = torch.softmax(y_true, dim=1)
    return (-(true_smax * torch.log(preds_smax)).sum(dim=1)).mean()


def listMLE(y_pred, y_true, eps=DEFAULT_EPS,
            padded_value_indicator=PADDED_Y_VALUE, generator=None):
    """rank_loss.py:196-228. With ``generator`` the list is shuffled
    first, for tie resolution (the reference's torch.randperm)."""
    if generator is not None:
        perm = torch.randperm(y_pred.shape[-1], generator=generator).to(
            y_pred.device)
        y_pred, y_true = y_pred[:, perm], y_true[:, perm]
    order = torch.argsort(-y_true, dim=-1, stable=True)
    y_true_sorted = torch.gather(y_true, 1, order)
    mask = y_true_sorted == padded_value_indicator
    preds = torch.gather(y_pred, 1, order)
    preds = torch.where(mask, _f(float("-inf"), preds), preds)
    pmax = preds.max(dim=1, keepdim=True).values
    p = preds - pmax
    cums = torch.flip(torch.cumsum(torch.flip(
        torch.where(mask, _f(0.0, p), torch.exp(p)), [1]), dim=1), [1])
    obs = torch.log(cums + eps) - p
    obs = torch.where(mask, _f(0.0, obs), obs)
    return obs.mean(dim=1).mean()


def rankNet(y_pred, y_true, padded_value_indicator=PADDED_Y_VALUE,
            weight_by_diff=False, weight_by_diff_powed=False):
    """rank_loss.py:303-352 as a masked mean over ordered pairs."""
    mask = _pad_mask(y_true, padded_value_indicator)
    y_pred = torch.where(mask, _f(float("-inf"), y_pred), y_pred)
    y_true_m = torch.where(mask, _f(float("-inf"), y_true), y_true)
    td = y_true_m[:, :, None] - y_true_m[:, None, :]
    pd = y_pred[:, :, None] - y_pred[:, None, :]
    sel = (td > 0) & torch.isfinite(td)
    weight = None
    if weight_by_diff:
        weight = torch.abs(td)
    elif weight_by_diff_powed:
        tp = torch.pow(y_true_m, 2)
        weight = torch.abs(tp[:, :, None] - tp[:, None, :])
    # BCEWithLogits(pred_diffs, 1): log(1 + exp(-x)), weighted mean over sel
    pd_safe = torch.where(sel, pd, _f(0.0, pd))
    losses = torch.logaddexp(_f(0.0, pd_safe), -pd_safe)
    w = torch.where(sel, weight if weight is not None else _f(1.0, pd),
                    _f(0.0, pd))
    return (losses * w).sum() / torch.clamp(sel.sum(), min=1)


def approxNDCGLoss(y_pred, y_true, eps=DEFAULT_EPS,
                   padded_value_indicator=PADDED_Y_VALUE, alpha=1.0):
    """rank_loss.py:230-283."""
    mask = _pad_mask(y_true, padded_value_indicator)
    y_pred = torch.where(mask, _f(float("-inf"), y_pred), y_pred)
    y_true = torch.where(mask, _f(float("-inf"), y_true), y_true)
    order = torch.argsort(-y_pred, dim=-1, stable=True)
    y_pred_sorted = torch.gather(y_pred, 1, order)
    y_true_sorted = -torch.sort(-y_true, dim=-1).values
    true_by_pred = torch.gather(y_true, 1, order)
    true_diffs = true_by_pred[:, :, None] - true_by_pred[:, None, :]
    n = y_pred.shape[1]
    pairs = torch.isfinite(true_diffs) & ~torch.eye(
        n, dtype=torch.bool, device=y_pred.device)[None]
    true_by_pred = torch.clamp(true_by_pred, min=0.0)
    y_true_sorted = torch.clamp(y_true_sorted, min=0.0)
    D = torch.log2(1.0 + torch.arange(1, n + 1, dtype=torch.float32,
                                      device=y_pred.device))[None, :]
    maxDCG = torch.clamp(((torch.pow(2.0, y_true_sorted) - 1) / D).sum(
        dim=-1), min=eps)
    G = (torch.pow(2.0, true_by_pred) - 1) / maxDCG[:, None]
    sd = y_pred_sorted[:, :, None] - y_pred_sorted[:, None, :]
    sd = torch.where(pairs, sd, _f(0.0, sd))
    approx_pos = 1.0 + (pairs * torch.clamp(torch.sigmoid(-alpha * sd),
                                            min=eps)).sum(dim=-1)
    approx_D = torch.log2(1.0 + approx_pos)
    return -(G / approx_D).sum(dim=-1).mean()


# -- lambdaLoss weighing schemes (rank_loss.py:162-194) ---------------------

def ndcgLoss1_scheme(G, D, *_):
    return (G / D)[:, :, None]


def ndcgLoss2_scheme(G, D, *_):
    n = G.shape[1]
    pos = torch.arange(1, n + 1, device=G.device)
    delta_idxs = torch.abs(pos[:, None] - pos[None, :])
    deltas = torch.abs(torch.pow(torch.abs(D[0, delta_idxs - 1]), -1.0)
                       - torch.pow(torch.abs(D[0, delta_idxs]), -1.0))
    deltas = deltas * (1 - torch.eye(n, device=G.device))
    return deltas[None] * torch.abs(G[:, :, None] - G[:, None, :])


def lambdaRank_scheme(G, D, *_):
    return (torch.abs(torch.pow(D[:, :, None], -1.0)
                      - torch.pow(D[:, None, :], -1.0))
            * torch.abs(G[:, :, None] - G[:, None, :]))


def ndcgLoss2PP_scheme(G, D, mu, true_sorted):
    return mu * ndcgLoss2_scheme(G, D) + lambdaRank_scheme(G, D)


def rankNet_scheme(G, D, *_):
    return 1.0


def rankNetWeightedByGTDiff_scheme(G, D, mu, true_sorted):
    return torch.abs(true_sorted[:, :, None] - true_sorted[:, None, :])


def rankNetWeightedByGTDiffPowed_scheme(G, D, mu, true_sorted):
    return torch.abs(torch.pow(true_sorted[:, :, None], 2)
                     - torch.pow(true_sorted[:, None, :], 2))


_SCHEMES = {
    "ndcgLoss1_scheme": ndcgLoss1_scheme,
    "ndcgLoss2_scheme": ndcgLoss2_scheme,
    "lambdaRank_scheme": lambdaRank_scheme,
    "ndcgLoss2PP_scheme": ndcgLoss2PP_scheme,
    "rankNet_scheme": rankNet_scheme,
    "rankNetWeightedByGTDiff_scheme": rankNetWeightedByGTDiff_scheme,
    "rankNetWeightedByGTDiffPowed_scheme": rankNetWeightedByGTDiffPowed_scheme,
}


def lambdaLoss(y_pred, y_true, eps=DEFAULT_EPS,
               padded_value_indicator=PADDED_Y_VALUE, weighing_scheme=None,
               k=None, sigma=1.0, mu=10.0, reduction="mean",
               reduction_log="binary"):
    """rank_loss.py:379-453. ``weighing_scheme`` is a scheme name (the
    reference dispatches through globals())."""
    n = y_pred.shape[1]
    dev = y_pred.device
    mask = _pad_mask(y_true, padded_value_indicator)
    y_pred = torch.where(mask, _f(float("-inf"), y_pred), y_pred)
    y_true = torch.where(mask, _f(float("-inf"), y_true), y_true)
    order = torch.argsort(-y_pred, dim=-1, stable=True)
    true_by_pred = torch.gather(y_true, 1, order)
    true_sorted = -torch.sort(-y_true, dim=-1).values
    td = true_by_pred[:, :, None] - true_by_pred[:, None, :]
    pairs_mask = torch.isfinite(td)
    if weighing_scheme != "ndcgLoss1_scheme":
        pairs_mask = pairs_mask & (td > 0)
    kk = n if k is None else k
    within = torch.arange(n, device=dev) < kk
    ndcg_at_k = (within[:, None] & within[None, :])[None]
    true_by_pred = torch.clamp(true_by_pred, min=0.0)
    true_sorted_c = torch.clamp(true_sorted, min=0.0)
    D = torch.log2(1.0 + torch.arange(1, n + 1, dtype=torch.float32,
                                      device=dev))[None, :]
    maxDCG = torch.clamp(
        ((torch.pow(2.0, true_sorted_c) - 1) / D)[:, :kk].sum(dim=-1),
        min=eps)
    G = (torch.pow(2.0, true_by_pred) - 1) / maxDCG[:, None]
    preds_sorted = torch.gather(y_pred, 1, order)
    sd = torch.clamp(preds_sorted[:, :, None] - preds_sorted[:, None, :],
                     min=-1e8, max=1e8)
    sd = torch.where(torch.isnan(sd) | ~torch.isfinite(sd), _f(0.0, sd), sd)
    if weighing_scheme is None:
        weights = 1.0
    else:
        weights = _SCHEMES[weighing_scheme](G, D, mu, true_sorted_c)
    probas = torch.clamp(torch.pow(torch.clamp(torch.sigmoid(sigma * sd),
                                               min=eps), weights), min=eps)
    log_fn = torch.log2 if reduction_log == "binary" else torch.log
    losses = log_fn(probas)
    sel = pairs_mask & ndcg_at_k
    total = torch.where(sel, losses, _f(0.0, losses)).sum()
    if reduction == "sum":
        return -total
    return -total / torch.clamp(sel.sum(), min=1)
