"""Focal and gradient-harmonizing losses (the reference's utils/losses.py
semantics), in plain PyTorch and differentiable through autograd.

The port of the JAX package's ``ops/focal_losses.py``. In the reference
these are imported by the model with every call site commented out; the
dense finetuning script computes ``qfocal_loss`` and a KLDiv ``ce_loss``
for logging only (dense_annotation_finetuning.py:275-280). The GHM losses'
EMA bin counts are explicit: pass and return ``last_bin_count`` (a [bins]
tensor).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-20


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def binary_ce_focal_loss(predict, target, gamma=2.0, alpha=0.25,
                         reduction="mean", eps=EPS):
    """losses.py:25-34."""
    pt = torch.sigmoid(predict)
    loss = (-alpha * torch.clamp(1 - pt, min=eps) ** gamma * target
            * torch.log(torch.clamp(pt, min=eps))
            - (1 - alpha) * torch.clamp(pt, min=eps) ** gamma * (1 - target)
            * torch.log(torch.clamp(1 - pt, min=eps)))
    return _reduce(loss, reduction)


def multi_ce_focal_loss(predict, target, class_num=2, gamma=2.0, alpha=None,
                        reduction="mean", eps=EPS):
    """losses.py:63-78."""
    pt = torch.softmax(predict, dim=1)
    onehot = F.one_hot(target.long(), class_num).to(pt.dtype)
    if alpha is None:
        alpha = torch.ones(class_num, dtype=pt.dtype, device=pt.device)
    a = torch.as_tensor(alpha, dtype=pt.dtype,
                        device=pt.device).reshape(-1)[target.long()]
    probs = (pt * onehot).sum(1)
    log_p = torch.log(torch.clamp(probs, min=eps))
    loss = -a * torch.pow(1 - probs, gamma) * log_p
    return _reduce(loss, reduction)


def _ghm_weights(g, n_elems, bins, alpha, last_bin_count):
    bin_idx = torch.floor(g * (bins - 0.0001)).to(torch.int64)
    bin_count = torch.zeros(bins, dtype=torch.float32, device=g.device)
    bin_count = bin_count.index_add(
        0, bin_idx.reshape(-1),
        torch.ones(bin_idx.numel(), dtype=torch.float32, device=g.device))
    if last_bin_count is not None:
        bin_count = alpha * last_bin_count + (1 - alpha) * bin_count
    nonempty = (bin_count > 0).float().sum()
    gd = torch.clamp(bin_count * nonempty, min=0.0001)
    beta = n_elems / gd
    return beta[bin_idx], bin_count


def ghmc_loss(x, target, bins=10, alpha=0.75, last_bin_count=None):
    """Gradient-harmonized BCE (losses.py:83-106, 151-160). Returns (loss,
    new_bin_count)."""
    g = torch.abs(torch.sigmoid(x) - target).detach()
    n = x.shape[0] * x.shape[1]
    w, bin_count = _ghm_weights(g, n, bins, alpha, last_bin_count)
    per = (torch.clamp(x, min=0) - x * target
           + torch.log1p(torch.exp(-torch.abs(x))))
    return (per * w).mean(), bin_count


def ghmr_loss(x, target, mu=0.02, bins=10, alpha=0.75, last_bin_count=None):
    """Gradient-harmonized regression loss (losses.py:163-178). Returns
    (loss, new_bin_count)."""
    d = x - target
    g = torch.abs(d / torch.sqrt(d * d + mu * mu)).detach()
    n = x.shape[0] * x.shape[1]
    w, bin_count = _ghm_weights(g, n, bins, alpha, last_bin_count)
    loss = torch.sqrt(d * d + mu * mu) - mu
    return (loss * w).sum() / n, bin_count


# -- dense-finetuning logging quantities ------------------------------------

def dense_qfocal_log(nsp_logits, gt_relevance):
    """dense_annotation_finetuning.py:278-280: the quality-focal logging
    value. nsp_logits [B, O, 2]; gt_relevance [B, O]."""
    probs = torch.softmax(nsp_logits, dim=-1)
    log_probs = torch.log_softmax(nsp_logits, dim=-1)
    p0, lp0, lp1 = probs[..., 0], log_probs[..., 0], log_probs[..., 1]
    return -(torch.abs(gt_relevance - p0) ** 2.0
             * (gt_relevance * lp0 + (1 - gt_relevance) * lp1)).mean()


def dense_ce_log(nsp_logits, gt_relevance):
    """dense_annotation_finetuning.py:275: KLDiv(batchmean) between the
    slate-softmaxed NSP probabilities and the softmaxed relevance."""
    p0 = torch.softmax(nsp_logits, dim=-1)[..., 0]
    log_pred = torch.log_softmax(p0, dim=1)
    true = torch.softmax(gt_relevance, dim=1)
    kld = torch.where(true > 0,
                      true * (torch.log(torch.clamp(true, min=1e-30))
                              - log_pred),
                      torch.zeros_like(true))
    return kld.sum() / nsp_logits.shape[0]
