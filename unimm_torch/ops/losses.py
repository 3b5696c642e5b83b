"""Losses: the chunked online-softmax cross-entropy over the tied decoder
(eval and training) and the training losses.

``online_softmax_xent`` is the port of the JAX package's
``ops/losses.online_softmax_xent`` (a vocab-chunk scan with a running max,
exp-sum and true-label logit) and the plain version of the label-head
kernel (ops/xent_head.py). Only one [M, chunk] fp32 logits tile exists at a
time; the reference materialises [N, 256, 30522] logits on every eval
forward. ``online_softmax_xent_vjp`` is its differentiable form, whose
backward recomputes each vocab chunk; on CUDA bf16 rows of width 768 both
passes launch the Hopper kernels of ops/xent_train.py instead.

The training losses port ``unimm_tpu/ops/losses.py`` with the reference's
semantics (vilbert_dialog.py:1559-1624): the MLM likelihood +
unlikelihood loss (dense and at gathered label positions), the
class-weighted NSP cross-entropy, the masked-region KL and MSE image
losses, and their weighted sum.
"""

from __future__ import annotations

import torch

from unimm_torch.ops import xent_train
from unimm_torch.utils import trace


CLAMP_MIN = 1e-6  # vilbert_dialog.py:1558


def online_softmax_xent(hidden, decoder_weight, decoder_bias, labels,
                        chunk: int = 7680):
    """NLL of ``labels`` under softmax(hidden @ decoder_weight.T + bias).

    hidden [..., H], decoder_weight [V, H], decoder_bias [V], labels [...]
    int (-1 = ignore). Products accumulate in fp32 whatever the input
    dtype. Returns fp32 [...], zero at ignored positions. The vocab tail of
    the last chunk needs no padding: the JAX scan pads it with -1e30 bias
    columns, which add exp(-1e30 - max) = 0.
    """
    H = decoder_weight.shape[1]
    lab = labels.reshape(-1).long()
    lse, t = _xent_stats(hidden.reshape(-1, H).float(), decoder_weight,
                         decoder_bias, lab, chunk)
    return _nll(lse, t, lab).reshape(labels.shape)


def _nll(lse, true_logit, lab):
    return torch.where(lab == -1, torch.zeros_like(lse), lse - true_logit)


def _xent_stats(h, decoder_weight, decoder_bias, lab, chunk):
    """(lse [M], true-label logit [M]) of fp32 rows ``h`` by the chunked
    scan: a running max, exp-sum and true-label logit."""
    V = decoder_weight.shape[0]
    M = h.shape[0]
    run_max = torch.full((M,), float("-inf"), device=h.device)
    run_sum = torch.zeros(M, device=h.device)
    true_logit = torch.zeros(M, device=h.device)
    for c0 in range(0, V, chunk):
        w = decoder_weight[c0:c0 + chunk].float()
        logits = h @ w.t() + decoder_bias[c0:c0 + chunk].float()
        new_max = torch.maximum(run_max, logits.max(-1).values)
        run_sum = (run_sum * torch.exp(run_max - new_max)
                   + torch.exp(logits - new_max[:, None]).sum(-1))
        run_max = new_max
        local = lab - c0
        in_chunk = (local >= 0) & (local < w.shape[0])
        picked = torch.gather(logits, 1,
                              local.clamp(0, w.shape[0] - 1)[:, None])[:, 0]
        true_logit = torch.where(in_chunk, picked, true_logit)
    return run_max + torch.log(run_sum), true_logit


def _xent_grads(hidden, decoder_weight, decoder_bias, lab, lse, gf, chunk):
    """(dhidden, ddecoder, dbias) fp32 of sum(gf * nll) by the chunked
    scan: each vocab chunk's logits again, dlogits = gf (softmax - onehot)
    rounded to the hidden dtype for both products (fp32 accumulation),
    dbias from the unrounded dlogits."""
    V, H = decoder_weight.shape
    h = hidden.reshape(-1, H)
    M = h.shape[0]
    hf = h.float()
    rows = torch.arange(M, device=h.device)
    dh = torch.zeros(M, H, dtype=torch.float32, device=h.device)
    dw = torch.empty(V, H, dtype=torch.float32, device=h.device)
    db = torch.empty(V, dtype=torch.float32, device=h.device)
    for c0 in range(0, V, chunk):
        # the chunk in the hidden dtype, products in fp32 (the JAX
        # backward's preferred_element_type=float32)
        w_c = decoder_weight[c0:c0 + chunk].to(hidden.dtype).float()
        logits = hf @ w_c.t() + decoder_bias[c0:c0 + chunk].float()
        dlogits = torch.exp(logits - lse[:, None])
        local = lab - c0
        in_chunk = (local >= 0) & (local < w_c.shape[0])
        col = local.clamp(0, w_c.shape[0] - 1)
        dlogits[rows, col] -= in_chunk.float()
        dlogits = dlogits * gf[:, None]
        dl = dlogits.to(hidden.dtype).float()
        dh += dl @ w_c
        dw[c0:c0 + chunk] = dl.t() @ hf
        db[c0:c0 + chunk] = dlogits.sum(0)
    return dh, dw, db


class _OnlineXent(torch.autograd.Function):
    """The JAX package's ``online_softmax_xent_vjp``: the forward keeps
    only the [M] log-sum-exp; the backward recomputes the logits and takes
    dhidden, ddecoder and dbias, so the [M, V] fp32 logits exist in neither
    pass. CUDA tensors with bf16 hidden rows of width 768
    (``xent_train.takes``) launch the Hopper kernels of
    ``ops/xent_train.py``; anything else runs the chunked scan
    (``_xent_stats``, ``_xent_grads``), their plain version."""

    @staticmethod
    def forward(ctx, hidden, decoder_weight, decoder_bias, labels, chunk):
        H = decoder_weight.shape[1]
        lab = labels.reshape(-1).long()
        ctx.kernels = xent_train.takes(hidden)
        if ctx.kernels:
            nll, lse = xent_train.xent_train_fwd(
                *_kernel_operands(hidden, decoder_weight, decoder_bias, lab))
        else:
            lse, t = _xent_stats(hidden.reshape(-1, H).float(),
                                 decoder_weight, decoder_bias, lab, chunk)
            nll = _nll(lse, t, lab)
        ctx.save_for_backward(hidden, decoder_weight, decoder_bias, lab, lse)
        ctx.chunk = chunk
        return nll.reshape(labels.shape)

    @staticmethod
    def backward(ctx, g):
        with trace.span("train.mlm_xent.bwd"):
            return _OnlineXent._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        hidden, decoder_weight, decoder_bias, lab, lse = ctx.saved_tensors
        gf = g.reshape(-1).float() * (lab != -1).float()
        if ctx.kernels:
            dh, dw, db = xent_train.xent_train_bwd(
                *_kernel_operands(hidden, decoder_weight, decoder_bias, lab),
                lse, gf)
        else:
            dh, dw, db = _xent_grads(hidden, decoder_weight, decoder_bias,
                                     lab, lse, gf, ctx.chunk)
        return (dh.reshape(hidden.shape).to(hidden.dtype),
                dw.to(decoder_weight.dtype), db.to(decoder_bias.dtype), None,
                None)


def _kernel_operands(hidden, decoder_weight, decoder_bias, lab):
    """The kernels' hidden [M, 768], bf16 decoder, fp32 bias and int32
    labels (copies only where a dtype or layout differs)."""
    return (hidden.reshape(-1, hidden.shape[-1]).contiguous(),
            decoder_weight.to(hidden.dtype).contiguous(),
            decoder_bias.float().contiguous(), lab.to(torch.int32))


def online_softmax_xent_vjp(hidden, decoder_weight, decoder_bias, labels,
                            chunk: int = 7680):
    """``online_softmax_xent`` with the memory-lean chunk-recomputing
    backward (gradients of hidden, decoder_weight and decoder_bias)."""
    return _OnlineXent.apply(hidden, decoder_weight, decoder_bias, labels,
                             chunk)


def masked_lm_ul_loss(mlm_logits, labels, lm_weight, num_tokens=None):
    """MLM likelihood + unlikelihood loss over dense logits [N, L, V]:
    (sum w nll [w > 0] + sum -log(clamp(1 - p, 1e-6)) [w == -1]) /
    count(w != 0); labels -1 are ignored. ``num_tokens`` overrides the
    denominator (length-bucketed morsels pass the group count / k)."""
    log_probs = torch.log_softmax(mlm_logits.float(), dim=-1)
    tok_logp = torch.gather(log_probs, -1,
                            labels.long().clamp(min=0)[..., None])[..., 0]
    valid = labels != -1
    w = lm_weight.float()
    l_mask = (w > 0) & valid
    ul_mask = (w == -1) & valid
    zero = torch.zeros_like(tok_logp)
    l_sum = torch.where(l_mask, -tok_logp * w, zero).sum()
    # -log(clamp(1 - p, 1e-6)), the reference clamp formulation
    p = torch.exp(tok_logp)
    ul_nll = -torch.log(torch.clamp(1.0 - p, min=CLAMP_MIN))
    ul_sum = torch.where(ul_mask, ul_nll, zero).sum()
    if num_tokens is None:
        num_tokens = (w != 0).float().sum()
    return (l_sum + ul_sum) / torch.clamp(torch.as_tensor(
        num_tokens, dtype=torch.float32, device=w.device), min=1.0)


def masked_lm_ul_loss_gathered(nll, labels, weights, num_tokens=None):
    """``masked_lm_ul_loss`` from the NLL at gathered label positions (pairs
    with ``online_softmax_xent_vjp``): p = exp(-nll), so autograd chains the
    unlikelihood gradient through the xent's backward. Pass
    ``num_tokens`` = count(full lm_weight != 0) for the dense form's
    denominator."""
    nll = nll.float()
    valid = labels != -1
    w = weights.float()
    l_mask = (w > 0) & valid
    ul_mask = (w == -1) & valid
    zero = torch.zeros_like(nll)
    l_sum = torch.where(l_mask, nll * w, zero).sum()
    p = torch.exp(-nll)
    ul_term = -torch.log(torch.clamp(1.0 - p, min=CLAMP_MIN))
    ul_sum = torch.where(ul_mask, ul_term, zero).sum()
    if num_tokens is None:
        num_tokens = ((w != 0) & valid).float().sum()
    return (l_sum + ul_sum) / torch.clamp(torch.as_tensor(
        num_tokens, dtype=torch.float32, device=w.device), min=1.0)


def nsp_loss(nsp_logits, labels, nsp_weight=None, norm_counts=None):
    """Class-weighted NSP cross-entropy (F.cross_entropy(weight=w)
    semantics, w normalised by its first entry); ``norm_counts`` [2]
    overrides the per-class row counts of the denominator."""
    logits = nsp_logits.float()
    dev = logits.device
    if nsp_weight is None:
        w = torch.ones(2, device=dev)
    else:
        w = torch.as_tensor(nsp_weight, dtype=torch.float32,
                            device=dev).reshape(-1)[:2]
        w = w / w[0]
    labels = labels.long()
    nll = -torch.gather(torch.log_softmax(logits, -1), -1,
                        labels[..., None])[..., 0]
    sample_w = w[labels]
    if norm_counts is not None:
        den = (torch.as_tensor(norm_counts, dtype=torch.float32,
                               device=dev) * w).sum()
    else:
        den = sample_w.sum()
    return (nll * sample_w).sum() / torch.clamp(den, min=1e-12)


def masked_img_loss(img_logits, image_target, image_label, norm=None):
    """Masked-region KL loss: KLDiv(log_softmax(logits), target) summed
    over regions with image_label == 1, divided by their count (or
    ``norm``)."""
    log_probs = torch.log_softmax(img_logits.float(), -1)
    target = image_target.float()
    kld = torch.where(target > 0, target * (torch.log(
        torch.clamp(target, min=1e-30)) - log_probs),
        torch.zeros_like(log_probs))
    sel = (image_label == 1).float()
    num = (kld * sel[..., None]).sum()
    den = sel.sum() if norm is None else torch.as_tensor(
        norm, dtype=torch.float32, device=sel.device)
    return num / torch.clamp(den, min=1.0)


def masked_img_loss_mse(img_logits, image_target, image_label, norm=None):
    """predict_feature image loss: squared error over the selected
    regions' elements, divided by their element count (``norm`` regions
    times the feature width)."""
    pred = img_logits.float()
    mse = (pred - image_target.float()).square()
    sel = (image_label == 1).float()[..., None]
    num = (mse * sel).sum()
    if norm is None:
        den = (sel * torch.ones_like(mse)).sum()
    else:
        den = torch.as_tensor(norm, dtype=torch.float32,
                              device=pred.device) * pred.shape[-1]
    return num / torch.clamp(den, min=1.0)


def combine_losses(lm, img, nsp, lm_coeff=1.0, nsp_coeff=1.0, img_coeff=1.0):
    """The training objective (reference train.py:167-168)."""
    return lm_coeff * lm + nsp_coeff * nsp + img_coeff * img
