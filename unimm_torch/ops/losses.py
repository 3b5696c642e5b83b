"""Eval losses: the chunked online-softmax cross-entropy over the tied
decoder.

``online_softmax_xent`` is the port of the JAX package's
``ops/losses.online_softmax_xent`` (a vocab-chunk scan with a running max,
exp-sum and true-label logit) and the plain version of the label-head
kernel (ops/xent_head.py). Only one [M, chunk] fp32 logits tile exists at a
time; the reference materialises [N, 256, 30522] logits on every eval
forward.
"""

from __future__ import annotations

import torch


def online_softmax_xent(hidden, decoder_weight, decoder_bias, labels,
                        chunk: int = 7680):
    """NLL of ``labels`` under softmax(hidden @ decoder_weight.T + bias).

    hidden [..., H], decoder_weight [V, H], decoder_bias [V], labels [...]
    int (-1 = ignore). Products accumulate in fp32 whatever the input
    dtype. Returns fp32 [...], zero at ignored positions. The vocab tail of
    the last chunk needs no padding: the JAX scan pads it with -1e30 bias
    columns, which add exp(-1e30 - max) = 0.
    """
    V, H = decoder_weight.shape
    shape = labels.shape
    h = hidden.reshape(-1, H).float()
    lab = labels.reshape(-1).long()
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
    lse = run_max + torch.log(run_sum)
    nll = torch.where(lab == -1, torch.zeros_like(lse), lse - true_logit)
    return nll.reshape(shape)
