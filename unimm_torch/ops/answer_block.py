"""Fused answer-rows attention block of the prefix-cache scorer.

``answer_block`` replaces the TPU kernel
``unimm_tpu/ops/pallas_prefix.py:fused_answer_block``: one BERT attention
sub-block (QKV projection of the answer rows, scores against the cached
context K/V followed by the row block's own K/V, additive biases, fp32
softmax, PV, head merge, output projection, residual, LayerNorm). On a CUDA
tensor it launches the hand-written kernel in ``csrc/answer_block.cu``
(three launches: Q/K/V projection, attention per (query tile, head,
slate), output projection + LayerNorm); on a CPU tensor it runs
``answer_block_plain``, which repeats the kernel's arithmetic and rounding
points in plain PyTorch.

The attention masks arrive as two layer-independent additive fp32 biases:

* ``b_ctx`` [G, 1, Lcb]: context columns open on [1, lc);
* ``b_rr`` [G, PB, RB, RB]: the block-diagonal row->row bias (an option's
  rows attend only its own rows; first copy causal, masked copy strictly
  before i - A, self always open).
"""

from __future__ import annotations

import math

import torch

from unimm_torch.ops import _build
from unimm_torch.ops.masks import NEG_INF

HID = 768        # the width the CUDA kernel is built for
HEAD_DIM = 64


def pick_o_blk(O: int, W: int, target: int = 256) -> int:
    """Options per row block in the W-padded layout: the largest divisor of
    O with O_blk * W <= ``target`` rows."""
    best = 1
    for d in range(1, O + 1):
        if O % d == 0 and d * W <= target:
            best = d
    return best


def block_rr_bias(rr_open, o_blk: int):
    """[G, O, W, W] per-option row->row openness -> the blocked additive bias
    [G, O // o_blk, o_blk * W, o_blk * W] with NEG_INF between different
    options' rows."""
    G, O, W, _ = rr_open.shape
    OB = O // o_blk
    rr = rr_open.reshape(G, OB, o_blk, W, 1, W)
    same = torch.eye(o_blk, dtype=torch.bool,
                     device=rr_open.device)[None, None, :, None, :, None]
    open_blk = (same & rr).expand(G, OB, o_blk, W, o_blk, W)
    bias = torch.where(open_blk, 0.0, NEG_INF).float()
    return bias.reshape(G, OB, o_blk * W, o_blk * W)


def _weights(p_attn):
    ps, po = p_attn.self, p_attn.output
    return (ps.query.weight, ps.query.bias, ps.key.weight, ps.key.bias,
            ps.value.weight, ps.value.bias, po.dense.weight, po.dense.bias,
            po.LayerNorm.weight, po.LayerNorm.bias)


def answer_block_plain(x, kc, vc, b_ctx, b_rr, p_attn, *, num_heads,
                       eps=1e-12):
    """Plain PyTorch version of the kernel, with its rounding points:
    projections accumulate in fp32 and round to x.dtype after the bias; q
    is scaled in fp32 and rounded; scores and softmax are fp32; the
    probabilities and each head's context round to x.dtype; the output
    projection, bias, residual and LayerNorm run in fp32."""
    wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta = _weights(p_attn)
    dt = x.dtype
    G, P, Hd = x.shape
    _, PB, RB, _ = b_rr.shape
    K = kc.shape[1]
    D = Hd // num_heads
    xf = x.float()

    def proj(w, b):
        return (xf @ w.float().t() + b.float()).to(dt)

    q = (proj(wq, bq).float() * (1.0 / math.sqrt(D))).to(dt)
    kr, vr = proj(wk, bk), proj(wv, bv)

    def blocks(t):       # [G, P, Hd] -> [G, PB, H, RB, D] fp32
        return t.reshape(G, PB, RB, num_heads, D).permute(
            0, 1, 3, 2, 4).float()

    def heads(t):        # [G, K, Hd] -> [G, H, K, D] fp32
        return t.reshape(G, K, num_heads, D).permute(0, 2, 1, 3).float()

    qb = blocks(q)
    s_ctx = torch.einsum("gbhrd,ghkd->gbhrk", qb, heads(kc)) \
        + b_ctx.float()[:, :, None, None, :]
    s_rr = torch.einsum("gbhrd,gbhsd->gbhrs", qb, blocks(kr)) \
        + b_rr.float()[:, :, None]
    pr = torch.softmax(torch.cat([s_ctx, s_rr], -1), dim=-1).to(dt).float()
    ctx = (torch.einsum("gbhrk,ghkd->gbhrd", pr[..., :K], heads(vc))
           + torch.einsum("gbhrs,gbhsd->gbhrd", pr[..., K:], blocks(vr)))
    ctx = ctx.to(dt).permute(0, 1, 3, 2, 4).reshape(G, P, Hd)
    h32 = (ctx.float() @ wo.float().t() + bo.float()) + xf
    mean = h32.mean(-1, keepdim=True)
    var = (h32 - mean).square().mean(-1, keepdim=True)
    y = (h32 - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(dt)


def _require(cond, msg):
    if not cond:
        raise ValueError(f"answer_block: {msg}")


def answer_block(x, kc, vc, b_ctx, b_rr, p_attn, *, num_heads, eps=1e-12):
    """LayerNorm(x + Wo . attention(rows x, keys [kc ; row K], values
    [vc ; row V]) + bo) for packed answer rows.

    x [G, P, 768]; kc, vc [G, Lcb, 768] (the cached context projected by
    the layer's key/value Linear); b_ctx [G, 1, Lcb] fp32; b_rr [G, PB, RB,
    RB] fp32 with PB * RB == P; p_attn the layer's ``attention`` module in
    the compute dtype. A CPU tensor runs ``answer_block_plain``; a CUDA
    tensor launches the kernel (bf16 activations and weights) or raises.
    """
    if x.device.type == "cpu":
        return answer_block_plain(x, kc, vc, b_ctx, b_rr, p_attn,
                                  num_heads=num_heads, eps=eps)
    weights = _weights(p_attn)
    G, P, Hd = x.shape
    _require(Hd == HID and Hd // num_heads == HEAD_DIM,
             f"kernel is built for width {HID} in heads of {HEAD_DIM}, got "
             f"{Hd} / {num_heads}")
    _require(b_rr.dim() == 4 and b_rr.shape[0] == G
             and b_rr.shape[2] == b_rr.shape[3], f"b_rr {tuple(b_rr.shape)}")
    PB, RB = b_rr.shape[1], b_rr.shape[2]
    Lcb = kc.shape[1]
    _require(PB * RB == P and RB % 32 == 0
             and (RB <= 128 or RB % 128 == 0),
             f"P={P} must be PB*RB with RB a multiple of 32, and of 128 "
             f"above 128 (RB={RB})")
    _require(Lcb % 16 == 0 and 64 <= Lcb + RB <= 1024,
             f"Lcb={Lcb} must be a multiple of 16 with 64 <= Lcb+RB <= 1024")
    _require(tuple(kc.shape) == (G, Lcb, HID)
             and tuple(vc.shape) == (G, Lcb, HID), "kc/vc shape")
    _require(tuple(b_ctx.shape) == (G, 1, Lcb), "b_ctx shape")
    shapes = [(HID, HID), (HID,)] * 4 + [(HID,), (HID,)]
    for t, shp in zip(weights, shapes):
        _require(tuple(t.shape) == shp, f"weight shape {tuple(t.shape)}")
    for t in (x, kc, vc) + weights:
        _require(t.dtype == torch.bfloat16,
                 f"activations and weights must be bfloat16, got {t.dtype}")
    for t in (b_ctx, b_rr):
        _require(t.dtype == torch.float32,
                 f"b_ctx / b_rr must be float32, got {t.dtype}")
    for t in (x, kc, vc, b_ctx, b_rr) + weights:
        _require(t.device == x.device, "all tensors on one device")
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 "inputs must be contiguous and 16-byte aligned")
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    lib = _build.library()
    q, k, v, ctx, out = (torch.empty_like(x) for _ in range(5))
    code = lib.unimm_answer_block(
        x.data_ptr(), kc.data_ptr(), vc.data_ptr(), b_ctx.data_ptr(),
        b_rr.data_ptr(), *(t.data_ptr() for t in weights), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), ctx.data_ptr(), out.data_ptr(), G, P,
        Lcb, RB, eps, _build.stream(x.device))
    _build.check(code, "answer_block")
    answer_block.launches += 1
    return out


answer_block.launches = 0
