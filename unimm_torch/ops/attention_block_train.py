"""Differentiable whole-sequence BERT attention sub-block of the training
step, with attention-probability dropout made in the kernel.

``attention_block_train`` replaces the TPU kernel
``unimm_tpu/ops/pallas_attention_v2.py:fused_attention_block_train`` (a
``jax.custom_vjp`` over a forward and a backward Pallas kernel) with a
``torch.autograd.Function`` over two hand-written kernels in
``csrc/attention_block_train.cu``, following the JAX decomposition:

* forward (``attention_block_train_fwd``): x -> (y, ctx). QKV projection,
  the descriptor text mask, fp32 softmax, the Philox probability mask
  (ops/philox.py), PV, then (ctx Wo^T + bo) * m_o + x and the LayerNorm.
  The attention is B4's one-pass kernel (``csrc/seq_attn_fwd.cuh``) with
  the dropout drawn inside its loop: the row sum it divides by is that of
  the undropped probabilities, as in the twin, which drops after the
  softmax. The merged context ctx is saved, so the backward's LN / Wo side
  needs no attention recompute.
* backward, LN / Wo side: plain PyTorch, as ``_fabt_bwd`` does it in plain
  XLA: recompute the LayerNorm input from ctx, take the LN backward, then
  dctx, dWo, dbo, dgamma, dbeta.
* backward kernel (``attention_block_train_bwd``): (x, dctx) -> (dx_qkv,
  dq, dk, dv). It recomputes q/k/v and the softmax with the same Philox
  mask, backpropagates through them (``csrc/seq_attn_bwd.cuh``, shared
  with the per-head text attention: a dq launch and a dk / dv launch on
  64-row tiles), and takes dx_qkv = dq Wq + dk Wk + dv Wv in one GEMM.
* tail: dWq / dWk / dWv and the bias sums, plain PyTorch.

The kernels' products (Q/K/V, the output projection with its bias, mask
and residual summed in fp32 before the LayerNorm, and the backward's Q/K/V
recompute and dx_qkv) run on the wgmma + TMA GEMM core of
``csrc/gemm_wg.cuh``, as the answer block's.

On CUDA tensors the wrappers launch the kernels (bf16, width 768 in heads
of 64, 32 <= L <= 256 with L % 32 == 0) or raise; on CPU tensors they run
the plain twins below, which round at the kernels' points: projections
round to x.dtype after the bias, q after its 1/8 scale, the (dropped)
probabilities, P, Pd and dS where they enter a product, each head's
context, dq / dk / dv and dx_qkv; every product accumulates in fp32. The
forward kernel rounds each dropped probability before the softmax's
division, the twin after it: one rounding of each term either way.
"""

from __future__ import annotations

import math

import torch

from unimm_torch.ops import _build, philox
from unimm_torch.ops.answer_block import _weights
from unimm_torch.ops.attention_block import (BLOCK_PRODUCTS, HID,
                                             check_inputs)
from unimm_torch.ops.masks import mask_bias
from unimm_torch.utils import trace


def _heads(t, num_heads):          # [B, L, Hd] -> [B, H, L, D] fp32
    B, L, Hd = t.shape
    return t.reshape(B, L, num_heads, Hd // num_heads).permute(
        0, 2, 1, 3).float()


def _merge(t, dt):                 # [B, H, L, D] -> [B, L, Hd] in dt
    B, H, L, D = t.shape
    return t.to(dt).permute(0, 2, 1, 3).reshape(B, L, H * D)


def _probs(x, desc, seed, wq, bq, wk, bk, wv, bv, num_heads, attn_drop):
    """(q_s, k, v, p, mask) of the plain twins: projections in x.dtype,
    the fp32 softmax p [B, H, L, L] and the fp32 dropout scale mask (None
    without attention dropout)."""
    dt = x.dtype
    B, L, Hd = x.shape
    xf = x.float()

    def proj(w, b):
        return (xf @ w.float().t() + b.float()).to(dt)

    q = (proj(wq, bq).float() * (1.0 / math.sqrt(Hd // num_heads))).to(dt)
    k, v = proj(wk, bk), proj(wv, bv)
    s = (_heads(q, num_heads) @ _heads(k, num_heads).transpose(-1, -2)
         + mask_bias(desc, L).to(x.device)[:, None])
    p = torch.softmax(s, dim=-1)
    mask = None
    if attn_drop > 0:
        tags = (torch.arange(B, device=x.device)[:, None] * num_heads
                + torch.arange(num_heads, device=x.device)[None, :])
        mask = philox.prob_mask(seed, tags, L, attn_drop)
    return q, k, v, p, mask


def attention_block_train_fwd_plain(x, desc, seed, m_o, wq, bq, wk, bk, wv,
                                    bv, wo, bo, gamma, beta, *, num_heads,
                                    attn_drop, eps=1e-12):
    """Plain twin of the forward kernel: (y, ctx). Written in
    differentiable PyTorch operations, so autograd through it is the
    reference for the backward."""
    dt = x.dtype
    _, k, v, p, mask = _probs(x, desc, seed, wq, bq, wk, bk, wv, bv,
                              num_heads, attn_drop)
    if mask is not None:
        p = p * mask
    ctx = _merge(p.to(dt).float() @ _heads(v, num_heads), dt)
    out = ctx.float() @ wo.float().t() + bo.float()
    if m_o is not None:
        out = out * m_o.float()
    h32 = out + x.float()
    mean = h32.mean(-1, keepdim=True)
    var = (h32 - mean).square().mean(-1, keepdim=True)
    y = (h32 - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(dt), ctx


def attention_block_train_bwd_plain(x, dctx, desc, seed, wq, bq, wk, bk, wv,
                                    bv, *, num_heads, attn_drop):
    """Plain twin of the backward kernel: (dx_qkv, dq, dk, dv), each
    [B, L, Hd] in x.dtype; dq, dk, dv are the gradients of the projections'
    outputs (q before its scale)."""
    dt = x.dtype
    q, k, v, p, mask = _probs(x, desc, seed, wq, bq, wk, bk, wv, bv,
                              num_heads, attn_drop)
    D = x.shape[-1] // num_heads
    pd = p * mask if mask is not None else p
    do = _heads(dctx, num_heads)
    dpd = do @ _heads(v, num_heads).transpose(-1, -2)
    dv = pd.to(dt).float().transpose(-1, -2) @ do
    dp = dpd * mask if mask is not None else dpd
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = ds.to(dt).float()
    dq = (ds @ _heads(k, num_heads)) * (1.0 / math.sqrt(D))
    dk = ds.transpose(-1, -2) @ _heads(q, num_heads)
    dq, dk, dv = (_merge(t, dt) for t in (dq, dk, dv))
    dx = (dq.float() @ wq.float() + dk.float() @ wk.float()
          + dv.float() @ wv.float()).to(dt)
    return dx, dq, dk, dv


# the backward's products: the Q/K/V recompute, then dx_qkv from
# [dq | dk | dv] (K 2304)
BWD_PRODUCTS = ((HID, HID), (HID, 3 * HID))


def _require(cond, msg):
    if not cond:
        raise ValueError(f"attention_block_train: {msg}")


def _drop_args(seed, attn_drop):
    keep = 1.0 - attn_drop
    return (int(seed) & 0xFFFFFFFF, philox.keep_threshold(attn_drop),
            1.0 / keep, int(attn_drop > 0))


def attention_block_train_fwd(x, desc, seed, m_o, wq, bq, wk, bk, wv, bv,
                              wo, bo, gamma, beta, *, num_heads, attn_drop,
                              eps=1e-12):
    """The forward: (y, ctx). ``seed`` is a host int; ``m_o`` the fp32
    hidden-dropout scale mask [B, L, Hd] or None."""
    weights = (wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta)
    if x.device.type == "cpu":
        return attention_block_train_fwd_plain(
            x, desc, seed, m_o, *weights, num_heads=num_heads,
            attn_drop=attn_drop, eps=eps)
    check_inputs("attention_block_train", x, desc, weights, num_heads,
                 products=BLOCK_PRODUCTS)
    if m_o is not None:
        _require(m_o.dtype == torch.float32 and m_o.shape == x.shape
                 and m_o.device == x.device and m_o.is_contiguous(),
                 "m_o must be a contiguous float32 tensor shaped like x")
    with trace.span("op.attention_block_train_fwd"):
        B, L, _ = x.shape
        lib = _build.library()
        q, k, v, ctx, out = (torch.empty_like(x) for _ in range(5))
        # the output projection's (bias, mask, residual) sum, fp32, for the
        # LayerNorm
        pre = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        code = lib.unimm_attention_block_train_fwd(
            x.data_ptr(), desc.data_ptr(), *(t.data_ptr() for t in weights),
            None if m_o is None else m_o.data_ptr(), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), ctx.data_ptr(), pre.data_ptr(),
            out.data_ptr(), B, L, eps, *_drop_args(seed, attn_drop),
            _build.stream(x.device))
        _build.check(code, "attention_block_train_fwd")
        attention_block_train_fwd.launches += 1
    return out, ctx


def attention_block_train_bwd(x, dctx, desc, seed, wq, bq, wk, bk, wv, bv, *,
                              num_heads, attn_drop):
    """The backward kernel: (dx_qkv, dq, dk, dv)."""
    weights = (wq, bq, wk, bk, wv, bv)
    if x.device.type == "cpu":
        return attention_block_train_bwd_plain(
            x, dctx, desc, seed, *weights, num_heads=num_heads,
            attn_drop=attn_drop)
    check_inputs("attention_block_train", x, desc, weights, num_heads,
                 products=BWD_PRODUCTS)
    _require(dctx.dtype == x.dtype and dctx.shape == x.shape
             and dctx.is_contiguous(), "dctx must be shaped like x")
    with trace.span("op.attention_block_train_bwd"):
        B, L, Hd = x.shape
        lib = _build.library()
        w_cat_t = torch.cat([wq, wk, wv], 0).t().contiguous()   # [Hd, 3 Hd]
        q, k, v, dx = (torch.empty_like(x) for _ in range(4))
        dqkv = torch.empty(B, L, 3 * Hd, dtype=x.dtype, device=x.device)
        # each row's log-sum-exp and rowsum(dP P), from the dq launch to the
        # dk / dv launch
        stats = torch.empty(B, num_heads, 2, L, dtype=torch.float32,
                            device=x.device)
        code = lib.unimm_attention_block_train_bwd(
            x.data_ptr(), dctx.data_ptr(), desc.data_ptr(),
            *(t.data_ptr() for t in weights), w_cat_t.data_ptr(), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), dqkv.data_ptr(), dx.data_ptr(),
            stats.data_ptr(), B, L, *_drop_args(seed, attn_drop),
            _build.stream(x.device))
        _build.check(code, "attention_block_train_bwd")
        attention_block_train_bwd.launches += 1
    return dx, dqkv[..., :Hd], dqkv[..., Hd:2 * Hd], dqkv[..., 2 * Hd:]


attention_block_train_fwd.launches = 0
attention_block_train_bwd.launches = 0


def fwd_kernel_info(L=256):
    """The forward's attention launch at attention dropout 0 and above
    (the instances without and with the Philox draws): {"drop 0": ...,
    "drop": ...}, ``text_attention.fwd_kernel_info``'s fields each."""
    return {name: _build.kernel_info("unimm_attention_block_train_fwd_info",
                                     L, drop)
            for drop, name in ((0, "drop 0"), (1, "drop"))}


def bwd_kernel_info(L=256):
    """The attention backward's two kernels (dq, dk / dv) under attention
    dropout, as ``text_attention.bwd_kernel_info`` reports them."""
    return {name: _build.kernel_info("unimm_seq_attn_bwd_info", L, i, 1, 0)
            for i, name in enumerate(("dq", "dkdv"))}


def _wgrad(d, x):
    """[out, in] weight gradient d^T x over all rows, in the compute dtype
    (fp32 accumulation, one rounding)."""
    Hd = x.shape[-1]
    return d.reshape(-1, d.shape[-1]).t() @ x.reshape(-1, Hd)


class AttentionBlockTrain(torch.autograd.Function):
    """y = LN((Wo attention_dropped(x) + bo) * m_o + x), differentiable in
    x and the ten weights; ``desc``, ``seed`` and ``m_o`` get no
    gradient."""

    @staticmethod
    def forward(ctx, x, desc, seed, m_o, wq, bq, wk, bk, wv, bv, wo, bo,
                gamma, beta, num_heads, attn_drop, eps):
        y, c = attention_block_train_fwd(
            x, desc, seed, m_o, wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta,
            num_heads=num_heads, attn_drop=attn_drop, eps=eps)
        ctx.save_for_backward(x, desc, m_o, c, wq, bq, wk, bk, wv, bv, wo,
                              bo, gamma, beta)
        ctx.cfg = (seed, num_heads, attn_drop, eps)
        return y

    @staticmethod
    def backward(ctx, dy):
        (x, desc, m_o, c, wq, bq, wk, bk, wv, bv, wo, bo, gamma,
         beta) = ctx.saved_tensors
        seed, num_heads, attn_drop, eps = ctx.cfg
        f32, dt = torch.float32, x.dtype
        # ---- LN / Wo side (recompute the LayerNorm input from ctx) ----
        h_out = torch.matmul(c, wo.t()) + bo                  # in dt
        od = h_out.float() * m_o if m_o is not None else h_out.float()
        h32 = od + x.float()
        mean = h32.mean(-1, keepdim=True)
        var = (h32 - mean).square().mean(-1, keepdim=True)
        inv = torch.rsqrt(var + eps)
        xhat = (h32 - mean) * inv
        dy32 = dy.to(f32)
        dgamma = (dy32 * xhat).sum((0, 1)).to(gamma.dtype)
        dbeta = dy32.sum((0, 1)).to(beta.dtype)
        dxhat = dy32 * gamma.float()
        dh32 = (dxhat - dxhat.mean(-1, keepdim=True)
                - xhat * (dxhat * xhat).mean(-1, keepdim=True)) * inv
        dh_out = (dh32 * m_o if m_o is not None else dh32).to(dt)
        dctx = torch.matmul(dh_out, wo).contiguous()
        dwo = _wgrad(dh_out, c).to(wo.dtype)
        dbo = dh_out.float().sum((0, 1)).to(bo.dtype)
        # ---- QKV / attention side (the backward kernel) ----
        dx_qkv, dq, dk, dv = attention_block_train_bwd(
            x, dctx, desc, seed, wq, bq, wk, bk, wv, bv,
            num_heads=num_heads, attn_drop=attn_drop)
        dx = (dx_qkv.float() + dh32).to(dt)
        grads = []
        for d, w, b in ((dq, wq, bq), (dk, wk, bk), (dv, wv, bv)):
            grads += [_wgrad(d, x).to(w.dtype),
                      d.float().sum((0, 1)).to(b.dtype)]
        return (dx, None, None, None, *grads, dwo, dbo, dgamma, dbeta, None,
                None, None)


def attention_block_train(x, desc, seed, m_o, p_attn, *, num_heads,
                          attn_drop, eps=1e-12):
    """The differentiable attention sub-block of one text layer in
    training: x [B, L, Hd] in the compute dtype, desc [B, 3] int32, seed a
    host int (the probability-dropout stream, keyed per (sequence, head)),
    m_o the fp32 hidden-dropout scale mask or None, p_attn the layer's
    ``attention`` module (its tensors in the compute dtype)."""
    return AttentionBlockTrain.apply(x, desc, int(seed), m_o,
                                     *_weights(p_attn), num_heads,
                                     float(attn_drop), eps)
