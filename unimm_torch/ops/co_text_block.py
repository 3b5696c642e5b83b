"""Text side of a co-attention (connection) layer: text queries attend the
image regions, then dense2 + residual + LayerNorm2.

``co_text_block`` replaces the TPU kernel
``unimm_tpu/ops/pallas_attention_v2.py:fused_co_text_block``. On a CUDA
tensor it launches the hand-written kernel in ``csrc/co_text_block.cu``
(five launches: the q2 projection and the k1/v1 projections of the
regions on the wgmma + TMA core of ``csrc/gemm_wg.cuh``, attention per
(query tile, head, sequence), dense2 + bias + residual on the same core
into fp32, LayerNorm2 one warp a row); on a CPU
tensor it runs ``co_text_block_plain``, which repeats the kernel's
arithmetic and rounding points in plain PyTorch. The image side of the
connection layer stays plain PyTorch, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import math

import torch

from unimm_torch.ops import _build
from unimm_torch.ops.masks import NEG_INF
from unimm_torch.utils import trace

HID = 768          # text width the CUDA kernel is built for
BI = 1024          # bi_hidden_size = v_hidden_size
HEAD_DIM = 128
MAX_REGIONS = 64   # keys padded to one 64-row tile


def _weights(p_conn):
    pb, po = p_conn.biattention, p_conn.biOutput
    return (pb.query2.weight, pb.query2.bias, pb.key1.weight, pb.key1.bias,
            pb.value1.weight, pb.value1.bias, po.dense2.weight,
            po.dense2.bias, po.LayerNorm2.weight, po.LayerNorm2.bias)


def co_context_plain(t_x, v_x, image_mask, p_conn, *, num_heads):
    """The attention part of ``co_text_block_plain``: each head's context,
    rounded to t_x.dtype, merged to [B, L, bi_hidden_size] (the input of
    dense2)."""
    wq, bq, wk, bk, wv, bv = _weights(p_conn)[:6]
    dt = t_x.dtype
    B, L, _ = t_x.shape
    R = v_x.shape[1]
    BIw = wq.shape[0]
    D = BIw // num_heads

    def proj(x, w, b):
        return (x.float() @ w.float().t() + b.float()).to(dt)

    def heads(t, n):     # [B, n, BI] -> [B, H, n, D] fp32
        return t.reshape(B, n, num_heads, D).permute(0, 2, 1, 3).float()

    q = (proj(t_x, wq, bq).float() * (1.0 / math.sqrt(D))).to(dt)
    k, v = proj(v_x, wk, bk), proj(v_x, wv, bv)
    bias = torch.where(image_mask > 0, 0.0, NEG_INF).float()
    s = heads(q, L) @ heads(k, R).transpose(-1, -2) + bias[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(dt).float()
    return (p @ heads(v, R)).to(dt).permute(0, 2, 1, 3).reshape(B, L, BIw)


def co_text_block_plain(t_x, v_x, image_mask, p_conn, *, num_heads,
                        eps=1e-12):
    """Plain PyTorch version of the kernel, with its rounding points: the
    projections accumulate in fp32 and round to t_x.dtype after the bias;
    q2 is scaled in fp32 and rounded; scores, the image padding bias and
    the softmax over the regions are fp32; the probabilities and each
    head's context round to t_x.dtype; dense2, bias, residual and
    LayerNorm2 run in fp32."""
    wd, bd, gamma, beta = _weights(p_conn)[6:]
    ctx = co_context_plain(t_x, v_x, image_mask, p_conn, num_heads=num_heads)
    h32 = (ctx.float() @ wd.float().t() + bd.float()) + t_x.float()
    mean = h32.mean(-1, keepdim=True)
    var = (h32 - mean).square().mean(-1, keepdim=True)
    y = (h32 - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(t_x.dtype)


def _require(cond, msg):
    if not cond:
        raise ValueError(f"co_text_block: {msg}")


def co_text_block(t_x, v_x, image_mask, p_conn, *, num_heads, eps=1e-12):
    """LayerNorm2(t_x + Wd2 . attention(q2(t_x), k1/v1(v_x), image padding
    bias) + bd2).

    t_x [B, L, 768]; v_x [B, R, 1024]; image_mask [B, R] (> 0 = a real
    region); p_conn the connection layer module in the compute dtype. A CPU
    tensor runs ``co_text_block_plain``; a CUDA tensor launches the kernel
    (bf16 activations and weights, fp32 image_mask, L % 16 == 0, R <= 64)
    or raises."""
    if t_x.device.type == "cpu":
        return co_text_block_plain(t_x, v_x, image_mask, p_conn,
                                   num_heads=num_heads, eps=eps)
    weights = _weights(p_conn)
    _require(t_x.dim() == 3 and v_x.dim() == 3, "t_x and v_x must be 3-D")
    B, L, Ht = t_x.shape
    R = v_x.shape[1]
    _require(Ht == HID and tuple(v_x.shape) == (B, R, BI),
             f"kernel is built for text width {HID} and image width {BI}, "
             f"got {tuple(t_x.shape)} / {tuple(v_x.shape)}")
    _require(BI // num_heads == HEAD_DIM,
             f"kernel is built for heads of {HEAD_DIM}, got {num_heads} "
             f"heads of {BI}")
    _require(L % 16 == 0, f"text length {L} must be a multiple of 16")
    _require(1 <= R <= MAX_REGIONS, f"{R} regions, at most {MAX_REGIONS}")
    _require(tuple(image_mask.shape) == (B, R)
             and image_mask.dtype == torch.float32,
             f"image_mask must be float32 [{B}, {R}], got "
             f"{image_mask.dtype} {tuple(image_mask.shape)}")
    shapes = [(BI, HID), (BI,), (BI, BI), (BI,), (BI, BI), (BI,),
              (HID, BI), (HID,), (HID,), (HID,)]
    for t, shp in zip(weights, shapes):
        _require(tuple(t.shape) == shp, f"weight shape {tuple(t.shape)}")
    for t in (t_x, v_x) + weights:
        _require(t.dtype == torch.bfloat16,
                 f"activations and weights must be bfloat16, got {t.dtype}")
    for t in (t_x, v_x, image_mask) + weights:
        _require(t.device == t_x.device, "all tensors on one device")
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 "inputs must be contiguous and 16-byte aligned")
    _require(t_x.device.type == "cuda", f"unsupported device {t_x.device}")
    with trace.span("op.co_text_block"):
        lib = _build.library()
        dev, dt = t_x.device, t_x.dtype
        q = torch.empty(B, L, BI, dtype=dt, device=dev)
        k, v = (torch.empty(B, R, BI, dtype=dt, device=dev) for _ in range(2))
        ctx = torch.empty_like(q)
        pre = torch.empty(B, L, HID, dtype=torch.float32, device=dev)
        out = torch.empty_like(t_x)
        code = lib.unimm_co_text_block(
            t_x.data_ptr(), v_x.data_ptr(), image_mask.data_ptr(),
            *(t.data_ptr() for t in weights), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), ctx.data_ptr(), pre.data_ptr(), out.data_ptr(), B, L,
            R, eps, _build.stream(dev))
        _build.check(code, "co_text_block")
        co_text_block.launches += 1
    return out


co_text_block.launches = 0
