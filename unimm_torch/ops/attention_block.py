"""Whole-sequence BERT attention sub-block of the flat scorer, with the
text mask made from the descriptor.

``attention_block`` replaces the TPU kernel
``unimm_tpu/ops/pallas_attention_v2.py:fused_attention_block`` (and its
in-kernel mask, ``unimm_tpu/ops/pallas_attention.py:_mask_bias``): QKV
projection, the dis/gen text mask from the ``(mode, ctx_end, ans_len)``
descriptor, fp32 softmax, PV, head merge, output projection, residual,
LayerNorm. On a CUDA tensor it launches the hand-written kernel in
``csrc/attention_block.cu`` (four launches: the Q/K/V projection on the
wgmma + TMA GEMM core of ``csrc/gemm_wg.cuh``; the one-pass attention of
``csrc/seq_attn_fwd.cuh`` per (query tile, head, sequence), with the mask
computed in the kernel from each row's open-key interval and the 64-key
chunks a warp's rows all leave closed skipped; the output projection with
the bias and residual into an fp32 scratch on the same core, then the
row LayerNorm); on a CPU tensor it runs
``attention_block_plain``, which repeats the kernel's arithmetic and
rounding points in plain PyTorch over the ``[B, L, L]`` bias of
``masks.mask_bias``, but for one: it rounds the normalised probabilities
where the kernel rounds each unnormalised one and divides by the row sum
once (one bf16 rounding of each term either way; the card check's bound
covers it, and tests/test_torch_block_onepass.py emulates the kernel's
order in fp32).
"""

from __future__ import annotations

import math

import torch

from unimm_torch.ops import _build
from unimm_torch.ops.answer_block import _weights
from unimm_torch.ops.masks import mask_bias
from unimm_torch.utils import trace

HID = 768        # the width the CUDA kernel is built for
HEAD_DIM = 64
MAX_LEN = 256    # the longest sequence whose K/V fit one CTA's shared memory
# csrc/gemm_wg.cuh's tiles: a product's width N must be a multiple of
# WG_BN, its depth K of WG_BK
WG_BN, WG_BK = 256, 64
# (N, K) of the block's products on the core: Q/K/V and the output, each
# 768 x 768
BLOCK_PRODUCTS = ((HID, HID),)


def attention_block_plain(x, desc, p_attn, *, num_heads, eps=1e-12):
    """Plain PyTorch version of the kernel, with its rounding points:
    projections accumulate in fp32 and round to x.dtype after the bias; q
    is scaled in fp32 and rounded; scores, mask and softmax are fp32; the
    probabilities and each head's context round to x.dtype; the output
    projection, bias, residual and LayerNorm run in fp32."""
    wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta = _weights(p_attn)
    dt = x.dtype
    B, L, Hd = x.shape
    D = Hd // num_heads
    xf = x.float()

    def proj(w, b):
        return (xf @ w.float().t() + b.float()).to(dt)

    def heads(t):        # [B, L, Hd] -> [B, H, L, D] fp32
        return t.reshape(B, L, num_heads, D).permute(0, 2, 1, 3).float()

    q = (proj(wq, bq).float() * (1.0 / math.sqrt(D))).to(dt)
    k, v = proj(wk, bk), proj(wv, bv)
    s = heads(q) @ heads(k).transpose(-1, -2) + mask_bias(desc, L)[:, None]
    p = torch.softmax(s, dim=-1).to(dt).float()
    ctx = (p @ heads(v)).to(dt).permute(0, 2, 1, 3).reshape(B, L, Hd)
    h32 = (ctx.float() @ wo.float().t() + bo.float()) + xf
    mean = h32.mean(-1, keepdim=True)
    var = (h32 - mean).square().mean(-1, keepdim=True)
    y = (h32 - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(dt)


def check_inputs(name, x, desc, weights, num_heads, width=HID,
                 products=()):
    """Raise ValueError unless the attention-block kernels (this one, the
    training block's and the bench's probes) take these tensors: x [B, L,
    768] bf16 with 32 <= L <= 256 and L % 32 == 0, heads of 64, desc int32
    [B, 3], the weights bf16 [width, 768] / [width] (Q, K, V), [768, width]
    / [768] (output) and [768] (LayerNorm), all contiguous, aligned and on
    one CUDA device. ``width`` is 768, or 1536 for heads padded to 128.
    ``products``: the (N, K) of each product the kernel runs on the GEMM
    core over the B L rows, each of which the core must take (the core
    itself returns an error for one it refuses, after the launches before
    it: this says so before any)."""
    def require(cond, msg):
        if not cond:
            raise ValueError(f"{name}: {msg}")
    require(x.dim() == 3, f"x must be [B, L, {HID}], got {tuple(x.shape)}")
    B, L, Hd = x.shape
    require(Hd == HID and Hd // num_heads == HEAD_DIM,
            f"kernel is built for width {HID} in heads of {HEAD_DIM}, got "
            f"{Hd} / {num_heads}")
    require(L % 32 == 0 and 32 <= L <= MAX_LEN,
            f"sequence length {L} must be a multiple of 32 in "
            f"[32, {MAX_LEN}]")
    require(tuple(desc.shape) == (B, 3) and desc.dtype == torch.int32,
            f"desc must be int32 [{B}, 3], got {desc.dtype} "
            f"{tuple(desc.shape)}")
    # wq, bq, wk, bk, wv, bv[, wo, bo, gamma, beta]
    shapes = [(width, HID), (width,)] * 3 + [(HID, width), (HID,),
                                             (HID,), (HID,)]
    for t, shp in zip(weights, shapes):
        require(tuple(t.shape) == shp, f"weight shape {tuple(t.shape)}")
    for t in (x,) + tuple(weights):
        require(t.dtype == torch.bfloat16,
                f"activations and weights must be bfloat16, got {t.dtype}")
    for t in (x, desc) + tuple(weights):
        require(t.device == x.device, "all tensors on one device")
        require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                "inputs must be contiguous and 16-byte aligned")
    for N, K in products:
        require(core_takes(B * L, N, K),
                f"the GEMM core does not take M {B * L}, N {N}, K {K} "
                f"(M >= 1, N % {WG_BN} == 0, K % {WG_BK} == 0)")
    require(x.device.type == "cuda", f"unsupported device {x.device}")


def core_takes(M, N, K):
    """Whether the GEMM core (csrc/gemm_wg.cuh's ``launch_gemm_nt_wg``,
    whose rule this repeats) takes a product of M rows, width N and depth
    K."""
    return M >= 1 and N >= WG_BN and N % WG_BN == 0 and K >= WG_BK \
        and K % WG_BK == 0


def lower_block_b(B, block_b):
    """The TPU kernel's rule: the largest divisor of B not above
    ``block_b``."""
    if block_b < 1:
        raise ValueError(f"block_b must be >= 1, got {block_b}")
    while B % block_b:
        block_b -= 1
    return block_b


def attention_block(x, desc, p_attn, *, num_heads, eps=1e-12, block_b=1):
    """LayerNorm(x + Wo . attention(x under the descriptor's text mask) +
    bo) for whole sequences.

    x [B, L, 768]; desc [B, 3] int32 (mode, ctx_end, ans_len); p_attn the
    layer's ``attention`` module in the compute dtype. A CPU tensor runs
    ``attention_block_plain``; a CUDA tensor launches the kernel (bf16
    activations and weights, 32 <= L <= 256 with L % 32 == 0) or raises.
    ``block_b`` (lowered to the largest divisor of B, as on the TPU) is the
    number of sequences each attention CTA walks in turn; the result does
    not depend on it.
    """
    block_b = lower_block_b(x.shape[0], block_b)
    if x.device.type == "cpu":
        return attention_block_plain(x, desc, p_attn, num_heads=num_heads,
                                     eps=eps)
    weights = _weights(p_attn)
    check_inputs("attention_block", x, desc, weights, num_heads,
                 products=BLOCK_PRODUCTS)
    with trace.span("op.attention_block"):
        B, L, _ = x.shape
        lib = _build.library()
        q, k, v, ctx, out = (torch.empty_like(x) for _ in range(5))
        # the output projection's bias + residual sum, fp32, for the LayerNorm
        pre = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        code = lib.unimm_attention_block(
            x.data_ptr(), desc.data_ptr(), *(t.data_ptr() for t in weights),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ctx.data_ptr(),
            pre.data_ptr(), out.data_ptr(), B, L, block_b, eps,
            _build.stream(x.device))
        _build.check(code, "attention_block")
        attention_block.launches += 1
    return out


attention_block.launches = 0


def kernel_info(L=MAX_LEN):
    """The attention launch's registers, local bytes, shared memory and
    CTAs an SM at length L (``text_attention.fwd_kernel_info``'s
    fields)."""
    return _build.kernel_info("unimm_attention_block_info", L)
