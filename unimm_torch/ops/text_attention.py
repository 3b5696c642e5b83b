"""Masked multi-head text self-attention of the per-head path
(``attention_impl="pallas"``), with the text mask made from the descriptor.

``text_attention`` replaces the TPU kernel
``unimm_tpu/ops/pallas_attention.py:fused_text_attention`` (a
``jax.custom_vjp`` over the forward kernel ``_fwd_kernel`` and the backward
kernel ``_bwd_kernel``) with a ``torch.autograd.Function`` over the two
hand-written kernels of ``csrc/text_attention.cu``:

* forward: ``softmax(q k^T * scale + bias(desc)) v`` over [B, H, L, D]
  heads: the scores in fp32, then the scale in fp32, the descriptor bias
  and an fp32 softmax; the probabilities round to v.dtype, the product
  accumulates in fp32 and rounds to q.dtype. The kernel
  (``csrc/seq_attn_fwd.cuh``) scores once in registers and skips the key
  chunks that ``masks.chunk_closed`` closes.
* backward: the probabilities recomputed in fp32; dv = p^T do, dp = do v^T,
  ds = p (dp - rowsum(dp p)), dq = ds k scale, dk = ds^T q scale, every
  product with fp32 operands, each output rounded to q.dtype once. The
  kernels (``csrc/seq_attn_bwd.cuh``) run on 64-row tiles in two launches,
  dq then dk / dv, with each row's log-sum-exp and rowsum(dp p) passed
  between them in an fp32 scratch the wrapper allocates; they skip the
  chunks that ``masks.chunk_closed`` and ``masks.query_chunk_closed``
  close.

The Function saves (q, k, v, desc), as ``_fta_fwd`` does. On CUDA tensors
the wrappers launch the kernels (bf16, heads of 64, 32 <= L <= 256 with
L % 32 == 0) or raise; on CPU tensors they run the plain twins below, which
compute the same arithmetic in plain PyTorch over the [B, L, L] bias of
``masks.mask_bias``. The kernels read q, k, v and do through their strides:
the head-split view of a [B, L, H D] projection (``vilbert._split_heads``)
goes in without a copy, and the outputs come back in q's layout, so
``vilbert._merge_heads`` of the result is a view too.
"""

from __future__ import annotations

import math

import torch

from unimm_torch.ops import _build
from unimm_torch.ops.masks import mask_bias
from unimm_torch.utils import trace

HEAD_DIM = 64    # the head width the CUDA kernels are built for
MAX_LEN = 256    # the longest sequence whose K/V fit one CTA's shared memory


def _scores(q, k, desc):
    """fp32 q k^T / sqrt(D) + the descriptor bias, [B, H, L, L]."""
    L = q.shape[-2]
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(
        q.shape[-1]))
    return s + mask_bias(desc, L).to(q.device)[:, None]


def text_attention_fwd_plain(q, k, v, desc):
    """Plain twin of the forward kernel: [B, H, L, D] in q.dtype."""
    p = torch.softmax(_scores(q, k, desc), dim=-1)
    return (p.to(v.dtype).float() @ v.float()).to(q.dtype)


def text_attention_bwd_plain(q, k, v, desc, do):
    """Plain twin of the backward kernel: (dq, dk, dv) in q.dtype, every
    product with fp32 operands."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(_scores(q, k, desc), dim=-1)
    dof = do.float()
    dv = p.transpose(-1, -2) @ dof
    dp = dof @ v.float().transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = (ds @ k.float()) * scale
    dk = (ds.transpose(-1, -2) @ q.float()) * scale
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def _dense_layout(t):
    """Whether t [B, H, L, D] is contiguous or the head-split view of a
    contiguous [B, L, H D] tensor: the two layouts the kernels take as
    they are."""
    B, H, L, D = t.shape
    return t.stride() in ((H * L * D, L * D, D, 1), (L * H * D, D, H * D, 1))


def same_layout(q, *others):
    """(q, *others) in one layout the kernels read: q as it is when
    ``_dense_layout`` holds, else contiguous; each other tensor copied into
    q's strides where its own differ."""
    if not _dense_layout(q):
        q = q.contiguous()
    out = [q]
    for t in others:
        if t.stride() != q.stride():
            t = torch.empty_strided(q.shape, q.stride(), dtype=t.dtype,
                                    device=t.device).copy_(t)
        out.append(t)
    return out


def check_inputs(name, tensors, desc):
    """Raise ValueError unless the per-head kernels take these tensors:
    [B, H, L, 64] bf16 of one shape with 32 <= L <= 256 and L % 32 == 0,
    16-byte aligned, desc int32 [B, 3], all on one CUDA device."""
    def require(cond, msg):
        if not cond:
            raise ValueError(f"{name}: {msg}")
    q = tensors[0]
    require(q.dim() == 4, f"q must be [B, H, L, {HEAD_DIM}], got "
            f"{tuple(q.shape)}")
    B, H, L, D = q.shape
    require(D == HEAD_DIM, f"kernel is built for heads of {HEAD_DIM}, got {D}")
    require(L % 32 == 0 and 32 <= L <= MAX_LEN,
            f"sequence length {L} must be a multiple of 32 in "
            f"[32, {MAX_LEN}]")
    require(tuple(desc.shape) == (B, 3) and desc.dtype == torch.int32
            and desc.is_contiguous(),
            f"desc must be int32 [{B}, 3], got {desc.dtype} "
            f"{tuple(desc.shape)}")
    for t in tensors:
        require(t.shape == q.shape, f"shape {tuple(t.shape)} differs from "
                f"q's {tuple(q.shape)}")
        require(t.dtype == torch.bfloat16,
                f"q, k, v must be bfloat16, got {t.dtype}")
        require(t.data_ptr() % 16 == 0, "inputs must be 16-byte aligned")
    for t in tuple(tensors) + (desc,):
        require(t.device == q.device, "all tensors on one device")
    require(q.device.type == "cuda", f"unsupported device {q.device}")


def _dims(q):
    B, H, L, D = q.shape
    return (B, H, L, *q.stride()[:3], 1.0 / math.sqrt(D))


def text_attention_fwd(q, k, v, desc):
    """The forward kernel: [B, H, L, D] in q's layout. A CPU tensor runs
    ``text_attention_fwd_plain``."""
    if q.device.type == "cpu":
        return text_attention_fwd_plain(q, k, v, desc)
    check_inputs("text_attention", (q, k, v), desc)
    q, k, v = same_layout(q, k, v)
    with trace.span("op.text_attention_fwd"):
        out = torch.empty_strided(q.shape, q.stride(), dtype=q.dtype,
                                  device=q.device)
        code = _build.library().unimm_text_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), desc.data_ptr(),
            out.data_ptr(), *_dims(q), _build.stream(q.device))
        _build.check(code, "text_attention_fwd")
        text_attention_fwd.launches += 1
    return out


def text_attention_bwd(q, k, v, desc, do):
    """The backward kernel: (dq, dk, dv) in q's layout. A CPU tensor runs
    ``text_attention_bwd_plain``."""
    if q.device.type == "cpu":
        return text_attention_bwd_plain(q, k, v, desc, do)
    check_inputs("text_attention_bwd", (q, k, v, do), desc)
    q, k, v, do = same_layout(q, k, v, do)
    with trace.span("op.text_attention_bwd"):
        dq, dk, dv = (torch.empty_strided(q.shape, q.stride(), dtype=q.dtype,
                                          device=q.device) for _ in range(3))
        B, H, L, _ = q.shape
        stats = torch.empty(B, H, 2, L, dtype=torch.float32, device=q.device)
        code = _build.library().unimm_text_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            desc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats.data_ptr(), *_dims(q), _build.stream(q.device))
        _build.check(code, "text_attention_bwd")
        text_attention_bwd.launches += 1
    return dq, dk, dv


text_attention_fwd.launches = 0
text_attention_bwd.launches = 0


def fwd_kernel_info(L=MAX_LEN):
    """The forward kernel's registers and local bytes (stack and spills) a
    thread, dynamic shared memory a CTA at length L and CTAs an SM, as the
    card's runtime reports them (builds the library)."""
    return _build.kernel_info("unimm_text_attention_fwd_info", L)


def bwd_kernel_info(L=MAX_LEN):
    """The same of the backward's two kernels: {"dq": ..., "dkdv": ...}."""
    return {name: _build.kernel_info("unimm_seq_attn_bwd_info", L, i, 0, 1)
            for i, name in enumerate(("dq", "dkdv"))}


class TextAttention(torch.autograd.Function):
    """softmax(q k^T / sqrt(D) + bias(desc)) v, differentiable in q, k and
    v; ``desc`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, desc):
        ctx.save_for_backward(q, k, v, desc)
        return text_attention_fwd(q, k, v, desc)

    @staticmethod
    def backward(ctx, do):
        q, k, v, desc = ctx.saved_tensors
        dq, dk, dv = text_attention_bwd(q, k, v, desc, do)
        return dq, dk, dv, None


def text_attention(q, k, v, desc):
    """Masked multi-head attention with the text mask made from the
    descriptor. q, k, v [B, H, L, D] in the compute dtype, desc [B, 3]
    int32 (mode, ctx_end, ans_len). Returns [B, H, L, D] in q.dtype."""
    return TextAttention.apply(q, k, v, desc)
