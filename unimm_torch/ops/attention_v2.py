"""Masked multi-head text attention with the 1/sqrt(D) scale folded into q,
the attention bench's second-generation variant (``tools/bench_attn.py``).

``attention_v2`` replaces the TPU kernel
``unimm_tpu/ops/pallas_attention_v2.py:attention_v2`` (``_v2_kernel``):
the function of ``text_attention``'s forward, except that q is scaled in
fp32 and rounded to its dtype before the scores (``q_s = bf16(q scale)``,
``s = q_s k^T`` in fp32). On the TPU ``block_b`` sequences share a grid
step; here it sets how many sequences one CTA of ``csrc/attention_v2.cu``
walks in turn, loading the next one's K, q and V while it computes the
current one, and the result does not depend on it. On CUDA tensors the
wrapper launches the kernel (bf16, heads of 64, 32 <= L <= 256 with
L % 32 == 0) or raises; on CPU tensors it runs ``attention_v2_plain``.
"""

from __future__ import annotations

import math

import torch

from unimm_torch.ops import _build
from unimm_torch.ops.attention_block import lower_block_b
from unimm_torch.ops.masks import mask_bias
from unimm_torch.ops.text_attention import check_inputs, same_layout
from unimm_torch.utils import trace


def attention_v2_plain(q, k, v, desc):
    """Plain twin of the kernel: [B, H, L, D] in q.dtype."""
    L = q.shape[-2]
    q_s = (q.float() * (1.0 / math.sqrt(q.shape[-1]))).to(q.dtype)
    s = (q_s.float() @ k.float().transpose(-1, -2)
         + mask_bias(desc, L).to(q.device)[:, None])
    p = torch.softmax(s, dim=-1)
    return (p.to(v.dtype).float() @ v.float()).to(q.dtype)


def attention_v2(q, k, v, desc, *, block_b=4):
    """[B, H, L, D] attention with ``block_b`` sequences per CTA (eval
    only). ``block_b`` is lowered to the largest divisor of B that it
    reaches, as the TPU kernel's grid does."""
    block_b = lower_block_b(q.shape[0], block_b)
    if q.device.type == "cpu":
        return attention_v2_plain(q, k, v, desc)
    check_inputs("attention_v2", (q, k, v), desc)
    q, k, v = same_layout(q, k, v)
    with trace.span("op.attention_v2"):
        B, H, L, D = q.shape
        out = torch.empty_strided(q.shape, q.stride(), dtype=q.dtype,
                                  device=q.device)
        code = _build.library().unimm_attention_v2(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), desc.data_ptr(),
            out.data_ptr(), B, H, L, *q.stride()[:3], block_b,
            1.0 / math.sqrt(D), _build.stream(q.device))
        _build.check(code, "attention_v2")
        attention_v2.launches += 1
    return out


attention_v2.launches = 0


def kernel_info(L=256):
    """The kernel's registers, local bytes, shared memory and CTAs an SM at
    length L (``text_attention.fwd_kernel_info``'s fields)."""
    return _build.kernel_info("unimm_attention_v2_info", L)
