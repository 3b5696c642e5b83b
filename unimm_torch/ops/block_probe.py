"""The attention-block bench's probes: the whole-sequence attention
sub-block (``attention_block``) with one part of its attention taken out or
laid out another way, to attribute its time on the card.

``probe_block`` replaces the TPU kernel
``scripts/bench_attn_block.py:_mk_probe`` (body ``_probe_kernel``) and
``layout_probe_block`` replaces ``:_mk_layout_probe`` (bodies
``_probe_transposed_kernel``, ``_probe_wo_acc_kernel``,
``_probe_pad128_kernel``). Both keep the attention block's rounding points
(projections rounded after the bias, q scaled and rounded, fp32 scores
under the descriptor's mask, bf16 probabilities and per-head context,
fp32 output projection, residual and LayerNorm) and change one thing:

* ``softmax_mode``: ``"full"`` is the block itself; ``"none"`` replaces
  the softmax by ``p = s * 1e-4`` (one score pass, no exp, no row
  statistic); ``"noshift"`` takes ``exp(s - 20) / sum`` without the row
  max (NaN on a row whose keys are all masked, as on the TPU); ``"skip"``
  takes ``ctx = v`` (no attention at all).
* ``layout``: ``"wo_acc"`` sums the output projection head by head in fp32
  instead of over the concatenated context; ``"transposed"`` computes the
  projections feature-major ([768, L] per sequence) and then proceeds as
  ``wo_acc``; ``"pad128"`` runs on weights whose heads were zero-padded to
  128 columns by ``pad_heads_128`` (the scale stays 1 / sqrt(64)).

The probes compute other functions than the block (``none``, ``skip``,
``noshift``) or the same one in another order; they serve the bench
(``tools/bench_attn_block.py``) and nothing else. On a CPU tensor each
wrapper runs its plain twin; on a CUDA tensor it launches the kernels in
``csrc/block_probe.cu`` or raises. They run on B4's design: the Q/K/V and
output products on the wgmma + TMA core of ``csrc/gemm_wg.cuh`` (the
output with the bias + residual into an fp32 scratch, then the row
LayerNorm); ``full`` launches B4's own attention (so it equals
``attention_block`` bit for bit); ``none``, ``noshift`` and ``pad128``
launch ``probe_attn_kernel``, the one-pass attention with another softmax
step (or heads of 128); ``wo_acc`` and ``transposed`` launch
``wo_acc_wg_kernel``, the attention, the output product on wgmma and the
LayerNorm in one kernel per 64 query rows.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from unimm_torch.ops import _build
from unimm_torch.ops.answer_block import _weights
from unimm_torch.ops.attention_block import (BLOCK_PRODUCTS, HEAD_DIM, HID,
                                             check_inputs)
from unimm_torch.ops.masks import mask_bias

SOFTMAX_MODES = {"full": 0, "none": 1, "noshift": 2, "skip": 3}
LAYOUTS = {"wo_acc": 0, "transposed": 1, "pad128": 2}
PAD_DIM = 128


def _plain(x, desc, p_attn, num_heads, *, soft="full", wo_acc=False,
           transposed=False, eps=1e-12, return_ctx=False):
    """The probes' common plain version. The heads are as wide as the
    projection weights make them (64, or 128 after ``pad_heads_128``); the
    scale is 1 / sqrt(x's width / num_heads). ``return_ctx``: also the
    context, [B, L, width] in x's dtype."""
    wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta = _weights(p_attn)
    dt = x.dtype
    B, L, Hd = x.shape
    D = wq.shape[0] // num_heads
    xf = x.float()

    def proj(w, b):
        if transposed:           # [B, W, L], then back to [B, L, W]
            y = w.float() @ xf.transpose(1, 2) + b.float()[:, None]
            return y.to(dt).transpose(1, 2)
        return (xf @ w.float().t() + b.float()).to(dt)

    def heads(t):                # [B, L, W] -> [B, H, L, D] fp32
        return t.reshape(B, L, num_heads, D).permute(0, 2, 1, 3).float()

    q = (proj(wq, bq).float() * (1.0 / math.sqrt(Hd // num_heads))).to(dt)
    k, v = proj(wk, bk), proj(wv, bv)
    if soft == "skip":
        ctx = heads(v).to(dt)
    else:
        s = heads(q) @ heads(k).transpose(-1, -2) + mask_bias(desc, L)[:, None]
        if soft == "full":
            p = torch.softmax(s, dim=-1)
        elif soft == "none":
            p = s * 1e-4
        else:                    # noshift
            e = torch.exp(s - 20.0)
            p = e / e.sum(-1, keepdim=True)
        ctx = (p.to(dt).float() @ heads(v)).to(dt)       # [B, H, L, D]
    if wo_acc:
        out = None
        for h in range(num_heads):
            acc = ctx[:, h].float() @ wo[:, h * D:(h + 1) * D].float().t()
            out = acc if out is None else out + acc
    else:
        out = ctx.permute(0, 2, 1, 3).reshape(B, L, -1).float() \
            @ wo.float().t()
    h32 = (out + bo.float()) + xf
    mean = h32.mean(-1, keepdim=True)
    var = (h32 - mean).square().mean(-1, keepdim=True)
    y = ((h32 - mean) * torch.rsqrt(var + eps) * gamma.float()
         + beta.float()).to(dt)
    if return_ctx:
        return y, ctx.permute(0, 2, 1, 3).reshape(B, L, -1)
    return y


def probe_block_plain(x, desc, p_attn, *, num_heads, softmax_mode,
                      eps=1e-12, return_ctx=False):
    """Plain PyTorch version of ``probe_block`` with its rounding points."""
    if softmax_mode not in SOFTMAX_MODES:
        raise ValueError(f"softmax_mode {softmax_mode!r}")
    return _plain(x, desc, p_attn, num_heads, soft=softmax_mode, eps=eps,
                  return_ctx=return_ctx)


def layout_probe_block_plain(x, desc, p_attn, *, num_heads, layout,
                             eps=1e-12):
    """Plain PyTorch version of ``layout_probe_block``: ``wo_acc`` and
    ``transposed`` sum the output projection head by head in fp32;
    ``transposed`` computes the projections as W x^T."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}")
    return _plain(x, desc, p_attn, num_heads, wo_acc=layout != "pad128",
                  transposed=layout == "transposed", eps=eps)


def pad_heads_128(p_attn):
    """The attention module's weights with every head zero-padded from 64
    to 128 columns, in the port's [out, in] layout: query / key / value
    [768, 768] -> [1536, 768] (and their biases), the output projection
    [768, 768] -> [768, 1536]. The port of ``pad_cols`` in
    scripts/bench_attn_block.py (JAX's [in, out] kernels pad their output
    columns, Wo its input rows). Returns an object that reads like the
    module (``.self.query.weight``, ...)."""
    ps, po = p_attn.self, p_attn.output
    H = ps.query.weight.shape[0] // HEAD_DIM

    def pad_out(lin):
        w = lin.weight.detach().reshape(H, HEAD_DIM, -1)
        w = torch.nn.functional.pad(w, (0, 0, 0, PAD_DIM - HEAD_DIM))
        b = torch.nn.functional.pad(lin.bias.detach().reshape(H, HEAD_DIM),
                                    (0, PAD_DIM - HEAD_DIM))
        return SimpleNamespace(weight=w.reshape(H * PAD_DIM, -1).contiguous(),
                               bias=b.reshape(-1).contiguous())

    wo = po.dense.weight.detach()
    wo = torch.nn.functional.pad(wo.reshape(wo.shape[0], H, HEAD_DIM),
                                 (0, PAD_DIM - HEAD_DIM))
    dense = SimpleNamespace(weight=wo.reshape(wo.shape[0], -1).contiguous(),
                            bias=po.dense.bias.detach())
    return SimpleNamespace(
        self=SimpleNamespace(query=pad_out(ps.query), key=pad_out(ps.key),
                             value=pad_out(ps.value)),
        output=SimpleNamespace(dense=dense, LayerNorm=po.LayerNorm))


def _launch(name, fn, x, desc, weights, code_arg, eps, width, need_ctx,
            need_pre):
    """Allocate the projections (and the context and the fp32
    pre-LayerNorm sum where the probe keeps them) and launch the C entry
    point ``fn``: the output and the context (v where the probe keeps
    none)."""
    B, L, _ = x.shape
    q, k, v = (torch.empty(B, L, width, dtype=x.dtype, device=x.device)
               for _ in range(3))
    ctx = torch.empty_like(q) if need_ctx else None
    pre = torch.empty(x.shape, dtype=torch.float32, device=x.device) \
        if need_pre else None
    out = torch.empty_like(x)
    code = fn(x.data_ptr(), desc.data_ptr(), *(t.data_ptr() for t in weights),
              q.data_ptr(), k.data_ptr(), v.data_ptr(),
              None if ctx is None else ctx.data_ptr(),
              None if pre is None else pre.data_ptr(), out.data_ptr(), B, L,
              code_arg, eps, _build.stream(x.device))
    _build.check(code, name)
    return out, v if ctx is None else ctx


def probe_block(x, desc, p_attn, *, num_heads, softmax_mode, eps=1e-12,
                return_ctx=False):
    """The attention block with its softmax replaced (``softmax_mode`` in
    ``full``, ``none``, ``noshift``, ``skip``). x [B, L, 768], desc [B, 3]
    int32, p_attn the layer's ``attention`` module. A CPU tensor runs
    ``probe_block_plain``; a CUDA tensor launches the kernel (bf16, 32 <=
    L <= 256, L % 32 == 0) or raises. ``return_ctx``: (y, ctx), ctx the
    [B, L, 768] context that enters the output projection (v under
    ``skip``), so that a check can hold the attention itself."""
    if softmax_mode not in SOFTMAX_MODES:
        raise ValueError(f"probe_block: softmax_mode {softmax_mode!r}")
    if x.device.type == "cpu":
        return probe_block_plain(x, desc, p_attn, num_heads=num_heads,
                                 softmax_mode=softmax_mode, eps=eps,
                                 return_ctx=return_ctx)
    weights = _weights(p_attn)
    check_inputs("probe_block", x, desc, weights, num_heads,
                 products=BLOCK_PRODUCTS)
    out, ctx = _launch("probe_block", _build.library().unimm_probe_block, x,
                       desc, weights, SOFTMAX_MODES[softmax_mode], eps, HID,
                       need_ctx=softmax_mode != "skip", need_pre=True)
    probe_block.launches += 1
    return (out, ctx) if return_ctx else out


def layout_probe_block(x, desc, p_attn, *, num_heads, layout, eps=1e-12):
    """The attention block under another layout (``layout`` in
    ``wo_acc``, ``transposed``, ``pad128``; for ``pad128`` p_attn comes from
    ``pad_heads_128``). A CPU tensor runs ``layout_probe_block_plain``; a
    CUDA tensor launches the kernel or raises."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout_probe_block: layout {layout!r}")
    if x.device.type == "cpu":
        return layout_probe_block_plain(x, desc, p_attn, num_heads=num_heads,
                                        layout=layout, eps=eps)
    weights = _weights(p_attn)
    pad = layout == "pad128"
    width = num_heads * PAD_DIM if pad else HID
    # pad128's Q/K/V products are [1536, 768], its output [768, 1536]
    check_inputs("layout_probe_block", x, desc, weights, num_heads, width,
                 products=((width, HID), (HID, width)))
    out, _ = _launch("layout_probe_block",
                     _build.library().unimm_layout_probe_block, x, desc,
                     weights, LAYOUTS[layout], eps, width, need_ctx=pad,
                     need_pre=pad)
    layout_probe_block.launches += 1
    return out


probe_block.launches = 0
layout_probe_block.launches = 0

# the probes' own kernels, by the index unimm_block_probe_info takes
PROBE_KERNELS = ("probe_attn_kernel none", "probe_attn_kernel noshift",
                 "probe_attn_kernel pad128", "wo_acc_wg_kernel wo_acc",
                 "wo_acc_wg_kernel transposed")


def kernel_info(L=256):
    """{kernel: registers, local bytes (stack and spills), dynamic shared
    memory and CTAs an SM at length L} of each of the probes' own kernels
    (``text_attention.fwd_kernel_info``'s fields); ``full`` launches B4's
    attention, whose instance ``attention_block.kernel_info`` reports."""
    return {name: _build.kernel_info("unimm_block_probe_info", L, i)
            for i, name in enumerate(PROBE_KERNELS)}
