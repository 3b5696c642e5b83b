"""The decoder's SwiGLU MLPs and its mixture-of-experts layer.

``moe_layer`` is one DeepSeek-V3 MoE block (models/deepseek_v3.py): the
router (``route``: sigmoid scores of fp32 logits, the top k chosen by
score + correction bias, ``noaux_tc`` with one group, the chosen scores
normalised and scaled), a stable sort of the (token, slot) rows by expert
(``plan``: per-expert counts, row offsets and row-tile offsets, all on the
device), one grouped product of every expert's gate and up weights with a
SwiGLU epilogue over its rows, one grouped down product that scales each
row by its router weight, and the combine: each token's k rows summed in
fp32 in slot order (a gather, no atomics). No token is dropped. The
shared experts are one SwiGLU MLP over every token (``swiglu_mlp``: the
same kernel as a single group over all rows), added to the routed sum;
the dense layers' MLPs run the same way.

On CUDA tensors the grouped products launch ``csrc/moe_gemm.cu`` (the
Hopper GEMM core's mainloop over a walk of (expert, row tile, column
tile)), or raise where the kernel cannot take them (not bf16, a width off
its tiles); on CPU tensors they run their plain versions
(``grouped_swiglu_plain``, ``grouped_down_plain``: fp32 products of each
expert's rows, the kernel's rounding points). Weights are held stacked:
``w13`` [G, 2I, H], the gate and up rows interleaved in blocks of
``gu_block(I)`` rows (``interleave_gate_up``), and ``w2`` [G, H, I].

Spans: ``op.moe`` around a layer, ``op.moe.route`` around its router.
Counters, while ``utils.trace`` records: ``moe.rows_routed`` (tokens x k,
known on the host) and ``moe.rows_max`` (the largest routed expert's rows,
a device count read when the recorder's counts are taken). Inside a
``utils.trace`` capture each layer keeps its choice as ``moe.route``
(uint8 [T, k], on the device).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from unimm_torch.ops import _build
from unimm_torch.utils import trace

GU_BLOCK = 128       # gate / up interleave: the kernel's half tile width
TILE_M = 128         # the kernel's row tile (gemm_wg_core.cuh WG_BM)
TILE_N = 256         # its column tile (WG_BN)
TILE_K = 64          # its k step (WG_BK)

__all__ = ["route", "plan", "routed_experts", "moe_layer", "swiglu_mlp",
           "grouped_swiglu", "grouped_down", "interleave_gate_up",
           "split_gate_up"]


def gu_block(inter: int) -> int:
    """Rows of a gate (or up) block in ``w13``: 128 where the width allows
    (the kernel's layout), else the largest divisor it shares with 128."""
    return math.gcd(inter, GU_BLOCK)


def interleave_gate_up(gate, up):
    """[..., I, H] gate and up weights as one [..., 2I, H]: blocks of
    ``gu_block(I)`` gate rows, then the same up rows, alternating."""
    *lead, inter, hid = gate.shape
    b = gu_block(inter)
    g = gate.reshape(*lead, inter // b, 1, b, hid)
    u = up.reshape(*lead, inter // b, 1, b, hid)
    return torch.cat([g, u], -3).reshape(*lead, 2 * inter, hid)


def split_gate_up(w13):
    """The gate and up weights [..., I, H] of an interleaved ``w13``."""
    *lead, two_i, hid = w13.shape
    inter = two_i // 2
    b = gu_block(inter)
    v = w13.reshape(*lead, inter // b, 2, b, hid)
    return (v[..., 0, :, :].reshape(*lead, inter, hid),
            v[..., 1, :, :].reshape(*lead, inter, hid))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def route(x, gate_weight, bias, *, top_k: int, scale: float,
          normalise: bool = True):
    """noaux_tc routing of rows x [T, H]: (idx [T, k] int64, the experts
    by chosen score, highest first; weight [T, k] fp32). Logits in fp32,
    scores their sigmoid, the choice by score + ``bias``, the weights the
    chosen scores (normalised to sum 1) times ``scale``."""
    with trace.span("op.moe.route"):
        scores = (x.float() @ gate_weight.float().t()).sigmoid()
        idx = torch.topk(scores + bias.float(), top_k, dim=-1)[1]
        w = scores.gather(1, idx)
        if normalise and top_k > 1:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return idx, w * scale


def plan(idx, n_experts: int):
    """The rows of ``idx`` [T, k] sorted by expert: (order [T k], the
    flat (token, slot) index of each sorted row, stable; counts [E];
    row_off, tile_off [E + 1] int32: each expert's first sorted row and
    first row tile of 128)."""
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    # the experts' first rows by a search of the sorted choices: no count
    # the host has to wait for (bincount reads the largest id back)
    first = torch.searchsorted(flat.index_select(0, order),
                               torch.arange(n_experts + 1,
                                            device=idx.device))
    counts = first.diff()
    return (order, counts) + offsets(counts)


def offsets(counts):
    """(row_off, tile_off) [G + 1] int32 of per-group row ``counts``."""
    z = counts.new_zeros(1)
    row_off = torch.cat([z, torch.cumsum(counts, 0)]).to(torch.int32)
    tiles = torch.div(counts + TILE_M - 1, TILE_M, rounding_mode="floor")
    tile_off = torch.cat([z, torch.cumsum(tiles, 0)]).to(torch.int32)
    return row_off, tile_off


# ---------------------------------------------------------------------------
# grouped products
# ---------------------------------------------------------------------------

def grouped_swiglu_plain(a, w13, row_off):
    """out [M, I] = silu(gate) * up of each group's rows of ``a`` under its
    ``w13`` [G, 2I, H], in fp32, rounded to a.dtype."""
    off = [int(v) for v in row_off.tolist()]
    out = a.new_empty(a.shape[0], w13.shape[1] // 2)
    for g in range(w13.shape[0]):
        r0, r1 = off[g], off[g + 1]
        if r1 > r0:
            gate, up = split_gate_up(w13[g].float())
            x = a[r0:r1].float()
            out[r0:r1] = (F.silu(x @ gate.t()) * (x @ up.t())).to(a.dtype)
    return out


def grouped_down_plain(h, w2, row_off, scale=None):
    """out [M, H] = (each group's rows of ``h`` @ w2[g].T) * ``scale`` [M]
    (fp32; None: 1), rounded to h.dtype."""
    off = [int(v) for v in row_off.tolist()]
    out = h.new_empty(h.shape[0], w2.shape[1])
    for g in range(w2.shape[0]):
        r0, r1 = off[g], off[g + 1]
        if r1 > r0:
            y = h[r0:r1].float() @ w2[g].float().t()
            if scale is not None:
                y = y * scale[r0:r1, None]
            out[r0:r1] = y.to(h.dtype)
    return out


def _require(cond, msg):
    if not cond:
        raise ValueError(f"moe: {msg}")


def takes(a, w) -> bool:
    """Whether the kernel takes rows ``a`` [M, K] under stacked weights
    ``w`` [G, N, K]: CUDA bf16, N a multiple of 256, K of 64."""
    return (a.device.type == "cuda" and a.dtype == torch.bfloat16
            and w.dtype == torch.bfloat16 and w.shape[1] % TILE_N == 0
            and w.shape[2] % TILE_K == 0 and a.shape[0] > 0)


def _check(a, w, row_off, tile_off):
    G, N, K = w.shape
    _require(a.dim() == 2 and a.shape[1] == K, f"rows {tuple(a.shape)} "
             f"against weights {tuple(w.shape)}")
    _require(takes(a, w), f"the kernel takes CUDA bf16 rows and weights "
             f"with N % {TILE_N} == 0 and K % {TILE_K} == 0, got "
             f"{a.dtype} {tuple(w.shape)}")
    for t in (row_off, tile_off):
        _require(t.dtype == torch.int32 and t.numel() == G + 1
                 and t.device == a.device, "offsets: int32 [G + 1] on "
                 "the rows' device")
    for t in (a, w, row_off, tile_off):
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 "inputs must be contiguous and 16-byte aligned")


def grouped_swiglu(a, w13, row_off, tile_off):
    """``grouped_swiglu_plain`` on the kernel (CUDA), plain on the CPU."""
    if a.device.type == "cpu":
        return grouped_swiglu_plain(a, w13, row_off)
    _check(a, w13, row_off, tile_off)
    G, N, K = w13.shape
    _require(N // 2 % GU_BLOCK == 0, f"width {N // 2} not a multiple of "
             f"{GU_BLOCK}")
    out = torch.empty(a.shape[0], N // 2, dtype=a.dtype, device=a.device)
    code = _build.library().unimm_moe_swiglu(
        a.data_ptr(), w13.data_ptr(), row_off.data_ptr(),
        tile_off.data_ptr(), out.data_ptr(), a.shape[0], G, N, K,
        _build.stream(a.device))
    _build.check(code, "moe_swiglu")
    grouped_swiglu.launches += 1
    return out


def grouped_down(h, w2, row_off, tile_off, scale=None):
    """``grouped_down_plain`` on the kernel (CUDA), plain on the CPU."""
    if h.device.type == "cpu":
        return grouped_down_plain(h, w2, row_off, scale)
    _check(h, w2, row_off, tile_off)
    G, N, K = w2.shape
    if scale is not None:
        _require(scale.dtype == torch.float32 and scale.is_contiguous()
                 and scale.numel() == h.shape[0], "scale: fp32 [M]")
    out = torch.empty(h.shape[0], N, dtype=h.dtype, device=h.device)
    code = _build.library().unimm_moe_down(
        h.data_ptr(), w2.data_ptr(), row_off.data_ptr(),
        tile_off.data_ptr(), 0 if scale is None else scale.data_ptr(),
        out.data_ptr(), h.shape[0], G, N, K, _build.stream(h.device))
    _build.check(code, "moe_down")
    grouped_down.launches += 1
    return out


grouped_swiglu.launches = 0
grouped_down.launches = 0


def kernel_info(mode: int) -> dict:
    """Registers, local bytes, shared memory and CTAs an SM of the grouped
    kernel's instance ``mode`` (0 SwiGLU, 1 the scaled down product)."""
    return _build.kernel_info("unimm_moe_info", mode)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def swiglu_mlp(x, w13, w2):
    """down(silu(gate x) * up x) of rows x [T, H] under one MLP's stacked
    ``w13`` [1, 2I, H] and ``w2`` [1, H, I]; [T, H] in x.dtype."""
    T = x.shape[0]
    counts = torch.full((1,), T, dtype=torch.long, device=x.device)
    row_off, tile_off = offsets(counts)
    h = grouped_swiglu(x, w13, row_off, tile_off)
    return grouped_down(h, w2, row_off, tile_off)


def routed_experts(x, idx, w, w13, w2):
    """The routed experts' weighted sum, fp32 [T, H], of rows x [T, H]
    sent to experts ``idx`` [T, k] with weights ``w`` [T, k] (fp32): the
    rows sorted by expert, the two grouped products, and each token's k
    rows summed in slot order."""
    T, k = idx.shape
    order, counts, row_off, tile_off = plan(idx, w13.shape[0])
    if trace.recording():
        trace.count("moe.rows_routed", T * k)
        trace.count_device("moe.rows_max", counts.max())
    a = x.index_select(0, torch.div(order, k, rounding_mode="floor"))
    h = grouped_swiglu(a, w13, row_off, tile_off)
    y = grouped_down(h, w2, row_off, tile_off,
                     w.reshape(-1).index_select(0, order).contiguous())
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=x.device)
    return y.index_select(0, inv).view(T, k, -1).sum(1, dtype=torch.float32)


def moe_layer(x, p: dict, *, top_k: int, scale: float):
    """One MoE block on rows x [T, H] (the post-attention norm's output):
    fp32 [T, H], the routed experts' weighted sum plus the shared experts.
    ``p``: gate_weight [E, H], e_score_correction_bias [E], w13 [E, 2I, H],
    w2 [E, H, I], shared_w13, shared_w2."""
    with trace.span("op.moe"):
        idx, w = route(x, p["gate_weight"], p["e_score_correction_bias"],
                       top_k=top_k, scale=scale)
        if trace.capturing():
            trace.keep("moe.route", idx.to(torch.uint8))
        routed = routed_experts(x, idx, w, p["w13"], p["w2"])
        routed += swiglu_mlp(x, p["shared_w13"], p["shared_w2"])
        return routed
