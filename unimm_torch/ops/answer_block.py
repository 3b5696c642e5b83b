"""Fused answer-rows attention block of the prefix-cache scorer.

``answer_block`` replaces the TPU kernel
``unimm_tpu/ops/pallas_prefix.py:fused_answer_block``: one BERT attention
sub-block (QKV projection of the answer rows, scores against the cached
context K/V followed by the row block's own K/V, additive biases, fp32
softmax, PV, head merge, output projection, residual, LayerNorm). On a CUDA
tensor it launches the hand-written kernel in ``csrc/answer_block.cu``
(four launches: the Q/K/V projection and the output projection on the
wgmma + TMA core of ``csrc/gemm_wg.cuh``, between them a one-pass
attention per (64 query rows, head, slate) that skips the key chunks
``answer_chunk_table`` closes, then the row LayerNorm); on a CPU tensor it
runs ``answer_block_plain``, which repeats the kernel's arithmetic and
rounding points in plain PyTorch.

The attention masks arrive as two layer-independent additive fp32 biases:

* ``b_ctx`` [G, 1, Lcb]: context columns open on [1, lc);
* ``b_rr`` [G, PB, RB, RB]: the block-diagonal row->row bias (an option's
  rows attend only its own rows; first copy causal, masked copy strictly
  before i - A, self always open).

``answer_chunk_table`` reads both once per dispatch into the kernel's
per-(16 query rows, 64-key chunk) states, which every layer reuses.
"""

from __future__ import annotations

import math

import torch

from unimm_torch.ops import _build
from unimm_torch.ops.masks import KEY_CHUNK, NEG_INF, ROW_TILE
from unimm_torch.utils import trace

HID = 768        # the width the CUDA kernel is built for
HEAD_DIM = 64
MAX_KEYS = 4 * KEY_CHUNK   # the kernel's largest RB and Lcb

# the states of answer_chunk_table
CHUNK_CLOSED, CHUNK_OPEN, CHUNK_MIXED = 0, 1, 2


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


def answer_chunk_table(b_ctx, b_rr):
    """uint8 [G, PB, RB / ROW_TILE, NC]: the state of each KEY_CHUNK-key
    chunk for each ROW_TILE query rows of a row block, the attention
    kernel's skip rule (csrc/answer_block.cu), on the device of the biases
    (also its CPU twin). The keys are the context's, in ceil(Lcb / 64)
    chunks (the last one's keys past Lcb are padding), then the row
    block's RB (a multiple of ROW_TILE) in ceil(RB / 64) chunks (the last
    one's keys past RB are padding), NC in all.

    * CHUNK_CLOSED: every bias of the chunk is <= NEG_INF for every row of
      the tile, and each of those rows has a key whose bias is above
      NEG_INF: the kernel skips the chunk. Exact, since such a row's max
      comes from a bias-0 key, so each masked key weighs exp(s - 10000 -
      max) = 0 in fp32. A row whose biases close every key takes its
      softmax over all of them (at s - 10000), so it closes no chunk.
    * CHUNK_OPEN: 64 real keys, every bias 0 for every row: no bias read.
    * CHUNK_MIXED: the rest; the kernel adds the bias (padding keys -inf).
    """
    G, PB, RB, _ = b_rr.shape
    Lcb = b_ctx.shape[-1]
    KC, RT = KEY_CHUNK, ROW_TILE
    if RB % RT:
        raise ValueError(f"answer_chunk_table: RB={RB} is not a multiple "
                         f"of {RT}")
    CC, NR = -(-Lcb // KC), -(-RB // KC)
    bc = torch.nn.functional.pad(b_ctx.reshape(G, Lcb).float(),
                                 (0, CC * KC - Lcb), value=float("-inf"))
    real = (torch.arange(CC * KC, device=bc.device) < Lcb).reshape(CC, KC)
    bc = bc.reshape(G, CC, KC)
    ctx_closed = (bc <= NEG_INF).all(-1)                     # [G, CC]
    ctx_open = ((bc == 0) & real).all(-1)
    br = torch.nn.functional.pad(b_rr.float(), (0, NR * KC - RB),
                                 value=float("-inf"))
    br = br.reshape(G, PB, RB // RT, RT, NR, KC)
    real_r = (torch.arange(NR * KC, device=bc.device) < RB).reshape(NR, KC)
    rr_closed = (br <= NEG_INF).all(-1)                      # [.., RT, NR]
    # a row with a key above NEG_INF anywhere
    has_key = (~rr_closed).any(-1) | (~ctx_closed).any(-1)[:, None, None,
                                                             None]
    closed = torch.cat([
        ctx_closed[:, None, None, None, :].expand(G, PB, RB // RT, RT, CC),
        rr_closed], -1) & has_key[..., None]
    opened = torch.cat([
        ctx_open[:, None, None, :].expand(G, PB, RB // RT, CC),
        ((br == 0) & real_r).all(-1).all(3)], -1)
    state = torch.where(closed.all(3), CHUNK_CLOSED,
                        torch.where(opened, CHUNK_OPEN, CHUNK_MIXED))
    return state.to(torch.uint8).contiguous()


def _weights(p_attn):
    ps, po = p_attn.self, p_attn.output
    return (ps.query.weight, ps.query.bias, ps.key.weight, ps.key.bias,
            ps.value.weight, ps.value.bias, po.dense.weight, po.dense.bias,
            po.LayerNorm.weight, po.LayerNorm.bias)


def answer_block_plain(x, kc, vc, b_ctx, b_rr, p_attn, *, num_heads,
                       eps=1e-12, return_ctx=False):
    """Plain PyTorch version of the kernel, with its rounding points:
    projections accumulate in fp32 and round to x.dtype after the bias; q
    is scaled in fp32 and rounded; scores and softmax are fp32; the
    probabilities and each head's context round to x.dtype; the output
    projection, bias, residual and LayerNorm run in fp32. Under
    ``return_ctx`` also the merged per-head context [G, P, Hd]."""
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
    y = (y * gamma.float() + beta.float()).to(dt)
    return (y, ctx) if return_ctx else y


def _require(cond, msg):
    if not cond:
        raise ValueError(f"answer_block: {msg}")


def answer_block(x, kc, vc, b_ctx, b_rr, p_attn, *, num_heads, eps=1e-12,
                 table=None, return_ctx=False):
    """LayerNorm(x + Wo . attention(rows x, keys [kc ; row K], values
    [vc ; row V]) + bo) for packed answer rows.

    x [G, P, 768]; kc, vc [G, Lcb, 768] (the cached context projected by
    the layer's key/value Linear); b_ctx [G, 1, Lcb] fp32; b_rr [G, PB, RB,
    RB] fp32 with PB * RB == P; p_attn the layer's ``attention`` module in
    the compute dtype; ``table`` ``answer_chunk_table(b_ctx, b_rr)``, built
    here when not given (the scorer builds it once per dispatch). Under
    ``return_ctx`` also the merged per-head context [G, P, 768]. A CPU
    tensor runs ``answer_block_plain``; a CUDA tensor launches the kernel
    (bf16 activations and weights) or raises.

    The kernel takes the row blocks and context buckets of the JAX
    package's kernel up to 256: RB any multiple of 16 in [16, 256] (the
    packed layout's fixed or per-group row block, the W layout's
    ``pick_o_blk(O, W) * W``) and Lcb any even length in [2, 256]. Route:
    the table and the kernel take 16-row tails, with no padding copied.
    A row block is ceil(RB / 64) CTAs of 64 query rows, the last one short
    by a multiple of 16 rows (its warps past the block take every chunk as
    CLOSED and store nothing), and the row block's last key chunk holds
    its keys past RB as padding, at -inf, which the table never calls
    OPEN: each weighs exp(-inf) = 0, and a real row keeps its open keys.
    The kernel has an instance for such tails and one for RB a multiple
    of 64, which carries no row count or guard; the launch picks it from
    RB.
    RB > 256 or Lcb > 256 (a fixed ``row_block`` above 256 or a
    ``max_seq_len`` above 256) raises ``ValueError``.
    """
    if x.device.type == "cpu":
        return answer_block_plain(x, kc, vc, b_ctx, b_rr, p_attn,
                                  num_heads=num_heads, eps=eps,
                                  return_ctx=return_ctx)
    weights = _weights(p_attn)
    G, P, Hd = x.shape
    _require(Hd == HID and Hd // num_heads == HEAD_DIM,
             f"kernel is built for width {HID} in heads of {HEAD_DIM}, got "
             f"{Hd} / {num_heads}")
    _require(b_rr.dim() == 4 and b_rr.shape[0] == G
             and b_rr.shape[2] == b_rr.shape[3], f"b_rr {tuple(b_rr.shape)}")
    PB, RB = b_rr.shape[1], b_rr.shape[2]
    Lcb = kc.shape[1]
    _require(PB * RB == P and RB % ROW_TILE == 0
             and ROW_TILE <= RB <= MAX_KEYS,
             f"P={P} must be PB*RB with RB a multiple of {ROW_TILE} in "
             f"[{ROW_TILE}, {MAX_KEYS}] (RB={RB})")
    _require(Lcb % 2 == 0 and 2 <= Lcb <= MAX_KEYS,
             f"Lcb={Lcb} must be even in [2, {MAX_KEYS}]")
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
    if table is None:
        table = answer_chunk_table(b_ctx, b_rr)
    NC = -(-Lcb // KEY_CHUNK) + -(-RB // KEY_CHUNK)
    _require(table.dtype == torch.uint8
             and tuple(table.shape) == (G, PB, RB // ROW_TILE, NC),
             f"table must be answer_chunk_table's uint8 [{G}, {PB}, "
             f"{RB // ROW_TILE}, {NC}], got {table.dtype} "
             f"{tuple(table.shape)}")
    for t in (x, kc, vc, b_ctx, b_rr, table) + weights:
        _require(t.device == x.device, "all tensors on one device")
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 "inputs must be contiguous and 16-byte aligned")
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    with trace.span("op.answer_block"):
        lib = _build.library()
        q, k, v, ctx, out = (torch.empty_like(x) for _ in range(5))
        pre = torch.empty(G, P, Hd, dtype=torch.float32, device=x.device)
        code = lib.unimm_answer_block(
            x.data_ptr(), kc.data_ptr(), vc.data_ptr(), b_ctx.data_ptr(),
            b_rr.data_ptr(), table.data_ptr(),
            *(t.data_ptr() for t in weights), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), ctx.data_ptr(), pre.data_ptr(), out.data_ptr(), G, P,
            Lcb, RB, eps, _build.stream(x.device))
        _build.check(code, "answer_block")
        answer_block.launches += 1
    return (out, ctx) if return_ctx else out


def kernel_info(tail: bool = False) -> dict:
    """The attention launch's kernel (``answer_attn_kernel``, the instance
    for whole 64-row CTAs or, under ``tail``, the one with a short CTA a
    row block): registers and local memory bytes a thread, shared memory a
    CTA, CTAs an SM."""
    return _build.kernel_info("unimm_answer_block_info", int(tail))


answer_block.launches = 0
