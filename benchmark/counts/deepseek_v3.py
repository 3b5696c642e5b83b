"""The work the decoder cells' inputs need, as functions of the inputs
alone: matrix-product operations (2 m n k each) of the DeepSeek-V3 decoder
over real tokens (the context's image and text tokens once a slate, each
option's answer rows once, never padded rows), and the operations and
bytes of the grouped expert GEMM's launches, whose roofline is read.

Per token and layer: the attention projections (q, kv_a, kv_b, o), the
causal attention over its (query, key) pairs in the expanded form (q.k at
the q head width, p.v at the v width: 2 nh (dq + dv) a pair), and the MLP:
the dense SwiGLU, or the router, the k routed experts' SwiGLUs and the
shared experts' (no token is dropped: exactly tokens x k routed rows). The
LM head at every label row. Every function takes host numpy arrays and
the configuration dict, so it counts the same work whatever implements it.
"""

from __future__ import annotations

import numpy as np


def _attn_proj(cfg):
    H, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    dq = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    R, dr = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    dkv = cfg["qk_nope_head_dim"] + cfg["v_head_dim"]
    return 2 * H * (nh * dq + R + dr) + 2 * R * nh * dkv + \
        2 * nh * cfg["v_head_dim"] * H


def _pair(cfg):
    dq = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return 2 * cfg["num_attention_heads"] * (dq + cfg["v_head_dim"])


def _layers(cfg):
    n = cfg["num_hidden_layers"]
    dense = min(cfg["first_k_dense_replace"], n)
    return dense, n - dense


def mlp_products(cfg, tokens: int):
    """[(groups, rows, N, K, out width)] of the grouped GEMM's launches for
    ``tokens`` tokens through every layer: per dense layer its gate / up
    and down products, per MoE layer the routed experts' (tokens x k rows)
    and the shared experts' (tokens rows)."""
    H = cfg["hidden_size"]
    dense, moe = _layers(cfg)
    I, Ie = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    Is = Ie * cfg["n_shared_experts"]
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    out = []
    for n_layers, groups, rows, inter in ((dense, 1, tokens, I),
                                          (moe, E, tokens * k, Ie),
                                          (moe, 1, tokens, Is)):
        out += [(groups, rows, 2 * inter, H, inter)] * n_layers
        out += [(groups, rows, H, inter, H)] * n_layers
    return out


def token_flops(cfg, tokens: int) -> int:
    """Every layer's projections and MLP over ``tokens`` tokens, and the
    router (attention pairs apart)."""
    dense, moe = _layers(cfg)
    H, E = cfg["hidden_size"], cfg["n_routed_experts"]
    mlp = sum(2 * rows * n * k for _, rows, n, k, _ in
              mlp_products(cfg, tokens))
    return ((dense + moe) * _attn_proj(cfg) * tokens + mlp
            + moe * 2 * H * E * tokens)


def decoder_slates(cfg, batch):
    """Work of a [B, R, O] decoder slate batch on the prefix path: each
    slate's context (image tokens, then text) once, causal; each option's
    input rows (its answer tokens but the end token) against the context
    and its earlier rows; the LM head at each option's answer tokens and
    end token. Returns model_flops and the grouped GEMM's flops and bytes
    (``moe_gemm``)."""
    B, R, O, _ = batch["tokens"].shape
    ni = batch["image_len"].astype(np.int64)
    lc = batch["ctx_end"].astype(np.int64)[..., 0]           # [B, R]
    n_ctx = ni[:, None] + lc
    n = batch["ans_len"].astype(np.int64) - 1                # [B, R, O]
    ctx_tokens, rows = int(n_ctx.sum()), int(n.sum())
    layers = cfg["num_hidden_layers"]
    ctx_pairs = int((n_ctx * (n_ctx + 1) // 2).sum())
    # row r (from 0) of an option sees the context and rows 0 .. r
    ans_pairs = int((n * n_ctx[..., None] + n * (n + 1) // 2).sum())
    labels = rows + B * R * O
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"] * labels
    flops = (token_flops(cfg, ctx_tokens + rows)
             + layers * _pair(cfg) * (ctx_pairs + ans_pairs) + head)
    g_flops, g_bytes = moe_gemm(cfg, ctx_tokens)
    a_flops, a_bytes = moe_gemm(cfg, rows)
    return {"model_flops": flops, "moe_gemm_flops": g_flops + a_flops,
            "moe_gemm_bytes": g_bytes + a_bytes}


def moe_gemm(cfg, tokens: int):
    """(flops, bytes) of the grouped GEMM's launches of one pass over
    ``tokens`` tokens: 2 m n k over real rows; each launch reads its rows
    and every group's weights once and writes its output once (bf16; the
    down products' fp32 row weights too)."""
    flops = nbytes = 0
    for groups, rows, n, k, out in mlp_products(cfg, tokens):
        flops += 2 * rows * n * k
        nbytes += 2 * (rows * k + groups * n * k + rows * out)
        if out == cfg["hidden_size"] and groups > 1:
            nbytes += 4 * rows
    return flops, nbytes


COUNTERS = {"decoder_slates": decoder_slates}
