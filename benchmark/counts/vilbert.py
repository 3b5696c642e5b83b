"""The work the benchmark's inputs need, as functions of the inputs alone:
matrix-product operations (2 m n k each) of the ViLBERT / UniMM-UL model
over real tokens (never padded rows, never recomputed operations), and
the operations and bytes of the kernels whose rooflines are read. Every
function takes host numpy descriptors and the configuration dict, so it
counts the same work whatever implements it.
"""

from __future__ import annotations

import numpy as np


def _dims(cfg):
    return (cfg["hidden_size"], cfg["intermediate_size"],
            cfg["v_hidden_size"], cfg["v_intermediate_size"],
            cfg["bi_hidden_size"], cfg["max_regions"])


def text_layer(cfg, rows, pairs):
    """A text layer: Q/K/V and output projections, the FFN, and the two
    attention products over ``pairs`` open (row, key) pairs."""
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    return 8 * rows * H * H + 4 * rows * H * I + 4 * pairs * H


def vision_layer(cfg, rows):
    Hv, Iv = cfg["v_hidden_size"], cfg["v_intermediate_size"]
    return 8 * rows * Hv * Hv + 4 * rows * Hv * Iv + 4 * rows * rows * Hv


def conn_vision_side(cfg, v_rows, t_rows):
    """Regions attend text: q1, k2 / v2 over the text rows, the attention,
    dense1 and the region FFN."""
    H, _, Hv, Iv, Hb, _ = _dims(cfg)
    return (2 * v_rows * Hv * Hb + 4 * t_rows * H * Hb
            + 4 * v_rows * t_rows * Hb + 2 * v_rows * Hb * Hv
            + 4 * v_rows * Hv * Iv)


def conn_text_side(cfg, t_rows, v_rows, kv=True):
    """Text attends regions: q2, k1 / v1 over the regions (``kv``), the
    attention, dense2 and the text FFN."""
    H, I, Hv, _, Hb, _ = _dims(cfg)
    return (2 * t_rows * H * Hb + (4 * v_rows * Hv * Hb if kv else 0)
            + 4 * t_rows * v_rows * Hb + 2 * t_rows * Hb * H
            + 4 * t_rows * H * I)


def image_embed(cfg, rows):
    return 2 * rows * cfg["v_hidden_size"] * (cfg["v_feature_size"] + 5)


def label_head(cfg, n):
    H = cfg["hidden_size"]
    return n * (2 * H * H + 2 * H * cfg["vocab_size"])


def encoder(cfg, t_rows, t_pairs):
    """The whole two-stream encoder over one sequence of ``t_rows`` real
    tokens with ``t_pairs`` open text pairs, and the regions."""
    R = cfg["max_regions"]
    nc = len(cfg["t_biattention_id"])
    return (image_embed(cfg, R)
            + cfg["num_hidden_layers"] * text_layer(cfg, t_rows, t_pairs)
            + cfg["v_num_hidden_layers"] * vision_layer(cfg, R)
            + nc * (conn_vision_side(cfg, R, t_rows)
                    + conn_text_side(cfg, t_rows, R)))


def text_ffn_layers(cfg):
    """FFNs on the text side: every text layer's and every connection
    layer's text FFN."""
    return cfg["num_hidden_layers"] + len(cfg["t_biattention_id"])


# ---------------------------------------------------------------------------
# per workload item
# ---------------------------------------------------------------------------

def gen_slates(cfg, batch):
    """Work of a [B, R, O] generative slate batch on the prefix path: per
    slate the context prefill (the whole encoder over its context), per
    option its answer rows through the text side against the context and
    its own rows, and the label head at its labels. ``ffn_tokens``: the
    answer rows the text-side FFNs take."""
    L = batch["tokens"].shape[-1]
    ce = batch["ctx_end"].astype(np.int64)
    a = batch["ans_len"].astype(np.int64)
    lc = (ce - a)[..., 0]                                    # [B, R]
    n = np.clip(np.minimum(ce + a, L) - lc[..., None], 0, L)  # [B, R, O]
    R = cfg["max_regions"]
    nt, nc = cfg["num_hidden_layers"], len(cfg["t_biattention_id"])
    prefill = sum(encoder(cfg, int(x), int(x) * int(x)) for x in lc.ravel())
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    keys = lc[..., None] + a
    rows = int(n.sum())
    answer = (nt * (8 * rows * H * H + 4 * rows * H * I
                    + 4 * int((n * keys).sum()) * H)
              + nc * conn_text_side(cfg, rows, R, kv=False))
    labels = int((batch["mlm_labels"] != -1).sum())
    return {"model_flops": prefill + answer + label_head(cfg, labels),
            "ffn_tokens": rows * text_ffn_layers(cfg)}


def dis_slates(cfg, batch):
    """Work of a [B, R, O] discriminative slate batch on the flat path:
    the whole encoder over each option's real extent (its own regions
    included) and the NSP head. ``ffn_tokens`` as ``gen_slates``."""
    ext = batch["ctx_end"].astype(np.int64).ravel()
    flops = sum(encoder(cfg, int(x), int(x) * int(x)) for x in ext)
    Hb = cfg["bi_hidden_size"]
    flops += ext.size * (2 * cfg["hidden_size"] * Hb
                         + 2 * cfg["v_hidden_size"] * Hb + 4 * Hb)
    return {"model_flops": flops,
            "ffn_tokens": int(ext.sum()) * text_ffn_layers(cfg)}


def open_pairs(mode, ctx_end, ans_len, n):
    """Open (row, key) pairs of each sequence's text mask [N] (the
    descriptor's rule, as ``reference.vilbert_ref.text_mask``)."""
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    out = np.empty(len(mode), np.int64)
    for s, (m, L, A) in enumerate(zip(mode, ctx_end, ans_len)):
        L, A = int(L), int(A)
        if m == 0:
            out[s] = min(L, n) ** 2
            continue
        T, Lc = min(L + A, n), L - A
        gen = (((i == 0) & (j < T))
               | ((i >= 1) & (i < Lc) & (((j >= 1) & (j < Lc)) | (i == j)))
               | ((i >= Lc) & (i < L) & (j >= 1) & (j <= i))
               | ((i >= L) & (i < T) & (((j >= 1) & (j < i - A)) | (i == j))))
        out[s] = int(gen.sum())
    return out


def extents(mode, ctx_end, ans_len, n):
    return np.clip(np.where(mode == 0, ctx_end, ctx_end + ans_len), 1, n)


def train_batch(cfg, batch):
    """Work of one training step on a flat batch: the forward over each
    sequence's real extent, the label head at its labels, the region head
    at its masked regions, three times (forward and backward); and the
    text attention backward's work (``attn_bwd_flops`` / ``_bytes``): per
    layer, four products per head over the open pairs, and q, k, v, o, dO
    read and dq, dk, dv written at the real extents, in bf16."""
    n = batch["tokens"].shape[-1]
    mode = batch["mode"]
    ce, al = batch["ctx_end"], batch["ans_len"]
    ext = extents(mode, ce, al, n).astype(np.int64)
    pairs = open_pairs(mode, ce, al, n)
    fwd = sum(encoder(cfg, int(e), int(p)) for e, p in zip(ext, pairs))
    fwd += label_head(cfg, int((batch["mlm_labels"] != -1).sum()))
    Hv = cfg["v_hidden_size"]
    regions = int((batch["image_label"] == 1).sum())
    fwd += regions * (2 * Hv * Hv + 2 * Hv * cfg["v_target_size"])
    H, nt = cfg["hidden_size"], cfg["num_hidden_layers"]
    return {"model_flops": 3 * fwd,
            "attn_bwd_flops": nt * 8 * int(pairs.sum()) * H,
            "attn_bwd_bytes": nt * 8 * int(ext.sum()) * H * 2}


def ffn_act_bytes_per_launch(cfg):
    """The first FFN product's weight and bias, read once a launch."""
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    return (H * I + I) * 2


def ffn_act(cfg, tokens, launches):
    """(operations, bytes) of the FFN's first product with its bias and
    GELU over ``tokens`` real tokens in ``launches`` launches: x read and
    the activation written once, the weight once a launch, in bf16."""
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    return (2 * tokens * H * I,
            tokens * (H + I) * 2 + launches * ffn_act_bytes_per_launch(cfg))


# the eval cells' counters, by the name their workload file gives
COUNTERS = {"gen_slates": gen_slates, "dis_slates": dis_slates}
