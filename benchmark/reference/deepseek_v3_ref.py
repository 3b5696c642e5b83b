"""Plain DeepSeek-V3 decoder (Kimi-VL-A3B's language model) in PyTorch: the
benchmark's reference for the decoder configurations.

Written from Hugging Face's ``modeling_deepseek.py``: RMSNorm pre-norm
layers; multi-head latent attention with the full q projection (q_nope
128 + q_pe 64 a head), the compressed kv (``kv_a_proj_with_mqa``: c_kv 512,
normed by ``kv_a_layernorm``, and one shared RoPE key of 64) expanded per
head by ``kv_b_proj`` (k_nope 128, v 128); RoPE with theta from the
configuration, its features de-interleaved (even, then odd) before
rotate_half; softmax scale 1 / sqrt(192), the softmax in fp32; a dense
SwiGLU MLP in the first ``first_k_dense_replace`` layers, then the MoE:
sigmoid scores of the router's logits, the top k chosen by score +
``e_score_correction_bias`` (noaux_tc, one group), the chosen scores
normalised and times ``routed_scaling_factor``, each expert's SwiGLU
output weighted, plus the shared experts (one SwiGLU of width
moe_intermediate_size x n_shared_experts); the final RMSNorm and the untied
LM head. It imports nothing of the program.

The reference runs the full causal forward of every sequence, whole, with
no cache, in float32 with TF32 off (``Precision("fp32")``;
``Precision("fp8")`` rounds the operands of every product to fp8 under
per-tensor scales, as ``vilbert_ref``'s control does: the check's
control). ``routes``: the experts a program chose, per
MoE layer and position; the reference then weights those experts with its
own fp32 scores (so that a choice flipped by rounding at a near-tie does
not enter the likelihoods), and reports where its own choice differs
(``flips``) and by how much its own k-th choice score beats the lowest of
the given experts' (``route_gap``).

Weights: every tensor is drawn by itself from (seed, name) (``draw``;
the generator's seed a 64-bit FNV-1a hash of the two): normal(0, init_std), RMSNorm scales 1 + normal(0, init_std),
``e_score_correction_bias`` normal(0, ``bias_std``) in fp32; every other
tensor rounded to bf16, the published dtype, and used in fp32. So any layer
can be made alone (``Weights`` draws each tensor when asked), and a program
handed the same tensors holds the same weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["Precision", "param_shapes", "draw", "Weights", "route",
           "route_weights", "forward", "log_probs", "ll_sum"]


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------

def _fp8(t, dtype=torch.float8_e4m3fn):
    """``t`` rounded to an fp8 format under a per-tensor scale that maps
    its largest magnitude to the format's largest value."""
    top = torch.finfo(dtype).max
    amax = t.abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return (t * scale).to(dtype).to(t.dtype) / scale


class Precision:
    """How the reference multiplies: "fp32" (exact fp32, no TF32) or "fp8"
    (the operands of every product rounded to e4m3: the control)."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"precision {kind!r}")
        self.kind = kind

    def mm(self, a, b):
        if self.kind == "fp8":
            return torch.matmul(_fp8(a), _fp8(b))
        return torch.matmul(a, b)


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _moe(cfg, i):
    return i >= cfg["first_k_dense_replace"]


def param_shapes(cfg: dict):
    """[(name, shape)] of every tensor of the language model, in Hugging
    Face's state_dict names."""
    H, V = cfg["hidden_size"], cfg["vocab_size"]
    nh = cfg["num_attention_heads"]
    dq = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    R = cfg["kv_lora_rank"]
    out = [("model.embed_tokens.weight", (V, H))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        out += [(p + "input_layernorm.weight", (H,)),
                (p + "post_attention_layernorm.weight", (H,)),
                (p + "self_attn.q_proj.weight", (nh * dq, H)),
                (p + "self_attn.kv_a_proj_with_mqa.weight",
                 (R + cfg["qk_rope_head_dim"], H)),
                (p + "self_attn.kv_a_layernorm.weight", (R,)),
                (p + "self_attn.kv_b_proj.weight",
                 (nh * (cfg["qk_nope_head_dim"] + cfg["v_head_dim"]), R)),
                (p + "self_attn.o_proj.weight", (H, nh * cfg["v_head_dim"]))]

        def mlp(pre, inter):
            return [(pre + "gate_proj.weight", (inter, H)),
                    (pre + "up_proj.weight", (inter, H)),
                    (pre + "down_proj.weight", (H, inter))]

        if _moe(cfg, i):
            E, Ie = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
            out += [(p + "mlp.gate.weight", (E, H)),
                    (p + "mlp.gate.e_score_correction_bias", (E,))]
            for e in range(E):
                out += mlp(f"{p}mlp.experts.{e}.", Ie)
            out += mlp(p + "mlp.shared_experts.",
                       Ie * cfg["n_shared_experts"])
        else:
            out += mlp(p + "mlp.", cfg["intermediate_size"])
    return out + [("model.norm.weight", (H,)), ("lm_head.weight", (V, H))]


def _name_seed(seed: int, name: str) -> int:
    """64-bit FNV-1a of "seed:name", cut to the generator's 63 bits."""
    h = 0xCBF29CE484222325
    for byte in f"{seed}:{name}".encode():
        h = ((h ^ byte) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h & 0x7FFFFFFFFFFFFFFF


def draw(cfg: dict, seed: int, name: str, shape, device) -> torch.Tensor:
    """The fp32 tensor ``name`` of run seed ``seed``: drawn from (seed,
    name) alone (the same bits on the same device whatever else is
    drawn), rounded to bf16 except the router's correction bias."""
    b = cfg["bench"]
    gen = torch.Generator(device=device)
    gen.manual_seed(_name_seed(seed, name))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if name.endswith("e_score_correction_bias"):
        return t.normal_(0.0, b["bias_std"], generator=gen)
    t.normal_(0.0, b["init_std"], generator=gen)
    if name.endswith("norm.weight"):
        t += 1.0
    return t.to(torch.bfloat16).float()


class Weights:
    """The seeded weights by name (``w[name]``, fp32), each drawn when
    asked and not kept."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.shapes = dict(param_shapes(cfg))

    def __getitem__(self, name):
        return draw(self.cfg, self.seed, name, self.shapes[name],
                    self.device)

    def items(self):
        for name in self.shapes:
            yield name, self[name]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x, pos, cfg):
    """RoPE of x [..., L, d] at positions pos [L]."""
    d = x.shape[-1]
    inv = 1.0 / (cfg["rope_theta"] ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = pos.float()[:, None] * inv[None, :]
    cos = torch.cat([ang, ang], -1).cos()
    sin = torch.cat([ang, ang], -1).sin()
    # modeling_deepseek: view (d / 2, 2), transpose, reshape
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(
        x.shape)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + rot * sin


def _attention(cfg, w, p, h, prec, block=8):
    """MLA, expanded, causal, over h [B, L, H]; sequences in blocks."""
    B, L, H = h.shape
    nh, dn, dr = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                  cfg["qk_rope_head_dim"])
    dv, R, eps = cfg["v_head_dim"], cfg["kv_lora_rank"], cfg["rms_norm_eps"]
    a = p + "self_attn."
    wq, wa = w[a + "q_proj.weight"], w[a + "kv_a_proj_with_mqa.weight"]
    wln, wb = w[a + "kv_a_layernorm.weight"], w[a + "kv_b_proj.weight"]
    wo = w[a + "o_proj.weight"]
    pos = torch.arange(L, device=h.device)
    causal = torch.ones(L, L, dtype=torch.bool, device=h.device).tril()
    out = torch.empty_like(h)
    for b0 in range(0, B, block):
        x = h[b0:b0 + block]
        n = x.shape[0]
        q = prec.mm(x, wq.t()).view(n, L, nh, dn + dr).transpose(1, 2)
        kva = prec.mm(x, wa.t())
        c = _rms(kva[..., :R], wln, eps)
        k_pe = _rope(kva[..., R:][:, None], pos, cfg)      # [n, 1, L, dr]
        kv = prec.mm(c, wb.t()).view(n, L, nh, dn + dv).transpose(1, 2)
        qq = torch.cat([q[..., :dn], _rope(q[..., dn:], pos, cfg)], -1)
        kk = torch.cat([kv[..., :dn], k_pe.expand(-1, nh, -1, -1)], -1)
        s = prec.mm(qq, kk.transpose(-1, -2)) / math.sqrt(dn + dr)
        s = s.masked_fill(~causal, float("-inf"))
        o = prec.mm(torch.softmax(s, -1), kv[..., dn:])   # [n, nh, L, dv]
        out[b0:b0 + block] = prec.mm(
            o.transpose(1, 2).reshape(n, L, nh * dv), wo.t())
    return out


def _swiglu(x, gate, up, down, prec):
    return prec.mm(F.silu(prec.mm(x, gate.t())) * prec.mm(x, up.t()),
                   down.t())


def route(cfg, w, p, h, prec):
    """noaux_tc at layer prefix ``p`` for rows h [N, H]: (the top-k experts
    [N, k] by score + correction bias, the sigmoid scores [N, E], the
    choice scores [N, E])."""
    m = p + "mlp.gate."
    scores = torch.sigmoid(prec.mm(h, w[m + "weight"].t()))
    choice = scores + w[m + "e_score_correction_bias"]
    return (torch.topk(choice, cfg["num_experts_per_tok"], dim=-1).indices,
            scores, choice)


def route_weights(cfg, scores, idx):
    """The weights [N, k] of experts ``idx``: their scores, normalised,
    times routed_scaling_factor."""
    wt = scores.gather(1, idx)
    if cfg["norm_topk_prob"]:
        wt = wt / (wt.sum(-1, keepdim=True) + 1e-20)
    return wt * cfg["routed_scaling_factor"]


def _moe_block(cfg, w, p, h, prec, forced, stats):
    """The MoE of rows h [N, H]; ``forced`` [N, k] the experts to use, or
    None for the reference's own choice."""
    m = p + "mlp."
    E = cfg["n_routed_experts"]
    own, scores, choice = route(cfg, w, p, h, prec)
    idx = own if forced is None else forced.long()
    if forced is not None:
        same = (own.sort(-1).values == idx.sort(-1).values).all(-1)
        gap = (choice.gather(1, own).min(-1).values
               - choice.gather(1, idx).min(-1).values).clamp(min=0)
        stats["flips"] += int((~same).sum())
        stats["route_gap"] = max(stats["route_gap"], float(gap.max()))
    stats["routed"] += idx.numel()
    wt = route_weights(cfg, scores, idx)
    out = torch.zeros_like(h)
    for e in range(E):
        hit = idx == e                                     # [N, k]
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        ex = f"{m}experts.{e}."
        y = _swiglu(h[rows], w[ex + "gate_proj.weight"],
                    w[ex + "up_proj.weight"], w[ex + "down_proj.weight"],
                    prec)
        out.index_add_(0, rows, (wt[rows] * hit[rows]).sum(-1)[:, None] * y)
    s = m + "shared_experts."
    return out + _swiglu(h, w[s + "gate_proj.weight"], w[s + "up_proj.weight"],
                         w[s + "down_proj.weight"], prec)


def forward(cfg: dict, w, embeds, lengths, prec: Precision, routes=None,
            stats=None):
    """The final norm's output [B, L, H] (fp32) of the causal forward of
    sequences embeds [B, L, H] whose first ``lengths`` [B] positions are
    real (the rest, after them, is padding that no real position sees).
    ``routes``: {layer: [B, L, k]} the experts to use at each MoE layer,
    or None; ``stats`` gathers flips, route_gap and routed."""
    _no_tf32()
    B, L, H = embeds.shape
    eps = cfg["rms_norm_eps"]
    real = torch.arange(L, device=embeds.device)[None, :] < lengths[:, None]
    if stats is None:
        stats = {}
    stats.setdefault("flips", 0)
    stats.setdefault("route_gap", 0.0)
    stats.setdefault("routed", 0)
    x = embeds.float()
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        x = x + _attention(cfg, w, p, _rms(x, w[p + "input_layernorm.weight"],
                                           eps), prec)
        h = _rms(x, w[p + "post_attention_layernorm.weight"], eps)
        if _moe(cfg, i):
            forced = None if routes is None else routes[i][real]
            y = torch.zeros_like(x)
            y[real] = _moe_block(cfg, w, p, h[real], prec, forced, stats)
        else:
            m = p + "mlp."
            y = _swiglu(h, w[m + "gate_proj.weight"], w[m + "up_proj.weight"],
                        w[m + "down_proj.weight"], prec)
        x = x + y
    return _rms(x, w["model.norm.weight"], eps)


def log_probs(w, hidden, labels, prec: Precision, block=256):
    """log p(labels [N]) under the LM head at rows hidden [N, H], fp32."""
    head = w["lm_head.weight"]
    out = []
    for r0 in range(0, hidden.shape[0], block):
        logits = prec.mm(hidden[r0:r0 + block], head.t())
        out.append(torch.log_softmax(logits, -1).gather(
            1, labels[r0:r0 + block, None].long())[:, 0])
    return torch.cat(out)


def ll_sum(cfg: dict, w, embeds, lengths, labels, prec: Precision,
           routes=None, stats=None):
    """Sum over positions of log p(labels[b, j] | positions <= j) for
    sequences embeds [B, L, H] (the first lengths[b] real) and labels
    [B, L] (-1: not scored): (ll_sum [B] fp32, stats)."""
    stats = {} if stats is None else stats
    h = forward(cfg, w, embeds, lengths, prec, routes, stats)
    at = (labels != -1).nonzero()
    lp = log_probs(w, h[at[:, 0], at[:, 1]], labels[at[:, 0], at[:, 1]],
                   prec)
    out = torch.zeros(embeds.shape[0], dtype=torch.float32,
                      device=embeds.device)
    out.index_add_(0, at[:, 0], lp)
    return out, stats
