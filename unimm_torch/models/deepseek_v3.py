"""The DeepSeek-V3 decoder (Kimi-VL-A3B's language model) for ranking by
log-likelihood: multi-head latent attention (MLA) and a mixture of experts.

Follows Hugging Face's ``modeling_deepseek.py``: pre-norm layers (RMSNorm),
MLA with the full q projection (no q low-rank): q [nh, 128 + 64] from
``q_proj``; the compressed kv, c_kv [512] (after ``kv_a_layernorm``), and
one RoPE key k_pe [64] shared by the heads, from ``kv_a_proj_with_mqa``;
``kv_b_proj`` expands c_kv into each head's k_nope [128] and v [128]. RoPE
de-interleaves its 64 features (even, then odd) before ``rotate_half``;
the softmax scale is 1 / sqrt(192); the softmax runs in fp32. The first
``first_k_dense_replace`` layers have a dense SwiGLU MLP, the rest the MoE
of ``ops/moe.py`` (router logits in fp32). A final RMSNorm, then the
untied LM head.

``DecoderModel`` holds the weights as the kernels take them: the experts
stacked (``w13`` [E, 2I, H] with gate and up interleaved, ``w2`` [E, H,
I]), the shared experts and the dense MLP as one-group stacks. It loads
Hugging Face state_dict names (``model.layers.{i}.self_attn.q_proj.weight``,
``...mlp.experts.{e}.gate_proj.weight``,
``...mlp.gate.e_score_correction_bias``, ``lm_head.weight``, ...) one tensor
at a time (``load``), mapping each into its slot.

Residual sums are kept in fp32; every product's inputs are the weights'
dtype. Two attention forms share the per-layer latent cache, cat(c_kv,
k_pe) [576] a position (``CACHE_DIM``):

* ``mla_expanded`` (prefill, and the full forward): k and v expanded per
  head, causal attention over whole padded sequences;
* ``mla_absorbed`` (the scorer's answer rows): W_uk folded into the query
  (q_nope W_uk: a 512-wide query per head) and W_uv applied after the
  attention, so the rows attend the cache as it is stored, then their own
  option's earlier rows (``ops/mla_answer.py``: one kernel a layer on the
  card).

Spans: ``op.mla_prefill`` and ``op.mla_answer`` around the attention of a
layer (projections included), ``op.moe`` / ``op.moe.route`` inside the
MoE.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List

import torch
import torch.nn.functional as F

from unimm_torch.config import DeepseekV3Config
from unimm_torch.ops import moe as moe_ops
from unimm_torch.ops import mla_answer as mla_ops
from unimm_torch.utils import trace


def cache_dim(cfg: DeepseekV3Config) -> int:
    return cfg.kv_lora_rank + cfg.qk_rope_head_dim


class DecoderModel:
    """The decoder's weights in the kernels' layout (see the module
    docstring). ``layers[i]`` is a dict: ``ln1``, ``ln2``, ``q``, ``kv_a``,
    ``kv_a_ln``, ``kv_b``, ``o``, and ``w13`` / ``w2`` (dense) or
    ``gate_weight``, ``e_score_correction_bias``, ``w13``, ``w2``,
    ``shared_w13``, ``shared_w2`` (MoE)."""

    def __init__(self, cfg: DeepseekV3Config, device, dtype=torch.bfloat16):
        self.cfg = cfg
        self.dtype = dtype
        H, V, nh = cfg.hidden_size, cfg.vocab_size, cfg.num_attention_heads

        def e(*shape, dt=dtype):
            return torch.empty(shape, dtype=dt, device=device)

        self.embed = e(V, H)
        self.norm = e(H)
        self.lm_head = e(V, H)
        self.layers: List[Dict[str, torch.Tensor]] = []
        for i in range(cfg.num_hidden_layers):
            lay = dict(
                ln1=e(H), ln2=e(H), q=e(nh * cfg.q_head_dim, H),
                kv_a=e(cache_dim(cfg), H), kv_a_ln=e(cfg.kv_lora_rank),
                kv_b=e(nh * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                       cfg.kv_lora_rank),
                o=e(H, nh * cfg.v_head_dim))
            if cfg.is_moe(i):
                Ie, Is = cfg.moe_intermediate_size, (
                    cfg.moe_intermediate_size * cfg.n_shared_experts)
                E = cfg.n_routed_experts
                lay.update(gate_weight=e(E, H),
                           e_score_correction_bias=e(E, dt=torch.float32),
                           w13=e(E, 2 * Ie, H), w2=e(E, H, Ie),
                           shared_w13=e(1, 2 * Is, H), shared_w2=e(1, H, Is))
            else:
                I = cfg.intermediate_size
                lay.update(w13=e(1, 2 * I, H), w2=e(1, H, I))
            self.layers.append(lay)

    # -- loading --------------------------------------------------------
    _ATTN = {"input_layernorm.weight": "ln1",
             "post_attention_layernorm.weight": "ln2",
             "self_attn.q_proj.weight": "q",
             "self_attn.kv_a_proj_with_mqa.weight": "kv_a",
             "self_attn.kv_a_layernorm.weight": "kv_a_ln",
             "self_attn.kv_b_proj.weight": "kv_b",
             "self_attn.o_proj.weight": "o",
             "mlp.gate.weight": "gate_weight",
             "mlp.gate.e_score_correction_bias": "e_score_correction_bias"}
    _NAME = re.compile(r"model\.layers\.(\d+)\.(.+)$")
    _EXPERT = re.compile(r"mlp\.experts\.(\d+)\.(gate|up|down)_proj\.weight$")
    _MLP = re.compile(r"mlp\.(shared_experts\.)?(gate|up|down)_proj\.weight$")

    def _mlp_slot(self, lay, stack, e, kind, t):
        if kind == "down":
            lay[stack + "w2"][e].copy_(t)
            return
        w13 = lay[stack + "w13"][e]
        inter = w13.shape[0] // 2
        b = moe_ops.gu_block(inter)
        v = w13.view(inter // b, 2, b, -1)
        v[:, 0 if kind == "gate" else 1].copy_(t.reshape(inter // b, b, -1))

    def load(self, name: str, t: torch.Tensor):
        """Copy the Hugging Face tensor ``name`` into its slot (cast to the
        slot's dtype)."""
        with torch.no_grad():
            if name == "model.embed_tokens.weight":
                return self.embed.copy_(t)
            if name == "model.norm.weight":
                return self.norm.copy_(t)
            if name == "lm_head.weight":
                return self.lm_head.copy_(t)
            m = self._NAME.match(name)
            if m is None:
                raise KeyError(name)
            lay, rest = self.layers[int(m.group(1))], m.group(2)
            if rest in self._ATTN and self._ATTN[rest] in lay:
                return lay[self._ATTN[rest]].copy_(t)
            m = self._EXPERT.match(rest)
            if m is not None and "gate_weight" in lay:
                return self._mlp_slot(lay, "", int(m.group(1)), m.group(2), t)
            m = self._MLP.match(rest)
            if m is not None and (m.group(1) is not None) == (
                    "gate_weight" in lay):
                return self._mlp_slot(lay, "shared_" if m.group(1) else "",
                                      0, m.group(2), t)
            raise KeyError(name)

    def load_state_dict(self, sd: Dict[str, torch.Tensor]):
        """Load every tensor of a Hugging Face state_dict; KeyError for a
        name this model has no slot for, or a slot left unfilled."""
        names = set(hf_names(self.cfg))
        missing = names - set(sd)
        if missing:
            raise KeyError(f"missing: {sorted(missing)[:5]}")
        for k, v in sd.items():
            self.load(k, v)


def hf_names(cfg: DeepseekV3Config) -> List[str]:
    """Every Hugging Face state_dict name of the language model."""
    out = ["model.embed_tokens.weight"]
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        out += [p + k for k in ("input_layernorm.weight",
                                "post_attention_layernorm.weight",
                                "self_attn.q_proj.weight",
                                "self_attn.kv_a_proj_with_mqa.weight",
                                "self_attn.kv_a_layernorm.weight",
                                "self_attn.kv_b_proj.weight",
                                "self_attn.o_proj.weight")]
        mlp = ("gate", "up", "down")
        if cfg.is_moe(i):
            out += [p + "mlp.gate.weight",
                    p + "mlp.gate.e_score_correction_bias"]
            out += [f"{p}mlp.experts.{e}.{k}_proj.weight"
                    for e in range(cfg.n_routed_experts) for k in mlp]
            out += [f"{p}mlp.shared_experts.{k}_proj.weight" for k in mlp]
        else:
            out += [f"{p}mlp.{k}_proj.weight" for k in mlp]
    return out + ["model.norm.weight", "lm_head.weight"]


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps, dtype):
    """RMSNorm of x [..., D] in fp32, times w, rounded once to ``dtype``."""
    return F.rms_norm(x.float(), (x.shape[-1],), w.float(), eps).to(dtype)


def rope_cos_sin(cfg: DeepseekV3Config, pos):
    """cos, sin [N, d] (fp32) of positions ``pos`` [N] for the RoPE part."""
    d = cfg.qk_rope_head_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(0, d, 2, device=pos.device,
                                                 dtype=torch.float32) / d))
    f = pos.float()[:, None] * inv[None, :]
    emb = torch.cat([f, f], -1)
    return emb.cos(), emb.sin()


def apply_rope(x, cos, sin):
    """RoPE of x [N, ..., d] (cos / sin [N, d]) as modeling_deepseek does:
    the features de-interleaved (even ones, then odd ones), then
    x cos + rotate_half(x) sin; fp32, rounded to x.dtype."""
    d = x.shape[-1]
    xf = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    shape = (cos.shape[0],) + (1,) * (x.dim() - 2) + (d,)
    c, s = cos.view(shape), sin.view(shape)
    rot = torch.cat([-xf[..., d // 2:], xf[..., :d // 2]], -1)
    return (xf * c + rot * s).to(x.dtype)


def _linear(x, w):
    return x @ w.t()


def _latent(lay, cfg, h, pos):
    """(q [N, nh, 192] with its RoPE part rotated, c_kv [N, 512] after
    kv_a_layernorm, k_pe [N, 64] rotated) of normed rows h [N, H]."""
    nh, dn = cfg.num_attention_heads, cfg.qk_nope_head_dim
    q = _linear(h, lay["q"]).view(-1, nh, cfg.q_head_dim)
    kva = _linear(h, lay["kv_a"])
    c_kv = rms_norm(kva[:, :cfg.kv_lora_rank], lay["kv_a_ln"],
                    cfg.rms_norm_eps, h.dtype)
    cos, sin = rope_cos_sin(cfg, pos)
    q[..., dn:] = apply_rope(q[..., dn:], cos, sin)
    k_pe = apply_rope(kva[:, cfg.kv_lora_rank:], cos, sin)
    return q, c_kv, k_pe


def _kv_b_heads(lay, cfg):
    """W_uk [nh, 128, 512] and W_uv [nh, 128, 512] of kv_b_proj."""
    nh, dn, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                  cfg.v_head_dim)
    w = lay["kv_b"].view(nh, dn + dv, cfg.kv_lora_rank)
    return w[:, :dn], w[:, dn:]


def mla_expanded(lay, cfg, h, slots, n_seq: int, L: int):
    """Causal MLA of normed rows h [N, H], row n being position
    ``slots[n] % L`` of sequence ``slots[n] // L`` in a padded [n_seq, L]
    layout whose padding lies after each sequence's rows. The rows are padded first, so the projections and the attention
    run on the padded layout (a padding row sees only earlier rows and is
    never read back). Returns (out [N, H] in h.dtype, the o projection's
    output; cache [n_seq, L, 576]: cat(c_kv, k_pe) of every position,
    padding positions undefined)."""
    with trace.span("op.mla_prefill"):
        nh, dn, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                      cfg.v_head_dim)
        dq = cfg.q_head_dim
        hp = h.new_zeros(n_seq * L, h.shape[1]).index_copy_(0, slots, h)
        q, c_kv, k_pe = _latent(lay, cfg, hp,
                                torch.arange(n_seq * L, device=h.device) % L)
        kv = _linear(c_kv, lay["kv_b"]).view(-1, nh, dn + dv)
        k = q.new_empty(q.shape)
        k[..., :dn] = kv[..., :dn]
        k[..., dn:] = k_pe[:, None, :]
        # v padded to the q / k width, so every attention backend takes it
        v = F.pad(kv[..., dn:], (0, dq - dv))

        def heads(t):
            return t.view(n_seq, L, nh, dq).transpose(1, 2)

        o = F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                           is_causal=True,
                                           scale=1.0 / math.sqrt(dq))
        o = o.transpose(1, 2).reshape(n_seq * L, nh, dq)[..., :dv]
        out = _linear(o.reshape(-1, nh * dv).index_select(0, slots), lay["o"])
        cache = torch.cat([c_kv, k_pe], -1)
        return out, cache.view(n_seq, L, -1)


def mla_absorbed(lay, cfg, h, pos, cache, rows: mla_ops.AnswerRows):
    """MLA of answer rows h [N, H] (positions ``pos``; the scorer's
    option-major order) in the absorbed form, against each slate's cache
    [G, Lc, 576] and the earlier rows of their own option (``rows``, the
    group's ``ops/mla_answer.AnswerRows``): every head's 512-wide latent
    query (q_nope W_uk) beside its q_pe, the softmax scale folded into
    both, then the attention core (``ops/mla_answer.mla_answer``: the
    kernel on the card), then W_uv on each head's 512-wide output.
    Returns the o projection's output [N, H]."""
    with trace.span("op.mla_answer"):
        nh, dn, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                      cfg.v_head_dim)
        R = cfg.kv_lora_rank
        q, c_kv, k_pe = _latent(lay, cfg, h, pos)
        w_uk, w_uv = _kv_b_heads(lay, cfg)
        scale = 1.0 / math.sqrt(cfg.q_head_dim)
        qf = q.new_empty(h.shape[0], nh, cache.shape[2])
        torch.bmm(q[..., :dn].transpose(0, 1), w_uk * scale,
                  out=qf[..., :R].transpose(0, 1))
        qf[..., R:] = q[..., dn:] * scale
        o = mla_ops.mla_answer(qf, cache, torch.cat([c_kv, k_pe], -1),
                               rows, R)
        # W_uv after the attention: each head's 512-wide output to its v
        o = torch.bmm(o.transpose(0, 1), w_uv.transpose(1, 2)).transpose(0, 1)
        return _linear(o.reshape(-1, nh * dv), lay["o"])


def mlp(lay, cfg, h):
    """The layer's MLP on normed rows h [N, H]: fp32 [N, H]."""
    if "gate_weight" in lay:
        return moe_ops.moe_layer(h, lay, top_k=cfg.num_experts_per_tok,
                                 scale=cfg.routed_scaling_factor)
    return moe_ops.swiglu_mlp(h, lay["w13"], lay["w2"]).float()


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------

def prefill(model: DecoderModel, x, slots, n_seq: int, L: int):
    """Every layer over rows x [N, H] (fp32 or the model's dtype; the
    input embeddings) of ``n_seq`` padded sequences of length ``L``
    (``slots`` as ``mla_expanded``): (the final norm's output [N, H] in
    the model's dtype, the per-layer caches [n_seq, L, 576])."""
    cfg, dt = model.cfg, model.dtype
    x = x.to(torch.float32, copy=True)      # the residual, summed in place
    caches = []
    for lay in model.layers:
        h = rms_norm(x, lay["ln1"], cfg.rms_norm_eps, dt)
        a, cache = mla_expanded(lay, cfg, h, slots, n_seq, L)
        caches.append(cache)
        x += a
        h = rms_norm(x, lay["ln2"], cfg.rms_norm_eps, dt)
        x += mlp(lay, cfg, h)
    return rms_norm(x, model.norm, cfg.rms_norm_eps, dt), caches


def answer(model: DecoderModel, x, pos, caches, rows: mla_ops.AnswerRows):
    """Every layer over answer rows x [N, H] against the slates' caches:
    the final norm's output [N, H] in the model's dtype."""
    cfg, dt = model.cfg, model.dtype
    x = x.to(torch.float32, copy=True)      # the residual, summed in place
    for lay, cache in zip(model.layers, caches):
        h = rms_norm(x, lay["ln1"], cfg.rms_norm_eps, dt)
        x += mla_absorbed(lay, cfg, h, pos, cache, rows)
        h = rms_norm(x, lay["ln2"], cfg.rms_norm_eps, dt)
        x += mlp(lay, cfg, h)
    return rms_norm(x, model.norm, cfg.rms_norm_eps, dt)


def forward_logits(model: DecoderModel, inputs_embeds):
    """The full causal forward of whole sequences inputs_embeds [B, L, H]:
    fp32 logits [B, L, V] (a test's reference point; the scorer never
    forms them)."""
    B, L, H = inputs_embeds.shape
    dev = inputs_embeds.device
    slots = torch.arange(B * L, device=dev)
    h, _ = prefill(model, inputs_embeds.reshape(B * L, H), slots, B, L)
    return (h.float() @ model.lm_head.float().t()).view(B, L, -1)
