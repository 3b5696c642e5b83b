"""ViLBERT two-stream co-attention encoder (UniMM-UL core model), eval mode.

The parameters live in ``VilbertModel``, an ``nn.Module`` tree whose
``state_dict`` keys are exactly the reference names
(``bert.encoder.layer.0.attention.self.query.weight``, Linear weights in
``[out, in]`` layout; the MLM decoder is tied to
``bert.embeddings.word_embeddings``). The computation is plain functions
over those modules, as in the JAX package's ``models/vilbert.py``:

* attention masks arrive as additive biases built from the descriptors
  (ops/masks.py);
* mixed precision via ``dtype`` with fp32 LayerNorm statistics and fp32
  softmax;
* no dropout: this slice of the port serves, it does not train.

Layer order for the shipped 6-connection config is the reference
interleave: t0..t5, [co0, v0, t6], ..., [co5, v5, t11].
"""

from __future__ import annotations

import copy
import math

import torch
import torch.nn.functional as F
from torch import nn

from unimm_torch.config import VilbertConfig


# ---------------------------------------------------------------------------
# parameter tree
# ---------------------------------------------------------------------------

class Node(nn.Module):
    """A container whose children (modules or parameters) carry the
    reference ``state_dict`` names."""

    # positional-only: the attention block has a child named "self"
    def __init__(node, /, **children):
        super().__init__()
        for name, child in children.items():
            if isinstance(child, nn.Parameter):
                node.register_parameter(name, child)
            else:
                node.add_module(name, child)


def _ln(dim):
    return nn.LayerNorm(dim, eps=1e-12)


def _attention(dim):
    return Node(self=Node(query=nn.Linear(dim, dim), key=nn.Linear(dim, dim),
                          value=nn.Linear(dim, dim)),
                output=Node(dense=nn.Linear(dim, dim), LayerNorm=_ln(dim)))


def _layer(dim, inter):
    return Node(attention=_attention(dim),
                intermediate=Node(dense=nn.Linear(dim, inter)),
                output=Node(dense=nn.Linear(inter, dim), LayerNorm=_ln(dim)))


def _connection(cfg: VilbertConfig):
    t, v, bi = cfg.hidden_size, cfg.v_hidden_size, cfg.bi_hidden_size
    return Node(
        biattention=Node(
            query1=nn.Linear(v, bi), key1=nn.Linear(v, bi),
            value1=nn.Linear(v, bi), query2=nn.Linear(t, bi),
            key2=nn.Linear(t, bi), value2=nn.Linear(t, bi)),
        biOutput=Node(
            dense1=nn.Linear(bi, v), LayerNorm1=_ln(v),
            q_dense1=nn.Linear(bi, v), dense2=nn.Linear(bi, t),
            LayerNorm2=_ln(t), q_dense2=nn.Linear(bi, t)),
        v_intermediate=Node(dense=nn.Linear(v, cfg.v_intermediate_size)),
        v_output=Node(dense=nn.Linear(cfg.v_intermediate_size, v),
                      LayerNorm=_ln(v)),
        t_intermediate=Node(dense=nn.Linear(t, cfg.intermediate_size)),
        t_output=Node(dense=nn.Linear(cfg.intermediate_size, t),
                      LayerNorm=_ln(t)))


class VilbertModel(nn.Module):
    """The reference BertForMultiModalPreTraining parameter set, including
    the unused ``sep_embeddings`` table and ``q_dense`` layers kept for
    checkpoint-format parity."""

    def __init__(self, cfg: VilbertConfig):
        super().__init__()
        H, V = cfg.hidden_size, cfg.vocab_size
        self.bert = Node(
            embeddings=Node(
                word_embeddings=nn.Embedding(V, H),
                position_embeddings=nn.Embedding(
                    cfg.max_position_embeddings, H),
                token_type_embeddings=nn.Embedding(cfg.type_vocab_size, H),
                token_type_embeddings_extension=nn.Embedding(10, H),
                sep_embeddings=nn.Embedding(50, H),
                LayerNorm=_ln(H)),
            v_embeddings=Node(
                image_embeddings=nn.Linear(cfg.v_feature_size,
                                           cfg.v_hidden_size),
                image_location_embeddings=nn.Linear(5, cfg.v_hidden_size),
                LayerNorm=_ln(cfg.v_hidden_size)),
            encoder=Node(
                layer=nn.ModuleList(_layer(H, cfg.intermediate_size)
                                    for _ in range(cfg.num_hidden_layers)),
                v_layer=nn.ModuleList(
                    _layer(cfg.v_hidden_size, cfg.v_intermediate_size)
                    for _ in range(cfg.v_num_hidden_layers)),
                c_layer=nn.ModuleList(
                    _connection(cfg)
                    for _ in range(len(cfg.v_biattention_id)))),
            t_pooler=Node(dense=nn.Linear(H, cfg.bi_hidden_size)),
            v_pooler=Node(dense=nn.Linear(cfg.v_hidden_size,
                                          cfg.bi_hidden_size)))
        self.cls = Node(
            predictions=Node(
                transform=Node(dense=nn.Linear(H, H), LayerNorm=_ln(H)),
                bias=nn.Parameter(torch.zeros(V))),
            bi_seq_relationship=nn.Linear(cfg.bi_hidden_size, 2),
            imagePredictions=Node(
                transform=Node(dense=nn.Linear(cfg.v_hidden_size,
                                               cfg.v_hidden_size),
                               LayerNorm=_ln(cfg.v_hidden_size)),
                decoder=nn.Linear(cfg.v_hidden_size, cfg.v_target_size)))


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device is never replaced
    by the CPU: asking for one on a machine without it raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available; pass device='cpu' to run the plain "
                           "versions on the CPU")
    return dev


def empty_model(cfg: VilbertConfig, device="cuda") -> VilbertModel:
    """An fp32 serving model (eval mode, no gradients) with uninitialised
    storage on ``device``."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = VilbertModel(cfg)
    return model.to_empty(device=dev).eval().requires_grad_(False)


@torch.no_grad()
def init_model(cfg: VilbertConfig, seed: int = 0,
               device="cuda") -> VilbertModel:
    """Random init as the reference's init_weights (and the JAX package's
    init_params): Linear weights and embedding tables normal(0,
    initializer_range), biases zero, LayerNorm ones/zeros. The stream comes
    from a ``torch.Generator`` seeded with ``seed``; it differs from JAX's
    stream, so cross-package tests move weights with
    ``checkpoint.state_dict_from_jax`` instead."""
    model = empty_model(cfg, device)
    gen = torch.Generator(device=model.cls.predictions.bias.device)
    gen.manual_seed(seed)
    std = cfg.initializer_range
    for mod in model.modules():
        if isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, nn.Linear):
            mod.weight.normal_(0.0, std, generator=gen)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, std, generator=gen)
    model.cls.predictions.bias.zero_()
    return model


def cast_floating(model: nn.Module, dtype) -> nn.Module:
    """The model with floating parameters in the compute dtype: the model
    itself when they already are, else a cast copy (the original, with its
    fp32 decoder bias, is left as it is)."""
    params = [p for p in model.parameters() if p.is_floating_point()]
    if all(p.dtype == dtype for p in params):
        return model
    # deepcopy with the parameters pre-seeded in its memo: the module tree
    # is copied, the fp32 storage never is (one cast per parameter)
    memo = {id(p): nn.Parameter(p.detach().to(dtype), requires_grad=False)
            for p in params}
    return copy.deepcopy(model, memo)


# ---------------------------------------------------------------------------
# small building blocks
# ---------------------------------------------------------------------------

def gelu(x):
    """erf gelu in fp32; the tanh approximation in bf16 (the JAX package's
    accepted deviation, models/vilbert.py:55)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16
                  else "none")


def swish(x):
    return x * torch.sigmoid(x)


ACT = {"gelu": gelu, "relu": F.relu, "swish": swish}


def linear(p: nn.Linear, x):
    return F.linear(x, p.weight, p.bias)


def layer_norm(p: nn.LayerNorm, x, eps: float = 1e-12):
    """LayerNorm with fp32 statistics whatever the compute dtype (PyTorch's
    kernel accumulates a bf16 input in fp32 and rounds once on output)."""
    return F.layer_norm(x, x.shape[-1:], p.weight.to(x.dtype),
                        p.bias.to(x.dtype), eps)


def _split_heads(x, num_heads: int):
    b, s, _ = x.shape
    return x.reshape(b, s, num_heads, -1).transpose(1, 2)


def _merge_heads(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def attention_core(q, k, v, bias):
    """Softmax attention over split heads; ``bias`` is additive and
    broadcasts to [B, H, S, K]; softmax in fp32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    probs = torch.softmax(scores, dim=-1, dtype=torch.float32).to(q.dtype)
    return torch.matmul(probs, v)


# ---------------------------------------------------------------------------
# transformer blocks
# ---------------------------------------------------------------------------

def self_attention_block(p, x, bias, *, num_heads):
    """BertAttention: self-attention + output projection + residual LN."""
    ps = p.self
    q = _split_heads(linear(ps.query, x), num_heads)
    k = _split_heads(linear(ps.key, x), num_heads)
    v = _split_heads(linear(ps.value, x), num_heads)
    ctx = _merge_heads(attention_core(q, k, v, bias))
    po = p.output
    return layer_norm(po.LayerNorm, linear(po.dense, ctx) + x)


def ffn_block(p_inter, p_out, x, *, act):
    """BertIntermediate + BertOutput."""
    h = ACT[act](linear(p_inter.dense, x))
    return layer_norm(p_out.LayerNorm, linear(p_out.dense, h) + x)


def encoder_layer(p, x, bias, *, num_heads, act):
    """BertLayer / BertImageLayer."""
    h = self_attention_block(p.attention, x, bias, num_heads=num_heads)
    return ffn_block(p.intermediate, p.output, h, act=act)


def co_text_side(p, cfg: VilbertConfig, v_x, t_x, v_bias):
    """Text side of BertConnectionLayer before its FFN: text queries attend
    image keys/values under the image padding bias, then dense2 + residual
    + LayerNorm2."""
    pb, po = p.biattention, p.biOutput
    nh = cfg.bi_num_attention_heads
    q2 = _split_heads(linear(pb.query2, t_x), nh)
    k1 = _split_heads(linear(pb.key1, v_x), nh)
    v1 = _split_heads(linear(pb.value1, v_x), nh)
    ctx = _merge_heads(attention_core(q2, k1, v1, v_bias))
    return layer_norm(po.LayerNorm2, linear(po.dense2, ctx) + t_x)


def connection_layer(p, cfg: VilbertConfig, v_x, v_bias, t_x, co_bias):
    """BertConnectionLayer: co-attention + both FFNs.

    Keeps the reference's argument swap (vilbert_dialog.py:775,
    biOutput(bi_output2, v_x, bi_output1, t_x)): the image-queries-text
    context feeds the VISION residual through dense1, the text-queries-image
    context the TEXT residual through dense2. Image->text scores get only
    the co-attention bias, text->image scores only the image padding bias.
    """
    pb, po = p.biattention, p.biOutput
    nh = cfg.bi_num_attention_heads
    q1 = _split_heads(linear(pb.query1, v_x), nh)
    k2 = _split_heads(linear(pb.key2, t_x), nh)
    v2 = _split_heads(linear(pb.value2, t_x), nh)
    ctx_v = _merge_heads(attention_core(q1, k2, v2, co_bias))
    v_out = layer_norm(po.LayerNorm1, linear(po.dense1, ctx_v) + v_x)
    t_out = co_text_side(p, cfg, v_x, t_x, v_bias)
    v_out = ffn_block(p.v_intermediate, p.v_output, v_out,
                      act=cfg.v_hidden_act)
    t_out = ffn_block(p.t_intermediate, p.t_output, t_out,
                      act=cfg.hidden_act)
    return v_out, t_out


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def text_embeddings(p, cfg: VilbertConfig, input_ids, token_type_ids,
                    position_ids, *, dtype):
    """BertEmbeddingsDialog without the dead sinusoid buffer; segment ids
    >= type_vocab_size route to the 10-entry extension table."""
    we = F.embedding(input_ids, p.word_embeddings.weight.to(dtype))
    pe = F.embedding(position_ids, p.position_embeddings.weight.to(dtype))
    ext = token_type_ids - cfg.type_vocab_size
    is_ext = ext >= 0
    zero = torch.zeros_like(token_type_ids)
    te_base = F.embedding(torch.where(is_ext, zero, token_type_ids),
                          p.token_type_embeddings.weight.to(dtype))
    te_ext = F.embedding(torch.where(is_ext, ext, zero),
                         p.token_type_embeddings_extension.weight.to(dtype))
    te = torch.where(is_ext[..., None], te_ext, te_base)
    return layer_norm(p.LayerNorm, we + pe + te)


def image_embeddings(p, cfg: VilbertConfig, features, locations, *, dtype):
    """BertImageEmbeddings."""
    emb = (linear(p.image_embeddings, features.to(dtype))
           + linear(p.image_location_embeddings, locations.to(dtype)))
    return layer_norm(p.LayerNorm, emb)


# ---------------------------------------------------------------------------
# encoder + poolers + heads
# ---------------------------------------------------------------------------

def encoder(p, cfg: VilbertConfig, t_x, v_x, t_bias, v_bias, co_bias, *,
            tap=None):
    """BertEncoder interleave.

    ``tap(kind, idx, x)`` is called with each text layer's input ("t",
    layer, t_x) and each connection layer's vision input ("c_v", count,
    v_x); the prefix-cache scorer records its context caches through it.
    It never alters the computation.
    """
    if cfg.in_batch_pairs or cfg.fast_mode:
        raise NotImplementedError("in_batch_pairs / fast_mode are training "
                                  "modes, not ported in this slice")
    def t_fn(lp, x):
        return encoder_layer(lp, x, t_bias, num_heads=cfg.num_attention_heads,
                             act=cfg.hidden_act)

    def v_fn(lp, x):
        return encoder_layer(lp, x, v_bias,
                             num_heads=cfg.v_num_attention_heads,
                             act=cfg.v_hidden_act)
    v_start = t_start = 0
    for count, (v_end, t_end) in enumerate(
            zip(cfg.v_biattention_id, cfg.t_biattention_id)):
        for i in range(v_start, v_end):
            v_x = v_fn(p.v_layer[i], v_x)
        for i in range(t_start, t_end):
            if tap is not None:
                tap("t", i, t_x)
            t_x = t_fn(p.layer[i], t_x)
        if cfg.with_coattention:
            if tap is not None:
                tap("c_v", count, v_x)
            v_x, t_x = connection_layer(p.c_layer[count], cfg, v_x, v_bias,
                                        t_x, co_bias)
        v_start, t_start = v_end, t_end
    for i in range(v_start, cfg.v_num_hidden_layers):
        v_x = v_fn(p.v_layer[i], v_x)
    for i in range(t_start, cfg.num_hidden_layers):
        if tap is not None:
            tap("t", i, t_x)
        t_x = t_fn(p.layer[i], t_x)
    return t_x, v_x


def pooler(p, x):
    """First-token pooling -> Linear -> ReLU."""
    return F.relu(linear(p.dense, x[:, 0]))


def mlm_head_at_positions(model: VilbertModel, cfg: VilbertConfig, t_seq,
                          positions):
    """MLM hidden transform at gathered positions only ([B, P, H]); pair
    with ops/losses.online_softmax_xent or the xent_head kernel for the NLL
    over the tied decoder."""
    pt = model.cls.predictions.transform
    idx = positions[..., None].expand(*positions.shape, t_seq.shape[-1])
    gathered = torch.gather(t_seq, 1, idx)
    h = ACT[cfg.hidden_act](linear(pt.dense, gathered))
    return layer_norm(pt.LayerNorm, h)
