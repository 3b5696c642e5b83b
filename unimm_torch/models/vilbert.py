"""ViLBERT two-stream co-attention encoder (UniMM-UL core model).

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
* in training (``train=True``) the five dropout sites of the JAX package
  (attention probabilities, the attention output, the FFN output, the
  connection layer's outputs and the embeddings; plus the NSP pooling
  head) draw from an explicit ``DropoutRng``, and ``call_in_dtype`` runs a
  function over a differentiable compute-dtype view of the fp32 master
  weights, so bf16 compute feeds its gradients back to them.

Layer order for the shipped 6-connection config is the reference
interleave: t0..t5, [co0, v0, t6], ..., [co5, v5, t11].
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
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


def train_model(cfg: VilbertConfig, seed: int = 0,
                device="cuda") -> VilbertModel:
    """``init_model`` in train mode with gradients on: fp32 master
    weights for the training step."""
    return init_model(cfg, seed, device).train().requires_grad_(True)


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


class _Call(nn.Module):
    """Holds a model so that ``torch.func.functional_call`` can run any
    function over it."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, fn, *args, **kwargs):
        return fn(self.model, *args, **kwargs)


def call_in_dtype(model: nn.Module, dtype, fn, /, *args, **kwargs):
    """``fn(view, *args, **kwargs)`` where ``view`` is ``model`` with each
    floating parameter replaced by its cast to ``dtype``: a differentiable
    view (the JAX package casts inside the differentiated function), so the
    gradients of bf16 compute reach the fp32 master parameters. The tied
    decoder is the one cast word-embedding tensor, read by both the
    embedding lookup and the output xent, so its two gradients add up."""
    params = {"model." + n: (p.to(dtype) if p.is_floating_point() else p)
              for n, p in model.named_parameters()}
    return torch.func.functional_call(_Call(model), params, (fn,) + args,
                                      kwargs)


class ComputeModels:
    """Compute-dtype copies of source models: one ``cast_floating`` per
    model, reused while that model's parameters are unchanged (their
    version counters), so a scorer casts once per model and not per call.
    Holds each source model it has seen."""

    def __init__(self, dtype):
        self.dtype = dtype
        self._by_id = {}

    def __call__(self, model):
        versions = tuple(p._version for p in model.parameters())
        hit = self._by_id.get(id(model))
        if hit is None or hit[0] is not model or hit[1] != versions:
            hit = (model, versions, cast_floating(model, self.dtype))
            self._by_id[id(model)] = hit
        return hit[2]


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

class DropoutRng:
    """The dropout stream of one training step: a generator on ``device``
    for the masks, and a host generator for the seeds of the attention
    block's in-kernel Philox stream (drawn without a device sync). The
    sites draw from it in the model's order, so a seed gives the same
    masks on every call."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.dev = torch.Generator(device=self.device)
        self.dev.manual_seed(seed)
        self.host = torch.Generator()
        # another stream than the device generator's, on a CPU device too
        self.host.manual_seed(seed ^ 0x5DEECE66D)


def dropout_scale_mask(rng: DropoutRng, shape, rate: float,
                       dtype=torch.float32):
    """Bernoulli(1 - rate) scale mask: 1 / keep where kept, else 0."""
    keep = 1.0 - rate
    mask = torch.empty(shape, dtype=torch.float32, device=rng.device)
    mask.bernoulli_(keep, generator=rng.dev).mul_(1.0 / keep)
    return mask.to(dtype)


def dropout(x, rate: float, train: bool, rng: Optional[DropoutRng]):
    """Inverted dropout: x * mask in fp32, rounded back to x.dtype."""
    if not train or rate == 0.0:
        return x
    if rng is None:
        raise ValueError("dropout in training needs a DropoutRng")
    return (x * dropout_scale_mask(rng, x.shape, rate)).to(x.dtype)


def dropout_seed(rng: DropoutRng) -> int:
    """A host int seed in [0, 2^31 - 1) for an in-kernel dropout stream."""
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=rng.host))


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


def attention_core(q, k, v, bias, *, drop_rate=0.0, train=False, rng=None):
    """Softmax attention over split heads; ``bias`` is additive and
    broadcasts to [B, H, S, K]; softmax in fp32; probability dropout in
    training."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    probs = torch.softmax(scores, dim=-1, dtype=torch.float32).to(q.dtype)
    probs = dropout(probs, drop_rate, train, rng)
    return torch.matmul(probs, v)


# ---------------------------------------------------------------------------
# transformer blocks
# ---------------------------------------------------------------------------

def self_attention_block(p, x, bias, *, num_heads, fused_block=None,
                         attn_drop=0.0, hidden_drop=0.0, train=False,
                         rng=None, fused_block_train=None, fused_attn=None):
    """BertAttention: self-attention + output projection + residual LN.
    ``fused_attn(q, k, v) -> ctx`` replaces the bias-based attention core
    over the split heads (the per-head attention kernel, which makes the
    mask from the descriptor); ``fused_block(p, x)`` replaces the whole
    block (the attention-block kernel); ``fused_block_train(p, x, rng)`` is
    its differentiable training form with both dropout sites."""
    if fused_block_train is not None:
        return fused_block_train(p, x, rng)
    if fused_block is not None:
        return fused_block(p, x)
    ps = p.self
    q = _split_heads(linear(ps.query, x), num_heads)
    k = _split_heads(linear(ps.key, x), num_heads)
    v = _split_heads(linear(ps.value, x), num_heads)
    if fused_attn is not None:
        ctx = _merge_heads(fused_attn(q, k, v))
    else:
        ctx = _merge_heads(attention_core(q, k, v, bias, drop_rate=attn_drop,
                                          train=train, rng=rng))
    po = p.output
    h = dropout(linear(po.dense, ctx), hidden_drop, train, rng)
    return layer_norm(po.LayerNorm, h + x)


def ffn_block(p_inter, p_out, x, *, act, fused_ffn=None, hidden_drop=0.0,
              train=False, rng=None):
    """BertIntermediate + BertOutput. ``fused_ffn(p_inter, p_out, x)``
    replaces the chain (the FFN kernel)."""
    if fused_ffn is not None:
        return fused_ffn(p_inter, p_out, x)
    h = ACT[act](linear(p_inter.dense, x))
    h = dropout(linear(p_out.dense, h), hidden_drop, train, rng)
    return layer_norm(p_out.LayerNorm, h + x)


def encoder_layer(p, x, bias, *, num_heads, act, fused_block=None,
                  fused_ffn=None, attn_drop=0.0, hidden_drop=0.0,
                  train=False, rng=None, fused_block_train=None,
                  fused_attn=None):
    """BertLayer / BertImageLayer."""
    h = self_attention_block(p.attention, x, bias, num_heads=num_heads,
                             fused_block=fused_block, attn_drop=attn_drop,
                             hidden_drop=hidden_drop, train=train, rng=rng,
                             fused_block_train=fused_block_train,
                             fused_attn=fused_attn)
    return ffn_block(p.intermediate, p.output, h, act=act,
                     fused_ffn=fused_ffn, hidden_drop=hidden_drop,
                     train=train, rng=rng)


def co_text_side(p, cfg: VilbertConfig, v_x, t_x, v_bias, *, train=False,
                 rng=None):
    """Text side of BertConnectionLayer before its FFN: text queries attend
    image keys/values under the image padding bias, then dense2 + residual
    + LayerNorm2."""
    pb, po = p.biattention, p.biOutput
    nh = cfg.bi_num_attention_heads
    q2 = _split_heads(linear(pb.query2, t_x), nh)
    k1 = _split_heads(linear(pb.key1, v_x), nh)
    v1 = _split_heads(linear(pb.value1, v_x), nh)
    ctx = _merge_heads(attention_core(
        q2, k1, v1, v_bias, drop_rate=cfg.v_attention_probs_dropout_prob,
        train=train, rng=rng))
    t_h = dropout(linear(po.dense2, ctx), cfg.hidden_dropout_prob, train,
                  rng)
    return layer_norm(po.LayerNorm2, t_h + t_x)


def connection_layer(p, cfg: VilbertConfig, v_x, v_bias, t_x, co_bias, *,
                     fused_t_ffn=None, fused_co_text=None, train=False,
                     rng=None):
    """BertConnectionLayer: co-attention + both FFNs.

    Keeps the reference's argument swap (vilbert_dialog.py:775,
    biOutput(bi_output2, v_x, bi_output1, t_x)): the image-queries-text
    context feeds the VISION residual through dense1, the text-queries-image
    context the TEXT residual through dense2. Image->text scores get only
    the co-attention bias, text->image scores only the image padding bias.
    ``fused_co_text(p, v_x, t_x)`` replaces the text side before its FFN
    (the co-attention kernel) and ``fused_t_ffn`` the text FFN; the image
    side is always plain.
    """
    pb, po = p.biattention, p.biOutput
    nh = cfg.bi_num_attention_heads
    q1 = _split_heads(linear(pb.query1, v_x), nh)
    k2 = _split_heads(linear(pb.key2, t_x), nh)
    v2 = _split_heads(linear(pb.value2, t_x), nh)
    ctx_v = _merge_heads(attention_core(
        q1, k2, v2, co_bias, drop_rate=cfg.attention_probs_dropout_prob,
        train=train, rng=rng))
    v_h = dropout(linear(po.dense1, ctx_v), cfg.v_hidden_dropout_prob, train,
                  rng)
    v_out = layer_norm(po.LayerNorm1, v_h + v_x)
    t_out = (fused_co_text(p, v_x, t_x) if fused_co_text is not None
             else co_text_side(p, cfg, v_x, t_x, v_bias, train=train,
                               rng=rng))
    v_out = ffn_block(p.v_intermediate, p.v_output, v_out,
                      act=cfg.v_hidden_act,
                      hidden_drop=cfg.v_hidden_dropout_prob, train=train,
                      rng=rng)
    t_out = ffn_block(p.t_intermediate, p.t_output, t_out,
                      act=cfg.hidden_act, fused_ffn=fused_t_ffn,
                      hidden_drop=cfg.hidden_dropout_prob, train=train,
                      rng=rng)
    return v_out, t_out


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

class _FewRowEmbedding(torch.autograd.Function):
    """``F.embedding`` over a table of few rows (the segment tables), whose
    gradient is the same on every run: onehot(ids)^T grad, one matrix
    product. PyTorch's embedding backward on CUDA sums each row's many hits
    (half of a batch's tokens land on one row) in an order that changes
    from run to run, which moved the segment table's gradient by one
    rounding step between two runs of one training step."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        rows = torch.arange(ctx.rows, device=ids.device)
        onehot = (ids.reshape(-1, 1) == rows).to(grad.dtype)  # no host sync
        return None, onehot.t() @ grad.reshape(-1, grad.shape[-1])


def text_embeddings(p, cfg: VilbertConfig, input_ids, token_type_ids,
                    position_ids, *, dtype, train=False, rng=None):
    """BertEmbeddingsDialog without the dead sinusoid buffer; segment ids
    >= type_vocab_size route to the 10-entry extension table."""
    we = F.embedding(input_ids, p.word_embeddings.weight.to(dtype))
    pe = F.embedding(position_ids, p.position_embeddings.weight.to(dtype))
    ext = token_type_ids - cfg.type_vocab_size
    is_ext = ext >= 0
    zero = torch.zeros_like(token_type_ids)
    te_base = _FewRowEmbedding.apply(
        torch.where(is_ext, zero, token_type_ids),
        p.token_type_embeddings.weight.to(dtype))
    te_ext = _FewRowEmbedding.apply(
        torch.where(is_ext, ext, zero),
        p.token_type_embeddings_extension.weight.to(dtype))
    te = torch.where(is_ext[..., None], te_ext, te_base)
    emb = layer_norm(p.LayerNorm, we + pe + te)
    return dropout(emb, cfg.hidden_dropout_prob, train, rng)


def image_embeddings(p, cfg: VilbertConfig, features, locations, *, dtype,
                     train=False, rng=None):
    """BertImageEmbeddings."""
    emb = (linear(p.image_embeddings, features.to(dtype))
           + linear(p.image_location_embeddings, locations.to(dtype)))
    emb = layer_norm(p.LayerNorm, emb)
    return dropout(emb, cfg.hidden_dropout_prob, train, rng)


# ---------------------------------------------------------------------------
# encoder + poolers + heads
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _replaying(rng: Optional[DropoutRng], snap: dict, recompute: bool):
    """The dropout stream of a rematerialised segment: on its first run,
    take the states of ``rng``'s generators before it draws; on the
    recompute, set them back to that snapshot for the segment and restore
    the states they had when the recompute began."""
    if rng is None:
        yield
        return
    now = (rng.dev.get_state(), rng.host.get_state())
    if not recompute:
        snap["state"] = now
        yield
        return
    rng.dev.set_state(snap["state"][0])
    rng.host.set_state(snap["state"][1])
    try:
        yield
    finally:
        rng.dev.set_state(now[0])
        rng.host.set_state(now[1])


def remat(fn, mod: nn.Module, rng: Optional[DropoutRng], *args):
    """``fn(mod, *args)`` under activation checkpointing: the backward
    recomputes the segment instead of keeping its activations (the JAX
    package's ``jax.checkpoint``). Two things ``torch.utils.checkpoint``
    alone would get wrong here:

    * the recompute runs after ``call_in_dtype`` has put the fp32 master
      parameters back, so the segment's parameters as they are bound now
      (the compute-dtype view) are inputs of the checkpoint and are bound
      again for the recompute;
    * the dropout sites draw from ``rng``'s explicit generators, which
      ``preserve_rng_state`` does not cover: ``_replaying`` gives the
      recompute the same masks and kernel seeds as the first run.

    So the loss and every gradient equal the step without remat."""
    names, params = zip(*mod.named_parameters())
    n, snap = len(params), {}

    def body(*flat):
        bound = {"model." + k: t for k, t in zip(names, flat[:n])}
        return torch.func.functional_call(_Call(mod), bound,
                                          (fn,) + flat[n:])

    return torch.utils.checkpoint.checkpoint(
        body, *params, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (_replaying(rng, snap, False),
                            _replaying(rng, snap, True)))


def encoder(p, cfg: VilbertConfig, t_x, v_x, t_bias, v_bias, co_bias, *,
            tap=None, text_fused_block=None, text_fused_ffn=None,
            text_fused_co=None, train=False, rng=None,
            text_fused_block_train=None, text_fused_attn=None):
    """BertEncoder interleave.

    ``text_fused_attn`` / ``text_fused_block`` / ``text_fused_ffn`` /
    ``text_fused_co`` replace every text layer's attention core or whole
    attention block, every text FFN (text layers and connection layers) and
    every connection layer's text side (see ``self_attention_block``,
    ``ffn_block``, ``connection_layer``); the vision stream is always
    plain.

    ``tap(kind, idx, x)`` is called with each text layer's input ("t",
    layer, t_x) and each connection layer's vision input ("c_v", count,
    v_x); the prefix-cache scorer records its context caches through it.
    It never alters the computation.

    ``train`` turns the dropout sites on (drawing from ``rng``, a
    ``DropoutRng``) and ``text_fused_block_train(p, x, rng)`` replaces
    every text layer's attention block (the training attention-block
    kernel). The frozen prefix of ``fixed_t_layer`` / ``fixed_v_layer``
    layers is detached: no gradient reaches its parameters or the
    embeddings, as under the reference's no_grad.

    Under ``cfg.remat``, when gradients are on, every vision and connection
    layer and every text layer is rematerialised (``remat``), as in the
    JAX package; with ``text_fused_block_train`` only each text layer's FFN
    is, since the block kernel's Function keeps just x and its context.
    """
    if cfg.in_batch_pairs or cfg.fast_mode:
        raise NotImplementedError("in_batch_pairs / fast_mode are not "
                                  "ported yet (ROADMAP Queue A item 9)")

    def t_fn(lp, x):
        return encoder_layer(lp, x, t_bias, num_heads=cfg.num_attention_heads,
                             act=cfg.hidden_act, fused_block=text_fused_block,
                             fused_ffn=text_fused_ffn,
                             attn_drop=cfg.attention_probs_dropout_prob,
                             hidden_drop=cfg.hidden_dropout_prob,
                             train=train, rng=rng,
                             fused_block_train=text_fused_block_train,
                             fused_attn=text_fused_attn)

    def t_ffn(lp, h):
        return ffn_block(lp.intermediate, lp.output, h, act=cfg.hidden_act,
                         hidden_drop=cfg.hidden_dropout_prob, train=train,
                         rng=rng)

    def v_fn(lp, x):
        return encoder_layer(lp, x, v_bias,
                             num_heads=cfg.v_num_attention_heads,
                             act=cfg.v_hidden_act,
                             attn_drop=cfg.v_attention_probs_dropout_prob,
                             hidden_drop=cfg.v_hidden_dropout_prob,
                             train=train, rng=rng)

    def c_fn(cp, vx, tx):
        return connection_layer(cp, cfg, vx, v_bias, tx, co_bias,
                                fused_t_ffn=text_fused_ffn,
                                fused_co_text=text_fused_co, train=train,
                                rng=rng)

    if cfg.remat and torch.is_grad_enabled():
        if text_fused_block_train is not None:
            def t_layer(lp, x):
                h = self_attention_block(
                    lp.attention, x, None,
                    num_heads=cfg.num_attention_heads,
                    fused_block_train=text_fused_block_train, rng=rng)
                return remat(t_ffn, lp, rng, h)
        else:
            def t_layer(lp, x):
                return remat(t_fn, lp, rng, x)

        def v_layer(lp, x):
            return remat(v_fn, lp, rng, x)

        def c_layer(cp, vx, tx):
            return remat(c_fn, cp, rng, vx, tx)
    else:
        t_layer, v_layer, c_layer = t_fn, v_fn, c_fn

    v_start = t_start = 0
    for count, (v_end, t_end) in enumerate(
            zip(cfg.v_biattention_id, cfg.t_biattention_id)):
        for i in range(v_start, v_end):
            v_x = v_layer(p.v_layer[i], v_x)
            if i < cfg.fixed_v_layer:
                v_x = v_x.detach()
        for i in range(t_start, t_end):
            if tap is not None:
                tap("t", i, t_x)
            t_x = t_layer(p.layer[i], t_x)
            if i < cfg.fixed_t_layer:
                t_x = t_x.detach()
        if cfg.with_coattention:
            if tap is not None:
                tap("c_v", count, v_x)
            v_x, t_x = c_layer(p.c_layer[count], v_x, t_x)
        v_start, t_start = v_end, t_end
    for i in range(v_start, cfg.v_num_hidden_layers):
        v_x = v_layer(p.v_layer[i], v_x)
    for i in range(t_start, cfg.num_hidden_layers):
        if tap is not None:
            tap("t", i, t_x)
        t_x = t_layer(p.layer[i], t_x)
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


def _fused_pooled(cfg, pooled_t, pooled_v, train, rng):
    pooled = (pooled_t * pooled_v if cfg.fusion_method == "mul"
              else pooled_t + pooled_v)
    # fixed 0.1 in the reference (vilbert_dialog.py:1056), cfg-surfaced
    return dropout(pooled, cfg.head_dropout_prob, train, rng)


def _img_logits(model, cfg, v_seq):
    pi = model.cls.imagePredictions
    hv = ACT[cfg.hidden_act](linear(pi.transform.dense, v_seq))
    return linear(pi.decoder, layer_norm(pi.transform.LayerNorm, hv))


def pretraining_heads(model: VilbertModel, cfg: VilbertConfig, t_seq, v_seq,
                      pooled_t, pooled_v, *, train=False, rng=None):
    """BertPreTrainingHeads over a model in the compute dtype: dense MLM
    logits through the tied decoder [N, L, V], the fused NSP logits and
    the region-class logits."""
    pooled = _fused_pooled(cfg, pooled_t, pooled_v, train, rng)
    pp = model.cls.predictions
    h = ACT[cfg.hidden_act](linear(pp.transform.dense, t_seq))
    h = layer_norm(pp.transform.LayerNorm, h)
    decoder = model.bert.embeddings.word_embeddings.weight
    mlm_logits = torch.matmul(h, decoder.to(h.dtype).t()) + pp.bias
    nsp_logits = linear(model.cls.bi_seq_relationship, pooled)
    return mlm_logits, _img_logits(model, cfg, v_seq), nsp_logits


def nsp_and_img_heads(model: VilbertModel, cfg: VilbertConfig, v_seq,
                      pooled_t, pooled_v, *, train=False, rng=None):
    """NSP + region-class heads without the MLM decode (the gathered MLM
    path takes the answer NLL separately): (img_logits, nsp_logits)."""
    pooled = _fused_pooled(cfg, pooled_t, pooled_v, train, rng)
    nsp_logits = linear(model.cls.bi_seq_relationship, pooled)
    return _img_logits(model, cfg, v_seq), nsp_logits
