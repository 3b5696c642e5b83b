"""UniMM-UL top-level functions: descriptors -> biases -> encoder ->
answer log-likelihoods and NSP logits (eval), or the training losses.

The port of the JAX package's ``models/unimm.py``. ``encode`` dispatches
on ``cfg.attention_impl``: "pallas_block" runs the text stream through the
Hopper kernels, which make the text mask from the descriptor, so no
[B, L, L] bias is built: in eval the attention block, the FFN and under
``cfg.fused_co`` the co-attention text side; in training the
differentiable attention block with its in-kernel probability dropout
(the text FFNs stay plain, as in the JAX package). "pallas" runs only each
text layer's attention core on the per-head kernel (ops/text_attention.py,
differentiable), in eval and in training at attention dropout 0; in
training with attention dropout it takes the plain bias path, as the JAX
package does (the kernel has no dropout site). Under ``in_batch_pairs``
or ``fast_mode`` every text kernel is off, as in the JAX package (the
rows no longer match their descriptors). "xla" runs the plain
PyTorch encoder over additive biases (what the prefix scorer's context
prefill runs). ``forward_eval`` is the flat full-sequence scorer;
``forward_train`` returns the training losses. Answer NLL is taken at
gathered label positions by an online softmax over the tied decoder; the
[N, L, vocab] logits never exist (except under ``mlm_loss_impl="dense"``).
"""

from __future__ import annotations

import torch

from unimm_torch.config import VilbertConfig
from unimm_torch.models import vilbert
from unimm_torch.ops import losses as L
from unimm_torch.ops import masks
from unimm_torch.ops.attention_block import attention_block
from unimm_torch.ops.attention_block_train import attention_block_train
from unimm_torch.ops.co_text_block import co_text_block
from unimm_torch.ops.ffn_block import ffn_block
from unimm_torch.ops.text_attention import text_attention
from unimm_torch.utils import trace

# Label positions gathered per sequence on the flat eval path: the
# generative layout bounds an answer at ~126 label tokens, so 128 covers
# every representable sequence.
MAX_LABEL_POSITIONS = 128

_IMG_KEYS = ("image_feat", "image_loc", "image_mask", "image_target",
             "image_label")


def expand_images(batch):
    """Resolve compact image storage: with ``img_index`` [N] the image
    arrays hold one row per IMAGE and are gathered per sequence here."""
    if batch.get("img_index") is None:
        return batch
    idx = batch["img_index"]
    out = {k: v for k, v in batch.items() if k != "img_index"}
    for k in _IMG_KEYS:
        if out.get(k) is not None:
            out[k] = out[k][idx]
    return out


def encode(model, cfg: VilbertConfig, batch, *, dtype=torch.float32,
           tap=None, train=False, rng=None):
    """Run the two-stream encoder from a descriptor batch (dict of tensors
    on one device): tokens/segments [B, L], mode/ctx_end/ans_len [B],
    image_feat [B, R, F], image_loc [B, R, 5], image_mask [B, R], optional
    img_index [B]. Returns (t_seq, v_seq, pooled_t, pooled_v).

    In eval, ``model`` is best passed already in ``dtype``
    (``cast_floating`` returns such a model as it is; any other is copied
    on every call). In training (``train=True``, dropout drawn from
    ``rng``, a ``vilbert.DropoutRng``) ``model`` must be the
    differentiable compute-dtype view of ``vilbert.call_in_dtype``; it is
    used as it is."""
    batch = expand_images(batch)
    if not train:
        model = vilbert.cast_floating(model, dtype)
    p = model.bert
    Lmax = batch["tokens"].shape[-1]
    mode, ce, al = batch["mode"], batch["ctx_end"], batch["ans_len"]
    t_bias = text_fused_block = text_fused_ffn = text_fused_co = None
    text_fused_block_train = text_fused_attn = None
    impl = cfg.attention_impl
    # the JAX package's rule (unimm_tpu/models/unimm.py:121): the text
    # kernels read one descriptor per text row and the co-attention kernel
    # one image mask per image, which no longer line up once
    # in_batch_pairs crosses the rows or fast_mode broadcasts them, so
    # under either mode the whole encoder runs its plain code
    pairs_ok = not cfg.in_batch_pairs and not cfg.fast_mode
    use_block = impl == "pallas_block" and pairs_ok
    # the JAX package's rule: the per-head kernel has no dropout site, so
    # it trains only at attention dropout 0
    use_pallas = impl == "pallas" and pairs_ok and not (
        train and cfg.attention_probs_dropout_prob > 0)
    if use_block or use_pallas:
        desc = torch.stack([torch.as_tensor(mode), torch.as_tensor(ce),
                            torch.as_tensor(al)], -1).to(torch.int32)
    if use_pallas:
        def text_fused_attn(q, k, v):
            return text_attention(q, k, v, desc)
    elif use_block:
        if train:
            def text_fused_block_train(p_attn, x, r):
                # the fp32 hidden-dropout mask, as the JAX package hands
                # its kernel, then one Philox seed per layer for the
                # probability dropout
                m_o = (vilbert.dropout_scale_mask(r, x.shape,
                                                  cfg.hidden_dropout_prob)
                       if cfg.hidden_dropout_prob > 0 else None)
                seed = (vilbert.dropout_seed(r)
                        if cfg.attention_probs_dropout_prob > 0 else 0)
                return attention_block_train(
                    x, desc, seed, m_o, p_attn,
                    num_heads=cfg.num_attention_heads,
                    attn_drop=cfg.attention_probs_dropout_prob)
        else:
            def text_fused_block(p_attn, x):
                return attention_block(x, desc, p_attn,
                                       num_heads=cfg.num_attention_heads)

            if cfg.fused_ffn:
                def text_fused_ffn(p_inter, p_out, x):
                    return ffn_block(x, p_inter, p_out, act=cfg.hidden_act)

            if cfg.fused_co:
                imask = batch["image_mask"].float().contiguous()

                def text_fused_co(p_conn, v_x, t_x):
                    return co_text_block(
                        t_x, v_x, imask, p_conn,
                        num_heads=cfg.bi_num_attention_heads)
    else:
        t_bias = masks.text_self_bias(mode, ce, al, Lmax, dtype)
    v_bias = masks.image_self_bias(batch["image_mask"], dtype)
    co_bias = masks.co_attention_bias(mode, ce, al, Lmax, dtype)
    pos = batch.get("positions")
    if pos is None:
        pos = masks.position_ids(mode, ce, al, Lmax)
    t_x = vilbert.text_embeddings(p.embeddings, cfg, batch["tokens"].long(),
                                  batch["segments"].long(), pos.long(),
                                  dtype=dtype, train=train, rng=rng)
    v_x = vilbert.image_embeddings(p.v_embeddings, cfg, batch["image_feat"],
                                   batch["image_loc"], dtype=dtype,
                                   train=train, rng=rng)
    t_seq, v_seq = vilbert.encoder(
        p.encoder, cfg, t_x, v_x, t_bias, v_bias, co_bias, tap=tap,
        text_fused_block=text_fused_block, text_fused_ffn=text_fused_ffn,
        text_fused_co=text_fused_co, train=train, rng=rng,
        text_fused_block_train=text_fused_block_train,
        text_fused_attn=text_fused_attn)
    return (t_seq, v_seq, vilbert.pooler(p.t_pooler, t_seq),
            vilbert.pooler(p.v_pooler, v_seq))


def label_positions(mlm_labels, max_positions: int = MAX_LABEL_POSITIONS):
    """Gather indices of label positions per sequence: (positions [B, P]
    int64, labels at them [B, P] with -1 padding). A stable argsort of the
    is-label flag keeps real positions first in their original order."""
    is_lab = mlm_labels != -1
    order = torch.argsort((~is_lab).to(torch.int8), dim=-1, stable=True)
    pos = order[..., :max_positions]
    return pos, torch.gather(mlm_labels, -1, pos)


@torch.no_grad()
def forward_eval(model, cfg: VilbertConfig, batch, *, dtype=torch.bfloat16,
                 need_lm=True, need_nsp=True,
                 max_label_positions: int = MAX_LABEL_POSITIONS,
                 decoder_bias=None):
    """Flat eval scoring pass (reference val_lm.py:121-143 semantics).

    Returns a dict with nsp_logits [B, 2], lm_nll_sum [B] (answer NLL
    summed over label tokens) and lm_nll_mean [B] (token-averaged).

    A caller that scores many chunks passes ``model`` already in
    ``dtype`` (one ``cast_floating`` per model) and ``decoder_bias``, the
    fp32 tied-decoder bias of the source model, which the JAX package
    reads before its compute-dtype cast; without it the bias is read from
    ``model`` and a model in another dtype is cast on this call."""
    if decoder_bias is None:
        decoder_bias = model.cls.predictions.bias.float()
    cast = vilbert.cast_floating(model, dtype)
    t_seq, _, pooled_t, pooled_v = encode(cast, cfg, batch, dtype=dtype)
    out = {}
    if need_nsp:
        pooled = (pooled_t * pooled_v if cfg.fusion_method == "mul"
                  else pooled_t + pooled_v)
        out["nsp_logits"] = vilbert.linear(cast.cls.bi_seq_relationship,
                                           pooled).float()
    if need_lm:
        pos, labs = label_positions(batch["mlm_labels"], max_label_positions)
        hidden = vilbert.mlm_head_at_positions(cast, cfg, t_seq, pos)
        decoder = cast.bert.embeddings.word_embeddings.weight
        nll = L.online_softmax_xent(hidden, decoder, decoder_bias, labs)
        count = (labs != -1).float().sum(-1)
        out["lm_nll_sum"] = nll.sum(-1)
        out["lm_nll_mean"] = out["lm_nll_sum"] / torch.clamp(count, min=1.0)
    return out


def forward_train(model, cfg: VilbertConfig, batch, *, rng=None,
                  nsp_weight=None, dtype=torch.bfloat16, train=True):
    """Training losses (reference vilbert_dialog.py:1559-1624 semantics)
    from the fp32 master ``model``: a dict of scalar fp32 losses lm, img,
    nsp, differentiable in the model's parameters.

    Extra batch keys: mlm_labels [B, L] (-1 ignore), lm_weight [B, L],
    next_sentence_label [B], image_target [B, R, 1601], image_label [B, R];
    optional lm_norm / img_norm / nsp_norm_counts (group normalisers of
    length-bucketed morsels). ``rng`` (a ``vilbert.DropoutRng``) feeds the
    dropout sites when ``train``. The forward runs on a differentiable
    ``dtype`` view of the model; the tied decoder's bias is read in fp32
    from the master weights, as the JAX package reads it before its cast.
    """
    batch = expand_images(batch)
    return vilbert.call_in_dtype(
        model, dtype, _forward_train, cfg, batch, rng=rng,
        nsp_weight=nsp_weight, dtype=dtype, train=train,
        decoder_bias=model.cls.predictions.bias)


def _forward_train(view, cfg, batch, *, rng, nsp_weight, dtype, train,
                   decoder_bias):
    t_seq, v_seq, pooled_t, pooled_v = encode(view, cfg, batch, dtype=dtype,
                                              train=train, rng=rng)
    lm, img_logits, nsp_logits = lm_loss_and_heads(
        view, cfg, t_seq, v_seq, pooled_t, pooled_v, batch, train=train,
        rng=rng, decoder_bias=decoder_bias)
    img_loss_fn = (L.masked_img_loss_mse if cfg.predict_feature
                   else L.masked_img_loss)
    return {
        "lm": lm,
        "img": img_loss_fn(img_logits, batch["image_target"],
                           batch["image_label"], norm=batch.get("img_norm")),
        "nsp": L.nsp_loss(nsp_logits, batch["next_sentence_label"],
                          nsp_weight,
                          norm_counts=batch.get("nsp_norm_counts")),
    }


def lm_loss_and_heads(view, cfg: VilbertConfig, t_seq, v_seq, pooled_t,
                      pooled_v, batch, *, train, rng, decoder_bias):
    """The MLM likelihood + unlikelihood loss and the NSP / image head
    logits, by ``cfg.mlm_loss_impl``: "gathered" takes the NLL at
    ``cfg.max_train_label_positions`` gathered label positions through the
    chunk-recomputing online softmax; "dense" materialises the
    [N, L, vocab] logits (the exactness oracle). ``view`` is the
    compute-dtype model view,
    ``decoder_bias`` the fp32 tied-decoder bias (gathered path; the dense
    path adds the view's bias, as the JAX package does)."""
    norm = batch.get("lm_norm")
    if cfg.mlm_loss_impl == "gathered":
        pos, labs = label_positions(batch["mlm_labels"],
                                    cfg.max_train_label_positions)
        w_g = torch.gather(batch["lm_weight"], -1, pos)
        hidden = vilbert.mlm_head_at_positions(view, cfg, t_seq, pos)
        decoder = view.bert.embeddings.word_embeddings.weight.to(
            hidden.dtype)
        with trace.span("train.mlm_xent"):
            nll = L.online_softmax_xent_vjp(hidden, decoder,
                                            decoder_bias.float(), labs)
            num_tokens = (norm if norm is not None
                          else (batch["lm_weight"] != 0).float().sum())
            lm = L.masked_lm_ul_loss_gathered(nll, labs, w_g, num_tokens)
        img_logits, nsp_logits = vilbert.nsp_and_img_heads(
            view, cfg, v_seq, pooled_t, pooled_v, train=train, rng=rng)
    else:
        mlm_logits, img_logits, nsp_logits = vilbert.pretraining_heads(
            view, cfg, t_seq, v_seq, pooled_t, pooled_v, train=train,
            rng=rng)
        with trace.span("train.mlm_xent"):
            lm = L.masked_lm_ul_loss(mlm_logits, batch["mlm_labels"],
                                     batch["lm_weight"], num_tokens=norm)
    return lm, img_logits, nsp_logits
