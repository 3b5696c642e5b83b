"""UniMM-UL top-level eval functions: descriptors -> biases -> encoder ->
answer log-likelihoods.

The port of the JAX package's ``models/unimm.py`` eval path on its bias
branch. ``encode`` is what the prefix scorer's context prefill runs;
``forward_eval`` is the flat full-sequence scorer, the oracle the tests hold
the prefix scorer against. Answer NLL is taken at gathered label positions
by an online softmax over the tied decoder; the [N, L, vocab] logits never
exist.
"""

from __future__ import annotations

import torch

from unimm_torch.config import VilbertConfig
from unimm_torch.models import vilbert
from unimm_torch.ops import losses as L
from unimm_torch.ops import masks

# Label positions gathered per sequence on the flat eval path: the
# generative layout bounds an answer at ~126 label tokens, so 128 covers
# every representable sequence.
MAX_LABEL_POSITIONS = 128

_IMG_KEYS = ("image_feat", "image_loc", "image_mask")


def expand_images(batch):
    """Resolve compact image storage: with ``img_index`` [N] the image
    arrays hold one row per IMAGE and are gathered per sequence here."""
    if batch.get("img_index") is None:
        return batch
    idx = batch["img_index"]
    out = {k: v for k, v in batch.items() if k != "img_index"}
    for k in _IMG_KEYS:
        if k in out:
            out[k] = out[k][idx]
    return out


def encode(model, cfg: VilbertConfig, batch, *, dtype=torch.float32,
           tap=None):
    """Run the two-stream encoder from a descriptor batch (dict of tensors
    on one device): tokens/segments [B, L], mode/ctx_end/ans_len [B],
    image_feat [B, R, F], image_loc [B, R, 5], image_mask [B, R], optional
    img_index [B]. Returns (t_seq, v_seq, pooled_t, pooled_v)."""
    batch = expand_images(batch)
    model = vilbert.cast_floating(model, dtype)
    p = model.bert
    Lmax = batch["tokens"].shape[-1]
    mode, ce, al = batch["mode"], batch["ctx_end"], batch["ans_len"]
    t_bias = masks.text_self_bias(mode, ce, al, Lmax, dtype)
    v_bias = masks.image_self_bias(batch["image_mask"], dtype)
    co_bias = masks.co_attention_bias(mode, ce, al, Lmax, dtype)
    pos = batch.get("positions")
    if pos is None:
        pos = masks.position_ids(mode, ce, al, Lmax)
    t_x = vilbert.text_embeddings(p.embeddings, cfg, batch["tokens"].long(),
                                  batch["segments"].long(), pos.long(),
                                  dtype=dtype)
    v_x = vilbert.image_embeddings(p.v_embeddings, cfg, batch["image_feat"],
                                   batch["image_loc"], dtype=dtype)
    t_seq, v_seq = vilbert.encoder(p.encoder, cfg, t_x, v_x, t_bias, v_bias,
                                   co_bias, tap=tap)
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
                 max_label_positions: int = MAX_LABEL_POSITIONS):
    """Flat eval scoring pass (reference val_lm.py:121-143 semantics).

    Returns a dict with nsp_logits [B, 2], lm_nll_sum [B] (answer NLL
    summed over label tokens) and lm_nll_mean [B] (token-averaged)."""
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
        # the fp32 decoder bias of the uncast model, as the JAX package reads
        # it before the compute-dtype cast
        bias = model.cls.predictions.bias.float()
        nll = L.online_softmax_xent(hidden, decoder, bias, labs)
        count = (labs != -1).float().sum(-1)
        out["lm_nll_sum"] = nll.sum(-1)
        out["lm_nll_mean"] = out["lm_nll_sum"] / torch.clamp(count, min=1.0)
    return out
