"""Multi-task V+L heads (VQA-style): VILBertForVLTasks' heads and its
SimpleClassifier over the two-stream encoder.

The port of the JAX package's ``models/vl_tasks.py``. No entry point of
either package calls these heads; they are part of the model file's
surface for downstream multi-task use: ``vil_prediction`` (a weight-normed
MLP classifier over the fused pooled output), ``vil_logit``, a
per-region ``vision_logit`` with the padding bias, a per-token linguistic
logit, beside the standard pretraining heads.

``add_task_heads`` puts a ``TaskHeads`` on a model as ``model.task_heads``
(never ``VilbertModel`` itself, so the reference state dict and every
checkpoint without heads keep their keys). Its ``state_dict`` names are
the JAX package's pytree paths under ``params["task_heads"]`` as
``checkpoint.torch_name`` writes them, ``linguisic_logit`` keeping the
reference's spelling, so ``checkpoint.state_dict_from_jax`` of a tree with
heads loads strictly. The three logits are ``nn.Linear``s (a JAX
``kernel``); the weight-normed linears keep the JAX layout, ``weight_v``
[in, out] applied as ``x @ w`` and ``weight_g`` 0-d, which is what a
reference-format file of either package holds (only a ``kernel`` is
transposed on export). A torch ``weight_norm`` Linear would hold
``weight_v`` as [out, in].

The heads compute in fp32 whatever the encoder's dtype, as the JAX
package's do (its fp32 head parameters promote the bf16 activations);
their weights are the ones the model holds, so a model cast to bf16
brings bf16-rounded head weights.
"""

from __future__ import annotations

from typing import Union

import torch
import torch.nn.functional as F
from torch import nn

from unimm_torch.config import VilbertConfig
from unimm_torch.models import unimm, vilbert
from unimm_torch.models.vilbert import Node, dropout


class WeightNormLinear(nn.Module):
    """torch ``weight_norm(Linear, dim=None)`` in the JAX layout: the
    direction ``weight_v`` [in, out], the scalar magnitude ``weight_g``."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(n_in, n_out))
        self.weight_g = nn.Parameter(torch.empty(()))
        self.bias = nn.Parameter(torch.empty(n_out))


def weight_norm_linear(p: WeightNormLinear, x):
    """x @ w + b with w = g * v / ||v||_F (the norm over the whole
    tensor), in fp32."""
    v = p.weight_v.float()
    w = v * (p.weight_g.float() / torch.linalg.vector_norm(v))
    return torch.matmul(x.float(), w) + p.bias.float()


def _linear32(p: nn.Linear, x):
    return F.linear(x.float(), p.weight.float(), p.bias.float())


class TaskHeads(nn.Module):
    """The task heads' parameters (``model.task_heads``)."""

    def __init__(self, cfg: VilbertConfig, num_labels: int):
        super().__init__()
        bi = cfg.bi_hidden_size
        # SimpleClassifier's Sequential: Linear, ReLU, Dropout, Linear
        self.vil_prediction = Node(**{
            "0": WeightNormLinear(bi, bi * 2),
            "3": WeightNormLinear(bi * 2, num_labels)})
        self.vil_logit = nn.Linear(bi, 1)
        self.vision_logit = nn.Linear(cfg.v_hidden_size, 1)
        self.linguisic_logit = nn.Linear(cfg.hidden_size, 1)


@torch.no_grad()
def init_task_heads(cfg: VilbertConfig, num_labels: int,
                    seed: Union[int, torch.Generator] = 0,
                    device="cuda") -> TaskHeads:
    """fp32 heads initialised as the JAX package's ``init_task_heads``:
    each weight-normed linear's ``weight_v`` normal(0, initializer_range),
    ``weight_g`` its Frobenius norm (so w = v at init), bias zero; the
    three logits as ``vilbert.init_model``'s Linears. ``seed`` is an int
    or a ``torch.Generator`` (whose device the heads then take); the
    stream differs from JAX's."""
    if isinstance(seed, torch.Generator):
        gen, dev = seed, seed.device
    else:
        dev = vilbert.resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    with torch.device("meta"):
        heads = TaskHeads(cfg, num_labels)
    heads = heads.to_empty(device=dev)
    std = cfg.initializer_range
    for mod in heads.modules():
        if isinstance(mod, WeightNormLinear):
            mod.weight_v.normal_(0.0, std, generator=gen)
            mod.weight_g.copy_(torch.linalg.vector_norm(mod.weight_v))
            mod.bias.zero_()
        elif isinstance(mod, nn.Linear):
            mod.weight.normal_(0.0, std, generator=gen)
            mod.bias.zero_()
    return heads


def add_task_heads(model: nn.Module, cfg: VilbertConfig, num_labels: int,
                   seed: Union[int, torch.Generator] = 0) -> nn.Module:
    """``model`` with ``init_task_heads`` on its device as
    ``model.task_heads``, in its train / eval mode and with gradients on
    where the model's are. Returns ``model``."""
    ref = model.bert.t_pooler.dense.weight
    heads = init_task_heads(cfg, num_labels, seed, ref.device)
    model.task_heads = heads.train(model.training).requires_grad_(
        ref.requires_grad)
    return model


def simple_classifier(p, x, *, train=False, rng=None):
    """SimpleClassifier: weight-normed linear, ReLU, dropout 0.5,
    weight-normed linear."""
    h = F.relu(weight_norm_linear(getattr(p, "0"), x))
    h = dropout(h, 0.5, train, rng)
    return weight_norm_linear(getattr(p, "3"), h)


def vl_tasks_forward(model, cfg: VilbertConfig, batch, *, train=False,
                     rng=None, dtype=torch.float32, dropout_prob=0.1):
    """VILBertForVLTasks.forward over a model with ``task_heads``.

    ``batch`` is a descriptor batch as ``unimm.encode`` takes it (compact
    ``img_index`` storage included); ``model``, ``train``, ``rng`` and
    ``dtype`` as there. Returns, in the JAX package's order,
    (vil_prediction [B, num_labels], vil_logit [B, 1], nsp_logits [B, 2],
    img_logits [B, R, v_target_size], vision_logit [B, R, 1], mlm_logits
    [B, L, vocab], linguistic_logit [B, L, 1]); the padded regions of
    ``vision_logit`` carry -10000.

    The task dropouts draw from ``rng`` after ``pretraining_heads`` has
    drawn its own, so no mask is drawn twice from one state (the JAX
    package gives them a key of their own for the same reason).
    ``vision_logit`` needs one image a row: under ``in_batch_pairs`` with
    B > 1 the encoder gives B * B rows for B image masks, and this
    raises."""
    if cfg.in_batch_pairs and batch["tokens"].shape[0] > 1:
        raise ValueError(
            "vl_tasks_forward: in_batch_pairs crosses B text rows with B "
            "images into B * B rows, and vision_logit's padding bias has "
            "one image mask a row; run it without in_batch_pairs (or "
            "with fast_mode, one text row over the images)")
    batch = unimm.expand_images(batch)
    pt = model.task_heads                  # as given: the fp32 weights
    if not train:
        model = vilbert.cast_floating(model, dtype)
    t_seq, v_seq, pooled_t, pooled_v = unimm.encode(
        model, cfg, batch, dtype=dtype, train=train, rng=rng)
    mlm_logits, img_logits, nsp_logits = vilbert.pretraining_heads(
        model, cfg, t_seq, v_seq, pooled_t, pooled_v, train=train, rng=rng)

    pooled = (pooled_t * pooled_v if cfg.fusion_method == "mul"
              else pooled_t + pooled_v)
    pooled = dropout(pooled, dropout_prob, train, rng)
    vil_prediction = simple_classifier(pt.vil_prediction, pooled,
                                       train=train, rng=rng)
    vil_logit = _linear32(pt.vil_logit, pooled)
    pad = (1.0 - batch["image_mask"].float()) * -10000.0
    vision_logit = (_linear32(pt.vision_logit,
                              dropout(v_seq, dropout_prob, train, rng))
                    + pad[..., None])
    linguistic_logit = _linear32(pt.linguisic_logit,
                                 dropout(t_seq, dropout_prob, train, rng))
    return (vil_prediction, vil_logit, nsp_logits, img_logits, vision_logit,
            mlm_logits, linguistic_logit)
