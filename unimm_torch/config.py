"""Model configuration for the PyTorch/CUDA UniMM-UL (ViLBERT two-stream)
encoder.

The port's own copy of the JAX package's ``VilbertConfig``: the same model
fields and defaults, read from the same JSON schema as the reference
``BertConfig`` (config/bert_base_6layer_6conect.json), so configuration
files are shared between the two packages, with the JAX package's training
options ``remat``, ``mlm_loss_impl`` and ``max_train_label_positions``.
``attention_impl="pallas_block"`` keeps its name and here means "run the
hand-written Hopper kernels" on the paths that have them (eval, and the
training step's text attention blocks); ``"pallas"`` runs only the text
self-attention core on the per-head kernel; ``"xla"`` means the plain
PyTorch versions.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class VilbertConfig:
    # --- text stream -------------------------------------------------------
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    # the fused NSP-pooling dropout is hard-coded 0.1 in the reference
    # (BertPreTrainingHeads); a field so determinism checks can zero it
    head_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    # --- vision stream -----------------------------------------------------
    v_feature_size: int = 2048
    v_target_size: int = 1601
    v_hidden_size: int = 1024
    v_num_hidden_layers: int = 6
    v_num_attention_heads: int = 8
    v_intermediate_size: int = 1024
    v_attention_probs_dropout_prob: float = 0.1
    v_hidden_act: str = "gelu"
    v_hidden_dropout_prob: float = 0.1
    v_initializer_range: float = 0.02
    # --- co-attention ------------------------------------------------------
    bi_hidden_size: int = 1024
    bi_num_attention_heads: int = 8
    v_biattention_id: Tuple[int, ...] = (0, 1, 2, 3, 4, 5)
    t_biattention_id: Tuple[int, ...] = (6, 7, 8, 9, 10, 11)
    # --- misc (reference knobs; defaults match the shipped config) ---------
    predict_feature: bool = False
    fast_mode: bool = False
    fixed_v_layer: int = 0
    fixed_t_layer: int = 0
    in_batch_pairs: bool = False
    fusion_method: str = "mul"
    with_coattention: bool = True
    # --- serving additions -------------------------------------------------
    max_seq_len: int = 256          # dialog sequence length
    max_regions: int = 37           # region count incl. the global <IMG> row
    # "pallas_block" runs the Hopper kernels: the prefix scorer's answer
    # pass (ops/answer_block.py, ops/ffn_block.py, ops/xent_head.py) and
    # the flat scorer's text stream (ops/attention_block.py,
    # ops/ffn_block.py, ops/co_text_block.py) and, in training, the text
    # attention blocks (ops/attention_block_train.py); "xla" runs their
    # plain PyTorch versions. The prefix scorer's context prefill is plain
    # PyTorch either way. "pallas" runs the text self-attention core of the
    # flat scorer and of training (at attention dropout 0) on the per-head
    # kernel (ops/text_attention.py); the projections, Wo, dropout,
    # LayerNorm and everything else stay plain, and so does the prefix
    # scorer.
    attention_impl: str = "pallas_block"
    # under "pallas_block": also route the text FFNs through the FFN kernel
    fused_ffn: bool = True
    # under "pallas_block": also route the text side of every connection
    # layer of the flat scorer through the co-attention kernel
    fused_co: bool = False
    # --- training (the JAX package's defaults) -----------------------------
    # rematerialise encoder layers in the backward pass (whole text, vision
    # and connection layers; only the text FFN under the training block
    # kernel), replaying the dropout stream on the recompute
    remat: bool = False
    # training MLM loss: "gathered" takes the NLL at <=
    # max_train_label_positions gathered label positions through the
    # chunk-recomputing online softmax (no [N, L, vocab] logits in either
    # pass); "dense" materialises the full logits as the reference does
    mlm_loss_impl: str = "gathered"
    # per-sequence label budget of the gathered path (labels past it are
    # dropped; train/step.py counts such sequences and can route them to
    # the dense path)
    max_train_label_positions: int = 160

    def __post_init__(self):
        if len(self.v_biattention_id) != len(self.t_biattention_id):
            raise ValueError("v_biattention_id and t_biattention_id differ "
                             "in length")
        if self.v_biattention_id and (
                max(self.v_biattention_id) >= self.v_num_hidden_layers
                or max(self.t_biattention_id) >= self.num_hidden_layers):
            raise ValueError("biattention id past the last layer")
        for dim, heads in ((self.hidden_size, self.num_attention_heads),
                           (self.v_hidden_size, self.v_num_attention_heads),
                           (self.bi_hidden_size,
                            self.bi_num_attention_heads)):
            if dim % heads:
                raise ValueError(f"width {dim} not divisible by {heads} "
                                 "heads")
        if self.fusion_method not in ("mul", "sum"):
            raise ValueError(f"fusion_method {self.fusion_method!r}")
        if self.attention_impl not in ("xla", "pallas", "pallas_block"):
            raise ValueError(f"attention_impl {self.attention_impl!r}: the "
                             "port has 'xla' (plain), 'pallas' (per-head "
                             "attention kernel) and 'pallas_block' (block "
                             "kernels)")
        if self.mlm_loss_impl not in ("gathered", "dense"):
            raise ValueError(f"mlm_loss_impl {self.mlm_loss_impl!r}")

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_dict(cls, d: dict) -> "VilbertConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        known = {}
        for k, v in d.items():
            if k == "pooling_method":       # reference JSON alias
                known["fusion_method"] = v
            elif k in fields:
                known[k] = tuple(v) if isinstance(v, list) else v
            # unknown keys (bi_intermediate_size, ..., and the JAX
            # package's other options) are accepted and ignored, as the
            # reference from_dict does
        return cls(**known)

    @classmethod
    def from_json_file(cls, path: str) -> "VilbertConfig":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def replace(self, **kw) -> "VilbertConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class DeepseekV3Config:
    """The DeepSeek-V3 decoder (Kimi-VL-A3B's language model): multi-head
    latent attention and a mixture of experts, read from the Hugging Face
    ``config.json`` keys (``text_config`` of Kimi-VL-A3B-Instruct); the
    defaults are that model's. Unknown keys are accepted and ignored."""
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 2.446
    kv_lora_rank: int = 512
    q_lora_rank: object = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    topk_method: str = "noaux_tc"
    scoring_func: str = "sigmoid"
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = True
    moe_layer_freq: int = 1
    first_k_dense_replace: int = 1
    hidden_act: str = "silu"
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    rope_scaling: object = None
    max_position_embeddings: int = 131072
    attention_bias: bool = False
    tie_word_embeddings: bool = False

    def __post_init__(self):
        if self.q_lora_rank is not None:
            raise ValueError("q_lora_rank: only the full q projection "
                             "(None) is implemented")
        if self.rope_scaling is not None:
            raise ValueError("rope_scaling: only plain RoPE (None) is "
                             "implemented")
        if (self.topk_method, self.scoring_func) != ("noaux_tc", "sigmoid"):
            raise ValueError("routing: only noaux_tc over sigmoid scores")
        if self.n_group != 1 or self.topk_group != 1:
            raise ValueError("routing: only one expert group")
        if self.hidden_act != "silu" or self.attention_bias:
            raise ValueError("silu experts and bias-free projections only")
        if self.moe_layer_freq != 1 or self.tie_word_embeddings:
            raise ValueError("every layer past the dense ones has experts; "
                             "the LM head is untied")

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace

    @classmethod
    def from_dict(cls, d: dict) -> "DeepseekV3Config":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def replace(self, **kw) -> "DeepseekV3Config":
        return dataclasses.replace(self, **kw)
