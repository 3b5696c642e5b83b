"""Model configuration for the PyTorch/CUDA UniMM-UL (ViLBERT two-stream)
encoder.

The port's own copy of the JAX package's ``VilbertConfig``: the same model
fields and defaults, read from the same JSON schema as the reference
``BertConfig`` (config/bert_base_6layer_6conect.json), so configuration
files are shared between the two packages; the JAX package's training
options are not carried. ``attention_impl="pallas_block"`` keeps its name
and here means "run the hand-written Hopper kernels" on the eval paths that
have them; ``"xla"`` means the plain PyTorch versions.
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
    # answer-pass implementation: "pallas_block" runs the Hopper kernels
    # (ops/answer_block.py, ops/ffn_block.py, ops/xent_head.py); "xla" runs
    # their plain PyTorch versions. The context prefill is plain PyTorch
    # either way.
    attention_impl: str = "pallas_block"
    # under "pallas_block": also route the answer pass's text FFNs through
    # the FFN kernel
    fused_ffn: bool = True

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
        if self.attention_impl not in ("xla", "pallas_block"):
            raise ValueError(f"attention_impl {self.attention_impl!r}: the "
                             "port has 'xla' (plain) and 'pallas_block' "
                             "(Hopper kernels)")

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
            # package's training options) are accepted and ignored, as the
            # reference from_dict does
        return cls(**known)

    @classmethod
    def from_json_file(cls, path: str) -> "VilbertConfig":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def replace(self, **kw) -> "VilbertConfig":
        return dataclasses.replace(self, **kw)
