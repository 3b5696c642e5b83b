"""Small shapes of the benchmark's cells for CPU tests: the cells' own
files with the model cut in depth and sequence length to a CPU's size
(the kernels' plain versions run there)."""

import copy
import json

from benchmark.harness import spec as spec_mod

# the context growth the slate mixes state
GROWTH = json.loads((spec_mod.ROOT / "benchmark" / "traffic" /
                     "visdial-val-gen-realistic.json").read_text()
                    )["ctx_growth"]

# the published widths, vocabulary and regions, four text, two region
# and two connection layers, sequences of 64: small enough for the CPU,
# wide enough that the limits set at the cells' sizes apply
TINY_MODEL = {
    "vocab_size": 30522, "hidden_size": 768, "num_hidden_layers": 4,
    "num_attention_heads": 12, "intermediate_size": 3072,
    "hidden_act": "gelu", "hidden_dropout_prob": 0.1,
    "attention_probs_dropout_prob": 0.1, "max_position_embeddings": 512,
    "type_vocab_size": 2, "initializer_range": 0.02,
    "v_feature_size": 2048, "v_target_size": 1601, "v_hidden_size": 1024,
    "v_num_hidden_layers": 2, "v_num_attention_heads": 8,
    "v_intermediate_size": 1024, "v_attention_probs_dropout_prob": 0.1,
    "v_hidden_act": "gelu", "v_hidden_dropout_prob": 0.1,
    "bi_hidden_size": 1024, "bi_num_attention_heads": 8,
    "v_biattention_id": [0, 1], "t_biattention_id": [2, 3],
    "fusion_method": "mul", "max_seq_len": 64, "max_regions": 37,
    "head_dropout_prob": 0.1}


# every width cut too: for comparisons of two fp32 computations
NARROW_MODEL = dict(
    TINY_MODEL, vocab_size=300, hidden_size=64, num_hidden_layers=3,
    num_attention_heads=2, intermediate_size=128, max_position_embeddings=128,
    v_feature_size=32, v_target_size=20, v_hidden_size=64,
    v_num_attention_heads=2, v_intermediate_size=64, bi_hidden_size=64,
    bi_num_attention_heads=2, v_biattention_id=[0, 1],
    t_biattention_id=[1, 2], max_regions=5)


def tiny_spec(cell: str, model=None, **load_kw):
    """The spec of ``cell`` at small shapes: the tiny model (or ``model``)
    under the cell's own program settings, a few dialogs or short
    batches, the cell's own limits."""
    sp = spec_mod.load(cell, **load_kw)
    cfg = copy.deepcopy(sp.config)
    cfg.update(TINY_MODEL if model is None else model)
    sp.config = cfg
    t = dict(sp.traffic)
    if t["kind"] == "slates":
        t.update(dialogs=t["loader_batch"] * t["coalesce"] * 2, rounds=2,
                 options=6)
        sp.check = dict(sp.check, slates=4)
    else:
        # 40 rows: over fewer, the sound bf16 loss gap reads above the
        # cell's limit
        t.update(batch=40, ctx_range=[20, 50], labels_range=[3, 9])
        sp.check = dict(sp.check, block_rows=20)
    sp.traffic = t
    return sp
