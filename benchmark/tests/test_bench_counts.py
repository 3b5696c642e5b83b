"""The work counts against hand-worked small cases."""

import numpy as np

from benchmark.counts import vilbert as counts

CFG = {"hidden_size": 4, "intermediate_size": 8, "v_hidden_size": 2,
       "v_intermediate_size": 3, "bi_hidden_size": 2, "max_regions": 3,
       "v_feature_size": 5, "vocab_size": 10, "num_hidden_layers": 2,
       "v_num_hidden_layers": 1, "t_biattention_id": [1],
       "v_biattention_id": [0], "v_target_size": 7, "max_seq_len": 8}


def test_text_layer_by_hand():
    # Q, K, V, O: 4 x 2*3*4*4 = 384; FFN 2 x 2*3*4*8 = 384; attention
    # 2 products x 2*5 pairs*4 = 80
    assert counts.text_layer(CFG, rows=3, pairs=5) == 384 + 384 + 80


def test_open_pairs_by_hand():
    # discriminative, 3 real tokens: 9 pairs; generative L=4 (ctx_end),
    # A=1, n=8: [CLS] row 5 keys (T=5), context rows 1..2 attend 1..2
    # (2 each), first-copy row 3 attends 1..3 (3), masked row 4 attends
    # 1..2 and itself (3): 5 + 4 + 3 + 3 = 15
    p = counts.open_pairs(np.array([0, 1]), np.array([3, 4]),
                          np.array([0, 1]), 8)
    assert p.tolist() == [9, 15]


def test_ffn_act_by_hand():
    flops, nbytes = counts.ffn_act(CFG, tokens=10, launches=2)
    assert flops == 2 * 10 * 4 * 8
    assert nbytes == 10 * (4 + 8) * 2 + 2 * (4 * 8 + 8) * 2


def test_gen_counts_answer_rows_only():
    # one slate, two options: context 3 tokens, answers 1 and 2 tokens
    # (2 and 4 rows); the FFN tokens are the answer rows of 2 + 1 layers
    b = {"tokens": np.zeros((1, 1, 2, 8), np.int32),
         "ctx_end": np.array([[[4, 5]]]), "ans_len": np.array([[[1, 2]]]),
         "mlm_labels": np.full((1, 1, 2, 8), -1)}
    b["mlm_labels"][0, 0, 0, 4] = 1
    b["mlm_labels"][0, 0, 1, 5:7] = 1
    got = counts.gen_slates(CFG, b)
    assert got["ffn_tokens"] == (2 + 4) * 3
    assert got["model_flops"] > counts.label_head(CFG, 3)


def test_train_counts_scale_with_work():
    n = 8
    b = {"tokens": np.zeros((2, n), np.int32), "mode": np.array([0, 0]),
         "ctx_end": np.array([3, 6]), "ans_len": np.array([0, 0]),
         "mlm_labels": np.full((2, n), -1), "image_label": np.zeros((2, 3))}
    got = counts.train_batch(CFG, b)
    assert got["attn_bwd_flops"] == 2 * 8 * (9 + 36) * 4
    assert got["attn_bwd_bytes"] == 2 * 8 * (3 + 6) * 4 * 2
    fwd = counts.encoder(CFG, 3, 9) + counts.encoder(CFG, 6, 36)
    assert got["model_flops"] == 3 * fwd
