"""Synthetic VisDial-format data for tests and CLI smoke runs: tiny vocab,
processed-JSON dialog files, dense annotations, and region features —
matching the reference's file schemas.

The port's copy of ``tests/fixtures.py``'s ``write_fixture_tree`` and the
helpers it calls, on the port's own tokenizer and feature reader, so that a
run on the card (chip_smoke.py phase 11) can write a tree without the JAX
package: the same seed writes the same files byte for byte
(tests/test_torch_data.py). ``feat_dim`` / ``n_classes`` set the region
features' widths (2048 and 1601 for ``config/bert_base_6layer_6conect
.json``), ``n_train`` / ``n_val`` / ``n_test`` the dialogs of each split.
``features.convert_npz_to_lmdb`` turns the tree's ``features.npz`` into a
reference-format LMDB.
"""

import base64
import json
import os

import numpy as np

from unimm_torch.data.features import DictFeatureReader
from unimm_torch.data.tokenizer import WordPieceTokenizer

N_WORDS = 200


def make_tokenizer() -> WordPieceTokenizer:
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "[MASK]": 4}
    for i in range(N_WORDS):
        vocab[f"w{i}"] = len(vocab)
    return WordPieceTokenizer(vocab)


def _sentence(rng, lo=2, hi=7):
    return " ".join(f"w{int(rng.integers(N_WORDS))}"
                    for _ in range(int(rng.integers(lo, hi))))


def make_visdial_json(rng, n_dialogs, n_rounds=10, n_answers=300,
                      n_questions=150, with_round_id=False):
    questions = [_sentence(rng) for _ in range(n_questions)]
    answers = [_sentence(rng, 1, 5) for _ in range(n_answers)]
    dialogs = []
    for d in range(n_dialogs):
        rounds = []
        for r in range(n_rounds):
            opts = rng.permutation(n_answers)[:100].tolist()
            gt_index = int(rng.integers(100))
            rounds.append({
                "question": int(rng.integers(n_questions)),
                "answer": opts[gt_index],
                "answer_options": opts,
                "gt_index": gt_index,
            })
        dialog = {"image_id": 1000 + d, "caption": _sentence(rng, 3, 9),
                  "dialog": rounds}
        if with_round_id:
            dialog["round_id"] = n_rounds
        dialogs.append(dialog)
    return {"data": {"dialogs": dialogs, "questions": questions,
                     "answers": answers}}


def make_dense_annotations(rng, data, n_rounds=10):
    out = []
    for dialog in data["data"]["dialogs"]:
        rel = np.zeros(100, np.float32)
        hot = rng.permutation(100)[: int(rng.integers(3, 10))]
        rel[hot] = rng.choice([0.2, 0.4, 0.5, 0.8, 1.0], size=len(hot))
        rid = int(rng.integers(1, n_rounds + 1))
        gt = dialog["dialog"][rid - 1]["gt_index"]
        rel[gt] = max(rel[gt], 0.5)
        out.append({"image_id": dialog["image_id"], "round_id": rid,
                    "gt_relevance": rel.tolist(), "relevance": rel.tolist()})
    return out


def make_feature_records(rng, image_ids, feat_dim=2048, n_classes=1601,
                         b64=False):
    records = {}
    for img_id in image_ids:
        n = int(rng.integers(8, 24))
        feats = rng.normal(size=(n, feat_dim)).astype(np.float32)
        boxes = np.abs(rng.normal(size=(n, 4))).astype(np.float32) * 100
        boxes[:, 2:] += boxes[:, :2]
        cls_prob = rng.dirichlet(np.ones(n_classes), n).astype(np.float32)
        rec = {"image_id": img_id, "image_h": 480, "image_w": 640,
               "num_boxes": n, "feature_size": feat_dim,
               "num_classes": n_classes}
        if b64:
            rec["features"] = base64.b64encode(feats.tobytes())
            rec["boxes"] = base64.b64encode(boxes.tobytes())
            rec["cls_prob"] = base64.b64encode(cls_prob.tobytes())
        else:
            rec.update(features=feats, boxes=boxes, cls_prob=cls_prob)
        records[img_id] = rec
    return records


def write_feature_npz(records, npz_path):
    """Export feature records to the pickle-free .npz layout the
    NpzFeatureReader parses ('<id>_features/_boxes/_cls_prob/_hw')."""
    arrays = {}
    for i, rec in records.items():
        arrays[f"{i}_features"] = rec["features"]
        arrays[f"{i}_boxes"] = rec["boxes"]
        arrays[f"{i}_cls_prob"] = rec["cls_prob"]
        arrays[f"{i}_hw"] = np.asarray([rec["image_h"], rec["image_w"]],
                                       np.int32)
    np.savez(npz_path, **arrays)


def write_fixture_tree(root, n_train=6, n_val=3, n_test=2, seed=0,
                       feat_dim=64, n_classes=32):
    """Write a full synthetic data tree + params dict pointing at it."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    train = make_visdial_json(rng, n_train)
    val = make_visdial_json(rng, n_val)
    test = make_visdial_json(rng, n_test, with_round_id=True)
    val_dense = make_dense_annotations(rng, val)
    # pad so overfit mode (val := train, dataloader_visdial.py:107-108) can
    # still index a dense entry per item, as the real 2064-entry file does
    while len(val_dense) < n_train:
        val_dense.append(dict(val_dense[len(val_dense) % n_val]))
    train_dense_ann = make_dense_annotations(rng, train)

    paths = {}
    for name, blob in [("train", train), ("val", val), ("test", test)]:
        p = os.path.join(root, f"visdial_1.0_{name}_processed.json")
        with open(p, "w") as f:
            json.dump(blob, f)
        paths[f"visdial_processed_{name}"] = p
    p = os.path.join(root, "visdial_1.0_val_dense_annotations_processed.json")
    with open(p, "w") as f:
        json.dump(val_dense, f)
    paths["visdial_processed_val_dense_annotations"] = p
    p = os.path.join(root, "visdial_1.0_train_dense_processed.json")
    with open(p, "w") as f:
        json.dump(train, f)
    paths["visdial_processed_train_dense"] = p
    p = os.path.join(root, "visdial_1.0_train_dense_annotations_processed.json")
    with open(p, "w") as f:
        json.dump(train_dense_ann, f)
    paths["visdial_processed_train_dense_annotations"] = p

    vocab_path = os.path.join(root, "vocab.txt")
    tok = make_tokenizer()
    with open(vocab_path, "w") as f:
        for t, i in sorted(tok.vocab.items(), key=lambda kv: kv[1]):
            f.write(t + "\n")
    paths["vocab_path"] = vocab_path

    image_ids = ([d["image_id"] for d in train["data"]["dialogs"]] +
                 [d["image_id"] for d in val["data"]["dialogs"]] +
                 [d["image_id"] for d in test["data"]["dialogs"]])
    records = make_feature_records(rng, image_ids, feat_dim=feat_dim,
                                   n_classes=n_classes)

    # also write an .npz so CLIs can be driven from a real shell command
    npz_path = os.path.join(root, "features.npz")
    write_feature_npz(records, npz_path)
    paths["visdial_image_feats"] = npz_path
    return paths, tok, DictFeatureReader(records)
