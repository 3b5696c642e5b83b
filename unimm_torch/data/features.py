"""Region-feature storage: record decoding + pluggable readers.

The port's copy of the JAX package's ``data/features.py``.

The reference reads Faster R-CNN region features from an LMDB of pickled
records (the reference's utils/image_features_reader.py:33-146): per image a
dict with base64-encoded ``features [n,2048]``, ``boxes [n,4]``,
``cls_prob [n,1601]`` plus image size. ``process_record`` replicates its
post-processing exactly: prepend a global <IMG> row (mean feature, full-image
box, one-hot background class), build 5-dim normalised box locations
(x1,y1,x2,y2,relative-area).

Readers:
* ``LmdbFeatureReader`` — reads the reference's actual LMDB file via
  unimm_torch.native.lmdb (from-scratch mdb-format reader; no liblmdb
  needed);
* ``NpzFeatureReader`` — a single-file .npz layout (faster cold reads, no
  pickle) with a converter;
* ``DictFeatureReader`` — in-memory records for tests.
"""

from __future__ import annotations

import base64
import pickle
from typing import Dict

import numpy as np


def decode_record(item: dict):
    """Raw pickled record -> (features [n,2048], boxes [n,4], cls_prob
    [n,1601], image_h, image_w). Accepts base64 or ndarray fields."""
    n = int(item["num_boxes"])

    def field(name, width):
        v = item[name]
        if isinstance(v, (bytes, str)):
            v = np.frombuffer(base64.b64decode(v), dtype=np.float32)
        v = np.asarray(v, np.float32)
        if v.ndim == 2:          # already shaped (possibly non-default width)
            assert v.shape[0] == n, (name, v.shape, n)
            return v
        return v.reshape(n, width)

    return (field("features", int(item.get("feature_size", 2048))),
            field("boxes", 4),
            field("cls_prob", int(item.get("num_classes", 1601))),
            int(item["image_h"]), int(item["image_w"]))


def process_record(item: dict):
    """image_features_reader.py:112-146 semantics. Returns
    (features, num_boxes, image_location, image_location_ori, cls_prob) with
    the global <IMG> row prepended to each."""
    features, boxes, cls_prob, image_h, image_w = decode_record(item)
    n = features.shape[0]

    g_cls = np.zeros((1, cls_prob.shape[1]), np.float32)
    g_cls[0, 0] = 1.0
    cls_prob = np.concatenate([g_cls, cls_prob], axis=0)

    g_feat = (features.sum(axis=0) / n)[None, :]
    features = np.concatenate([g_feat, features], axis=0)

    loc = np.zeros((n, 5), np.float32)
    loc[:, :4] = boxes
    loc[:, 4] = ((loc[:, 3] - loc[:, 1]) * (loc[:, 2] - loc[:, 0])
                 / (float(image_w) * float(image_h)))
    loc_ori = loc.copy()
    loc[:, 0] /= float(image_w)
    loc[:, 1] /= float(image_h)
    loc[:, 2] /= float(image_w)
    loc[:, 3] /= float(image_h)
    g_loc = np.array([[0, 0, 1, 1, 1]], np.float32)
    loc = np.concatenate([g_loc, loc], axis=0)
    g_loc_ori = np.array([[0, 0, image_w, image_h, image_w * image_h]],
                         np.float32)
    loc_ori = np.concatenate([g_loc_ori, loc_ori], axis=0)

    return features, n + 1, loc, loc_ori, cls_prob


class DictFeatureReader:
    """In-memory {image_id: raw record dict} (tests / tiny runs)."""

    def __init__(self, records: Dict[int, dict]):
        self.records = {int(k): v for k, v in records.items()}

    def keys(self):
        return list(self.records)

    def __len__(self):
        return len(self.records)

    def __getitem__(self, image_id):
        return process_record(self.records[int(image_id)])


class LmdbFeatureReader:
    """Reads the reference visdial_img_feat.lmdb (keys = str(image_id),
    values = pickled record dicts; a 'keys' entry lists all ids)."""

    def __init__(self, path: str, cache: bool = False):
        from unimm_torch.native import lmdb as nlmdb
        self.db = nlmdb.open(path)
        raw = self.db.get(b"keys")
        self._keys = pickle.loads(raw) if raw is not None else None
        self._cache = {} if cache else None

    def keys(self):
        return self._keys

    def __getitem__(self, image_id):
        if self._cache is not None and int(image_id) in self._cache:
            return self._cache[int(image_id)]
        raw = self.db.get(str(image_id).encode())
        if raw is None:
            raise KeyError(image_id)
        out = process_record(pickle.loads(raw))
        if self._cache is not None:
            self._cache[int(image_id)] = out
        return out


class NpzFeatureReader:
    """Single .npz with arrays '<id>_features', '<id>_boxes', '<id>_cls_prob',
    '<id>_hw' per image — a pickle-free layout."""

    def __init__(self, path: str):
        self.npz = np.load(path, allow_pickle=False)
        self._ids = sorted({int(k.split("_", 1)[0]) for k in self.npz.files})

    def keys(self):
        return list(self._ids)

    def __getitem__(self, image_id):
        i = int(image_id)
        feats = self.npz[f"{i}_features"]
        boxes = self.npz[f"{i}_boxes"]
        cls_prob = self.npz[f"{i}_cls_prob"]
        h, w = self.npz[f"{i}_hw"]
        item = {"num_boxes": feats.shape[0], "features": feats,
                "boxes": boxes, "cls_prob": cls_prob,
                "image_h": int(h), "image_w": int(w)}
        return process_record(item)


def open_features(path: str, cache: bool = False):
    if path.endswith(".npz"):
        return NpzFeatureReader(path)
    return LmdbFeatureReader(path, cache=cache)


def convert_lmdb_to_npz(lmdb_path: str, npz_path: str, limit: int = 0):
    """One-shot converter from the reference LMDB to the npz layout."""
    reader = LmdbFeatureReader(lmdb_path)
    arrays = {}
    for n, key in enumerate(reader.keys()):
        if limit and n >= limit:
            break
        raw = reader.db.get(key if isinstance(key, bytes) else
                            str(key).encode())
        item = pickle.loads(raw)
        feats, boxes, cls_prob, h, w = decode_record(item)
        i = int(key.decode() if isinstance(key, bytes) else key)
        arrays[f"{i}_features"] = feats
        arrays[f"{i}_boxes"] = boxes
        arrays[f"{i}_cls_prob"] = cls_prob
        arrays[f"{i}_hw"] = np.asarray([h, w], np.int32)
    np.savez_compressed(npz_path, **arrays)


def convert_npz_to_lmdb(npz_path: str, lmdb_path: str, psize: int = 4096):
    """Reciprocal export: .npz layout -> a reference-format LMDB environment
    (keys = str(image_id), values = pickled record dicts with base64 fields,
    plus the 'keys' index entry the reference reader expects —
    image_features_reader.py:43-44). The output is readable both by liblmdb
    tooling and by unimm_torch.native.lmdb."""
    from unimm_torch.native.lmdb_format import Writer

    npz = np.load(npz_path, allow_pickle=False)
    ids = sorted({int(k.split("_", 1)[0]) for k in npz.files})
    items = []
    key_list = []
    for i in ids:
        feats = np.asarray(npz[f"{i}_features"], np.float32)
        boxes = np.asarray(npz[f"{i}_boxes"], np.float32)
        cls_prob = np.asarray(npz[f"{i}_cls_prob"], np.float32)
        h, w = (int(v) for v in npz[f"{i}_hw"])
        record = {
            "image_id": i,
            "num_boxes": int(feats.shape[0]),
            "feature_size": int(feats.shape[1]),
            "num_classes": int(cls_prob.shape[1]),
            "image_h": h, "image_w": w,
            "features": base64.b64encode(feats.tobytes()),
            "boxes": base64.b64encode(boxes.tobytes()),
            "cls_prob": base64.b64encode(cls_prob.tobytes()),
        }
        key = str(i).encode()
        key_list.append(key)
        items.append((key, pickle.dumps(record)))
    items.append((b"keys", pickle.dumps(key_list)))
    Writer(psize=psize).write(lmdb_path, items)
