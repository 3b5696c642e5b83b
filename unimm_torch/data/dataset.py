"""Structured val batches -> flat per-sequence model inputs, and the
length-bucketed accumulation morsels of training.

The port's copies of the JAX package's ``data/dataset.py:
flatten_for_forward`` (its eval part) and ``length_bucket_morsels`` (one
process), with the same keys and layouts; numpy only. The VisDial
datasets, the loader and the training subsample are not ported yet.
"""

from __future__ import annotations

import numpy as np

from unimm_torch.ops import masks

_SEQ_KEYS = ("tokens", "segments", "positions", "sep_indices", "mlm_labels",
             "lm_weight", "mode", "ctx_end", "ans_len", "hist_len",
             "next_sentence_label")
_IMG_KEYS = ("image_feat", "image_loc", "image_mask", "image_target",
             "image_label")
_EVAL_IMG_KEYS = ("image_feat", "image_loc", "image_mask")


def flatten_for_forward(batch: dict, train: bool = True,
                        compact_images: bool = False) -> dict:
    """[B, R, S, ...] batch -> flat [N = B R S, ...] model inputs.

    Per-sequence arrays are reshaped; of the per-image arrays, ``train``
    keeps all and eval only the three the encoder reads. With
    ``compact_images`` they stay [B, ...] and ``img_index`` [N] maps each
    sequence to its image (``models/unimm.expand_images`` gathers on the
    device), so region features cross to the device once per image, not
    once per candidate."""
    B, R, S = batch["tokens"].shape[:3]
    N = B * R * S
    flat = {}
    for k in _SEQ_KEYS:
        if k in batch:
            v = np.asarray(batch[k])
            flat[k] = v.reshape((N,) + v.shape[3:])
    img_keys = [k for k in _IMG_KEYS
                if k in batch and (train or k in _EVAL_IMG_KEYS)]
    if compact_images:
        for k in img_keys:
            flat[k] = batch[k]
        flat["img_index"] = np.repeat(np.arange(B, dtype=np.int32), R * S)
    else:
        for k in img_keys:
            v = np.asarray(batch[k])
            v = np.broadcast_to(v[:, None, None], (B, R, S) + v.shape[1:])
            flat[k] = v.reshape((N,) + v.shape[3:])
    return flat


def length_bucket_morsels(flats, max_len: int, k: int, div: int = 4):
    """Regroup ``k`` flat training batches into ``k`` length-bucketed
    accumulation morsels (one process).

    All sequences are sorted by their attended extent
    (``masks.attended_extent``: every row past it is fully masked), split
    into k equal morsels, and each morsel's per-token [.., L] arrays are
    cut to the smallest covering multiple of max_len / div
    (``masks.quarter_bucket``), so the short morsels run at a fraction of
    the cost under accumulation. Each morsel carries group-level loss
    normalisers: ``lm_norm`` = (label tokens of the whole group) / k,
    ``img_norm`` = (masked regions of the group) / k and
    ``nsp_norm_counts`` = (NSP class counts of the group) / k, so the
    summed micro-gradients equal those of any other grouping of the same
    rows. The inputs must hold expanded per-sequence image arrays (no
    ``img_index``)."""
    if len(flats) != k or k < 1:
        raise ValueError(f"{len(flats)} batches for {k} morsels")
    if "img_index" in flats[0]:
        raise ValueError("length_bucket_morsels needs expanded "
                         "per-sequence image arrays")
    cat = {key: np.concatenate([np.asarray(f[key]) for f in flats])
           for key in flats[0]}
    m = cat["tokens"].shape[0] // k
    ext = masks.attended_extent(cat["mode"], cat["ctx_end"], cat["ans_len"],
                                max_len, cat.get("mlm_labels"))
    order = np.argsort(ext, kind="stable")
    parts = [order[j * m:(j + 1) * m] if j < k - 1 else order[(k - 1) * m:]
             for j in range(k)]
    lm_norm = img_norm = nsp_norm = None
    if "lm_weight" in cat:
        lm_norm = np.float32(max(float((cat["lm_weight"] != 0).sum()), 1.0)
                             / k)
    if "image_label" in cat:
        img_norm = np.float32(float((cat["image_label"] == 1).sum()) / k)
    if "next_sentence_label" in cat:
        nsp_norm = np.asarray(
            [float((cat["next_sentence_label"] == c).sum()) for c in (0, 1)],
            np.float64) / k
        nsp_norm = nsp_norm.astype(np.float32)
    morsels = []
    for idx in parts:
        morsel = {key: v[idx] for key, v in cat.items()}
        Lb = masks.quarter_bucket(int(ext[idx].max(initial=1)), max_len,
                                  div=div)
        if Lb < max_len:
            # per-token arrays only; 'sep_indices' lists SEP positions
            for key in ("tokens", "segments", "positions", "mlm_labels",
                        "lm_weight"):
                if key in morsel:
                    morsel[key] = np.ascontiguousarray(morsel[key][:, :Lb])
        if lm_norm is not None:
            morsel["lm_norm"] = lm_norm
        if img_norm is not None:
            morsel["img_norm"] = img_norm
        if nsp_norm is not None:
            morsel["nsp_norm_counts"] = nsp_norm
        morsels.append(morsel)
    return morsels
