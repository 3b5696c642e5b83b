"""Structured val batches -> flat per-sequence model inputs.

The port's copy of the eval part of the JAX package's
``data/dataset.py:flatten_for_forward`` (same keys, same layout; numpy
only). The VisDial datasets, the loader and the training subsample are not
in this slice.
"""

from __future__ import annotations

import numpy as np

_SEQ_KEYS = ("tokens", "segments", "positions", "sep_indices", "mlm_labels",
             "lm_weight", "mode", "ctx_end", "ans_len", "hist_len",
             "next_sentence_label")
_IMG_KEYS = ("image_feat", "image_loc", "image_mask", "image_target",
             "image_label")
_EVAL_IMG_KEYS = ("image_feat", "image_loc", "image_mask")


def flatten_for_forward(batch: dict, train: bool = False,
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
