"""Host-side sequence encoding: dialog utterances -> padded token arrays,
MLM corruption channels, and compact mask descriptors.

The port's copy of the JAX package's ``data/encoding.py`` (held equal to
it byte for byte in tests/test_torch_data.py).

Pure-NumPy port of the reference encoders' SEMANTICS
(the reference's utils/data_utils.py: encode_input_gen :139-288,
encode_input_dis :291-428, encode_input :430-436, encode_image_input
:438-482) with one structural change: the O(L^2) dense attention matrices are
NOT built here — each sequence carries a 3-int descriptor
(mode, ctx_end, ans_len) from which unimm_torch/ops/masks.py regenerates the
masks on device (golden-equivalence is tested in tests/test_masks.py and
tests/test_encoding.py).

All randomness flows through an explicit ``numpy.random.Generator`` so
encodings are reproducible under a fixed seed.

Reference quirks preserved exactly:
* per-utterance masking skips a <=1-token final utterance (:174-177);
* negative sequences zero the final-utterance likelihood weights (:183-186);
* MLM corruption is 90% [MASK] / 10% random (NOT BERT's 80/10/10 — the
  "keep original" branch writes [MASK] because tokens were pre-overwritten,
  :250-257); second-copy positions are always [MASK];
* the generative layout appends the answer twice: a visible copy then a fully
  masked copy REUSING the first copy's position ids (:212-229);
* truncation clips arrays at max_seq_len and pins the last sep index
  (:237-244); the descriptor keeps the UNCLIPPED ctx_end, matching how the
  reference slices its mask with the raw orig_length.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

MAX_SEP_LEN = 25


@dataclasses.dataclass
class EncodedSequence:
    tokens: np.ndarray        # [L] int32, corrupted input ids
    segments: np.ndarray      # [L] int32
    positions: np.ndarray     # [L] int32 (device can rebuild from descriptor)
    sep_indices: np.ndarray   # [MAX_SEP_LEN] int32
    mlm_labels: np.ndarray    # [L] int32, -1 = ignore, else original token id
    lm_weight: np.ndarray     # [L] float32 (>0 likelihood, -w unlikelihood)
    mode: int                 # 0 = dis, 1 = gen
    ctx_end: int              # "orig_length" (may exceed L when truncated)
    ans_len: int              # "last_len" (answer + SEP), 0 for dis
    hist_len: int             # len(utterances) - 1


def _finalize(token_ids, segment_ids, position_ids, sep_indices, masked_flags,
              weights, *, mode, ctx_end, ans_len, hist_len, max_seq_len,
              mask_prob_applied, mask_id, vocab_size, rng):
    """Shared truncate/pad/corrupt tail of both encoders."""
    if len(token_ids) > max_seq_len:
        token_ids = token_ids[:max_seq_len]
        segment_ids = segment_ids[:max_seq_len]
        position_ids = position_ids[:max_seq_len]
        masked_flags = masked_flags[:max_seq_len]
        weights = weights[:max_seq_len]
        sep_indices = sep_indices[:-1] + [max_seq_len - 1]

    L = max_seq_len
    tokens = np.zeros(L, np.int32)
    tokens[: len(token_ids)] = token_ids
    segs = np.zeros(L, np.int32)
    segs[: len(segment_ids)] = segment_ids
    poss = np.zeros(L, np.int32)
    poss[: len(position_ids)] = position_ids
    # the reference pads weights through torch.LongTensor
    # (data_utils.py:268,58-63), truncating fractional weights toward zero —
    # notably collapsing dense-relevance weights in (0, 1) to 0; preserved.
    w = np.zeros(L, np.float32)
    w[: len(weights)] = np.trunc(np.asarray(weights, np.float64))
    seps = np.zeros(MAX_SEP_LEN, np.int32)
    seps[: len(sep_indices)] = sep_indices[:MAX_SEP_LEN]

    flags = np.zeros(L, np.int64)
    flags[: len(masked_flags)] = masked_flags
    labels = np.where(flags == 1, tokens, -1).astype(np.int32)

    # corruption: all flagged positions -> MASK; 20% re-roll, of which half
    # become a random token (only before ctx_end and only when vocab known)
    masked_pos = np.nonzero(flags == 1)[0]
    tokens[masked_pos] = mask_id
    if mask_prob_applied:
        for pos in masked_pos:
            if rng.random() < 0.8 or vocab_size is None or pos >= ctx_end:
                tokens[pos] = mask_id
            elif rng.random() < 0.5:
                tokens[pos] = rng.integers(0, vocab_size)

    return EncodedSequence(tokens=tokens, segments=segs, positions=poss,
                           sep_indices=seps, mlm_labels=labels, lm_weight=w,
                           mode=mode, ctx_end=ctx_end, ans_len=ans_len,
                           hist_len=hist_len)


def encode_gen(utterances: Sequence[Sequence[int]], start_segment: int,
               cls_id: int, sep_id: int, mask_id: int, *, max_seq_len=256,
               mask_prob=0.1, is_negative=False, weight=1.0, vocab_size=None,
               rng: np.random.Generator) -> EncodedSequence:
    """Generative (autoregressive-MLM) encoding with the duplicated answer."""
    token_ids = [cls_id]
    segment_ids = [start_segment]
    position_ids = [0]
    masked = [0]
    weights = [0.0]
    sep_indices: List[int] = []

    seg = start_segment
    n_utt = len(utterances)
    ctx_end = 0
    ans_len = 0
    cur_sep = 0
    for ui, utt in enumerate(utterances, start=1):
        utt = list(utt)
        n = len(utt)
        last = ui == n_utt
        if last and n <= 1:
            flags = [0] * n
        else:
            flags = [1 if rng.random() < mask_prob else 0 for _ in range(n)]
        masked.extend(flags)
        token_ids.extend(utt)
        segment_ids.extend([seg] * n)
        weights.extend([0.0] * n if (last and is_negative) else
                       [float(f) for f in flags])

        token_ids.append(sep_id)
        segment_ids.append(seg)
        masked.append(0)
        weights.append(0.0)

        first_copy_pos = list(range(len(position_ids),
                                    len(position_ids) + n + 1))
        position_ids.extend(first_copy_pos)
        cur_sep += n + 1
        sep_indices.append(cur_sep)

        if last:
            ans_len = n + 1
            ctx_end = len(token_ids)
            # second (fully masked) answer copy, same positions
            masked.extend([1] * n + [1])
            token_ids.extend(utt)
            token_ids.append(sep_id)
            segment_ids.extend([seg] * (n + 1))
            sign = -1.0 if is_negative else 1.0
            weights.extend([sign * float(weight)] * (n + 1))
            position_ids.extend(first_copy_pos)
            cur_sep += n + 1
            sep_indices.append(cur_sep)
        seg ^= 1

    return _finalize(token_ids, segment_ids, position_ids, sep_indices,
                     masked, weights, mode=1, ctx_end=ctx_end,
                     ans_len=ans_len, hist_len=n_utt - 1,
                     max_seq_len=max_seq_len, mask_prob_applied=mask_prob > 0,
                     mask_id=mask_id, vocab_size=vocab_size, rng=rng)


def encode_dis(utterances: Sequence[Sequence[int]], start_segment: int,
               cls_id: int, sep_id: int, mask_id: int, *, max_seq_len=256,
               mask_prob=0.1, is_negative=False, weight=1.0, vocab_size=None,
               rng: np.random.Generator) -> EncodedSequence:
    """Discriminative encoding: bidirectional over the full dialog+answer."""
    token_ids = [cls_id]
    segment_ids = [start_segment]
    position_ids = [0]
    masked = [0]
    weights = [0.0]
    sep_indices: List[int] = []

    seg = start_segment
    n_utt = len(utterances)
    ctx_end = 0
    cur_sep = 0
    for ui, utt in enumerate(utterances, start=1):
        utt = list(utt)
        n = len(utt)
        last = ui == n_utt
        if last and n <= 1:
            flags = [0] * n
        else:
            flags = [1 if rng.random() < mask_prob else 0 for _ in range(n)]
        masked.extend(flags)
        token_ids.extend(utt)
        segment_ids.extend([seg] * n)
        weights.extend([0.0] * n if (last and is_negative) else
                       [float(f) for f in flags])

        token_ids.append(sep_id)
        segment_ids.append(seg)
        masked.append(0)
        weights.append(0.0)

        position_ids.extend(range(len(position_ids),
                                  len(position_ids) + n + 1))
        cur_sep += n + 1
        sep_indices.append(cur_sep)
        if last:
            ctx_end = len(token_ids)
        seg ^= 1

    return _finalize(token_ids, segment_ids, position_ids, sep_indices,
                     masked, weights, mode=0, ctx_end=ctx_end, ans_len=0,
                     hist_len=n_utt - 1, max_seq_len=max_seq_len,
                     mask_prob_applied=mask_prob > 0, mask_id=mask_id,
                     vocab_size=vocab_size, rng=rng)


def encode_auto(dis_rate: float, utterances, start_segment, cls_id, sep_id,
                mask_id, *, rng: np.random.Generator, **kw) -> EncodedSequence:
    """Bernoulli(dis_rate) dispatch per sequence (data_utils.py:430-436)."""
    fn = encode_dis if rng.random() < dis_rate else encode_gen
    return fn(utterances, start_segment, cls_id, sep_id, mask_id, rng=rng, **kw)


# ---------------------------------------------------------------------------
# image regions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EncodedImage:
    features: np.ndarray      # [R, 2048] float32
    spatials: np.ndarray      # [R, 5] float32
    image_mask: np.ndarray    # [R] float32
    image_target: np.ndarray  # [R, 1601] float32
    image_label: np.ndarray   # [R] int32 (-1 ignore / 0 <IMG> / 1 predict)


def encode_image(features, num_boxes, boxes, cls_prob, *, max_regions=37,
                 mask_prob=0.15, rng: np.random.Generator) -> EncodedImage:
    """Pad/truncate regions and apply region masking (data_utils.py:438-482):
    w.p. mask_prob a region is selected for prediction (features zeroed 90%
    of the time); at least one region is always predicted; the global <IMG>
    row never contributes to the loss."""
    num_boxes = min(int(num_boxes), max_regions)
    feat = np.zeros((max_regions, features.shape[-1]), np.float32)
    loc = np.zeros((max_regions, boxes.shape[-1]), np.float32)
    target = np.zeros((max_regions, cls_prob.shape[-1]), np.float32)
    feat[:num_boxes] = features[:num_boxes]
    loc[:num_boxes] = boxes[:num_boxes]
    target[:num_boxes] = cls_prob[:num_boxes]

    labels = []
    for i in range(num_boxes):
        p = rng.random()
        if p < mask_prob:
            if p / mask_prob < 0.9:
                feat[i] = 0
            labels.append(1)
        else:
            labels.append(-1)
    mask = [1.0] * num_boxes + [0.0] * (max_regions - num_boxes)
    labels += [-1] * (max_regions - num_boxes)
    labels[int(rng.integers(1, len(labels)))] = 1   # ensure >=1 predicted
    labels[0] = 0                                    # <IMG> row excluded
    return EncodedImage(features=feat, spatials=loc,
                        image_mask=np.asarray(mask, np.float32),
                        image_target=target,
                        image_label=np.asarray(labels, np.int32))


# ---------------------------------------------------------------------------
# batching
# ---------------------------------------------------------------------------

def stack_sequences(seqs: Sequence[EncodedSequence]) -> dict:
    """Stack EncodedSequence records into a descriptor batch (host arrays)."""
    return {
        "tokens": np.stack([s.tokens for s in seqs]),
        "segments": np.stack([s.segments for s in seqs]),
        "positions": np.stack([s.positions for s in seqs]),
        "sep_indices": np.stack([s.sep_indices for s in seqs]),
        "mlm_labels": np.stack([s.mlm_labels for s in seqs]),
        "lm_weight": np.stack([s.lm_weight for s in seqs]),
        "mode": np.asarray([s.mode for s in seqs], np.int32),
        "ctx_end": np.asarray([s.ctx_end for s in seqs], np.int32),
        "ans_len": np.asarray([s.ans_len for s in seqs], np.int32),
        "hist_len": np.asarray([s.hist_len for s in seqs], np.int32),
    }


def prune_rounds(context: list, num_rounds: int):
    """dataloader_visdial.py:90-99: keep the trailing 2*num_rounds utterances
    (dropping the caption) once the dialog exceeds the round budget."""
    start_segment = 1
    cur_rounds = (len(context) // 2) + 1
    if cur_rounds > num_rounds:
        return context[len(context) - 2 * num_rounds:], 0
    return context, start_segment
