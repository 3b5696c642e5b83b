"""VisDial datasets: dialog JSON + region features -> descriptor batches;
structured batches -> flat per-sequence model inputs; the length-bucketed
accumulation morsels of training.

The port's copy of the JAX package's ``data/dataset.py`` (numpy and the
standard library only; held equal to it in tests/test_torch_data.py):
``VisdialDataset`` with its train, val and test items, ``collate``,
``flatten_for_forward`` with its training subsample, and
``length_bucket_morsels`` (in a data-parallel world its ``sync`` makes
each morsel's bucket and normalisers cover every rank's rows), and
``VisdialDatasetDense``, dense finetuning's set.

The datasets reimplement the reference dataset semantics (the reference's
dataloader/dataloader_visdial.py VisdialDataset) without building dense
masks:

* train: per image, 10 rounds x (1 positive + num_negative_samples negatives
  sampled under the max_seq_len budget, dataloader_visdial.py:154-188), each
  encoded dis/gen by Bernoulli(train_dis_rate);
* val: 10 rounds x num_options candidates with the GT at index 0
  (:322-457), mask_prob=0, mode fixed by val_dis; attaches gt_relevance for
  the dense-annotated round;
* test: 100 candidates at the last round only (:459-547).

All sampling uses an explicit np.random.Generator seeded by
(seed, epoch, index) so items are reproducible; call ``set_epoch`` between
epochs to refresh the corruption/negatives.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from unimm_torch.data import encoding as E
from unimm_torch.ops import masks


class _TokenCache:
    """Memoises tokenizer.encode over the shared question/answer string lists."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self._cache: Dict[str, List[int]] = {}

    def encode(self, text: str) -> List[int]:
        got = self._cache.get(text)
        if got is None:
            got = self.tokenizer.encode(text)
            self._cache[text] = got
        return got


class VisdialDataset:
    """Split-aware dataset ('train' | 'val' | 'test')."""

    def __init__(self, params: dict, tokenizer, features_reader):
        self.params = params
        self.tok = _TokenCache(tokenizer)
        self.reader = features_reader
        self.cls_id = tokenizer.cls_id
        self.sep_id = tokenizer.sep_id
        self.mask_id = tokenizer.mask_id
        self.vocab_size = tokenizer.vocab_size
        self.max_regions = params.get("max_regions", 37)
        self.num_options = params["num_options"]
        self.overfit = params.get("overfit", False)
        self.seed = params.get("seed", 0)
        self.epoch = 0
        self._split = "train"
        # loader telemetry (VERDICT r1 item 8): how often the reference's
        # negative-sampling truncation fallback (dataloader_visdial.py:178-183
        # quirk, replicated below) actually fires on this data
        self.stats = {"neg_truncation_fallbacks": 0}
        # __getitem__ runs concurrently from DataLoader worker threads;
        # a bare `+= 1` can drop increments under interleaving
        self._stats_lock = threading.Lock()

        self.data = {}
        self.num_data_points = {}
        with open(params["visdial_processed_train"]) as f:
            self.data["train"] = json.load(f)["data"]
        with open(params["visdial_processed_val"]) as f:
            self.data["val"] = json.load(f)["data"]
        with open(params["visdial_processed_test"]) as f:
            self.data["test"] = json.load(f)["data"]
        with open(params["visdial_processed_val_dense_annotations"]) as f:
            self.val_dense = json.load(f)

        for split in ("train", "val", "test"):
            n = len(self.data[split]["dialogs"])
            if self.overfit and split != "test":
                n = min(params.get("num_%s_samples" % split, 0) or 5, n)
            else:
                override = params.get("num_%s_samples" % split, 0)
                if override:
                    n = min(override, n)
            self.num_data_points[split] = n
        # overfit reuses train data for val (dataloader_visdial.py:107-108)
        if self.overfit:
            self.data["val"] = self.data["train"]
            self.num_data_points["val"] = self.num_data_points["train"]

    # -- split property (reference API) --------------------------------------
    @property
    def split(self):
        return self._split

    @split.setter
    def split(self, s):
        assert s in ("train", "val", "test")
        self._split = s

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.num_data_points[self._split]

    _SPLIT_IDS = {"train": 0, "val": 1, "test": 2}

    def _rng(self, index: int) -> np.random.Generator:
        # fixed split ids, NOT hash(): str hashing is salted per process
        # (PYTHONHASHSEED) and would break cross-run/cross-host reproducibility
        return np.random.default_rng(
            (self.seed, self.epoch, index, self._SPLIT_IDS[self._split]))

    def _image(self, img_id, rng, mask_prob) -> E.EncodedImage:
        features, num_boxes, boxes, _, cls_prob = self.reader[img_id]
        return E.encode_image(features, num_boxes, boxes, cls_prob,
                              max_regions=self.max_regions,
                              mask_prob=mask_prob, rng=rng)

    # -- items ----------------------------------------------------------------
    def __getitem__(self, index: int) -> dict:
        if self._split == "train":
            return self._train_item(index)
        if self._split == "val":
            return self._val_item(index)
        return self._test_item(index)

    def _train_item(self, index: int) -> dict:
        p = self.params
        rng = self._rng(index)
        max_len = p["max_seq_len"]
        num_options = self.num_options
        dialog = self.data["train"]["dialogs"][index]
        questions = self.data["train"]["questions"]
        answers = self.data["train"]["answers"]

        cap = self.tok.encode(dialog["caption"])
        utterances = [[cap]]
        utterances_random = [[cap]]
        tot_len = len(cap) + 2
        for utt in dialog["dialog"]:
            cur = utterances[-1].copy()
            cur_rand = utterances[-1].copy()
            q = self.tok.encode(questions[utt["question"]])
            a = self.tok.encode(answers[utt["answer"]])
            cur.append(q)
            cur.append(a)
            tot_len += len(q) + 1 + len(a) + 1
            cur_rand.append(list(q))
            utterances.append(cur)

            gt = utt["gt_index"]
            # candidate pools (dataloader_visdial.py:156-161): first
            # num_options-1 non-GT options, in order
            all_inds = [i for i in range(100) if i != gt][: num_options - 1]
            all_neg_inds = list(all_inds)
            negatives = []
            for _ in range(p["num_negative_samples"]):
                chosen = None
                while all_inds:
                    oi = all_inds[int(rng.integers(len(all_inds)))]
                    cand = self.tok.encode(answers[utt["answer_options"][oi]])
                    if max_len >= tot_len + len(cand) + 1:
                        all_inds.remove(oi)
                        all_neg_inds.remove(oi)
                        chosen = cand
                        break
                    all_inds.remove(oi)
                # reference quirk (dataloader_visdial.py:178-183): the
                # truncation fallback triggers whenever the candidate pool is
                # EMPTY — even if the final pick above succeeded — replacing
                # it with a random option truncated to the GT answer length
                if not all_inds:
                    oi = all_neg_inds[int(rng.integers(len(all_neg_inds)))]
                    chosen = self.tok.encode(
                        answers[utt["answer_options"][oi]])[: len(a)]
                    all_neg_inds.remove(oi)
                    with self._stats_lock:
                        self.stats["neg_truncation_fallbacks"] += 1
                t = cur_rand.copy()
                t.append(chosen)
                negatives.append(t)
            utterances_random.append(negatives)

        utterances = utterances[1:]
        utterances_random = utterances_random[1:]
        assert len(utterances) == len(utterances_random) == 10

        kw = dict(max_seq_len=max_len, vocab_size=self.vocab_size)
        rounds = []
        nsp_labels = []
        for pos_ctx, negs in zip(utterances, utterances_random):
            seqs = []
            ctx, start_seg = E.prune_rounds(pos_ctx, p["visdial_tot_rounds"])
            seqs.append(E.encode_auto(p["train_dis_rate"], ctx, start_seg,
                                      self.cls_id, self.sep_id, self.mask_id,
                                      mask_prob=p["mask_prob"],
                                      is_negative=False, weight=1.0,
                                      rng=rng, **kw))
            labels = [0]
            for neg_ctx in negs:
                ctx, start_seg = E.prune_rounds(neg_ctx,
                                                p["visdial_tot_rounds"])
                seqs.append(E.encode_auto(
                    p["train_dis_rate"], ctx, start_seg, self.cls_id,
                    self.sep_id, self.mask_id, mask_prob=p["mask_prob"],
                    is_negative=True, weight=p["neg_token_weight"],
                    rng=rng, **kw))
                labels.append(1)
            rounds.append(seqs)
            nsp_labels.append(labels)

        item = _stack_rounds(rounds)
        item["next_sentence_label"] = np.asarray(nsp_labels, np.int32)
        img = self._image(dialog["image_id"], rng, p["mask_prob"])
        item.update(_image_fields(img))
        item["image_id"] = np.int64(dialog["image_id"])
        return item

    def _val_item(self, index: int) -> dict:
        p = self.params
        rng = self._rng(index)
        num_options = self.num_options
        data = self.data["val"]
        dialog = data["dialogs"][index]
        questions, answers = data["questions"], data["answers"]
        encode = E.encode_dis if p["val_dis"] else E.encode_gen

        gt_relevance = None
        dense = self.val_dense[index]
        utterances = [[self.tok.encode(dialog["caption"])]]
        rounds = []
        gt_option_inds = []
        for rnd, utt in enumerate(dialog["dialog"]):
            cur = utterances[-1].copy()
            cur.append(self.tok.encode(questions[utt["question"]]))
            gt = utt["gt_index"]
            option_inds = [gt] + [i for i in range(100) if i != gt][
                : num_options - 1]
            gt_option_inds.append(0)
            answer_options = [utt["answer_options"][k] for k in option_inds]
            assert answer_options[0] == utt["answer"]
            if rnd == dense["round_id"] - 1:
                rel = np.asarray(dense["gt_relevance"], np.float32)
                gt_relevance = rel[np.asarray(option_inds)]
            seqs = []
            for ao in answer_options:
                opt = cur.copy()
                opt.append(self.tok.encode(answers[ao]))
                ctx, start_seg = E.prune_rounds(opt, p["visdial_tot_rounds"])
                seqs.append(encode(ctx, start_seg, self.cls_id, self.sep_id,
                                   self.mask_id, max_seq_len=p["max_seq_len"],
                                   mask_prob=0, is_negative=False,
                                   vocab_size=self.vocab_size, rng=rng))
            cur.append(self.tok.encode(answers[utt["answer"]]))
            utterances.append(cur)
            rounds.append(seqs)

        item = _stack_rounds(rounds)
        item["gt_option_inds"] = np.asarray(gt_option_inds, np.int32)
        item["round_id"] = np.int32(dense["round_id"])
        item["gt_relevance"] = gt_relevance
        img = self._image(dialog["image_id"], rng, mask_prob=0)
        item.update(_image_fields(img))
        item["image_id"] = np.int64(dialog["image_id"])
        return item

    def _test_item(self, index: int) -> dict:
        p = self.params
        rng = self._rng(index)
        data = self.data["test"]
        dialog = data["dialogs"][index]
        questions, answers = data["questions"], data["answers"]

        cur = [self.tok.encode(dialog["caption"])]
        for rnd, utt in enumerate(dialog["dialog"]):
            cur.append(self.tok.encode(questions[utt["question"]]))
            if rnd != len(dialog["dialog"]) - 1:
                cur.append(self.tok.encode(answers[utt["answer"]]))
        encode = E.encode_dis if p.get("test_dis", 1) else E.encode_gen
        seqs = []
        for ao in dialog["dialog"][-1]["answer_options"]:
            opt = cur.copy()
            opt.append(self.tok.encode(answers[ao]))
            ctx, start_seg = E.prune_rounds(opt, p["visdial_tot_rounds"])
            seqs.append(encode(ctx, start_seg, self.cls_id, self.sep_id,
                               self.mask_id, max_seq_len=p["max_seq_len"],
                               mask_prob=0, is_negative=False,
                               vocab_size=self.vocab_size, rng=rng))
        item = _stack_rounds([seqs])   # [1, 100, ...]
        item["round_id"] = np.int32(dialog["round_id"])
        img = self._image(dialog["image_id"], rng, mask_prob=0)
        item.update(_image_fields(img))
        item["image_id"] = np.int64(dialog["image_id"])
        return item


class VisdialDatasetDense:
    """Dense-annotation finetuning set: one annotated round, all 100 options."""

    def __init__(self, params: dict, tokenizer, features_reader):
        self.params = params
        self.tok = _TokenCache(tokenizer)
        self.reader = features_reader
        self.cls_id = tokenizer.cls_id
        self.sep_id = tokenizer.sep_id
        self.mask_id = tokenizer.mask_id
        self.vocab_size = tokenizer.vocab_size
        self.max_regions = params.get("max_regions", 37)
        self.seed = params.get("seed", 0)
        self.epoch = 0
        with open(params["visdial_processed_train_dense"]) as f:
            self.data = json.load(f)["data"]
        with open(params["visdial_processed_train_dense_annotations"]) as f:
            self.annotations = json.load(f)
        n = len(self.data["dialogs"])
        if params.get("overfit"):
            n = min(5, n)
        self.num_data_points = {"train": n}

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.num_data_points["train"]

    def __getitem__(self, index: int) -> dict:
        p = self.params
        rng = np.random.default_rng((self.seed, self.epoch, index, 0xD))
        dialog = self.data["dialogs"][index]
        questions, answers = self.data["questions"], self.data["answers"]
        ann = self.annotations[index]
        assert dialog["image_id"] == ann["image_id"]

        cur_rounds = ann["round_id"]
        cur = [self.tok.encode(dialog["caption"])]
        for rnd, utt in enumerate(dialog["dialog"][:cur_rounds]):
            cur.append(self.tok.encode(questions[utt["question"]]))
            if rnd != cur_rounds - 1:
                cur.append(self.tok.encode(answers[utt["answer"]]))

        # per-item mode draw (dataloader_dense_annotations.py:148)
        use_dis = rng.random() < p["train_dis_rate"]
        encode = E.encode_dis if use_dis else E.encode_gen
        seqs = []
        for oi, ao in enumerate(dialog["dialog"][cur_rounds - 1]
                                ["answer_options"]):
            opt = cur.copy()
            opt.append(self.tok.encode(answers[ao]))
            ctx, start_seg = E.prune_rounds(opt, p["visdial_tot_rounds"])
            rel = ann["relevance"][oi]
            seqs.append(encode(ctx, start_seg, self.cls_id, self.sep_id,
                               self.mask_id, max_seq_len=p["max_seq_len"],
                               mask_prob=p["mask_prob"],
                               is_negative=(rel == 0),
                               weight=(rel if rel > 0 else 1),
                               vocab_size=self.vocab_size, rng=rng))
        gt_option = dialog["dialog"][cur_rounds - 1]["gt_index"]
        item = _stack_rounds([seqs])
        nsp = np.ones(len(seqs), np.int32)
        nsp[gt_option] = 0
        item["next_sentence_label"] = nsp[None, :]
        item["gt_relevance"] = np.asarray(ann["relevance"], np.float32)
        item["gt_option"] = np.int32(gt_option)
        item["round_id"] = np.int32(cur_rounds)
        img_rng = rng
        features, num_boxes, boxes, _, cls_prob = self.reader[dialog["image_id"]]
        img = E.encode_image(features, num_boxes, boxes, cls_prob,
                             max_regions=self.max_regions, mask_prob=0,
                             rng=img_rng)
        item.update(_image_fields(img))
        item["image_id"] = np.int64(dialog["image_id"])
        return item


# ---------------------------------------------------------------------------
# stacking / flattening helpers
# ---------------------------------------------------------------------------

def _stack_rounds(rounds: Sequence[Sequence[E.EncodedSequence]]) -> dict:
    """[rounds][samples] EncodedSequence -> dict of [rounds, samples, ...]."""
    flat = [s for rnd in rounds for s in rnd]
    stacked = E.stack_sequences(flat)
    R, S = len(rounds), len(rounds[0])
    return {k: v.reshape((R, S) + v.shape[1:]) for k, v in stacked.items()}


def _image_fields(img: E.EncodedImage) -> dict:
    return {"image_feat": img.features, "image_loc": img.spatials,
            "image_mask": img.image_mask, "image_target": img.image_target,
            "image_label": img.image_label}


_SEQ_KEYS = ("tokens", "segments", "positions", "sep_indices", "mlm_labels",
             "lm_weight", "mode", "ctx_end", "ans_len", "hist_len",
             "next_sentence_label")
_IMG_KEYS = ("image_feat", "image_loc", "image_mask", "image_target",
             "image_label")


def collate(items: Sequence[dict]) -> dict:
    """Stack per-image items into a batch dict [B, rounds, samples, ...]."""
    out = {}
    for k in items[0]:
        out[k] = np.stack([it[k] for it in items])
    return out



def flatten_for_forward(batch: dict, sample_size: Optional[int] = None,
                        rng: Optional[np.random.Generator] = None,
                        train: bool = True,
                        compact_images: bool = False) -> dict:
    """[B, R, S, ...] batch -> flat [N, ...] model inputs, optionally
    subsampling N -> sample_size (train.py:53-92).

    With ``compact_images`` the per-image arrays stay [B, ...] and an
    ``img_index`` [N] maps each sequence to its image — the model gathers on
    device (unimm.expand_images), so region features are shipped host->HBM
    once per image instead of once per candidate sequence (1000x less for the
    val slate)."""
    B, R, S = batch["tokens"].shape[:3]
    N = B * R * S
    flat = {}
    for k in _SEQ_KEYS:
        if k in batch:
            v = np.asarray(batch[k])
            flat[k] = v.reshape((N,) + v.shape[3:])
    img_keys = [k for k in _IMG_KEYS if k in batch and
                (train or k in ("image_feat", "image_loc", "image_mask"))]
    if compact_images:
        for k in img_keys:
            flat[k] = batch[k]
        flat["img_index"] = np.repeat(np.arange(B, dtype=np.int32), R * S)
    else:
        for k in img_keys:
            v = np.asarray(batch[k])           # [B, ...]
            v = np.broadcast_to(v[:, None, None], (B, R, S) + v.shape[1:])
            flat[k] = v.reshape((N,) + v.shape[3:])
    if sample_size is not None and sample_size < N:
        assert rng is not None
        idx = rng.permutation(N)[:sample_size]
        keep_whole = set(img_keys) if compact_images else set()
        flat = {k: (v if k in keep_whole else v[idx])
                for k, v in flat.items()}
    return flat



def length_bucket_morsels(flats, max_len: int, k: int, div: int = 4,
                          sync=None):
    """Regroup ``k`` flat training batches into ``k`` length-bucketed
    accumulation morsels.

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
    ``img_index``).

    In a data-parallel world (``sync``) each rank sorts its own rows, and
    ``sync(stats)`` gathers every rank's float64 stats vector as a
    [ranks, k + 4] stack (``dist.allgather_np``): morsel j's bucket covers
    the largest extent over the ranks and the normalisers count the whole
    world's rows, so the ranks' summed gradients equal the unsorted global
    grouping's."""
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
    labels = (float((cat["lm_weight"] != 0).sum())
              if "lm_weight" in cat else -1.0)
    img_sel = (float((cat["image_label"] == 1).sum())
               if "image_label" in cat else -1.0)
    nsp_counts = (np.asarray([float((cat["next_sentence_label"] == c).sum())
                              for c in (0, 1)], np.float64)
                  if "next_sentence_label" in cat
                  else np.asarray([-1.0, -1.0]))
    morsel_ext = np.asarray([ext[idx].max(initial=1) for idx in parts],
                            np.float64)
    if sync is not None:
        g = np.asarray(sync(np.concatenate(
            [morsel_ext, [labels, img_sel], nsp_counts])))
        if g.ndim != 2 or g.shape[1] != k + 4:
            raise ValueError(f"sync gave a {g.shape} stack, want "
                             f"[ranks, {k + 4}]")
        morsel_ext = g[:, :k].max(axis=0)
        labels = float(g[:, k].sum()) if labels >= 0 else -1.0
        img_sel = float(g[:, k + 1].sum()) if img_sel >= 0 else -1.0
        if nsp_counts[0] >= 0:
            nsp_counts = g[:, k + 2:k + 4].sum(axis=0)
    lm_norm = np.float32(max(labels, 1.0) / k) if labels >= 0 else None
    img_norm = np.float32(img_sel / k) if img_sel >= 0 else None
    nsp_norm = (np.asarray(nsp_counts / k, np.float32)
                if nsp_counts[0] >= 0 else None)
    morsels = []
    for idx, e in zip(parts, morsel_ext):
        morsel = {key: v[idx] for key, v in cat.items()}
        Lb = masks.quarter_bucket(int(e), max_len, div=div)
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
