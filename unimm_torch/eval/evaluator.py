"""Candidate-ranking evaluation: generative sequence log-likelihood ranking
(reference val_lm.py), its token-averaged form (val_avg_lm.py),
discriminative NSP-probability ranking (train.py visdial_evaluate, val.py)
and the multi-model ensemble with per-slate min-max normalisation
(val.py, evaluate.py).

The port of the JAX package's ``eval/evaluator.py`` serving loop on one
device. ``RankingEvaluator.score_flat(_async)`` scores a flat [N, ...]
batch in fixed-size padded chunks (sorted by attended extent, each chunk
sliced to its length bucket) through ``models/unimm.forward_eval``;
``score_slates(_async)`` scores [B, R, O] val batches through the
prefix-cache scorer when only answer log-likelihoods are needed and sends
the slates it cannot take through the flat scorer; given a decoder
configuration (``config.DeepseekV3Config``) it scores them through the
decoder's prefix scorer (``eval/decoder_prefix.py``), which has no flat
fallback. ``evaluate_split`` and
``evaluate_ensemble`` coalesce loader batches, keep ``pipeline_depth`` of
them in flight, and accumulate R@k / MRR / mean rank and NDCG.

In a world of several processes (``parallel/dist.py``) the evaluators
serve in one of the JAX package's two modes: ``split_rows`` (every rank
iterates the same batches, stages every dispatch whole, scores its dp
index's contiguous share of the rows, a flat chunk's or a prefix
group's, and the score vectors are all-gathered over the dp group; the
counterpart of a dp mesh spanning processes; the ranks of an mp group
score the same rows, each model gathered whole from its slices,
``parallel/mesh.py``) or ``process_merge`` (each rank scores its own
shard of the split and the metric statistics are merged at the end).
``dump_ranks_merged`` writes one predictions file from the ranks' shards.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from unimm_torch.config import DeepseekV3Config, VilbertConfig
from unimm_torch.data.dataset import flatten_for_forward
from unimm_torch.eval.decoder_prefix import DecoderPrefixScorer
from unimm_torch.eval.prefix import PrefixScorer
from unimm_torch.models import unimm, vilbert
from unimm_torch.ops import masks as M_masks
from unimm_torch.ops import metrics as M
from unimm_torch.parallel import dist
from unimm_torch.utils import trace

# per-chunk sequence arrays; position ids are always regenerated from the
# descriptor on the device
_SEQ_KEYS = ("tokens", "segments", "mode", "ctx_end", "ans_len",
             "mlm_labels", "img_index")
_IMG_KEYS = ("image_feat", "image_loc", "image_mask")


class RankingEvaluator:
    def __init__(self, cfg: VilbertConfig, *, chunk_size: int = 256,
                 dtype=torch.bfloat16, need_lm=True, need_nsp=True,
                 length_buckets=True, bucket_div: int = 8,
                 gen_prefix=True, prefix_group: int = 40,
                 prefix_packed=True, prefix_rowblock: int = 0,
                 split_rows=False, device="cuda"):
        """``length_buckets``: score sequences sorted by their attended
        extent (``masks.attended_extent``), each chunk sliced to the
        smallest covering multiple of L / ``bucket_div``; exact, since rows
        and columns past the extent are fully masked. Scores are restored
        to the caller's order.

        ``gen_prefix``: for LM-only scoring (``need_nsp=False``), score
        slates whose options share a context through the prefix-cache
        scorer (``score_slates``); ineligible slates take the flat path.
        ``prefix_packed`` / ``prefix_rowblock``: the prefix scorer's
        ``packed`` and ``row_block``.

        ``split_rows``: in a world of several processes every rank is
        given the same batches and scores its dp index's rows
        ``dist.row_block`` of each padded chunk (and of each prefix group);
        ``chunk_size`` must divide over the dp size. The scores are
        all-gathered over the dp group when a batch is fetched, so every
        rank returns all of them.

        The compute-dtype copy of each model is made once and reused while
        its parameters are unchanged (``vilbert.ComputeModels``), one per
        ensemble member."""
        self.cfg = cfg
        self.chunk = chunk_size
        self.dtype = dtype
        self.length_buckets = length_buckets
        self._bucket_div = bucket_div
        self._need_lm = need_lm
        self._need_nsp = need_nsp
        self._split = split_rows and dist.dp_size() > 1
        self.device = vilbert.resolve_device(device)
        self._compute_model = vilbert.ComputeModels(dtype)
        self._prefix = None
        self._decoder = isinstance(cfg, DeepseekV3Config)
        if self._decoder:
            # a decoder ranks by answer log-likelihood, through its own
            # prefix scorer; it holds its weights in the dtype it runs in
            if not need_lm or need_nsp:
                raise ValueError("a decoder configuration ranks by "
                                 "log-likelihood only")
            self._prefix = DecoderPrefixScorer(
                cfg, group=prefix_group, device=self.device)
        elif (gen_prefix and need_lm and not need_nsp
                and not cfg.in_batch_pairs and not cfg.fast_mode):
            self._prefix = PrefixScorer(
                cfg, dtype=dtype, group=prefix_group, bucket_div=bucket_div,
                packed=prefix_packed, row_block=prefix_rowblock,
                compute_models=self._compute_model, split_rows=split_rows,
                device=self.device)

    def _fwd(self, cast, d_bias, chunk, pmax):
        out = unimm.forward_eval(cast, self.cfg, chunk, dtype=self.dtype,
                                 need_lm=self._need_lm,
                                 need_nsp=self._need_nsp,
                                 max_label_positions=pmax,
                                 decoder_bias=d_bias)
        res = {}
        if self._need_nsp:
            # P(next) = softmax(logits)[:, 0]  (train.py:261-263)
            res["nsp_prob"] = torch.softmax(out["nsp_logits"], dim=-1)[:, 0]
        if self._need_lm:
            res["ll_sum"] = -out["lm_nll_sum"]
            res["ll_mean"] = -out["lm_nll_mean"]
        return res

    def _label_bucket(self, flat) -> int:
        """Smallest power-of-two label budget (>= 8) covering this batch:
        the head's cost is linear in the budget, real answers carry ~8
        label tokens."""
        if not self._need_lm:
            return unimm.MAX_LABEL_POSITIONS
        counts = (np.asarray(flat["mlm_labels"]) != -1).sum(axis=-1)
        need = int(counts.max(initial=1))
        p = 8
        while p < need:
            p *= 2
        return min(p, unimm.MAX_LABEL_POSITIONS)

    def _length_order(self, flat):
        """(sort order, sorted extents) by attended extent; the label
        guard keeps the buckets exact for synthetic inputs with labels past
        the extent."""
        ext = M_masks.attended_extent(
            flat["mode"], flat["ctx_end"], flat["ans_len"],
            flat["tokens"].shape[-1],
            flat.get("mlm_labels") if self._need_lm else None)
        order = np.argsort(ext, kind="stable")
        return order, ext[order]

    def _put(self, v):
        with trace.span("eval.h2d"):
            return torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device, non_blocking=True)

    def score_flat(self, model, flat: Dict[str, np.ndarray]) -> dict:
        """Score a flat [N, ...] batch in fixed-size padded chunks; returns
        [N] score arrays (nsp_prob and / or ll_sum, ll_mean) in input
        order."""
        return self.score_flat_async(model, flat)()

    @torch.no_grad()
    def score_flat_async(self, model, flat: Dict[str, np.ndarray]):
        """Stage and launch every chunk of a flat batch; return a closure
        that fetches and assembles the score dict. Per-image arrays
        (compact storage + img_index) are staged once per batch; the
        sequence arrays move per chunk. Launches are asynchronous on the
        card, so a caller can stage the next batch before finalizing this
        one."""
        N = flat["tokens"].shape[0]
        Lmax = flat["tokens"].shape[-1]
        compact = "img_index" in flat
        with trace.span("eval.plan"):
            pmax = self._label_bucket(flat)
            order = None
            if self.length_buckets and N > 1:
                order, ext_sorted = self._length_order(flat)
                seq_keys = [k for k in _SEQ_KEYS if k in flat] + \
                    [k for k in _IMG_KEYS if k in flat and not compact]
                flat = dict(flat, **{k: np.asarray(flat[k])[order]
                                     for k in seq_keys})
        cast = self._compute_model(model)
        # the fp32 tied-decoder bias, read before the compute-dtype cast
        d_bias = model.cls.predictions.bias.detach().float()
        imgs = ({k: self._put(flat[k]) for k in _IMG_KEYS if k in flat}
                if compact else {})
        chunk_keys = list(_SEQ_KEYS) + ([] if compact else list(_IMG_KEYS))
        # under split_rows this dp index's block of every padded chunk
        rows = (dist.row_block(self.chunk, over=dist.DP) if self._split
                else slice(None))
        outs = []
        for s in range(0, N, self.chunk):
            e = min(s + self.chunk, N)
            with trace.span("eval.plan"):
                chunk = {k: np.asarray(flat[k])[s:e] for k in chunk_keys
                         if k in flat}
                pad = self.chunk - (e - s)
                if pad:
                    chunk = {k: np.concatenate(
                        [v, np.repeat(v[-1:], pad, axis=0)]) for k, v in
                        chunk.items()}
                if order is not None:
                    Lb = M_masks.quarter_bucket(int(ext_sorted[s:e].max()),
                                                Lmax, div=self._bucket_div)
                    if Lb < Lmax:
                        for k in ("tokens", "segments", "mlm_labels"):
                            if k in chunk:
                                chunk[k] = chunk[k][:, :Lb]
                if trace.recording():
                    self._count_chunk_rows(chunk, e - s, rows)
            chunk = {k: self._put(v[rows]) for k, v in chunk.items()}
            chunk.update(imgs)
            with trace.span("eval.flat_forward"):
                outs.append((e - s, self._fwd(cast, d_bias, chunk, pmax)))

        def finalize():
            keys = sorted(outs[0][1])
            local = np.stack([[res[k].cpu().numpy() for k in keys]
                              for _, res in outs])      # [chunks, keys, rows]
            if self._split:
                local = np.concatenate(
                    dist.allgather_np(local, over=dist.DP), axis=2)
            fetched = [dict(zip(keys, v[:, :n])) for (n, _), v in
                       zip(outs, local)]
            scores = {k: np.concatenate([o[k] for o in fetched])
                      for k in fetched[0]}
            if order is not None:
                inv = np.empty_like(order)
                inv[order] = np.arange(N)
                scores = {k: v[inv] for k, v in scores.items()}
            return scores

        return finalize

    def _count_chunk_rows(self, chunk, n_real: int, rows):
        """The flat scorer's ``eval.rows_needed.flat`` (the attended
        extents of the chunk's real sequences this rank scores) and
        ``eval.rows_launched.flat`` (its rows times the chunk's length)."""
        ext = M_masks.attended_extent(
            chunk["mode"], chunk["ctx_end"], chunk["ans_len"],
            chunk["tokens"].shape[-1],
            chunk.get("mlm_labels") if self._need_lm else None)
        real = (np.arange(self.chunk) < n_real)[rows]
        trace.count("eval.rows_needed.flat", ext[rows][real].sum())
        trace.count("eval.rows_launched.flat",
                    real.size * chunk["tokens"].shape[-1])

    def score_slates(self, model, batch: Dict[str, np.ndarray]) -> dict:
        """Score a [B, R, O] val batch; returns flat [B*R*O] score arrays
        in the batch's order, with the keys of ``score_flat``."""
        return self.score_slates_async(model, batch)()

    def score_slates_async(self, model, batch: Dict[str, np.ndarray]):
        """Stage and launch a [B, R, O] val batch; return a closure that
        fetches and assembles the flat score dict. Slates the prefix scorer
        cannot take (decided on the host at dispatch) are launched through
        the flat scorer at the same time. The call is the root span
        ``eval.dispatch``, the closure ``eval.fetch``, with one id."""
        with trace.span("eval.dispatch") as did:
            trace.count("eval.dispatches")
            fin = self._slates_async(model, batch)

        def fetch():
            with trace.span("eval.fetch", id=did):
                return fin()

        return fetch

    def _slates_async(self, model, batch):
        B, R, O = np.asarray(batch["tokens"]).shape[:3]
        if self._decoder:
            fin = self._prefix.score_async(model, batch)

            def finalize_decoder():
                pref, _ = fin()
                return {k: v.reshape(B * R * O) for k, v in pref.items()}

            return finalize_decoder
        if self._prefix is None:
            return self.score_flat_async(
                model, flatten_for_forward(batch, train=False,
                                           compact_images=True))
        fin_prefix = self._prefix.score_async(model, batch)
        ok = self._prefix.last_ok
        fin_flat, m = None, None
        if not ok.all():
            flat = flatten_for_forward(batch, train=False,
                                       compact_images=True)
            m = np.repeat(~ok, O)
            # per-image arrays pass whole; every per-sequence array,
            # img_index included, is masked to the ineligible rows
            sub = {k: (v if k in _IMG_KEYS else v[m])
                   for k, v in flat.items()}
            fin_flat = self.score_flat_async(model, sub)

        def finalize():
            pref, _ = fin_prefix()
            scores = {k: v.reshape(B * R * O).copy() for k, v in pref.items()}
            if fin_flat is not None:
                fb = fin_flat()
                for k in scores:
                    scores[k][m] = fb[k]
            return scores

        return finalize


def _merge_batches(bs: Sequence[dict]) -> dict:
    """Concatenate loader batches along the dialog axis (coalesced serving).
    The 'valid' tail-padding mask is merged treating absent masks as
    all-True."""
    if len(bs) == 1:
        return bs[0]
    keys = set(bs[0]) - {"valid"}
    for b in bs[1:]:
        if set(b) - {"valid"} != keys:
            raise ValueError(
                f"coalesced batches must share keys: {sorted(keys)} vs "
                f"{sorted(set(b) - {'valid'})}")
    out = {k: np.concatenate([np.asarray(b[k]) for b in bs], axis=0)
           for k in keys}
    if any("valid" in b for b in bs):
        out["valid"] = np.concatenate(
            [np.asarray(b["valid"]) if "valid" in b
             else np.ones(np.asarray(b["tokens"]).shape[0], bool)
             for b in bs])
    return out


def _coalesced(loader, n: int):
    """Yield (number of loader batches merged, merged batch), up to n."""
    buf: List[dict] = []
    for b in loader:
        buf.append(b)
        if len(buf) == n:
            yield len(buf), _merge_batches(buf)
            buf = []
    if buf:
        yield len(buf), _merge_batches(buf)


def _serving_loop(loader, dispatch, consume, *, pipeline_depth: int,
                  coalesce: int):
    """Pipelined, coalesced serving loop: group i + depth is staged and
    launched before group i's scores are fetched. ``consume(done, batch,
    fin)`` receives the cumulative loader-batch count after the group."""
    if pipeline_depth < 1:
        raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
    if coalesce < 1:
        raise ValueError(f"coalesce must be >= 1, got {coalesce}")
    pending: List[tuple] = []
    done = 0
    for nb, batch in _coalesced(loader, coalesce):
        done += nb
        pending.append((done, batch, dispatch(batch)))
        if len(pending) > pipeline_depth:
            consume(*pending.pop(0))
    for p in pending:
        consume(*p)


def _evaluator(cfg, mode, **kw):
    """The evaluator for ``mode`` and the score key it ranks by: NSP
    scores through the flat scorer (``score_slates`` has no prefix scorer
    then), ll_sum / ll_mean through the prefix scorer and its flat
    fallback."""
    if mode not in ("nsp", "ll_sum", "ll_mean"):
        raise ValueError(f"mode {mode!r}: 'nsp', 'll_sum' or 'll_mean'")
    need_lm = mode != "nsp"
    return (RankingEvaluator(cfg, need_lm=need_lm, need_nsp=not need_lm,
                             **kw),
            "nsp_prob" if mode == "nsp" else mode)


def _valid(batch, B):
    # rows duplicated by a loader's tail padding: scored (fixed shapes) but
    # never ranked or observed
    return (np.asarray(batch["valid"]) if "valid" in batch
            else np.ones(B, bool))


def _fit_chunk(chunk_size: int, split_rows: bool) -> int:
    """The chunk rounded down to a multiple of the dp size under
    ``split_rows`` (at least one row a dp index)."""
    n = dist.dp_size() if split_rows else 1
    return max(n, chunk_size // n * n)


def evaluate_split(model, cfg: VilbertConfig, loader, *, mode: str,
                   chunk_size: int = 256, dtype=torch.bfloat16,
                   ranks_out: Optional[list] = None,
                   progress_every: int = 10, log=print,
                   gen_prefix: bool = True, prefix_group: int = 40,
                   prefix_packed: bool = True, prefix_rowblock: int = 0,
                   process_merge: bool = False, split_rows: bool = False,
                   pipeline_depth: int = 1,
                   coalesce: int = 2, device="cuda") -> dict:
    """Run ranking eval over a loader of [B, R, O] val batches.

    mode: 'nsp' (discriminative, the flat scorer), 'll_sum' (val_lm) or
    'll_mean' (val_avg_lm; both through the prefix scorer with the flat
    fallback). Batches carry gt_option_inds [B, R], round_id [B],
    gt_relevance [B, O], image_id [B] when ``ranks_out`` is given, and
    optionally a boolean ``valid`` [B] mask of rows to observe (the
    process-sharded loader's tail padding: scored, never observed). Returns
    the metric dict (R@k / mean / MRR, per round, and NDCG).

    In a world of several processes: ``split_rows`` (every rank iterates
    the same loader; see ``RankingEvaluator``) or ``process_merge`` (each
    rank's loader holds a disjoint shard; the ranks' metric statistics
    are merged at the end, so every rank returns the metrics of the whole
    split).
    """
    ev, key = _evaluator(cfg, mode,
                         chunk_size=_fit_chunk(chunk_size, split_rows),
                         dtype=dtype, gen_prefix=gen_prefix,
                         prefix_group=prefix_group,
                         prefix_packed=prefix_packed,
                         prefix_rowblock=prefix_rowblock,
                         split_rows=split_rows, device=device)
    sparse = M.SparseGTMetrics()
    ndcg = M.NDCG()
    logged = 0

    def dispatch(batch):
        return ev.score_slates_async(model, batch)

    def consume(done, batch, finalize):
        nonlocal logged
        B, R, O = np.asarray(batch["tokens"]).shape[:3]
        out = finalize()[key].reshape(B, R, O)
        valid = _valid(batch, B)
        if ranks_out is not None:
            ranks = M.scores_to_ranks(out)
            for b in range(B):
                if not valid[b]:
                    continue
                for r in range(R):
                    ranks_out.append({
                        "image_id": int(batch["image_id"][b]),
                        "round_id": r + 1,
                        "ranks": [int(x) for x in ranks[b, r]],
                    })
        sparse.observe(out[valid], np.asarray(batch["gt_option_inds"])[valid])
        rid = np.asarray(batch["round_id"]).reshape(B)
        dense_scores = out[np.arange(B), rid - 1]
        ndcg.observe(dense_scores[valid],
                     np.asarray(batch["gt_relevance"])[valid])
        if progress_every and done // progress_every > logged:
            logged = done // progress_every
            cur = {**sparse.retrieve(reset=False),
                   **ndcg.retrieve(reset=False)}
            keys = ("r@1", "r@5", "r@10", "mean", "mrr", "ndcg")
            body = " ".join(f"{k} {cur[k]:.4f}" for k in keys if k in cur)
            log(f"eval batches: {done} " + (body or "(no valid rows yet)"))

    _serving_loop(loader, dispatch, consume,
                  pipeline_depth=pipeline_depth, coalesce=coalesce)
    if process_merge and dist.world_size() > 1:
        return M.allreduce_metrics(sparse, ndcg)
    return {**sparse.retrieve(), **ndcg.retrieve()}


def minmax_per_slate(scores: np.ndarray) -> np.ndarray:
    """Per-slate min-max normalisation for ensembling (val.py:151-158)."""
    lo = scores.min(axis=-1, keepdims=True)
    hi = scores.max(axis=-1, keepdims=True)
    return (scores - lo) / np.maximum(hi - lo, 1e-12)


def evaluate_ensemble(models: Sequence, cfg: VilbertConfig, loader, *,
                      mode: str = "nsp", chunk_size: int = 256,
                      dtype=torch.bfloat16, ranks_out: Optional[list] = None,
                      test_split: bool = False, log=print,
                      gen_prefix: bool = True, prefix_group: int = 40,
                      prefix_packed: bool = True, prefix_rowblock: int = 0,
                      process_merge: bool = False, split_rows: bool = False,
                      pipeline_depth: int = 1,
                      coalesce: int = 1, progress_every: int = 10,
                      device="cuda") -> dict:
    """Multi-checkpoint ensemble: per-model scores are min-max normalised
    per slate and summed (val.py:151-164 / evaluate.py:108-132). With
    ``test_split`` the loader yields [B, 1, 100] slates and ranks_out
    records the EvalAI format (round_id from the data); no metrics are
    computed (the test split has no ground truth). Pipelining, coalescing,
    the ``valid`` mask, ``split_rows`` and ``process_merge`` as in
    ``evaluate_split``; every member's chunks of a group are launched
    before the previous group is fetched."""
    ev, key = _evaluator(cfg, mode,
                         chunk_size=_fit_chunk(chunk_size, split_rows),
                         dtype=dtype, gen_prefix=gen_prefix,
                         prefix_group=prefix_group,
                         prefix_packed=prefix_packed,
                         prefix_rowblock=prefix_rowblock,
                         split_rows=split_rows, device=device)
    sparse = M.SparseGTMetrics()
    ndcg = M.NDCG()
    logged = 0

    def dispatch(batch):
        return [ev.score_slates_async(m, batch) for m in models]

    def consume(done, batch, fins):
        nonlocal logged
        B, R, O = np.asarray(batch["tokens"]).shape[:3]
        total = np.zeros((B, R, O), np.float64)
        for fin in fins:
            total += minmax_per_slate(fin()[key].reshape(B, R, O))
        valid = _valid(batch, B)
        if ranks_out is not None:
            ranks = M.scores_to_ranks(total)
            for b in range(B):
                if not valid[b]:
                    continue
                if test_split:
                    ranks_out.append({
                        "image_id": int(batch["image_id"][b]),
                        "round_id": int(np.asarray(batch["round_id"])
                                        .reshape(B)[b]),
                        "ranks": [int(x) for x in ranks[b, 0]],
                    })
                else:
                    for r in range(R):
                        ranks_out.append({
                            "image_id": int(batch["image_id"][b]),
                            "round_id": r + 1,
                            "ranks": [int(x) for x in ranks[b, r]],
                        })
        if not test_split:
            sparse.observe(total[valid],
                           np.asarray(batch["gt_option_inds"])[valid])
            rid = np.asarray(batch["round_id"]).reshape(B)
            ndcg.observe(total[np.arange(B), rid - 1][valid],
                         np.asarray(batch["gt_relevance"])[valid])
        if progress_every and done // progress_every > logged:
            logged = done // progress_every
            log(f"eval batches: {done}")

    _serving_loop(loader, dispatch, consume,
                  pipeline_depth=pipeline_depth, coalesce=coalesce)
    if test_split:
        return {}
    if process_merge and dist.world_size() > 1:
        return M.allreduce_metrics(sparse, ndcg)
    return {**sparse.retrieve(), **ndcg.retrieve()}


def dump_ranks(ranks: list, path: str, all_processes: bool = False):
    """Write the ranks list as JSON. In a world of several processes only
    rank 0 writes (split-rows serving gives every rank the same ranks);
    ``all_processes``: every rank writes its own, the caller putting the
    rank in ``path``."""
    if not all_processes and dist.rank() != 0:
        return
    with open(path, "w") as f:
        json.dump(ranks, f)


def dump_ranks_merged(ranks: list, path: str) -> int:
    """Write one predictions file sorted by (image_id, round_id), as the
    reference's single save_name file (val_lm.py:186-190), from the ranks'
    disjoint shards of data-sharded eval: every rank's records are
    gathered and rank 0 writes them. Returns the record count of the whole
    file on every rank."""
    merged = sorted((e for part in dist.allgather_objects(ranks)
                     for e in part),
                    key=lambda e: (e["image_id"], e["round_id"]))
    if dist.rank() == 0:
        with open(path, "w") as f:
            json.dump(merged, f)
    return len(merged)
