"""Eval cells: ranking Visual Dialog slates through the program's
evaluator, as ``evaluate_split`` serves them.

Set-up: the seeded weights (``reference.make_weights``) loaded into the
program's model, one persistent ``RankingEvaluator`` with
``evaluate_split``'s settings and the cell's ``serving`` ones, the traffic
pool, and one warm-up lap over every group of the pool (every shape the
window serves). The window is a closed loop with ``pipeline_depth``
groups in flight, a copy of ``evaluator._serving_loop`` over coalesced
loader batches (``_merge_batches``): a group is staged and launched, then
the oldest pending one is fetched. After the window, a seeded sample of the
slates whose scores came back is scored again by the plain reference,
option by option, on a full flat forward (no prefix cache), and compared.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.counts import vilbert as counts
from benchmark.harness import spec as spec_mod
from benchmark.harness import trace as tr
from benchmark.harness import traffic
from benchmark.reference import vilbert_ref as ref

# the program's score key and the reference number compared, by mode
SCORE_KEY = {"ll_sum": "ll_sum", "nsp": "nsp_prob"}


def merge(bs: List[dict]) -> dict:
    """Loader batches concatenated along the dialog axis: a copy of
    ``evaluator._merge_batches`` (the pool's batches carry no ``valid``
    mask)."""
    if len(bs) == 1:
        return bs[0]
    return {k: np.concatenate([b[k] for b in bs], axis=0) for k in bs[0]}


class Program:
    """The system under test: the fp32 model with the seeded weights and
    one evaluator."""

    def __init__(self, cfg: dict, serving: dict, seed: int, device):
        from unimm_torch.config import VilbertConfig
        from unimm_torch.eval.evaluator import RankingEvaluator
        from unimm_torch.models import vilbert
        self.pcfg = VilbertConfig.from_dict(spec_mod.model_keys(cfg))
        self.model = vilbert.empty_model(self.pcfg, device)
        W = ref.make_weights(cfg, seed, cfg["bench"]["init_std"], device)
        self.model.load_state_dict(W, strict=True)
        del W
        mode = serving["mode"]
        self.ev = RankingEvaluator(
            self.pcfg, chunk_size=serving["chunk_size"],
            dtype=torch.bfloat16, need_lm=mode != "nsp",
            need_nsp=mode == "nsp", gen_prefix=True,
            prefix_group=serving["prefix_group"], prefix_packed=True,
            prefix_rowblock=0, split_rows=False, device=device)

    def dispatch(self, batch):
        return self.ev.score_slates_async(self.model, batch)


def serve(prog, groups, order, coalesce, depth, spans, *, seconds=None,
          laps=None, on_done=None):
    """The closed serving loop over the pool's groups in ``order``, for
    ``seconds`` (then every pending group is fetched) or ``laps`` whole
    laps. ``on_done(group, t_dispatch, t_done, scores)``. Returns the
    wall seconds from the first dispatch to the last fetch."""
    pending = []
    t0 = time.perf_counter()
    n = len(order) * laps if laps is not None else None
    i = 0

    def fetch():
        g, td, fin = pending.pop(0)
        with spans("fetch"):
            scores = fin()
        if on_done is not None:
            on_done(g, td, time.perf_counter(), scores)

    while (i < n) if n is not None else (time.perf_counter() - t0 < seconds):
        g = int(order[i % len(order)])
        i += 1
        with spans("merge"):
            batch = merge(groups[g * coalesce:(g + 1) * coalesce])
        td = time.perf_counter()
        with spans("dispatch"):
            fin = prog.dispatch(batch)
        pending.append((g, td, fin))
        if len(pending) > depth:
            fetch()
    while pending:
        fetch()
    return time.perf_counter() - t0


def sample(done, shape, n: int, seed: int, lc):
    """A seeded sample of ``n`` (completion index, slate index) among the
    window's completed groups, with the longest context in it."""
    B, R = shape
    rng = np.random.default_rng([seed, 2])
    picks = set()
    longest = max(((ci, s) for ci, (g, _) in enumerate(done)
                   for s in range(B * R)),
                  key=lambda p: lc[done[p[0]][0]][p[1]])
    picks.add(longest)
    total = len(done) * B * R
    while len(picks) < min(n, total):
        k = int(rng.integers(total))
        picks.add((k // (B * R), k % (B * R)))
    return sorted(picks)


def slate_batch(batch: dict, s: int, device) -> Dict[str, torch.Tensor]:
    """Slate ``s`` (b * R + r) of a merged [B, R, O] batch as a flat batch
    of its O options, cut to their longest attended extent."""
    B, R, O, L = batch["tokens"].shape
    b, r = divmod(s, R)
    mode, ce, al = (batch[k][b, r] for k in ("mode", "ctx_end", "ans_len"))
    ext = int(counts.extents(mode, ce, al, L).max())
    lab = batch["mlm_labels"][b, r]
    if (lab != -1).any():
        ext = max(ext, int(np.nonzero((lab != -1).any(0))[0].max()) + 1)
    out = {k: batch[k][b, r][:, :ext] for k in ("tokens", "segments",
                                                  "mlm_labels")}
    out.update(mode=mode, ctx_end=ce, ans_len=al)
    for k in ("image_feat", "image_loc", "image_mask"):
        out[k] = np.broadcast_to(batch[k][b], (O,) + batch[k][b].shape)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in out.items()}


def compare(mode, prog_scores, ref_out, batch_slate):
    """Per option, the gap between the program's score and the
    reference's: ``ll_sum`` per label token (nats), or the NSP margin
    (logit 0 - logit 1) from the program's probability."""
    if mode == "nsp":
        p = prog_scores.astype(np.float64)
        with np.errstate(divide="ignore"):
            m = np.log(p) - np.log1p(-p)
        return np.abs(m - ref_out["nsp_margin"].double().cpu().numpy())
    n_lab = (batch_slate["mlm_labels"] != -1).sum(-1).double().cpu().numpy()
    d = np.abs(prog_scores.astype(np.float64)
               - ref_out["ll_sum"].double().cpu().numpy())
    return d / np.maximum(n_lab, 1.0)


def as_program(mode, out):
    """Reference output in the form the program returns its scores."""
    if mode == "nsp":
        return torch.sigmoid(out["nsp_margin"]).double().cpu().numpy()
    return out["ll_sum"].double().cpu().numpy()


def check(cfg, mode, seed, device, groups, coalesce, done, n_sample,
          control=None):
    """The largest gap over a seeded sample of the window's slates (the
    ``done`` completions) between the program's scores and the fp32
    reference's, and the count of options compared. ``control``: a
    ``Precision`` whose reference takes the program's place."""
    B = groups[0]["tokens"].shape[0] * coalesce
    R = groups[0]["tokens"].shape[1]
    lc = {}
    for g, _ in done:
        if g not in lc:
            bt = merge(groups[g * coalesce:(g + 1) * coalesce])
            lc[g] = (bt["ctx_end"] - bt["ans_len"])[..., 0].reshape(-1)
    picks = sample(done, (B, R), n_sample, seed, lc)
    W = ref.make_weights(cfg, seed, cfg["bench"]["init_std"], device)
    key = SCORE_KEY[mode]
    worst, count = 0.0, 0
    for ci, s in picks:
        g, scores = done[ci]
        bt = merge(groups[g * coalesce:(g + 1) * coalesce])
        sb = slate_batch(bt, s, device)
        O = sb["tokens"].shape[0]
        out = ref.score(cfg, W, sb, ref.Precision("fp32"))
        mine = (scores[key][s * O:(s + 1) * O] if control is None
                else as_program(mode, ref.score(cfg, W, sb, control)))
        gap = compare(mode, mine, out, sb)
        worst = max(worst, float(np.max(gap)) if np.all(np.isfinite(gap))
                    else math.inf)
        count += O
    del W
    return worst, count


def run(spec, seed: int, seconds: float, trace: bool, device,
        t_start: float, program=Program):
    """One run of an eval cell; returns (result fields, checks)."""
    cfg, mix, srv = spec.config, spec.traffic, spec.serving
    parts = tr.Parts(t_start)
    groups, order = traffic.make(mix, cfg, seed)
    c, depth = mix["coalesce"], srv["pipeline_depth"]
    dialogs = mix["loader_batch"] * c
    counter = counts.COUNTERS[srv["counter"]]
    work = [counter(cfg, merge(groups[g * c:(g + 1) * c]))
            for g in range(len(order))]
    parts.mark("pool")
    prog = program(cfg, srv, seed, device)
    parts.mark("program")
    spans = tr.Spans()
    serve(prog, groups, order, c, depth, tr.Spans(), laps=1)
    tr.sync(device)
    parts.mark("warm-up")
    setup_s = time.perf_counter() - t_start

    done, lat = [], []

    def on_done(g, td, t1, scores):
        done.append((g, {k: np.asarray(v) for k, v in scores.items()}))
        lat.append(t1 - td)

    summary, slice_groups = None, 0
    if trace:
        # the traced slice first; the host metrics from the rest
        prof = tr.Profile(spans, device)
        slice_s = min(srv["trace_slice_s"], seconds / 2)
        prof.start()
        serve(prog, groups, order, c, depth, spans, seconds=slice_s,
              on_done=on_done)
        tr.sync(device)
        prof.stop()
        slice_done = list(done)
        slice_groups = len(slice_done)
        done.clear()
        lat.clear()
        wall = serve(prog, groups, order, c, depth, spans,
                     seconds=seconds - slice_s, on_done=on_done)
        summary = prof.summary()
        slice_work = {k: sum(work[g][k] for g, _ in slice_done)
                      for k in work[0]}
        slice_work["dialogs"] = slice_groups * dialogs
        done = slice_done + done
    else:
        wall = serve(prog, groups, order, c, depth, spans, seconds=seconds,
                     on_done=on_done)
    host_done = done[slice_groups:]
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    key = SCORE_KEY[srv["mode"]]
    failed = sum(dialogs for _, s in done if not np.all(np.isfinite(s[key])))
    n_host = len(host_done)
    host_work = {k: sum(work[g][k] for g, _ in host_done) for k in work[0]}
    e2e = {"dialogs_per_s": n_host * dialogs / wall,
           "group_p95_ms": float(np.percentile(lat, 95)) * 1e3,
           "setup_s": setup_s}
    ctx = {"cfg": cfg, "unit": "dialogs", "trace": summary,
           "slice_work": slice_work if trace else None,
           "host": {"seconds": wall, "units": n_host * dialogs,
                    "spans": dict(spans.durations), **host_work},
           "memory": {"peak_bytes": peak}}

    # the comparison, once the program's state is freed
    del prog
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    gap, compared = check(cfg, srv["mode"], seed, device, groups, c, done,
                          spec.check["slates"])
    name = spec.check["number"]
    checks = {name: {"value": gap, "limit": spec.limits[name]}}
    ok = failed == 0 and compared > 0 and gap <= spec.limits[name]
    return {"correct": bool(ok), "attempted": len(done) * dialogs,
            "failed": failed, "e2e": e2e, "ctx": ctx, "peak": peak,
            "compared": compared}, checks
