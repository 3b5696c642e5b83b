"""Decoder eval cells: ranking Visual Dialog slates by log-likelihood with
a causal decoder (``unimm_torch.models.deepseek_v3`` under a
``DeepseekV3Config``) through the program's ``RankingEvaluator``, as
``eval_slates`` serves the ViLBERT cells.

The pool: ``dialogs`` dialogs of ``rounds`` slates of ``options`` options,
their sizes from ``traffic.slate_sizes`` (the mix's ``size_seed``: each
round's text context and each option's answer length), each dialog's
image tokens (``image_tokens``: a count from the size seed, the vision
projector's outputs normal(0, ``image_std``) from the run seed) first in
every context of the dialog; text tokens from the run seed, each answer
followed by the mix's ``end_token``. Grouped into loader batches of
``loader_batch`` dialogs, ``coalesce`` of them a dispatch.

Set-up: the seeded weights (``reference.deepseek_v3_ref.draw``, a tensor
at a time into the program's bf16 model), one persistent evaluator, and a
warm-up lap over every group of the pool. The window: ``eval_slates.serve``
(a closed loop, ``pipeline_depth`` in flight). With ``--trace 1`` the
first ``trace_slice_s`` are profiled (the program's ranges on) and the
rest runs with the program's recorder on: ``ctx["program"]`` holds the
slice's attribution (``harness/program.attribute``) and the recorder's
snapshot, which the decoder's per-layer readers read; their tables go to
stderr (``harness/program.tables``).

The check, once the program is freed: a seeded sample of ``slates``
slates among those the window completed (the longest context among them),
``options`` options each (the longest answer among them), scored again by
the plain fp32 reference, each option a whole causal sequence with no
cache. Every dispatch runs inside a ``utils.trace`` capture, which keeps
the experts the program chose for every row (``moe.route``) and the rows'
places (``eval.rows``); they go to the host when the dispatch's scores are
fetched. The reference weights those experts with its own fp32 router
scores, so that a choice that bf16 rounding flipped at a near-tie does not
enter the likelihoods, and the routes are held on their own, by two
numbers against their limits: ``route_gap``, the largest margin by which
the reference's own k-th choice score beats the lowest of the program's
choices (0 where they agree), and ``route_flips``, the share of (token,
layer) choices that differ. ``ll_gap``: the largest |ll_sum gap| over the
options' label tokens (nats a token).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.counts import deepseek_v3 as counts
from benchmark.harness import program as pg
from benchmark.harness import spec as spec_mod
from benchmark.harness import trace as tr
from benchmark.harness import traffic
from benchmark.loops import eval_slates
from benchmark.reference import deepseek_v3_ref as ref


def make_pool(mix: dict, cfg: dict, seed: int):
    """(loader batches, the seeded serving order of the coalesced
    groups) of the decoder mix ``mix``."""
    L, V, H = mix["max_seq_len"], cfg["vocab_size"], cfg["hidden_size"]
    D, R, O = mix["dialogs"], mix["rounds"], mix["options"]
    lc, a = traffic.slate_sizes(mix, L)
    A = a + 1                                    # the end token
    ni = np.random.default_rng([mix["size_seed"], 1]).integers(
        *mix["image_tokens"], D)
    Ni = int(mix["image_tokens"][1]) - 1
    rng = np.random.default_rng([seed, 0])
    j = np.arange(L)
    ctx = rng.integers(1, V, (D, R, L), dtype=np.int32)
    ans = rng.integers(1, V, (D, R, O, L), dtype=np.int32)
    lc4 = lc[:, :, None, None]
    in_ans = (j >= lc4) & (j < lc4 + A[..., None])
    src = np.clip(j - lc4, 0, L - 1)
    ans = np.take_along_axis(ans, src, -1)
    ans = np.where(j == lc4 + A[..., None] - 1, mix["end_token"], ans)
    tokens = np.where(in_ans, ans, np.where(j < lc4, ctx[:, :, None], 0))
    img = (mix["image_std"] * rng.standard_normal((D, Ni, H),
                                                  dtype=np.float32))
    nb = mix["loader_batch"]
    if D % (nb * mix["coalesce"]):
        raise ValueError("dialogs must fill whole coalesced groups")
    pool = []
    for s in range(0, D, nb):
        e = s + nb
        pool.append({
            "tokens": tokens[s:e].astype(np.int32),
            "ctx_end": np.repeat(lc[s:e, :, None], O, -1).astype(np.int32),
            "ans_len": A[s:e].astype(np.int32),
            "image_embeds": img[s:e], "image_len": ni[s:e].astype(np.int32)})
    return pool, rng.permutation(len(pool) // mix["coalesce"])


class Program:
    """The system under test: the decoder's bf16 weights, drawn a tensor
    at a time, and one evaluator; ``logs`` gets each fetched dispatch's
    route records (``route_records``)."""

    def __init__(self, cfg: dict, serving: dict, seed: int, device):
        from unimm_torch.config import DeepseekV3Config
        from unimm_torch.eval.evaluator import RankingEvaluator
        from unimm_torch.models import deepseek_v3 as dsv3
        self.pcfg = DeepseekV3Config.from_dict(spec_mod.model_keys(cfg))
        self.model = dsv3.DecoderModel(
            self.pcfg, device, dtype=getattr(torch, cfg["bench"]["dtype"]))
        for name, shape in ref.param_shapes(cfg):
            self.model.load(name, ref.draw(cfg, seed, name, shape, device))
        self.ev = RankingEvaluator(
            self.pcfg, need_lm=True, need_nsp=False,
            prefix_group=serving["prefix_group"], device=device)
        self.n_moe = sum(self.pcfg.is_moe(i)
                         for i in range(self.pcfg.num_hidden_layers))
        self.logs = []

    def dispatch(self, batch):
        from unimm_torch.utils import trace as ptrace

        with ptrace.capture() as kept:
            fin = self.ev.score_slates_async(self.model, batch)

        def fetch():
            scores = fin()
            self.logs.append(route_records(kept, self.n_moe))
            kept.clear()            # the device's copies go now
            return scores

        return fetch


def route_records(kept, n_moe: int):
    """A dispatch's capture as one record a group: its ``eval.rows`` and
    the experts its MoE layers chose, on the host (``prefill``, ``answer``:
    uint8 [rows, k] a layer)."""
    routes = [t.cpu() for t in kept.get("moe.route", [])]
    out = []
    for i, rows in enumerate(kept.get("eval.rows", [])):
        r = routes[2 * n_moe * i:2 * n_moe * (i + 1)]
        out.append(dict(rows, prefill=r[:n_moe], answer=r[n_moe:]))
    return out


def _sequences(batch, s, opts, log, cfg, emb, device):
    """Slate ``s`` of a merged batch, options ``opts``, as the reference's
    whole sequences: [(embeds [n, H] fp32, labels [n], routes {layer:
    [n, k]} from the program's ``log``)], one an option."""
    R = batch["tokens"].shape[1]
    b, r = divmod(s, R)
    rec = next(x for x in log if s in x["slates"])
    j = int(np.nonzero(rec["slates"] == s)[0][0])
    ni = int(batch["image_len"][b])
    lc = int(batch["ctx_end"][b, r, 0])
    n_ctx = ni + lc
    img = torch.from_numpy(batch["image_embeds"][b, :ni])
    ctx_at = np.nonzero(rec["ctx_rows"][0] == j)[0]
    ctx_pos = torch.from_numpy(rec["ctx_rows"][1][ctx_at])
    moe_layers = [i for i in range(cfg["num_hidden_layers"])
                  if i >= cfg["first_k_dense_replace"]]
    out = []
    for o in opts:
        A = int(batch["ans_len"][b, r, o])
        t = torch.from_numpy(batch["tokens"][b, r, o, :lc + A].astype(
            np.int64))
        x = torch.cat([img.to(device), emb[t[:-1].to(device)]])
        lab = torch.full((n_ctx + A - 1,), -1, dtype=torch.long)
        lab[n_ctx - 1:] = t[lc:]
        ans_at = np.nonzero((rec["ans_rows"][0] == j)
                            & (rec["ans_rows"][1] == o))[0]
        ans_pos = torch.from_numpy(n_ctx + rec["ans_rows"][2][ans_at])
        routes = {}
        for li, i in enumerate(moe_layers):
            rt = torch.empty(n_ctx + A - 1, cfg["num_experts_per_tok"],
                             dtype=torch.long)
            rt[ctx_pos] = rec["prefill"][li][torch.from_numpy(ctx_at)].long()
            rt[ans_pos] = rec["answer"][li][torch.from_numpy(ans_at)].long()
            routes[i] = rt
        out.append((x, lab, routes))
    return out


def _stack(seqs, device):
    """(embeds [n, Lmax, H], lengths, labels [n, Lmax], routes {layer:
    [n, Lmax, k]}) of ``_sequences``' items, padded after each."""
    n = max(x.shape[0] for x, _, _ in seqs)
    X = torch.stack([F.pad(x, (0, 0, 0, n - x.shape[0])) for x, _, _ in seqs])
    Y = torch.stack([F.pad(y, (0, n - y.shape[0]), value=-1)
                     for _, y, _ in seqs]).to(device)
    Rt = {i: torch.stack([F.pad(rt[i], (0, 0, 0, n - rt[i].shape[0]))
                          for _, _, rt in seqs]).to(device)
          for i in seqs[0][2]}
    lengths = torch.tensor([x.shape[0] for x, _, _ in seqs], device=device)
    return X, lengths, Y, Rt


def pick_options(batch, s, n_opt, seed):
    """``n_opt`` options of slate ``s``: its longest answer, then a seeded
    draw."""
    R = batch["tokens"].shape[1]
    b, r = divmod(s, R)
    A = batch["ans_len"][b, r]
    rng = np.random.default_rng([seed, 3, s])
    first = int(np.argmax(A))
    rest = [int(o) for o in rng.permutation(len(A)) if o != first]
    return [first] + rest[:n_opt - 1]


def check(cfg, seed, device, groups, coalesce, done, logs, n_slates,
          n_opt, control=None):
    """The check over a seeded sample of the window's completed slates,
    their options whole sequences in one reference forward: {"ll_gap",
    "route_gap", "route_flips" (a share), "compared"}.
    ``control``: a ``Precision`` whose reference takes the program's
    place (with the program's routes)."""
    B = groups[0]["tokens"].shape[0] * coalesce
    R = groups[0]["tokens"].shape[1]
    lc = {}
    for g, _ in done:
        if g not in lc:
            bt = eval_slates.merge(groups[g * coalesce:(g + 1) * coalesce])
            lc[g] = (bt["image_len"][:, None] + bt["ctx_end"][..., 0]
                     ).reshape(-1)
    picks = eval_slates.sample(done, (B, R), n_slates, seed, lc)
    W = ref.Weights(cfg, seed, device)
    emb = W["model.embed_tokens.weight"]
    seqs, mine = [], []
    for ci, s in picks:
        g, scores = done[ci]
        bt = eval_slates.merge(groups[g * coalesce:(g + 1) * coalesce])
        opts = pick_options(bt, s, n_opt, seed)
        seqs += _sequences(bt, s, opts, logs[ci], cfg, emb, device)
        O = bt["tokens"].shape[2]
        mine.append(scores["ll_sum"][s * O:(s + 1) * O][opts])
    del emb
    X, lengths, Y, Rt = _stack(seqs, device)
    stats = {}
    want, _ = ref.ll_sum(cfg, W, X, lengths, Y, ref.Precision("fp32"), Rt,
                         stats)
    if control is None:
        mine = np.concatenate(mine).astype(np.float64)
    else:
        mine = ref.ll_sum(cfg, W, X, lengths, Y, control, Rt)[0].double(
        ).cpu().numpy()
    del W
    n_lab = (Y != -1).sum(-1).double().cpu().numpy()
    d = np.abs(mine - want.double().cpu().numpy()) / n_lab
    gap = float(d.max()) if np.all(np.isfinite(d)) else math.inf
    return {"ll_gap": gap, "route_gap": stats["route_gap"],
            "route_flips": stats["flips"] / max(1, stats["routed"]),
            "compared": len(seqs)}


def run(spec, seed: int, seconds: float, trace: bool, device,
        t_start: float, program=Program):
    """One run of a decoder eval cell; returns (result fields, checks)."""
    from unimm_torch.utils import trace as ptrace

    cfg, mix, srv = spec.config, spec.traffic, spec.serving
    parts = tr.Parts(t_start)
    groups, order = make_pool(mix, cfg, seed)
    c, depth = mix["coalesce"], srv["pipeline_depth"]
    dialogs = mix["loader_batch"] * c
    counter = counts.COUNTERS[srv["counter"]]
    work = [counter(cfg, eval_slates.merge(groups[g * c:(g + 1) * c]))
            for g in range(len(order))]
    parts.mark("pool")
    prog = program(cfg, srv, seed, device)
    parts.mark("program")
    spans = tr.Spans()
    eval_slates.serve(prog, groups, order, c, depth, tr.Spans(), laps=1)
    tr.sync(device)
    prog.logs.clear()
    parts.mark("warm-up")
    setup_s = time.perf_counter() - t_start

    done, lat = [], []

    def on_done(g, td, t1, scores):
        done.append((g, {k: np.asarray(v) for k, v in scores.items()}))
        lat.append(t1 - td)

    summary, slice_groups, att, snap = None, 0, None, None
    if trace:
        prof = tr.Profile(spans, device)
        slice_s = min(srv["trace_slice_s"], seconds / 2)
        prof.start()
        eval_slates.serve(prog, groups, order, c, depth, spans,
                          seconds=slice_s, on_done=on_done)
        tr.sync(device)
        prof.stop()
        att = pg.attribute(pg.events(prof.prof))
        slice_groups = len(done)
        lat.clear()
        ptrace.reset()
        ptrace.enable()
        try:
            wall = eval_slates.serve(prog, groups, order, c, depth, spans,
                                     seconds=seconds - slice_s,
                                     on_done=on_done)
            tr.sync(device)
        finally:
            ptrace.disable()
        snap = ptrace.snapshot()
        ptrace.reset()
        pg.tables(att, snap, ("eval.dispatch", "eval.fetch"))
        summary = prof.summary()
        slice_work = {k: sum(work[g][k] for g, _ in done[:slice_groups])
                      for k in work[0]}
        slice_work["dialogs"] = slice_groups * dialogs
    else:
        wall = eval_slates.serve(prog, groups, order, c, depth, spans,
                                 seconds=seconds, on_done=on_done)
    host_done = done[slice_groups:]
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    failed = sum(dialogs for _, s in done
                 if not np.all(np.isfinite(s["ll_sum"])))
    host_work = {k: sum(work[g][k] for g, _ in host_done) for k in work[0]}
    ctx = {"cfg": cfg, "unit": "dialogs", "trace": summary,
           "slice_work": slice_work if trace else None,
           "host": {"seconds": wall, "units": len(host_done) * dialogs,
                    "spans": dict(spans.durations), **host_work},
           "memory": {"peak_bytes": peak}}
    if trace:
        ctx["program"] = {"device": att, "host": snap}
    e2e = {"dialogs_per_s": len(host_done) * dialogs / wall,
           "group_p95_ms": float(np.percentile(lat, 95)) * 1e3,
           "setup_s": setup_s}

    # the check, once the program's state is freed
    logs = prog.logs
    del prog
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    got = check(cfg, seed, device, groups, c, done, logs,
                spec.check["slates"], spec.check["options"])
    checks = {k: {"value": got[k], "limit": spec.limits[k]}
              for k in ("ll_gap", "route_gap", "route_flips")}
    ok = (failed == 0 and got["compared"] > 0
          and all(v["value"] <= v["limit"] for v in checks.values()))
    ctx["check"] = got
    return {"correct": bool(ok), "attempted": len(done) * dialogs,
            "failed": failed, "e2e": e2e, "ctx": ctx, "peak": peak,
            "compared": got["compared"]}, checks
