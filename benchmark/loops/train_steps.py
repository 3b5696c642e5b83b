"""Training cells: the UniMM-UL training step as the training command line
takes it (``train/step.make_train_step_with_fallback`` on batches staged by
``cli/train.to_device``), one step a batch.

Set-up builds one training state (the seeded weights as fp32 master
weights, the grouped AdamW of the configuration) and drives it through its
first three steps on three different batches of the pool, through the
window's own call and feed; those steps are the warm-up, and their
readings (each step's loss, each leaf's first gradient as the optimizer
took it, each leaf's change after the three) are what the reference is
held to. The window then runs the same state on, one step per pool batch
in the seeded order. After the window the program is freed and the
reference takes the same three steps in fp32, in blocks of rows, with the
program's dropout streams drawn again.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark.counts import vilbert as counts
from benchmark.harness import spec as spec_mod
from benchmark.harness import trace as tr
from benchmark.harness import traffic
from benchmark.reference import vilbert_ref as ref

FIRST_STEPS = 3
B1 = 0.9
# leaves whose reference gradient is below this share of the median leaf's
# move by round-off alone (a key's bias under softmax): left out of the
# change
ZERO_GRAD_SHARE = 1e-3


def step_seed(seed: int, step: int, rank=None) -> int:
    """The dropout seed of step ``step`` of a run seeded ``seed``: one
    stream per (seed, step), and per rank in a world of several."""
    key = [seed, step] if rank is None else [seed, step, rank]
    return int(np.random.SeedSequence(key).generate_state(
        1, np.uint64)[0])


class Program:
    """The system under test: one training state and the step function
    of the training command line."""

    def __init__(self, cfg: dict, seed: int, device):
        from unimm_torch.cli.train import to_device
        from unimm_torch.config import VilbertConfig
        from unimm_torch.models import vilbert
        from unimm_torch.train import optim
        from unimm_torch.train import step as tstep
        b = cfg["bench"]
        o = b["optimizer"]
        self.pcfg = VilbertConfig.from_dict(spec_mod.model_keys(cfg))
        model = vilbert.empty_model(self.pcfg, device)
        W = ref.make_weights(cfg, seed, b["init_std"], device)
        model.load_state_dict(W, strict=True)
        del W
        model.train().requires_grad_(True)
        # one learning rate for text and image parameters, as the
        # reference takes it
        ocfg = optim.OptimConfig(
            lr=o["lr"], image_lr=o["lr"],
            warmup_steps=o["warmup_steps"], t_total=o["t_total"],
            min_lr=o["min_lr"], weight_decay=o["weight_decay"],
            batch_multiply=o["batch_multiply"], adam_eps=o["adam_eps"])
        self.opt = optim.make_fused_optimizer(model, ocfg, None)
        self.model = model
        self.state = tstep.init_state(model, self.opt, seed=seed)
        self.step_fn = tstep.make_train_step_with_fallback(
            self.pcfg, policy=b["label_overflow_policy"],
            dtype=torch.bfloat16)
        self.nsp_weight = torch.tensor(
            [float(b["num_negative_samples"]), 1.0], device=device)
        self.to_device = to_device
        self.device = device

    def step(self, batch: dict, spans):
        with spans("to_device"):
            dev_batch = self.to_device(batch, self.device)
        with spans("step"), torch.enable_grad():
            self.state, metrics = self.step_fn(
                self.state, dev_batch, self.nsp_weight,
                host_mlm_labels=batch["mlm_labels"])
        return metrics["loss"]

    def first_grad_norms(self) -> dict:
        """Each leaf's first gradient as the optimizer took it, from its
        first moment after one update (mu = (1 - b1) g)."""
        n = torch.stack([m.float().norm() for m in self.opt.mu]) / (1 - B1)
        return dict(zip(self.opt.names, n.cpu().numpy().astype(np.float64)))

    def params(self) -> dict:
        return dict(self.model.named_parameters())


def _change_norms(cfg, seed, params: dict, device) -> dict:
    W0 = ref.make_weights(cfg, seed, cfg["bench"]["init_std"], device)
    with torch.no_grad():
        n = torch.stack([(params[k].detach().float() - W0[k]).norm()
                         for k in W0])
    return dict(zip(W0, n.cpu().numpy().astype(np.float64)))


def program_readings(prog, cfg, seed, pool, order, spans, device):
    """The first steps' readings of the program's state: losses, first
    gradient norms, change norms."""
    losses = []
    g1 = None
    for k in range(FIRST_STEPS):
        loss = prog.step(pool[order[k % len(order)]], spans)
        losses.append(float(loss))
        if k == 0:
            g1 = prog.first_grad_norms()
    return {"losses": losses, "g1": g1,
            "change": _change_norms(cfg, seed, prog.params(), device)}


def reference_readings(cfg, seed, pool, order, device, prec, *,
                       block: int = 40, rows_kept=None, world: int = 1):
    """The same readings of the reference, in fp32 (or the control's
    precision), in blocks of ``block`` rows. ``rows_kept``: a fault, only
    these rows of each batch, with their own denominators. ``world``:
    each step's batch split evenly over that many ranks, each with its own
    dropout stream over its own rows."""
    W = {k: v.clone().requires_grad_(True) for k, v in
         ref.make_weights(cfg, seed, cfg["bench"]["init_std"],
                          device).items()}
    opt = ref.AdamW(W, cfg["bench"]["optimizer"])
    nsp_w = [float(cfg["bench"]["num_negative_samples"]), 1.0]
    losses, g1 = [], None
    for k in range(FIRST_STEPS):
        host = pool[order[k % len(order)]]
        b = {n: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for n, v in host.items()}
        B = b["tokens"].shape[0]
        if rows_kept is not None:
            b = {n: v[rows_kept] for n, v in b.items()}
            B = b["tokens"].shape[0]
        norms = ref.world_norms(b)
        for t in W.values():
            t.grad = None
        total = 0.0
        for rank in range(world):
            lo, hi = rank * B // world, (rank + 1) * B // world
            sseed = step_seed(seed, k, rank if world > 1 else None)
            for r0 in range(0, hi - lo, block):
                rows = slice(r0, min(r0 + block, hi - lo))
                loss = ref.train_loss(
                    cfg, W, {n: v[lo + rows.start:lo + rows.stop]
                             for n, v in b.items()}, norms,
                    seed=sseed, batch=hi - lo, rows=rows, prec=prec,
                    nsp_weight=nsp_w)
                loss.backward()
                total += float(loss.detach())
        losses.append(total)
        grads = {n: t.grad for n, t in W.items()}
        if k == 0:
            g1 = {n: (float(g.norm()) if g is not None else 0.0)
                  for n, g in grads.items()}
        opt.step(W, grads)
    change = _change_norms(cfg, seed, W, device)
    return {"losses": losses, "g1": g1, "change": change}


def _leaf_gaps(p: dict, r: dict, names) -> np.ndarray:
    """Per leaf of ``names``: the gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    rn = np.array([r[n] for n in names])
    pn = np.array([p[n] for n in names])
    return np.abs(pn - rn) / np.maximum(rn, float(np.median(rn)))


def _leaves(r: dict) -> dict:
    """The leaves each per-leaf number is taken over: every leaf for the
    gradient; for the change, those whose reference gradient is at least
    ``ZERO_GRAD_SHARE`` of the median leaf's."""
    med = float(np.median(list(r["g1"].values())))
    return {"grad_gap": ("g1", list(r["g1"])),
            "change_gap": ("change", [n for n, g in r["g1"].items()
                                      if g >= ZERO_GRAD_SHARE * med])}


def gaps(p: dict, r: dict) -> dict:
    """The compared numbers. ``loss_gap``: the largest relative gap of a
    step's loss. ``grad_gap`` / ``change_gap``: the worst leaf's
    ``_leaf_gaps`` over ``_leaves``."""
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                           zip(p["losses"], r["losses"]))}
    for number, (key, names) in _leaves(r).items():
        out[number] = float(np.max(_leaf_gaps(p[key], r[key], names)))
    return {k: (float(v) if np.isfinite(v) else float("inf"))
            for k, v in out.items()}


def worst_leaves(p: dict, r: dict, k: int = 3) -> list:
    """The ``k`` leaves that read highest on each per-leaf number, worst
    first: (number, leaf, gap, program's norm, reference's norm)."""
    rows = []
    for number, (key, names) in _leaves(r).items():
        g = _leaf_gaps(p[key], r[key], names)
        for i in np.argsort(-g)[:k]:
            n = names[i]
            rows.append((number, n, float(g[i]), float(p[key][n]),
                         float(r[key][n])))
    return rows


def print_leaves(p: dict, r: dict):
    """The worst leaves on stderr, before the compared numbers."""
    for row in worst_leaves(p, r):
        print("leaf %s %s %.6g program %.6g reference %.6g" % row,
              file=sys.stderr, flush=True)


def run(spec, seed: int, seconds: float, trace: bool, device,
        t_start: float, program=Program):
    """One run of a training cell; returns (result fields, checks)."""
    cfg, mix, srv = spec.config, spec.traffic, spec.serving
    parts = tr.Parts(t_start)
    pool, order = traffic.make(mix, cfg, seed)
    work = [counts.train_batch(cfg, b) for b in pool]
    B = mix["batch"]
    parts.mark("pool")
    prog = program(cfg, seed, device)
    parts.mark("program")
    spans = tr.Spans()
    readings = program_readings(prog, cfg, seed, pool, order, tr.Spans(),
                                device)
    tr.sync(device)
    parts.mark("first steps")
    setup_s = time.perf_counter() - t_start

    def window(secs, k0):
        """Steps for ``secs`` from step index ``k0``: (steps, wall, loss
        tensors)."""
        t0 = time.perf_counter()
        k, losses = k0, []
        while time.perf_counter() - t0 < secs:
            losses.append(prog.step(pool[order[k % len(order)]], spans))
            k += 1
        tr.sync(device)
        return k - k0, time.perf_counter() - t0, losses

    k = FIRST_STEPS
    summary, slice_work = None, None
    losses = []
    if trace:
        prof = tr.Profile(spans, device)
        slice_s = min(srv["trace_slice_s"], seconds / 2)
        prof.start()
        n_slice, _, lt = window(slice_s, k)
        prof.stop()
        slice_work = {key: sum(work[order[(k + i) % len(order)]][key]
                               for i in range(n_slice)) for key in work[0]}
        slice_work["steps"] = n_slice
        k += n_slice
        losses += lt
        summary = prof.summary()
        seconds -= slice_s
    n, wall, lw = window(seconds, k)
    losses += lw
    host_work = {key: sum(work[order[(k + i) % len(order)]][key]
                          for i in range(n)) for key in work[0]}
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    finite = torch.isfinite(torch.stack(losses)).cpu().numpy()
    e2e = {"train_seq_per_s": n * B / wall, "setup_s": setup_s}
    ctx = {"cfg": cfg, "unit": "steps", "trace": summary,
           "slice_work": slice_work,
           "host": {"seconds": wall, "units": n,
                    "spans": dict(spans.durations), **host_work},
           "memory": {"peak_bytes": peak}}

    del prog
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    r = reference_readings(cfg, seed, pool, order, device,
                           ref.Precision("fp32"),
                           block=spec.check["block_rows"])
    g = gaps(readings, r)
    print_leaves(readings, r)
    checks = {name: {"value": g[name], "limit": spec.limits[name]}
              for name in spec.check["numbers"]}
    ok = (bool(finite.all())
          and all(c["value"] <= c["limit"] for c in checks.values()))
    return {"correct": ok, "attempted": len(losses),
            "failed": int((~finite).sum()), "e2e": e2e, "ctx": ctx,
            "peak": peak, "readings": readings, "reference": r}, checks
