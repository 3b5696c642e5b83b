"""Training cells across the cards of one host: each step's batch split
evenly over ``chips`` processes, one a card, joined by the program's
``parallel/dist.init_world`` at a free localhost port (NCCL on cards,
gloo on the CPU); the program sums the gradients over the world and
normalises every loss by the world's denominators.

Each process builds the same training state from the seed, takes its
rows of every pool batch, and runs ``train_steps``' set-up and window;
rank 0 decides on the host when the traced slice and the window end and
tells the others over a gloo group, so that every rank takes the same
steps without a device sync. The rates, spans and readings are rank 0's
(its loss is the world's, its first moments the summed gradient's); the
trace is read on every rank and averaged. Each rank reports the JAX
modules it holds once the window has closed (``loaded``: the ranks, not
the parent, run the program). Once every rank has ended, the
parent process holds the world's first three steps to the reference,
which takes the whole batch in fp32 with each rank's dropout stream drawn
again.
"""

from __future__ import annotations

import dataclasses
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from benchmark.counts import vilbert as counts
from benchmark.harness import result
from benchmark.harness import trace as tr
from benchmark.harness import traffic
from benchmark.loops import train_steps
from benchmark.reference import vilbert_ref as ref

# the parent's wait for the ranks' results (set-up, window, reference)
RESULT_TIMEOUT_S = 900


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flag(value: int, group) -> int:
    """Rank 0's ``value``, on every rank (a host collective)."""
    t = torch.tensor([value], dtype=torch.int32)
    tdist.broadcast(t, src=0, group=group)
    return int(t[0])


def _rank_run(rank, world, port, spec, seed, seconds, trace, device,
              t_start, program):
    from unimm_torch.parallel import dist as pdist
    cfg, mix, srv = spec.config, spec.traffic, spec.serving
    dev = (torch.device("cuda", rank) if torch.device(device).type == "cuda"
           else torch.device("cpu"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    parts = tr.Parts(t_start) if rank == 0 else None
    pdist.init_world({"coordinator_address": f"127.0.0.1:{port}",
                      "num_processes": world, "process_id": rank,
                      "mesh_mp": 1}, dev)
    host = tdist.new_group(backend="gloo")
    pool, order = traffic.make(mix, cfg, seed)
    B = mix["batch"]
    rows = slice(rank * B // world, (rank + 1) * B // world)
    local = [{k: v[rows] for k, v in b.items()} for b in pool]
    work = [counts.train_batch(cfg, b) for b in local]
    world_flops = [counts.train_batch(cfg, b)["model_flops"] for b in pool]
    if parts:
        parts.mark("pool")
    prog = program(cfg, seed, dev)
    if parts:
        parts.mark("program")
    spans = tr.Spans()
    readings = train_steps.program_readings(prog, cfg, seed, local, order,
                                            tr.Spans(), dev)
    tr.sync(dev)
    tdist.barrier(group=host)
    if parts:
        parts.mark("first steps")
    setup_s = time.perf_counter() - t_start

    def window(secs, k0):
        """Steps from step index ``k0`` until rank 0 has seen ``secs``
        pass: (steps, wall, loss tensors)."""
        t0 = time.perf_counter()
        k, losses = k0, []
        while not _flag(int(time.perf_counter() - t0 >= secs), host):
            losses.append(prog.step(local[order[k % len(order)]], spans))
            k += 1
        tr.sync(dev)
        tdist.barrier(group=host)
        return k - k0, time.perf_counter() - t0, losses

    k = train_steps.FIRST_STEPS
    summary, slice_work, losses = None, None, []
    if trace:
        prof = tr.Profile(spans, dev)
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
    host_work["model_flops"] = sum(world_flops[order[(k + i) % len(order)]]
                                   for i in range(n))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    finite = torch.isfinite(torch.stack(losses)).cpu().numpy()
    gathered = [None] * world
    tdist.all_gather_object(gathered, (summary, peak, int(finite.all()),
                                       result.loaded_forbidden()),
                            group=host)
    if rank != 0:
        return None
    summaries = [g[0] for g in gathered]
    if trace:
        summary = dict(summaries[0])
        summary["busy_s"] = float(np.mean([s["busy_s"] for s in summaries]))
        summary["slice_s"] = float(np.mean([s["slice_s"] for s in summaries]))
        summary["ranks"] = summaries
    peak = max(g[1] for g in gathered)
    ok_ranks = all(g[2] for g in gathered)
    loaded = sorted({m for g in gathered for m in g[3]})
    e2e = {"world_seq_per_s": n * B / wall, "setup_s": setup_s}
    ctx = {"cfg": cfg, "unit": "steps", "trace": summary, "chips": world,
           "slice_work": slice_work,
           "host": {"seconds": wall, "units": n,
                    "spans": dict(spans.durations), **host_work},
           "memory": {"peak_bytes": peak}}
    return {"readings": readings, "losses_finite": bool(finite.all()),
            "ok_ranks": ok_ranks, "loaded": loaded,
            "failed": int((~finite).sum()),
            "attempted": len(losses), "e2e": e2e, "ctx": ctx, "peak": peak}


def _rank(rank, world, port, spec, seed, seconds, trace, device, t_start,
          program, results):
    from unimm_torch.parallel import dist as pdist
    try:
        out = _rank_run(rank, world, port, spec, seed, seconds, trace,
                        device, t_start, program)
        results.put((rank, out, None))
    except BaseException:       # reported to the parent, then re-raised
        results.put((rank, None, traceback.format_exc()))
        raise
    finally:
        pdist.close_world()


def run(spec, seed: int, seconds: float, trace: bool, device,
        t_start: float, program=train_steps.Program):
    """One run of a training cell over ``spec.chips`` processes; returns
    (result fields, checks)."""
    world = spec.chips
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    bare = dataclasses.replace(spec, readers={})
    procs = [ctx.Process(target=_rank, args=(
        r, world, port, bare, seed, seconds, trace, device, t_start,
        program, results)) for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < world:
            r, out, err = results.get(timeout=RESULT_TIMEOUT_S)
            if err is not None:
                raise RuntimeError(f"rank {r} failed:\n{err}")
            got[r] = out
    except queue.Empty:
        raise RuntimeError("a rank gave no result") from None
    finally:
        for p in procs:
            p.join(timeout=60)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    out = got[0]
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    cfg, mix = spec.config, spec.traffic
    pool, order = traffic.make(mix, cfg, seed)
    r = train_steps.reference_readings(
        cfg, seed, pool, order, torch.device(device), ref.Precision("fp32"),
        block=spec.check["block_rows"], world=world)
    g = train_steps.gaps(out["readings"], r)
    train_steps.print_leaves(out["readings"], r)
    checks = {name: {"value": g[name], "limit": spec.limits[name]}
              for name in spec.check["numbers"]}
    ok = (out["losses_finite"] and out["ok_ranks"]
          and all(c["value"] <= c["limit"] for c in checks.values()))
    return {"correct": ok, "attempted": out["attempted"],
            "failed": out["failed"], "e2e": out["e2e"], "ctx": out["ctx"],
            "peak": out["peak"], "readings": out["readings"],
            "reference": r, "loaded": out["loaded"]}, checks
