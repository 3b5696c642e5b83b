"""One cell seen through the program's own spans
(``unimm_torch/utils/trace.py``): where the slice's device time and idle
time go by program range, and where the host time of the rest of the
window goes by span.

    python3 -m benchmark.program_view --workload <cell> --seed <n> \
        --seconds <s>

from the root of a checkout. The set-up is the cell's loop's (the same
pool, program and warm-up); then the first ``trace_slice_s`` of the
window are profiled as a ``--trace 1`` run profiles them (the program's
``unimm.*`` ranges on, its recorder off), and the rest of the window runs
with the recorder on and no profile. The attribution tables go to stderr
(``harness/program.tables``); the last line of stdout is one JSON object:
the cell, the card, the program's per-layer numbers
(``harness/program.METRICS``), the slice's numbers as the harness reads
them beside the share of device time under the program's root ranges, and
the rest's spans. A cell of several cards runs one process a card, as its
loop does, and reports each rank's slice; its host numbers are rank 0's.

It is not a run of the benchmark: nothing is held to the reference and no
``correct`` is given.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import queue  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as tdist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from benchmark.harness import program as pg  # noqa: E402
from benchmark.harness import readers, result  # noqa: E402
from benchmark.harness import spec as spec_mod  # noqa: E402
from benchmark.harness import trace as tr  # noqa: E402
from benchmark.harness import traffic  # noqa: E402
from benchmark.loops import eval_slates, train_steps, train_world  # noqa

ROOTS = {"eval_slates": ("eval.dispatch", "eval.fetch"),
         "train_steps": ("train.step", "train.h2d"),
         "train_world": ("train.step", "train.h2d")}


def _traced(prof_device, spans, work):
    """Run ``work(seconds)`` over a profiled slice, then over the rest
    with the recorder on: (slice summary, attribution, snapshot, slice
    result, rest result)."""
    from unimm_torch.utils import trace
    prof = tr.Profile(spans, prof_device)
    prof.start()
    got_slice = work("slice")
    prof.stop()
    summary = prof.summary()
    att = pg.attribute(pg.events(prof.prof))
    trace.reset()
    trace.enable()
    try:
        got_rest = work("rest")
    finally:
        trace.disable()
    return summary, att, trace.snapshot(), got_slice, got_rest


def _eval(sp, seed, seconds, device):
    cfg, mix, srv = sp.config, sp.traffic, sp.serving
    groups, order = traffic.make(mix, cfg, seed)
    c, depth = mix["coalesce"], srv["pipeline_depth"]
    dialogs = mix["loader_batch"] * c
    prog = eval_slates.Program(cfg, srv, seed, device)
    eval_slates.serve(prog, groups, order, c, depth, tr.Spans(), laps=1)
    tr.sync(device)
    spans = tr.Spans()
    slice_s = min(srv["trace_slice_s"], seconds / 2)

    def work(part):
        done = []
        secs = slice_s if part == "slice" else seconds - slice_s
        wall = eval_slates.serve(prog, groups, order, c, depth, spans,
                                 seconds=secs,
                                 on_done=lambda *a: done.append(a[0]))
        tr.sync(device)
        return len(done) * dialogs, wall

    summary, att, snap, (d_slice, _), (d_rest, wall) = _traced(
        device, spans, work)
    return ({"dialogs": d_slice}, summary, att, snap, spans,
            {"dialogs_per_s": d_rest / wall})


def _steps(prog, local, order, spans, dev, secs, k0, stop):
    """Steps from index ``k0`` until ``stop(elapsed)``: (steps, wall)."""
    t0 = time.perf_counter()
    k = k0
    while not stop(time.perf_counter() - t0, secs):
        prog.step(local[order[k % len(order)]], spans)
        k += 1
    tr.sync(dev)
    return k - k0, time.perf_counter() - t0


def _train(sp, seed, seconds, device, pool=None, stop=None, barrier=None):
    cfg, mix, srv = sp.config, sp.traffic, sp.serving
    if pool is None:
        pool, order = traffic.make(mix, cfg, seed)
    else:
        pool, order = pool
    stop = stop or (lambda elapsed, secs: elapsed >= secs)
    prog = train_steps.Program(cfg, seed, device)
    for k in range(train_steps.FIRST_STEPS):
        prog.step(pool[order[k % len(order)]], tr.Spans())
    tr.sync(device)
    if barrier:
        barrier()
    spans = tr.Spans()
    slice_s = min(srv["trace_slice_s"], seconds / 2)
    k = [train_steps.FIRST_STEPS]

    def work(part):
        secs = slice_s if part == "slice" else seconds - slice_s
        n, wall = _steps(prog, pool, order, spans, device, secs, k[0], stop)
        if barrier:
            barrier()
        k[0] += n
        return n, wall

    summary, att, snap, (n_slice, _), (n_rest, wall) = _traced(
        device, spans, work)
    B = len(pool[0]["tokens"])
    return ({"steps": n_slice}, summary, att, snap, spans,
            {"seq_per_s": n_rest * B / wall})


def _world_rank(rank, world, port, sp, seed, seconds, device, results):
    from unimm_torch.parallel import dist as pdist
    try:
        dev = (torch.device("cuda", rank)
               if torch.device(device).type == "cuda"
               else torch.device("cpu"))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.type == "cpu":
            torch.set_num_threads(max(1, torch.get_num_threads() // world))
        pdist.init_world({"coordinator_address": f"127.0.0.1:{port}",
                          "num_processes": world, "process_id": rank,
                          "mesh_mp": 1}, dev)
        host = tdist.new_group(backend="gloo")
        pool, order = traffic.make(sp.traffic, sp.config, seed)
        B = sp.traffic["batch"]
        rows = slice(rank * B // world, (rank + 1) * B // world)
        local = [{k: v[rows] for k, v in b.items()} for b in pool]

        def stop(elapsed, secs):
            # rank 0 decides on the host, as the cell's loop does
            return train_world._flag(int(elapsed >= secs), host)

        out = _train(sp, seed, seconds, dev, pool=(local, order), stop=stop,
                     barrier=lambda: tdist.barrier(group=host))
        gathered = [None] * world
        tdist.all_gather_object(gathered, out[:4] + (
            dict(out[4].durations), out[5]), group=host)
        results.put((rank, gathered if rank == 0 else None, None))
    except BaseException:       # reported to the parent, then re-raised
        results.put((rank, None, traceback.format_exc()))
        raise
    finally:
        pdist.close_world()


def _world(sp, seed, seconds, device):
    world = sp.chips
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = train_world._free_port()
    bare = dataclasses.replace(sp, readers={})
    procs = [ctx.Process(target=_world_rank, args=(
        r, world, port, bare, seed, seconds, device, results))
        for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < world:
            r, out, err = results.get(timeout=train_world.RESULT_TIMEOUT_S)
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
    ranks = got[0]
    work, summary, att, snap, spans, rate = ranks[0]
    host = tr.Spans()
    host.durations.update(spans)
    rate = {"world_seq_per_s": rate["seq_per_s"] * world}
    return work, summary, att, snap, host, rate, ranks


def run(sp, seed, seconds, device):
    """The view of one cell; returns the result line's fields."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ranks = None
    if sp.loop == "eval_slates":
        work, summary, att, snap, spans, rate = _eval(sp, seed, seconds,
                                                      device)
    elif sp.loop == "train_steps":
        work, summary, att, snap, spans, rate = _train(sp, seed, seconds,
                                                       device)
    else:
        work, summary, att, snap, spans, rate, ranks = _world(
            sp, seed, seconds, device)
    roots = ROOTS[sp.loop]
    pg.tables(att, snap, roots)
    unit = next(iter(work))
    ctx = {"trace": summary, "slice_work": work, "unit": unit,
           "program": {"device": att, "host": snap}}
    line = {"cell": sp.name, "seed": seed, "card": result.card(),
            "metrics": pg.read_all(ctx),
            "slice": {"idle_share": readers.idle_pct(ctx),
                      f"device_ms_per_{unit[:-1]}":
                          readers.device_ms_per_unit(ctx),
                      "root_share": pg.root_share(att, roots) if att else None,
                      "unattributed_ms": (att["roots"].get(pg.UNATTRIBUTED,
                                                           0.0) * 1e3
                                          if att else None),
                      "found": att["found"] if att else None,
                      "idle_by_range_ms": ({k: v * 1e3 for k, v in
                                            att["idle"].items()}
                                           if att else None)},
            "rest": {"spans_ms": {k: float(np.mean(v)) * 1e3 for k, v in
                                  spans.durations.items() if v},
                     **rate}}
    if ranks:
        line["ranks"] = [{
            "idle_share": readers.idle_pct({"trace": r[1]}),
            "root_share": pg.root_share(r[2], roots) if r[2] else None,
            "idle_by_range_ms": {k: v * 1e3 for k, v in r[2]["idle"].items()},
            "step_spans_ms": {
                k: sum(d["dur"]) * 1e3 / max(1, len(r[3]["spans"].get(
                    "train.step", {"dur": []})["dur"]))
                for k, d in r[3]["spans"].items()}} for r in ranks]
    return line


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sp = spec_mod.load(args.workload)
    if torch.device(device).type == "cuda" and (
            torch.cuda.device_count() < sp.chips):
        print(f"the cell needs {sp.chips} cards", file=sys.stderr)
        return 2
    line = run(sp, args.seed, args.seconds, device)
    line["setup_to_end_s"] = time.perf_counter() - T_START
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
