"""Readings that the limits of a cell's compared numbers are set from, in
one process on the card:

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 4] [--out FILE]

For each of ``--seeds``, one run of the cell with a short window (the
program's readings, the lower end of each limit). For each of
``--control-seeds``, the control: the reference computed in fp8 (the
operands of every product rounded to fp8 with per-tensor scales) put in
the program's place and held to the fp32 reference by the same numbers; for a training cell also
the fault of half the batch left out (the reference on its first half,
the mean over those rows). A state left unchanged reads 1 on the change
by the measure itself. ``--fault NAME`` runs ``--seeds`` on a fault of
``benchmark/loops/faults.py`` planted in the program instead. One JSON line
a reading, on stdout and in ``--out``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from benchmark.harness import spec as spec_mod, traffic  # noqa: E402
from benchmark.loops import (eval_slates, faults, train_steps,  # noqa: E402
                            train_world)
from benchmark.reference import vilbert_ref as ref  # noqa: E402


def _emit(rec, out):
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a", encoding="utf-8") as f:
            f.write(line + "\n")


def control_eval(sp, seed, device):
    cfg, mix, srv = sp.config, sp.traffic, sp.serving
    groups, order = traffic.make(mix, cfg, seed)
    done = [(int(g), None) for g in order]
    gap, n = eval_slates.check(cfg, srv["mode"], seed, device, groups,
                               mix["coalesce"], done, sp.check["slates"],
                               control=ref.Precision("fp8"))
    return {sp.check["number"]: gap, "compared": n}


def control_train(sp, seed, device):
    cfg, mix = sp.config, sp.traffic
    pool, order = traffic.make(mix, cfg, seed)
    kw = {"block": sp.check["block_rows"], "world": sp.chips}
    r32 = train_steps.reference_readings(cfg, seed, pool, order, device,
                                         ref.Precision("fp32"), **kw)
    r8 = train_steps.reference_readings(cfg, seed, pool, order, device,
                                        ref.Precision("fp8"), **kw)
    half = train_steps.reference_readings(
        cfg, seed, pool, order, device, ref.Precision("fp32"),
        rows_kept=slice(0, mix["batch"] // 2), **kw)
    return {"fp8": train_steps.gaps(r8, r32),
            "half_batch": train_steps.gaps(half, r32)}


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--fault", default="", choices=("", *faults.BY_NAME))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sp = spec_mod.load(args.workload)
    drv = {"eval_slates": eval_slates, "train_steps": train_steps,
           "train_world": train_world}[sp.loop]
    kw = {"program": faults.BY_NAME[args.fault]} if args.fault else {}
    for s in filter(None, args.seeds.split(",")):
        seed = int(s)
        t = time.perf_counter()
        out, checks = drv.run(sp, seed, args.seconds, False, device, t, **kw)
        rec = {"cell": sp.name, "kind": args.fault or "program", "seed": seed,
               "correct": out["correct"],
               **{k: c["value"] for k, c in checks.items()},
               "e2e": out["e2e"], "seconds": time.perf_counter() - t}
        if "readings" in out:
            rec["losses"] = out["readings"]["losses"]
            rec["ref_losses"] = out["reference"]["losses"]
        _emit(rec, args.out)
        torch.cuda.empty_cache()
    for s in filter(None, args.control_seeds.split(",")):
        seed = int(s)
        t = time.perf_counter()
        got = (control_eval if sp.loop == "eval_slates"
               else control_train)(sp, seed, device)
        _emit({"cell": sp.name, "kind": "control", "seed": seed, **got,
               "seconds": time.perf_counter() - t}, args.out)
        torch.cuda.empty_cache()
    print(f"card {torch.cuda.get_device_name(0)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
