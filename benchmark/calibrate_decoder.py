"""Readings that the limits of a decoder cell's compared numbers are set
from, in one process on the card:

    python3 -m benchmark.calibrate_decoder --workload gen-visdial-kimivl \
        --seeds 1,2,... [--control-seeds 7,8,9] [--fault-seeds 5,6] \
        [--groups 2] [--out FILE]

For each seed the cell's program (its seeded weights, its evaluator)
scores ``--groups`` dispatches of the cell's pool, is freed, and the
cell's check runs on them (``eval_slates_decoder.check``: ll_gap with the
program's routes, route_gap, the share of flipped choices): the program's
readings. For each of ``--control-seeds`` the same, then the check with
the reference computed in fp8 (the operands of every product rounded to
fp8 with per-tensor scales) in the program's place. For each of
``--fault-seeds`` the check on each planted fault (``FAULTS``). One JSON
line a reading, on stdout and in ``--out``.
"""

import argparse
import json
import sys

import numpy as np
import torch

from benchmark.harness import spec as spec_mod
from benchmark.loops import eval_slates, eval_slates_decoder as loop
from benchmark.reference import deepseek_v3_ref as ref


class BiasLeftOut(loop.Program):
    """The router's correction bias left out of the choice."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        for lay in self.model.layers:
            if "e_score_correction_bias" in lay:
                lay["e_score_correction_bias"].zero_()


class ExpertsRolled(loop.Program):
    """Every routed expert's rows run under the next expert's weights (a
    grouped product whose walk is one group off)."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        for lay in self.model.layers:
            if "gate_weight" in lay:
                for key in ("w13", "w2"):
                    lay[key].copy_(lay[key].roll(1, 0))


FAULTS = {"bias_left_out": BiasLeftOut, "experts_rolled": ExpertsRolled}


def readings(sp, seed, groups, device, program=loop.Program, control=None):
    cfg, mix, srv = sp.config, sp.traffic, sp.serving
    pool, order = loop.make_pool(mix, cfg, seed)
    c = mix["coalesce"]
    prog = program(cfg, srv, seed, device)
    done = []
    for g in order[:groups]:
        fin = prog.dispatch(eval_slates.merge(pool[g * c:(g + 1) * c]))
        done.append((int(g), {k: np.asarray(v) for k, v in fin().items()}))
    logs = prog.logs
    del prog
    torch.cuda.empty_cache()
    return loop.check(cfg, seed, device, pool, c, done, logs,
                      sp.check["slates"], sp.check["options"],
                      control=control)


def _emit(rec, out):
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a", encoding="utf-8") as f:
            f.write(line + "\n")


def _ints(s):
    return [int(x) for x in s.split(",") if x]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="gen-visdial-kimivl")
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sp = spec_mod.load(args.workload)
    for seed in args.seeds:
        _emit({"kind": "program", "seed": seed,
               **readings(sp, seed, args.groups, dev)}, args.out)
    for seed in args.control_seeds:
        _emit({"kind": "fp8", "seed": seed,
               **readings(sp, seed, args.groups, dev,
                          control=ref.Precision("fp8"))}, args.out)
    for seed in args.fault_seeds:
        for name, cls in FAULTS.items():
            _emit({"kind": name, "seed": seed,
                   **readings(sp, seed, args.groups, dev, program=cls)},
                  args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
