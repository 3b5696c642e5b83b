"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints, as the last line of stdout, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; the numbers
compared with the reference, each beside its limit, close both it and
stderr. Exits non-zero without a result when the card or the cards the
cell needs are missing, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from benchmark.harness import result, spec as spec_mod  # noqa: E402


def metrics_of(sp, out: dict, trace: bool) -> dict:
    """The cell's metrics: end-to-end untraced, per-layer traced (a
    reader that finds nothing to read leaves its metric out)."""
    if not trace:
        return {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                for m in sp.end_to_end}
    got = {}
    for m in sp.per_layer:
        v = sp.readers[m["name"]](out["ctx"])
        if v is not None:
            got[m["name"]] = {"value": v, "unit": m["unit"]}
    return got


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sp = spec_mod.load(args.workload)
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < sp.chips:
            print(f"the cell needs {sp.chips} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
    return run_cell(sp, args.seed, args.seconds, bool(args.trace), device)


def run_cell(sp, seed: int, seconds: float, trace: bool, device,
             **loop_kw) -> int:
    """Run the cell's loop and print its result; 3 and no result when this
    process, or a process that ran the program for it, holds JAX or the
    JAX package once the window has closed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    drv = importlib.import_module(f"benchmark.loops.{sp.loop}")
    out, checks = drv.run(sp, seed, seconds, trace, device, T_START,
                          **loop_kw)
    bad = sorted(set(result.loaded_forbidden()).union(out.get("loaded", ())))
    if bad:
        print(f"loaded by the run: {', '.join(bad)}", file=sys.stderr)
        return 3
    result.emit(result_line(sp, out, trace, device), checks)
    return 0


def result_line(sp, out: dict, trace: bool, device) -> dict:
    """The result's fields before ``checks``."""
    dev = result.device_info(device, sp.chips, out["peak"])
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics_of(sp, out, trace),
            "device": dev, "card": result.card()}
    summary = out["ctx"]["trace"]
    if trace and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["slice_s"]
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    return line


if __name__ == "__main__":
    sys.exit(main())
