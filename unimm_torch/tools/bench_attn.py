"""Isolated A/B benchmark of the text self-attention core variants.

    python3 -m unimm_torch.tools.bench_attn [variant ...] [--iters N]
        [--shape B,H,L,D] [--device cuda|cpu]

The port of scripts/bench_attn.py, at its shape [B=512, H=12, L=256, D=64]
bf16 by default. Variants:

* ``xla``: plain PyTorch (``vilbert.attention_core``) over the
  materialised [B, 1, L, L] additive bias (``masks.text_self_bias``);
* ``pallas_v1``: the per-head kernel (``ops/text_attention.py``);
* ``pallas_v2_bb1`` / ``_bb4`` / ``_bb8``: ``ops/attention_v2.py`` with
  block_b 1, 4 and 8.

Protocol (scripts/bench_attn.py's): a measurement is ITERS calls, each
fed the previous call's output as its query, so no call repeats its
inputs; there are 3 input sets (seeds 0-2: normal q, k, v; descriptors of
mode 0 or 1, ctx_end 60-199 and ans_len 2-8, scaled into L below 256),
one warm-up measurement on each, then 6 measurements cycling through the
sets. It prints each variant's median ms per call with the fastest and
slowest measurement. On the card a measurement is timed with CUDA events;
``--device cpu`` runs the plain twins as a smoke test of the tool, timed
by the host clock, which says nothing of a device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from unimm_torch.models import vilbert
from unimm_torch.ops import masks
from unimm_torch.ops.attention_v2 import attention_v2
from unimm_torch.ops.text_attention import text_attention_fwd

SHAPE = (512, 12, 256, 64)
ITERS = 20
SETS, REPS = 3, 6


def normal(rng, shape, dev):
    """A bf16 tensor on ``dev`` from a standard normal draw of ``rng``."""
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        dev, torch.bfloat16)


def make_desc(rng, B, L, dev):
    """The benches' int32 [B, 3] descriptors: mode 0 or 1, ctx_end 60-199
    and ans_len 2-8, scaled into L below 256."""
    mode = rng.integers(0, 2, B)
    ctx_end = rng.integers(60, 200, B) * L // 256
    ans_len = rng.integers(2, 9, B)
    desc = np.stack([mode, np.maximum(ctx_end, ans_len + 2), ans_len], -1)
    return torch.from_numpy(desc.astype(np.int32)).to(dev)


def make_inputs(seed, shape, dev):
    """(q, k, v, desc) on ``dev``: bf16 [B, H, L, D] from a normal draw and
    the int32 [B, 3] descriptors."""
    B, H, L, D = shape
    rng = np.random.default_rng(seed)
    q, k, v = (normal(rng, shape, dev) for _ in range(3))
    return q, k, v, make_desc(rng, B, L, dev)


def xla_attn(q, k, v, desc):
    bias = masks.text_self_bias(desc[:, 0], desc[:, 1], desc[:, 2],
                                q.shape[-2])
    return vilbert.attention_core(q, k, v, bias)


def _v2(block_b):
    def run(q, k, v, desc):
        return attention_v2(q, k, v, desc, block_b=block_b)
    return run


VARIANTS = {"xla": xla_attn, "pallas_v1": text_attention_fwd,
            **{f"pallas_v2_bb{b}": _v2(b) for b in (1, 4, 8)}}


def bench(fn, sets, iters, dev):
    """Median, fastest and slowest ms per call of ``fn`` by the protocol
    above: each call takes the previous call's output in place of the
    first tensor of its input set."""
    def measure(first, *rest):
        out = first
        for _ in range(iters):
            out = fn(out, *rest)
        return out

    cuda = dev.type == "cuda"
    for s in sets:
        measure(*s)
    times = []
    for rep in range(REPS):
        s = sets[rep % len(sets)]
        if cuda:
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            measure(*s)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            measure(*s)
            times.append((time.perf_counter() - t0) * 1e3 / iters)
    return statistics.median(times), min(times), max(times)


def run(names, *, iters=ITERS, shape=SHAPE, dev=None):
    """{variant: (median, min, max) ms per call} for ``names``."""
    dev = dev or torch.device("cuda", 0)
    sets = [make_inputs(s, shape, dev) for s in range(SETS)]
    with torch.no_grad():
        return {n: bench(VARIANTS[n], sets, iters, dev) for n in names}


def device_and_card(name):
    """The device a bench runs on (card 0 unless ``name`` is "cpu"; raises
    without a card) and the line that names it: the card's name and power
    limit from nvidia-smi, or the CPU's host clock. TF32 is off."""
    dev = vilbert.resolve_device(name)
    if dev.type == "cpu":
        return dev, "cpu (host clock)"
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return torch.device("cuda", 0), card


def cli(argv, *, key, variants, run_fn, shape, shape_help):
    """The benches' command line (``[variant ...] [--iters N] [--shape ...]
    [--device cuda|cpu]``): run the variants, print each one's line, then
    one JSON line of the medians under ``key``; return {variant: (median,
    min, max)}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*",
                    help=f"any of {', '.join(variants)} (default: all)")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--shape", default=",".join(map(str, shape)),
                    help=shape_help)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    shape = tuple(int(x) for x in args.shape.split(","))
    dev, card = device_and_card(args.device)
    unknown = sorted(set(args.variants) - set(variants))
    if unknown:
        ap.error(f"unknown variants {unknown}")
    names = args.variants or list(variants)
    print(f"device={card} shape={list(shape)} iters={args.iters}",
          flush=True)
    res = run_fn(names, iters=args.iters, shape=shape, dev=dev)
    for name, (med, lo, hi) in res.items():
        print(f"{name:24s} {med:8.3f} ms/call   ({lo:.3f} min, {hi:.3f} "
              f"max)", flush=True)
    print(json.dumps({key: {n: r[0] for n, r in res.items()},
                      "shape": list(shape), "iters": args.iters,
                      "device": card}), flush=True)
    return res


def main(argv=None):
    return cli(argv, key="bench_attn", variants=VARIANTS, run_fn=run,
               shape=SHAPE, shape_help="B,H,L,D")


if __name__ == "__main__":
    main()
