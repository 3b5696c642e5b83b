"""What the per-layer metric readers share: the chip's peaks and the
arithmetic of shares, spans and device time. A reader returns None when
the run has nothing for it to read (no trace, no span, no launch of its
kernels): the harness then leaves the metric out."""

from __future__ import annotations

import json
from pathlib import Path

_PEAKS = Path(__file__).resolve().parents[1] / "counts" / "peaks.json"


def peaks() -> dict:
    with open(_PEAKS, encoding="utf-8") as f:
        return json.load(f)


def span_mean_ms(ctx, name):
    d = ctx["host"]["spans"].get(name)
    return sum(d) / len(d) * 1e3 if d else None


def idle_pct(ctx):
    t = ctx["trace"]
    if not t or t["slice_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["slice_s"])


def device_ms_per_unit(ctx):
    t, w = ctx["trace"], ctx["slice_work"]
    if not t or not w or not w.get(ctx["unit"]) or t["busy_s"] <= 0:
        return None
    return t["busy_s"] * 1e3 / w[ctx["unit"]]


def mfu_pct(ctx):
    """Counted model operations of the untraced part of the window's
    completed work, over its wall time, over the bf16 peak of the cards
    used."""
    h = ctx["host"]
    if not h["seconds"] or not h.get("model_flops"):
        return None
    return 100.0 * h["model_flops"] / h["seconds"] / (
        peaks()["bf16_flops_per_s"] * ctx.get("chips", 1))


def kernel_time(ctx, names):
    """(seconds, launches) of the traced kernels whose names contain one
    of ``names``."""
    t = ctx["trace"]
    if not t:
        return 0.0, 0
    s, n = 0.0, 0
    for k, (sec, cnt) in t["kernels"].items():
        if any(x in k for x in names):
            s += sec
            n += cnt
    return s, n


def roofline_pct(flops, nbytes, seconds):
    """The least time the chip could take (operations at the bf16 peak or
    bytes at the HBM peak, the larger) as a share of ``seconds``."""
    if not seconds or seconds <= 0:
        return None
    p = peaks()
    bound = max(flops / p["bf16_flops_per_s"], nbytes / p["hbm_bytes_per_s"])
    return 100.0 * bound / seconds


def names_beside(path):
    """The kernel-name list in the data file beside a reader."""
    with open(Path(path).with_suffix(".json"), encoding="utf-8") as f:
        return json.load(f)["kernels"]
