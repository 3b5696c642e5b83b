"""The program's own spans, read beside the harness's: its ranges in a
profile of the window's slice, its recorder's spans and counters over the
rest of the window, and the per-layer numbers they give.

``unimm_torch/utils/trace.py`` opens a ``torch.profiler.record_function``
range named ``unimm.<span>`` around each of its spans while a profile is
on, and keeps each span's host times, parent and id, and its counters,
while its recorder is on. ``events(prof)`` reads a finished profile;
``attribute(evs)`` reduces it over the harness's ``bench.slice`` range:

* each kernel and copy goes to the innermost program range open on the
  thread that launched it, at its launch. The launch is the CUDA runtime
  call kineto gives the kernel's ``correlation_id``, else the operator it
  links the kernel to (``linked_correlation_id``). A launch on a thread
  with no program range open there (the autograd engine's, outside the
  ranges it opens itself) goes to the innermost range open on the main
  thread (the slice's) at that moment; one outside every program range to
  the innermost harness span, as ``bench.<span>``; the rest is
  ``unattributed``. ``roots`` gives the same time by the outermost
  program range open on the main thread;
* each idle gap (the slice less the union of the device's intervals, as
  ``harness/trace.reduce`` takes it) goes to the innermost program range
  open on the main thread at its middle, else to the innermost harness
  span, else ``outside_spans``.

``METRICS`` maps each per-layer number these give to its reader, which
takes a context holding ``program`` ({"device": ``attribute``'s result,
"host": the recorder's ``snapshot()``}) and ``slice_work``, and returns
None when the run has nothing for it (a program without the spans).
"""

from __future__ import annotations

import bisect
import collections
import re
import sys
from typing import NamedTuple

import torch

PREFIX = "unimm."
HARNESS = "bench."
SLICE = HARNESS + "slice"
UNATTRIBUTED = "unattributed"
_API = re.compile(r"cu(da)?[A-Z]")


class Ev(NamedTuple):
    name: str
    dev: bool          # an activity of the device
    start: float       # us
    end: float
    tid: int
    corr: int
    linked: int
    launch: bool       # a CUDA runtime or driver call on the host


def events(prof) -> list:
    """The events of a finished ``torch.profiler.profile`` as ``Ev``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == torch.autograd.DeviceType.CUDA
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        launch = not dev and ("runtime" in kind or "driver" in kind
                              or bool(_API.match(e.name())))
        s = e.start_ns() / 1e3
        out.append(Ev(e.name(), dev, s, s + e.duration_ns() / 1e3,
                      e.start_thread_id(), e.correlation_id(),
                      e.linked_correlation_id(), launch))
    return out


class _Nest:
    """Properly nested ranges of one thread: the innermost and outermost
    open at a moment."""

    def __init__(self, ranges):
        ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in ranges]
        self.ends = [r[1] for r in ranges]
        self.names = [r[2] for r in ranges]
        self.parent, self.root = [], []
        stack = []
        for i, (s, e, _) in enumerate(ranges):
            while stack and self.ends[stack[-1]] < s:
                stack.pop()
            p = stack[-1] if stack else -1
            self.parent.append(p)
            self.root.append(self.root[p] if p >= 0 else i)
            stack.append(i)

    def inner(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ends[i] < t:
            i = self.parent[i]
        return i

    def name(self, t, outermost=False):
        i = self.inner(t)
        if i < 0:
            return None
        return self.names[self.root[i] if outermost else i]


def attribute(evs, slice_name=SLICE):
    """The slice's device time, launches and idle time by program range
    (see the module docstring): {"device": {range: [seconds, launches]},
    "kernels": {range: {kernel or copy: [seconds, launches]}}, "roots":
    {range: seconds}, "idle": {range: seconds}, "busy_s",
    "slice_s", "ranges" (program ranges in the slice), "found" (launches
    found {"runtime", "linked", "none"})}; None without the slice."""
    host = [e for e in evs if not e.dev]
    sl = [e for e in host if e.name == slice_name]
    if not sl:
        return None
    s0, s1, main = sl[0].start, sl[0].end, sl[0].tid
    host_names = {e.name for e in host}
    by_tid = collections.defaultdict(list)
    harness = []
    n_ranges = 0
    for e in host:
        if e.name.startswith(PREFIX):
            by_tid[e.tid].append((e.start, e.end, e.name[len(PREFIX):]))
            n_ranges += s0 <= e.start <= s1
        elif (e.name.startswith(HARNESS) and e.name != slice_name
              and e.tid == main):
            harness.append((e.start, e.end, e.name))
    nests = {t: _Nest(r) for t, r in by_tid.items()}
    none = _Nest([])
    main_nest = nests.get(main, none)
    harness_nest = _Nest(harness)
    runtime = {e.corr: e for e in host if e.launch and e.corr}
    ops = {e.corr: e for e in host if not e.launch and e.corr}

    device = collections.defaultdict(lambda: [0.0, 0])
    kernels = collections.defaultdict(lambda: collections.defaultdict(
        lambda: [0.0, 0]))
    roots = collections.defaultdict(float)
    found = collections.Counter()
    ivs = []
    for d in evs:
        if not d.dev or d.name in host_names:
            continue
        a, b = max(d.start, s0), min(d.end, s1)
        if b <= a:
            continue
        ivs.append((a, b))
        at = runtime.get(d.corr)
        found["runtime" if at is not None else
              "linked" if d.linked in ops else "none"] += 1
        if at is None:
            at = ops.get(d.linked)
        name = root = None
        if at is not None:
            name = nests.get(at.tid, none).name(at.start)
            root = main_nest.name(at.start, outermost=True)
            if name is None:
                name = main_nest.name(at.start)
            if name is None:
                name = harness_nest.name(at.start)
                root = name
        sec = (b - a) / 1e6
        for k in (device[name or UNATTRIBUTED],
                  kernels[name or UNATTRIBUTED][d.name]):
            k[0] += sec
            k[1] += 1
        roots[root or UNATTRIBUTED] += sec
    ivs.sort()
    merged = []
    for a, b in ivs:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    idle = collections.defaultdict(float)
    edges = [s0] + [x for iv in merged for x in iv] + [s1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        name = (main_nest.name(mid) or harness_nest.name(mid)
                or "outside_spans")
        idle[name] += (b - a) / 1e6
    return {"device": dict(device),
            "kernels": {r: dict(k) for r, k in kernels.items()},
            "roots": dict(roots), "idle": dict(idle),
            "busy_s": sum(b - a for a, b in merged) / 1e6,
            "slice_s": (s1 - s0) / 1e6, "ranges": n_ranges,
            "found": dict(found)}


def root_share(att, names):
    """The share of the slice's device time under the root ranges
    ``names`` (%)."""
    total = sum(att["roots"].values())
    if not total:
        return None
    return 100.0 * sum(att["roots"].get(n, 0.0) for n in names) / total


# --- the per-layer numbers ---------------------------------------------------

def _host(ctx):
    p = ctx.get("program")
    return p.get("host") if p else None


def _device(ctx):
    p = ctx.get("program")
    att = p.get("device") if p else None
    return att if att and att["ranges"] else None


def _per_root(ctx, names, root, key="dur"):
    """ms a root span (``root``) of the spans ``names``, summed on
    ``key`` (``dur`` or ``self``)."""
    h = _host(ctx)
    if not h or not h["spans"].get(root):
        return None
    sp = h["spans"]
    total = sum(sum(sp[n][key]) for n in names if n in sp)
    return total * 1e3 / len(sp[root]["dur"])


def _idle_pct(ctx, names, unit="dialogs"):
    att, w = _device(ctx), ctx.get("slice_work")
    if not att or not w or not w.get(unit) or att["slice_s"] <= 0:
        return None
    return 100.0 * sum(att["idle"].get(n, 0.0) for n in names) / \
        att["slice_s"]


def _device_ms(ctx, names, unit):
    att, w = _device(ctx), ctx.get("slice_work")
    if not att or not w or not w.get(unit):
        return None
    got = [att["device"][n] for n in names if n in att["device"]]
    if not any(launches for _, launches in got):
        return None
    return sum(s for s, _ in got) * 1e3 / w[unit]


def useful_rows_pct(ctx):
    h = _host(ctx)
    if not h:
        return None
    c = h["counts"]
    need = sum(v for k, v in c.items()
               if k.startswith("eval.rows_needed."))
    launched = sum(v for k, v in c.items()
                   if k.startswith("eval.rows_launched."))
    return 100.0 * need / launched if launched else None


METRICS = {
    # host ms a dispatch in the copies to the device
    "h2d_ms.eval": lambda c: _per_root(c, ["eval.h2d"], "eval.dispatch"),
    # host ms a dispatch of planning and packing, their own time
    "pack_ms.eval": lambda c: _per_root(c, ["eval.plan", "eval.pack"],
                                        "eval.dispatch", key="self"),
    # the slice's idle time under the copies, and under the packing (%)
    "idle_h2d_share.eval": lambda c: _idle_pct(c, ["eval.h2d"]),
    "idle_pack_share.eval": lambda c: _idle_pct(c, ["eval.plan",
                                                    "eval.pack"]),
    # rows the scorers needed over the rows they launched (%)
    "useful_rows.eval": useful_rows_pct,
    # device ms a dialog under K2's launches, and under K1's and B4's
    "ffn_ms_per_dialog.eval": lambda c: _device_ms(
        c, ["op.ffn_block"], "dialogs"),
    "attn_block_ms_per_dialog.eval": lambda c: _device_ms(
        c, ["op.answer_block", "op.attention_block"], "dialogs"),
    # device ms a step of the MLM cross-entropy, forward and backward
    "xent_ms_per_step.train": lambda c: _device_ms(
        c, ["train.mlm_xent", "train.mlm_xent.bwd"], "steps"),
    # host ms a step in the label-budget vote
    "vote_host_ms.world": lambda c: _per_root(c, ["train.vote"],
                                              "train.step"),
}


def read_all(ctx) -> dict:
    """Every number of ``METRICS`` the run has."""
    got = {name: fn(ctx) for name, fn in METRICS.items()}
    return {k: v for k, v in got.items() if v is not None}


# --- the tables --------------------------------------------------------------

_DTYPE = re.compile(r"lambda\((c10::\w+|float|double|long|int|bool)\)")


def _short(kernel: str, width: int = 100) -> str:
    """A kernel's name cut to ``width``, namespaces dropped, with the
    element type of an elementwise lambda kept."""
    s = kernel.replace("(anonymous namespace)::", "").replace(
        "at::native::", "")
    m = _DTYPE.search(s)
    return s[:width] + (f" [{m.group(1)}]" if m else "")

def tables(att, snap, roots, top=25, kernels=6, file=None):
    """The attribution tables on ``file`` (stderr): device ms by range,
    each with its ``kernels`` largest kernels and copies, the share of the
    root ranges ``roots`` and the unattributed rest, idle
    by range, and the recorder's host time by span (ms of each and of its
    self time, over the number of spans of ``roots[0]``)."""
    file = file or sys.stderr

    def out(line):
        print(line, file=file, flush=True)

    if att:
        busy = att["busy_s"] or 1.0
        out(f"program device by range (slice {att['slice_s']:.3f} s, busy "
            f"{att['busy_s']:.3f} s, launches found {att['found']})")
        rows = sorted(att["device"].items(), key=lambda kv: -kv[1][0])
        for name, (sec, n) in rows[:top]:
            out(f"  {name:<32} {sec * 1e3:10.1f} ms {n:8d} "
                f"{100 * sec / busy:6.2f}%")
            ks = sorted(att["kernels"][name].items(),
                        key=lambda kv: -kv[1][0])
            for kname, (ksec, kn) in ks[:kernels]:
                out(f"      {ksec * 1e3:10.1f} ms {kn:8d}  {_short(kname)}")
        out("program device by root range:")
        for name, sec in sorted(att["roots"].items(), key=lambda kv: -kv[1]):
            out(f"  {name:<32} {sec * 1e3:10.1f} ms {100 * sec / busy:6.2f}%")
        out(f"  root ranges {', '.join(roots)}: "
            f"{root_share(att, roots)}%; unattributed "
            f"{att['roots'].get(UNATTRIBUTED, 0.0) * 1e3:.1f} ms")
        out("program idle by range:")
        for name, sec in sorted(att["idle"].items(), key=lambda kv: -kv[1]):
            out(f"  {name:<32} {sec * 1e3:10.1f} ms "
                f"{100 * sec / att['slice_s']:6.2f}% of the slice")
    if snap and snap["spans"]:
        sp = snap["spans"]
        n_roots = len(sp[roots[0]]["dur"]) if roots[0] in sp else 1
        out(f"program host time by span (rest of the window, ms a "
            f"{roots[0]} over {n_roots}):")
        for name, d in sorted(sp.items(), key=lambda kv: -sum(kv[1]["dur"])):
            out(f"  {name:<32} {sum(d['dur']) * 1e3 / n_roots:9.3f} ms, self "
                f"{sum(d['self']) * 1e3 / n_roots:9.3f} ms, {len(d['dur'])} "
                f"spans")
        for name, v in sorted(snap["counts"].items()):
            out(f"  counter {name} {v}")
