"""Host spans of the harness and the reading of the device trace.

``Spans`` times the harness's calls into each layer of the program on the
host clock; while a profile is on, each span is also a
``torch.profiler.record_function`` range, so the trace can name what the
host was doing in each idle gap of the device. ``Profile`` traces a slice
of the window with ``torch.profiler`` (CUPTI) and reduces it to the
device time of each kernel name, its launch count, the device's busy time
(the union of its activity intervals) and the idle gaps by open span.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import sys
import time

import torch

PREFIX = "bench."


class Spans:
    """Durations (s) of the harness's host spans by name, recorded while
    no profile is on (so host-clock metrics carry no tracing cost)."""

    def __init__(self):
        self.durations = collections.defaultdict(list)
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.profiling:
            with torch.profiler.record_function(PREFIX + name):
                yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.durations[name].append(time.perf_counter() - t0)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Parts:
    """The set-up's parts on stderr: seconds since the process started
    (imports, torch and CUDA) and since the previous mark."""

    def __init__(self, t_start: float):
        self.t = t_start
        self.mark("start")

    def mark(self, name: str):
        now = time.perf_counter()
        print(f"setup part {name} {now - self.t:.3f} s", file=sys.stderr,
              flush=True)
        self.t = now


def _events(prof):
    """(device intervals [(start_us, end_us, name)], host spans [(start,
    end, name)]) of a finished profile. A range the host opened (the
    harness's, a collective's ``nccl:*``) is also recorded on the device
    under its own name; such copies are not device work and are left
    out."""
    events = [(e.name(), e.device_type() == torch.autograd.DeviceType.CUDA,
               e.start_ns() / 1e3, e.duration_ns() / 1e3)
              for e in prof.profiler.kineto_results.events()]
    host_names = {name for name, on_dev, _, _ in events if not on_dev}
    dev, host = [], []
    for name, on_dev, s, d in events:
        if on_dev:
            if name not in host_names:
                dev.append((s, s + d, name))
        elif name.startswith(PREFIX):
            host.append((s, s + d, name[len(PREFIX):]))
    return dev, host


def reduce(dev, host, slice_name="slice", top=10):
    """The trace's summary over the host span ``slice_name``: kernels
    {name: [seconds, launches]}, busy_s, slice_s, device_ops and
    idle_gaps (the ``top`` largest, [name, seconds])."""
    sl = [h for h in host if h[2] == slice_name]
    if not sl:
        return None
    s0, s1 = sl[0][0], sl[0][1]
    kernels = collections.defaultdict(lambda: [0.0, 0])
    ivs = []
    for a, b, name in dev:
        a, b = max(a, s0), min(b, s1)
        if b <= a:
            continue
        k = kernels[name]
        k[0] += (b - a) / 1e6
        k[1] += 1
        ivs.append((a, b))
    ivs.sort()
    merged = []
    for a, b in ivs:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) / 1e6
    # idle gaps, each named by the innermost harness span open at its
    # middle
    spans = sorted((h for h in host if h[2] != slice_name),
                   key=lambda h: h[0])
    starts = [h[0] for h in spans]
    gaps = collections.defaultdict(float)
    edges = [s0] + [x for iv in merged for x in iv] + [s1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        name = "outside_spans"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if spans[i][1] >= mid:
                name = spans[i][2]
                break
        gaps[name] += (b - a) / 1e6
    by_time = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {
        "kernels": {k: v for k, v in kernels.items()},
        "busy_s": busy, "slice_s": (s1 - s0) / 1e6,
        "device_ops": [[k, v[0]] for k, v in by_time[:top]],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:top],
    }


class Profile:
    """A profile of one slice of the window: ``start()`` (with the device
    idle), ``stop()`` (after the slice's work is complete) and
    ``summary()``."""

    def __init__(self, spans: Spans, device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.spans = spans
        self._range = None

    def start(self):
        self.prof.start()
        self.spans.profiling = True
        self._range = torch.profiler.record_function(PREFIX + "slice")
        self._range.__enter__()

    def stop(self):
        self._range.__exit__(None, None, None)
        self.spans.profiling = False
        self.prof.stop()

    def summary(self):
        dev, host = _events(self.prof)
        return reduce(dev, host)
