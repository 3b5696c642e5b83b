"""Spans and counters inside the program.

``span(name)`` marks a stretch of host work (``with trace.span("eval.h2d"):``)
and ``count(name, n)`` adds to a counter. Both cost one check of two
switches when neither is on:

* a ``torch.profiler`` session (``-profile_dir``, or any other): the span
  is a ``record_function`` range named ``unimm.<name>``, so it lands on
  the profiler's clock beside the kernels and copies it launched;
* the recorder (``enable()`` / ``disable()``): the span's start and end on
  ``time.perf_counter``, its parent (the innermost span open on its
  thread; on a thread with none open, such as the autograd engine's, the
  innermost open on the thread that called ``enable()``) and its id (given to a root span,
  else inherited from the parent: the dispatch or step it belongs to) are
  kept in memory, and the counters count. ``snapshot()`` returns them.

Counters count only while the recorder is on; a caller whose count takes
work (a numpy sum) asks ``recording()`` first. ``count_device(name, t)``
adds a device scalar without waiting for the device: the recorder keeps the
tensor and ``snapshot()`` reads it.

``capture()`` opens a block in which ``keep(name, x)`` appends ``x`` (a
tensor as it is, on its device, or any host value) to the list of
``name`` in the dict the block yields; outside one, ``keep`` does nothing
and ``capturing()`` is False, so a caller whose value takes work to build
asks it first. A test or a check reads the program's intermediate values
this way (the experts the MoE layers chose, ``moe.route``).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch

PREFIX = "unimm."

_profiler_enabled = torch.autograd._profiler_enabled
_NOOP = contextlib.nullcontext()


class _Recorder:
    def __init__(self):
        self.on = False
        self.owner = None           # the thread that called enable()
        self.reset()

    def reset(self):
        # each span: [name, start, end, parent span or None, id]
        self.spans = []
        self.counts = collections.Counter()
        self.pending = []           # (name, device scalar) not yet read
        self.open = {}              # thread ident -> stack of open spans
        self.ids = itertools.count()


_rec = _Recorder()


def enable():
    """Turn the recorder on (what it holds is kept: ``reset()`` clears)."""
    _rec.owner = threading.get_ident()
    _rec.on = True


def disable():
    _rec.on = False


def reset():
    """Drop every recorded span and counter."""
    _rec.reset()


def recording() -> bool:
    return _rec.on


def count(name: str, n=1):
    """Add ``n`` to counter ``name`` while the recorder is on."""
    if _rec.on:
        _rec.counts[name] += int(n)


def count_device(name: str, t):
    """Add the device scalar ``t`` to counter ``name`` while the recorder
    is on; read when the counts are taken (``snapshot``)."""
    if _rec.on:
        _rec.pending.append((name, t.detach()))


_kept = None        # the open capture's dict, or None


def capturing() -> bool:
    return _kept is not None


def keep(name: str, x):
    """Append ``x`` to ``name``'s list while a capture is open."""
    if _kept is not None:
        _kept.setdefault(name, []).append(x)


@contextlib.contextmanager
def capture():
    """A block inside which ``keep`` keeps: yields the dict it fills, each
    name's values in the order they were kept (an outer capture sees
    nothing of the block's)."""
    global _kept
    outer, _kept = _kept, {}
    try:
        yield _kept
    finally:
        _kept = outer


def span(name: str, id=None):
    """A context manager around the host work of ``name``; ``as`` gives
    the span's id while the recorder is on (a root span without an ``id``
    takes a fresh one), else None."""
    if not _rec.on and not _profiler_enabled():
        return _NOOP
    return _Span(name, id)


class _Span:
    __slots__ = ("name", "id", "rf", "rec", "stack")

    def __init__(self, name, id):
        self.name = name
        self.id = id
        self.rf = None
        self.rec = None

    def __enter__(self):
        if _profiler_enabled():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        if _rec.on:
            tid = threading.get_ident()
            stack = _rec.open.setdefault(tid, [])
            parent = stack[-1] if stack else _owner_open()
            sid = self.id
            if sid is None:
                sid = parent[4] if parent is not None else next(_rec.ids)
            self.rec = [self.name, time.perf_counter(), None, parent, sid]
            stack.append(self.rec)
            self.stack = stack
            return sid
        return None

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec[2] = time.perf_counter()
            self.stack.pop()
            _rec.spans.append(self.rec)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def _owner_open():
    stack = _rec.open.get(_rec.owner)
    return stack[-1] if stack else None


def snapshot() -> dict:
    """What the recorder holds: ``spans`` by name, each a dict of lists in
    the order the spans closed (``start`` and ``end`` in perf_counter
    seconds, ``dur`` and ``self``, the duration less its children's, in
    seconds, the parent's name or None, the id), and ``counts``."""
    if _rec.pending:
        for name, v in zip([n for n, _ in _rec.pending],
                           torch.stack([t.reshape(()).long()
                                        for _, t in _rec.pending]).tolist()):
            _rec.counts[name] += int(v)
        _rec.pending = []
    children = collections.defaultdict(float)
    for s in _rec.spans:
        if s[3] is not None:
            children[id(s[3])] += s[2] - s[1]
    out = {}
    for s in _rec.spans:
        d = out.setdefault(s[0], {"start": [], "end": [], "dur": [],
                                  "self": [], "parent": [], "id": []})
        dur = s[2] - s[1]
        d["start"].append(s[1])
        d["end"].append(s[2])
        d["dur"].append(dur)
        d["self"].append(dur - children.get(id(s), 0.0))
        d["parent"].append(s[3][0] if s[3] is not None else None)
        d["id"].append(s[4])
    return {"spans": out, "counts": dict(_rec.counts)}
