"""Metrics logging: stdout lines + CSV files.

The port's copy of the JAX package's ``utils/logging.py``. It replaces the
reference's Visdom plots (its utils/visualize.py) with a dependency-free
CSV logger (one file per plot group) that accepts the same (x, y, key,
line_name) call shape, so entry points read like the reference while
producing artifacts any dashboard can ingest.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, directory: Optional[str] = None, enable: bool = True):
        self.dir = directory
        self.enable = enable and directory is not None
        self._files = {}
        if self.enable:
            os.makedirs(directory, exist_ok=True)

    def line_plot(self, x, y, key: str, line_name: str):
        if not self.enable:
            return
        fname = key.replace(" ", "_").replace("/", "_") + ".csv"
        path = os.path.join(self.dir, fname)
        new = not os.path.exists(path)
        f = self._files.get(path)
        if f is None:
            f = open(path, "a", newline="")
            self._files[path] = f
        w = csv.writer(f)
        if new:
            w.writerow(["time", "x", "line", "y"])
        w.writerow([f"{time.time():.1f}", x, line_name, float(y)])
        f.flush()

    def add_text(self, text: str):
        if not self.enable:
            return
        with open(os.path.join(self.dir, "notes.txt"), "a") as f:
            f.write(text + "\n")

    def show_text(self, text: str, key: str):
        """Named text window (visualize.py:67-75): the keyed file is
        OVERWRITTEN on update, like viz.text(win=key) replaces the window."""
        if not self.enable:
            return
        fname = "text_" + key.replace(" ", "_").replace("/", "_") + ".txt"
        with open(os.path.join(self.dir, fname), "w") as f:
            f.write(text + "\n")

    def hist_plot(self, x, key: str):
        """Histogram window (visualize.py:88-100): appends the raw values —
        any dashboard can re-bin; visdom's binning is display-side too."""
        if not self.enable:
            return
        import numpy as np
        fname = "hist_" + key.replace(" ", "_").replace("/", "_") + ".csv"
        with open(os.path.join(self.dir, fname), "a", newline="") as f:
            csv.writer(f).writerow(np.asarray(x).reshape(-1).tolist())

    def save(self):
        """Persist the logger state (visualize.py:80-86 ``viz.save([env])``).

        CSV rows are already flushed per write; this records the env-level
        manifest visdom would serialise — which plots exist and their row
        counts — so a dashboard can reload the run like a saved visdom env.
        Called by the CLIs at the reference's viz.save() sites
        (train.py:506, dense_annotation_finetuning.py:329)."""
        if not self.enable:
            return
        import json
        plots = {}
        for name in sorted(os.listdir(self.dir)):
            if not name.endswith(".csv"):
                continue
            path = os.path.join(self.dir, name)
            with open(path) as f:
                rows = sum(1 for _ in f)
            # hist_* files append raw value rows with no header line
            header = 0 if name.startswith("hist_") else 1
            plots[name] = {"rows": max(0, rows - header)}
        with open(os.path.join(self.dir, "env.json"), "w") as f:
            json.dump({"saved_at": time.time(), "plots": plots}, f, indent=2)

    def close(self):
        for f in self._files.values():
            f.close()
        self._files = {}
