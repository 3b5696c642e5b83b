"""What a run is asked to do, found by name: the cell in ``BENCHMARK.json``
and its own files, ``benchmark/workloads/<cell>.json``,
``benchmark/configs/<config>.json`` (the file ``BENCHMARK.json`` names),
``benchmark/traffic/<mix>.json``, and a reader
``benchmark/metrics/<metric>.py`` for each per-layer metric the cell
reports (one reader serves a quantity split by the end-to-end metric it
moves: ``mfu.py`` reads ``mfu.eval`` and ``mfu.train``). A cell, mix or
metric is added by adding its files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Spec:
    name: str
    chips: int
    loop: str
    config: dict            # the configuration file as it is run
    traffic: dict           # the mix's parameters
    serving: dict           # the cell's settings of the program
    limits: dict            # each compared number's limit
    check: dict             # how many answers / steps are compared
    end_to_end: List[dict]  # this cell's end-to-end metrics
    per_layer: List[dict]   # this cell's per-layer metrics
    readers: Dict[str, Callable]


def _load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def model_keys(cfg: dict) -> dict:
    """The configuration file's model keys: all but the benchmark's own
    ``bench`` group."""
    return {k: v for k, v in cfg.items() if k != "bench"}


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader_path(name: str, root: Path) -> Path:
    """The reader file of the per-layer metric ``name``: its own file, or,
    for a quantity split by the end-to-end metric it moves
    (``<quantity>.<split>``), the quantity's ``<quantity>.py``."""
    path = root / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = root / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    return path


def reader(name: str, root: Path) -> Callable:
    """``read(ctx)`` of the per-layer metric ``name``, from its file."""
    path = reader_path(name, root)
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load(cell: str, bench_json: Path = ROOT / "BENCHMARK.json",
         root: Path = None) -> Spec:
    """The spec of cell ``cell`` (KeyError for an unknown cell). Paths in
    ``bench_json`` are relative to its folder; the cell's own files are
    under ``root`` (default: that folder's ``benchmark``)."""
    bench_json = Path(bench_json)
    base = bench_json.parent
    root = Path(root) if root is not None else base / "benchmark"
    top = _load_json(bench_json)
    entry = {w["name"]: w for w in top["workloads"]}[cell]
    configs = {c["name"]: c for c in top["configs"]}
    wl = _load_json(root / "workloads" / f"{cell}.json")
    cfg = _load_json(base / configs[entry["config"]]["file"])
    traffic = _load_json(root / "traffic" / f"{entry['traffic']}.json")
    per_layer = [m for m in top["per_layer"] if _applies(m, cell)]
    return Spec(
        name=cell, chips=entry["chips"], loop=wl["loop"], config=cfg,
        traffic=traffic, serving=wl.get("serving", {}),
        limits=wl.get("limits", {}), check=wl.get("check", {}),
        end_to_end=[m for m in top["end_to_end"] if _applies(m, cell)],
        per_layer=per_layer,
        readers={m["name"]: reader(m["name"], root) for m in per_layer})
