"""BENCHMARK.json against the benchmark's contract (keys, names, units,
files, bounds), and the last line a run prints."""

import json
import math
import re
from pathlib import Path

import pytest

from benchmark import run
from benchmark.harness import result
from benchmark.harness import spec as spec_mod
from benchmark.loops import eval_slates, train_steps
from benchmark.tests._tiny import tiny_spec

ROOT = Path(__file__).resolve().parents[2]
TOP = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_limits():
    assert set(TOP) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= TOP["run_seconds"] <= 51
    cells = len(TOP["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(TOP["configs"]) <= 24
    assert sum(w["chips"] == 4 for w in TOP["workloads"]) <= max(1,
                                                                 cells // 4)
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (TOP["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for p in TOP["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p)
        assert (ROOT / p).is_dir()
    assert all(TEXT.match(w) for w in TOP["command"])


def test_names_units_and_files():
    names = set()
    for c in TOP["configs"]:
        assert set(c) <= {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in TOP["paths"]))
        assert all(NAME.match(k) for k in c["reduced"])
    cfgs = {c["name"] for c in TOP["configs"]}
    pairs = set()
    for w in TOP["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        assert w["config"] in cfgs
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "benchmark" / "workloads" / f"{w['name']}.json"
                ).is_file()
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json"
                ).is_file()
    cells = {w["name"] for w in TOP["workloads"]}
    assert cfgs == {w["config"] for w in TOP["workloads"]}
    e2e = {m["name"]: m for m in TOP["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in TOP["end_to_end"] + TOP["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
        assert set(m.get("workloads", cells)) <= cells
    for m in TOP["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in TOP["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        assert spec_mod.reader_path(m["name"], ROOT / "benchmark"
                                    ).is_file()
        for c in m["workloads"]:
            moved = e2e[m["moves"]]
            assert c in moved.get("workloads", cells)
        layers.setdefault(m["layer"], m["layer"])
    for c in cells:
        mine = [m for m in TOP["end_to_end"]
                if c in m.get("workloads", cells)]
        assert len(mine) >= 2
        assert any(c in m["workloads"] for m in TOP["per_layer"])


def test_every_reader_file_is_read():
    read = {spec_mod.reader_path(m["name"], ROOT / "benchmark")
            for m in TOP["per_layer"]}
    assert set((ROOT / "benchmark" / "metrics").glob("*.py")) == read


@pytest.mark.parametrize("cell,trace", [("gen-visdial-val", True),
                                        ("train-b240", False)])
def test_last_line(cell, trace, capsys):
    sp = tiny_spec(cell)
    drv = eval_slates if sp.loop == "eval_slates" else train_steps
    out, checks = drv.run(sp, 2 ** 32 + 3, 1.0, trace, "cpu", 0.0)
    line = run.result_line(sp, out, trace, "cpu")
    result.emit(line, checks)
    got = capsys.readouterr()
    last = json.loads(got.out.strip().splitlines()[-1])
    assert list(last)[-1] == "checks"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in last
    assert set(last["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for name, m in last["metrics"].items():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    if not trace:
        assert set(last["metrics"]) == {m["name"] for m in sp.end_to_end}
    err = got.err.strip().splitlines()
    assert len(err) >= len(checks)
    assert all(x.startswith("check ") for x in err[-len(checks):])
    assert set(last["checks"]) == set(sp.limits)


def test_forbidden_modules_compared_whole(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "unimm_tpu_extra", types.ModuleType(
        "unimm_tpu_extra"))
    assert result.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla",
                        types.ModuleType("jaxlib.xla"))
    assert result.loaded_forbidden() == ["jaxlib"]
