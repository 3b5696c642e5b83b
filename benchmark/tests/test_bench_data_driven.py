"""A cell, a traffic mix and a per-layer metric are added by new files
and new entries only: a copy of the benchmark's data with a dummy cell,
its own mix and its own metric reader, run through the unchanged
harness."""

import json
import shutil
from pathlib import Path

from benchmark import run
from benchmark.loops import eval_slates
from benchmark.tests._tiny import GROWTH, tiny_spec

ROOT = Path(__file__).resolve().parents[2]


def test_dummy_cell_from_data_only(tmp_path):
    for d in ("configs", "workloads", "traffic", "metrics"):
        shutil.copytree(ROOT / "benchmark" / d, tmp_path / "benchmark" / d)
    top = json.loads((ROOT / "BENCHMARK.json").read_text())
    top["workloads"].append({
        "name": "gen-dummy", "config": "vilbert-base-visdial-eval",
        "traffic": "dummy-short", "chips": 1, "why": "a test's cell"})
    for m in top["end_to_end"]:
        if m["name"] == "dialogs_per_s":
            m["workloads"].append("gen-dummy")
    top["per_layer"].append({
        "name": "merge_ms.eval", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "evaluator staging",
        "moves": "dialogs_per_s", "workloads": ["gen-dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(top))
    b = tmp_path / "benchmark"
    (b / "traffic" / "dummy-short.json").write_text(json.dumps({
        "kind": "slates", "layout": "gen", "dialogs": 4, "rounds": 2,
        "options": 5, "ctx_growth": dict(GROWTH, per_round=9),
        "ans_range": [2, 5], "loader_batch": 2, "coalesce": 1,
        "size_seed": 1}))
    wl = json.loads((b / "workloads" / "gen-visdial-val.json").read_text())
    wl["serving"]["prefix_group"] = 4
    (b / "workloads" / "gen-dummy.json").write_text(json.dumps(wl))
    (b / "metrics" / "merge_ms.eval.py").write_text(
        "from benchmark.harness.readers import span_mean_ms\n\n\n"
        "def read(ctx):\n    return span_mean_ms(ctx, 'merge')\n")

    sp = tiny_spec("gen-dummy", bench_json=tmp_path / "BENCHMARK.json")
    assert sp.traffic["ctx_growth"]["per_round"] == 9
    assert sp.traffic["coalesce"] == 1
    out, _ = eval_slates.run(sp, 123, 1.0, True, "cpu", 0.0)
    got = run.metrics_of(sp, out, True)
    assert got["merge_ms.eval"]["value"] > 0
    assert {m["name"] for m in sp.end_to_end} == {"dialogs_per_s",
                                                  "setup_s"}
