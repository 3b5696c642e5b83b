"""The reading of the program's own spans (``harness/program.py``):
attribution of device time and idle gaps by program range on synthetic
events, the harness's summary unchanged by the program's ranges, each
number's reader, and the view of a cell at small shapes on the CPU."""

import json
import math

import pytest
import torch

from benchmark import program_view
from benchmark.harness import program as pg
from benchmark.harness import trace as tr
from benchmark.tests._tiny import tiny_spec


def ev(name, start, end, tid=1, corr=0, linked=0, dev=False, launch=None):
    if launch is None:
        launch = not dev and name.startswith("cuda")
    return pg.Ev(name, dev, float(start), float(end), tid, corr, linked,
                 launch)


# one slice of 1000 us on thread 1; thread 2 is the autograd engine's
EVENTS = [
    ev("bench.slice", 0, 1000),
    ev("bench.dispatch", 90, 410), ev("bench.merge", 480, 520),
    ev("bench.fetch", 590, 710),
    ev("unimm.eval.dispatch", 100, 400, corr=1),
    ev("unimm.eval.h2d", 120, 150, corr=2),
    ev("unimm.op.ffn_block", 200, 210, corr=3),
    ev("aten::mm", 202, 208, corr=50),
    ev("unimm.eval.fetch", 600, 700, corr=4),
    ev("unimm.op.attention_block_train_bwd", 320, 340, tid=2, corr=5),
    # the launches
    ev("cudaMemcpyAsync", 125, 126, corr=11),
    ev("cudaLaunchKernel", 205, 206, corr=12),
    ev("cudaLaunchKernel", 300, 301, corr=13),
    ev("cudaLaunchKernel", 325, 326, tid=2, corr=14),
    ev("cudaLaunchKernel", 350, 351, tid=2, corr=15),
    ev("cudaLaunchKernel", 500, 501, corr=16),
    ev("cudaLaunchKernel", 610, 611, corr=17),
    # the device: a copy, kernels, and the ranges' copies on its timeline
    ev("Memcpy HtoD", 130, 160, corr=11, dev=True),
    ev("k_ffn", 210, 300, corr=12, dev=True),
    ev("k_dispatch", 305, 320, corr=13, dev=True),
    ev("k_bwd", 330, 360, corr=14, dev=True),
    ev("k_autograd", 360, 380, corr=15, dev=True),
    ev("k_linked", 380, 390, corr=99, linked=50, dev=True),
    ev("k_lost", 395, 398, corr=98, dev=True),
    ev("k_merge", 505, 515, corr=16, dev=True),
    ev("k_fetch", 620, 640, corr=17, dev=True),
    ev("unimm.eval.dispatch", 100, 400, dev=True),
    ev("bench.dispatch", 90, 410, dev=True),
]


def test_attribution_by_launch_thread_and_range():
    att = pg.attribute(EVENTS)
    us = 1e-6
    want = {"eval.h2d": (30, 1), "op.ffn_block": (90 + 10, 2),
            "eval.dispatch": (15 + 20, 2),
            "op.attention_block_train_bwd": (30, 1),
            "unattributed": (3, 1), "bench.merge": (10, 1),
            "eval.fetch": (20, 1)}
    assert set(att["device"]) == set(want)
    for name, (t, n) in want.items():
        assert att["device"][name][0] == pytest.approx(t * us), name
        assert att["device"][name][1] == n, name
    assert att["roots"] == pytest.approx({
        "eval.dispatch": 195 * us, "eval.fetch": 20 * us,
        "bench.merge": 10 * us, "unattributed": 3 * us})
    assert att["found"] == {"runtime": 7, "linked": 1, "none": 1}
    assert att["kernels"]["op.ffn_block"] == {
        "k_ffn": [pytest.approx(90 * us), 1],
        "k_linked": [pytest.approx(10 * us), 1]}
    assert att["kernels"]["eval.h2d"] == {"Memcpy HtoD":
                                          [pytest.approx(30 * us), 1]}
    assert att["busy_s"] == pytest.approx(
        (30 + 90 + 15 + 50 + 10 + 3 + 10 + 20) * us)
    assert att["slice_s"] == pytest.approx(1000 * us)
    assert att["ranges"] == 5
    # gaps: [0, 130] before every span; [160, 210], [300, 305] and
    # [320, 330] in the dispatch (the last while thread 2 ran); [390, 395]
    # and [398, 505] at 396.5 in the dispatch, at 451.5 in none; [515,
    # 620] at 567.5 in none; [640, 1000] at 820 in none
    assert att["idle"] == pytest.approx({
        "outside_spans": (130 + 107 + 105 + 360) * us,
        "eval.dispatch": (50 + 5 + 10 + 5) * us})
    assert pg.root_share(att, ("eval.dispatch", "eval.fetch")) == \
        pytest.approx(100 * 215 / 228)


def test_no_slice_no_attribution():
    assert pg.attribute([e for e in EVENTS if e.name != "bench.slice"]) \
        is None


class _KEv:
    """A kineto event as ``harness/trace._events`` reads it."""

    def __init__(self, e):
        self.e = e

    def name(self):
        return self.e.name

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self.e.dev
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return int(self.e.start * 1e3)

    def duration_ns(self):
        return int((self.e.end - self.e.start) * 1e3)


class _Prof:
    def __init__(self, evs):
        evs = [_KEv(e) for e in evs]
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": staticmethod(lambda: evs)})()})()


def test_harness_summary_unchanged_by_program_ranges():
    without = [e for e in EVENTS if not e.name.startswith("unimm.")]
    a = tr.reduce(*tr._events(_Prof(EVENTS)))
    b = tr.reduce(*tr._events(_Prof(without)))
    assert a == b
    assert a["busy_s"] == pytest.approx(228e-6)
    assert "unimm.eval.dispatch" not in a["kernels"]


def _ctx():
    att = pg.attribute(EVENTS)
    att["device"]["op.answer_block"] = [0.004, 2]
    att["device"]["train.mlm_xent"] = [0.010, 3]
    att["device"]["train.mlm_xent.bwd"] = [0.020, 3]
    sp = {"eval.dispatch": {"dur": [0.010, 0.030], "self": [0.001, 0.002]},
          "eval.h2d": {"dur": [0.002, 0.004, 0.006], "self": [0, 0, 0]},
          "eval.plan": {"dur": [0.003, 0.003], "self": [0.003, 0.001]},
          "eval.pack": {"dur": [0.005], "self": [0.002]},
          "train.step": {"dur": [0.5] * 4, "self": [0.1] * 4},
          "train.vote": {"dur": [0.01, 0.02, 0.03, 0.04],
                         "self": [0.01] * 4}}
    counts = {"eval.rows_needed.prefill": 30, "eval.rows_launched.prefill": 48,
              "eval.rows_needed.answer": 10, "eval.rows_launched.answer": 52,
              "eval.dispatches": 2}
    return {"program": {"device": att,
                        "host": {"spans": sp, "counts": counts}},
            "slice_work": {"dialogs": 4, "steps": 5}}


def test_readers_values():
    c = _ctx()
    want = {"h2d_ms.eval": 6.0, "pack_ms.eval": 3.0,
            "idle_h2d_share.eval": 0.0, "idle_pack_share.eval": 0.0,
            "useful_rows.eval": 40.0, "ffn_ms_per_dialog.eval": 0.1e-3 / 4
            * 1e3, "attn_block_ms_per_dialog.eval": 1.0,
            "xent_ms_per_step.train": 6.0, "vote_host_ms.world": 25.0}
    got = pg.read_all(c)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k
    # idle under the h2d and the packing ranges, when there is some
    c["program"]["device"]["idle"]["eval.h2d"] = 0.25e-3
    c["program"]["device"]["idle"]["eval.pack"] = 0.1e-3
    c["program"]["device"]["idle"]["eval.plan"] = 0.15e-3
    assert pg.METRICS["idle_h2d_share.eval"](c) == pytest.approx(25.0)
    assert pg.METRICS["idle_pack_share.eval"](c) == pytest.approx(25.0)


@pytest.mark.parametrize("ctx", [
    {}, {"program": None, "slice_work": None},
    {"program": {"device": None, "host": None}, "slice_work": {}},
    # a parent's program: no range in the slice, nothing recorded
    {"program": {"device": pg.attribute(
        [e for e in EVENTS if not e.name.startswith("unimm.")]),
        "host": {"spans": {}, "counts": {}}},
     "slice_work": {"dialogs": 4, "steps": 5}}])
def test_readers_none_without_the_spans(ctx):
    for name, fn in pg.METRICS.items():
        assert fn(ctx) is None, name
    assert pg.read_all(ctx) == {}


@pytest.mark.parametrize("cell,names", [
    ("gen-visdial-val", {"h2d_ms.eval", "pack_ms.eval", "useful_rows.eval",
                         "idle_h2d_share.eval", "idle_pack_share.eval"}),
    ("train-b240", {"vote_host_ms.world"})])
def test_view_of_a_cell_on_the_cpu(cell, names, capsys):
    sp = tiny_spec(cell)
    sp.serving = dict(sp.serving, trace_slice_s=0.5)
    line = program_view.run(sp, 2 ** 32 + 5, 1.0, "cpu")
    print(json.dumps(line))
    out = capsys.readouterr()
    last = json.loads(out.out.strip().splitlines()[-1])
    # the CPU runs the kernels' plain versions: no op ranges, no device
    assert names <= set(last["metrics"])
    for v in last["metrics"].values():
        assert math.isfinite(v)
    assert 0 < last["metrics"].get("useful_rows.eval", 50) <= 100
    assert "program host time by span" in out.err
    assert last["rest"]["spans_ms"]
