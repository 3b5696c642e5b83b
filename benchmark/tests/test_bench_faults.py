"""``correct`` at the cells' own limits, on the CPU at small shapes:
a sound run passes; the control (the reference in fp8 in the program's
place) and each fault a cell can have, planted under the timed path, come
out not correct. The harness's look for a card is skipped (the cell loops
are called directly); the rest of a run is driven as it is."""

import sys
import types

import pytest
import torch

from benchmark import run
from benchmark.harness import result, traffic
from benchmark.loops import eval_slates, train_steps, train_world
from benchmark.loops.faults import (AnswerAltered, HalfBatch, HalfLeftOut,
                                    NoExchange, Unchanged)
from benchmark.reference import vilbert_ref as ref
from benchmark.tests._tiny import NARROW_MODEL, tiny_spec

SEED = 2 ** 31 + 17
EVAL_CELLS = ["gen-visdial-val", "dis-visdial-val"]


def _run(sp, program):
    drv = {"eval_slates": eval_slates, "train_steps": train_steps,
           "train_world": train_world}[sp.loop]
    out, checks = drv.run(sp, SEED, 1.0, False, "cpu", 0.0, program=program)
    return out, checks


@pytest.mark.parametrize("cell", EVAL_CELLS)
def test_eval_sound_run_is_correct(cell):
    out, checks = _run(tiny_spec(cell), eval_slates.Program)
    assert out["correct"], checks


@pytest.mark.parametrize("cell", EVAL_CELLS)
@pytest.mark.parametrize("fault", [AnswerAltered, HalfLeftOut])
def test_eval_fault_is_not_correct(cell, fault):
    out, checks = _run(tiny_spec(cell), fault)
    assert not out["correct"], checks


@pytest.mark.parametrize("cell", EVAL_CELLS)
def test_eval_control_is_not_correct(cell):
    sp = tiny_spec(cell)
    groups, order = traffic.make(sp.traffic, sp.config, SEED)
    done = [(int(g), None) for g in order]
    gap, n = eval_slates.check(sp.config, sp.serving["mode"], SEED, "cpu",
                               groups, sp.traffic["coalesce"], done,
                               sp.check["slates"],
                               control=ref.Precision("fp8"))
    name = sp.check["number"]
    assert n > 0 and gap > sp.limits[name], (gap, sp.limits[name])


def test_train_sound_run_is_correct():
    out, checks = _run(tiny_spec("train-b240"), train_steps.Program)
    assert out["correct"], checks


@pytest.mark.parametrize("fault", [Unchanged, HalfBatch])
def test_train_fault_is_not_correct(fault):
    out, checks = _run(tiny_spec("train-b240"), fault)
    assert not out["correct"], checks


@pytest.mark.parametrize("cell", ["train-b240", "train-b240-dp4"])
def test_train_control_is_not_correct(cell):
    sp = tiny_spec(cell)
    pool, order = traffic.make(sp.traffic, sp.config, SEED)
    kw = {"block": sp.check["block_rows"], "world": sp.chips}
    r32 = train_steps.reference_readings(sp.config, SEED, pool, order, "cpu",
                                         ref.Precision("fp32"), **kw)
    r8 = train_steps.reference_readings(sp.config, SEED, pool, order, "cpu",
                                        ref.Precision("fp8"), **kw)
    g = train_steps.gaps(r8, r32)
    assert any(g[n] > sp.limits[n] for n in sp.check["numbers"]), g


def test_unchanged_state_reads_one():
    r = {"losses": [1.0], "g1": {"a": 1.0, "b": 2.0},
         "change": {"a": 0.5, "b": 0.25}}
    p = dict(r, change={"a": 0.0, "b": 0.0})
    assert train_steps.gaps(p, r)["change_gap"] == pytest.approx(1.0)
    assert torch.isfinite(torch.tensor(train_steps.gaps(r, r)["loss_gap"]))


# the world of four processes on the CPU (gloo), every width cut: the
# world's mechanics, at readings under the cell's limits
def test_world_sound_run_is_correct():
    out, checks = _run(tiny_spec("train-b240-dp4", NARROW_MODEL),
                       train_steps.Program)
    assert out["correct"], checks
    assert out["loaded"] == []


class LoadsJax(train_steps.Program):
    """A sound program whose second rank loads a module named ``jax``."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        if torch.distributed.get_rank() == 1:
            sys.modules.setdefault("jax", types.ModuleType("jax"))


def test_world_rank_holding_jax_prints_no_result(capsys):
    """The ranks run the program, not the parent: what a rank loads stops
    the run without a result."""
    assert result.loaded_forbidden() == []
    rc = run.run_cell(tiny_spec("train-b240-dp4", NARROW_MODEL), SEED, 1.0,
                      False, "cpu", program=LoadsJax)
    got = capsys.readouterr()
    assert rc != 0
    assert not got.out.strip()
    assert got.err.strip().splitlines()[-1] == "loaded by the run: jax"


@pytest.mark.parametrize("fault", [NoExchange, Unchanged])
def test_world_fault_is_not_correct(fault):
    out, checks = _run(tiny_spec("train-b240-dp4", NARROW_MODEL), fault)
    assert not out["correct"], checks
