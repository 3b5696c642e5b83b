"""The decoder cell (``gen-visdial-kimivl``, ``loops/eval_slates_decoder``)
at small shapes on the CPU: its last line through ``run.result_line``
(traced: the per-layer metrics the decoder's readers read), and its check
failing on a planted fault and under the fp8 control."""

import copy
import json
import math

import numpy as np
import torch

from benchmark import run
from benchmark.harness import result
from benchmark.harness import spec as spec_mod
from benchmark.loops import eval_slates_decoder as loop
from benchmark.reference import deepseek_v3_ref as ref

CELL = "gen-visdial-kimivl"
# two layers (the dense one, one MoE layer of 8 experts, top 2), hidden 64
SMALL = dict(vocab_size=300, hidden_size=64, intermediate_size=128,
             moe_intermediate_size=32, num_hidden_layers=2,
             num_attention_heads=2, n_routed_experts=8, num_experts_per_tok=2,
             kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16)
SEED = 2 ** 32 + 3


def small_spec():
    sp = spec_mod.load(CELL)
    cfg = copy.deepcopy(sp.config)
    cfg.update(SMALL)
    cfg["bench"] = dict(cfg["bench"], init_std=0.15, bias_std=0.2)
    sp.config = cfg
    sp.traffic = dict(sp.traffic, dialogs=4, rounds=2, options=6,
                      loader_batch=1, coalesce=2, max_seq_len=40,
                      ctx_growth=dict(sp.traffic["ctx_growth"], first=4,
                                      per_round=4, min=3, room=10),
                      image_tokens=[5, 9], image_std=0.15,
                      end_token=SMALL["vocab_size"] - 1)
    sp.check = dict(sp.check, slates=3, options=4)
    return sp


def test_last_line_traced(capsys):
    sp = small_spec()
    out, checks = loop.run(sp, SEED, 1.0, True, "cpu", 0.0)
    line = run.result_line(sp, out, True, "cpu")
    result.emit(line, checks)
    got = capsys.readouterr()
    last = json.loads(got.out.strip().splitlines()[-1])
    assert list(last)[-1] == "checks"
    assert set(last["checks"]) == set(sp.limits) == {"ll_gap", "route_gap",
                                                     "route_flips"}
    assert last["correct"] is True, last["checks"]
    for name, m in last["metrics"].items():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    # the decoder's readers find their spans and counters (the CPU runs
    # the plain versions: no grouped GEMM launch, so no roofline)
    assert {"moe_ms_per_dialog.eval", "mla_ms_per_dialog.eval",
            "moe_peak_load.eval", "mfu.eval", "idle_share.eval",
            "device_ms_per_dialog.eval"} <= set(last["metrics"]) or \
        {"moe_peak_load.eval", "mfu.eval"} <= set(last["metrics"])
    assert 100.0 <= last["metrics"]["moe_peak_load.eval"]["value"] <= 800.0
    assert out["ctx"]["check"]["compared"] == 12


def test_untraced_end_to_end_metrics():
    sp = small_spec()
    out, checks = loop.run(sp, SEED + 1, 1.0, False, "cpu", 0.0)
    line = run.result_line(sp, out, False, "cpu")
    assert set(line["metrics"]) == {"dialogs_per_s", "group_p95_ms",
                                    "setup_s"}
    assert line["correct"] is True, checks


class _BiasLeftOut(loop.Program):
    """A fault: the router's correction bias left out of the choice."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        for lay in self.model.layers:
            if "e_score_correction_bias" in lay:
                lay["e_score_correction_bias"].zero_()


def test_check_fails_on_a_planted_fault():
    sp = small_spec()
    out, checks = loop.run(sp, SEED, 1.0, False, "cpu", 0.0,
                           program=_BiasLeftOut)
    assert out["correct"] is False
    assert checks["route_gap"]["value"] > checks["route_gap"]["limit"]
    assert checks["route_flips"]["value"] > checks["route_flips"]["limit"]


def test_check_fails_under_the_fp8_control():
    sp = small_spec()
    cfg, mix = sp.config, sp.traffic
    pool, order = loop.make_pool(mix, cfg, SEED)
    prog = loop.Program(cfg, sp.serving, SEED, "cpu")
    c = mix["coalesce"]
    done = []
    for g in order:
        fin = prog.dispatch(loop.eval_slates.merge(pool[g * c:(g + 1) * c]))
        done.append((int(g), {k: np.asarray(v) for k, v in fin().items()}))
    logs = prog.logs
    got = loop.check(cfg, SEED, "cpu", pool, c, done, logs, 3, 4,
                     control=ref.Precision("fp8"))
    assert got["ll_gap"] > sp.limits["ll_gap"]


def test_pool_sizes_follow_the_mix():
    sp = spec_mod.load(CELL)
    mix = dict(sp.traffic, dialogs=8)
    cfg = dict(sp.config, hidden_size=8)
    pool, order = loop.make_pool(mix, cfg, SEED)
    assert len(pool) == 4 and sorted(order.tolist()) == [0]
    b = loop.eval_slates.merge(pool[:4])
    assert b["tokens"].shape == (8, 10, 100, 256)
    assert (b["image_len"] >= 345).all() and (b["image_len"] <= 391).all()
    A = b["ans_len"]
    assert A.min() >= 3 and A.max() <= 9
    lc = b["ctx_end"][..., 0]
    assert lc.min() >= 24 and lc.max() <= 238
    end = np.take_along_axis(b["tokens"], (lc[..., None] + A - 1)[..., None],
                             -1)[..., 0]
    assert (end == mix["end_token"]).all()
    torch.manual_seed(0)
