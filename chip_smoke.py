"""Drive the PyTorch/CUDA port on one NVIDIA card: build the Hopper kernels,
hold each against its plain PyTorch version at main-path shapes, then run
the serving paths end to end and check that they went through the kernels.

    python3 chip_smoke.py
    python3 chip_smoke.py --train-gates [SEED ...]
    python3 chip_smoke.py --world
    python3 chip_smoke.py --mp
    python3 chip_smoke.py --modes
    python3 chip_smoke.py --xent-train
    python3 chip_smoke.py --moe

``--world`` runs phase 1, the build and phase 13 alone, ``--mp`` phase 1,
the build and phase 14 alone (``--world-rank SPEC RANK`` is one of their
rank processes), ``--modes`` phase 1, the build and phase 15 alone,
``--xent-train`` phase 1, the build, phase 2's report and phase 3's
training cross-entropy cases alone, ``--moe`` phase 1, the build, phase
2's report, phase 3's grouped expert GEMM, MLA answer and K3 cases and
phase 16 (the decoder's path) alone.
``--train-gates`` runs phase 1,
the build and phase 8 (a)'s two gates alone, on the batches of the given
seeds (default GATE_SEEDS), printing
both results and each batch's single-batch margins, and exits 1 if a gate
fails: the readings of a gate on a changed tree, as a planted fault.

Phases (any failure exits nonzero with its traceback, and no ok line; each
prints its seconds):
  1. device: require CUDA; print the card's name and power limit; TF32 off.
  2. build: compile unimm_torch/csrc/*.cu for sm_90a (timed); print
     ptxas's registers and spills of every kernel, the one-pass forward's
     five instances (B6's forward, B9, B4, B5's forward with and without
     dropout) and the attention backward's two kernels (B6's and B5's
     backward) with their shared memory and CTAs an SM, the Hopper GEMM
     core's instances (K1, K2, B8, B4, B5), K1's attention kernel (with its
     shared memory and CTAs an SM) and K3's logits kernel (fails on a
     spill of any), the probes' own kernels (B10's none and noshift
     attention, B11's pad128 attention and wo_acc / transposed kernel,
     with their shared memory and CTAs an SM; fails on a spill), whether
     each recorded attention-kernel and gemm_nt_wg_kernel instance kept
     the SASS of SASS_RECORD's build (tools/sass_digest; fails on one that
     differs under the same nvcc), that B4's and B5's Q/K/V and residual
     instances of the GEMM core have K1's SASS and the probes' GEMM-core
     and B4-attention instances B4's, and that no kernel of the library is
     one of the first design's (FIRST_DESIGN), so that no phase can launch
     one.
  3. kernels: each kernel against its plain version on the same bf16
     inputs at full width, with the stated tolerance; kernel, plain and
     one-PyTorch-call (``library_ms``) times by CUDA events; the roofline
     bound from this run's shapes. K2 also at 1-300 rows and B8 at 1, 37
     and 64 regions, at WIDE_STD, each bit-equal when rerun and with
     controls that must miss (the twin with one 64-wide k tile of W1, W2
     or Wd2 zeroed, or with the last row dropped). K1 at WIDE_STD at four
     shapes and on the scorer's own biases at two, then at row blocks of
     16-row tails (RB 32 and 96 on the packed biases, the W layout's Rw
     160 on its biases at W 16 and 32) and context buckets 96 and 36, its
     per-head context too, bit-equal when rerun, the twin at lc - 1 and on
     options shifted by a row missing the context bound; K3 at M 25600
     and 1000, bit-equal when rerun, the twin on labels one column on and
     without the last vocab tile missing its bound; the training
     cross-entropy (xent_train: nll, lse and the three gradients against
     the plain scan of _OnlineXent) at the step's M 38400, a dp rank's 9600
     and 129 rows over a vocabulary of 5000, bit-equal when rerun, the same
     two controls missing on every output. B4 and B5 bit-equal
     when rerun, with each kernel's time a call at their main shapes
     (fails on a launch of the first design's gemm_nt_kernel,
     out_ln_kernel or seq_attn_kernel); B10 and B11 likewise at the
     bench's shape, and B10 ``full`` bit-equal to B4. K3 also at width
     2048 without a bias (the decoder's head, M 48000 and 1000 over 163840
     words); the grouped expert GEMM (``check_moe``: both products, an
     expert with no row and one with every token) at 16384 and 40960
     tokens over 64 experts (the cell's rows a pass), the shared experts
     and a dense layer as one group each, and 129 tokens; the MLA answer
     kernel (``check_mla_answer``) at the cell's shapes (80 slates, Lcb
     640, ~40k rows of 16 heads), bit-equal when rerun, its controls (a
     key tile dropped, an option boundary moved by a row, n_ctx one on)
     missing, with the padded plain chain it replaced timed beside it.
  4. generative path: ``evaluate_split(mode="ll_sum")`` (prefix-cache
     scorer) at the default config (12 text / 6 vision / 6 connection
     layers, hidden 768 / 1024, vocab 30522) from a seeded init over 4
     pinned and 4 realistic ``make_val_batch(B=2, R=10, O=100)`` batches;
     launch counts must be 12 / 18 / 1 per slate group; scores against
     the plain versions on the card.
  5. discriminative path: ``evaluate_split(mode="nsp")`` (flat chunked
     scorer, chunk 256) over 4 pinned and 4 realistic ``make_dis_batch``
     batches; 12 attention-block and 18 FFN launches per chunk; NSP logits
     against the all-plain evaluator on the card.
  6. ``evaluate_ensemble(mode="nsp")`` of two members (seeds 0 and 1) with
     ``fused_co``: 6 co-attention launches per chunk per member; each
     member's logits against the plain path; one ``test_split`` call.
  7. generative fallback: a pinned pair with 3 slates made ineligible;
     ``score_slates`` must send them through the attention-block kernel
     and agree with the plain evaluator.
  8. training (``train/step.make_train_step`` at the default config, fp32
     master weights, bf16 compute, ``workload.make_train_batch``):
     (a) B 64: at dropout 0, the kernel path's loss parts against the
     all-plain path, every parameter's gradient against the fp32 step
     no farther than the plain bf16 path's (mean distances over three
     batches); at the default dropouts, the
     kernel path against the attention blocks' plain twin with the same
     masks, every text attention gradient within 15%; (b) default
     dropouts, B 240: 2 warm-up and 5 timed steps with the grouped plain
     AdamW and 5 with the fused one, 12 + 12 attention-block launches per
     step and one AdamW launch per parameter tensor, ms/step, sequences/s
     and peak memory; the fused update against the plain one bit for bit;
     (c) 8 steps on one batch lower the loss.
  9. per-head attention and remat (phase 3 also holds B6's forward and
     backward and B9 against their plain twins, each with a control on
     the flipped descriptors, B6's forward and backward also at L 32 and
     160 on the edge descriptors and on masked tails, B9 equal to B6's
     forward bit for bit, and B5's and B6's backward equal bit for bit
     across two runs, B5's with the twin under another Philox seed as a
     control): (a) ``evaluate_split(mode="nsp")`` under
     ``attention_impl="pallas"`` over 2 pinned and 2 realistic dis
     batches, 12 B6 launches per chunk and nothing else, NSP margins
     against the all-plain evaluator, steady dialogs/s beside phase 5's;
     (b) training under "pallas" at attention dropout 0: at B 64 the text
     attention gradients against the "xla" step on the same masks (phase
     8 (a)'s fp32 yardstick), then 3 timed B 240 steps (12 + 12 B6
     launches a step); (c) remat: 3 timed B 240 steps under "pallas" (24
     forward, 12 backward B6 launches a step) and "pallas_block" (12 + 12
     B5), and at B 64 the gradients against the step without remat,
     within the spread of two runs of that step; (d) "pallas" at the
     default dropouts launches no B6; (e) ``tools/bench_attn`` runs every
     variant.
 10. attention-block bench (phase 3 also holds B10's four softmax modes and
     B11's three layouts against their plain twins at the bench's shape
     and at L 96, each with a control, B10 ``full`` equal to B4 bit for
     bit, and B4 at block_b 2 equal to block_b 1 bit for bit):
     ``tools/bench_attn_block`` runs its 13 variants, 2 calls a
     measurement, with 2 B4, 2 K2, 4 B10 and 3 B11 launches per call
     round; then each variant's kernels, one profiled call round (fails
     on a launch of FIRST_DESIGN).
 11. the evaluation CLIs at full width through ``main(argv)``, as a user
     runs them (``python -m unimm_torch.cli.val_lm ...``): a fixture tree
     (``tools/fixture_tree.py``, 2048 features and 1601 classes, 8 val and
     4 test dialogs) with its features in a reference-format LMDB read by
     the native reader, reference-format .ckpt files of seeded models
     through -start_path / -model_paths, -max_seq_len 256, 100 options,
     bf16: (a) val_lm (12 K1 / 18 K2 / 1 K3 per slate group), (b) under
     -attention_impl xla (no launch), (c) -prefix_packed 0 (the W layout,
     K1 at Rw 160), (d) -prefix_rowblock 32 (K1 at RB 32), (e) val_avg_lm,
     (f) val with two -model_paths (12 B4 / 18 K2 per chunk per member),
     (g) evaluate on the test split (one EvalAI record of 100 ranks per
     dialog); (b)-(d) rank like (a) (top-1 agreement); each run's wall
     seconds, one reading each (a functional check, not a rate). Then the
     rate from files: a second tree of CLI_RATE_VAL val dialogs, one
     val_lm run as warm-up, then CLI_RATE_TURNS turns of the val loader
     alone and a timed val_lm run on the same dialogs: each run's evaluate
     call and its dialogs/s (the host data pipeline included), the seconds
     in it that the evaluator waited for the loader's next batch, and the
     loader alone; median and spread of each.
 12. the training CLIs at full width through ``main(argv)``, as a user runs
     them (``python -m unimm_torch.cli.train ...``, ``... dense_finetune``):
     a fixture tree of 90 train and 4 val dialogs at the config's widths
     (features in a native-read LMDB), the default config file at
     -max_seq_len 256, bf16, a seeded start .ckpt, -batch_size 240
     -sequences_per_image 8 (3 steps an epoch): (a) train 2 epochs with a
     save each epoch, the epoch-2 eval and -fused_adamw 1; (b) -continue
     from (a)'s native directory, the restored state bit-equal to (a)'s;
     (c) -continue from (a)'s .ckpt, the Adam count restored; (d) (a)
     relaunched with -auto_resume does nothing; (e) -batch_multiply 2
     -length_buckets 1, B5 at the morsels' bucket lengths; (f) val_lm from
     (a)'s .ckpt; (g) dense_finetune -overfit, 5 steps of 100 options with
     the GT first. Launch counts as derived from the code (12 + 12 B5
     and one xent_train_fwd / _bwd a micro-step, one B7 a parameter tensor an update, 12 B4 / 18 K2 an
     eval chunk, 12 K1 / 18 K2 / 1 K3 a slate group), every loss finite;
     each run's seconds and the training runs' ms a step beside the
     loader's wait and phase 8 (b)'s ms a step.
 13. the data-parallel world at full width: two rank processes on the one
     card (``--world-rank``; ``device="cuda:0"`` on both, backend gloo,
     passed explicitly, since NCCL takes one rank a device) run the CLIs
     through -coordinator_address -num_processes 2 -process_id r, against
     one-process runs of the same commands on a fixture tree of 24 train
     and 9 val dialogs and a start .ckpt: (a) val_lm -eval_data_sharded 1
     (rank 1's last batch tail padding), (b) val_lm serving (each rank
     scores half of every prefix group): every record once in the
     predictions file, top-1 agreement with the one-process run, the
     largest ll_sum and metric differences, 12 K1 / 18 K2 / 1 K3 a group
     a rank; (c) train, 2 ranks x 120 sequences against 1 x 240 (every
     sequence of 12 images a step, so the same global batches), dropout
     0, 2 steps, -fused_adamw 1: the ranks' weights bit-equal, every loss
     part within LOSS_RTOL of the one-rank run's, 12 + 12 B5, one
     xent_train_fwd / _bwd and 534 B7 a rank and step, each rank's peak memory and ms a step beside its
     gradient all-reduce's ms (the card synchronized around it); (d)
     dense_finetune, 2 steps, the slate split 50 / 50, as (c); (e) one
     rank under NCCL: one train step and a data-sharded val_lm, each
     bit-equal to the same command without the flags.
 14. the -mesh_mp axis at full width: rank processes on the one card under
     gloo, each model sharded over its mp group by the JAX package's rules
     (``unimm_torch/parallel/mesh.py``), on phase 13's tree at the default
     dropouts, against runs of the same commands in this process: (a)
     train, dp 1 x mp 2, 2 steps, -fused_adamw 1, a save: the gathered
     weights and both moments bit-equal to one process's, the replicated
     tensors bit-equal across the ranks; (b) val_lm serving, dp 1 x mp 2:
     the predictions file byte-equal; (c) dense_finetune, dp 1 x mp 2, 2
     slates: bit-equal; (d) train, dp 2 x mp 2, 2 steps: bit-equal to a dp
     2 x mp 1 world; (e) (a)'s save resumed at mp 1 for one step, bit-equal
     to the one-process save resumed. Launches a rank as one process's;
     each rank's fp32 state bytes, peak memory since sharding, ms a step,
     mp gather and dp all-reduce MiB and ms (the card synchronized around
     each). Phase 3 also holds B7 at the word embeddings' mp 2 slice,
     [15261, 768].
 15. the encoder modes and the VL task heads at full width (the default
     config, seeded weights, TF32 off), through ``unimm.encode`` and
     ``vl_tasks.vl_tasks_forward``: (a) ``in_batch_pairs``, fp32, 8 text
     rows (4 gen, 4 dis, ``workload``'s sequences) crossed with 8 images
     (9-37 real regions) into 64 pairs, against the plain ``encode``
     (``attention_impl="xla"``, the mode off) of the batch crossed on the
     host (row p = text p // 8 with image p % 8), and its diagonal against
     the unexpanded forward; (b) ``fast_mode``, fp32, one gen text row
     over 64 images, against the plain forward of the row repeated 64
     times. (a) and (b) launch no kernel (the JAX package's rule: the
     modes run the plain text stream) and hold each of the four outputs
     by two rules: run in fp64 (the model cast to float64), the mode's
     forward and the plain one agree at every element within
     MODES64_ATOL + MODES64_RTOL |plain|; run in fp32, the mode's forward
     is no farther from the plain fp64 forward (max |d|) than MODES_SLACK
     times the plain fp32 forward is, plus MODES_FLOOR (the two fp32
     forwards differ only in the GEMMs' row counts, so in the order of
     their sums). (c)
     ``vl_tasks_forward`` in eval, bf16 (the evaluation CLIs' default), on
     64 flat sequences (32 gen, 32 dis) over 8 images stored compact
     (``img_index``), TASK_LABELS answer labels, at
     ``attention_impl="pallas_block"`` at the default config and then
     with ``fused_co``: 12 B4 and 18 K2 launches a forward, plus 6 B8
     under ``fused_co``; the seven outputs against the same call under
     "xla" on the card: the NSP margins (logit 0 - logit 1) by phase 5's
     rule (max |d margin| <= 0.02 + 0.05 max |margin|); each other output
     by max |d| <= TASK_REL_TOL max |plain| and, where it has a class
     axis (vil_prediction over the labels, img_logits over the region
     classes, mlm_logits over the vocabulary), argmax agreement >=
     TASK_MIN_ARGMAX over its rows; mlm_logits and linguistic_logit are
     compared at the positions inside each sequence's attended extent
     (the rows past it attend nothing, and the kernels and the plain
     softmax fill such rows differently; no row inside reads them), the
     region outputs at the real regions; every padded region's
     vision_logit below -5000. Each run prints its ms (the card
     synchronized), launches and peak memory.
 16. the decoder's generative path (``phase_decoder``): a DeepseekV3Config
     at Kimi-VL-A3B's widths, 3 layers (the dense one, two MoE layers),
     through ``RankingEvaluator`` on 4 slates of 100 options with 345-391
     image tokens: 2 ``grouped_swiglu`` and 2 ``grouped_down`` launches a
     MLP a pass, one ``mla_answer`` a layer of the answer pass and one K3
     (width 2048) a group; its ll_mean against the
     same evaluator with those launches swapped for their plain versions
     on the card (``plain_decoder``): the median |d| within DECODER_D_LL,
     top-1 agreement at least MIN_TOP1_AGREEMENT.
The last lines are the kernels JSON, the card line, and
{"ok": true, "device": {...}}.
"""

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters, warmup=2):
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def within(got, want, atol, rtol, equal_nan=False):
    """(max abs err, max rel err, ok) of got against want, in fp32. Any
    non-finite entry fails, except, under ``equal_nan``, NaN at the same
    places in both (the errors are then those of the other entries)."""
    g, w = got.float(), want.float()
    if equal_nan:
        if not torch.equal(g.isnan(), w.isnan()):
            return float("inf"), float("inf"), False
        keep = ~g.isnan()
        g, w = g[keep], w[keep]
    if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
        return float("inf"), float("inf"), False
    err = (g - w).abs()
    rel = err / w.abs().clamp(min=1e-6)
    ok = bool((err <= atol + rtol * w.abs()).all())
    return float(err.max()), float(rel.max()), ok


def seeded_module(make, gen, dev, std=0.02):
    """A bf16 module from ``make`` with weights drawn from ``gen``: Linear
    weights normal(0, std) and small biases, LayerNorm near (1, 0)."""
    with torch.device(dev):
        mod = make()
    with torch.no_grad():
        for m in mod.modules():
            if isinstance(m, torch.nn.Linear):
                m.weight.normal_(0.0, std, generator=gen)
                m.bias.normal_(0.0, 0.02, generator=gen)
            elif isinstance(m, torch.nn.LayerNorm):
                m.weight.normal_(1.0, 0.1, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
    return mod.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# phase 2: what the compiler made of the kernels
# ---------------------------------------------------------------------------

# the SASS digests, taken with tools/sass_digest, of the instances of the
# attention kernels (seq_attn_fwd_kernel, the backward's seq_attn_bwd_*,
# K1's answer_attn_kernel, the probes' probe_attn_kernel and
# wo_acc_wg_kernel), of the wgmma + TMA core gemm_nt_wg_kernel and of K3's
# xent_wg_kernel, recorded when the probes B10 and B11 moved onto B4's
# design: every instance that is not a probe's has the machine code of
# the record before (B4's and B5's move onto the wgmma core), the first
# design's instances are gone and the probes' are new; the record's
# "sources" says so
SASS_RECORD = "unimm_torch/tools/kernel_sass.json"


def report_spills(pattern, n):
    """ptxas's registers and spills of the n instances of the kernels whose
    name contains pattern; fails unless there are n, none spilling."""
    from unimm_torch.tools import sass_digest

    rows = sass_digest.ptxas_report(pattern)
    for r in rows:
        print(json.dumps({"ptxas": r}), flush=True)
    if len(rows) != n or any(r.get("spill_stores", 1) or
                             r.get("spill_loads", 1) for r in rows):
        raise SystemExit(f"{pattern}: want {n} instances without spills, "
                         f"got {rows}")


def report_kernels():
    """The one-pass forward's and the attention backward's two kernels'
    registers and spills (ptxas: 6 forward instances, B6, B9, B4, B5's
    forward at dropout 0 and above, and the probes' copy of B4's; dq and
    dk / dv for B6, B5 and B5 at dropout 0), their shared memory and CTAs
    an SM at L 256 (the runtime), the Hopper GEMM core's (gemm_wg.cuh:
    gemm_nt_wg_kernel, 2 instances each for K1, K2, B8 and B4, 4 for B5, 3
    for the probes), K1's attention kernel's two instances (whole row
    blocks and 16-row tails, with their shared memory and CTAs an SM), K3's
    logits kernel's and the probes' own kernels' (3 probe_attn_kernel and
    2 wo_acc_wg_kernel instances, with their shared memory and CTAs an
    SM), failing on a spill; then whether each recorded instance kept the
    SASS of SASS_RECORD's build, failing on one that differs under the
    same nvcc, that the instances shared with K1 or B4 have its SASS
    (shared_core_sass), and that the library holds no kernel of
    FIRST_DESIGN."""
    from pathlib import Path

    from unimm_torch.ops import answer_block as k1
    from unimm_torch.ops import attention_block as ab
    from unimm_torch.ops import attention_block_train as abt
    from unimm_torch.ops import attention_v2 as av2
    from unimm_torch.ops import block_probe as bp
    from unimm_torch.ops import text_attention as ta
    from unimm_torch.tools import sass_digest

    # B6's forward, B9, B4, B5's forward twice, and block_probe.cu's copy
    # of B4's (B10 full)
    report_spills("seq_attn_fwd_kernel", 6)
    report_spills("seq_attn_bwd_dq_kernel", 3)
    report_spills("seq_attn_bwd_dkdv_kernel", 3)
    # 16: K1's, K2's, B8's and B4's two each, B5's four (Q/K/V, the
    # output with and without the hidden-dropout mask, dx), the residual
    # instance that xent_head.cu compiles with gemm_wg.cuh's
    # launch_gemm_residual_ln and never launches, and the probes' three
    # (Q/K/V, its feature-major QkvEpiT, the residual)
    report_spills("gemm_nt_wg_kernel", 16)
    report_spills("answer_attn_kernel", 2)
    # K3's ViLBERT instance <768, true> and the decoder's <2048, false>
    report_spills("xent_wg_kernel", 2)
    # the grouped expert GEMM's SwiGLU and scaled-store instances
    report_spills("moe_wg_kernel", 2)
    # the decoder's MLA answer kernel
    report_spills("mla_answer_kernel", 1)
    # the training cross-entropy's recompute, dh and ddecoder instances
    report_spills("xt_wg_kernel", 3)
    # B10's none and noshift, B11's pad128 attention; wo_acc, transposed
    report_spills("probe_attn_kernel", 3)
    report_spills("wo_acc_wg_kernel", 2)
    print(json.dumps({"block_probe_kernels": bp.kernel_info(256)}),
          flush=True)
    print(json.dumps({"answer_attn_kernel": {
        "whole": k1.kernel_info(), "tail": k1.kernel_info(tail=True)}}),
        flush=True)
    print(json.dumps({"seq_attn_fwd_kernel": {
        "text_attention_fwd": ta.fwd_kernel_info(256),
        "attention_v2": av2.kernel_info(256),
        "attention_block": ab.kernel_info(256),
        **{f"attention_block_train_fwd {k}": v
           for k, v in abt.fwd_kernel_info(256).items()}}}), flush=True)
    print(json.dumps({"seq_attn_bwd_kernels": {
        "text_attention_bwd": ta.bwd_kernel_info(256),
        "attention_block_train_bwd": abt.bwd_kernel_info(256)}}),
        flush=True)
    recorded = json.loads((Path(__file__).resolve().parent
                           / SASS_RECORD).read_text())
    current = sass_digest.digests(sass_digest.built_objects())
    nvcc = sass_digest.nvcc_version()
    cmp = sass_digest.compare(recorded["digests"], current)
    print(json.dumps({"kernel_sass": {
        "recorded_nvcc": recorded["nvcc"], "nvcc": nvcc,
        "vs_recorded": cmp}}), flush=True)
    differ = [k for k, v in cmp.items() if v == "differs"]
    if differ and nvcc == recorded["nvcc"]:
        raise SystemExit(f"SASS differs from {SASS_RECORD}: {differ}")
    shared_core_sass(current)
    first = [n for n in sass_digest.kernel_names(sass_digest.built_objects())
             if any(d in n for d in FIRST_DESIGN)]
    if first:
        raise SystemExit(f"the library holds the first design's kernels: "
                         f"{first}")


# the GEMM core's instances that B4, B5 and the probes share with K1: one
# kernel, one epilogue, so one machine code whichever source compiles it
SHARED_CORE = ("QkvEpi", "ResidualEpi")


def shared_core_sass(current):
    """Fail unless attention_block.cu's, attention_block_train.cu's and
    block_probe.cu's gemm_nt_wg_kernel instances of SHARED_CORE's
    epilogues have the SASS digests of answer_block.cu's, and
    block_probe.cu's instance of B4's attention (B10 full) that of
    attention_block.cu."""
    def digest(src, kernel):
        found = [v for k, v in current.items()
                 if k.startswith(f"{src}: ") and kernel in k]
        if len(found) != 1:
            raise SystemExit(f"{src}: {len(found)} {kernel} instances")
        return found[0]
    same = {f"{src} {epi}": digest(src, f"gemm_nt_wg_kernel<<unnamed>::"
                                        f"{epi}>")
            == digest("answer_block.cu", f"gemm_nt_wg_kernel<<unnamed>::"
                                         f"{epi}>")
            for src in ("attention_block.cu", "attention_block_train.cu",
                        "block_probe.cu")
            for epi in SHARED_CORE}
    b4_attn = "seq_attn_fwd_kernel<(int)0, (bool)0>"
    same["block_probe.cu seq_attn_fwd_kernel"] = digest(
        "block_probe.cu", b4_attn) == digest("attention_block.cu", b4_attn)
    print(json.dumps({"gemm_core_shared_with_answer_block": same}),
          flush=True)
    if not all(same.values()):
        raise SystemExit(f"B4 / B5 / B10-B11's shared instances differ from "
                         f"K1's or B4's: {same}")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

# Tolerances, kernel against plain version on the same bf16 inputs. Both
# round at the same points; only the order of fp32 sums differs, which can
# move an intermediate bf16 rounding (q/k/v, probabilities, context, the
# activation) by one step of 2^-8 relative. That reaches the LayerNorm
# output as about one bf16 step of the output's magnitude, so K1 and K2
# hold |d| <= 0.05 + 0.02 |y|. K1's weights have std 0.05 (WIDE_STD), so
# that y reacts to its attention, and its per-head context is held as
# B5's below (B5_CTX_REL of the largest entry): its one-pass attention
# (csrc/answer_block.cu) rounds the unnormalised p~ as B4's does; the
# twin on the context bias at lc - 1, or on the row->row bias shifted by
# one row and key (every option moved by one row), must miss that bound.
# K3 sums 30522 exponentials and takes a log in fp32 on both sides
# (the kernel by 256-column tiles and a combine): |d| <= 2e-3 +
# 1e-4 |nll|; the twin on labels one column on, or without the last vocab
# tile, must miss it.
# B4 (attention_block) and B8 (co_text_block) round at the same points as
# K1 (projections, q scale, probabilities, per-head context, LayerNorm
# output; B4 its probabilities before their normalisation, see the
# one-pass forward below) and differ from their plain versions only in
# fp32 summation order, so they take K1's bound. B4's weights have std
# 0.05 (WIDE_STD, below), so that y reacts to a wrong attention: the twin
# on the descriptors with every mode flipped must miss B4's bound.
# The training block's forward (attention_block_train_fwd) rounds at B4's
# points (plus the same Philox mask on both sides): its output y takes
# B4's bound. Its context ctx (the attention's own output, which the
# backward reads) is held like the backward's outputs below, to
# max |d| <= B5_CTX_REL max |plain|: an absolute bound would be as large as
# a typical context entry. The check draws the block's weights at std
# 0.05 (WIDE_STD), not 0.02: then the scores are O(1), so the softmax is
# far from uniform, and ctx Wo is O(1) against the residual, so y reacts
# to a wrong attention or mask as well. Its backward kernel's bf16
# outputs (dx_qkv, dq, dk, dv) round P, dS and the outputs at the same
# points as the plain twin; fp32 summation order can move a bf16 rounding
# of P or dS by one step, which reaches an output as a fraction of a
# percent of its largest entry: each output is held to
# max |d| <= 2e-2 max |plain| (the atol column; rtol 0). The fused AdamW
# equals its plain twin bit for bit (no FMA contraction on either side).
# The per-head attention kernels (B6 forward and backward, B9) take bf16
# q, k, v straight from the caller (no projection inside) and round where
# their twins do: B6's forward and B9 the probabilities and the output,
# B6's backward only its outputs (its twin keeps P and dS in fp32; the
# kernel carries them as hi + lo bf16 pairs, 2^-17 relative). Only fp32
# summation order differs, which moves a bf16 rounding by one step, 2^-8
# of the entry: each output is held to max |d| <= TA_REL max |plain|
# (the atol column; rtol 0), and the twin on the descriptors with every
# mode flipped must miss that bound. On an H100 (700 W) the first design's
# readings were at most 2.6e-3 (forward), 3.1e-3 (backward) and 2.0e-3
# (B9), the controls at least 0.41. The one-pass forward (B6's forward and
# B9, and since the move of the block kernels onto it B4 and B5's forward)
# rounds each probability once too, at another point: its online softmax
# (csrc/seq_attn_fwd.cuh) rounds the unnormalised p~ = exp(s - running
# max), times the dropout scale under B5's dropout, and divides by the row
# sum of the undropped p~ once, in fp32, where the twins round the
# normalised (and dropped) p. Each term still carries one bf16 rounding of
# its probability (2^-9 relative), so B4's y bound and B5's ctx bound
# (B5_CTX_REL) stand as they were. Its readings on B6 and B9 reach 6.7e-3
# / 7.1e-3, one bf16 step of an output entry in the largest entry's binade
# (at most 2^-7 of the largest entry), controls at least 0.34.
# The bench's probes (B10 probe_block, B11 layout_probe_block) round at
# B4's points and differ from their plain twins only in fp32 summation
# order (wo_acc and transposed also sum Wo head by head, in fp32 on both
# sides): B4's bound. Their weights have std 0.05 (WIDE_STD), so that the
# control misses it: the twin on the flipped descriptors, or, for skip
# (which ignores the mask), the full twin. Under noshift a row whose keys
# are all masked is NaN on both sides; NaN must stand at the same places.
# y hardly sees B10's context under none (p = s 1e-4 puts ~4e-3 into it),
# so B10's context is held too, under full, none and noshift, on open
# descriptors (every row attends every key: the context is a function of
# the scores alone), to TA_REL of its largest entry, as B6's; its control
# is the twin on weights whose Wq and bq are zero (every score 0).
TA_REL = 1e-2
XT_REL = 2e-2   # the training cross-entropy's gradients (check_xent_train)
TOL = {"answer_block": (5e-2, 2e-2), "ffn_block": (5e-2, 2e-2),
       "xent_head": (2e-3, 1e-4), "xent_train_fwd": (2e-3, 1e-4),
       "xent_train_bwd": (XT_REL, 0.0),
       "attention_block": (5e-2, 2e-2),
       "co_text_block": (5e-2, 2e-2),
       "attention_block_train_fwd": (5e-2, 2e-2),
       "attention_block_train_bwd": (2e-2, 0.0),
       "adamw_update_leaf": (0.0, 0.0),
       "text_attention_fwd": (TA_REL, 0.0),
       "text_attention_bwd": (TA_REL, 0.0), "attention_v2": (TA_REL, 0.0),
       "probe_block": (5e-2, 2e-2), "layout_probe_block": (5e-2, 2e-2),
       "grouped_swiglu": (2e-2, 2e-2), "grouped_down": (2e-2, 2e-2),
       "mla_answer": (2e-3, 1e-2)}
B5_CTX_REL = 2e-2
WIDE_STD = 0.05


def real_rows(G, Lcb, RB, gen, O=100):
    """The scorer's packed rows for G slates of O options (ans_len 2-8, so
    2 ans_len rows each, packed by ``prefix.pack_option_rows``): (lc [G],
    opt, rin, A_row [G, P]) on gen's device, the layout
    ``PrefixScorer._answer_impl_packed`` builds its biases from."""
    from unimm_torch.eval import prefix

    dev = gen.device
    rng = np.random.default_rng(int(torch.randint(
        0, 2**31 - 1, (1,), generator=gen, device=dev)))
    lc = rng.integers(2, Lcb + 1, G)
    A = rng.integers(2, 9, (G, O))
    n = 2 * A
    starts, P = prefix.pack_option_rows(n, RB)
    opt = np.full((G, P), O, np.int64)
    rin = np.zeros((G, P), np.int64)
    for g in range(G):
        for o in range(O):
            opt[g, starts[g, o]:starts[g, o] + n[g, o]] = o
            rin[g, starts[g, o]:starts[g, o] + n[g, o]] = np.arange(n[g, o])
    A_row = np.take_along_axis(np.concatenate([A, np.zeros((G, 1), A.dtype)],
                                              1), opt, 1)
    return tuple(torch.from_numpy(a).to(dev) for a in (lc, opt, rin, A_row))


def answer_inputs(dev, gen, Lcb, RB, G, P, real, w=0):
    """K1's case: x, kc, vc, the biases (b_ctx, b_rr), the layer at
    WIDE_STD, and the controls' biases: b_ctx at lc - 1 (the last context
    key closed) and b_rr shifted one row and key down its diagonal (each
    option's rows moved by one). ``real``: the scorer's biases
    (``prefix.answer_biases``) on packed rows of 2-8 token answers, P as
    the packing gives it; ``w``: the scorer's W-layout biases
    (``prefix.w_layout_biases``: 100 options of 1 .. w / 2 tokens, each
    padded to w rows, ``pick_o_blk(100, w)`` options a row block of RB
    rows), P = 100 w; else context keys [1, lc) and random options of
    about 8 rows, causal inside."""
    from unimm_torch.eval import prefix
    from unimm_torch.models import vilbert
    from unimm_torch.ops.masks import NEG_INF

    Hd = 768
    attn = seeded_module(lambda: vilbert._attention(Hd), gen, dev,
                         std=WIDE_STD)
    if w:
        rng = np.random.default_rng(int(torch.randint(
            0, 2**31 - 1, (1,), generator=gen, device=dev)))
        lc = torch.from_numpy(rng.integers(2, Lcb + 1, G)).to(dev)
        A = torch.from_numpy(rng.integers(1, w // 2 + 1, (G, 100))).to(dev)
        P = 100 * w

        def biases(lc_):
            return prefix.w_layout_biases(lc_, A, w, Lcb)
        b_ctx, b_rr = biases(lc)
        if b_rr.shape[-1] != RB:
            raise SystemExit(f"W {w}: row blocks of {b_rr.shape[-1]} rows, "
                             f"not {RB}")
    elif real:
        lc, opt, rin, A_row = real_rows(G, Lcb, RB, gen)
        P = opt.shape[1]

        def biases(lc_):
            return prefix.answer_biases(lc_, opt, rin, A_row, 100, Lcb, RB)
        b_ctx, b_rr = biases(lc)
    else:
        lc = torch.randint(2, Lcb + 1, (G,), generator=gen, device=dev)
        PB = P // RB
        opt = torch.cumsum(torch.rand(G, PB, RB, generator=gen, device=dev)
                           < 0.12, -1)
        r = torch.arange(RB, device=dev)
        open_ = (((opt[..., :, None] == opt[..., None, :])
                  & (r[None, :] <= r[:, None]))
                 | torch.eye(RB, dtype=torch.bool, device=dev))
        b_rr = torch.where(open_, 0.0, NEG_INF).float().contiguous()

        def biases(lc_):
            j = torch.arange(Lcb, device=dev)
            return (torch.where((j >= 1) & (j < lc_[:, None]), 0.0,
                                NEG_INF).float()[:, None, :].contiguous(),
                    b_rr)
        b_ctx, _ = biases(lc)
    x = torch.randn(G, P, Hd, generator=gen, device=dev).to(torch.bfloat16)
    tc = torch.randn(G, Lcb, Hd, generator=gen, device=dev).to(torch.bfloat16)
    kc = vilbert.linear(attn.self.key, tc)
    vc = vilbert.linear(attn.self.value, tc)
    controls = {"lc_minus_1": (biases(lc - 1)[0], b_rr),
                "rr_shift": (b_ctx, torch.roll(b_rr, (1, 1), (-2, -1)))}
    return attn, x, kc, vc, b_ctx, b_rr, controls


def check_answer_block(dev, gen, Lcb, RB, G=40, P=1280, real=False, w=0):
    """K1 against its plain twin at WIDE_STD: y within TOL, the per-head
    context (``return_ctx``) within B5_CTX_REL of its largest entry, both
    bit-equal when rerun; the twin on each control's biases must miss the
    context bound. ``real`` / ``w``: the scorer's packed / W-layout biases
    (``answer_inputs``)."""
    import torch.nn.functional as F
    from unimm_torch.ops.answer_block import (answer_block,
                                              answer_block_plain,
                                              answer_chunk_table)
    from unimm_torch.ops.masks import NEG_INF

    H, D, Hd = 12, 64, 768
    attn, x, kc, vc, b_ctx, b_rr, controls = answer_inputs(
        dev, gen, Lcb, RB, G, P, real, w)
    P = x.shape[1]
    PB = P // RB
    table = answer_chunk_table(b_ctx, b_rr)   # once, as the scorer does

    def kern(ret=False):
        return answer_block(x, kc, vc, b_ctx, b_rr, attn, num_heads=H,
                            table=table, return_ctx=ret)

    def plain(bc=b_ctx, br=b_rr, ret=False):
        return answer_block_plain(x, kc, vc, bc, br, attn, num_heads=H,
                                  return_ctx=ret)

    def library():
        ps, po = attn.self, attn.output
        q = F.linear(x, ps.query.weight, ps.query.bias)
        k = F.linear(x, ps.key.weight, ps.key.bias)
        v = F.linear(x, ps.value.weight, ps.value.bias)

        def blocks(t):
            return t.view(G, PB, RB, H, D).permute(0, 1, 3, 2, 4)

        def ctxh(t):
            return t.view(G, 1, Lcb, H, D).permute(0, 1, 3, 2, 4).expand(
                G, PB, H, Lcb, D)

        keys = torch.cat([ctxh(kc), blocks(k)], 3)
        vals = torch.cat([ctxh(vc), blocks(v)], 3)
        mask = torch.cat([b_ctx[:, None, None].expand(G, PB, 1, RB, Lcb),
                          b_rr[:, :, None]], -1).to(x.dtype)
        o = F.scaled_dot_product_attention(blocks(q), keys, vals,
                                           attn_mask=mask)
        o = o.permute(0, 1, 3, 2, 4).reshape(G, P, Hd)
        h = F.linear(o, po.dense.weight, po.dense.bias) + x
        return F.layer_norm(h, (Hd,), po.LayerNorm.weight,
                            po.LayerNorm.bias, 1e-12)

    got, got_ctx = kern(True)
    again, again_ctx = kern(True)
    want, want_ctx = plain(ret=True)
    torch.cuda.synchronize()
    same = torch.equal(got, again) and torch.equal(got_ctx, again_ctx)
    err, rel, ok = within(got, want, *TOL["answer_block"])
    ctx_rel = rel_err(got_ctx, want_ctx)
    ctrl = {k: rel_err(got_ctx, plain(bc, br, True)[1])
            for k, (bc, br) in controls.items()}
    missed = all(v > B5_CTX_REL for v in ctrl.values())
    if not missed:
        raise SystemExit(f"answer_block: the context check passes a "
                         f"control ({ctrl})")
    # the attention's work is the open (row, key) pairs of this run's
    # biases (a row that attends no key weighs every key)
    M, K = G * P, Lcb + RB
    open_ctx = (b_ctx > NEG_INF).sum(-1).expand(G, P)
    open_rr = (b_rr > NEG_INF).sum(-1).reshape(G, P)
    pairs = open_ctx + open_rr
    pairs = int(torch.where(pairs > 0, pairs, K).sum())
    flops = 8 * M * Hd * Hd + 4 * pairs * Hd
    nbytes = (2 * M * Hd * 2 + 2 * G * Lcb * Hd * 2 + G * Lcb * 4
              + G * PB * RB * RB * 4 + 4 * (Hd * Hd + Hd) * 2 + 2 * Hd * 2)
    b_ms, b_by = bound(flops, nbytes)
    return dict(shape=f"G={G} P={P} Lcb={Lcb} RB={RB}"
                + (" scorer biases" if real else "")
                + (f" W-layout biases W={w}" if w else ""), max_abs_err=err,
                max_rel_err=rel, ctx_rel_err=ctx_rel,
                control_rel_errs=ctrl, bit_equal=same,
                ok=ok and same and ctx_rel <= B5_CTX_REL,
                ms=time_ms(kern, 10), plain_ms=time_ms(plain, 3, 1),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(library, 10))


def zero_k_tile(lin, k0):
    """Linear ``lin`` with the 64 input columns k0 .. k0 + 63 of its weight
    zeroed: one k tile of the kernels' products lost."""
    w = lin.weight.clone()
    w[:, k0:k0 + 64] = 0
    return SimpleNamespace(weight=w, bias=lin.bias)


def drop_last_row(y):
    """y with its last row (a row of the last, partial tile) zeroed: a row
    the kernel did not store."""
    y = y.clone()
    y.view(-1, y.shape[-1])[-1] = 0
    return y


def gemm_controls(name, got, wrongs):
    """Each control output must miss TOL[name]; their max |d|."""
    errs = {}
    for label, wrong in wrongs.items():
        e, _, passes = within(got, wrong, *TOL[name])
        if passes:
            raise SystemExit(f"{name}: the check passes the control "
                             f"{label} ({e})")
        errs[label] = e
    return errs


def check_ffn_block(dev, gen, N=200, R=256, std=0.02, controls=False):
    """K2 against its plain twin, the rerun bit-equal; under ``controls``
    (weights at WIDE_STD) the twin with one k tile of W1 or of W2 zeroed,
    or with the last row dropped, must miss the bound."""
    import torch.nn.functional as F
    from unimm_torch.models import vilbert
    from unimm_torch.ops.ffn_block import ffn_block, ffn_block_plain

    Hd, I = 768, 3072
    layer = seeded_module(lambda: vilbert._layer(Hd, I), gen, dev, std=std)
    pi, po = layer.intermediate, layer.output
    x = torch.randn(N, R, Hd, generator=gen, device=dev).to(torch.bfloat16)

    def kern():
        return ffn_block(x, pi, po, act="gelu")

    def plain():
        return ffn_block_plain(x, pi, po, act="gelu")

    def library():
        h = F.gelu(F.linear(x, pi.dense.weight, pi.dense.bias),
                   approximate="tanh")
        h = F.linear(h, po.dense.weight, po.dense.bias) + x
        return F.layer_norm(h, (Hd,), po.LayerNorm.weight,
                            po.LayerNorm.bias, 1e-12)

    got, want = kern(), plain()
    same = torch.equal(got, kern())
    torch.cuda.synchronize()
    err, rel, ok = within(got, want, *TOL["ffn_block"])
    extra = {}
    if controls:
        extra["control_max_abs_errs"] = gemm_controls("ffn_block", got, {
            "w1_k_tile": ffn_block_plain(
                x, SimpleNamespace(dense=zero_k_tile(pi.dense, 64)), po),
            "w2_k_tile": ffn_block_plain(
                x, pi, SimpleNamespace(dense=zero_k_tile(po.dense, 1536),
                                       LayerNorm=po.LayerNorm)),
            "tail_row": drop_last_row(want)})
    M = N * R
    flops = 4 * M * Hd * I
    nbytes = 2 * M * Hd * 2 + 2 * Hd * I * 2 + (I + 3 * Hd) * 2
    b_ms, b_by = bound(flops, nbytes)
    return dict(shape=f"[{N}, {R}, {Hd}] inter {I}"
                + (f" std {std}" if std != 0.02 else ""), max_abs_err=err,
                max_rel_err=rel, ok=ok and same, bit_equal=same, **extra,
                ms=time_ms(kern, 10), plain_ms=time_ms(plain, 3, 1),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(library, 10))


def check_xent_head(dev, gen, M=25600, V=30522, Hd=768, bias=True):
    """K3 against its plain twin, bit-equal when rerun; the twin with the
    labels one column on, or with the last vocab tile (columns past
    256 (ceil(V / 256) - 1), which hold lab[0]) dropped from the softmax,
    must miss the bound. ``Hd`` 2048 without ``bias``: the decoder's LM
    head (its plain twin on a zero bias)."""
    import torch.nn.functional as F
    from unimm_torch.ops.xent_head import xent_head, xent_head_plain

    h = torch.randn(M, Hd, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(V, Hd, generator=gen, device=dev) * 0.02).to(
        torch.bfloat16)
    b = torch.randn(V, generator=gen, device=dev) * 0.1
    if not bias:
        b.zero_()
    lab = torch.randint(0, V, (M,), generator=gen, device=dev)
    lab[torch.rand(M, generator=gen, device=dev) < 0.5] = -1
    lab[0], lab[1] = V - 1, 0          # the vocab tail and head

    def kern():
        return xent_head(h, w, b if bias else None, lab)

    def plain():
        return xent_head_plain(h, w, b, lab)

    def library():
        return F.cross_entropy(h @ w.t() + b, lab, reduction="none",
                               ignore_index=-1)

    got, want = kern(), plain()
    same = torch.equal(got, kern())
    torch.cuda.synchronize()
    err, rel, ok = within(got, want, *TOL["xent_head"])
    ok = ok and same and bool((got[lab == -1] == 0).all())
    b_drop = b.clone()
    b_drop[(V - 1) // 256 * 256:] = -1e4
    ctrl = gemm_controls("xent_head", got, {
        "labels_shifted": xent_head_plain(
            h, w, b, torch.where(lab == -1, lab, (lab + 1) % V)),
        "last_tile_dropped": xent_head_plain(h, w, b_drop, lab)})
    flops = 2 * M * Hd * V
    nbytes = M * Hd * 2 + V * Hd * 2 + V * 4 + M * 8 + M * 4
    b_ms, b_by = bound(flops, nbytes)
    return dict(shape=f"M={M} V={V}" + ("" if Hd == 768 else
                                         f" width {Hd} no bias"),
                max_abs_err=err, max_rel_err=rel,
                ok=ok, bit_equal=same, control_max_abs_errs=ctrl,
                ms=time_ms(kern, 5), plain_ms=time_ms(plain, 2, 1),
                bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library, 5))


# The grouped expert GEMM (ops/moe.py -> csrc/moe_gemm.cu) against its plain
# version (each expert's rows, fp32 products, the kernel's rounding points)
# on rows routed as the router would send them (k distinct experts a
# token), with expert 0 given no row and expert 1 every token (slot 0):
# the gate / up product with its SwiGLU epilogue, then the down product
# scaled by the router weights, each to TOL, bit-equal when rerun. Controls
# that must miss: one 64-wide k tile of every expert's weights zeroed, the
# last row dropped, the row weights left out (down), and one expert's
# first row run under the expert before it (a tile walk off by one; with
# more than two experts).
def check_moe(dev, gen, T=16384, E=64, k=6, Hd=2048, I=1408, std=0.02):
    import torch.nn.functional as F
    from unimm_torch.ops import moe

    x = torch.randn(T, Hd, generator=gen, device=dev).to(torch.bfloat16)

    def weights(*shape):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(
            torch.bfloat16)

    gate, up, down = weights(E, I, Hd), weights(E, I, Hd), weights(E, Hd, I)
    w13 = moe.interleave_gate_up(gate, up).contiguous()
    if E == 1:
        idx = torch.zeros(T, 1, dtype=torch.long, device=dev)
    else:
        rest = torch.rand(T, E - 2, generator=gen, device=dev).argsort(-1)
        idx = torch.cat([torch.ones(T, 1, dtype=torch.long, device=dev),
                         rest[:, :k - 1] + 2], 1)
    wt = torch.rand(T, k, generator=gen, device=dev)
    order, counts, row_off, tile_off = moe.plan(idx, E)
    a = x.index_select(0, torch.div(order, k, rounding_mode="floor"))
    scale = wt.reshape(-1).index_select(0, order).contiguous()
    M = a.shape[0]

    def up_k():
        return moe.grouped_swiglu(a, w13, row_off, tile_off)

    def up_p():
        return moe.grouped_swiglu_plain(a, w13, row_off)

    h_k, h_p = up_k(), up_p()
    same_h = torch.equal(h_k, up_k())

    def dn_k():
        return moe.grouped_down(h_p, down, row_off, tile_off, scale)

    def dn_p():
        return moe.grouped_down_plain(h_p, down, row_off, scale)

    y_k, y_p = dn_k(), dn_p()
    same_y = torch.equal(y_k, dn_k())
    torch.cuda.synchronize()
    shifted = row_off.clone()
    shifted[min(3, E)] += 1            # expert 3's first row under expert 2
    zk13 = w13.clone()
    zk13[..., 64:128] = 0
    zk2 = down.clone()
    zk2[..., 64:128] = 0

    def library_up():
        return torch.cat([F.silu(a[r0:r1] @ gate[e].t()) * (a[r0:r1]
                                                            @ up[e].t())
                          for e, (r0, r1) in enumerate(zip(
                              row_off.tolist()[:-1], row_off.tolist()[1:]))
                          if r1 > r0])

    out = {}
    for name, got, want, ctrl, same, kern, plain, n_out, kk, lib in (
            ("grouped_swiglu", h_k, h_p, {
                "k_tile": moe.grouped_swiglu_plain(a, zk13, row_off),
                "tail_row": drop_last_row(h_p),
                **({"walk_off_by_one": moe.grouped_swiglu_plain(
                    a, w13, shifted)} if E > 2 else {})},
             same_h, up_k, up_p, 2 * I, Hd, library_up),
            ("grouped_down", y_k, y_p, {
                "k_tile": moe.grouped_down_plain(h_p, zk2, row_off, scale),
                "tail_row": drop_last_row(y_p),
                "no_row_weights": moe.grouped_down_plain(h_p, down,
                                                         row_off)},
             same_y, dn_k, dn_p, Hd, I, None)):
        err, rel, ok = within(got, want, *TOL[name])
        flops = 2 * M * n_out * kk
        nbytes = M * kk * 2 + E * n_out * kk * 2 + M * got.shape[1] * 2
        b_ms, b_by = bound(flops, nbytes)
        out[name] = [dict(
            shape=f"{T} tokens x {k} over {E} experts ({M} rows), N "
                  f"{n_out} K {kk}; expert rows {int(counts.min())}-"
                  f"{int(counts.max())}",
            max_abs_err=err, max_rel_err=rel, ok=ok and same,
            bit_equal=same,
            control_max_abs_errs=gemm_controls(name, got, ctrl),
            ms=time_ms(kern, 10), plain_ms=time_ms(plain, 2, 1),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lib, 3) if lib is not None else None)]
    return out


def moe_cases(dev, gen):
    """Phase 3's cases of the grouped expert GEMM: the routed experts at
    16384 tokens and at the cell's 40960 tokens a pass (245760 rows, ~3.8k
    an expert), the shared experts at the cell's 40960 rows as one group
    (N 5632 / K 2048 up, N 2048 / K 2816 down), a dense layer's MLP as one
    group (N 22528, K 11264 in the down product) and 129 tokens (partial
    tiles, most experts 0-20 rows)."""
    cases = check_moe(dev, gen)
    for extra in (check_moe(dev, gen, T=40960),
                  check_moe(dev, gen, T=40960, E=1, k=1, I=2816),
                  check_moe(dev, gen, T=2048, E=1, k=1, I=11264),
                  check_moe(dev, gen, T=129)):
        for name, cs in extra.items():
            cases[name] += cs
    return cases


# The decoder's MLA answer kernel (ops/mla_answer.py -> csrc/mla_answer.cu)
# against its plain version (each slate's fp32 scores, an fp32 softmax, p
# rounded to bf16 for the product with v, the output rounded once) at the
# cell's shapes: G slates of 100 options of 2-8 input rows, contexts of
# 369-629 positions (Lcb 640), 16 heads, queries and latents normal(0,
# 0.3) (scores of std ~2), the cache's padding positions too. The kernel
# rounds p at its running maximum, the plain version at the final one: a
# step of bf16 in p, and one of the output either side, so 2e-3 + 1e-2
# |plain| (outputs up to ~0.5). Bit-equal when rerun; controls that must
# miss: the first key tile dropped, each slate's second option's first row
# moved into its first option, n_ctx one on (the key at n_ctx, past the
# context). Timed beside it: the padded plain chain the kernel replaced.
def check_mla_answer(dev, gen, G=80, O=100, nh=16, Lcb=640, std=0.3):
    from unimm_torch.ops import mla_answer as mla_ops

    rng = np.random.default_rng(int(torch.randint(
        0, 2**31 - 1, (1,), generator=gen, device=dev)))
    n_rows = rng.integers(2, 9, (G, O))
    n_ctx = rng.integers(345, 392, G) + rng.integers(24, 239, G)
    arrays, cnt = mla_ops.plan(n_rows, n_ctx, nh)
    N, C, R = cnt["rows_needed"], mla_ops.LATENT, mla_ops.VALUE

    def rnd(*shape):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(
            torch.bfloat16)

    qf, cache, kr = rnd(N, nh, C), rnd(G, Lcb, C), rnd(N, C)

    def rows_of(a):
        return mla_ops.AnswerRows.put(a, dev)

    rows = rows_of(arrays)

    def kern():
        return mla_ops.mla_answer(qf, cache, kr, rows, R)

    def plain():
        return mla_ops.mla_answer_plain(qf, cache, kr, rows, R)

    got, want = kern(), plain()
    same = torch.equal(got, kern())
    torch.cuda.synchronize()
    # the controls' metadata
    moved = dict(arrays, first=arrays["first"].copy())
    opt_first = (np.cumsum(n_rows) - n_rows.ravel()).reshape(G, O)
    for g in range(G):
        f0, f1, k1 = opt_first[g, 0], opt_first[g, 1], n_rows[g, 1]
        moved["first"][f1] = f0
        moved["first"][f1 + 1:f1 + k1] = f1 + 1
    wrongs = {
        "key_tile_dropped": mla_ops.mla_answer_plain(
            qf, torch.cat([cache[:, 64:], cache[:, :64]], 1).contiguous(),
            kr, rows_of(dict(arrays, n_ctx=arrays["n_ctx"] - 64)), R),
        "option_boundary_moved": mla_ops.mla_answer_plain(
            qf, cache, kr, rows_of(moved), R),
        "n_ctx_one_on": mla_ops.mla_answer_plain(
            qf, cache, kr, rows_of(dict(arrays, n_ctx=arrays["n_ctx"] + 1)),
            R)}
    chain = padded_chain(qf, cache, kr, n_rows, n_ctx)
    err, rel, ok = within(got, want, *TOL["mla_answer"])
    flops = 2 * (C + R) * nh * cnt["pairs_needed"]
    nbytes = 2 * (N * nh * (C + R) + int(n_ctx.sum()) * C + N * C)
    b_ms, b_by = bound(flops, nbytes)
    # what the row tiles read from L2: the query tile, the cache tiles and
    # the own tile, 64 x C bf16 each
    l2 = 2 * C * 64 * int((2 + -(-n_ctx[arrays["tiles"][:, 0]] // 64)).sum())
    return dict(
        shape=f"{G} slates, Lcb {Lcb}, {N} rows x {nh} heads, n_ctx "
              f"{int(n_ctx.min())}-{int(n_ctx.max())}; pairs real / "
              f"launched {cnt['pairs_needed']} / {cnt['pairs_launched']}; "
              f"L2 reads {l2 / 1e9:.2f} GB",
        max_abs_err=err, max_rel_err=rel, ok=ok and same, bit_equal=same,
        control_max_abs_errs=gemm_controls("mla_answer", got, wrongs),
        ms=time_ms(kern, 10), plain_ms=time_ms(plain, 1, 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(chain, 3, 1),
        chain_max_abs_err=within(chain(), want, *TOL["mla_answer"])[0])


def padded_chain(qf, cache, kr, n_rows, n_ctx, rb=64, chunk=1 << 29):
    """The absorbed attention as the main path ran it before the kernel, on
    the same inputs (a yardstick: nothing else calls it): each slate's rows
    bin-packed into rb-row blocks (``prefix.pack_option_rows``), every
    head's query scattered into that padded layout, bf16 scores of each
    slate's padded rows against its whole padded cache and of each block
    against its own rows, a masked fill from a stored mask, a softmax and
    the two products with the keys' c_kv, slates in chunks of at most
    ``chunk`` scores, the real rows gathered back. Returns a closure that
    runs one layer's chain (the layout and the mask, built once a group,
    outside it)."""
    from unimm_torch.eval.prefix import pack_option_rows

    dev = qf.device
    G, O = n_rows.shape
    N, nh, C = qf.shape
    Lc, R = cache.shape[1], 512
    starts, P = pack_option_rows(n_rows, rb)
    n = n_rows.ravel()
    sid = np.repeat(np.repeat(np.arange(G), O), n)
    oid = np.repeat(np.tile(np.arange(O), G), n)
    rin = np.arange(N) - np.repeat(np.cumsum(n) - n, n)
    slot = sid * P + starts.ravel()[sid * O + oid] + rin
    opt_p = np.full(G * P, O, np.int64)
    rin_p = np.zeros(G * P, np.int64)
    opt_p[slot] = oid
    rin_p[slot] = rin
    slots = torch.from_numpy(slot).to(dev)
    o_ = torch.from_numpy(opt_p).to(dev).view(G, P // rb, rb)
    i_ = torch.from_numpy(rin_p).to(dev).view(G, P // rb, rb)
    rr = ((o_[..., :, None] == o_[..., None, :])
          & (i_[..., None, :] <= i_[..., :, None]))
    rr |= torch.eye(rb, dtype=torch.bool, device=dev)
    ctx = (torch.arange(Lc, device=dev)[None, :]
           < torch.from_numpy(n_ctx).to(dev)[:, None])
    closed = ~torch.cat([ctx[:, None, None, :].expand(G, P // rb, rb, Lc),
                         rr], -1).view(G * P // rb, rb, 1, Lc + rb)
    PB, K = P // rb, Lc + rb

    def run():
        qp = qf.new_zeros(G * P, nh, C).index_copy_(0, slots, qf)
        krp = qf.new_zeros(G * P, C).index_copy_(0, slots, kr)
        o = qf.new_empty(G, P * nh, R)
        step = max(1, chunk // (P * nh * K))
        for g0 in range(0, G, step):
            g1 = min(G, g0 + step)
            m, b0, b1 = g1 - g0, g0 * PB, g1 * PB
            s = qf.new_empty(m * P * nh, K)
            torch.bmm(qp[g0 * P:g1 * P].view(m, P * nh, C),
                      cache[g0:g1].transpose(1, 2),
                      out=s.view(m, P * nh, K)[..., :Lc])
            torch.bmm(qp[g0 * P:g1 * P].view(m * PB, rb * nh, C),
                      krp[g0 * P:g1 * P].view(m * PB, rb, C).transpose(1, 2),
                      out=s.view(m * PB, rb * nh, K)[..., Lc:])
            s.view(m * PB, rb, nh, K).masked_fill_(closed[b0:b1],
                                                   float("-inf"))
            p = torch.softmax(s, -1)
            torch.bmm(p.view(m, P * nh, K)[..., :Lc], cache[g0:g1, :, :R],
                      out=o[g0:g1])
            o[g0:g1].view(m * PB, rb * nh, R).baddbmm_(
                p.view(m * PB, rb * nh, K)[..., Lc:],
                krp[g0 * P:g1 * P].view(m * PB, rb, C)[..., :R])
        return o.view(G * P, nh, R).index_select(0, slots)

    return run


# The training cross-entropy (xent_train) against the plain scan of
# ops/losses._OnlineXent on the same bf16 inputs: nll and lse take K3's
# bound (the same logits kernel and combine). Its gradients round dlogits
# to bf16 on both sides (the kernel from ex2, the scan from exp: a rounding
# may move by one step, 2^-8 of the entry) and the kernel rounds dh and
# ddecoder once more, 2^-9: each gradient is held to max |d| <= XT_REL
# max |plain| (the atol column; rtol 0), as B5's backward outputs. That
# bound is set by the one-hot term (-gf at the label), so the softmax term
# (gf p) is held on its own too: every row of dh (where gf != 0) and of
# ddecoder to XT_REL of that row's largest entry, and dbias on the vocab
# columns that no label hits (the softmax term alone) to XT_REL of their
# largest. The hidden rows peak the softmax as a trained head does, so
# that the softmax term weighs in dh as much as the one-hot term.
# Controls that must miss: the scan on labels one column on (the one-hot
# term moves), the scan without the last vocab tile, as a kernel that
# skipped it would return (its columns of ddecoder and dbias 0, their part
# of dhidden lost; a likelihood row's label is V - 1), each on nll and
# every gradient; and the gradients of the one-hot term alone (d = -gf
# onehot, a kernel that lost the softmax term) on every gradient.


def xent_train_case(gen, B, P, V, L=256):
    """The cross-entropy's inputs as the training step gives them: 10-39
    labels a sequence of L at random places, gathered to P slots by
    ``unimm.label_positions`` (the slots past a sequence's labels hold -1),
    the first quarter of the sequences unlikelihood (weight -1), the rest
    likelihood; the bf16 decoder at std 0.02, an fp32 bias, and hidden
    rows h = c W[t] / |W[t]|^2 + N(0, 1) that peak the softmax at a token t
    (the row's label for half of the labelled rows, else one drawn at
    random): logit c in [4, 12] over noise of std ~0.55, so t takes 0.2%
    to 85% of the row's probability. Returns (h [B P, 768], w, b,
    labels [B P], weights [B P], the loss's denominator)."""
    from unimm_torch.models.unimm import label_positions

    dev = gen.device
    n = torch.randint(10, 40, (B,), generator=gen, device=dev)
    rank = torch.rand(B, L, generator=gen, device=dev).argsort(-1).argsort(-1)
    mlm = torch.where(rank < n[:, None],
                      torch.randint(0, V, (B, L), generator=gen, device=dev),
                      -1)
    _, labs = label_positions(mlm, P)
    wt = torch.where(torch.arange(B, device=dev)[:, None] < B // 4, -1.0,
                     1.0).expand(B, P)
    wt = torch.where(labs == -1, 0.0, wt).reshape(-1)
    lab = labs.reshape(-1).clone()
    r0 = (B // 4) * P                  # the first likelihood sequence's
    lab[r0], lab[r0 + 1] = V - 1, 0    # the vocab tail and head
    M = B * P
    w = (torch.randn(V, 768, generator=gen, device=dev) * 0.02).to(
        torch.bfloat16)
    hit = torch.rand(M, generator=gen, device=dev) < 0.5
    peak = torch.where(hit & (lab != -1), lab,
                       torch.randint(0, V, (M,), generator=gen, device=dev))
    wp = w[peak].float()
    c = 4 + 8 * torch.rand(M, 1, generator=gen, device=dev)
    h = (c * wp / (wp * wp).sum(-1, keepdim=True)
         + torch.randn(M, 768, generator=gen, device=dev)).to(torch.bfloat16)
    b = torch.randn(V, generator=gen, device=dev) * 0.1
    return h, w, b, lab, wt, (wt != 0).float().sum()


def xent_upstream(nll, lab, wt, num):
    """d loss / d nll of ``masked_lm_ul_loss_gathered`` (likelihood rows
    w / num, unlikelihood rows the derivative of -log(1 - exp(-nll)) /
    num), 0 where the label is -1: _OnlineXent's gf."""
    from unimm_torch.ops import losses

    with torch.enable_grad():
        x = nll.detach().float().requires_grad_()
        g, = torch.autograd.grad(
            losses.masked_lm_ul_loss_gathered(x, lab, wt, num), x)
    return g * (lab != -1).float()


def check_xent_train(dev, gen, B=240, P=160, V=30522):
    """xent_train's forward and backward against the plain scan, bit-equal
    when rerun, each control missing on every output it moves. Returns
    (the forward's case, the backward's case)."""
    import torch.nn.functional as F
    from unimm_torch.ops import losses
    from unimm_torch.ops import xent_train as xt

    h, w, b, lab, wt, num = xent_train_case(gen, B, P, V)
    lab32 = lab.to(torch.int32)
    M, Hd, ch = h.shape[0], h.shape[1], 7680

    def plain(lab_=lab, w_=w, b_=b):
        lse, t = losses._xent_stats(h.float(), w_, b_, lab_, ch)
        return losses._nll(lse, t, lab_), lse

    nll_p, lse_p = plain()
    gf = xent_upstream(nll_p, lab, wt, num)

    def fwd():
        return xt.xent_train_fwd(h, w, b, lab32)

    def bwd():
        return xt.xent_train_bwd(h, w, b, lab32, fwd_out[1], gf)

    def plain_bwd(lab_=lab, w_=w, b_=b):
        return losses._xent_grads(h, w_, b_, lab_, lse_p, gf, ch)

    def onehot_only():
        # the gradients of d = -gf onehot: the softmax term left out
        g = -gf
        idx = lab.clamp(min=0)
        return (g[:, None] * w.float()[idx],
                torch.zeros(V, Hd, device=dev).index_add_(
                    0, idx, g[:, None] * h.float()),
                torch.zeros(V, device=dev).index_add_(0, idx, g))

    with torch.enable_grad():
        hh, ww, bb = (t.detach().requires_grad_() for t in (h, w, b))

        def library():
            return F.cross_entropy((hh @ ww.t()).float() + bb, lab,
                                   reduction="none", ignore_index=-1)

        nll_lib = library()

    names = ("nll", "lse", "dh", "dw", "db")
    fwd_out = fwd()
    got = (*fwd_out, *bwd())
    again = (*fwd(), *bwd())
    same_f, same_b = (all(torch.equal(x, y) for x, y in zip(got[k], again[k]))
                      for k in (slice(0, 2), slice(2, 5)))
    want = (nll_p, lse_p, *plain_bwd())
    torch.cuda.synchronize()
    live = gf != 0                     # the rows with a gradient
    free = torch.bincount(lab[lab >= 0], minlength=V) == 0

    def rel(g_, r):
        return float((g_.float() - r.float()).abs().max()
                     / r.float().abs().max())

    def row_rel(g_, r):
        # the worst row, held against that row's largest entry
        r = r.float()
        return float(((g_.float() - r).abs().amax(-1)
                      / r.abs().amax(-1)).max())

    def errs(ref):
        """{output: (its errors, whether all hold)}"""
        out = {}
        for name, g_, r in zip(names, got, ref):
            if name in ("nll", "lse"):
                e, _, ok_ = within(g_, r, *TOL["xent_train_fwd"])
                out[name] = ({name: e}, ok_)
                continue
            e = {name: rel(g_, r)}
            if name == "dh":
                e["dh_rows"] = row_rel(g_[live], r[live])
            elif name == "dw":
                e["dw_rows"] = row_rel(g_, r)
            else:
                e["db_free"] = rel(g_[free], r[free])
            out[name] = (e, bool(torch.isfinite(g_.float()).all())
                         and all(v <= XT_REL for v in e.values()))
        return out

    res = errs(want)
    ok_f = (res["nll"][1] and res["lse"][1] and same_f
            and bool((got[0][lab == -1] == 0).all()))
    ok_b = all(res[k][1] for k in ("dh", "dw", "db")) and same_b
    shifted = torch.where(lab == -1, lab, (lab + 1) % V)
    cut = (V - 1) // 256 * 256
    b_drop = b.clone()
    b_drop[cut:] = -1e4
    g_cut = plain_bwd(torch.where(lab >= cut, -1, lab), w[:cut], b[:cut])
    zeros = torch.zeros(V - cut, Hd, device=dev)
    grads = ("dh", "dw", "db")
    # (the control's outputs, the outputs it must miss on): lse hardly
    # sees the labels, or one of 120 tiles; nll carries them
    controls = {
        "labels_shifted": ((*plain(shifted), *plain_bwd(shifted)),
                           ("nll",) + grads),
        "last_tile_dropped": ((
            *plain(lab, w, b_drop), g_cut[0],
            torch.cat([g_cut[1], zeros]),
            torch.cat([g_cut[2], torch.zeros(V - cut, device=dev)])),
            ("nll",) + grads),
        "softmax_dropped": ((nll_p, lse_p, *onehot_only()), grads)}
    ctrl = {}
    for label, (outs, must) in controls.items():
        r = errs(outs)
        if any(r[k][1] for k in must):
            seen = {k: r[k] for k in must}
            raise SystemExit(f"xent_train: the check passes the control "
                             f"{label}: {seen}")
        ctrl[label] = {n: e for k in must for n, e in r[k][0].items()}
    # inputs read once, outputs written once (dl, the backward's own
    # intermediate, not counted)
    flops = 2 * M * Hd * V
    nbytes = M * Hd * 2 + V * Hd * 2 + V * 4 + M * 4
    f_ms, f_by = bound(flops, nbytes + M * 8)
    b_ms, b_by = bound(3 * flops, 2 * nbytes + M * 8)
    shape = f"M={M} (B={B} P={P}) V={V}"
    fwd_case = dict(
        shape=shape, max_abs_err=res["nll"][0]["nll"],
        lse_max_abs_err=res["lse"][0]["lse"], ok=ok_f, bit_equal=same_f,
        control_max_errs={k: {"nll": v["nll"]} for k, v in ctrl.items()
                          if "nll" in v},
        ms=time_ms(fwd, 5), plain_ms=time_ms(plain, 2, 1),
        bound_ms=f_ms, bound_by=f_by)
    rel_errs = {n: e for k in grads for n, e in res[k][0].items()}
    with torch.enable_grad():
        fwd_case["library_ms"] = time_ms(library, 3, 1)
        lib_bwd = time_ms(lambda: torch.autograd.backward(
            nll_lib, gf, retain_graph=True), 3, 1)
    del nll_lib
    bwd_case = dict(
        shape=shape, max_abs_err=max(rel_errs.values()), rel_errs=rel_errs,
        ok=ok_b, bit_equal=same_b,
        control_max_errs={k: {n: e for n, e in v.items() if n != "nll"}
                          for k, v in ctrl.items()},
        ms=time_ms(bwd, 5), plain_ms=time_ms(plain_bwd, 2, 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_bwd)
    return fwd_case, bwd_case


def xent_train_cases(dev, gen):
    """Phase 3's cases of xent_train_fwd and xent_train_bwd: the training
    step's shape, a data-parallel rank's (B 60), and a ragged one (129
    rows, a vocabulary of 5000: partial row and vocab tiles)."""
    cs = [check_xent_train(dev, gen),
          check_xent_train(dev, gen, B=60),
          check_xent_train(dev, gen, B=3, P=43, V=5000)]
    return {"xent_train_fwd": [f for f, _ in cs],
            "xent_train_bwd": [b_ for _, b_ in cs]}

def dis_desc(B, L, gen):
    """Discriminative descriptors of the flat path's bucket L: real
    lengths in (L - 32, L], as the length buckets give them."""
    n = torch.randint(max(1, L - 31), L + 1, (B,), generator=gen,
                      device=gen.device)
    z = torch.zeros_like(n)
    return torch.stack([z, n, z], -1).to(torch.int32)


def edge_desc(B, L, gen):
    """Mixed descriptors: dis at full length, dis with fully masked rows
    past a short extent, gen, gen whose masked copy is truncated at L
    (ctx_end + ans_len > L), and gen with a one-token context."""
    rows = []
    for i in range(B):
        a = int(torch.randint(3, 9, (1,), generator=gen, device=gen.device))
        rows.append([(0, L, 0), (0, max(1, L // 4), 0), (1, L // 2, a),
                     (1, L - a + 2, a), (1, 5, 4)][i % 5])
    return torch.tensor(rows, dtype=torch.int32, device=gen.device)


def tail_desc(B, L, gen):
    """Discriminative descriptors with long fully masked tails: ctx_end in
    [1, min(64, L)], so the first rows attend keys of the first chunk only
    (the later chunks are closed for them) and the rows past ctx_end attend
    no key (and weigh every key); a 16-row tile can hold both."""
    n = torch.randint(1, min(64, L) + 1, (B,), generator=gen,
                      device=gen.device)
    z = torch.zeros_like(n)
    return torch.stack([z, n, z], -1).to(torch.int32)


def library_block(attn, x, mask, H=12):
    """B4's function as a chain of PyTorch calls: F.linear x 3,
    scaled_dot_product_attention with the additive mask [B, 1, L, L],
    F.linear, the residual and F.layer_norm."""
    import torch.nn.functional as F
    B, L, Hd = x.shape
    ps, po = attn.self, attn.output

    def heads(t):
        return t.view(B, L, H, Hd // H).transpose(1, 2)

    q = heads(F.linear(x, ps.query.weight, ps.query.bias))
    k = heads(F.linear(x, ps.key.weight, ps.key.bias))
    v = heads(F.linear(x, ps.value.weight, ps.value.bias))
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    o = o.transpose(1, 2).reshape(B, L, Hd)
    h = F.linear(o, po.dense.weight, po.dense.bias) + x
    return F.layer_norm(h, (Hd,), po.LayerNorm.weight, po.LayerNorm.bias,
                        1e-12)


# the first design's kernels (the mma.sync GEMM core, its output
# projection + LayerNorm and the two-pass attention), which no source
# defines any more: phase 2 fails if the library holds one, core_launches
# if a call launches one
FIRST_DESIGN = ("gemm_nt_kernel", "out_ln_kernel", "seq_attn_kernel")


def core_launches(name, fn):
    """{kernel: mean device ms a call} of each kernel one ``fn()`` call
    launches (tools/bench_bwd.sub_kernels: torch.profiler over 5 calls),
    the names without their namespaces and arguments; fails if one is of
    FIRST_DESIGN."""
    from unimm_torch.tools.bench_bwd import sub_kernels
    out = {}
    for k, ms in sub_kernels(fn).items():
        k = re.sub(r"^void |\(anonymous namespace\)::", "", k).split("(")[0]
        out[k] = out.get(k, 0.0) + ms
    if any(d in k for k in out for d in FIRST_DESIGN):
        raise SystemExit(f"{name}: launches the first design: {out}")
    return out


def check_attention_block(dev, gen, L, desc_fn, B=256, split=False):
    """B4 against its plain twin on the same bf16 inputs, weights at
    WIDE_STD, and bit-equal when rerun. The control, the twin on the
    flipped descriptors, must miss the same bound. ``split``: each
    kernel's time a call too (core_launches)."""
    from unimm_torch.models import vilbert
    from unimm_torch.ops.attention_block import (attention_block,
                                                 attention_block_plain)
    from unimm_torch.ops.masks import mask_bias

    H, Hd = 12, 768
    attn = seeded_module(lambda: vilbert._attention(Hd), gen, dev,
                         std=WIDE_STD)
    x = torch.randn(B, L, Hd, generator=gen, device=dev).to(torch.bfloat16)
    desc = desc_fn(B, L, gen)
    # the library call takes the additive mask built beforehand
    mask = mask_bias(desc, L)[:, None].to(x.dtype)

    def kern():
        return attention_block(x, desc, attn, num_heads=H)

    def plain():
        return attention_block_plain(x, desc, attn, num_heads=H)

    def library():
        return library_block(attn, x, mask, H)

    got, want = kern(), plain()
    same = torch.equal(got, kern())
    torch.cuda.synchronize()
    err, rel, ok = within(got, want, *TOL["attention_block"])
    wrong = attention_block_plain(x, flip_mode(desc), attn, num_heads=H)
    c_err, _, c_ok = within(got, wrong, *TOL["attention_block"])
    del wrong
    if c_ok:
        raise SystemExit(f"attention_block: the check passes the flipped "
                         f"descriptors ({c_err})")
    M = B * L
    flops = 8 * M * Hd * Hd + 4 * B * L * L * Hd
    nbytes = 2 * M * Hd * 2 + B * 3 * 4 + (4 * (Hd * Hd + Hd) + 2 * Hd) * 2
    b_ms, b_by = bound(flops, nbytes)
    extra = {"launch_ms": core_launches("attention_block", kern)} \
        if split else {}
    return dict(shape=f"[{B}, {L}, {Hd}] {desc_fn.__name__}",
                max_abs_err=err, max_rel_err=rel, ok=ok and same,
                bit_equal=same, control_max_abs_err=c_err,
                ms=time_ms(kern, 10), **extra,
                plain_ms=time_ms(plain, 3, 1), bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(library, 10))


def check_co_text_block(dev, gen, B=256, L=224, R=37, std=0.02,
                        controls=False):
    """B8 against its plain twin, every region of one sequence masked, the
    rerun bit-equal; under ``controls`` (weights at WIDE_STD) the twin with
    one k tile of Wd2 zeroed, or with the last row dropped, must miss the
    bound."""
    import torch.nn.functional as F
    from unimm_torch.config import VilbertConfig
    from unimm_torch.models import vilbert
    from unimm_torch.ops.co_text_block import (co_text_block,
                                               co_text_block_plain)
    from unimm_torch.ops.masks import NEG_INF

    H, D, Ht, Bi = 8, 128, 768, 1024
    conn = seeded_module(lambda: vilbert._connection(VilbertConfig()), gen,
                         dev, std=std)
    t_x = torch.randn(B, L, Ht, generator=gen, device=dev).to(torch.bfloat16)
    v_x = torch.randn(B, R, Bi, generator=gen, device=dev).to(torch.bfloat16)
    im = (torch.rand(B, R, generator=gen, device=dev) > 0.2).float()
    im[min(3, B - 1)] = 0.0            # one sequence with every region masked
    mask = torch.where(im > 0, 0.0, NEG_INF)[:, None, None].to(t_x.dtype)

    def kern():
        return co_text_block(t_x, v_x, im, conn, num_heads=H)

    def plain():
        return co_text_block_plain(t_x, v_x, im, conn, num_heads=H)

    def library():
        pb, po = conn.biattention, conn.biOutput

        def heads(t, n):
            return t.view(B, n, H, D).transpose(1, 2)

        q = heads(F.linear(t_x, pb.query2.weight, pb.query2.bias), L)
        k = heads(F.linear(v_x, pb.key1.weight, pb.key1.bias), R)
        v = heads(F.linear(v_x, pb.value1.weight, pb.value1.bias), R)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        o = o.transpose(1, 2).reshape(B, L, Bi)
        h = F.linear(o, po.dense2.weight, po.dense2.bias) + t_x
        return F.layer_norm(h, (Ht,), po.LayerNorm2.weight,
                            po.LayerNorm2.bias, 1e-12)

    got, want = kern(), plain()
    same = torch.equal(got, kern())
    torch.cuda.synchronize()
    err, rel, ok = within(got, want, *TOL["co_text_block"])
    extra = {}
    if controls:
        po = conn.biOutput
        wrong_conn = SimpleNamespace(
            biattention=conn.biattention,
            biOutput=SimpleNamespace(dense2=zero_k_tile(po.dense2, 512),
                                     LayerNorm2=po.LayerNorm2))
        extra["control_max_abs_errs"] = gemm_controls("co_text_block", got, {
            "wd2_k_tile": co_text_block_plain(t_x, v_x, im, wrong_conn,
                                              num_heads=H),
            "tail_row": drop_last_row(want)})
    M = B * L
    flops = (2 * M * Ht * Bi + 4 * B * R * Bi * Bi + 4 * M * R * Bi
             + 2 * M * Bi * Ht)
    nbytes = (2 * M * Ht * 2 + B * R * Bi * 2 + B * R * 4
              + (Bi * Ht + 2 * Bi * Bi + Ht * Bi + 3 * Bi + 3 * Ht) * 2)
    b_ms, b_by = bound(flops, nbytes)
    return dict(shape=f"[{B}, {L}, {Ht}] x [{B}, {R}, {Bi}]"
                + (f" std {std}" if std != 0.02 else ""),
                max_abs_err=err, max_rel_err=rel, ok=ok and same,
                bit_equal=same, **extra,
                ms=time_ms(kern, 10), plain_ms=time_ms(plain, 3, 1),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(library, 10))


def train_desc(B, L, gen):
    """The training batch's descriptors (workload.make_train_batch): mode
    0 or 1, ctx_end 60-199, ans_len 2-8; with L < 256 they are scaled
    into the length."""
    mode = torch.randint(0, 2, (B,), generator=gen, device=gen.device)
    ce = torch.randint(60, 200, (B,), generator=gen, device=gen.device)
    al = torch.randint(2, 9, (B,), generator=gen, device=gen.device)
    ce = torch.clamp(ce * L // 256, min=al + 2)
    return torch.stack([mode, ce, al * mode], -1).to(torch.int32)


def rel_err(got, want):
    """max |got - want| / max |want| in fp32 (inf if not finite)."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        return float("inf")
    return float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))


def check_attention_block_train(dev, gen, B, L, desc_fn, drop=0.1,
                                split=False):
    """B5's forward and backward kernels against their plain twins on the
    same bf16 inputs, Philox seed and hidden-dropout mask: two result
    dicts (forward, backward). The controls hold the kernels' outputs
    against the plain twins under another Philox seed: that must fail both
    forward bounds and the backward's bound for each output, or the check
    could not see a wrong mask. Each kernel run again on the same inputs
    must give the same bits. ``split``: each kernel's time a call too
    (core_launches)."""
    import torch.nn.functional as F
    from unimm_torch.models import vilbert
    from unimm_torch.ops import attention_block_train as abt
    from unimm_torch.ops.answer_block import _weights
    from unimm_torch.ops.masks import mask_bias

    H, D, Hd = 12, 64, 768
    attn = seeded_module(lambda: vilbert._attention(Hd), gen, dev,
                         std=WIDE_STD)
    ws = _weights(attn)
    x = torch.randn(B, L, Hd, generator=gen, device=dev).to(torch.bfloat16)
    desc = desc_fn(B, L, gen)
    m_o = (torch.rand(B, L, Hd, generator=gen, device=dev) >= drop).float()
    m_o /= 1.0 - drop
    dctx = torch.randn(B, L, Hd, generator=gen, device=dev).to(
        torch.bfloat16)
    kw = dict(num_heads=H, attn_drop=drop)
    seed = 1234

    def fwd():
        return abt.attention_block_train_fwd(x, desc, seed, m_o, *ws, **kw)

    def fwd_plain():
        return abt.attention_block_train_fwd_plain(x, desc, seed, m_o, *ws,
                                                   **kw)

    def bwd():
        return abt.attention_block_train_bwd(x, dctx, desc, seed, *ws[:6],
                                             **kw)

    def bwd_plain_seed(sd):
        return abt.attention_block_train_bwd_plain(x, dctx, desc, sd,
                                                   *ws[:6], **kw)

    def bwd_plain():
        return bwd_plain_seed(seed)

    # the library chain: F.linear x 3 + scaled_dot_product_attention with
    # the additive mask and dropout_p, then F.linear, the hidden-dropout
    # mask, the residual and F.layer_norm; its backward from dctx through
    # the attention and the three projections (what the backward kernel
    # computes)
    mask = mask_bias(desc, L)[:, None].to(x.dtype)
    ps, po = attn.self, attn.output

    def lib_ctx(xs):
        def heads(t):
            return t.view(B, L, H, D).transpose(1, 2)
        q = heads(F.linear(xs, ps.query.weight, ps.query.bias))
        k = heads(F.linear(xs, ps.key.weight, ps.key.bias))
        v = heads(F.linear(xs, ps.value.weight, ps.value.bias))
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                           dropout_p=drop)
        return o.transpose(1, 2).reshape(B, L, Hd), (q, k, v)

    m_o_lib = m_o.to(x.dtype)

    def library_fwd():
        c, _ = lib_ctx(x)
        h = F.linear(c, po.dense.weight, po.dense.bias) * m_o_lib + x
        return F.layer_norm(h, (Hd,), po.LayerNorm.weight, po.LayerNorm.bias,
                            1e-12)

    (y, ctx), (y_p, ctx_p) = fwd(), fwd_plain()
    f_same = all(torch.equal(a, b) for a, b in zip((y, ctx), fwd()))
    if not f_same:
        raise SystemExit("attention_block_train_fwd: two runs on the same "
                         "inputs differ")
    got, want = bwd(), bwd_plain()
    torch.cuda.synchronize()
    f_err, f_rel, f_ok = within(y, y_p, *TOL["attention_block_train_fwd"])
    c_err = float((ctx.float() - ctx_p.float()).abs().max())
    c_rel = rel_err(ctx, ctx_p)
    c_ok = c_rel <= B5_CTX_REL
    control = {}
    if drop > 0:
        y_o, ctx_o = abt.attention_block_train_fwd_plain(
            x, desc, seed + 1, m_o, *ws, **kw)
        control = dict(y_ok=within(y, y_o,
                                   *TOL["attention_block_train_fwd"])[2],
                       ctx_rel_err=rel_err(ctx, ctx_o))
        if control["y_ok"] or control["ctx_rel_err"] <= B5_CTX_REL:
            raise SystemExit(f"attention_block_train_fwd: the check passes "
                             f"under another Philox seed: {control}")
        del y_o, ctx_o
    b_tol = TOL["attention_block_train_bwd"][0]
    b_errs = {n: rel_err(g, w) for n, g, w in
              zip(("dx", "dq", "dk", "dv"), got, want)}
    b_ok = all(e <= b_tol for e in b_errs.values())
    b_control = {}
    if drop > 0:
        wrong = bwd_plain_seed(seed + 1)
        b_control = {n: rel_err(g, w) for n, g, w in
                     zip(("dx", "dq", "dk", "dv"), got, wrong)}
        del wrong
        if min(b_control.values()) <= b_tol:
            raise SystemExit(f"attention_block_train_bwd: the check passes "
                             f"under another Philox seed: {b_control}")
    same_bits = all(torch.equal(g, h) for g, h in zip(got, bwd()))
    if not same_bits:
        raise SystemExit("attention_block_train_bwd: two runs on the same "
                         "inputs differ")
    b_abs = max(float((g.float() - w.float()).abs().max())
                for g, w in zip(got, want))
    M = B * L
    wbytes = (4 * (Hd * Hd + Hd) + 2 * Hd) * 2
    fb_ms, fb_by = bound(8 * M * Hd * Hd + 4 * B * L * L * Hd,
                         3 * M * Hd * 2 + M * Hd * 4 + B * 12 + wbytes)
    # backward: q/k/v recompute and dx (12 M Hd^2); S, dP, dQ, dK, dV
    # (10 B L^2 Hd); x, dctx in, dx, dq, dk, dv out
    bb_ms, bb_by = bound(12 * M * Hd * Hd + 10 * B * L * L * Hd,
                         6 * M * Hd * 2 + B * 12 + 3 * (Hd * Hd + Hd) * 2)
    shape = f"[{B}, {L}, {Hd}] {desc_fn.__name__} drop {drop}"
    fwd_case = dict(shape=shape, max_abs_err=f_err, max_rel_err=f_rel,
                    ctx_max_abs_err=c_err, ctx_rel_err=c_rel,
                    ctx_rel_tol=B5_CTX_REL,
                    ctx_max_abs=float(ctx_p.float().abs().max()),
                    other_seed=control, same_bits=f_same, ok=f_ok and c_ok,
                    ms=time_ms(fwd, 10),
                    plain_ms=time_ms(fwd_plain, 2, 1), bound_ms=fb_ms,
                    bound_by=fb_by, library_ms=time_ms(library_fwd, 10))
    with torch.enable_grad():
        xg = x.detach().requires_grad_()
        c_lib, qkv = lib_ctx(xg)

        def library_bwd():
            return torch.autograd.grad(c_lib, [xg, *qkv], dctx,
                                       retain_graph=True)

        bwd_case = dict(shape=shape, max_abs_err=b_abs, rel_errs=b_errs,
                        other_seed_rel_errs=b_control, same_bits=same_bits,
                        ok=b_ok, ms=time_ms(bwd, 10),
                        plain_ms=time_ms(bwd_plain, 2, 1), bound_ms=bb_ms,
                        bound_by=bb_by, library_ms=time_ms(library_bwd, 10))
    if split:
        fwd_case["launch_ms"] = core_launches("attention_block_train_fwd",
                                              fwd)
        bwd_case["launch_ms"] = core_launches("attention_block_train_bwd",
                                              bwd)
    return fwd_case, bwd_case


def check_adamw(dev, gen, shape):
    """B7 against its plain twin bit for bit, on one parameter tensor."""
    from unimm_torch.ops.adamw import (adamw_update_leaf,
                                       adamw_update_leaf_plain)

    def rnd(scale):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    g, p, mu, nu = rnd(1e-2), rnd(2e-2), rnd(1e-3), rnd(1e-4).abs()
    args = (2e-5, 0.01, 1.0 - 0.9 ** 5, 1.0 - 0.999 ** 5)
    want = adamw_update_leaf_plain(g, p, mu, nu, *args)
    got = adamw_update_leaf(g.clone(), p, mu.clone(), nu.clone(), *args)
    torch.cuda.synchronize()
    ok = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    gk, muk, nuk = g.clone(), mu.clone(), nu.clone()
    n = g.numel()
    b_ms, b_by = bound(12 * n, 28 * n)
    # the library step: torch.optim.AdamW(fused=True) over the same
    # tensor (its op order differs: decay before the step, eps placement)
    pl = p.clone()
    pl.grad = g.clone()
    lib = torch.optim.AdamW([pl], lr=2e-5, betas=(0.9, 0.999), eps=1e-6,
                            weight_decay=0.01, fused=True)
    return dict(shape=f"{list(shape)}", max_abs_err=err, max_rel_err=0.0,
                ok=ok,
                ms=time_ms(lambda: adamw_update_leaf(gk, p, muk, nuk, *args),
                           20),
                plain_ms=time_ms(lambda: adamw_update_leaf_plain(
                    g, p, mu, nu, *args), 10),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(lib.step, 20))


def split_heads(B, L, gen, dev):
    """A [B, 12, L, 64] bf16 tensor as the per-head path hands it to B6:
    the head-split view of a [B, L, 768] projection (no copy)."""
    t = torch.randn(B, L, 768, generator=gen, device=dev).to(torch.bfloat16)
    return t.view(B, L, 12, 64).transpose(1, 2)


def flip_mode(desc):
    """The control's wrong descriptors: each sequence's mode flipped."""
    wrong = desc.clone()
    wrong[:, 0] = 1 - wrong[:, 0]
    return wrong


def check_heads_attention(dev, gen, name, B, L, desc_fn, block_b=None):
    """B6's forward (the head-split view of a projection, as the model
    gives it) or B9 (contiguous [B, 12, L, 64], as its bench gives it, at
    ``block_b``) against its plain twin, with the control: the twin on the
    flipped descriptors must miss the same bound."""
    import torch.nn.functional as F
    from unimm_torch.ops import attention_v2 as av2
    from unimm_torch.ops import text_attention as ta
    from unimm_torch.ops.masks import mask_bias

    H, D = 12, 64
    q, k, v = (split_heads(B, L, gen, dev) for _ in range(3))
    if block_b is None:
        def kern():
            return ta.text_attention_fwd(q, k, v, desc)
        plain_fn = ta.text_attention_fwd_plain
    else:
        q, k, v = (t.contiguous() for t in (q, k, v))

        def kern():
            return av2.attention_v2(q, k, v, desc, block_b=block_b)
        plain_fn = av2.attention_v2_plain
    desc = desc_fn(B, L, gen)
    mask = mask_bias(desc, L)[:, None].to(torch.bfloat16)

    def plain():
        return plain_fn(q, k, v, desc)

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    tol = TOL[name][0]
    err = rel_err(got, want)
    control = rel_err(got, plain_fn(q, k, v, flip_mode(desc)))
    if control <= tol:
        raise SystemExit(f"{name}: the check passes the flipped "
                         f"descriptors: {control} <= {tol}")
    n = B * H * L * D
    b_ms, b_by = bound(4 * B * H * L * L * D, 4 * n * 2 + B * 12)
    return dict(shape=f"[{B}, {H}, {L}, {D}] {desc_fn.__name__}"
                + ("" if block_b is None else f" block_b {block_b}"),
                max_abs_err=float((got.float() - want.float()).abs().max()),
                out_rel_err=err, control_rel_err=control,
                max_abs_out=float(want.float().abs().max()), ok=err <= tol,
                ms=time_ms(kern, 10), plain_ms=time_ms(plain, 3, 1),
                bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library, 10))


def check_text_attention_bwd(dev, gen, B, L, desc_fn):
    """B6's backward against its plain twin (fp32 operands) on the same
    bf16 inputs; the twin on the flipped descriptors must miss the bound
    for each of dq, dk, dv; a second run must give the same bits."""
    import torch.nn.functional as F
    from unimm_torch.ops import text_attention as ta
    from unimm_torch.ops.masks import mask_bias

    H, D = 12, 64
    q, k, v, do = (split_heads(B, L, gen, dev) for _ in range(4))
    desc = desc_fn(B, L, gen)

    def kern():
        return ta.text_attention_bwd(q, k, v, desc, do)

    def plain():
        return ta.text_attention_bwd_plain(q, k, v, desc, do)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    tol = TOL["text_attention_bwd"][0]
    errs = {n: rel_err(g, w) for n, g, w in zip(("dq", "dk", "dv"), got,
                                                want)}
    same_bits = all(torch.equal(g, h) for g, h in zip(got, kern()))
    if not same_bits:
        raise SystemExit("text_attention_bwd: two runs on the same inputs "
                         "differ")
    wrong = ta.text_attention_bwd_plain(q, k, v, flip_mode(desc), do)
    control = {n: rel_err(g, w) for n, g, w in zip(("dq", "dk", "dv"), got,
                                                   wrong)}
    del wrong
    if min(control.values()) <= tol:
        raise SystemExit(f"text_attention_bwd: the check passes the flipped "
                         f"descriptors: {control} <= {tol}")
    n = B * H * L * D
    # five L x L x 64 products a head (the scores, dP, dq, dk, dv) on bf16
    # inputs; q, k, v, do in, dq, dk, dv out
    b_ms, b_by = bound(10 * B * H * L * L * D, 7 * n * 2 + B * 12)
    mask = mask_bias(desc, L)[:, None].to(torch.bfloat16)
    with torch.enable_grad():
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)

        def library():
            return torch.autograd.grad(o, [qg, kg, vg], do,
                                       retain_graph=True)

        lib_ms = time_ms(library, 10)
    return dict(shape=f"[{B}, {H}, {L}, {D}] {desc_fn.__name__}",
                max_abs_err=max(float((g.float() - w.float()).abs().max())
                                for g, w in zip(got, want)),
                dq_rel_err=errs["dq"], dk_rel_err=errs["dk"],
                dv_rel_err=errs["dv"], control_rel_errs=control,
                same_bits=same_bits, ok=max(errs.values()) <= tol,
                ms=time_ms(kern, 10),
                plain_ms=time_ms(plain, 2, 1), bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def bench_desc(B, L, gen):
    """The attention-block bench's descriptors (tools/bench_attn.make_desc):
    mode 0 or 1, ctx_end 60-199 scaled into L below 256, ans_len 2-8 (kept
    under mode 0, which ignores it)."""
    mode = torch.randint(0, 2, (B,), generator=gen, device=gen.device)
    ce = torch.randint(60, 200, (B,), generator=gen, device=gen.device)
    al = torch.randint(2, 9, (B,), generator=gen, device=gen.device)
    ce = torch.maximum(ce * L // 256, al + 2)
    return torch.stack([mode, ce, al], -1).to(torch.int32)


def open_desc(B, L, gen):
    """Discriminative descriptors at full length: every row attends every
    key."""
    z = torch.zeros(B, dtype=torch.int32, device=gen.device)
    return torch.stack([z, z + L, z], -1)


def zero_scores(attn):
    """attn's weights with the query projection zeroed: every score is 0."""
    ps = attn.self
    q = SimpleNamespace(weight=torch.zeros_like(ps.query.weight),
                        bias=torch.zeros_like(ps.query.bias))
    return SimpleNamespace(self=SimpleNamespace(query=q, key=ps.key,
                                                value=ps.value),
                           output=attn.output)


def check_probe_ctx(x, attn, kind, gen):
    """B10's context (``kind`` full, none or noshift) against its plain
    twin's on open descriptors, and the control: the twin without scores
    (zero_scores) must miss the bound. (ctx err, control err)."""
    from unimm_torch.ops import block_probe as bp

    B, L, _ = x.shape
    desc = open_desc(B, L, gen)

    def ctx(p, fn):
        return fn(x, desc, p, num_heads=12, softmax_mode=kind,
                  return_ctx=True)[1]

    got = ctx(attn, bp.probe_block)
    err = rel_err(got, ctx(attn, bp.probe_block_plain))
    control = rel_err(got, ctx(zero_scores(attn), bp.probe_block_plain))
    if control <= TA_REL:
        raise SystemExit(f"probe_block {kind}: the context check passes the "
                         f"twin without scores: {control} <= {TA_REL}")
    return err, control


def check_probe(dev, gen, name, kind, B, L, desc_fn, split=False):
    """B10 (``name`` "probe_block", ``kind`` a softmax mode) or B11
    ("layout_probe_block", a layout) against its plain twin on the same
    bf16 inputs, weights at WIDE_STD. The control must miss the same bound:
    the twin on the flipped descriptors, or for skip the full twin. B10's
    context is held as well (check_probe_ctx), and B10 ``full`` must equal
    B4 (attention_block) bit for bit: it launches B4's kernels. ``split``:
    each kernel's time a call too (core_launches)."""
    import torch.nn.functional as F
    from unimm_torch.models import vilbert
    from unimm_torch.ops import block_probe as bp
    from unimm_torch.ops.attention_block import attention_block
    from unimm_torch.ops.masks import mask_bias

    H, Hd = 12, 768
    attn = seeded_module(lambda: vilbert._attention(Hd), gen, dev,
                         std=WIDE_STD)
    x = torch.randn(B, L, Hd, generator=gen, device=dev).to(torch.bfloat16)
    desc = desc_fn(B, L, gen)
    if name == "probe_block":
        p = attn

        def kern():
            return bp.probe_block(x, desc, p, num_heads=H, softmax_mode=kind)

        def plain(d=desc, k=kind):
            return bp.probe_block_plain(x, d, p, num_heads=H, softmax_mode=k)
    else:
        p = bp.pad_heads_128(attn) if kind == "pad128" else attn

        def kern():
            return bp.layout_probe_block(x, desc, p, num_heads=H, layout=kind)

        def plain(d=desc, k=kind):
            return bp.layout_probe_block_plain(x, d, p, num_heads=H,
                                               layout=k)
    mask = mask_bias(desc, L)[:, None].to(x.dtype)
    ps, po = attn.self, attn.output

    def library():
        if kind == "skip":        # v, Wo, the residual and LayerNorm
            v = F.linear(x, ps.value.weight, ps.value.bias)
            h = F.linear(v, po.dense.weight, po.dense.bias) + x
            return F.layer_norm(h, (Hd,), po.LayerNorm.weight,
                                po.LayerNorm.bias, 1e-12)
        return library_block(attn, x, mask, H)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    atol, rtol = TOL[name]
    nan = kind == "noshift"
    err, rel, ok = within(got, want, atol, rtol, equal_nan=nan)
    wrong = plain(desc, "full") if kind == "skip" else plain(flip_mode(desc))
    c_err, _, c_ok = within(got, wrong, atol, rtol, equal_nan=nan)
    del wrong
    if c_ok:
        raise SystemExit(f"{name} {kind}: the check passes its control "
                         f"({c_err})")
    res = dict(shape=f"{kind} [{B}, {L}, {Hd}] {desc_fn.__name__}",
               max_abs_err=err, max_rel_err=rel, ok=ok,
               control_max_abs_err=c_err,
               nan_rows=int(got.float().isnan().any(-1).sum()))
    if name == "probe_block" and kind != "skip":
        c_err, c_control = check_probe_ctx(x, attn, kind, gen)
        res.update(ctx_rel_err=c_err, ctx_control_rel_err=c_control,
                   ok=res["ok"] and c_err <= TA_REL)
    if name == "probe_block" and kind == "full":
        same = torch.equal(got, attention_block(x, desc, attn, num_heads=H))
        res.update(bit_equal_to_attention_block=same, ok=res["ok"] and same)
    if split:
        res["launch_ms"] = core_launches(f"{name} {kind}", kern)
    # the function's work: skip's output needs only the V and Wo products;
    # its kernel also projects q and k (as_run_bound_ms)
    M, W = B * L, 2 * Hd if kind == "pad128" else Hd
    attn_flops = 0 if kind == "skip" else 4 * B * L * L * W
    nbytes = (2 * M * Hd * 2 + B * 12
              + (3 * (W * Hd + W) + Hd * W + 3 * Hd) * 2)
    b_ms, b_by = bound((4 if kind == "skip" else 8) * M * Hd * W
                       + attn_flops, nbytes)
    if kind == "skip":
        res["as_run_bound_ms"] = bound(8 * M * Hd * W, nbytes)[0]
    return dict(res, ms=time_ms(kern, 10), plain_ms=time_ms(plain, 3, 1),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=None if kind in ("none", "noshift")
                else time_ms(library, 10))


def probe_cases(dev, gen):
    """Phase 3's cases of B10 and B11: each mode and layout at the
    bench's shape and descriptors, with each kernel's time a call, then at
    L 96 on the edge descriptors (padding keys under none, fully masked
    rows under noshift); ``full`` bit-equal to B4 at both."""
    out = {}
    for name, kinds in (("probe_block", ("full", "none", "noshift", "skip")),
                        ("layout_probe_block",
                         ("wo_acc", "transposed", "pad128"))):
        out[name] = ([check_probe(dev, gen, name, k, 512, 256, bench_desc,
                                  split=True)
                      for k in kinds]
                     + [check_probe(dev, gen, name, k, 20, 96, edge_desc)
                        for k in kinds])
    return out


def check_block_b(dev, gen, B=256, L=256):
    """B4 at block_b 2 against block_b 1: bit for bit (each CTA walks its
    sequences in turn; nothing is summed across them)."""
    from unimm_torch.models import vilbert
    from unimm_torch.ops.attention_block import attention_block

    attn = seeded_module(lambda: vilbert._attention(768), gen, dev)
    x = torch.randn(B, L, 768, generator=gen, device=dev).to(torch.bfloat16)
    desc = bench_desc(B, L, gen)
    fns = {bb: (lambda bb=bb: attention_block(x, desc, attn, num_heads=12,
                                              block_b=bb))
           for bb in (1, 2)}
    same = torch.equal(fns[1](), fns[2]())
    res = dict(shape=f"[{B}, {L}, 768] bench_desc", bit_equal=same,
               **{f"ms_block_b{bb}": time_ms(f, 10) for bb, f in fns.items()})
    print(json.dumps({"attention_block_block_b": res}), flush=True)
    if not same:
        raise SystemExit("attention_block: block_b 2 differs from block_b 1")


KERNELS = [
    ("answer_block", "unimm_torch/csrc/answer_block.cu",
     "unimm_tpu/ops/pallas_prefix.py:151"),
    ("ffn_block", "unimm_torch/csrc/ffn_block.cu",
     "unimm_tpu/ops/pallas_attention_v2.py:494"),
    ("xent_head", "unimm_torch/csrc/xent_head.cu",
     "unimm_tpu/ops/pallas_head.py:106"),
    ("xent_train_fwd", "unimm_torch/csrc/xent_train.cu",
     "unimm_tpu/ops/losses.py:177"),
    ("xent_train_bwd", "unimm_torch/csrc/xent_train.cu",
     "unimm_tpu/ops/losses.py:183"),
    ("attention_block", "unimm_torch/csrc/attention_block.cu",
     "unimm_tpu/ops/pallas_attention_v2.py:168"),
    ("co_text_block", "unimm_torch/csrc/co_text_block.cu",
     "unimm_tpu/ops/pallas_attention_v2.py:589"),
    ("attention_block_train_fwd", "unimm_torch/csrc/attention_block_train.cu",
     "unimm_tpu/ops/pallas_attention_v2.py:347"),
    ("attention_block_train_bwd", "unimm_torch/csrc/attention_block_train.cu",
     "unimm_tpu/ops/pallas_attention_v2.py:370"),
    ("adamw_update_leaf", "unimm_torch/csrc/adamw.cu",
     "unimm_tpu/ops/pallas_optim.py:90"),
    ("text_attention_fwd", "unimm_torch/csrc/text_attention.cu",
     "unimm_tpu/ops/pallas_attention.py:121"),
    ("text_attention_bwd", "unimm_torch/csrc/text_attention.cu",
     "unimm_tpu/ops/pallas_attention.py:137"),
    ("attention_v2", "unimm_torch/csrc/attention_v2.cu",
     "unimm_tpu/ops/pallas_attention_v2.py:79"),
    ("probe_block", "unimm_torch/csrc/block_probe.cu",
     "scripts/bench_attn_block.py:144"),
    ("layout_probe_block", "unimm_torch/csrc/block_probe.cu",
     "scripts/bench_attn_block.py:328"),
    # the decoder's grouped expert products: no TPU kernel (the JAX
    # package runs no decoder)
    ("grouped_swiglu", "unimm_torch/csrc/moe_gemm.cu", None),
    ("grouped_down", "unimm_torch/csrc/moe_gemm.cu", None),
    # the decoder's absorbed MLA answer pass: no TPU kernel either
    ("mla_answer", "unimm_torch/csrc/mla_answer.cu", None),
]


def heads_cases(dev, gen):
    """Phase 3's cases of the per-head attention kernels: B6's forward at
    the flat path's main and longest buckets and the training step's shape,
    then the edge descriptors at L 32, 96 and 160 and the masked tails at
    L 256 (skipped chunks and fully masked rows in one 16-row tile); its
    backward at the training step's shape, on the edge descriptors at L
    32, 96 and 160 and on the masked tails at L 256 (skipped key and query
    chunks both ways); B9 at its bench's shape. Then B9 must equal B6's
    forward bit for bit."""
    return {
        "text_attention_fwd": [
            check_heads_attention(dev, gen, "text_attention_fwd", 256, 192,
                                  dis_desc),
            check_heads_attention(dev, gen, "text_attention_fwd", 256, 256,
                                  dis_desc),
            check_heads_attention(dev, gen, "text_attention_fwd", 240, 256,
                                  train_desc),
            check_heads_attention(dev, gen, "text_attention_fwd", 20, 32,
                                  edge_desc),
            check_heads_attention(dev, gen, "text_attention_fwd", 20, 96,
                                  edge_desc),
            check_heads_attention(dev, gen, "text_attention_fwd", 20, 160,
                                  edge_desc),
            check_heads_attention(dev, gen, "text_attention_fwd", 64, 256,
                                  tail_desc)],
        "text_attention_bwd": [
            check_text_attention_bwd(dev, gen, 240, 256, train_desc),
            check_text_attention_bwd(dev, gen, 20, 32, edge_desc),
            check_text_attention_bwd(dev, gen, 20, 96, edge_desc),
            check_text_attention_bwd(dev, gen, 20, 160, edge_desc),
            check_text_attention_bwd(dev, gen, 64, 256, tail_desc)],
        "attention_v2": [
            check_heads_attention(dev, gen, "attention_v2", 512, 256,
                                  train_desc, block_b=bb)
            for bb in (1, 4, 8)],
    }


def check_v2_equals_fwd(dev, gen):
    """At heads of 64 the scale is 2^-3, so B9 (q rounded at scale) and
    B6's forward (scores scaled) compute one function on the same sums:
    equal bit for bit at every block_b, at the bench's shape, on the edge
    descriptors at L 160 and on the masked tails."""
    from unimm_torch.ops import attention_v2 as av2
    from unimm_torch.ops import text_attention as ta
    for B, L, desc_fn, bbs in ((512, 256, train_desc, (1, 4, 8)),
                               (20, 160, edge_desc, (1, 4)),
                               (64, 256, tail_desc, (1, 8))):
        q, k, v = (split_heads(B, L, gen, dev).contiguous()
                   for _ in range(3))
        desc = desc_fn(B, L, gen)
        want = ta.text_attention_fwd(q, k, v, desc)
        for bb in bbs:
            if not torch.equal(av2.attention_v2(q, k, v, desc, block_b=bb),
                               want):
                raise SystemExit(f"attention_v2 block_b {bb} differs from "
                                 f"text_attention_fwd at [{B}, 12, {L}, 64] "
                                 f"{desc_fn.__name__}")


def phase_kernels(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    # the first case of each kernel is the main path's shape; the small
    # ones after it reach the edges that shape does not: key counts Lcb + RB
    # that end in a half chunk, and row counts with a partial last tile
    cases = {
        "answer_block": [check_answer_block(dev, gen, 192, 64),
                         check_answer_block(dev, gen, 256, 256),
                         check_answer_block(dev, gen, 224, 256, G=4),
                         check_answer_block(dev, gen, 96, 64, G=4, P=512),
                         check_answer_block(dev, gen, 192, 64, real=True),
                         check_answer_block(dev, gen, 256, 256,
                                            real=True),
                         # row blocks of 16-row tails (32, 96 and the W
                         # layout's Rw 160 at W 16 and 32) and context
                         # buckets that are not multiples of 16 (36, the
                         # max_seq_len 96 buckets' multiples of 12)
                         check_answer_block(dev, gen, 96, 32, real=True),
                         check_answer_block(dev, gen, 192, 96, real=True),
                         check_answer_block(dev, gen, 256, 160, w=16),
                         check_answer_block(dev, gen, 96, 160, G=4, w=32),
                         check_answer_block(dev, gen, 36, 96, G=4,
                                            real=True)],
        # then row tails of the 128-row and 64-row tiles (M = 1 .. 300)
        # at WIDE_STD with the lost-tile and lost-row controls
        "ffn_block": [check_ffn_block(dev, gen),
                      check_ffn_block(dev, gen, N=3, R=100)]
        + [check_ffn_block(dev, gen, N=1, R=m, std=WIDE_STD, controls=True)
           for m in (1, 63, 64, 65, 129, 300)],
        "xent_head": [check_xent_head(dev, gen),
                      check_xent_head(dev, gen, M=1000),
                      check_xent_head(dev, gen, M=48000, V=163840, Hd=2048,
                                      bias=False),
                      check_xent_head(dev, gen, M=1000, V=163840, Hd=2048,
                                      bias=False)],
        **xent_train_cases(dev, gen),
        **moe_cases(dev, gen),
        "mla_answer": [check_mla_answer(dev, gen)],
        # the flat path's main bucket, the longest one, the shortest one
        # with every kind of descriptor, the longest with the same, and the
        # masked tails (the chunks the one-pass attention skips, and rows
        # that weigh every key, in one 16-row tile)
        "attention_block": [check_attention_block(dev, gen, 192, dis_desc,
                                                  split=True),
                            check_attention_block(dev, gen, 256, dis_desc,
                                                  split=True),
                            check_attention_block(dev, gen, 32, edge_desc),
                            check_attention_block(dev, gen, 256, edge_desc,
                                                  B=20),
                            check_attention_block(dev, gen, 256,
                                                  tail_desc)],
        # then 1, 37 and 64 regions (kv rows 3 .. 192), text rows with a
        # partial last tile, at WIDE_STD with the controls
        "co_text_block": [check_co_text_block(dev, gen),
                          check_co_text_block(dev, gen, B=5, L=32)]
        + [check_co_text_block(dev, gen, B=3, L=L, R=R, std=WIDE_STD,
                               controls=True)
           for L, R in ((48, 1), (112, 37), (80, 64))],
    }
    # the training step's shape first, then the edge descriptors at a
    # length with a half key chunk, with and without attention dropout
    # (phase 8 (a) trains at dropout 0: the kernels' other instances), then
    # the masked tails with dropout (skipped chunks draw nothing)
    b5 = [check_attention_block_train(dev, gen, 240, 256, train_desc,
                                      split=True),
          check_attention_block_train(dev, gen, 20, 96, edge_desc),
          check_attention_block_train(dev, gen, 20, 96, edge_desc,
                                      drop=0.0),
          check_attention_block_train(dev, gen, 64, 256, tail_desc)]
    cases["attention_block_train_fwd"] = [f for f, _ in b5]
    cases["attention_block_train_bwd"] = [b for _, b in b5]
    # the largest parameter tensor (the tied word embeddings), a bias, a
    # length that leaves a tail past the float4 loads, and the word
    # embeddings' slice at -mesh_mp 2 (odd rows)
    cases["adamw_update_leaf"] = [check_adamw(dev, gen, (30522, 768)),
                                  check_adamw(dev, gen, (768,)),
                                  check_adamw(dev, gen, (1001,)),
                                  check_adamw(dev, gen, (15261, 768))]
    cases.update(heads_cases(dev, gen))
    check_v2_equals_fwd(dev, gen)
    cases.update(probe_cases(dev, gen))
    check_block_b(dev, gen)
    failed = []
    for name, cs in cases.items():
        atol, rtol = TOL[name]
        for c in cs:
            print(json.dumps({"kernel": name, "atol": atol, "rtol": rtol,
                              **c}), flush=True)
            if not c["ok"]:
                failed.append(f"{name} {c['shape']}")
    if failed:
        raise SystemExit(f"kernel disagrees with its plain version: {failed}")
    return cases


# ---------------------------------------------------------------------------
# phases 4-7: the serving paths
# ---------------------------------------------------------------------------

def wrappers():
    from unimm_torch.ops.adamw import adamw_update_leaf
    from unimm_torch.ops.answer_block import answer_block
    from unimm_torch.ops.attention_block import attention_block
    from unimm_torch.ops.attention_block_train import (
        attention_block_train_bwd, attention_block_train_fwd)
    from unimm_torch.ops.attention_v2 import attention_v2
    from unimm_torch.ops.block_probe import layout_probe_block, probe_block
    from unimm_torch.ops.co_text_block import co_text_block
    from unimm_torch.ops.ffn_block import ffn_block
    from unimm_torch.ops.mla_answer import mla_answer
    from unimm_torch.ops.moe import grouped_down, grouped_swiglu
    from unimm_torch.ops.text_attention import (text_attention_bwd,
                                                text_attention_fwd)
    from unimm_torch.ops.xent_head import xent_head
    from unimm_torch.ops.xent_train import xent_train_bwd, xent_train_fwd
    return (answer_block, ffn_block, xent_head, xent_train_fwd,
            xent_train_bwd, attention_block, co_text_block,
            attention_block_train_fwd, attention_block_train_bwd,
            adamw_update_leaf, text_attention_fwd, text_attention_bwd,
            attention_v2, probe_block, layout_probe_block, grouped_swiglu,
            grouped_down, mla_answer)


def counted(fn):
    """Run ``fn`` with every kernel's launch count set to 0 just before;
    return (its result, seconds until the card is idle, launches)."""
    ws = wrappers()
    torch.cuda.synchronize()
    for w in ws:
        w.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {
        w.__name__: w.launches for w in ws}


def expect(name, launches, want):
    """Fail unless the launch counts are ``want`` (kernels not named: 0)."""
    full = {k: want.get(k, 0) for k in launches}
    if launches != full:
        raise SystemExit(f"{name}: launches {launches} != {full}")


def series(cfg, seed, realistic, dis=False):
    from unimm_torch import workload
    rng = np.random.default_rng(seed)
    fn = workload.realistic_ctx_range(cfg.max_seq_len) if realistic else None
    if dis:
        return [workload.make_dis_batch(rng, cfg, 2, 10, 100,
                                        ctx_range_fn=fn) for _ in range(4)]
    return [workload.with_ranking_targets(
        workload.make_val_batch(rng, cfg, 2, 10, 100, ctx_range_fn=fn), rng)
        for _ in range(4)]


def n_units(batches, coalesce, per):
    """Sum over the coalesced groups of a run of ``per(slates, options)``:
    the dispatch units (slate groups or chunks) the run launches."""
    total = 0
    for i in range(0, len(batches), coalesce):
        grp = batches[i:i + coalesce]
        slates = sum(b["tokens"].shape[0] * b["tokens"].shape[1]
                     for b in grp)
        total += per(slates, grp[0]["tokens"].shape[2])
    return total


def slate_groups(batches, coalesce=2, group=40):
    return n_units(batches, coalesce, lambda s, o: -(-s // group))


def chunks(batches, coalesce=2, chunk=256):
    return n_units(batches, coalesce, lambda s, o: -(-s * o // chunk))


def run_split(dev, model, cfg, batches, mode, coalesce=2):
    """One counted, timed evaluate_split run: (metrics, seconds,
    launches)."""
    from unimm_torch.eval.evaluator import evaluate_split
    metrics, secs, launches = counted(lambda: evaluate_split(
        model, cfg, batches, mode=mode, dtype=torch.bfloat16,
        progress_every=0, coalesce=coalesce, pipeline_depth=1, device=dev))
    if not all(math.isfinite(v) for v in metrics.values()):
        raise SystemExit(f"{mode}: non-finite metrics {metrics}")
    return metrics, secs, launches


def check_scores(scores, n):
    for v in scores.values():
        if v.shape != (n,) or not np.isfinite(v).all():
            raise SystemExit("non-finite or misshapen scores")


def compare_plain(dev, model, cfg, batches):
    """Per-option ll scores through the kernels and through their plain
    versions on the card: (top-1 agreement over slates, max |d ll_mean|,
    slates)."""
    from unimm_torch.eval.evaluator import RankingEvaluator, _merge_batches
    agree, n, d_mean = 0, 0, 0.0
    evs = [RankingEvaluator(cfg.replace(attention_impl=impl), need_nsp=False,
                            dtype=torch.bfloat16, device=dev)
           for impl in ("pallas_block", "xla")]
    for i in range(0, len(batches), 2):
        pair = _merge_batches(batches[i:i + 2])
        B, R, O = pair["tokens"].shape[:3]
        k, p = (ev.score_slates(model, pair) for ev in evs)
        for sc in (k, p):
            check_scores(sc, B * R * O)
        ks, ps = (sc["ll_sum"].reshape(B * R, O) for sc in (k, p))
        agree += int((ks.argmax(-1) == ps.argmax(-1)).sum())
        n += B * R
        d_mean = max(d_mean, float(np.abs(k["ll_mean"] - p["ll_mean"]).max()))
    return agree / n, d_mean, n


def nsp_margins(dev, model, cfg, batches):
    """NSP margins (logit 0 - logit 1 = logit(nsp_prob)) of every option,
    [slates, O] float64, through the flat scorer under ``cfg``."""
    from unimm_torch.eval.evaluator import RankingEvaluator, _merge_batches
    ev = RankingEvaluator(cfg, need_lm=False, dtype=torch.bfloat16,
                          device=dev)
    out = []
    for i in range(0, len(batches), 2):
        pair = _merge_batches(batches[i:i + 2])
        B, R, O = pair["tokens"].shape[:3]
        sc = ev.score_slates(model, pair)
        check_scores(sc, B * R * O)
        p = sc["nsp_prob"].astype(np.float64)
        out.append((np.log(p) - np.log1p(-p)).reshape(B * R, O))
    return np.concatenate(out)


def compare_nsp(dev, model, cfg, batches):
    """The kernels' NSP margins against the all-plain evaluator's on the
    card: max |d margin|, max |margin|, top-1 agreement, slates, and
    whether |d margin| keeps within NSP_MARGIN_TOL."""
    k = nsp_margins(dev, model, cfg, batches)
    p = nsp_margins(dev, model, cfg.replace(attention_impl="xla"), batches)
    d, size = float(np.abs(k - p).max()), float(np.abs(p).max())
    atol, rtol = NSP_MARGIN_TOL
    return dict(max_abs_d_margin=d, max_abs_margin=size,
                top1_agreement=float((k.argmax(-1) == p.argmax(-1)).mean()),
                slates=int(k.shape[0]), gate=NSP_MARGIN_TOL,
                ok=d <= atol + rtol * size)


# The kernels and their plain versions round at the same points, so the
# per-slate argmax can differ only where two options' ll_sum lie within the
# fp32-summation-order noise of each other. With random weights the best
# option of a slate leads the runner-up by far more than that on almost
# every slate; 0.95 leaves room for a few near-ties in 160 slates and still
# fails on any systematic fault.
MIN_TOP1_AGREEMENT = 0.95

# The all-plain evaluator ("xla") is PyTorch's bf16 encoder: it rounds at
# other points than the kernels (bf16 GEMM outputs, bf16 softmax input), so
# the two differ by bf16 rounding carried through 18 text and 6 vision
# blocks. The NSP margin is a 1024-term product of pooled vectors whose
# bf16 rounding alone moves it by ~2^-8 of its size. With random weights
# the margins are ~0.1 and the options of a slate differ by ~1e-3, so
# top-1 agreement is reported, not gated (near-ties decide it); the gate is
# |d margin| <= 0.02 + 0.05 |margin|: a few bf16 steps of the margin, and
# far below what a wrong mask or a dropped head moves it by (the size of
# the margin itself).
NSP_MARGIN_TOL = (2e-2, 5e-2)


# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------

# Gates of phase 8 (a), at dropout 0. The loss parts of the kernel path
# and the all-plain bf16 path agree to LOSS_RTOL. Their gradients do not
# agree element by element, nor to a cosine of 0.999 and a norm within 5%:
# on an H100 (700 W) the two measured cosine 0.9947 and a 10% norm
# difference at the image and text embeddings. Both paths round to bf16
# at other points (the kernels' q/k/v/P/context/dS against PyTorch's bf16
# GEMM outputs and softmax), each gradient is a sum of bf16-rounded terms
# over 16384 rows, and the differences compound through the 18 text and 6
# vision layers that the backward crosses before the embeddings. So each
# bf16 path is held against the same step in fp32 (the plain path with
# fp32 compute): the kernel path must be no farther from it than the
# plain bf16 path, GRAD_SLACK times that distance plus GRAD_FLOOR, and
# point the same way (cosine >= MIN_GRAD_COSINE). A wrong mask, dropped
# head or wrong backward moves a gradient by its own size.
# The distances are the means over GATE_SEEDS' batches, the cosine is held
# on each batch. On one batch the distance of a small gradient is noise:
# a query bias's (the sum over all rows of dq, whose terms nearly cancel)
# reads 3-13% from the fp32 step on either bf16 path, and which of the two
# reads farther changes with any change of rounding. On an H100 (700 W),
# by --train-gates 10 11 12 13, the single-batch rule failed on seed 11
# before the move of B4 and B5's forward onto the one-pass kernel (a
# query bias, margin +0.0023), and on seeds 10 and 13 after it (+0.0016
# on a query bias, +0.0066 on a co-attention leaf that no kernel
# computes). Faults planted in that forward (its last live key chunk
# skipped; its context 3% too large) failed the mean rule, and the
# single-batch rule on every seed.
LOSS_RTOL = 1e-2
GRAD_SLACK, GRAD_FLOOR = 1.5, 1e-2
MIN_GRAD_COSINE = 0.99
GATE_SEEDS = (10, 11, 12)
# Gate of phase 8 (a) at the default dropouts: the kernel path against the
# same step with every text attention block run as autograd through the
# forward kernel's plain twin (plain_block_train), both drawing from one
# DropoutRng seed, so both see the same hidden-dropout masks and Philox
# seeds; everything else is the same code. Their forwards round at the
# same points; their backwards round at others (the kernels round dS and
# dq / dk / dv, autograd through the twin at the forward's casts). Each
# text-layer attention leaf's gradient (the leaves whose backward the
# kernels compute) is held to a relative norm distance of TWIN_GRAD_REL
# from the twin's. On an H100 (700 W) the distance measured 5.1-7.4% over
# the 12 layers (cosine >= 0.9977): below the 10-12% by which each bf16
# path misses the fp32 step at dropout 0, the bf16 noise of these
# gradients at this init. The gate is twice the worst reading. A
# control step from another seed (other masks; measured 55-119% from the
# twin) must land farther than the gate at every such leaf, or the gate
# could not see a wrong mask.
TWIN_GRAD_REL = 0.15
# gradients that are zero in exact arithmetic (a key projection's bias
# shifts every score of a row alike, and the softmax is blind to that):
# both paths give rounding noise, which no gate can compare
ZERO_GRAD_SUFFIXES = ("key.bias", "key1.bias", "key2.bias")
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  v_hidden_dropout_prob=0.0,
                  v_attention_probs_dropout_prob=0.0, head_dropout_prob=0.0)


class Named:
    """A list of (name, tensor) as a module's ``named_parameters``."""

    def __init__(self, named):
        self.named = named

    def named_parameters(self):
        return iter(self.named)


# the training cross-entropy's launches a forward and backward of the
# gathered MLM loss on bf16 rows (ops/xent_train.takes)
XENT_STEP = {"xent_train_fwd": 1, "xent_train_bwd": 1}


def on_device(batch, dev):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


@contextlib.contextmanager
def plain_block_train():
    """Inside: the training step's text attention blocks run as autograd
    through the forward kernel's plain twin (its Philox mask, hidden-
    dropout mask and rounding points), launching no kernel of theirs (the
    step's cross-entropy still launches its own, XENT_STEP)."""
    from unimm_torch.models import unimm
    from unimm_torch.ops import attention_block_train as abt
    from unimm_torch.ops.answer_block import _weights

    def twin(x, desc, seed, m_o, p_attn, *, num_heads, attn_drop,
             eps=1e-12):
        return abt.attention_block_train_fwd_plain(
            x, desc, seed, m_o, *_weights(p_attn), num_heads=num_heads,
            attn_drop=attn_drop, eps=eps)[0]

    kernel = unimm.attention_block_train
    unimm.attention_block_train = twin
    try:
        yield
    finally:
        unimm.attention_block_train = kernel


def compare_twin(g_k, g_t, g_o):
    """Per text-layer attention leaf: the relative norm distance of the
    kernel path's gradient g_k and of the other-seed control's g_o to the
    plain twin's g_t. Returns (summary, failures)."""
    import re
    leaf = re.compile(r"bert\.encoder\.layer\.(\d+)\.attention\..*")
    worst = {"rel_kt": 0.0, "cos_kt": 1.0, "control_min_rel": math.inf,
             "leaves": 0, "rel_kt_by_layer": {}}
    bad = []
    for name, gt in g_t.items():
        m = leaf.fullmatch(name)
        if not m or name.endswith(ZERO_GRAD_SUFFIXES):
            continue
        t, k, o = (g.double().flatten() for g in (gt, g_k[name], g_o[name]))
        nt = float(t.norm())
        rel = float((k - t).norm()) / nt
        cos = float(k @ t / (k.norm() * nt))
        ctl = float((o - t).norm()) / nt
        worst["leaves"] += 1
        by_layer = worst["rel_kt_by_layer"]
        by_layer[m[1]] = max(by_layer.get(m[1], 0.0), rel)
        worst["rel_kt"] = max(worst["rel_kt"], rel)
        worst["cos_kt"] = min(worst["cos_kt"], cos)
        worst["control_min_rel"] = min(worst["control_min_rel"], ctl)
        if not rel <= TWIN_GRAD_REL or ctl <= TWIN_GRAD_REL:
            bad.append((name, rel, ctl))
    return worst, bad


def grad_distances(g_k, g_p, g_32):
    """Per parameter (but the ZERO_GRAD_SUFFIXES): (cosine of the kernel
    path's gradient g_k with the fp32 gradient g_32, relative norm distance
    of g_k and of the plain bf16 path's g_p to g_32, of g_k to g_p)."""
    out = {}
    for name, g32 in g_32.items():
        if g32 is None or name.endswith(ZERO_GRAD_SUFFIXES):
            continue
        c, a, b = (t.double().flatten() for t in (g32, g_k[name], g_p[name]))
        nc = float(c.norm())
        if nc == 0.0:
            continue
        cos = float(a @ c / (a.norm() * nc).clamp(min=1e-300))
        rel_k, rel_p = (float((t - c).norm()) / nc for t in (a, b))
        rel_kp = float((a - b).norm()) / max(float(b.norm()), 1e-300)
        out[name] = (cos, rel_k, rel_p, rel_kp)
    return out


def compare_grads(per_batch):
    """grad_distances of each batch -> (summary, failures): a parameter
    fails if its cosine is below MIN_GRAD_COSINE on a batch, or if its
    mean distance to the fp32 step exceeds GRAD_SLACK times the plain
    path's mean plus GRAD_FLOOR. The summary also gives, per batch, the
    worst margin a single-batch rule would have read."""
    worst, bad = {"cos_k32": 1.0, "rel_k32": 0.0, "rel_p32": 0.0,
                  "rel_kp": 0.0}, []
    for name in per_batch[0]:
        cos = min(d[name][0] for d in per_batch)
        rel_k, rel_p, rel_kp = (
            sum(d[name][i] for d in per_batch) / len(per_batch)
            for i in (1, 2, 3))
        worst["cos_k32"] = min(worst["cos_k32"], cos)
        for k, v in (("rel_k32", rel_k), ("rel_p32", rel_p),
                     ("rel_kp", rel_kp)):
            worst[k] = max(worst[k], v)
        if cos < MIN_GRAD_COSINE or rel_k > GRAD_SLACK * rel_p + GRAD_FLOOR:
            bad.append((name, cos, rel_k, rel_p))
    worst["single_batch_margins"] = [
        max((d[n][1] - GRAD_SLACK * d[n][2] - GRAD_FLOOR, n) for n in d)
        for d in per_batch]
    return worst, bad


def train_gates(dev, cfg, runs, seeds=GATE_SEEDS, B_small=64):
    """Phase 8 (a) at ``cfg`` on batches of ``B_small`` sequences: the
    gradient gate against the fp32 step (dropout 0, the batches of
    ``seeds``) and the dropout gate against the plain twin (the first
    seed's batch). Returns ((gradient result, passed), (dropout result,
    passed)) and fills ``runs`` with each counted run's launches."""
    from unimm_torch import workload
    from unimm_torch.models import unimm, vilbert

    per_step = {"attention_block_train_fwd": cfg.num_hidden_layers,
                "attention_block_train_bwd": cfg.num_hidden_layers,
                **XENT_STEP}
    cfg0 = cfg.replace(**NO_DROPOUT)
    model = vilbert.train_model(cfg0, seed=0, device=dev)

    def loss_and_grads(c, batch, dtype=torch.bfloat16):
        for p in model.parameters():
            p.grad = None
        parts = unimm.forward_train(model, c, batch, dtype=dtype,
                                    rng=vilbert.DropoutRng(0, dev))
        sum(parts.values()).backward()
        return ({k: float(v.detach()) for k, v in parts.items()},
                {n: p.grad for n, p in model.named_parameters()})

    plain = cfg0.replace(attention_impl="xla")
    loss_ok, per_batch, losses = True, [], []
    for seed in seeds:
        batch = on_device(workload.make_train_batch(
            np.random.default_rng(seed), cfg, B_small), dev)
        with torch.enable_grad():
            (parts_k, g_k), secs, launches = counted(
                lambda: loss_and_grads(cfg0, batch))
            expect("train (a) kernel path", launches, per_step)
            runs["train_a"] = launches
            parts_p, g_p = loss_and_grads(plain, batch)
            _, g_32 = loss_and_grads(plain, batch, torch.float32)
        loss_ok &= all(abs(parts_k[k] - parts_p[k])
                       <= LOSS_RTOL * abs(parts_p[k]) for k in parts_p)
        losses.append(dict(seed=seed, kernel=parts_k, plain=parts_p))
        per_batch.append(grad_distances(g_k, g_p, g_32))
        del g_k, g_p, g_32
    worst, bad = compare_grads(per_batch)
    res_a = dict(batch=B_small, losses=losses, loss_rtol=LOSS_RTOL,
                 worst=worst,
                 gates=dict(slack=GRAD_SLACK, floor=GRAD_FLOOR,
                            min_cosine=MIN_GRAD_COSINE, seeds=seeds),
                 failures=bad[:10], seconds=secs)
    batch = on_device(workload.make_train_batch(
        np.random.default_rng(seeds[0]), cfg, B_small), dev)

    # at the default dropouts: the kernel path against the plain twin
    # from the same DropoutRng seed, and a control from another seed
    def drop_step(seed):
        for p in model.parameters():
            p.grad = None
        parts = unimm.forward_train(model, cfg, batch,
                                    rng=vilbert.DropoutRng(seed, dev))
        sum(parts.values()).backward()
        return ({k: float(v.detach()) for k, v in parts.items()},
                {n: p.grad for n, p in model.named_parameters()})

    with torch.enable_grad():
        (parts_k, g_k), secs, launches = counted(lambda: drop_step(1))
        expect("train (a) dropout, kernel path", launches, per_step)
        runs["train_a_dropout"] = launches
        with plain_block_train():
            (parts_t, g_t), _, launches = counted(lambda: drop_step(1))
        expect("train (a) dropout, plain twin", launches, XENT_STEP)
        _, g_o = drop_step(2)
    d_loss_ok = all(abs(parts_k[k] - parts_t[k])
                    <= LOSS_RTOL * abs(parts_t[k]) for k in parts_t)
    d_worst, d_bad = compare_twin(g_k, g_t, g_o)
    res_d = dict(batch=B_small, losses_kernel=parts_k, losses_twin=parts_t,
                 loss_rtol=LOSS_RTOL, worst=d_worst, rel_tol=TWIN_GRAD_REL,
                 failures=d_bad[:10], seconds=secs)
    return (res_a, loss_ok and not bad), (res_d, d_loss_ok and not d_bad)


def phase_train(dev, card, runs, cfg=None, B=240, B_small=64):
    """Phase 8 at ``cfg`` (default: the default config) with training
    batches of ``B`` and ``B_small`` sequences; fills ``runs`` with each
    counted run's launches."""
    from pathlib import Path

    from unimm_torch import workload
    from unimm_torch.config import VilbertConfig
    from unimm_torch.models import unimm, vilbert
    from unimm_torch.train import optim
    from unimm_torch.train import step as tstep

    cfg = cfg or VilbertConfig()
    n_t = cfg.num_hidden_layers
    lang = optim.load_language_weights(
        Path(__file__).resolve().parent / "config" / "language_weights.json")
    per_step = {"attention_block_train_fwd": n_t,
                "attention_block_train_bwd": n_t, **XENT_STEP}

    def times(d, k):
        return {name: n * k for name, n in d.items()}

    # (a) kernel path against the all-plain path at dropout 0, and against
    # the plain twin at the default dropouts
    (res_a, ok_a), (res_d, ok_d) = train_gates(dev, cfg, runs,
                                               B_small=B_small)
    print(json.dumps({"train_vs_plain": res_a}), flush=True)
    if not ok_a:
        raise SystemExit(f"training step disagrees with the plain path: "
                         f"{res_a}")
    print(json.dumps({"train_dropout_vs_twin": res_d}), flush=True)
    if not ok_d:
        raise SystemExit(f"training step at dropout disagrees with the "
                         f"plain twin: {res_d}")

    # (b) default dropouts, B 240: grouped plain AdamW, then the fused one
    batches = [on_device(workload.make_train_batch(
        np.random.default_rng(20 + i), cfg, B), dev) for i in range(3)]
    ocfg = optim.OptimConfig(warmup_steps=10, t_total=1000)
    res_b = {}
    for kind, make in (("grouped", optim.make_optimizer),
                       ("fused", optim.make_fused_optimizer)):
        model = vilbert.train_model(cfg, seed=0, device=dev)
        n_params = len(list(model.parameters()))
        state = tstep.init_state(model, make(model, ocfg, lang), seed=0)
        step = tstep.make_train_step(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.enable_grad():
            for i in range(2):
                state, _ = step(state, batches[i % 3])

            def timed():
                out = []
                for i in range(5):
                    out.append(step(state, batches[i % 3])[1])
                return out

            metrics, secs, launches = counted(timed)
        want = times(per_step, 5)
        if kind == "fused":
            want["adamw_update_leaf"] = 5 * n_params
        expect(f"train (b) {kind}", launches, want)
        runs[f"train_{kind}"] = launches
        losses = [float(m["loss"]) for m in metrics]
        if not all(math.isfinite(v) for v in losses):
            raise SystemExit(f"train (b) {kind}: non-finite loss {losses}")
        res_b[kind] = dict(batch=B, steps=5, launches=launches,
                           launches_per_step={k: v // 5
                                              for k, v in launches.items()},
                           parameter_tensors=n_params, losses=losses,
                           ms_per_step=secs / 5 * 1e3,
                           sequences_per_s=5 * B / secs,
                           max_memory_allocated_gb=(
                               torch.cuda.max_memory_allocated() / 1e9))
        print(json.dumps({"train_step": {kind: res_b[kind]}, "card": card}),
              flush=True)
        if kind == "grouped":
            del model, state
    # the fused update against the plain one from the same gradients and
    # optimizer state, bit for bit
    with torch.enable_grad():
        for p in model.parameters():
            p.grad = None
        parts = unimm.forward_train(model, cfg, batches[0],
                                    rng=vilbert.DropoutRng(99, dev))
        sum(parts.values()).backward()
    src = state["opt"]
    grads = [p.grad for p in model.parameters()]
    opts = []
    for make in (optim.make_optimizer, optim.make_fused_optimizer):
        o = make(Named([(n, p.detach().clone()) for n, p in
                        model.named_parameters()]), ocfg, lang)
        o.mu = [m.clone() for m in src.mu]
        o.nu = [v.clone() for v in src.nu]
        o.count, o.sched_count = src.count, src.sched_count
        o.step([None if g is None else g.clone() for g in grads])
        opts.append(o)
    plain, fused = opts
    same = all(all(torch.equal(a, b) for a, b in zip(x, y)) for x, y in (
        (plain.params, fused.params), (plain.mu, fused.mu),
        (plain.nu, fused.nu)))
    print(json.dumps({"fused_vs_plain_update_bit_identical": same}),
          flush=True)
    if not same:
        raise SystemExit("fused AdamW differs from the plain update")
    del model, state, src, grads, opts, plain, fused, batches

    # (c) 8 steps on one batch lower the loss
    model = vilbert.train_model(cfg, seed=0, device=dev)
    n_params = len(list(model.parameters()))
    state = tstep.init_state(model, optim.make_fused_optimizer(
        model, optim.OptimConfig(lr=1e-4, image_lr=1e-4, warmup_steps=1,
                                 t_total=1000), lang), seed=0)
    step = tstep.make_train_step(cfg)
    batch = on_device(workload.make_train_batch(np.random.default_rng(30),
                                                cfg, B_small), dev)
    with torch.enable_grad():
        metrics, secs, launches = counted(
            lambda: [step(state, batch)[1] for _ in range(8)])
    expect("train (c)", launches, {**times(per_step, 8),
                                   "adamw_update_leaf": 8 * n_params})
    runs["train_sanity"] = launches
    losses = [float(m["loss"]) for m in metrics]
    print(json.dumps({"train_sanity": {"batch": B_small, "losses": losses,
                                       "seconds": secs}}), flush=True)
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise SystemExit(f"train (c): loss did not fall: {losses}")
    return res_a, res_b


# ---------------------------------------------------------------------------
# phase 9: the per-head attention path and remat
# ---------------------------------------------------------------------------

# the text-layer attention leaves, whose backward B6 computes under "pallas"
TEXT_ATTN_LEAF = r"bert\.encoder\.layer\.\d+\.attention\..*"
# Remat gate: each parameter's gradient under remat differs from the step
# without it by at most REMAT_SPREAD times the largest difference between
# two runs of that step (same seed): both forwards run the same kernels on
# the same inputs and the recompute replays the dropout stream, so the
# difference is the run-to-run spread of the backward's reductions, zero
# where they are deterministic.
REMAT_SPREAD = 2.0


def train_grads(model, cfg, batch, seed, dtype=torch.bfloat16):
    """Loss parts and every parameter's gradient of one forward_train on
    ``model`` with dropout drawn from ``DropoutRng(seed)``."""
    from unimm_torch.models import unimm, vilbert
    for p in model.parameters():
        p.grad = None
    parts = unimm.forward_train(model, cfg, batch, dtype=dtype,
                                rng=vilbert.DropoutRng(seed, batch[
                                    "tokens"].device))
    sum(parts.values()).backward()
    return ({k: float(v.detach()) for k, v in parts.items()},
            {n: p.grad for n, p in model.named_parameters()})


def remat_spread(dev, cfg, batch):
    """The step under remat against two runs of the step without it (B
    64, one seed): per parameter, max |remat - run 1| and max |run 2 -
    run 1|. Returns (summary, failures)."""
    from unimm_torch.models import vilbert
    model = vilbert.train_model(cfg, seed=0, device=dev)
    l1, g1 = train_grads(model, cfg, batch, 4)
    g1 = {n: g.clone() for n, g in g1.items() if g is not None}
    l2, g2 = train_grads(model, cfg, batch, 4)
    lr, gr = train_grads(model, cfg.replace(remat=True), batch, 4)
    worst = {"max_d_remat": 0.0, "max_spread": 0.0, "params_differing": 0,
             "loss_equal": lr == l1, "loss_spread": l1 != l2}
    bad = []
    for n, a in g1.items():
        d = float((gr[n] - a).abs().max())
        spread = float((g2[n] - a).abs().max())
        worst["max_d_remat"] = max(worst["max_d_remat"], d)
        worst["max_spread"] = max(worst["max_spread"], spread)
        worst["params_differing"] += d > 0
        if d > REMAT_SPREAD * spread:
            bad.append((n, d, spread))
    if lr != l1 and l1 == l2:
        bad.append(("loss", lr, l1))
    return worst, bad


def timed_steps(dev, cfg, batches, lang, steps=3, warmup=1):
    """``steps`` timed B-240 training steps with the fused AdamW after
    ``warmup``: (result dict, launches, parameter tensors)."""
    from unimm_torch.models import vilbert
    from unimm_torch.train import optim
    from unimm_torch.train import step as tstep
    model = vilbert.train_model(cfg, seed=0, device=dev)
    n_params = len(list(model.parameters()))
    state = tstep.init_state(model, optim.make_fused_optimizer(
        model, optim.OptimConfig(warmup_steps=10, t_total=1000), lang),
        seed=0)
    step = tstep.make_train_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.enable_grad():
        for i in range(warmup):
            step(state, batches[i % len(batches)])
        metrics, secs, launches = counted(lambda: [
            step(state, batches[i % len(batches)])[1] for i in range(steps)])
    losses = [float(m["loss"]) for m in metrics]
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"non-finite training loss {losses}")
    B = batches[0]["tokens"].shape[0]
    return dict(batch=B, steps=steps, losses=losses,
                ms_per_step=secs / steps * 1e3,
                sequences_per_s=steps * B / secs,
                max_memory_allocated_gb=(
                    torch.cuda.max_memory_allocated() / 1e9),
                launches_per_step={k: v // steps
                                   for k, v in launches.items()}), \
        launches, n_params


def phase_per_head(dev, card, runs, model, cfg, dis_batches, dis_steady,
                   train_fused, B=240, B_small=64):
    """Phase 9: the flat scorer and training under attention_impl="pallas"
    (B6), remat under "pallas" and "pallas_block", the dispatch rule under
    attention dropout, and the attention bench (B6, B9)."""
    import re
    from pathlib import Path

    from unimm_torch import workload
    from unimm_torch.models import vilbert
    from unimm_torch.tools import bench_attn
    from unimm_torch.tools.kernel_profile import steady_throughput
    from unimm_torch.train import optim

    n_t = cfg.num_hidden_layers
    cfg_p = cfg.replace(attention_impl="pallas")
    # (a) the flat scorer under "pallas": 12 B6 launches per chunk
    for batches in dis_batches.values():              # warm-up, not counted
        run_split(dev, model, cfg_p, batches, "nsp")
    res_a = {}
    for name, batches in dis_batches.items():
        metrics, secs, launches = run_split(dev, model, cfg_p, batches,
                                            "nsp")
        c = chunks(batches)
        expect(f"pallas dis {name}", launches, {"text_attention_fwd": n_t * c})
        runs[f"pallas_dis_{name}"] = launches
        res_a[name] = dict(launches=launches, chunks=c, seconds=secs,
                           r1=metrics["r@1"], ndcg=metrics["ndcg"])
    cmp = compare_nsp(dev, model, cfg_p, sum(dis_batches.values(), []))
    steady = {name: steady_throughput(dev, model, cfg_p, b, need_lm=False)[0]
              for name, b in dis_batches.items()}
    print(json.dumps({"pallas_dis_path": res_a, "pallas_vs_plain": cmp,
                      "steady_dialogs_per_s": {
                          "pallas": steady, "pallas_block_phase5": dis_steady},
                      "card": card}), flush=True)
    if not cmp["ok"]:
        raise SystemExit(f"pallas: NSP margins disagree with plain: {cmp}")

    # (b) training under "pallas" at attention dropout 0: B 64 gradients
    # of the text attention leaves against the "xla" step on the same
    # masks, held to phase 8 (a)'s fp32-step yardstick; then timed steps
    lang = optim.load_language_weights(
        Path(__file__).resolve().parent / "config" / "language_weights.json")
    cfg_t = cfg_p.replace(attention_probs_dropout_prob=0.0)
    small = on_device(workload.make_train_batch(np.random.default_rng(40),
                                                cfg, B_small), dev)
    model_t = vilbert.train_model(cfg_t, seed=0, device=dev)
    plain = cfg_t.replace(attention_impl="xla")
    with torch.enable_grad():
        (parts_k, g_k), secs, launches = counted(
            lambda: train_grads(model_t, cfg_t, small, 3))
        expect("pallas train (b)", launches,
               {"text_attention_fwd": n_t, "text_attention_bwd": n_t,
                **XENT_STEP})
        runs["pallas_train_b64"] = launches
        g_k = {n: g.clone() for n, g in g_k.items() if g is not None}
        parts_p, g_p = train_grads(model_t, plain, small, 3)
        g_p = {n: g.clone() for n, g in g_p.items() if g is not None}
        _, g_32 = train_grads(model_t, plain, small, 3, torch.float32)
    leaf = re.compile(TEXT_ATTN_LEAF)
    worst, bad = compare_grads([grad_distances(
        g_k, g_p, {n: g for n, g in g_32.items() if leaf.fullmatch(n)})])
    loss_ok = all(abs(parts_k[k] - parts_p[k]) <= LOSS_RTOL * abs(parts_p[k])
                  for k in parts_p)
    res_b = dict(batch=B_small, losses_kernel=parts_k, losses_plain=parts_p,
                 worst=worst, gates=dict(slack=GRAD_SLACK, floor=GRAD_FLOOR,
                                         min_cosine=MIN_GRAD_COSINE),
                 failures=bad[:10], seconds=secs)
    print(json.dumps({"pallas_train_vs_plain": res_b}), flush=True)
    if not loss_ok or bad:
        raise SystemExit(f"pallas training step disagrees with the plain "
                         f"path: {res_b}")
    del model_t, g_k, g_p, g_32
    batches = [on_device(workload.make_train_batch(
        np.random.default_rng(50 + i), cfg, B), dev) for i in range(2)]
    steps = {}
    res, launches, n_params = timed_steps(dev, cfg_t, batches, lang)
    expect("pallas train (b) B 240", launches,
           {"text_attention_fwd": 3 * n_t, "text_attention_bwd": 3 * n_t,
            "adamw_update_leaf": 3 * n_params,
            **{k: 3 * v for k, v in XENT_STEP.items()}})
    runs["pallas_train"] = launches
    steps["pallas"] = res

    # (c) remat: B 240 steps, and at B 64 the gradients against the step
    # without remat
    remat = {}
    for impl, c, want in (
            ("pallas", cfg_t, {"text_attention_fwd": 2 * n_t,
                               "text_attention_bwd": n_t, **XENT_STEP}),
            ("pallas_block", cfg, {"attention_block_train_fwd": n_t,
                                   "attention_block_train_bwd": n_t,
                                   **XENT_STEP})):
        res, launches, n_params = timed_steps(dev, c.replace(remat=True),
                                              batches, lang)
        expect(f"remat {impl}", launches,
               {**{k: 3 * v for k, v in want.items()},
                "adamw_update_leaf": 3 * n_params})
        runs[f"remat_{impl}"] = launches
        steps[f"{impl}_remat"] = res
        with torch.enable_grad():
            worst, bad = remat_spread(dev, c, small)
        remat[impl] = dict(worst=worst, failures=bad[:10])
        print(json.dumps({"remat_vs_no_remat": {impl: remat[impl]}}),
              flush=True)
        if bad:
            raise SystemExit(f"remat {impl}: gradients differ from the step "
                             f"without remat: {remat[impl]}")
    steps["pallas_block_phase8"] = train_fused
    print(json.dumps({"train_steps_b240": steps, "card": card}), flush=True)

    # (d) "pallas" at the default dropouts trains on the plain bias path
    model_d = vilbert.train_model(cfg_p, seed=0, device=dev)
    with torch.enable_grad():
        _, _, launches = counted(lambda: train_grads(model_d, cfg_p, small,
                                                     5))
    expect("pallas train at attention dropout", launches, XENT_STEP)
    runs["pallas_train_dropout"] = launches
    del model_d, small, batches

    # (e) the attention bench's entry point, every variant, a few calls
    iters = 2
    res_e, secs, launches = counted(lambda: bench_attn.run(
        list(bench_attn.VARIANTS), iters=iters, dev=dev))
    calls = (bench_attn.SETS + bench_attn.REPS) * iters
    expect("bench_attn", launches, {"text_attention_fwd": calls,
                                    "attention_v2": 3 * calls})
    runs["bench_attn"] = launches
    print(json.dumps({"bench_attn": {n: r[0] for n, r in res_e.items()},
                      "iters": iters, "seconds": secs, "card": card}),
          flush=True)
    return res_a, steps


# ---------------------------------------------------------------------------
# phase 10: the attention-block bench
# ---------------------------------------------------------------------------

def phase_bench_block(dev, card, runs, iters=2):
    """``tools/bench_attn_block`` over its 13 variants, ``iters`` calls a
    measurement: per call round 2 B4 (block_b 1 and 2), 2 K2, 4 B10 and 3
    B11 launches. Smoke numbers: PERF.md's come from the tool's default
    ITERS."""
    from unimm_torch.tools import bench_attn, bench_attn_block
    res, secs, launches = counted(lambda: bench_attn_block.run(
        list(bench_attn_block.VARIANTS), iters=iters, dev=dev))
    calls = (bench_attn.SETS + bench_attn.REPS) * iters
    expect("bench_attn_block", launches,
           {"attention_block": 2 * calls, "ffn_block": 2 * calls,
            "probe_block": 4 * calls, "layout_probe_block": 3 * calls})
    runs["bench_attn_block"] = launches
    if not all(0 < r[0] < math.inf for r in res.values()):
        raise SystemExit(f"bench_attn_block: bad times {res}")
    print(json.dumps({"bench_attn_block": {n: r[0] for n, r in res.items()},
                      "iters": iters, "seconds": secs, "card": card}),
          flush=True)
    # each variant's kernels on the bench's first input set (core_launches
    # fails on a launch of FIRST_DESIGN); not counted, after the counted run
    fns = bench_attn_block.variants(
        bench_attn_block.make_layer(bench_attn_block.SHAPE[2], dev),
        bench_attn_block.SHAPE[2] // 64)
    x, desc = bench_attn_block.make_inputs(0, bench_attn_block.SHAPE, dev)
    print(json.dumps({"bench_attn_block_kernels": {
        n: core_launches(f"bench_attn_block {n}",
                         lambda f=f: f(x, desc))
        for n, f in fns.items()}, "card": card}), flush=True)


# ---------------------------------------------------------------------------
# phase 11: the evaluation command line
# ---------------------------------------------------------------------------

CLI_DIALOGS = dict(n_train=2, n_val=8, n_test=4)   # the fixture tree's
CLI_EVAL_BATCH, CLI_TEST_BATCH = 2, 4               # the CLIs' batch sizes
# the rate from files: val dialogs of the second tree, timed turns (each
# the loader alone, then val_lm) after one val_lm warm-up
CLI_RATE_VAL, CLI_RATE_TURNS = 12, 3


def cli_runs(n_val, n_test, n_t, n_c, coalesce=2, group=40, chunk=250,
             members=2):
    """Each CLI run's launch counts, from the code's own rules: the val
    split in batches of CLI_EVAL_BATCH dialogs of 10 rounds, merged by
    ``coalesce``; generative runs score every slate of a merged batch in
    ceil(slates / group) prefix groups (12 K1, 18 K2 and 1 K3 a group:
    every fixture slate is eligible, its context and answers fitting 256
    tokens); the ensemble runs score 100 options a slate through the flat
    scorer in ceil(sequences / chunk) chunks a merged batch (12 B4 and 18
    K2 a chunk a member); the test split has one slate a dialog, in
    batches of CLI_TEST_BATCH."""
    def merged(n, batch):
        sizes = [min(batch, n - i) for i in range(0, n, batch)]
        return [sum(sizes[i:i + coalesce])
                for i in range(0, len(sizes), coalesce)]
    g = sum(-(-10 * d // group) for d in merged(n_val, CLI_EVAL_BATCH))
    gen = {"answer_block": n_t * g, "ffn_block": (n_t + n_c) * g,
           "xent_head": g}
    ens = {}
    for name, n, batch, rounds in (("val", n_val, CLI_EVAL_BATCH, 10),
                                   ("evaluate", n_test, CLI_TEST_BATCH, 1)):
        c = members * sum(-(-d * rounds * 100 // chunk)
                          for d in merged(n, batch))
        ens[name] = {"attention_block": n_t * c, "ffn_block": (n_t + n_c) * c}
    return gen, ens


def top1(path):
    """The option each record of a predictions file ranks first."""
    with open(path) as f:
        return np.array([r["ranks"].index(1) for r in json.load(f)])


def cli_loader_seconds(argv):
    """Seconds to iterate a val_lm run's val loader alone (the CLI's
    dataset, reader and loader, no scoring) over the same dialogs."""
    from unimm_torch.cli import common, options
    from unimm_torch.data.dataset import VisdialDataset

    params = options.read_command_line(argv + ["-save_name", "loader"])
    dataset = VisdialDataset(params, common.load_tokenizer(params),
                             common.open_reader(params))
    dataset.split = "val"
    t0 = time.perf_counter()
    for _ in common.eval_loader(params, dataset, CLI_EVAL_BATCH):
        pass
    return time.perf_counter() - t0


class WaitTimed:
    """A loader whose consumer's waits for each batch are summed into
    ``waits[0]``: the seconds the evaluator spent blocked on the host data
    pipeline."""

    def __init__(self, loader, waits):
        self._loader, self._waits = loader, waits

    def __getattr__(self, name):
        return getattr(self._loader, name)

    def __len__(self):
        return len(self._loader)

    def __iter__(self):
        it = iter(self._loader)
        while True:
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            finally:
                self._waits[0] += time.perf_counter() - t
            yield batch


def spread(xs):
    """Median, least and most of a list of readings."""
    return {"median": float(np.median(xs)), "min": min(xs), "max": max(xs),
            "n": len(xs)}


def cli_rate(root, base, one, cfg, dev, card, eval_s):
    """The val_lm CLI's rate from files: a tree of CLI_RATE_VAL val
    dialogs at the config's widths (its features in a native-read LMDB),
    one val_lm run with the defaults as warm-up (not counted), then
    CLI_RATE_TURNS turns of the val loader alone and a timed val_lm run
    (launches as ``cli_runs`` derives them). Each run's evaluate call
    (``eval_s``), the seconds the evaluator waited in it for the loader's
    next batch (``wait_s``) and the loader alone, median and spread.
    ``eval_s``: the list phase_cli's evaluate_split wrapper appends to."""
    from unimm_torch.cli import common, val_lm
    from unimm_torch.data import features
    from unimm_torch.tools import fixture_tree

    paths, _, _ = fixture_tree.write_fixture_tree(
        str(root), n_train=2, n_val=CLI_RATE_VAL, n_test=1, seed=1,
        feat_dim=cfg.v_feature_size, n_classes=cfg.v_target_size)
    lmdb = str(root / "features.lmdb")
    features.convert_npz_to_lmdb(paths["visdial_image_feats"], lmdb)
    argv = list(base)
    for flag in ("visdial_processed_train", "visdial_processed_val",
                 "visdial_processed_test",
                 "visdial_processed_val_dense_annotations", "vocab_path"):
        argv[argv.index("-" + flag) + 1] = paths[flag]
    argv[argv.index("-visdial_image_feats") + 1] = lmdb
    argv += ["-val_dis", "0"] + one
    gen, _ = cli_runs(CLI_RATE_VAL, 1, cfg.num_hidden_layers,
                      len(cfg.t_biattention_id))
    waits = [0.0]
    real_loader = common.eval_loader
    common.eval_loader = lambda *a: WaitTimed(real_loader(*a), waits)
    res = {"main_s": [], "eval_s": [], "wait_s": [], "loader_alone_s": []}
    try:
        with contextlib.chdir(root):
            for turn in range(CLI_RATE_TURNS + 1):
                if turn:        # the warm-up run goes first, alone
                    res["loader_alone_s"].append(cli_loader_seconds(argv))
                eval_s.clear()
                waits[0] = 0.0
                _, secs, launches = counted(lambda: val_lm.main(
                    argv + ["-save_name", f"rate{turn}"], device=dev))
                expect(f"cli rate ({turn})", launches, gen)
                if turn:
                    res["main_s"].append(secs)
                    res["eval_s"].append(eval_s[0])
                    res["wait_s"].append(waits[0])
                else:
                    warm = dict(main_s=secs, eval_s=eval_s[0],
                                wait_s=waits[0])
    finally:
        common.eval_loader = real_loader
    rates = [CLI_RATE_VAL / t for t in res["eval_s"]]
    out = {"dialogs": CLI_RATE_VAL, "turns": CLI_RATE_TURNS, "warm_up": warm,
           **res, **{f"{k}_spread": spread(v) for k, v in res.items()},
           "dialogs_per_s": rates, "dialogs_per_s_spread": spread(rates),
           "wait_share": [w / e for w, e in zip(res["wait_s"],
                                                res["eval_s"])],
           "loader_alone_dialogs_per_s_median": CLI_RATE_VAL / float(
               np.median(res["loader_alone_s"])),
           "launches_per_run": gen, "card": card}
    print(json.dumps({"cli_rate": out}), flush=True)
    return out


def phase_cli(dev, card, runs):
    """The evaluation CLIs on the card at full width, through the entry
    points a user calls (``main(argv)``): the fixture tree of
    ``tools/fixture_tree.py`` at the config's widths (2048 features, 1601
    classes), its features converted to a reference-format LMDB that the
    native reader reads, reference-format .ckpt files written from seeded
    models' state dicts and loaded through -start_path / -model_paths, at
    -max_seq_len 256, -num_options 100, bf16. Runs: (a) val_lm with the
    defaults, (b) -attention_impl xla (no kernel), (c) -prefix_packed 0
    (the W layout: K1 at Rw 160), (d) -prefix_rowblock 32, (e) val_avg_lm,
    (f) val with two -model_paths, (g) evaluate on the test split; each
    counted, (b)-(d) ranking like (a) (top-1 agreement >=
    MIN_TOP1_AGREEMENT). Prints each run's wall seconds (the whole main
    and its evaluate call, the loader's host pipeline included), one
    reading each; then ``cli_rate``'s repeated val_lm runs on a larger
    tree."""
    import shutil
    from pathlib import Path

    from unimm_torch.cli import evaluate, val, val_avg_lm, val_lm
    from unimm_torch.config import VilbertConfig
    from unimm_torch.data import features
    from unimm_torch.eval import evaluator, prefix
    from unimm_torch.models import vilbert
    from unimm_torch.tools import fixture_tree

    here = Path(__file__).resolve().parent
    root = here / "build" / "unimm_torch" / "phase11"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    config = here / "config" / "bert_base_6layer_6conect.json"
    cfg = VilbertConfig.from_json_file(str(config))
    n_t, n_c = cfg.num_hidden_layers, len(cfg.t_biattention_id)
    t0 = time.perf_counter()
    paths, _, _ = fixture_tree.write_fixture_tree(
        str(root), feat_dim=cfg.v_feature_size, n_classes=cfg.v_target_size,
        **CLI_DIALOGS)
    lmdb = str(root / "features.lmdb")
    features.convert_npz_to_lmdb(paths["visdial_image_feats"], lmdb)
    backend = features.open_features(lmdb).db.backend
    if backend != "native":
        raise SystemExit(f"the LMDB reader is the {backend} one, not the "
                         "native one")
    ckpts = []
    for seed in (0, 1):
        model = vilbert.init_model(cfg, seed=seed, device=dev)
        path = str(root / f"member{seed}.ckpt")
        torch.save({"model_state_dict": {k: v.cpu() for k, v in
                                         model.state_dict().items()},
                    "iter_id": 0}, path)
        ckpts.append(path)
        del model
    setup_s = time.perf_counter() - t0
    base = ["-visdial_processed_train", paths["visdial_processed_train"],
            "-visdial_processed_val", paths["visdial_processed_val"],
            "-visdial_processed_test", paths["visdial_processed_test"],
            "-visdial_processed_val_dense_annotations",
            paths["visdial_processed_val_dense_annotations"],
            "-visdial_image_feats", lmdb, "-vocab_path", paths["vocab_path"],
            "-model_config", str(config), "-max_seq_len", "256",
            "-num_options", "100", "-num_workers", "4",
            "-save_path", str(root / "ckpt")]
    one = ["-start_path", ckpts[0]]
    two = ["-model_paths", ",".join(ckpts)]
    gen, ens = cli_runs(CLI_DIALOGS["n_val"], CLI_DIALOGS["n_test"], n_t, n_c)
    plan = [  # name, entry, argv, launches, row blocks K1 may take
        ("a", val_lm, ["-val_dis", "0"] + one, gen, {64, 256}),
        ("b", val_lm, ["-val_dis", "0", "-attention_impl", "xla"] + one, {},
         set()),
        ("c", val_lm, ["-val_dis", "0", "-prefix_packed", "0"] + one, gen,
         {160}),
        ("d", val_lm, ["-val_dis", "0", "-prefix_rowblock", "32"] + one, gen,
         {32}),
        ("e", val_avg_lm, ["-val_dis", "0"] + one, gen, {64, 256}),
        ("f", val, two, ens["val"], set()),
        ("g", evaluate, two, ens["evaluate"], set()),
    ]
    # K1's row blocks and each run's evaluate call, seen through wrappers
    real_k1, real_split, real_ens = (prefix.answer_block,
                                     evaluator.evaluate_split,
                                     evaluator.evaluate_ensemble)
    seen, eval_s = set(), []

    def k1(x, kc, vc, b_ctx, b_rr, *a, **kw):
        seen.add(b_rr.shape[-1])
        return real_k1(x, kc, vc, b_ctx, b_rr, *a, **kw)

    def timed(fn):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            eval_s.append(time.perf_counter() - t)
            return out
        return run

    res = {}
    prefix.answer_block = k1
    evaluator.evaluate_split = timed(real_split)
    evaluator.evaluate_ensemble = timed(real_ens)
    try:
        with contextlib.chdir(root):
            for name, mod, argv, want, rbs in plan:
                seen.clear()
                eval_s.clear()
                metrics, secs, launches = counted(lambda: mod.main(
                    base + argv + ["-save_name", name], device=dev))
                expect(f"cli ({name})", launches, want)
                if name in "acde" and not (seen and seen <= rbs):
                    raise SystemExit(f"cli ({name}): K1 row blocks {seen}, "
                                     f"want {rbs}")
                if name == "b" and seen:
                    raise SystemExit(f"cli (b): K1 launched at {seen}")
                dialogs = CLI_DIALOGS["n_test" if name == "g" else "n_val"]
                if metrics is not None and not all(
                        math.isfinite(v) for v in metrics.values()):
                    raise SystemExit(f"cli ({name}): metrics {metrics}")
                runs[f"cli_{name}"] = launches
                res[name] = dict(
                    entry=mod.__name__.rsplit(".", 1)[1], argv=argv,
                    launches=launches, k1_row_blocks=sorted(seen),
                    main_s=secs, eval_s=eval_s[0], dialogs=dialogs,
                    dialogs_per_s=dialogs / eval_s[0],
                    ndcg=None if metrics is None else metrics["ndcg"],
                    mrr=None if metrics is None else metrics["mrr"])
                print(json.dumps({"cli": name, **res[name], "card": card}),
                      flush=True)
            a = top1("a_predictions.txt")
            agree = {k: float((top1(f"{k}_predictions.txt") == a).mean())
                     for k in "bcd"}
            with open("g_predictions.txt") as f:
                recs = json.load(f)
        rate = cli_rate(root / "rate", base, one, cfg, dev, card, eval_s)
    finally:
        prefix.answer_block = real_k1
        evaluator.evaluate_split = real_split
        evaluator.evaluate_ensemble = real_ens
    print(json.dumps({"cli_top1_agreement_vs_a": agree, "records": len(a),
                      "min_agreement": MIN_TOP1_AGREEMENT}), flush=True)
    if min(agree.values()) < MIN_TOP1_AGREEMENT:
        raise SystemExit(f"cli: top-1 agreement {agree}")
    if len(a) != 10 * CLI_DIALOGS["n_val"]:
        raise SystemExit(f"cli (a): {len(a)} predictions")
    if len(recs) != CLI_DIALOGS["n_test"] or any(
            sorted(r["ranks"]) != list(range(1, 101)) or r["round_id"] != 10
            for r in recs):
        raise SystemExit("cli (g): the EvalAI file is not one record of "
                         "100 ranks per test dialog")
    print(json.dumps({"cli_phase": {
        "lmdb_reader": backend, "setup_s": setup_s, "card": card}}),
        flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return res, rate


# ---------------------------------------------------------------------------
# phase 12: the training command line
# ---------------------------------------------------------------------------

# the fixture tree's dialogs: 3 loader batches of 30 images an epoch at
# -batch_size 240 -sequences_per_image 8; 4 val dialogs (one eval batch)
TRAIN_CLI_DIALOGS = dict(n_train=90, n_val=4, n_test=1)
TRAIN_CLI_STEPS = 3                  # loader batches (steps) an epoch
DENSE_STEPS = 5                      # -overfit: 5 dialogs, one step each


class StepRecorder:
    """Wraps the CLIs' step functions: each step waits for the card at its
    end and records its seconds, its loss (a device scalar), the batch's
    rows and length, and whether the slate's GT is first (a dense slate:
    NSP label 0 on the first row only)."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.secs, self.loss, self.rows, self.lengths, self.gt_first = (
            [], [], [], [], [])
        self.parts = []

    def wrap(self, fn):
        def run(state, batch, *a, **kw):
            t = time.perf_counter()
            out = fn(state, batch, *a, **kw)
            torch.cuda.synchronize()
            self.secs.append(time.perf_counter() - t)
            self.loss.append(out[1]["loss"])
            self.parts.append(out[1])
            self.rows.append(int(batch["tokens"].shape[0]))
            self.lengths.append(int(batch["tokens"].shape[1]))
            nsp = batch["next_sentence_label"]
            self.gt_first.append(bool(nsp[0] == 0 and (nsp[1:] == 1).all()))
            return out
        return run

    def summary(self):
        losses = [float(v) for v in self.loss]
        if not all(math.isfinite(v) for v in losses):
            raise SystemExit(f"non-finite loss {losses}")
        later = self.secs[1:]
        return dict(steps=len(self.secs), losses=losses,
                    rows=sorted(set(self.rows)), lengths=self.lengths,
                    first_step_s=self.secs[0] if self.secs else None,
                    ms_per_step_after_first=(sum(later) / len(later) * 1e3
                                             if later else None))


def phase_train_cli(dev, card, runs, train_b, config=None, max_seq_len=256):
    """The training CLIs on the card at full width through ``main(argv)``
    (``python -m unimm_torch.cli.train`` / ``dense_finetune``): a fixture
    tree at the config's widths (2048 features, 1601 classes; 90 train and
    4 val dialogs; its features in a native-read LMDB), the default config
    file at -max_seq_len 256, bf16, a seeded reference-format start .ckpt,
    -batch_size 240 -sequences_per_image 8 (30 images, 3 steps an epoch).
    Runs, each counted: (a) train 2 epochs, -save_every_epochs 1
    -eval_every_epochs 2 -fused_adamw 1; (b) -continue from (a)'s native
    directory (the restored state equal to (a)'s tensors bit for bit, the
    step going on from (a)'s); (c) -continue from (a)'s .ckpt (the Adam
    count restored above 0); (d) (a)'s command relaunched with
    -auto_resume does nothing (no launch, no file written); (e)
    -batch_multiply 2 -length_buckets 1
    (B5 at the morsels' bucket lengths); (f) val_lm from (a)'s .ckpt; (g)
    dense_finetune -overfit from (a)'s .ckpt (100 options a step, the GT
    first). Launches as derived from the code: 12 + 12 B5 and one
    xent_train_fwd / _bwd a micro-step, one B7 a parameter tensor an update, 12 B4 / 18 K2 an eval chunk, 12
    K1 / 18 K2 / 1 K3 a slate group. Every loss finite. Prints each run's
    wall seconds, the training runs' mean ms a step after the first (each
    step timed to the card's idle) and the seconds their loop waited for
    the loader: single readings, a functional check."""
    import shutil
    from pathlib import Path

    from unimm_torch import checkpoint as C
    from unimm_torch.cli import dense_finetune, train, val_lm
    from unimm_torch.config import VilbertConfig
    from unimm_torch.data import features
    from unimm_torch.models import vilbert
    from unimm_torch.tools import fixture_tree
    from unimm_torch.train import step as tstep

    here = Path(__file__).resolve().parent
    root = here / "build" / "unimm_torch" / "phase12"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    config = config or here / "config" / "bert_base_6layer_6conect.json"
    cfg = VilbertConfig.from_json_file(str(config)).replace(
        max_seq_len=max_seq_len)
    n_t, n_c = cfg.num_hidden_layers, len(cfg.t_biattention_id)
    t0 = time.perf_counter()
    paths, _, _ = fixture_tree.write_fixture_tree(
        str(root), feat_dim=cfg.v_feature_size, n_classes=cfg.v_target_size,
        **TRAIN_CLI_DIALOGS)
    lmdb = str(root / "features.lmdb")
    features.convert_npz_to_lmdb(paths["visdial_image_feats"], lmdb)
    model = vilbert.init_model(cfg, seed=0, device=dev)
    n_params = len(list(model.parameters()))
    start = str(root / "start.ckpt")
    C.save_reference_ckpt(start, model)
    del model
    setup_s = time.perf_counter() - t0
    flags = ("visdial_processed_train", "visdial_processed_val",
             "visdial_processed_test", "visdial_processed_train_dense",
             "visdial_processed_train_dense_annotations",
             "visdial_processed_val_dense_annotations", "vocab_path")
    base = [a for f in flags for a in ("-" + f, paths[f])] + [
        "-visdial_image_feats", lmdb, "-model_config", str(config),
        "-max_seq_len", str(max_seq_len), "-num_options", "100",
        "-num_workers", "4", "-batch_size", "240",
        "-sequences_per_image", "8",
        "-language_weights", str(here / "config" / "language_weights.json"),
        "-save_path", str(root / "ckpt")]
    per_step = {"attention_block_train_fwd": n_t,
                "attention_block_train_bwd": n_t, **XENT_STEP}

    def per(d, k):
        return {name: n * k for name, n in d.items()}

    def files_of(d):
        """Each file under ``d`` with its size and modification time."""
        return sorted((str(f), f.stat().st_size, f.stat().st_mtime_ns)
                      for f in Path(d).rglob("*") if f.is_file())

    def train_want(micro, updates, eval_chunks=0):
        want = per(per_step, micro)
        want["adamw_update_leaf"] = n_params * updates
        if eval_chunks:
            want["attention_block"] = n_t * eval_chunks
            want["ffn_block"] = (n_t + n_c) * eval_chunks
        return want

    # the epoch-2 eval: one batch of 4 val dialogs, 4000 sequences in
    # chunks of 250
    eval_chunks = -(-TRAIN_CLI_DIALOGS["n_val"] * 10 * 100 // 250)
    gen, _ = cli_runs(TRAIN_CLI_DIALOGS["n_val"], 1, n_t, n_c)
    fused = ["-fused_adamw", "1"]
    a_args = ["-num_epochs", "2", "-save_every_epochs", "1",
              "-eval_every_epochs", "2", "-start_path", start] + fused
    one = ["-num_epochs", "1", "-save_every_epochs", "2",
           "-eval_every_epochs", "2"] + fused
    a_ckpt = str(root / "ckpt" / "a" /
                 f"visdial_dialog_encoder_{2 * TRAIN_CLI_STEPS}.ckpt")
    steps = TRAIN_CLI_STEPS
    plan = [  # name, entry, argv, launches, steps after the run
        ("a", train, a_args, train_want(2 * steps, 2 * steps, eval_chunks),
         2 * steps),
        ("b", train, one + ["-continue", "-start_path",
                            str(root / "ckpt" / "a" / "native")],
         train_want(steps, steps), 3 * steps),
        ("c", train, one + ["-continue", "-start_path", a_ckpt],
         train_want(steps, steps), 3 * steps),
        ("d", train, a_args + ["-auto_resume"], {}, 2 * steps),
        ("e", train, ["-num_epochs", "1", "-save_every_epochs", "2",
                      "-eval_every_epochs", "2", "-batch_multiply", "2",
                      "-length_buckets", "1", "-start_path", start] + fused,
         train_want(steps, 1), steps),
        ("f", val_lm, ["-val_dis", "0", "-start_path", a_ckpt], gen, None),
        ("g", dense_finetune, ["-overfit", "-num_epochs", "1",
                               "-start_path", a_ckpt] + fused,
         train_want(DENSE_STEPS, DENSE_STEPS), DENSE_STEPS),
    ]
    rec, waits, checks = StepRecorder(), [0.0], {}
    real = (tstep.make_train_step_with_fallback,
            dense_finetune.make_dense_step, train.DataLoader,
            dense_finetune.DataLoader, C.restore_native,
            C.load_reference_train_state)
    kept = {}

    def loader(*a, **kw):      # the training loaders' waits, timed
        ld = real[2](*a, **kw)
        return WaitTimed(ld, waits) if kw.get("shuffle") else ld

    def restore_native(path, state):
        out = real[4](path, state)
        if "a" not in kept:
            return out
        want = kept["a"]
        o, w = out["opt"], want["opt"]
        same = (out["step"] == want["step"] and out["seed"] == want["seed"]
                and (o.count, o.sched_count, o.mini_step) == (
                    w.count, w.sched_count, w.mini_step)
                and all(torch.equal(x, y) for x, y in zip(
                    list(out["model"].parameters()) + o.mu + o.nu,
                    list(want["model"].parameters()) + w.mu + w.nu)))
        checks["b_restored_bit_equal"] = same
        return out

    def load_train_state(*a, **kw):
        out = real[5](*a, **kw)
        checks.setdefault("restored_adam_count", out[1].count)
        return out

    tstep.make_train_step_with_fallback = (
        lambda *a, **kw: rec.wrap(real[0](*a, **kw)))
    dense_finetune.make_dense_step = lambda *a, **kw: rec.wrap(
        real[1](*a, **kw))
    train.DataLoader = dense_finetune.DataLoader = loader
    C.restore_native, C.load_reference_train_state = (restore_native,
                                                      load_train_state)
    res = {}
    try:
        with contextlib.chdir(root):
            for name, mod, argv, want, want_step in plan:
                rec.clear()
                waits[0] = 0.0
                checks.pop("restored_adam_count", None)
                # (d) relaunches (a)'s run under its name
                save = "a" if name == "d" else name
                before = files_of(root / "ckpt" / "a")
                out, secs, launches = counted(lambda: mod.main(
                    base + argv + ["-save_name", save], device=dev))
                expect(f"train cli ({name})", launches, want)
                if name == "d" and files_of(root / "ckpt" / "a") != before:
                    raise SystemExit("train cli (d): the relaunch of a "
                                     "complete run wrote files")
                runs[f"train_cli_{name}"] = launches
                r = dict(entry=mod.__name__.rsplit(".", 1)[1], argv=argv,
                         launches=launches, main_s=secs,
                         loader_wait_s=waits[0], **rec.summary())
                if want_step is not None:
                    r["step"] = out["step"]
                    if out["step"] != want_step:
                        raise SystemExit(f"train cli ({name}): step "
                                         f"{out['step']}, want {want_step}")
                if name == "a":
                    kept["a"] = out
                    # keep the latest save only: each is ~3 GB twice
                    shutil.rmtree(root / "ckpt" / "a" / "native" /
                                  f"step_{steps}")
                    (root / "ckpt" / "a" /
                     f"visdial_dialog_encoder_{steps}.ckpt").unlink()
                elif name == "b":
                    if not checks.get("b_restored_bit_equal"):
                        raise SystemExit("train cli (b): the restored state "
                                         "differs from (a)'s")
                    del kept["a"]
                elif name == "c":
                    r["restored_adam_count"] = checks["restored_adam_count"]
                    if not checks["restored_adam_count"] > 0:
                        raise SystemExit("train cli (c): Adam count 0")
                elif name == "e":
                    r["bucket_lengths"] = sorted(set(r["lengths"]))
                    if min(r["lengths"]) >= cfg.max_seq_len:
                        raise SystemExit("train cli (e): no morsel below "
                                         f"{cfg.max_seq_len}: {r['lengths']}")
                elif name == "f":
                    r["ndcg"], r["mrr"] = out["ndcg"], out["mrr"]
                    if not all(math.isfinite(v) for v in out.values()):
                        raise SystemExit(f"train cli (f): metrics {out}")
                elif name == "g":
                    if r["rows"] != [100] or not all(rec.gt_first):
                        raise SystemExit(
                            f"train cli (g): slates {r['rows']}, GT first "
                            f"{rec.gt_first}")
                out = None
                res[name] = r
                print(json.dumps({"train_cli": name, **r, "card": card}),
                      flush=True)
    finally:
        (tstep.make_train_step_with_fallback, dense_finetune.make_dense_step,
         train.DataLoader, dense_finetune.DataLoader, C.restore_native,
         C.load_reference_train_state) = real
    print(json.dumps({"train_cli_phase": {
        "setup_s": setup_s, "parameter_tensors": n_params,
        "phase8_b_ms_per_step": {k: v["ms_per_step"]
                                 for k, v in train_b.items()},
        "card": card}}), flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phase 13: the data-parallel world (two ranks on the one card)
# ---------------------------------------------------------------------------

# the tree: 24 train dialogs (2 steps of 12 images at -batch_size 240
# -sequences_per_image 20: every sequence of an image, so no subsample and
# the same global batch for one rank or two), 9 val dialogs (the global
# batch of 2 leaves a one-dialog tail) and a second tree of 2 dense dialogs
DIST_DIALOGS = dict(n_train=24, n_val=9, n_test=1)
DIST_DENSE = 2
DIST_TIMEOUT_S = 300


class ScoreRecorder:
    """Wraps ``RankingEvaluator.score_slates_async``: each observed (valid)
    dialog's [R, O] ll_sum scores, by image id, as the batch is
    fetched."""

    def __init__(self):
        self.scores = {}

    def wrap(self, fn):
        rec = self

        def run(ev, model, batch):
            fin = fn(ev, model, batch)
            B, R, O = np.asarray(batch["tokens"]).shape[:3]
            ids = np.asarray(batch["image_id"])
            valid = np.asarray(batch.get("valid", np.ones(B, bool)))

            def finalize():
                out = fin()
                s = out["ll_sum"].reshape(B, R, O)
                for b in np.nonzero(valid)[0]:
                    rec.scores[int(ids[b])] = s[b].copy()
                return out
            return finalize
        return run


def state_sha256(model, opt=None):
    """SHA-256s of a training state's whole tensors (a sharded model's
    gathered over the mp group, a bucket at a time to the host: a
    collective): ``digests``, each tensor's own (``w/<name>``, and with
    ``opt`` ``mu/<name>`` and ``nu/<name>``), to name the tensors where
    two states differ, and over them, in order, ``weights_sha256`` and
    with ``opt`` ``moments_sha256``; on a sharded model also
    ``replicated_sha256``, over the parameters this rank holds whole."""
    import hashlib

    from unimm_torch.parallel import mesh

    each = {}

    def digest(tag, items):
        h = hashlib.sha256()
        for n, a in mesh.whole(model, items, lambda t: t.detach().float()
                               .cpu().numpy()):
            d = hashlib.sha256(a).hexdigest()
            each[f"{tag}/{n}"] = d
            h.update(d.encode())
        return h.hexdigest()

    out = {"weights_sha256": digest("w", model.named_parameters())}
    lay = mesh.layout(model)
    if lay is not None:
        out["replicated_sha256"] = hashlib.sha256("".join(
            each[f"w/{n}"] for n, _ in model.named_parameters()
            if n not in lay.dims).encode()).hexdigest()
    if opt is not None:
        out["moments_sha256"] = hashlib.sha256((
            digest("mu", zip(opt.names, opt.mu))
            + digest("nu", zip(opt.names, opt.nu))).encode()).hexdigest()
    out["digests"] = each
    return out


def state_bytes(model, opt) -> int:
    """The bytes of the training state a rank holds: its parameters (each
    counted once more for its gradient) and its moments."""
    n = sum(p.numel() * p.element_size() * 2 for p in model.parameters())
    return n + sum(t.numel() * t.element_size() for t in opt.mu + opt.nu)


def shown(obj):
    """``obj`` without the runs' per-tensor ``digests``, for a printed
    line."""
    if isinstance(obj, dict):
        return {k: shown(v) for k, v in obj.items() if k != "digests"}
    if isinstance(obj, list):
        return [shown(v) for v in obj]
    return obj


def differ(a, b):
    """The names whose digests differ between two runs' records."""
    return sorted(k for k in a["digests"] if a["digests"][k] !=
                  b["digests"].get(k))


def dist_run(entry, argv, dev, backend=None, moments=False):
    """One CLI run through ``main(argv)``, counted, with its scores (gen
    runs), its steps (training runs), its peak memory (over the run, and
    since ``mesh.shard_model``), each collective in a world
    (``dist.allreduce_sum_``, ``dist.broadcast_`` and the mp gather
    ``mesh.gather_whole``: the card waits before and after each; its MiB
    and ms) and, for a training run, the bytes of the fp32 state it holds
    and the SHA-256s of its whole weights (and under ``moments`` its
    moments; ``state_sha256``).
    Returns a JSON-able record and the scores by image id."""
    from unimm_torch.cli import dense_finetune, train, val_lm
    from unimm_torch.eval import evaluator
    from unimm_torch.parallel import dist, mesh
    from unimm_torch.train import step as tstep

    mod = {"val_lm": val_lm, "train": train,
           "dense_finetune": dense_finetune}[entry]
    scores, rec, colls, peaks = ScoreRecorder(), StepRecorder(), [], []
    real = (evaluator.RankingEvaluator.score_slates_async,
            tstep.make_train_step_with_fallback,
            dense_finetune.make_dense_step, dist.allreduce_sum_,
            dist.broadcast_, mesh.gather_whole, mesh.shard_model)

    def timed(name, fn, mib, axis):
        def run(*a, **kw):
            if not dist.active() or dist.axis_size(
                    kw.get("over", axis)) == 1:
                return fn(*a, **kw)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            colls.append({"op": name, "mib": mib(*a, **kw) / 2**20,
                          "ms": (time.perf_counter() - t) * 1e3})
            return out
        return run

    def nbytes(tensors, **kw):
        return sum(x.numel() * x.element_size() for x in tensors)

    def gathered(model, tensors):
        # the bytes this rank receives: the sharded tensors' other slices
        lay = mesh.layout(model)
        if lay is None:
            return 0
        return nbytes(t for n, t in tensors.items()
                      if n in lay.dims) * (lay.size - 1)

    def shard(model):
        model = real[6](model)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)
        return model

    evaluator.RankingEvaluator.score_slates_async = scores.wrap(real[0])
    tstep.make_train_step_with_fallback = (
        lambda *a, **kw: rec.wrap(real[1](*a, **kw)))
    dense_finetune.make_dense_step = lambda *a, **kw: rec.wrap(
        real[2](*a, **kw))
    dist.allreduce_sum_ = timed("allreduce_sum_", real[3], nbytes,
                                dist.WORLD)
    dist.broadcast_ = timed("broadcast_", real[4], nbytes, dist.MP)
    mesh.gather_whole = timed("gather_whole", real[5], gathered, dist.MP)
    mesh.shard_model = shard
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        out, secs, launches = counted(lambda: mod.main(
            argv, device=dev, backend=backend))
    finally:
        (evaluator.RankingEvaluator.score_slates_async,
         tstep.make_train_step_with_fallback,
         dense_finetune.make_dense_step, dist.allreduce_sum_,
         dist.broadcast_, mesh.gather_whole, mesh.shard_model) = real
    after = torch.cuda.max_memory_allocated(dev)
    r = dict(entry=entry, launches=launches, main_s=secs,
             peak_gib=max(peaks + [after]) / 2**30,
             peak_after_shard_gib=after / 2**30 if peaks else None,
             collectives=colls, grid=[dist.dp_rank(), dist.dp_size(),
                                      dist.mp_rank(), dist.mp_size()])
    if entry == "val_lm":
        r["metrics"] = out
    else:
        r.update(rec.summary(), step=out["step"],
                 state_gib=state_bytes(out["model"], out["opt"]) / 2**30,
                 parts=[{k: float(v) for k, v in p.items()}
                        for p in rec.parts],
                 **state_sha256(out["model"],
                                out["opt"] if moments else None))
    return r, scores.scores


def main_world_rank(spec_path, rank):
    """``--world-rank SPEC RANK``: one rank process of phase 13 or 14. Runs
    the spec's CLI runs in order (each joining the world through the flags
    unless the run says ``"world": false``; ``"moments": true`` hashes the
    Adam moments too), prints one JSON line a run and writes each gen
    run's scores to ``<out>/<run>_<rank>.npz``."""
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(spec["device"])
    torch.empty(0, device=dev)      # the card's context, for its counters
    flags = ["-coordinator_address", f"127.0.0.1:{spec['port']}",
             "-num_processes", str(spec["world"]), "-process_id", str(rank)]
    for run in spec["runs"]:
        argv = run["argv"] + (flags if run.get("world", True) else [])
        r, scores = dist_run(run["entry"], argv, dev,
                             spec["backend"] if run.get("world", True)
                             else None, run.get("moments", False))
        if scores:
            np.savez(os.path.join(spec["out"], f"{run['name']}_{rank}.npz"),
                     **{str(k): v for k, v in scores.items()})
        print(json.dumps({"world_run": run["name"], "rank": rank, **r}),
              flush=True)
    return 0


def spawn_world(spec, out, n):
    """Start ``n`` rank processes of ``spec`` (this script with
    --world-rank), each writing its output to a file under ``out`` (a
    pipe would block a rank whose output outgrew it while another rank's
    was being read, and its peers with it in their next collective), and
    wait for them; a rank that fails, or a world that outlives
    DIST_TIMEOUT_S, fails the phase with the ranks' output. Returns
    {(run, rank): record} and the world's seconds from start to exit."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    name = spec.get("name", spec["backend"])
    spec = dict(spec, port=s.getsockname()[1], world=n, out=str(out))
    s.close()
    path = out / f"spec_{name}.json"
    path.write_text(json.dumps(spec))
    logs = [out / f"{name}_rank{r}.log" for r in range(n)]
    t0 = time.perf_counter()
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--world-rank", str(path), str(r)],
                stdout=f, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=max(0.0, t0 + DIST_TIMEOUT_S - time.perf_counter()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        tails = "\n".join(f"rank {r}: ...{log.read_text()[-3000:]}"
                          for r, log in enumerate(logs))
        raise SystemExit(f"world ({name}): outlived {DIST_TIMEOUT_S} s\n"
                         f"{tails}")
    secs = time.perf_counter() - t0
    outs = [log.read_text() for log in logs]
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise SystemExit(f"world ({name}) rank {r} exited "
                             f"{p.returncode}:\n{o[-6000:]}")
    recs = {}
    for o in outs:
        for line in o.splitlines():
            if line.startswith('{"world_run"'):
                d = json.loads(line)
                recs[(d.pop("world_run"), d.pop("rank"))] = d
    return recs, secs


def load_scores(path):
    with np.load(path) as z:
        return {int(k): v for k, v in z.items()}


def score_gap(got, want):
    """(largest |d ll_sum| over the shared dialogs, top-1 agreement of the
    rounds) of two {image id: [R, O]} score dicts over the same dialogs."""
    if sorted(got) != sorted(want):
        raise SystemExit(f"world: dialogs {sorted(got)} != {sorted(want)}")
    g = np.stack([got[k] for k in sorted(got)])
    w = np.stack([want[k] for k in sorted(want)])
    return (float(np.abs(g - w).max()),
            float((g.argmax(-1) == w.argmax(-1)).mean()))


def world_tree(name, dev, config=None, max_seq_len=256):
    """Phases 13 and 14's setting under build/unimm_torch/<name>/: the
    fixture tree of DIST_DIALOGS at the config's widths (its features in a
    native-read LMDB), a second tree of DIST_DENSE dense dialogs, the
    config (the default file unless ``config``) and its zero-dropout copy,
    a seeded start .ckpt, the CLIs' common argv (-batch_size 240
    -sequences_per_image 20) and val_lm's data-sharded argv, and the
    launch counts of a training run of n steps (``train_want``) and of
    val_lm over loader batches of given dialog counts (``gen_want``)."""
    import shutil
    from pathlib import Path

    from unimm_torch import checkpoint as C
    from unimm_torch.config import VilbertConfig
    from unimm_torch.data import features
    from unimm_torch.models import vilbert
    from unimm_torch.tools import fixture_tree

    here = Path(__file__).resolve().parent
    root = here / "build" / "unimm_torch" / name
    shutil.rmtree(root, ignore_errors=True)
    out = root / "out"
    out.mkdir(parents=True)
    config = Path(config or here / "config" / "bert_base_6layer_6conect.json")
    cfg = VilbertConfig.from_json_file(str(config)).replace(
        max_seq_len=max_seq_len)
    n_t, n_c = cfg.num_hidden_layers, len(cfg.t_biattention_id)
    nodrop = root / "nodrop.json"
    nodrop.write_text(json.dumps(dict(json.loads(config.read_text()),
                                      **NO_DROPOUT)))
    t0 = time.perf_counter()
    paths, _, _ = fixture_tree.write_fixture_tree(
        str(root), feat_dim=cfg.v_feature_size, n_classes=cfg.v_target_size,
        **DIST_DIALOGS)
    dense, _, _ = fixture_tree.write_fixture_tree(
        str(root / "dense"), n_train=DIST_DENSE, n_val=1, n_test=1,
        feat_dim=cfg.v_feature_size, n_classes=cfg.v_target_size)
    lmdb = str(root / "features.lmdb")
    features.convert_npz_to_lmdb(paths["visdial_image_feats"], lmdb)
    model = vilbert.init_model(cfg, seed=0, device=dev)
    n_params = len(list(model.parameters()))
    start = str(root / "start.ckpt")
    C.save_reference_ckpt(start, model)
    del model
    setup_s = time.perf_counter() - t0
    flags = ("visdial_processed_train", "visdial_processed_val",
             "visdial_processed_test",
             "visdial_processed_val_dense_annotations", "vocab_path")
    base = [a for f in flags for a in ("-" + f, paths[f])] + [
        "-visdial_processed_train_dense",
        dense["visdial_processed_train_dense"],
        "-visdial_processed_train_dense_annotations",
        dense["visdial_processed_train_dense_annotations"],
        "-visdial_image_feats", lmdb, "-max_seq_len", str(max_seq_len),
        "-num_options", "100", "-num_workers", "4", "-batch_size", "240",
        "-sequences_per_image", "20", "-num_negative_samples", "1",
        "-language_weights", str(here / "config" / "language_weights.json"),
        "-save_path", str(root / "ckpt")]
    lm = base + ["-model_config", str(config), "-val_dis", "0",
                 "-start_path", start, "-eval_data_sharded", "1"]
    per_step = {"attention_block_train_fwd": n_t,
                "attention_block_train_bwd": n_t, **XENT_STEP}

    def train_want(steps):
        return dict({k: v * steps for k, v in per_step.items()},
                    adamw_update_leaf=n_params * steps)

    def gen_want(dialog_batches):
        """K1 / K2 / K3 of val_lm over loader batches of these dialog
        counts, coalesced by 2, 40 slates a prefix group."""
        merged = [sum(dialog_batches[i:i + 2])
                  for i in range(0, len(dialog_batches), 2)]
        g = sum(-(-10 * d // 40) for d in merged)
        return {"answer_block": n_t * g, "ffn_block": (n_t + n_c) * g,
                "xent_head": g}

    return SimpleNamespace(root=root, out=out, config=config, nodrop=nodrop,
                           n_params=n_params, start=start, base=base, lm=lm,
                           setup_s=setup_s, train_want=train_want,
                           gen_want=gen_want)


def phase_dist(dev, card, runs, config=None, max_seq_len=256,
               rank_device="cuda:0", one_backend="nccl"):
    """The data-parallel world on the card at full width, through the
    entry points a user runs in each rank (``main(argv)`` with
    ``-coordinator_address -num_processes -process_id``): two rank
    processes on the one card (``device="cuda:0"`` on both; backend gloo,
    passed explicitly: NCCL takes one rank a device), against one-process
    runs of the same commands in this process. (a) val_lm
    -eval_data_sharded 1 over 9 val dialogs (rank 1's last batch is tail
    padding): every record once in the merged file, each dialog's scores
    and the metrics against the one-process run (top-1 agreement >=
    MIN_TOP1_AGREEMENT); (b) val_lm serving (each rank scores half of
    every prefix group): the same checks, K1 / K2 / K3 launches a rank;
    (c) train, 2 ranks x 120 sequences against 1 rank x 240 (the same
    global batches: every sequence of 12 images a step), dropout 0, 2
    steps from one start .ckpt, -fused_adamw 1: the ranks' weights
    bit-equal, every loss part within LOSS_RTOL of the one-rank run's,
    12 + 12 B5, one xent_train_fwd / _bwd and 534 B7 a rank and step,
    each rank's peak memory and ms a step beside its gradient
    all-reduce's ms; (d) dense_finetune, 2 steps, the 100-option slate
    split 50 / 50: as (c). (e) one rank under NCCL (the backend's default
    on a card): one train step and a data-sharded val_lm, each bit-equal to the same
    command without the flags. ``config`` / ``max_seq_len`` /
    ``rank_device`` / ``one_backend`` rehearse it on the CPU at TINY size
    (with ``torch.cuda``'s calls and ``expect`` stubbed in every
    process)."""
    import shutil

    t = world_tree("phase13", dev, config, max_seq_len)
    root, out, config, n_params = t.root, t.out, t.config, t.n_params
    start, lm, train_want, gen_want = t.start, t.lm, t.train_want, t.gen_want
    fit = t.base + ["-model_config", str(t.nodrop), "-num_epochs", "1",
                    "-save_every_epochs", "2", "-eval_every_epochs", "2",
                    "-fused_adamw", "1", "-start_path", start]
    n_val = DIST_DIALOGS["n_val"]
    serve_batches = [min(2, n_val - i) for i in range(0, n_val, 2)]
    shard_batches = [1] * len(serve_batches)       # one dialog a rank each
    res = {"setup_s": t.setup_s, "card": card}
    with contextlib.chdir(root):
        # the one-process runs
        ref = {}
        for name, entry, argv, want in (
                ("lm", "val_lm", lm + ["-save_name", "ref_lm"],
                 gen_want(serve_batches)),
                ("train", "train", fit + ["-save_name", "ref_train"],
                 train_want(2)),
                ("dense", "dense_finetune",
                 fit + ["-save_name", "ref_dense"], train_want(DIST_DENSE))):
            r, scores = dist_run(entry, argv, dev)
            expect(f"world one-process {name}", r["launches"], want)
            runs[f"dist_ref_{name}"] = r["launches"]
            ref[name] = (r, scores)
            print(json.dumps(shown({"world_ref": name, **r, "card": card})),
                  flush=True)
        torch.cuda.empty_cache()
        # (a)-(d): two ranks on the one card under gloo
        plan = [
            {"name": "a", "entry": "val_lm", "argv": lm + [
                "-save_name", "a"]},
            {"name": "b", "entry": "val_lm", "argv": lm[:-2] + [
                "-save_name", "b"]},
            {"name": "c", "entry": "train", "argv": fit + [
                "-save_name", "c"]},
            {"name": "d", "entry": "dense_finetune", "argv": fit + [
                "-save_name", "d"]}]
        recs, secs = spawn_world({"device": rank_device, "backend": "gloo",
                                  "runs": plan}, out, 2)
        res["world_s"] = secs
        wants = {"a": gen_want(shard_batches), "b": gen_want(serve_batches),
                 "c": train_want(2), "d": train_want(DIST_DENSE)}
        ref_file = top1_by_record(root / "ref_lm_predictions.txt")
        for name in "abcd":
            for rank in (0, 1):
                r = recs[(name, rank)]
                expect(f"world ({name}) rank {rank}", r["launches"],
                       wants[name])
                runs[f"dist_{name}_rank{rank}"] = r["launches"]
            r0, r1 = recs[(name, 0)], recs[(name, 1)]
            row = {"ranks": [r0, r1]}
            if name in "ab":
                got = load_scores(out / f"{name}_0.npz")
                if name == "a":
                    got.update(load_scores(out / f"{name}_1.npz"))
                else:
                    other = load_scores(out / f"{name}_1.npz")
                    if any(not np.array_equal(got[k], other[k])
                           for k in got):
                        raise SystemExit("world (b): the ranks' gathered "
                                         "scores differ")
                gap, agree = score_gap(got, ref["lm"][1])
                recs_file = top1_by_record(root / f"{name}_predictions.txt")
                if sorted(recs_file) != sorted(ref_file) or len(
                        recs_file) != 10 * n_val:
                    raise SystemExit(f"world ({name}): the predictions "
                                     "file is not every record once")
                file_agree = float(np.mean([recs_file[k] == ref_file[k]
                                            for k in ref_file]))
                m_ref = ref["lm"][0]["metrics"]
                d_m = {k: max(abs(r0["metrics"][k] - m_ref[k]),
                              abs(r1["metrics"][k] - m_ref[k]))
                       for k in ("r@1", "r@5", "r@10", "mean", "mrr",
                                 "ndcg")}
                row.update(max_abs_d_ll_sum=gap, top1_agreement=agree,
                           file_top1_agreement=file_agree,
                           max_abs_d_metrics=d_m,
                           records=len(recs_file))
                if min(agree, file_agree) < MIN_TOP1_AGREEMENT:
                    raise SystemExit(f"world ({name}): top-1 agreement "
                                     f"{agree} / {file_agree}")
            else:
                if r0["weights_sha256"] != r1["weights_sha256"]:
                    raise SystemExit(f"world ({name}): the ranks' weights "
                                     "differ")
                want = ref["train" if name == "c" else "dense"][0]
                if len(r0["parts"]) != len(want["parts"]):
                    raise SystemExit(f"world ({name}): {len(r0['parts'])} "
                                     f"steps, one rank {len(want['parts'])}")
                # every loss part of every step (the overflow count equal)
                gaps = [{k: (abs(g[k] - w[k]) / abs(w[k]) if w[k] else
                             abs(g[k])) for k in w}
                        for g, w in zip(r0["parts"], want["parts"])]
                # the step's ms beside its gradient all-reduce's (the
                # largest call; the loss counts' are a few bytes)
                row.update(step_ms=[r["ms_per_step_after_first"]
                                    for r in (r0, r1)],
                           grad_allreduce_ms=[grad_reduce_ms(r)
                                              for r in (r0, r1)])
                row.update(loss_rel_gap=gaps, loss_rtol=LOSS_RTOL,
                           ref_parts=want["parts"],
                           ref_ms_per_step=want["ms_per_step_after_first"],
                           ref_peak_gib=want["peak_gib"])
                if r0["parts"] != r1["parts"] or max(
                        v for gap in gaps for v in gap.values()) > LOSS_RTOL:
                    raise SystemExit(f"world ({name}): losses {r0['parts']}"
                                     f" vs one rank's {want['parts']}")
            res[name] = row
            print(json.dumps(shown({"world": name, **row, "card": card})),
                  flush=True)
        # (e): one rank under nccl, each run bit-equal to it without a world
        one = ["-num_train_samples", "12"]
        plan = [{"name": "e_train_none", "entry": "train", "world": False,
                 "argv": fit + one + ["-save_name", "e0"]},
                {"name": "e_lm_none", "entry": "val_lm", "world": False,
                 "argv": lm + ["-save_name", "e1"]},
                {"name": "e_train_world", "entry": "train",
                 "argv": fit + one + ["-save_name", "e2"]},
                {"name": "e_lm_world", "entry": "val_lm",
                 "argv": lm + ["-save_name", "e3"]}]
        recs, secs = spawn_world({"device": rank_device,
                                  "backend": one_backend, "runs": plan},
                                 out, 1)
        res["nccl_s"] = secs
        for name, want in (("e_train_none", train_want(1)),
                           ("e_lm_none", gen_want(serve_batches)),
                           ("e_train_world", train_want(1)),
                           ("e_lm_world", gen_want(serve_batches))):
            expect(f"world ({name})", recs[(name, 0)]["launches"], want)
            runs[f"dist_{name}"] = recs[(name, 0)]["launches"]
        t0_, t1_ = recs[("e_train_none", 0)], recs[("e_train_world", 0)]
        l0_, l1_ = recs[("e_lm_none", 0)], recs[("e_lm_world", 0)]
        s0, s1 = (load_scores(out / f"{n}_0.npz")
                  for n in ("e_lm_none", "e_lm_world"))
        same = {
            "train_weights": t0_["weights_sha256"] == t1_["weights_sha256"],
            "train_losses": t0_["parts"] == t1_["parts"],
            "lm_scores": sorted(s0) == sorted(s1) and all(
                np.array_equal(s0[k], s1[k]) for k in s0),
            "lm_metrics": l0_["metrics"] == l1_["metrics"],
            "lm_file": (root / "e1_predictions.txt").read_bytes()
            == (root / "e3_predictions.txt").read_bytes()}
        res["e"] = {"bit_equal": same, "ranks": [t1_, l1_]}
        print(json.dumps(shown({"world": "e", **res["e"], "card": card})),
              flush=True)
        if not all(same.values()):
            raise SystemExit(f"world (e): not bit-equal to no world: {same}")
    print(json.dumps({"world_phase": {k: res[k] for k in (
        "setup_s", "world_s", "nccl_s")}, "parameter_tensors": n_params,
        "card": card}), flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phase 14: the mp axis (ranks on the one card, the model sharded over them)
# ---------------------------------------------------------------------------

def phase_mp(dev, card, runs, config=None, max_seq_len=256,
             rank_device="cuda:0"):
    """The -mesh_mp axis on the card at full width, through the entry
    points a user runs in each rank (``main(argv)`` with the world flags
    and ``-mesh_mp``), the ranks on the one card under gloo (NCCL takes
    one rank a device), on phase 13's fixture tree and a seeded start
    .ckpt, against runs of the same commands in this process: (a) train,
    2 ranks (dp 1 x mp 2), 2 steps of 12 images x 20 sequences at the
    default dropouts, -fused_adamw 1, a save at the end: the gathered
    weights and both moments bit-equal to one process's, each replicated
    tensor bit-equal across the ranks; (b) val_lm serving, 2 ranks (dp 1
    x mp 2), over the 9 val dialogs: the predictions file byte-equal to
    one process's; (c) dense_finetune, 2 ranks (dp 1 x mp 2), 2 slates:
    the weights bit-equal to one process's; (d) train, 4 ranks (dp 2 x mp
    2), 2 steps: the weights bit-equal to a (dp 2 x mp 1) world's, run by
    the two processes of (a)-(c) regridded by the flags; (e) (a)'s native
    save resumed in one process (mp 1) for one step, weights and moments
    bit-equal to the one-process run resumed from its own save (on a
    mismatch: the tensors named, the two saves compared, and the
    one-process resume run again as the control).
    Each rank prints the bytes of the fp32 state it holds against one
    process's, its peak memory (since sharding), its ms a step, its mp
    gathers' and dp gradient all-reduce's MiB and ms (the card synchronized
    around each) and its launches, which must be one process's: 12 + 12
    B5 and one xent_train_fwd / _bwd a step and 534 B7 an update (on the slices), 12 K1 / 18 K2 / 1 K3 a
    prefix group. ``config`` / ``max_seq_len`` / ``rank_device`` rehearse
    it on the CPU at TINY size (with ``torch.cuda``'s calls and ``expect``
    stubbed in every process)."""
    import shutil

    t = world_tree("phase14", dev, config, max_seq_len)
    root, out, n_val = t.root, t.out, DIST_DIALOGS["n_val"]
    serve = t.gen_want([min(2, n_val - i) for i in range(0, n_val, 2)])
    fit = t.base + ["-model_config", str(t.config), "-num_epochs", "1",
                    "-eval_every_epochs", "2", "-fused_adamw", "1"]
    start = ["-start_path", t.start]
    save = ["-save_every_epochs", "1"]
    nosave = ["-save_every_epochs", "2"]
    lm = t.lm[:-2]                               # serving
    mp2 = ["-mesh_mp", "2"]
    res = {"setup_s": t.setup_s, "card": card}
    with contextlib.chdir(root):
        t0 = time.perf_counter()
        ref = {}
        for name, entry, argv, want in (
                ("a", "train", fit + start + save, t.train_want(2)),
                ("b", "val_lm", lm, serve),
                ("c", "dense_finetune", fit + start + nosave,
                 t.train_want(DIST_DENSE))):
            r, _ = dist_run(entry, argv + ["-save_name", f"ref_{name}"], dev,
                            moments=name == "a")
            expect(f"mp one-process {name}", r["launches"], want)
            runs[f"mp_ref_{name}"] = r["launches"]
            ref[name] = r
            print(json.dumps(shown({"mp_ref": name, **r, "card": card})),
                  flush=True)
        res["one_process_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        # two processes as dp 1 x mp 2 for (a)-(c), then, rearranged by
        # the flags (no -mesh_mp), as dp 2 x mp 1 for (d)'s reference
        worlds = (
            ("dp1mp2", 2, [
                {"name": "a", "entry": "train", "moments": True,
                 "argv": fit + start + save + mp2 + ["-save_name", "a"]},
                {"name": "b", "entry": "val_lm",
                 "argv": lm + mp2 + ["-save_name", "b"]},
                {"name": "c", "entry": "dense_finetune",
                 "argv": fit + start + nosave + mp2 + ["-save_name", "c"]},
                {"name": "d_ref", "entry": "train",
                 "argv": fit + start + nosave + ["-save_name", "d_ref"]}]),
            ("dp2mp2", 4, [
                {"name": "d", "entry": "train",
                 "argv": fit + start + nosave + mp2 + ["-save_name", "d"]}]))
        recs = {}
        for wname, n, plan in worlds:
            got, secs = spawn_world({"device": rank_device, "name": wname,
                                     "backend": "gloo", "runs": plan}, out, n)
            recs.update(got)
            res[f"{wname}_s"] = secs
        wants = {"a": t.train_want(2), "b": serve,
                 "c": t.train_want(DIST_DENSE), "d": t.train_want(2),
                 "d_ref": t.train_want(2)}
        for (name, rank), r in sorted(recs.items()):
            expect(f"mp ({name}) rank {rank}", r["launches"], wants[name])
            runs[f"mp_{name}_rank{rank}"] = r["launches"]
        failed = []

        def same(what, got, want):
            if got != want:
                failed.append(what)
            return got == want

        for name in "abcd":
            ranks = sorted(k[1] for k in recs if k[0] == name)
            rows = [recs[(name, k)] for k in ranks]
            row = {"ranks": rows,
                   "launches": [{k: v for k, v in r["launches"].items()
                                 if v} for r in rows],
                   "gather": [collective_ms(r, "gather_whole")
                              for r in rows]}
            if name == "b":
                row["file_byte_equal"] = same(
                    "(b) predictions file",
                    (root / "b_predictions.txt").read_bytes(),
                    (root / "ref_b_predictions.txt").read_bytes())
            else:
                want = (ref[name] if name != "d"
                        else recs[("d_ref", 0)])
                keys = ["weights_sha256"] + (["moments_sha256"]
                                             if name == "a" else [])
                row["bit_equal"] = {k: same(f"({name}) {k}", [
                    r[k] for r in rows], [want[k]] * len(rows)) for k in keys}
                if not all(row["bit_equal"].values()):
                    row["differ"] = [differ(r, want) for r in rows]
                groups = [rows[i:i + 2] for i in range(0, len(rows), 2)]
                row["replicated_bit_equal"] = same(
                    f"({name}) replicated tensors across an mp group",
                    [g[0]["replicated_sha256"] for g in groups],
                    [g[1]["replicated_sha256"] for g in groups])
                row.update(
                    state_gib=[r["state_gib"] for r in rows],
                    ref_state_gib=want["state_gib"],
                    peak_after_shard_gib=[r["peak_after_shard_gib"]
                                          for r in rows],
                    ref_peak_gib=want["peak_after_shard_gib"],
                    step_ms=[r["ms_per_step_after_first"] for r in rows],
                    ref_step_ms=want["ms_per_step_after_first"],
                    grad_allreduce=[collective_ms(r, "allreduce_sum_")
                                    for r in rows],
                    replicated_broadcast=[collective_ms(r, "broadcast_")
                                          for r in rows])
            res[name] = row
            print(json.dumps({"mp": name, **{k: v for k, v in row.items()
                                              if k != "ranks"},
                              "card": card}), flush=True)
        # (e): (a)'s mp-2 save and the one-process save, each resumed in
        # one process for one step; where they differ, which tensors, and
        # the one-process resume run again as the control (a kernel whose
        # sums change from run to run differs there too)
        t0 = time.perf_counter()
        one = ["-num_train_samples", "12"]
        e = {}

        def resume(name, src):
            native = str(root / "ckpt" / src / "native")
            r, _ = dist_run("train", fit + one + nosave + [
                "-continue", "-start_path", native, "-save_name", name], dev,
                moments=True)
            expect(f"mp ({name})", r["launches"], t.train_want(1))
            runs[f"mp_{name}"] = r["launches"]
            e[name] = r

        resume("e", "a")
        resume("e_ref", "ref_a")
        res["e"] = {k: same(f"(e) {k}", e["e"][k], e["e_ref"][k])
                    for k in ("weights_sha256", "moments_sha256", "step")}
        res["e_differ"] = differ(e["e"], e["e_ref"])
        if res["e_differ"]:
            res["e_saves_differ"] = saves_differ(root / "ckpt" / "a",
                                                 root / "ckpt" / "ref_a")
            resume("e_control", "ref_a")
            res["e_control_differ"] = differ(e["e_control"], e["e_ref"])
        res["resume_s"] = time.perf_counter() - t0
        print(json.dumps({"mp": "e", "bit_equal": res["e"], **{
            k: res[k] for k in ("e_saves_differ", "e_differ",
                                "e_control_differ") if k in res},
            "card": card}), flush=True)
        if failed:
            raise SystemExit(f"mp: not bit-equal: {failed}")
    print(json.dumps({"mp_phase": {k: res[k] for k in (
        "setup_s", "one_process_s", "dp1mp2_s", "dp2mp2_s", "resume_s")},
        "card": card}), flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return res


def saves_differ(a, b):
    """The tensors (``<name>``, ``mu/<name>``, ``nu/<name>``) that differ
    between the native saves of step 2 under two save directories."""
    x, y = (torch.load(d / "native" / "step_2" / "state.pt",
                       map_location="cpu", weights_only=False)
            for d in (a, b))
    return sorted(n for n, v in y["params"].items()
                  if not torch.equal(v, x["params"][n])) + sorted(
        f"{key}/{n}" for key in ("mu", "nu") for n, u, v in zip(
            y["opt"]["names"], x["opt"][key], y["opt"][key])
        if not torch.equal(u, v))


def collective_ms(r, op):
    """(MiB, [ms]) of a run's largest calls of collective ``op`` (for
    ``allreduce_sum_`` the gradient's, one an update; the loss counts'
    are a few bytes): ``(0, [])`` if it made none."""
    calls = [c for c in r["collectives"] if c["op"] == op]
    if not calls:
        return 0, []
    big = max(c["mib"] for c in calls)
    return big, [c["ms"] for c in calls if c["mib"] == big]


def grad_reduce_ms(r):
    """The ms of a training run's gradient all-reduces, one an update."""
    return collective_ms(r, "allreduce_sum_")[1]


def top1_by_record(path):
    """{(image_id, round_id): the option ranked first} of a predictions
    file."""
    with open(path) as f:
        return {(r["image_id"], r["round_id"]): r["ranks"].index(1)
                for r in json.load(f)}


# ---------------------------------------------------------------------------
# phase 15: the encoder modes and the VL task heads
# ---------------------------------------------------------------------------

# (a) and (b) against the plain forward of the same rows: both run
# PyTorch's plain encoder (the modes turn every text kernel off), so they
# differ only where cuBLAS sums a GEMM of another row count in another
# order. The first rule written here held every fp32 element within 1e-5 +
# 1e-4 |plain|; on an H100 (700 W) (b) missed it at 6.3e-5 on t_seq, where
# the plain fp32 forward itself is up to 5.2e-5 from its fp64 run (the
# fp32 noise of 18 text layers at a scale of ~5), while the two fp64
# forwards were bit-equal. So each fp32 forward is held against the plain
# fp64 forward, the mode's no farther than MODES_SLACK times the plain
# one's, and the two fp64 forwards elementwise, 50 times below the fp32
# noise (the softmax stays fp32 in an fp64 run, so an fp32 ulp of a
# probability may differ); a wrong pairing, bias or row moves an output
# by its own size
MODES_SLACK, MODES_FLOOR = 2.0, 1e-6
MODES64_RTOL, MODES64_ATOL = 1e-6, 1e-6
# (c): the VQA v2 answer set that ViLBERT's VQA head predicts
TASK_LABELS = 3129
# (c) in bf16, kernels against the plain path: they round at other points
# (phase 5's note on NSP_MARGIN_TOL), a few bf16 steps carried through 18
# text and 6 vision blocks, so an output moves by a few percent of its
# scale at most, and an argmax over thousands of classes turns on
# near-ties; a wrong mask, a dropped head or a wrong image row moves an
# output by its own size and its argmax to chance (1 / 3129 at best)
TASK_REL_TOL = 0.1
TASK_MIN_ARGMAX = 0.8
TEXT_KEYS = ("tokens", "segments", "mode", "ctx_end", "ans_len")


def modes_text(cfg, rng, rounds, options, dis):
    """rounds x options flat text rows (numpy) of ``workload``'s gen or dis
    slates for one image: each round its own context, each option its own
    answer; the context range scaled to ``cfg.max_seq_len``."""
    from unimm_torch import workload
    L = cfg.max_seq_len
    make = workload.make_dis_batch if dis else workload.make_val_batch
    b = make(rng, cfg, 1, rounds, options,
             ctx_range=(max(2, L * 58 // 256), L * 192 // 256),
             feat_dim=cfg.v_feature_size)
    return {k: b[k].reshape(rounds * options, *b[k].shape[3:])
            for k in TEXT_KEYS}


def modes_images(cfg, rng, n):
    """n images (numpy): image i has max(1, R - 4 (i % 8)) real regions,
    the rest padded."""
    R = cfg.max_regions
    mask = np.zeros((n, R), np.float32)
    for i in range(n):
        mask[i, :max(1, R - 4 * (i % 8))] = 1.0
    return {"image_feat": rng.normal(size=(n, R, cfg.v_feature_size)
                                     ).astype(np.float32),
            "image_loc": rng.normal(size=(n, R, 5)).astype(np.float32),
            "image_mask": mask}


def cat_rows(*parts):
    """Interleave the rows of equal-length row dicts: row 0 of each, then
    row 1 of each, ..."""
    return {k: np.stack([p[k] for p in parts], 1).reshape(
        -1, *parts[0][k].shape[1:]) for k in parts[0]}


def modes_gate(got, ref, got64, ref64):
    """Phase 15 (a) / (b)'s rules (the docstring) for the four encode
    outputs of a mode (``got``, fp32; ``got64``, fp64) and of the plain
    forward of the same rows (``ref``, ``ref64``): ([readings an output],
    whether all hold)."""
    out, ok = [], True
    for name, g, r, g64, r64 in zip(("t_seq", "v_seq", "pooled_t",
                                     "pooled_v"), got, ref, got64, ref64):
        g, r, g64, r64 = (x.double() for x in (g, r, g64, r64))
        e_mode = float((g - r64).abs().max())
        e_plain = float((r - r64).abs().max())
        d64 = (g64 - r64).abs()
        ok64 = bool((d64 <= MODES64_ATOL + MODES64_RTOL * r64.abs()).all())
        hold = ok64 and e_mode <= MODES_SLACK * e_plain + MODES_FLOOR
        out.append(dict(output=name, fp32_vs_plain_fp32=float(
            (g - r).abs().max()), fp32_vs_fp64=e_mode,
            plain_fp32_vs_fp64=e_plain, fp64_vs_plain_fp64=float(d64.max()),
            scale=float(r64.abs().max()), ok=hold))
        ok = ok and hold
    return out, ok


def measured(fn, dev):
    """``counted(fn)`` with the peak memory of the run:
    (result, ms, launches, peak GiB)."""
    torch.cuda.reset_peak_memory_stats(dev)
    out, secs, launches = counted(fn)
    return (out, secs * 1e3, launches,
            torch.cuda.max_memory_allocated(dev) / 2 ** 30)


def compare_tasks(got, want, batch, cfg):
    """Phase 15 (c)'s rules (the docstring) for the seven outputs of
    ``vl_tasks_forward`` through the kernels (``got``) and the plain path
    (``want``): {output: its readings}, and whether all hold."""
    from unimm_torch.ops import masks
    ext = masks.attended_extent(*(batch[k].cpu().numpy() for k in (
        "mode", "ctx_end", "ans_len")), cfg.max_seq_len)
    real = batch["image_mask"][batch["img_index"]].bool()
    pos = torch.from_numpy(np.arange(cfg.max_seq_len)[None] < ext[:, None]
                           ).to(real.device)
    names = ("vil_prediction", "vil_logit", "nsp_logits", "img_logits",
             "vision_logit", "mlm_logits", "linguistic_logit")
    sel = {"img_logits": real, "vision_logit": real, "mlm_logits": pos,
           "linguistic_logit": pos}
    res, ok = {}, True
    for name, g, w in zip(names, got, want):
        g, w = g.float(), w.float()
        if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
            res[name], ok = {"finite": False}, False
            continue
        if name == "nsp_logits":
            mg, mw = g[:, 0] - g[:, 1], w[:, 0] - w[:, 1]
            d, size = float((mg - mw).abs().max()), float(mw.abs().max())
            atol, rtol = NSP_MARGIN_TOL
            r = dict(max_abs_d_margin=d, max_abs_margin=size,
                     ok=d <= atol + rtol * size)
        else:
            if name in sel:
                g, w = g[sel[name]], w[sel[name]]
            d, scale = float((g - w).abs().max()), float(w.abs().max())
            r = dict(max_abs_d=d, scale=scale, rel=d / scale,
                     ok=d <= TASK_REL_TOL * scale)
            if name in ("vil_prediction", "img_logits", "mlm_logits"):
                agree = float((g.argmax(-1) == w.argmax(-1)).float().mean())
                r.update(argmax_agreement=agree, rows=int(g.shape[0]),
                         ok=r["ok"] and agree >= TASK_MIN_ARGMAX)
        res[name] = r
        ok = ok and r["ok"]
    pad = got[4][~real]
    res["padded_regions"] = dict(n=int(pad.numel()), max=float(
        pad.max()) if pad.numel() else None)
    if pad.numel() and float(pad.max()) >= -5000:
        ok = False
    return res, ok


def phase_modes(dev, card, runs, config=None, n=8):
    """Phase 15 (the module docstring has its rules): ``in_batch_pairs``
    and ``fast_mode`` at full width against the host-crossed plain forward,
    then ``vl_tasks_forward`` through the kernels against the plain path.
    ``config`` rehearses it on the CPU at TINY size (with ``torch.cuda``'s
    calls and ``expect`` stubbed)."""
    from unimm_torch.config import VilbertConfig
    from unimm_torch.models import unimm, vilbert, vl_tasks

    cfg = config or VilbertConfig()
    model = vilbert.init_model(cfg, seed=0, device=dev)
    rng = np.random.default_rng(15)
    res, failed = {"card": card}, []

    def fp32(c, b):
        return unimm.encode(model, c, on_device(b, dev), dtype=torch.float32)

    plain_cfg = cfg.replace(attention_impl="xla")
    m64 = vilbert.cast_floating(model, torch.float64)

    def fp64(c, b):
        return unimm.encode(m64, c, on_device(b, dev), dtype=torch.float64)

    def check(tag, mode_cfg, batch, ref_batch, rows):
        """Run the mode and the plain forward of ``ref_batch`` (counted,
        timed, after a warm-up each), both again in fp64; gate them."""
        fp32(mode_cfg, batch)                       # warm-up, not counted
        got, ms, launches, peak = measured(lambda: fp32(mode_cfg, batch),
                                           dev)
        fp32(plain_cfg, ref_batch)
        ref, plain_ms, _, plain_peak = measured(
            lambda: fp32(plain_cfg, ref_batch), dev)
        outs, ok = modes_gate(got, ref, fp64(mode_cfg, batch),
                              fp64(plain_cfg, ref_batch))
        expect(tag, launches, {})
        r = dict(rows=rows, ms=ms, launches=launches, peak_gib=peak,
                 plain_ms=plain_ms, plain_peak_gib=plain_peak, outputs=outs,
                 ok=ok)
        return got, r

    # (a) in_batch_pairs: 8 text rows x 8 images -> 64 pairs
    text = cat_rows(modes_text(cfg, rng, n // 2, 1, False),
                    modes_text(cfg, rng, n // 2, 1, True))
    batch = {**text, **modes_images(cfg, rng, n)}
    t_i, v_i = np.repeat(np.arange(n), n), np.tile(np.arange(n), n)
    crossed = {k: v[t_i] if k in TEXT_KEYS else v[v_i]
               for k, v in batch.items()}
    got, res["a"] = check("in_batch_pairs", cfg.replace(in_batch_pairs=True),
                          batch, crossed, n * n)
    runs["modes_in_batch_pairs"] = res["a"]["launches"]
    diag = np.arange(n) * (n + 1)
    pairs64 = fp64(cfg.replace(in_batch_pairs=True), batch)
    res["a"]["diagonal"], d_ok = modes_gate(
        [o[diag] for o in got], fp32(plain_cfg, batch),
        [o[diag] for o in pairs64], fp64(plain_cfg, batch))
    print(json.dumps({"modes": "a in_batch_pairs", **res["a"],
                      "card": card}), flush=True)
    if not (res["a"]["ok"] and d_ok):
        failed.append("(a) in_batch_pairs")

    # (b) fast_mode: one gen text row over n * n images
    one = modes_text(cfg, rng, 1, 1, False)
    imgs = modes_images(cfg, rng, n * n)
    rep = {**{k: np.repeat(v, n * n, 0) for k, v in one.items()}, **imgs}
    _, res["b"] = check("fast_mode", cfg.replace(fast_mode=True),
                        {**one, **imgs}, rep, n * n)
    runs["modes_fast_mode"] = res["b"]["launches"]
    print(json.dumps({"modes": "b fast_mode", **res["b"], "card": card}),
          flush=True)
    if not res["b"]["ok"]:
        failed.append("(b) fast_mode")
    del m64, pairs64

    # (c) vl_tasks_forward in eval, bf16, through the kernels and plain
    vl_tasks.add_task_heads(model, cfg, TASK_LABELS, seed=1)
    mb = vilbert.cast_floating(model, torch.bfloat16)
    del model
    text = cat_rows(modes_text(cfg, rng, n, n // 2, False),
                    modes_text(cfg, rng, n, n // 2, True))
    rows = text["tokens"].shape[0]
    batch = on_device({**text, **modes_images(cfg, rng, n),
                       "img_index": np.arange(rows) % n}, dev)

    def tasks(c):
        return vl_tasks.vl_tasks_forward(mb, c, batch, dtype=torch.bfloat16)

    tasks(plain_cfg)                                # warm-up, not counted
    plain, plain_ms, _, plain_peak = measured(lambda: tasks(plain_cfg), dev)
    n_t, n_c = cfg.num_hidden_layers, len(cfg.t_biattention_id)
    res["c"] = {"rows": rows, "labels": TASK_LABELS, "plain_ms": plain_ms,
                "plain_peak_gib": plain_peak}
    for name, c, want in (
            ("default", cfg, {"attention_block": n_t,
                              "ffn_block": n_t + n_c}),
            ("fused_co", cfg.replace(fused_co=True),
             {"attention_block": n_t, "ffn_block": n_t + n_c,
              "co_text_block": n_c})):
        tasks(c)                                    # warm-up, not counted
        got, ms, launches, peak = measured(lambda: tasks(c), dev)
        expect(f"vl_tasks {name}", launches, want)
        runs[f"vl_tasks_{name}"] = launches
        cmp, ok = compare_tasks(got, plain, batch, cfg)
        res["c"][name] = dict(ms=ms, launches=launches, peak_gib=peak,
                              outputs=cmp, ok=ok)
        print(json.dumps({"modes": f"c vl_tasks {name}", **res["c"][name],
                          "plain_ms": plain_ms, "plain_peak_gib": plain_peak,
                          "rows": rows, "card": card}), flush=True)
        if not ok:
            failed.append(f"(c) vl_tasks {name}")
        del got
    if failed:
        raise SystemExit(f"modes: {failed}")
    return res


@contextlib.contextmanager
def phase(name):
    """Print the phase's seconds when it ends."""
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def main_train_gates(dev, card, seeds):
    """``--train-gates``: phase 8 (a)'s gates alone."""
    from unimm_torch.config import VilbertConfig
    from unimm_torch.ops import _build

    with phase("2 build"):
        _build.library()
    (res_a, ok_a), (res_d, ok_d) = train_gates(
        dev, VilbertConfig(), {}, seeds or GATE_SEEDS)
    print(json.dumps({"train_vs_plain": res_a, "passed": ok_a}), flush=True)
    print(json.dumps({"train_dropout_vs_twin": res_d, "passed": ok_d}),
          flush=True)
    print(card, flush=True)
    return 0 if ok_a and ok_d else 1


def main_xent_train(dev, card):
    """``--xent-train``: the build, phase 2's report and the training
    cross-entropy's phase 3 cases alone."""
    from unimm_torch.ops import _build

    with phase("2 build"):
        _build.library()
    report_kernels()
    with phase("3 xent_train"):
        gen = torch.Generator(device=dev).manual_seed(0)
        cases = xent_train_cases(dev, gen)
    bad = []
    for name, cs in cases.items():
        atol, rtol = TOL[name]
        for c in cs:
            print(json.dumps({"kernel": name, "atol": atol, "rtol": rtol,
                              **c}), flush=True)
            if not c["ok"]:
                bad.append(f"{name} {c['shape']}")
    print(card, flush=True)
    if bad:
        raise SystemExit(f"xent_train disagrees with its plain version: {bad}")
    return 0


@contextlib.contextmanager
def plain_decoder():
    """Inside: the decoder's grouped expert products, its MLA answer
    attention and its LM head run their plain versions on the card (fp32
    products of each expert's rows, each slate's fp32 scores, the
    vocabulary scan), launching no kernel of theirs."""
    from unimm_torch.eval import decoder_prefix
    from unimm_torch.ops import mla_answer as mla_ops
    from unimm_torch.ops import moe
    from unimm_torch.ops.xent_head import xent_head_plain

    def swiglu(a, w13, row_off, tile_off):
        return moe.grouped_swiglu_plain(a, w13, row_off)

    def down(h, w2, row_off, tile_off, scale=None):
        return moe.grouped_down_plain(h, w2, row_off, scale)

    def head(hidden, weight, bias, labels):
        return xent_head_plain(hidden, weight, hidden.new_zeros(
            weight.shape[0], dtype=torch.float32), labels)

    kernels = (moe.grouped_swiglu, moe.grouped_down, decoder_prefix.xent_head,
               mla_ops.mla_answer)
    (moe.grouped_swiglu, moe.grouped_down, decoder_prefix.xent_head,
     mla_ops.mla_answer) = (swiglu, down, head, mla_ops.mla_answer_plain)
    try:
        yield
    finally:
        (moe.grouped_swiglu, moe.grouped_down, decoder_prefix.xent_head,
         mla_ops.mla_answer) = kernels


def phase_decoder(dev, card, layers=3, dialogs=2, rounds=2, config=None):
    """The decoder's generative path (``RankingEvaluator`` on a
    ``DeepseekV3Config``) at Kimi-VL-A3B's widths, ``layers`` deep (the
    dense layer, then MoE layers), weights normal(0, 0.02) (norms 1), on
    slates of 100 options with 345-391 image tokens: launches counted per
    group (two grouped products a MLP a pass, both passes, one MLA answer
    kernel a layer of the answer pass, and the head),
    then its scores against the same evaluator under ``plain_decoder``:
    top-1 agreement and the median and max |d ll_mean|.
    ``config``: another DeepseekV3Config (a rehearsal's small one)."""
    from unimm_torch.config import DeepseekV3Config
    from unimm_torch.eval.evaluator import RankingEvaluator
    from unimm_torch.models import deepseek_v3 as dsv3

    cfg = (config or DeepseekV3Config()).replace(num_hidden_layers=layers)
    model = dsv3.DecoderModel(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    tensors = [model.embed, model.norm, model.lm_head] + [
        t for lay in model.layers for t in lay.values()]
    for t in tensors:
        if t.dim() == 1 and t.dtype == torch.bfloat16:
            t.fill_(1.0)
        else:
            t.copy_(torch.randn(t.shape, generator=g, device=dev) * 0.02)
    rng = np.random.default_rng(3)
    B, R, O, L, H = dialogs, rounds, 100, 256, cfg.hidden_size
    lc = rng.integers(24, 239, (B, R))
    A = rng.integers(3, 10, (B, R, O))
    tokens = np.zeros((B, R, O, L), np.int32)
    ctx = rng.integers(1, cfg.vocab_size, (B, R, L))
    ans = rng.integers(1, cfg.vocab_size, (B, R, O, L))
    j = np.arange(L)
    tokens[:] = np.where(j < lc[..., None], ctx, 0)[:, :, None]
    put = (j >= lc[..., None, None]) & (j < (lc[..., None] + A)[..., None])
    tokens = np.where(put, ans, tokens).astype(np.int32)
    batch = {"tokens": tokens,
             "ctx_end": np.repeat(lc[..., None], O, -1).astype(np.int32),
             "ans_len": A.astype(np.int32),
             "image_embeds": (0.02 * rng.standard_normal((B, 391, H))
                              ).astype(np.float32),
             "image_len": rng.integers(345, 392, B).astype(np.int32)}
    ev = RankingEvaluator(cfg, need_lm=True, need_nsp=False,
                          prefix_group=B * R, device=dev)
    ev.score_slates(model, batch)                       # warm-up
    scores, secs, launches = counted(lambda: ev.score_slates(model, batch))
    mlps = 2 * (layers - cfg.first_k_dense_replace) + \
        cfg.first_k_dense_replace
    expect("decoder", launches, {"grouped_swiglu": 2 * mlps,
                                 "grouped_down": 2 * mlps, "xent_head": 1,
                                 "mla_answer": layers})
    got = scores["ll_mean"].reshape(B * R, O)
    kernels = wrappers()
    for w in kernels:
        w.launches = 0
    with plain_decoder():
        want = ev.score_slates(model, batch)
    expect("decoder, plain versions", {w.__name__: w.launches
                                       for w in kernels}, {})
    want = want["ll_mean"].reshape(B * R, O)
    d = np.abs(got - want)
    res = dict(layers=layers, slates=B * R, options=O, launches=launches,
               seconds=secs,
               top1_agreement=float((got.argmax(-1) == want.argmax(-1)
                                     ).mean()),
               median_abs_d_ll_mean=float(np.median(d)),
               max_abs_d_ll_mean=float(d.max()),
               share_above=float((d > DECODER_D_LL).mean()),
               limit=DECODER_D_LL, min_agreement=MIN_TOP1_AGREEMENT)
    print(json.dumps({"decoder_path": res, "card": card}), flush=True)
    if not (res["median_abs_d_ll_mean"] <= DECODER_D_LL
            and res["top1_agreement"] >= MIN_TOP1_AGREEMENT):
        raise SystemExit(f"decoder: kernels against plain {res}")
    return res


# the decoder path's kernels against its plain versions, nats a label
# token. Both run bf16 with the same rounding points, so their hidden
# states differ by the order of fp32 sums; but a router's choice that this
# moves at a near-tie sends a token to another expert in both passes after
# it, and such a token's options move by up to ~0.07 (the first card run,
# 3 layers, 400 options). So the median over the options is held, with the
# top-1 agreement; the benchmark's check holds the routes on their own.
DECODER_D_LL = 2e-2


def main_moe(dev, card):
    """``--moe``: the build, phase 2's report, phase 3's grouped expert
    GEMM, MLA answer and K3 cases, and the decoder's path
    (phase_decoder)."""
    from unimm_torch.ops import _build
    from unimm_torch.ops import mla_answer as mla_ops
    from unimm_torch.ops import moe

    with phase("2 build"):
        _build.library()
    report_kernels()
    print(json.dumps({"moe_wg_kernel": {
        "swiglu": moe.kernel_info(0), "down": moe.kernel_info(1)}}),
        flush=True)
    print(json.dumps({"mla_answer_kernel": mla_ops.kernel_info()}),
          flush=True)
    with phase("3 grouped expert GEMM, MLA answer and K3"):
        gen = torch.Generator(device=dev).manual_seed(0)
        cases = {"mla_answer": [check_mla_answer(dev, gen)]}
        cases.update(moe_cases(dev, gen))
        cases["xent_head"] = [
            check_xent_head(dev, gen),
            check_xent_head(dev, gen, M=48000, V=163840, Hd=2048,
                            bias=False),
            check_xent_head(dev, gen, M=1000, V=163840, Hd=2048,
                            bias=False)]
    bad = []
    for name, cs in cases.items():
        atol, rtol = TOL[name]
        for c in cs:
            print(json.dumps({"kernel": name, "atol": atol, "rtol": rtol,
                              **c}), flush=True)
            if not c["ok"]:
                bad.append(f"{name} {c['shape']}")
    if bad:
        raise SystemExit(f"disagrees with its plain version: {bad}")
    with phase("16 decoder path"):
        phase_decoder(dev, card)
    print(card, flush=True)
    return 0


def main_world(dev, card):
    """``--world``: the build and phase 13 alone."""
    from unimm_torch.ops import _build

    with phase("2 build"):
        _build.library()
    with phase("13 data-parallel world"):
        phase_dist(dev, card, {})
    print(card, flush=True)
    return 0


def main_mp(dev, card):
    """``--mp``: the build and phase 14 alone."""
    from unimm_torch.ops import _build

    with phase("2 build"):
        _build.library()
    with phase("14 mp axis"):
        phase_mp(dev, card, {})
    print(card, flush=True)
    return 0


def main_modes(dev, card):
    """``--modes``: the build and phase 15 alone."""
    from unimm_torch.ops import _build

    with phase("2 build"):
        _build.library()
    with phase("15 encoder modes and VL task heads"):
        phase_modes(dev, card, {})
    print(card, flush=True)
    return 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda", 0)
    if sys.argv[1:2] == ["--train-gates"]:
        return main_train_gates(dev, card, tuple(map(int, sys.argv[2:])))
    if sys.argv[1:2] == ["--world-rank"]:
        return main_world_rank(sys.argv[2], int(sys.argv[3]))
    if sys.argv[1:2] == ["--world"]:
        return main_world(dev, card)
    if sys.argv[1:2] == ["--mp"]:
        return main_mp(dev, card)
    if sys.argv[1:2] == ["--modes"]:
        return main_modes(dev, card)
    if sys.argv[1:2] == ["--xent-train"]:
        return main_xent_train(dev, card)
    if sys.argv[1:2] == ["--moe"]:
        return main_moe(dev, card)

    from unimm_torch.config import VilbertConfig
    from unimm_torch.eval.evaluator import (RankingEvaluator, _merge_batches,
                                            evaluate_ensemble)
    from unimm_torch.models import vilbert
    from unimm_torch.ops import _build
    from unimm_torch.tools.kernel_profile import steady_throughput

    with phase("2 build"):
        _build.library()
    print(f"build: nvcc ran: {_build.build_seconds is not None}", flush=True)
    for cu in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in cu.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {cu.stem}: {line.strip()}", flush=True)
    report_kernels()

    with phase("3 kernels"):
        cases = phase_kernels(dev)

    cfg = VilbertConfig()
    model = vilbert.init_model(cfg, seed=0, device=dev)
    n_t, n_c = cfg.num_hidden_layers, len(cfg.t_biattention_id)
    runs = {}                # counted path runs: name -> launches

    with phase("4 generative path"):
        pinned = series(cfg, 0, realistic=False)
        realistic = series(cfg, 1, realistic=True)
        for batches in (pinned, realistic):          # warm-up, not counted
            run_split(dev, model, cfg, batches, "ll_sum")
        gen = {}
        for name, batches in (("pinned", pinned), ("realistic", realistic)):
            metrics, secs, launches = run_split(dev, model, cfg, batches,
                                                "ll_sum")
            # per slate group: one answer block per text layer, one FFN per
            # text and connection layer, one label head (12 / 18 / 1)
            g = slate_groups(batches)
            expect(f"gen {name}", launches,
                   {"answer_block": n_t * g, "ffn_block": (n_t + n_c) * g,
                    "xent_head": g})
            runs[f"gen_{name}"] = launches
            dialogs = sum(b["tokens"].shape[0] for b in batches)
            gen[name] = dict(launches=launches, groups=g, seconds=secs,
                             dialogs_per_s=dialogs / secs, r1=metrics["r@1"],
                             mrr=metrics["mrr"], ndcg=metrics["ndcg"])
            print(json.dumps({"main_path": name, **gen[name]}), flush=True)
        top1, d_mean, n = compare_plain(dev, model, cfg, pinned + realistic)
        print(json.dumps({"kernels_vs_plain": {
            "slates": n, "top1_agreement": top1, "max_abs_d_ll_mean": d_mean,
            "min_agreement": MIN_TOP1_AGREEMENT}}), flush=True)
        if top1 < MIN_TOP1_AGREEMENT:
            raise SystemExit(f"top-1 agreement {top1} < {MIN_TOP1_AGREEMENT}")
        steady = {name: steady_throughput(dev, model, cfg, b, need_lm=True)
                  for name, b in (("pinned", pinned),
                                  ("realistic", realistic))}
        print(json.dumps({"dialogs_per_s": {
            "evaluate_split": {k: v["dialogs_per_s"] for k, v in gen.items()},
            "steady": {k: v[0] for k, v in steady.items()},
            "steady_repeats": {k: v[1] for k, v in steady.items()}},
            "card": card}), flush=True)

    with phase("5 discriminative path"):
        dis_p = series(cfg, 2, realistic=False, dis=True)
        dis_r = series(cfg, 3, realistic=True, dis=True)
        for batches in (dis_p, dis_r):               # warm-up, not counted
            run_split(dev, model, cfg, batches, "nsp")
        dis = {}
        for name, batches in (("pinned", dis_p), ("realistic", dis_r)):
            metrics, secs, launches = run_split(dev, model, cfg, batches,
                                                "nsp")
            # per 256-sequence chunk: one attention block per text layer,
            # one FFN per text and connection layer (12 / 18)
            c = chunks(batches)
            expect(f"dis {name}", launches,
                   {"attention_block": n_t * c, "ffn_block": (n_t + n_c) * c})
            runs[f"dis_{name}"] = launches
            dialogs = sum(b["tokens"].shape[0] for b in batches)
            dis[name] = dict(launches=launches, chunks=c, seconds=secs,
                             dialogs_per_s=dialogs / secs, r1=metrics["r@1"],
                             mrr=metrics["mrr"], ndcg=metrics["ndcg"])
            print(json.dumps({"dis_path": name, **dis[name]}), flush=True)
        cmp = compare_nsp(dev, model, cfg, dis_p + dis_r)
        print(json.dumps({"dis_kernels_vs_plain": cmp}), flush=True)
        if not cmp["ok"]:
            raise SystemExit(f"NSP margins disagree with plain: {cmp}")
        steady = {name: steady_throughput(dev, model, cfg, b, need_lm=False)
                  for name, b in (("pinned", dis_p), ("realistic", dis_r))}
        dis_steady = {k: v[0] for k, v in steady.items()}
        print(json.dumps({"dis_dialogs_per_s": {
            "evaluate_split": {k: v["dialogs_per_s"] for k, v in dis.items()},
            "steady": {k: v[0] for k, v in steady.items()},
            "steady_repeats": {k: v[1] for k, v in steady.items()}},
            "card": card}), flush=True)

    with phase("6 ensemble, fused_co, test split"):
        cfg_co = cfg.replace(fused_co=True)
        members = [model, vilbert.init_model(cfg, seed=1, device=dev)]
        ens = dis_p[:2]
        # fused_co off / on in turns (off, on, on, off) on one card
        ab = [(name, steady_throughput(dev, model, c, ens, need_lm=False)[0])
              for name, c in (("off", cfg), ("on", cfg_co), ("on", cfg_co),
                              ("off", cfg))]
        print(json.dumps({"fused_co_ab_dialogs_per_s": ab, "card": card}),
              flush=True)
        for i, m in enumerate(members):
            cmp = compare_nsp(dev, m, cfg_co, ens)
            print(json.dumps({"fused_co_vs_plain": {"member": i, **cmp}}),
                  flush=True)
            if not cmp["ok"]:
                raise SystemExit(f"member {i}: NSP margins disagree: {cmp}")
        metrics, secs, launches = counted(lambda: evaluate_ensemble(
            members, cfg_co, ens, mode="nsp", coalesce=2, progress_every=0,
            device=dev))
        c = chunks(ens) * len(members)
        expect("ensemble", launches,
               {"attention_block": n_t * c, "ffn_block": (n_t + n_c) * c,
                "co_text_block": n_c * c})
        if not all(math.isfinite(v) for v in metrics.values()):
            raise SystemExit(f"ensemble: non-finite metrics {metrics}")
        runs["ensemble"] = launches
        print(json.dumps({"ensemble": {"launches": launches, "chunks": c,
                                       "seconds": secs, "r1": metrics["r@1"],
                                       "ndcg": metrics["ndcg"]}}), flush=True)
        from unimm_torch import workload
        test = workload.make_dis_batch(np.random.default_rng(4), cfg, 20, 1,
                                       100)
        ranks = []
        out, secs, launches = counted(lambda: evaluate_ensemble(
            members, cfg_co, [test], mode="nsp", test_split=True,
            ranks_out=ranks, progress_every=0, device=dev))
        c = chunks([test]) * len(members)
        expect("test split", launches,
               {"attention_block": n_t * c, "ffn_block": (n_t + n_c) * c,
                "co_text_block": n_c * c})
        if out != {} or [(e["image_id"], e["round_id"]) for e in ranks] != [
                (b, int(test["round_id"][b])) for b in range(20)] or any(
                sorted(e["ranks"]) != list(range(1, 101)) for e in ranks):
            raise SystemExit("test split: wrong ranks records")
        runs["test_split"] = launches
        print(json.dumps({"test_split": {"records": len(ranks),
                                         "launches": launches,
                                         "seconds": secs}}), flush=True)

    with phase("7 generative fallback"):
        pair = _merge_batches(pinned[:2])             # fresh arrays
        for b, r in ((0, 0), (1, 4), (3, 9)):
            pair["tokens"][b, r, 1, 1] += 1          # breaks a shared context
        B, R, O = pair["tokens"].shape[:3]
        ev = RankingEvaluator(cfg, need_nsp=False, dtype=torch.bfloat16,
                              device=dev)
        got, secs, launches = counted(lambda: ev.score_slates(model, pair))
        check_scores(got, B * R * O)
        bad = ~ev._prefix.last_ok
        if bad.sum() != 3:
            raise SystemExit(f"fallback: {int(bad.sum())} ineligible slates")
        g, c = -(-(B * R - 3) // 40), -(-3 * O // 256)
        expect("fallback", launches,
               {"answer_block": n_t * g, "xent_head": g,
                "ffn_block": (n_t + n_c) * (g + c),
                "attention_block": n_t * c})
        runs["fallback"] = launches
        plain = RankingEvaluator(cfg.replace(attention_impl="xla"),
                                 need_nsp=False, dtype=torch.bfloat16,
                                 device=dev).score_slates(model, pair)
        ks, ps = (sc["ll_sum"].reshape(B * R, O) for sc in (got, plain))
        top1 = float((ks.argmax(-1) == ps.argmax(-1)).mean())
        d_mean = float(np.abs(got["ll_mean"] - plain["ll_mean"]).max())
        d_flat = float(np.abs(got["ll_mean"] - plain["ll_mean"]).reshape(
            B * R, O)[bad].max())
        print(json.dumps({"fallback": {
            "launches": launches, "seconds": secs, "slates": B * R,
            "ineligible": 3, "top1_agreement": top1,
            "max_abs_d_ll_mean": d_mean,
            "max_abs_d_ll_mean_fallback_slates": d_flat,
            "min_agreement": MIN_TOP1_AGREEMENT}}), flush=True)
        if top1 < MIN_TOP1_AGREEMENT:
            raise SystemExit(f"fallback: top-1 agreement {top1}")

    with phase("8 training"):
        _, train_b = phase_train(dev, card, runs)

    with phase("9 per-head attention and remat"):
        phase_per_head(dev, card, runs, model, cfg,
                       {"pinned": dis_p[:2], "realistic": dis_r[:2]},
                       dis_steady, train_b["fused"])

    with phase("10 attention-block bench"):
        phase_bench_block(dev, card, runs)

    with phase("11 evaluation CLIs"):
        phase_cli(dev, card, runs)

    with phase("12 training CLIs"):
        phase_train_cli(dev, card, runs, train_b)

    with phase("13 data-parallel world"):
        phase_dist(dev, card, runs)

    with phase("14 mp axis"):
        phase_mp(dev, card, runs)

    with phase("15 encoder modes and VL task heads"):
        phase_modes(dev, card, runs)

    with phase("16 decoder path"):
        phase_decoder(dev, card)

    kernels = []
    for name, source, replaces in KERNELS:
        cs = cases[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(r[name] for r in runs.values()),
            "max_abs_err": max(c["max_abs_err"] for c in cs),
            "ms": cs[0]["ms"], "plain_ms": cs[0]["plain_ms"],
            "bound_ms": cs[0]["bound_ms"], "bound_by": cs[0]["bound_by"],
            "library_ms": cs[0]["library_ms"],
            "launches_by_run": {k: r[name] for k, r in runs.items()},
            "cases": [{k: c[k] for k in ("shape", "ms", "plain_ms",
                                         "bound_ms", "library_ms",
                                         "max_abs_err", "ctx_max_abs_err",
                                         "ctx_rel_err", "rel_errs",
                                         "out_rel_err", "dq_rel_err",
                                         "dk_rel_err", "dv_rel_err",
                                         "control_rel_err",
                                         "control_rel_errs",
                                         "control_max_abs_err",
                                         "control_max_abs_errs", "bit_equal",
                                         "nan_rows",
                                         "ctx_control_rel_err",
                                         "bit_equal_to_attention_block",
                                         "as_run_bound_ms")
                       if k in c} for c in cs]})
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
