"""Drive the PyTorch/CUDA port on one NVIDIA card: build the Hopper kernels,
hold each against its plain PyTorch version at main-path shapes, then run
the serving paths end to end and check that they went through the kernels.

    python3 chip_smoke.py

Phases (any failure exits nonzero with its traceback, and no ok line; each
prints its seconds):
  1. device: require CUDA; print the card's name and power limit; TF32 off.
  2. build: compile unimm_torch/csrc/*.cu for sm_90a (timed); print
     ptxas's registers and spills of every kernel, the one-pass per-head
     kernel's (B6's forward, B9) with its shared memory and CTAs an SM
     (fails on a spill), and whether each seq_attn_kernel instance kept
     the SASS of the first design's build (tools/sass_digest).
  3. kernels: each kernel against its plain version on the same bf16
     inputs at full width, with the stated tolerance; kernel, plain and
     one-PyTorch-call (``library_ms``) times by CUDA events; the roofline
     bound from this run's shapes.
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
     no farther than the plain bf16 path's; at the default dropouts, the
     kernel path against the attention blocks' plain twin with the same
     masks, every text attention gradient within 15%; (b) default
     dropouts, B 240: 2 warm-up and 5 timed steps with the grouped plain
     AdamW and 5 with the fused one, 12 + 12 attention-block launches per
     step and one AdamW launch per parameter tensor, ms/step, sequences/s
     and peak memory; the fused update against the plain one bit for bit;
     (c) 8 steps on one batch lower the loss.
  9. per-head attention and remat (phase 3 also holds B6's forward and
     backward and B9 against their plain twins, each with a control on
     the flipped descriptors, B6's forward also at L 160 on the edge
     descriptors and on masked tails, and B9 equal to B6's forward bit
     for bit): (a) ``evaluate_split(mode="nsp")`` under
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
     and at L 96, each with a control, and B4 at block_b 2 equal to
     block_b 1 bit for bit): ``tools/bench_attn_block`` runs its 13
     variants, 2 calls a measurement, with 2 B4, 2 K2, 4 B10 and 3 B11
     launches per call round.
The last lines are the kernels JSON, the card line, and
{"ok": true, "device": {...}}.
"""

import contextlib
import json
import math
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

# the SASS digests of the first design's seq_attn_kernel instances, taken
# from commit 0104b97's sources with tools/sass_digest
SASS_RECORD = "unimm_torch/tools/seq_attn_kernel_sass.json"


def report_fwd_kernel():
    """The one-pass per-head kernel's registers and spills (ptxas), its
    shared memory and CTAs an SM at L 256 (the runtime), failing on a
    spill; then whether each seq_attn_kernel instance left for B4, B5, B10
    and B11 kept the SASS of SASS_RECORD's build."""
    from pathlib import Path

    from unimm_torch.ops import attention_v2 as av2
    from unimm_torch.ops import text_attention as ta
    from unimm_torch.tools import sass_digest

    rows = sass_digest.ptxas_report("seq_attn_fwd_kernel")
    for r in rows:
        print(json.dumps({"ptxas": r}), flush=True)
    if len(rows) != 2 or any(r.get("spill_stores", 1) or
                             r.get("spill_loads", 1) for r in rows):
        raise SystemExit(f"seq_attn_fwd_kernel: want 2 instances without "
                         f"spills, got {rows}")
    print(json.dumps({"seq_attn_fwd_kernel": {
        "text_attention_fwd": ta.fwd_kernel_info(256),
        "attention_v2": av2.kernel_info(256)}}), flush=True)
    recorded = json.loads((Path(__file__).resolve().parent
                           / SASS_RECORD).read_text())
    current = sass_digest.digests(sass_digest.built_objects())
    print(json.dumps({"seq_attn_kernel_sass": {
        "recorded_nvcc": recorded["nvcc"],
        "nvcc": sass_digest.nvcc_version(),
        "vs_recorded": sass_digest.compare(recorded["digests"], current)}}),
        flush=True)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

# Tolerances, kernel against plain version on the same bf16 inputs. Both
# round at the same points; only the order of fp32 sums differs, which can
# move an intermediate bf16 rounding (q/k/v, probabilities, context, the
# activation) by one step of 2^-8 relative. That reaches the LayerNorm
# output as about one bf16 step of the output's magnitude, so K1 and K2
# hold |d| <= 0.05 + 0.02 |y|. K3 sums 30522 exponentials and takes a log
# in fp32 on both sides: |d| <= 2e-3 + 1e-4 |nll|.
# B4 (attention_block) and B8 (co_text_block) round at the same points as
# K1 (projections, q scale, probabilities, per-head context, LayerNorm
# output) and differ from their plain versions only in fp32 summation
# order, so they take K1's bound.
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
# B9) rounds each probability once too, at another point (its online
# softmax, csrc/seq_attn_fwd.cuh); its readings reach 6.7e-3 / 7.1e-3, one
# bf16 step of an output entry in the largest entry's binade (at most 2^-7
# of the largest entry), controls at least 0.34.
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
TOL = {"answer_block": (5e-2, 2e-2), "ffn_block": (5e-2, 2e-2),
       "xent_head": (2e-3, 1e-4), "attention_block": (5e-2, 2e-2),
       "co_text_block": (5e-2, 2e-2),
       "attention_block_train_fwd": (5e-2, 2e-2),
       "attention_block_train_bwd": (2e-2, 0.0),
       "adamw_update_leaf": (0.0, 0.0),
       "text_attention_fwd": (TA_REL, 0.0),
       "text_attention_bwd": (TA_REL, 0.0), "attention_v2": (TA_REL, 0.0),
       "probe_block": (5e-2, 2e-2), "layout_probe_block": (5e-2, 2e-2)}
B5_CTX_REL = 2e-2
WIDE_STD = 0.05


def check_answer_block(dev, gen, Lcb, RB, G=40, P=1280):
    import torch.nn.functional as F
    from unimm_torch.models import vilbert
    from unimm_torch.ops.answer_block import answer_block, answer_block_plain
    from unimm_torch.ops.masks import NEG_INF

    H, D, Hd = 12, 64, 768
    attn = seeded_module(lambda: vilbert._attention(Hd), gen, dev)
    x = torch.randn(G, P, Hd, generator=gen, device=dev).to(torch.bfloat16)
    tc = torch.randn(G, Lcb, Hd, generator=gen, device=dev).to(torch.bfloat16)
    kc = vilbert.linear(attn.self.key, tc)
    vc = vilbert.linear(attn.self.value, tc)
    lc = torch.randint(2, Lcb + 1, (G,), generator=gen, device=dev)
    j = torch.arange(Lcb, device=dev)
    b_ctx = torch.where((j >= 1) & (j < lc[:, None]), 0.0,
                        NEG_INF).float()[:, None, :].contiguous()
    # block-diagonal option structure: options of 2..16 rows, causal inside
    PB = P // RB
    opt = torch.cumsum(torch.rand(G, PB, RB, generator=gen, device=dev)
                       < 0.12, -1)
    r = torch.arange(RB, device=dev)
    open_ = ((opt[..., :, None] == opt[..., None, :])
             & (r[None, :] <= r[:, None])) | torch.eye(RB, dtype=torch.bool,
                                                       device=dev)
    b_rr = torch.where(open_, 0.0, NEG_INF).float().contiguous()

    def kern():
        return answer_block(x, kc, vc, b_ctx, b_rr, attn, num_heads=H)

    def plain():
        return answer_block_plain(x, kc, vc, b_ctx, b_rr, attn, num_heads=H)

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

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err, rel, ok = within(got, want, *TOL["answer_block"])
    M, NK = G * P, Lcb + RB
    flops = 8 * M * Hd * Hd + 4 * M * NK * Hd
    nbytes = (2 * M * Hd * 2 + 2 * G * Lcb * Hd * 2 + G * Lcb * 4
              + G * PB * RB * RB * 4 + 4 * (Hd * Hd + Hd) * 2 + 2 * Hd * 2)
    b_ms, b_by = bound(flops, nbytes)
    return dict(shape=f"G={G} P={P} Lcb={Lcb} RB={RB}", max_abs_err=err,
                max_rel_err=rel, ok=ok, ms=time_ms(kern, 10),
                plain_ms=time_ms(plain, 3, 1), bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(library, 10))


def check_ffn_block(dev, gen, N=200, R=256):
    import torch.nn.functional as F
    from unimm_torch.models import vilbert
    from unimm_torch.ops.ffn_block import ffn_block, ffn_block_plain

    Hd, I = 768, 3072
    layer = seeded_module(lambda: vilbert._layer(Hd, I), gen, dev)
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
    torch.cuda.synchronize()
    err, rel, ok = within(got, want, *TOL["ffn_block"])
    M = N * R
    flops = 4 * M * Hd * I
    nbytes = 2 * M * Hd * 2 + 2 * Hd * I * 2 + (I + 3 * Hd) * 2
    b_ms, b_by = bound(flops, nbytes)
    return dict(shape=f"[{N}, {R}, {Hd}] inter {I}", max_abs_err=err,
                max_rel_err=rel, ok=ok, ms=time_ms(kern, 10),
                plain_ms=time_ms(plain, 3, 1), bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(library, 10))


def check_xent_head(dev, gen, M=25600, V=30522):
    import torch.nn.functional as F
    from unimm_torch.ops.xent_head import xent_head, xent_head_plain

    Hd = 768
    h = torch.randn(M, Hd, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(V, Hd, generator=gen, device=dev) * 0.02).to(
        torch.bfloat16)
    b = torch.randn(V, generator=gen, device=dev) * 0.1
    lab = torch.randint(0, V, (M,), generator=gen, device=dev)
    lab[torch.rand(M, generator=gen, device=dev) < 0.5] = -1
    lab[0], lab[1] = V - 1, 0          # the vocab tail and head

    def kern():
        return xent_head(h, w, b, lab)

    def plain():
        return xent_head_plain(h, w, b, lab)

    def library():
        return F.cross_entropy(h @ w.t() + b, lab, reduction="none",
                               ignore_index=-1)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err, rel, ok = within(got, want, *TOL["xent_head"])
    ok = ok and bool((got[lab == -1] == 0).all())
    flops = 2 * M * Hd * V
    nbytes = M * Hd * 2 + V * Hd * 2 + V * 4 + M * 8 + M * 4
    b_ms, b_by = bound(flops, nbytes)
    return dict(shape=f"M={M} V={V}", max_abs_err=err, max_rel_err=rel,
                ok=ok, ms=time_ms(kern, 5), plain_ms=time_ms(plain, 2, 1),
                bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library, 5))


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


def check_attention_block(dev, gen, L, desc_fn, B=256):
    from unimm_torch.models import vilbert
    from unimm_torch.ops.attention_block import (attention_block,
                                                 attention_block_plain)
    from unimm_torch.ops.masks import mask_bias

    H, Hd = 12, 768
    attn = seeded_module(lambda: vilbert._attention(Hd), gen, dev)
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
    torch.cuda.synchronize()
    err, rel, ok = within(got, want, *TOL["attention_block"])
    M = B * L
    flops = 8 * M * Hd * Hd + 4 * B * L * L * Hd
    nbytes = 2 * M * Hd * 2 + B * 3 * 4 + (4 * (Hd * Hd + Hd) + 2 * Hd) * 2
    b_ms, b_by = bound(flops, nbytes)
    return dict(shape=f"[{B}, {L}, {Hd}] {desc_fn.__name__}",
                max_abs_err=err, max_rel_err=rel, ok=ok,
                ms=time_ms(kern, 10), plain_ms=time_ms(plain, 3, 1),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(library, 10))


def check_co_text_block(dev, gen, B=256, L=224, R=37):
    import torch.nn.functional as F
    from unimm_torch.config import VilbertConfig
    from unimm_torch.models import vilbert
    from unimm_torch.ops.co_text_block import (co_text_block,
                                               co_text_block_plain)
    from unimm_torch.ops.masks import NEG_INF

    H, D, Ht, Bi = 8, 128, 768, 1024
    conn = seeded_module(lambda: vilbert._connection(VilbertConfig()), gen,
                         dev)
    t_x = torch.randn(B, L, Ht, generator=gen, device=dev).to(torch.bfloat16)
    v_x = torch.randn(B, R, Bi, generator=gen, device=dev).to(torch.bfloat16)
    im = (torch.rand(B, R, generator=gen, device=dev) > 0.2).float()
    im[3] = 0.0                        # one sequence with every region masked
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
    torch.cuda.synchronize()
    err, rel, ok = within(got, want, *TOL["co_text_block"])
    M = B * L
    flops = (2 * M * Ht * Bi + 4 * B * R * Bi * Bi + 4 * M * R * Bi
             + 2 * M * Bi * Ht)
    nbytes = (2 * M * Ht * 2 + B * R * Bi * 2 + B * R * 4
              + (Bi * Ht + 2 * Bi * Bi + Ht * Bi + 3 * Bi + 3 * Ht) * 2)
    b_ms, b_by = bound(flops, nbytes)
    return dict(shape=f"[{B}, {L}, {Ht}] x [{B}, {R}, {Bi}]",
                max_abs_err=err, max_rel_err=rel, ok=ok,
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


def check_attention_block_train(dev, gen, B, L, desc_fn, drop=0.1):
    """B5's forward and backward kernels against their plain twins on the
    same bf16 inputs, Philox seed and hidden-dropout mask: two result
    dicts (forward, backward). The forward's control holds the kernel's
    output against the plain twin under another Philox seed: that must
    fail both forward bounds, or the check could not see a wrong mask."""
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

    def bwd_plain():
        return abt.attention_block_train_bwd_plain(x, dctx, desc, seed,
                                                   *ws[:6], **kw)

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
    b_errs = {n: rel_err(g, w) for n, g, w in
              zip(("dx", "dq", "dk", "dv"), got, want)}
    b_ok = all(e <= TOL["attention_block_train_bwd"][0]
               for e in b_errs.values())
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
                    other_seed=control, ok=f_ok and c_ok, ms=time_ms(fwd, 10),
                    plain_ms=time_ms(fwd_plain, 2, 1), bound_ms=fb_ms,
                    bound_by=fb_by, library_ms=time_ms(library_fwd, 10))
    with torch.enable_grad():
        xg = x.detach().requires_grad_()
        c_lib, qkv = lib_ctx(xg)

        def library_bwd():
            return torch.autograd.grad(c_lib, [xg, *qkv], dctx,
                                       retain_graph=True)

        bwd_case = dict(shape=shape, max_abs_err=b_abs, rel_errs=b_errs,
                        ok=b_ok, ms=time_ms(bwd, 10),
                        plain_ms=time_ms(bwd_plain, 2, 1), bound_ms=bb_ms,
                        bound_by=bb_by, library_ms=time_ms(library_bwd, 10))
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
    for each of dq, dk, dv."""
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
                ok=max(errs.values()) <= tol, ms=time_ms(kern, 10),
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


def check_probe(dev, gen, name, kind, B, L, desc_fn):
    """B10 (``name`` "probe_block", ``kind`` a softmax mode) or B11
    ("layout_probe_block", a layout) against its plain twin on the same
    bf16 inputs, weights at WIDE_STD. The control must miss the same bound:
    the twin on the flipped descriptors, or for skip the full twin. B10's
    context is held as well (check_probe_ctx)."""
    import torch.nn.functional as F
    from unimm_torch.models import vilbert
    from unimm_torch.ops import block_probe as bp
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
                   ok=ok and c_err <= TA_REL)
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
    bench's shape and descriptors, then at L 96 on the edge descriptors
    (padding keys under none, fully masked rows under noshift)."""
    out = {}
    for name, kinds in (("probe_block", ("full", "none", "noshift", "skip")),
                        ("layout_probe_block",
                         ("wo_acc", "transposed", "pad128"))):
        out[name] = ([check_probe(dev, gen, name, k, 512, 256, bench_desc)
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
]


def heads_cases(dev, gen):
    """Phase 3's cases of the per-head attention kernels: B6's forward at
    the flat path's main and longest buckets and the training step's shape,
    then the edge descriptors at L 32, 96 and 160 and the masked tails at
    L 256 (skipped chunks and fully masked rows in one 16-row tile); its
    backward at the training step's shape and at L 96; B9 at its bench's
    shape. Then B9 must equal B6's forward bit for bit."""
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
            check_text_attention_bwd(dev, gen, 20, 96, edge_desc)],
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
                         check_answer_block(dev, gen, 96, 64, G=4, P=512)],
        "ffn_block": [check_ffn_block(dev, gen),
                      check_ffn_block(dev, gen, N=3, R=100)],
        "xent_head": [check_xent_head(dev, gen),
                      check_xent_head(dev, gen, M=1000)],
        # the flat path's main bucket, the longest one, the shortest one
        # with every kind of descriptor, and the longest with the same
        "attention_block": [check_attention_block(dev, gen, 192, dis_desc),
                            check_attention_block(dev, gen, 256, dis_desc),
                            check_attention_block(dev, gen, 32, edge_desc),
                            check_attention_block(dev, gen, 256, edge_desc,
                                                  B=20)],
        "co_text_block": [check_co_text_block(dev, gen),
                          check_co_text_block(dev, gen, B=5, L=32)],
    }
    # the training step's shape first, then the edge descriptors at a
    # length with a half key chunk
    b5 = [check_attention_block_train(dev, gen, 240, 256, train_desc),
          check_attention_block_train(dev, gen, 20, 96, edge_desc)]
    cases["attention_block_train_fwd"] = [f for f, _ in b5]
    cases["attention_block_train_bwd"] = [b for _, b in b5]
    # the largest parameter tensor (the tied word embeddings), a bias, and
    # a length that leaves a tail past the float4 loads
    cases["adamw_update_leaf"] = [check_adamw(dev, gen, (30522, 768)),
                      check_adamw(dev, gen, (768,)),
                      check_adamw(dev, gen, (1001,))]
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
    from unimm_torch.ops.text_attention import (text_attention_bwd,
                                                text_attention_fwd)
    from unimm_torch.ops.xent_head import xent_head
    return (answer_block, ffn_block, xent_head, attention_block,
            co_text_block, attention_block_train_fwd,
            attention_block_train_bwd, adamw_update_leaf, text_attention_fwd,
            text_attention_bwd, attention_v2, probe_block,
            layout_probe_block)


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


def steady_throughput(dev, model, cfg, batches, need_lm, repeats=3):
    """dialogs/s by the bench protocol (bench.py, scripts/bench_dis.py):
    one persistent evaluator, the batches coalesced in pairs, each pair
    staged and launched before the previous one is fetched; the median of
    ``repeats`` passes after a warm-up pass. Unlike one evaluate_split
    call, it leaves out the per-call set-up (the compute-dtype copy of the
    model)."""
    from unimm_torch.eval.evaluator import RankingEvaluator, _merge_batches
    ev = RankingEvaluator(cfg, need_lm=need_lm, need_nsp=not need_lm,
                          dtype=torch.bfloat16, device=dev)
    pairs = [_merge_batches(batches[i:i + 2])
             for i in range(0, len(batches), 2)]
    for p in pairs:
        ev.score_slates(model, p)
    dialogs = sum(b["tokens"].shape[0] for b in batches)
    rates = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = ev.score_slates_async(model, pairs[0])
        for p in pairs[1:]:
            nxt = ev.score_slates_async(model, p)
            pending()
            pending = nxt
        pending()
        rates.append(dialogs / (time.perf_counter() - t0))
    return sorted(rates)[len(rates) // 2], rates


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
LOSS_RTOL = 1e-2
GRAD_SLACK, GRAD_FLOOR = 1.5, 1e-2
MIN_GRAD_COSINE = 0.99
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


def on_device(batch, dev):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


@contextlib.contextmanager
def plain_block_train():
    """Inside: the training step's text attention blocks run as autograd
    through the forward kernel's plain twin (its Philox mask, hidden-
    dropout mask and rounding points), launching no kernel."""
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


def compare_grads(g_k, g_p, g_32):
    """Per parameter: the relative norm distance of the kernel path's
    gradient g_k and of the plain bf16 path's g_p to the fp32 gradient
    g_32, and the cosine of g_k with g_32. Returns (summary, failures)."""
    worst, bad = {"cos_k32": 1.0, "rel_k32": 0.0, "rel_p32": 0.0,
                  "rel_kp": 0.0}, []
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
        worst["cos_k32"] = min(worst["cos_k32"], cos)
        for k, v in (("rel_k32", rel_k), ("rel_p32", rel_p),
                     ("rel_kp", rel_kp)):
            worst[k] = max(worst[k], v)
        if cos < MIN_GRAD_COSINE or rel_k > GRAD_SLACK * rel_p + GRAD_FLOOR:
            bad.append((name, cos, rel_k, rel_p))
    return worst, bad


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
                "attention_block_train_bwd": n_t}

    def times(d, k):
        return {name: n * k for name, n in d.items()}

    # (a) kernel path against the all-plain path, dropout 0, B 64
    cfg0 = cfg.replace(**NO_DROPOUT)
    model = vilbert.train_model(cfg0, seed=0, device=dev)
    batch = on_device(workload.make_train_batch(np.random.default_rng(10),
                                                cfg, B_small), dev)

    def loss_and_grads(c, dtype=torch.bfloat16):
        for p in model.parameters():
            p.grad = None
        parts = unimm.forward_train(model, c, batch, dtype=dtype,
                                    rng=vilbert.DropoutRng(0, dev))
        sum(parts.values()).backward()
        return ({k: float(v.detach()) for k, v in parts.items()},
                {n: p.grad for n, p in model.named_parameters()})

    plain = cfg0.replace(attention_impl="xla")
    with torch.enable_grad():
        (parts_k, g_k), secs, launches = counted(lambda: loss_and_grads(cfg0))
        expect("train (a) kernel path", launches, per_step)
        runs["train_a"] = launches
        parts_p, g_p = loss_and_grads(plain)
        _, g_32 = loss_and_grads(plain, torch.float32)
    loss_ok = all(abs(parts_k[k] - parts_p[k]) <= LOSS_RTOL * abs(parts_p[k])
                  for k in parts_p)
    worst, bad = compare_grads(g_k, g_p, g_32)
    res_a = dict(batch=B_small, losses_kernel=parts_k, losses_plain=parts_p,
                 loss_rtol=LOSS_RTOL, worst=worst,
                 gates=dict(slack=GRAD_SLACK, floor=GRAD_FLOOR,
                            min_cosine=MIN_GRAD_COSINE),
                 failures=bad[:10], seconds=secs)
    print(json.dumps({"train_vs_plain": res_a}), flush=True)
    if not loss_ok or bad:
        raise SystemExit(f"training step disagrees with the plain path: "
                         f"{res_a}")
    del g_k, g_p, g_32

    # (a) at the default dropouts: the kernel path against the plain twin
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
        expect("train (a) dropout, plain twin", launches, {})
        _, g_o = drop_step(2)
    loss_ok = all(abs(parts_k[k] - parts_t[k]) <= LOSS_RTOL * abs(parts_t[k])
                  for k in parts_t)
    worst, bad = compare_twin(g_k, g_t, g_o)
    res_d = dict(batch=B_small, losses_kernel=parts_k, losses_twin=parts_t,
                 loss_rtol=LOSS_RTOL, worst=worst, rel_tol=TWIN_GRAD_REL,
                 failures=bad[:10], seconds=secs)
    print(json.dumps({"train_dropout_vs_twin": res_d}), flush=True)
    if not loss_ok or bad:
        raise SystemExit(f"training step at dropout disagrees with the "
                         f"plain twin: {res_d}")
    del model, g_k, g_t, g_o, batch

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
        o.count = src.count
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
               {"text_attention_fwd": n_t, "text_attention_bwd": n_t})
        runs["pallas_train_b64"] = launches
        g_k = {n: g.clone() for n, g in g_k.items() if g is not None}
        parts_p, g_p = train_grads(model_t, plain, small, 3)
        g_p = {n: g.clone() for n, g in g_p.items() if g is not None}
        _, g_32 = train_grads(model_t, plain, small, 3, torch.float32)
    leaf = re.compile(TEXT_ATTN_LEAF)
    worst, bad = compare_grads(g_k, g_p, {n: g for n, g in g_32.items()
                                          if leaf.fullmatch(n)})
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
            "adamw_update_leaf": 3 * n_params})
    runs["pallas_train"] = launches
    steps["pallas"] = res

    # (c) remat: B 240 steps, and at B 64 the gradients against the step
    # without remat
    remat = {}
    for impl, c, want in (
            ("pallas", cfg_t, {"text_attention_fwd": 2 * n_t,
                               "text_attention_bwd": n_t}),
            ("pallas_block", cfg, {"attention_block_train_fwd": n_t,
                                   "attention_block_train_bwd": n_t})):
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
    expect("pallas train at attention dropout", launches, {})
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


@contextlib.contextmanager
def phase(name):
    """Print the phase's seconds when it ends."""
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)


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

    from unimm_torch.config import VilbertConfig
    from unimm_torch.eval.evaluator import (RankingEvaluator, _merge_batches,
                                            evaluate_ensemble)
    from unimm_torch.models import vilbert
    from unimm_torch.ops import _build

    with phase("2 build"):
        _build.library()
    print(f"build: nvcc ran: {_build.build_seconds is not None}", flush=True)
    for cu in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in cu.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {cu.stem}: {line.strip()}", flush=True)
    report_fwd_kernel()

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
                                         "control_max_abs_err", "nan_rows",
                                         "ctx_control_rel_err",
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
