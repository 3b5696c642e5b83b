"""Drive the PyTorch/CUDA port on one NVIDIA card: build the Hopper kernels,
hold each against its plain PyTorch version at main-path shapes, then run
the serving paths end to end and check that they went through the kernels.

    python3 chip_smoke.py

Phases (any failure exits nonzero with its traceback, and no ok line; each
prints its seconds):
  1. device: require CUDA; print the card's name and power limit; TF32 off.
  2. build: compile unimm_torch/csrc/*.cu for sm_90a (timed).
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
The last lines are the kernels JSON, the card line, and
{"ok": true, "device": {...}}.
"""

import contextlib
import json
import math
import subprocess
import sys
import time

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


def within(got, want, atol, rtol):
    """(max abs err, max rel err, ok) of got against want, in fp32."""
    g, w = got.float(), want.float()
    if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
        return float("inf"), float("inf"), False
    err = (g - w).abs()
    rel = err / w.abs().clamp(min=1e-6)
    ok = bool((err <= atol + rtol * w.abs()).all())
    return float(err.max()), float(rel.max()), ok


def seeded_module(make, gen, dev):
    """A bf16 module from ``make`` with weights drawn from ``gen``: Linear
    weights normal(0, 0.02) and small biases, LayerNorm near (1, 0)."""
    with torch.device(dev):
        mod = make()
    with torch.no_grad():
        for m in mod.modules():
            if isinstance(m, torch.nn.Linear):
                m.weight.normal_(0.0, 0.02, generator=gen)
                m.bias.normal_(0.0, 0.02, generator=gen)
            elif isinstance(m, torch.nn.LayerNorm):
                m.weight.normal_(1.0, 0.1, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
    return mod.to(torch.bfloat16)


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
TOL = {"answer_block": (5e-2, 2e-2), "ffn_block": (5e-2, 2e-2),
       "xent_head": (2e-3, 1e-4), "attention_block": (5e-2, 2e-2),
       "co_text_block": (5e-2, 2e-2)}


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


def check_attention_block(dev, gen, L, desc_fn, B=256):
    import torch.nn.functional as F
    from unimm_torch.models import vilbert
    from unimm_torch.ops.attention_block import (attention_block,
                                                 attention_block_plain)
    from unimm_torch.ops.masks import mask_bias

    H, D, Hd = 12, 64, 768
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
        ps, po = attn.self, attn.output

        def heads(t):
            return t.view(B, L, H, D).transpose(1, 2)

        q = heads(F.linear(x, ps.query.weight, ps.query.bias))
        k = heads(F.linear(x, ps.key.weight, ps.key.bias))
        v = heads(F.linear(x, ps.value.weight, ps.value.bias))
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        o = o.transpose(1, 2).reshape(B, L, Hd)
        h = F.linear(o, po.dense.weight, po.dense.bias) + x
        return F.layer_norm(h, (Hd,), po.LayerNorm.weight,
                            po.LayerNorm.bias, 1e-12)

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
]


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
    from unimm_torch.ops.answer_block import answer_block
    from unimm_torch.ops.attention_block import attention_block
    from unimm_torch.ops.co_text_block import co_text_block
    from unimm_torch.ops.ffn_block import ffn_block
    from unimm_torch.ops.xent_head import xent_head
    return (answer_block, ffn_block, xent_head, attention_block,
            co_text_block)


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
    return out, time.perf_counter() - t0, {w.__name__: w.launches
                                           for w in ws}


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
                                         "max_abs_err")} for c in cs]})
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
