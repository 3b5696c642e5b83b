"""Drive the PyTorch/CUDA port on one NVIDIA card: build the Hopper kernels,
hold each against its plain PyTorch version at main-path shapes, then run
generative val_lm ranking end to end and check that it went through the
kernels.

    python3 chip_smoke.py

Phases (any failure exits nonzero with its traceback, and no ok line):
  1. device: require CUDA; print the card's name and power limit; TF32 off.
  2. build: compile unimm_torch/csrc/*.cu for sm_90a (timed).
  3. kernels: each kernel against its plain version on the same bf16
     inputs at full width, with the stated tolerance; kernel, plain and
     one-PyTorch-call (``library_ms``) times by CUDA events; the roofline
     bound from this run's shapes.
  4. main path: ``evaluate_split(mode="ll_sum")`` at the default config
     (12 text / 6 vision / 6 connection layers, hidden 768 / 1024, vocab
     30522) from a seeded init over 4 pinned and 4 realistic
     ``make_val_batch(B=2, R=10, O=100)`` batches; launch counts must be
     12 / 18 / 1 per slate group; scores against the plain versions on the
     card.
The last lines are the kernels JSON, the card line, and
{"ok": true, "device": {...}}.
"""

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
TOL = {"answer_block": (5e-2, 2e-2), "ffn_block": (5e-2, 2e-2),
       "xent_head": (2e-3, 1e-4)}


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


KERNELS = [
    ("answer_block", "unimm_torch/csrc/answer_block.cu",
     "unimm_tpu/ops/pallas_prefix.py:151"),
    ("ffn_block", "unimm_torch/csrc/ffn_block.cu",
     "unimm_tpu/ops/pallas_attention_v2.py:494"),
    ("xent_head", "unimm_torch/csrc/xent_head.cu",
     "unimm_tpu/ops/pallas_head.py:106"),
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
# phase 4: the main path
# ---------------------------------------------------------------------------

def series(cfg, seed, realistic):
    from unimm_torch import workload
    rng = np.random.default_rng(seed)
    fn = workload.realistic_ctx_range(cfg.max_seq_len) if realistic else None
    return [workload.with_ranking_targets(
        workload.make_val_batch(rng, cfg, 2, 10, 100, ctx_range_fn=fn), rng)
        for _ in range(4)]


def phase_main(dev, model, cfg, batches, group=40, coalesce=2):
    """One counted, timed evaluate_split run. Returns (metrics, seconds,
    launches, slate groups)."""
    from unimm_torch.eval.evaluator import evaluate_split
    from unimm_torch.ops.answer_block import answer_block
    from unimm_torch.ops.ffn_block import ffn_block
    from unimm_torch.ops.xent_head import xent_head

    wrappers = (answer_block, ffn_block, xent_head)
    torch.cuda.synchronize()
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    metrics = evaluate_split(model, cfg, batches, mode="ll_sum",
                             dtype=torch.bfloat16, progress_every=0,
                             prefix_group=group, coalesce=coalesce,
                             pipeline_depth=1, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    groups = 0
    for i in range(0, len(batches), coalesce):
        slates = sum(b["tokens"].shape[0] * b["tokens"].shape[1]
                     for b in batches[i:i + coalesce])
        groups += -(-slates // group)
    return metrics, secs, launches, groups


def compare_plain(dev, model, cfg, batches):
    """Per-option scores through the kernels and through their plain
    versions on the card: (top-1 agreement over slates, max |d ll_mean|,
    slates)."""
    from unimm_torch.eval.evaluator import RankingEvaluator, _merge_batches
    agree, n, d_mean = 0, 0, 0.0
    evs = [RankingEvaluator(cfg.replace(attention_impl=impl),
                            dtype=torch.bfloat16, device=dev)
           for impl in ("pallas_block", "xla")]
    for i in range(0, len(batches), 2):
        pair = _merge_batches(batches[i:i + 2])
        B, R, O = pair["tokens"].shape[:3]
        k, p = (ev.score_slates(model, pair) for ev in evs)
        for s in (k, p):
            for v in s.values():
                if v.shape != (B * R * O,) or not np.isfinite(v).all():
                    raise SystemExit("non-finite or misshapen scores")
        ks, ps = (s["ll_sum"].reshape(B * R, O) for s in (k, p))
        agree += int((ks.argmax(-1) == ps.argmax(-1)).sum())
        n += B * R
        d_mean = max(d_mean, float(np.abs(k["ll_mean"] - p["ll_mean"]).max()))
    return agree / n, d_mean, n


def steady_throughput(dev, model, cfg, batches, repeats=3):
    """dialogs/s by bench.py's protocol: one persistent evaluator, the
    batches coalesced in pairs, each pair staged and launched before the
    previous one is fetched; the median of ``repeats`` passes after a
    warm-up pass. Unlike one evaluate_split call, it leaves out the
    per-call set-up (the compute-dtype copy of the model)."""
    from unimm_torch.eval.evaluator import RankingEvaluator, _merge_batches
    ev = RankingEvaluator(cfg, dtype=torch.bfloat16, device=dev)
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda", 0)

    from unimm_torch.config import VilbertConfig
    from unimm_torch.models import vilbert
    from unimm_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc ran: {_build.build_seconds is not None})", flush=True)
    for cu in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in cu.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {cu.stem}: {line.strip()}", flush=True)

    cases = phase_kernels(dev)

    cfg = VilbertConfig()
    model = vilbert.init_model(cfg, seed=0, device=dev)
    pinned = series(cfg, 0, realistic=False)
    realistic = series(cfg, 1, realistic=True)
    for batches in (pinned, realistic):          # warm-up, not counted
        phase_main(dev, model, cfg, batches)
    runs = {}
    for name, batches in (("pinned", pinned), ("realistic", realistic)):
        metrics, secs, launches, groups = phase_main(dev, model, cfg, batches)
        # per slate group: one answer block per text layer, one FFN per text
        # and connection layer, one label head (12 / 18 / 1 by default)
        n_t, n_c = cfg.num_hidden_layers, len(cfg.t_biattention_id)
        want = {"answer_block": n_t * groups, "ffn_block": (n_t + n_c) * groups,
                "xent_head": groups}
        if launches != want:
            raise SystemExit(f"{name}: launches {launches} != {want}")
        if not all(math.isfinite(v) for v in metrics.values()):
            raise SystemExit(f"{name}: non-finite metrics {metrics}")
        dialogs = sum(b["tokens"].shape[0] for b in batches)
        runs[name] = dict(launches=launches, groups=groups, seconds=secs,
                          dialogs_per_s=dialogs / secs,
                          r1=metrics["r@1"], mrr=metrics["mrr"],
                          ndcg=metrics["ndcg"])
        print(json.dumps({"main_path": name, **runs[name]}), flush=True)
    top1, d_mean, n = compare_plain(dev, model, cfg, pinned + realistic)
    print(json.dumps({"kernels_vs_plain": {"slates": n, "top1_agreement":
                                           top1, "max_abs_d_ll_mean": d_mean,
                                           "min_agreement":
                                           MIN_TOP1_AGREEMENT}}), flush=True)
    if top1 < MIN_TOP1_AGREEMENT:
        raise SystemExit(f"top-1 agreement {top1} < {MIN_TOP1_AGREEMENT}")
    steady = {name: steady_throughput(dev, model, cfg, batches)
              for name, batches in (("pinned", pinned),
                                    ("realistic", realistic))}
    print(json.dumps({"dialogs_per_s": {
        "evaluate_split": {k: v["dialogs_per_s"] for k, v in runs.items()},
        "steady": {k: v[0] for k, v in steady.items()},
        "steady_repeats": {k: v[1] for k, v in steady.items()}},
        "card": card}), flush=True)

    kernels = []
    for name, source, replaces in KERNELS:
        cs = cases[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(r["launches"][name] for r in runs.values()),
            "max_abs_err": max(c["max_abs_err"] for c in cs),
            "ms": cs[0]["ms"], "plain_ms": cs[0]["plain_ms"],
            "bound_ms": cs[0]["bound_ms"], "bound_by": cs[0]["bound_by"],
            "library_ms": cs[0]["library_ms"],
            "cases": [{k: c[k] for k in ("shape", "ms", "plain_ms",
                                         "bound_ms", "library_ms",
                                         "max_abs_err")} for c in cs]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
