"""Device-time breakdowns from ``torch.profiler`` (CUPTI) on a CUDA card.

    python3 -m unimm_torch.tools.kernel_profile [--iters 5]
    python3 -m unimm_torch.tools.kernel_profile --main-path [--steady]
    python3 -m unimm_torch.tools.kernel_profile --dis-path [--steady]
    python3 -m unimm_torch.tools.kernel_profile --train-step
        [--attention-impl {pallas_block,pallas,xla}] [--remat]

Default: for each kernel wrapper at main-path shapes, a JSON line with the
mean device time per call of every CUDA kernel the call launched (the
sub-kernels of one wrapper seen one by one; the training attention block's
forward and backward at [240, 256, 768] on the training descriptors, so
its GEMMs and attention launches show apart); the attention-block bench's
probes at its shape [512, 256, 768], on its descriptors ("bench") and on
descriptors under which every row attends every key ("open"), so that a
cost that depends on fully masked rows shows. ``--main-path``: one warm
generative ``evaluate_split`` over 2 coalesced pinned batches (one slate
group pair) at the default config; ``--dis-path``: one warm
discriminative ``evaluate_split(mode="nsp")`` over 2 coalesced pinned
``make_dis_batch`` batches (one group of 16 chunks); ``--train-step``: one
warm training step (``train/step.make_train_step``, fused AdamW) at the
default config on a 240-sequence ``make_train_batch``.
``--steady`` adds to ``--dis-path`` the steady dialogs/s of 4 pinned
batches by chip_smoke.py's protocol (``steady_throughput``, 5 passes), and
to ``--main-path`` that of phase 4's 4 pinned and 4 realistic batches (3
passes each, as phase 4 takes them).
``--attention-impl`` sets the text stream's attention path of
``--dis-path`` and ``--train-step`` (default "pallas_block"; "pallas" trains
at attention dropout 0, where its kernel runs); ``--remat`` turns on
encoder remat for ``--train-step``. Each reports its wall
time, the summed device time of all kernels, the device idle share (1 -
device / wall; one stream, so kernels do not overlap), the kernels that
took the most device time, every attention kernel (``*_attn_*``: which
attention design ran), every GEMM-core launch of the block kernels
(``GEMM_CORES``: which GEMM design ran), and the PyTorch operators whose
kernels took the most (inclusive). All end with the card's name and power
limit.
"""

import argparse
import json
import subprocess

import torch


def _kernel_times(fn, iters):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = ev.cuda_time_total
        if t:
            out[ev.key[:80]] = round(t / iters / 1e3, 4)   # ms per call
    return out


def steady_throughput(dev, model, cfg, batches, need_lm, repeats=3):
    """dialogs/s by the bench protocol (bench.py, scripts/bench_dis.py):
    one persistent evaluator, the batches coalesced in pairs, each pair
    staged and launched before the previous one is fetched; the median of
    ``repeats`` passes after a warm-up pass. Unlike one evaluate_split
    call, it leaves out the per-call set-up (the compute-dtype copy of the
    model)."""
    import time

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


def main_path(dev, dis=False, impl="pallas_block", steady=False):
    import numpy as np

    from unimm_torch import workload
    from unimm_torch.config import VilbertConfig
    from unimm_torch.eval.evaluator import evaluate_split
    from unimm_torch.models import vilbert

    cfg = VilbertConfig(attention_impl=impl)
    model = vilbert.init_model(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    if dis:
        batches = [workload.make_dis_batch(rng, cfg, 2, 10, 100)
                   for _ in range(4 if steady else 2)]
    else:
        batches = [workload.with_ranking_targets(
            workload.make_val_batch(rng, cfg, 2, 10, 100), rng)
            for _ in range(4 if steady else 2)]

    def run():
        evaluate_split(model, cfg, batches[:2],
                       mode="nsp" if dis else "ll_sum", progress_every=0,
                       device=dev)
        torch.cuda.synchronize()

    run()
    _profile(run, f"dis {impl}" if dis else "gen")
    if steady and dis:
        rate, rates = steady_throughput(dev, model, cfg, batches,
                                        need_lm=False, repeats=5)
        print(json.dumps({"path": f"dis {impl}", "steady_dialogs_per_s":
                          rate, "passes": rates}), flush=True)
    elif steady:   # chip_smoke.py phase 4's pinned and realistic series
        rng = np.random.default_rng(1)
        fn = workload.realistic_ctx_range(cfg.max_seq_len)
        realistic = [workload.with_ranking_targets(workload.make_val_batch(
            rng, cfg, 2, 10, 100, ctx_range_fn=fn), rng) for _ in range(4)]
        for name, b in (("pinned", batches), ("realistic", realistic)):
            rate, rates = steady_throughput(dev, model, cfg, b, need_lm=True)
            print(json.dumps({"path": "gen", "series": name,
                              "steady_dialogs_per_s": rate,
                              "passes": rates}), flush=True)


def train_step(dev, impl="pallas_block", remat=False):
    from pathlib import Path

    import numpy as np

    from unimm_torch import workload
    from unimm_torch.config import VilbertConfig
    from unimm_torch.models import vilbert
    from unimm_torch.train import optim
    from unimm_torch.train import step as tstep

    cfg = VilbertConfig(attention_impl=impl, remat=remat)
    if impl == "pallas":
        cfg = cfg.replace(attention_probs_dropout_prob=0.0)
    model = vilbert.train_model(cfg, seed=0, device=dev)
    lang = optim.load_language_weights(
        Path(__file__).resolve().parents[2] / "config"
        / "language_weights.json")
    state = tstep.init_state(model, optim.make_fused_optimizer(
        model, optim.OptimConfig(warmup_steps=10, t_total=1000), lang))
    step = tstep.make_train_step(cfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             workload.make_train_batch(np.random.default_rng(0), cfg,
                                       240).items()}

    def run():
        step(state, batch)
        torch.cuda.synchronize()

    with torch.enable_grad():
        run()
        run()
        _profile(run, f"train {impl}" + (" remat" if remat else ""))


# the block kernels' GEMM launches: the wgmma + TMA core and its row
# LayerNorm, and the probes' wo_acc_wg_kernel (attention, output product
# and LayerNorm in one launch)
GEMM_CORES = ("gemm_nt_wg_kernel", "ln_rows_kernel", "wo_acc_wg_kernel")


def _profile(run, label):
    """Profile one ``run()`` and print its breakdown."""
    import time

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    rows, ops = [], []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        if t and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((t / 1e3, ev.count, ev.key[:70]))
        total = getattr(ev, "device_time_total", None)
        if total is None:
            total = ev.cuda_time_total
        if total and ev.key.startswith("aten::"):
            ops.append((total / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    ops.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(json.dumps({"path": label,
                      "main_path_wall_ms": wall * 1e3,
                      "device_busy_ms": busy,
                      "device_idle_share": 1 - busy / (wall * 1e3),
                      "top_kernels": [{"ms": r[0], "launches": r[1],
                                       "name": r[2]} for r in rows[:25]],
                      "attention_kernels": [
                          {"ms": r[0], "launches": r[1], "name": r[2]}
                          for r in rows if "_attn_" in r[2]],
                      "gemm_core_kernels": [
                          {"ms": r[0], "launches": r[1], "name": r[2]}
                          for r in rows if any(k in r[2] for k in GEMM_CORES)],
                      "top_torch_ops": [{"ms": r[0], "calls": r[1],
                                         "op": r[2]} for r in ops[:25]]}),
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--main-path", action="store_true")
    ap.add_argument("--dis-path", action="store_true")
    ap.add_argument("--train-step", action="store_true")
    ap.add_argument("--attention-impl", default="pallas_block",
                    choices=("pallas_block", "pallas", "xla"))
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--steady", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_profile: needs a CUDA device")
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    if args.main_path or args.dis_path:
        main_path(torch.device("cuda", 0), dis=args.dis_path,
                  impl=args.attention_impl if args.dis_path
                  else "pallas_block", steady=args.steady)
        print(card)
        return
    if args.train_step:
        train_step(torch.device("cuda", 0), args.attention_impl,
                   args.remat)
        print(card)
        return
    from unimm_torch.config import VilbertConfig
    from unimm_torch.models import vilbert
    from unimm_torch.ops.answer_block import answer_block
    from unimm_torch.ops.attention_block import attention_block
    from unimm_torch.ops.co_text_block import co_text_block
    from unimm_torch.ops.ffn_block import ffn_block
    from unimm_torch.ops.masks import NEG_INF
    from unimm_torch.ops.xent_head import xent_head

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rand(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(bf)

    def module(make):
        with torch.device(dev):
            m = make()
        for p in m.parameters():
            p.data.normal_(0.0, 0.02, generator=g)
        return m.to(bf)

    attn = module(lambda: vilbert._attention(768))
    for Lcb, RB in ((192, 64), (256, 256)):
        G, P = 40, 1280
        x = rand(G, P, 768)
        kc, vc = rand(G, Lcb, 768, std=0.5), rand(G, Lcb, 768, std=0.5)
        b_ctx = torch.zeros(G, 1, Lcb, device=dev)
        b_ctx[..., 0] = NEG_INF
        b_rr = torch.where(torch.eye(RB, dtype=torch.bool, device=dev), 0.0,
                           NEG_INF).expand(G, P // RB, RB, RB).contiguous()
        t = _kernel_times(lambda: answer_block(x, kc, vc, b_ctx, b_rr, attn,
                                               num_heads=12), args.iters)
        print(json.dumps({"wrapper": "answer_block",
                          "shape": f"G={G} P={P} Lcb={Lcb} RB={RB}",
                          "ms": t}), flush=True)
    layer = module(lambda: vilbert._layer(768, 3072))
    x = rand(200, 256, 768)
    t = _kernel_times(lambda: ffn_block(x, layer.intermediate, layer.output),
                      args.iters)
    print(json.dumps({"wrapper": "ffn_block", "shape": "[200, 256, 768]",
                      "ms": t}), flush=True)
    h, w = rand(25600, 768), rand(30522, 768, std=0.02)
    b = torch.zeros(30522, device=dev)
    lab = torch.randint(0, 30522, (25600,), generator=g, device=dev)
    t = _kernel_times(lambda: xent_head(h, w, b, lab), args.iters)
    print(json.dumps({"wrapper": "xent_head", "shape": "M=25600 V=30522",
                      "ms": t}), flush=True)
    for L in (192, 256):
        x = rand(256, L, 768)
        desc = torch.zeros(256, 3, dtype=torch.int32, device=dev)
        desc[:, 1] = L - 8
        t = _kernel_times(lambda: attention_block(x, desc, attn,
                                                  num_heads=12), args.iters)
        print(json.dumps({"wrapper": "attention_block",
                          "shape": f"[256, {L}, 768]", "ms": t}), flush=True)
    conn = module(lambda: vilbert._connection(VilbertConfig()))
    t_x, v_x = rand(256, 224, 768), rand(256, 37, 1024)
    im = torch.ones(256, 37, device=dev)
    t = _kernel_times(lambda: co_text_block(t_x, v_x, im, conn, num_heads=8),
                      args.iters)
    print(json.dumps({"wrapper": "co_text_block",
                      "shape": "[256, 224, 768] x [256, 37, 1024]", "ms": t}),
          flush=True)
    from unimm_torch.ops.attention_v2 import attention_v2
    from unimm_torch.ops.text_attention import (text_attention_bwd,
                                                text_attention_fwd)
    for B in (256, 512):
        q, k, v, do = (rand(B, 12, 256, 64) for _ in range(4))
        desc = torch.zeros(B, 3, dtype=torch.int32, device=dev)
        desc[:, 1] = 248
        for name, fn in (("text_attention_fwd", lambda: text_attention_fwd(
                              q, k, v, desc)),
                         ("text_attention_bwd", lambda: text_attention_bwd(
                             q, k, v, desc, do)),
                         ("attention_v2", lambda: attention_v2(q, k, v,
                                                               desc))):
            t = _kernel_times(fn, args.iters)
            print(json.dumps({"wrapper": name,
                              "shape": f"[{B}, 12, 256, 64]", "ms": t}),
                  flush=True)
    _train_block(rand, attn, g, args.iters)
    _probes(rand, attn, args.iters)
    print(card)


def _train_block(rand, attn, g, iters, B=240, L=256, drop=0.1):
    """Sub-kernel device times of the training attention block's forward
    and backward wrappers at the training step's shape, on the training
    batch's descriptors (workload.make_train_batch: mode 0 or 1, ctx_end
    60-199, ans_len 2-8) at the default attention dropout: the Q/K/V
    GEMM, the attention launches and the output or dx GEMM one by one."""
    from unimm_torch.ops import attention_block_train as abt
    from unimm_torch.ops.answer_block import _weights
    from unimm_torch.tools.bench_bwd import train_desc

    dev = g.device
    desc = train_desc(B, L, g)
    x, dctx = rand(B, L, 768), rand(B, L, 768)
    m_o = (torch.rand(B, L, 768, generator=g, device=dev) >= drop).float()
    m_o /= 1.0 - drop
    ws = _weights(attn)
    kw = dict(num_heads=12, attn_drop=drop)

    def fwd():
        return abt.attention_block_train_fwd(x, desc, 1234, m_o, *ws, **kw)

    def bwd():
        return abt.attention_block_train_bwd(x, dctx, desc, 1234, *ws[:6],
                                             **kw)

    for name, fn in (("attention_block_train_fwd", fwd),
                     ("attention_block_train_bwd", bwd)):
        print(json.dumps({"wrapper": name,
                          "shape": f"[{B}, {L}, 768] train drop {drop}",
                          "ms": _kernel_times(fn, iters)}), flush=True)


def _probes(rand, attn, iters, B=512, L=256):
    """Sub-kernel device times of every probe of the attention-block bench
    on the bench's descriptors and on all-open ones."""
    import numpy as np

    from unimm_torch.ops import block_probe as bp
    from unimm_torch.tools.bench_attn import make_desc

    x = rand(B, L, 768)
    dev = x.device
    descs = {"bench": make_desc(np.random.default_rng(0), B, L, dev),
             "open": torch.tensor([0, L, 0], dtype=torch.int32,
                                  device=dev).repeat(B, 1)}
    padded = bp.pad_heads_128(attn)
    for dname, desc in descs.items():
        runs = {f"probe_block {m}": (lambda m=m: bp.probe_block(
            x, desc, attn, num_heads=12, softmax_mode=m))
            for m in bp.SOFTMAX_MODES}
        runs.update({f"layout_probe_block {lay}": (
            lambda lay=lay: bp.layout_probe_block(
                x, desc, padded if lay == "pad128" else attn, num_heads=12,
                layout=lay)) for lay in bp.LAYOUTS})
        for name, fn in runs.items():
            wrapper, kind = name.split()
            print(json.dumps({"wrapper": wrapper,
                              "shape": f"{kind} [{B}, {L}, 768] {dname}",
                              "ms": _kernel_times(fn, iters)}), flush=True)


if __name__ == "__main__":
    main()
