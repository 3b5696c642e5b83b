"""Device-time breakdowns from ``torch.profiler`` (CUPTI) on a CUDA card.

    python3 -m unimm_torch.tools.kernel_profile [--iters 5]
    python3 -m unimm_torch.tools.kernel_profile --main-path

Default: for each kernel wrapper at main-path shapes, a JSON line with the
mean device time per call of every CUDA kernel the call launched (the
sub-kernels of one wrapper seen one by one). ``--main-path``: one warm
``evaluate_split`` over 2 coalesced pinned batches at the default config,
with its wall time, the summed device time of all kernels, the device idle
share (1 - device / wall; one stream, so kernels do not overlap), the
kernels that took the most device time, and the PyTorch operators whose
kernels took the most (inclusive). Both end with the card's name and
power limit.
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


def main_path(dev):
    import time

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from unimm_torch import workload
    from unimm_torch.config import VilbertConfig
    from unimm_torch.eval.evaluator import evaluate_split
    from unimm_torch.models import vilbert

    cfg = VilbertConfig()
    model = vilbert.init_model(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    batches = [workload.with_ranking_targets(
        workload.make_val_batch(rng, cfg, 2, 10, 100), rng) for _ in range(2)]

    def run():
        evaluate_split(model, cfg, batches, mode="ll_sum", progress_every=0,
                       device=dev)
        torch.cuda.synchronize()

    run()
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
    print(json.dumps({"main_path_wall_ms": wall * 1e3,
                      "device_busy_ms": busy,
                      "device_idle_share": 1 - busy / (wall * 1e3),
                      "top_kernels": [{"ms": r[0], "launches": r[1],
                                       "name": r[2]} for r in rows[:25]],
                      "top_torch_ops": [{"ms": r[0], "calls": r[1],
                                         "op": r[2]} for r in ops[:25]]}),
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--main-path", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_profile: needs a CUDA device")
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    if args.main_path:
        main_path(torch.device("cuda", 0))
        print(card)
        return
    from unimm_torch.models import vilbert
    from unimm_torch.ops.answer_block import answer_block
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
    print(card)


if __name__ == "__main__":
    main()
