"""Times of kernel wrappers on a CUDA card, for A/Bs of
two trees: the attention backward, B6's wrapper (``text_attention_bwd``)
at [240, 12, 256, 64] and B5's (``attention_block_train_bwd``) at [240,
256, 768], attention dropout 0.1, both on the training batch's
descriptors; or the block kernels' forward (``--forward``): B4
(``attention_block``) at [256, 192 / 256, 768] on the flat path's dis
descriptors and B5's forward (``attention_block_train_fwd``) at [240, 256,
768] on the training descriptors, attention dropout 0.1 and 0; or the
GEMM-core blocks (``--gemm``): K2 (``ffn_block``) at [200, 256, 768],
intermediate 3072, and B8 (``co_text_block``) at [256, 224, 768] x [256,
37, 1024], weights at std 0.02; or the main path's answer block and head
(``--head``): K1 (``answer_block``) at chip_smoke.py phase 3's four
shapes and on the prefix scorer's biases at G 40, Lcb 192 / RB 64 and Lcb
256 / RB 256, then Lcb 96 / RB 32, Lcb 192 / RB 96 and the W layout's Lcb
256 / RB 160 (another tree that refuses one records the refusal),
weights at std 0.05, and K3 (``xent_head``) at M 25600 and 1000, V
30522; or the training MLM cross-entropy forward and backward
(``--xent``: ``losses.online_softmax_xent_vjp`` under autograd, the
kernels of ``ops/xent_train.py`` where the tree routes to them) at M 38400
and 9600; or B 240 training steps.

    python3 -m unimm_torch.tools.bench_bwd [--label NAME] [--csrc DIR
        --build DIR] [--forward | --gemm | --head | --xent | --train-step
        {pallas_block,pallas} [--remat] [--steps 8]]

Default, ``--forward``, ``--gemm`` and ``--head``: one JSON line with each
wrapper's device time per call (CUDA events, median of 5 runs of 20
calls), its host time per call (the loop that enqueues 20 calls, the card
busy behind it), the mean device time of every kernel it launched (``torch.profiler``),
each output's largest error against its plain twin relative to the twin's
largest entry, and whether two runs give the same bits. ``--head`` gives
each launch of one call in launch order with its mean device time and the
largest absolute error against the twin (K1 with the chunk table built
once, as the scorer builds it; ``table_ms`` its build). ``--gemm`` adds
each launch of one call in launch order with its mean device time and,
for a product, its TFLOP/s (the product's 2 M N K over that time; B8's
attention launch counts its two score and value products), and the
largest absolute error against the twin. ``--train-step``:
ms per step of ``--steps`` B 240 training steps with the fused AdamW after
2 warm-up steps, as chip_smoke.py phase 9 times them ("pallas" at
attention dropout 0; ``--remat`` with encoder remat), and the peak of
allocated device memory over the steps. ``--csrc`` builds
and loads the kernels of another csrc directory into ``--build`` (a copy
with a design change, say). To compare two commits on one card, run this
file from each tree's root with ``PYTHONPATH`` set to that root, in turns;
it uses only entry points both have. Ends with the card's name and power
limit.
"""

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch


def train_desc(B, L, g):
    """workload.make_train_batch's descriptors: mode 0 or 1, ctx_end
    60-199, ans_len 2-8 under gen."""
    dev = g.device
    mode = torch.randint(0, 2, (B,), generator=g, device=dev)
    ce = torch.randint(60, 200, (B,), generator=g, device=dev)
    al = torch.randint(2, 9, (B,), generator=g, device=dev)
    return torch.stack([mode, ce, al * mode], -1).to(torch.int32)


def _device_ms(fn, iters=20, reps=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e) / iters)
    return sorted(out)[len(out) // 2]


def _host_us(fn, n=20):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def sub_kernels(fn, iters=5):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0)
        if t:
            out[ev.key[:90]] = round(t / iters / 1e3, 4)   # ms per call
    return out


def dis_desc(B, L, g):
    """The flat path's dis descriptors of bucket L: real lengths in
    (L - 32, L]."""
    n = torch.randint(max(1, L - 31), L + 1, (B,), generator=g,
                      device=g.device)
    z = torch.zeros_like(n)
    return torch.stack([z, n, z], -1).to(torch.int32)


def _rel(got, want):
    """each output's max |got - want| / max |want|"""
    return [float((a.float() - b.float()).abs().max()
                  / b.float().abs().max()) for a, b in zip(got, want)]


def _wide_attention(dev, g):
    """A bf16 attention module with every weight at std 0.05 (the card
    checks' WIDE_STD): O(1) scores."""
    from unimm_torch.models import vilbert
    with torch.device(dev):
        attn = vilbert._attention(768)
    with torch.no_grad():
        for p in attn.parameters():
            p.normal_(0.0, 0.05, generator=g)
    return attn.to(torch.bfloat16)


def _time_runs(runs):
    """{name: (kernel call, plain call)} -> each kernel's times, errors
    against the plain twin and whether two runs give the same bits."""
    out = {}
    for name, (kern, plain) in runs.items():
        same = all(torch.equal(a, b) for a, b in zip(kern(), kern()))
        out[name] = dict(ms=_device_ms(kern), host_us=_host_us(kern),
                         rel_errs=_rel(kern(), plain()), same_bits=same,
                         kernels_ms=sub_kernels(kern))
    return out


def backward_times(dev, B=240, L=256):
    from unimm_torch.ops import attention_block_train as abt
    from unimm_torch.ops import text_attention as ta
    from unimm_torch.ops.answer_block import _weights

    g = torch.Generator(device=dev).manual_seed(0)
    # the head-split views of [B, L, 768] tensors, as the model gives them
    q, k, v, do = (torch.randn(B, L, 768, generator=g, device=dev).bfloat16()
                   .view(B, L, 12, 64).transpose(1, 2) for _ in range(4))
    desc = train_desc(B, L, g)
    ws = _weights(_wide_attention(dev, g))
    x = torch.randn(B, L, 768, generator=g, device=dev).bfloat16()
    dctx = torch.randn(B, L, 768, generator=g, device=dev).bfloat16()
    kw = dict(num_heads=12, attn_drop=0.1)
    return _time_runs({
        "text_attention_bwd": (
            lambda: ta.text_attention_bwd(q, k, v, desc, do),
            lambda: ta.text_attention_bwd_plain(q, k, v, desc, do)),
        "attention_block_train_bwd": (
            lambda: abt.attention_block_train_bwd(x, dctx, desc, 1234,
                                                  *ws[:6], **kw),
            lambda: abt.attention_block_train_bwd_plain(x, dctx, desc, 1234,
                                                        *ws[:6], **kw))})


def forward_times(dev):
    from unimm_torch.ops import attention_block as ab
    from unimm_torch.ops import attention_block_train as abt
    from unimm_torch.ops.answer_block import _weights

    g = torch.Generator(device=dev).manual_seed(0)
    attn = _wide_attention(dev, g)
    ws = _weights(attn)
    runs = {}
    for L in (192, 256):
        x = torch.randn(256, L, 768, generator=g, device=dev).bfloat16()
        desc = dis_desc(256, L, g)
        runs[f"attention_block [256, {L}, 768] dis"] = (
            lambda x=x, d=desc: (ab.attention_block(x, d, attn,
                                                    num_heads=12),),
            lambda x=x, d=desc: (ab.attention_block_plain(x, d, attn,
                                                          num_heads=12),))
    B, L = 240, 256
    x = torch.randn(B, L, 768, generator=g, device=dev).bfloat16()
    desc = train_desc(B, L, g)
    m_o = (torch.rand(B, L, 768, generator=g, device=dev) >= 0.1).float()
    m_o /= 0.9
    for drop in (0.1, 0.0):
        kw = dict(num_heads=12, attn_drop=drop)
        runs[f"attention_block_train_fwd [{B}, {L}, 768] drop {drop}"] = (
            lambda kw=kw: abt.attention_block_train_fwd(x, desc, 1234, m_o,
                                                        *ws, **kw),
            lambda kw=kw: abt.attention_block_train_fwd_plain(
                x, desc, 1234, m_o, *ws, **kw))
    return _time_runs(runs)


def _launch_split(fn, iters=5, tries=3):
    """[(kernel name, mean device ms)] of each launch of one ``fn()`` call,
    in launch order, over ``iters`` profiled calls (profiled again, up to
    ``tries`` times, when the profiler's count of launches is not a
    multiple of ``iters``: it has lost some of a short call's)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        n = len(evs) // iters
        if n * iters == len(evs):
            break
    else:
        raise SystemExit(f"bench_bwd: {len(evs)} launches in {iters} calls")
    return [(evs[i].name[:90],
             sum(evs[i + c * n].time_range.elapsed_us()
                 for c in range(iters)) / iters / 1e3) for i in range(n)]


def gemm_times(dev):
    """K2 and B8 at the main path's shapes: times, launches with TFLOP/s,
    errors against the twins, bits across two runs."""
    from unimm_torch.config import VilbertConfig
    from unimm_torch.models import vilbert
    from unimm_torch.ops import co_text_block as co
    from unimm_torch.ops import ffn_block as fb

    g = torch.Generator(device=dev).manual_seed(0)

    def module(make):
        with torch.device(dev):
            m = make()
        with torch.no_grad():
            for p in m.parameters():
                p.normal_(0.0, 0.02, generator=g)
        return m.to(torch.bfloat16)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev).bfloat16()

    Hd, I, N, R = 768, 3072, 200, 256
    layer = module(lambda: vilbert._layer(Hd, I))
    x = rand(N, R, Hd)
    M = N * R
    conn = module(lambda: vilbert._connection(VilbertConfig()))
    B, L, Rg, Bi = 256, 224, 37, 1024
    t_x, v_x = rand(B, L, Hd), rand(B, Rg, Bi)
    im = (torch.rand(B, Rg, generator=g, device=dev) > 0.2).float()
    im[3] = 0.0
    Mc = B * L
    runs = {
        f"ffn_block [{N}, {R}, {Hd}] inter {I}": (
            lambda: fb.ffn_block(x, layer.intermediate, layer.output),
            lambda: fb.ffn_block_plain(x, layer.intermediate, layer.output),
            [2 * M * Hd * I, 2 * M * I * Hd]),
        f"co_text_block [{B}, {L}, {Hd}] x [{B}, {Rg}, {Bi}]": (
            lambda: co.co_text_block(t_x, v_x, im, conn, num_heads=8),
            lambda: co.co_text_block_plain(t_x, v_x, im, conn, num_heads=8),
            [2 * Mc * Hd * Bi, 2 * 2 * B * Rg * Bi * Bi, 4 * Mc * Rg * Bi,
             2 * Mc * Bi * Hd])}
    out = {}
    for name, (kern, plain, flops) in runs.items():
        got, want = kern(), plain()
        launches = []
        for i, (kname, ms) in enumerate(_launch_split(kern)):
            row = dict(kernel=kname, ms=ms)
            if i < len(flops):
                row["tflops"] = flops[i] / ms / 1e9
            launches.append(row)
        out[name] = dict(
            ms=_device_ms(kern), host_us=_host_us(kern),
            max_abs_err=float((got.float() - want.float()).abs().max()),
            rel_errs=_rel([got], [want]), same_bits=torch.equal(got, kern()),
            launches=launches)
    return out


def _scorer_biases(G, Lcb, RB, g, O=100):
    """The prefix scorer's biases (the rule of ``prefix.answer_biases``,
    written out here so that a parent tree without that function runs it
    too) for G slates of O options of ans_len 2-8 packed into RB-row
    blocks: (b_ctx [G, 1, Lcb], b_rr [G, PB, RB, RB], P)."""
    import numpy as np

    from unimm_torch.eval.prefix import pack_option_rows
    from unimm_torch.ops.masks import NEG_INF

    dev = g.device
    rng = np.random.default_rng(int(torch.randint(0, 2**31 - 1, (1,),
                                                  generator=g, device=dev)))
    lc = torch.from_numpy(rng.integers(2, Lcb + 1, G)).to(dev)
    A = rng.integers(2, 9, (G, O))
    starts, P = pack_option_rows(2 * A, RB)
    opt = np.full((G, P), O)
    rin = np.zeros((G, P), np.int64)
    for gi in range(G):
        for o in range(O):
            sl = slice(starts[gi, o], starts[gi, o] + 2 * A[gi, o])
            opt[gi, sl], rin[gi, sl] = o, np.arange(2 * A[gi, o])
    a_row = np.take_along_axis(np.concatenate([A, np.zeros((G, 1), int)],
                                              1), opt, 1)
    opt, rin, a_row = (torch.from_numpy(t).to(dev).reshape(G, P // RB, RB)
                       for t in (opt, rin, a_row))
    j = torch.arange(Lcb, device=dev)
    b_ctx = torch.where((j >= 1) & (j < lc[:, None]), 0.0, NEG_INF)
    first = (opt < O) & (rin < a_row)
    rq, ks = rin[..., :, None], rin[..., None, :]
    rr = ((opt[..., :, None] == opt[..., None, :]) & (opt[..., :, None] < O)
          & torch.where(first[..., :, None], ks <= rq,
                        ks < rq - a_row[..., :, None]))
    rr |= torch.eye(RB, dtype=torch.bool, device=dev)
    return (b_ctx.float()[:, None, :].contiguous(),
            torch.where(rr, 0.0, NEG_INF).float().contiguous(), P)


def _w_biases(G, Lcb, W, g, O=100):
    """The prefix scorer's W-layout biases (``prefix.w_layout_biases``) for
    G slates of O options of ans_len 1 .. W / 2: (b_ctx, b_rr, P = O W).
    A tree without the W layout gets the same biases rebuilt here from
    ``answer_block.block_rr_bias``, so that it can be timed too."""
    from unimm_torch.eval import prefix
    from unimm_torch.ops.answer_block import block_rr_bias, pick_o_blk
    from unimm_torch.ops.masks import NEG_INF

    dev = g.device
    A = torch.randint(1, W // 2 + 1, (G, O), generator=g, device=dev)
    lc = torch.randint(2, Lcb + 1, (G,), generator=g, device=dev)
    if hasattr(prefix, "w_layout_biases"):
        b_ctx, b_rr = prefix.w_layout_biases(lc, A, W, Lcb)
    else:
        j = torch.arange(Lcb, device=dev)
        b_ctx = torch.where((j >= 1) & (j < lc[:, None]), 0.0,
                            NEG_INF).float()[:, None, :]
        r = torch.arange(W, device=dev)
        rq, ks, A4 = r[:, None], r[None, :], A[..., None, None]
        rr = torch.where(rq < A4, ks <= rq, (ks < rq - A4) | (ks == rq))
        b_rr = block_rr_bias(rr, pick_o_blk(O, W))
    return b_ctx.contiguous(), b_rr.contiguous(), O * W


def head_times(dev, other_tree=False):
    """K1 at phase 3's four shapes (its random options, causal inside), on
    the scorer's biases at the main path's two and at the row blocks of
    16-row tails (RB 32 and 96, the W layout's Rw 160), and K3 at M 25600
    and 1000 (V 30522): times, each launch, errors against the twins, bits
    across two runs. Under ``other_tree`` (the kernels of ``--csrc``, or a
    package imported from another tree's root) a K1 that refuses a shape
    records the refusal (``refused``); this tree's K1 raises."""
    from unimm_torch.ops import answer_block as ab
    from unimm_torch.ops import xent_head as xh
    from unimm_torch.ops.masks import NEG_INF

    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev)
                * scale).bfloat16()

    runs, table_ms, refused = {}, {}, {}
    for Lcb, RB, G, P, real in ((192, 64, 40, 1280, False),
                                (256, 256, 40, 1280, False),
                                (224, 256, 4, 1280, False),
                                (96, 64, 4, 512, False),
                                (192, 64, 40, 0, True),
                                (256, 256, 40, 0, True),
                                (96, 32, 40, 0, True),
                                (192, 96, 40, 0, True),
                                (256, 160, 40, 0, "w16")):
        attn = _wide_attention(dev, g)
        if real == "w16":
            b_ctx, b_rr, P = _w_biases(G, Lcb, 16, g)
        elif real:
            b_ctx, b_rr, P = _scorer_biases(G, Lcb, RB, g)
        else:
            lc = torch.randint(2, Lcb + 1, (G,), generator=g, device=dev)
            j = torch.arange(Lcb, device=dev)
            b_ctx = torch.where((j >= 1) & (j < lc[:, None]), 0.0,
                                NEG_INF).float()[:, None, :].contiguous()
            opt = torch.cumsum(torch.rand(G, P // RB, RB, generator=g,
                                          device=dev) < 0.12, -1)
            r = torch.arange(RB, device=dev)
            b_rr = torch.where(((opt[..., :, None] == opt[..., None, :])
                                & (r[None, :] <= r[:, None]))
                               | torch.eye(RB, dtype=torch.bool, device=dev),
                               0.0, NEG_INF).float().contiguous()
        x, kc, vc = rand(G, P, 768), rand(G, Lcb, 768), rand(G, Lcb, 768)
        args = (x, kc, vc, b_ctx, b_rr, attn)
        # the chunk table, built once as the scorer does (a tree from
        # before it has none)
        name = (f"answer_block G={G} P={P} Lcb={Lcb} RB={RB}"
                + (" W-layout biases W=16" if real == "w16" else
                   " scorer biases" if real else ""))
        kw = {}
        try:
            if hasattr(ab, "answer_chunk_table"):
                kw["table"] = ab.answer_chunk_table(b_ctx, b_rr)
                table_ms[name] = _device_ms(
                    lambda b=(b_ctx, b_rr): ab.answer_chunk_table(*b))
            ab.answer_block(*args, num_heads=12, **kw)
        except ValueError as e:     # a tree whose K1 refuses the shape
            if not other_tree:
                raise
            refused[name] = str(e)
            continue
        runs[name] = (
            lambda a=args, kw=kw: ab.answer_block(*a, num_heads=12, **kw),
            lambda a=args: ab.answer_block_plain(*a, num_heads=12))
    V = 30522
    w, b = rand(V, 768, scale=0.02), torch.randn(V, generator=g, device=dev)
    for M in (25600, 1000):
        h = rand(M, 768)
        lab = torch.randint(0, V, (M,), generator=g, device=dev)
        lab[torch.rand(M, generator=g, device=dev) < 0.5] = -1
        runs[f"xent_head M={M} V={V}"] = (
            lambda h=h, lab=lab: xh.xent_head(h, w, b * 0.1, lab),
            lambda h=h, lab=lab: xh.xent_head_plain(h, w, b * 0.1, lab))
    out = {}
    for name, (kern, plain) in runs.items():
        got, want = kern(), plain()
        out[name] = dict(
            ms=_device_ms(kern), host_us=_host_us(kern),
            max_abs_err=float((got.float() - want.float()).abs().max()),
            rel_errs=_rel([got], [want]), same_bits=torch.equal(got, kern()),
            launches=[dict(kernel=k, ms=ms)
                      for k, ms in _launch_split(kern)])
        if name in table_ms:
            out[name]["table_ms"] = table_ms[name]
    for name, msg in refused.items():
        out[name] = {"refused": msg}
    return out


def xent_times(dev):
    """The training MLM cross-entropy as the step calls it
    (``losses.online_softmax_xent_vjp`` on bf16 rows, forward, then
    forward and backward under autograd) at the step's M 38400 and a dp
    rank's 9600, V 30522, a fifth of the rows labelled (the step's gathered
    slots are mostly padding): times, each kernel's device ms a forward
    and backward (``torch.profiler``; a kernel product's TFLOP/s over 2 M
    768 V: the parent's scan launches a varying count of kernels a call,
    so no launch split), the peak of allocated memory above the inputs,
    the largest errors against the fp32 scan (fp32 rows take the plain
    path), bits across two runs."""
    from unimm_torch.ops import losses

    g = torch.Generator(device=dev).manual_seed(0)
    V = 30522
    w = (torch.randn(V, 768, generator=g, device=dev) * 0.02).bfloat16()
    b = torch.randn(V, generator=g, device=dev) * 0.1
    out = {}
    for M in (38400, 9600):
        h = torch.randn(M, 768, generator=g, device=dev).bfloat16()
        lab = torch.randint(0, V, (M,), generator=g, device=dev)
        lab[torch.rand(M, generator=g, device=dev) < 0.8] = -1
        up = torch.rand(M, generator=g, device=dev)

        def fwd(h=h, lab=lab):
            return losses.online_softmax_xent_vjp(h, w, b, lab)

        def both(h=h, lab=lab, up=up):
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (h, w, b)]
                nll = losses.online_softmax_xent_vjp(*leaves, lab)
                return (nll, *torch.autograd.grad(nll, leaves, up))

        got = both()
        same = all(torch.equal(x, y) for x, y in zip(got, both()))
        want = both(h.float())
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        both()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        flops = 2 * M * 768 * V
        kernels = {}
        for kname, ms in sub_kernels(both).items():
            kernels[kname] = row = dict(ms=ms)
            if "xent_wg_kernel" in kname or "xt_wg_kernel" in kname:
                row["tflops"] = flops / ms / 1e9      # a whole product
        out[f"xent M={M} V={V}"] = dict(
            fwd_ms=_device_ms(fwd), ms=_device_ms(both),
            host_us=_host_us(both), peak_gib=peak, same_bits=same,
            rel_errs=dict(zip(("nll", "dh", "dw", "db"), _rel(got, want))),
            kernels=kernels)
    return out


def step_times(dev, impl, steps, remat=False):
    import numpy as np

    from unimm_torch import workload
    from unimm_torch.config import VilbertConfig
    from unimm_torch.models import vilbert
    from unimm_torch.train import optim
    from unimm_torch.train import step as tstep

    cfg = VilbertConfig(attention_impl=impl, remat=remat)
    if impl == "pallas":
        cfg = cfg.replace(attention_probs_dropout_prob=0.0)
    lang = optim.load_language_weights(Path("config/language_weights.json"))
    batches = [{k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for k, a in workload.make_train_batch(
                    np.random.default_rng(50 + i), cfg, 240).items()}
               for i in range(2)]
    model = vilbert.train_model(cfg, seed=0, device=dev)
    state = tstep.init_state(model, optim.make_fused_optimizer(
        model, optim.OptimConfig(warmup_steps=10, t_total=1000), lang),
        seed=0)
    step = tstep.make_train_step(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.enable_grad():
        for i in range(2):
            step(state, batches[i % 2])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            step(state, batches[i % 2])
        torch.cuda.synchronize()
    return dict(impl=impl, remat=remat, steps=steps,
                ms_per_step=(time.perf_counter() - t0) / steps * 1e3,
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--csrc", type=Path, default=None)
    ap.add_argument("--build", type=Path, default=None)
    ap.add_argument("--train-step", default=None,
                    choices=("pallas_block", "pallas"))
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--forward", action="store_true")
    ap.add_argument("--gemm", action="store_true")
    ap.add_argument("--head", action="store_true")
    ap.add_argument("--xent", action="store_true")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_bwd: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    from unimm_torch.ops import _build
    if args.csrc is not None:
        _build.CSRC = args.csrc.resolve()
        _build.BUILD_DIR = (args.build or args.csrc.parent / "build").resolve()
    _build.library()
    dev = torch.device("cuda", 0)
    if args.train_step:
        res = step_times(dev, args.train_step, args.steps, args.remat)
    elif args.forward:
        res = forward_times(dev)
    elif args.gemm:
        res = gemm_times(dev)
    elif args.xent:
        res = xent_times(dev)
    elif args.head:
        here = Path(__file__).resolve().parents[2]
        res = head_times(dev, other_tree=args.csrc is not None or Path(
            _build.__file__).resolve().parents[2] != here)
    else:
        res = backward_times(dev)
    print(json.dumps({"label": args.label, **res}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
