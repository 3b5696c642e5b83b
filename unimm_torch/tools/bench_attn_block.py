"""Isolated A/B benchmark of the whole attention sub-block, the FFN block
and the attention block's probes.

    python3 -m unimm_torch.tools.bench_attn_block [variant ...] [--iters N]
        [--shape B,L,HID] [--device cuda|cpu]

The port of scripts/bench_attn_block.py, at its shape [B=512, L=256,
HID=768] bf16 by default, with its variant names, so that the two tables
line up:

* ``xla_block``: plain PyTorch, ``vilbert.self_attention_block`` over the
  [B, 1, L, L] bias of ``masks.text_self_bias``;
* ``fused_block`` / ``fused_block_bb2``: ``ops/attention_block.py`` with
  block_b 1 and 2;
* ``xla_ffn``: plain PyTorch, ``vilbert.ffn_block`` (gelu); ``fused_ffn``:
  ``ops/ffn_block.py``; ``fused_ffn_bb2``: the same call. On the TPU
  block_b is the number of sequences per Pallas grid step; the FFN kernel
  here tiles the flat rows by 128 and has no such parameter, so the row
  is kept only for the table to line up with the JAX one;
* ``probe_nosoftmax`` / ``probe_projonly`` / ``probe_noshift`` /
  ``probe_softmax``: ``ops/block_probe.probe_block`` with softmax_mode
  ``none`` / ``skip`` / ``noshift`` / ``full``;
* ``probe_transposed`` / ``probe_wo_acc`` / ``probe_pad128``:
  ``ops/block_probe.layout_probe_block``; pad128's weights are padded once,
  when the variant is built, outside the timed loop (in JAX the padding of
  closure constants folds away inside ``jit``).

Protocol (the script's): a measurement is ITERS calls, each fed the
previous call's output as its x; there are 3 input sets (seeds 0-2:
normal x; descriptors of mode 0 or 1, ctx_end 60-199 and ans_len 2-8,
scaled into L below 256), one warm-up measurement on each, then 6
measurements cycling through the sets. It prints each variant's median ms
per call with the fastest and slowest measurement, then one JSON line.
``probe_noshift`` gives NaN on the rows past a sequence's extent (every
input set has them), as its TPU kernel does; fed back as the next x, the
NaNs fill the whole tensor after one call, which changes no time on the
card. Weights: one seeded layer, Linear weights normal(0, 0.02) from a
``torch.Generator`` seeded 0, biases 0, LayerNorm (1, 0), cast to bf16
(the script's ``_init_attention``, ``_init_linear``, ``_init_ln``). On the
card a measurement is timed with CUDA events; ``--device cpu`` runs the
plain twins as a smoke test of the tool, timed by the host clock, which
says nothing of a device.
"""

from __future__ import annotations

import numpy as np
import torch

from unimm_torch.models import vilbert
from unimm_torch.ops import masks
from unimm_torch.ops.attention_block import HEAD_DIM, attention_block
from unimm_torch.ops.block_probe import (layout_probe_block, pad_heads_128,
                                         probe_block)
from unimm_torch.ops.ffn_block import ffn_block
from unimm_torch.tools.bench_attn import (ITERS, SETS, bench, cli,
                                          make_desc, normal)

SHAPE = (512, 256, 768)
PROBES = {"probe_nosoftmax": "none", "probe_projonly": "skip",
          "probe_noshift": "noshift", "probe_softmax": "full"}
LAYOUT_PROBES = {"probe_transposed": "transposed", "probe_wo_acc": "wo_acc",
                 "probe_pad128": "pad128"}
VARIANTS = ("xla_block", "fused_block", "xla_ffn", "fused_ffn",
            "fused_block_bb2", "fused_ffn_bb2", *PROBES, *LAYOUT_PROBES)


def make_inputs(seed, shape, dev):
    """(x, desc) on ``dev``: bf16 [B, L, HID] from a normal draw and the
    int32 [B, 3] descriptors."""
    B, L, _ = shape
    rng = np.random.default_rng(seed)
    x = normal(rng, shape, dev)
    return x, make_desc(rng, B, L, dev)


@torch.no_grad()
def make_layer(hid, dev, seed=0, std=0.02):
    """One bf16 encoder layer (attention and FFN, intermediate 4 hid):
    Linear weights normal(0, std), biases 0, LayerNorm (1, 0)."""
    with torch.device(dev):
        layer = vilbert._layer(hid, 4 * hid)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for m in layer.modules():
        if isinstance(m, torch.nn.Linear):
            m.weight.normal_(0.0, std, generator=gen)
            m.bias.zero_()
        elif isinstance(m, torch.nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return layer.to(torch.bfloat16).requires_grad_(False)


def variants(layer, num_heads):
    """{name: fn(x, desc)} over ``layer``'s weights, every name of
    VARIANTS."""
    attn, inter, out = layer.attention, layer.intermediate, layer.output
    padded = pad_heads_128(attn)

    def xla_block(x, desc):
        bias = masks.text_self_bias(desc[:, 0], desc[:, 1], desc[:, 2],
                                    x.shape[1])
        return vilbert.self_attention_block(attn, x, bias,
                                            num_heads=num_heads)

    def fused_block(block_b):
        return lambda x, desc: attention_block(
            x, desc, attn, num_heads=num_heads, block_b=block_b)

    def fused_ffn(x, desc):
        return ffn_block(x, inter, out, act="gelu")

    def probe(mode):
        return lambda x, desc: probe_block(x, desc, attn, num_heads=num_heads,
                                           softmax_mode=mode)

    def layout_probe(layout):
        p = padded if layout == "pad128" else attn
        return lambda x, desc: layout_probe_block(
            x, desc, p, num_heads=num_heads, layout=layout)

    fns = {"xla_block": xla_block, "fused_block": fused_block(1),
           "xla_ffn": lambda x, desc: vilbert.ffn_block(inter, out, x,
                                                        act="gelu"),
           "fused_ffn": fused_ffn, "fused_block_bb2": fused_block(2),
           "fused_ffn_bb2": fused_ffn}
    fns.update({n: probe(m) for n, m in PROBES.items()})
    fns.update({n: layout_probe(m) for n, m in LAYOUT_PROBES.items()})
    return fns


def run(names, *, iters=ITERS, shape=SHAPE, dev=None):
    """{variant: (median, min, max) ms per call} for ``names``."""
    dev = dev or torch.device("cuda", 0)
    fns = variants(make_layer(shape[2], dev), shape[2] // HEAD_DIM)
    sets = [make_inputs(s, shape, dev) for s in range(SETS)]
    with torch.no_grad():
        return {n: bench(fns[n], sets, iters, dev) for n in names}


def main(argv=None):
    return cli(argv, key="bench_attn_block", variants=VARIANTS, run_fn=run,
               shape=SHAPE, shape_help="B,L,HID")


if __name__ == "__main__":
    main()
