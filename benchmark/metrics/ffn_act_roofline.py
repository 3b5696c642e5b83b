"""K2's first FFN product with its bias and GELU (``ops/ffn_block.py`` ->
``csrc/ffn_block.cu``, the ``ActEpi`` epilogue of the GEMM core), as a
share of its roofline (%): operations and bytes of the real tokens the
text-side FFNs took in the traced slice, over the device time of the
launches named in ``ffn_act_roofline.json``."""

from benchmark.counts import vilbert as counts
from benchmark.harness.readers import kernel_time, names_beside, roofline_pct


def read(ctx):
    sec, launches = kernel_time(ctx, names_beside(__file__))
    w = ctx["slice_work"]
    if not launches or not w:
        return None
    flops, nbytes = counts.ffn_act(ctx["cfg"], w["ffn_tokens"], launches)
    return roofline_pct(flops, nbytes, sec)
