"""The decoder's grouped expert GEMM (``ops/moe.py`` ->
``csrc/moe_gemm.cu``: every MLP's gate / up product with its SwiGLU
epilogue and its down product, routed, shared and dense) as a share of
its roofline (%): the operations and bytes of the real tokens of the
traced slice's dispatches (``counts/deepseek_v3.moe_gemm``), over the
device time of the launches named in ``moe_gemm_roofline.json``."""

from benchmark.harness.readers import kernel_time, names_beside, roofline_pct


def read(ctx):
    sec, launches = kernel_time(ctx, names_beside(__file__))
    w = ctx["slice_work"]
    if not launches or not w or not w.get("moe_gemm_flops"):
        return None
    return roofline_pct(w["moe_gemm_flops"], w["moe_gemm_bytes"], sec)
