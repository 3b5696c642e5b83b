"""B5's attention backward (``csrc/seq_attn_bwd.cuh``: the dq and the dk /
dv launches) as a share of its roofline (%): four products per head over
the open pairs and the bytes of q, k, v, o, dO in and dq, dk, dv out at the
real extents, of the steps in the traced slice, over the device time of
the launches named in ``attn_bwd_roofline.json``."""

from benchmark.harness.readers import kernel_time, names_beside, roofline_pct


def read(ctx):
    sec, launches = kernel_time(ctx, names_beside(__file__))
    w = ctx["slice_work"]
    if not launches or not w:
        return None
    return roofline_pct(w["attn_bwd_flops"], w["attn_bwd_bytes"], sec)
