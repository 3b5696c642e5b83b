"""The largest routed expert's rows against an even share (%): the number
of routed experts times the program's counter ``moe.rows_max`` (the
largest expert's rows of each MoE launch, summed over layers and passes)
over ``moe.rows_routed`` (tokens x k, summed the same way), from the
recorder over the untraced rest of the window; 100 is an even load. Read
as ``moe_peak_load.<split>``, one metric for each end-to-end metric it
moves."""

from benchmark.harness.program import _host


def read(ctx):
    h = _host(ctx)
    if not h:
        return None
    c = h["counts"]
    if not c.get("moe.rows_routed") or "moe.rows_max" not in c:
        return None
    return (100.0 * ctx["cfg"]["n_routed_experts"] * c["moe.rows_max"]
            / c["moe.rows_routed"])
