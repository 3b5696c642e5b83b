"""Device ms a dialog under the program's ``op.moe`` ranges (the router,
``op.moe.route``, included: the expert sort, the grouped expert GEMM's
launches and the combine) over the traced slice. Read as
``moe_ms_per_dialog.<split>``, one metric for each end-to-end metric it
moves."""

from benchmark.harness.program import _device_ms


def read(ctx):
    return _device_ms(ctx, ["op.moe", "op.moe.route"], "dialogs")
