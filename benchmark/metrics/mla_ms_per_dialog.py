"""Device ms a dialog under the program's latent-attention ranges,
``op.mla_prefill`` (the expanded form over the contexts) and
``op.mla_answer`` (the absorbed form over the answer rows), projections
included, over the traced slice. Read as ``mla_ms_per_dialog.<split>``,
one metric for each end-to-end metric it moves."""

from benchmark.harness.program import _device_ms


def read(ctx):
    return _device_ms(ctx, ["op.mla_prefill", "op.mla_answer"], "dialogs")
