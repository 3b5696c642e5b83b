"""Device busy ms per training step over the traced slice; in a world of
several cards, the mean over the cards. Read as
``device_ms_per_step.<split>``, one metric for each end-to-end metric it
moves."""

from benchmark.harness.readers import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx)
