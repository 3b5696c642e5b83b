"""Device busy ms (the union of kernel and copy intervals) per dialog
scored, over the traced slice."""

from benchmark.harness.readers import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx)
