"""Counted model operations of the completed work (training: forward and
backward, three times the forward, over real extents) over wall time, as a
share of the bf16 peak of the cards used (%); the untraced part of the
window. Read as ``mfu.<split>``, one metric for each end-to-end metric it
moves."""

from benchmark.harness.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
