"""Share of the traced slice in which the device ran nothing (%); in a
world of several cards, the mean over the cards. Read as
``idle_share.<split>``, one metric for each end-to-end metric it moves."""

from benchmark.harness.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
