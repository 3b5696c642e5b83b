"""Mean host ms inside one training-step call
(``train/step.make_train_step_with_fallback``'s step), untraced part of
the window; rank 0's in a world of several cards. Read as
``step_host_ms.<split>``, one metric for each end-to-end metric it
moves."""

from benchmark.harness.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "step")
