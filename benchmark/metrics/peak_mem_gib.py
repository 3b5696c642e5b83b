"""Peak device memory the process allocated up to the window's close
(GiB, ``torch.cuda.max_memory_allocated``; the fullest card of a world):
the weights, the optimizer state and the step's activations. Read as
``peak_mem_gib.<split>``, one metric for each end-to-end metric it
moves."""


def read(ctx):
    peak = ctx["memory"]["peak_bytes"]
    return peak / 2 ** 30 if peak else None
