"""Generative ranking by token-averaged log-likelihood (the reference's
val_avg_lm.py:120-148: nll.sum / token count); the port's counterpart of
the JAX package's ``cli/val_avg_lm.py``."""

import sys

from unimm_torch.cli import val_lm


def main(argv=None, device=None, backend=None):
    return val_lm.main(argv, mode="ll_mean", device=device, backend=backend)


if __name__ == "__main__":
    main(sys.argv[1:])
