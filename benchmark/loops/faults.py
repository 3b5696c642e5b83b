"""Faults planted under a cell's timed path, each a ``Program`` of its
loop: the benchmark's own tests (and ``calibrate --fault``) run a cell on
them and see ``correct`` come out false."""

import numpy as np
import torch

from benchmark.loops import eval_slates, train_steps


class AnswerAltered(eval_slates.Program):
    """Each slate's first answer's score altered where it is produced."""

    def dispatch(self, batch):
        fin = super().dispatch(batch)
        O = batch["tokens"].shape[2]

        def altered():
            s = {k: np.array(v, copy=True) for k, v in fin().items()}
            for k in s:
                s[k][::O] = (1.0 - s[k][::O] if k == "nsp_prob"
                             else s[k][::O] + 0.5)
            return s
        return altered


class HalfLeftOut(eval_slates.Program):
    """Only the first half of a dispatch's dialogs scored; the rest take
    the scores of the first half."""

    def dispatch(self, batch):
        B = batch["tokens"].shape[0]
        fin = super().dispatch({k: v[:B // 2] for k, v in batch.items()})

        def whole():
            return {k: np.concatenate([v, v]) for k, v in fin().items()}
        return whole


class Unchanged(train_steps.Program):
    """A step that returns its state unchanged."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.opt.step = lambda *a, **k: True


class HalfBatch(train_steps.Program):
    """Half of each batch left out, the mean taken over the rest."""

    def step(self, batch, spans):
        B = batch["tokens"].shape[0]
        return super().step({k: v[:B // 2] for k, v in batch.items()}, spans)


class NoExchange(train_steps.Program):
    """The exchange between chips left out: each rank updates with its
    own rows' gradient, never summed over the world."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        opt = self.opt

        @torch.no_grad()
        def step(grads=None):
            opt._update(opt._grads(grads))
            return True
        opt.step = step


BY_NAME = {c.__name__: c for c in (AnswerAltered, HalfLeftOut, Unchanged,
                                    HalfBatch, NoExchange)}
