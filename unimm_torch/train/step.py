"""The training step: forward, the three losses, backward and the grouped
AdamW update.

The port of the JAX package's ``train/step.py`` (the reference train
iteration, train.py:445-463, without its GradScaler: bf16 needs no loss
scaling). PyTorch runs eagerly, so there is no jit: ``make_train_step``
returns a function that takes one step on a state dict and updates the
model and the optimizer in place (the JAX step donates its state).

In a world of several processes (``parallel/dist.py``) each dp index
holds its share of the rows of the global batch; the ranks of one mp group
hold the same rows (and one model, sharded over them). The JAX package
computes each loss once over the global batch, so its denominators (the
label-token count, the NSP class counts, the masked-region count) are the
global batch's: the step all-reduces the local counts over the dp group
first and passes them through the losses' overrides (``world_norms``), so
each rank's loss is its local sum over the global denominator; the
optimizer sums the gradients over the dp group (``train.optim``), and the
logged loss parts are summed over it too (over the world, every row would
count once an mp rank). Each dp index draws its own dropout masks (its
index enters the seed, ``step_seed``), as JAX draws one mask over the
global batch and offsets its kernels' seed by the dp axis index only: the
mp peers of a dp index draw the same masks, and a world of one dp index
draws the one-process stream.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from unimm_torch.config import VilbertConfig
from unimm_torch.models import unimm, vilbert
from unimm_torch.ops import losses as L
from unimm_torch.parallel import dist
from unimm_torch.utils import trace


def step_seed(seed: int, step: int, rank=None) -> int:
    """The dropout seed of step ``step`` of a run seeded with ``seed``:
    one stream per (seed, step), as ``jax.random.fold_in(rng, step)``; a
    ``rank`` (the dp index of a world of several) enters the seed too, so
    no two dp indices share a mask (None: the one-process stream)."""
    key = [seed, step] if rank is None else [seed, step, rank]
    return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])


def world_rank():
    """This process's dp index for ``step_seed``: None where the dp axis
    has one index (no world, or every rank in one mp group)."""
    return dist.dp_rank() if dist.dp_size() > 1 else None


def world_norms(batch: dict) -> dict:
    """``batch`` with the loss denominators of the world's whole batch
    (``lm_norm``: tokens with lm_weight != 0; ``img_norm``: the sequences'
    regions with image_label 1, compact image arrays expanded first;
    ``nsp_norm_counts``: the NSP label counts; those whose keys the batch
    holds), summed over the dp group in one all-reduce. A batch that
    carries them already (length-bucketed morsels, whose group normalisers
    are synced across the ranks) and a dp axis of one index are returned
    as they are."""
    if dist.dp_size() == 1 or "lm_norm" in batch:
        return batch
    batch = unimm.expand_images(batch)     # image_label a sequence
    counts = {"lm_norm": (batch["lm_weight"] != 0).sum()[None]}
    if "image_label" in batch:
        counts["img_norm"] = (batch["image_label"] == 1).sum()[None]
    if "next_sentence_label" in batch:
        nsl = batch["next_sentence_label"]
        counts["nsp_norm_counts"] = torch.stack([(nsl == 0).sum(),
                                                 (nsl == 1).sum()])
    flat = torch.cat(list(counts.values())).float()
    dist.allreduce_sum_([flat], over=dist.DP)
    out = dict(batch)
    for (k, v), x in zip(counts.items(),
                         flat.split([v.numel() for v in counts.values()])):
        out[k] = x if k == "nsp_norm_counts" else x[0]
    return out


def init_state(model: torch.nn.Module, opt, seed: int = 0) -> Dict[str, Any]:
    """The state a step takes: the fp32 master model, its optimizer (from
    ``train.optim``), the step count and the run's dropout seed."""
    return {"model": model, "opt": opt, "step": 0, "seed": seed}


def make_train_step(cfg: VilbertConfig, *, lm_coeff=1.0, nsp_coeff=1.0,
                    img_coeff=1.0, dtype=torch.bfloat16):
    """Returns ``train_step(state, batch, nsp_weight=None) -> (state,
    metrics)``: one forward over ``batch`` (a descriptor batch of tensors
    on the model's device, see ``unimm.forward_train``) in ``dtype``, the
    backward into the parameters' ``.grad``, and one optimizer call. The
    metrics are device scalars: loss, lm_loss, nsp_loss, img_loss and
    label_budget_overflow, the sequences whose label count exceeds
    ``cfg.max_train_label_positions`` (their tail labels are dropped on the
    gathered path). In a world of several processes the loss parts and
    the overflow count are the world's (summed over the dp group)."""

    def train_step(state, batch, nsp_weight=None):
        model = state["model"]
        rng = vilbert.DropoutRng(step_seed(state["seed"], state["step"],
                                           world_rank()),
                                 batch["tokens"].device)
        with trace.span("train.world_norms"):
            normed = world_norms(batch)
        with trace.span("train.forward"):
            parts = unimm.forward_train(model, cfg, normed, rng=rng,
                                        nsp_weight=nsp_weight, dtype=dtype)
            loss = L.combine_losses(parts["lm"], parts["img"], parts["nsp"],
                                    lm_coeff, nsp_coeff, img_coeff)
        with trace.span("train.backward"):
            for p in model.parameters():
                p.grad = None
            loss.backward()
        with trace.span("train.optim"):
            state["opt"].step()
        state["step"] += 1
        with trace.span("train.metrics"):
            n_lab = (batch["mlm_labels"] != -1).sum(-1)
            metrics = {"loss": loss.detach(), "lm_loss": parts["lm"].detach(),
                       "nsp_loss": parts["nsp"].detach(),
                       "img_loss": parts["img"].detach(),
                       "label_budget_overflow": (
                           n_lab > cfg.max_train_label_positions).sum()}
            return state, world_metrics(metrics)

    return train_step


def world_metrics(metrics: dict) -> dict:
    """Device scalars summed over the dp group (one all-reduce); as they
    are on a dp axis of one index."""
    if dist.dp_size() == 1:
        return metrics
    keys = sorted(metrics)
    v = torch.cat([metrics[k].double().reshape(1) for k in keys])
    dist.allreduce_sum_([v], over=dist.DP)
    return {k: x.reshape(metrics[k].shape).to(metrics[k].dtype)
            for k, x in zip(keys, v)}


def make_train_step_with_fallback(cfg: VilbertConfig, *,
                                  policy: str = "dense", **kw):
    """``make_train_step`` that never drops labels silently on the
    gathered MLM path (the reference always materialises full logits, so
    every label counts). Returns ``step(state, batch, nsp_weight=None,
    host_mlm_labels=None)``; ``host_mlm_labels`` is the host [N, L] label
    array (read from the batch when omitted).

    policy:
      'dense' - a batch in which a sequence carries more than
                cfg.max_train_label_positions labels takes a step with
                mlm_loss_impl='dense' (the exact full-logits path);
      'error' - raise ValueError instead;
      'allow' - keep the gathered step (the metric still counts them).

    In a world of several processes the ranks vote: any rank's overflow
    sends every rank down the same branch.

    The step is the root span ``train.step``, its id the step index.
    """
    if policy not in ("dense", "error", "allow"):
        raise ValueError(f"policy {policy!r}")
    gathered = make_train_step(cfg, **kw)
    if cfg.mlm_loss_impl != "gathered" or policy == "allow":
        def plain(state, batch, nsp_weight=None, host_mlm_labels=None):
            with trace.span("train.step", id=state["step"]):
                return gathered(state, batch, nsp_weight)
        return plain
    dense = make_train_step(dataclasses.replace(cfg, mlm_loss_impl="dense"),
                            **kw)

    def step(state, batch, nsp_weight=None, host_mlm_labels=None):
        with trace.span("train.step", id=state["step"]):
            with trace.span("train.vote"):
                labels = (host_mlm_labels if host_mlm_labels is not None
                          else batch["mlm_labels"].cpu().numpy())
                n = (np.asarray(labels) != -1).sum(axis=-1)
                over = n.max(initial=0) > cfg.max_train_label_positions
                over = any(dist.allgather_np(np.asarray([over])))
            if over:
                if policy == "error":
                    raise ValueError(
                        "gathered-MLM label budget overflow: a sequence "
                        "carries more than max_train_label_positions="
                        f"{cfg.max_train_label_positions} labels and its "
                        "tail would be dropped; raise the budget or use the "
                        "'dense' policy")
                return dense(state, batch, nsp_weight)
            return gathered(state, batch, nsp_weight)

    return step
