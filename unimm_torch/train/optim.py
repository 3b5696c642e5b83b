"""Optimizer and learning-rate schedule of the training step.

The port of the JAX package's ``train/optim.py`` (which replicates the
reference train.py:322-348 and utils/optim_utils.py:8-26 with optax):

* AdamW with eps 1e-6 added outside the square root and bias correction
  on, written out in optax's op order (moments as ``b * m + (1 - b) *
  g``, bias correction by division, then ``-lr * (direction + wd * p)``).
  This is not ``torch.optim.AdamW``, which decays the weights before the
  step and places eps differently. A bfloat16 first moment
  (``mu_dtype``) forms ``b1 * m`` in bfloat16, b1 rounded to it, as optax
  does with its weakly typed constant;
* two learning rates: parameters named in config/language_weights.json
  get ``lr``, the rest (vision stream, poolers, co-attention, image head)
  ``image_lr``; no weight decay for bias / LayerNorm parameters, 0.01
  otherwise (``checkpoint.group_label``);
* the warmup-linear-to-floor schedule;
* gradient accumulation with optax.MultiSteps semantics
  (``batch_multiply``): the running mean of k gradients, one update every
  k calls;
* in a world of several processes (``parallel/dist.py``) the gradients
  an update applies are summed over the rank's dp group first, once an
  update (under accumulation: the running mean, at the k-th call), in
  flat buckets (``dist.allreduce_sum_``). Each rank's loss is its local
  sum over the dp group's denominators (``train.step.world_norms``), so
  the sum is the gradient of the global batch. On a model sharded over an
  mp group (``parallel/mesh.py``) a sharded parameter's gradient, and its
  moments, are this rank's slice, and the update runs on the slices; a
  replicated parameter's summed gradient is then broadcast from the mp
  group's first rank (``dist.broadcast_``), so the group's copies of it
  cannot drift apart, whatever the order of a sum on the way (the JAX
  package's replicated tensor is one array). Every rank of a group then
  applies the same bits.

Two counters, as optax keeps them in ``ScaleByAdamState.count`` and
``ScaleByScheduleState.count``: ``count`` sets the bias correction and
``sched_count`` the learning rate. Both advance on every update, but a
restore may set them apart: ``checkpoint.load_reference_train_state``
takes the Adam count from the file's ``step`` and the schedule count from
``iter_id // batch_multiply``. ``state_dict`` / ``load_state_dict`` carry
both, the moments in their dtype and the MultiSteps state (``mini_step``,
``acc``).

``make_optimizer`` computes each tensor's update with plain PyTorch
operations (``ops/adamw.adamw_update_leaf_plain``); ``make_fused_optimizer``
launches the fused AdamW kernel once per tensor (``ops/adamw.py``). The two
give the same bits. Parameters are updated in place under ``no_grad``, as
the JAX step donates its state; gradients are read from ``.grad`` (a
parameter without one counts as a zero gradient, as in JAX) and the fused
optimizer overwrites them with the update.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import torch

from unimm_torch import checkpoint as ckpt
from unimm_torch.ops.adamw import adamw_update_leaf, adamw_update_leaf_plain
from unimm_torch.parallel import dist, mesh
from unimm_torch.utils import trace

B1, B2 = 0.9, 0.999


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 2e-5
    image_lr: float = 2e-5
    warmup_steps: int = 10000
    t_total: int = 200000          # hard-coded at reference call sites
    min_lr: float = 1e-5
    weight_decay: float = 0.01
    batch_multiply: int = 1
    adam_eps: float = 1e-6
    # dtype of the first Adam moment (optax mu_dtype): "bfloat16" halves
    # its memory; None keeps fp32 (the fused optimizer always does)
    mu_dtype: Optional[str] = None


def warmup_linear_nonzero(base_lr: float, cfg: OptimConfig,
                          step_scale: int = 1):
    """utils/optim_utils.py:19-26: linear warmup to ``base_lr`` over
    ``warmup_steps``, then linear decay to 0 at ``t_total``, floored at
    ``min_lr``; in fp32 as the JAX schedule. ``step_scale``: the reference
    advances its scheduler every micro-batch, so under accumulation the
    schedule is read at update_count * batch_multiply."""

    def schedule(step):
        step = torch.tensor(step, dtype=torch.float32) * step_scale
        warm = step / max(1, cfg.warmup_steps)
        decay = torch.clamp((cfg.t_total - step)
                            / max(1.0, cfg.t_total - cfg.warmup_steps),
                            min=0.0)
        lr = base_lr * torch.where(step < cfg.warmup_steps, warm, decay)
        return torch.where(lr > cfg.min_lr, lr,
                           torch.tensor(cfg.min_lr, dtype=torch.float32))

    return schedule


def load_language_weights(path: str):
    with open(path) as f:
        return json.load(f)


def group_labels(names: Sequence[str], language_weights=None):
    """The lr / decay group of each parameter name; without
    ``language_weights`` every parameter takes ``lr``."""
    lang = (set(names) if language_weights is None
            else ckpt.language_param_set(list(language_weights)))
    return [ckpt.group_label(n, lang) for n in names]


class GroupedAdamW:
    """The grouped two-LR AdamW over a model's parameters (see the module
    docstring). ``step()`` takes one optimizer call: with
    ``batch_multiply`` k it accumulates and updates on every k-th call,
    returning whether it updated. Build it after ``mesh.shard_model``: its
    moments take the parameters' shapes, the slices of a sharded model."""

    def __init__(self, model: torch.nn.Module, cfg: OptimConfig,
                 language_weights=None, fused: bool = False):
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        lay = mesh.layout(model)
        # the parameters every rank of an mp group holds whole
        self.replicated = ([i for i, n in enumerate(self.names)
                            if n not in lay.dims] if lay is not None else [])
        self.cfg = cfg
        self.fused = fused
        labels = group_labels(self.names, language_weights)
        self.groups = [lab.split("_")[0] for lab in labels]
        self.decay = [cfg.weight_decay if lab.endswith("_decay") else 0.0
                      for lab in labels]
        self.sched = {g: warmup_linear_nonzero(base, cfg,
                                               step_scale=cfg.batch_multiply)
                      for g, base in (("lang", cfg.lr),
                                      ("img", cfg.image_lr))}
        mu_dtype = (getattr(torch, cfg.mu_dtype)
                    if cfg.mu_dtype and not fused else torch.float32)
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]
        self.count = 0        # optax's adam count: the bias correction
        self.sched_count = 0  # optax's schedule count: the learning rate
        self.mini_step = 0    # MultiSteps: gradients accumulated so far
        self.acc = None

    def state_dict(self) -> dict:
        """The optimizer's whole state, tensors as they are (device and
        dtype): the two counters, the MultiSteps state and the moments,
        in parameter order with the parameters' names."""
        return {"names": list(self.names), "count": self.count,
                "sched_count": self.sched_count,
                "mini_step": self.mini_step,
                "acc": None if self.acc is None else list(self.acc),
                "mu": list(self.mu), "nu": list(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, sd: dict):
        """Restore ``state_dict``'s output (copied into this optimizer's
        tensors, on their device; the moments keep this optimizer's
        dtypes)."""
        if list(sd["names"]) != self.names:
            raise ValueError("optimizer state of other parameters")
        for dst, src in zip(self.mu + self.nu,
                            list(sd["mu"]) + list(sd["nu"])):
            dst.copy_(src)
        self.count = int(sd["count"])
        self.sched_count = int(sd["sched_count"])
        self.mini_step = int(sd["mini_step"])
        self.acc = (None if sd["acc"] is None else
                    [a.to(device=p.device, dtype=torch.float32, copy=True)
                     for a, p in zip(sd["acc"], self.params)])

    def _grads(self, grads):
        if grads is None:
            grads = [p.grad for p in self.params]
        for p, m in zip(self.params, self.mu):
            if p.shape != m.shape:
                raise ValueError(
                    f"a parameter of shape {tuple(p.shape)} has moments of "
                    f"{tuple(m.shape)}: build the optimizer after "
                    "mesh.shard_model")
        return [torch.zeros_like(p, dtype=torch.float32) if g is None
                else g.float() for p, g in zip(self.params, grads)]

    @torch.no_grad()
    def step(self, grads=None) -> bool:
        """Apply the gradients (default: each parameter's ``.grad``)."""
        grads = self._grads(grads)
        k = self.cfg.batch_multiply
        if k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            n = torch.tensor(self.mini_step + 1, dtype=torch.float32,
                             device=grads[0].device)
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / n)
            self.mini_step += 1
            if self.mini_step < k:
                return False
            grads, self.acc, self.mini_step = self.acc, None, 0
        with trace.span("train.optim.allreduce"):
            dist.allreduce_sum_(grads, over=dist.DP)
            dist.broadcast_([grads[i] for i in self.replicated],
                            over=dist.MP)
        with trace.span("train.optim.update"):
            self._update(grads)
        return True

    def _update(self, grads):
        lr = {g: float(s(self.sched_count)) for g, s in self.sched.items()}
        t = torch.tensor(self.count + 1, dtype=torch.float32)
        bc1 = float(1.0 - torch.tensor(B1, dtype=torch.float32) ** t)
        bc2 = float(1.0 - torch.tensor(B2, dtype=torch.float32) ** t)
        eps = self.cfg.adam_eps
        for i, p in enumerate(self.params):
            g, group, wd = grads[i], self.groups[i], self.decay[i]
            if self.fused:
                g = g.contiguous()
                u, _, _ = adamw_update_leaf(g, p.data, self.mu[i],
                                            self.nu[i], lr[group], wd, bc1,
                                            bc2, b1=B1, b2=B2, eps=eps)
            else:
                m = self.mu[i]
                # a narrower first moment: optax forms b1 * mu in its dtype
                # (b1 rounded to it, a weakly typed constant) before the sum
                b1_mu = (None if m.dtype == torch.float32 else
                         (torch.tensor(B1, dtype=m.dtype, device=m.device)
                          * m).float())
                u, mu, nu = adamw_update_leaf_plain(
                    g, p.data, m.float(), self.nu[i], lr[group], wd, bc1,
                    bc2, b1=B1, b2=B2, eps=eps, b1_mu=b1_mu)
                self.mu[i].copy_(mu)
                self.nu[i].copy_(nu)
            p.add_(u.to(p.dtype))
        self.count += 1
        self.sched_count += 1


def make_optimizer(model, cfg: OptimConfig,
                   language_weights: Optional[Sequence[str]] = None):
    """The grouped AdamW with each tensor's update in plain PyTorch."""
    return GroupedAdamW(model, cfg, language_weights, fused=False)


def make_fused_optimizer(model, cfg: OptimConfig,
                         language_weights: Optional[Sequence[str]] = None):
    """The grouped AdamW whose update is one fused kernel launch per
    parameter tensor (ops/adamw.py); fp32 moments."""
    return GroupedAdamW(model, cfg, language_weights, fused=True)
