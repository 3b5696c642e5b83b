"""Shared pieces of the tests that hold the PyTorch port (unimm_torch)
against the JAX package on the same weights: the TINY config in both
packages, the JAX parameters, and the port's model loaded from them with
``state_dict_from_jax``."""

import dataclasses
import functools

import numpy as np
import torch

import jax

from tests.test_model import TINY
from unimm_torch.checkpoint import state_dict_from_jax
from unimm_torch.config import VilbertConfig as TorchConfig
from unimm_torch.models import vilbert as tv
from unimm_tpu.models import vilbert as jv

TINY_T = TorchConfig.from_dict(dataclasses.asdict(TINY))

# the TINY shapes gain nothing from intra-op threads, and the suite's
# parallel workers would oversubscribe the cores with them
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def jax_params():
    return jv.init_params(jax.random.PRNGKey(0), TINY)


@functools.lru_cache(maxsize=None)
def jax_params_np():
    return jax.tree_util.tree_map(np.asarray, jax_params())


@functools.lru_cache(maxsize=None)
def member(seed, std):
    """(JAX params, the port's fp32 CPU model) of the TINY config drawn
    from ``seed`` with weight std ``std``."""
    params = jv.init_params(jax.random.PRNGKey(seed),
                            TINY.replace(initializer_range=std))
    model = tv.empty_model(TINY_T, "cpu")
    model.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return params, model


def torch_model(cfg=TINY_T):
    """The port's fp32 CPU model carrying the JAX parameters."""
    model = tv.empty_model(cfg, "cpu")
    model.load_state_dict(state_dict_from_jax(jax_params_np()), strict=True)
    return model


def flatten_slates(batch):
    """A [B, R, O] val batch -> the flat per-sequence torch batch that
    ``unimm_torch.models.unimm.forward_eval`` takes."""
    B, R, O, L = np.asarray(batch["tokens"]).shape
    N = B * R * O
    flat = {k: torch.from_numpy(np.asarray(batch[k]).reshape(N, L))
            for k in ("tokens", "segments", "mlm_labels")}
    flat.update({k: torch.from_numpy(np.asarray(batch[k]).reshape(N))
                 for k in ("mode", "ctx_end", "ans_len")})
    flat["img_index"] = torch.from_numpy(np.repeat(np.arange(B), R * O))
    for k in ("image_feat", "image_loc", "image_mask"):
        flat[k] = torch.from_numpy(np.asarray(batch[k]))
    return flat

