"""Parameter naming and weight transfer for the PyTorch port.

The port's ``VilbertModel`` carries the reference ``state_dict`` names, so:

* ``state_dict_from_jax(params)`` turns the JAX package's parameter pytree
  (nested dicts of numpy arrays) into a state dict the port's model loads
  with strict key matching: the pytree path joined with '.', a Linear
  ``kernel`` [in, out] becomes ``weight`` [out, in];
* ``load_reference_state_dict(model, sd)`` loads a reference ``.ckpt``
  ``model_state_dict`` with strict key matching after stripping the
  ``module.`` / ``bert_pretrained.`` prefixes and the legacy gamma/beta
  names; the tied ``cls.predictions.decoder.weight`` must equal the word
  embeddings it is tied to.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# Embedding tables whose reference '.weight' is not transposed.
_EMBEDDING_LEAVES = {
    "word_embeddings", "position_embeddings", "token_type_embeddings",
    "token_type_embeddings_extension", "sep_embeddings",
}
TIED_DECODER = "cls.predictions.decoder.weight"
WORD_EMBEDDINGS = "bert.embeddings.word_embeddings.weight"


def iter_param_items(params) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) for every leaf of a nested-dict pytree, keys sorted."""
    out = []

    def rec(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k], path + (k,))
        else:
            out.append((path, node))

    rec(params, ())
    return out


def torch_name(path: Tuple[str, ...]) -> str:
    """Pytree path -> reference state_dict key."""
    path = list(path)
    if path[-1] == "kernel":
        path[-1] = "weight"
    elif path[-1] in _EMBEDDING_LEAVES:
        path.append("weight")
    return ".".join(path)


def _normalize_key(k: str) -> str:
    """Strip wrapper prefixes and legacy LayerNorm names."""
    changed = True
    while changed:
        changed = False
        for prefix in ("module.", "bert_pretrained."):
            if k.startswith(prefix):
                k = k[len(prefix):]
                changed = True
    return k.replace(".gamma", ".weight").replace(".beta", ".bias")


def state_dict_from_jax(params) -> "OrderedDict[str, torch.Tensor]":
    """JAX parameter pytree (numpy leaves) -> the port's fp32 state dict."""
    out = OrderedDict()
    for path, leaf in iter_param_items(params):
        arr = np.asarray(leaf, dtype=np.float32)
        if path[-1] == "kernel":
            arr = arr.T
        out[torch_name(path)] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


@torch.no_grad()
def load_reference_state_dict(model: torch.nn.Module,
                              state_dict: Dict[str, Any]):
    """Strictly load a reference-format state dict into ``model``. Raises on
    a missing or unexpected key, and when the tied decoder differs from the
    word embeddings."""
    sd = {}
    for raw, tensor in state_dict.items():
        key = _normalize_key(raw)
        if key in sd:
            raise KeyError(f"duplicate key after normalisation: {raw}")
        sd[key] = torch.as_tensor(tensor)
    tied = sd.pop(TIED_DECODER, None)
    if tied is not None and WORD_EMBEDDINGS in sd and not torch.equal(
            tied.float(), sd[WORD_EMBEDDINGS].float()):
        raise ValueError(f"{TIED_DECODER} is not tied to {WORD_EMBEDDINGS}")
    model.load_state_dict(sd, strict=True)
    return model
