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
  embeddings it is tied to (the parity harness's loader);
* ``load_reference_state_dict_lenient(model, sd)`` loads one as the
  reference and the JAX package's ``from_torch_state_dict`` do, by
  dict-intersection update: missing keys keep the model's values, extra
  keys are skipped and returned;
* ``language_param_set`` / ``group_label`` give each parameter its
  optimizer group (train/optim.py), as the reference train.py groups them.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Tuple, Union

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


@torch.no_grad()
def load_reference_state_dict_lenient(model: torch.nn.Module,
                                      state_dict: Dict[str, Any]):
    """Load a reference-format state dict into ``model`` by
    dict-intersection update (reference train.py:359-364), with the JAX
    package's ``from_torch_state_dict`` rules: keys are normalised; the
    tied ``cls.predictions.decoder.weight`` is skipped in favour of the word
    embeddings; a key the model lacks is collected (as given) in
    ``skipped``; a key the checkpoint lacks keeps the model's value; a shape
    mismatch raises ValueError and leaves the model as it was. Returns
    (model, transferred, skipped)."""
    params = model.state_dict()
    updates, skipped = [], []
    for raw, tensor in state_dict.items():
        key = _normalize_key(raw)
        if key == TIED_DECODER:
            continue
        if key not in params:
            skipped.append(raw)
            continue
        value = (tensor if isinstance(tensor, torch.Tensor)
                 else torch.as_tensor(np.asarray(tensor))).float()
        if tuple(value.shape) != tuple(params[key].shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {tuple(value.shape)} vs "
                f"model {tuple(params[key].shape)}")
        updates.append((key, value))
    for key, value in updates:        # the model changes only if all fit
        params[key].copy_(value)
    return model, len(updates), skipped


# ---------------------------------------------------------------------------
# optimizer parameter groups (reference train.py:322-347)
# ---------------------------------------------------------------------------

def language_param_set(language_weights: List[str]) -> set:
    """The reference names in config/language_weights.json, normalised."""
    return {_normalize_key(k) for k in language_weights}


def group_label(name: Union[str, Tuple[str, ...]], lang_set: set) -> str:
    """One of 'lang_decay', 'lang_nodecay', 'img_decay', 'img_nodecay' for
    the parameter ``name`` (a state_dict key, or a JAX pytree path).

    As the reference groups them: membership in language_weights.json
    decides the learning rate; a substring match on "bias" or
    "LayerNorm.weight" decides weight decay. The substring rule is the
    reference's, quirks included: it was written for names whose
    LayerNorm scale was still called "gamma", and it also exempts any name
    that merely contains "bias" (e.g. the biattention weights)."""
    if not isinstance(name, str):
        name = torch_name(tuple(name))
    lang = name in lang_set
    no_decay = ("bias" in name) or ("LayerNorm.weight" in name)
    return ("lang" if lang else "img") + ("_nodecay" if no_decay else "_decay")
