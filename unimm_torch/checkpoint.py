"""Parameter naming and weight transfer for the PyTorch port.

The port's ``VilbertModel`` carries the reference ``state_dict`` names, so:

* ``state_dict_from_jax(params)`` turns the JAX package's parameter pytree
  (nested dicts of numpy arrays) into a state dict the port's model loads
  with strict key matching: the pytree path joined with '.', a Linear
  ``kernel`` [in, out] becomes ``weight`` [out, in], every other leaf
  keeps its layout (the task heads' ``weight_v`` [in, out] and 0-d
  ``weight_g``, models/vl_tasks.py);
* ``load_reference_state_dict(model, sd)`` loads a reference ``.ckpt``
  ``model_state_dict`` with strict key matching after stripping the
  ``module.`` / ``bert_pretrained.`` prefixes and the legacy gamma/beta
  names; the tied ``cls.predictions.decoder.weight`` must equal the word
  embeddings it is tied to (the parity harness's loader);
* ``load_reference_state_dict_lenient(model, sd)`` loads one as the
  reference and the JAX package's ``from_torch_state_dict`` do, by
  dict-intersection update: missing keys keep the model's values, extra
  keys are skipped and returned;
* ``load_reference_ckpt(path, model)`` reads a reference-format ``.ckpt``
  file (its ``model_state_dict`` / ``iter_id`` wrapper or a bare state
  dict) or a local ``.tar.gz`` archive holding one, and loads it leniently
  (the JAX package's ``load_reference_ckpt``);
* ``save_reference_ckpt`` / ``load_reference_train_state`` write and read
  the reference's full training checkpoint (train.py:504-505: the
  ``model_state_dict`` / ``optimizer_state_dict`` / ``scheduler_state_dict``
  / ``iter_id`` dict) with the JAX package's rules: the optimizer state is
  keyed by parameter index in ``model_state_dict`` order without the tied
  decoder; the Adam count comes from the largest ``step`` and the schedule
  count is ``iter_id // batch_multiply``;
* ``save_native`` / ``restore_native`` / ``latest_native`` keep the whole
  training state (fp32 master weights, the optimizer's two counters, its
  MultiSteps state and moments, the step and the dropout seed) as one
  ``torch.save`` file under ``<directory>/step_<n>/``, written under a
  temporary name and renamed, so a killed save never leaves a
  ``step_<n>`` behind. The JAX package writes Orbax directories there;
  the two formats do not read each other;
* ``latest_reference_ckpt`` finds a run's newest reference ``.ckpt``;
* in a world of several processes (``parallel/dist.py``; the ranks of a
  dp group hold the same state) only rank 0 writes a checkpoint and every
  rank then passes a barrier, so none reads before the file is complete;
  ``latest_native`` and ``latest_reference_ckpt`` raise unless every rank
  finds the same step. A checkpoint holds whole tensors: on a model
  sharded over an mp group (``parallel/mesh.py``) the parameters and both
  moments are gathered over rank 0's mp group before the write
  (``mesh.whole``), and a restore slices each whole tensor to this rank's
  block (``mesh.local``), so a run saved at one mp size resumes at
  another;
* ``language_param_set`` / ``group_label`` give each parameter its
  optimizer group (train/optim.py), as the reference train.py groups them.
"""

from __future__ import annotations

import os
import shutil
from collections import OrderedDict
from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch

from unimm_torch.parallel import dist, mesh

# Embedding tables whose reference '.weight' is not transposed.
_EMBEDDING_LEAVES = {
    "word_embeddings", "position_embeddings", "token_type_embeddings",
    "token_type_embeddings_extension", "sep_embeddings",
}
TIED_DECODER = "cls.predictions.decoder.weight"
PREFIX = "bert_pretrained."
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
        # ascontiguousarray makes a 0-d leaf (a weight norm's scalar
        # ``weight_g``) 1-d; the reshape gives it its shape back
        out[torch_name(path)] = torch.from_numpy(
            np.ascontiguousarray(arr)).reshape(arr.shape)
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
        want = mesh.whole_shape(model, key, params[key])
        if tuple(value.shape) != want:
            raise ValueError(
                f"shape mismatch for {key}: ckpt {tuple(value.shape)} vs "
                f"model {want}")
        updates.append((key, mesh.local(model, key, value)))
    for key, value in updates:        # the model changes only if all fit
        params[key].copy_(value)
    return model, len(updates), skipped


def _resolve_archive(path: str):
    """HF-style local archive resolution (the reference's
    vilbert_dialog.py:1123-1232 ``from_pretrained``): a ``.tar.gz``
    containing ``pytorch_model.bin`` is extracted to a temp dir and the
    weights file path is returned with the directory (kept alive by the
    caller). The URL/name-resolution half of the reference surface needs a
    network and is intentionally not reproduced."""
    import tarfile
    import tempfile

    if not (os.path.isfile(path) and tarfile.is_tarfile(path)):
        return path, None
    tmp = tempfile.TemporaryDirectory(prefix="unimm_archive_")
    with tarfile.open(path, "r:*") as t:
        try:
            t.extractall(tmp.name, filter="data")
        except TypeError:      # older tarfile without the filter kwarg:
            # reject traversal members manually before extracting
            for m in t.getmembers():
                p = os.path.normpath(m.name)
                if p.startswith(("/", "..")) or os.path.isabs(p):
                    raise ValueError(
                        f"archive member escapes extraction dir: {m.name!r}")
            t.extractall(tmp.name)
    candidates = []
    for root, _, files in os.walk(tmp.name):
        for f in files:
            if f == "pytorch_model.bin":
                return os.path.join(root, f), tmp
            if f.endswith((".bin", ".ckpt", ".pt")):
                candidates.append(os.path.join(root, f))
    if len(candidates) == 1:
        return candidates[0], tmp
    if candidates:
        # refuse to guess between several non-canonical weight files —
        # os.walk order is filesystem-dependent and picking the wrong blob
        # (e.g. an optimizer .pt) would silently load garbage
        raise ValueError(
            f"archive {path!r} has no pytorch_model.bin and several "
            f"candidate weight files: "
            f"{sorted(map(os.path.basename, candidates))}; "
            "repack with the weights as pytorch_model.bin")
    raise FileNotFoundError(
        f"archive {path!r} contains no pytorch_model.bin/.bin/.ckpt/.pt "
        "weights file")


def load_reference_ckpt(path: str, model: torch.nn.Module):
    """Load a reference-format .ckpt (torch.save pickle: the
    ``model_state_dict`` / ``iter_id`` wrapper or a bare state dict) or a
    local HF-style .tar.gz archive into ``model`` with
    ``load_reference_state_dict_lenient``.

    Returns (model, iter_id, n_transferred, skipped_keys)."""
    path, _tmp = _resolve_archive(path)
    blob = torch.load(path, map_location="cpu", weights_only=False)
    iter_id = 0
    if isinstance(blob, dict) and "model_state_dict" in blob:
        iter_id = int(blob.get("iter_id", blob.get("iterId", 0)) or 0)
        blob = blob["model_state_dict"]
    model, n, skipped = load_reference_state_dict_lenient(model, blob)
    return model, iter_id, n, skipped


# ---------------------------------------------------------------------------
# the reference's full training checkpoint (train.py:371-386, :504-505)
# ---------------------------------------------------------------------------

def _jax_order(names):
    """``names`` in the JAX package's parameter order (its pytree's sorted
    paths): the order its ``save_reference_ckpt`` writes them in."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


def _index_names(keys):
    """The optimizer's parameter index order of a reference checkpoint:
    its ``model_state_dict`` keys without the tied decoder (the
    reference's ``named_parameters()`` leaves shared tensors out)."""
    return [k for k in keys if _normalize_key(k) != TIED_DECODER]


@torch.no_grad()
def load_reference_train_state(path: str, model: torch.nn.Module, opt,
                               batch_multiply: int = 1):
    """Full ``-continue`` restore from a reference-format .ckpt into
    ``model`` and ``opt`` (a fresh ``train.optim.GroupedAdamW`` of it):
    the weights (leniently, as ``load_reference_state_dict_lenient``),
    AdamW's exp_avg / exp_avg_sq, the Adam count (the largest ``step``)
    and the schedule count ``iter_id // batch_multiply`` (the reference
    ticks its scheduler every micro-batch; this optimizer counts updates).
    A moment in the file is [out, in] like the model's parameter, so
    nothing is transposed; a sharded model takes its slices of the
    weights and moments. A file without optimizer state leaves ``opt``
    as it is. Returns (model, opt, iter_id, n_transferred)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if "model_state_dict" not in blob:
        raise ValueError(f"{path} is not a full reference checkpoint "
                         "(no model_state_dict)")
    iter_id = int(blob.get("iter_id", blob.get("iterId", 0)) or 0)
    msd = blob["model_state_dict"]
    model, n, _ = load_reference_state_dict_lenient(model, msd)
    osd = blob.get("optimizer_state_dict")
    if not osd or not osd.get("state"):
        return model, opt, iter_id, n
    index = {name: i for i, name in enumerate(opt.names)}
    names = _index_names(list(msd.keys()))
    for m in opt.mu + opt.nu:
        m.zero_()
    step = 0
    for idx, pstate in osd["state"].items():
        i = index.get(_normalize_key(names[int(idx)]))
        if i is None:
            continue
        name = opt.names[i]
        opt.mu[i].copy_(mesh.local(model, name, torch.as_tensor(
            pstate["exp_avg"]).float()))
        opt.nu[i].copy_(mesh.local(model, name, torch.as_tensor(
            pstate["exp_avg_sq"]).float()))
        step = max(step, int(np.asarray(pstate.get("step", 0))))
    opt.count = step
    opt.sched_count = iter_id // max(1, batch_multiply)
    opt.mini_step, opt.acc = 0, None
    return model, opt, iter_id, n


def extract_adam_moments(opt):
    """(mu, nu, count): fp32 CPU copies of ``opt``'s moments by parameter
    name, and its Adam count (the inverse of the restore above)."""
    mu = {n: m.detach().float().cpu() for n, m in zip(opt.names, opt.mu)}
    nu = {n: v.detach().float().cpu() for n, v in zip(opt.names, opt.nu)}
    return mu, nu, int(opt.count)


def _whole_cpu(model, items, keep: bool):
    """{name: whole CPU copy} of (name, this rank's tensor) items, dtypes
    kept (``mesh.whole``: a collective over the mp group); {} where not
    ``keep`` (a peer of the writer that only takes part in the gather)."""
    got = mesh.whole(model, items, (lambda t: t.detach().to("cpu", copy=True))
                     if keep else None)
    return dict(got) if keep else {}


def _writes() -> bool:
    """Whether this rank takes part in writing a checkpoint: rank 0's mp
    group (the dp index 0) gathers, rank 0 writes."""
    return dist.dp_rank() == 0


def save_reference_ckpt(path: str, model: torch.nn.Module, iter_id: int = 0,
                        opt=None, lang_set=None, lr: float = 2e-5,
                        image_lr: float = 2e-5):
    """Write a reference-format checkpoint as the JAX package's
    ``save_reference_ckpt`` does: ``model_state_dict`` (every parameter as
    ``bert_pretrained.<name>``, fp32, in the JAX package's order, then the
    tied decoder) and ``iter_id``; with ``opt`` also the torch AdamW
    ``optimizer_state_dict`` (one param group per parameter, each state
    holding the Adam count as ``step``) and a ``scheduler_state_dict``.
    Whole tensors (gathered over rank 0's mp group); rank 0 writes; every
    rank passes a barrier after it."""
    if _writes():
        blob = _reference_blob(model, iter_id, opt, lang_set, lr, image_lr,
                               keep=dist.rank() == 0)
        if dist.rank() == 0:
            torch.save(blob, path)
    dist.barrier()


def _reference_blob(model, iter_id, opt, lang_set, lr, image_lr,
                    keep=True) -> dict:
    params = _whole_cpu(model, model.named_parameters(), keep)
    if opt is not None:
        mu = _whole_cpu(model, zip(opt.names, opt.mu), keep)
        nu = _whole_cpu(model, zip(opt.names, opt.nu), keep)
    if not keep:
        return {}
    order = _jax_order(params)
    sd = OrderedDict((PREFIX + n, params[n].float()) for n in order)
    sd[PREFIX + TIED_DECODER] = sd[PREFIX + WORD_EMBEDDINGS].clone()
    blob = {"model_state_dict": sd, "iter_id": iter_id}
    if opt is not None:
        count = int(opt.count)
        lang_set = lang_set or set()
        state, groups = {}, []
        for i, name in enumerate(_index_names(list(sd))):
            key = _normalize_key(name)
            state[i] = {"step": count, "exp_avg": mu[key].float(),
                        "exp_avg_sq": nu[key].float()}
            base = lr if key in lang_set else image_lr
            nodecay = ("bias" in key) or ("LayerNorm.weight" in key)
            groups.append({"params": [i], "lr": base,
                           "weight_decay": 0.0 if nodecay else 0.01,
                           "betas": (0.9, 0.999), "eps": 1e-6,
                           "correct_bias": True})
        blob["optimizer_state_dict"] = {"state": state,
                                        "param_groups": groups}
        blob["scheduler_state_dict"] = {
            "last_epoch": iter_id, "_step_count": iter_id + 1,
            "base_lrs": [g["lr"] for g in groups],
            "warmup_steps": 10000, "t_total": 200000,
        }
    return blob


def _agreed(found):
    """``found`` ((path, step) or None), checked to be every rank's."""
    steps = dist.allgather_np(np.asarray(
        [-1 if found is None else found[1]], np.int64))
    if len({int(s[0]) for s in steps}) > 1:
        raise RuntimeError("the ranks find different latest checkpoints "
                           f"(steps {[int(s[0]) for s in steps]}, -1: none)")
    return found


def latest_reference_ckpt(directory: str):
    """(path, iter_id) of the highest-numbered
    ``visdial_dialog_encoder_<iter>.ckpt`` under ``directory``, or None
    (the same on every rank, or it raises)."""
    return _agreed(_latest_reference_ckpt(directory))


def _latest_reference_ckpt(directory: str):
    if not os.path.isdir(directory):
        return None
    best = None
    prefix, suffix = "visdial_dialog_encoder_", ".ckpt"
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(suffix):
            try:
                it = int(name[len(prefix):-len(suffix)])
            except ValueError:
                continue
            if best is None or it > best[1]:
                best = (os.path.join(directory, name), it)
    return best


# ---------------------------------------------------------------------------
# native checkpoints: the whole training state, one torch.save file a step
# ---------------------------------------------------------------------------

NATIVE_FILE = "state.pt"


def save_native(directory: str, state: dict, step: int) -> str:
    """Write ``state`` (``train.step.init_state``'s dict: model, opt, step,
    seed) as ``<directory>/step_<step>/state.pt``, replacing an existing
    one. The file is written into a hidden temporary directory that is
    then renamed, so ``latest_native`` never sees a half-written step.
    Whole tensors (gathered over rank 0's mp group); rank 0 writes; every
    rank passes a barrier after it."""
    directory = os.path.abspath(directory)
    final = os.path.join(directory, f"step_{step}")
    if _writes():
        blob = _native_blob(state, keep=dist.rank() == 0)
        if dist.rank() == 0:
            _write_native(directory, final, blob, step)
    dist.barrier()
    return final


def _native_blob(state: dict, keep: bool) -> dict:
    model, sd = state["model"], state["opt"].state_dict()
    params = _whole_cpu(model, model.named_parameters(), keep)
    for key in ("mu", "nu", "acc"):
        if sd[key] is not None:
            got = _whole_cpu(model, zip(sd["names"], sd[key]), keep)
            sd[key] = [got.get(n) for n in sd["names"]]
    return {"params": params, "opt": sd, "step": int(state["step"]),
            "seed": int(state["seed"])}


def _write_native(directory: str, final: str, blob: dict, step: int):
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp_step_{step}_{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(blob, os.path.join(tmp, NATIVE_FILE))
    if os.path.exists(final):
        old = os.path.join(directory, f".old_step_{step}_{os.getpid()}")
        os.rename(final, old)
        os.rename(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(tmp, final)


@torch.no_grad()
def restore_native(path: str, state: dict) -> dict:
    """Load ``<path>/state.pt`` into ``state``'s model and optimizer (in
    place, on their device; a sharded model takes its slices of the whole
    tensors) and set its step and seed. Returns ``state``."""
    blob = torch.load(os.path.join(path, NATIVE_FILE), map_location="cpu",
                      weights_only=False)
    model = state["model"]
    params = dict(model.named_parameters())
    if set(params) != set(blob["params"]):
        raise KeyError(f"{path}: the checkpoint holds other parameters")
    for name, value in blob["params"].items():
        params[name].copy_(mesh.local(model, name, value))
    sd = dict(blob["opt"])
    for key in ("mu", "nu", "acc"):
        if sd[key] is not None:
            sd[key] = [mesh.local(model, n, t)
                       for n, t in zip(sd["names"], sd[key])]
    state["opt"].load_state_dict(sd)
    state["step"], state["seed"] = int(blob["step"]), int(blob["seed"])
    return state


def latest_native(directory: str):
    """(path, step) of the highest ``step_<n>`` under ``directory``, or
    None (temporary names are not ``step_<n>``); the same on every rank,
    or it raises."""
    return _agreed(_latest_native(directory))


def _latest_native(directory: str):
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    if not steps:
        return None
    step = max(steps)
    return os.path.join(directory, f"step_{step}"), step


@torch.no_grad()
def load_native_params(path: str, model: torch.nn.Module):
    """Load the weights of a native checkpoint into ``model``: ``path`` is
    a ``step_<n>`` directory or a directory of them (its latest)."""
    if not os.path.isfile(os.path.join(path, NATIVE_FILE)):
        latest = latest_native(path)
        if latest is None:
            raise FileNotFoundError(f"{path}: no native checkpoint")
        path = latest[0]
    blob = torch.load(os.path.join(path, NATIVE_FILE), map_location="cpu",
                      weights_only=False)
    model.load_state_dict(blob["params"], strict=True)
    return model, int(blob["step"])


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
