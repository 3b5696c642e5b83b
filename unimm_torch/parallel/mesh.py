"""The tensor-parallel layout: which parameters the mp axis shards, and
how a sharded model is sliced, gathered for compute and gathered whole for
checkpoints.

The port's counterpart of the layout half of the JAX package's
``parallel/mesh.py``: ``param_spec`` is its rule table, copied, applied to
each parameter's JAX path (the inverse of ``checkpoint.torch_name``), and
``layout_dims`` its ``param_shardings`` (a dimension the mp size does not
divide leaves the tensor replicated). What mp buys there, and here, is the
storage of the parameters and of the Adam moments that inherit their
shapes: the JAX package's kernels are ``shard_map``ped over the dp axis
only, with their weights replicated, so each mp device receives each
kernel's weights whole. The port does the same: ``shard_model`` keeps
this rank's slice of each sharded parameter (a contiguous copy, the whole
tensor freed), and every compute view of the model gathers the slices
whole over the rank's mp group (``gather_whole``, differentiable: its
backward hands each rank its slice of the gradient, with no sum over mp,
since the mp peers compute that gradient on the same rows with the same
dropout masks). Checkpoints hold whole tensors (``whole``; ``local``
slices a whole tensor on restore), so a run saved at one mp size resumes
at another, as the JAX package's ``gather_to_host`` / ``restore_placement``
allow.

A spec is a tuple over the JAX tensor's dimensions: ``()`` replicated,
``(None, MP)`` a kernel's output columns, ``(MP, None)`` a kernel's input
rows or the embedding table's vocabulary rows. JAX kernels are [in, out]
and torch weights [out, in], so a column spec shards torch dim 0 and a
row spec on a kernel torch dim 1; the embedding table is not transposed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from unimm_torch.parallel import dist

MP = "mp"


def param_spec(path: Tuple[str, ...]) -> tuple:
    """Megatron-style sharding rules keyed on the torch-mirroring path.

    Column-parallel (shard output dim): QKV projections, FFN up-projection,
    co-attention QKV. Row-parallel (shard input dim): attention output dense,
    FFN down-projection, biOutput projections. Vocab-shard the embedding
    table. Everything small is replicated.
    """
    name = ".".join(path)
    if path[-1] != "kernel":
        if path[-1] == "word_embeddings":
            return (MP, None)
        return ()
    col = (".self.query.", ".self.key.", ".self.value.", "intermediate.dense",
           "biattention.query", "biattention.key", "biattention.value")
    # NOTE: the connection layers name their FFN down-projections
    # v_output.dense / t_output.dense — ".output.dense" does not match them
    row = ("attention.output.dense", ".output.dense", "v_output.dense",
           "t_output.dense", "biOutput.dense", "biOutput.q_dense")
    if any(s in name or name.endswith(s.strip(".")) for s in col):
        return (None, MP)
    if any(s in name for s in row):
        return (MP, None)
    return ()


def jax_paths(model: nn.Module) -> Dict[str, Tuple[str, ...]]:
    """Each parameter's JAX pytree path by its name: a Linear weight is
    the path's ``kernel``, an embedding table's ``weight`` is dropped (the
    inverse of ``checkpoint.torch_name``)."""
    kinds = {name: type(m) for name, m in model.named_modules()}
    out = {}
    for name, _ in model.named_parameters():
        mod, _, leaf = name.rpartition(".")
        path = tuple(name.split("."))
        if leaf == "weight" and issubclass(kinds[mod], nn.Linear):
            path = path[:-1] + ("kernel",)
        elif leaf == "weight" and issubclass(kinds[mod], nn.Embedding):
            path = path[:-1]
        out[name] = path
    return out


def torch_dim(path: Tuple[str, ...]) -> Optional[int]:
    """The torch dimension that ``param_spec(path)`` shards, or None."""
    spec = param_spec(path)
    if MP not in spec:
        return None
    if path[-1] == "kernel":            # [in, out] in JAX, [out, in] here
        return 1 - spec.index(MP)
    return spec.index(MP)


def layout_dims(model: nn.Module, mp: int) -> Dict[str, int]:
    """{parameter name: the torch dim it is sharded on} at mp size ``mp``,
    as the JAX package's ``param_shardings``: a parameter whose sharded
    dimension ``mp`` does not divide stays replicated, and nothing is
    sharded at mp 1. ``model`` may live on the meta device."""
    if mp == 1:
        return {}
    shapes = {n: p.shape for n, p in model.named_parameters()}
    out = {}
    for name, path in jax_paths(model).items():
        d = torch_dim(path)
        if d is not None and shapes[name][d] % mp == 0:
            out[name] = d
    return out


@dataclasses.dataclass(frozen=True)
class Layout:
    """A sharded model's layout: each sharded parameter's torch dim and
    whole shape, the mp size and this rank's mp index."""
    dims: Dict[str, int]
    shapes: Dict[str, Tuple[int, ...]]
    size: int
    rank: int


def layout(model: nn.Module) -> Optional[Layout]:
    """The layout ``shard_model`` gave ``model``, or None (whole)."""
    return getattr(model, "_mp_layout", None)


@torch.no_grad()
def shard_model(model: nn.Module) -> nn.Module:
    """Keep this rank's slice of each parameter that the current grid's mp
    size shards (``dist.mp_size()``; nothing at mp 1): the parameter's data
    becomes a contiguous copy of its block of the sharded dim, so the whole
    tensor is freed (a view would keep its storage alive). Build the
    optimizer after this, so that its moments take the slices' shapes.
    Returns ``model``."""
    size, rank = dist.mp_size(), dist.mp_rank()
    if layout(model) is not None:
        raise ValueError("the model is sharded already")
    dims = layout_dims(model, size)
    if not dims:
        return model
    shapes = {}
    for name, p in model.named_parameters():
        if name in dims:
            shapes[name] = tuple(p.shape)
            p.data = _block(p.data, dims[name], size, rank)
    model._mp_layout = Layout(dims, shapes, size, rank)
    return model


def _block(t: torch.Tensor, dim: int, size: int, rank: int) -> torch.Tensor:
    k = t.shape[dim] // size
    return t.narrow(dim, rank * k, k).clone(
        memory_format=torch.contiguous_format)


def local(model: nn.Module, name: str, whole: torch.Tensor) -> torch.Tensor:
    """This rank's slice of a whole tensor shaped like parameter ``name``
    (a checkpoint's weight or moment), checked against the whole shape;
    ``whole`` itself for a replicated parameter or a whole model."""
    lay = layout(model)
    if lay is None or name not in lay.dims:
        return whole
    if tuple(whole.shape) != lay.shapes[name]:
        raise ValueError(f"shape mismatch for {name}: ckpt "
                         f"{tuple(whole.shape)} vs model {lay.shapes[name]}")
    return _block(whole, lay.dims[name], lay.size, lay.rank)


def whole_shape(model: nn.Module, name: str, t: torch.Tensor):
    """The whole shape of parameter ``name`` (``t`` is its tensor)."""
    lay = layout(model)
    if lay is None or name not in lay.dims:
        return tuple(t.shape)
    return lay.shapes[name]


def _gather(slices: List[torch.Tensor], dims: List[int], sink=None):
    """Whole tensors from this rank's ``slices`` (sharded on ``dims``),
    gathered over the mp group in flat byte buckets of one dtype and
    device, at most ``dist.BUCKET_BYTES`` each (one collective a bucket),
    each whole tensor handed to ``sink`` as its bucket arrives; the bytes
    travel as uint8, so every dtype goes through every backend bit for
    bit."""
    sink = sink or (lambda t: t)
    out: List[Optional[torch.Tensor]] = [None] * len(slices)
    index = {id(t): i for i, t in enumerate(slices)}
    for bucket in dist.buckets(slices):
        flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in bucket])
        peers = dist.allgather_tensors(flat, dist.MP)
        sizes = [t.numel() * t.element_size() for t in bucket]
        parts = [peer.split(sizes) for peer in peers]
        for j, t in enumerate(bucket):
            i = index[id(t)]
            out[i] = sink(torch.cat([p[j].view(t.dtype).view(t.shape)
                                     for p in parts], dim=dims[i]))
    return out


class _GatherWhole(torch.autograd.Function):
    """``_gather`` with a backward that hands each rank its slice of each
    incoming gradient (no sum over the mp group)."""

    @staticmethod
    def forward(ctx, dims, *slices):
        ctx.dims, ctx.size, ctx.rank = dims, dist.mp_size(), dist.mp_rank()
        return tuple(_gather(list(slices), list(dims)))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(_block(g, d, ctx.size, ctx.rank)
                               for g, d in zip(grads, ctx.dims))


def gather_whole(model: nn.Module,
                 tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``tensors`` (parameter name -> this rank's tensor of it, e.g. its
    compute-dtype cast) with each sharded one gathered whole over the mp
    group, differentiably (``_GatherWhole``); as given for a whole model.
    A collective: every rank of the mp group calls it at the same point
    with the same names."""
    lay = layout(model)
    names = [n for n in tensors if lay is not None and n in lay.dims]
    if not names:
        return dict(tensors)
    wholes = _GatherWhole.apply(tuple(lay.dims[n] for n in names),
                                *(tensors[n] for n in names))
    return dict(tensors, **dict(zip(names, wholes)))


@torch.no_grad()
def whole(model: nn.Module, items, sink=None) -> list:
    """[(name, sink(whole tensor))] for each (parameter name, this rank's
    tensor shaped like it: the parameter, a moment) of ``items``, in
    order: a sharded one gathered over the mp group a bucket at a time and
    handed to ``sink`` as its bucket arrives (so no more than a bucket is
    whole on the card at once when ``sink`` copies to the host), a
    replicated one as it is. Without ``sink`` nothing is kept (None for
    every tensor): a peer that takes part in the gather and writes
    nothing. A collective, as ``gather_whole``."""
    items = list(items)
    keep = sink or (lambda t: None)
    lay = layout(model)
    sharded = [i for i, (n, _) in enumerate(items)
               if lay is not None and n in lay.dims]
    got = _gather([items[i][1] for i in sharded],
                  [lay.dims[items[i][0]] for i in sharded], keep)
    out = [(n, None if i in sharded else keep(t))
           for i, (n, t) in enumerate(items)]
    for i, t in zip(sharded, got):
        out[i] = (items[i][0], t)
    return out
