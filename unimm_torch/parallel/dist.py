"""The world across processes: one process per card, arranged as the JAX
package's dp x mp mesh.

The port's counterpart of the process half of the JAX package's
``parallel/mesh.py`` (``make_mesh``: the device list reshaped to
``(n / mp, mp)``) and of ``jax.experimental.multihost_utils.
process_allgather``. The world is joined through the CLIs' flags
``-coordinator_address host:port -num_processes N -process_id r
[-mesh_mp M]`` (``init_world``); rank ``r`` is dp index ``r // M`` and mp
index ``r % M``. The ranks of one dp index form an mp group, which holds
one copy of the model sharded over its ranks (``parallel/mesh.py``); the
ranks of one mp index form a dp group, over which the rows of a batch are
split and the gradients summed. At ``-mesh_mp`` 1 the dp group is the
world. Without the flags there is no process group, ``rank()`` is 0,
``world_size()`` is 1 and every helper here returns its input.

The helpers act ``over`` an axis: ``WORLD`` (every rank), ``DP`` or
``MP`` (this rank's group of that axis). Collectives run on the group's
own device: the host arrays of ``allgather_np`` travel as CPU tensors
under gloo and as CUDA tensors under nccl. A failed initialisation or
collective raises; barriers wait for the group's timeout.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)
# gradient buckets: one all-reduce per 256 MB of a dtype, not one a tensor
BUCKET_BYTES = 256 << 20
WORLD, DP, MP = "world", "dp", "mp"


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the dp x mp grid and its two groups (None:
    the world's default group, or no group where the axis has one rank)."""
    dp_rank: int = 0
    dp_size: int = 1
    mp_rank: int = 0
    mp_size: int = 1
    dp_group: Optional[object] = None
    mp_group: Optional[object] = None


_grid = Grid()

def active() -> bool:
    """Whether this process is in a process group (a world of one joined
    through the flags included)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def grid_groups(world: int, mp: int):
    """(dp groups, mp groups) of a world of ``world`` ranks at mp size
    ``mp``, each a list of rank lists: mp group d holds ranks ``d * mp ..
    d * mp + mp - 1``, dp group m the ranks ``m, m + mp, ...``."""
    if mp < 1 or world % mp:
        raise ValueError(f"-mesh_mp {mp} does not divide the world's "
                         f"{world} processes")
    dp = world // mp
    return ([[d * mp + m for d in range(dp)] for m in range(mp)],
            [[d * mp + m for m in range(mp)] for d in range(dp)])


def _build_grid(mp: int) -> Grid:
    """Arrange the world as dp x ``mp`` and make it the current grid.
    Every rank creates every group of more than one rank, in the same
    order (dp groups, then mp groups), as ``new_group`` requires; at mp 1
    the dp group is the world's own. Keeps the current grid when it has
    this mp already."""
    global _grid
    if _grid.mp_size == mp and _grid.dp_size * mp == world_size():
        return _grid
    r, n = rank(), world_size()
    dp_groups, mp_groups = grid_groups(n, mp)
    made = {}
    for ranks in (dp_groups if mp > 1 else []) + mp_groups:
        if len(ranks) > 1:
            group = dist.new_group(ranks)
            if r in ranks:
                made[tuple(ranks)] = group
    d, m = divmod(r, mp)
    _grid = Grid(dp_rank=d, dp_size=n // mp, mp_rank=m, mp_size=mp,
                 dp_group=made.get(tuple(dp_groups[m])),
                 mp_group=made.get(tuple(mp_groups[d])))
    return _grid


def grid() -> Grid:
    """The current grid; a world joined without ``init_world`` is dp x 1."""
    if _grid.dp_size * _grid.mp_size != world_size():
        return Grid(dp_rank=rank(), dp_size=world_size())
    return _grid


def dp_rank() -> int:
    return grid().dp_rank


def dp_size() -> int:
    return grid().dp_size


def mp_rank() -> int:
    return grid().mp_rank


def mp_size() -> int:
    return grid().mp_size


def axis_size(over: str) -> int:
    """The number of ranks in this rank's group of axis ``over``."""
    return _axis(over)[1]


def _axis(over: str):
    """(process group or None for the world's, size, this rank's index,
    the global rank of the group's index 0) of axis ``over``."""
    g = grid()
    if over == WORLD:
        return None, world_size(), rank(), 0
    if over == DP:
        return g.dp_group, g.dp_size, g.dp_rank, g.mp_rank
    if over == MP:
        return g.mp_group, g.mp_size, g.mp_rank, g.dp_rank * g.mp_size
    raise ValueError(f"axis {over!r}")


def default_device(params: dict):
    """Each rank's default device: ``cuda:<process_id>`` when the world
    fits this host's cards, plain ``cuda`` without a world. A larger world
    raises: ranks are never folded onto a shared card unless the caller
    passes ``device=``."""
    if not params["coordinator_address"]:
        return "cuda"
    n = params["num_processes"]
    if n > torch.cuda.device_count():
        raise ValueError(
            f"a world of {n} processes on a host with "
            f"{torch.cuda.device_count()} cards: one process drives one "
            "card, so pass the entry point's device= parameter to place "
            "each rank")
    return f"cuda:{params['process_id']}"


def init_world(params: dict, device: torch.device, backend=None) -> bool:
    """Join the process group the flags name (``-coordinator_address
    host:port -num_processes N -process_id r``) on ``device``; the backend
    is nccl on a CUDA device and gloo on the CPU unless ``backend`` says
    otherwise (the flags as ``options.check_world`` admits them), and
    arrange it as dp x ``-mesh_mp`` (``_build_grid``). Without the flags
    nothing happens. Joining again with the same world, rank and backend
    keeps the group (several entry points in one process; the grid is
    rebuilt if the mp size differs); another raises. Returns whether a
    group is active."""
    addr = params["coordinator_address"]
    if not addr:
        return False
    mp = params.get("mesh_mp", 1) or 1
    n, r = params["num_processes"], params["process_id"]
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if active():
        joined = (dist.get_world_size(), dist.get_rank(), dist.get_backend())
        if joined != (n, r, backend):
            raise ValueError(f"already in a world (size, rank, backend) "
                             f"{joined}; the flags ask for {(n, r, backend)}")
        _build_grid(mp)
        return True
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=n, rank=r, timeout=TIMEOUT, **kw)
    atexit.register(close_world)
    _build_grid(mp)
    return True


def close_world():
    """Leave the process group, if any, and its grid."""
    global _grid
    if active():
        dist.destroy_process_group()
    _grid = Grid()


def _comm_device() -> torch.device:
    """Where a host array travels: the current CUDA device under nccl
    (it takes no CPU tensor), the CPU otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier():
    """Wait for every rank (the group's timeout); nothing without one."""
    if active():
        dist.barrier()


def _to_tensor(x: np.ndarray) -> torch.Tensor:
    x = np.ascontiguousarray(x)
    if x.dtype == np.bool_:
        x = x.astype(np.uint8)
    return torch.from_numpy(x).to(_comm_device())


def allgather_np(x, over: str = WORLD) -> List[np.ndarray]:
    """Every rank's ``x`` (a host array) of axis ``over``, in rank order,
    on each of them: ``process_allgather``'s counterpart. The ranks'
    leading dims may differ (their trailing ones may not): each is padded
    to the largest and stripped again. Without a group, or on an axis of
    one rank: ``[x]``."""
    x = np.asarray(x)
    if not active() or axis_size(over) == 1:
        return [x]
    lead = x.shape[0] if x.ndim else 1
    flat = x.reshape((lead,) + x.shape[1:])
    sizes = [int(s[0]) for s in _gather_same(np.asarray([lead], np.int64),
                                             over)]
    if not max(sizes):                  # every rank's x is empty
        return [flat] * len(sizes)
    pad = max(sizes) - lead
    if pad:
        flat = np.concatenate(
            [flat, np.zeros((pad,) + flat.shape[1:], flat.dtype)])
    blocks = _gather_same(flat, over)
    return [b[:s].reshape(x.shape if not x.ndim else (s,) + x.shape[1:])
            for b, s in zip(blocks, sizes)]


def allgather_objects(obj) -> list:
    """Every rank's picklable ``obj``, in rank order, on every rank;
    ``[obj]`` without a group."""
    if not active():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def _gather_same(x: np.ndarray, over: str) -> List[np.ndarray]:
    out = allgather_tensors(_to_tensor(x), over)
    return [o.cpu().numpy().astype(x.dtype, copy=False) for o in out]


def allgather_tensors(t: torch.Tensor, over: str) -> List[torch.Tensor]:
    """Every rank's ``t`` of axis ``over`` (equal shapes and dtypes), in
    rank order; ``[t]`` on an axis of one rank."""
    group, size, _, _ = _axis(over)
    if size == 1:
        return [t]
    out = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def buckets(tensors: Sequence[torch.Tensor]):
    """``tensors`` in runs of one device and dtype of at most
    ``BUCKET_BYTES`` each (a larger tensor alone), in order within a run."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for ts in groups.values():
        bucket, nbytes = [], 0
        for t in ts:
            size = t.numel() * t.element_size()
            if bucket and nbytes + size > BUCKET_BYTES:
                yield bucket
                bucket, nbytes = [], 0
            bucket.append(t)
            nbytes += size
        if bucket:
            yield bucket


def _flat_apply_(bucket, collective):
    flat = torch.cat([b.reshape(-1) for b in bucket])
    collective(flat)
    for b, v in zip(bucket, flat.split([b.numel() for b in bucket])):
        b.copy_(v.view_as(b))


@torch.no_grad()
def allreduce_sum_(tensors: Sequence[torch.Tensor], over: str = WORLD):
    """Sum ``tensors`` over the ranks of axis ``over`` in place, in flat
    buckets of at most ``BUCKET_BYTES`` per dtype and device (one
    collective a bucket, not one a tensor). Every rank of the axis ends
    with the same bits. Nothing without a group or on an axis of one
    rank."""
    group, size, _, _ = _axis(over)
    if not active() or size == 1:
        return
    for bucket in buckets(tensors):
        _flat_apply_(bucket, lambda f: dist.all_reduce(f, group=group))


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], over: str = MP):
    """Overwrite ``tensors`` on every rank of axis ``over`` with its
    index-0 rank's, in flat buckets as ``allreduce_sum_``. Nothing without
    a group or on an axis of one rank."""
    group, size, _, root = _axis(over)
    if not active() or size == 1:
        return
    for bucket in buckets(tensors):
        _flat_apply_(bucket, lambda f: dist.broadcast(f, root, group=group))


def row_block(n: int, over: str = WORLD) -> slice:
    """This rank's contiguous block of ``n`` rows split over axis
    ``over``: ``[i * k, (i + 1) * k)``, i its index there, k = n / the
    axis's size. A row count that the axis does not divide raises, as the
    JAX package's ``mesh.shard_batch`` refuses to replicate rows that
    differ between processes: pad the batch."""
    _, size, i, _ = _axis(over)
    if n % size:
        raise ValueError(
            f"{n} rows do not divide over {size} processes; pad the "
            "per-process batch (rows that differ between processes are "
            "never replicated)")
    k = n // size
    return slice(i * k, (i + 1) * k)


class _GatherRows(torch.autograd.Function):
    """The equal [k, ...] blocks of axis ``over``'s ranks concatenated in
    rank order; the backward hands each rank its own block of the incoming
    gradient (each rank of the axis computes the same loss from the
    gathered rows, so the gradients summed over the axis are the
    single-process ones)."""

    @staticmethod
    def forward(ctx, x, over):
        size = axis_size(over)
        ctx.block = row_block(x.shape[0] * size, over)
        return torch.cat(allgather_tensors(x, over))

    @staticmethod
    def backward(ctx, g):
        return g[ctx.block], None


def gather_rows(x: torch.Tensor, over: str = WORLD) -> torch.Tensor:
    """``x`` [k, ...] of every rank of axis ``over`` concatenated to
    [size * k, ...] in rank order, differentiable (see ``_GatherRows``);
    ``x`` without a group or on an axis of one rank."""
    if not active() or axis_size(over) == 1:
        return x
    return _GatherRows.apply(x, over)
