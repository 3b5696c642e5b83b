"""The data-parallel world across processes: one process per card, every
rank holding the whole model.

The port's counterpart of the data-parallel half of the JAX package's
``parallel/mesh.py`` (its dp axis spanning processes, ``mesh_mp`` 1) and
of ``jax.experimental.multihost_utils.process_allgather``. The world is
joined through the CLIs' flags ``-coordinator_address host:port
-num_processes N -process_id r`` (``init_world``); without them there is
no process group, ``rank()`` is 0, ``world_size()`` is 1 and every helper
here returns its input. The tensor-parallel half (``mesh_mp`` above 1) is
not ported.

Collectives run on the group's own device: the host arrays of
``allgather_np`` travel as CPU tensors under gloo and as CUDA tensors
under nccl. A failed initialisation or collective raises;
barriers wait for the group's timeout.
"""

from __future__ import annotations

import atexit
import datetime
from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)
# gradient buckets: one all-reduce per 256 MB of a dtype, not one a tensor
BUCKET_BYTES = 256 << 20


def active() -> bool:
    """Whether this process is in a process group (a world of one joined
    through the flags included)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


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
    otherwise (the flags as ``options.check_world`` admits them). Without
    the flags nothing happens. Joining again with the same world, rank and
    backend keeps the group (several entry points in one process); another
    raises. Returns whether a group is active."""
    addr = params["coordinator_address"]
    if not addr:
        return False
    n, r = params["num_processes"], params["process_id"]
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if active():
        joined = (dist.get_world_size(), dist.get_rank(), dist.get_backend())
        if joined != (n, r, backend):
            raise ValueError(f"already in a world (size, rank, backend) "
                             f"{joined}; the flags ask for {(n, r, backend)}")
        return True
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=n, rank=r, timeout=TIMEOUT, **kw)
    atexit.register(close_world)
    return True


def close_world():
    """Leave the process group, if any."""
    if active():
        dist.destroy_process_group()


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


def allgather_np(x) -> List[np.ndarray]:
    """Every rank's ``x`` (a host array), in rank order, on every rank:
    ``process_allgather``'s counterpart. The ranks' leading dims may
    differ (their trailing ones may not): each is padded to the largest
    and stripped again. Without a group: ``[x]``."""
    x = np.asarray(x)
    if not active():
        return [x]
    lead = x.shape[0] if x.ndim else 1
    flat = x.reshape((lead,) + x.shape[1:])
    sizes = [int(s[0]) for s in _gather_same(np.asarray([lead], np.int64))]
    if not max(sizes):                  # every rank's x is empty
        return [flat] * len(sizes)
    pad = max(sizes) - lead
    if pad:
        flat = np.concatenate(
            [flat, np.zeros((pad,) + flat.shape[1:], flat.dtype)])
    blocks = _gather_same(flat)
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


def _gather_same(x: np.ndarray) -> List[np.ndarray]:
    t = _to_tensor(x)
    out = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(out, t)
    return [o.cpu().numpy().astype(x.dtype, copy=False) for o in out]


@torch.no_grad()
def allreduce_sum_(tensors: Sequence[torch.Tensor]):
    """Sum ``tensors`` over the ranks in place, in flat buckets of at most
    ``BUCKET_BYTES`` per dtype and device (one collective a bucket, not
    one a tensor). Every rank ends with the same bits. Nothing without a
    group."""
    if not active():
        return
    groups = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for ts in groups.values():
        bucket, nbytes = [], 0
        for t in ts + [None]:
            size = 0 if t is None else t.numel() * t.element_size()
            if bucket and (t is None or nbytes + size > BUCKET_BYTES):
                flat = torch.cat([b.reshape(-1) for b in bucket])
                dist.all_reduce(flat)
                for b, v in zip(bucket, flat.split([b.numel()
                                                    for b in bucket])):
                    b.copy_(v.view_as(b))
                bucket, nbytes = [], 0
            if t is not None:
                bucket.append(t)
                nbytes += size


def row_block(n: int) -> slice:
    """This rank's contiguous block of ``n`` rows: ``[r * k, (r + 1) *
    k)``, k = n / world. A row count that the world does not divide raises,
    as the JAX package's ``mesh.shard_batch`` refuses to replicate rows
    that differ between processes: pad the batch."""
    r, world = rank(), world_size()
    if n % world:
        raise ValueError(
            f"{n} rows do not divide over {world} processes; pad the "
            "per-process batch (rows that differ between processes are "
            "never replicated)")
    k = n // world
    return slice(r * k, (r + 1) * k)


class _GatherRows(torch.autograd.Function):
    """All ranks' equal [k, ...] blocks concatenated in rank order; the
    backward hands each rank its own block of the incoming gradient (every
    rank computes the same loss from the gathered rows, so the gradients
    summed over the ranks are the single-process ones)."""

    @staticmethod
    def forward(ctx, x):
        ctx.block = row_block(x.shape[0] * world_size())
        out = [torch.empty_like(x) for _ in range(world_size())]
        dist.all_gather(out, x.contiguous())
        return torch.cat(out)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.block]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` [k, ...] of every rank concatenated to [world * k, ...] in
    rank order, differentiable (see ``_GatherRows``); ``x`` without a
    group."""
    if not active():
        return x
    return _GatherRows.apply(x)
