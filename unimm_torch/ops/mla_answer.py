"""The decoder's absorbed MLA answer pass: the attention core of
``models/deepseek_v3.mla_absorbed``.

Each answer row n (of N, in the scorer's option-major order: slate,
option, row) has nh absorbed queries ``qf`` [N, nh, C] (q W_uk beside
q_pe, the softmax scale folded in; C = kv_lora_rank + qk_rope_head_dim).
Its keys are its slate's first ``n_ctx`` cache positions (``cache`` [G,
Lcb, C], cat(c_kv, k_pe) a position) and its own option's rows up to
itself (``kr`` [N, C], the rows' own cat(c_kv, k_pe)); a key's value is
its first ``value_dim`` (kv_lora_rank) columns. ``mla_answer`` returns o
[N, nh, value_dim] = softmax(q k^T) v.

On CUDA tensors it launches ``csrc/mla_answer.cu`` (bf16, C 576, value
width 512, nh dividing 64), or raises where the kernel cannot take them;
on CPU tensors it runs ``mla_answer_plain``, the same function at the
kernel's rounding points: fp32 scores and sums, p rounded to the inputs'
dtype for the product with v, the output rounded once.

The kernel's geometry: a row tile is ``rows_per_tile(nh)`` = 64 / nh
consecutive rows of one slate (64 query vectors, one wgmma tile); its
keys come in tiles of ``KEY_TILE`` positions, the slate's cache up to
n_ctx, then one tile of own rows from the tile's first row's option's
first row, so an option may have at most ``max_option_rows(nh)`` rows.
``plan`` lays the row tiles out on the host once a group
(``AnswerRows`` holds them on the device) and counts the (row, key)
pairs the group needs and the pairs the kernel's key tiles cover.
"""

from __future__ import annotations

import numpy as np
import torch

from unimm_torch.ops import _build

KEY_TILE = 64        # key positions a tile (csrc/mla_answer.cu)
MMA_ROWS = 64        # query vectors a row tile: one wgmma tile
LATENT = 576         # the kernel's key width: c_kv 512 + k_pe 64
VALUE = 512          # its value width: c_kv

__all__ = ["AnswerRows", "plan", "mla_answer", "mla_answer_plain",
           "rows_per_tile", "max_option_rows"]


def _require(cond, msg):
    if not cond:
        raise ValueError(f"mla_answer: {msg}")


def rows_per_tile(nh: int) -> int:
    """Answer rows a row tile: 64 query vectors over nh heads."""
    _require(nh >= 1 and MMA_ROWS % nh == 0,
             f"{nh} heads do not divide a {MMA_ROWS}-row tile")
    return MMA_ROWS // nh


def max_option_rows(nh: int) -> int:
    """The most rows an option may have: a row tile's own keys, from its
    first row's option's first row to its last row, fit one key tile."""
    return KEY_TILE + 1 - rows_per_tile(nh)


class AnswerRows:
    """A group's answer-pass metadata on the device (int32): ``tiles``
    [nb, 3] (slate, first row, end row) of each row tile, ``first`` [N]
    the flat index of each row's option's first row, ``n_ctx`` [G]."""

    def __init__(self, tiles, first, n_ctx):
        self.tiles, self.first, self.n_ctx = tiles, first, n_ctx

    @classmethod
    def put(cls, arrays, device):
        """``plan``'s arrays on ``device``."""
        return cls(*(torch.from_numpy(np.ascontiguousarray(arrays[k])).to(
            device, non_blocking=True) for k in ("tiles", "first", "n_ctx")))


def plan(n_rows, n_ctx, nh: int):
    """The row tiles of a group, on the host: ``n_rows`` [G, O] the input
    rows of each option, ``n_ctx`` [G] each slate's context length.
    Returns (arrays: ``tiles``, ``first``, ``n_ctx`` as ``AnswerRows``
    takes them, int32; counts: ``rows_needed`` (N), ``rows_launched``
    (row tiles x rows a tile), ``pairs_needed`` (the real (row, key) pairs,
    sum over the rows of n_ctx + its index in its option + 1) and
    ``pairs_launched`` (the pairs the kernel's key tiles cover: rows a
    tile x 64 keys x its cache tiles and own tile)). Raises for an option
    of more than ``max_option_rows(nh)`` rows."""
    rt = rows_per_tile(nh)
    n_rows = np.asarray(n_rows, np.int64)
    n_ctx = np.asarray(n_ctx, np.int64)
    G = n_rows.shape[0]
    most = int(n_rows.max(initial=0))
    _require(most <= max_option_rows(nh),
             f"an option of {most} rows exceeds the {max_option_rows(nh)} "
             f"a row tile's own keys can hold at {nh} heads")
    n = n_rows.ravel()
    first = np.repeat(np.cumsum(n) - n, n)
    per = n_rows.sum(1)
    start = np.cumsum(per) - per
    nb = -(-per // rt)
    tg = np.repeat(np.arange(G), nb)
    k = np.arange(int(nb.sum())) - np.repeat(np.cumsum(nb) - nb, nb)
    n0 = start[tg] + rt * k
    n1 = np.minimum(n0 + rt, (start + per)[tg])
    rin = np.arange(first.size) - first
    slate = np.repeat(np.arange(G), per)
    cache_tiles = -(-n_ctx // KEY_TILE)
    counts = dict(
        rows_needed=int(first.size), rows_launched=int(tg.size * rt),
        pairs_needed=int((n_ctx[slate] + rin + 1).sum()),
        pairs_launched=int(rt * KEY_TILE * (cache_tiles[tg] + 1).sum()))
    arrays = dict(tiles=np.stack([tg, n0, n1], 1).astype(np.int32),
                  first=first.astype(np.int32),
                  n_ctx=n_ctx.astype(np.int32))
    return arrays, counts


def mla_answer_plain(qf, cache, kr, rows: AnswerRows, value_dim: int):
    """o [N, nh, value_dim] in qf.dtype, one slate at a time: fp32 scores
    against the slate's first n_ctx cache positions and the row's own
    option's rows up to itself, an fp32 softmax, p rounded to qf.dtype
    for the product with v (fp32 sums), the output rounded once."""
    N, nh, C = qf.shape
    tiles = rows.tiles.long().cpu()
    first = rows.first.long()
    n_ctx = rows.n_ctx.long().cpu().tolist()
    out = qf.new_empty(N, nh, value_dim)
    for g in range(len(n_ctx)):
        mine = tiles[tiles[:, 0] == g]
        if mine.numel() == 0:
            continue
        a, b = int(mine[:, 1].min()), int(mine[:, 2].max())
        q = qf[a:b].float()                                  # [n, nh, C]
        kc = cache[g, :n_ctx[g]].float()                     # [L, C]
        idx = torch.arange(a, b, device=qf.device)
        f = first[a:b]
        width = int((idx - f).max()) + 1
        kidx = f[:, None] + torch.arange(width, device=qf.device)
        shut = kidx > idx[:, None]                           # [n, W]
        ko = kr.index_select(0, kidx.clamp(max=N - 1).reshape(-1)).view(
            b - a, width, C).float()
        s = torch.cat([torch.einsum("nhc,lc->nhl", q, kc),
                       torch.einsum("nhc,nwc->nhw", q, ko).masked_fill(
                           shut[:, None, :], float("-inf"))], -1)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        l = p.sum(-1, keepdim=True)
        p = p.to(qf.dtype).float()
        L = kc.shape[0]
        o = (torch.einsum("nhl,lr->nhr", p[..., :L], kc[:, :value_dim])
             + torch.einsum("nhw,nwr->nhr", p[..., L:],
                            ko[..., :value_dim]))
        out[a:b] = (o / l).to(qf.dtype)
    return out


def mla_answer(qf, cache, kr, rows: AnswerRows, value_dim: int):
    """``mla_answer_plain`` on the kernel (CUDA), plain on the CPU."""
    if qf.device.type == "cpu":
        return mla_answer_plain(qf, cache, kr, rows, value_dim)
    N, nh, C = qf.shape
    G, lcb = cache.shape[0], cache.shape[1]
    _require(C == LATENT and value_dim == VALUE,
             f"the kernel takes keys of {LATENT} and values of {VALUE}, "
             f"got {C} and {value_dim}")
    _require(tuple(cache.shape) == (G, lcb, C) and lcb % KEY_TILE == 0,
             f"cache {tuple(cache.shape)}: [G, Lcb, {C}], Lcb a multiple "
             f"of {KEY_TILE}")
    _require(tuple(kr.shape) == (N, C), f"kr {tuple(kr.shape)}: [N, {C}]")
    rows_per_tile(nh)
    for t in (qf, cache, kr):
        _require(t.dtype == torch.bfloat16, f"bf16 inputs, got {t.dtype}")
    nb = rows.tiles.shape[0]
    _require(tuple(rows.tiles.shape) == (nb, 3) and rows.first.numel() == N
             and rows.n_ctx.numel() == G, "metadata: tiles [nb, 3], first "
             "[N], n_ctx [G]")
    for t in (rows.tiles, rows.first, rows.n_ctx):
        _require(t.dtype == torch.int32, "int32 metadata")
    for t in (qf, cache, kr, rows.tiles, rows.first, rows.n_ctx):
        _require(t.device == qf.device, "all tensors on one device")
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 "inputs must be contiguous and 16-byte aligned")
    out = torch.empty(N, nh, VALUE, dtype=qf.dtype, device=qf.device)
    code = _build.library().unimm_mla_answer(
        qf.data_ptr(), cache.data_ptr(), kr.data_ptr(),
        rows.tiles.data_ptr(), rows.first.data_ptr(), rows.n_ctx.data_ptr(),
        out.data_ptr(), N, nh, G, lcb, nb, _build.stream(qf.device))
    _build.check(code, "mla_answer")
    mla_answer.launches += 1
    return out


mla_answer.launches = 0


def kernel_info() -> dict:
    """Registers, local bytes, shared memory and CTAs an SM of the
    kernel."""
    return _build.kernel_info("unimm_mla_answer_info", 0)
