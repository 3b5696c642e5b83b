"""The one-pass per-head attention kernel's mask rule on the CPU: each
query row's open keys as one interval plus the diagonal
(``masks.row_intervals``, the twin of csrc/seq_attn_fwd.cuh's ``row_span``)
against the port's ``mask_bias`` and the JAX package's in-kernel
``_mask_bias``, over every descriptor with mode in {0, 1}, ctx_end in
[0, L] and ans_len in [0, 8]; and the skip rule (``masks.chunk_closed``):
attention over only the key chunks it keeps equals the plain twin to fp32
rounding, on the card check's edge and masked-tail descriptors. This is the
skip rule's proof where there is no card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from unimm_torch.ops import masks as tm
from unimm_torch.ops import text_attention as tta
from unimm_tpu.ops.pallas_attention import _mask_bias


def _all_desc(L):
    return torch.tensor([(m, ce, a) for m in (0, 1) for ce in range(L + 1)
                         for a in range(9)], dtype=torch.int32)


def _open_from_intervals(desc, L):
    lo, hi, diag, is_open = tm.row_intervals(desc, L)
    j = torch.arange(L)[None, None, :]
    return is_open[..., None] & (((j >= lo[..., None]) & (j < hi[..., None]))
                                 | (j == diag[..., None]))


@pytest.mark.parametrize("L", [32, 64, 96])
def test_row_intervals_match_the_masks(L):
    desc = _all_desc(L)
    got = _open_from_intervals(desc, L)
    assert torch.equal(got, tm.mask_bias(desc, L) == 0)
    d = jnp.asarray(desc.numpy())
    want = jax.vmap(lambda m, l1, a: _mask_bias(m, l1, a, L))(
        d[:, 0], d[:, 1], d[:, 2])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want) == 0)
    lo, hi, diag, is_open = tm.row_intervals(desc, L)
    # both kinds of row occur; a row that attends nothing weighs every key
    assert is_open.any() and (~is_open).any()
    assert (lo[~is_open] == 0).all() and (hi[~is_open] == L).all()
    assert (diag[~is_open] == -1).all()
    assert ((0 <= lo) & (lo <= hi) & (hi <= L)).all()


def _tail_desc(B, L):
    gen = torch.Generator().manual_seed(L)
    return chip_smoke.tail_desc(B, L, gen)


def _edge_desc(B, L):
    gen = torch.Generator().manual_seed(L)
    return chip_smoke.edge_desc(B, L, gen)


@pytest.mark.parametrize("L,desc_fn", [(96, _edge_desc), (96, _tail_desc),
                                       (160, _edge_desc), (256, _edge_desc),
                                       (256, _tail_desc)])
def test_chunk_skip_is_exact(L, desc_fn):
    """Attention in fp32 over only the chunks ``chunk_closed`` keeps, per
    16-row tile as the kernel's warps skip them, equals the plain twin
    over every key: the masked terms it drops are exact zeros, so only the
    order of the sums differs."""
    B, H, D = 10, 2, 16
    desc = desc_fn(B, L)
    rng = np.random.default_rng(L)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, H, L, D)).astype(
        np.float32)) for _ in range(3))
    keep = torch.ones(B, L, L, dtype=torch.bool)
    n_chunks = -(-L // tm.KEY_CHUNK)
    for b in range(B):
        for r0 in range(0, L, tm.ROW_TILE):
            for c in range(n_chunks):
                if tm.chunk_closed(desc[b], L, r0, tm.ROW_TILE, c):
                    keep[b, r0:r0 + tm.ROW_TILE,
                         c * tm.KEY_CHUNK:(c + 1) * tm.KEY_CHUNK] = False
    skipped = int((~keep).sum())
    assert skipped > 0
    s = tta._scores(q, k, desc).masked_fill(~keep[:, None], float("-inf"))
    got = torch.softmax(s, dim=-1) @ v
    want = tta.text_attention_fwd_plain(q, k, v, desc)
    assert float((got - want).abs().max()) <= 1e-6 * float(
        want.abs().max())
    # the rows that attend no key are in the batch and were never skipped
    closed = ~tm.row_intervals(desc, L)[3]
    assert closed.any() and keep[closed].all()


def test_chunk_closed_per_tile():
    """Dis at ctx_end 40, L 256: rows < 40 attend keys [0, 40); the rest
    attend nothing and weigh every key."""
    desc = (0, 40, 0)
    assert not tm.chunk_closed(desc, 256, 0, 16, 0)
    assert all(tm.chunk_closed(desc, 256, 0, 16, c) for c in (1, 2, 3))
    assert tm.chunk_closed(desc, 256, 32, 8, 1)            # rows 32-39
    assert not tm.chunk_closed(desc, 256, 32, 16, 1)       # rows 40-47 too
    # gen at L1 100, A 8: first-copy rows 96-99 attend [1, i]; the second
    # copy's rows 100-107 [1, i - 8) and the diagonal; rows >= 108 nothing
    desc = (1, 100, 8)
    assert not tm.chunk_closed(desc, 256, 96, 16, 1)
    assert tm.chunk_closed(desc, 256, 96, 12, 2)
    assert not tm.chunk_closed(desc, 256, 112, 16, 1)
