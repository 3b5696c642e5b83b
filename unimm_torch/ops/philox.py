"""Attention-dropout bits from a counter-based generator (Philox4x32-10).

The TPU kernel ``unimm_tpu/ops/pallas_attention_v2.py:_prob_mask`` draws
its probability-dropout bits from the TPU's hardware PRNG, seeded per
(sequence, head). Those bits cannot be reproduced off the TPU; the port
draws them from Philox4x32-10 (Salmon et al., SC'11; the Random123
constants) so that the attention block's forward and backward kernels
(``csrc/philox.cuh``) and this plain twin all see one mask:

* key     = (seed, tag), tag = b * H + h for sequence b, head h;
* counter = (column // 4, row, 0, 0); the four output words are the bits
  of columns 4 c .. 4 c + 3 of that row;
* keep where bits < uint32(keep * 2**32) (capped at 2**32 - 1), the JAX
  threshold rule, and scale a kept probability by 1 / keep.

Everything here is integer arithmetic in int64 with ``& 0xFFFFFFFF``, so
the plain twin equals the kernels' bits exactly on any device.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
M0, M1 = 0xD2511F53, 0xCD9E8D57          # round multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85          # key increments (Weyl sequence)
ROUNDS = 10


def _mulhilo(a: int, b):
    """(hi, lo) 32-bit words of a * b for a 32-bit constant ``a`` and an
    int64 tensor ``b`` of 32-bit values, without overflowing int64."""
    t_lo = a * (b & 0xFFFF)               # < 2**48
    t_hi = a * (b >> 16)                  # < 2**48
    s = t_lo + ((t_hi & 0xFFFF) << 16)    # < 2**49
    return (t_hi >> 16) + (s >> 32), s & MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 of counter (c0..c3) under key (k0, k1): four uint32
    words as int64 tensors. Arguments broadcast (tensors or ints)."""
    def t(v):
        return torch.as_tensor(v, dtype=torch.int64) & MASK32
    c0, c1, c2, c3, k0, k1 = (t(v) for v in (c0, c1, c2, c3, k0, k1))
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + W0) & MASK32
            k1 = (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = (hi1 ^ c1 ^ k0), lo1, (hi0 ^ c3 ^ k1), lo0
    return c0, c1, c2, c3


def keep_threshold(attn_drop: float) -> int:
    """The uint32 threshold below which a draw keeps its element."""
    keep = 1.0 - attn_drop
    return min(int(keep * 2 ** 32), 2 ** 32 - 1)


def dropout_bits(seed: int, tags, L: int):
    """uint32 draws (as int64) [*tags.shape, L, L] of rows and columns
    0..L-1 (L % 4 == 0) for each tag, on the tags' device."""
    tags = torch.as_tensor(tags, dtype=torch.int64)
    dev = tags.device
    row = torch.arange(L, dtype=torch.int64, device=dev)[:, None]
    col4 = torch.arange(L // 4, dtype=torch.int64, device=dev)[None, :]
    k1 = tags[..., None, None]
    words = philox4x32_10(col4, row, 0, 0, seed, k1)
    # [..., L, L/4, 4] -> [..., L, L]: word w is column 4 c + w
    return torch.stack(torch.broadcast_tensors(*words), -1).flatten(-2)


def prob_mask(seed: int, tags, L: int, attn_drop: float):
    """fp32 scale mask [*tags.shape, L, L]: 1 / keep where kept, else 0."""
    bits = dropout_bits(seed, tags, L)
    keep = 1.0 - attn_drop
    one = torch.full((), 1.0 / keep, dtype=torch.float32, device=bits.device)
    return torch.where(bits < keep_threshold(attn_drop), one,
                       torch.zeros_like(one))
