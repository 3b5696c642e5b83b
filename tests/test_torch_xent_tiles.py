"""K3's tiled label head (csrc/xent_head.cu) where there is no card: the
logits in 256-column vocab tiles, each tile reduced to every row's
(max, sum of exp2((logit - max) log2(e))) with the columns past V at
-1e30 (the TPU kernel's bias padding), the label's logit picked from the
one tile that holds it, then one combine per row (the largest max, the
sums rescaled to it, log, minus the label's logit), 0 where the label is
-1; emulated in fp32 as the two launches take it. Held against the JAX
package's ``online_softmax_xent_tpu`` (interpret mode) at the tolerance of
``test_xent_head_plain_matches_pallas`` (rtol 1e-6, atol 1e-6), and the
controls (the labels one column on, the last tile dropped) must miss."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unimm_torch.ops import xent_head as txh
from unimm_tpu.ops import pallas_head

LOG2E = 1.4426950408889634
PAD = -1e30


def tiled_xent(h, w, b, lab, drop_last_tile=False):
    """The kernel's partials and combine on fp32 h [M, D], w [V, D], b [V],
    int labels [M]: the NLL [M]."""
    M, V = h.shape[0], w.shape[0]
    VT = txh.VOCAB_TILE
    ntn = -(-V // VT)
    maxes, sums = [], []
    label_logit = torch.zeros(M)
    for t in range(ntn - int(drop_last_tile)):
        cols = t * VT + torch.arange(VT)
        real = cols < V
        cc = cols.clamp(max=V - 1)
        z = torch.where(real, h @ w[cc].t() + b[cc], torch.tensor(PAD))
        mx = z.amax(1)
        sums.append(torch.exp2(z * LOG2E - (mx * LOG2E)[:, None]).sum(1))
        maxes.append(mx)
        hit = (lab[:, None] == cols[None]) & real
        label_logit = torch.where(hit.any(1),
                                  z.gather(1, hit.float().argmax(1,
                                           keepdim=True))[:, 0],
                                  label_logit)
    m_t, s_t = torch.stack(maxes, 1), torch.stack(sums, 1)
    mx = m_t.amax(1)
    lse = mx + torch.log((s_t * torch.exp(m_t - mx[:, None])).sum(1))
    return torch.where(lab == -1, torch.zeros(()), lse - label_logit)


@pytest.mark.parametrize("M,V,block_m,block_v", [
    (40, 517, 16, 256),      # a vocab tail of 5 columns past two tiles
    (7, 300, 256, 128),      # fewer rows than one block
    (33, 1024, 32, 512),     # V a multiple of the tile
])
def test_tiles_and_combine_match_pallas(M, V, block_m, block_v):
    rng = np.random.default_rng(M + V)
    h = rng.normal(size=(M, 64)).astype(np.float32)
    w = (rng.normal(size=(V, 64)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(V,)) * 0.1).astype(np.float32)
    lab = rng.integers(0, V, size=(M,)).astype(np.int32)
    lab[rng.random(M) < 0.3] = -1
    lab[0], lab[1] = V - 1, 0          # the vocab tail and head
    want = np.asarray(pallas_head.online_softmax_xent_tpu(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), jnp.asarray(lab),
        block_m=block_m, block_v=block_v, interpret=True))
    th, tw, tb, tl = (torch.from_numpy(a) for a in (h, w, b, lab))
    got = tiled_xent(th, tw, tb, tl.long())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert (got.numpy()[lab == -1] == 0).all()
    # the controls: a label one column on, the last vocab tile lost
    shifted = torch.where(tl == -1, tl, (tl + 1) % V).long()
    for bad in (tiled_xent(th, tw, tb, shifted),
                tiled_xent(th, tw, tb, tl.long(), drop_last_tile=True)):
        assert not np.allclose(bad.numpy(), want, rtol=1e-6, atol=1e-6)
