"""The one-pass attention of the attention-block kernels (B4, B5's forward:
csrc/seq_attn_fwd.cuh at SCALE_NONE, with DROP under attention dropout)
emulated in plain PyTorch, in fp32, step by step as the kernel takes it:
16-row warp tiles against 64-key chunks, the chunks ``masks.chunk_closed``
closes skipped, each row's open keys from ``masks.row_intervals`` (a row
that attends no key takes [0, L)), a running max with the rescale of the
sum and the context as it grows, the Philox scales (``philox.prob_mask``)
on the P.V operand only, and one division by the sum of the undropped
probabilities at the end. Held on the card check's edge and masked-tail
descriptors against the plain twins (``attention_block_plain``,
``attention_block_train_fwd_plain``) and, at dropout 0, against the JAX
package's ``fused_attention_block_train`` in interpret mode; a control
that lets the dropped probabilities make the sum must miss. The draws'
lane-pair exchange of the kernel (``drop_rows``) is mirrored too. This is
the algorithm's proof where there is no card; the kernel itself is held
in tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from unimm_torch.ops import attention_block_train as tabt
from unimm_torch.ops import masks as tm
from unimm_torch.ops import philox
from unimm_torch.ops.attention_block import attention_block_plain
from unimm_tpu.ops import pallas_attention_v2 as pattn2

H, D = 2, 64             # heads of the kernel's width
SEED = 7                 # the Philox seed
REL = 1e-5               # fp32: only the order of the sums differs


def onepass_ctx(q, k, v, desc, seed=SEED, attn_drop=0.0, drop_in_l=False):
    """The kernel's attention on q (scaled), k, v [B, H, L, D] fp32 and desc
    [B, 3]: [B, H, L, D]. ``drop_in_l`` is the control: the sum l then
    takes the dropped probabilities, which renormalises each row."""
    B, _, L, _ = q.shape
    lo, hi, diag, _ = tm.row_intervals(desc, L)
    j = torch.arange(L)
    opens = (((j >= lo[..., None]) & (j < hi[..., None]))
             | (j == diag[..., None]))                       # [B, L, L]
    mask = None
    if attn_drop > 0:
        tags = torch.arange(B)[:, None] * H + torch.arange(H)[None, :]
        mask = philox.prob_mask(seed, tags, L, attn_drop)   # [B, H, L, L]
    R, KC = tm.ROW_TILE, tm.KEY_CHUNK
    out = torch.zeros_like(q)
    ninf = float("-inf")
    for b in range(B):
        for r0 in range(0, L, R):
            rows = slice(r0, r0 + R)
            m = torch.full((H, R), ninf)
            l = torch.zeros(H, R)
            o = torch.zeros(H, R, D)
            for c in range(-(-L // KC)):
                if tm.chunk_closed(desc[b], L, r0, R, c):
                    continue
                keys = slice(c * KC, min((c + 1) * KC, L))
                s = q[b, :, rows] @ k[b, :, keys].transpose(-1, -2)
                s = s.masked_fill(~opens[b, rows, keys], ninf)
                mn = torch.maximum(m, s.amax(-1))
                # a row with no open key so far keeps m = -inf: exps 0
                ms = torch.where(mn == ninf, torch.zeros_like(mn), mn)
                alpha = torch.exp(m - ms)
                p = torch.exp(s - ms[..., None])
                pd = p if mask is None else p * mask[b, :, rows, keys]
                l = l * alpha + (pd if drop_in_l else p).sum(-1)
                o = o * alpha[..., None] + pd @ v[b, :, keys]
                m = mn
            out[b, :, rows] = o / l[..., None]
    return out


def block_out(ctx, x, wo, bo, gamma, beta, m_o=None, eps=1e-12):
    """The block's output from its merged context, as the twins take it:
    (ctx Wo^T + bo) (* m_o) + x, then the LayerNorm."""
    h = ctx @ wo.t() + bo
    if m_o is not None:
        h = h * m_o
    h = h + x
    mean = h.mean(-1, keepdim=True)
    var = (h - mean).square().mean(-1, keepdim=True)
    return (h - mean) * torch.rsqrt(var + eps) * gamma + beta


def _inputs(L, desc_name, B=10):
    """x, desc, m_o and the ten weights (torch layout) drawn with numpy at
    std 0.1, so the scores are O(1) and the softmax is far from uniform."""
    rng = np.random.default_rng(L + len(desc_name))
    Hd = H * D
    desc = getattr(chip_smoke, desc_name)(
        B, L, torch.Generator().manual_seed(L))
    x = rng.normal(size=(B, L, Hd)).astype(np.float32)
    m_o = ((rng.random((B, L, Hd)) > 0.1) / 0.9).astype(np.float32)
    ws = []
    for shape in [(Hd, Hd), (Hd,)] * 4:
        ws.append((0.1 * rng.normal(size=shape)).astype(np.float32))
    ws.append((1 + 0.1 * rng.normal(size=Hd)).astype(np.float32))
    ws.append((0.1 * rng.normal(size=Hd)).astype(np.float32))
    return (torch.from_numpy(x), desc, torch.from_numpy(m_o),
            [torch.from_numpy(w) for w in ws])


def _emulate(x, desc, ws, drop, m_o=None, drop_in_l=False):
    """(ctx, y) of the kernel's algorithm on the twins' q, k, v."""
    q, k, v, _, _ = tabt._probs(x, desc, SEED, *ws[:6], H, drop)
    ctx = onepass_ctx(*(tabt._heads(t, H) for t in (q, k, v)), desc,
                      attn_drop=drop, drop_in_l=drop_in_l)
    ctx = tabt._merge(ctx, torch.float32)
    return ctx, block_out(ctx, x, *ws[6:], m_o)


def _on_open_rows(desc, L, fn):
    """fn(desc) on the rows that attend a key, fn(every key open) on the
    rows that attend none. Such a row's function is the softmax over all L
    keys at s - 10000, which is the softmax over them at s: the twins and
    the TPU kernel sum s - 10000 in fp32, which carries s to 2^-10 (~1e-4
    of the context), the one-pass kernel drops the constant; on the
    all-open descriptor the twins compute the same function without it."""
    is_open = tm.row_intervals(desc, L)[3]
    assert is_open.any() and (~is_open).any()
    all_open = torch.tensor([[0, L, 0]], dtype=torch.int32).repeat(
        desc.shape[0], 1)
    return [torch.where(is_open[..., None], a, b)
            for a, b in zip(fn(desc), fn(all_open))]


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("drop", [0.0, 0.1])
@pytest.mark.parametrize("desc_name", ["edge_desc", "tail_desc"])
@pytest.mark.parametrize("L", [32, 96, 160, 256])
def test_onepass_matches_the_twins(L, desc_name, drop):
    """ctx and y against B5's twin (at the same Philox seed and hidden
    mask), y at dropout 0 also against B4's twin, each within 1e-5 of its
    largest entry; the control (dropped probabilities in l) misses."""
    x, desc, m_o, ws = _inputs(L, desc_name)
    skipped = sum(tm.chunk_closed(d, L, r0, tm.ROW_TILE, c)
                  for d in desc for r0 in range(0, L, tm.ROW_TILE)
                  for c in range(-(-L // tm.KEY_CHUNK)))
    assert skipped > 0 or L <= tm.KEY_CHUNK  # the skip rule is exercised
    ctx, y = _emulate(x, desc, ws, drop, m_o)
    want_y, want_ctx = _on_open_rows(
        desc, L, lambda d: tabt.attention_block_train_fwd_plain(
            x, d, SEED, m_o, *ws, num_heads=H, attn_drop=drop))
    assert _rel(ctx, want_ctx) <= REL
    assert _rel(y, want_y) <= REL
    if drop == 0.0:
        _, y4 = _emulate(x, desc, ws, drop)
        (want4,) = _on_open_rows(desc, L, lambda d: [attention_block_plain(
            x, d, _attn(ws), num_heads=H)])
        assert _rel(y4, want4) <= REL
    else:
        ctl, _ = _emulate(x, desc, ws, drop, m_o, drop_in_l=True)
        assert _rel(ctl, want_ctx) > REL


def _attn(ws):
    """A module view of the ten weights, as the wrappers take them."""
    from types import SimpleNamespace as NS
    return NS(self=NS(query=NS(weight=ws[0], bias=ws[1]),
                      key=NS(weight=ws[2], bias=ws[3]),
                      value=NS(weight=ws[4], bias=ws[5])),
              output=NS(dense=NS(weight=ws[6], bias=ws[7]),
                        LayerNorm=NS(weight=ws[8], bias=ws[9])))


@pytest.mark.parametrize("desc_name", ["edge_desc", "tail_desc"])
@pytest.mark.parametrize("L", [32, 96, 160, 256])
def test_onepass_matches_jax_at_dropout_0(L, desc_name):
    """y at dropout 0 against JAX's fused_attention_block_train in
    interpret mode (the rows that attend no key from its run on the
    all-open descriptor, as above)."""
    x, desc, m_o, ws = _inputs(L, desc_name)
    _, y = _emulate(x, desc, ws, 0.0, m_o)
    # JAX's kernels take [in, out]
    jw = [jnp.asarray(w.t().numpy() if w.dim() == 2 else w.numpy())
          for w in ws]

    def jax_y(d):
        out = pattn2.fused_attention_block_train(
            H, 0.0, True, jnp.asarray(x.numpy()), jnp.asarray(d.numpy()),
            jnp.array([3], jnp.int32), jnp.asarray(m_o.numpy()), *jw)
        return [torch.from_numpy(np.array(out))]

    (want,) = _on_open_rows(desc, L, jax_y)
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-5)


def drop_rows(bits, thresh, r0, c, j, lane):
    """csrc/seq_attn_fwd.cuh's drop_rows for one lane of the warp at rows
    r0 .. r0 + 15, key chunk c, column group j, line for line on a [L, L]
    table of a (sequence, head)'s draws: the lane computes one Philox block
    (row ra's or rb's, counter col / 4) and takes the other half of its
    pair's from lane ^ 1. Returns the keep bits in an mma accumulator's
    order: (ra, col), (ra, col + 1), (rb, col), (rb, col + 1)."""
    def lane_block(ln):
        ra = r0 + (ln >> 2)
        col = c * tm.KEY_CHUNK + j * 8 + (ln & 3) * 2
        hi = bool(col & 2)
        row = ra + 8 if hi else ra
        w = bits[row, col >> 2 << 2:(col >> 2 << 2) + 4]
        own = (w[2], w[3]) if hi else (w[0], w[1])
        give = (w[0], w[1]) if hi else (w[2], w[3])
        return hi, own, give
    hi, own, _ = lane_block(lane)
    _, _, got = lane_block(lane ^ 1)     # __shfl_xor_sync(..., 1)
    da, db = (got, own) if hi else (own, got)
    return sum(int(u < thresh) << i for i, u in enumerate(da + db))


def test_drop_rows_lane_pairs_give_each_lane_its_keep_bits():
    """Every lane of a warp gets the keep bits of its own two rows and two
    columns from the pair exchange, at every row tile, chunk and column
    group of L 256: the chunk's word (bit 4 j + t for the score the lane
    holds at accumulator j, entry t) equals prob_mask's."""
    L, drop = 256, 0.1
    bits = philox.dropout_bits(SEED, 5, L).numpy()  # tag 5: b 2, h 1 of 2
    kept = (philox.prob_mask(SEED, 5, L, drop) > 0).numpy()
    thresh = philox.keep_threshold(drop)
    for r0 in range(0, L, tm.ROW_TILE):
        for c in range(L // tm.KEY_CHUNK):
            for lane in range(32):
                ra = r0 + (lane >> 2)
                word = 0
                want = 0
                for j in range(8):
                    word |= drop_rows(bits, thresh, r0, c, j, lane) << (4 * j)
                    col = c * tm.KEY_CHUNK + j * 8 + (lane & 3) * 2
                    for t in range(4):
                        row = ra + 8 * (t >> 1)
                        want |= int(kept[row, col + (t & 1)]) << (4 * j + t)
                assert word == want
