"""K1's one-pass attention (csrc/answer_block.cu, ``answer_attn_kernel``)
where there is no card: its chunk table and its algorithm.

(a) ``answer_block.answer_chunk_table`` (the per-dispatch state of each
64-key chunk for each 16 query rows, which the scorer builds on the device
and the kernel reads) against a loop over its definition, on the port's
scorer biases (``prefix.answer_biases`` on packed rows), on the JAX
package's W-padded ones (``pallas_prefix.block_rr_bias``), and with a row
whose biases close every key, at Lcb 96 and RB 64 / 256: every CLOSED
entry has every bias <= NEG_INF and each row of the tile a key above it
elsewhere; every OPEN entry 64 real keys at bias 0.

(b) The kernel's attention emulated in fp32, step by step as it takes it:
16-row tiles against the context's 64-key chunks (padding past Lcb at
-inf) and then the row block's, CLOSED chunks skipped, OPEN ones without
the bias, a running max with the rescale of the sum and the context, the
unnormalised probabilities p~ rounded to bf16 before P.V (``round_p``),
one division at the end; then the output projection, residual and
LayerNorm. Without the rounding it equals ``answer_block_plain`` and the
JAX package's ``fused_answer_block`` (interpret mode) to fp32 summation
order (rtol 1e-4, atol 1e-5 on y). With it, each probability carries one
bf16 rounding (2^-9 relative), so the context stays within 2^-9 max |v|
of the twin's (held at 2^-8 max |v|), the bound the card check's
B5_CTX_REL covers. A control that adds no bias on MIXED chunks must miss.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from tests._torch_common import TINY, member
from unimm_torch.eval import prefix
from unimm_torch.ops import answer_block as tab
from unimm_torch.ops.masks import KEY_CHUNK, NEG_INF, ROW_TILE
from unimm_tpu.ops import pallas_prefix

KC, RT = KEY_CHUNK, ROW_TILE


def table_by_loops(b_ctx, b_rr):
    """The chunk table from its definition, one entry at a time."""
    G, PB, RB, _ = b_rr.shape
    Lcb = b_ctx.shape[-1]
    CC = -(-Lcb // KC)
    out = np.zeros((G, PB, RB // RT, CC + RB // KC), np.uint8)
    for g in range(G):
        for pb in range(PB):
            for t in range(RB // RT):
                rows = [np.concatenate([b_ctx[g, 0].numpy(),
                                        np.full(CC * KC - Lcb, -np.inf),
                                        b_rr[g, pb, t * RT + r].numpy()])
                        for r in range(RT)]
                real = np.concatenate([np.ones(Lcb, bool),
                                       np.zeros(CC * KC - Lcb, bool),
                                       np.ones(RB, bool)])
                for c in range(out.shape[-1]):
                    keys = slice(c * KC, (c + 1) * KC)
                    closed = all(
                        (row[keys] <= NEG_INF).all()
                        and (row[real] > NEG_INF).any() for row in rows)
                    opened = real[keys].all() and all(
                        (row[keys] == 0).all() for row in rows)
                    out[g, pb, t, c] = (tab.CHUNK_CLOSED if closed else
                                        tab.CHUNK_OPEN if opened else
                                        tab.CHUNK_MIXED)
    return out


def port_biases(Lcb, RB, G=2, seed=0, closed_row=False):
    """The scorer's biases on packed rows (chip_smoke.real_rows); with
    ``closed_row`` slate 0's context closed and row 5 of its first block
    closed on every key (the diagonal too)."""
    gen = torch.Generator().manual_seed(seed)
    lc, opt, rin, A_row = chip_smoke.real_rows(G, Lcb, RB, gen, O=12)
    b_ctx, b_rr = prefix.answer_biases(lc, opt, rin, A_row, 12, Lcb, RB)
    if closed_row:
        b_ctx[0] = NEG_INF
        b_rr[0, 0, 5] = NEG_INF
    return b_ctx, b_rr


def jax_biases(Lcb, W, o_blk, G=2, O=8, seed=0):
    """The JAX package's W-padded biases: its per-option rule (first copy
    causal, second copy strictly before i - A plus the diagonal) through
    ``pallas_prefix.block_rr_bias``, and its context bias."""
    rng = np.random.default_rng(seed)
    A = rng.integers(1, W // 2 + 1, (G, O))
    r = np.arange(W)
    rq, ks = r[:, None], r[None, :]
    A4 = A[..., None, None]
    rr_open = np.where(rq[None, None] < A4, ks <= rq,
                       (ks < rq - A4) | (ks == rq))
    lc = rng.integers(2, Lcb + 1, G)
    jc = np.arange(Lcb)
    b_ctx = np.where((jc >= 1) & (jc < lc[:, None]), 0.0,
                     NEG_INF).astype(np.float32)[:, None, :]
    b_rr = pallas_prefix.block_rr_bias(jnp.asarray(rr_open), o_blk)
    return torch.from_numpy(b_ctx), torch.from_numpy(np.array(b_rr))


@pytest.mark.parametrize("source,Lcb,RB", [
    ("port", 96, 64), ("port", 96, 256), ("closed_row", 96, 64),
    ("jax", 96, 64), ("jax", 96, 256),
    ("port_open_ctx", 192, 256),     # slate 1 attends its whole context
])
def test_chunk_table_matches_its_definition(source, Lcb, RB):
    if source == "jax":
        b_ctx, b_rr = jax_biases(Lcb, 16 if RB == 64 else 32,
                                 4 if RB == 64 else 8)
    else:
        b_ctx, b_rr = port_biases(Lcb, RB, closed_row=source == "closed_row")
    if source == "port_open_ctx":
        b_ctx[1, 0, 1:] = 0.0
    table = tab.answer_chunk_table(b_ctx, b_rr)
    np.testing.assert_array_equal(table.numpy(), table_by_loops(b_ctx, b_rr))
    G, PB, NT, NC = table.shape
    CC = NC - RB // KC
    assert CC == -(-Lcb // KC) and NT == RB // RT
    states = set(table.unique().tolist())
    assert tab.CHUNK_MIXED in states
    if RB == 256:   # block-diagonal options leave whole chunks closed
        assert tab.CHUNK_CLOSED in states
    if source == "port_open_ctx":   # context keys 64-127, 128-191 open
        assert (table[1, :, :, 1:CC] == tab.CHUNK_OPEN).all()
    if source == "closed_row":   # the closed row's tile closes nothing
        assert (table[0, 0, 0] != tab.CHUNK_CLOSED).all()
    # the stated properties, entry by entry
    full = torch.cat([torch.nn.functional.pad(
        b_ctx.expand(G, 1, Lcb)[:, 0], (0, CC * KC - Lcb),
        value=float("-inf"))[:, None, None].expand(G, PB, RB, CC * KC),
        b_rr], -1)
    real = torch.cat([torch.arange(CC * KC) < Lcb,
                      torch.ones(RB, dtype=torch.bool)])
    for g, pb, t, c in (table == tab.CHUNK_CLOSED).nonzero().tolist():
        rows = full[g, pb, t * RT:(t + 1) * RT]
        assert (rows[:, c * KC:(c + 1) * KC] <= NEG_INF).all()
        assert (rows[:, real] > NEG_INF).any(-1).all()
    for g, pb, t, c in (table == tab.CHUNK_OPEN).nonzero().tolist():
        assert real[c * KC:(c + 1) * KC].all()
        assert (full[g, pb, t * RT:(t + 1) * RT,
                     c * KC:(c + 1) * KC] == 0).all()


# --- (b) the kernel's algorithm ---------------------------------------------

def onepass_ctx(q, kr, vr, kc, vc, b_ctx, b_rr, round_p=True,
                mixed_as_open=False):
    """The kernel's attention on q (scaled), the rows' k, v [G, P, H, D]
    and the context's kc, vc [G, Lcb, H, D], all fp32: the merged context
    [G, P, H, D]. ``mixed_as_open`` is the control: MIXED chunks then take
    no bias."""
    G, P, H, D = q.shape
    _, PB, RB, _ = b_rr.shape
    Lcb = kc.shape[1]
    CC = -(-Lcb // KC)
    table = tab.answer_chunk_table(b_ctx, b_rr)
    ninf = float("-inf")
    out = torch.zeros_like(q)
    for g in range(G):
        for pb in range(PB):
            for t in range(RB // RT):
                rows = pb * RB + t * RT + torch.arange(RT)
                m = torch.full((H, RT), ninf)
                l = torch.zeros(H, RT)
                o = torch.zeros(H, RT, D)
                for c in range(table.shape[-1]):
                    state = int(table[g, pb, t, c])
                    if state == tab.CHUNK_CLOSED:
                        continue
                    if c < CC:
                        keys = c * KC + torch.arange(KC)
                        real = keys < Lcb
                        kk = keys.clamp(max=Lcb - 1)
                        k, v = kc[g, kk], vc[g, kk] * real[:, None, None]
                        bias = b_ctx[g, 0, kk].expand(RT, KC)
                    else:
                        keys = pb * RB + (c - CC) * KC + torch.arange(KC)
                        real = torch.ones(KC, dtype=torch.bool)
                        k, v = kr[g, keys], vr[g, keys]
                        bias = b_rr[g, pb, t * RT:(t + 1) * RT,
                                    (c - CC) * KC:(c - CC + 1) * KC]
                    s = torch.einsum("rhd,khd->hrk", q[g, rows], k)
                    if state == tab.CHUNK_MIXED and not mixed_as_open:
                        s = s + bias[None]
                    s = torch.where(real, s, ninf)
                    m_new = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(s - m_new[..., None])
                    l = l * alpha + p.sum(-1)
                    if round_p:
                        p = p.bfloat16().float()
                    o = o * alpha[..., None] + torch.einsum("hrk,khd->hrd",
                                                            p, v)
                    m = m_new
                out[g, rows] = (o / l[..., None]).permute(1, 0, 2)
    return out


def block_y(ctx, x, attn, eps=1e-12):
    """The output projection, bias, residual and LayerNorm of the twin."""
    po = attn.output
    h = ctx @ po.dense.weight.t() + po.dense.bias + x
    mean = h.mean(-1, keepdim=True)
    var = (h - mean).square().mean(-1, keepdim=True)
    return ((h - mean) * torch.rsqrt(var + eps) * po.LayerNorm.weight
            + po.LayerNorm.bias)


def _case(Lcb, RB, seed=1):
    """TINY width at weight std 0.2 (O(1) scores), the scorer's biases on
    packed rows: x, kc, vc [G, *, 32] fp32, the biases, the layer (port,
    JAX)."""
    b_ctx, b_rr = port_biases(Lcb, RB, seed=seed)
    G, PB, _, _ = b_rr.shape
    P = PB * RB
    params, model = member(seed, 0.2)
    rng = np.random.default_rng(seed)
    Hd = TINY.hidden_size
    x, kc, vc = (torch.from_numpy(rng.normal(size=(G, n, Hd)).astype(
        np.float32)) for n in (P, Lcb, Lcb))
    return (x, kc, vc, b_ctx, b_rr, model.bert.encoder.layer[0].attention,
            params["bert"]["encoder"]["layer"]["0"]["attention"])


def _emulate(x, kc, vc, b_ctx, b_rr, attn, **kw):
    H = TINY.num_attention_heads
    G, P, Hd = x.shape
    D = Hd // H
    ps = attn.self

    def heads(t):
        return t.reshape(t.shape[0], t.shape[1], H, D)

    q = heads(x @ ps.query.weight.t() + ps.query.bias) / D ** 0.5
    kr = heads(x @ ps.key.weight.t() + ps.key.bias)
    vr = heads(x @ ps.value.weight.t() + ps.value.bias)
    ctx = onepass_ctx(q, kr, vr, heads(kc), heads(vc), b_ctx, b_rr, **kw)
    return block_y(ctx.reshape(G, P, Hd), x, attn), ctx.reshape(G, P, Hd), vr


@pytest.mark.parametrize("Lcb,RB", [(96, 64), (96, 256)])
def test_onepass_equals_the_twin_and_jax_in_fp32(Lcb, RB):
    x, kc, vc, b_ctx, b_rr, attn, jattn = _case(Lcb, RB)
    with torch.no_grad():
        got, _, _ = _emulate(x, kc, vc, b_ctx, b_rr, attn, round_p=False)
        plain = tab.answer_block_plain(x, kc, vc, b_ctx, b_rr, attn,
                                       num_heads=TINY.num_attention_heads)
    want = pallas_prefix.fused_answer_block(
        *(jnp.asarray(t.numpy()) for t in (x, kc, vc, b_ctx, b_rr)), jattn,
        num_heads=TINY.num_attention_heads, interpret=True)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("Lcb,RB", [(96, 64), (96, 256)])
def test_onepass_bf16_probabilities_within_the_bound(Lcb, RB):
    x, kc, vc, b_ctx, b_rr, attn, _ = _case(Lcb, RB, seed=2)
    H = TINY.num_attention_heads
    with torch.no_grad():
        _, ctx, vr = _emulate(x, kc, vc, b_ctx, b_rr, attn)
        _, ctx_bad, _ = _emulate(x, kc, vc, b_ctx, b_rr, attn,
                                 mixed_as_open=True)
        _, want = tab.answer_block_plain(x, kc, vc, b_ctx, b_rr, attn,
                                         num_heads=H, return_ctx=True)
    vmax = max(float(vr.abs().max()), float(vc.abs().max()))
    err = float((ctx - want).abs().max())
    assert 0 < err <= 2.0 ** -8 * vmax
    assert chip_smoke.rel_err(ctx_bad, want) > 0.1
