"""K1 (csrc/answer_block.cu) at the row blocks and context buckets that
are not whole 64-row tiles or 16-key multiples, where there is no card:
RB 16 .. 256 in multiples of 16 (32, 96, the W layout's Rw 160) and even
Lcb (36 and 60, the context buckets of max_seq_len 96 at div 8).

(a) ``answer_chunk_table`` against a loop over its definition in which the
row block's keys past RB are padding, as the context's keys past Lcb are:
on the port's scorer biases, on the W layout's (the port's and the JAX
package's ``block_rr_bias``), and with a row whose biases close every key.
A chunk holding padding keys is never OPEN, and every CLOSED entry has
every bias <= NEG_INF and each row of the tile a key above it elsewhere.

(b) The kernel's attention emulated in fp32 as the short CTAs take it: a
row block is ceil(RB / 64) CTAs of 64 query rows, the last one short by a
multiple of 16 rows; the row block's last key chunk holds its keys past RB
as padding at -inf; CLOSED chunks are skipped, OPEN ones take no bias.
Without the bf16 rounding of p~ it equals ``answer_block_plain`` and the
JAX package's ``fused_answer_block`` (interpret mode) to fp32 summation
order (rtol 1e-4, atol 1e-5 on y); with it the context stays within 2^-8
max |v| of the twin's, and a control that takes the padding keys as open
(bias 0, the zero-filled K and V the kernel stages) must miss by 10%.

(c) The wrapper's limits: RB not a multiple of 16, RB or Lcb above 256 and
odd Lcb raise ``ValueError`` naming them (checked on meta tensors, where
every argument check runs and the device check raises).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from tests._torch_common import TINY, member
from tests.test_torch_answer_onepass import block_y, jax_biases, port_biases
from unimm_torch.eval import prefix
from unimm_torch.models import vilbert
from unimm_torch.ops import answer_block as tab
from unimm_torch.ops.masks import KEY_CHUNK, NEG_INF, ROW_TILE
from unimm_tpu.ops import pallas_prefix

KC, RT = KEY_CHUNK, ROW_TILE


def padded_keys(b_ctx, b_rr, g, pb, row):
    """One query row's biases over the kernel's key layout: the context
    in whole chunks, then the row block in whole chunks, padding at -inf;
    and which keys are real."""
    Lcb, RB = b_ctx.shape[-1], b_rr.shape[-1]
    CC, NR = -(-Lcb // KC), -(-RB // KC)
    bias = np.concatenate([b_ctx[g, 0].numpy(),
                           np.full(CC * KC - Lcb, -np.inf),
                           b_rr[g, pb, row].numpy(),
                           np.full(NR * KC - RB, -np.inf)])
    real = np.concatenate([np.ones(Lcb, bool),
                           np.zeros(CC * KC - Lcb, bool),
                           np.ones(RB, bool), np.zeros(NR * KC - RB, bool)])
    return bias, real


def table_by_loops(b_ctx, b_rr):
    G, PB, RB, _ = b_rr.shape
    Lcb = b_ctx.shape[-1]
    NC = -(-Lcb // KC) + -(-RB // KC)
    out = np.zeros((G, PB, RB // RT, NC), np.uint8)
    for g in range(G):
        for pb in range(PB):
            for t in range(RB // RT):
                rows = [padded_keys(b_ctx, b_rr, g, pb, t * RT + r)
                        for r in range(RT)]
                for c in range(NC):
                    keys = slice(c * KC, (c + 1) * KC)
                    closed = all((b[keys] <= NEG_INF).all()
                                 and (b[real] > NEG_INF).any()
                                 for b, real in rows)
                    opened = all(real[keys].all() and (b[keys] == 0).all()
                                 for b, real in rows)
                    out[g, pb, t, c] = (tab.CHUNK_CLOSED if closed else
                                        tab.CHUNK_OPEN if opened else
                                        tab.CHUNK_MIXED)
    return out


def w_biases(Lcb, W, O, G=2, seed=0):
    """The port scorer's W-layout biases (``prefix.w_layout_biases``) at
    Rw = pick_o_blk(O, W) * W, for answers of 1 .. W / 2 tokens."""
    rng = np.random.default_rng(seed)
    A = torch.from_numpy(rng.integers(1, W // 2 + 1, (G, O)))
    lc = torch.from_numpy(rng.integers(2, Lcb + 1, G))
    return prefix.w_layout_biases(lc, A, W, Lcb)


def test_w_layout_row_blocks_are_jax_s():
    """Rw = pick_o_blk(O, W) * W: 160 at O 100 for W 16 and 32, and at O
    20 for W 16; the port's blocked bias equals the JAX package's."""
    for O, W, Rw in ((100, 16, 160), (100, 32, 160), (20, 16, 160),
                     (100, 64, 256), (10, 16, 160)):
        assert tab.pick_o_blk(O, W) * W == Rw
        assert pallas_prefix.pick_o_blk(O, W) == tab.pick_o_blk(O, W)
    rng = np.random.default_rng(3)
    rr_open = rng.random((2, 20, 16, 16)) < 0.5
    np.testing.assert_array_equal(
        tab.block_rr_bias(torch.from_numpy(rr_open), 10).numpy(),
        np.asarray(pallas_prefix.block_rr_bias(jnp.asarray(rr_open), 10)))


@pytest.mark.parametrize("source,Lcb,RB", [
    ("port", 96, 32), ("port", 96, 96), ("port", 36, 160),
    ("port", 60, 16), ("closed_row", 96, 96), ("w", 96, 160),
    ("w", 36, 160), ("jax", 60, 96),
])
def test_chunk_table_at_tails_matches_its_definition(source, Lcb, RB):
    if source == "w":
        b_ctx, b_rr = w_biases(Lcb, 16, 20)
    elif source == "jax":            # W 32, three options a block
        b_ctx, b_rr = jax_biases(Lcb, 32, 3, O=6)
    else:
        b_ctx, b_rr = port_biases(Lcb, RB, closed_row=source == "closed_row")
    assert b_rr.shape[-1] == RB
    table = tab.answer_chunk_table(b_ctx, b_rr)
    np.testing.assert_array_equal(table.numpy(), table_by_loops(b_ctx, b_rr))
    G, PB, NT, NC = table.shape
    CC = -(-Lcb // KC)
    assert NC == CC + -(-RB // KC) and NT == RB // RT
    if RB % KC:       # the row block's last chunk holds padding keys
        assert (table[..., -1] != tab.CHUNK_OPEN).all()
    if source == "closed_row":
        assert (table[0, 0, 0] != tab.CHUNK_CLOSED).all()
    assert tab.CHUNK_MIXED in set(table.unique().tolist())


def test_chunk_table_refuses_rows_off_the_tile():
    b_ctx, b_rr = port_biases(96, 64)
    with pytest.raises(ValueError, match="multiple of 16"):
        tab.answer_chunk_table(b_ctx, b_rr[..., :40, :40])


# --- (b) the kernel's algorithm at short CTAs -------------------------------

def onepass_tails(q, kr, vr, kc, vc, b_ctx, b_rr, round_p=True,
                  padding_open=False):
    """The kernel's attention, CTA by CTA: q (scaled), kr, vr [G, P, H, D],
    kc, vc [G, Lcb, H, D], fp32; the merged context [G, P, H, D]. Under
    ``padding_open`` (the control) the row block's padding keys count as
    keys of bias 0 with K = V = 0, the zero-filled rows the kernel
    stages."""
    G, P, H, D = q.shape
    _, PB, RB, _ = b_rr.shape
    Lcb = kc.shape[1]
    CC = -(-Lcb // KC)
    table = tab.answer_chunk_table(b_ctx, b_rr)
    if padding_open:
        table = torch.where(table == tab.CHUNK_CLOSED, tab.CHUNK_MIXED,
                            table)
    ninf = float("-inf")
    out = torch.zeros_like(q)
    for g in range(G):
        for pb in range(PB):
            for cta in range(-(-RB // 64)):
                nrows = min(64, RB - 64 * cta)
                assert nrows % RT == 0
                for t in range(64 * cta // RT, 64 * cta // RT + nrows // RT):
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
                            k = kc[g, kk] * real[:, None, None]
                            v = vc[g, kk] * real[:, None, None]
                            bias = b_ctx[g, 0, kk].expand(RT, KC)
                        else:
                            r = (c - CC) * KC + torch.arange(KC)
                            real = r < RB
                            kk = pb * RB + r.clamp(max=RB - 1)
                            k = kr[g, kk] * real[:, None, None]
                            v = vr[g, kk] * real[:, None, None]
                            bias = b_rr[g, pb, t * RT:(t + 1) * RT,
                                        r.clamp(max=RB - 1)]
                        s = torch.einsum("rhd,khd->hrk", q[g, rows], k)
                        if state == tab.CHUNK_MIXED:
                            s = s + torch.where(real, bias, 0.0)[None]
                        if not padding_open:
                            s = torch.where(real, s, ninf)
                        m_new = torch.maximum(m, s.amax(-1))
                        alpha = torch.exp(m - m_new)
                        p = torch.exp(s - m_new[..., None])
                        l = l * alpha + p.sum(-1)
                        if round_p:
                            p = p.bfloat16().float()
                        o = o * alpha[..., None] + torch.einsum(
                            "hrk,khd->hrd", p, v)
                        m = m_new
                    out[g, rows] = (o / l[..., None]).permute(1, 0, 2)
    return out


def _case(Lcb, RB, seed):
    if RB == 160:
        b_ctx, b_rr = w_biases(Lcb, 16, 20, seed=seed)
    else:
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
    ctx = onepass_tails(q, kr, vr, heads(kc), heads(vc), b_ctx, b_rr, **kw)
    return block_y(ctx.reshape(G, P, Hd), x, attn), ctx.reshape(G, P, Hd), vr


@pytest.mark.parametrize("Lcb,RB", [(96, 32), (36, 96), (60, 160)])
def test_onepass_tails_equal_the_twin_and_jax_in_fp32(Lcb, RB):
    x, kc, vc, b_ctx, b_rr, attn, jattn = _case(Lcb, RB, 1)
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


@pytest.mark.parametrize("Lcb,RB", [(96, 96), (36, 160)])
def test_onepass_tails_bf16_probabilities_within_the_bound(Lcb, RB):
    x, kc, vc, b_ctx, b_rr, attn, _ = _case(Lcb, RB, 2)
    H = TINY.num_attention_heads
    with torch.no_grad():
        _, ctx, vr = _emulate(x, kc, vc, b_ctx, b_rr, attn)
        _, ctx_bad, _ = _emulate(x, kc, vc, b_ctx, b_rr, attn,
                                 round_p=False, padding_open=True)
        _, want = tab.answer_block_plain(x, kc, vc, b_ctx, b_rr, attn,
                                         num_heads=H, return_ctx=True)
    vmax = max(float(vr.abs().max()), float(vc.abs().max()))
    err = float((ctx - want).abs().max())
    assert 0 < err <= 2.0 ** -8 * vmax
    assert chip_smoke.rel_err(ctx_bad, want) > 0.1


# --- (c) the wrapper's limits ------------------------------------------------

@pytest.mark.parametrize("RB,Lcb,msg", [
    (40, 96, "multiple of 16"), (512, 96, r"\[16, 256\]"),
    (64, 264, r"even in \[2, 256\]"), (64, 37, r"even in \[2, 256\]")])
def test_answer_block_names_its_limits(RB, Lcb, msg):
    torch.manual_seed(0)
    attn = vilbert._attention(768).to("meta").to(torch.bfloat16)
    G, P = 2, 2 * RB

    def t(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match=msg):
        tab.answer_block(t(G, P, 768), t(G, Lcb, 768), t(G, Lcb, 768),
                         t(G, 1, Lcb, dtype=torch.float32),
                         t(G, 2, RB, RB, dtype=torch.float32), attn,
                         num_heads=12)


def test_answer_block_takes_the_tails_up_to_the_device_check():
    """RB 32 / 96 / 160 and Lcb 36 / 96 pass every argument check (meta
    tensors stop at the device check)."""
    attn = vilbert._attention(768).to("meta").to(torch.bfloat16)
    for RB, Lcb in ((32, 96), (96, 36), (160, 96)):
        G, P = 2, 2 * RB

        def t(*shape, dtype=torch.bfloat16):
            return torch.empty(*shape, dtype=dtype, device="meta")

        table = t(G, 2, RB // RT, -(-Lcb // KC) + -(-RB // KC),
                  dtype=torch.uint8)
        with pytest.raises(ValueError, match="unsupported device meta"):
            tab.answer_block(t(G, P, 768), t(G, Lcb, 768), t(G, Lcb, 768),
                             t(G, 1, Lcb, dtype=torch.float32),
                             t(G, 2, RB, RB, dtype=torch.float32), attn,
                             num_heads=12, table=table)
