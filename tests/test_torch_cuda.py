"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same bf16 inputs, at the kernels' width (768) and small
batches (K2 and B8, on the Hopper GEMM cores, also at row tails and 1-64
regions with bit-equal reruns and lost-tile / lost-row controls; K1 with
its per-head context, on the scorer's biases too, K3 and the training
cross-entropy, each with controls that must miss and bit-equal reruns),
plus the wrappers' refusals, a short prefix-scorer run through
its three kernels, a short flat-scorer run through its three, and the
training attention block (forward and backward, with dropout, the
backward's other-seed control and bit-equal reruns; B4's and B5's
products on the wgmma + TMA core: bit-equal reruns, B5's dx at the
training morsels' lengths, nothing launched but the GEMM core, the
attention and the row LayerNorm) and the fused AdamW,
the per-head text attention kernels (forward, backward and attention_v2,
the skipped chunks of the one-pass forward and of the tiled backward,
their fit on the card), and the attention-block bench's probes (B4 at
other block_b, the softmax-mode and layout probes, the ``full`` probe
equal to B4 bit for bit, their own kernels' fit), the decoder's grouped
expert GEMM and K3 at width 2048. Every test needs a CUDA device and skips
without one.

This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda -q tests/test_torch_cuda.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from unimm_torch.config import VilbertConfig
from unimm_torch.models import vilbert
from unimm_torch.ops import adamw as tadam
from unimm_torch.ops import answer_block as tab
from unimm_torch.ops import attention_block as tatb
from unimm_torch.ops import attention_block_train as tabt
from unimm_torch.ops import attention_v2 as tav2
from unimm_torch.ops import block_probe as tbp
from unimm_torch.ops import co_text_block as tco
from unimm_torch.ops import ffn_block as tfb
from unimm_torch.ops import text_attention as tta
from unimm_torch.ops import xent_head as txh
from unimm_torch.ops import xent_train as txt
from unimm_torch.ops.masks import NEG_INF

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _module(make, gen, dev):
    with torch.device(dev):
        m = make()
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    return m.to(torch.bfloat16).requires_grad_(False)


def _close(got, want, atol, rtol):
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("Lcb,RB,P", [(64, 64, 256), (96, 64, 256),
                                      (224, 256, 512)])
def test_answer_block_matches_plain(dev, Lcb, RB, P):
    gen = torch.Generator(device=dev).manual_seed(Lcb + RB)
    G = 2
    attn = _module(lambda: vilbert._attention(768), gen, dev)
    x = torch.randn(G, P, 768, generator=gen, device=dev).bfloat16()
    kc = torch.randn(G, Lcb, 768, generator=gen, device=dev).bfloat16()
    vc = torch.randn(G, Lcb, 768, generator=gen, device=dev).bfloat16()
    j = torch.arange(Lcb, device=dev)
    b_ctx = torch.where((j >= 1) & (j < Lcb - 3), 0.0, NEG_INF).expand(
        G, 1, Lcb).contiguous()
    r = torch.arange(RB, device=dev)
    b_rr = torch.where(r[None, :] <= r[:, None], 0.0, NEG_INF).expand(
        G, P // RB, RB, RB).contiguous()
    n0 = tab.answer_block.launches
    got = tab.answer_block(x, kc, vc, b_ctx, b_rr, attn, num_heads=12)
    assert tab.answer_block.launches == n0 + 1
    want = tab.answer_block_plain(x, kc, vc, b_ctx, b_rr, attn,
                                  num_heads=12)
    _close(got, want, 5e-2, 2e-2)


@pytest.mark.parametrize("Lcb,RB,P,real", [(96, 64, 512, False),
                                           (224, 256, 512, False),
                                           (192, 64, 0, True),
                                           (256, 256, 0, True)])
def test_answer_block_context_controls_and_bits(dev, Lcb, RB, P, real):
    """K1 as chip_smoke.py phase 3 holds it, at G 4: y and the per-head
    context against the twin at WIDE_STD, the reruns bit-equal, and the
    twin on the lc - 1 and shifted-options biases missing the context
    bound (``check_answer_block`` raises if a control passes)."""
    gen = torch.Generator(device=dev).manual_seed(Lcb + RB + real)
    res = chip_smoke.check_answer_block(dev, gen, Lcb, RB, G=4, P=P,
                                        real=real)
    assert res["ok"], res


@pytest.mark.parametrize("Lcb,RB,real,w", [(96, 32, True, 0),
                                            (192, 96, True, 0),
                                            (256, 160, False, 16),
                                            (96, 160, False, 32),
                                            (36, 96, True, 0)])
def test_answer_block_tails_controls_and_bits(dev, Lcb, RB, real, w):
    """K1 at row blocks of 16-row tails (32, 96, the W layout's Rw 160 on
    the scorer's W-layout biases at W 16 and 32) and at context buckets of
    96 and 36, as chip_smoke.py phase 3 holds it at G 4: y and the context
    against the twin at WIDE_STD, reruns bit-equal, both controls missing
    the context bound."""
    gen = torch.Generator(device=dev).manual_seed(Lcb + RB + w)
    res = chip_smoke.check_answer_block(dev, gen, Lcb, RB, G=4, P=0,
                                        real=real, w=w)
    assert res["ok"], res


def test_answer_block_takes_the_scorers_table(dev):
    """A table built once (as the scorer builds it) gives the bits of the
    call that builds its own."""
    gen = torch.Generator(device=dev).manual_seed(5)
    attn, x, kc, vc, b_ctx, b_rr, _ = chip_smoke.answer_inputs(
        dev, gen, 160, 256, 3, 0, True)
    table = tab.answer_chunk_table(b_ctx, b_rr)
    assert torch.equal(
        tab.answer_block(x, kc, vc, b_ctx, b_rr, attn, num_heads=12,
                         table=table),
        tab.answer_block(x, kc, vc, b_ctx, b_rr, attn, num_heads=12))


def _mixed_desc(B, L, gen):
    """[B, 3] int32 descriptors cycling through: dis at full length, dis
    with fully masked rows past its extent, gen, gen whose masked answer
    copy is truncated at L (ctx_end + ans_len > L), and gen with a context
    of one token."""
    rows = []
    for i in range(B):
        kind = i % 5
        if kind == 0:
            rows.append((0, L, 0))
        elif kind == 1:
            rows.append((0, int(gen.integers(1, L)), 0))
        elif kind == 2:
            a = int(gen.integers(2, 9))
            rows.append((1, int(gen.integers(a + 2, L - a)), a))
        elif kind == 3:
            a = int(gen.integers(3, 9))
            rows.append((1, L - a + int(gen.integers(1, a)), a))
        else:
            rows.append((1, 5, 4))
    return torch.tensor(rows, dtype=torch.int32)


@pytest.mark.parametrize("L", [32, 96, 192, 256])
def test_attention_block_matches_plain(dev, L):
    gen = torch.Generator(device=dev).manual_seed(L)
    B = 10
    attn = _module(lambda: vilbert._attention(768), gen, dev)
    x = torch.randn(B, L, 768, generator=gen, device=dev).bfloat16()
    desc = _mixed_desc(B, L, np.random.default_rng(L)).to(dev)
    n0 = tatb.attention_block.launches
    got = tatb.attention_block(x, desc, attn, num_heads=12)
    assert tatb.attention_block.launches == n0 + 1
    want = tatb.attention_block_plain(x, desc, attn, num_heads=12)
    _close(got, want, 5e-2, 2e-2)


def test_attention_block_masked_tails(dev):
    """B4 on the masked tails (ctx_end <= 64 at L 256: the one-pass kernel
    skips the closed chunks of the first rows, and the rows past ctx_end
    weigh every key) within its bound of the plain twin; the twin on the
    flipped descriptors misses it."""
    gen = torch.Generator(device=dev).manual_seed(3)
    B, L = 16, 256
    attn = _wide_attention(gen, dev)
    x = torch.randn(B, L, 768, generator=gen, device=dev).bfloat16()
    desc = chip_smoke.tail_desc(B, L, gen)
    n0 = tatb.attention_block.launches
    got = tatb.attention_block(x, desc, attn, num_heads=12)
    assert tatb.attention_block.launches == n0 + 1
    _close(got, tatb.attention_block_plain(x, desc, attn, num_heads=12),
           5e-2, 2e-2)
    with pytest.raises(AssertionError):
        _close(got, tatb.attention_block_plain(x, _flip(desc), attn,
                                               num_heads=12), 5e-2, 2e-2)


def test_co_text_block_matches_plain(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    B, L, R = 6, 224, 37
    conn = _module(lambda: vilbert._connection(VilbertConfig()), gen, dev)
    t_x = torch.randn(B, L, 768, generator=gen, device=dev).bfloat16()
    v_x = torch.randn(B, R, 1024, generator=gen, device=dev).bfloat16()
    im = (torch.rand(B, R, generator=gen, device=dev) > 0.3).float()
    im[2] = 0.0                          # a sequence with every region masked
    n0 = tco.co_text_block.launches
    got = tco.co_text_block(t_x, v_x, im, conn, num_heads=8)
    assert tco.co_text_block.launches == n0 + 1
    want = tco.co_text_block_plain(t_x, v_x, im, conn, num_heads=8)
    _close(got, want, 5e-2, 2e-2)


@pytest.mark.parametrize("M", [1, 63, 64, 65, 129, 300])
def test_ffn_block_row_tails_and_controls(dev, M):
    """K2 on the Hopper GEMM cores at row counts around their 128-row and
    64-row tiles, weights at WIDE_STD: within the bound of the twin, bit-
    equal when rerun; the twin with one 64-wide k tile of W1 or of W2
    zeroed, or with the last row dropped, misses the bound."""
    gen = torch.Generator(device=dev).manual_seed(M)
    layer = chip_smoke.seeded_module(lambda: vilbert._layer(768, 3072), gen,
                                     dev, std=chip_smoke.WIDE_STD)
    pi, po = layer.intermediate, layer.output
    x = torch.randn(1, M, 768, generator=gen, device=dev).bfloat16()
    n0 = tfb.ffn_block.launches
    got = tfb.ffn_block(x, pi, po)
    assert tfb.ffn_block.launches == n0 + 1
    assert torch.equal(got, tfb.ffn_block(x, pi, po))
    tol = chip_smoke.TOL["ffn_block"]
    want = tfb.ffn_block_plain(x, pi, po)
    _close(got, want, *tol)
    for wrong in (
            tfb.ffn_block_plain(x, SimpleNamespace(
                dense=chip_smoke.zero_k_tile(pi.dense, 64)), po),
            tfb.ffn_block_plain(x, pi, SimpleNamespace(
                dense=chip_smoke.zero_k_tile(po.dense, 1536),
                LayerNorm=po.LayerNorm)),
            chip_smoke.drop_last_row(want)):
        with pytest.raises(AssertionError):
            _close(got, wrong, *tol)


@pytest.mark.parametrize("O,W", [(100, 16), (25, 48)])
def test_make_ffn_takes_the_w_layouts_rows(dev, O, W):
    """The prefix scorer's answer-pass FFN with the kernels on, at the W
    layout's O * W rows a slate (G 2: 1600 rows at O 100, W 16; 1200 at the
    odd O 25, W 48), which no re-blocking touches: one K2 launch, within
    K2's bound of its twin, bit-equal when rerun; the twin with the last
    row dropped misses the bound."""
    from unimm_torch.eval.prefix import PrefixScorer

    gen = torch.Generator(device=dev).manual_seed(O + W)
    layer = chip_smoke.seeded_module(lambda: vilbert._layer(768, 3072), gen,
                                     dev, std=chip_smoke.WIDE_STD)
    pi, po = layer.intermediate, layer.output
    x = torch.randn(2, O * W, 768, generator=gen, device=dev).bfloat16()
    ffn = PrefixScorer(VilbertConfig(), device=dev)._make_ffn(True)
    n0 = tfb.ffn_block.launches
    got = ffn(pi, po, x)
    assert tfb.ffn_block.launches == n0 + 1
    assert torch.equal(got, ffn(pi, po, x))
    tol = chip_smoke.TOL["ffn_block"]
    want = tfb.ffn_block_plain(x, pi, po)
    _close(got, want, *tol)
    with pytest.raises(AssertionError):
        _close(got, chip_smoke.drop_last_row(want), *tol)


@pytest.mark.parametrize("L,R", [(48, 1), (112, 37), (80, 64)])
def test_co_text_block_regions_and_controls(dev, L, R):
    """B8 at 1, 37 and 64 regions with every region of one sequence masked,
    text rows with a partial last tile, weights at WIDE_STD: within the
    bound of the twin, bit-equal when rerun; the twin with one 64-wide k
    tile of Wd2 zeroed, or with the last row dropped, misses the bound."""
    gen = torch.Generator(device=dev).manual_seed(L + R)
    B = 3
    conn = chip_smoke.seeded_module(
        lambda: vilbert._connection(VilbertConfig()), gen, dev,
        std=chip_smoke.WIDE_STD)
    t_x = torch.randn(B, L, 768, generator=gen, device=dev).bfloat16()
    v_x = torch.randn(B, R, 1024, generator=gen, device=dev).bfloat16()
    im = (torch.rand(B, R, generator=gen, device=dev) > 0.2).float()
    im[1] = 0.0
    n0 = tco.co_text_block.launches
    got = tco.co_text_block(t_x, v_x, im, conn, num_heads=8)
    assert tco.co_text_block.launches == n0 + 1
    assert torch.equal(got, tco.co_text_block(t_x, v_x, im, conn,
                                              num_heads=8))
    tol = chip_smoke.TOL["co_text_block"]
    want = tco.co_text_block_plain(t_x, v_x, im, conn, num_heads=8)
    _close(got, want, *tol)
    po = conn.biOutput
    wrong_conn = SimpleNamespace(
        biattention=conn.biattention,
        biOutput=SimpleNamespace(dense2=chip_smoke.zero_k_tile(po.dense2, 512),
                                 LayerNorm2=po.LayerNorm2))
    for wrong in (tco.co_text_block_plain(t_x, v_x, im, wrong_conn,
                                          num_heads=8),
                  chip_smoke.drop_last_row(want)):
        with pytest.raises(AssertionError):
            _close(got, wrong, *tol)


@pytest.mark.parametrize("act", ["gelu", "relu", "swish"])
def test_ffn_block_matches_plain(dev, act):
    gen = torch.Generator(device=dev).manual_seed(1)
    layer = _module(lambda: vilbert._layer(768, 3072), gen, dev)
    x = torch.randn(3, 100, 768, generator=gen, device=dev).bfloat16()
    got = tfb.ffn_block(x, layer.intermediate, layer.output, act=act)
    want = tfb.ffn_block_plain(x, layer.intermediate, layer.output, act=act)
    _close(got, want, 5e-2, 2e-2)


def test_xent_head_matches_plain(dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    M, V = 300, 5000
    h = torch.randn(M, 768, generator=gen, device=dev).bfloat16()
    w = (torch.randn(V, 768, generator=gen, device=dev) * 0.02).bfloat16()
    b = torch.randn(V, generator=gen, device=dev) * 0.1
    lab = torch.randint(0, V, (M,), generator=gen, device=dev)
    lab[::3] = -1
    lab[1], lab[2] = V - 1, 0
    got = txh.xent_head(h, w, b, lab)
    want = txh.xent_head_plain(h, w, b, lab)
    _close(got, want, 2e-3, 1e-4)
    assert (got[lab == -1] == 0).all()


@pytest.mark.parametrize("M,V", [(1000, 30522), (129, 5000)])
def test_xent_head_controls_and_bits(dev, M, V):
    """K3 as chip_smoke.py phase 3 holds it: the twin's bound, the rerun
    bit-equal, and the shifted-label and dropped-tile controls missing
    (``check_xent_head`` raises if one passes)."""
    gen = torch.Generator(device=dev).manual_seed(M)
    res = chip_smoke.check_xent_head(dev, gen, M=M, V=V)
    assert res["ok"], res


@pytest.mark.parametrize("M,V", [(1000, 163840), (129, 5000)])
def test_xent_head_2048_controls_and_bits(dev, M, V):
    """K3's width-2048 instance (the decoder's untied head, no bias) as
    chip_smoke.py phase 3 holds it."""
    gen = torch.Generator(device=dev).manual_seed(M + 1)
    res = chip_smoke.check_xent_head(dev, gen, M=M, V=V, Hd=2048,
                                     bias=False)
    assert res["ok"], res


@pytest.mark.parametrize("T,E,k,I", [(2048, 64, 6, 1408), (129, 64, 6, 1408),
                                     (300, 1, 1, 11264), (512, 1, 1, 2816)])
def test_grouped_moe_gemm_controls_and_bits(dev, T, E, k, I):
    """The grouped expert GEMM as chip_smoke.py phase 3 holds it: both
    products against their plain versions, an expert with no row and one
    with every token, bit-equal reruns, the controls missing."""
    gen = torch.Generator(device=dev).manual_seed(T)
    for name, cases in chip_smoke.check_moe(dev, gen, T=T, E=E, k=k,
                                            I=I).items():
        assert cases[0]["ok"], (name, cases[0])


def test_decoder_kernels_refuse_fp32_on_the_card(dev):
    """On CUDA tensors the grouped products and K3 at width 2048 launch
    their kernels or raise: fp32 rows take no plain path on the card."""
    from unimm_torch.ops import moe
    from unimm_torch.ops.xent_head import xent_head
    a = torch.randn(256, 2048, device=dev)
    off = moe.offsets(torch.tensor([128, 128], device=dev))
    with pytest.raises(ValueError):
        moe.grouped_swiglu(a, torch.randn(2, 2816, 2048, device=dev), *off)
    with pytest.raises(ValueError):
        moe.grouped_down(torch.randn(256, 1408, device=dev),
                         torch.randn(2, 2048, 1408, device=dev), *off)
    with pytest.raises(ValueError):
        xent_head(a, torch.randn(1024, 2048, device=dev), None,
                  torch.zeros(256, dtype=torch.long, device=dev))


def test_moe_kernels_fit_the_card(dev):
    from unimm_torch.ops import moe
    for mode in (0, 1):
        info = moe.kernel_info(mode)
        assert info["local_bytes"] == 0 and info["registers"] <= 168, info


@pytest.mark.parametrize("B,P,V", [(60, 160, 30522), (3, 43, 5000)])
def test_xent_train_controls_and_bits(dev, B, P, V):
    """The training cross-entropy's kernels as chip_smoke.py phase 3 holds
    them: nll, lse and the three gradients against the plain scan (the
    softmax term row by row too), reruns bit-equal, the shifted-label,
    dropped-tile and dropped-softmax controls missing on every output they
    move (``check_xent_train`` raises if one passes)."""
    gen = torch.Generator(device=dev).manual_seed(B)
    fwd, bwd = chip_smoke.check_xent_train(dev, gen, B=B, P=P, V=V)
    assert fwd["ok"] and bwd["ok"], (fwd, bwd)


def test_xent_train_refuses_wrong_dtype(dev):
    h = torch.randn(64, 768, device=dev)
    w = torch.randn(300, 768, device=dev, dtype=torch.bfloat16)
    b = torch.zeros(300, device=dev)
    lab = torch.zeros(64, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="must be bfloat16"):
        txt.xent_train_fwd(h, w, b, lab)
    with pytest.raises(ValueError, match="must be int32"):
        txt.xent_train_fwd(h.bfloat16(), w, b, lab.long())


def test_wrappers_refuse_wrong_dtype(dev):
    h = torch.randn(64, 768, device=dev)
    w = torch.randn(300, 768, device=dev, dtype=torch.bfloat16)
    lab = torch.zeros(64, dtype=torch.long, device=dev)
    with pytest.raises(ValueError, match="must be bfloat16"):
        txh.xent_head(h, w, torch.zeros(300, device=dev), lab)
    with pytest.raises(ValueError, match="must be float32"):
        txh.xent_head(h.bfloat16(), w, torch.zeros(300, device=dev,
                                                   dtype=torch.bfloat16), lab)


def test_prefix_scorer_through_the_kernels(dev):
    """Two text layers and one connection layer at full width: the scorer
    launches each kernel the expected number of times and its scores agree
    with its plain versions on the card."""
    from unimm_torch import workload
    from unimm_torch.eval.prefix import PrefixScorer

    cfg = VilbertConfig(num_hidden_layers=2, v_num_hidden_layers=1,
                        v_biattention_id=(0,), t_biattention_id=(1,))
    model = vilbert.init_model(cfg, seed=0, device=dev)
    batch = workload.make_val_batch(np.random.default_rng(0), cfg, B=1, R=4,
                                    O=20)
    counts = [f.launches for f in (tab.answer_block, tfb.ffn_block,
                                   txh.xent_head)]
    got, ok = PrefixScorer(cfg, group=4, device=dev).score(model, batch)
    after = [f.launches for f in (tab.answer_block, tfb.ffn_block,
                                  txh.xent_head)]
    assert ok.all()
    assert [a - c for a, c in zip(after, counts)] == [2, 3, 1]
    plain, _ = PrefixScorer(cfg.replace(attention_impl="xla"), group=4,
                            device=dev).score(model, batch)
    for k in ("ll_sum", "ll_mean"):
        assert np.isfinite(got[k]).all()
        np.testing.assert_allclose(got[k], plain[k], rtol=1e-2, atol=5e-2)


def test_flat_scorer_through_the_kernels(dev):
    """Two text layers and one connection layer at full width with
    ``fused_co``: the flat scorer launches the attention-block, FFN and
    co-attention kernels once per layer per chunk, and its NSP
    probabilities agree with the plain path on the card."""
    from unimm_torch import workload
    from unimm_torch.data.dataset import flatten_for_forward
    from unimm_torch.eval.evaluator import RankingEvaluator

    cfg = VilbertConfig(num_hidden_layers=2, v_num_hidden_layers=1,
                        v_biattention_id=(0,), t_biattention_id=(1,),
                        fused_co=True)
    model = vilbert.init_model(cfg, seed=0, device=dev)
    batch = workload.make_dis_batch(np.random.default_rng(1), cfg, B=1, R=2,
                                    O=50)
    flat = flatten_for_forward(batch, train=False, compact_images=True)
    fns = (tatb.attention_block, tfb.ffn_block, tco.co_text_block)
    counts = [f.launches for f in fns]
    got = RankingEvaluator(cfg, chunk_size=64, need_lm=False,
                           device=dev).score_flat(model, flat)
    chunks = 2                                  # 100 sequences in 64s
    assert [f.launches - c for f, c in zip(fns, counts)] == [
        2 * chunks, 3 * chunks, chunks]
    plain = RankingEvaluator(cfg.replace(attention_impl="xla"),
                             chunk_size=64, need_lm=False,
                             device=dev).score_flat(model, flat)
    assert np.isfinite(got["nsp_prob"]).all()
    # the plain path rounds to bf16 at other points; at full depth that
    # moves the NSP margin by ~1e-2 (chip_smoke.py phase 5), the
    # probability near 0.5 by a quarter of it
    np.testing.assert_allclose(got["nsp_prob"], plain["nsp_prob"],
                               rtol=0, atol=5e-3)


def _rel_err(got, want):
    """max |got - want| over max |want|, in fp32."""
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    return float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))


def _wide_attention(gen, dev):
    """A bf16 attention module with projections of std 0.05 and LayerNorm
    near (1, 0): the scores are O(1), so the softmax is far from uniform,
    and ctx Wo is O(1) against the residual, so the block's output reacts
    to its attention and dropout masks."""
    with torch.device(dev):
        m = vilbert._attention(768)
    with torch.no_grad():
        for lin in (m.self.query, m.self.key, m.self.value, m.output.dense):
            lin.weight.normal_(0.0, 0.05, generator=gen)
            lin.bias.normal_(0.0, 0.02, generator=gen)
        m.output.LayerNorm.weight.normal_(1.0, 0.1, generator=gen)
        m.output.LayerNorm.bias.normal_(0.0, 0.1, generator=gen)
    return m.to(torch.bfloat16).requires_grad_(False)


@pytest.mark.parametrize("L,drop", [(256, 0.1), (96, 0.1), (32, 0.0)])
def test_attention_block_train_matches_plain(dev, L, drop):
    """The training block's forward (y, ctx) and backward kernel (dx_qkv,
    dq, dk, dv) against their plain twins on the same bf16 inputs and the
    same Philox seed, with mixed descriptors and attention and hidden
    dropout: y within the eval block's bound; ctx and the backward's bf16
    outputs within 2% of their largest entry (they round P, dS and the
    outputs at the same points; only fp32 summation order differs). Under
    another Philox seed the same bounds must fail."""
    gen = torch.Generator(device=dev).manual_seed(L)
    B = 8
    attn = _wide_attention(gen, dev)
    ws = tuple(t.contiguous() for t in tab._weights(attn))
    x = torch.randn(B, L, 768, generator=gen, device=dev).bfloat16()
    desc = _mixed_desc(B, L, np.random.default_rng(L)).to(dev)
    m_o = ((torch.rand(B, L, 768, generator=gen, device=dev) > drop).float()
           / (1 - drop)) if drop else None
    kw = dict(num_heads=12, attn_drop=drop)
    n0 = tabt.attention_block_train_fwd.launches
    y, ctx = tabt.attention_block_train_fwd(x, desc, 77, m_o, *ws, **kw)
    assert tabt.attention_block_train_fwd.launches == n0 + 1
    y_p, ctx_p = tabt.attention_block_train_fwd_plain(x, desc, 77, m_o, *ws,
                                                      **kw)
    _close(y, y_p, 5e-2, 2e-2)
    assert _rel_err(ctx, ctx_p) <= 2e-2
    if drop:
        y_o, ctx_o = tabt.attention_block_train_fwd_plain(
            x, desc, 78, m_o, *ws, **kw)
        assert _rel_err(ctx, ctx_o) > 2e-2
        with pytest.raises(AssertionError):
            _close(y, y_o, 5e-2, 2e-2)
    dctx = torch.randn(B, L, 768, generator=gen, device=dev).bfloat16()
    n0 = tabt.attention_block_train_bwd.launches
    got = tabt.attention_block_train_bwd(x, dctx, desc, 77, *ws[:6], **kw)
    assert tabt.attention_block_train_bwd.launches == n0 + 1
    want = tabt.attention_block_train_bwd_plain(x, dctx, desc, 77, *ws[:6],
                                                **kw)
    for name, g, w in zip(("dx", "dq", "dk", "dv"), got, want):
        assert _rel_err(g, w) <= 2e-2, name


@pytest.mark.parametrize("drop", [0.1, 0.0])
def test_attention_block_train_fwd_masked_tails(dev, drop):
    """B5's forward on the masked tails at L 256: y within the eval
    block's bound, ctx within 2% of its largest entry; under another
    Philox seed ctx misses."""
    gen = torch.Generator(device=dev).manual_seed(4)
    B, L = 16, 256
    attn = _wide_attention(gen, dev)
    ws = tuple(t.contiguous() for t in tab._weights(attn))
    x = torch.randn(B, L, 768, generator=gen, device=dev).bfloat16()
    desc = chip_smoke.tail_desc(B, L, gen)
    m_o = ((torch.rand(B, L, 768, generator=gen, device=dev) > 0.1).float()
           / 0.9)
    kw = dict(num_heads=12, attn_drop=drop)
    n0 = tabt.attention_block_train_fwd.launches
    y, ctx = tabt.attention_block_train_fwd(x, desc, 77, m_o, *ws, **kw)
    assert tabt.attention_block_train_fwd.launches == n0 + 1
    y_p, ctx_p = tabt.attention_block_train_fwd_plain(x, desc, 77, m_o, *ws,
                                                      **kw)
    _close(y, y_p, 5e-2, 2e-2)
    assert _rel_err(ctx, ctx_p) <= 2e-2
    if drop:
        _, ctx_o = tabt.attention_block_train_fwd_plain(x, desc, 78, m_o,
                                                        *ws, **kw)
        assert _rel_err(ctx, ctx_o) > 2e-2


@pytest.mark.parametrize("L", [256, 96])
def test_attention_block_train_bwd_control_and_bits(dev, L):
    """The training block's backward kernel under attention dropout: the
    plain twin under another Philox seed misses the 2% bound for every
    output (the check sees the dropout mask), and two runs on the same
    inputs give the same bits (the attention backward sums every output
    in a fixed order, without atomics)."""
    gen = torch.Generator(device=dev).manual_seed(L + 3)
    B = 8
    attn = _wide_attention(gen, dev)
    ws = tuple(t.contiguous() for t in tab._weights(attn))
    x = torch.randn(B, L, 768, generator=gen, device=dev).bfloat16()
    dctx = torch.randn(B, L, 768, generator=gen, device=dev).bfloat16()
    desc = _mixed_desc(B, L, np.random.default_rng(L + 3)).to(dev)
    kw = dict(num_heads=12, attn_drop=0.1)
    got = tabt.attention_block_train_bwd(x, dctx, desc, 77, *ws[:6], **kw)
    again = tabt.attention_block_train_bwd(x, dctx, desc, 77, *ws[:6], **kw)
    want = tabt.attention_block_train_bwd_plain(x, dctx, desc, 77, *ws[:6],
                                                **kw)
    other = tabt.attention_block_train_bwd_plain(x, dctx, desc, 78, *ws[:6],
                                                 **kw)
    for name, g, a, w, o in zip(("dx", "dq", "dk", "dv"), got, again, want,
                                other):
        assert torch.equal(g, a), name
        assert _rel_err(g, w) <= 2e-2, name
        assert _rel_err(g, o) > 2e-2, name


def test_attention_block_train_autograd(dev):
    """The autograd Function on the card: its gradients of x and the ten
    weights against the same Function's plain path on the CPU (same bf16
    inputs, seed and masks)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    B, L = 4, 128
    attn = _wide_attention(gen, dev)
    x = torch.randn(B, L, 768, generator=gen, device=dev).bfloat16()
    desc = _mixed_desc(B, L, np.random.default_rng(3)).to(dev)
    m_o = (torch.rand(B, L, 768, generator=gen, device=dev) > 0.1).float() / 0.9
    dy = torch.randn(B, L, 768, generator=gen, device=dev).bfloat16()

    def grads(device):
        xs = x.to(device).requires_grad_()
        ws = [t.detach().to(device).requires_grad_()
              for t in tab._weights(attn)]
        y = tabt.AttentionBlockTrain.apply(
            xs, desc.to(device), 5, m_o.to(device), *ws, 12, 0.1, 1e-12)
        return torch.autograd.grad(y, [xs] + ws, dy.to(device))

    names = ["x", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "gamma",
             "beta"]
    for name, g, w in zip(names, grads(dev), grads("cpu")):
        # the key bias shifts every score of a row by the same amount, to
        # which the softmax is blind: its gradient is rounding noise
        if name != "bk":
            assert _rel_err(g.cpu(), w) <= 3e-2, name


def _block_calls(dev, B, L, seed):
    """One call each of B4, B5's forward with and without the
    hidden-dropout mask and B5's backward, on one set of bf16 inputs at
    weight std 0.05: {name: call}."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    attn = _wide_attention(gen, dev)
    ws = tuple(t.contiguous() for t in tab._weights(attn))
    x = torch.randn(B, L, 768, generator=gen, device=dev).bfloat16()
    dctx = torch.randn(B, L, 768, generator=gen, device=dev).bfloat16()
    desc = _mixed_desc(B, L, np.random.default_rng(seed)).to(dev)
    m_o = ((torch.rand(B, L, 768, generator=gen, device=dev) > 0.1).float()
           / 0.9)
    kw = dict(num_heads=12, attn_drop=0.1)
    return {
        "attention_block": lambda: (tatb.attention_block(
            x, desc, attn, num_heads=12),),
        "attention_block_train_fwd mo":
            lambda: tabt.attention_block_train_fwd(x, desc, 77, m_o, *ws,
                                                   **kw),
        "attention_block_train_fwd":
            lambda: tabt.attention_block_train_fwd(
                x, desc, 77, None, *ws, num_heads=12, attn_drop=0.0),
        "attention_block_train_bwd": lambda: tabt.attention_block_train_bwd(
            x, dctx, desc, 77, *ws[:6], **kw)}


@pytest.mark.parametrize("name", ["attention_block",
                                  "attention_block_train_fwd mo",
                                  "attention_block_train_fwd",
                                  "attention_block_train_bwd"])
def test_block_kernels_on_the_core_give_the_same_bits(dev, name):
    """B4 and B5 on the GEMM core (each tile's sums in one fixed order, no
    atomics): two runs on the same inputs give the same bits."""
    call = _block_calls(dev, 6, 160, 21)[name]
    for a, b in zip(call(), call()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("L", [64, 128, 256])
def test_attention_block_train_bwd_dx_at_morsel_lengths(dev, L):
    """B5's backward at the training morsels' lengths (64, 128 and 256
    tokens): dx_qkv, the GEMM core's K 2304 product, and dq, dk, dv within
    2% of their largest entry of the twin."""
    gen = torch.Generator(device=dev).manual_seed(L + 9)
    B = 60 if L < 256 else 12
    attn = _wide_attention(gen, dev)
    ws = tuple(t.contiguous() for t in tab._weights(attn))
    x = torch.randn(B, L, 768, generator=gen, device=dev).bfloat16()
    dctx = torch.randn(B, L, 768, generator=gen, device=dev).bfloat16()
    desc = chip_smoke.train_desc(B, L, gen)
    kw = dict(num_heads=12, attn_drop=0.1)
    got = tabt.attention_block_train_bwd(x, dctx, desc, 77, *ws[:6], **kw)
    want = tabt.attention_block_train_bwd_plain(x, dctx, desc, 77, *ws[:6],
                                                **kw)
    for name, g, w in zip(("dx", "dq", "dk", "dv"), got, want):
        assert _rel_err(g, w) <= 2e-2, name


def _launched(call, calls=3):
    """The names of the CUDA kernels ``calls`` calls launch, each once
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def _probe_calls(dev, B, L, seed):
    """One call of each mode of B10 and each layout of B11 on one set of
    bf16 inputs at weight std 0.05: {name: (call, GEMM-core instances it
    launches)}."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    attn = _wide_attention(gen, dev)
    padded = tbp.pad_heads_128(attn)
    x = torch.randn(B, L, 768, generator=gen, device=dev).bfloat16()
    desc = _mixed_desc(B, L, np.random.default_rng(seed)).to(dev)
    out = {f"probe_block {m}": (lambda m=m: tbp.probe_block(
        x, desc, attn, num_heads=12, softmax_mode=m), 2)
        for m in tbp.SOFTMAX_MODES}
    # wo_acc and transposed: the projection alone on the core
    out.update({f"layout_probe_block {lay}": (
        lambda lay=lay: tbp.layout_probe_block(
            x, desc, padded if lay == "pad128" else attn, num_heads=12,
            layout=lay), 2 if lay == "pad128" else 1)
        for lay in tbp.LAYOUTS})
    return out


# what the probes' wrappers launch: the wgmma + TMA GEMM core and its row
# LayerNorm, B4's one-pass attention and the probes' own attention kernels
PROBE_LAUNCHES = ("gemm_nt_wg_kernel", "ln_rows_kernel",
                  "seq_attn_fwd_kernel", "probe_attn_kernel",
                  "wo_acc_wg_kernel")


def test_block_wrappers_launch_only_the_gemm_core(dev):
    """B4's and B5's wrappers launch their products on the wgmma + TMA
    core, two instances each (Q/K/V and the output or dx epilogue); the
    probes B10 and B11 theirs too (one under wo_acc and transposed, whose
    own kernel holds the output product) and nothing but the core, its row
    LayerNorm and the attention kernels. No wrapper launches the first
    design's kernels (chip_smoke.FIRST_DESIGN), which no source defines."""
    calls = {name: (call, 2)
             for name, call in _block_calls(dev, 4, 128, 22).items()}
    probes = _probe_calls(dev, 4, 128, 22)
    calls.update(probes)
    for name, (call, n_core) in calls.items():
        names = _launched(call)
        assert not [n for n in names
                    if any(d in n for d in chip_smoke.FIRST_DESIGN)], \
            (name, names)
        if name in probes:
            assert all(any(k in n for k in PROBE_LAUNCHES) for n in names), \
                (name, names)
        wg = [n for n in names if "gemm_nt_wg_kernel" in n]
        assert len(wg) == n_core, (name, names)


@pytest.mark.parametrize("L", [96, 256])
def test_probe_full_equals_attention_block(dev, L):
    """B10 under ``full`` launches B4's kernels on B4's buffers: its output
    is attention_block's bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(L + 5)
    attn = _wide_attention(gen, dev)
    x = torch.randn(6, L, 768, generator=gen, device=dev).bfloat16()
    desc = _mixed_desc(6, L, np.random.default_rng(L)).to(dev)
    assert torch.equal(
        tbp.probe_block(x, desc, attn, num_heads=12, softmax_mode="full"),
        tatb.attention_block(x, desc, attn, num_heads=12))


def test_probe_kernels_fit_the_card(dev):
    """The probes' own kernels at L 256: no local memory (no spills), the
    register cap of their launch bounds, and at least one CTA an SM (the
    one-pass instances at heads of 64: B4's 72 KB and 2 CTAs or more)."""
    for name, info in tbp.kernel_info(256).items():
        assert info["local_bytes"] == 0, (name, info)
        assert info["ctas_per_sm"] >= 1, (name, info)
        if name.endswith(("none", "noshift")):
            assert info["registers"] <= 168, (name, info)
            assert info["smem_bytes"] == (2 * 256 + 64) * 128, (name, info)
            assert info["ctas_per_sm"] >= 2, (name, info)


@pytest.mark.parametrize("shape", [(30522, 768), (768,), (1001,), (3, 5)])
def test_adamw_matches_plain_bit_for_bit(dev, shape):
    gen = torch.Generator(device=dev).manual_seed(len(shape))

    def rnd(scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    g, p, mu, nu = rnd(1e-2), rnd(), rnd(1e-3), rnd(1e-5).abs()
    args = (2e-5, 0.01, 1.0 - 0.9 ** 3, 1.0 - 0.999 ** 3)
    want = tadam.adamw_update_leaf_plain(g, p, mu, nu, *args)
    n0 = tadam.adamw_update_leaf.launches
    got = tadam.adamw_update_leaf(g.clone(), p, mu.clone(), nu.clone(),
                                  *args)
    assert tadam.adamw_update_leaf.launches == n0 + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# B6 and B9 round at their plain twins' points; only fp32 summation order
# (and, in B6's backward, the hi + lo split of P and dS) differs: each
# output is held to TA_REL of its largest entry, and the plain twin under
# the descriptors with the mode flipped must miss that bound (chip_smoke.py
# states how the bound was read)
TA_REL = 1e-2


def _heads(B, L, gen, dev, split):
    """A [B, 12, L, 64] bf16 tensor: the head-split view of a [B, L, 768]
    tensor (as vilbert._split_heads gives it) or contiguous."""
    t = torch.randn(B, L, 768, generator=gen, device=dev).bfloat16()
    t = t.view(B, L, 12, 64).transpose(1, 2)
    return t if split else t.contiguous()


def _flip(desc):
    wrong = desc.clone()
    wrong[:, 0] = 1 - wrong[:, 0]
    return wrong


@pytest.mark.parametrize("L,split", [(256, True), (96, False), (32, True)])
def test_text_attention_matches_plain(dev, L, split):
    gen = torch.Generator(device=dev).manual_seed(L)
    B = 10
    q, k, v, do = (_heads(B, L, gen, dev, split) for _ in range(4))
    desc = _mixed_desc(B, L, np.random.default_rng(L)).to(dev)
    n0 = tta.text_attention_fwd.launches
    got = tta.text_attention_fwd(q, k, v, desc)
    assert tta.text_attention_fwd.launches == n0 + 1
    assert got.stride() == q.stride()
    assert _rel_err(got, tta.text_attention_fwd_plain(q, k, v, desc)) \
        <= TA_REL
    assert _rel_err(got, tta.text_attention_fwd_plain(q, k, v,
                                                      _flip(desc))) > TA_REL
    n0 = tta.text_attention_bwd.launches
    grads = tta.text_attention_bwd(q, k, v, desc, do)
    assert tta.text_attention_bwd.launches == n0 + 1
    want = tta.text_attention_bwd_plain(q, k, v, desc, do)
    wrong = tta.text_attention_bwd_plain(q, k, v, _flip(desc), do)
    for name, g, w, o in zip(("dq", "dk", "dv"), grads, want, wrong):
        assert _rel_err(g, w) <= TA_REL, name
        assert _rel_err(g, o) > TA_REL, name


def test_text_attention_autograd(dev):
    """TextAttention on the card against the same Function on the CPU
    (the plain twins) on the same bf16 inputs."""
    gen = torch.Generator(device=dev).manual_seed(7)
    B, L = 4, 128
    q, k, v, do = (_heads(B, L, gen, dev, True) for _ in range(4))
    desc = _mixed_desc(B, L, np.random.default_rng(7)).to(dev)

    def grads(device):
        ts = [t.detach().to(device).requires_grad_() for t in (q, k, v)]
        out = tta.text_attention(*ts, desc.to(device))
        return torch.autograd.grad(out, ts, do.to(device))

    for name, g, w in zip("qkv", grads(dev), grads("cpu")):
        assert _rel_err(g.cpu(), w) <= TA_REL, name


@pytest.mark.parametrize("block_b", [1, 3, 4])
def test_attention_v2_matches_plain(dev, block_b):
    gen = torch.Generator(device=dev).manual_seed(block_b)
    B, L = 6, 160
    q, k, v = (_heads(B, L, gen, dev, False) for _ in range(3))
    desc = _mixed_desc(B, L, np.random.default_rng(block_b)).to(dev)
    n0 = tav2.attention_v2.launches
    got = tav2.attention_v2(q, k, v, desc, block_b=block_b)
    assert tav2.attention_v2.launches == n0 + 1
    assert _rel_err(got, tav2.attention_v2_plain(q, k, v, desc)) <= TA_REL
    assert _rel_err(got, tav2.attention_v2_plain(q, k, v, _flip(desc))) \
        > TA_REL
    # at heads of 64 the scale is 2^-3: the per-head kernel's function
    assert torch.equal(got, tta.text_attention_fwd(q, k, v, desc))


@pytest.mark.parametrize("L,kind", [(160, "mixed"), (256, "tail")])
def test_text_attention_fwd_edges(dev, L, kind):
    """B6's forward where the one-pass kernel skips key chunks and weighs
    fully masked rows over every key: the edge descriptors at L 160 (a
    half key chunk) and the masked tails at L 256."""
    gen = torch.Generator(device=dev).manual_seed(L + 1)
    B = 12
    q, k, v = (_heads(B, L, gen, dev, True) for _ in range(3))
    desc = (_mixed_desc(B, L, np.random.default_rng(L + 1)).to(dev)
            if kind == "mixed" else chip_smoke.tail_desc(B, L, gen))
    got = tta.text_attention_fwd(q, k, v, desc)
    assert _rel_err(got, tta.text_attention_fwd_plain(q, k, v, desc)) \
        <= TA_REL
    assert _rel_err(got, tta.text_attention_fwd_plain(q, k, v,
                                                      _flip(desc))) > TA_REL


@pytest.mark.parametrize("L,kind", [(32, "mixed"), (160, "mixed"),
                                    (256, "tail")])
def test_text_attention_bwd_edges(dev, L, kind):
    """B6's backward where its kernels skip key chunks (the dq launch) and
    query chunks (the dk / dv launch) and weigh fully masked rows over
    every key: the edge descriptors at L 32 and 160 (a half chunk) and
    the masked tails at L 256; the control on the flipped descriptors;
    two runs give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(L + 2)
    B = 12
    q, k, v, do = (_heads(B, L, gen, dev, True) for _ in range(4))
    desc = (_mixed_desc(B, L, np.random.default_rng(L + 2)).to(dev)
            if kind == "mixed" else chip_smoke.tail_desc(B, L, gen))
    grads = tta.text_attention_bwd(q, k, v, desc, do)
    again = tta.text_attention_bwd(q, k, v, desc, do)
    want = tta.text_attention_bwd_plain(q, k, v, desc, do)
    wrong = tta.text_attention_bwd_plain(q, k, v, _flip(desc), do)
    for name, g, a, w, o in zip(("dq", "dk", "dv"), grads, again, want,
                                wrong):
        assert torch.equal(g, a), name
        assert _rel_err(g, w) <= TA_REL, name
        assert _rel_err(g, o) > TA_REL, name


@pytest.mark.parametrize("block_b", [1, 4, 8])
def test_attention_v2_masked_tails(dev, block_b):
    gen = torch.Generator(device=dev).manual_seed(block_b + 20)
    B, L = 16, 256
    q, k, v = (_heads(B, L, gen, dev, False) for _ in range(3))
    desc = chip_smoke.tail_desc(B, L, gen)
    got = tav2.attention_v2(q, k, v, desc, block_b=block_b)
    assert _rel_err(got, tav2.attention_v2_plain(q, k, v, desc)) <= TA_REL
    assert _rel_err(got, tav2.attention_v2_plain(q, k, v, _flip(desc))) \
        > TA_REL
    assert torch.equal(got, tta.text_attention_fwd(q, k, v, desc))


def test_fwd_kernel_fits_the_card(dev):
    """The one-pass kernel at L 256, in each of its instances (B6's
    forward, B9, B4, B5's forward with and without dropout): no local
    memory (no spills), the registers of __launch_bounds__(128, 3), 72 KB
    of shared memory (K, V and 64 query rows), and at least 2 CTAs an
    SM."""
    for info in (tta.fwd_kernel_info(256), tav2.kernel_info(256),
                 tatb.kernel_info(256),
                 *tabt.fwd_kernel_info(256).values()):
        assert info["local_bytes"] == 0, info
        assert info["registers"] <= 168, info
        assert info["smem_bytes"] == (2 * 256 + 64) * 128, info
        assert info["ctas_per_sm"] >= 2, info


def test_bwd_kernels_fit_the_card(dev):
    """The attention backward's two kernels at L 256, for B6 (hi + lo
    operands) and B5 (dropout): no local memory (no spills), the
    registers of __launch_bounds__(128, 3), and 3 CTAs an SM."""
    for infos in (tta.bwd_kernel_info(256), tabt.bwd_kernel_info(256)):
        for info in infos.values():
            assert info["local_bytes"] == 0, infos
            assert info["registers"] <= 168, infos
            assert info["smem_bytes"] <= 56 * 1024, infos
            assert info["ctas_per_sm"] >= 3, infos


def test_segment_embedding_gradient_is_deterministic(dev):
    """The segment table's gradient (``vilbert._FewRowEmbedding``) is the
    same on every run: 16384 bf16 hits on 2 rows, ten runs."""
    gen = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(0, 2, (64, 256), device=dev, generator=gen)
    g = torch.randn(64, 256, 768, device=dev, generator=gen).bfloat16()
    grads = []
    for _ in range(10):
        w = torch.zeros(2, 768, device=dev, requires_grad=True)
        vilbert._FewRowEmbedding.apply(ids, w.to(torch.bfloat16)).backward(g)
        grads.append(w.grad)
    assert all(torch.equal(x, grads[0]) for x in grads)


def test_attention_block_result_does_not_depend_on_block_b(dev):
    gen = torch.Generator(device=dev).manual_seed(11)
    B, L = 6, 160
    attn = _module(lambda: vilbert._attention(768), gen, dev)
    x = torch.randn(B, L, 768, generator=gen, device=dev).bfloat16()
    desc = _mixed_desc(B, L, np.random.default_rng(11)).to(dev)
    want = tatb.attention_block(x, desc, attn, num_heads=12)
    for block_b in (2, 3, 4):          # 4 lowers to 3, a divisor of 6
        got = tatb.attention_block(x, desc, attn, num_heads=12,
                                   block_b=block_b)
        assert torch.equal(got, want), block_b


# The probes round at B4's points (chip_smoke.py states the bound): y within
# B4's bound of the plain twin, NaN (noshift, on rows whose keys are all
# masked) at the same places; the control, the twin on the flipped
# descriptors (for skip, which ignores the mask, the full twin), must miss.
def _zero_scores(attn):
    """attn's weights with the query projection zeroed: every score is 0."""
    ps = attn.self
    q = SimpleNamespace(weight=torch.zeros_like(ps.query.weight),
                        bias=torch.zeros_like(ps.query.bias))
    return SimpleNamespace(self=SimpleNamespace(query=q, key=ps.key,
                                                value=ps.value),
                           output=attn.output)


def _probe_close(got, want):
    g, w = got.float(), want.float()
    assert torch.equal(g.isnan(), w.isnan())
    keep = ~g.isnan()
    _close(g[keep], w[keep], 5e-2, 2e-2)


@pytest.mark.parametrize("L", [96, 256])
@pytest.mark.parametrize("mode", ["full", "none", "noshift", "skip"])
def test_probe_block_matches_plain(dev, mode, L):
    gen = torch.Generator(device=dev).manual_seed(L)
    B = 6
    attn = _wide_attention(gen, dev)
    x = torch.randn(B, L, 768, generator=gen, device=dev).bfloat16()
    desc = _mixed_desc(B, L, np.random.default_rng(L)).to(dev)

    def plain(d, m=mode):
        return tbp.probe_block_plain(x, d, attn, num_heads=12,
                                     softmax_mode=m)

    n0 = tbp.probe_block.launches
    got = tbp.probe_block(x, desc, attn, num_heads=12, softmax_mode=mode)
    assert tbp.probe_block.launches == n0 + 1
    _probe_close(got, plain(desc))
    assert bool(got.isnan().any()) == (mode == "noshift")
    with pytest.raises(AssertionError):
        _probe_close(got, plain(desc, "full") if mode == "skip"
                     else plain(_flip(desc)))
    if mode == "skip":
        return
    # y hardly sees the context under none (p = s 1e-4): hold the context
    # itself, on open descriptors (a function of the scores alone), to
    # TA_REL of its largest entry; the twin without scores must miss it
    z = torch.zeros_like(desc)
    open_ = torch.stack([z[:, 0], z[:, 0] + L, z[:, 0]], -1)
    _, ctx = tbp.probe_block(x, open_, attn, num_heads=12, softmax_mode=mode,
                             return_ctx=True)
    assert _rel_err(ctx, tbp.probe_block_plain(
        x, open_, attn, num_heads=12, softmax_mode=mode,
        return_ctx=True)[1]) <= TA_REL
    assert _rel_err(ctx, tbp.probe_block_plain(
        x, open_, _zero_scores(attn), num_heads=12, softmax_mode=mode,
        return_ctx=True)[1]) > TA_REL


@pytest.mark.parametrize("L", [96, 256])
@pytest.mark.parametrize("layout", ["wo_acc", "transposed", "pad128"])
def test_layout_probe_block_matches_plain(dev, layout, L):
    gen = torch.Generator(device=dev).manual_seed(L + 1)
    B = 6
    attn = _wide_attention(gen, dev)
    p = tbp.pad_heads_128(attn) if layout == "pad128" else attn
    x = torch.randn(B, L, 768, generator=gen, device=dev).bfloat16()
    desc = _mixed_desc(B, L, np.random.default_rng(L)).to(dev)

    def plain(d):
        return tbp.layout_probe_block_plain(x, d, p, num_heads=12,
                                            layout=layout)

    n0 = tbp.layout_probe_block.launches
    got = tbp.layout_probe_block(x, desc, p, num_heads=12, layout=layout)
    assert tbp.layout_probe_block.launches == n0 + 1
    assert torch.isfinite(got).all()
    _probe_close(got, plain(desc))
    # B4's function: against B4's own kernel within the same bound
    _probe_close(got, tatb.attention_block(x, desc, attn, num_heads=12))
    with pytest.raises(AssertionError):
        _probe_close(got, plain(_flip(desc)))
