"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same bf16 inputs, at the kernels' width (768) and small
batches, plus the wrappers' refusals and a short prefix-scorer run through
all three kernels. Every test needs a CUDA device and skips without one.

This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from unimm_torch.config import VilbertConfig
from unimm_torch.models import vilbert
from unimm_torch.ops import answer_block as tab
from unimm_torch.ops import ffn_block as tfb
from unimm_torch.ops import xent_head as txh
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
