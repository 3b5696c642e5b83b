"""The plain versions of the port's three Hopper kernels against the JAX
package's Pallas kernels, run as the JAX suite runs them on the CPU
(``interpret=True``), in fp32 at small shapes; plus the wrappers' refusal
rules. The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py, and chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests._torch_common import TINY, jax_params, torch_model
from unimm_torch.ops import answer_block as tab
from unimm_torch.ops import ffn_block as tfb
from unimm_torch.ops import xent_head as txh
from unimm_torch.ops.masks import NEG_INF
from unimm_tpu.ops import pallas_attention_v2 as pattn2
from unimm_tpu.ops import pallas_head, pallas_prefix


def _answer_inputs(seed, G=2, P=128, RB=64, Lcb=32):
    rng = np.random.default_rng(seed)
    Hd = TINY.hidden_size
    x = rng.normal(size=(G, P, Hd)).astype(np.float32)
    kc = rng.normal(size=(G, Lcb, Hd)).astype(np.float32)
    vc = rng.normal(size=(G, Lcb, Hd)).astype(np.float32)
    lc = rng.integers(2, Lcb + 1, G)
    b_ctx = np.where((np.arange(Lcb) >= 1) & (np.arange(Lcb) < lc[:, None]),
                     0.0, NEG_INF).astype(np.float32)[:, None, :]
    opt = np.cumsum(rng.random((G, P // RB, RB)) < 0.2, -1)
    r = np.arange(RB)
    open_ = ((opt[..., :, None] == opt[..., None, :])
             & (r[None, :] <= r[:, None])) | np.eye(RB, dtype=bool)
    b_rr = np.where(open_, 0.0, NEG_INF).astype(np.float32)
    return x, kc, vc, b_ctx, b_rr


@pytest.mark.parametrize("RB,Lcb", [(64, 32), (128, 64)])
def test_answer_block_plain_matches_pallas(RB, Lcb):
    x, kc, vc, b_ctx, b_rr = _answer_inputs(RB, P=256, RB=RB, Lcb=Lcb)
    layer = 1
    want = pallas_prefix.fused_answer_block(
        jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(b_ctx),
        jnp.asarray(b_rr),
        jax_params()["bert"]["encoder"]["layer"][str(layer)]["attention"],
        num_heads=TINY.num_attention_heads, interpret=True)
    attn = torch_model().bert.encoder.layer[layer].attention
    args = [torch.from_numpy(a) for a in (x, kc, vc, b_ctx, b_rr)]
    got = tab.answer_block(*args, attn, num_heads=TINY.num_attention_heads)
    plain = tab.answer_block_plain(*args, attn,
                                   num_heads=TINY.num_attention_heads)
    assert torch.equal(got, plain)       # a CPU tensor takes the plain path
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-6)


@pytest.mark.parametrize("act", ["gelu", "relu", "swish"])
def test_ffn_block_plain_matches_pallas(act):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 64, TINY.hidden_size)).astype(np.float32)
    jl = jax_params()["bert"]["encoder"]["layer"]["0"]
    want = pattn2.fused_ffn_block(jnp.asarray(x), jl["intermediate"],
                                  jl["output"], act=act, interpret=True)
    tl = torch_model().bert.encoder.layer[0]
    got = tfb.ffn_block(torch.from_numpy(x), tl.intermediate, tl.output,
                        act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-6)


@pytest.mark.parametrize("M,V,block_m,block_v", [
    (40, 517, 16, 256),      # both axes ragged against the Pallas blocks
    (7, 300, 256, 128),      # fewer rows than one block
])
def test_xent_head_plain_matches_pallas(M, V, block_m, block_v):
    rng = np.random.default_rng(0)
    h = rng.normal(size=(M, 64)).astype(np.float32)
    w = (rng.normal(size=(V, 64)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(V,)) * 0.1).astype(np.float32)
    lab = rng.integers(-1, V, size=(M,)).astype(np.int32)
    lab[rng.random(M) < 0.3] = -1
    lab[0], lab[1] = V - 1, 0          # the vocab tail and head
    want = pallas_head.online_softmax_xent_tpu(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), jnp.asarray(lab),
        block_m=block_m, block_v=block_v, interpret=True)
    got = txh.xent_head(torch.from_numpy(h), torch.from_numpy(w),
                        torch.from_numpy(b), torch.from_numpy(lab))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert (got.numpy()[lab == -1] == 0).all()
    small = txh.xent_head_plain(torch.from_numpy(h), torch.from_numpy(w),
                                torch.from_numpy(b), torch.from_numpy(lab),
                                chunk=128)     # the vocab scan in chunks
    np.testing.assert_allclose(small.numpy(), got.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_block_rr_bias_and_pick_o_blk_match_jax():
    rng = np.random.default_rng(1)
    rr_open = rng.integers(0, 2, (2, 6, 4, 4)).astype(bool)
    np.testing.assert_array_equal(
        tab.block_rr_bias(torch.from_numpy(rr_open), 3).numpy(),
        np.asarray(pallas_prefix.block_rr_bias(jnp.asarray(rr_open), 3)))
    for O, W in ((100, 16), (100, 32), (6, 16), (7, 256), (100, 256)):
        assert tab.pick_o_blk(O, W) == pallas_prefix.pick_o_blk(O, W)


# --- the wrappers never take the plain path off the CPU ---------------------

def _bf16_meta_modules():
    model = torch_model().to(torch.bfloat16).to("meta")
    return model.bert.encoder.layer[0]


def test_wrappers_refuse_non_cpu_tensors():
    """Tensors off the CPU either launch the kernel or raise: here (meta
    tensors) every argument check runs and the device check raises; a
    wrong dtype or width is refused first."""
    layer = _bf16_meta_modules()
    x = torch.empty(2, 256, TINY.hidden_size, dtype=torch.bfloat16,
                    device="meta")
    with pytest.raises(ValueError, match="built for width 768"):
        tfb.ffn_block(x, layer.intermediate, layer.output)
    with pytest.raises(ValueError, match="built for width 768"):
        tab.answer_block(x, x[:, :32], x[:, :32],
                         torch.empty(2, 1, 32, device="meta"),
                         torch.empty(2, 4, 64, 64, device="meta"),
                         layer.attention, num_heads=2)
    h = torch.empty(10, 768, dtype=torch.bfloat16, device="meta")
    w = torch.empty(50, 768, dtype=torch.bfloat16, device="meta")
    lab = torch.zeros(10, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        txh.xent_head(h, w, torch.empty(50, device="meta"), lab)
    with pytest.raises(ValueError, match="must be float32"):
        txh.xent_head(h, w, torch.empty(50, dtype=torch.bfloat16,
                                        device="meta"), lab)
    with pytest.raises(ValueError, match="must be bfloat16"):
        txh.xent_head(h.float(), w, torch.empty(50, device="meta"), lab)

