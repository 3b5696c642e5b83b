"""The plain versions of the port's Hopper kernels against the JAX
package's Pallas kernels, run as the JAX suite runs them on the CPU
(``interpret=True``), in fp32 at small shapes; the Philox dropout bits;
plus the wrappers' refusal rules. The CUDA kernels themselves run only on
the card (tests/test_torch_cuda.py, and chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_common import TINY, jax_params, torch_model
from unimm_torch.ops import adamw as tadam
from unimm_torch.ops import answer_block as tab
from unimm_torch.ops import attention_block_train as tabt
from unimm_torch.ops import ffn_block as tfb
from unimm_torch.ops import xent_head as txh
from unimm_torch.ops import philox
from unimm_torch.ops.masks import NEG_INF
from unimm_tpu.models import vilbert as jv
from unimm_tpu.ops import pallas_attention_v2 as pattn2
from unimm_tpu.ops import pallas_head, pallas_optim, pallas_prefix


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


# --- the training attention block (B5) --------------------------------------

def _train_block_inputs(B, H, L, D, seed):
    rng = np.random.default_rng(seed)
    Hd = H * D
    x = rng.normal(size=(B, L, Hd)).astype(np.float32)
    mode = rng.integers(0, 2, B).astype(np.int32)
    ctx = rng.integers(4, L - 2, B).astype(np.int32)
    ans = np.where(mode == 1, rng.integers(1, L // 4, B), 0).astype(np.int32)
    mode[0], ctx[0], ans[0] = 1, L - 3, 5          # truncated gen layout
    desc = np.stack([mode, ctx, ans], -1)
    m_o = ((rng.random((B, L, Hd)) > 0.2) / 0.8).astype(np.float32)
    p = jax.tree_util.tree_map(np.asarray, jv._init_attention(
        jax.random.PRNGKey(seed), Hd, 0.2))
    p["output"]["LayerNorm"]["weight"] = (
        1 + 0.1 * rng.normal(size=Hd)).astype(np.float32)
    for name in ("query", "key", "value"):
        p["self"][name]["bias"] = (0.1 * rng.normal(size=Hd)).astype(
            np.float32)
    ps, po = p["self"], p["output"]
    jw = [ps["query"]["kernel"], ps["query"]["bias"], ps["key"]["kernel"],
          ps["key"]["bias"], ps["value"]["kernel"], ps["value"]["bias"],
          po["dense"]["kernel"], po["dense"]["bias"],
          po["LayerNorm"]["weight"], po["LayerNorm"]["bias"]]
    # torch Linear layout: [out, in]
    tw = [torch.from_numpy(np.ascontiguousarray(w.T if w.ndim == 2 else w))
          for w in jw]
    return x, desc, m_o, jw, tw


@pytest.mark.parametrize("shape", [(3, 2, 32, 16), (2, 4, 64, 16),
                                   (5, 2, 48, 32)])
def test_attention_block_train_plain_matches_pallas(shape):
    """The Function's CPU path (the plain twins) against JAX
    fused_attention_block_train in interpret mode, attention dropout 0 and
    a random hidden-dropout mask: y and the gradients of x and all ten
    weights."""
    B, H, L, D = shape
    x, desc, m_o, jw, tw = _train_block_inputs(B, H, L, D, L + H)
    jx, jd, jm = jnp.asarray(x), jnp.asarray(desc), jnp.asarray(m_o)
    seed = jnp.array([3], jnp.int32)

    def jloss(x_, *ws):
        y = pattn2.fused_attention_block_train(H, 0.0, True, x_, jd, seed,
                                               jm, *ws)
        return jnp.sum(y * jnp.sin(y)), y

    (_, jy), jg = jax.value_and_grad(jloss, argnums=tuple(range(11)),
                                     has_aux=True)(jx, *map(jnp.asarray, jw))
    tx = torch.from_numpy(x).requires_grad_()
    tws = [w.clone().requires_grad_() for w in tw]
    y = tabt.AttentionBlockTrain.apply(tx, torch.from_numpy(desc), 3,
                                       torch.from_numpy(m_o), *tws, H, 0.0,
                                       1e-12)
    tg = torch.autograd.grad((y * torch.sin(y)).sum(), [tx] + tws)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=5e-5, atol=5e-5)
    for i, (a, b) in enumerate(zip(tg, jg)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b.T if b.ndim == 2 and i else b,
                                   rtol=5e-5, atol=5e-5, err_msg=str(i))


def test_attention_block_train_backward_matches_autograd_with_dropout():
    """With attention dropout 0.3 (port only: the TPU's bits cannot be
    reproduced) the Function's backward equals autograd through the plain
    forward with the same Philox mask."""
    B, H, L, D = 3, 2, 32, 16
    x, desc, m_o, _, tw = _train_block_inputs(B, H, L, D, 11)
    args = (torch.from_numpy(desc), 99, torch.from_numpy(m_o))

    def grads(fn):
        tx = torch.from_numpy(x).requires_grad_()
        tws = [w.clone().requires_grad_() for w in tw]
        y = fn(tx, tws)
        return torch.autograd.grad((y * torch.sin(y)).sum(), [tx] + tws)

    got = grads(lambda tx, ws: tabt.AttentionBlockTrain.apply(
        tx, *args, *ws, H, 0.3, 1e-12))
    want = grads(lambda tx, ws: tabt.attention_block_train_fwd_plain(
        tx, *args, *ws, num_heads=H, attn_drop=0.3)[0])
    names = ["x", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "gamma",
             "beta"]
    for name, a, b in zip(names, got, want):
        # the key bias's gradient is zero up to rounding (the softmax is
        # blind to a shift of a whole row): held absolutely
        atol = 1e-5 * float(b.abs().max()) if name != "bk" else 1e-5
        torch.testing.assert_close(a, b, rtol=1e-5, atol=atol, msg=name)


def test_philox_known_answer_and_mask_statistics():
    """Philox4x32-10's known-answer vector (Random123, counter and key all
    zero); the keep share of a [64, 256, 256] draw within 4 sigma of 0.7;
    one (seed, tag) gives one mask, another tag another."""
    words = philox.philox4x32_10(0, 0, 0, 0, 0, 0)
    assert [int(w) for w in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                       0x9B00DBD8]
    m = philox.prob_mask(123, torch.arange(64), 256, 0.3)
    n = m.numel()
    share = float((m > 0).float().mean())
    assert abs(share - 0.7) <= 4 * (0.7 * 0.3 / n) ** 0.5
    assert set(torch.unique(m).tolist()) == {0.0, np.float32(1 / 0.7)}
    assert torch.equal(m[5], philox.prob_mask(123, 5, 256, 0.3))
    assert not torch.equal(m[5], m[6])
    assert not torch.equal(m[5], philox.prob_mask(124, 5, 256, 0.3))


# --- the fused AdamW (B7) ----------------------------------------------------

@pytest.mark.parametrize("shape", [(1000,), (37, 50)])
def test_adamw_plain_matches_pallas(shape):
    """The plain twin against JAX adamw_update_leaf in interpret mode:
    each output within a few ulps (2^-21) of the terms of its last sum,
    the update also of what the moments' rounding moves. XLA on the CPU
    contracts ``a * b + c`` into a fused multiply-add (one rounding where
    the twin, like the CUDA kernel, takes two), so where a sum cancels a
    difference of one ulp of a term is many ulps of the result."""
    rng = np.random.default_rng(len(shape))
    g = (rng.normal(size=shape) * 1e-2).astype(np.float32)
    p = rng.normal(size=shape).astype(np.float32)
    mu = (rng.normal(size=shape) * 1e-3).astype(np.float32)
    nu = np.abs(rng.normal(size=shape) * 1e-5).astype(np.float32)
    lr, wd = np.float32(3e-4), 0.01
    bc1 = np.float32(1) - np.float32(0.9) ** np.float32(4)
    bc2 = np.float32(1) - np.float32(0.999) ** np.float32(4)
    want = pallas_optim.adamw_update_leaf(
        *map(jnp.asarray, (g, p, mu, nu)), lr, wd, bc1, bc2, interpret=True)
    tg, tmu, tnu = (torch.from_numpy(a.copy()) for a in (g, mu, nu))
    got = tadam.adamw_update_leaf(tg, torch.from_numpy(p), tmu, tnu,
                                  float(lr), wd, float(bc1), float(bc2))
    assert got[0] is tg and got[1] is tmu      # written in place
    u, mu2, nu2 = (t.numpy().astype(np.float64) for t in got)
    f = np.float32
    den = np.sqrt(nu2 / bc2) + 1e-6
    direction = (mu2 / bc1) / den
    s_mu = np.abs(f(0.9) * mu) + np.abs(f(1 - 0.9) * g)
    s_nu = np.abs(f(0.999) * nu) + np.abs(f(1 - 0.999) * g * g)
    # the update's terms, and how far the moments' one ulp moves them
    s_u = lr * (np.abs(direction) + np.abs(wd * p) + s_mu / bc1 / den
                + np.abs(direction) * s_nu / nu2)
    for a, b, scale in zip((u, mu2, nu2), want, (s_u, s_mu, s_nu)):
        b = np.asarray(b)
        np.testing.assert_array_less(np.abs(a - b),
                                     2.0 ** -21 * scale + np.spacing(b))


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
    ws = tab._weights(layer.attention)
    desc = torch.zeros(2, 3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="built for width 768"):
        tabt.attention_block_train_fwd(x, desc, 0, None, *ws, num_heads=2,
                                       attn_drop=0.1)
    with pytest.raises(ValueError, match="built for width 768"):
        tabt.attention_block_train_bwd(x, x, desc, 0, *ws[:6], num_heads=2,
                                       attn_drop=0.1)
    v = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        tadam.adamw_update_leaf(v, v, v, v, 1e-3, 0.0, 0.1, 0.001)
    with pytest.raises(ValueError, match="must be float32"):
        tadam.adamw_update_leaf(v.bfloat16(), v, v, v, 1e-3, 0.0, 0.1, 0.001)

