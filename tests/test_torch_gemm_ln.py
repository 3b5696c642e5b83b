"""The residual + LayerNorm that ends K2 (``ffn_block``: W2 + b2 +
residual + LayerNorm), B8 (``co_text_block``: dense2 + bd2 + residual +
LayerNorm2), B4 (``attention_block``: Wo + bo + residual + LayerNorm) and
B5's forward (``attention_block_train_fwd``: the same with the
hidden-dropout scale mask m_o) on the Hopper GEMM core (csrc/gemm_wg.cuh,
``launch_gemm_residual_ln`` / ``launch_gemm_ln``), emulated in plain
PyTorch in fp32 in the kernels' order of work: the product's epilogue
forms h = (acc + bias) + x in fp32 (``ResidualEpi``), or h = (acc + bias)
* m_o + x (``MaskedResidualEpi``, the order of the TPU kernel's
``_train_fwd_kernel``); ``ln_rows_kernel`` gives each row to a warp,
lane l adds its 24 columns l + 32 j in order of j, the warp's butterfly
(xor 16, 8, 4, 2, 1) adds the lanes; mean first, then the sum of squared
deviations from it (two passes); y = (h - mean) rsqrt(var + eps) gamma +
beta. (A tile that owns 64 rows and all 768 columns and runs the
LayerNorm on its accumulators lost to this route on an H100, PERF.md
section 6.) Held at full width against the plain twins (``ffn_block_plain``,
``co_text_block_plain``, ``attention_block_plain``,
``attention_block_train_fwd_plain``) and the JAX package's Pallas kernels
in interpret mode; a control with the one-pass variance E[h^2] - mean^2 on
rows offset by 1e3 must miss the bound the two-pass order holds there,
and one with m_o applied after the residual must miss the twin. The
attention blocks' wrappers take every (B, L) of the flat path and the
training morsels and refuse what the core does not take.
This is the algorithm's proof where there is no card; the kernels
themselves are held in tests/test_torch_cuda.py and chip_smoke.py."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unimm_torch.models.vilbert import ACT
from unimm_torch.ops import attention_block as tatb
from unimm_torch.ops import attention_block_train as tabt
from unimm_torch.ops import co_text_block as tco
from unimm_torch.ops import ffn_block as tfb
from unimm_tpu.ops import pallas_attention_v2 as pattn2

HID, INTER, BI = 768, 3072, 1024
LANES = 32                 # a row's warp
EPS = 1e-12
# fp32 on both sides, only the order of the sums differs: the emulation
# against the twins to 2e-5; against JAX, whose CPU products sum 1024-3072
# terms in another order, to 1e-4 (a few units of fp32 rounding of the
# pre-LayerNorm sum, magnified by rstd)
TOL_TWIN = dict(rtol=2e-5, atol=2e-5)
TOL_JAX = dict(rtol=1e-4, atol=1e-4)
# B8 against JAX: at weight std 0.05 the scores are O(3), and the softmax
# carries the two frameworks' fp32 rounding of q2 and k1 (~1e-6 relative)
# into the context; the plain twin itself reads up to 4.6e-4 from JAX at
# 64 regions on one thread: 1e-3
TOL_JAX_CO = dict(rtol=1e-3, atol=1e-3)


def _row_sums(v):
    """ln_row_store's sum over the 768 columns of each row of v [M, 768]:
    lane l adds columns l + 32 j in order of j, then the butterfly."""
    t = v.reshape(-1, HID // LANES, LANES)       # [M, j, lane]
    s = t[:, 0]
    for j in range(1, HID // LANES):
        s = s + t[:, j]
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, torch.arange(LANES) ^ o]
    return s[:, 0]


def ln_rows(h, gamma, beta, eps=EPS, one_pass=False):
    """ln_rows_kernel's LayerNorm of each row of h [M, 768] fp32;
    ``one_pass`` is the control's variance."""
    mean = _row_sums(h) / HID
    if one_pass:
        var = _row_sums(h * h) / HID - mean * mean
    else:
        var = _row_sums((h - mean[:, None]).square()) / HID
    rstd = torch.rsqrt(var + eps)
    return (h - mean[:, None]) * rstd[:, None] * gamma.float() + beta.float()


def residual_ln(a, w, bias, x, gamma, beta, eps=EPS, one_pass=False):
    """LN(fp32(a w^T) + bias + x) * gamma + beta as the residual epilogue
    and ln_rows_kernel take it, in fp32; ``one_pass`` is the control's
    variance."""
    shape = x.shape
    a = a.reshape(-1, a.shape[-1]).float()
    x = x.reshape(-1, HID).float()
    h = (a @ w.float().t() + bias.float()) + x
    return ln_rows(h, gamma, beta, eps, one_pass).reshape(shape)


def _linear(rng, n_out, n_in, std):
    w = rng.normal(0.0, std, (n_out, n_in)).astype(np.float32)
    return w, rng.normal(0.0, 0.02, n_out).astype(np.float32)


def _ln(rng, n):
    return (rng.normal(1.0, 0.1, n).astype(np.float32),
            rng.normal(0.0, 0.1, n).astype(np.float32))


def _ffn_weights(seed, std=0.05):
    rng = np.random.default_rng(seed)
    return (*_linear(rng, INTER, HID, std), *_linear(rng, HID, INTER, std),
            *_ln(rng, HID))


def _ffn_modules(w1, b1, w2, b2, g, be):
    t = torch.from_numpy
    p_inter = SimpleNamespace(dense=SimpleNamespace(weight=t(w1), bias=t(b1)))
    p_out = SimpleNamespace(dense=SimpleNamespace(weight=t(w2), bias=t(b2)),
                            LayerNorm=SimpleNamespace(weight=t(g),
                                                      bias=t(be)))
    jax_inter = {"dense": {"kernel": jnp.asarray(w1.T),
                           "bias": jnp.asarray(b1)}}
    jax_out = {"dense": {"kernel": jnp.asarray(w2.T), "bias": jnp.asarray(b2)},
               "LayerNorm": {"weight": jnp.asarray(g),
                             "bias": jnp.asarray(be)}}
    return p_inter, p_out, jax_inter, jax_out


def _ffn_emulated(x, p_inter, p_out, act, one_pass=False):
    h = ACT[act](x @ p_inter.dense.weight.t() + p_inter.dense.bias)
    return residual_ln(h, p_out.dense.weight, p_out.dense.bias, x,
                   p_out.LayerNorm.weight, p_out.LayerNorm.bias,
                   one_pass=one_pass)


@pytest.mark.parametrize("act", ["gelu", "relu", "swish"])
def test_ffn_residual_ln_order_matches_twin_and_jax(act):
    ws = _ffn_weights(1)
    p_inter, p_out, j_inter, j_out = _ffn_modules(*ws)
    x = np.random.default_rng(2).normal(size=(2, 16, HID)).astype(np.float32)
    xt = torch.from_numpy(x)
    got = _ffn_emulated(xt, p_inter, p_out, act)
    twin = tfb.ffn_block_plain(xt, p_inter, p_out, act=act)
    torch.testing.assert_close(got, twin, **TOL_TWIN)
    want = pattn2.fused_ffn_block(jnp.asarray(x), j_inter, j_out, act=act,
                                  interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_JAX)


def _co_modules(seed, std=0.05):
    rng = np.random.default_rng(seed)
    wq, bq = _linear(rng, BI, HID, std)
    wk, bk = _linear(rng, BI, BI, std)
    wv, bv = _linear(rng, BI, BI, std)
    wd, bd = _linear(rng, HID, BI, std)
    g, be = _ln(rng, HID)
    t = torch.from_numpy

    def lin(w, b):
        return SimpleNamespace(weight=t(w), bias=t(b))

    conn = SimpleNamespace(
        biattention=SimpleNamespace(query2=lin(wq, bq), key1=lin(wk, bk),
                                    value1=lin(wv, bv)),
        biOutput=SimpleNamespace(dense2=lin(wd, bd),
                                 LayerNorm2=SimpleNamespace(weight=t(g),
                                                            bias=t(be))))

    def jlin(w, b):
        return {"kernel": jnp.asarray(w.T), "bias": jnp.asarray(b)}

    jconn = {"biattention": {"query2": jlin(wq, bq), "key1": jlin(wk, bk),
                             "value1": jlin(wv, bv)},
             "biOutput": {"dense2": jlin(wd, bd),
                          "LayerNorm2": {"weight": jnp.asarray(g),
                                         "bias": jnp.asarray(be)}}}
    return conn, jconn


@pytest.mark.parametrize("R", [1, 37, 64])
def test_co_text_residual_ln_order_matches_twin_and_jax(R):
    """B8's dense2 + LayerNorm2 in the kernels' order on the twin's context,
    at 1, 37 and 64 regions, with every region of one sequence masked."""
    conn, jconn = _co_modules(3)
    rng = np.random.default_rng(R)
    B, L = 2, 16
    t_x = rng.normal(size=(B, L, HID)).astype(np.float32)
    v_x = rng.normal(size=(B, R, BI)).astype(np.float32)
    im = (rng.random((B, R)) > 0.3).astype(np.float32)
    im[1] = 0.0
    args = [torch.from_numpy(a) for a in (t_x, v_x, im)]
    ctx = tco.co_context_plain(*args, conn, num_heads=8)
    po = conn.biOutput
    got = residual_ln(ctx, po.dense2.weight, po.dense2.bias, args[0],
                  po.LayerNorm2.weight, po.LayerNorm2.bias)
    twin = tco.co_text_block_plain(*args, conn, num_heads=8)
    torch.testing.assert_close(got, twin, **TOL_TWIN)
    want = pattn2.fused_co_text_block(jnp.asarray(t_x), jnp.asarray(v_x),
                                      jnp.asarray(im), jconn, num_heads=8,
                                      interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_JAX_CO)


def test_one_pass_variance_misses_on_offset_rows():
    """Rows offset by 1e3 (through b2, so the spread of a row stays as it
    was): the two-pass order still holds the bound below; E[h^2] - mean^2
    loses the variance to fp32 cancellation and misses it."""
    w1, b1, w2, b2, g, be = _ffn_weights(4)
    p_inter, p_out, _, _ = _ffn_modules(w1, b1, w2, b2 + np.float32(1e3), g,
                                        be)
    x = np.random.default_rng(5).normal(size=(2, 16, HID)).astype(np.float32)
    xt = torch.from_numpy(x)
    twin = tfb.ffn_block_plain(xt, p_inter, p_out, act="gelu")
    # h near 1e3 carries fp32 steps of 2^-14 (6e-5), rounded at other
    # points on the two sides: 3e-4 (the two-pass order reads ~1e-4, the
    # one-pass ~5e-2)
    tol = dict(rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(_ffn_emulated(xt, p_inter, p_out, "gelu"),
                               twin, **tol)
    bad = _ffn_emulated(xt, p_inter, p_out, "gelu", one_pass=True)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(bad, twin, **tol)


def test_row_sums_add_each_column_once():
    """_row_sums adds exactly the 768 columns once each."""
    v = torch.zeros(3, HID)
    v[0, 5] = 1.0
    v[1] = torch.arange(HID, dtype=torch.float32)
    v[2, 256:512] = 2.0
    torch.testing.assert_close(_row_sums(v), torch.tensor(
        [1.0, HID * (HID - 1) / 2, 512.0]))


def test_ffn_wrapper_refuses_a_width_the_tile_does_not_take():
    """The first product's tiles are 256 columns wide: an intermediate
    width that is not a multiple raises before any launch; 3072 passes
    every check (meta tensors then stop at the device check)."""
    def meta_layer(inter):
        def lin(n_out, n_in):
            return SimpleNamespace(
                weight=torch.empty(n_out, n_in, dtype=torch.bfloat16,
                                   device="meta"),
                bias=torch.empty(n_out, dtype=torch.bfloat16, device="meta"))
        ln = SimpleNamespace(
            weight=torch.empty(HID, dtype=torch.bfloat16, device="meta"),
            bias=torch.empty(HID, dtype=torch.bfloat16, device="meta"))
        return (SimpleNamespace(dense=lin(inter, HID)),
                SimpleNamespace(dense=lin(HID, inter), LayerNorm=ln))

    x = torch.empty(2, 8, HID, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="% 256"):
        tfb.ffn_block(x, *meta_layer(3200))
    with pytest.raises(ValueError, match="unsupported device meta"):
        tfb.ffn_block(x, *meta_layer(INTER))


# --- B4 and B5's forward: the output side on the GEMM core ------------------

BLOCK_H = 12             # heads of 64 at the kernels' width


def _block_inputs(seed, B=2, L=32):
    """x, desc, the hidden-dropout scale mask m_o (rate 0.1) and the ten
    weights [out, in] (std 0.05, so that y sees its attention) of one
    attention sub-block at full width, from numpy."""
    rng = np.random.default_rng(seed)
    ws = []
    for _ in range(4):                     # query, key, value, output
        ws += _linear(rng, HID, HID, 0.05)
    ws += _ln(rng, HID)
    x = rng.normal(size=(B, L, HID)).astype(np.float32)
    desc = np.asarray([(0, L - 7, 0), (1, L - 4, 5)][:B], np.int32)
    m_o = ((rng.random((B, L, HID)) >= 0.1) / 0.9).astype(np.float32)
    return x, desc, m_o, ws


def _block_module(ws):
    t = torch.from_numpy

    def lin(i):
        return SimpleNamespace(weight=t(ws[i]), bias=t(ws[i + 1]))
    return SimpleNamespace(
        self=SimpleNamespace(query=lin(0), key=lin(2), value=lin(4)),
        output=SimpleNamespace(dense=lin(6), LayerNorm=SimpleNamespace(
            weight=t(ws[8]), bias=t(ws[9]))))


def block_out_ln(ctx, wo, bo, x, gamma, beta, m_o=None, mo_after=False):
    """The blocks' output side as the core's epilogue and ln_rows_kernel
    take it, in fp32: h = (ctx wo^T + bo) + x (``ResidualEpi``), or
    (ctx wo^T + bo) * m_o + x (``MaskedResidualEpi``); ``mo_after`` is the
    control, ((ctx wo^T + bo) + x) * m_o."""
    shape = x.shape
    acc = ctx.reshape(-1, HID).float() @ wo.float().t()
    x = x.reshape(-1, HID).float()
    h = acc + bo.float()
    if m_o is not None and not mo_after:
        h = h * m_o.reshape(-1, HID)
    h = h + x
    if m_o is not None and mo_after:
        h = h * m_o.reshape(-1, HID)
    return ln_rows(h, gamma, beta).reshape(shape)


def _block_case(seed, with_mo, mo_after=False):
    """(the emulated route, the plain twin, the fp32 tensors) of one
    case: B4 (``with_mo`` None), B5 with m_o (True) or without (False)."""
    x, desc, m_o, ws = _block_inputs(seed)
    xt, dt, mt = (torch.from_numpy(a) for a in (x, desc, m_o))
    tws = [torch.from_numpy(w) for w in ws]
    mo = mt if with_mo else None
    # the context of both blocks' twins (fp32: identical arithmetic)
    _, ctx = tabt.attention_block_train_fwd_plain(
        xt, dt, 0, None, *tws, num_heads=BLOCK_H, attn_drop=0.0)
    got = block_out_ln(ctx, tws[6], tws[7], xt, tws[8], tws[9], mo,
                       mo_after)
    if with_mo is None:
        twin = tatb.attention_block_plain(xt, dt, _block_module(ws),
                                          num_heads=BLOCK_H)
    else:
        twin, _ = tabt.attention_block_train_fwd_plain(
            xt, dt, 0, mo, *tws, num_heads=BLOCK_H, attn_drop=0.0)
    return got, twin, (x, desc, m_o, ws)


@pytest.mark.parametrize("with_mo", [None, True, False],
                         ids=["B4", "B5_mo", "B5_no_mo"])
def test_block_out_ln_order_matches_twin_and_jax(with_mo):
    """B4's and B5's forward output side in the new route's order on the
    twin's context, at full width, against the twins and JAX's
    fused_attention_block / fused_attention_block_train (attention
    dropout 0; m_o all ones where the torch side has none) in interpret
    mode."""
    got, twin, (x, desc, m_o, ws) = _block_case(11, with_mo)
    torch.testing.assert_close(got, twin, **TOL_TWIN)
    jx, jd = jnp.asarray(x), jnp.asarray(desc)
    if with_mo is None:
        def jlin(i):
            return {"kernel": jnp.asarray(ws[i].T),
                    "bias": jnp.asarray(ws[i + 1])}
        jp = {"self": {"query": jlin(0), "key": jlin(2), "value": jlin(4)},
              "output": {"dense": jlin(6),
                         "LayerNorm": {"weight": jnp.asarray(ws[8]),
                                       "bias": jnp.asarray(ws[9])}}}
        want = pattn2.fused_attention_block(jx, jd, jp, num_heads=BLOCK_H,
                                            interpret=True)
    else:
        jm = jnp.asarray(m_o if with_mo else np.ones_like(m_o))
        jw = [jnp.asarray(w.T if w.ndim == 2 else w) for w in ws]
        want = pattn2.fused_attention_block_train(
            BLOCK_H, 0.0, True, jx, jd, jnp.array([3], jnp.int32), jm, *jw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_JAX)


def test_block_mask_after_residual_misses():
    """The control: m_o applied after the residual instead of before it
    misses the twin's bound that the kernel's order holds."""
    got, twin, _ = _block_case(12, True, mo_after=True)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, twin, **TOL_TWIN)


def _meta_block(B, L, width=HID):
    """x, desc, the ten weights and dctx as meta tensors: the wrappers'
    checks run on them and stop at the device check."""
    def m(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, dtype=dtype, device="meta")
    ws = [m(width, HID), m(width), m(width, HID), m(width), m(width, HID),
          m(width), m(HID, width), m(HID), m(HID), m(HID)]
    return m(B, L, HID), m(B, 3, dtype=torch.int32), ws, m(B, L, HID)


def _block_wrappers(x, desc, ws, dctx):
    """Each block wrapper called on the tensors."""
    kw = dict(num_heads=BLOCK_H, attn_drop=0.1)
    return {
        "attention_block": lambda: tatb.attention_block(
            x, desc, _meta_module(ws), num_heads=BLOCK_H),
        "attention_block_train_fwd": lambda: tabt.attention_block_train_fwd(
            x, desc, 1, None, *ws, **kw),
        "attention_block_train_bwd": lambda: tabt.attention_block_train_bwd(
            x, dctx, desc, 1, *ws[:6], **kw)}


def _meta_module(ws):
    def lin(i):
        return SimpleNamespace(weight=ws[i], bias=ws[i + 1])
    return SimpleNamespace(
        self=SimpleNamespace(query=lin(0), key=lin(2), value=lin(4)),
        output=SimpleNamespace(dense=lin(6), LayerNorm=SimpleNamespace(
            weight=ws[8], bias=ws[9])))


# the rows of the paths' calls: the flat path's 256-row chunks, a split
# world's 128-row half chunks, short last chunks; the training batch (240),
# its morsels under accumulation (60, 80, 120), a data-parallel rank's
# (120, 50) and the dense step's (100)
PATH_ROWS = (1, 37, 50, 60, 80, 100, 120, 128, 240, 255, 256)


@pytest.mark.parametrize("L", range(32, 257, 32))
def test_block_wrappers_take_every_path_shape(L):
    """Every (B, L) the flat path and the training morsels give B4 and B5
    passes every check of their wrappers (meta tensors then stop at the
    device check), the GEMM core's rule included: M = B L >= 1, N 768,
    K 768 and 2304."""
    for B in PATH_ROWS:
        assert all(tatb.core_takes(B * L, N, K)
                   for N, K in tabt.BWD_PRODUCTS + tatb.BLOCK_PRODUCTS)
        for name, call in _block_wrappers(*_meta_block(B, L)).items():
            with pytest.raises(ValueError, match="unsupported device meta"):
                call()


@pytest.mark.parametrize("B,L,match", [
    (0, 64, "GEMM core does not take M 0"),
    (2, 48, "multiple of 32"), (2, 16, "multiple of 32"),
    (2, 288, "multiple of 32")])
def test_block_wrappers_refuse_what_the_kernels_do_not_take(B, L, match):
    """No rows (the core's M >= 1) and lengths the attention does not take
    are refused by each wrapper before any launch."""
    for name, call in _block_wrappers(*_meta_block(B, L)).items():
        with pytest.raises(ValueError, match=match):
            call()


@pytest.mark.parametrize("M,N,K", [(0, 768, 768), (64, 640, 768),
                                   (64, 768, 720), (64, 128, 768),
                                   (64, 768, 32)])
def test_core_rule_refuses_shapes_off_its_tiles(M, N, K):
    """The core's rule (``launch_gemm_nt_wg``'s) refuses no rows, a width
    that is not a multiple of 256 and a depth that is not one of 64."""
    assert not tatb.core_takes(M, N, K)
    assert tatb.core_takes(64, 768, 768) and tatb.core_takes(1, 768, 2304)
