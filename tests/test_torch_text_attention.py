"""The port's per-head text attention path (``attention_impl="pallas"``)
against the JAX package (CPU): the plain twins of the per-head kernel's
forward and backward and of ``attention_v2`` against the Pallas kernels in
interpret mode, autograd through ``TextAttention`` against ``jax.grad``,
the wrappers' refusals off the CPU, and the slice end to end at TINY
(``encode``, ``evaluate_split(mode="nsp")``, the prefix scorer, the
training dispatch) on weights moved with ``state_dict_from_jax``: the
slice adds no parameter, so the bridge is unchanged."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_common import TINY, TINY_T, jax_params, member, \
    torch_model
from tests.test_model import make_batch
from tests.test_torch_flat import _desc_sweep, _dis_loader
from tests.test_prefix import make_shared_batch
from tests.test_torch_train import NO_DROP, to_torch, train_batch
from unimm_torch.eval import evaluator as tev
from unimm_torch.eval import prefix as tpre
from unimm_torch.models import unimm as tu
from unimm_torch.models import vilbert as tv
from unimm_torch.ops import attention_v2 as tav2
from unimm_torch.ops import masks as tm
from unimm_torch.ops import text_attention as tta
from unimm_tpu.eval import evaluator as jev
from unimm_tpu.models import unimm as ju
from unimm_tpu.ops import pallas_attention as pattn
from unimm_tpu.ops import pallas_attention_v2 as pattn2

PALLAS_J = TINY.replace(attention_impl="pallas")
PALLAS_T = TINY_T.replace(attention_impl="pallas")
FP32 = dict(rtol=2e-5, atol=2e-6)
GRAD = dict(rtol=5e-4, atol=5e-5)      # tests/test_pallas_attention.py:54


def _inputs(L, dtype, H=2, D=16, seed=0):
    """q, k, v, do [B, H, L, D] (numpy, rounded to ``dtype``) and desc
    [B, 3]: the descriptors of tests/test_pallas_attention.py (a truncated
    generative row among them) and the mask tests' sweep at length L."""
    desc = np.concatenate([
        np.asarray([(0, 20, 0), (1, 15, 4), (1, 30, 6), (0, 8, 0)],
                   np.int32),
        _desc_sweep(L)])
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(len(desc), H, L, D)).astype(np.float32)
                   for _ in range(4))
    if dtype == "bfloat16":
        q, k, v, do = (np.asarray(jnp.asarray(t, jnp.bfloat16)
                                  .astype(jnp.float32)) for t in (q, k, v, do))
    return q, k, v, do, desc


def _closed_rows(desc, L):
    """[B, 1, L, 1] bool: the query rows that attend no key. Every score of
    such a row sits at s - 10000, where fp32's step is 2^-10, so a
    difference of 1e-7 in the order of a dot product's sums moves it by
    up to 1e-3: their outputs agree only to ~2^-10 of max |v|."""
    m = tm.text_attention_mask(*(torch.from_numpy(desc[:, i])
                                 for i in range(3)), L)
    return (~m.any(-1)).numpy()[:, None, :, None]


def _jax(t, dtype):
    return jnp.asarray(t, getattr(jnp, dtype))


def _torch(t, dtype):
    return torch.from_numpy(t).to(getattr(torch, dtype))


def _close(got, want, dtype, tol):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **tol)
    else:
        # bf16 outputs of the same arithmetic: the fp32 sums differ only in
        # order, which can move a bf16 rounding (of p, or of the output)
        # by one step: at most two bf16 steps of the largest output
        bound = 2.0 ** -7 * float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= bound


# --- the plain twins against the Pallas kernels ------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [32, 96])
def test_fwd_plain_matches_pallas(L, dtype):
    q, k, v, _, desc = _inputs(L, dtype)
    want = pattn.fused_text_attention(*(_jax(t, dtype) for t in (q, k, v)),
                                      jnp.asarray(desc), True)
    got = tta.text_attention(*(_torch(t, dtype) for t in (q, k, v)),
                             torch.from_numpy(desc))
    assert got.dtype == getattr(torch, dtype)
    closed = np.broadcast_to(_closed_rows(desc, L), got.shape)
    assert closed.any() and not closed.all()
    if dtype == "float32":
        w = np.asarray(want)
        g = got.numpy()
        np.testing.assert_allclose(g[~closed], w[~closed], **FP32)
        assert np.abs(g - w)[closed].max() <= 2.0 ** -9 * np.abs(v).max()
    else:
        _close(got, want, dtype, None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [32, 96])
def test_bwd_plain_matches_pallas(L, dtype):
    """The cotangent is zero on the rows that attend no key (see
    ``_closed_rows``), which would otherwise spread their ill-conditioned
    probabilities into every key's dk and dv; the autograd test below
    keeps them."""
    q, k, v, do, desc = _inputs(L, dtype, seed=1)
    do = np.where(_closed_rows(desc, L), 0.0, do).astype(np.float32)
    want = pattn._call_bwd(jnp.asarray(desc),
                           *(_jax(t, dtype) for t in (q, k, v, do)),
                           interpret=True)
    got = tta.text_attention_bwd(*(_torch(t, dtype) for t in (q, k, v)),
                                 torch.from_numpy(desc), _torch(do, dtype))
    for g, w in zip(got, want):
        _close(g, w, dtype, GRAD)


@pytest.mark.parametrize("L", [32, 96])
def test_autograd_matches_jax_grad(L):
    """sum(out ** 2) through TextAttention against jax.grad through
    fused_text_attention (its custom VJP)."""
    q, k, v, _, desc = _inputs(L, "float32", seed=2)

    def loss(q_, k_, v_):
        return jnp.sum(pattn.fused_text_attention(q_, k_, v_,
                                                  jnp.asarray(desc),
                                                  True) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = tta.text_attention(*ts, torch.from_numpy(desc))
    got = torch.autograd.grad((out ** 2).sum(), ts)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **GRAD)


@pytest.mark.parametrize("block_b", [1, 2, 4])
def test_attention_v2_plain_matches_pallas(block_b):
    q, k, v, _, desc = _inputs(32, "float32", seed=3)
    want = pattn2.attention_v2(*map(jnp.asarray, (q, k, v)),
                               jnp.asarray(desc), block_b=block_b,
                               interpret=True)
    got = tav2.attention_v2(*map(torch.from_numpy, (q, k, v)),
                            torch.from_numpy(desc), block_b=block_b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_attention_v2_rounds_q_where_the_per_head_kernel_does_not():
    """In bf16 at a head width whose scale is not a power of two (D 32),
    attention_v2's bf16(q scale) moves its output away from the per-head
    kernel's; each plain twin matches its own Pallas kernel. (At D 64 the
    scale is 2^-3 and the two functions agree.)"""
    q, k, v, _, desc = _inputs(32, "bfloat16", D=32, seed=4)
    jq, jk, jv = (_jax(t, "bfloat16") for t in (q, k, v))
    tq, tk, tv_ = (_torch(t, "bfloat16") for t in (q, k, v))
    v1 = tta.text_attention(tq, tk, tv_, torch.from_numpy(desc))
    v2 = tav2.attention_v2(tq, tk, tv_, torch.from_numpy(desc), block_b=2)
    _close(v1, pattn.fused_text_attention(jq, jk, jv, jnp.asarray(desc),
                                          True), "bfloat16", None)
    _close(v2, pattn2.attention_v2(jq, jk, jv, jnp.asarray(desc), block_b=2,
                                   interpret=True), "bfloat16", None)
    assert not torch.equal(v1, v2)


def test_wrappers_refuse_non_cpu_tensors():
    """Off the CPU the wrappers launch their kernel or raise: here (meta
    tensors) every argument check runs and the device check raises; a
    shape or type the kernels do not take is refused first."""
    def t(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    q = t(2, 12, 64, 64)
    desc = t(2, 3, dtype=torch.int32)
    cases = [((t(2, 12, 64, 32),) * 3, desc, "heads of 64"),
             ((t(2, 12, 48, 64),) * 3, desc, "multiple of 32"),
             ((q, q, t(2, 12, 64, 64, dtype=torch.float32)), desc,
              "must be bfloat16"),
             ((q, q, q), t(2, 3, dtype=torch.int64), "desc must be int32"),
             ((q, q, t(2, 12, 32, 64)), desc, "differs from q's"),
             ((q, q, q), desc, "unsupported device meta")]
    for (a, b, c), d, msg in cases:
        with pytest.raises(ValueError, match=msg):
            tta.text_attention_fwd(a, b, c, d)
        with pytest.raises(ValueError, match=msg):
            tav2.attention_v2(a, b, c, d)
    with pytest.raises(ValueError, match="unsupported device meta"):
        tta.text_attention_bwd(q, q, q, desc, q.transpose(1, 2).contiguous()
                               .transpose(1, 2))
    with pytest.raises(ValueError, match="block_b"):
        tav2.attention_v2(q, q, q, desc, block_b=0)


def test_same_layout_keeps_the_head_split_view():
    """The head-split view of a [B, L, H D] projection goes to the kernels
    as it is; another tensor is copied into q's strides, values kept."""
    x = torch.randn(2, 32, 4 * 64)
    q = tv._split_heads(x, 4)
    k = torch.randn(2, 4, 32, 64)
    q2, k2 = tta.same_layout(q, k)
    assert q2.data_ptr() == q.data_ptr() and k2.stride() == q.stride()
    assert torch.equal(k2, k)
    odd = torch.randn(2, 32, 64, 4).permute(0, 3, 1, 2)
    (o2,) = tta.same_layout(odd)
    assert o2.is_contiguous() and torch.equal(o2, odd)


# --- the slice end to end at TINY --------------------------------------------

def test_encode_matches_jax():
    b = make_batch(np.random.default_rng(0), TINY, B=3)
    b = {k: np.array(v) for k, v in b.items()}
    b["mode"][1], b["ans_len"][1] = 0, 0          # a dis row among gen rows
    b["ctx_end"][2] = 30                          # truncated masked copy
    got = tu.encode(torch_model(), PALLAS_T,
                    {k: torch.from_numpy(v) for k, v in b.items()},
                    dtype=torch.float32)
    want = jax.jit(lambda p, x: ju.encode(p, PALLAS_J, x, dtype=jnp.float32))(
        jax_params(), {k: jnp.asarray(v) for k, v in b.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5)


def test_evaluate_split_nsp_matches_jax():
    params, model = member(0, 0.2)
    loader = _dis_loader(10)
    ranks_t, ranks_j = [], []
    got = tev.evaluate_split(model, PALLAS_T, loader, mode="nsp",
                             chunk_size=16, dtype=torch.float32,
                             ranks_out=ranks_t, progress_every=0,
                             device="cpu")
    want = jev.evaluate_split(params, PALLAS_J, loader, mode="nsp",
                              chunk_size=16, dtype=jnp.float32,
                              ranks_out=ranks_j, progress_every=0)
    assert got.keys() == want.keys() and "ndcg" in got
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert ranks_t == ranks_j


def _forbid(monkeypatch, module, *names):
    """Replace kernel wrappers that ``module`` calls with ones that fail."""
    def refuse(*a, **kw):
        raise AssertionError("a kernel wrapper was called")
    for name in names:
        monkeypatch.setattr(module, name, refuse)


def test_prefix_scorer_is_plain_under_pallas(monkeypatch):
    """The JAX package gates the prefix scorer's kernels on "pallas_block"
    alone: under "pallas" the scorer runs its plain versions, calls no
    kernel wrapper, and its scores equal the "xla" scorer's."""
    batch = make_shared_batch(np.random.default_rng(1), TINY, B=2, R=3, O=6)
    kw = dict(dtype=torch.float32, group=8, device="cpu")
    want, ok_x = tpre.PrefixScorer(TINY_T, **kw).score(torch_model(), batch)
    _forbid(monkeypatch, tpre, "answer_block", "ffn_block", "xent_head")
    _forbid(monkeypatch, tu, "text_attention", "attention_block", "ffn_block",
            "attention_block_train", "co_text_block")
    got, ok_p = tpre.PrefixScorer(PALLAS_T, **kw).score(torch_model(), batch)
    assert ok_p.all() and (ok_p == ok_x).all()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pallas_trains_plain_under_attention_dropout(monkeypatch):
    """The port of tests/test_pallas_attention.py's dropout case: with
    attention dropout on, forward_train under "pallas" takes the plain bias
    path, launches no per-head kernel, and equals "xla" on the same
    DropoutRng seed."""
    b = to_torch(train_batch(np.random.default_rng(3), TINY))
    ct = PALLAS_T.replace(head_dropout_prob=0.1)
    assert ct.attention_probs_dropout_prob > 0

    def run(cfg):
        model = torch_model(cfg).train().requires_grad_(True)
        o = tu.forward_train(model, cfg, b, dtype=torch.float32,
                             rng=tv.DropoutRng(7, "cpu"))
        (o["lm"] + o["img"] + o["nsp"]).backward()
        return ({k: float(v.detach()) for k, v in o.items()},
                {n: p.grad for n, p in model.named_parameters()})

    want = run(ct.replace(attention_impl="xla"))
    _forbid(monkeypatch, tu, "text_attention")
    got = run(ct)
    assert got[0] == want[0]
    for n, g in want[1].items():
        assert (g is None and got[1][n] is None) or torch.equal(got[1][n], g)


def test_pallas_trains_through_the_kernel_at_attention_dropout_0(
        monkeypatch):
    """At attention dropout 0 every text layer's attention core goes
    through TextAttention: one call per text layer in the forward."""
    calls = []
    real = tu.text_attention

    def counting(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(tu, "text_attention", counting)
    ct = PALLAS_T.replace(**NO_DROP)
    b = to_torch(train_batch(np.random.default_rng(4), TINY))
    model = torch_model(ct).train().requires_grad_(True)
    o = tu.forward_train(model, ct, b, dtype=torch.float32)
    (o["lm"] + o["img"] + o["nsp"]).backward()
    assert len(calls) == TINY.num_hidden_layers
    g = model.bert.encoder.layer[0].attention.self.query.weight.grad
    assert g is not None and float(g.abs().max()) > 0


def test_bench_attn_runs_every_variant_on_cpu(capsys):
    """The bench's entry point at a small shape on the CPU (the plain
    twins): every variant reports a time."""
    from unimm_torch.tools import bench_attn
    res = bench_attn.main(["--device", "cpu", "--iters", "1", "--shape",
                           "2,2,32,64"])
    assert sorted(res) == sorted(bench_attn.VARIANTS)
    assert all(0 < r[1] <= r[0] <= r[2] for r in res.values())
    assert '"bench_attn"' in capsys.readouterr().out
