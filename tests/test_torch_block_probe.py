"""The attention-block bench's probes and B4's block_b against the JAX
package (CPU): the plain twins of ``ops/block_probe.py`` against the TPU
probe kernels of scripts/bench_attn_block.py run in interpret mode, B4 at
block_b 2 against ``fused_attention_block``, ``pad_heads_128`` against the
script's ``pad_cols``, the wrappers' refusals off the CPU and the bench
tool on the CPU.

The script keeps its shape in module constants and calls ``pallas_call``
without ``interpret``: each test loads it with importlib, sets the
constants to a small shape (heads of 64, width 128) and gives it a ``pl``
whose ``pallas_call`` interprets. Nothing in scripts/ changes. The probes
add no parameter: the weights cross with ``state_dict_from_jax``."""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from unimm_torch.checkpoint import state_dict_from_jax
from unimm_torch.models import vilbert as tv
from unimm_torch.ops import attention_block as tatb
from unimm_torch.ops import block_probe as tbp
from unimm_torch.ops import masks as tm
from unimm_tpu.ops import pallas_attention_v2 as pattn2

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / \
    "bench_attn_block.py"
H, D = 2, 64
HID = H * D
FP32 = dict(rtol=2e-5, atol=2e-6)
PROBES = {"none": "probe_nosoftmax", "skip": "probe_projonly",
          "noshift": "probe_noshift", "full": "probe_softmax"}
LAYOUTS = {"transposed": "probe_transposed", "wo_acc": "probe_wo_acc",
           "pad128": "probe_pad128"}


@functools.lru_cache(maxsize=None)
def _script():
    spec = importlib.util.spec_from_file_location("bench_attn_block_script",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Interpret:
    """The script's ``pl`` with ``pallas_call`` in interpret mode."""
    pallas_call = staticmethod(functools.partial(pl.pallas_call,
                                                 interpret=True))

    def __getattr__(self, name):
        return getattr(pl, name)


@pytest.fixture
def script(monkeypatch):
    mod = _script()
    monkeypatch.setattr(mod, "pl", _Interpret())
    monkeypatch.setattr(mod, "H", H)
    monkeypatch.setattr(mod, "D", D)
    monkeypatch.setattr(mod, "HID", HID)
    return mod


def _run(script, monkeypatch, variant, p, x, desc):
    """The script's variant at x's shape on JAX arrays (numpy out)."""
    monkeypatch.setattr(script, "B", x.shape[0])
    monkeypatch.setattr(script, "L", x.shape[1])
    out = script.VARIANTS[variant](p, jnp.asarray(x),
                                   *map(jnp.asarray, desc.T))
    return np.asarray(jnp.asarray(out, jnp.float32))


def _desc(L):
    """A discriminative sequence at full length, one with fully masked
    rows past a short extent, a generative one, and a generative one
    whose masked copy is truncated at L."""
    return np.asarray([(0, L, 0), (0, 20, 0), (1, 30, 5), (1, L - 2, 4)],
                      np.int32)


def _weights(seed, dtype="float32"):
    """A JAX attention subtree (numpy leaves) of width HID: projections of
    std 0.1 (scores of O(1), so the softmax and the mask matter), small
    biases, LayerNorm near (1, 0); rounded to ``dtype``."""
    rng = np.random.default_rng(seed)

    def lin():
        return {"kernel": rng.normal(0, 0.1, (HID, HID)),
                "bias": rng.normal(0, 0.02, HID)}

    p = {"self": {"query": lin(), "key": lin(), "value": lin()},
         "output": {"dense": lin(),
                    "LayerNorm": {"weight": rng.normal(1, 0.1, HID),
                                  "bias": rng.normal(0, 0.1, HID)}}}
    return jax.tree_util.tree_map(lambda a: _round(a, dtype), p)


def _round(a, dtype):
    """``a`` rounded to ``dtype``, as fp32 numpy."""
    return np.asarray(jnp.asarray(jnp.asarray(a, getattr(jnp, dtype)),
                                  jnp.float32))


def _port(p, dtype):
    attn = tv._attention(HID)
    attn.load_state_dict(state_dict_from_jax(p), strict=True)
    return attn.to(getattr(torch, dtype)).requires_grad_(False)


def _inputs(L, dtype, seed=0):
    x = np.random.default_rng(100 + seed).normal(size=(4, L, HID))
    return _round(x, dtype), _desc(L), _weights(seed, dtype)


def _closed(desc, L):
    """[B, L, 1] bool: the query rows that attend no key."""
    m = tm.text_attention_mask(*(torch.from_numpy(desc[:, i])
                                 for i in range(3)), L)
    return (~m.any(-1)).numpy()[..., None]


def _port_probe(kind, attn, x, desc, dtype):
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    d = torch.from_numpy(desc)
    if kind in PROBES:
        out = tbp.probe_block(t, d, attn, num_heads=H, softmax_mode=kind)
    else:
        p = tbp.pad_heads_128(attn) if kind == "pad128" else attn
        out = tbp.layout_probe_block(t, d, p, num_heads=H, layout=kind)
    assert out.dtype == t.dtype
    return out.float().numpy()


def _jax_params(p, dtype):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, getattr(jnp, dtype)), p)


@pytest.mark.parametrize("L", [64, 96])
@pytest.mark.parametrize("kind", [*PROBES, *LAYOUTS])
def test_plain_twin_matches_jax_probe(script, monkeypatch, kind, L):
    """fp32: every entry to FP32, NaN at the same places (noshift: the rows
    whose keys are all masked, 0 / 0 in both), except the closed rows'
    finite entries: their scores sit at s - 10000, where fp32's step is
    2^-10, so the order of a dot product's sums moves their softmax by up
    to ~1e-3 relative; they are held to 2e-4 absolute (the LayerNorm
    output is O(1); the largest reading here was 5.1e-5)."""
    x, desc, p = _inputs(L, "float32")
    want = _run(script, monkeypatch, {**PROBES, **LAYOUTS}[kind],
                _jax_params(p, "float32"), x, desc)
    got = _port_probe(kind, _port(p, "float32"), x, desc, "float32")
    closed = np.broadcast_to(_closed(desc, L), got.shape)
    assert closed.any() and not closed.all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if kind == "noshift":
        assert np.isnan(got).all(-1).sum() == closed[..., 0].sum() > 0
    else:
        assert np.isfinite(got).all()
    open_ = ~closed & ~np.isnan(want)
    np.testing.assert_allclose(got[open_], want[open_], **FP32)
    shut = closed & ~np.isnan(want)
    if shut.any():
        np.testing.assert_allclose(got[shut], want[shut], rtol=0, atol=2e-4)


@pytest.mark.parametrize("kind", [*PROBES, *LAYOUTS])
def test_plain_twin_matches_jax_probe_bf16(script, monkeypatch, kind):
    """bf16 inputs, weights and outputs: the same arithmetic and rounding
    points, fp32 sums in another order, which can move one bf16 rounding
    (of q / k / v, p, the context or y) by a step. B4's bound on the card
    (chip_smoke.py): |d| <= 0.05 + 0.02 |y|, about one bf16 step of the
    LayerNorm output; NaN at the same places."""
    x, desc, p = _inputs(64, "bfloat16", seed=1)
    want = _run(script, monkeypatch, {**PROBES, **LAYOUTS}[kind],
                _jax_params(p, "bfloat16"), x, desc)
    got = _port_probe(kind, _port(p, "bfloat16"), x, desc, "bfloat16")
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=2e-2, atol=5e-2)


def test_none_is_finite_at_a_half_key_chunk(script, monkeypatch):
    """L 96: the card kernel pads the keys to 128 with zero rows; under
    "none" they must weigh 0, as JAX, which has no padding keys, gives a
    finite output. The plain twin is finite as well and holds JAX."""
    x, desc, p = _inputs(96, "float32", seed=2)
    want = _run(script, monkeypatch, PROBES["none"],
                _jax_params(p, "float32"), x, desc)
    got = _port_probe("none", _port(p, "float32"), x, desc, "float32")
    assert np.isfinite(want).all() and np.isfinite(got).all()


@pytest.mark.parametrize("kind", ["full", "none", "noshift"])
def test_probe_context_sees_the_scores(kind):
    """The context ``probe_block(..., return_ctx=True)`` gives a check: on
    open descriptors (every row attends every key) it is the attention
    recomputed here from bf16 q, k, v at the probe's rounding points, and
    the twin without scores (Wq and bq zero) misses it by far more than
    the card's bound on it, 1e-2 of its largest entry. Under "none" the
    output y could not tell them apart: p = s 1e-4 leaves ctx ~1e-2 of v."""
    x, _, p = _inputs(64, "bfloat16", seed=5)
    attn = _port(p, "bfloat16")
    t = torch.from_numpy(x).bfloat16()
    B, L, _ = t.shape
    desc = torch.tensor([[0, L, 0]] * B, dtype=torch.int32)

    def ctx(a):
        _, c = tbp.probe_block(t, desc, a, num_heads=H, softmax_mode=kind,
                               return_ctx=True)
        assert c.shape == t.shape and c.dtype == t.dtype
        return c.float()

    def proj(lin):
        return (t.float() @ lin.weight.float().t()
                + lin.bias.float()).bfloat16()

    def heads(a):
        return a.float().reshape(B, L, H, D).transpose(1, 2)

    ps = attn.self
    q = (proj(ps.query).float() / 8).bfloat16()
    s = heads(q) @ heads(proj(ps.key)).transpose(-1, -2)
    pr = {"full": lambda: torch.softmax(s, -1), "none": lambda: s * 1e-4,
          "noshift": lambda: torch.exp(s - 20) / torch.exp(s - 20).sum(
              -1, keepdim=True)}[kind]()
    want = (pr.bfloat16().float() @ heads(proj(ps.value))).bfloat16()
    got = ctx(attn)
    np.testing.assert_array_equal(
        got.numpy(), want.transpose(1, 2).reshape(B, L, HID).float().numpy())
    no_scores = _port(p, "bfloat16")
    with torch.no_grad():
        no_scores.self.query.weight.zero_()
        no_scores.self.query.bias.zero_()
    wrong = ctx(no_scores)
    assert float((got - wrong).abs().max() / wrong.abs().max().clamp(
        min=1e-30)) > 0.1


def test_attention_block_block_b_matches_jax():
    """B4 at block_b 2 (lowered to a divisor of B, as on the TPU) against
    the TPU kernel at block_b 2 in interpret mode."""
    x, desc, p = _inputs(64, "float32", seed=3)
    desc = np.concatenate([desc, desc[1:3]])        # B 6: block_b 2 and 3
    x = np.concatenate([x, x[:2]])
    for block_b in (2, 4):
        want = pattn2.fused_attention_block(
            jnp.asarray(x), jnp.asarray(desc), _jax_params(p, "float32"),
            num_heads=H, block_b=block_b, interpret=True)
        got = tatb.attention_block(torch.from_numpy(x),
                                   torch.from_numpy(desc),
                                   _port(p, "float32"), num_heads=H,
                                   block_b=block_b)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    assert tatb.lower_block_b(6, 4) == 3
    with pytest.raises(ValueError, match="block_b"):
        tatb.attention_block(torch.from_numpy(x), torch.from_numpy(desc),
                             _port(p, "float32"), num_heads=H, block_b=0)


def test_pad_heads_128_matches_pad_cols(script, monkeypatch):
    """The padded weights the script hands its pad128 kernel (captured at
    its pallas_call) are pad_heads_128's, transposed to JAX's [in, out]."""
    seen = {}

    class Capture(_Interpret):
        @staticmethod
        def pallas_call(kernel, *, out_shape, **kw):
            def call(*args):
                seen["args"] = args
                return jnp.zeros(out_shape.shape, out_shape.dtype)
            return call

    monkeypatch.setattr(script, "pl", Capture())
    x, desc, p = _inputs(64, "float32", seed=4)
    _run(script, monkeypatch, LAYOUTS["pad128"], _jax_params(p, "float32"),
         x, desc)
    wq, bq, wk, bk, wv, bv, wo, bo, gamma, beta = (
        np.asarray(a) for a in seen["args"][2:])
    ps = tbp.pad_heads_128(_port(p, "float32"))
    for got, want in ((ps.self.query.weight.T, wq), (ps.self.query.bias, bq),
                      (ps.self.key.weight.T, wk), (ps.self.key.bias, bk),
                      (ps.self.value.weight.T, wv), (ps.self.value.bias, bv),
                      (ps.output.dense.weight.T, wo),
                      (ps.output.dense.bias, bo),
                      (ps.output.LayerNorm.weight, gamma),
                      (ps.output.LayerNorm.bias, beta)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert wq.shape == (HID, H * 128) and wo.shape == (H * 128, HID)


def test_wrappers_refuse_non_cpu_tensors():
    """Off the CPU the probes launch their kernel or raise: here (meta
    tensors) every argument check runs and the device check raises; a
    width, type, mode or weight shape the kernels do not take is refused
    first."""
    def t(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    with torch.device("meta"):
        attn = tv._attention(768).to(torch.bfloat16)
        narrow = tv._attention(256).to(torch.bfloat16)
    padded = tbp.pad_heads_128(attn)
    x, desc = t(2, 64, 768), t(2, 3, dtype=torch.int32)
    probe = functools.partial(tbp.probe_block, num_heads=12,
                              softmax_mode="full")
    layout = functools.partial(tbp.layout_probe_block, num_heads=12,
                               layout="wo_acc")
    cases = [(probe, (t(2, 64, 256), desc, narrow), "built for width 768"),
             (probe, (t(2, 64, 768, dtype=torch.float32), desc, attn),
              "must be bfloat16"),
             (probe, (x, t(2, 3, dtype=torch.int64), attn),
              "desc must be int32"),
             (probe, (t(2, 48, 768), desc, attn), "multiple of 32"),
             (probe, (x, desc, attn), "unsupported device meta"),
             (layout, (x, desc, padded), "weight shape"),
             (layout, (x, desc, attn), "unsupported device meta"),
             (functools.partial(tbp.layout_probe_block, num_heads=12,
                                layout="pad128"), (x, desc, attn),
              "weight shape"),
             (functools.partial(tbp.layout_probe_block, num_heads=12,
                                layout="pad128"), (x, desc, padded),
              "unsupported device meta"),
             (functools.partial(tbp.probe_block, num_heads=12,
                                softmax_mode="relu"), (x, desc, attn),
              "softmax_mode"),
             (functools.partial(tbp.layout_probe_block, num_heads=12,
                                layout="k_major"), (x, desc, attn),
              "layout")]
    for fn, args, msg in cases:
        with pytest.raises(ValueError, match=msg):
            fn(*args)


def test_bench_attn_block_runs_every_variant_on_cpu(capsys):
    """The bench's entry point at a small shape on the CPU (the plain
    twins): every variant reports a time."""
    from unimm_torch.tools import bench_attn_block
    res = bench_attn_block.main(["--device", "cpu", "--iters", "1",
                                 "--shape", "2,64,128"])
    assert list(res) == list(bench_attn_block.VARIANTS)
    assert len(res) == 13
    assert all(0 < r[1] <= r[0] <= r[2] for r in res.values())
    assert '"bench_attn_block"' in capsys.readouterr().out
