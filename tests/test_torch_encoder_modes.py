"""The encoder's ``in_batch_pairs`` and ``fast_mode`` in the PyTorch port
against the JAX package on the same weights and numpy inputs (TINY
config, CPU, fp32): the four ``encode`` outputs under each
``attention_impl``, the gradients in training at dropout 0 (with
``fixed_t_layer`` and with remat), remat equal to no remat at the default
dropouts, and the rule that turns every text kernel off under either
mode (the JAX package's ``pairs_ok``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_common import TINY, TINY_T, jax_params, torch_model
from tests.test_model import make_batch
from tests.test_torch_train import NO_DROP, to_jax, to_torch, torch_tree
from unimm_torch.models import unimm as tu
from unimm_torch.models import vilbert as tv
from unimm_tpu.models import unimm as ju

RTOL, ATOL = 2e-4, 2e-5           # the port's bar against the JAX package
B = 3
TEXT_KEYS = ("tokens", "segments", "mode", "ctx_end", "ans_len")


def modes_batch(seed, kind, mode):
    """A numpy batch of B rows: gen, dis or mixed descriptors (ctx_end and
    ans_len varied per row), the last region of every image padded and one
    more of the second; under fast_mode one text row over the B images."""
    rng = np.random.default_rng(seed)
    b = {k: np.array(v) for k, v in make_batch(rng, TINY, B=B).items()}
    b["mode"] = np.array({"gen": [1, 1, 1], "dis": [0, 0, 0],
                          "mixed": [1, 0, 1]}[kind], np.int32)
    b["ctx_end"] = np.array([20, 14, 26], np.int32)
    b["ans_len"] = np.where(b["mode"] == 1, [5, 3, 2], 0).astype(np.int32)
    b["image_mask"][1, -2] = 0
    if mode == "fast_mode":
        b.update({k: b[k][1:2] for k in TEXT_KEYS})
    return b


def jax_encode(cfg, b, train=False):
    return jax.jit(lambda p, x: ju.encode(
        p, cfg, x, dtype=jnp.float32, train=train,
        rng=jax.random.PRNGKey(0) if train else None))(jax_params(), to_jax(b))


@pytest.mark.parametrize("kind", ["gen", "dis"])
@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_block"])
@pytest.mark.parametrize("mode", ["in_batch_pairs", "fast_mode"])
def test_modes_encode_matches_jax(mode, impl, kind):
    cj = TINY.replace(attention_impl=impl, **{mode: True})
    ct = TINY_T.replace(attention_impl=impl, **{mode: True})
    b = modes_batch(0, kind, mode)
    got = tu.encode(torch_model(ct), ct, to_torch(b), dtype=torch.float32)
    want = jax_encode(cj, b)
    rows = B * B if mode == "in_batch_pairs" else B
    for g, w in zip(got, want):
        assert g.shape[0] == rows
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_in_batch_pairs_is_the_crossed_batch():
    """Pair p = text p // B with image p % B: the port's in_batch_pairs
    rows equal the plain forward of the batch crossed on the host (the
    same TINY forward on B * B rows), the diagonal the unexpanded one."""
    b = modes_batch(1, "mixed", "in_batch_pairs")
    ct = TINY_T.replace(in_batch_pairs=True)
    got = tu.encode(torch_model(ct), ct, to_torch(b), dtype=torch.float32)
    t, i = np.repeat(np.arange(B), B), np.tile(np.arange(B), B)
    crossed = {k: (v[t] if k in TEXT_KEYS else v[i]) for k, v in b.items()}
    want = tu.encode(torch_model(), TINY_T, to_torch(crossed),
                     dtype=torch.float32)
    plain = tu.encode(torch_model(), TINY_T, to_torch(b),
                      dtype=torch.float32)
    diag = np.arange(B) * B + np.arange(B)
    for g, w, p in zip(got, want, plain):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(g[diag], p, rtol=RTOL, atol=ATOL)


def _loss(out):
    return (out[2] ** 2).sum() + (out[3] ** 2).sum()


@pytest.mark.parametrize("mode,extra", [
    ("in_batch_pairs", {}), ("fast_mode", {}),
    ("in_batch_pairs", {"fixed_t_layer": 1}),
    ("in_batch_pairs", {"remat": True}), ("fast_mode", {"remat": True})])
def test_modes_gradients_match_jax(mode, extra):
    """train=True at dropout 0 under the default attention_impl: the
    gradient of sum(pooled_t**2) + sum(pooled_v**2) with respect to every
    parameter against jax.grad."""
    kw = dict(attention_impl="pallas_block", **{mode: True}, **NO_DROP,
              **extra)
    cj, ct = TINY.replace(**kw), TINY_T.replace(**kw)
    b = modes_batch(2, "mixed", mode)

    def jloss(p):
        return _loss(ju.encode(p, cj, to_jax(b), train=True,
                               rng=jax.random.PRNGKey(0), dtype=jnp.float32))

    jl, jg = jax.value_and_grad(jloss)(jax_params())
    model = torch_model(ct).train().requires_grad_(True)
    loss = _loss(tu.encode(model, ct, to_torch(b), dtype=torch.float32,
                           train=True, rng=tv.DropoutRng(0, "cpu")))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL)
    want = torch_tree(jg)
    for name, p in model.named_parameters():
        got = (p.grad.numpy() if p.grad is not None
               else np.zeros(p.shape, np.float32))
        np.testing.assert_allclose(got, want[name], rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    if extra.get("fixed_t_layer"):           # detached, as JAX's zeros
        assert model.bert.encoder.layer[0].attention.self.query.weight.grad \
            is None


@pytest.mark.parametrize("mode", ["in_batch_pairs", "fast_mode"])
def test_modes_remat_equals_no_remat(mode):
    """At the default dropouts the rematerialised layers replay their
    masks and see the biases they ran with (the crossed or broadcast ones
    after the first connection layer's input, the per-row ones before):
    the loss and every gradient equal the step without remat."""
    ct = TINY_T.replace(**{mode: True})
    b = to_torch(modes_batch(3, "mixed", mode))

    def run(cfg):
        model = torch_model(cfg).train().requires_grad_(True)
        loss = _loss(tu.encode(model, cfg, b, dtype=torch.float32,
                               train=True, rng=tv.DropoutRng(7, "cpu")))
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in model.named_parameters()}

    (lw, gw), (lr, gr) = run(ct), run(ct.replace(remat=True))
    assert torch.equal(lr, lw)
    for name, g in gw.items():
        assert (g is None and gr[name] is None) or torch.equal(gr[name], g), \
            name


def _boom(*args, **kwargs):
    raise AssertionError("a text kernel ran under in_batch_pairs/fast_mode")


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("mode", ["in_batch_pairs", "fast_mode"])
def test_modes_launch_no_text_kernel(mode, train, monkeypatch):
    """Under either mode, at attention_impl "pallas_block" with fused_co
    (and "pallas" at attention dropout 0), encode calls none of the text
    kernels' wrappers: the whole encoder runs its plain code."""
    for name in ("attention_block", "ffn_block", "co_text_block",
                 "attention_block_train", "text_attention"):
        monkeypatch.setattr(tu, name, _boom)
    b = to_torch(modes_batch(4, "mixed", mode))
    for impl in ("pallas_block", "pallas"):
        ct = TINY_T.replace(attention_impl=impl, fused_co=True,
                            attention_probs_dropout_prob=0.0, **{mode: True})
        model = torch_model(ct).train(train).requires_grad_(train)
        out = tu.encode(model, ct, b, dtype=torch.float32, train=train,
                        rng=tv.DropoutRng(0, "cpu"))
        assert all(torch.isfinite(o).all() for o in out)
