"""The training MLM cross-entropy's route to the Hopper kernels
(``ops/xent_train.py``) where there is no card: which tensors
``_OnlineXent`` sends to the kernels, that it hands them the operands
their contract asks for and returns their gradients as the plain scan
returns its own, and the contract's refusals. The kernels themselves are
held against the plain scan on the card (``chip_smoke.py --xent-train``,
``tests/test_torch_cuda.py``)."""

from types import SimpleNamespace

import pytest
import torch

from unimm_torch.ops import losses
from unimm_torch.ops import xent_train as xt


@pytest.mark.parametrize("device,dtype,width,kernels", [
    ("cuda", torch.bfloat16, 768, True),
    ("cuda:1", torch.bfloat16, 768, True),
    ("cuda", torch.float32, 768, False),     # -dtype float32 training
    ("cuda", torch.float16, 768, False),
    ("cuda", torch.bfloat16, 1024, False),   # another width
    ("cuda", torch.bfloat16, 64, False),
    ("cpu", torch.bfloat16, 768, False),     # every CPU test
    ("cpu", torch.float32, 768, False),
    ("meta", torch.bfloat16, 768, False),
])
def test_routing_rule(device, dtype, width, kernels):
    hidden = SimpleNamespace(device=torch.device(device), dtype=dtype,
                             shape=(240, 160, width))
    assert xt.takes(hidden) is kernels


def _case(M=37, V=300, H=768, seed=0):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(M, H, generator=g).bfloat16()
    w = (torch.randn(V, H, generator=g) * 0.05).bfloat16()
    b = torch.randn(V, generator=g) * 0.1
    lab = torch.randint(0, V, (M,), generator=g)
    lab[::4] = -1
    up = torch.rand(M, generator=g)
    return h, w, b, lab, up


def _grads(h, w, b, lab, up):
    leaves = [t.detach().requires_grad_() for t in (h, w, b)]
    nll = losses.online_softmax_xent_vjp(*leaves, lab, 128)
    return (nll, *torch.autograd.grad(nll, leaves, up))


@pytest.mark.parametrize("route", [True, False])
def test_online_xent_takes_the_kernels_where_routed(monkeypatch, route):
    """With ``takes`` true the autograd function calls the two wrappers
    once each with the contract's operands (2-D bf16 rows, bf16 decoder,
    fp32 bias, int32 labels, fp32 lse and gf) and returns what they give,
    cast as the scan's; with it false it never calls them. The stand-ins
    run the plain scan, so both routes give the same bits."""
    h, w, b, lab, up = _case()
    want = _grads(h, w, b, lab, up)
    calls = []

    def contract(hidden, decoder_weight, decoder_bias, labels, rows=()):
        M = hidden.shape[0]
        assert hidden.shape == (M, 768) and hidden.dtype == torch.bfloat16
        assert decoder_weight.shape == (300, 768)
        assert decoder_weight.dtype == torch.bfloat16
        assert decoder_bias.shape == (300,)
        assert decoder_bias.dtype == torch.float32
        assert labels.shape == (M,) and labels.dtype == torch.int32
        for r in rows:
            assert r.shape == (M,) and r.dtype == torch.float32
        for t in (hidden, decoder_weight, decoder_bias, labels, *rows):
            assert t.is_contiguous()

    def fwd(hidden, decoder_weight, decoder_bias, labels):
        contract(hidden, decoder_weight, decoder_bias, labels)
        calls.append("fwd")
        lse, t = losses._xent_stats(hidden.float(), decoder_weight,
                                    decoder_bias, labels.long(), 128)
        return losses._nll(lse, t, labels.long()), lse

    def bwd(hidden, decoder_weight, decoder_bias, labels, lse, gf):
        contract(hidden, decoder_weight, decoder_bias, labels, (lse, gf))
        calls.append("bwd")
        dh, dw, db = losses._xent_grads(hidden, decoder_weight,
                                        decoder_bias, labels.long(), lse,
                                        gf, 128)
        return dh.bfloat16(), dw.bfloat16(), db

    monkeypatch.setattr(xt, "takes", lambda hidden: route)
    monkeypatch.setattr(xt, "xent_train_fwd", fwd)
    monkeypatch.setattr(xt, "xent_train_bwd", bwd)
    got = _grads(h.reshape(1, 37, 768), w, b, lab.reshape(1, 37),
                 up.reshape(1, 37))
    assert calls == (["fwd", "bwd"] if route else [])
    assert [tuple(t.shape) for t in got] == [
        (1, 37), (1, 37, 768), (300, 768), (300,)]
    assert [t.dtype for t in got] == [t.dtype for t in want]
    for a, c in zip(got, want):
        assert torch.equal(a.reshape(c.shape), c)


def test_online_xent_on_the_cpu_launches_nothing():
    h, w, b, lab, up = _case()
    before = xt.xent_train_fwd.launches, xt.xent_train_bwd.launches
    _grads(h, w, b, lab, up)
    assert (xt.xent_train_fwd.launches, xt.xent_train_bwd.launches) == before


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _operands(**over):
    ops = dict(hidden=_meta(10, 768), decoder_weight=_meta(50, 768),
               decoder_bias=_meta(50, dtype=torch.float32),
               labels=_meta(10, dtype=torch.int32),
               lse=_meta(10, dtype=torch.float32),
               gf=_meta(10, dtype=torch.float32))
    ops.update(over)
    return ops


# refusals of both wrappers, then of the backward's own rows
BOTH = [
    ({}, "unsupported device meta"),
    ({"hidden": _meta(10, 1024), "decoder_weight": _meta(50, 1024)},
     "built for width 768"),
    ({"hidden": _meta(2, 5, 768)}, "built for width 768"),
    ({"hidden": _meta(0, 768), "labels": _meta(0, dtype=torch.int32),
      "lse": _meta(0, dtype=torch.float32),
      "gf": _meta(0, dtype=torch.float32)}, "empty"),
    ({"decoder_bias": _meta(49, dtype=torch.float32)}, "decoder_bias shape"),
    ({"labels": _meta(11, dtype=torch.int32)}, "labels shape"),
    ({"hidden": _meta(10, 768, dtype=torch.float32)}, "must be bfloat16"),
    ({"decoder_weight": _meta(50, 768, dtype=torch.float32)},
     "must be bfloat16"),
    ({"decoder_bias": _meta(50)}, "must be float32"),
    ({"labels": _meta(10, dtype=torch.int64)}, "must be int32"),
    ({"hidden": _meta(768, 10).t()}, "contiguous"),
    ({"labels": torch.zeros(10, dtype=torch.int32)}, "one device"),
]
BWD = [
    ({"lse": _meta(10)}, "lse and gf must be float32"),
    ({"gf": _meta(9, dtype=torch.float32)}, "lse and gf must be float32"),
    ({"gf": _meta(20, dtype=torch.float32)[::2]}, "contiguous"),
]


@pytest.mark.parametrize("which,over,match",
                         [("fwd", *c) for c in BOTH]
                         + [("bwd", *c) for c in BOTH + BWD])
def test_contract_refusals(which, over, match):
    ops = _operands(**over)
    args = [ops[k] for k in ("hidden", "decoder_weight", "decoder_bias",
                             "labels")]
    before = xt.xent_train_fwd.launches, xt.xent_train_bwd.launches
    with pytest.raises(ValueError, match=match):
        if which == "fwd":
            xt.xent_train_fwd(*args)
        else:
            xt.xent_train_bwd(*args, ops["lse"], ops["gf"])
    assert (xt.xent_train_fwd.launches, xt.xent_train_bwd.launches) == before
