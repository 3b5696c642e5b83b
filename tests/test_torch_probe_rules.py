"""The rules the attention-block bench's probe kernels (csrc/block_probe.cu)
rely on, held on the probes' plain twins (``ops/block_probe.py``) in fp32
on the CPU, where there is no card:

* the skip rule: attention over only the 64-key chunks that
  ``masks.chunk_closed`` keeps, per 16-row warp tile, equals the twin for
  ``full`` and ``noshift`` (the masked terms it drops are exact zeros) but
  not for ``none``, whose masked keys weigh (s - 10000) 1e-4: that kernel
  computes every chunk;
* ``noshift``'s NaN rows are exactly the rows that attend no key, which
  the kernel's ``attends_none`` finds from ``row_span``'s interval (the
  rule mirrored here on ``masks.row_intervals``);
* ``wo_acc`` and ``transposed`` (the output projection summed head by
  head, the projections feature-major) compute ``full``'s function: their
  twins agree with it to fp32 summation order.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from unimm_torch.ops import block_probe as tbp
from unimm_torch.ops import masks as tm

H, D = 2, 64
HID = H * D


def _attn(seed, std=0.05):
    """An fp32 attention module of width 128 (two heads of 64) in the
    port's [out, in] layout, from a numpy seed."""
    rng = np.random.default_rng(seed)

    def lin(n_out, n_in):
        return SimpleNamespace(
            weight=torch.from_numpy(rng.normal(0, std, (n_out, n_in))
                                    .astype(np.float32)),
            bias=torch.from_numpy(rng.normal(0, 0.02, n_out)
                                  .astype(np.float32)))
    ln = SimpleNamespace(
        weight=torch.from_numpy(rng.normal(1, 0.1, HID).astype(np.float32)),
        bias=torch.from_numpy(rng.normal(0, 0.1, HID).astype(np.float32)))
    return SimpleNamespace(
        self=SimpleNamespace(query=lin(HID, HID), key=lin(HID, HID),
                             value=lin(HID, HID)),
        output=SimpleNamespace(dense=lin(HID, HID), LayerNorm=ln))


def _x(B, L, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(B, L, HID)).astype(np.float32))


def _desc(name, B, L):
    """B descriptors of chip_smoke's family ``name``; "all": every
    descriptor with mode in {0, 1}, ctx_end in [0, L], ans_len in [0, 8]."""
    if name == "all":
        return torch.tensor([(m, ce, a) for m in (0, 1)
                             for ce in range(L + 1) for a in range(9)],
                            dtype=torch.int32)
    return getattr(chip_smoke, name)(B, L, torch.Generator().manual_seed(L))


def _kept_keys(desc, L):
    """bool [B, L, L]: the keys of each row a warp's attention computes
    under masks.chunk_closed (16-row tiles, 64-key chunks)."""
    B = desc.shape[0]
    keep = torch.ones(B, L, L, dtype=torch.bool)
    for b in range(B):
        for r0 in range(0, L, tm.ROW_TILE):
            for c in range(-(-L // tm.KEY_CHUNK)):
                if tm.chunk_closed(desc[b], L, r0, tm.ROW_TILE, c):
                    keep[b, r0:r0 + tm.ROW_TILE,
                         c * tm.KEY_CHUNK:(c + 1) * tm.KEY_CHUNK] = False
    return keep


def _skipped_ctx(x, desc, attn, mode, keep):
    """The twin's fp32 context with the terms of the keys outside ``keep``
    dropped (the kernels' skipped chunks): [B, L, HID]."""
    B, L, _ = x.shape
    ps = attn.self

    def heads(lin, scale=1.0):
        y = (x @ lin.weight.t() + lin.bias) * scale
        return y.reshape(B, L, H, D).permute(0, 2, 1, 3)

    q, k, v = heads(ps.query, 1.0 / math.sqrt(D)), heads(ps.key), \
        heads(ps.value)
    s = q @ k.transpose(-1, -2) + tm.mask_bias(desc, L)[:, None]
    kept = keep[:, None]
    if mode == "full":
        e = torch.exp(s - s.amax(-1, keepdim=True)) * kept
        p = e / e.sum(-1, keepdim=True)
    elif mode == "noshift":
        e = torch.exp(s - 20.0) * kept
        p = e / e.sum(-1, keepdim=True)
    else:
        p = s * 1e-4 * kept
    return (p @ v).permute(0, 2, 1, 3).reshape(B, L, HID)


@pytest.mark.parametrize("mode,same", [("full", True), ("noshift", True),
                                       ("none", False)])
@pytest.mark.parametrize("L,desc_name", [(96, "edge_desc"),
                                         (256, "tail_desc")])
def test_skipping_closed_chunks(mode, same, L, desc_name):
    """Dropping the chunks masks.chunk_closed closes leaves full's and
    noshift's context as the twin's (to fp32 rounding; NaN rows included)
    and changes none's."""
    B = 10
    desc = _desc(desc_name, B, L)
    keep = _kept_keys(desc, L)
    assert (~keep).any()
    attn, x = _attn(L), _x(B, L, L + 1)
    got = _skipped_ctx(x, desc, attn, mode, keep)
    want = tbp.probe_block_plain(x, desc, attn, num_heads=H,
                                 softmax_mode=mode, return_ctx=True)[1]
    assert torch.equal(got.isnan(), want.isnan())
    ok = ~want.isnan()
    d = float((got[ok] - want[ok]).abs().max())
    scale = float(want[ok].abs().max())
    if same:
        assert d <= 1e-5 * scale, d
    else:
        assert d > 1e-2 * scale, d


def _attends_none(desc, L):
    """The kernel's attends_none over row_span's intervals: [0, L) without
    a diagonal is a real span only for a dis row below ctx_end >= L or gen
    row 0 with ctx_end + ans_len >= L."""
    lo, hi, diag, _ = tm.row_intervals(desc, L)
    mode, L1, A = (desc[:, k, None].long() for k in range(3))
    i = torch.arange(L)[None, :]
    whole = (lo == 0) & (hi == L) & (diag < 0)
    return whole & torch.where(mode == 0, i >= L1, (i != 0) | (L1 + A < L))


@pytest.mark.parametrize("L", [32, 96, 160])
@pytest.mark.parametrize("desc_name", ["edge_desc", "tail_desc",
                                       "train_desc", "all"])
def test_noshift_nan_rows_are_the_rows_without_a_key(L, desc_name):
    """noshift's output is NaN exactly on the rows that attend no key
    (row_intervals' open False), which the kernel's attends_none finds."""
    desc = _desc(desc_name, 8, L)
    B = desc.shape[0]
    none = ~tm.row_intervals(desc, L)[3]
    assert torch.equal(_attends_none(desc, L), none)
    y = tbp.probe_block_plain(_x(B, L, L), desc, _attn(L), num_heads=H,
                              softmax_mode="noshift")
    assert torch.equal(y.isnan().any(-1), none)
    assert torch.equal(y.isnan().all(-1), none)


@pytest.mark.parametrize("layout", ["wo_acc", "transposed"])
@pytest.mark.parametrize("L", [64, 96])
def test_layout_twins_compute_full(layout, L):
    """wo_acc's and transposed's twins equal full's within fp32 summation
    order (the output projection head by head; W x^T)."""
    B = 4
    desc = _desc("edge_desc", B, L)
    attn, x = _attn(L + 2), _x(B, L, L + 3)
    got = tbp.layout_probe_block_plain(x, desc, attn, num_heads=H,
                                       layout=layout)
    want = tbp.probe_block_plain(x, desc, attn, num_heads=H,
                                 softmax_mode="full")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
