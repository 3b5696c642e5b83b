"""The training MLM cross-entropy over the tied decoder on the Hopper GEMM
core: the forward's NLL and log-sum-exp, and the backward's gradients of
the hidden rows, the decoder and its bias.

``ops/losses._OnlineXent`` (the port of the JAX package's XLA scan
``unimm_tpu/ops/losses.py:online_softmax_xent_vjp``) routes here by
``takes``: CUDA tensors with bf16 hidden rows of width 768. Its own
chunked fp32 scan stays the path of everything else (CPU tensors, fp32
training, other widths) and is the plain version these kernels are held
against. ``xent_train_fwd`` launches ``csrc/xent_train.cu``'s forward (K3's
logits kernel, then a combine that keeps lse); ``xent_train_bwd`` its
backward (the logits again with dlogits formed in the product's epilogue,
then dh and ddecoder on wgmma's transposed reads, db from the epilogue's
column sums).
"""

from __future__ import annotations

import torch

from unimm_torch.ops import _build

HID = 768            # the width the kernels are built for
VOCAB_TILE = 256     # the kernels' vocab columns a tile
ROW_TILE = 128       # the backward's rows a tile

__all__ = ["takes", "xent_train_fwd", "xent_train_bwd"]


def takes(hidden) -> bool:
    """Whether ``_OnlineXent`` launches the kernels for ``hidden`` [...,
    H]: CUDA, bf16, H 768. Anything else runs the plain scan."""
    return (hidden.device.type == "cuda" and hidden.dtype == torch.bfloat16
            and hidden.shape[-1] == HID)


def _require(cond, msg):
    if not cond:
        raise ValueError(f"xent_train: {msg}")


def _check(hidden, decoder_weight, decoder_bias, labels, rows=()):
    """The kernels' input contract: hidden [M, 768] and decoder [V, 768]
    bf16, bias [V] fp32, labels [M] int32, each of ``rows`` [M] fp32, all
    contiguous, 16-byte aligned, on one CUDA device."""
    _require(hidden.dim() == 2 and hidden.shape[1] == HID
             and decoder_weight.dim() == 2
             and decoder_weight.shape[1] == HID,
             f"hidden [M, {HID}] and decoder [V, {HID}]: kernels are built "
             f"for width {HID}")
    M, V = hidden.shape[0], decoder_weight.shape[0]
    _require(M >= 1 and V >= 1, "empty hidden or decoder")
    _require(tuple(decoder_bias.shape) == (V,), "decoder_bias shape")
    _require(tuple(labels.shape) == (M,), "labels shape")
    _require(hidden.dtype == torch.bfloat16
             and decoder_weight.dtype == torch.bfloat16,
             f"hidden and decoder must be bfloat16, got {hidden.dtype} / "
             f"{decoder_weight.dtype}")
    _require(decoder_bias.dtype == torch.float32,
             f"decoder_bias must be float32, got {decoder_bias.dtype}")
    _require(labels.dtype == torch.int32,
             f"labels must be int32, got {labels.dtype}")
    for r in rows:
        _require(tuple(r.shape) == (M,) and r.dtype == torch.float32,
                 "lse and gf must be float32 [M]")
    for t in (hidden, decoder_weight, decoder_bias, labels, *rows):
        _require(t.device == hidden.device, "all tensors on one device")
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 "inputs must be contiguous and 16-byte aligned")
    _require(hidden.device.type == "cuda",
             f"unsupported device {hidden.device}")
    return M, V


def xent_train_fwd(hidden, decoder_weight, decoder_bias, labels):
    """(nll [M], lse [M]) fp32 of int32 ``labels`` [M] under
    softmax(hidden [M, 768] @ decoder_weight.T + decoder_bias); nll is 0
    where the label is -1, lse is every row's."""
    M, V = _check(hidden, decoder_weight, decoder_bias, labels)
    dev = hidden.device
    nll = torch.empty(M, dtype=torch.float32, device=dev)
    lse = torch.empty(M, dtype=torch.float32, device=dev)
    part = torch.empty(M, -(-V // VOCAB_TILE), 2, dtype=torch.float32,
                       device=dev)
    label_logit = torch.empty(M, dtype=torch.float32, device=dev)
    code = _build.library().unimm_xent_train_fwd(
        hidden.data_ptr(), labels.data_ptr(), decoder_weight.data_ptr(),
        decoder_bias.data_ptr(), part.data_ptr(), label_logit.data_ptr(),
        nll.data_ptr(), lse.data_ptr(), M, V, _build.stream(dev))
    _build.check(code, "xent_train_fwd")
    xent_train_fwd.launches += 1
    return nll, lse


def xent_train_bwd(hidden, decoder_weight, decoder_bias, labels, lse, gf):
    """(dhidden [M, 768] bf16, ddecoder [V, 768] bf16, dbias [V] fp32) of
    sum(gf * nll) for the forward's ``lse`` and the upstream gradient
    ``gf`` [M] fp32 (0 where the label is -1): dlogits = gf (softmax -
    onehot), rounded to bf16 for both products, dbias from the unrounded
    dlogits."""
    M, V = _check(hidden, decoder_weight, decoder_bias, labels, (lse, gf))
    dev = hidden.device
    vp = -(-V // VOCAB_TILE) * VOCAB_TILE
    dl = torch.empty(M, vp, dtype=torch.bfloat16, device=dev)
    part_db = torch.empty(-(-M // ROW_TILE), vp, dtype=torch.float32,
                          device=dev)
    dh = torch.empty(M, HID, dtype=torch.bfloat16, device=dev)
    dw = torch.empty(V, HID, dtype=torch.bfloat16, device=dev)
    db = torch.empty(V, dtype=torch.float32, device=dev)
    code = _build.library().unimm_xent_train_bwd(
        hidden.data_ptr(), labels.data_ptr(), decoder_weight.data_ptr(),
        decoder_bias.data_ptr(), lse.data_ptr(), gf.data_ptr(),
        dl.data_ptr(), part_db.data_ptr(), dh.data_ptr(), dw.data_ptr(),
        db.data_ptr(), M, V, _build.stream(dev))
    _build.check(code, "xent_train_bwd")
    xent_train_bwd.launches += 1
    return dh, dw, db


xent_train_fwd.launches = 0
xent_train_bwd.launches = 0
