"""Online-softmax label head (K3): per-row NLL under a vocabulary head, the
ViLBERT model's tied 30522-word decoder at width 768 (with its bias) or the
decoder model's untied 163840-word LM head at width 2048 (no bias).

``xent_head`` replaces the TPU kernel
``unimm_tpu/ops/pallas_head.py:online_softmax_xent_tpu`` (eval only). On a
CUDA tensor it launches the hand-written kernel in ``csrc/xent_head.cu``
(the logits on a wgmma + TMA mainloop over 128 x 256 tiles, each tile
reduced in registers to each row's (max, exp-sum) over its vocab columns
and the label's logit, into an fp32 scratch; then one warp a row merges a
row's partials into its NLL); on a CPU tensor it runs the plain version,
``ops/losses.online_softmax_xent``, the chunked vocab scan of the JAX
package's XLA path.
"""

from __future__ import annotations

import torch

from unimm_torch.ops import _build
from unimm_torch.ops.losses import online_softmax_xent as xent_head_plain
from unimm_torch.utils import trace

HID = 768            # the ViLBERT width (the kernel's instance with a bias)
WIDTHS = {768: True, 2048: False}   # the kernel's widths: with a bias?
VOCAB_TILE = 256     # the kernel's vocab columns a tile

__all__ = ["xent_head", "xent_head_plain"]


def _require(cond, msg):
    if not cond:
        raise ValueError(f"xent_head: {msg}")


def xent_head(hidden, decoder_weight, decoder_bias, labels):
    """NLL of ``labels`` [...] under softmax(hidden [..., W] @
    decoder_weight.T (+ decoder_bias)); -1 labels give 0. A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel (bf16 hidden and
    decoder; at width 768 an fp32 bias, at 2048 none: ``decoder_bias``
    None) or raises."""
    W = hidden.shape[-1]
    if hidden.device.type == "cpu":
        if decoder_bias is None:
            decoder_bias = torch.zeros(decoder_weight.shape[0])
        return xent_head_plain(hidden, decoder_weight, decoder_bias, labels)
    V = decoder_weight.shape[0]
    _require(W in WIDTHS and tuple(decoder_weight.shape) == (V, W),
             f"kernel is built for widths {sorted(WIDTHS)}")
    _require((decoder_bias is not None) == WIDTHS[W],
             f"width {W} takes {'a' if WIDTHS[W] else 'no'} bias")
    if decoder_bias is not None:
        _require(tuple(decoder_bias.shape) == (V,), "decoder_bias shape")
        _require(decoder_bias.dtype == torch.float32,
                 f"decoder_bias must be float32, got {decoder_bias.dtype}")
    _require(tuple(labels.shape) == tuple(hidden.shape[:-1]), "labels shape")
    _require(hidden.dtype == torch.bfloat16
             and decoder_weight.dtype == torch.bfloat16,
             f"hidden and decoder must be bfloat16, got {hidden.dtype} / "
             f"{decoder_weight.dtype}")
    _require(not labels.is_floating_point(), "labels must be integers")
    for t in (hidden, decoder_weight, decoder_bias, labels):
        if t is None:
            continue
        _require(t.device == hidden.device, "all tensors on one device")
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 "inputs must be contiguous and 16-byte aligned")
    _require(hidden.device.type == "cuda",
             f"unsupported device {hidden.device}")
    with trace.span("op.xent_head"):
        lab = labels.to(torch.int32)
        M = lab.numel()
        nll = torch.empty(labels.shape, dtype=torch.float32,
                          device=hidden.device)
        # per (row, vocab tile) (max, exp-sum), and each row's label logit
        part = torch.empty(M, -(-V // VOCAB_TILE), 2, dtype=torch.float32,
                           device=hidden.device)
        label_logit = torch.empty(M, dtype=torch.float32, device=hidden.device)
        lib = _build.library()
        st = _build.stream(hidden.device)
        if W == HID:
            code = lib.unimm_xent_head(
                hidden.data_ptr(), lab.data_ptr(), decoder_weight.data_ptr(),
                decoder_bias.data_ptr(), part.data_ptr(),
                label_logit.data_ptr(), nll.data_ptr(), M, V, st)
        else:
            code = lib.unimm_xent_head_2048(
                hidden.data_ptr(), lab.data_ptr(), decoder_weight.data_ptr(),
                part.data_ptr(), label_logit.data_ptr(), nll.data_ptr(), M,
                V, st)
        _build.check(code, "xent_head")
        xent_head.launches += 1
    return nll


xent_head.launches = 0
