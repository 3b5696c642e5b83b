"""Online-softmax label head: per-row NLL under the tied 30522-word decoder.

``xent_head`` replaces the TPU kernel
``unimm_tpu/ops/pallas_head.py:online_softmax_xent_tpu`` (eval only). On a
CUDA tensor it launches the hand-written kernel in ``csrc/xent_head.cu``
(one CTA per 64-row block walks every vocab tile with a running max,
exp-sum and true-label logit; only [M] NLL reaches device memory); on a CPU
tensor it runs the plain version, ``ops/losses.online_softmax_xent``, the
chunked vocab scan of the JAX package's XLA path.
"""

from __future__ import annotations

import torch

from unimm_torch.ops import _build
from unimm_torch.ops.losses import online_softmax_xent as xent_head_plain

HID = 768            # the width the CUDA kernel is built for

__all__ = ["xent_head", "xent_head_plain"]


def _require(cond, msg):
    if not cond:
        raise ValueError(f"xent_head: {msg}")


def xent_head(hidden, decoder_weight, decoder_bias, labels):
    """NLL of ``labels`` [...] under softmax(hidden [..., 768] @
    decoder_weight.T + decoder_bias); -1 labels give 0. A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel (bf16 hidden and
    decoder, fp32 bias) or raises."""
    if hidden.device.type == "cpu":
        return xent_head_plain(hidden, decoder_weight, decoder_bias, labels)
    V = decoder_weight.shape[0]
    _require(hidden.shape[-1] == HID
             and tuple(decoder_weight.shape) == (V, HID),
             f"kernel is built for width {HID}")
    _require(tuple(decoder_bias.shape) == (V,), "decoder_bias shape")
    _require(tuple(labels.shape) == tuple(hidden.shape[:-1]), "labels shape")
    _require(hidden.dtype == torch.bfloat16
             and decoder_weight.dtype == torch.bfloat16,
             f"hidden and decoder must be bfloat16, got {hidden.dtype} / "
             f"{decoder_weight.dtype}")
    _require(decoder_bias.dtype == torch.float32,
             f"decoder_bias must be float32, got {decoder_bias.dtype}")
    _require(not labels.is_floating_point(), "labels must be integers")
    for t in (hidden, decoder_weight, decoder_bias, labels):
        _require(t.device == hidden.device, "all tensors on one device")
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 "inputs must be contiguous and 16-byte aligned")
    _require(hidden.device.type == "cuda",
             f"unsupported device {hidden.device}")
    lab = labels.to(torch.int32)
    M = lab.numel()
    nll = torch.empty(labels.shape, dtype=torch.float32,
                      device=hidden.device)
    code = _build.library().unimm_xent_head(
        hidden.data_ptr(), lab.data_ptr(), decoder_weight.data_ptr(),
        decoder_bias.data_ptr(), nll.data_ptr(), M, V,
        _build.stream(hidden.device))
    _build.check(code, "xent_head")
    xent_head.launches += 1
    return nll


xent_head.launches = 0
