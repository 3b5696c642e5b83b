"""Fused BERT FFN block: LayerNorm(x + W2 act(W1 x + b1) + b2).

``ffn_block`` replaces the TPU kernel
``unimm_tpu/ops/pallas_attention_v2.py:fused_ffn_block``. On a CUDA tensor
it launches the hand-written kernels in ``csrc/ffn_block.cu`` (the two
products with fused bias/activation and bias/residual epilogues, then a
row LayerNorm);
on a CPU tensor it runs ``ffn_block_plain``, which repeats the kernel's
rounding points in plain PyTorch: h rounds to x.dtype after the fp32
product and bias, the activation is evaluated in x.dtype (tanh gelu in
bf16, exact erf gelu in fp32), the second product, bias and residual run
in fp32, then LayerNorm with fp32 statistics.
"""

from __future__ import annotations

import torch

from unimm_torch.models.vilbert import ACT
from unimm_torch.ops import _build

HID = 768            # the width the CUDA kernel is built for
_ACT_CODE = {"gelu": 0, "relu": 1, "swish": 2}


def _weights(p_inter, p_out):
    return (p_inter.dense.weight, p_inter.dense.bias, p_out.dense.weight,
            p_out.dense.bias, p_out.LayerNorm.weight, p_out.LayerNorm.bias)


def ffn_block_plain(x, p_inter, p_out, *, act="gelu", eps=1e-12):
    w1, b1, w2, b2, gamma, beta = _weights(p_inter, p_out)
    dt = x.dtype
    xf = x.float()
    h = (xf @ w1.float().t() + b1.float()).to(dt)
    h = ACT[act](h)
    h32 = (h.float() @ w2.float().t() + b2.float()) + xf
    mean = h32.mean(-1, keepdim=True)
    var = (h32 - mean).square().mean(-1, keepdim=True)
    y = (h32 - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(dt)


def _require(cond, msg):
    if not cond:
        raise ValueError(f"ffn_block: {msg}")


def ffn_block(x, p_inter, p_out, *, act="gelu", eps=1e-12):
    """BertIntermediate + BertOutput on x [..., 768] (rows are
    independent). A CPU tensor runs ``ffn_block_plain``; a CUDA tensor
    launches the kernel (bf16 activations and weights) or raises."""
    if x.device.type == "cpu":
        return ffn_block_plain(x, p_inter, p_out, act=act, eps=eps)
    _require(act in _ACT_CODE, f"activation {act!r}")
    weights = _weights(p_inter, p_out)
    inter = weights[0].shape[0]
    _require(x.shape[-1] == HID, f"kernel is built for width {HID}")
    _require(inter % 128 == 0, f"intermediate {inter} % 128 != 0")
    shapes = [(inter, HID), (inter,), (HID, inter), (HID,), (HID,), (HID,)]
    for t, shp in zip(weights, shapes):
        _require(tuple(t.shape) == shp, f"weight shape {tuple(t.shape)}")
    for t in (x,) + weights:
        _require(t.dtype == torch.bfloat16,
                 f"activations and weights must be bfloat16, got {t.dtype}")
        _require(t.device == x.device, "all tensors on one device")
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 "inputs must be contiguous and 16-byte aligned")
    _require(x.device.type == "cuda", f"unsupported device {x.device}")
    M = x.numel() // HID
    act_buf = torch.empty(M, inter, dtype=x.dtype, device=x.device)
    pre = torch.empty(M, HID, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    code = _build.library().unimm_ffn_block(
        x.data_ptr(), *(t.data_ptr() for t in weights), act_buf.data_ptr(),
        pre.data_ptr(), out.data_ptr(), M, inter, _ACT_CODE[act], eps,
        _build.stream(x.device))
    _build.check(code, "ffn_block")
    ffn_block.launches += 1
    return out


ffn_block.launches = 0
