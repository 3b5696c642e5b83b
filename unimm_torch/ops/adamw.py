"""Fused AdamW update of one parameter tensor.

``adamw_update_leaf`` replaces the TPU kernel
``unimm_tpu/ops/pallas_optim.py:adamw_update_leaf``: one pass reads
(g, p, mu, nu) and writes (update, mu', nu') in optax's op order (moments
as ``b * m + (1 - b) * g``, bias correction by division). On CUDA tensors
it launches ``csrc/adamw.cu`` (one launch per tensor); on CPU tensors it
runs ``adamw_update_leaf_plain``, which repeats the kernel's operations one
rounding at a time, so the two agree bit for bit on the card. As the TPU
kernel donates its inputs, the update is written over ``g`` and the new
moments over ``mu`` and ``nu`` on either device.
"""

from __future__ import annotations

import torch

from unimm_torch.ops import _build


def _f32(v, device):
    """A scalar as a 0-dim fp32 tensor (a Python float rounds to fp32 as
    JAX rounds its weakly typed constants)."""
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def adamw_update_leaf_plain(g, p, mu, nu, lr, wd, bc1, bc2, *, b1=0.9,
                            b2=0.999, eps=1e-6, b1_mu=None):
    """(update, mu', nu') in fp32, one operation per rounding as the
    kernel; inputs are not modified. ``b1_mu``, when given, is b1 * mu
    already formed (a narrower first moment's product, rounded as optax
    rounds it) and takes the place of ``b1 * mu``."""
    d = g.device
    b1_, omb1 = _f32(b1, d), _f32(1.0 - b1, d)
    b2_, omb2 = _f32(b2, d), _f32(1.0 - b2, d)
    mu2 = (b1_ * mu if b1_mu is None else b1_mu) + omb1 * g
    nu2 = b2_ * nu + omb2 * (g * g)
    direction = (mu2 / _f32(bc1, d)) / (torch.sqrt(nu2 / _f32(bc2, d))
                                        + _f32(eps, d))
    update = -_f32(lr, d) * (direction + _f32(wd, d) * p)
    return update, mu2, nu2


def _require(cond, msg):
    if not cond:
        raise ValueError(f"adamw_update_leaf: {msg}")


def adamw_update_leaf(g, p, mu, nu, lr, wd, bc1, bc2, *, b1=0.9, b2=0.999,
                      eps=1e-6):
    """One fused AdamW pass over one fp32 parameter tensor (any shape).

    ``lr``, ``wd``, ``bc1`` = 1 - b1^t and ``bc2`` = 1 - b2^t are host
    scalars. Returns (update, mu', nu'), which are ``g``, ``mu`` and ``nu``
    overwritten. A CPU tensor runs the plain twin; a CUDA tensor launches
    the kernel (fp32, contiguous, 16-byte aligned) or raises."""
    ts = (g, p, mu, nu)
    if g.device.type == "cpu":
        u, m2, v2 = adamw_update_leaf_plain(g, p, mu, nu, lr, wd, bc1, bc2,
                                            b1=b1, b2=b2, eps=eps)
        g.copy_(u)
        mu.copy_(m2)
        nu.copy_(v2)
        return g, mu, nu
    for t in ts:
        _require(t.dtype == torch.float32, f"tensors must be float32, got "
                 f"{t.dtype}")
        _require(t.shape == g.shape, "g, p, mu, nu differ in shape")
        _require(t.device == g.device, "all tensors on one device")
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 "tensors must be contiguous and 16-byte aligned")
    _require(g.device.type == "cuda", f"unsupported device {g.device}")
    lib = _build.library()
    code = lib.unimm_adamw(g.data_ptr(), p.data_ptr(), mu.data_ptr(),
                           nu.data_ptr(), g.numel(), float(lr), float(wd),
                           float(bc1), float(bc2), b1, 1.0 - b1, b2,
                           1.0 - b2, eps, _build.stream(g.device))
    _build.check(code, "adamw")
    adamw_update_leaf.launches += 1
    return g, mu, nu


adamw_update_leaf.launches = 0
