"""Attention masks and position ids built on the device from the 3-int
per-sequence descriptor ``(mode, ctx_end, ans_len)``.

Same semantics as the JAX package's ``ops/masks.py`` (reference
utils/data_utils.py:139-288 generative, :291-428 discriminative):

    mode     : 0 = discriminative, 1 = generative
    ctx_end  : dis -> real length L; gen -> L1 = context + first answer copy
    ans_len  : gen -> answer length + 1 (incl. trailing [SEP]); dis -> 0

* dis: M[i, j] = (i < L) & (j < L).
* gen, with T = min(L1 + A, max_len), Lc = L1 - A: row 0 attends [0, T);
  context rows attend [1, Lc) + self; first-copy rows attend [1, i];
  masked-copy rows attend [1, i - A) + self; rows >= T attend nothing.
* co-attention text columns: dis [0, L); gen [1, Lc).
"""

from __future__ import annotations

import torch

NEG_INF = -10000.0  # additive-mask fill value (reference vilbert_dialog.py:1418)


def _desc(mode, ctx_end, ans_len):
    return (torch.as_tensor(mode), torch.as_tensor(ctx_end),
            torch.as_tensor(ans_len))


def text_attention_mask(mode, ctx_end, ans_len, max_len: int):
    """bool [..., max_len, max_len]; True = may attend."""
    mode, L, A = (t[..., None, None] for t in _desc(mode, ctx_end, ans_len))
    dev = L.device
    i = torch.arange(max_len, dtype=torch.int32, device=dev)[:, None]
    j = torch.arange(max_len, dtype=torch.int32, device=dev)[None, :]
    dis = (i < L) & (j < L)
    T = torch.clamp(L + A, max=max_len)
    Lc = L - A
    diag = i == j
    row0 = (i == 0) & (j < T)
    ctx_rows = (i >= 1) & (i < Lc) & (((j >= 1) & (j < Lc)) | diag)
    first_copy = (i >= Lc) & (i < L) & (j >= 1) & (j <= i)
    second_copy = (i >= L) & (i < T) & (((j >= 1) & (j < i - A)) | diag)
    gen = row0 | ctx_rows | first_copy | second_copy
    return torch.where(mode == 0, dis, gen)


def co_text_mask(mode, ctx_end, ans_len, max_len: int):
    """bool [..., max_len]: text columns visible to the image stream."""
    mode, L, A = (t[..., None] for t in _desc(mode, ctx_end, ans_len))
    j = torch.arange(max_len, dtype=torch.int32, device=L.device)
    return torch.where(mode == 0, j < L, (j >= 1) & (j < L - A))


def position_ids(mode, ctx_end, ans_len, max_len: int):
    """int64 [..., max_len]; the gen second copy reuses first-copy ids."""
    mode, L, A = (t[..., None] for t in _desc(mode, ctx_end, ans_len))
    i = torch.arange(max_len, dtype=torch.int32, device=L.device)
    T = torch.clamp(L + A, max=max_len)
    zero = torch.zeros((), dtype=i.dtype, device=i.device)
    dis = torch.where(i < L, i, zero)
    gen = torch.where(i < L, i, torch.where(i < T, i - A, zero))
    return torch.where(mode == 0, dis, gen).long()


def to_additive(mask_bool, dtype=torch.float32):
    """(1 - mask) * -10000 additive bias."""
    zero = torch.zeros((), dtype=dtype, device=mask_bool.device)
    return torch.where(mask_bool, zero, zero + NEG_INF)


def text_self_bias(mode, ctx_end, ans_len, max_len: int,
                   dtype=torch.float32):
    """[..., 1, max_len, max_len] additive bias for text self-attention."""
    return to_additive(text_attention_mask(mode, ctx_end, ans_len, max_len),
                       dtype)[..., None, :, :]


def image_self_bias(image_mask, dtype=torch.float32):
    """[..., 1, 1, R] additive bias from a [..., R] region padding mask."""
    return to_additive(torch.as_tensor(image_mask) > 0,
                       dtype)[..., None, None, :]


def co_attention_bias(mode, ctx_end, ans_len, max_len: int,
                      dtype=torch.float32):
    """[..., 1, 1, max_len] additive bias for image-attends-text scores."""
    return to_additive(co_text_mask(mode, ctx_end, ans_len, max_len),
                       dtype)[..., None, None, :]


def quarter_bucket(ext_max: int, max_len: int, div: int = 4) -> int:
    """Smallest multiple of max_len/div covering ``ext_max`` (max_len when
    max_len is not divisible by div): the shared length-bucket rule."""
    if max_len % div:
        return max_len
    q = max_len // div
    return min(-(-max(int(ext_max), 1) // q) * q, max_len)
