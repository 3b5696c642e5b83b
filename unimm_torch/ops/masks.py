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

import numpy as np
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


def mask_bias(desc, max_len: int):
    """[B, max_len, max_len] fp32 additive text-mask bias from a [B, 3]
    (mode, ctx_end, ans_len) descriptor: the plain version of the bias the
    attention-block kernel makes in its body (the JAX package's
    ``ops/pallas_attention._mask_bias``, whose arithmetic select of the
    dis / gen zones equals this one for the modes 0 and 1)."""
    desc = torch.as_tensor(desc)
    return to_additive(text_attention_mask(desc[:, 0], desc[:, 1],
                                           desc[:, 2], max_len))


# The one-pass per-head attention kernel (csrc/seq_attn_fwd.cuh) holds a
# warp's ROW_TILE query rows against KEY_CHUNK-key chunks; the backward's
# kernels (csrc/seq_attn_bwd.cuh) a CTA's 64 rows (or keys) against
# KEY_CHUNK-key (or -row) chunks.
ROW_TILE = 16
KEY_CHUNK = 64


def row_intervals(desc, max_len: int):
    """Each query row's open keys as one interval plus at most the
    diagonal, the CPU twin of csrc/seq_attn_fwd.cuh's ``row_span`` (line for
    line): (lo, hi, diag, open), int64 [B, max_len] each but ``open`` (bool).
    Row i attends key j iff open and (lo <= j < hi or j == diag), which is
    ``text_attention_mask`` for any descriptor (mode 0 is dis, any other
    gen, as ``mask_bias`` selects them). A row that attends no key
    (open False) takes its softmax over all max_len keys at s - 10000,
    which is softmax(s) over them: its interval is [0, max_len), diag -1.

    gen zones, with T = min(L1 + A, max_len) and Lc = L1 - A: row 0
    [0, T); context rows [1, Lc); first-copy rows [1, i]; second-copy rows
    [1, i - A) and the diagonal; rows >= T none. dis: rows < L1 [0, L1)."""
    desc = torch.as_tensor(desc).long()
    mode, L1, A = (desc[:, k, None] for k in range(3))
    i = torch.arange(max_len, device=desc.device)[None, :]
    T = torch.clamp(L1 + A, max=max_len)
    Lc = L1 - A
    zero, one, none = (torch.full_like(i + L1, v) for v in (0, 1, -1))
    gen = mode != 0
    lo = torch.where(~gen | (i == 0), zero, one)
    hi = torch.where(
        ~gen, torch.where(i < L1, L1, zero),
        torch.where(i == 0, T,
                    torch.where(i < Lc, Lc,
                                torch.where(i < L1, i + 1,
                                            torch.where(i < T, i - A,
                                                        zero)))))
    diag = torch.where(gen & (i != 0) & (i >= Lc) & (i >= L1) & (i < T),
                       i + zero, none)
    hi = torch.maximum(torch.clamp(hi, max=max_len), lo)
    is_open = (hi > lo) | (diag >= 0)
    lo = torch.where(is_open, lo, zero)
    hi = torch.where(is_open, hi, zero + max_len)
    return lo, hi, diag, is_open


def chunk_closed(desc, max_len: int, row0: int, rows: int, c: int) -> bool:
    """Whether no query row in [row0, row0 + rows) of the sequence with
    descriptor ``desc`` (mode, ctx_end, ans_len) attends any key of chunk
    c, keys [c KEY_CHUNK, min((c + 1) KEY_CHUNK, max_len)): the one-pass
    kernel's skip rule, per warp of ROW_TILE rows, and the backward's dq
    kernel's, per CTA of 64 rows. A row that attends no
    key weighs every key, so it closes no chunk. Skipping is exact: a row
    with an open key gives each masked key exp(s - 10000 - max) = 0 in
    fp32."""
    lo, hi, diag, _ = (t[0, row0:row0 + rows] for t in row_intervals(
        torch.as_tensor(desc).reshape(1, 3), max_len))
    k0 = c * KEY_CHUNK
    k1 = min(k0 + KEY_CHUNK, max_len)
    hit = ((torch.clamp(lo, min=k0) < torch.clamp(hi, max=k1))
           | ((diag >= k0) & (diag < k1)))
    return not bool(hit.any())


def query_chunk_closed(desc, max_len: int, key0: int, keys: int,
                       c: int) -> bool:
    """Whether no query row of chunk c, rows [c KEY_CHUNK, min((c + 1)
    KEY_CHUNK, max_len)), of the sequence with descriptor ``desc`` attends
    any key of [key0, key0 + keys): the backward's dk / dv kernel's skip
    rule (csrc/seq_attn_bwd.cuh, per CTA of 64 keys), the transpose of
    ``chunk_closed``. A row that attends no key weighs every key, so a
    chunk holding one is never closed. Skipping is exact for the same
    reason as ``chunk_closed``'s."""
    lo, hi, diag, _ = (t[0] for t in row_intervals(
        torch.as_tensor(desc).reshape(1, 3), max_len))
    r0 = c * KEY_CHUNK
    r1 = min(r0 + KEY_CHUNK, max_len)
    lo, hi, diag = lo[r0:r1], hi[r0:r1], diag[r0:r1]
    k1 = key0 + keys
    hit = ((torch.clamp(lo, min=key0) < torch.clamp(hi, max=k1))
           | ((diag >= key0) & (diag < k1)))
    return not bool(hit.any())


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


def attended_extent(mode, ctx_end, ans_len, max_len: int, mlm_labels=None):
    """Host-side (numpy) per-sequence attended extent: the first row/column
    index past which the self-attention mask is all closed. dis: ctx_end;
    gen: ctx_end + ans_len (rows >= T attend nothing and no open row
    reaches past T). With ``mlm_labels`` the label positions bound the
    extent too, a guard for synthetic inputs. Scoring a sequence at any
    padded length >= its extent gives the same scores (the length buckets
    of the flat scorer)."""
    mode = np.asarray(mode)
    ext = np.where(mode == 0, np.asarray(ctx_end),
                   np.asarray(ctx_end) + np.asarray(ans_len))
    if mlm_labels is not None:
        labs = np.asarray(mlm_labels)
        ext = np.maximum(ext, ((labs != -1) *
                               np.arange(1, labs.shape[-1] + 1)).max(-1))
    return np.clip(ext, 1, max_len)


def quarter_bucket(ext_max: int, max_len: int, div: int = 4) -> int:
    """Smallest multiple of max_len/div covering ``ext_max`` (max_len when
    max_len is not divisible by div): the shared length-bucket rule."""
    if max_len % div:
        return max_len
    q = max_len // div
    return min(-(-max(int(ext_max), 1) // q) * q, max_len)
