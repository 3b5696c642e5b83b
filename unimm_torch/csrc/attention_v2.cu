// Masked multi-head text attention with the scale folded into q: the
// attention bench's second-generation variant.
//
// Replaces the TPU kernel unimm_tpu/ops/pallas_attention_v2.py:
// attention_v2 (_v2_kernel). For q, k, v [B, H, L, 64] bf16 (32 <= L <=
// 256, L % 32 == 0) read through element strides, desc [B, 3] int32 and
// scale = 1 / sqrt(64):
//
//   q_s = bf16(q * scale), once per query tile as it is staged
//   s = q_s k^T (fp32) + bias(desc);  p = softmax_fp32(s)
//   o = bf16(bf16(p) v)
//
// seq_attn_fwd_kernel<SCALE_Q, false> (seq_attn_fwd.cuh: one score pass in
// registers, closed key chunks skipped), one CTA per (64-row query tile,
// head, block_b sequences). On the TPU, block_b sequences per grid step
// widen the DMA windows; here each CTA walks its block_b sequences in
// turn and loads the next sequence's K, q and V while it computes the
// current one, so block_b trades CTAs for overlapped loads and the result
// does not depend on it. At a head width of 64 the scale is 2^-3, so q_s
// is exact and the function equals the per-head kernel's
// (text_attention.cu) bit for bit on the same sums; the plain twins
// differ at other widths.
//
// What bounds it on an H100: device memory: q, k, v read and o written,
// 4 B H L 64 x 2 bytes (805 MB at [512, 12, 256, 64], 0.24 ms at 3.35 TB/s)
// against 4 B H L^2 64 flops (103 GFLOP, 0.10 ms at the bf16 peak).

#include "seq_attn_fwd.cuh"

extern "C" int unimm_attention_v2(const void* q, const void* k,
                                  const void* v, const void* desc, void* out,
                                  int B, int H, int L, long sb, long sh,
                                  int sl, int block_b, float scale,
                                  void* stream) {
  const SeqLayout lay{sb, sh, sl};
  const SeqAttnArgs a{static_cast<const bf16*>(q),
                      static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v),
                      static_cast<const int*>(desc),
                      static_cast<bf16*>(out),
                      lay, lay, B, H, L, block_b, scale,
                      DropArgs{0u, 0u, 1.0f}};
  return launch_seq_attn_fwd<SCALE_Q, false>(
      a, static_cast<cudaStream_t>(stream));
}

extern "C" int unimm_attention_v2_info(int L, void* out) {
  return seq_attn_fwd_info<SCALE_Q, false>(L, static_cast<int*>(out));
}
