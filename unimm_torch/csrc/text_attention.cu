// Masked multi-head text self-attention of the per-head path
// (attention_impl="pallas"), forward and backward.
//
// Replaces the TPU kernel unimm_tpu/ops/pallas_attention.py:
// fused_text_attention (_call_fwd / _fwd_kernel and _call_bwd /
// _bwd_kernel). For q, k, v and do [B, H, L, 64] bf16 (32 <= L <= 256,
// L % 32 == 0) read through element strides (seq_attn.cuh's SeqLayout: the
// contiguous layout, or the head-split view of a [B, L, H 64] projection,
// which the wrapper passes without a copy), desc [B, 3] int32 and
// scale = 1 / sqrt(64):
//
// forward (unimm_text_attention_fwd): seq_attn_fwd_kernel<SCALE_SCORES>
//   (seq_attn_fwd.cuh: one score pass in registers, closed key chunks
//   skipped), one CTA per (64-row query tile, head, sequence):
//     s = (q k^T) * scale (fp32) + bias(desc);  p = softmax_fp32(s)
//     o = bf16(bf16(p) v)
//   q is not pre-scaled and rounded, unlike the block kernels' q.
// backward (unimm_text_attention_bwd): seq_attn_bwd_kernel<false, true>,
//   one CTA per (head, sequence), the probabilities recomputed in fp32:
//     dv = p^T do;  dp = do v^T;  ds = p (dp - rowsum(dp p))
//     dq = ds k scale;  dk = ds^T q scale;  each rounded to bf16 once.
//   The TPU kernel takes these products with fp32 operands. q, k, v and do
//   are bf16, so exact as bf16 operands; p and ds enter the bf16 tensor-core
//   products as hi + lo bf16 pairs (16 significand bits, relative error
//   <= 2^-17), each product exact in the fp32 accumulators: two mma.sync
//   where one would round p or ds to bf16, at the bf16 rate (989 TFLOP/s)
//   against TF32's 495 for one pass that keeps 11 bits.
//
// What bounds it on an H100: device memory. Forward: q, k, v read and o
// written, 4 B H L 64 x 2 bytes (403 MB at [256, 12, 256, 64], 0.12 ms at
// 3.35 TB/s) against 4 B H L^2 64 flops (52 GFLOP, 0.05 ms at the bf16
// peak). Backward: q, k, v, do read and dq, dk, dv written (661 MB at
// [240, 12, 256, 64], 0.20 ms) against five L x L x 64 products per head
// (121 GFLOP, 0.12 ms). Neither writes an [L, L] tensor or a mask to
// device memory. The forward's design against that bound is in
// seq_attn_fwd.cuh. The backward stages all four inputs per head and
// recomputes the scores three times: what a later design would cut.

#include "seq_attn_fwd.cuh"

extern "C" int unimm_text_attention_fwd(const void* q, const void* k,
                                        const void* v, const void* desc,
                                        void* out, int B, int H, int L,
                                        long sb, long sh, int sl,
                                        float scale, void* stream) {
  const SeqLayout lay{sb, sh, sl};
  const SeqAttnArgs a{static_cast<const bf16*>(q),
                      static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v),
                      static_cast<const int*>(desc),
                      static_cast<bf16*>(out),
                      lay, lay, B, H, L, 1, scale, DropArgs{0u, 0u, 1.0f}};
  return launch_seq_attn_fwd<SCALE_SCORES>(a,
                                           static_cast<cudaStream_t>(stream));
}

// the forward kernel's registers, local bytes, shared memory and CTAs an
// SM at length L (seq_attn_fwd_info); out: int32[4]
extern "C" int unimm_text_attention_fwd_info(int L, void* out) {
  return seq_attn_fwd_info<SCALE_SCORES>(L, static_cast<int*>(out));
}

extern "C" int unimm_text_attention_bwd(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* desc, void* dq, void* dk,
                                        void* dv, int B, int H, int L,
                                        long sb, long sh, int sl,
                                        float scale, void* stream) {
  const SeqLayout lay{sb, sh, sl};
  const SeqAttnBwdArgs a{static_cast<const bf16*>(q),
                         static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v),
                         static_cast<const bf16*>(dout),
                         static_cast<const int*>(desc),
                         static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                         static_cast<bf16*>(dv), lay, lay, L,
                         scale, scale, scale, DropArgs{0u, 0u, 1.0f}};
  return launch_seq_attn_bwd<false, true>(a, B, H,
                                          static_cast<cudaStream_t>(stream));
}
