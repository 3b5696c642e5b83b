// Whole-sequence BERT attention sub-block of the flat scorer, with the
// text mask made in the kernel from the (mode, ctx_end, ans_len)
// descriptor.
//
// Replaces the TPU kernel unimm_tpu/ops/pallas_attention_v2.py:
// fused_attention_block (body _block_kernel, mask from
// unimm_tpu/ops/pallas_attention.py:_mask_bias). For x [B, L, 768]
// (L % 32 == 0, 32 <= L <= 256) and desc [B, 3] int32 it computes
//
//   q, k, v = bf16(x W^T + b);  q = bf16(fp32(q) / 8)
//   s = q_h k_h^T (fp32) + bias(desc, i, j)        (0 or -10000)
//   p = softmax_fp32(s);  ctx_h = bf16(bf16(p) v_h)
//   y = LN(fp32(ctx Wo^T) + bo + x) * gamma + beta            (eps 1e-12)
//
// with the TPU kernel's rounding points, but for p's: the attention rounds
// each unnormalised probability and divides by the row sum once
// (seq_attn_fwd.cuh), one bf16 rounding of each term either way. Four
// launches, the first and the last two on the Hopper GEMM core
// (gemm_wg.cuh), as the answer block's (answer_block.cu):
//   1. gemm_nt_wg_kernel<QkvEpi>   Q/K/V projection: TMA loads, wgmma,
//                                  persistent over 128 x 256 tiles;
//                                  QkvEpi's per-matrix at(z) rounds q, k, v
//                                  to bf16 after the bias and q once more
//                                  after the 1/8 scale
//   2. seq_attn_fwd_kernel         one-pass online softmax, one CTA per
//                                  (64-row query tile, head, block_b
//                                  sequences walked in turn)
//                                  (seq_attn_fwd.cuh, shared with the
//                                  training block and the per-head
//                                  attention)
//   3. gemm_nt_wg_kernel<ResidualEpi> + 4. ln_rows_kernel: the output
//      projection with the bias + residual into fp32, then the row
//      LayerNorm (launch_gemm_residual_ln)
// What bounds it on an H100: 8 M 768^2 + 4 B L^2 768 flops (0.36 TFLOP at
// [256, 256, 768]) against ~0.2 GB of x, output and weights: the
// tensor-core rate. Unlike the TPU kernel, q/k/v and ctx ([B, L, 768] bf16
// each) and the pre-LayerNorm sum ([B, L, 768] fp32) pass through device
// memory between the launches; the [L, L] scores and probabilities never
// leave registers, and no [B, L, L] mask exists.
// A 64-key chunk that all 16 rows of a warp leave closed is skipped (no
// score, exp or P.V: exact, its probabilities are 0 in fp32). Rows past a
// sequence's extent are fully masked and, as in the TPU kernel, take their
// softmax over all L keys (without the constant -10000, which the softmax
// cancels). block_b (the TPU kernel's sequences per grid step) only trades
// CTAs for per-CTA work: each CTA computes every sequence it walks on its
// own, so the result does not depend on it. A product the GEMM core does
// not take (launch_gemm_nt_wg's rule) returns its error: nothing falls
// back to another core.

#include "gemm_wg.cuh"
#include "seq_attn_fwd.cuh"

extern "C" int unimm_attention_block(
    const void* x, const void* desc, const void* wq, const void* bq,
    const void* wk, const void* bk, const void* wv, const void* bv,
    const void* wo, const void* bo, const void* gamma, const void* beta,
    void* q_buf, void* k_buf, void* v_buf, void* ctx_buf, void* pre_buf,
    void* out, int B, int L, int block_b, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * L;
  const GemmArgs g{static_cast<const bf16*>(x),
                   {static_cast<const bf16*>(wq), static_cast<const bf16*>(wk),
                    static_cast<const bf16*>(wv)},
                   M, HID, HID};
  const QkvEpi e{{static_cast<const bf16*>(bq), static_cast<const bf16*>(bk),
                  static_cast<const bf16*>(bv)},
                 {static_cast<bf16*>(q_buf), static_cast<bf16*>(k_buf),
                  static_cast<bf16*>(v_buf)},
                 {0.125f, 1.0f, 1.0f},  // q scale: 1 / sqrt(head_dim 64)
                 HID};
  cudaError_t err = launch_gemm_nt_wg(g, 3, e, st);
  if (err != cudaSuccess) return err;

  err = launch_block_attn_fwd<false>(q_buf, k_buf, v_buf, desc, ctx_buf, B,
                                     L, DropArgs{0u, 0u, 1.0f}, st, block_b);
  if (err != cudaSuccess) return err;

  return launch_gemm_residual_ln(ctx_buf, wo, bo, x, gamma, beta, eps,
                                 pre_buf, out, M, HID, st);
}

// the attention launch's registers, local bytes, shared memory and CTAs
// an SM at length L (seq_attn_fwd_info); out: int32[4]
extern "C" int unimm_attention_block_info(int L, void* out) {
  return seq_attn_fwd_info<SCALE_NONE, false>(L, static_cast<int*>(out));
}
