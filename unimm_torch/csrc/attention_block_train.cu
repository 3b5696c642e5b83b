// Differentiable whole-sequence BERT attention sub-block of the training
// step, with in-kernel attention-probability dropout.
//
// Replaces the TPU kernel unimm_tpu/ops/pallas_attention_v2.py:
// fused_attention_block_train (_train_call_fwd / _train_fwd_kernel and
// _train_call_bwd / _train_bwd_kernel). For x [B, L, 768] bf16 (L % 32 ==
// 0, 32 <= L <= 256), desc [B, 3] int32 and a hidden-dropout scale mask
// mo [B, L, 768] fp32 (or none):
//
// forward  (unimm_attention_block_train_fwd), four launches:
//   1. gemm_nt_wg_kernel<QkvEpi>  q, k, v = bf16(x W^T + b);
//                       q = bf16(fp32(q) / 8), on the Hopper GEMM core
//                       (gemm_wg.cuh: TMA loads, wgmma, persistent over
//                       128 x 256 tiles), as B4's and K1's projections
//   2. seq_attn_fwd_kernel<SCALE_NONE, DROP>, B4's one-pass attention
//                       (seq_attn_fwd.cuh) with the dropout in its loop:
//                       p = softmax_fp32(s + bias(desc)) * Philox mask;
//                       ctx_h = bf16(bf16(p) v_h), each unnormalised
//                       probability rounded, the row sum of the undropped
//                       ones divided out once; closed key chunks skipped
//                       (they draw nothing)
//   3. gemm_nt_wg_kernel<MaskedResidualEpi> (or <ResidualEpi> without mo)
//      + 4. ln_rows_kernel: pre = (fp32(ctx Wo^T) + bo) * mo + x into an
//                       fp32 [M, 768] scratch, then y = LN(pre)
//                       (gemm_wg.cuh's launch_gemm_ln); ctx is kept for
//                       the backward
// backward (unimm_attention_block_train_bwd), four launches:
//   1. gemm_nt_wg_kernel<QkvEpi>  recompute q_s, k, v as in the forward
//                       (the TPU kernel recomputes them too; keeping them
//                       would hold 3 x [B, L, 768] bf16 a layer)
//   2. seq_attn_bwd_dq_kernel<DROP, false> and
//      seq_attn_bwd_dkdv_kernel<DROP, false> (seq_attn_bwd.cuh, shared
//      with the per-head text attention, launched through seq_attn_bwd.cu),
//      one CTA per (64-row tile, head, sequence) each:
//        a. per query row: the softmax's lse and D = sum_j dP_ij P_ij (dP =
//           dctx v^T * mask) in one online pass over the key chunks, to an
//           fp32 scratch [B, 12, 2, L]; then dS = P (dP - D) and dq =
//           bf16(dS k / 8) in a second pass;
//        b. per key row, over the query chunks: the same P and dS
//           transposed from lse and D; dv = bf16(Pd^T dctx), dk =
//           bf16(dS^T q_s) (Pd = P * mask).
//      Each tile draws its own rows' or columns' dropout bits from the
//      forward's Philox stream (philox.cuh). P, Pd and dS enter the
//      wgmma products rounded to bf16 (the plain twin,
//      ops/attention_block_train.py, rounds them at the same points).
//   3. gemm_nt_wg_kernel<StoreEpi>  dx_qkv = bf16([dq | dk | dv] [Wq; Wk;
//                       Wv]), one product with K = 2304 against the
//                       transposed weights, on the GEMM core
// The LayerNorm / Wo side of the backward and the weight gradients are
// large dense products that the TPU kernel also leaves outside; the
// wrapper runs them in PyTorch. A product the GEMM core does not take
// (launch_gemm_nt_wg's rule) returns its error: nothing falls back to
// another core.
//
// What bounds it on an H100: the tensor-core rate. Forward 8 M 768^2 + 4 B
// L^2 768 flops; backward 8 M 768^2 (recompute, dx) + 9 x 2 B L^2 768 (the
// scores three times, dP three times, dq, dk, dv) against ~0.2 GB of x,
// dctx, outputs and weights. q, k, v, ctx, the forward's pre-LayerNorm sum
// (fp32), [dq | dk | dv] and the rows' lse and D pass through device
// memory between launches; no [L, L] tensor leaves the SM.

#include "gemm_wg.cuh"
#include "seq_attn_fwd.cuh"

namespace {

// y = bf16(acc) with row pitch ld (the dx product): the core's vector
// store, 16 bytes a lane
struct StoreEpi {
  static constexpr bool VEC = true;
  bf16* y;
  int ld;
  __device__ __forceinline__ StoreEpi at(int) const { return *this; }
  __device__ __forceinline__ __nv_bfloat162 value(int, float v0,
                                                  float v1) const {
    return __floats2bfloat162_rn(v0, v1);
  }
  __device__ __forceinline__ bf16* row_ptr(long row) const {
    return y + row * ld;
  }
};

constexpr int QKV = 3 * HID;  // row pitch of the [dq | dk | dv] buffer

cudaError_t launch_qkv(const void* x, const void* wq, const void* bq,
                       const void* wk, const void* bk, const void* wv,
                       const void* bv, void* q_buf, void* k_buf, void* v_buf,
                       int M, cudaStream_t st) {
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
  return launch_gemm_nt_wg(g, 3, e, st);
}

}  // namespace

extern "C" int unimm_attention_block_train_fwd(
    const void* x, const void* desc, const void* wq, const void* bq,
    const void* wk, const void* bk, const void* wv, const void* bv,
    const void* wo, const void* bo, const void* gamma, const void* beta,
    const void* mo, void* q_buf, void* k_buf, void* v_buf, void* ctx_buf,
    void* pre_buf, void* out, int B, int L, float eps, unsigned seed,
    unsigned thresh, float inv_keep, int drop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * L;
  cudaError_t err = launch_qkv(x, wq, bq, wk, bk, wv, bv, q_buf, k_buf,
                               v_buf, M, st);
  if (err != cudaSuccess) return err;
  const DropArgs d{seed, thresh, inv_keep};
  err = drop ? launch_block_attn_fwd<true>(q_buf, k_buf, v_buf, desc,
                                           ctx_buf, B, L, d, st)
             : launch_block_attn_fwd<false>(q_buf, k_buf, v_buf, desc,
                                            ctx_buf, B, L, d, st);
  if (err != cudaSuccess) return err;
  if (mo == nullptr)
    return launch_gemm_residual_ln(ctx_buf, wo, bo, x, gamma, beta, eps,
                                   pre_buf, out, M, HID, st);
  const GemmArgs g{static_cast<const bf16*>(ctx_buf),
                   {static_cast<const bf16*>(wo), nullptr, nullptr}, M, HID,
                   HID};
  const MaskedResidualEpi e{static_cast<const bf16*>(bo),
                            static_cast<const bf16*>(x),
                            static_cast<const float*>(mo),
                            static_cast<float*>(pre_buf)};
  return launch_gemm_ln(g, e, gamma, beta, eps, out, st);
}

// the forward's attention launch (drop: the instance with dropout):
// registers, local bytes, shared memory and CTAs an SM at length L
extern "C" int unimm_attention_block_train_fwd_info(int L, int drop,
                                                    void* out) {
  int* o = static_cast<int*>(out);
  return drop ? seq_attn_fwd_info<SCALE_NONE, true>(L, o)
              : seq_attn_fwd_info<SCALE_NONE, false>(L, o);
}

extern "C" int unimm_attention_block_train_bwd(
    const void* x, const void* dctx, const void* desc, const void* wq,
    const void* bq, const void* wk, const void* bk, const void* wv,
    const void* bv, const void* w_cat_t, void* q_buf, void* k_buf,
    void* v_buf, void* dqkv, void* dx, void* stats, int B, int L,
    unsigned seed, unsigned thresh, float inv_keep, int drop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * L;
  cudaError_t err = launch_qkv(x, wq, bq, wk, bk, wv, bv, q_buf, k_buf,
                               v_buf, M, st);
  if (err != cudaSuccess) return err;
  // the attention backward on the heads of the [B, L, 768] projections
  // into [dq | dk | dv] [B, L, 2304]; dq through the q scale 1/8
  bf16* d = static_cast<bf16*>(dqkv);
  err = static_cast<cudaError_t>(unimm_seq_attn_bwd(
      q_buf, k_buf, v_buf, dctx, desc, d, d + HID, d + 2 * HID, stats,
      (long)L * HID, SA_D, HID, (long)L * QKV, SA_D, QKV, B, HID / SA_D, L,
      1.0f, 0.125f, 1.0f, seed, thresh, inv_keep, drop, 0, st));
  if (err != cudaSuccess) return err;
  // dx = [dq | dk | dv] [Wq; Wk; Wv]: C = A B^T with B = [Wq; Wk; Wv]^T
  const GemmArgs g{static_cast<const bf16*>(dqkv),
                   {static_cast<const bf16*>(w_cat_t), nullptr, nullptr},
                   M, HID, QKV};
  return launch_gemm_nt_wg(g, 1, StoreEpi{static_cast<bf16*>(dx), HID}, st);
}
