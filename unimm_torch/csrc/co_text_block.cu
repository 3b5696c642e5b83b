// Text side of a co-attention (connection) layer: text queries attend the
// image regions, then dense2 + residual + LayerNorm2.
//
// Replaces the TPU kernel unimm_tpu/ops/pallas_attention_v2.py:
// fused_co_text_block (body _co_text_kernel). For t_x [B, L, 768], v_x
// [B, R, 1024] (R <= 64 regions) and image_mask [B, R] it computes, in 8
// heads of 128,
//
//   q2 = bf16(t Wq2^T + bq2);  q2 = bf16(fp32(q2) / sqrt(128))
//   k1, v1 = bf16(v_x W^T + b)
//   s = q2_h k1_h^T (fp32) + (image_mask > 0 ? 0 : -10000)
//   p = bf16(softmax_fp32(s) over the R regions);  ctx_h = bf16(p v1_h)
//   y = LN2(fp32(ctx Wd2^T) + bd2 + t) * gamma + beta         (eps 1e-12)
//
// with the TPU kernel's rounding points. Five launches:
//   1. gemm_nt_wg_kernel  q2 projection, 768 -> 1024 (gemm_wg.cuh)
//   2. gemm_nt_wg_kernel  k1 and v1 projections of the B R region rows
//   3. co_attn_kernel   one CTA per (64-row query tile, head, sequence):
//                       the sequence's R keys and values for the head are
//                       staged in shared memory padded to 64 rows; all 64
//                       scores of a row sit in registers, so one exact
//                       softmax pass feeds P V. The padding rows are kept
//                       out of the softmax by their count (-inf), never by
//                       a -10000 bias: a sequence whose regions are all
//                       masked takes its softmax over exactly R keys.
//   4. gemm_nt_wg_kernel  Wd2 (K = 1024) + bd2 + residual into fp32, then
//      ln_rows_kernel     LayerNorm2, one warp a row (gemm_wg.cuh's
//                         launch_gemm_residual_ln)
// What bounds it on an H100: 2 M 768 1024 (q2) + 4 B R 1024^2 (k1, v1) +
// 4 M R 1024 (scores, P V) + 2 M 1024 768 (dense2) flops, ~0.23 TFLOP at
// [256, 224, 768] x [256, 37, 1024], against ~0.2 GB of inputs, output and
// weights: the tensor-core rate. Unlike the TPU kernel, q2 / k1 / v1 / ctx
// and the fp32 pre-LayerNorm sum pass through device memory between the
// launches.

#include "gemm_wg.cuh"

namespace {

constexpr int CO_HID = 1024;  // bi_hidden_size = v_hidden_size
constexpr int CO_D = 128, CO_QT = 64, CO_THREADS = 128, CO_KP = 64;
constexpr int CO_LD = CO_D + 8;
constexpr size_t CO_SMEM = (size_t)(CO_QT + 2 * CO_KP) * CO_LD * 2;

__global__ void __launch_bounds__(CO_THREADS)
    co_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v,
                   const float* __restrict__ image_mask,
                   bf16* __restrict__ ctx, int L, int R) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [CO_QT][CO_LD]
  bf16* sK = sQ + CO_QT * CO_LD;             // [CO_KP][CO_LD]
  bf16* sV = sK + CO_KP * CO_LD;             // [CO_KP][CO_LD]

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * CO_QT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long qbase = (long)b * L * CO_HID + (long)h * CO_D;
  const long kbase = (long)b * R * CO_HID + (long)h * CO_D;
  stage_tile(sQ, CO_LD, q + qbase + (long)row0 * CO_HID, CO_HID, CO_QT,
             CO_D, min(CO_QT, L - row0), tid, CO_THREADS);
  stage_tile(sK, CO_LD, k + kbase, CO_HID, CO_KP, CO_D, R, tid, CO_THREADS);
  stage_tile(sV, CO_LD, v + kbase, CO_HID, CO_KP, CO_D, R, tid, CO_THREADS);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  // L % 16 == 0: a warp's 16 rows are all inside the sequence or all past
  // it; no barrier follows, so a warp past the end leaves here
  if (row0 + warp * 16 >= L) return;

  const int gr = lane >> 2, gc = (lane & 3) * 2;
  const int kb_off = ((lane & 7) + ((lane >> 4) << 3)) * CO_LD +
                     ((lane >> 3) & 1) * 8;
  const int vb_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * CO_LD +
                     (lane >> 4) * 8;
  float sc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t) sc[j][t] = 0.f;
#pragma unroll
  for (int kd = 0; kd < CO_D / 16; ++kd) {
    uint32_t qf[4];
    ldmatrix_x4(qf, sQ + (warp * 16 + (lane & 15)) * CO_LD + kd * 16 +
                        (lane >> 4) * 8);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t kf[4];
      ldmatrix_x4(kf, sK + kb_off + jj * 16 * CO_LD + kd * 16);
      mma_bf16(sc[2 * jj], qf, kf[0], kf[1]);
      mma_bf16(sc[2 * jj + 1], qf, kf[2], kf[3]);
    }
  }
  // image padding bias on the R real keys; the padding keys leave the
  // softmax (exp(-inf) = 0)
  const float* im = image_mask + (long)b * R;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int col = j * 8 + gc + (t & 1);
      sc[j][t] = col < R ? sc[j][t] + (im[col] > 0.f ? 0.f : -10000.0f)
                         : -INFINITY;
    }
  // exact fp32 softmax of rows gr (index 0) and gr + 8 (1)
  float sum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float cm = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      cm = fmaxf(cm, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
    cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1));
    cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 2));
    float e = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j][2 * r] = expf(sc[j][2 * r] - cm);
      sc[j][2 * r + 1] = expf(sc[j][2 * r + 1] - cm);
      e += sc[j][2 * r] + sc[j][2 * r + 1];
    }
    e += __shfl_xor_sync(0xffffffffu, e, 1);
    e += __shfl_xor_sync(0xffffffffu, e, 2);
    sum[r] = e;
  }

  float o[CO_D / 8][4];
#pragma unroll
  for (int j = 0; j < CO_D / 8; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t) o[j][t] = 0.f;
#pragma unroll
  for (int t = 0; t < CO_KP / 16; ++t) {  // k16 step: keys 16 t .. 16 t + 15
    uint32_t pa[4];
    const float (&s0)[4] = sc[2 * t], (&s1)[4] = sc[2 * t + 1];
    pa[0] = pack_bf16(s0[0] / sum[0], s0[1] / sum[0]);
    pa[1] = pack_bf16(s0[2] / sum[1], s0[3] / sum[1]);
    pa[2] = pack_bf16(s1[0] / sum[0], s1[1] / sum[0]);
    pa[3] = pack_bf16(s1[2] / sum[1], s1[3] / sum[1]);
#pragma unroll
    for (int jj = 0; jj < CO_D / 16; ++jj) {  // head-dim columns 16 jj ..
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, sV + vb_off + t * 16 * CO_LD + jj * 16);
      mma_bf16(o[2 * jj], pa, vf[0], vf[1]);
      mma_bf16(o[2 * jj + 1], pa, vf[2], vf[3]);
    }
  }

  // each head's context rounds to bf16
  bf16* out_a = ctx + qbase + (long)(row0 + warp * 16 + gr) * CO_HID;
  bf16* out_b = out_a + 8 * CO_HID;
#pragma unroll
  for (int j = 0; j < CO_D / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(out_a + j * 8 + gc) =
        __floats2bfloat162_rn(o[j][0], o[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(out_b + j * 8 + gc) =
        __floats2bfloat162_rn(o[j][2], o[j][3]);
  }
}

}  // namespace

extern "C" int unimm_co_text_block(
    const void* t_x, const void* v_x, const void* image_mask,
    const void* wq2, const void* bq2, const void* wk1, const void* bk1,
    const void* wv1, const void* bv1, const void* wd2, const void* bd2,
    const void* gamma, const void* beta, void* q_buf, void* k_buf,
    void* v_buf, void* ctx_buf, void* pre_buf, void* out, int B, int L, int R,
    float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * L;
  const float q_scale = 0.08838834764831845f;  // 1 / sqrt(head_dim 128)
  GemmArgs gq{static_cast<const bf16*>(t_x),
              {static_cast<const bf16*>(wq2), nullptr, nullptr},
              M, CO_HID, HID};
  QkvEpi eq{{static_cast<const bf16*>(bq2), nullptr, nullptr},
            {static_cast<bf16*>(q_buf), nullptr, nullptr},
            {q_scale, 1.0f, 1.0f},
            CO_HID};
  cudaError_t err = launch_gemm_nt_wg(gq, 1, eq, st);
  if (err != cudaSuccess) return err;

  GemmArgs gkv{static_cast<const bf16*>(v_x),
               {static_cast<const bf16*>(wk1), static_cast<const bf16*>(wv1),
                nullptr},
               B * R, CO_HID, CO_HID};
  QkvEpi ekv{{static_cast<const bf16*>(bk1), static_cast<const bf16*>(bv1),
              nullptr},
             {static_cast<bf16*>(k_buf), static_cast<bf16*>(v_buf), nullptr},
             {1.0f, 1.0f, 1.0f},
             CO_HID};
  err = launch_gemm_nt_wg(gkv, 2, ekv, st);
  if (err != cudaSuccess) return err;

  cudaFuncSetAttribute(co_attn_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)CO_SMEM);
  dim3 grid((L + CO_QT - 1) / CO_QT, CO_HID / CO_D, B);
  co_attn_kernel<<<grid, CO_THREADS, CO_SMEM, st>>>(
      static_cast<const bf16*>(q_buf), static_cast<const bf16*>(k_buf),
      static_cast<const bf16*>(v_buf),
      static_cast<const float*>(image_mask), static_cast<bf16*>(ctx_buf), L,
      R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  return launch_gemm_residual_ln(ctx_buf, wd2, bd2, t_x, gamma, beta, eps,
                                 pre_buf, out, M, CO_HID, st);
}
