// The output projection + residual + LayerNorm launch of the first design
// of the attention-style sub-block kernels, kept for the bench's probes
// (block_probe.cu, B10 and B11) alone: the answer block and the attention
// blocks run their output projection on gemm_wg.cuh's
// launch_gemm_residual_ln.
#pragma once

#include "common.cuh"

namespace {

// ---- output projection + residual + LayerNorm -----------------------------
// out = LN(fp32(ctx Wo^T) + bo + x) * gamma + beta for ctx [M, K] and
// Wo [768, K] (K % 32 == 0), x and out [M, 768]. (The kernel still takes
// a hidden-dropout scale mask mo [M, 768] fp32, the sum then (fp32(ctx
// Wo^T) + bo) * mo + x, from when the training block used it, so that its
// machine code stays the probes'; the launcher passes none.) One CTA per
// 32 rows holds all 768 output columns, so the LayerNorm runs in the same
// launch: 8 warps, warp w computes columns [96 w, 96 w + 96) of both
// 16-row halves (24 accumulator tiles), Wo streamed in k slices of 32.
constexpr int OL_ROWS = 32, OL_THREADS = 256, OL_BK = 32, OL_LD = OL_BK + 8;
constexpr int OL_LDC = HID + 4;  // pitch of the fp32 pre-LayerNorm tile

size_t out_ln_smem_bytes() {
  const size_t a = (size_t)2 * OL_ROWS * OL_LD * 2;
  const size_t w = (size_t)2 * HID * OL_LD * 2;
  const size_t c = (size_t)OL_ROWS * OL_LDC * 4;
  return a + (w > c ? w : c);
}

__global__ void __launch_bounds__(OL_THREADS)
    out_ln_kernel(const bf16* __restrict__ ctx, const bf16* __restrict__ x,
                  const bf16* __restrict__ wo, const bf16* __restrict__ bo,
                  const bf16* __restrict__ gamma,
                  const bf16* __restrict__ beta,
                  const float* __restrict__ mo, float eps,
                  bf16* __restrict__ out, int M, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);      // [2][32][OL_LD]
  bf16* sW = sA + 2 * OL_ROWS * OL_LD;           // [2][768][OL_LD]
  float* sC = reinterpret_cast<float*>(sW);      // epilogue, aliases sW
  const long m0 = (long)blockIdx.x * OL_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int valid = rows_left(m0, M, OL_ROWS);

  auto stage = [&](int st, int k0) {
    stage_tile(sA + st * OL_ROWS * OL_LD, OL_LD, ctx + m0 * K + k0, K,
               OL_ROWS, OL_BK, valid, tid, OL_THREADS);
    stage_tile(sW + st * HID * OL_LD, OL_LD, wo + k0, K, HID, OL_BK, HID,
               tid, OL_THREADS);
  };
  float acc[2][12][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;
  const int a_off = (lane & 15) * OL_LD + (lane >> 4) * 8;
  const int b_off = (warp * 96 + (lane & 7) + ((lane >> 4) << 3)) * OL_LD +
                    ((lane >> 3) & 1) * 8;
  const int NK = K / OL_BK;
  stage(0, 0);
  cp_commit();
  for (int kt = 0; kt < NK; ++kt) {
    if (kt + 1 < NK) stage((kt + 1) & 1, (kt + 1) * OL_BK);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* a = sA + (kt & 1) * OL_ROWS * OL_LD + a_off;
    const bf16* b = sW + (kt & 1) * HID * OL_LD + b_off;
#pragma unroll
    for (int kk = 0; kk < OL_BK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldmatrix_x4(af[i], a + i * 16 * OL_LD + kk);
#pragma unroll
      for (int jj = 0; jj < 6; ++jj) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, b + jj * 16 * OL_LD + kk);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jj], af[i], bfr[0], bfr[1]);
          mma_bf16(acc[i][2 * jj + 1], af[i], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();
  }
  const int gr = lane >> 2, gc = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(
            sC + (i * 16 + gr + hh * 8) * OL_LDC + warp * 96 + j * 8 + gc) =
            make_float2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
  __syncthreads();

  // h = (acc + bo) [* mo] + x, then LayerNorm
  for (int r = warp * 4; r < warp * 4 + 4 && r < valid; ++r) {
    float h[HID / 32];
#pragma unroll
    for (int j = 0; j < HID / 32; ++j) {
      const int c = lane + 32 * j;
      float o = sC[r * OL_LDC + c] + __bfloat162float(bo[c]);
      if (mo != nullptr) o *= mo[(m0 + r) * HID + c];
      h[j] = o + __bfloat162float(x[(m0 + r) * HID + c]);
    }
    ln_row_store(h, gamma, beta, eps, out + (m0 + r) * HID, lane);
  }
}

cudaError_t launch_out_ln(const void* ctx, const void* x, const void* wo,
                          const void* bo, const void* gamma, const void* beta,
                          float eps, void* out, int M, int K,
                          cudaStream_t st) {
  const size_t smem = out_ln_smem_bytes();
  cudaFuncSetAttribute(out_ln_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  out_ln_kernel<<<(M + OL_ROWS - 1) / OL_ROWS, OL_THREADS, smem, st>>>(
      static_cast<const bf16*>(ctx), static_cast<const bf16*>(x),
      static_cast<const bf16*>(wo), static_cast<const bf16*>(bo),
      static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta),
      nullptr, eps, static_cast<bf16*>(out), M, K);
  return cudaGetLastError();
}

}  // namespace
