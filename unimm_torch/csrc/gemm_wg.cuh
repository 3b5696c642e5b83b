// The Hopper GEMM core (gemm_wg_core.cuh) with the block kernels'
// residual + row-LayerNorm output product.
//
// launch_gemm_residual_ln: y = LN(fp32(A W^T) + bias + x) * gamma + beta for
// W [768, K]: the product with the bias + residual epilogue into an fp32
// [M, 768] buffer, then a one-warp-a-row LayerNorm (ln_rows_kernel,
// common.cuh's ln_row_store: two-pass fp32 statistics). launch_gemm_ln
// takes any such fp32 epilogue: the training block's MaskedResidualEpi,
// (acc + bias) * mo + x, goes through it.
#pragma once

#include "gemm_wg_core.cuh"

namespace {

// ---------------------------------------------------------------------------
// the product + bias + residual into fp32, then the row LayerNorm
// ---------------------------------------------------------------------------
struct ResidualEpi {  // pre = (acc + bias) + x, fp32
  static constexpr bool VEC = false;  // fp32 pairs: a quad stores 32 bytes
  const bf16* bias;
  const bf16* x;
  float* pre;
  __device__ __forceinline__ ResidualEpi at(int) const { return *this; }
  __device__ __forceinline__ void operator()(long row, int col, float v0,
                                             float v1) const {
    const long i = row * HID + col;
    const float2 b = __bfloat1622float2(
        __ldg(reinterpret_cast<const __nv_bfloat162*>(bias + col)));
    const float2 r = __bfloat1622float2(
        __ldg(reinterpret_cast<const __nv_bfloat162*>(x + i)));
    *reinterpret_cast<float2*>(pre + i) =
        make_float2((v0 + b.x) + r.x, (v1 + b.y) + r.y);
  }
};

// pre = (acc + bias) * mo + x, fp32, for a hidden-dropout scale mask mo
// [M, 768] fp32: the order of the TPU kernel's _train_fwd_kernel, each
// step rounded once (no fused multiply-add). A type of its own, so that
// ResidualEpi's instances keep their machine code.
struct MaskedResidualEpi {
  static constexpr bool VEC = false;
  const bf16* bias;
  const bf16* x;
  const float* mo;
  float* pre;
  __device__ __forceinline__ MaskedResidualEpi at(int) const { return *this; }
  __device__ __forceinline__ void operator()(long row, int col, float v0,
                                             float v1) const {
    const long i = row * HID + col;
    const float2 b = __bfloat1622float2(
        __ldg(reinterpret_cast<const __nv_bfloat162*>(bias + col)));
    const float2 r = __bfloat1622float2(
        __ldg(reinterpret_cast<const __nv_bfloat162*>(x + i)));
    const float2 m = __ldg(reinterpret_cast<const float2*>(mo + i));
    *reinterpret_cast<float2*>(pre + i) =
        make_float2(__fadd_rn(__fmul_rn(v0 + b.x, m.x), r.x),
                    __fadd_rn(__fmul_rn(v1 + b.y, m.y), r.y));
  }
};

constexpr int LN_WARPS = 8;

// y = (h - mean) * rsqrt(var + eps) * gamma + beta, one warp per row
__global__ void __launch_bounds__(LN_WARPS * 32)
    ln_rows_kernel(const float* __restrict__ pre,
                   const bf16* __restrict__ gamma,
                   const bf16* __restrict__ beta, float eps,
                   bf16* __restrict__ out, int M) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * LN_WARPS + warp;
  if (row >= M) return;
  const float* h = pre + row * HID;
  float v[HID / 32];
#pragma unroll
  for (int j = 0; j < HID / 32; ++j) v[j] = h[lane + 32 * j];
  ln_row_store(v, gamma, beta, eps, out + row * HID, lane);
}

// out = LN(e.pre) * gamma + beta: the product g (N 768) through the fp32
// pre-LayerNorm epilogue e (ResidualEpi, MaskedResidualEpi) into e.pre
// [M, 768], then ln_rows_kernel
template <class Epi>
cudaError_t launch_gemm_ln(const GemmArgs& g, const Epi& e,
                           const void* gamma, const void* beta, float eps,
                           void* out, cudaStream_t st) {
  cudaError_t err = launch_gemm_nt_wg(g, 1, e, st);
  if (err != cudaSuccess) return err;
  ln_rows_kernel<<<(g.M + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0, st>>>(
      e.pre, static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), eps, static_cast<bf16*>(out), g.M);
  return cudaGetLastError();
}

// out = LN(fp32(a W^T) + bias + x) * gamma + beta for a [M, K], W [768, K]
// (K % 64 == 0), x and out [M, 768], through pre [M, 768] fp32
cudaError_t launch_gemm_residual_ln(const void* a, const void* w,
                                    const void* bias, const void* x,
                                    const void* gamma, const void* beta,
                                    float eps, void* pre, void* out, int M,
                                    int K, cudaStream_t st) {
  const GemmArgs g{static_cast<const bf16*>(a),
                   {static_cast<const bf16*>(w), nullptr, nullptr}, M, HID,
                   K};
  const ResidualEpi e{static_cast<const bf16*>(bias),
                      static_cast<const bf16*>(x), static_cast<float*>(pre)};
  return launch_gemm_ln(g, e, gamma, beta, eps, out, st);
}

}  // namespace
