// BERT FFN block: y = LN(x + W2 act(W1 x + b1) + b2) * gamma + beta.
//
// Replaces the TPU kernel unimm_tpu/ops/pallas_attention_v2.py:
// fused_ffn_block (body _ffn_kernel) with its rounding points:
//   h = bf16(fp32(x W1^T) + b1);  a = bf16(act(h))
//   y = LN(fp32(a W2^T) + b2 + x)                  (fp32 statistics)
// act: 0 = gelu (tanh form, as the bf16 path computes it), 1 = relu,
// 2 = swish.
//
// Three launches: the first product with the bias + activation epilogue
// (gemm_nt_kernel, common.cuh), the second with the bias + residual
// epilogue into fp32, and a one-warp-per-row LayerNorm. What bounds it on an
// H100: 9.4 MFLOP per row against 3 KB of row traffic, so the tensor-core
// rate. Unlike the TPU kernel, the [rows, 3072] activation (bf16) and the
// [rows, 768] pre-LayerNorm sum (fp32) pass through device memory (about
// 7.7 KB a row each way, ~0.2 ms at 51200 rows): a fused row tile keeping
// them on chip has to be ~32 rows for its [rows, 768] fp32 accumulator to
// fit in registers, and then streams both weight matrices (9.4 MB) from L2
// for every 32 rows.

#include "common.cuh"

namespace {

__device__ __forceinline__ float activation(float v, int act) {
  if (act == 0)
    return 0.5f * v *
           (1.0f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  if (act == 1) return fmaxf(v, 0.0f);
  return v / (1.0f + expf(-v));
}

struct ActEpi {  // a = bf16(act(bf16(acc + b1)))
  const bf16* b1;
  bf16* a;
  int N, act;
  __device__ __forceinline__ void operator()(int, long row, int col, float v0,
                                             float v1) const {
    const bf16 h0 = __float2bfloat16(v0 + __bfloat162float(b1[col]));
    const bf16 h1 = __float2bfloat16(v1 + __bfloat162float(b1[col + 1]));
    __nv_bfloat162 o;
    o.x = __float2bfloat16(activation(__bfloat162float(h0), act));
    o.y = __float2bfloat16(activation(__bfloat162float(h1), act));
    *reinterpret_cast<__nv_bfloat162*>(a + row * N + col) = o;
  }
};

struct ResidualEpi {  // pre = (acc + b2) + x, fp32
  const bf16* b2;
  const bf16* x;
  float* pre;
  __device__ __forceinline__ void operator()(int, long row, int col, float v0,
                                             float v1) const {
    const long i = row * HID + col;
    float2 o;
    o.x = (v0 + __bfloat162float(b2[col])) + __bfloat162float(x[i]);
    o.y = (v1 + __bfloat162float(b2[col + 1])) + __bfloat162float(x[i + 1]);
    *reinterpret_cast<float2*>(pre + i) = o;
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

}  // namespace

extern "C" int unimm_ffn_block(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2,
                               const void* gamma, const void* beta,
                               void* act_buf, void* pre_buf, void* out, int M,
                               int inter, int act, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GemmArgs g1{static_cast<const bf16*>(x),
              {static_cast<const bf16*>(w1), nullptr, nullptr}, M, inter,
              HID};
  ActEpi e1{static_cast<const bf16*>(b1), static_cast<bf16*>(act_buf), inter,
            act};
  cudaError_t err = launch_gemm_nt(g1, 1, e1, st);
  if (err != cudaSuccess) return err;
  GemmArgs g2{static_cast<const bf16*>(act_buf),
              {static_cast<const bf16*>(w2), nullptr, nullptr}, M, HID,
              inter};
  ResidualEpi e2{static_cast<const bf16*>(b2), static_cast<const bf16*>(x),
                 static_cast<float*>(pre_buf)};
  err = launch_gemm_nt(g2, 1, e2, st);
  if (err != cudaSuccess) return err;
  ln_rows_kernel<<<(M + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0, st>>>(
      static_cast<const float*>(pre_buf), static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), eps, static_cast<bf16*>(out), M);
  return cudaGetLastError();
}
