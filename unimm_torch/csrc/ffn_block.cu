// BERT FFN block: y = LN(x + W2 act(W1 x + b1) + b2) * gamma + beta.
//
// Replaces the TPU kernel unimm_tpu/ops/pallas_attention_v2.py:
// fused_ffn_block (body _ffn_kernel) with its rounding points:
//   h = bf16(fp32(x W1^T) + b1);  a = bf16(act(h))
//   y = LN(fp32(a W2^T) + b2 + x)                  (fp32 statistics)
// act: 0 = gelu (tanh form, as the bf16 path computes it), 1 = relu,
// 2 = swish.
//
// Three launches on the Hopper GEMM core of gemm_wg.cuh: the first product
// with the bias + activation epilogue (a, bf16), the second with the bias
// + residual epilogue into fp32, then a one-warp-a-row LayerNorm
// (launch_gemm_residual_ln). What bounds it on an H100: 9.4 MFLOP per row
// against 3 KB of row traffic, so the tensor-core rate. Unlike the TPU
// kernel, the [rows, 3072] activation (bf16) and the [rows, 768]
// pre-LayerNorm sum (fp32) pass through device memory (about 6 + 3 KB a
// row each way, ~0.2 ms at 51200 rows). A CTA that owns 64 rows and all
// 768 columns can run the LayerNorm on its accumulators, but it streams
// all of W2 (4.7 MB) from L2 for every 64 rows: on an H100 that tile ran
// 0.98 ms against 0.47 + 0.08 for the product on 128 x 256 tiles and the
// row LayerNorm (PERF.md, section 6).

#include "gemm_wg.cuh"

namespace {

__device__ __forceinline__ float activation(float v, int act) {
  if (act == 0)
    return 0.5f * v *
           (1.0f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  if (act == 1) return fmaxf(v, 0.0f);
  return v / (1.0f + expf(-v));
}

struct ActEpi {  // a = bf16(act(bf16(acc + b1)))
  static constexpr bool VEC = false;
  const bf16* b1;
  bf16* a;
  int N, act;
  __device__ __forceinline__ ActEpi at(int) const { return *this; }
  __device__ __forceinline__ void operator()(long row, int col, float v0,
                                             float v1) const {
    const float2 b = __bfloat1622float2(
        __ldg(reinterpret_cast<const __nv_bfloat162*>(b1 + col)));
    const bf16 h0 = __float2bfloat16(v0 + b.x);
    const bf16 h1 = __float2bfloat16(v1 + b.y);
    __nv_bfloat162 o;
    o.x = __float2bfloat16(activation(__bfloat162float(h0), act));
    o.y = __float2bfloat16(activation(__bfloat162float(h1), act));
    *reinterpret_cast<__nv_bfloat162*>(a + row * N + col) = o;
  }
};

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
  cudaError_t err = launch_gemm_nt_wg(g1, 1, e1, st);
  if (err != cudaSuccess) return err;
  return launch_gemm_residual_ln(act_buf, w2, b2, x, gamma, beta, eps,
                                 pre_buf, out, M, inter, st);
}
