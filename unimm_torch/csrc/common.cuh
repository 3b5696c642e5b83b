// Shared device helpers for the port's hand-written Hopper kernels.
//
// The mma.sync m16n8k16 building blocks (bf16 in, fp32 accumulators, with
// fragments loaded by ldmatrix from shared memory that cp.async fills),
// the GEMM core's arguments and projection epilogue (gemm_wg.cuh) and the
// row LayerNorm.
// Everything here is internal linkage: each .cu is compiled on its own and
// the objects are linked into one shared library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// The hidden width the kernels are built for (BERT-base text stream); the
// Python wrappers refuse any other width.
constexpr int HID = 768;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// LayerNorm of one 768-wide row held by a warp as 24 fp32 values per lane
// (column lane + 32 j): out = bf16((h - mean) * rsqrt(var + eps) * gamma +
// beta), two-pass fp32 statistics.
__device__ __forceinline__ void ln_row_store(const float (&h)[HID / 32],
                                             const bf16* gamma,
                                             const bf16* beta, float eps,
                                             bf16* out_row, int lane) {
  constexpr int PER = HID / 32;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < PER; ++j) s += h[j];
  const float mean = warp_sum(s) / HID;
  float v = 0.f;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const float d = h[j] - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / HID + eps);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = lane + 32 * j;
    out_row[c] = __float2bfloat16((h[j] - mean) * rstd *
                                      __bfloat162float(gamma[c]) +
                                  __bfloat162float(beta[c]));
  }
}

// 16-byte global->shared copy; when !valid the destination is zero-filled
// and nothing is read.
__device__ __forceinline__ void cp16(void* smem, const void* gmem,
                                     bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage a [rows, cols] bf16 tile (cols % 8 == 0) into shared memory with
// row pitch ld_s. Global row r starts at g + r * ld_g; rows >= valid_rows
// are zero-filled.
__device__ __forceinline__ void stage_tile(bf16* s, int ld_s, const bf16* g,
                                           long ld_g, int rows, int cols,
                                           int valid_rows, int tid,
                                           int nthreads) {
  const int vpr = cols / 8;
  for (int i = tid; i < rows * vpr; i += nthreads) {
    const int r = i / vpr, c = (i - r * vpr) * 8;
    const bool ok = r < valid_rows;
    cp16(s + r * ld_s + c, ok ? g + (long)r * ld_g + c : g, ok);
  }
}

// --------------------------------------------------------------------------
// mma.sync building blocks (bf16 m16n8k16, fp32 accumulators)
// --------------------------------------------------------------------------
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const bf16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// the same with each 8x8 matrix transposed (B operand from [k][n] rows)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// two floats -> one register of two bf16 (lo = a)
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a product C[M, N] = A[M, K] B[z][N, K]^T of gemm_wg.cuh's core: A and
// up to three B matrices (the Q/K/V projections share A)
struct GemmArgs {
  const bf16* a;
  const bf16* b[3];
  int M, N, K;
};

// one matrix's part of QkvEpi (gemm_wg.cuh's per-tile epilogue): y =
// bf16(acc + b), then bf16(fp32(y) * scale) where scale != 1, the bias
// read as one pair
struct QkvOne {
  static constexpr bool VEC = true;
  const bf16* b;
  bf16* y;
  float scale;
  int ld;
  __device__ __forceinline__ __nv_bfloat162 value(int col, float v0,
                                                  float v1) const {
    const float2 bb = __bfloat1622float2(
        __ldg(reinterpret_cast<const __nv_bfloat162*>(b + col)));
    bf16 o0 = __float2bfloat16(v0 + bb.x);
    bf16 o1 = __float2bfloat16(v1 + bb.y);
    if (scale != 1.0f) {
      o0 = __float2bfloat16(__bfloat162float(o0) * scale);
      o1 = __float2bfloat16(__bfloat162float(o1) * scale);
    }
    __nv_bfloat162 o;
    o.x = o0;
    o.y = o1;
    return o;
  }
  __device__ __forceinline__ bf16* row_ptr(long row) const {
    return y + row * ld;
  }
};

// ---- projection epilogue (grid z picks the matrix) -------------------------
// y[z] = bf16(acc + b[z]); where scale[z] != 1 additionally
// y[z] = bf16(fp32(y[z]) * scale[z]) (the 1 / sqrt(head_dim) query scale).
// Rows of y[z] are ld elements apart.
struct QkvEpi {
  const bf16* b[3];
  bf16* y[3];
  float scale[3];
  int ld;
  // matrix z's part, its fields selected without indexing (no local copy)
  __device__ __forceinline__ QkvOne at(int z) const {
    return z == 0   ? QkvOne{b[0], y[0], scale[0], ld}
           : z == 1 ? QkvOne{b[1], y[1], scale[1], ld}
                    : QkvOne{b[2], y[2], scale[2], ld};
  }
};

}  // namespace
