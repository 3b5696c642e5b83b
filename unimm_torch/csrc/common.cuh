// Shared device helpers for the port's hand-written Hopper kernels.
//
// The mma.sync m16n8k16 building blocks (bf16 in, fp32 accumulators, with
// fragments loaded by ldmatrix from shared memory that cp.async fills),
// the first design's GEMM core (gemm_nt_kernel: now the bench's probes'
// alone; the block kernels' products run on gemm_wg.cuh), the projection
// epilogues and the row LayerNorm.
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

// Rows of a tile starting at row m0 that lie inside [0, M), at most cap.
__device__ __forceinline__ int rows_left(long m0, int M, int cap) {
  const long n = M - m0;
  return n < cap ? (int)n : cap;
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

// --------------------------------------------------------------------------
// C[M, N] = A[M, K] B[N, K]^T (both K-contiguous, the torch Linear layout)
// with an epilogue functor. CTA tile 128 x 128, k step 64, 3-stage cp.async
// ring (two CTAs fit an SM), 8 warps as 4 (rows) x 2 (columns) of 32 x 64;
// fragments come from shared memory by ldmatrix (row pitch 72 elements:
// conflict-free) and multiply with mma.sync m16n8k16. Needs N % 128 == 0
// and K % 64 == 0; rows
// past M are zero-filled and never stored. blockIdx.z selects one of up to
// three B matrices (the Q/K/V projections share A). The epilogue is called
// as epi(z, row, col, v0, v1) for the two adjacent columns col, col + 1.
// Launched by the bench's probes (block_probe.cu, B10 and B11) alone.
// --------------------------------------------------------------------------
constexpr int GM_BM = 128, GM_BN = 128, GM_BK = 64, GM_LD = GM_BK + 8;
constexpr int GM_STAGES = 3, GM_THREADS = 256;
constexpr size_t GM_SMEM = (size_t)GM_STAGES * (GM_BM + GM_BN) * GM_LD * 2;

struct GemmArgs {
  const bf16* a;
  const bf16* b[3];
  int M, N, K;
};

template <class Epi>
__global__ void __launch_bounds__(GM_THREADS)
    gemm_nt_kernel(GemmArgs g, Epi epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);                  // [S][BM][LD]
  bf16* sB = sA + GM_STAGES * GM_BM * GM_LD;                 // [S][BN][LD]
  const int z = blockIdx.z;
  const bf16* __restrict__ A = g.a;
  const bf16* __restrict__ B = g.b[z];
  const int n0 = blockIdx.x * GM_BN;
  const long m0 = (long)blockIdx.y * GM_BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int valid = rows_left(m0, g.M, GM_BM);
  const int nk = g.K / GM_BK;

  auto stage = [&](int st, int kt) {
    const int k0 = kt * GM_BK;
    stage_tile(sA + st * GM_BM * GM_LD, GM_LD, A + m0 * g.K + k0, g.K, GM_BM,
               GM_BK, valid, tid, GM_THREADS);
    stage_tile(sB + st * GM_BN * GM_LD, GM_LD, B + (long)n0 * g.K + k0, g.K,
               GM_BN, GM_BK, GM_BN, tid, GM_THREADS);
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;

#pragma unroll
  for (int s = 0; s < GM_STAGES - 1; ++s) {
    if (s < nk) stage(s, s);
    cp_commit();
  }
  // per-lane ldmatrix offsets: A 16x16 (rows lane%16, k half lane/16);
  // B two n8 x k16 tiles (n lane%8 + 8 (lane/16), k half (lane/8)%2)
  const int a_off = (wm * 32 + (lane & 15)) * GM_LD + (lane >> 4) * 8;
  const int b_off = (wn * 64 + (lane & 7) + ((lane >> 4) << 3)) * GM_LD +
                    ((lane >> 3) & 1) * 8;
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<GM_STAGES - 2>();
    __syncthreads();
    const int pf = kt + GM_STAGES - 1;
    if (pf < nk) stage(pf % GM_STAGES, pf);
    cp_commit();
    const bf16* a = sA + (kt % GM_STAGES) * GM_BM * GM_LD + a_off;
    const bf16* b = sB + (kt % GM_STAGES) * GM_BN * GM_LD + b_off;
#pragma unroll
    for (int kk = 0; kk < GM_BK; kk += 16) {
      uint32_t af[2][4], bfr[4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldmatrix_x4(af[i], a + i * 16 * GM_LD + kk);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        ldmatrix_x4(bfr[jj], b + jj * 16 * GM_LD + kk);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          mma_bf16(acc[i][2 * jj], af[i], bfr[jj][0], bfr[jj][1]);
          mma_bf16(acc[i][2 * jj + 1], af[i], bfr[jj][2], bfr[jj][3]);
        }
    }
  }

  const int gr = lane >> 2, gc = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long row = m0 + wm * 32 + i * 16 + gr + h * 8;
      if (row >= g.M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        epi(z, row, n0 + wn * 64 + j * 8 + gc, acc[i][j][2 * h],
            acc[i][j][2 * h + 1]);
    }
}

template <class Epi>
cudaError_t launch_gemm_nt(const GemmArgs& g, int nz, const Epi& epi,
                           cudaStream_t st) {
  cudaFuncSetAttribute(gemm_nt_kernel<Epi>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)GM_SMEM);
  dim3 grid(g.N / GM_BN, (g.M + GM_BM - 1) / GM_BM, nz);
  gemm_nt_kernel<Epi><<<grid, GM_THREADS, GM_SMEM, st>>>(g, epi);
  return cudaGetLastError();
}

// one matrix's part of QkvEpi (gemm_wg.cuh's per-tile epilogue): QkvEpi's
// arithmetic, the bias read as one pair (QkvEpi itself stays as the
// mma.sync core's callers compiled it)
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
  // the values of columns col, col + 1
  __device__ __forceinline__ __nv_bfloat162 value(int z, int col, float v0,
                                                  float v1) const {
    bf16 o0 = __float2bfloat16(v0 + __bfloat162float(b[z][col]));
    bf16 o1 = __float2bfloat16(v1 + __bfloat162float(b[z][col + 1]));
    if (scale[z] != 1.0f) {
      o0 = __float2bfloat16(__bfloat162float(o0) * scale[z]);
      o1 = __float2bfloat16(__bfloat162float(o1) * scale[z]);
    }
    __nv_bfloat162 o;
    o.x = o0;
    o.y = o1;
    return o;
  }
  __device__ __forceinline__ void operator()(int z, long row, int col,
                                             float v0, float v1) const {
    *reinterpret_cast<__nv_bfloat162*>(y[z] + row * ld + col) =
        value(z, col, v0, v1);
  }
  // matrix z's part, its fields selected without indexing (no local copy)
  __device__ __forceinline__ QkvOne at(int z) const {
    return z == 0   ? QkvOne{b[0], y[0], scale[0], ld}
           : z == 1 ? QkvOne{b[1], y[1], scale[1], ld}
                    : QkvOne{b[2], y[2], scale[2], ld};
  }
};

}  // namespace
