// Hopper GEMM core of every product of the port's block kernels: the FFN
// block (ffn_block.cu, K2), the co-attention text block (co_text_block.cu,
// B8), the answer block (answer_block.cu, K1) and the whole-sequence
// attention blocks (attention_block.cu, B4; attention_block_train.cu, B5):
// C[M, N] = A[M, K] B[N, K]^T (both K-contiguous, the torch Linear
// layout), up to three B matrices (grid z), on wgmma with TMA loads; the
// bench's probes (block_probe.cu, B10 and B11) run their products on it as
// B4 does. The training cross-entropy (xent_train.cu) runs its own
// products on this file's TMA and mainloop pieces; gemm_wg.cuh adds the
// residual + LayerNorm product, which it does not need.
//
// gemm_nt_wg_kernel<Epi>: CTA tiles of 128 x 256, k step 64. A producer
// warpgroup (one thread issues) keeps 2-D TMA loads (cp.async.bulk.tensor,
// 128-byte swizzle: a tile row is 64 bf16 of k, 128 bytes, the unit of
// wgmma's 128-byte swizzle read through wgmma.cuh's descriptors) in flight
// into a ring of 4 shared-memory stages: it waits for a stage to be
// released (its "empty" mbarrier), arms the stage's "full" mbarrier with
// the stage's byte count and issues the A and B boxes. Two consumer
// warpgroups of 64 x 256 each wait on "full", issue the stage's four
// m64n256k16 products, keep one stage's products in flight and release
// the stage before. setmaxnreg hands the producer's registers to the
// consumers (128 fp32 accumulators a thread). One CTA an SM walks the
// tiles t = blockIdx.x, + gridDim.x, ... (columns fastest, then rows, then
// z), and the producer runs into the next tile's stages while the
// consumers store the last one.
//
// The epilogue functor: e = epi.at(z), copied once a tile into registers
// (read through a __grid_constant__ parameter at each use, its fields
// cost the first product of K2 half its speed), is matrix z's epilogue;
// e(row, col, v0, v1) stores the accumulators of columns col, col + 1 of
// a row; where e's type has VEC = true it instead gives their bf16 pair
// (e.value(col, v0, v1)) and the row's address (e.row_ptr(row)), and the
// four lanes that hold a row's 32 columns trade pairs by shuffles so that
// each stores 16 contiguous bytes (faster for the projections' light
// epilogue, slower for the gelu one on an H100: PERF.md).
// Rows past M are zero-filled by the TMA and never stored. Tensor maps are
// encoded on the host for every launch (cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint: the library links no -lcuda) and passed
// as __grid_constant__ parameters. The launcher returns an error, and
// launches nothing, for a width, depth or address the tiles do not take, a
// tensor map the driver refuses, or a register budget that setmaxnreg
// cannot meet; an mbarrier wait that never completes traps.
#pragma once

#include <cuda.h>

#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// mbarriers, TMA, register hand-over
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait for the phase of the given parity to complete; a barrier that never
// completes traps (a launch error) instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t n = 0;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 24)) __trap();
  }
}

// the box at (column c0, row c1) of map into shared address dst, counted
// against bar's transaction bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// the shared-window address of the dynamic shared memory's first
// 1024-byte boundary (the 128-byte swizzle repeats every 8 rows of 128
// bytes)
__device__ __forceinline__ uint32_t wg_smem_base(unsigned char* raw) {
  const uint32_t r = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  return (r + 1023) & ~1023u;
}

constexpr int WG_BK = 64;            // k step: one 128-byte swizzle row
constexpr int WG_ROW = WG_BK * 2;    // bytes of a tile row

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's tensor-map encoder, looked up once
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the map of a [rows, cols] bf16 matrix (row pitch cols) in boxes of
// box_rows x 64 columns, 128-byte swizzle, rows past the end read as 0
cudaError_t tma_map(CUtensorMap* m, const void* base, long rows, int cols,
                    int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 || cols % WG_BK)
    return cudaErrorInvalidValue;
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)WG_BK, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = enc(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dim,
      stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a kernel's one-time set-up: its dynamic shared memory, and a check that
// it starts with the registers its warpgroups ask for after setmaxnreg
// (which moves registers within the CTA's allocation: a request beyond it
// would wait for ever)
template <class K>
cudaError_t prepare_kernel(K kernel, int threads, int wanted, size_t smem) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  if (fa.numRegs * threads < wanted) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ---------------------------------------------------------------------------
// gemm_nt_wg_kernel
// ---------------------------------------------------------------------------
constexpr int WG_BM = 128;           // two consumer warpgroups of 64 rows
constexpr int WG_BN = 256;           // the CTA tile's width (m64n256k16)
constexpr int WG_THREADS = 384;      // consumers 0-255, producer 256-383
// one CTA an SM: a 384-thread CTA's 168 registers a thread (ptxas
// compiles the whole kernel under that cap; setmaxnreg then moves the
// producer's registers (40) to the consumers (232) at run time); a second
// CTA would cap every thread at 80, below the 128 accumulators
constexpr int WG_STAGES = 4, WG_PROD_REGS = 40, WG_CONS_REGS = 232;
constexpr int WG_A_TILE = WG_BM * WG_ROW, WG_B_TILE = WG_BN * WG_ROW;
constexpr size_t WG_SMEM =
    1024 + (size_t)WG_STAGES * (WG_A_TILE + WG_B_TILE + 16);

struct WgMaps {
  CUtensorMap a;
  CUtensorMap b[3];
};

// the 32-bit word of a bf16 pair
__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// lane q of a quad holds v[t] = columns 8 (4 g + t) + 2 q, + 1 of its row;
// returns column block 4 g + q's 8 columns (lane p's word q is pair p),
// gathered by three xor shuffles (sender s sends v[s ^ r])
__device__ __forceinline__ uint4 quad_gather(const uint32_t (&v)[4], int q) {
  uint32_t w[4];  // w[r]: pair q ^ r of block q
#pragma unroll
  for (int r = 0; r < 4; ++r)
    w[r] = r == 0 ? pick4(v, q)
                  : __shfl_xor_sync(0xffffffffu, pick4(v, q ^ r), r);
  return make_uint4(pick4(w, q), pick4(w, 1 ^ q), pick4(w, 2 ^ q),
                    pick4(w, 3 ^ q));
}

template <class Epi>
__global__ void __launch_bounds__(WG_THREADS, 1)
    gemm_nt_wg_kernel(const __grid_constant__ WgMaps maps, const int M,
                      const int N, const int K, const int nz,
                      const Epi epi) {
  constexpr int S = WG_STAGES, NJ = WG_BN / 8;
  using Tile = decltype(epi.at(0));
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sa = wg_smem_base(smem_raw);         // [S] A tiles
  const uint32_t sb = sa + S * WG_A_TILE;             // [S] B tiles
  const uint32_t full = sb + S * WG_B_TILE;           // [S] mbarriers
  const uint32_t empty = full + 8 * S;                // [S] mbarriers
  const int nk = K / WG_BK, tn = N / WG_BN, tm = (M + WG_BM - 1) / WG_BM;
  const int tiles = tn * tm * nz;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer
    regs_dec<WG_PROD_REGS>();
    if (threadIdx.x == 256) {
      int it = 0;  // k tiles loaded by this CTA so far
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int z = t / (tn * tm), r = t - z * tn * tm;
        const int m0 = (r / tn) * WG_BM, n0 = (r % tn) * WG_BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(empty + 8 * s, ((it / S) - 1) & 1);
          mbar_expect_tx(full + 8 * s, WG_A_TILE + WG_B_TILE);
          tma_load(sa + s * WG_A_TILE, &maps.a, kt * WG_BK, m0,
                   full + 8 * s);
          tma_load(sb + s * WG_B_TILE, &maps.b[z], kt * WG_BK, n0,
                   full + 8 * s);
        }
      }
    }
    return;
  }

  regs_inc<WG_CONS_REGS>();
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int q = lane & 3, gc = q * 2;
  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[j][t] = 0.f;
  int it = 0;  // k tiles consumed by this CTA so far
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int z = t / (tn * tm), r = t - z * tn * tm;
    const int m0 = (r / tn) * WG_BM, n0 = (r % tn) * WG_BN;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % S;
      mbar_wait(full + 8 * s, (it / S) & 1);
      __syncwarp();  // the warp converged for the .aligned wgmma
      const uint64_t da = wg_desc(sa + s * WG_A_TILE + wg * 64 * WG_ROW);
      const uint64_t db = wg_desc(sb + s * WG_B_TILE);
      wg_pin(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        wg_ss<NJ>(acc, da + 2 * kk, db + 2 * kk, (kt | kk) != 0);
      wg_commit();
      wg_wait<1>();  // the products of the stage before are done
      wg_pin(acc);
      if (kt > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(empty + 8 * ((it - 1) % S));
    }
    wg_wait0();
    wg_pin(acc);
    if (threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * ((it - 1) % S));

    const Tile e = epi.at(z);  // matrix z's fields, in registers
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long row = m0 + wg * 64 + w * 16 + (lane >> 2) + h * 8;
      if constexpr (Tile::VEC) {
        // four column blocks at a time (all 32 pairs of a row held at once
        // spill under ptxas's 168-register cap); every lane shuffles, only
        // rows inside M store
        bf16* dst = row < M ? e.row_ptr(row) + n0 : nullptr;
#pragma unroll
        for (int g = 0; g < NJ / 4; ++g) {
          uint32_t v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            v[u] = bf2_bits(e.value(n0 + (4 * g + u) * 8 + gc,
                                    acc[4 * g + u][2 * h],
                                    acc[4 * g + u][2 * h + 1]));
          const uint4 o = quad_gather(v, q);
          if (dst != nullptr)
            *reinterpret_cast<uint4*>(dst + (4 * g + q) * 8) = o;
        }
      } else {
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          e(row, n0 + j * 8 + gc, acc[j][2 * h], acc[j][2 * h + 1]);
      }
    }
  }
}

// the card's SMs (the persistent grid), looked up once
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

// C = A B[z]^T for z < nz through epi; needs N % WG_BN == 0, K % 64 == 0,
// 16-byte aligned operands
template <class Epi>
cudaError_t launch_gemm_nt_wg(const GemmArgs& g, int nz, const Epi& epi,
                              cudaStream_t st) {
  if (g.M < 1 || g.N < WG_BN || g.N % WG_BN || g.K < WG_BK ||
      g.K % WG_BK || nz < 1 || nz > 3)
    return cudaErrorInvalidValue;
  WgMaps maps;
  cudaError_t err = tma_map(&maps.a, g.a, g.M, g.K, WG_BM);
  for (int z = 0; z < nz && err == cudaSuccess; ++z)
    err = tma_map(&maps.b[z], g.b[z], g.N, g.K, WG_BN);
  if (err != cudaSuccess) return err;
  const auto kernel = gemm_nt_wg_kernel<Epi>;
  static const cudaError_t ready = prepare_kernel(
      kernel, WG_THREADS, 128 * WG_PROD_REGS + 256 * WG_CONS_REGS, WG_SMEM);
  if (ready != cudaSuccess) return ready;
  const int tiles = (g.N / WG_BN) * ((g.M + WG_BM - 1) / WG_BM) * nz;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  kernel<<<tiles < sms ? tiles : sms, WG_THREADS, WG_SMEM, st>>>(
      maps, g.M, g.N, g.K, nz, epi);
  return cudaGetLastError();
}

}  // namespace
