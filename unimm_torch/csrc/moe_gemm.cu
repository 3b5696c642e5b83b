// Grouped expert GEMM of the decoder's mixture-of-experts layers
// (ops/moe.py): one launch runs a product for every expert over that
// expert's rows, whatever their counts.
//
// A [M, K] holds the layer's rows sorted by expert (row_off[g] ..
// row_off[g + 1] are expert g's, an expert may have none); B [G, N, K] the
// experts' weights, stacked (one 2-D tensor map over G * N rows).
// moe_wg_kernel<MODE> runs gemm_wg_core.cuh's mainloop unchanged (2-D TMA
// loads with the 128-byte swizzle into a 4-stage mbarrier ring, a
// producer warpgroup, two consumer warpgroups on m64n256k16, setmaxnreg,
// one persistent CTA an SM) over its own tile walk: tile t is row tile
// r = t / tn (column tile fastest) of the concatenated per-expert row
// tiles, tile_off[g] .. tile_off[g + 1] being expert g's ceil(rows / 128);
// the expert is found by a binary search of tile_off, its A box starts at
// row_off[g] + 128 (r - tile_off[g]) and its B box at row g N + 256 n.
// A box that runs past the expert's last row reads the next expert's rows
// (or TMA zeros past M); those rows are never stored. Both counts live on
// the device (the router's bincount): the host never waits for them, and
// launches a grid sized for the largest tile count the rows can need
// (ceil(M / 128) + G row tiles); the CTAs read the real count.
//
// MODE 0 (SWIGLU): B is the gate and up products interleaved in blocks of
// 128 rows (rows 256 j .. 256 j + 127 the gate's rows 128 j .., the next
// 128 the up's), so a 256-wide tile holds gate and up of the same 128
// output columns in one thread's accumulators (j and j + 16):
// out [M, N / 2] = bf16(silu(gate) * up), in fp32.
// MODE 1 (SCALE): out [M, N] = bf16(acc * scale[row]) (the router's
// weight of the row; no scale: acc).
// No atomics: the result is the same bit for bit on every run, and a row's
// result does not depend on the other rows of the launch.
#include "gemm_wg_core.cuh"

namespace {

constexpr int MOE_SWIGLU = 0, MOE_SCALE = 1;

struct MoeArgs {
  const int* row_off;   // [G + 1]
  const int* tile_off;  // [G + 1]
  const float* scale;   // [M] or nullptr (MODE 1)
  bf16* out;
  int G, N, K;
};

// the expert of row tile r: the g with tile_off[g] <= r < tile_off[g + 1]
__device__ __forceinline__ int moe_group(const int* __restrict__ tile_off,
                                         int G, int r) {
  int lo = 0, hi = G;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(tile_off + mid) <= r)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + __expf(-v));
}

template <int MODE>
__global__ void __launch_bounds__(WG_THREADS, 1)
    moe_wg_kernel(const __grid_constant__ WgMaps maps, const MoeArgs p) {
  constexpr int S = WG_STAGES, NJ = WG_BN / 8;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sa = wg_smem_base(smem_raw);         // [S] A tiles
  const uint32_t sb = sa + S * WG_A_TILE;             // [S] B tiles
  const uint32_t full = sb + S * WG_B_TILE;           // [S] mbarriers
  const uint32_t empty = full + 8 * S;                // [S] mbarriers
  const int nk = p.K / WG_BK, tn = p.N / WG_BN;
  const int tiles = __ldg(p.tile_off + p.G) * tn;
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
        const int r = t / tn, g = moe_group(p.tile_off, p.G, r);
        const int m0 = __ldg(p.row_off + g) +
                       (r - __ldg(p.tile_off + g)) * WG_BM;
        const int n0 = g * p.N + (t - r * tn) * WG_BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(empty + 8 * s, ((it / S) - 1) & 1);
          mbar_expect_tx(full + 8 * s, WG_A_TILE + WG_B_TILE);
          tma_load(sa + s * WG_A_TILE, &maps.a, kt * WG_BK, m0,
                   full + 8 * s);
          tma_load(sb + s * WG_B_TILE, &maps.b[0], kt * WG_BK, n0,
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
    const int r = t / tn, g = moe_group(p.tile_off, p.G, r);
    const int m0 = __ldg(p.row_off + g) + (r - __ldg(p.tile_off + g)) * WG_BM;
    const int m_end = __ldg(p.row_off + g + 1);
    const int nt = t - r * tn;
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

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long row = m0 + wg * 64 + w * 16 + (lane >> 2) + h * 8;
      if (row >= m_end) continue;
      if constexpr (MODE == MOE_SWIGLU) {
        const int half = p.N / 2;
        bf16* dst = p.out + row * half + nt * (WG_BN / 2) + gc;
#pragma unroll
        for (int j = 0; j < NJ / 2; ++j) {
          const float a0 = silu(acc[j][2 * h]) * acc[j + NJ / 2][2 * h];
          const float a1 =
              silu(acc[j][2 * h + 1]) * acc[j + NJ / 2][2 * h + 1];
          *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
              __floats2bfloat162_rn(a0, a1);
        }
      } else {
        const float sc = p.scale != nullptr ? __ldg(p.scale + row) : 1.0f;
        bf16* dst = p.out + row * p.N + nt * WG_BN + gc;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
              __floats2bfloat162_rn(acc[j][2 * h] * sc,
                                    acc[j][2 * h + 1] * sc);
      }
    }
  }
}

template <int MODE>
cudaError_t launch_moe(const void* a, const void* b, const MoeArgs& p, int M,
                       cudaStream_t st) {
  if (M < 1 || p.G < 1 || p.N < WG_BN || p.N % WG_BN || p.K < WG_BK ||
      p.K % WG_BK || p.out == nullptr)
    return cudaErrorInvalidValue;
  WgMaps maps;
  cudaError_t err = tma_map(&maps.a, a, M, p.K, WG_BM);
  if (err == cudaSuccess)
    err = tma_map(&maps.b[0], b, (long)p.G * p.N, p.K, WG_BN);
  if (err != cudaSuccess) return err;
  const auto kernel = moe_wg_kernel<MODE>;
  static const cudaError_t ready = prepare_kernel(
      kernel, WG_THREADS, 128 * WG_PROD_REGS + 256 * WG_CONS_REGS, WG_SMEM);
  if (ready != cudaSuccess) return ready;
  // the most row tiles M rows over G experts can take
  const long most = ((long)(M + WG_BM - 1) / WG_BM + p.G) * (p.N / WG_BN);
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  kernel<<<most < sms ? (int)most : sms, WG_THREADS, WG_SMEM, st>>>(maps, p);
  return cudaGetLastError();
}

}  // namespace

// out [M, N / 2] = silu(gate) * up of each row under its expert's
// interleaved gate / up weights w13 [G, N, K]
extern "C" int unimm_moe_swiglu(const void* a, const void* w13,
                                const void* row_off, const void* tile_off,
                                void* out, int M, int G, int N, int K,
                                void* stream) {
  const MoeArgs p{static_cast<const int*>(row_off),
                  static_cast<const int*>(tile_off), nullptr,
                  static_cast<bf16*>(out), G, N, K};
  return launch_moe<MOE_SWIGLU>(a, w13, p, M,
                                static_cast<cudaStream_t>(stream));
}

// out [M, N] = (a w2[g]^T) * scale[row] (scale may be null)
extern "C" int unimm_moe_down(const void* a, const void* w2,
                              const void* row_off, const void* tile_off,
                              const void* scale, void* out, int M, int G,
                              int N, int K, void* stream) {
  const MoeArgs p{static_cast<const int*>(row_off),
                  static_cast<const int*>(tile_off),
                  static_cast<const float*>(scale), static_cast<bf16*>(out),
                  G, N, K};
  return launch_moe<MOE_SCALE>(a, w2, p, M,
                               static_cast<cudaStream_t>(stream));
}

// registers, local bytes, dynamic shared memory and CTAs an SM of the
// instance MODE
extern "C" int unimm_moe_info(int mode, int* out) {
  cudaFuncAttributes fa;
  const cudaError_t err =
      mode == MOE_SWIGLU
          ? cudaFuncGetAttributes(&fa, moe_wg_kernel<MOE_SWIGLU>)
          : cudaFuncGetAttributes(&fa, moe_wg_kernel<MOE_SCALE>);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)WG_SMEM;
  out[3] = 1;
  return cudaSuccess;
}
