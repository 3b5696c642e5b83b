// The decoder's absorbed MLA answer pass (models/deepseek_v3.mla_absorbed,
// ops/mla_answer.py): the attention of every answer row's absorbed
// queries against its slate's latent cache and its own option's earlier
// rows, in one launch a layer.
//
// Replaces no TPU kernel: the JAX package runs no decoder. It replaces
// the plain-PyTorch chain the scorer ran before it, which padded the rows
// to 64-row blocks, wrote bf16 scores of every padded row against the
// slate's whole padded cache and the whole block (~1.4 GB a layer at the
// cell's 80 slates), masked them from a stored mask, softmaxed them and
// gathered the rows back: memory passes over scores of which under half
// were real.
//
// Inputs, all bf16: qf [N, nh, 576], each real row's absorbed queries (q
// W_uk beside q_pe, the softmax scale folded in) in the scorer's
// option-major order (slate, option, row); cache [G, Lcb, 576], each
// slate's cat(c_kv, k_pe); kr [N, 576], the rows' own cat(c_kv, k_pe).
// Metadata (int32): tiles [nb, 3] (slate, first row, end row) of each row
// tile, first [N] (the flat index of the row's option's first row), n_ctx
// [G]. Output o [N, nh, 512] = softmax(q k^T) v, v the keys' first 512
// columns (c_kv), over the slate's first n_ctx cache positions and the
// rows first[n] .. n.
//
// What bounds it on an H100: per real (row, head, key) pair 2 (576 + 512)
// flops (0.70 TFLOP a layer at ~40k rows of 16 heads against ~500 keys,
// 0.71 ms at the bf16 peak) against the queries read and the outputs
// written once (~1.4 GB a layer, 0.42 ms at 3.35 TB/s): ~480 flops a
// byte, above the card's ~295, so the tensor-core rate.
//
// Design (a row tile is 64 / nh rows x nh heads = 64 query vectors, one
// wgmma tile; one CTA an SM, two warpgroups, 256 threads, so that ptxas
// may give each thread up to 255 registers; the CTA walks the row tiles
// blockIdx.x, + gridDim.x, ..., so the CTAs in flight hold adjacent row
// tiles, mostly of one slate):
// - The layout is MQA: one 576-wide latent is the key of every head and
//   its first 512 columns the value, so one shared-memory key tile feeds
//   both products of all 64 query vectors. One thread of warpgroup 1
//   walks the CTA's (row tile, key tile) pairs in order and brings each
//   key tile (64 positions x 576: 9 TMA boxes of 64 x 64, 128-byte
//   swizzle) into a ring of 2 stages, and each row tile's query tile
//   once: the slate's cache tiles up to its n_ctx (none wholly past it is
//   loaded), then one tile of kr from the row tile's first row's option's
//   first row, which holds every earlier row of the tile's options (an
//   option has at most 65 - 64 / nh rows, ops/mla_answer.py checks). The
//   loads run on into the next row tile while this one finishes; its
//   query tile comes once the last scores that read this one are done.
// - Warpgroup 0 takes the scores of the whole tile (36 m64n64k16 over the
//   576 columns, fp32 accumulators), masks them in registers from the
//   metadata (a cache key past n_ctx; in the own tile, a key outside
//   first[n] .. n), runs the online softmax in fp32 (a row's 64 keys lie
//   in one quad of lanes: shuffles only; ex2 with log2 e folded into one
//   FFMA) and writes p, rounded to bf16, into one 64 x 64 shared tile in
//   the swizzled layout wgmma reads, with each row's rescale factor beside
//   it. Named barriers hand p to warpgroup 1 and back.
// - The 64 x 512 fp32 output accumulator is split by columns: warpgroup w
//   holds columns 256 w .. 256 w + 255 (128 registers a thread) and runs
//   p v over the whole tile with the key tile read MN-major (wgmma's
//   transposed read of the TMA boxes). Warpgroup 0 issues the next tile's
//   scores behind its p v, so the tensor cores hold the two products of
//   both warpgroups while it waits; only its softmax leaves them idle.
// - A stage is released when both warpgroups' p v of its tile are done;
//   the loading thread then brings the key tile two ahead into it, a
//   tile's scores and softmax before they are needed. (A third stage
//   would not fit beside the query tile: 230,960 bytes of 232,448.)
// - Warpgroup 0 keeps the row sums (of the fp32 p) and hands their
//   inverses over once a row tile; the output is rounded to bf16 once.
//   No atomics: the same bits on every run.
// - Every branch that holds a wgmma is uniform to ptxas (the warpgroup
//   and n_ctx broadcast from lane 0) and issues one shape: a branch ptxas
//   cannot prove uniform, or two shapes on one accumulator (an own tile
//   of 16 keys beside the cache's 64: 2.37 ms against 1.64 at the cell's
//   shapes on an H100 SXM), serializes the wgmmas.
// - Cache reuse comes from L2 alone, neither from more rows a CTA (two
//   row tiles' 512-wide outputs do not fit the registers) nor from
//   multicast: each row tile reads its query tile, its slate's cache
//   tiles and its own tile, 73,728 bytes each, ~7.4 GB of L2 reads a layer
//   at the cell's shapes (4.5 TB/s at 1.64 ms), against ~0.8 GB the grid
//   reads from device memory.
#include "gemm_wg_core.cuh"

namespace {

constexpr int MA_C = 576;                 // the latent: c_kv then k_pe
constexpr int MA_R = 512;                 // c_kv: the value's width
constexpr int MA_BOX = 64 * WG_ROW;       // a 64 x 64 TMA box, bytes
constexpr int MA_NB = MA_C / 64;          // boxes a 64-row tile
constexpr int MA_TILE = MA_NB * MA_BOX;   // a 64 x 576 tile, bytes
constexpr int MA_STAGES = 2;
constexpr int MA_THREADS = 256;           // two warpgroups
constexpr size_t MA_SMEM = 1024 + (size_t)MA_TILE * (1 + MA_STAGES) +
                           MA_BOX + 2 * 64 * sizeof(float) +
                           8 * (2 * MA_STAGES + 2);
constexpr float MA_LOG2E = 1.4426950408889634f;
// named barriers between the warpgroups (0 is __syncthreads)
constexpr int MA_P_FULL = 1;   // p and its rescale factors written
constexpr int MA_P_FREE = 2;   // warpgroup 1's p v read them
constexpr int MA_SUMS = 3;     // the rows' inverse sums written

struct MaMaps {
  CUtensorMap q;      // qf as [N nh, 576]
  CUtensorMap cache;  // [G Lcb, 576]
  CUtensorMap own;    // kr [N, 576]
};

struct MaArgs {
  const int* tiles;   // [nb, 3]: slate, first row, end row
  const int* first;   // [N]
  const int* n_ctx;   // [G]
  bf16* out;          // [N, nh, 512]
  int nh, lcb;
};

__device__ __forceinline__ float ma_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ma_bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void ma_bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// v, opaque to the compiler: a descriptor made from it is recomputed
// where it is used instead of 36 of them held in registers across the
// tile walk
__device__ __forceinline__ uint32_t ma_opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

__device__ __forceinline__ void ma_st32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// the scores of the query tile against the key tile at kt (issued, not
// waited for)
__device__ __forceinline__ void ma_scores(float (&sc)[8][4], uint32_t sq,
                                          uint32_t kt) {
  const uint64_t dq = wg_desc(ma_opaque(sq)), dk = wg_desc(kt);
#pragma unroll
  for (int c = 0; c < MA_NB; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg_ss<8>(sc, dq + (c * MA_BOX >> 4) + 2 * kk,
               dk + (c * MA_BOX >> 4) + 2 * kk, (c | kk) != 0);
}

// o (+)= p v over the key tile at kt: warpgroup half's 256 value columns
__device__ __forceinline__ void ma_pv(float (&o)[32][4], uint32_t sp,
                                      uint32_t kt, int half) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wg_ss_t<0, 1>(o, wg_desc(sp) + 2 * kk,
                  wg_desc_mn(kt + 4 * half * MA_BOX, MA_BOX) + 128 * kk, 1);
}

// o's rows r0 (a[0]) and r0 + 8 (a[1]) times their rescale factors
__device__ __forceinline__ void ma_rescale(float (&o)[32][4],
                                           const float (&a)[2]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    o[j][0] *= a[0];
    o[j][1] *= a[0];
    o[j][2] *= a[1];
    o[j][3] *= a[1];
  }
}

// the output rows r0, r0 + 8 of a row tile (those of real answer rows):
// warpgroup half's columns 256 half .. 256 half + 255, times f
__device__ __forceinline__ void ma_store(const MaArgs& p, int n0, int n1,
                                         const float (&o)[32][4],
                                         const float (&f)[2], int r0, int q4,
                                         int half) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (n0 + r / p.nh >= n1) continue;
    bf16* dst = p.out + ((long)n0 * p.nh + r) * MA_R + 256 * half + 2 * q4;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[j][2 * h] * f[h], o[j][2 * h + 1] * f[h]);
  }
}

// a row tile's walk: its slate, rows n0 .. n1, the slate's context and
// cache tiles (nctx, nct; the own tile is key tile nct), the first cache
// row of the slate and its own tile's first row (base). A whole warp
// that walks it broadcasts nctx from lane 0 (uniform), so that ptxas sees
// the walk's branches, which hold wgmmas, uniform too.
struct MaTile {
  int n0, n1, nctx, nct, row0, base;
  __device__ __forceinline__ MaTile(const MaArgs& p, int b, bool uniform) {
    const int g = __ldg(p.tiles + 3 * b);
    n0 = __ldg(p.tiles + 3 * b + 1);
    n1 = __ldg(p.tiles + 3 * b + 2);
    nctx = __ldg(p.n_ctx + g);
    if (uniform) nctx = __shfl_sync(0xffffffffu, nctx, 0);
    nct = (nctx + 63) / 64;
    row0 = g * p.lcb;
    base = __ldg(p.first + n0);
  }
};

// the loading thread's walk over every (row tile, key tile) of its CTA in
// order, key tile k into stage k % 2 once both warpgroups are done with
// key tile k - 2, a row tile's query tile once warpgroup 0's last scores
// of the row tile before are done
struct MaLoader {
  const MaMaps& maps;
  const MaArgs p;
  uint32_t sq, sk, full, empty, qbar, qfree;
  int b, t, k, rows;  // row tile, its key tile; key tiles, row tiles begun
  MaTile rt;

  __device__ __forceinline__ MaLoader(const MaMaps& m, const MaArgs& a,
                                      uint32_t q, uint32_t kk, uint32_t f,
                                      uint32_t e, uint32_t qb, uint32_t qf)
      : maps(m), p(a), sq(q), sk(kk), full(f), empty(e), qbar(qb),
        qfree(qf), b(blockIdx.x), t(0), k(0), rows(0),
        rt(a, blockIdx.x, false) {}

  // the next key tile, if any (its row tile's query tile first)
  __device__ __forceinline__ void next(int nb) {
    if (b >= nb) return;
    if (t == 0) {
      if (rows > 0) mbar_wait(qfree, (rows - 1) & 1);
      mbar_expect_tx(qbar, MA_TILE);
      for (int c = 0; c < MA_NB; ++c)
        tma_load(sq + c * MA_BOX, &maps.q, 64 * c, rt.n0 * p.nh, qbar);
      ++rows;
    }
    const int s = k % MA_STAGES;
    if (k >= MA_STAGES) mbar_wait(empty + 8 * s, ((k / MA_STAGES) - 1) & 1);
    const bool own = t == rt.nct;
    const uint32_t bar = full + 8 * s;
    mbar_expect_tx(bar, MA_TILE);
    for (int c = 0; c < MA_NB; ++c)
      tma_load(sk + s * MA_TILE + c * MA_BOX, own ? &maps.own : &maps.cache,
               64 * c, own ? rt.base : rt.row0 + 64 * t, bar);
    ++k;
    if (++t > rt.nct) {
      t = 0;
      b += gridDim.x;
      if (b < nb) rt = MaTile(p, b, false);
    }
  }
};

// One CTA an SM walks the row tiles blockIdx.x, + gridDim.x, ...; the
// loads run on across row tiles.
__global__ void __launch_bounds__(MA_THREADS, 1)
    mla_answer_kernel(const __grid_constant__ MaMaps maps, const MaArgs p,
                      const int nb) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sq = wg_smem_base(smem_raw);        // the query tile
  const uint32_t sk = sq + MA_TILE;                  // [S] key tiles
  const uint32_t sp = sk + MA_STAGES * MA_TILE;      // p, 64 x 64 bf16
  const uint32_t sred = sp + MA_BOX;                 // float [2][64]
  const uint32_t full = sred + 2 * 64 * sizeof(float);
  const uint32_t empty = full + 8 * MA_STAGES;
  const uint32_t qbar = empty + 8 * MA_STAGES;
  const uint32_t qfree = qbar + 8;
  float* scale = reinterpret_cast<float*>(smem_raw + (sred - raw));
  float* inv = scale + 64;

  // the warpgroup, broadcast from lane 0 so that ptxas sees it uniform
  // (a branch it cannot prove uniform serializes every wgmma under it)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128, lane = tid & 31;
  const int q4 = lane & 3;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);  // rows r0, r0 + 8

  if (threadIdx.x == 0) {
    for (int s = 0; s < MA_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival per warpgroup
    }
    mbar_init(qbar, 1);
    mbar_init(qfree, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float o[32][4], f[2];  // the output, the rows' inverse sums
  int k = 0;             // key tiles walked by this CTA

  if (wg == 1) {  // p v of the upper 256 columns; the loads
    const bool loader = tid == 0;
    MaLoader ld(maps, p, sq, sk, full, empty, qbar, qfree);
    if (loader)
      for (int i = 0; i < MA_STAGES; ++i) ld.next(nb);
    __syncwarp();
    for (int b = blockIdx.x; b < nb; b += gridDim.x) {
      const MaTile rt(p, b, true);
      const bool last_rt = b + (int)gridDim.x >= nb;
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
      for (int t = 0; t <= rt.nct; ++t, ++k) {
        const int s = k % MA_STAGES;
        ma_bar_sync(MA_P_FULL);
        const float a[2] = {scale[r0], scale[r0 + 8]};
        ma_rescale(o, a);
        wg_fence();
        ma_pv(o, sp, sk + s * MA_TILE, 1);
        wg_commit();
        wg_wait0();
        wg_pin(o);
        if (!(last_rt && t == rt.nct)) ma_bar_arrive(MA_P_FREE);
        if (loader) {
          mbar_arrive(empty + 8 * s);
          ld.next(nb);
        }
        __syncwarp();
      }
      ma_bar_sync(MA_SUMS);
      f[0] = inv[r0];
      f[1] = inv[r0 + 8];
      ma_store(p, rt.n0, rt.n1, o, f, r0, q4, 1);
    }
    return;
  }

  // warpgroup 0: the scores, the softmax, p v of the lower 256 columns
  // p's 4-byte words of row r0 (r0 + 8: + 8 rows), less the swizzle
  // (chunk j of row r at j ^ r % 8; r0 and r0 + 8 alike)
  const uint32_t prow = sp + r0 * WG_ROW + 4 * q4, r7 = (r0 & 7) << 4;
  float sc[8][4];
  int rows = 0;  // row tiles walked
  for (int b = blockIdx.x; b < nb; b += gridDim.x, ++rows) {
    const MaTile rt(p, b, true);
    const int nct = rt.nct;
    // each of the thread's two query rows: its answer row's open own keys
    // lo .. hi, counted from base (none for a row past the tile's end)
    int lo[2], hi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = rt.n0 + (r0 + 8 * h) / p.nh;
      lo[h] = n < rt.n1 ? __ldg(p.first + n) - rt.base : 1;
      hi[h] = n < rt.n1 ? n - rt.base : 0;
    }
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

    mbar_wait(qbar, rows & 1);
    mbar_wait(full + 8 * (k % MA_STAGES), (k / MA_STAGES) & 1);
    __syncwarp();
    wg_fence();
    ma_scores(sc, sq, sk + (k % MA_STAGES) * MA_TILE);
    wg_commit();
    wg_wait0();
    wg_pin(sc);
    if (nct == 0 && tid == 0) mbar_arrive(qfree);

    for (int t = 0; t <= nct; ++t, ++k) {
      const int s = k % MA_STAGES;
      // the mask, from the metadata: open keys klo .. khi of the tile
      const bool own = t == nct;
      if (own || 64 * (t + 1) > rt.nctx) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int klo = own ? lo[h] : 0;
          const int khi = own ? hi[h] : rt.nctx - 64 * t - 1;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = 8 * j + 2 * q4 + e;
              if (key < klo || key > khi) sc[j][2 * h + e] = -INFINITY;
            }
        }
      }
      // the online softmax in place: sc becomes p (fp32)
      float a[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = m[h];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[j][2 * h], sc[j][2 * h + 1]));
        mx = quad_max(mx);
        const float mu = mx == -INFINITY ? 0.f : mx * MA_LOG2E;
        a[h] = ma_ex2(fmaf(m[h], MA_LOG2E, -mu));
        m[h] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sc[j][2 * h + e] = ma_ex2(fmaf(sc[j][2 * h + e], MA_LOG2E, -mu));
            sum += sc[j][2 * h + e];
          }
        l[h] = l[h] * a[h] + sum;
      }
      // p, rounded to bf16, once warpgroup 1 has read the last one
      if (k > 0) ma_bar_sync(MA_P_FREE);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          ma_st32(prow + 8 * h * WG_ROW + ((j << 4) ^ r7),
                  pack_bf16(sc[j][2 * h], sc[j][2 * h + 1]));
        if (q4 == 0) scale[r0 + 8 * h] = a[h];
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      ma_bar_arrive(MA_P_FULL);
      ma_rescale(o, a);
      // p v over this tile, then the next tile's scores behind it
      __syncwarp();
      wg_fence();
      ma_pv(o, sp, sk + s * MA_TILE, 0);
      wg_commit();
      if (t < nct) {
        const int s1 = (k + 1) % MA_STAGES;
        mbar_wait(full + 8 * s1, ((k + 1) / MA_STAGES) & 1);
        __syncwarp();
        ma_scores(sc, sq, sk + s1 * MA_TILE);
        wg_commit();
        wg_wait<1>();
      } else {
        wg_wait0();
      }
      wg_pin(o);
      if (tid == 0) mbar_arrive(empty + 8 * s);
      wg_wait0();
      wg_pin(sc);
      // the row tile's last scores are done: its query tile is free
      if (t + 1 == nct && tid == 0) mbar_arrive(qfree);
    }
    // the rows' sums over the quad; their inverses to warpgroup 1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      f[h] = 1.0f / quad_sum(l[h]);
      if (q4 == 0) inv[r0 + 8 * h] = f[h];
    }
    ma_bar_arrive(MA_SUMS);
    ma_store(p, rt.n0, rt.n1, o, f, r0, q4, 0);
  }
}

}  // namespace

// o [N, nh, 512] of the absorbed queries qf [N, nh, 576] against the
// slates' caches [G, Lcb, 576] and the rows' own latents kr [N, 576]
// (ops/mla_answer.py); tiles [nb, 3], first [N], n_ctx [G] int32
extern "C" int unimm_mla_answer(const void* qf, const void* cache,
                                const void* kr, const void* tiles,
                                const void* first, const void* n_ctx,
                                void* out, int N, int nh, int G, int lcb,
                                int nb, void* stream) {
  if (N < 1 || nb < 1 || G < 1 || nh < 1 || 64 % nh || lcb < 64 ||
      lcb % 64 || out == nullptr)
    return cudaErrorInvalidValue;
  MaMaps maps;
  cudaError_t err = tma_map(&maps.q, qf, (long)N * nh, MA_C, 64);
  if (err == cudaSuccess)
    err = tma_map(&maps.cache, cache, (long)G * lcb, MA_C, 64);
  if (err == cudaSuccess) err = tma_map(&maps.own, kr, N, MA_C, 64);
  if (err != cudaSuccess) return err;
  static const cudaError_t ready = cudaFuncSetAttribute(
      mla_answer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)MA_SMEM);
  if (ready != cudaSuccess) return ready;
  const MaArgs p{static_cast<const int*>(tiles),
                 static_cast<const int*>(first),
                 static_cast<const int*>(n_ctx), static_cast<bf16*>(out), nh,
                 lcb};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  mla_answer_kernel<<<nb < sms ? nb : sms, MA_THREADS, MA_SMEM, st>>>(maps,
                                                                      p, nb);
  return cudaGetLastError();
}

// registers, local bytes, dynamic shared memory and CTAs an SM
extern "C" int unimm_mla_answer_info(int unused, int* out) {
  (void)unused;
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, mla_answer_kernel);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)MA_SMEM;
  out[3] = 1;
  return cudaSuccess;
}
