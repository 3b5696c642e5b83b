// The training MLM cross-entropy over the tied decoder: the forward keeps
// each row's log-sum-exp, the backward recomputes the logits and takes
// the three gradients, all products on Hopper's wgmma with TMA loads.
//
// Replaces no pallas_call: it is the port of the JAX package's XLA scan
// unimm_tpu/ops/losses.py: online_softmax_xent_vjp (a vocab-chunk scan of
// bf16 products with fp32 accumulators, forward and backward), which the
// port ran as fp32 SIMT products chunk by chunk (ops/losses._OnlineXent,
// still the path of CPU tensors, fp32 hidden and other widths). For h [M,
// 768] bf16, Wdec [V, 768] bf16, b [V] fp32, labels [M] (-1 = ignored):
//
// forward (unimm_xent_train_fwd): K3's logits kernel as it is
//   (xent_head.cu's xent_wg_kernel through unimm_xent_tiles: per (row,
//   256-column vocab tile) (max, exp-sum) partials and the label's logit),
//   then xt_lse_kernel, K3's combine that writes lse [M] for every row
//   besides nll [M] (0 where the label is -1; the same bits as K3's nll).
// backward (unimm_xent_train_bwd), for the upstream gradient gf [M] (0
//   where the label is -1), in four launches:
//   1. xt_wg_kernel<XT_RECOMPUTE>: S = h Wdec^T again on K3's mainloop and
//      tile order (groups of 16 row tiles, the row tile fastest), and in
//      the epilogue d = gf (exp(S + b - lse) - [col == label]) (ex2 with
//      log2 e folded into one FFMA, as K3), stored as dl = bf16(d) [M, Vp]
//      (Vp = 256 ceil(V / 256): columns past V read bias -1e30 and hold
//      0), and the fp32 column sums of the unrounded d over each 128-row
//      tile into part_db [ceil(M / 128), Vp] (a warp's 16 rows by xor
//      shuffles, the CTA's 8 warps through shared memory in a fixed
//      order);
//   2. xt_db_kernel: db[v] = the tiles' sums in row-tile order;
//   3. xt_wg_kernel<XT_DH>: dh = dl Wdec [M, 768], K = Vp (the decoder
//      rows past V read as 0 by the TMA), Wdec read N-major: TMA boxes of
//      64 columns of its [V, 768] rows, wgmma's transposed read;
//   4. xt_wg_kernel<XT_DW>: dWdec = dl^T h [V, 768], K = M, both operands
//      read MN-major from dl's and h's own rows.
//   dh and dWdec are rounded to bf16 once from the fp32 accumulators. No
//   atomics: every output is the same bit for bit on every run. The
//   transposed reads spare the transposed copies of dl (2.4 GB at M
//   38400), h and Wdec that the k-contiguous core would need.
// What bounds it on an H100: 2 M 768 Vp flops a product, four products
// (7.2 TFLOP at M 38400, 7.3 ms at the bf16 peak), against dl written
// once and read twice (2.4 GB each way at M 38400): the tensor-core rate.
// Measured (PERF.md section 6): dh and dWdec at 800-890 TFLOP/s, K3's
// forward at ~490, the recompute at ~315 (its epilogue, an exp, a store
// and a column sum a logit, runs while no product is in flight).
#include "gemm_wg_core.cuh"
#include "xent_tiles.cuh"

extern "C" int unimm_xent_tiles(const void* hid, const void* labels,
                                const void* w, const void* b, void* part,
                                void* label_logit, int M, int V,
                                void* stream);

namespace {

constexpr int XT_PANEL = 64 * WG_ROW;  // one 64 x 64 MN-major box, bytes
// the ring, then two buffers of the CTA's 8 warps' column sums (recompute)
constexpr size_t XT_SMEM = WG_SMEM + 2 * 8 * WG_BN * sizeof(float);

enum { XT_RECOMPUTE = 0, XT_DH = 1, XT_DW = 2 };

struct XtArgs {
  int ntm, ntn, nk;  // row tiles, column tiles, k steps of the product
  int rows;          // rows of the output (stores past it are dropped)
  int M, V, vp;      // the loss's rows, vocabulary, dl's row pitch
  const float* bias;
  const int* labels;
  const float* lse;
  const float* gf;
  bf16* out;         // dl [M, vp], dh [M, 768] or dWdec [V, 768]
  float* part_db;    // [ntm, vp] (recompute)
};

// the recompute's epilogue for the tile (tm, tn), a column pair of the
// thread's two rows at a time (so that a pair's accumulators die at once;
// a row's 16-byte stores after quad shuffles spill under ptxas's cap): d
// for both rows, their bf16 pairs into dl, then the pair's column sums,
// the two rows, the warp's 16 (lanes that share lane % 4, xor shuffles)
// and the CTA's 8 warps through shared memory in a fixed order
__device__ __forceinline__ void xt_dlogits(float (&acc)[WG_BN / 8][4],
                                           const XtArgs p, int tm, int tn,
                                           float* red) {
  constexpr int NJ = WG_BN / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gc = (lane & 3) * 2, n0 = tn * WG_BN;
  const int row0 = tm * WG_BM + warp * 16 + (lane >> 2);  // h 0; h 1: + 8
  int lab[2];
  float g[2], lc[2];
  bf16* dst[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8;
    const bool in = row < p.M;
    lab[h] = in ? __ldg(p.labels + row) : -1;
    g[h] = in ? __ldg(p.gf + row) : 0.f;
    lc[h] = in ? __ldg(p.lse + row) * XW_LOG2E : 0.f;
    dst[h] = in ? p.out + (long)row * p.vp + n0 + gc : nullptr;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = n0 + j * 8 + gc;
    const float b0 = col < p.V ? __ldg(p.bias + col) : XW_PAD;
    const float b1 = col + 1 < p.V ? __ldg(p.bias + col + 1) : XW_PAD;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float d0 = 0.f, d1 = 0.f;
      if (dst[h] != nullptr) {
        const float p0 =
            xw_ex2(fmaf(acc[j][2 * h] + b0, XW_LOG2E, -lc[h]));
        const float p1 =
            xw_ex2(fmaf(acc[j][2 * h + 1] + b1, XW_LOG2E, -lc[h]));
        d0 = g[h] * (p0 - (col == lab[h] ? 1.f : 0.f));
        d1 = g[h] * (p1 - (col + 1 == lab[h] ? 1.f : 0.f));
        *reinterpret_cast<uint32_t*>(dst[h] + j * 8) = pack_bf16(d0, d1);
      }
      acc[j][2 * h] = d0;
      acc[j][2 * h + 1] = d1;
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      float s = acc[j][t] + acc[j][2 + t];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 4) red[warp * WG_BN + j * 8 + gc + t] = s;
    }
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the consumers only
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < 8; ++u) s += red[u * WG_BN + threadIdx.x];
  p.part_db[(long)tm * p.vp + n0 + threadIdx.x] = s;
}

// a product's epilogue: bf16 rows of out (row pitch 768), 16 bytes a lane
__device__ __forceinline__ void xt_store(const float (&acc)[WG_BN / 8][4],
                                         const XtArgs p, int tm, int tn) {
  constexpr int NJ = WG_BN / 8;
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int wg = threadIdx.x / 128, q = lane & 3;
  const int n0 = tn * WG_BN;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long row = tm * WG_BM + wg * 64 + w * 16 + (lane >> 2) + h * 8;
    bf16* dst = row < p.rows ? p.out + row * HID + n0 : nullptr;
#pragma unroll
    for (int gq = 0; gq < NJ / 4; ++gq) {
      uint32_t v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = pack_bf16(acc[4 * gq + u][2 * h], acc[4 * gq + u][2 * h + 1]);
      const uint4 o = quad_gather(v, q);
      if (dst != nullptr)
        *reinterpret_cast<uint4*>(dst + (4 * gq + q) * 8) = o;
    }
  }
}

// gemm_wg.cuh's mainloop (TMA ring of 4 stages, a producer warpgroup, two
// consumer warpgroups on m64n256k16, persistent over 128 x 256 tiles) in
// K3's tile order, with A read MN-major under XT_DW and B under XT_DH and
// XT_DW (wg_ss_t): their stage is 64 x 64 TMA boxes, one a consumer
// warpgroup (A) or four side by side along N (B)
template <int MODE>
__global__ void __launch_bounds__(WG_THREADS, 1)
    xt_wg_kernel(const __grid_constant__ WgMaps maps, const XtArgs p) {
  constexpr bool TA = MODE == XT_DW, TB = MODE != XT_RECOMPUTE;
  constexpr int S = WG_STAGES, NJ = WG_BN / 8;
  // the descriptors' step per 16 columns of k: 32 bytes of a k-contiguous
  // row, or 16 rows (2048 bytes) of an MN-major panel
  constexpr int KA = TA ? 128 : 2, KB = TB ? 128 : 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sa = wg_smem_base(smem_raw);         // [S] A tiles
  const uint32_t sb = sa + S * WG_A_TILE;             // [S] B tiles
  const uint32_t full = sb + S * WG_B_TILE;           // [S] mbarriers
  const uint32_t empty = full + 8 * S;                // [S] mbarriers
  // [2][8 warps][256] fp32 column sums, behind the mbarriers
  float* red = reinterpret_cast<float*>(
      smem_raw + (empty + 8 * S -
                  static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw))));
  const int tiles = p.ntm * p.ntn;
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
        int tm, tn;
        xw_tile(t, p.ntm, p.ntn, tm, tn);
        const int m0 = tm * WG_BM, n0 = tn * WG_BN;
        for (int kt = 0; kt < p.nk; ++kt, ++it) {
          const int s = it % S, k0 = kt * WG_BK;
          const uint32_t a = sa + s * WG_A_TILE, b = sb + s * WG_B_TILE;
          if (it >= S) mbar_wait(empty + 8 * s, ((it / S) - 1) & 1);
          mbar_expect_tx(full + 8 * s, WG_A_TILE + WG_B_TILE);
          if (TA) {
            tma_load(a, &maps.a, m0, k0, full + 8 * s);
            tma_load(a + XT_PANEL, &maps.a, m0 + 64, k0, full + 8 * s);
          } else {
            tma_load(a, &maps.a, k0, m0, full + 8 * s);
          }
          if (TB) {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              tma_load(b + c * XT_PANEL, &maps.b[0], n0 + 64 * c, k0,
                       full + 8 * s);
          } else {
            tma_load(b, &maps.b[0], k0, n0, full + 8 * s);
          }
        }
      }
    }
    return;
  }

  regs_inc<WG_CONS_REGS>();
  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[j][t] = 0.f;
  int it = 0;  // k tiles consumed by this CTA so far
  int nt = 0;  // tiles finished by this CTA so far
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++nt) {
    int tm, tn;
    xw_tile(t, p.ntm, p.ntn, tm, tn);
    for (int kt = 0; kt < p.nk; ++kt, ++it) {
      const int s = it % S;
      mbar_wait(full + 8 * s, (it / S) & 1);
      __syncwarp();  // the warp converged for the .aligned wgmma
      const uint64_t da =
          TA ? wg_desc_mn(sa + s * WG_A_TILE + wg * XT_PANEL, XT_PANEL)
             : wg_desc(sa + s * WG_A_TILE + wg * 64 * WG_ROW);
      const uint64_t db = TB ? wg_desc_mn(sb + s * WG_B_TILE, XT_PANEL)
                             : wg_desc(sb + s * WG_B_TILE);
      wg_pin(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        wg_ss_t<TA, TB>(acc, da + KA * kk, db + KB * kk, (kt | kk) != 0);
      wg_commit();
      wg_wait<1>();  // the products of the stage before are done
      wg_pin(acc);
      if (kt > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(empty + 8 * ((it - 1) % S));
    }
    wg_wait0();
    wg_pin(acc);
    if (threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * ((it - 1) % S));
    if constexpr (MODE == XT_RECOMPUTE)
      xt_dlogits(acc, p, tm, tn, red + (nt & 1) * 8 * WG_BN);
    else
      xt_store(acc, p, tm, tn);
  }
}

constexpr int XC_WARPS = 8;

// K3's combine (xent_head.cu's xent_combine_kernel) for every row:
// lse[row] = max + log(sum of sum_t exp(max_t - max)), nll[row] = lse -
// label logit (0 where the label is -1)
__global__ void __launch_bounds__(XC_WARPS * 32)
    xt_lse_kernel(const float2* __restrict__ part,
                  const float* __restrict__ label_logit,
                  const int* __restrict__ labels, float* __restrict__ nll,
                  float* __restrict__ lse, int M, int ntn) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * XC_WARPS + warp;
  if (row >= M) return;
  const float2* pr = part + row * ntn;
  float mx = XW_PAD;
  for (int t = lane; t < ntn; t += 32) mx = fmaxf(mx, pr[t].x);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int t = lane; t < ntn; t += 32) sum += pr[t].y * expf(pr[t].x - mx);
  sum = warp_sum(sum);
  if (lane == 0) {
    const float l = mx + logf(sum);
    lse[row] = l;
    nll[row] = labels[row] == -1 ? 0.f : l - label_logit[row];
  }
}

// db[v] = sum over the row tiles of part_db[t][v], in tile order
__global__ void xt_db_kernel(const float* __restrict__ part_db,
                             float* __restrict__ db, int ntm, int vp,
                             int V) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float s = 0.f;
  for (int t = 0; t < ntm; ++t) s += part_db[(long)t * vp + v];
  db[v] = s;
}

template <int MODE>
cudaError_t launch_xt(const WgMaps& maps, const XtArgs& p, cudaStream_t st) {
  static const cudaError_t ready =
      prepare_kernel(xt_wg_kernel<MODE>, WG_THREADS,
                     128 * WG_PROD_REGS + 256 * WG_CONS_REGS, XT_SMEM);
  if (ready != cudaSuccess) return ready;
  const int tiles = p.ntm * p.ntn, sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  xt_wg_kernel<MODE><<<tiles < sms ? tiles : sms, WG_THREADS, XT_SMEM, st>>>(
      maps, p);
  return cudaGetLastError();
}

}  // namespace

// nll and lse [M] fp32; part [M, ceil(V / 256)] float2 and label_logit [M]
// fp32 are scratch
extern "C" int unimm_xent_train_fwd(const void* hid, const void* labels,
                                    const void* w, const void* b, void* part,
                                    void* label_logit, void* nll, void* lse,
                                    int M, int V, void* stream) {
  const int err =
      unimm_xent_tiles(hid, labels, w, b, part, label_logit, M, V, stream);
  if (err != cudaSuccess) return err;
  xt_lse_kernel<<<(M + XC_WARPS - 1) / XC_WARPS, XC_WARPS * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(part),
      static_cast<const float*>(label_logit),
      static_cast<const int*>(labels), static_cast<float*>(nll),
      static_cast<float*>(lse), M, (V + WG_BN - 1) / WG_BN);
  return cudaGetLastError();
}

// dh [M, 768] and dw [V, 768] bf16, db [V] fp32, for lse and gf [M] fp32;
// dl [M, Vp] bf16 and part_db [ceil(M / 128), Vp] fp32 are scratch (Vp =
// 256 ceil(V / 256))
extern "C" int unimm_xent_train_bwd(const void* hid, const void* labels,
                                    const void* w, const void* b,
                                    const void* lse, const void* gf,
                                    void* dl, void* part_db, void* dh,
                                    void* dw, void* db, int M, int V,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || V < 1) return cudaErrorInvalidValue;
  const int ntn = (V + WG_BN - 1) / WG_BN, vp = ntn * WG_BN;
  const int ntm = (M + WG_BM - 1) / WG_BM;
  XtArgs p{ntm, ntn, HID / WG_BK, M, M, V, vp,
           static_cast<const float*>(b), static_cast<const int*>(labels),
           static_cast<const float*>(lse), static_cast<const float*>(gf),
           static_cast<bf16*>(dl), static_cast<float*>(part_db)};
  WgMaps maps;
  // 1. dl and the column sums
  cudaError_t err = tma_map(&maps.a, hid, M, HID, WG_BM);
  if (err == cudaSuccess) err = tma_map(&maps.b[0], w, V, HID, WG_BN);
  if (err == cudaSuccess) err = launch_xt<XT_RECOMPUTE>(maps, p, st);
  if (err != cudaSuccess) return err;
  // 2. db
  xt_db_kernel<<<(V + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part_db), static_cast<float*>(db), ntm, vp,
      V);
  err = cudaGetLastError();
  // 3. dh = dl Wdec: A dl k-contiguous, B Wdec N-major
  p.ntn = HID / WG_BN;
  p.nk = vp / WG_BK;
  p.out = static_cast<bf16*>(dh);
  if (err == cudaSuccess) err = tma_map(&maps.a, dl, M, vp, WG_BM);
  if (err == cudaSuccess) err = tma_map(&maps.b[0], w, V, HID, 64);
  if (err == cudaSuccess) err = launch_xt<XT_DH>(maps, p, st);
  if (err != cudaSuccess) return err;
  // 4. dWdec = dl^T h: A dl M-major (vocab along M), B h N-major
  p.ntm = vp / WG_BM;
  p.nk = (M + WG_BK - 1) / WG_BK;
  p.rows = V;
  p.out = static_cast<bf16*>(dw);
  err = tma_map(&maps.a, dl, M, vp, 64);
  if (err == cudaSuccess) err = tma_map(&maps.b[0], hid, M, HID, 64);
  if (err == cudaSuccess) err = launch_xt<XT_DW>(maps, p, st);
  return err;
}
