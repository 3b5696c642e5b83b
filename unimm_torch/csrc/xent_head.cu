// Online-softmax label head (K3): nll[m] = logsumexp(h_m Wdec^T + b) -
// logit at label[m], 0 where label[m] == -1.
//
// Replaces the TPU kernel unimm_tpu/ops/pallas_head.py:
// online_softmax_xent_tpu (body _xent_kernel). On the TPU the vocab axis is
// a sequential grid dimension carrying (max, exp-sum, true logit) in
// scratch. Here blocks run in no order, so the sweep is split in two
// launches:
//   1. xent_wg_kernel: the logits h Wdec^T on the wgmma + TMA mainloop of
//      gemm_wg.cuh (2-D TMA loads with the 128-byte swizzle into a 4-stage
//      mbarrier ring, a producer warpgroup, two consumer warpgroups on
//      m64n256k16, setmaxnreg, one persistent CTA an SM over 128 x 256
//      tiles), copied here with its own tile order and epilogue so that
//      K2's and B8's gemm_nt_wg_kernel instances keep their machine code.
//      Each consumer reduces its 64 x 256 fp32 fragment in registers to
//      each row's (max, sum of exp(logit - max)) over the tile's vocab
//      columns, bias added; columns past V read as -1e30 (the TPU kernel's
//      bias padding, pallas_head.py:100-102; V = 30522 is not a multiple of
//      256, and the TMA zero-fills the decoder rows past V). The pair goes
//      to an fp32 scratch part [M, ceil(V / 256)] (25 MB at M 25600); the
//      one lane whose column is the row's label writes its logit to
//      label_logit [M].
//   2. xent_combine_kernel: one warp a row merges the row's partials
//      (max, then the rescaled sums) and writes nll.
// No atomics: the result is the same bit for bit on every run.
// The logits kernel is a template on the hidden width KW and on the bias:
// <768, true> is the ViLBERT head above (its machine code as before the
// template), <2048, false> the decoder's untied 163840-word LM head
// (models/deepseek_v3.py), which has no bias: 2 x 2048 x 163840 flops a
// row against 4 KB of row input and the 671 MB head, the tensor-core rate
// again (V is 640 whole vocab tiles).
// What bounds it on an H100: 2 x 768 x 30522 flops a row (1.2 TFLOP at
// M 25600, 1.21 ms at the bf16 peak) against 1.5 KB of row input and the
// 47 MB decoder, so the tensor-core rate. 24 000 tiles at M 25600 spread
// over 132 SMs leave no 1.5-wave tail (the first design's one CTA per
// 128-row block gave 200 CTAs). The tiles go in groups of 16 row tiles
// (on an H100 2.48 ms against 2.86 with the vocab tile fastest, PERF.md
// section 6): within a
// group the row tile changes fastest, so the CTAs in flight share a few
// decoder tiles and a few hidden blocks, and the decoder is read from
// device memory about once per group, not once per row tile. exp is
// ex2.approx with log2(e) folded into one FFMA per logit.
#include "gemm_wg.cuh"
#include "xent_tiles.cuh"

namespace {

template <int KW, bool BIAS>
__global__ void __launch_bounds__(WG_THREADS, 1)
    xent_wg_kernel(const __grid_constant__ WgMaps maps, const int M,
                   const int V, const float* __restrict__ bias,
                   const int* __restrict__ labels, float2* __restrict__ part,
                   float* __restrict__ label_logit) {
  constexpr int S = WG_STAGES, NJ = WG_BN / 8, NK = KW / WG_BK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sa = wg_smem_base(smem_raw);         // [S] A tiles
  const uint32_t sb = sa + S * WG_A_TILE;             // [S] B tiles
  const uint32_t full = sb + S * WG_B_TILE;           // [S] mbarriers
  const uint32_t empty = full + 8 * S;                // [S] mbarriers
  const int ntm = (M + WG_BM - 1) / WG_BM, ntn = (V + WG_BN - 1) / WG_BN;
  const int tiles = ntm * ntn;
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
        xw_tile(t, ntm, ntn, tm, tn);
        for (int kt = 0; kt < NK; ++kt, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(empty + 8 * s, ((it / S) - 1) & 1);
          mbar_expect_tx(full + 8 * s, WG_A_TILE + WG_B_TILE);
          tma_load(sa + s * WG_A_TILE, &maps.a, kt * WG_BK, tm * WG_BM,
                   full + 8 * s);
          tma_load(sb + s * WG_B_TILE, &maps.b[0], kt * WG_BK, tn * WG_BN,
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
    int tm, tn;
    xw_tile(t, ntm, ntn, tm, tn);
    for (int kt = 0; kt < NK; ++kt, ++it) {
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

    // the fragment: rows gr (h 0) and gr + 8 (h 1) of the warp's 16, the
    // quad's lanes holding 64 columns each
    const int n0 = tn * WG_BN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tm * WG_BM + wg * 64 + w * 16 + (lane >> 2) + h * 8;
      const int lab = row < M ? __ldg(labels + row) : -1;
      float mx = XW_PAD;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = n0 + j * 8 + gc;
        float v0, v1;
        if constexpr (BIAS) {
          v0 = col < V ? acc[j][2 * h] + __ldg(bias + col) : XW_PAD;
          v1 = col + 1 < V ? acc[j][2 * h + 1] + __ldg(bias + col + 1)
                           : XW_PAD;
        } else {
          v0 = col < V ? acc[j][2 * h] : XW_PAD;
          v1 = col + 1 < V ? acc[j][2 * h + 1] : XW_PAD;
        }
        acc[j][2 * h] = v0;
        acc[j][2 * h + 1] = v1;
        mx = fmaxf(mx, fmaxf(v0, v1));
        if (col == lab) label_logit[row] = v0;
        if (col + 1 == lab) label_logit[row] = v1;
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mc = mx * XW_LOG2E;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        sum += xw_ex2(fmaf(acc[j][2 * h], XW_LOG2E, -mc)) +
               xw_ex2(fmaf(acc[j][2 * h + 1], XW_LOG2E, -mc));
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (q == 0 && row < M)
        part[(long)row * ntn + tn] = make_float2(mx, sum);
    }
  }
}

constexpr int XC_WARPS = 8;

// nll[row] = (max + log(sum of sum_t exp(max_t - max))) - label logit
__global__ void __launch_bounds__(XC_WARPS * 32)
    xent_combine_kernel(const float2* __restrict__ part,
                        const float* __restrict__ label_logit,
                        const int* __restrict__ labels,
                        float* __restrict__ nll, int M, int ntn) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * XC_WARPS + warp;
  if (row >= M) return;
  if (labels[row] == -1) {
    if (lane == 0) nll[row] = 0.f;
    return;
  }
  const float2* p = part + row * ntn;
  float mx = XW_PAD;
  for (int t = lane; t < ntn; t += 32) mx = fmaxf(mx, p[t].x);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int t = lane; t < ntn; t += 32) sum += p[t].y * expf(p[t].x - mx);
  sum = warp_sum(sum);
  if (lane == 0) nll[row] = (mx + logf(sum)) - label_logit[row];
}

// the logits kernel of width KW for M rows: part and label_logit
template <int KW, bool BIAS>
cudaError_t launch_xent_tiles(const void* hid, const void* labels,
                              const void* w, const void* b, void* part,
                              void* label_logit, int M, int V,
                              cudaStream_t st) {
  if (M < 1 || V < 1 || (BIAS && b == nullptr)) return cudaErrorInvalidValue;
  WgMaps maps;
  cudaError_t err = tma_map(&maps.a, hid, M, KW, WG_BM);
  if (err == cudaSuccess) err = tma_map(&maps.b[0], w, V, KW, WG_BN);
  if (err != cudaSuccess) return err;
  const auto kernel = xent_wg_kernel<KW, BIAS>;
  static const cudaError_t ready =
      prepare_kernel(kernel, WG_THREADS,
                     128 * WG_PROD_REGS + 256 * WG_CONS_REGS, WG_SMEM);
  if (ready != cudaSuccess) return ready;
  const int ntn = (V + WG_BN - 1) / WG_BN;
  const int tiles = ((M + WG_BM - 1) / WG_BM) * ntn;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  kernel<<<tiles < sms ? tiles : sms, WG_THREADS, WG_SMEM, st>>>(
      maps, M, V, static_cast<const float*>(b),
      static_cast<const int*>(labels), static_cast<float2*>(part),
      static_cast<float*>(label_logit));
  return cudaGetLastError();
}

cudaError_t launch_xent_combine(const void* labels, void* part,
                                void* label_logit, void* nll, int M, int V,
                                cudaStream_t st) {
  const int ntn = (V + WG_BN - 1) / WG_BN;
  xent_combine_kernel<<<(M + XC_WARPS - 1) / XC_WARPS, XC_WARPS * 32, 0,
                        st>>>(
      static_cast<const float2*>(part),
      static_cast<const float*>(label_logit),
      static_cast<const int*>(labels), static_cast<float*>(nll), M, ntn);
  return cudaGetLastError();
}

}  // namespace

// the logits kernel alone at width 768: part and label_logit for M rows
// (the training cross-entropy's forward, xent_train.cu, combines them
// itself)
extern "C" int unimm_xent_tiles(const void* hid, const void* labels,
                                const void* w, const void* b, void* part,
                                void* label_logit, int M, int V,
                                void* stream) {
  return launch_xent_tiles<HID, true>(hid, labels, w, b, part, label_logit,
                                      M, V,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" int unimm_xent_head(const void* hid, const void* labels,
                               const void* w, const void* b, void* part,
                               void* label_logit, void* nll, int M, int V,
                               void* stream) {
  const int err =
      unimm_xent_tiles(hid, labels, w, b, part, label_logit, M, V, stream);
  if (err != cudaSuccess) return err;
  return launch_xent_combine(labels, part, label_logit, nll, M, V,
                             static_cast<cudaStream_t>(stream));
}

// the decoder's LM head: width 2048, no bias
extern "C" int unimm_xent_head_2048(const void* hid, const void* labels,
                                    const void* w, void* part,
                                    void* label_logit, void* nll, int M,
                                    int V, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_xent_tiles<2048, false>(
      hid, labels, w, nullptr, part, label_logit, M, V, st);
  if (err != cudaSuccess) return err;
  return launch_xent_combine(labels, part, label_logit, nll, M, V, st);
}
