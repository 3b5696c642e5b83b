// Online-softmax label head: nll[m] = logsumexp(h_m Wdec^T + b) - logit at
// label[m], 0 where label[m] == -1.
//
// Replaces the TPU kernel unimm_tpu/ops/pallas_head.py:
// online_softmax_xent_tpu (body _xent_kernel). On the TPU the vocab axis is
// a sequential grid dimension carrying (max, exp-sum, true logit) in
// scratch; here one CTA per 128-row block walks every 128-wide vocab tile
// itself, so no state crosses CTAs. The hidden block stays in shared memory
// for the whole sweep; decoder slices stream through a 3-stage cp.async
// ring; the products are mma.sync m16n8k16 with fp32 accumulators, and each
// [128, 128] logits tile is reduced in registers: 8 warps as 4 (32 rows) x
// 2 (64 vocab columns) keep running (max, exp-sum, true logit) per row and
// per column half, merged once at the end. The running max starts at -1e30
// and the vocab tail reads as logit -1e30 (the TPU kernel's bias padding).
// Only [M] NLL is written.
// What bounds it on an H100: 2 * 768 * 30522 FLOP per row against 1.5 KB of
// row input, so the tensor-core rate; each CTA also streams the whole
// 47 MB decoder from L2.

#include "common.cuh"

namespace {

constexpr int XE_BM = 128, XE_VT = 128, XE_BK = 32, XE_STAGES = 3;
constexpr int XE_THREADS = 256;
constexpr int XE_LDH = HID + 8, XE_LDW = XE_BK + 8;
constexpr size_t XE_SMEM = (size_t)XE_BM * XE_LDH * 2 +
                           (size_t)XE_STAGES * XE_VT * XE_LDW * 2;

__global__ void __launch_bounds__(XE_THREADS, 1)
    xent_kernel(const bf16* __restrict__ hid, const int* __restrict__ labels,
                const bf16* __restrict__ w, const float* __restrict__ b,
                float* __restrict__ nll, int M, int V) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sH = reinterpret_cast<bf16*>(smem);        // [BM][LDH]
  bf16* sW = sH + XE_BM * XE_LDH;                  // [STAGES][VT][LDW]

  const long m0 = (long)blockIdx.x * XE_BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp >> 1, wc = warp & 1;
  const int gr = lane >> 2, gc = (lane & 3) * 2;
  const int valid = rows_left(m0, M, XE_BM);

  stage_tile(sH, XE_LDH, hid + m0 * HID, HID, XE_BM, HID, valid, tid,
             XE_THREADS);
  cp_commit();

  // running state of this thread's rows: slot 2 i + hh is local row
  // 32 wr + 16 i + gr + 8 hh; replicated over the lane quad
  float rm[4], rl[4], rt[4];
  int lab[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const long row = m0 + wr * 32 + (s >> 1) * 16 + gr + (s & 1) * 8;
    lab[s] = row < M ? labels[row] : -1;
    rm[s] = -1e30f;
    rl[s] = 0.f;
    rt[s] = 0.f;
  }

  const int n_vt = (V + XE_VT - 1) / XE_VT;
  constexpr int NK = HID / XE_BK;
  const int steps = n_vt * NK;
  auto stage = [&](int s) {
    const int vt = s / NK, kt = s - vt * NK;
    const int v0 = vt * XE_VT;
    stage_tile(sW + (s % XE_STAGES) * XE_VT * XE_LDW, XE_LDW,
               w + (long)v0 * HID + kt * XE_BK, HID, XE_VT, XE_BK,
               min(XE_VT, V - v0), tid, XE_THREADS);
  };
#pragma unroll
  for (int s = 0; s < XE_STAGES - 1; ++s) {
    if (s < steps) stage(s);
    cp_commit();
  }
  const int a_off = (wr * 32 + (lane & 15)) * XE_LDH + (lane >> 4) * 8;
  const int b_off = (wc * 64 + (lane & 7) + ((lane >> 4) << 3)) * XE_LDW +
                    ((lane >> 3) & 1) * 8;

  float acc[2][8][4];
  for (int s = 0; s < steps; ++s) {
    const int vt = s / NK, kt = s - vt * NK;
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;
    }
    cp_wait<XE_STAGES - 2>();
    __syncthreads();
    const int pf = s + XE_STAGES - 1;
    if (pf < steps) stage(pf);
    cp_commit();
    const bf16* a = sH + a_off + kt * XE_BK;
    const bf16* bw = sW + (s % XE_STAGES) * XE_VT * XE_LDW + b_off;
#pragma unroll
    for (int kk = 0; kk < XE_BK; kk += 16) {
      uint32_t af[2][4], bfr[4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldmatrix_x4(af[i], a + i * 16 * XE_LDH + kk);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        ldmatrix_x4(bfr[jj], bw + jj * 16 * XE_LDW + kk);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          mma_bf16(acc[i][2 * jj], af[i], bfr[jj][0], bfr[jj][1]);
          mma_bf16(acc[i][2 * jj + 1], af[i], bfr[jj][2], bfr[jj][3]);
        }
    }
    if (kt != NK - 1) continue;

    // the vocab tile is complete: online (max, exp-sum, true logit) update
    const int c0 = vt * XE_VT + wc * 64 + gc;
#pragma unroll
    for (int sl = 0; sl < 4; ++sl) {
      const int i = sl >> 1, hh = sl & 1;
      float lg[16];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + j * 8 + e;
          const float v = col < V ? acc[i][j][2 * hh + e] + b[col] : -1e30f;
          lg[2 * j + e] = v;
          cmax = fmaxf(cmax, v);
          if (col == lab[sl]) rt[sl] = v;
        }
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 1));
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 2));
      const float nm = fmaxf(rm[sl], cmax);
      float es = 0.f;
#pragma unroll
      for (int u = 0; u < 16; ++u) es += expf(lg[u] - nm);
      es += __shfl_xor_sync(0xffffffffu, es, 1);
      es += __shfl_xor_sync(0xffffffffu, es, 2);
      rl[sl] = rl[sl] * expf(rm[sl] - nm) + es;
      rm[sl] = nm;
    }
  }

  // the true logit sits in one lane of one column half: sum it over the
  // quad, then merge the two column halves' states through shared memory
#pragma unroll
  for (int sl = 0; sl < 4; ++sl) {
    rt[sl] += __shfl_xor_sync(0xffffffffu, rt[sl], 1);
    rt[sl] += __shfl_xor_sync(0xffffffffu, rt[sl], 2);
  }
  __syncthreads();
  float* mrg = reinterpret_cast<float*>(sW);       // [BM][3]
  if (wc == 1 && (lane & 3) == 0) {
#pragma unroll
    for (int sl = 0; sl < 4; ++sl) {
      const int r = wr * 32 + (sl >> 1) * 16 + gr + (sl & 1) * 8;
      mrg[3 * r] = rm[sl];
      mrg[3 * r + 1] = rl[sl];
      mrg[3 * r + 2] = rt[sl];
    }
  }
  __syncthreads();
  if (wc == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int sl = 0; sl < 4; ++sl) {
      const int r = wr * 32 + (sl >> 1) * 16 + gr + (sl & 1) * 8;
      if (m0 + r >= M) continue;
      const float pm = mrg[3 * r], pl = mrg[3 * r + 1], pt = mrg[3 * r + 2];
      const float mx = fmaxf(rm[sl], pm);
      const float l = rl[sl] * expf(rm[sl] - mx) + pl * expf(pm - mx);
      nll[m0 + r] =
          lab[sl] == -1 ? 0.f : (mx + logf(l)) - (rt[sl] + pt);
    }
  }
}

}  // namespace

extern "C" int unimm_xent_head(const void* hid, const void* labels,
                               const void* w, const void* b, void* nll,
                               int M, int V, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaFuncSetAttribute(xent_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)XE_SMEM);
  xent_kernel<<<(M + XE_BM - 1) / XE_BM, XE_THREADS, XE_SMEM, st>>>(
      static_cast<const bf16*>(hid), static_cast<const int*>(labels),
      static_cast<const bf16*>(w), static_cast<const float*>(b),
      static_cast<float*>(nll), M, V);
  return cudaGetLastError();
}
