// The whole-sequence attention launch of the attention sub-block kernels
// (attention_block.cu for eval, attention_block_train.cu for training) and
// the descriptor text mask they share.
//
// seq_attn_kernel<DROP>: one CTA per (64-row query tile, head, sequence).
// The sequence's K and V for the head (at most 256 x 64 each) are staged
// once in shared memory; a max/exp-sum pass over 64-key chunks, then an
// exact softmax pass that multiplies by V, scores in registers:
//
//   s = q_h k_h^T (fp32) + bias(desc, i, j)        (0 or -10000)
//   p = softmax_fp32(s);  DROP: p *= Philox mask (0 or 1 / keep)
//   ctx_h = bf16(bf16(p) v_h)
//
// Rows past a sequence's extent are fully masked and, as in the TPU
// kernels, take their softmax over all L keys at s - 10000: no key tile is
// skipped. Padding keys past L (L % 64 == 32) are zero rows at -inf.
#pragma once

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int SA_QT = 64, SA_THREADS = 128, SA_KC = 64, SA_D = 64;
constexpr int SA_LD = SA_D + 8;

// key rows staged: L rounded up to the 64-key chunk, the tail zero-filled
__host__ __device__ __forceinline__ int sa_keys(int L) {
  return (L + SA_KC - 1) / SA_KC * SA_KC;
}

size_t sa_smem_bytes(int L) {
  return (size_t)(SA_QT + 2 * sa_keys(L)) * SA_LD * 2;
}

// Additive text-mask bias of query row i and key column j: the zones of
// ops/masks.text_attention_mask, selected arithmetically as _mask_bias does
// (sel = dis (1 - mode) + gen mode; bias = (1 - sel) * -10000).
__device__ __forceinline__ float text_bias(int i, int j, int mode, int L1,
                                           int A, int L) {
  const int T = min(L1 + A, L), Lc = L1 - A;
  const bool diag = i == j;
  const int dis = (i < L1) && (j < L1);
  const int gen = (i == 0 && j < T) ||
                  (i >= 1 && i < Lc && ((j >= 1 && j < Lc) || diag)) ||
                  (i >= Lc && i < L1 && j >= 1 && j <= i) ||
                  (i >= L1 && i < T && ((j >= 1 && j < i - A) || diag));
  const int sel = dis * (1 - mode) + gen * mode;
  return (float)(1 - sel) * -10000.0f;
}

template <bool DROP>
__global__ void __launch_bounds__(SA_THREADS)
    seq_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ desc,
                    bf16* __restrict__ ctx, int L, DropArgs drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int NKP = sa_keys(L);
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [SA_QT][SA_LD]
  bf16* sK = sQ + SA_QT * SA_LD;             // [NKP][SA_LD]
  bf16* sV = sK + NKP * SA_LD;               // [NKP][SA_LD]

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * SA_QT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long base = (long)b * L * HID + (long)h * SA_D;
  const int qrows = min(SA_QT, L - row0);
  stage_tile(sQ, SA_LD, q + base + (long)row0 * HID, HID, SA_QT, SA_D,
             qrows, tid, SA_THREADS);
  stage_tile(sK, SA_LD, k + base, HID, NKP, SA_D, L, tid, SA_THREADS);
  stage_tile(sV, SA_LD, v + base, HID, NKP, SA_D, L, tid, SA_THREADS);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  // L % 32 == 0: a warp's 16 rows are all inside the sequence or all past
  // it; no barrier follows, so a warp past the end leaves here
  if (row0 + warp * 16 >= L) return;

  const int mode = desc[3 * b], L1 = desc[3 * b + 1], A = desc[3 * b + 2];
  const uint32_t tag = (uint32_t)(b * gridDim.y + h);
  const int gr = lane >> 2, gc = (lane & 3) * 2;
  const int ra = row0 + warp * 16 + gr, rb = ra + 8;  // this thread's rows
  const int kb_off = ((lane & 7) + ((lane >> 4) << 3)) * SA_LD +
                     ((lane >> 3) & 1) * 8;
  const int vb_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * SA_LD +
                     (lane >> 4) * 8;
  uint32_t qf[4][4];
#pragma unroll
  for (int kd = 0; kd < 4; ++kd)
    ldmatrix_x4(qf[kd], sQ + (warp * 16 + (lane & 15)) * SA_LD + kd * 16 +
                            (lane >> 4) * 8);

  // scores of this warp's 16 rows against key chunk c (+ mask; -inf past L)
  auto scores = [&](int c, float (&sc)[8][4]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) sc[j][t] = 0.f;
    const bf16* kbuf = sK + c * SA_KC * SA_LD;
#pragma unroll
    for (int kd = 0; kd < 4; ++kd)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kbuf + kb_off + jj * 16 * SA_LD + kd * 16);
        mma_bf16(sc[2 * jj], qf[kd], kf[0], kf[1]);
        mma_bf16(sc[2 * jj + 1], qf[kd], kf[2], kf[3]);
      }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c * SA_KC + j * 8 + gc;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int cc = col + (t & 1), row = t < 2 ? ra : rb;
        sc[j][t] = cc < L ? sc[j][t] + text_bias(row, cc, mode, L1, A, L)
                          : -INFINITY;
      }
    }
  };

  const int nchunks = NKP / SA_KC;
  // pass 1: running max and exp-sum of rows ra (index 0) and rb (1)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int c = 0; c < nchunks; ++c) {
    float sc[8][4];
    scores(c, sc);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float cm = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        cm = fmaxf(cm, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1));
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 2));
      const float nm = fmaxf(m[r], cm);
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e += expf(sc[j][2 * r] - nm) + expf(sc[j][2 * r + 1] - nm);
      e += __shfl_xor_sync(0xffffffffu, e, 1);
      e += __shfl_xor_sync(0xffffffffu, e, 2);
      l[r] = l[r] * expf(m[r] - nm) + e;
      m[r] = nm;
    }
  }

  // pass 2: p = exp(s - max) / sum (times the dropout scale), rounded to
  // bf16; ctx += p V
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t) o[j][t] = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    float sc[8][4];
    scores(c, sc);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int r = t >> 1;
        sc[j][t] = expf(sc[j][t] - m[r]) / l[r];
      }
    if (DROP) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * SA_KC + j * 8 + gc;
        const uint2 ua = drop_pair(drop, tag, ra, col);
        const uint2 ub = drop_pair(drop, tag, rb, col);
        sc[j][0] *= drop_scale(drop, ua.x);
        sc[j][1] *= drop_scale(drop, ua.y);
        sc[j][2] *= drop_scale(drop, ub.x);
        sc[j][3] *= drop_scale(drop, ub.y);
      }
    }
    const bf16* vbuf = sV + c * SA_KC * SA_LD;
#pragma unroll
    for (int t = 0; t < 4; ++t) {       // k16 step: keys 16 t .. 16 t + 15
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * t][0], sc[2 * t][1]);
      pa[1] = pack_bf16(sc[2 * t][2], sc[2 * t][3]);
      pa[2] = pack_bf16(sc[2 * t + 1][0], sc[2 * t + 1][1]);
      pa[3] = pack_bf16(sc[2 * t + 1][2], sc[2 * t + 1][3]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {  // head-dim columns 16 jj ..
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vbuf + vb_off + t * 16 * SA_LD + jj * 16);
        mma_bf16(o[2 * jj], pa, vf[0], vf[1]);
        mma_bf16(o[2 * jj + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // each head's context rounds to bf16
  bf16* out_a = ctx + base + (long)ra * HID;
  bf16* out_b = out_a + 8 * HID;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(out_a + j * 8 + gc) =
        __floats2bfloat162_rn(o[j][0], o[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(out_b + j * 8 + gc) =
        __floats2bfloat162_rn(o[j][2], o[j][3]);
  }
}

template <bool DROP>
cudaError_t launch_seq_attn(const void* q, const void* k, const void* v,
                            const void* desc, void* ctx, int B, int L,
                            const DropArgs& drop, cudaStream_t st) {
  const size_t smem = sa_smem_bytes(L);
  cudaFuncSetAttribute(seq_attn_kernel<DROP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((L + SA_QT - 1) / SA_QT, HID / SA_D, B);
  seq_attn_kernel<DROP><<<grid, SA_THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(desc),
      static_cast<bf16*>(ctx), L, drop);
  return cudaGetLastError();
}

}  // namespace
