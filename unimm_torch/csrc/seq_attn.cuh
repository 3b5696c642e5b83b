// The whole-sequence attention launches of the attention kernels, forward
// and backward, and the descriptor text mask they share: attention_block.cu
// (B4) and attention_block_train.cu (B5) on the [B, L, 768] projections of
// a block, text_attention.cu (B6's backward) on [B, H, L, 64] heads; B6's
// forward and B9 run the one-pass seq_attn_fwd.cuh, which takes its
// layout and arguments from here. A head is a [L, 64] bf16 tile read
// through element strides (SeqLayout: sequence, head, row; the 64 columns
// are contiguous), so one kernel reads a block's projections (L 768, 64,
// 768), a contiguous [B, H, L, 64] tensor (H L 64, L 64, 64) and the
// head-split view of a [B, L, H 64] tensor (L H 64, 64, H 64) without a
// copy.
//
// seq_attn_kernel<DROP, SCALE, SOFT, DH>: one CTA per (64-row query tile,
// head, bb sequences walked in turn). The sequence's K and V for the head
// (at most 256 x DH each) are staged in shared memory; a max/exp-sum pass
// over 64-key chunks, then an exact softmax pass that multiplies by V,
// scores in registers:
//
//   s = q_h k_h^T (fp32) + bias(desc, i, j)        (0 or -10000)
//       SCALE_NONE    q arrives scaled by 1 / sqrt(64) (B4, B5)
//       SCALE_SCORES  s = (q_h k_h^T) * scale in fp32 (B6's first design)
//       SCALE_Q       q_h = bf16(q_h * scale) as it is staged (B9's first
//                     design; neither has a caller now, and the instances
//                     left keep their SASS while these branches stay)
//   p = softmax_fp32(s);  DROP: p *= Philox mask (0 or 1 / keep)
//   ctx_h = bf16(bf16(p) v_h)
//
// SOFT and DH serve the attention-block bench's probes (block_probe.cu);
// every other caller takes the defaults, SOFT_EXACT at heads of 64, whose
// code they leave as it was:
//   SOFT_SCALE    p = s * 1e-4: no row statistic, one score pass; padding
//                 keys weigh 0 (their -inf would make -inf * 0 = NaN)
//   SOFT_NOSHIFT  p = exp(s - 20) / sum_j exp(s - 20): the exp-sum pass
//                 without the row max (a row whose keys are all masked
//                 sums to 0 and gives 0 / 0 = NaN, as its TPU probe does)
//   DH 128        heads of 128 columns (the bench's zero-padded heads)
//
// seq_attn_bwd_kernel<DROP, SPLIT>: one CTA per (head, sequence); see its
// comment below.
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
enum : int { SCALE_NONE = 0, SCALE_SCORES = 1, SCALE_Q = 2 };
enum : int { SOFT_EXACT = 0, SOFT_SCALE = 1, SOFT_NOSHIFT = 2 };

// element strides of a [sequences, heads, rows, 64] tensor
struct SeqLayout {
  long sb, sh;
  int sl;
};

// the layout of a block's [B, L, 768] projections, 12 heads of 64
SeqLayout block_layout(int L, int pitch = HID) {
  return SeqLayout{(long)L * pitch, SA_D, pitch};
}

struct SeqAttnArgs {
  const bf16 *q, *k, *v;
  const int* desc;
  bf16* ctx;
  SeqLayout in, out;  // q, k, v; ctx
  int B, H, L, bb;    // bb: sequences per CTA
  float scale;        // SCALE_SCORES / SCALE_Q
  DropArgs drop;
};

// key rows staged: L rounded up to the 64-key chunk, the tail zero-filled
__host__ __device__ __forceinline__ int sa_keys(int L) {
  return (L + SA_KC - 1) / SA_KC * SA_KC;
}

size_t sa_smem_bytes(int L, int dh = SA_D) {
  return (size_t)(SA_QT + 2 * sa_keys(L)) * (dh + 8) * 2;
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

// The per-chunk steps of the two-pass softmax attention, shared by
// seq_attn_kernel and block_probe.cu's wo_acc_kernel. A warp holds the
// scores of 16 query rows (its rows ra and rb = ra + 8 per thread) against
// a 64-key chunk as mma accumulators sc[8][4]: sc[j][t] is row t < 2 ? ra
// : rb, key 8 j + gc + (t & 1) of the chunk. The K and V tile reads come
// in as functors, so a kernel chooses its own shared-memory layout.

// sc = q (A fragments qf, 16 rows x 16 KD columns) . (the chunk's keys)^T
// in fp32; load_k(kd, jj, kf) gives the B fragments of keys 16 jj .. 16 jj
// + 15 at head-dim columns 16 kd ..
template <int KD, class LoadK>
__device__ __forceinline__ void qk_chunk(const uint32_t (&qf)[KD][4],
                                         LoadK load_k, float (&sc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t) sc[j][t] = 0.f;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t kf[4];
      load_k(kd, jj, kf);
      mma_bf16(sc[2 * jj], qf[kd], kf[0], kf[1]);
      mma_bf16(sc[2 * jj + 1], qf[kd], kf[2], kf[3]);
    }
}

// a thread's rows and its sequence's descriptor
struct RowMask {
  int ra, rb, gc, mode, L1, A, L;
};

// sc (of key chunk c) += the text-mask bias; keys past L take pad; under
// SCALE_SCORES the scores are scaled first
template <int SCALE>
__device__ __forceinline__ void mask_chunk(float (&sc)[8][4], int c,
                                           const RowMask& r, float scale,
                                           float pad) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = c * SA_KC + j * 8 + r.gc;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int cc = col + (t & 1), row = t < 2 ? r.ra : r.rb;
      const float s = SCALE == SCALE_SCORES ? sc[j][t] * scale : sc[j][t];
      sc[j][t] = cc < r.L ? s + text_bias(row, cc, r.mode, r.L1, r.A, r.L)
                          : pad;
    }
  }
}

// pass 1 over one more chunk: the running max m and exp-sum l of rows ra
// (index 0) and rb (1); under SOFT_NOSHIFT the sum of exp(s - 20) alone.
// From m = -inf, l = 0 it gives the chunk's own max and exp-sum.
template <int SOFT>
__device__ __forceinline__ void chunk_stats(const float (&sc)[8][4],
                                            float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (SOFT == SOFT_NOSHIFT) {
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e += expf(sc[j][2 * r] - 20.f) + expf(sc[j][2 * r + 1] - 20.f);
      e += __shfl_xor_sync(0xffffffffu, e, 1);
      e += __shfl_xor_sync(0xffffffffu, e, 2);
      l[r] += e;
    } else {
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
}

// pass 2: the scores become probabilities: exp(s - m) / l, exp(s - 20) /
// l under SOFT_NOSHIFT, s * 1e-4 under SOFT_SCALE
template <int SOFT>
__device__ __forceinline__ void chunk_probs(float (&sc)[8][4],
                                            const float (&m)[2],
                                            const float (&l)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int r = t >> 1;
      if constexpr (SOFT == SOFT_SCALE)
        sc[j][t] = sc[j][t] * 1e-4f;
      else if constexpr (SOFT == SOFT_NOSHIFT)
        sc[j][t] = expf(sc[j][t] - 20.f) / l[r];
      else
        sc[j][t] = expf(sc[j][t] - m[r]) / l[r];
    }
}

// o += bf16(p) . (the chunk's V rows); load_v(t, jj, vf) gives the B
// fragments of keys 16 t .. 16 t + 15 at head-dim columns 16 jj ..
template <int KD, class LoadV>
__device__ __forceinline__ void pv_chunk(const float (&p)[8][4],
                                         LoadV load_v,
                                         float (&o)[2 * KD][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {       // k16 step: keys 16 t .. 16 t + 15
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * t][0], p[2 * t][1]);
    pa[1] = pack_bf16(p[2 * t][2], p[2 * t][3]);
    pa[2] = pack_bf16(p[2 * t + 1][0], p[2 * t + 1][1]);
    pa[3] = pack_bf16(p[2 * t + 1][2], p[2 * t + 1][3]);
#pragma unroll
    for (int jj = 0; jj < KD; ++jj) {  // head-dim columns 16 jj ..
      uint32_t vf[4];
      load_v(t, jj, vf);
      mma_bf16(o[2 * jj], pa, vf[0], vf[1]);
      mma_bf16(o[2 * jj + 1], pa, vf[2], vf[3]);
    }
  }
}

template <bool DROP, int SCALE, int SOFT = SOFT_EXACT, int DH = SA_D>
__global__ void __launch_bounds__(SA_THREADS)
    seq_attn_kernel(const SeqAttnArgs a) {
  constexpr int LD = DH + 8, KD = DH / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = a.L, NKP = sa_keys(L);
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [SA_QT][LD]
  bf16* sK = sQ + SA_QT * LD;                // [NKP][LD]
  bf16* sV = sK + NKP * LD;                  // [NKP][LD]

  const int h = blockIdx.y, row0 = blockIdx.x * SA_QT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qrows = min(SA_QT, L - row0);
  const int gr = lane >> 2, gc = (lane & 3) * 2;
  const int ra = row0 + warp * 16 + gr, rb = ra + 8;  // this thread's rows
  const int kb_off = ((lane & 7) + ((lane >> 4) << 3)) * LD +
                     ((lane >> 3) & 1) * 8;
  const int vb_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                     (lane >> 4) * 8;
  const int nchunks = NKP / SA_KC;
  const int b_end = min(a.B, (int)(blockIdx.z + 1) * a.bb);

  for (int b = blockIdx.z * a.bb; b < b_end; ++b) {
    const long base = b * a.in.sb + h * a.in.sh;
    __syncthreads();  // the previous sequence's tiles are read out
    stage_tile(sQ, LD, a.q + base + (long)row0 * a.in.sl, a.in.sl, SA_QT, DH,
               qrows, tid, SA_THREADS);
    stage_tile(sK, LD, a.k + base, a.in.sl, NKP, DH, L, tid, SA_THREADS);
    stage_tile(sV, LD, a.v + base, a.in.sl, NKP, DH, L, tid, SA_THREADS);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    if (SCALE == SCALE_Q) {  // q_s = bf16(q * scale), once per tile
      for (int i = tid; i < SA_QT * DH; i += SA_THREADS) {
        bf16* e = sQ + (i / DH) * LD + i % DH;
        *e = __float2bfloat16(__bfloat162float(*e) * a.scale);
      }
      __syncthreads();
    }
    // L % 32 == 0: a warp's 16 rows are all inside the sequence or all past
    // it; a warp past the end waits for the next sequence
    if (row0 + warp * 16 >= L) continue;

    const int mode = a.desc[3 * b], L1 = a.desc[3 * b + 1],
              A = a.desc[3 * b + 2];
    const uint32_t tag = (uint32_t)(b * a.H + h);
    uint32_t qf[KD][4];
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
      ldmatrix_x4(qf[kd], sQ + (warp * 16 + (lane & 15)) * LD + kd * 16 +
                              (lane >> 4) * 8);

    // scores of this warp's 16 rows against key chunk c (+ mask; past L
    // -inf, or 0 under SOFT_SCALE)
    const RowMask rm{ra, rb, gc, mode, L1, A, L};
    auto scores = [&](int c, float (&sc)[8][4]) {
      const bf16* kbuf = sK + c * SA_KC * LD + kb_off;
      qk_chunk(qf, [&](int kd, int jj, uint32_t (&kf)[4]) {
        ldmatrix_x4(kf, kbuf + jj * 16 * LD + kd * 16);
      }, sc);
      mask_chunk<SCALE>(sc, c, rm, a.scale,
                        SOFT == SOFT_SCALE ? 0.f : -INFINITY);
    };

    // pass 1: running max and exp-sum of rows ra (index 0) and rb (1); the
    // exp-sum alone under SOFT_NOSHIFT; nothing under SOFT_SCALE
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    if constexpr (SOFT != SOFT_SCALE) {
      for (int c = 0; c < nchunks; ++c) {
        float sc[8][4];
        scores(c, sc);
        chunk_stats<SOFT>(sc, m, l);
      }
    }

    // pass 2: p = exp(s - max) / sum (times the dropout scale), rounded to
    // bf16; ctx += p V
    float o[2 * KD][4];
#pragma unroll
    for (int j = 0; j < 2 * KD; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) o[j][t] = 0.f;
    for (int c = 0; c < nchunks; ++c) {
      float sc[8][4];
      scores(c, sc);
      chunk_probs<SOFT>(sc, m, l);
      if (DROP) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c * SA_KC + j * 8 + gc;
          const uint2 ua = drop_pair(a.drop, tag, ra, col);
          const uint2 ub = drop_pair(a.drop, tag, rb, col);
          sc[j][0] *= drop_scale(a.drop, ua.x);
          sc[j][1] *= drop_scale(a.drop, ua.y);
          sc[j][2] *= drop_scale(a.drop, ub.x);
          sc[j][3] *= drop_scale(a.drop, ub.y);
        }
      }
      const bf16* vbuf = sV + c * SA_KC * LD + vb_off;
      pv_chunk<KD>(sc, [&](int t, int jj, uint32_t (&vf)[4]) {
        ldmatrix_x4_trans(vf, vbuf + t * 16 * LD + jj * 16);
      }, o);
    }

    // each head's context rounds to bf16
    bf16* out_a = a.ctx + b * a.out.sb + h * a.out.sh + (long)ra * a.out.sl;
    bf16* out_b = out_a + 8L * a.out.sl;
#pragma unroll
    for (int j = 0; j < 2 * KD; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(out_a + j * 8 + gc) =
          __floats2bfloat162_rn(o[j][0], o[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(out_b + j * 8 + gc) =
          __floats2bfloat162_rn(o[j][2], o[j][3]);
    }
  }
}

template <bool DROP, int SCALE, int SOFT = SOFT_EXACT, int DH = SA_D>
cudaError_t launch_seq_attn_heads(const SeqAttnArgs& a, cudaStream_t st) {
  const size_t smem = sa_smem_bytes(a.L, DH);
  cudaFuncSetAttribute(seq_attn_kernel<DROP, SCALE, SOFT, DH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((a.L + SA_QT - 1) / SA_QT, a.H, (a.B + a.bb - 1) / a.bb);
  seq_attn_kernel<DROP, SCALE, SOFT, DH><<<grid, SA_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// The block kernels' launch: [B, L, 768] q (pre-scaled), k, v and ctx;
// each CTA walks bb sequences in turn.
template <bool DROP, int SOFT = SOFT_EXACT>
cudaError_t launch_seq_attn(const void* q, const void* k, const void* v,
                            const void* desc, void* ctx, int B, int L,
                            const DropArgs& drop, cudaStream_t st,
                            int bb = 1) {
  const SeqLayout lay = block_layout(L);
  const SeqAttnArgs a{static_cast<const bf16*>(q),
                      static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v),
                      static_cast<const int*>(desc),
                      static_cast<bf16*>(ctx),
                      lay, lay, B, HID / SA_D, L, bb, 1.0f, drop};
  return launch_seq_attn_heads<DROP, SCALE_NONE, SOFT>(a, st);
}

// ---------------------------------------------------------------------------
// seq_attn_bwd_kernel<DROP, SPLIT>, one CTA per (head, sequence): q, k, v
// and dout of the head (<= 256 x 64 bf16 each) and, under DROP, the head's
// dropout bits (one bit per (row, column): 8 KB at L 256, drawn once from
// the forward's Philox stream, philox.cuh) sit in shared memory. Three
// phases over 16-row warp tiles, every product on mma.sync with fp32
// accumulators, s = (q k^T) * s_scale + bias:
//   a. per query row: m, l of the softmax and D = sum_j dP_ij P_ij
//      (dP = dout v^T * mask), one online pass over the keys;
//   b. per query row: dS = P (dP - D); dq = bf16(dS k * dq_scale);
//   c. per key row: the same P and dS transposed; dv = bf16(Pd^T dout),
//      dk = bf16(dS^T q * dk_scale) (Pd = P * mask).
// P, Pd and dS enter the products rounded to bf16 (B5, whose plain twin
// rounds them at the same points), or, under SPLIT, as two bf16 terms
// hi = bf16(x), lo = bf16(x - hi) (B6, whose TPU kernel takes these
// products with fp32 operands): hi + lo keeps 16 of fp32's 24 significand
// bits (relative error <= 2^-17), the bf16 products are exact in the fp32
// accumulators, and the other operand (q, k, v or dout) is bf16 already.
// No [L, L] tensor leaves the SM; no atomics.
// ---------------------------------------------------------------------------
constexpr int BW_THREADS = 256, BW_WARPS = BW_THREADS / 32;

struct SeqAttnBwdArgs {
  const bf16 *q, *k, *v, *dout;
  const int* desc;
  bf16 *dq, *dk, *dv;
  SeqLayout in, out;  // q, k, v, dout; dq, dk, dv
  int L;
  float s_scale, dq_scale, dk_scale;
  DropArgs drop;
};

size_t bw_smem_bytes(int L) {
  const size_t nkp = sa_keys(L);
  return 4 * nkp * SA_LD * 2 + 3 * nkp * 4 + nkp * (nkp / 32) * 4;
}

// lo = bf16(a - hi.x), bf16(b - hi.y): the rounding residue of pack_bf16
__device__ __forceinline__ uint32_t pack_bf16_lo(float a, float b,
                                                 uint32_t hi) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  return pack_bf16(a - f.x, b - f.y);
}

template <bool DROP, bool SPLIT>
__global__ void __launch_bounds__(BW_THREADS, 1)
    seq_attn_bwd_kernel(const SeqAttnBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = a.L, NKP = sa_keys(L), NW = NKP / 32;
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [NKP][SA_LD] each
  bf16* sK = sQ + NKP * SA_LD;
  bf16* sV = sK + NKP * SA_LD;
  bf16* sO = sV + NKP * SA_LD;               // dout of the head
  float* sM = reinterpret_cast<float*>(sO + NKP * SA_LD);  // row max
  float* sL = sM + NKP;                                    // row exp-sum
  float* sD = sL + NKP;                                    // sum dP P
  uint32_t* sBits = reinterpret_cast<uint32_t*>(sD + NKP); // [NKP][NW]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long base = b * a.in.sb + h * a.in.sh;
  const int sl = a.in.sl;
  stage_tile(sQ, SA_LD, a.q + base, sl, NKP, SA_D, L, tid, BW_THREADS);
  stage_tile(sK, SA_LD, a.k + base, sl, NKP, SA_D, L, tid, BW_THREADS);
  stage_tile(sV, SA_LD, a.v + base, sl, NKP, SA_D, L, tid, BW_THREADS);
  stage_tile(sO, SA_LD, a.dout + base, sl, NKP, SA_D, L, tid, BW_THREADS);
  cp_commit();
  const uint32_t tag = (uint32_t)(b * gridDim.x + h);
  if (DROP) {
    // the forward's draws: word w of counter (c, row) is column 4 c + w
    for (int w = tid; w < NKP * NW; w += BW_THREADS) {
      const int row = w / NW, c4 = (w - row * NW) * 8;
      uint32_t bits = 0;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const uint4 u = philox4x32_10((uint32_t)(c4 + g), (uint32_t)row, 0u,
                                      0u, a.drop.seed, tag);
        bits |= ((uint32_t)(u.x < a.drop.thresh) << (4 * g)) |
                ((uint32_t)(u.y < a.drop.thresh) << (4 * g + 1)) |
                ((uint32_t)(u.z < a.drop.thresh) << (4 * g + 2)) |
                ((uint32_t)(u.w < a.drop.thresh) << (4 * g + 3));
      }
      sBits[w] = bits;
    }
  }
  for (int i = tid; i < NKP; i += BW_THREADS) {
    sM[i] = 0.f;
    sL[i] = 1.f;
    sD[i] = 0.f;
  }
  cp_wait<0>();
  __syncthreads();

  const int mode = a.desc[3 * b], L1 = a.desc[3 * b + 1],
            A = a.desc[3 * b + 2];
  const int gr = lane >> 2, gc = (lane & 3) * 2;
  const int nb_off = ((lane & 7) + ((lane >> 4) << 3)) * SA_LD +
                     ((lane >> 3) & 1) * 8;
  const int tb_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * SA_LD +
                     (lane >> 4) * 8;
  const int nchunks = NKP / SA_KC, ntiles = L / 16;

  auto mval = [&](int row, int col) -> float {
    if (!DROP) return 1.f;
    return ((sBits[row * NW + (col >> 5)] >> (col & 31)) & 1u)
               ? a.drop.inv_keep
               : 0.f;
  };
  // A fragments of 16 rows x 64 columns of a staged [rows][SA_LD] tile
  auto load_a = [&](const bf16* s, int r0, uint32_t(&f)[4][4]) {
#pragma unroll
    for (int kd = 0; kd < 4; ++kd)
      ldmatrix_x4(f[kd], s + (r0 + (lane & 15)) * SA_LD + kd * 16 +
                             (lane >> 4) * 8);
  };
  // out = A (16 x 64) . (rows 64 c .. 64 c + 63 of s)^T
  auto nt = [&](const uint32_t(&f_a)[4][4], const bf16* s, int c,
                float(&out)[8][4]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) out[j][t] = 0.f;
    const bf16* bb = s + c * SA_KC * SA_LD + nb_off;
#pragma unroll
    for (int kd = 0; kd < 4; ++kd)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t f[4];
        ldmatrix_x4(f, bb + jj * 16 * SA_LD + kd * 16);
        mma_bf16(out[2 * jj], f_a[kd], f[0], f[1]);
        mma_bf16(out[2 * jj + 1], f_a[kd], f[2], f[3]);
      }
  };
  // acc += vals (16 x 64, the chunk's rows as k) . rows 64 c .. of s, vals
  // rounded to bf16 or, under SPLIT, as hi + lo
  auto nn_acc = [&](const float(&vals)[8][4], const bf16* s, int c,
                    float(&acc)[8][4]) {
    const bf16* bb = s + c * SA_KC * SA_LD + tb_off;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      uint32_t pa[4], pl[4];
      pa[0] = pack_bf16(vals[2 * t][0], vals[2 * t][1]);
      pa[1] = pack_bf16(vals[2 * t][2], vals[2 * t][3]);
      pa[2] = pack_bf16(vals[2 * t + 1][0], vals[2 * t + 1][1]);
      pa[3] = pack_bf16(vals[2 * t + 1][2], vals[2 * t + 1][3]);
      if (SPLIT) {
        pl[0] = pack_bf16_lo(vals[2 * t][0], vals[2 * t][1], pa[0]);
        pl[1] = pack_bf16_lo(vals[2 * t][2], vals[2 * t][3], pa[1]);
        pl[2] = pack_bf16_lo(vals[2 * t + 1][0], vals[2 * t + 1][1], pa[2]);
        pl[3] = pack_bf16_lo(vals[2 * t + 1][2], vals[2 * t + 1][3], pa[3]);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, bb + t * 16 * SA_LD + jj * 16);
        mma_bf16(acc[2 * jj], pa, f[0], f[1]);
        mma_bf16(acc[2 * jj + 1], pa, f[2], f[3]);
        if (SPLIT) {
          mma_bf16(acc[2 * jj], pl, f[0], f[1]);
          mma_bf16(acc[2 * jj + 1], pl, f[2], f[3]);
        }
      }
    }
  };
  // scores of query rows ra / rb against key chunk c: scaled, + mask, -inf
  // past L
  auto add_bias = [&](int c, int ra, int rb, float(&sc)[8][4]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int col = c * SA_KC + j * 8 + gc + (t & 1);
        const int row = t < 2 ? ra : rb;
        sc[j][t] = col < L ? sc[j][t] * a.s_scale +
                                 text_bias(row, col, mode, L1, A, L)
                           : -INFINITY;
      }
  };
  auto store = [&](const float(&o)[8][4], bf16* dst, int ra, float scale) {
    bf16* pa = dst + b * a.out.sb + h * a.out.sh + (long)ra * a.out.sl;
    bf16* pb = pa + 8L * a.out.sl;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(pa + j * 8 + gc) =
          __floats2bfloat162_rn(o[j][0] * scale, o[j][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(pb + j * 8 + gc) =
          __floats2bfloat162_rn(o[j][2] * scale, o[j][3] * scale);
    }
  };

  // ---- a. softmax statistics and D per query row ------------------------
  for (int qt = warp; qt < ntiles; qt += BW_WARPS) {
    const int ra = qt * 16 + gr, rb = ra + 8;
    uint32_t qf[4][4], of[4][4];
    load_a(sQ, qt * 16, qf);
    load_a(sO, qt * 16, of);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f},
          dacc[2] = {0.f, 0.f};
    for (int c = 0; c < nchunks; ++c) {
      float sc[8][4], dp[8][4];
      nt(qf, sK, c, sc);
      add_bias(c, ra, rb, sc);
      nt(of, sV, c, dp);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? rb : ra;
        float cm = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          cm = fmaxf(cm, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1));
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 2));
        const float nm = fmaxf(m[r], cm);
        float e = 0.f, de = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int col = c * SA_KC + j * 8 + gc + u;
            const float ex = expf(sc[j][2 * r + u] - nm);
            e += ex;
            de += dp[j][2 * r + u] * mval(row, col) * ex;
          }
        e += __shfl_xor_sync(0xffffffffu, e, 1);
        e += __shfl_xor_sync(0xffffffffu, e, 2);
        de += __shfl_xor_sync(0xffffffffu, de, 1);
        de += __shfl_xor_sync(0xffffffffu, de, 2);
        const float sc_old = expf(m[r] - nm);
        l[r] = l[r] * sc_old + e;
        dacc[r] = dacc[r] * sc_old + de;
        m[r] = nm;
      }
    }
    if ((lane & 3) == 0) {
      sM[ra] = m[0];
      sL[ra] = l[0];
      sD[ra] = dacc[0] / l[0];
      sM[rb] = m[1];
      sL[rb] = l[1];
      sD[rb] = dacc[1] / l[1];
    }
  }
  __syncthreads();

  // ---- b. dq per query row ----------------------------------------------
  for (int qt = warp; qt < ntiles; qt += BW_WARPS) {
    const int ra = qt * 16 + gr, rb = ra + 8;
    uint32_t qf[4][4], of[4][4];
    load_a(sQ, qt * 16, qf);
    load_a(sO, qt * 16, of);
    const float m[2] = {sM[ra], sM[rb]}, l[2] = {sL[ra], sL[rb]},
                D[2] = {sD[ra], sD[rb]};
    float dq[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) dq[j][t] = 0.f;
    for (int c = 0; c < nchunks; ++c) {
      float sc[8][4], dp[8][4];
      nt(qf, sK, c, sc);
      add_bias(c, ra, rb, sc);
      nt(of, sV, c, dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int r = t >> 1, row = r ? rb : ra;
          const int col = c * SA_KC + j * 8 + gc + (t & 1);
          const float p = expf(sc[j][t] - m[r]) / l[r];
          sc[j][t] = p * (dp[j][t] * mval(row, col) - D[r]);   // dS
        }
      nn_acc(sc, sK, c, dq);
    }
    store(dq, a.dq, ra, a.dq_scale);
  }

  // ---- c. dk, dv per key row --------------------------------------------
  for (int kt = warp; kt < ntiles; kt += BW_WARPS) {
    const int ka = kt * 16 + gr, kb = ka + 8;
    uint32_t kf[4][4], vf[4][4];
    load_a(sK, kt * 16, kf);
    load_a(sV, kt * 16, vf);
    float dk[8][4], dv[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) dk[j][t] = dv[j][t] = 0.f;
    for (int c = 0; c < nchunks; ++c) {
      float st[8][4], dpt[8][4];   // [key row][query column]
      nt(kf, sQ, c, st);
      nt(vf, sO, c, dpt);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int key = t < 2 ? ka : kb;
          const int qi = c * SA_KC + j * 8 + gc + (t & 1);
          float pd = 0.f, ds = 0.f;
          if (qi < L) {
            const float p =
                expf(st[j][t] * a.s_scale +
                     text_bias(qi, key, mode, L1, A, L) - sM[qi]) /
                sL[qi];
            const float mv = mval(qi, key);
            pd = p * mv;
            ds = p * (dpt[j][t] * mv - sD[qi]);
          }
          st[j][t] = pd;
          dpt[j][t] = ds;
        }
      nn_acc(st, sO, c, dv);
      nn_acc(dpt, sQ, c, dk);
    }
    store(dk, a.dk, ka, a.dk_scale);
    store(dv, a.dv, ka, 1.0f);
  }
}

template <bool DROP, bool SPLIT>
cudaError_t launch_seq_attn_bwd(const SeqAttnBwdArgs& a, int B, int H,
                                cudaStream_t st) {
  const size_t smem = bw_smem_bytes(a.L);
  cudaFuncSetAttribute(seq_attn_bwd_kernel<DROP, SPLIT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  seq_attn_bwd_kernel<DROP, SPLIT><<<dim3(H, B), BW_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace
