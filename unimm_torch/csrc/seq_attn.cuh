// The attention kernels' common ground (the head layout, the launch
// arguments, the descriptor text mask, the mma.sync chunk steps) and the
// first design of the whole-sequence attention, seq_attn_kernel, which
// only the attention-block bench's probes B10 / B11 (block_probe.cu) still
// launch: they attribute its time. The forward of B4, B5, B6 and B9 runs
// the one-pass seq_attn_fwd.cuh, the backward of B5 and B6
// seq_attn_bwd.cuh; both take their layout and arguments from here. A
// head is a [L, 64] bf16 tile read
// through element strides (SeqLayout: sequence, head, row; the 64 columns
// are contiguous), so one kernel reads a block's projections (L 768, 64,
// 768), a contiguous [B, H, L, 64] tensor (H L 64, L 64, 64) and the
// head-split view of a [B, L, H 64] tensor (L H 64, 64, H 64) without a
// copy.
//
// seq_attn_kernel<SOFT, DH>: one CTA per (64-row query tile, head, bb
// sequences walked in turn). The sequence's K and V for the head (at most
// 256 x DH each) are staged in shared memory; a max/exp-sum pass over
// 64-key chunks, then an exact softmax pass that multiplies by V, scores
// in registers (B4's function, as the probes run it):
//
//   s = q_h k_h^T (fp32) + bias(desc, i, j)        (0 or -10000)
//       q arrives scaled by 1 / sqrt(64) and rounded
//   p = softmax_fp32(s);  ctx_h = bf16(bf16(p) v_h)
//
// SOFT and DH are the probes' variants; SOFT_EXACT at heads of 64 is B4's
// function:
//   SOFT_SCALE    p = s * 1e-4: no row statistic, one score pass; padding
//                 keys weigh 0 (their -inf would make -inf * 0 = NaN)
//   SOFT_NOSHIFT  p = exp(s - 20) / sum_j exp(s - 20): the exp-sum pass
//                 without the row max (a row whose keys are all masked
//                 sums to 0 and gives 0 / 0 = NaN, as its TPU probe does)
//   DH 128        heads of 128 columns (the bench's zero-padded heads)
//
// Rows past a sequence's extent are fully masked and, as in the TPU
// kernels, take their softmax over all L keys at s - 10000: no key tile is
// skipped, so every masked score pays its exp (the cost the one-pass
// kernel removes). Padding keys past L (L % 64 == 32) are zero rows at
// -inf.
#pragma once

#include "common.cuh"
#include "philox.cuh"

// The attention backward (seq_attn_bwd.cuh), defined in seq_attn_bwd.cu
// and called from text_attention.cu and attention_block_train.cu: q, k, v,
// dout [B, H, L, 64] (the in strides) into dq, dk, dv (the out strides);
// stats [B, H, 2, L] fp32 scratch; drop selects the Philox mask (seed,
// thresh, inv_keep), split the hi + lo operands of P and dS.
extern "C" int unimm_seq_attn_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, const void* desc,
                                  void* dq, void* dk, void* dv, void* stats,
                                  long in_sb, long in_sh, int in_sl,
                                  long out_sb, long out_sh, int out_sl, int B,
                                  int H, int L, float s_scale, float dq_scale,
                                  float dk_scale, unsigned seed,
                                  unsigned thresh, float inv_keep, int drop,
                                  int split, void* stream);

namespace {

constexpr int SA_QT = 64, SA_THREADS = 128, SA_KC = 64, SA_D = 64;
constexpr int SA_LD = SA_D + 8;
// q arrives scaled (the block kernels), or the one-pass kernel scales the
// scores (B6) or q (B9)
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
  DropArgs drop;      // the one-pass kernel's DROP
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

// sc (of key chunk c) += the text-mask bias; keys past L take pad
__device__ __forceinline__ void mask_chunk(float (&sc)[8][4], int c,
                                           const RowMask& r, float pad) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = c * SA_KC + j * 8 + r.gc;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int cc = col + (t & 1), row = t < 2 ? r.ra : r.rb;
      sc[j][t] = cc < r.L ? sc[j][t] + text_bias(row, cc, r.mode, r.L1,
                                                 r.A, r.L)
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

template <int SOFT, int DH>
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
    // L % 32 == 0: a warp's 16 rows are all inside the sequence or all past
    // it; a warp past the end waits for the next sequence
    if (row0 + warp * 16 >= L) continue;

    const int mode = a.desc[3 * b], L1 = a.desc[3 * b + 1],
              A = a.desc[3 * b + 2];
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
      mask_chunk(sc, c, rm, SOFT == SOFT_SCALE ? 0.f : -INFINITY);
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

    // pass 2: p = exp(s - max) / sum, rounded to bf16; ctx += p V
    float o[2 * KD][4];
#pragma unroll
    for (int j = 0; j < 2 * KD; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) o[j][t] = 0.f;
    for (int c = 0; c < nchunks; ++c) {
      float sc[8][4];
      scores(c, sc);
      chunk_probs<SOFT>(sc, m, l);
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

template <int SOFT, int DH = SA_D>
cudaError_t launch_seq_attn_heads(const SeqAttnArgs& a, cudaStream_t st) {
  const size_t smem = sa_smem_bytes(a.L, DH);
  cudaFuncSetAttribute(seq_attn_kernel<SOFT, DH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((a.L + SA_QT - 1) / SA_QT, a.H, (a.B + a.bb - 1) / a.bb);
  seq_attn_kernel<SOFT, DH><<<grid, SA_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// The probes' launch on a block's [B, L, 768] q (pre-scaled), k, v and
// ctx; each CTA walks bb sequences in turn.
template <int SOFT>
cudaError_t launch_seq_attn(const void* q, const void* k, const void* v,
                            const void* desc, void* ctx, int B, int L,
                            cudaStream_t st, int bb = 1) {
  const SeqLayout lay = block_layout(L);
  const SeqAttnArgs a{static_cast<const bf16*>(q),
                      static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v),
                      static_cast<const int*>(desc),
                      static_cast<bf16*>(ctx),
                      lay, lay, B, HID / SA_D, L, bb, 1.0f,
                      DropArgs{0u, 0u, 1.0f}};
  return launch_seq_attn_heads<SOFT>(a, st);
}

}  // namespace
