// seq_attn_fwd_kernel<SCALE>: the one-pass forward of the per-head text
// attention, launched by text_attention.cu (B6's forward, SCALE_SCORES)
// and attention_v2.cu (B9, SCALE_Q). It replaces the TPU kernels
// unimm_tpu/ops/pallas_attention.py:_fwd_kernel (fused_text_attention's
// forward) and unimm_tpu/ops/pallas_attention_v2.py:_v2_kernel
// (attention_v2), whose function it computes: for q, k, v [B, H, L, 64]
// bf16 heads read through seq_attn.cuh's SeqLayout strides (32 <= L <=
// 256, L % 32 == 0) and desc [B, 3] int32,
//
//   s = q k^T (fp32) * scale (SCALE_SCORES), or bf16(q scale) k^T (SCALE_Q)
//   o = bf16(softmax_fp32(s + bias(desc)) v), each p rounded to bf16
//
// The rounding point of p: an online softmax with deferred normalisation.
// Key chunk c of a row gives p~ = bf16(exp2((s - m_c) log2(e))), m_c the
// row's running max through chunk c; o sums p~ v in fp32, rescaled by
// exp2((m_old - m_new) log2(e)) as the max grows, and is divided once by
// l, the fp32 sum of the unrounded p~ (rescaled alike), before it rounds
// to bf16. The twins and the TPU kernels round the normalised p instead.
// Either way each term carries one bf16 rounding of its probability
// (2^-9 relative), so the card checks' bound on the twins (TA_REL,
// chip_smoke.py) holds as it did. A row that attends no key (rows past a
// sequence's extent, dis rows at or past ctx_end) takes its softmax over
// all L keys at s - 10000, which is softmax(s) over them: the kernel drops
// the constant (the twins' fp32 sums at 10000 carry s to 2^-10; the
// kernel does not). Padding keys past L (L % 64 == 32) weigh 0.
// seq_attn_kernel (seq_attn.cuh), the first design, stays for B4, B5's
// forward and the bench probes B10 / B11.
//
// What bounds it on an H100: device memory. q, k, v read and o written,
// 4 B H L 64 x 2 bytes (805 MB for B9 at [512, 12, 256, 64], 0.240 ms at
// 3.35 TB/s) against 4 B H L^2 64 flops (103 GFLOP, 0.104 ms at the bf16
// peak) and one exp per open score. What each design point does:
//
// 1. Scores once. A CTA of 4 warps takes 64 query rows of one (sequence,
//    head); a warp holds its 16 rows' scores against one 64-key chunk as
//    mma.sync accumulators (32 fp32 a thread), takes the chunk's row max,
//    its exps and P.V, and goes on: one QK^T pass, no second one. (Holding
//    all 256 keys' scores for the exact max takes 128 registers a thread
//    on top of ~40 others: at 168, the 3-CTA budget, ptxas spilled, and
//    at 255 only 2 CTAs fit an SM and the kernel ran ~1.4x slower.)
// 2. The mask by row intervals (row_span, mirrored line for line by
//    ops/masks.row_intervals): each row's open keys are [lo, hi) plus at
//    most its diagonal, computed once per row. A 64-key chunk that every
//    row of a warp leaves closed is skipped (no QK^T, exp or P.V: exact,
//    since a row with an open key gives each masked key exp(s - 10000 -
//    max) = 0 in fp32; ops/masks.chunk_closed is the CPU twin of the
//    rule); a chunk every row of the warp fully attends takes no mask; the
//    rest cost two compares and a select per score. Masked scores are
//    -inf. A row that attends no key has the interval [0, L), so it skips
//    nothing.
// 3. exp2 and reciprocals: log2(e) (and SCALE_SCORES' scale) folds into
//    one FFMA per score before ex2.approx (one MUFU op); the row sum is
//    inverted once per row (rcp.approx).
// 4. Overlap and occupancy. Shared memory holds the sequence's K and V
//    and the CTA's q (2 x 256 + 64 rows of 128 bytes at L 256: 72 KB, no
//    padding: the 16-byte units of a row are XOR-swizzled by row & 7, so
//    ldmatrix is conflict-free), staged by cp.async. 3 CTAs (12 warps) fit
//    an SM: 3 x 72 KB of shared memory and at most 168 registers a thread
//    (__launch_bounds__(128, 3); seq_attn_fwd_info reports the count), so
//    one CTA's loads overlap two others' math. Under block_b > 1 a CTA
//    walks its sequences in turn: it loads the next sequence's q as soon
//    as its warps hold this one's, and K and V after the last P.V. (Waiting
//    per 64-key chunk instead, to start on chunk 0 before chunk 3 lands,
//    cost more in barriers than it gained.)
// 5. Tensor cores: mma.sync m16n8k16 (bf16 in, fp32 accumulators), the
//    fragment layout of seq_attn.cuh. Both rows are bound by bytes, and
//    mma.sync lets each warp skip chunks for its own 16 rows, where
//    wgmma's 64-row tiles would skip per warpgroup.
#pragma once

#include "seq_attn.cuh"

namespace {

constexpr int SF_ROWS = 64, SF_THREADS = 128, SF_KC = 64, SF_MAXC = 4;
constexpr int SF_ROW_BYTES = SA_D * 2;  // one row of 64 bf16 columns
constexpr float SF_LOG2E = 1.4426950408889634f;

// K and V of the sequence and the CTA's 64 query rows
__host__ __device__ __forceinline__ int sf_smem_bytes(int L) {
  return (2 * sa_keys(L) + SF_ROWS) * SF_ROW_BYTES;
}

// byte offset of 16-byte unit u (columns 8 u .. 8 u + 7) of row r
__device__ __forceinline__ uint32_t swz(int r, int u) {
  return r * SF_ROW_BYTES + ((u ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp16_s(uint32_t s, const void* g,
                                       bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(g), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t s) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t s) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d = a b (fp32 accumulators from zero)
__device__ __forceinline__ void mma_bf16_c0(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// bf16(x * s) for the two bf16 of x: SCALE_Q's q_s, as the twin rounds it
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float s) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack_bf16(f.x * s, f.y * s);
}

// Stage rows [0, rows) of a [*, 64] bf16 tile (row r at g + r sl) into
// swizzled shared memory at s; rows >= valid are zero-filled.
__device__ __forceinline__ void sf_stage(uint32_t s, const bf16* g, int sl,
                                         int rows, int valid, int tid) {
  for (int i = tid; i < rows * 8; i += SF_THREADS) {
    const int r = i >> 3, u = i & 7;
    const bool ok = r < valid;
    cp16_s(s + swz(r, u), ok ? g + (long)r * sl + u * 8 : g, ok);
  }
}

// Query row i's open keys: [lo, hi) and the key diag (-1: none); a row
// that attends no key gets [0, L). The zones of ops/masks.
// text_attention_mask, mode 0 dis and any other mode gen, as the twins'
// mask_bias selects them. ops/masks.row_intervals is the CPU twin.
struct RowSpan {
  int lo, hi, diag;
};

__device__ __forceinline__ RowSpan row_span(int i, int mode, int L1, int A,
                                            int L) {
  const int T = min(L1 + A, L), Lc = L1 - A;
  const int lo = (mode == 0 || i == 0) ? 0 : 1;
  int hi, diag = -1;
  if (mode == 0) hi = i < L1 ? L1 : 0;  // dis: rows < L1 attend [0, L1)
  else if (i == 0) hi = T;              // gen row 0: [0, T)
  else if (i < Lc) hi = Lc;             // context rows: [1, Lc)
  else if (i < L1) hi = i + 1;          // first copy: [1, i]
  else if (i < T) {                     // second copy: [1, i - A) + {i}
    hi = i - A;
    diag = i;
  } else hi = 0;                        // rows >= T: none
  hi = max(min(hi, L), lo);
  if (hi == lo && diag < 0) return RowSpan{0, L, -1};  // attends no key
  return RowSpan{lo, hi, diag};
}

// whether the row attends a key of [k0, k1)
__device__ __forceinline__ bool span_hits(const RowSpan& s, int k0, int k1) {
  return max(s.lo, k0) < min(s.hi, k1) || (s.diag >= k0 && s.diag < k1);
}

__device__ __forceinline__ bool span_open(const RowSpan& s, int j) {
  return (unsigned)(j - s.lo) < (unsigned)(s.hi - s.lo) || j == s.diag;
}

template <int SCALE>
__global__ void __launch_bounds__(SF_THREADS, 3)
    seq_attn_fwd_kernel(const SeqAttnArgs a) {
  static_assert(SCALE == SCALE_SCORES || SCALE == SCALE_Q,
                "the per-head kernels scale the scores or q");
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = a.L, NKP = sa_keys(L), nch = NKP / SF_KC, sl = a.in.sl;
  const uint32_t sK = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t sV = sK + NKP * SF_ROW_BYTES;
  const uint32_t sQ = sV + NKP * SF_ROW_BYTES;
  const int h = blockIdx.y, row0 = blockIdx.x * SF_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, gc = (lane & 3) * 2;
  const int ra = row0 + warp * 16 + gr, rb = ra + 8;  // this thread's rows
  // L % 32 == 0: a warp's 16 rows are all inside the sequence or all past
  // it; a warp past the end only stages and waits
  const bool active = row0 + warp * 16 < L;
  const int qrows = min(SF_ROWS, L - row0);
  const int b_first = blockIdx.z * a.bb, b_end = min(a.B, b_first + a.bb);
  const float c2 = (SCALE == SCALE_SCORES ? a.scale : 1.f) * SF_LOG2E;
  // the lane's ldmatrix rows; each address's unit is XORed with lane & 7,
  // which is its row & 7
  const int x7 = lane & 7;
  const uint32_t q_row = (warp * 16 + (lane & 15)) * SF_ROW_BYTES;
  const uint32_t k_row = (x7 + ((lane >> 4) << 3)) * SF_ROW_BYTES;
  const uint32_t v_row = (x7 + (((lane >> 3) & 1) << 3)) * SF_ROW_BYTES;
  const int q_u = lane >> 4, k_u = (lane >> 3) & 1, v_u = lane >> 4;
  auto head = [&](const bf16* t, int b) {
    return t + b * a.in.sb + h * a.in.sh;
  };

  sf_stage(sQ, head(a.q, b_first) + (long)row0 * sl, sl, SF_ROWS, qrows,
           tid);
  sf_stage(sK, head(a.k, b_first), sl, NKP, L, tid);
  sf_stage(sV, head(a.v, b_first), sl, NKP, L, tid);
  cp_commit();

  for (int b = b_first; b < b_end; ++b) {
    const bool next = b + 1 < b_end;
    cp_wait<0>();
    __syncthreads();
    uint32_t qf[SA_D / 16][4];
#pragma unroll
    for (int kd = 0; kd < SA_D / 16; ++kd) {
      ldsm_x4(qf[kd], sQ + q_row + (((kd * 2 + q_u) ^ x7) << 4));
      if (SCALE == SCALE_Q) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          qf[kd][r] = scale_bf16x2(qf[kd][r], a.scale);
      }
    }
    if (next) {  // the next sequence's q, once every warp holds this one's
      __syncthreads();
      sf_stage(sQ, head(a.q, b + 1) + (long)row0 * sl, sl, SF_ROWS, qrows,
               tid);
      cp_commit();
    }
    if (active) {
      const int mode = a.desc[3 * b], L1 = a.desc[3 * b + 1],
                A = a.desc[3 * b + 2];
      // live: a row of the warp attends a key of the chunk; full: every
      // row attends every key of it (no mask). Lane l votes for the warp's
      // row l % 16.
      unsigned live = 0, full = 0;
      {
        const RowSpan ls =
            row_span(row0 + warp * 16 + (lane & 15), mode, L1, A, L);
#pragma unroll
        for (int c = 0; c < SF_MAXC; ++c) {
          if (c >= nch) break;
          const int k0 = c * SF_KC, k1 = min(k0 + SF_KC, L);
          if (__any_sync(0xffffffffu, span_hits(ls, k0, k1)))
            live |= 1u << c;
          if (__all_sync(0xffffffffu, ls.lo <= k0 && ls.hi >= k0 + SF_KC))
            full |= 1u << c;
        }
      }
      const RowSpan sa = row_span(ra, mode, L1, A, L),
                    sb = row_span(rb, mode, L1, A, L);
      // running row max m (of s), exp-sum l (of the thread's columns) and
      // o = sum_j bf16(exp2((s_j - m) c2)) v_j, rescaled as m grows
      float o[8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int t = 0; t < 4; ++t) o[j][t] = 0.f;
#pragma unroll
      for (int c = 0; c < SF_MAXC; ++c) {
        if (!(live >> c & 1)) continue;
        float sc[8][4];
#pragma unroll
        for (int kd = 0; kd < SA_D / 16; ++kd)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            uint32_t kf[4];
            ldsm_x4(kf, sK + (c * SF_KC + jj * 16) * SF_ROW_BYTES + k_row +
                            (((kd * 2 + k_u) ^ x7) << 4));
            if (kd == 0) {
              mma_bf16_c0(sc[2 * jj], qf[kd], kf[0], kf[1]);
              mma_bf16_c0(sc[2 * jj + 1], qf[kd], kf[2], kf[3]);
            } else {
              mma_bf16(sc[2 * jj], qf[kd], kf[0], kf[1]);
              mma_bf16(sc[2 * jj + 1], qf[kd], kf[2], kf[3]);
            }
          }
        if (!(full >> c & 1)) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = c * SF_KC + j * 8 + gc;
#pragma unroll
            for (int t = 0; t < 4; ++t)
              if (!span_open(t < 2 ? sa : sb, col + (t & 1)))
                sc[j][t] = -INFINITY;
          }
        }
        float ms[2], alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float cm = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            cm = fmaxf(cm, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
          cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1));
          cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 2));
          const float mn = fmaxf(m[r], cm);
          // a row with no open key so far keeps m = -inf: its exps are 0
          ms[r] = mn == -INFINITY ? 0.f : mn * c2;
          alpha[r] = ex2(fmaf(m[r], c2, -ms[r]));
          m[r] = mn;
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            o[j][t] *= alpha[t >> 1];
            sc[j][t] = ex2(fmaf(sc[j][t], c2, -ms[t >> 1]));
            l[t >> 1] += sc[j][t];
          }
        // o += bf16(p) V over the chunk's keys
#pragma unroll
        for (int t = 0; t < 4; ++t) {  // keys 16 t .. 16 t + 15
          uint32_t pa[4];
          pa[0] = pack_bf16(sc[2 * t][0], sc[2 * t][1]);
          pa[1] = pack_bf16(sc[2 * t][2], sc[2 * t][3]);
          pa[2] = pack_bf16(sc[2 * t + 1][0], sc[2 * t + 1][1]);
          pa[3] = pack_bf16(sc[2 * t + 1][2], sc[2 * t + 1][3]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            uint32_t vf[4];
            ldsm_x4_t(vf, sV + (c * SF_KC + t * 16) * SF_ROW_BYTES + v_row +
                              (((jj * 2 + v_u) ^ x7) << 4));
            mma_bf16(o[2 * jj], pa, vf[0], vf[1]);
            mma_bf16(o[2 * jj + 1], pa, vf[2], vf[3]);
          }
        }
      }
      // o / l; each head's context rounds to bf16
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = rcp(l[r]);
      }
      bf16* out_a = a.ctx + b * a.out.sb + h * a.out.sh + (long)ra * a.out.sl;
      bf16* out_b = out_a + 8L * a.out.sl;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(out_a + j * 8 + gc) =
            __floats2bfloat162_rn(o[j][0] * inv[0], o[j][1] * inv[0]);
        *reinterpret_cast<__nv_bfloat162*>(out_b + j * 8 + gc) =
            __floats2bfloat162_rn(o[j][2] * inv[1], o[j][3] * inv[1]);
      }
    }
    if (next) {
      __syncthreads();  // K and V are read out
      sf_stage(sK, head(a.k, b + 1), sl, NKP, L, tid);
      sf_stage(sV, head(a.v, b + 1), sl, NKP, L, tid);
      cp_commit();
    }
  }
}

template <int SCALE>
void sf_configure(int smem) {
  cudaFuncSetAttribute(seq_attn_fwd_kernel<SCALE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(seq_attn_fwd_kernel<SCALE>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
}

template <int SCALE>
cudaError_t launch_seq_attn_fwd(const SeqAttnArgs& a, cudaStream_t st) {
  const int smem = sf_smem_bytes(a.L);
  sf_configure<SCALE>(smem);
  dim3 grid((a.L + SF_ROWS - 1) / SF_ROWS, a.H, (a.B + a.bb - 1) / a.bb);
  seq_attn_fwd_kernel<SCALE><<<grid, SF_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// out: registers a thread, local memory bytes a thread (stack and
// spills), dynamic shared memory bytes a CTA at length L, CTAs an SM
template <int SCALE>
cudaError_t seq_attn_fwd_info(int L, int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, seq_attn_fwd_kernel<SCALE>);
  if (e != cudaSuccess) return e;
  const int smem = sf_smem_bytes(L);
  sf_configure<SCALE>(smem);
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, seq_attn_fwd_kernel<SCALE>, SF_THREADS, smem);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = smem;
  out[3] = ctas;
  return e;
}

}  // namespace
