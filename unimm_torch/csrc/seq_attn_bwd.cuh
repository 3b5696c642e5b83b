// The backward of the per-head text attention on 64-row tiles, launched
// through seq_attn_bwd.cu for text_attention.cu (B6's backward, SPLIT) and
// attention_block_train.cu (B5's attention backward, DROP at attention
// dropout > 0). It replaces the TPU kernels
// unimm_tpu/ops/pallas_attention.py:_bwd_kernel (fused_text_attention's
// VJP) and the attention part of
// unimm_tpu/ops/pallas_attention_v2.py:_train_bwd_kernel
// (fused_attention_block_train's backward), whose function it computes:
// for q, k, v, do [B, H, L, 64] bf16 heads read through seq_attn.cuh's
// SeqLayout strides (32 <= L <= 256, L % 32 == 0) and desc [B, 3] int32,
//
//   s  = (q k^T) * s_scale (fp32) + bias(desc);  p = softmax_fp32(s)
//   DROP: m = Philox keep mask * 1 / keep (philox.cuh, the forward's
//         stream: key (seed, b H + h), counter (column / 4, row)); else 1
//   dP = (do v^T) * m;  D = rowsum(dP * p);  dS = p (dP - D)
//   dq = bf16(dS k * dq_scale);  dk = bf16(dS^T q * dk_scale);
//   dv = bf16((p * m)^T do)
//
// D is the exact fp32 rowsum of the recomputed dP * p, as in the TPU
// kernels, not do . out (the forward's output is rounded to bf16). P * m
// and dS enter the products rounded to bf16 (B5, whose plain twin rounds
// them at the same points), or, under SPLIT, as two bf16 terms hi =
// bf16(x), lo = bf16(x - hi) (B6, whose TPU kernel takes these products
// with fp32 operands): hi + lo keeps 16 significand bits (relative error
// <= 2^-17) and each bf16 product is exact in the fp32 accumulators.
//
// Two launches, no atomics: every output element is summed by one CTA in
// a fixed order, so two runs on the same inputs give the same bits.
//   (a) seq_attn_bwd_dq_kernel, one CTA per (64 query rows, head,
//       sequence). Pass 1 over the key chunks: the row max m, exp-sum l
//       and D of each row (online, rescaled as m grows); lse = m c + log2
//       l (base 2, c = s_scale log2(e)) and D go to the fp32 scratch
//       stats [B, H, 2, L]. Pass 2 over the same chunks: p = exp2(s c -
//       lse), dS, dq += dS k.
//   (b) seq_attn_bwd_dkdv_kernel, one CTA per (64 key rows, head,
//       sequence), after (a): over the query chunks, the scores transposed
//       (S^T = k q^T, dP^T = v do^T), p = exp2(s c - lse) with each
//       query's lse and D from stats (no division), dv += (p m)^T do,
//       dk += dS^T q.
// Both keep 9 products a head (12 under SPLIT), as the first design
// (one CTA per (head, sequence), three phases) did.
//
// What bounds it on an H100: device memory. q, k, v, do read and dq, dk,
// dv written, 7 B H L 64 x 2 bytes (661 MB at [240, 12, 256, 64], 0.197
// ms at 3.35 TB/s) against the function's five L x L x 64 products a head
// (121 GFLOP, 0.122 ms at the bf16 peak). What each design point does:
//
// 1. Occupancy. A CTA is one warpgroup (4 warps) on its 64-row tile; the
//    other operand streams through a two-stage cp.async ring of 64-row
//    chunks (K and V in (a); Q, do, lse and D in (b); 16 KB a stage), so
//    a CTA holds 50-56 KB of shared memory, not the head's four [L, 64]
//    tiles (158 KB and one CTA an SM in the first design). (a) runs 4 CTAs
//    an SM at <= 128 registers, (b) 3 at <= 168 (seq_attn_bwd_info reports
//    them); [240, 12, 256, 64] gives 11,520 CTAs a launch, not 2,880.
// 2. Tensor cores: wgmma (m64nNk16, bf16 in, fp32 accumulators). S and dP
//    ((b): S^T and dP^T) read both operands from shared memory; dq, dk and
//    dv take P * m and dS (rounded, or hi + lo) from registers as A and
//    the chunk's k, q or do from shared memory as transposed (MN-major) B.
//    Tiles are 128-byte rows whose 16-byte units are XOR-swizzled by row &
//    7 (cp.async writes them so): wgmma's 128-byte swizzle, read through
//    descriptors as they are, on 1024-byte boundaries. (a) takes a 64-key
//    chunk a product, (b) 32 query rows (one after another, not unrolled).
//    The accumulators have mma.sync's C layout per 8 columns, so each warp
//    forms its own 16 rows' probabilities. On an H100 (700 W;
//    tools/bench_bwd on copies of these sources, one call each) wgmma took
//    B6's backward at [240, 12, 256, 64] from 1.20 ms on mma.sync
//    m16n8k16 (ldmatrix B fragments) to 1.00, and B5's from 3.11-3.15 to
//    2.93-3.00. Holding k and v as register A in (b), 16-row sub-chunks,
//    or issuing the next sub-chunk's S^T before this one's exps gained
//    less or spilled; (a) at 32 keys a product and 3 CTAs an SM ran 0.06
//    ms slower.
// 3. Score elements: the scale and log2(e) fold into one FFMA per score
//    before ex2.approx; no division per element (one per row, for D); the
//    mask from row_span intervals (seq_attn_fwd.cuh), not a bias computed
//    per score; a chunk that every row of a warp fully attends takes no mask there.
// 4. Closed chunks are skipped both ways, per CTA (exact: a masked key of
//    a row with an open key has p = exp(-10000 + ...) = 0 in fp32): (a)
//    skips a key chunk that no row of its 64 attends (masks.chunk_closed),
//    (b) a query chunk none of whose rows attends a key of its 64
//    (masks.query_chunk_closed); such a chunk is neither loaded nor
//    multiplied. A row that attends no key (past a sequence's extent, dis
//    rows at or past ctx_end) weighs every key, at s - 10000 in the twins:
//    softmax(s) over all L keys, which the kernel takes without the
//    constant, as the forward does. Padding keys past L weigh 0.
// 5. Dropout bits: each CTA draws only its own rows' (a) or key columns'
//    (b) bits from the forward's Philox stream into shared memory (one
//    bit an element), tagged b H + h from the sequence and head, so the
//    backward sees the forward's masks bit for bit.
#pragma once

#include "seq_attn_fwd.cuh"
#include "wgmma.cuh"

namespace {

constexpr int SB_ROWS = 64, SB_THREADS = 128, SB_KC = 64, SB_MAXC = 4;
constexpr int SB_STAGES = 2;
constexpr int SB_SUB_KV = 32;  // (b)'s query rows a product
constexpr int SB_TILE = SB_ROWS * SF_ROW_BYTES;  // 64 rows of 64 bf16
// the slack that puts the first tile on a 1024-byte boundary
constexpr int SB_ALIGN = 1024;

struct SeqAttnBwdArgs {
  const bf16 *q, *k, *v, *dout;
  const int* desc;
  bf16 *dq, *dk, *dv;
  float* stats;        // [B, H, 2, L] fp32: lse (base 2), then D
  SeqLayout in, out;   // q, k, v, dout; dq, dk, dv
  int H, L;
  float s_scale, dq_scale, dk_scale;
  DropArgs drop;
};

// (a): q and do of the tile, the ring of K and V chunks, under DROP the
// tile's bits (a row's words padded by one: conflict-free reads)
__host__ __device__ __forceinline__ int sb_dq_smem(int L, bool drop) {
  return SB_ALIGN + (2 + 2 * SB_STAGES) * SB_TILE +
         (drop ? SB_ROWS * (sa_keys(L) / 32 + 1) * 4 : 0);
}

// (b): k and v of the tile, the ring of q / do chunks, the ring's lse and
// D, every query row's open interval, under DROP the tile's bits (two
// words a row)
__host__ __device__ __forceinline__ int sb_kv_smem(int L, bool drop) {
  return SB_ALIGN + (2 + 2 * SB_STAGES) * SB_TILE +
         SB_STAGES * 2 * SB_KC * 4 + sa_keys(L) * 8 +
         (drop ? sa_keys(L) * 8 : 0);
}

// the dynamic shared memory from its first 1024-byte boundary (the
// 128-byte swizzle's pattern repeats every 8 rows of 128 bytes): its
// shared-window address and a generic pointer to it
__device__ __forceinline__ uint32_t sb_aligned(unsigned char* raw,
                                               unsigned char** out) {
  const uint32_t r = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  const uint32_t t = (r + SB_ALIGN - 1) & ~(uint32_t)(SB_ALIGN - 1);
  *out = raw + (t - r);
  return t;
}

// lo = bf16(a - hi.x), bf16(b - hi.y): the rounding residue of pack_bf16
__device__ __forceinline__ uint32_t pack_bf16_lo(float a, float b,
                                                 uint32_t hi) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  return pack_bf16(a - f.x, b - f.y);
}

// the keep bits of row `row`, columns col0 .. col0 + 31 (col0 % 32 == 0):
// bit j is column col0 + j; word w of counter (c, row) is column 4 c + w
__device__ __forceinline__ uint32_t drop_word(const DropArgs& d,
                                              uint32_t tag, int row,
                                              int col0) {
  uint32_t bits = 0;
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const uint4 u = philox4x32_10((uint32_t)(col0 / 4 + g), (uint32_t)row,
                                  0u, 0u, d.seed, tag);
    bits |= ((uint32_t)(u.x < d.thresh) << (4 * g)) |
            ((uint32_t)(u.y < d.thresh) << (4 * g + 1)) |
            ((uint32_t)(u.z < d.thresh) << (4 * g + 2)) |
            ((uint32_t)(u.w < d.thresh) << (4 * g + 3));
  }
  return bits;
}

// the chunks some warp of the CTA needs (bit c: chunk c), from each warp's
// own; every thread of the CTA calls it
__device__ __forceinline__ unsigned cta_chunks(unsigned live, int nch) {
  unsigned all = 0;
#pragma unroll
  for (int c = 0; c < SB_MAXC; ++c) {
    if (c >= nch) break;
    if (__syncthreads_or((live >> c) & 1u)) all |= 1u << c;
  }
  return all;
}

// the index of the k-th set bit of mask
__device__ __forceinline__ int nth_chunk(unsigned mask, int k) {
  for (; k > 0; --k) mask &= mask - 1;
  return __ffs(mask) - 1;
}

// bf16(o * scale) of a warp's 16 rows x 64 columns to rows ra, ra + 8 of
// (sequence b, head h) of dst
__device__ __forceinline__ void sb_store(const float (&o)[8][4], bf16* dst,
                                         const SeqLayout& lay, int b, int h,
                                         int ra, int gc, float scale) {
  bf16* pa = dst + b * lay.sb + h * lay.sh + (long)ra * lay.sl;
  bf16* pb = pa + 8L * lay.sl;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(pa + j * 8 + gc) =
        __floats2bfloat162_rn(o[j][0] * scale, o[j][1] * scale);
    *reinterpret_cast<__nv_bfloat162*>(pb + j * 8 + gc) =
        __floats2bfloat162_rn(o[j][2] * scale, o[j][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// wgmma with A from registers in mma.sync's A fragment layout (warp w:
// rows 16 w ..); the other building blocks are wgmma.cuh's
// ---------------------------------------------------------------------------
// c (64 x 64) += A (registers, 16 columns of k) . B, B the 16 rows of k
// of a tile whose rows hold the 64 columns of n (transposed B); the
// predicate reads 1: accumulate
__device__ __forceinline__ void wg_n64t(float (&c)[8][4],
                                        const uint32_t (&a)[4],
                                        uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]),
        "+f"(c[1][0]), "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3]),
        "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]), "+f"(c[2][3]),
        "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3]),
        "+f"(c[4][0]), "+f"(c[4][1]), "+f"(c[4][2]), "+f"(c[4][3]),
        "+f"(c[5][0]), "+f"(c[5][1]), "+f"(c[5][2]), "+f"(c[5][3]),
        "+f"(c[6][0]), "+f"(c[6][1]), "+f"(c[6][2]), "+f"(c[6][3]),
        "+f"(c[7][0]), "+f"(c[7][1]), "+f"(c[7][2]), "+f"(c[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// the A fragment of the warp's 16 rows x k columns 16 s .. 16 s + 15 from
// C fragments v rounded to bf16 (hi) and, under split, the residue (lo)
template <int NJ>
__device__ __forceinline__ void wg_pack(const float (&v)[NJ][4], int s,
                                        uint32_t (&hi)[4],
                                        uint32_t (&lo)[4], bool split) {
  const float(&a)[4] = v[2 * s];
  const float(&b)[4] = v[2 * s + 1];
  hi[0] = pack_bf16(a[0], a[1]);
  hi[1] = pack_bf16(a[2], a[3]);
  hi[2] = pack_bf16(b[0], b[1]);
  hi[3] = pack_bf16(b[2], b[3]);
  if (split) {
    lo[0] = pack_bf16_lo(a[0], a[1], hi[0]);
    lo[1] = pack_bf16_lo(a[2], a[3], hi[1]);
    lo[2] = pack_bf16_lo(b[0], b[1], hi[2]);
    lo[3] = pack_bf16_lo(b[2], b[3], hi[3]);
  }
}

// ---------------------------------------------------------------------------
// (a) the row statistics and dq
// ---------------------------------------------------------------------------
template <bool DROP, bool SPLIT>
__global__ void __launch_bounds__(SB_THREADS, 4)
    seq_attn_bwd_dq_kernel(const SeqAttnBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem;
  const uint32_t sQ = sb_aligned(smem_raw, &smem);
  const int L = a.L, nch = sa_keys(L) / SB_KC, NW = sa_keys(L) / 32;
  const uint32_t sO = sQ + SB_TILE, sRing = sO + SB_TILE;
  uint32_t* sBits =
      reinterpret_cast<uint32_t*>(smem + (2 + 2 * SB_STAGES) * SB_TILE);
  const int row0 = blockIdx.x * SB_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, gc = (lane & 3) * 2;
  const int ra = row0 + warp * 16 + gr, rb = ra + 8;  // this thread's rows
  // L % 32 == 0: a warp's 16 rows are all inside the sequence or all past
  // it; a warp past the end takes part in the warpgroup's products only
  const bool active = row0 + warp * 16 < L;
  const int sl = a.in.sl, qrows = min(SB_ROWS, L - row0);
  const long base = b * a.in.sb + h * a.in.sh;
  const int mode = a.desc[3 * b], L1 = a.desc[3 * b + 1],
            A = a.desc[3 * b + 2];
  const float c2 = a.s_scale * SF_LOG2E;

  // live: a row of the warp attends a key of the chunk; full: every row
  // attends every key of it (no mask). Lane l votes for the warp's row
  // l % 16. The CTA takes the chunks some warp needs.
  unsigned live = 0, full = 0;
  {
    const RowSpan ls =
        row_span(row0 + warp * 16 + (lane & 15), mode, L1, A, L);
#pragma unroll
    for (int c = 0; c < SB_MAXC; ++c) {
      if (c >= nch) break;
      const int k0 = c * SB_KC, k1 = min(k0 + SB_KC, L);
      if (__any_sync(0xffffffffu, span_hits(ls, k0, k1))) live |= 1u << c;
      if (__all_sync(0xffffffffu, ls.lo <= k0 && ls.hi >= k0 + SB_KC))
        full |= 1u << c;
    }
  }
  if (!active) live = 0;
  const unsigned chunks = cta_chunks(live, nch);
  const int n = __popc(chunks), nsteps = 2 * n;  // pass 1, then pass 2

  // step i: K and V of the (i mod n)-th chunk into stage i % SB_STAGES
  auto load = [&](int i) {
    const int c = nth_chunk(chunks, i < n ? i : i - n);
    const uint32_t st = sRing + (i % SB_STAGES) * 2 * SB_TILE;
    const long off = base + (long)c * SB_KC * sl;
    const int valid = min(SB_KC, L - c * SB_KC);
    sf_stage(st, a.k + off, sl, SB_KC, valid, tid);
    sf_stage(st + SB_TILE, a.v + off, sl, SB_KC, valid, tid);
  };
  sf_stage(sQ, a.q + base + (long)row0 * sl, sl, SB_ROWS, qrows, tid);
  sf_stage(sO, a.dout + base + (long)row0 * sl, sl, SB_ROWS, qrows, tid);
  load(0);
  cp_commit();
#pragma unroll
  for (int s = 1; s < SB_STAGES - 1; ++s) {
    if (s < nsteps) load(s);
    cp_commit();
  }
  const uint32_t tag = (uint32_t)(b * a.H + h);
  if (DROP) {
    for (int w = tid; w < SB_ROWS * NW; w += SB_THREADS) {
      const int r = w / NW, cw = w - r * NW;
      sBits[r * (NW + 1) + cw] = drop_word(a.drop, tag, row0 + r, cw * 32);
    }
  }
  cp_wait<SB_STAGES - 2>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const uint64_t dq_a = wg_desc(sQ), do_a = wg_desc(sO);
  const RowSpan sa = row_span(ra, mode, L1, A, L),
                sb = row_span(rb, mode, L1, A, L);
  const uint32_t* bits_a = sBits + (warp * 16 + gr) * (NW + 1);
  const uint32_t* bits_b = bits_a + 8 * (NW + 1);
  // pass 1: running max m (of s), exp-sum l and sum of exp * dP of the
  // thread's columns, rescaled as m grows; then lse and D (dd)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  float lse[2] = {0.f, 0.f};
  float dq[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t) dq[j][t] = 0.f;

  for (int i = 0; i < nsteps; ++i) {
    if (i + SB_STAGES - 1 < nsteps) load(i + SB_STAGES - 1);
    cp_commit();
    if (active && i == n) {  // pass 1 is done: the rows' lse and D
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        dd[r] += __shfl_xor_sync(0xffffffffu, dd[r], 1);
        dd[r] += __shfl_xor_sync(0xffffffffu, dd[r], 2);
        lse[r] = fmaf(m[r], c2, log2f(l[r]));
        dd[r] = dd[r] / l[r];
      }
      if ((lane & 3) == 0) {
        float* st = a.stats + ((long)b * a.H + h) * 2 * L;
        st[ra] = lse[0];
        st[rb] = lse[1];
        st[L + ra] = dd[0];
        st[L + rb] = dd[1];
      }
    }
    const int c = nth_chunk(chunks, i < n ? i : i - n);
    const uint32_t sK = sRing + (i % SB_STAGES) * 2 * SB_TILE;
    const uint32_t sV = sK + SB_TILE;
    const bool masked = !(full >> c & 1);
    const int k0 = c * SB_KC;
    {  // S and dP of the tile's 64 rows against the chunk's 64 keys
      float s[8][4], dp[8][4];
      const uint64_t kb = wg_desc(sK), vb = wg_desc(sV);
      wg_fence();
#pragma unroll
      for (int kd = 0; kd < 4; ++kd)
        wg_ss(s, dq_a + 2 * kd, kb + 2 * kd, kd);
#pragma unroll
      for (int kd = 0; kd < 4; ++kd)
        wg_ss(dp, do_a + 2 * kd, vb + 2 * kd, kd);
      wg_commit();
      wg_wait0();
      if (masked) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (!span_open(t < 2 ? sa : sb, k0 + j * 8 + gc + (t & 1)))
              s[j][t] = -INFINITY;
      }
      if (DROP) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int col = k0 + j * 8;
            const uint32_t w = (t < 2 ? bits_a : bits_b)[col >> 5];
            dp[j][t] = (w >> ((col & 31) + gc + (t & 1))) & 1u
                           ? dp[j][t] * a.drop.inv_keep
                           : 0.f;
          }
      }
      if (i < n) {
        float ms[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float cm = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            cm = fmaxf(cm, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
          cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1));
          cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 2));
          const float mn = fmaxf(m[r], cm);
          // a row with no open key so far keeps m = -inf: its exps are 0
          ms[r] = mn == -INFINITY ? 0.f : mn * c2;
          const float alpha = ex2(fmaf(m[r], c2, -ms[r]));
          m[r] = mn;
          l[r] *= alpha;
          dd[r] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float e = ex2(fmaf(s[j][t], c2, -ms[t >> 1]));
            l[t >> 1] += e;
            dd[t >> 1] = fmaf(e, dp[j][t], dd[t >> 1]);
          }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float p = ex2(fmaf(s[j][t], c2, -lse[t >> 1]));
            s[j][t] = p * (dp[j][t] - dd[t >> 1]);  // dS
          }
        wg_fence();  // dq += dS k, 16 keys a product
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          uint32_t ps[4], pls[4];
          wg_pack(s, t, ps, pls, SPLIT);
          const uint64_t kt = wg_desc(sK + 16 * t * SF_ROW_BYTES);
          wg_n64t(dq, ps, kt);
          if (SPLIT) wg_n64t(dq, pls, kt);
        }
        wg_commit();
        wg_wait0();
      }
    }
    cp_wait<SB_STAGES - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
  if (active) sb_store(dq, a.dq, a.out, b, h, ra, gc, a.dq_scale);
}

// ---------------------------------------------------------------------------
// (b) dk and dv
// ---------------------------------------------------------------------------
template <bool DROP, bool SPLIT>
__global__ void __launch_bounds__(SB_THREADS, 3)
    seq_attn_bwd_dkdv_kernel(const SeqAttnBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem;
  const uint32_t sK = sb_aligned(smem_raw, &smem);
  const int L = a.L, NKP = sa_keys(L), nch = NKP / SB_KC;
  const uint32_t sV = sK + SB_TILE, sRing = sV + SB_TILE;
  // the ring's lse and D, [SB_STAGES][2][SB_KC]
  float* sStat = reinterpret_cast<float*>(smem + 2 * SB_TILE +
                                          SB_STAGES * 2 * SB_TILE);
  int2* sSpan = reinterpret_cast<int2*>(sStat + SB_STAGES * 2 * SB_KC);
  uint32_t* sBits = reinterpret_cast<uint32_t*>(sSpan + NKP);  // [NKP][2]
  const int key0 = blockIdx.x * SB_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, gc = (lane & 3) * 2;
  const int kw0 = key0 + warp * 16;  // the warp's keys kw0 .. kw0 + 15
  const int ka = kw0 + gr;           // this thread's keys ka, ka + 8
  // a warp past the end takes part in the warpgroup's products only
  const bool active = kw0 < L;
  const int sl = a.in.sl;
  const long base = b * a.in.sb + h * a.in.sh;
  const int mode = a.desc[3 * b], L1 = a.desc[3 * b + 1],
            A = a.desc[3 * b + 2];
  const float c2 = a.s_scale * SF_LOG2E;
  const float* stats = a.stats + ((long)b * a.H + h) * 2 * L;

  sf_stage(sK, a.k + base + (long)key0 * sl, sl, SB_ROWS,
           min(SB_ROWS, L - key0), tid);
  sf_stage(sV, a.v + base + (long)key0 * sl, sl, SB_ROWS,
           min(SB_ROWS, L - key0), tid);
  cp_commit();
  for (int i = tid; i < NKP; i += SB_THREADS) {
    const RowSpan s = i < L ? row_span(i, mode, L1, A, L) : RowSpan{0, 0, -1};
    sSpan[i] = make_int2(s.lo | (s.hi << 16), s.diag);
  }
  const uint32_t tag = (uint32_t)(b * a.H + h);
  if (DROP) {
    for (int w = tid; w < 2 * NKP; w += SB_THREADS)
      sBits[w] = drop_word(a.drop, tag, w >> 1, key0 + (w & 1) * 32);
  }
  __syncthreads();

  // live: a row of the query chunk attends a key of the warp's 16; full:
  // every row of it attends all 16. Lane l votes for rows l and l + 32.
  // The CTA takes the chunks some warp needs.
  unsigned live = 0, full = 0;
  if (active) {
#pragma unroll
    for (int c = 0; c < SB_MAXC; ++c) {
      if (c >= nch) break;
      bool hit = false, cover = true;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int2 sp = sSpan[c * SB_KC + g * 32 + lane];
        const RowSpan s{sp.x & 0xffff, sp.x >> 16, sp.y};
        hit = hit || span_hits(s, kw0, kw0 + 16);
        cover = cover && s.lo <= kw0 && s.hi >= kw0 + 16;
      }
      if (__any_sync(0xffffffffu, hit)) live |= 1u << c;
      if (__all_sync(0xffffffffu, cover)) full |= 1u << c;
    }
  }
  const unsigned chunks = cta_chunks(live, nch);
  const int n = __popc(chunks);

  // step i: q, do, lse and D of the i-th chunk into stage i % SB_STAGES
  auto load = [&](int i) {
    const int c = nth_chunk(chunks, i), stg = i % SB_STAGES;
    const uint32_t st = sRing + stg * 2 * SB_TILE;
    const long off = base + (long)c * SB_KC * sl;
    const int valid = min(SB_KC, L - c * SB_KC);
    sf_stage(st, a.q + off, sl, SB_KC, valid, tid);
    sf_stage(st + SB_TILE, a.dout + off, sl, SB_KC, valid, tid);
    if (tid < 32) {  // 16 units of lse, then 16 of D; none past L
      const int u = tid & 15, row = c * SB_KC + u * 4;
      const float* g = stats + (tid >> 4) * L + row;
      const uint32_t dst = static_cast<uint32_t>(
          __cvta_generic_to_shared(sStat + stg * 2 * SB_KC));
      cp16_s(dst + tid * 16, row < L ? g : stats, row < L);
    }
  };
  if (n > 0) load(0);
  cp_commit();
#pragma unroll
  for (int s = 1; s < SB_STAGES - 1; ++s) {
    if (s < n) load(s);
    cp_commit();
  }
  cp_wait<SB_STAGES - 2>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const uint64_t k_a = wg_desc(sK), v_a = wg_desc(sV);
  const int bit0 = (warp & 1) * 16 + gr;
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t) dk[j][t] = dv[j][t] = 0.f;

  for (int i = 0; i < n; ++i) {
    if (i + SB_STAGES - 1 < n) load(i + SB_STAGES - 1);
    cp_commit();
    const int c = nth_chunk(chunks, i);
    const int stg = i % SB_STAGES;
    const uint32_t sQc = sRing + stg * 2 * SB_TILE, sOc = sQc + SB_TILE;
    const float* sLse = sStat + stg * 2 * SB_KC;
    const float* sD = sLse + SB_KC;
    const bool masked = !(full >> c & 1);
    // one sub-chunk at a time: unrolled, ptxas overlaps them and spills
#pragma unroll 1
    for (int hh = 0; hh < SB_KC / SB_SUB_KV; ++hh) {  // query rows r0 ..
      constexpr int NJ = SB_SUB_KV / 8;
      const int r0 = hh * SB_SUB_KV;
      float s[NJ][4], dp[NJ][4];  // S^T, dP^T: [key][query]
      const uint64_t qd = wg_desc(sQc + r0 * SF_ROW_BYTES);
      const uint64_t od = wg_desc(sOc + r0 * SF_ROW_BYTES);
      wg_fence();
#pragma unroll
      for (int kd = 0; kd < 4; ++kd)
        wg_ss(s, k_a + 2 * kd, qd + 2 * kd, kd);
#pragma unroll
      for (int kd = 0; kd < 4; ++kd)
        wg_ss(dp, v_a + 2 * kd, od + 2 * kd, kd);
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int ql = r0 + j * 8 + gc;  // the chunk's rows ql, ql + 1
        const float2 lse2 = *reinterpret_cast<const float2*>(sLse + ql);
        const float2 d2 = *reinterpret_cast<const float2*>(sD + ql);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int qi = c * SB_KC + ql + u;
          const float lse = u ? lse2.y : lse2.x, D = u ? d2.y : d2.x;
          int2 sp = make_int2(0, -1);
          if (masked) sp = sSpan[qi];
          uint32_t w = 0;
          if (DROP) w = sBits[qi * 2 + (warp >> 1)];
#pragma unroll
          for (int kr = 0; kr < 2; ++kr) {
            const int t = 2 * kr + u, key = ka + 8 * kr;
            const bool open =
                !masked || (unsigned)(key - (sp.x & 0xffff)) <
                               (unsigned)((sp.x >> 16) - (sp.x & 0xffff)) ||
                key == sp.y;
            const float p = open ? ex2(fmaf(s[j][t], c2, -lse)) : 0.f;
            const float mv = !DROP ? 1.f
                             : (w >> (bit0 + 8 * kr)) & 1u ? a.drop.inv_keep
                                                            : 0.f;
            s[j][t] = p * mv;                     // P * mask
            dp[j][t] = p * (dp[j][t] * mv - D);   // dS
          }
        }
      }
      wg_fence();  // dv += (P m)^T do, dk += dS^T q, 16 rows a product
#pragma unroll
      for (int t = 0; t < NJ / 2; ++t) {
        uint32_t ps[4], pls[4], ds[4], dls[4];
        wg_pack(s, t, ps, pls, SPLIT);
        wg_pack(dp, t, ds, dls, SPLIT);
        const uint64_t ot = wg_desc(sOc + (r0 + 16 * t) * SF_ROW_BYTES);
        const uint64_t qt = wg_desc(sQc + (r0 + 16 * t) * SF_ROW_BYTES);
        wg_n64t(dv, ps, ot);
        wg_n64t(dk, ds, qt);
        if (SPLIT) {
          wg_n64t(dv, pls, ot);
          wg_n64t(dk, dls, qt);
        }
      }
      wg_commit();
      wg_wait0();
    }
    cp_wait<SB_STAGES - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
  if (active) {
    sb_store(dk, a.dk, a.out, b, h, ka, gc, a.dk_scale);
    sb_store(dv, a.dv, a.out, b, h, ka, gc, 1.0f);
  }
}

inline void sb_configure(const void* fn, int smem) {
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
}

// (a) then (b) on one stream; a.stats holds [B, H, 2, L] fp32 of scratch
template <bool DROP, bool SPLIT>
cudaError_t launch_seq_attn_bwd(const SeqAttnBwdArgs& a, int B,
                                cudaStream_t st) {
  const dim3 grid((a.L + SB_ROWS - 1) / SB_ROWS, a.H, B);
  int smem = sb_dq_smem(a.L, DROP);
  sb_configure((const void*)seq_attn_bwd_dq_kernel<DROP, SPLIT>, smem);
  seq_attn_bwd_dq_kernel<DROP, SPLIT><<<grid, SB_THREADS, smem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  smem = sb_kv_smem(a.L, DROP);
  sb_configure((const void*)seq_attn_bwd_dkdv_kernel<DROP, SPLIT>, smem);
  seq_attn_bwd_dkdv_kernel<DROP, SPLIT><<<grid, SB_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// kernel 0 (a) or 1 (b); out: registers a thread, local memory bytes a
// thread (stack and spills), dynamic shared memory bytes a CTA at length
// L, CTAs an SM
template <bool DROP, bool SPLIT>
cudaError_t seq_attn_bwd_info(int kernel, int L, int* out) {
  const void* fn = kernel ? (const void*)seq_attn_bwd_dkdv_kernel<DROP, SPLIT>
                          : (const void*)seq_attn_bwd_dq_kernel<DROP, SPLIT>;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, fn);
  if (e != cudaSuccess) return e;
  const int smem = kernel ? sb_kv_smem(L, DROP) : sb_dq_smem(L, DROP);
  sb_configure(fn, smem);
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, SB_THREADS,
                                                    smem);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = smem;
  out[3] = ctas;
  return e;
}

}  // namespace
