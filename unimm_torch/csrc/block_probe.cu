// The attention-block bench's probes: B4's function (attention_block.cu)
// on B4's own design, with one part of its attention taken out
// (unimm_probe_block) or laid out another way (unimm_layout_probe_block).
// They are attribution tools: each times one piece of B4's cost on this
// card, so each launches B4's kernels where it can and a kernel of its own
// built from the same parts where it cannot.
//
// Replaces the TPU kernels scripts/bench_attn_block.py:_mk_probe (body
// _probe_kernel) and :_mk_layout_probe (bodies _probe_transposed_kernel,
// _probe_wo_acc_kernel, _probe_pad128_kernel). For x [B, L, 768] (L % 32
// == 0, 32 <= L <= 256) and desc [B, 3] int32, with B4's rounding points
// (the twins'):
//
//   q, k, v = bf16(x W^T + b);  q = bf16(fp32(q) / 8)
//   s = q_h k_h^T (fp32) + bias(desc, i, j)        (0 or -10000)
//   y = LN(out + bo + x) * gamma + beta                          (eps 1e-12)
//
// unimm_probe_block, by mode; the Q/K/V product gemm_nt_wg_kernel<QkvEpi>
// and the output product + row LayerNorm launch_gemm_residual_ln
// (gemm_wg.cuh) as B4 launches them, out = fp32(ctx Wo^T):
//   PROBE_FULL     p = softmax_fp32(s), ctx_h = bf16(bf16(p) v_h): B4
//                  itself, its attention launch launch_block_attn_fwd
//                  (seq_attn_fwd.cuh), so the output is B4's bit for bit
//   PROBE_NONE     p = bf16(s * 1e-4): no exp, no row statistic, no
//                  division; probe_attn_kernel<SOFT_SCALE>
//   PROBE_NOSHIFT  p = exp(s - 20) / sum exp(s - 20): no running max, no
//                  rescale; probe_attn_kernel<SOFT_NOSHIFT>. A row whose
//                  keys are all masked gives 0 / 0 = NaN, as on the TPU
//   PROBE_SKIP     ctx = v: no attention launch (q and k are still
//                  projected), so it times B4 without its attention
//
// unimm_layout_probe_block, by layout (B4's function, full softmax):
//   LAYOUT_WO_ACC      out = sum_h fp32(ctx_h Wo_h^T) in one kernel with
//                      the attention and the LayerNorm: no [B, L, 768]
//                      context and no fp32 pre-LayerNorm sum in device
//                      memory (two launches: the projection,
//                      wo_acc_wg_kernel<false>)
//   LAYOUT_TRANSPOSED  the projection stores q, k, v feature-major, [B,
//                      768, L] (QkvEpiT, a per-element epilogue of the
//                      same core); wo_acc_wg_kernel<true> reads K-major
//                      head tiles
//   LAYOUT_PAD128      weights zero-padded per head to 128 columns
//                      (ops/block_probe.pad_heads_128): projections of
//                      width 1536 on the core, probe_attn_kernel at heads
//                      of 128, the output product over K 1536; scale
//                      still 1 / sqrt(64)
//
// probe_attn_kernel<SOFT, DH, ROWS>: seq_attn_fwd_kernel's CTA (ROWS query
// rows of one (head, sequence), one warp per 16 rows, the sequence's K and
// V and the CTA's q staged by cp.async into rows XOR-swizzled by row & 7)
// with another softmax step in the same loop over 64-key chunks:
//   SOFT_EXACT    B4's online softmax (running max, rescale, one division;
//                 rows that attend no key weigh every key), at heads of
//                 128 (pad128: 160 KB of shared memory at L 256, one CTA
//                 an SM, so 128 rows a CTA: 8 warps share its K and V)
//   SOFT_SCALE    every chunk is computed: a masked key weighs (s -
//                 10000) 1e-4, about -1, not 0, so nothing can be skipped;
//                 padding keys past L (L % 64 == 32) weigh 0
//   SOFT_NOSHIFT  o sums bf16(exp(s + bias - 20)) v, l the unrounded exps;
//                 ctx = bf16(o / l) once. A chunk the warp's rows all
//                 leave closed is skipped (exact: exp(-10020) = 0 in
//                 fp32, masks.chunk_closed's rule); a row that attends no
//                 key keeps its -10000 (no B4 rule): l = 0, o = 0, NaN
// SOFT_SCALE and SOFT_NOSHIFT round each term once, as the twins do (the
// twin rounds the normalised p under noshift, the kernel exp(s - 20): one
// bf16 rounding of each term either way, as B4's one-pass rule).
//
// wo_acc_wg_kernel<KMAJOR>: one CTA of three warpgroups per (64 query
// rows, sequence); the 64 x 768 fp32 product accumulator (192 KB of
// registers, 128 a thread) and the attention's registers (~100 a thread)
// cannot be live in one thread at once under ptxas's cap of 168 a thread
// at 384 threads, so the kernel runs in three phases:
//   1. attention: warpgroups 0 and 1 take the heads h = wg, wg + 2, ...;
//      each stages its head's q into tile h of a [12][64, 64] bf16 tile
//      array (96 KB) and the head's K and V into a buffer of its own (64
//      KB at L 256: two buffers fill the 128 KB left beside the tiles, so
//      one warpgroup's loads run while the other computes), by cp.async;
//      one warp per 16 rows runs probe_attn_kernel's SOFT_EXACT loop (B4's
//      steps, closed chunks skipped) and writes ctx_h = bf16(o / l) over
//      q_h in tile h, in wgmma's 128-byte swizzle (warpgroup 2 waits).
//   2. product: acc[64, 768] = ctx Wo^T on wgmma m64n256k16, warpgroup g
//      the columns 256 g ..; A is the tile array (12 k tiles, the heads,
//      never leaving shared memory), B Wo's [256, 64] slabs by TMA into a
//      ring of 4 stages of 32 KB over the K / V buffers, item i = (head i
//      / 3, slab i % 3) in stage i % 4, issued by thread 0 as stages are
//      released. Three consumers share the ring, so a stage's "full"
//      mbarrier would be waited on by warpgroups up to two phases apart
//      (its parity then aliases an older phase): each warpgroup waits on
//      two "full" barriers of its own instead (its k-th item on barrier k
//      & 1, in order), and thread 0 alone waits on the stages' "empty"
//      barriers, in order.
//   3. epilogue: acc through shared memory (fp32 [64, 772]), then h =
//      (acc + bo) + x and the row LayerNorm (ln_row_store), a warp a row.
// No cross-CTA reduction: the result is deterministic; against the twin
// only the fp32 summation order differs. Wo streams once per CTA (1.18 MB
// from L2, 2.4 GB at [512, 256, 768]; 5.3 GB with 32-row CTAs, which
// staged a head's slice a head); K and V once per (CTA, head), as B4's
// attention.
//
// What bounds them on an H100: the tensor-core rate, as B4: 8 M 768^2 + 4
// B L^2 768 flops (0.72 TFLOP at [512, 256, 768]; pad128 twice B4's)
// against 0.4 GB of x and y. skip's function needs only the V and Wo
// products, 4 M 768^2 (0.31 TFLOP); its kernel also projects q and k
// (0.62 TFLOP as run).
#include "gemm_wg.cuh"
#include "seq_attn_fwd.cuh"

namespace {

enum : int { PROBE_FULL = 0, PROBE_NONE = 1, PROBE_NOSHIFT = 2,
             PROBE_SKIP = 3 };
enum : int { LAYOUT_WO_ACC = 0, LAYOUT_TRANSPOSED = 1, LAYOUT_PAD128 = 2 };
// the probe attention's softmax step
enum : int { SOFT_EXACT = 0, SOFT_SCALE = 1, SOFT_NOSHIFT = 2 };

// one matrix of QkvEpiT: QkvOne's values, stored feature-major: row b L +
// l, column c goes to y[(b ld + c) L + l] (2-byte stores L apart)
struct QkvOneT {
  static constexpr bool VEC = false;
  QkvOne e;
  int L;
  __device__ __forceinline__ void operator()(long row, int col, float v0,
                                             float v1) const {
    const __nv_bfloat162 o = e.value(col, v0, v1);
    const long seq = row / L, l = row - seq * L;
    bf16* dst = e.y + (seq * e.ld + col) * L + l;
    dst[0] = o.x;
    dst[L] = o.y;
  }
};

// The projection epilogue of LAYOUT_TRANSPOSED (gemm_wg.cuh's per-tile
// epilogue: at(z) is matrix z's)
struct QkvEpiT {
  QkvEpi e;
  int L;
  __device__ __forceinline__ QkvOneT at(int z) const {
    return QkvOneT{e.at(z), L};
  }
};

// byte offset of 16-byte unit u of row r in a tile of DH-column rows, the
// unit XORed with r & 7 (seq_attn_fwd.cuh's swz at any row width; at DH
// 64 wgmma's 128-byte swizzle)
template <int DH>
__device__ __forceinline__ uint32_t swz_dh(int r, int u) {
  return r * (DH * 2) + ((u ^ (r & 7)) << 4);
}

// Stage rows [0, rows) of a [*, DH] bf16 tile (row r at g + r sl) into the
// swizzled tile at s; rows >= valid are zero-filled.
template <int DH>
__device__ __forceinline__ void stage_rows(uint32_t s, const bf16* g, int sl,
                                           int rows, int valid, int tid,
                                           int nthreads) {
  constexpr int U = DH / 8;
  for (int i = tid; i < rows * U; i += nthreads) {
    const int r = i / U, u = i - r * U;
    const bool ok = r < valid;
    cp16_s(s + swz_dh<DH>(r, u), ok ? g + (long)r * sl + u * 8 : g, ok);
  }
}

// Stage columns [0, cols) (cols % 64 == 0) of a feature-major head [64
// dims, L] (dim r at g + r L) as 64-column chunk tiles [64 dims][64], 8 KB
// each, swizzled; columns >= valid are zero-filled.
__device__ __forceinline__ void stage_kmajor(uint32_t s, const bf16* g, int L,
                                             int cols, int valid, int tid,
                                             int nthreads) {
  const int units = cols / 8;
  for (int i = tid; i < SA_D * units; i += nthreads) {
    const int r = i / units, u = i - r * units;
    const bool ok = u * 8 < valid;
    cp16_s(s + (u >> 3) * (SA_D * SF_ROW_BYTES) + swz_dh<SA_D>(r, u & 7),
           ok ? g + (long)r * L + u * 8 : g, ok);
  }
}

// Whether query row i attends no key: row_span gives such a row [0, L)
// (B4's rule), which a real span is only for a dis row below ctx_end >= L
// or gen row 0 with ctx_end + ans_len >= L.
__device__ __forceinline__ bool attends_none(int i, int mode, int L1, int A,
                                             int L) {
  const RowSpan s = row_span(i, mode, L1, A, L);
  if (s.lo != 0 || s.hi != L || s.diag >= 0) return false;
  return mode == 0 ? i >= L1 : (i != 0 || L1 + A < L);
}

// One warp's attention over its 16 query rows r0 .. r0 + 15 of a sequence
// (rows qr0 .. of the q tile): o = sum_j bf16(p~_j) v_j over the chunks it
// does not skip, and f, each row's final factor (1 / l; 1 under
// SOFT_SCALE), in seq_attn_fwd_kernel's fragment layout (o[j][t]: row t <
// 2 ? ra : rb, column 8 j + gc + (t & 1)). Tiles as swz_dh lays them out;
// under KMAJOR (heads of 64) q is [64 dims][q rows] and K and V are
// stage_kmajor's chunk tiles.
template <int SOFT, int DH, bool KMAJOR>
__device__ __forceinline__ void attend_rows(uint32_t sQ, uint32_t sK,
                                            uint32_t sV, int qr0, int r0,
                                            int mode, int L1, int A, int L,
                                            float (&o)[DH / 8][4],
                                            float (&f)[2]) {
  static_assert(!KMAJOR || DH == SA_D, "K-major tiles hold heads of 64");
  constexpr int KD = DH / 16, CT = SA_D * SF_ROW_BYTES;  // K-major chunk
  const int lane = threadIdx.x & 31, x7 = lane & 7, gc = (lane & 3) * 2;
  const int ra = r0 + (lane >> 2), rb = ra + 8;
  const int nch = sa_keys(L) / SF_KC;
  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    if constexpr (KMAJOR)
      ldsm_x4_t(qf[kd], sQ + swz_dh<DH>(kd * 16 + ((lane >> 4) << 3) + x7,
                                        (qr0 >> 3) + ((lane >> 3) & 1)));
    else
      ldsm_x4(qf[kd], sQ + swz_dh<DH>(qr0 + (lane & 15),
                                      kd * 2 + (lane >> 4)));
  }
  // live: a row of the warp weighs a key of the chunk (masks.chunk_closed:
  // a row that attends no key weighs every key); every chunk under
  // SOFT_SCALE. full: every row attends every key of it (no mask; a row
  // that attends no key keeps its -10000 outside SOFT_EXACT). Lane l votes
  // for the warp's row l % 16.
  unsigned live = 0, full = 0;
  {
    const int i = r0 + (lane & 15);
    const RowSpan ls = row_span(i, mode, L1, A, L);
    const bool real = SOFT == SOFT_EXACT || !attends_none(i, mode, L1, A, L);
#pragma unroll
    for (int c = 0; c < SF_MAXC; ++c) {
      if (c >= nch) break;
      const int k0 = c * SF_KC, k1 = min(k0 + SF_KC, L);
      if (SOFT == SOFT_SCALE ||
          __any_sync(0xffffffffu, span_hits(ls, k0, k1)))
        live |= 1u << c;
      if (__all_sync(0xffffffffu,
                     real && ls.lo <= k0 && ls.hi >= k0 + SF_KC))
        full |= 1u << c;
    }
  }
  const RowSpan sa = row_span(ra, mode, L1, A, L),
                sb = row_span(rb, mode, L1, A, L);
  const bool na = SOFT != SOFT_EXACT && attends_none(ra, mode, L1, A, L);
  const bool nb = SOFT != SOFT_EXACT && attends_none(rb, mode, L1, A, L);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t) o[j][t] = 0.f;
#pragma unroll
  for (int c = 0; c < SF_MAXC; ++c) {
    if (!(live >> c & 1)) continue;
    float sc[8][4];
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t kf[4];
        if constexpr (KMAJOR)
          ldsm_x4_t(kf, sK + c * CT +
                            swz_dh<DH>(kd * 16 + (((lane >> 3) & 1) << 3) +
                                           x7,
                                       jj * 2 + (lane >> 4)));
        else
          ldsm_x4(kf, sK + swz_dh<DH>(c * SF_KC + jj * 16 + x7 +
                                          ((lane >> 4) << 3),
                                      kd * 2 + ((lane >> 3) & 1)));
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
        for (int t = 0; t < 4; ++t) {
          const int cc = col + (t & 1);
          const bool open = !(t < 2 ? na : nb) &&
                            span_open(t < 2 ? sa : sb, cc);
          if (SOFT == SOFT_SCALE)  // padding keys weigh 0
            sc[j][t] = cc >= L ? 0.f : open ? sc[j][t]
                                            : sc[j][t] + -10000.0f;
          else if (!open)
            sc[j][t] = -INFINITY;
        }
      }
    }
    if (SOFT == SOFT_EXACT) {  // seq_attn_fwd_kernel's step
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
        ms[r] = mn == -INFINITY ? 0.f : mn * SF_LOG2E;
        alpha[r] = ex2(fmaf(m[r], SF_LOG2E, -ms[r]));
        m[r] = mn;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          sc[j][t] = ex2(fmaf(sc[j][t], SF_LOG2E, -ms[t >> 1]));
          l[t >> 1] += sc[j][t];
        }
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
#pragma unroll
        for (int t = 0; t < 4; ++t) o[j][t] *= alpha[t >> 1];
    } else if (SOFT == SOFT_NOSHIFT) {  // exp(s - 20): no max, no rescale
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          sc[j][t] = ex2(fmaf(sc[j][t], SF_LOG2E, -20.0f * SF_LOG2E));
          l[t >> 1] += sc[j][t];
        }
    } else {  // SOFT_SCALE
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int t = 0; t < 4; ++t) sc[j][t] *= 1e-4f;
    }
    // o += bf16(p~) V over the chunk's keys
#pragma unroll
    for (int t = 0; t < 4; ++t) {  // keys 16 t .. 16 t + 15
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * t][0], sc[2 * t][1]);
      pa[1] = pack_bf16(sc[2 * t][2], sc[2 * t][3]);
      pa[2] = pack_bf16(sc[2 * t + 1][0], sc[2 * t + 1][1]);
      pa[3] = pack_bf16(sc[2 * t + 1][2], sc[2 * t + 1][3]);
#pragma unroll
      for (int jj = 0; jj < KD; ++jj) {
        uint32_t vf[4];
        if constexpr (KMAJOR)
          ldsm_x4(vf, sV + c * CT +
                          swz_dh<DH>(jj * 16 + ((lane >> 4) << 3) + x7,
                                     t * 2 + ((lane >> 3) & 1)));
        else
          ldsm_x4_t(vf, sV + swz_dh<DH>(c * SF_KC + t * 16 + x7 +
                                            (((lane >> 3) & 1) << 3),
                                        jj * 2 + (lane >> 4)));
        mma_bf16(o[2 * jj], pa, vf[0], vf[1]);
        mma_bf16(o[2 * jj + 1], pa, vf[2], vf[3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (SOFT == SOFT_SCALE) {
      f[r] = 1.f;
    } else {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      f[r] = rcp(l[r]);  // l = 0 (noshift, no open key): 0 * inf = NaN
    }
  }
}

// K and V of the sequence and the CTA's q rows, rows of DH bf16
template <int DH, int ROWS>
__host__ __device__ __forceinline__ int pa_smem_bytes(int L) {
  return (2 * sa_keys(L) + ROWS) * DH * 2;
}

template <int SOFT, int DH, int ROWS>
__global__ void __launch_bounds__(ROWS * 2, DH == SA_D ? 3 : 1)
    probe_attn_kernel(const SeqAttnArgs a) {
  constexpr int THREADS = ROWS * 2;  // a warp per 16 rows
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = a.L, NKP = sa_keys(L), sl = a.in.sl;
  const uint32_t sK = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t sV = sK + NKP * DH * 2, sQ = sV + NKP * DH * 2;
  const int h = blockIdx.y, b = blockIdx.z, row0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long head = b * a.in.sb + h * a.in.sh;
  stage_rows<DH>(sQ, a.q + head + (long)row0 * sl, sl, ROWS, L - row0, tid,
                 THREADS);
  stage_rows<DH>(sK, a.k + head, sl, NKP, L, tid, THREADS);
  stage_rows<DH>(sV, a.v + head, sl, NKP, L, tid, THREADS);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  // L % 32 == 0: a warp's 16 rows are all inside the sequence or all past
  if (row0 + warp * 16 >= L) return;
  float o[DH / 8][4], f[2];
  attend_rows<SOFT, DH, false>(sQ, sK, sV, warp * 16, row0 + warp * 16,
                               a.desc[3 * b], a.desc[3 * b + 1],
                               a.desc[3 * b + 2], L, o, f);
  const int ra = row0 + warp * 16 + (lane >> 2), gc = (lane & 3) * 2;
  bf16* out_a = a.ctx + b * a.out.sb + h * a.out.sh + (long)ra * a.out.sl;
  bf16* out_b = out_a + 8L * a.out.sl;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(out_a + j * 8 + gc) =
        __floats2bfloat162_rn(o[j][0] * f[0], o[j][1] * f[0]);
    *reinterpret_cast<__nv_bfloat162*>(out_b + j * 8 + gc) =
        __floats2bfloat162_rn(o[j][2] * f[1], o[j][3] * f[1]);
  }
}

// the probe attention of a block's [B, L, W] q (pre-scaled), k, v and ctx
// in heads of DH (W = 12 DH)
template <int SOFT, int DH, int ROWS>
cudaError_t launch_probe_heads(const void* q, const void* k, const void* v,
                               const void* desc, void* ctx, int B, int L,
                               cudaStream_t st) {
  const SeqLayout lay{(long)L * (HID / SA_D) * DH, DH, (HID / SA_D) * DH};
  const SeqAttnArgs a{static_cast<const bf16*>(q),
                      static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v),
                      static_cast<const int*>(desc),
                      static_cast<bf16*>(ctx),
                      lay, lay, B, HID / SA_D, L, 1, 1.0f,
                      DropArgs{0u, 0u, 1.0f}};
  const int smem = pa_smem_bytes<DH, ROWS>(L);
  cudaFuncSetAttribute(probe_attn_kernel<SOFT, DH, ROWS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((L + ROWS - 1) / ROWS, a.H, B);
  probe_attn_kernel<SOFT, DH, ROWS><<<grid, ROWS * 2, smem, st>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wo_acc_wg_kernel
// ---------------------------------------------------------------------------
constexpr int WA_ROWS = 64, WA_THREADS = 384, WA_HEADS = HID / SA_D;
constexpr int WA_TILE = WA_ROWS * SF_ROW_BYTES;    // one head's q or ctx
constexpr int WA_KV = 2 * 256 * SF_ROW_BYTES;      // K and V at L 256
constexpr int WA_STAGES = 4, WA_SLAB = WG_BN * WG_ROW;  // Wo [256, 64]
constexpr int WA_LDC = HID + 4;  // pitch of the fp32 epilogue tile
constexpr int WA_FULL = 6;  // two "full" mbarriers a warpgroup
constexpr size_t WA_SMEM = 1024 + (size_t)WA_HEADS * WA_TILE +
                           2 * (size_t)WA_KV + (WA_FULL + WA_STAGES) * 8;
static_assert(WA_STAGES * WA_SLAB <= 2 * WA_KV, "the ring fits the buffers");
static_assert(WA_ROWS * WA_LDC * 4 <= WA_HEADS * WA_TILE + 2 * WA_KV,
              "the epilogue tile fits");

struct WoAccArgs {
  const bf16 *q, *k, *v;
  const int* desc;
  const bf16 *x, *bo, *gamma, *beta;
  bf16* out;
  float eps;
  int L;
};

// the 128 threads of warpgroup wg (wg 0, 1) meet
__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t s, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(s), "r"(v) : "memory");
}

template <bool KMAJOR>
__global__ void __launch_bounds__(WA_THREADS, 1)
    wo_acc_wg_kernel(const __grid_constant__ CUtensorMap wo_map,
                     const WoAccArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(
      smem_raw));
  const uint32_t sC = wg_smem_base(smem_raw);  // [12] q, then ctx, tiles
  const uint32_t sR = sC + WA_HEADS * WA_TILE;  // K / V; then the Wo ring
  const uint32_t full = sR + 2 * WA_KV, empty = full + 8 * WA_FULL;
  float* sOut = reinterpret_cast<float*>(smem_raw + (sC - raw));
  const int L = p.L, NKP = sa_keys(L), b = blockIdx.y;
  const int row0 = blockIdx.x * WA_ROWS;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, gr = lane >> 2, gc = (lane & 3) * 2;
  const bool active = row0 + warp * 16 < L;

  if (tid == 0) {
    for (int s = 0; s < WA_FULL; ++s) mbar_init(full + 8 * s, 1);
    // a stage's item is read by one warpgroup, which releases it
    for (int s = 0; s < WA_STAGES; ++s) mbar_init(empty + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // 1. attention, warpgroups 0 and 1 in turns of heads
  if (wg < 2) {
    const int mode = p.desc[3 * b], L1 = p.desc[3 * b + 1],
              A = p.desc[3 * b + 2];
    const uint32_t sK = sR + wg * WA_KV, sV = sK + NKP * SF_ROW_BYTES;
    const int t = tid & 127;
    for (int h = wg; h < WA_HEADS; h += 2) {
      const uint32_t sQ = sC + h * WA_TILE;
      if (KMAJOR) {  // head h: rows 64 h .. of the sequence's [768, L]
        const long base = ((long)b * HID + h * SA_D) * L;
        stage_kmajor(sQ, p.q + base + row0, L, WA_ROWS, L - row0, t, 128);
        stage_kmajor(sK, p.k + base, L, NKP, L, t, 128);
        stage_kmajor(sV, p.v + base, L, NKP, L, t, 128);
      } else {
        const long base = (long)b * L * HID + h * SA_D;
        stage_rows<SA_D>(sQ, p.q + base + (long)row0 * HID, HID, WA_ROWS,
                         L - row0, t, 128);
        stage_rows<SA_D>(sK, p.k + base, HID, NKP, L, t, 128);
        stage_rows<SA_D>(sV, p.v + base, HID, NKP, L, t, 128);
      }
      cp_commit();
      cp_wait<0>();
      wg_bar(wg);
      float o[8][4], f[2] = {0.f, 0.f};
      if (active)
        attend_rows<SOFT_EXACT, SA_D, KMAJOR>(sQ, sK, sV, warp * 16,
                                              row0 + warp * 16, mode, L1, A,
                                              L, o, f);
      wg_bar(wg);  // q, K and V are read out
      // ctx_h = bf16(o / l) over q_h; rows past L are zeros
      const int r = warp * 16 + gr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        st_shared(sQ + swz_dh<SA_D>(r, j) + gc * 2,
                  active ? pack_bf16(o[j][0] * f[0], o[j][1] * f[0]) : 0u);
        st_shared(sQ + swz_dh<SA_D>(r + 8, j) + gc * 2,
                  active ? pack_bf16(o[j][2] * f[1], o[j][3] * f[1]) : 0u);
      }
    }
  }
  // the context tiles (written here) are read by wgmma, and the K / V
  // buffers (read here) are overwritten by TMA: both async-proxy accesses
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // 2. acc = ctx Wo^T, warpgroup wg the columns 256 wg ..
  int next = 0;  // thread 0: ring items issued
  auto issue = [&](int upto) {
    for (; next < upto && next < 3 * WA_HEADS; ++next) {
      const int s = next % WA_STAGES, kt = next / 3, g = next - 3 * kt;
      if (next >= WA_STAGES)
        mbar_wait(empty + 8 * s, ((next / WA_STAGES) - 1) & 1);
      const uint32_t fb = full + 8 * (2 * g + (kt & 1));
      mbar_expect_tx(fb, WA_SLAB);
      tma_load(sR + s * WA_SLAB, &wo_map, kt * WG_BK, g * WG_BN, fb);
    }
  };
  if (tid == 0) issue(WA_STAGES);
  float acc[WG_BN / 8][4];
#pragma unroll
  for (int j = 0; j < WG_BN / 8; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[j][u] = 0.f;
  for (int kt = 0; kt < WA_HEADS; ++kt) {
    const int s = (3 * kt + wg) % WA_STAGES;
    mbar_wait(full + 8 * (2 * wg + (kt & 1)), (kt >> 1) & 1);
    __syncwarp();  // the warp converged for the .aligned wgmma
    const uint64_t da = wg_desc(sC + kt * WA_TILE);
    const uint64_t db = wg_desc(sR + s * WA_SLAB);
    wg_pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
      wg_ss<WG_BN / 8>(acc, da + 2 * kk, db + 2 * kk, 1);
    wg_commit();
    wg_wait0();
    wg_pin(acc);
    if ((tid & 127) == 0) mbar_arrive(empty + 8 * s);
    // the next two heads' slabs, as the warpgroups release this head's
    if (tid == 0) issue(3 * (kt + 1) + WA_STAGES);
  }
  __syncthreads();  // every product and load is done: the tiles are free

  // 3. h = (acc + bo) + x, then the row LayerNorm
#pragma unroll
  for (int j = 0; j < WG_BN / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(sOut + (warp * 16 + gr + hh * 8) * WA_LDC +
                                 wg * WG_BN + j * 8 + gc) =
          make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
  __syncthreads();
  const long m0 = (long)b * L + row0;
  for (int r = tid >> 5; r < WA_ROWS && row0 + r < L;
       r += WA_THREADS / 32) {
    float hv[HID / 32];
#pragma unroll
    for (int j = 0; j < HID / 32; ++j) {
      const int c = lane + 32 * j;
      hv[j] = (sOut[r * WA_LDC + c] + __bfloat162float(p.bo[c])) +
              __bfloat162float(p.x[(m0 + r) * HID + c]);
    }
    ln_row_store(hv, p.gamma, p.beta, p.eps, p.out + (m0 + r) * HID, lane);
  }
}

template <bool KMAJOR>
cudaError_t launch_wo_acc(const WoAccArgs& p, const void* wo, int B,
                          cudaStream_t st) {
  CUtensorMap map;
  cudaError_t err = tma_map(&map, wo, HID, HID, WG_BN);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wo_acc_wg_kernel<KMAJOR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)WA_SMEM);
  if (err != cudaSuccess) return err;
  wo_acc_wg_kernel<KMAJOR>
      <<<dim3((p.L + WA_ROWS - 1) / WA_ROWS, B), WA_THREADS, WA_SMEM, st>>>(
          map, p);
  return cudaGetLastError();
}

// registers, local bytes, dynamic shared memory and CTAs an SM of a kernel
template <class K>
cudaError_t kernel_fit(K kernel, int threads, int smem, int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads,
                                                    smem);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = smem;
  out[3] = ctas;
  return e;
}

}  // namespace

extern "C" int unimm_probe_block(
    const void* x, const void* desc, const void* wq, const void* bq,
    const void* wk, const void* bk, const void* wv, const void* bv,
    const void* wo, const void* bo, const void* gamma, const void* beta,
    void* q_buf, void* k_buf, void* v_buf, void* ctx_buf, void* pre_buf,
    void* out, int B, int L, int mode, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode < PROBE_FULL || mode > PROBE_SKIP) return cudaErrorInvalidValue;
  const int M = B * L;
  const GemmArgs g{static_cast<const bf16*>(x),
                   {static_cast<const bf16*>(wq),
                    static_cast<const bf16*>(wk),
                    static_cast<const bf16*>(wv)},
                   M, HID, HID};
  const QkvEpi e{{static_cast<const bf16*>(bq), static_cast<const bf16*>(bk),
                  static_cast<const bf16*>(bv)},
                 {static_cast<bf16*>(q_buf), static_cast<bf16*>(k_buf),
                  static_cast<bf16*>(v_buf)},
                 {0.125f, 1.0f, 1.0f},  // q scale: 1 / sqrt(head_dim 64)
                 HID};
  cudaError_t err = launch_gemm_nt_wg(g, 3, e, st);
  if (err != cudaSuccess) return err;
  if (mode == PROBE_FULL)
    err = launch_block_attn_fwd<false>(q_buf, k_buf, v_buf, desc, ctx_buf, B,
                                       L, DropArgs{0u, 0u, 1.0f}, st);
  else if (mode == PROBE_NONE)
    err = launch_probe_heads<SOFT_SCALE, SA_D, SF_ROWS>(
        q_buf, k_buf, v_buf, desc, ctx_buf, B, L, st);
  else if (mode == PROBE_NOSHIFT)
    err = launch_probe_heads<SOFT_NOSHIFT, SA_D, SF_ROWS>(
        q_buf, k_buf, v_buf, desc, ctx_buf, B, L, st);
  else
    ctx_buf = v_buf;  // PROBE_SKIP
  if (err != cudaSuccess) return err;
  return launch_gemm_residual_ln(ctx_buf, wo, bo, x, gamma, beta, eps,
                                 pre_buf, out, M, HID, st);
}

extern "C" int unimm_layout_probe_block(
    const void* x, const void* desc, const void* wq, const void* bq,
    const void* wk, const void* bk, const void* wv, const void* bv,
    const void* wo, const void* bo, const void* gamma, const void* beta,
    void* q_buf, void* k_buf, void* v_buf, void* ctx_buf, void* pre_buf,
    void* out, int B, int L, int layout, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout < LAYOUT_WO_ACC || layout > LAYOUT_PAD128)
    return cudaErrorInvalidValue;
  const int M = B * L;
  const int W = layout == LAYOUT_PAD128 ? 2 * HID : HID;  // projection width
  const GemmArgs g{static_cast<const bf16*>(x),
                   {static_cast<const bf16*>(wq),
                    static_cast<const bf16*>(wk),
                    static_cast<const bf16*>(wv)},
                   M, W, HID};
  const QkvEpi e{{static_cast<const bf16*>(bq), static_cast<const bf16*>(bk),
                  static_cast<const bf16*>(bv)},
                 {static_cast<bf16*>(q_buf), static_cast<bf16*>(k_buf),
                  static_cast<bf16*>(v_buf)},
                 {0.125f, 1.0f, 1.0f},  // q scale: 1 / sqrt(head_dim 64)
                 W};
  cudaError_t err = layout == LAYOUT_TRANSPOSED
                        ? launch_gemm_nt_wg(g, 3, QkvEpiT{e, L}, st)
                        : launch_gemm_nt_wg(g, 3, e, st);
  if (err != cudaSuccess) return err;
  if (layout == LAYOUT_PAD128) {  // 12 heads of 128 columns, rows of 1536
    err = launch_probe_heads<SOFT_EXACT, 2 * SA_D, 2 * SF_ROWS>(
        q_buf, k_buf, v_buf, desc, ctx_buf, B, L, st);
    if (err != cudaSuccess) return err;
    return launch_gemm_residual_ln(ctx_buf, wo, bo, x, gamma, beta, eps,
                                   pre_buf, out, M, W, st);
  }
  const WoAccArgs p{static_cast<const bf16*>(q_buf),
                    static_cast<const bf16*>(k_buf),
                    static_cast<const bf16*>(v_buf),
                    static_cast<const int*>(desc),
                    static_cast<const bf16*>(x),
                    static_cast<const bf16*>(bo),
                    static_cast<const bf16*>(gamma),
                    static_cast<const bf16*>(beta),
                    static_cast<bf16*>(out), eps, L};
  return layout == LAYOUT_TRANSPOSED ? launch_wo_acc<true>(p, wo, B, st)
                                     : launch_wo_acc<false>(p, wo, B, st);
}

// The probes' own kernels at length L (kernel 0 none, 1 noshift, 2 pad128's
// attention, 3 wo_acc, 4 transposed): registers, local bytes, dynamic
// shared memory and CTAs an SM; out int32[4]
extern "C" int unimm_block_probe_info(int L, int kernel, void* out) {
  int* o = static_cast<int*>(out);
  switch (kernel) {
    case 0:
      return kernel_fit(probe_attn_kernel<SOFT_SCALE, SA_D, SF_ROWS>,
                        2 * SF_ROWS, pa_smem_bytes<SA_D, SF_ROWS>(L), o);
    case 1:
      return kernel_fit(probe_attn_kernel<SOFT_NOSHIFT, SA_D, SF_ROWS>,
                        2 * SF_ROWS, pa_smem_bytes<SA_D, SF_ROWS>(L), o);
    case 2:
      return kernel_fit(
          probe_attn_kernel<SOFT_EXACT, 2 * SA_D, 2 * SF_ROWS>,
          4 * SF_ROWS, pa_smem_bytes<2 * SA_D, 2 * SF_ROWS>(L), o);
    case 3:
      return kernel_fit(wo_acc_wg_kernel<false>, WA_THREADS, (int)WA_SMEM,
                        o);
    case 4:
      return kernel_fit(wo_acc_wg_kernel<true>, WA_THREADS, (int)WA_SMEM, o);
    default:
      return cudaErrorInvalidValue;
  }
}
