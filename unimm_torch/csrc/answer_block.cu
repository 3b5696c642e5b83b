// Fused answer-rows attention sub-block of the prefix-cache scorer (K1).
//
// Replaces the TPU kernel unimm_tpu/ops/pallas_prefix.py:fused_answer_block
// (body _answer_kernel). For packed answer rows x [G, P, 768] of G slates it
// computes one BERT attention sub-block whose keys are the slate's cached
// context K/V (kc/vc [G, Lcb, 768], projected outside) followed by the rows
// of the same row block (RB rows):
//
//   q, k, v = bf16(x W^T + b);  q = bf16(fp32(q) / 8)
//   s = q_h [k_ctx ; k_rows]_h^T (fp32) + [b_ctx ; b_rr]
//   p = bf16(softmax_fp32(s));  ctx_h = bf16(p [v_ctx ; v_rows]_h)
//   y = LN(fp32(ctx Wo^T) + bo + x) * gamma + beta            (eps 1e-12)
//
// with the TPU kernel's rounding points, in four launches:
//   1. gemm_nt_wg_kernel<QkvEpi>  the row Q/K/V projection on the wgmma +
//      TMA core (gemm_wg.cuh; QkvEpi's per-matrix at(z) rounds q, k, v to
//      bf16 after the bias and q once more after the 1/8 scale, the
//      functor B8's projections use)
//   2. answer_attn_kernel         one pass of attention per (64 query rows,
//      head, slate), below
//   3. gemm_nt_wg_kernel<ResidualEpi> + 4. ln_rows_kernel: the output
//      projection with the bias + residual into fp32, then the row
//      LayerNorm (launch_gemm_residual_ln, as K2 and B8)
// What bounds it on an H100: the tensor-core rate. At G 40, P 1280 the
// four 768-wide products are 242 GFLOP against 0.2-0.25 GB of inputs and
// output (x, the context K/V, the biases, y); the attention adds 4 x 768
// flops per open (row, key) pair. Unlike the TPU kernel, q/k/v, ctx (bf16)
// and the pre-LayerNorm sum (fp32) pass through device memory between the
// launches.
//
// answer_attn_kernel, modelled on seq_attn_fwd.cuh's design points (whose
// helpers it uses; its instances are untouched):
//
// 1. Scores once. A CTA of 4 warps takes 64 query rows of one row block
//    for one (slate, head): a row block of RB rows (a multiple of 16 up to
//    256) is ceil(RB / 64) CTAs. When RB is not a multiple of 64 the
//    launch picks the TAIL instance, whose last CTA a row block is short
//    (its warps past the block's rows take no chunk and store nothing);
//    whole row blocks run the instance without the tail's row count and
//    guards, whose loop the short CTA would slow by a few percent. A warp
//    holds its 16 rows' scores against one 64-key chunk as mma.sync
//    accumulators, takes the chunk's row max, its exps and P.V, and goes
//    on (online softmax). Key chunk c < CC = ceil(Lcb /
//    64) holds context keys [64 c, 64 c + 64) (those past Lcb are padding,
//    at -inf), chunk CC + r the row block's keys [64 r, 64 r + 64) (those
//    past RB are padding, at -inf; the table never calls a chunk with
//    padding keys OPEN). The rounding point of p: key chunk c of a row
//    gives p~ = exp2((s - m_c) log2(e)), m_c the row's running max through
//    chunk c; o sums bf16(p~) v in fp32, rescaled as the max grows, and is
//    divided once by l, the fp32 sum of the unrounded p~, before it rounds
//    to bf16. The twin and the TPU kernel round the normalised p instead;
//    either way each term carries one bf16 rounding of its probability
//    (2^-9 relative), the argument of seq_attn_fwd.cuh, so the card check
//    holds the context to B5_CTX_REL of its largest entry (chip_smoke.py).
// 2. The chunk table. ops/answer_block.answer_chunk_table reads b_ctx and
//    b_rr once per dispatch (the scorer builds it next to the biases, and
//    the 12 layers share it) into a state per (16 query rows, chunk):
//    CLOSED (every bias <= -10000 for every row, each of which has a key
//    above -10000 elsewhere), OPEN (64 real keys, every bias 0) or MIXED.
//    A warp skips its CLOSED chunks (no QK^T, exp or P.V), reads no bias
//    for its OPEN ones, and adds the dense bias only on MIXED ones; a
//    chunk CLOSED for all four warps is not loaded. Skipping is exact: a
//    row with an open key has its max at s + 0 on it, so each masked key
//    weighs exp(s - 10000 - max) = 0 in fp32 (masks.NEG_INF is -10000). A
//    row whose biases close every key takes its softmax over all of them
//    at s - 10000 (the twin's fp32 sums), so it closes no chunk and skips
//    nothing. The scorer's masks are block-diagonal, so at RB 256 most of
//    a row block's key chunks, and the context chunks at or past lc, are
//    closed for every row of a warp.
// 3. exp2 and reciprocals: log2(e) folds into one FFMA per score before
//    ex2.approx; the row sum is inverted once per row (rcp.approx).
// 4. Overlap and occupancy. Shared memory holds the CTA's 64 q rows and a
//    2-stage ring of (K chunk, V chunk) (40 KB; rows of 128 bytes whose
//    16-byte units are XOR-swizzled by row & 7, so ldmatrix is conflict
//    free), staged by cp.async: the next live chunk loads while this one
//    is multiplied. 3 CTAs (12 warps) an SM: at most 168 registers a
//    thread (__launch_bounds__(128, 3); unimm_answer_block_info reports it).
#include "gemm_wg.cuh"
#include "seq_attn_fwd.cuh"

namespace {

constexpr int AA_ROWS = 64, AA_THREADS = 128, AA_KC = 64, AA_MAXC = 8;
constexpr int AA_SMEM = (AA_ROWS + 4 * AA_KC) * SF_ROW_BYTES;
// the chunk states of ops/answer_block.answer_chunk_table
constexpr uint8_t AA_CLOSED = 0, AA_OPEN = 1;

struct AnswerAttnArgs {
  const bf16* q;         // [G, P, 768] bf16(q / 8), bf16 k and v rows
  const bf16* k;
  const bf16* v;
  const bf16* kc;        // [G, Lcb, 768] the cached context's K and V
  const bf16* vc;
  const float* b_ctx;    // [G, Lcb]
  const float* b_rr;     // [G, PB, RB, RB]
  const uint8_t* table;  // [G, PB, RB / 16, NC]
  bf16* ctx;             // [G, P, 768]
  int P, Lcb, RB;
};

template <bool TAIL>  // TAIL: RB is not a multiple of 64
__global__ void __launch_bounds__(AA_THREADS, 3)
    answer_attn_kernel(const AnswerAttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint8_t st[4][AA_MAXC];  // the 4 warps' chunk states
  const uint32_t sQ = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t sK = sQ + AA_ROWS * SF_ROW_BYTES;  // [2][64 rows]
  const uint32_t sV = sK + 2 * AA_KC * SF_ROW_BYTES;
  const int g = blockIdx.z, h = blockIdx.y, PB = a.P / a.RB;
  int row0, pb, rin0, nrows = AA_ROWS;  // nrows: the CTA's rows
  if constexpr (TAIL) {
    const int TPB = (a.RB + AA_ROWS - 1) / AA_ROWS;  // CTAs a row block
    pb = blockIdx.x / TPB;
    rin0 = (blockIdx.x - pb * TPB) * AA_ROWS;
    row0 = pb * a.RB + rin0;
    nrows = min(AA_ROWS, a.RB - rin0);
  } else {
    row0 = blockIdx.x * AA_ROWS;
    pb = row0 / a.RB;
    rin0 = row0 - pb * a.RB;
  }
  const int CC = (a.Lcb + AA_KC - 1) / AA_KC;
  const int NC = CC + (TAIL ? (a.RB + AA_KC - 1) / AA_KC : a.RB / AA_KC);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, gc = (lane & 3) * 2;
  const long hoff = (long)h * SA_D;
  const int x7 = lane & 7;
  const uint32_t q_row = (warp * 16 + (lane & 15)) * SF_ROW_BYTES;
  const uint32_t k_row = (x7 + ((lane >> 4) << 3)) * SF_ROW_BYTES;
  const uint32_t v_row = (x7 + (((lane >> 3) & 1) << 3)) * SF_ROW_BYTES;
  const int q_u = lane >> 4, k_u = (lane >> 3) & 1, v_u = lane >> 4;

  sf_stage(sQ, a.q + ((long)g * a.P + row0) * HID + hoff, HID, AA_ROWS,
           nrows, tid);
  cp_commit();
  // the CTA's 16-row tiles are consecutive rows of the table; a warp past
  // the row block's rows (a short CTA) takes every chunk as CLOSED
  const uint8_t* tab =
      a.table + (((long)g * PB + pb) * (a.RB / 16) + rin0 / 16) * NC;
  if (tid < 4 * NC) {
    if constexpr (TAIL)
      st[tid / NC][tid % NC] = tid / NC < nrows / 16 ? tab[tid] : AA_CLOSED;
    else
      st[tid / NC][tid % NC] = tab[tid];
  }
  __syncthreads();
  unsigned live = 0, mine = 0;  // chunks the CTA loads; this warp takes
  for (int c = 0; c < NC; ++c) {
    if (st[0][c] | st[1][c] | st[2][c] | st[3][c]) live |= 1u << c;
    if (st[warp][c] != AA_CLOSED) mine |= 1u << c;
  }

  // chunk c into ring slot s: keys past Lcb or past RB zero-filled
  auto stage_chunk = [&](int c, int s) {
    const uint32_t dk = sK + s * AA_KC * SF_ROW_BYTES;
    const uint32_t dv = sV + s * AA_KC * SF_ROW_BYTES;
    if (c < CC) {
      const long base = ((long)g * a.Lcb + c * AA_KC) * HID + hoff;
      const int valid = min(AA_KC, a.Lcb - c * AA_KC);
      sf_stage(dk, a.kc + base, HID, AA_KC, valid, tid);
      sf_stage(dv, a.vc + base, HID, AA_KC, valid, tid);
    } else {
      const long base =
          ((long)g * a.P + pb * a.RB + (c - CC) * AA_KC) * HID + hoff;
      // a whole chunk stages with a constant row count (a count known
      // only at run time predicates every copy)
      const int valid = a.RB - (c - CC) * AA_KC;
      if (!TAIL || valid >= AA_KC) {
        sf_stage(dk, a.k + base, HID, AA_KC, AA_KC, tid);
        sf_stage(dv, a.v + base, HID, AA_KC, AA_KC, tid);
      } else {
        sf_stage(dk, a.k + base, HID, AA_KC, valid, tid);
        sf_stage(dv, a.v + base, HID, AA_KC, valid, tid);
      }
    }
  };

  const int ra = rin0 + warp * 16 + gr;  // this thread's rows in the block
  const float* bc = a.b_ctx + (long)g * a.Lcb;
  const float* brr_a = a.b_rr + (((long)g * PB + pb) * a.RB + ra) * a.RB;
  const float* brr_b = brr_a + 8L * a.RB;
  uint32_t qf[SA_D / 16][4];
  float o[8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t) o[j][t] = 0.f;

  unsigned rest = live;
  int c = rest ? __ffs(rest) - 1 : 0;
  if (rest) stage_chunk(c, 0);
  cp_commit();
  for (int i = 0; rest; ++i) {
    rest &= rest - 1;
    const int next = rest ? __ffs(rest) - 1 : -1;
    if (next >= 0) stage_chunk(next, (i + 1) & 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kd = 0; kd < SA_D / 16; ++kd)
        ldsm_x4(qf[kd], sQ + q_row + (((kd * 2 + q_u) ^ x7) << 4));
    }
    if (mine >> c & 1) {
      const uint32_t kb = sK + (i & 1) * AA_KC * SF_ROW_BYTES;
      const uint32_t vb = sV + (i & 1) * AA_KC * SF_ROW_BYTES;
      float sc[8][4];
#pragma unroll
      for (int kd = 0; kd < SA_D / 16; ++kd)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t kf[4];
          ldsm_x4(kf, kb + jj * 16 * SF_ROW_BYTES + k_row +
                          (((kd * 2 + k_u) ^ x7) << 4));
          if (kd == 0) {
            mma_bf16_c0(sc[2 * jj], qf[kd], kf[0], kf[1]);
            mma_bf16_c0(sc[2 * jj + 1], qf[kd], kf[2], kf[3]);
          } else {
            mma_bf16(sc[2 * jj], qf[kd], kf[0], kf[1]);
            mma_bf16(sc[2 * jj + 1], qf[kd], kf[2], kf[3]);
          }
        }
      if (st[warp][c] != AA_OPEN) {  // MIXED: the dense bias
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float2 ba, bb;
          if (c < CC) {
            const int key = c * AA_KC + j * 8 + gc;  // Lcb is even
            ba = key < a.Lcb ? *reinterpret_cast<const float2*>(bc + key)
                             : make_float2(-INFINITY, -INFINITY);
            bb = ba;
          } else if constexpr (TAIL) {  // RB is even
            // a key past RB reads the row's last pair and takes -inf: the
            // loads stay unpredicated (predicated, they cost the attention
            // launch 12% at RB 64 and 17% at RB 256 on an H100)
            const int key = (c - CC) * AA_KC + j * 8 + gc;
            const int kk = min(key, a.RB - 2);
            ba = *reinterpret_cast<const float2*>(brr_a + kk);
            bb = *reinterpret_cast<const float2*>(brr_b + kk);
            if (key >= a.RB) ba = bb = make_float2(-INFINITY, -INFINITY);
          } else {
            const int key = (c - CC) * AA_KC + j * 8 + gc;
            ba = *reinterpret_cast<const float2*>(brr_a + key);
            bb = *reinterpret_cast<const float2*>(brr_b + key);
          }
          sc[j][0] += ba.x;
          sc[j][1] += ba.y;
          sc[j][2] += bb.x;
          sc[j][3] += bb.y;
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
        ms[r] = mn == -INFINITY ? 0.f : mn * SF_LOG2E;
        alpha[r] = ex2(fmaf(m[r], SF_LOG2E, -ms[r]));
        m[r] = mn;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          o[j][t] *= alpha[t >> 1];
          sc[j][t] = ex2(fmaf(sc[j][t], SF_LOG2E, -ms[t >> 1]));
          l[t >> 1] += sc[j][t];
        }
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
          ldsm_x4_t(vf, vb + t * 16 * SF_ROW_BYTES + v_row +
                            (((jj * 2 + v_u) ^ x7) << 4));
          mma_bf16(o[2 * jj], pa, vf[0], vf[1]);
          mma_bf16(o[2 * jj + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // the slot is read out before it is staged again
    c = next;
  }

  // o / l; each head's context rounds to bf16 (a warp left no chunk, which
  // the table never gives, would store 0); a warp past the row block's
  // rows stores nothing
  if (TAIL && warp * 16 >= nrows) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? rcp(l[r]) : 0.f;
  }
  bf16* out_a = a.ctx + ((long)g * a.P + row0 + warp * 16 + gr) * HID + hoff;
  bf16* out_b = out_a + 8L * HID;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(out_a + j * 8 + gc) =
        __floats2bfloat162_rn(o[j][0] * inv[0], o[j][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(out_b + j * 8 + gc) =
        __floats2bfloat162_rn(o[j][2] * inv[1], o[j][3] * inv[1]);
  }
}

template <bool TAIL>
cudaError_t answer_attn_configure() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        answer_attn_kernel<TAIL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        AA_SMEM);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(answer_attn_kernel<TAIL>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  }();
  return err;
}

// the instance for RB: whole row blocks or 16-row tails
template <bool TAIL>
cudaError_t launch_answer_attn(const AnswerAttnArgs& a, int G,
                               cudaStream_t st) {
  const cudaError_t err = answer_attn_configure<TAIL>();
  if (err != cudaSuccess) return err;
  const int ctas = a.P / a.RB * ((a.RB + AA_ROWS - 1) / AA_ROWS);
  answer_attn_kernel<TAIL>
      <<<dim3(ctas, HID / SA_D, G), AA_THREADS, AA_SMEM, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int unimm_answer_block(
    const void* x, const void* kc, const void* vc, const void* b_ctx,
    const void* b_rr, const void* table, const void* wq, const void* bq,
    const void* wk, const void* bk, const void* wv, const void* bv,
    const void* wo, const void* bo, const void* gamma, const void* beta,
    void* q_buf, void* k_buf, void* v_buf, void* ctx_buf, void* pre_buf,
    void* out, int G, int P, int Lcb, int RB, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (RB < 16 || RB % 16 || RB > 4 * AA_KC || P % RB || Lcb < 2 ||
      Lcb % 2 || Lcb > 4 * AA_KC)
    return cudaErrorInvalidValue;
  const int M = G * P;
  const GemmArgs gq{static_cast<const bf16*>(x),
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
  cudaError_t err = launch_gemm_nt_wg(gq, 3, e, st);
  if (err != cudaSuccess) return err;

  const AnswerAttnArgs a{static_cast<const bf16*>(q_buf),
                         static_cast<const bf16*>(k_buf),
                         static_cast<const bf16*>(v_buf),
                         static_cast<const bf16*>(kc),
                         static_cast<const bf16*>(vc),
                         static_cast<const float*>(b_ctx),
                         static_cast<const float*>(b_rr),
                         static_cast<const uint8_t*>(table),
                         static_cast<bf16*>(ctx_buf),
                         P,
                         Lcb,
                         RB};
  err = RB % AA_ROWS ? launch_answer_attn<true>(a, G, st)
                     : launch_answer_attn<false>(a, G, st);
  if (err != cudaSuccess) return err;

  return launch_gemm_residual_ln(ctx_buf, wo, bo, x, gamma, beta, eps,
                                 pre_buf, out, M, HID, st);
}

// out: answer_attn_kernel<tail != 0>'s registers and local memory bytes
// a thread (stack and spills), dynamic shared memory a CTA, CTAs an SM
extern "C" int unimm_answer_block_info(int tail, void* out) {
  const void* fn = tail ? reinterpret_cast<const void*>(
                              answer_attn_kernel<true>)
                        : reinterpret_cast<const void*>(
                              answer_attn_kernel<false>);
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, fn);
  if (e == cudaSuccess)
    e = tail ? answer_attn_configure<true>() : answer_attn_configure<false>();
  int ctas = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, AA_THREADS,
                                                      AA_SMEM);
  int* o = static_cast<int*>(out);
  o[0] = fa.numRegs;
  o[1] = (int)fa.localSizeBytes;
  o[2] = AA_SMEM;
  o[3] = ctas;
  return e;
}
