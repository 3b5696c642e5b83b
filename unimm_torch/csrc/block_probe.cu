// The attention-block bench's probes: B4's function (attention_block.cu)
// on the first design of its attention, the two-pass seq_attn_kernel
// (seq_attn.cuh), with one part of that attention taken out
// (unimm_probe_block) or laid out another way (unimm_layout_probe_block).
// They are attribution tools: each times one piece of the first design's
// cost on this card; B4 itself now runs the one-pass seq_attn_fwd.cuh, so
// PROBE_FULL against B4 is the two designs side by side.
//
// Replaces the TPU kernels scripts/bench_attn_block.py:_mk_probe (body
// _probe_kernel) and :_mk_layout_probe (bodies _probe_transposed_kernel,
// _probe_wo_acc_kernel, _probe_pad128_kernel). For x [B, L, 768] (L % 32
// == 0, 32 <= L <= 256) and desc [B, 3] int32, with the first design's
// rounding points (the twins'):
//
//   q, k, v = bf16(x W^T + b);  q = bf16(fp32(q) / 8)
//   s = q_h k_h^T (fp32) + bias(desc, i, j)        (0 or -10000)
//   y = LN(out + bo + x) * gamma + beta                          (eps 1e-12)
//
// unimm_probe_block, by mode (three launches, as B4; skip two):
//   PROBE_FULL     p = bf16(softmax_fp32(s)), ctx_h = bf16(p v_h): B4's
//                  function on the first design
//   PROBE_NONE     p = bf16(s * 1e-4): one score pass, no exp, no row
//                  statistic
//   PROBE_NOSHIFT  p = bf16(exp(s - 20) / sum exp(s - 20)): no row max; a
//                  row whose keys are all masked gives NaN, as on the TPU
//   PROBE_SKIP     ctx = v: no attention launch (q and k are still
//                  projected), so it times B4 without its attention
//   out = fp32(ctx Wo^T)
// The attention launch is seq_attn_kernel<SOFT> (seq_attn.cuh), so a mode
// differs from the first design only in its softmax.
//
// unimm_layout_probe_block, by layout (B4's function, full softmax):
//   LAYOUT_WO_ACC      out = sum_h fp32(ctx_h Wo_h^T), head by head in
//                      fp32: no [B, L, 768] context in device memory
//                      (two launches: projection, wo_acc_kernel)
//   LAYOUT_TRANSPOSED  the projection stores q, k, v feature-major,
//                      [B, 768, L] (a transposed GEMM epilogue); the
//                      attention reads K-major head tiles [64, L]
//                      (ldmatrix .trans where the row-major read has none,
//                      and none where it has one); then as wo_acc
//   LAYOUT_PAD128      weights zero-padded per head to 128 columns
//                      (ops/block_probe.pad_heads_128): projections of
//                      width 1536, seq_attn_kernel at heads of 128, out_ln
//                      over K 1536; scale still 1 / sqrt(64)
//
// wo_acc_kernel<KMAJOR>: one CTA per (32 query rows, sequence), 8 warps,
// walks the 12 heads. Per head it stages Q, K, V and Wo's 64-column slice
// (Wo_h [768, 64], 108 KB) in shared memory; warp w takes rows 16 (w & 1)
// and key chunk w >> 1 (keys 64 (w >> 1) ..): pass 1 the chunk's row max
// and exp-sum, exchanged through shared memory into the row's max and
// sum; pass 2 the chunk's scores again (two score passes, as
// seq_attn_kernel), p = bf16(exp(s - max) / sum), p V over the chunk. Each
// step over a chunk is seq_attn.cuh's, as in seq_attn_kernel (qk_chunk,
// mask_chunk, chunk_stats, chunk_probs, pv_chunk); only the warp split and
// the tile reads are the kernel's own. The
// four chunks' fp32 partial contexts add in chunk order into ctx_h, rounded
// to bf16, which all 8 warps multiply by Wo_h^T into a [32, 768] fp32
// accumulator held in registers (warp w: columns 96 w ..., as out_ln).
// After the 12 heads the same CTA adds bias and residual and normalises.
// No cross-CTA reduction, so the result is deterministic; only fp32
// summation order differs from the plain twin.
//
// What bounds them on an H100: the tensor-core rate, as B4: 8 M 768^2 + 4
// B L^2 768 flops (0.72 TFLOP at [512, 256, 768]; pad128 twice B4's)
// against 0.4 GB of x and y. skip's function needs only the V and Wo
// products, 4 M 768^2 (0.31 TFLOP); its kernel also projects q and k
// (0.62 TFLOP as run).
#include "block_parts.cuh"
#include "seq_attn.cuh"

namespace {

enum : int { PROBE_FULL = 0, PROBE_NONE = 1, PROBE_NOSHIFT = 2,
             PROBE_SKIP = 3 };
enum : int { LAYOUT_WO_ACC = 0, LAYOUT_TRANSPOSED = 1, LAYOUT_PAD128 = 2 };

// The projection epilogue of LAYOUT_TRANSPOSED: QkvEpi's values (its ld
// unused), stored feature-major: row b L + l, column c of y[z] goes to
// y[z][(b 768 + c) L + l].
struct QkvEpiT {
  QkvEpi e;
  int L;
  __device__ __forceinline__ void operator()(int z, long row, int col,
                                             float v0, float v1) const {
    const __nv_bfloat162 o = e.value(z, col, v0, v1);
    const long seq = row / L, l = row - seq * L;
    bf16* dst = e.y[z] + (seq * HID + col) * L + l;
    dst[0] = o.x;
    dst[L] = o.y;
  }
};

// Stage a [rows, cols] bf16 tile whose columns >= valid_cols are
// zero-filled (valid_cols % 8 == 0): the K-major key tiles past L.
__device__ __forceinline__ void stage_cols(bf16* s, int ld_s, const bf16* g,
                                           long ld_g, int rows, int cols,
                                           int valid_cols, int tid,
                                           int nthreads) {
  const int vpr = cols / 8;
  for (int i = tid; i < rows * vpr; i += nthreads) {
    const int r = i / vpr, c = (i - r * vpr) * 8;
    const bool ok = c < valid_cols;
    cp16(s + r * ld_s + c, ok ? g + (long)r * ld_g + c : g, ok);
  }
}

constexpr int WA_ROWS = 32, WA_THREADS = 256, WA_OLD = SA_D + 4;
constexpr size_t WA_FIXED = (size_t)HID * SA_LD * 2      // sW
                            + (size_t)WA_ROWS * SA_LD * 2  // sCtx
                            + 4 * WA_ROWS * 2 * 4;         // sStat

// q tile and K / V tiles: [32][72] and [NKP][72] row-major, [64][40] and
// [64][NKP + 8] K-major
__host__ __device__ __forceinline__ int wa_qsz(bool kmajor) {
  return kmajor ? SA_D * (WA_ROWS + 8) : WA_ROWS * SA_LD;
}
__host__ __device__ __forceinline__ int wa_ksz(int nkp, bool kmajor) {
  return kmajor ? SA_D * (nkp + 8) : nkp * SA_LD;
}

size_t wa_smem_bytes(int L, bool kmajor) {
  const size_t tiles =
      WA_FIXED + (size_t)(wa_qsz(kmajor) + 2 * wa_ksz(sa_keys(L), kmajor)) * 2;
  const size_t epi = (size_t)WA_ROWS * OL_LDC * 4;
  return tiles > epi ? tiles : epi;
}

template <bool KMAJOR>
__global__ void __launch_bounds__(WA_THREADS, 1)
    wo_acc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ desc,
                  const bf16* __restrict__ x, const bf16* __restrict__ wo,
                  const bf16* __restrict__ bo,
                  const bf16* __restrict__ gamma,
                  const bf16* __restrict__ beta, float eps,
                  bf16* __restrict__ out, int L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int NKP = sa_keys(L), nchunks = NKP / SA_KC;
  constexpr int QLD = KMAJOR ? WA_ROWS + 8 : SA_LD;
  const int KLD = KMAJOR ? NKP + 8 : SA_LD;
  bf16* sW = reinterpret_cast<bf16*>(smem);               // [768][72]
  bf16* sCtx = sW + HID * SA_LD;                          // [32][72]
  float* sStat = reinterpret_cast<float*>(sCtx + WA_ROWS * SA_LD);
  bf16* sQ = reinterpret_cast<bf16*>(sStat + 4 * WA_ROWS * 2);
  bf16* sK = sQ + wa_qsz(KMAJOR);
  bf16* sV = sK + wa_ksz(NKP, KMAJOR);
  float* sO = reinterpret_cast<float*>(sK);  // [chunk][32][68], after PV
  float* sC = reinterpret_cast<float*>(smem);  // [32][OL_LDC], epilogue

  const int b = blockIdx.y, row0 = blockIdx.x * WA_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, gc = (lane & 3) * 2;
  const int rh = warp & 1, kq = warp >> 1;      // row half, key chunk
  const bool active = kq < nchunks;
  const int ra = row0 + rh * 16 + gr, rb = ra + 8;
  const int mode = desc[3 * b], L1 = desc[3 * b + 1], A = desc[3 * b + 2];

  float acc[2][12][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;

  // scores of rows ra / rb against key chunk c (+ mask; -inf past L)
  const RowMask rm{ra, rb, gc, mode, L1, A, L};
  auto scores = [&](const uint32_t(&qf)[4][4], int c, float(&sc)[8][4]) {
    qk_chunk(qf, [&](int kd, int jj, uint32_t(&kf)[4]) {
      if constexpr (KMAJOR)
        ldmatrix_x4_trans(
            kf, sK + (kd * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * KLD +
                    c * SA_KC + jj * 16 + (lane >> 4) * 8);
      else
        ldmatrix_x4(kf, sK + (c * SA_KC + jj * 16 + (lane & 7) +
                              ((lane >> 4) << 3)) * SA_LD +
                              kd * 16 + ((lane >> 3) & 1) * 8);
    }, sc);
    mask_chunk(sc, c, rm, -INFINITY);
  };

  for (int h = 0; h < HID / SA_D; ++h) {
    __syncthreads();  // the previous head's tiles are read out
    if (KMAJOR) {     // head h: rows 64 h .. of the sequence's [768, L]
      const long base = ((long)b * HID + h * SA_D) * L;
      stage_cols(sQ, QLD, q + base + row0, L, SA_D, WA_ROWS, WA_ROWS, tid,
                 WA_THREADS);
      stage_cols(sK, KLD, k + base, L, SA_D, NKP, L, tid, WA_THREADS);
      stage_cols(sV, KLD, v + base, L, SA_D, NKP, L, tid, WA_THREADS);
    } else {
      const long base = (long)b * L * HID + h * SA_D;
      stage_tile(sQ, QLD, q + base + (long)row0 * HID, HID, WA_ROWS, SA_D,
                 WA_ROWS, tid, WA_THREADS);
      stage_tile(sK, KLD, k + base, HID, NKP, SA_D, L, tid, WA_THREADS);
      stage_tile(sV, KLD, v + base, HID, NKP, SA_D, L, tid, WA_THREADS);
    }
    cp_commit();
    stage_tile(sW, SA_LD, wo + h * SA_D, HID, HID, SA_D, HID, tid,
               WA_THREADS);
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    uint32_t qf[4][4];
#pragma unroll
    for (int kd = 0; kd < 4; ++kd) {
      if (KMAJOR)
        ldmatrix_x4_trans(
            qf[kd], sQ + (kd * 16 + (lane & 7) + ((lane >> 4) << 3)) * QLD +
                        rh * 16 + ((lane >> 3) & 1) * 8);
      else
        ldmatrix_x4(qf[kd], sQ + (rh * 16 + (lane & 15)) * QLD + kd * 16 +
                                (lane >> 4) * 8);
    }

    // pass 1: the chunk's row max and exp-sum, then the row's
    if (active) {
      float sc[8][4];
      scores(qf, kq, sc);
      float cm[2] = {-INFINITY, -INFINITY}, ce[2] = {0.f, 0.f};
      chunk_stats<SOFT_EXACT>(sc, cm, ce);
      if ((lane & 3) == 0)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float* st = sStat + (kq * WA_ROWS + rh * 16 + gr + 8 * r) * 2;
          st[0] = cm[r];
          st[1] = ce[r];
        }
    }
    __syncthreads();
    float m[2], l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rh * 16 + gr + 8 * r;
      m[r] = -INFINITY;
      for (int i = 0; i < nchunks; ++i)
        m[r] = fmaxf(m[r], sStat[(i * WA_ROWS + row) * 2]);
      l[r] = 0.f;
      for (int i = 0; i < nchunks; ++i) {
        const float* st = sStat + (i * WA_ROWS + row) * 2;
        l[r] += st[1] * expf(st[0] - m[r]);
      }
    }

    // pass 2: p = bf16(exp(s - max) / sum); the chunk's p V
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) o[j][t] = 0.f;
    if (active) {
      float sc[8][4];
      scores(qf, kq, sc);
      chunk_probs<SOFT_EXACT>(sc, m, l);
      pv_chunk<4>(sc, [&](int t, int jj, uint32_t(&vf)[4]) {
        const int key0 = kq * SA_KC + t * 16;  // keys 64 kq + 16 t ..
        if constexpr (KMAJOR)
          ldmatrix_x4(vf, sV + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                   KLD +
                               key0 + ((lane >> 3) & 1) * 8);
        else
          ldmatrix_x4_trans(vf, sV + (key0 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * SA_LD +
                                    jj * 16 + (lane >> 4) * 8);
      }, o);
    }
    __syncthreads();  // K and V are read out: the partials overwrite them
    if (active) {
      float* pa = sO + (kq * WA_ROWS + rh * 16 + gr) * WA_OLD;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(pa + j * 8 + gc) =
            make_float2(o[j][0], o[j][1]);
        *reinterpret_cast<float2*>(pa + 8 * WA_OLD + j * 8 + gc) =
            make_float2(o[j][2], o[j][3]);
      }
    }
    __syncthreads();
    // ctx_h = bf16(the chunks' partials, added in chunk order)
    for (int i = tid; i < WA_ROWS * SA_D; i += WA_THREADS) {
      const int r = i / SA_D, c = i - r * SA_D;
      float s = sO[r * WA_OLD + c];
      for (int ch = 1; ch < nchunks; ++ch)
        s += sO[(ch * WA_ROWS + r) * WA_OLD + c];
      sCtx[r * SA_LD + c] = __float2bfloat16(s);
    }
    cp_wait<0>();
    __syncthreads();  // ctx_h and Wo_h are in shared memory

    // acc += ctx_h Wo_h^T; warp w: output columns 96 w .. 96 w + 95
    const bf16* a = sCtx + (lane & 15) * SA_LD + (lane >> 4) * 8;
    const bf16* bw = sW + (warp * 96 + (lane & 7) + ((lane >> 4) << 3)) *
                              SA_LD + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < SA_D; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldmatrix_x4(af[i], a + i * 16 * SA_LD + kk);
#pragma unroll
      for (int jj = 0; jj < 6; ++jj) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, bw + jj * 16 * SA_LD + kk);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jj], af[i], bfr[0], bfr[1]);
          mma_bf16(acc[i][2 * jj + 1], af[i], bfr[2], bfr[3]);
        }
      }
    }
  }

  // h = (acc + bo) + x, then LayerNorm, as out_ln
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(
            sC + (i * 16 + gr + hh * 8) * OL_LDC + warp * 96 + j * 8 + gc) =
            make_float2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
  __syncthreads();
  const long m0 = (long)b * L + row0;
  for (int r = warp * 4; r < warp * 4 + 4; ++r) {
    float hv[HID / 32];
#pragma unroll
    for (int j = 0; j < HID / 32; ++j) {
      const int c = lane + 32 * j;
      hv[j] = (sC[r * OL_LDC + c] + __bfloat162float(bo[c])) +
              __bfloat162float(x[(m0 + r) * HID + c]);
    }
    ln_row_store(hv, gamma, beta, eps, out + (m0 + r) * HID, lane);
  }
}

template <bool KMAJOR>
cudaError_t launch_wo_acc(const void* q, const void* k, const void* v,
                          const void* desc, const void* x, const void* wo,
                          const void* bo, const void* gamma,
                          const void* beta, float eps, void* out, int B,
                          int L, cudaStream_t st) {
  const size_t smem = wa_smem_bytes(L, KMAJOR);
  cudaFuncSetAttribute(wo_acc_kernel<KMAJOR>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  wo_acc_kernel<KMAJOR><<<dim3(L / WA_ROWS, B), WA_THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(desc),
      static_cast<const bf16*>(x), static_cast<const bf16*>(wo),
      static_cast<const bf16*>(bo), static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), eps, static_cast<bf16*>(out), L);
  return cudaGetLastError();
}

}  // namespace

extern "C" int unimm_probe_block(
    const void* x, const void* desc, const void* wq, const void* bq,
    const void* wk, const void* bk, const void* wv, const void* bv,
    const void* wo, const void* bo, const void* gamma, const void* beta,
    void* q_buf, void* k_buf, void* v_buf, void* ctx_buf, void* out, int B,
    int L, int mode, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
  cudaError_t err = launch_gemm_nt(g, 3, e, st);
  if (err != cudaSuccess) return err;
  switch (mode) {
    case PROBE_FULL:
      err = launch_seq_attn<SOFT_EXACT>(q_buf, k_buf, v_buf, desc, ctx_buf,
                                        B, L, st);
      break;
    case PROBE_NONE:
      err = launch_seq_attn<SOFT_SCALE>(q_buf, k_buf, v_buf, desc, ctx_buf,
                                        B, L, st);
      break;
    case PROBE_NOSHIFT:
      err = launch_seq_attn<SOFT_NOSHIFT>(q_buf, k_buf, v_buf, desc,
                                          ctx_buf, B, L, st);
      break;
    case PROBE_SKIP:
      ctx_buf = v_buf;
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return launch_out_ln(ctx_buf, x, wo, bo, gamma, beta, eps, out, M, HID,
                       st);
}

extern "C" int unimm_layout_probe_block(
    const void* x, const void* desc, const void* wq, const void* bq,
    const void* wk, const void* bk, const void* wv, const void* bv,
    const void* wo, const void* bo, const void* gamma, const void* beta,
    void* q_buf, void* k_buf, void* v_buf, void* ctx_buf, void* out, int B,
    int L, int layout, float eps, void* stream) {
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
  const bf16* bias[3] = {static_cast<const bf16*>(bq),
                         static_cast<const bf16*>(bk),
                         static_cast<const bf16*>(bv)};
  bf16* bufs[3] = {static_cast<bf16*>(q_buf), static_cast<bf16*>(k_buf),
                   static_cast<bf16*>(v_buf)};
  const QkvEpi e{{bias[0], bias[1], bias[2]},
                 {bufs[0], bufs[1], bufs[2]},
                 {0.125f, 1.0f, 1.0f},  // q scale: 1 / sqrt(head_dim 64)
                 W};
  cudaError_t err = layout == LAYOUT_TRANSPOSED
                        ? launch_gemm_nt(g, 3, QkvEpiT{e, L}, st)
                        : launch_gemm_nt(g, 3, e, st);
  if (err != cudaSuccess) return err;
  if (layout == LAYOUT_PAD128) {
    // 12 heads of 128 columns in rows of 1536
    const SeqLayout lay{(long)L * W, 2 * SA_D, W};
    const SeqAttnArgs a{bufs[0], bufs[1], bufs[2],
                        static_cast<const int*>(desc),
                        static_cast<bf16*>(ctx_buf),
                        lay, lay, B, HID / SA_D, L, 1, 1.0f,
                        DropArgs{0u, 0u, 1.0f}};
    err = launch_seq_attn_heads<SOFT_EXACT, 2 * SA_D>(a, st);
    if (err != cudaSuccess) return err;
    return launch_out_ln(ctx_buf, x, wo, bo, gamma, beta, eps, out, M, W,
                         st);
  }
  if (layout == LAYOUT_TRANSPOSED)
    return launch_wo_acc<true>(q_buf, k_buf, v_buf, desc, x, wo, bo, gamma,
                               beta, eps, out, B, L, st);
  return launch_wo_acc<false>(q_buf, k_buf, v_buf, desc, x, wo, bo, gamma,
                              beta, eps, out, B, L, st);
}
