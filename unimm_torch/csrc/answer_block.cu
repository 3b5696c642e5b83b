// Fused answer-rows attention sub-block of the prefix-cache scorer.
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
// with the TPU kernel's rounding points. Three launches:
//   1. gemm_nt_kernel     row Q/K/V projection (common.cuh), 128x128 tiles
//   2. rows_attn_kernel   one CTA per (query tile, head, slate): scores in
//                         registers, a max/exp-sum pass, then an exact
//                         softmax pass that multiplies by V
//   3. out_ln_kernel      Wo + bo + residual + LayerNorm on 32-row tiles
// What bounds it on an H100: ~7 GFLOP per 1280-row slate against ~5 MB of
// its activations and biases (the 4.7 MB of weights are shared by the
// group), so the tensor-core rate.
// Unlike the TPU kernel, q/k/v and ctx ([G, P, 768] bf16 each) pass through
// device memory between the launches; the [rows, Lcb + RB] scores and
// probabilities never leave registers.

#include "common.cuh"

namespace {

// ---- launch 1: row Q/K/V projection (gemm_nt_kernel, grid z = q/k/v) --
struct QkvEpi {  // y = bf16(acc + b); q additionally bf16(fp32(y) * scale)
  const bf16* b[3];
  bf16* y[3];
  float scale[3];
  __device__ __forceinline__ void operator()(int z, long row, int col,
                                             float v0, float v1) const {
    bf16 o0 = __float2bfloat16(v0 + __bfloat162float(b[z][col]));
    bf16 o1 = __float2bfloat16(v1 + __bfloat162float(b[z][col + 1]));
    if (scale[z] != 1.0f) {
      o0 = __float2bfloat16(__bfloat162float(o0) * scale[z]);
      o1 = __float2bfloat16(__bfloat162float(o1) * scale[z]);
    }
    __nv_bfloat162 o;
    o.x = o0;
    o.y = o1;
    *reinterpret_cast<__nv_bfloat162*>(y[z] + row * HID + col) = o;
  }
};

// ---- launch 2: attention over (cached context ++ row block) keys ---------
// One CTA per (query tile of QT = min(RB, 128) rows, head, slate); each warp
// owns 16 query rows, kept as mma.sync A fragments. Keys and values stream
// through shared memory in 64-key chunks (context keys first, then the row
// block's own keys). Pass 1 runs the running row max and exp-sum over all
// chunks; pass 2 recomputes each score chunk and forms p = exp(s - max) /
// sum exactly as the fp32 softmax does, rounds it to bf16 in registers
// (the accumulator layout of two n8 tiles is the A layout of one k16 step)
// and multiplies by the value chunk. Scores never leave registers.
constexpr int AT_KC = 64, AT_D = 64, AT_LD = AT_D + 8;
constexpr int AT_MAX_QT = 128;

size_t at_smem_bytes(int qt) {
  // Q tile + 2 stages of (K chunk, V chunk)
  return (size_t)(qt + 4 * AT_KC) * AT_LD * 2;
}

__global__ void __launch_bounds__(AT_MAX_QT * 2)
    rows_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kr,
                     const bf16* __restrict__ vr, const bf16* __restrict__ kc,
                     const bf16* __restrict__ vc,
                     const float* __restrict__ b_ctx,
                     const float* __restrict__ b_rr, bf16* __restrict__ ctx,
                     int P, int Lcb, int RB) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int QT = blockDim.x / 2;             // 16 query rows per warp
  const int NK = Lcb + RB;
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [QT][AT_LD]
  bf16* sK = sQ + QT * AT_LD;                // [2][AT_KC][AT_LD]
  bf16* sV = sK + 2 * AT_KC * AT_LD;         // [2][AT_KC][AT_LD]

  const int g = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * QT;
  const int pb = row0 / RB, rblk0 = pb * RB;
  const int PB = P / RB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = blockDim.x;
  const long hoff = (long)h * AT_D;
  const int gr = lane >> 2, gc = (lane & 3) * 2;
  // this thread's two query rows, as indices inside the row block
  const int rin_a = row0 - rblk0 + warp * 16 + gr, rin_b = rin_a + 8;

  stage_tile(sQ, AT_LD, q + ((long)g * P + row0) * HID + hoff, HID, QT, AT_D,
             QT, tid, nthreads);
  cp_commit();

  // chunk c: keys [64 c, 64 c + 64) of (context ++ row block)
  auto stage_kv = [&](bf16* dst, const bf16* cs, const bf16* rs, int c) {
    for (int i = tid; i < AT_KC * 8; i += nthreads) {
      const int r = i >> 3, col = (i & 7) * 8, kk = c * AT_KC + r;
      const bool ok = kk < NK;
      const bf16* src =
          kk < Lcb ? cs + ((long)g * Lcb + kk) * HID + hoff + col
                   : rs + ((long)g * P + rblk0 + (kk - Lcb)) * HID + hoff +
                         col;
      cp16(dst + r * AT_LD + col, ok ? src : cs, ok);
    }
  };
  const int nchunks = (NK + AT_KC - 1) / AT_KC;
  const float* bc = b_ctx + (long)g * Lcb;
  const float* brr_a = b_rr + (((long)g * PB + pb) * RB + rin_a) * RB;
  const float* brr_b = b_rr + (((long)g * PB + pb) * RB + rin_b) * RB;
  // ldmatrix lane offsets: K chunk as B (n = key, k = d); V chunk as B with
  // a transposed load (k = key, n = d)
  const int kb_off = ((lane & 7) + ((lane >> 4) << 3)) * AT_LD +
                     ((lane >> 3) & 1) * 8;
  const int vb_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * AT_LD +
                     (lane >> 4) * 8;

  uint32_t qf[4][4];
  // scores of this warp's 16 rows against chunk c (+ bias; -inf past NK)
  auto scores = [&](const bf16* kbuf, int c, float (&sc)[8][4]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) sc[j][t] = 0.f;
#pragma unroll
    for (int kd = 0; kd < 4; ++kd)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kbuf + kb_off + jj * 16 * AT_LD + kd * 16);
        mma_bf16(sc[2 * jj], qf[kd], kf[0], kf[1]);
        mma_bf16(sc[2 * jj + 1], qf[kd], kf[2], kf[3]);
      }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c * AT_KC + j * 8 + gc;
      if (col >= NK) {
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = -INFINITY;
      } else if (col < Lcb) {
        const float2 b = *reinterpret_cast<const float2*>(bc + col);
        sc[j][0] += b.x;
        sc[j][1] += b.y;
        sc[j][2] += b.x;
        sc[j][3] += b.y;
      } else {
        const float2 ba =
            *reinterpret_cast<const float2*>(brr_a + (col - Lcb));
        const float2 bb =
            *reinterpret_cast<const float2*>(brr_b + (col - Lcb));
        sc[j][0] += ba.x;
        sc[j][1] += ba.y;
        sc[j][2] += bb.x;
        sc[j][3] += bb.y;
      }
    }
  };

  // pass 1: running max and exp-sum of rows gr (index 0) and gr + 8 (1)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  stage_kv(sK, kc, kr, 0);
  cp_commit();
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks)
      stage_kv(sK + ((c + 1) & 1) * AT_KC * AT_LD, kc, kr, c + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (c == 0) {
#pragma unroll
      for (int kd = 0; kd < 4; ++kd)
        ldmatrix_x4(qf[kd], sQ + (warp * 16 + (lane & 15)) * AT_LD +
                                kd * 16 + (lane >> 4) * 8);
    }
    float sc[8][4];
    scores(sK + (c & 1) * AT_KC * AT_LD, c, sc);
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
    __syncthreads();
  }

  // pass 2: p = bf16(exp(s - max) / sum); ctx += p V
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t) o[j][t] = 0.f;
  stage_kv(sK, kc, kr, 0);
  stage_kv(sV, vc, vr, 0);
  cp_commit();
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      stage_kv(sK + ((c + 1) & 1) * AT_KC * AT_LD, kc, kr, c + 1);
      stage_kv(sV + ((c + 1) & 1) * AT_KC * AT_LD, vc, vr, c + 1);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    float sc[8][4];
    scores(sK + (c & 1) * AT_KC * AT_LD, c, sc);
    const bf16* vbuf = sV + (c & 1) * AT_KC * AT_LD;
#pragma unroll
    for (int t = 0; t < 4; ++t) {       // k16 step: keys 16 t .. 16 t + 15
      uint32_t pa[4];
      pa[0] = pack_bf16(expf(sc[2 * t][0] - m[0]) / l[0],
                        expf(sc[2 * t][1] - m[0]) / l[0]);
      pa[1] = pack_bf16(expf(sc[2 * t][2] - m[1]) / l[1],
                        expf(sc[2 * t][3] - m[1]) / l[1]);
      pa[2] = pack_bf16(expf(sc[2 * t + 1][0] - m[0]) / l[0],
                        expf(sc[2 * t + 1][1] - m[0]) / l[0]);
      pa[3] = pack_bf16(expf(sc[2 * t + 1][2] - m[1]) / l[1],
                        expf(sc[2 * t + 1][3] - m[1]) / l[1]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {  // head-dim columns 16 jj ..
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vbuf + vb_off + t * 16 * AT_LD + jj * 16);
        mma_bf16(o[2 * jj], pa, vf[0], vf[1]);
        mma_bf16(o[2 * jj + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();
  }

  // each head's context rounds to bf16
  bf16* out_a = ctx + ((long)g * P + row0 + warp * 16 + gr) * HID + hoff;
  bf16* out_b = out_a + 8 * HID;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    __nv_bfloat162 va = __floats2bfloat162_rn(o[j][0], o[j][1]);
    __nv_bfloat162 vb = __floats2bfloat162_rn(o[j][2], o[j][3]);
    *reinterpret_cast<__nv_bfloat162*>(out_a + j * 8 + gc) = va;
    *reinterpret_cast<__nv_bfloat162*>(out_b + j * 8 + gc) = vb;
  }
}

// ---- launch 3: output projection + residual + LayerNorm ------------------
// One CTA per 32 rows holds all 768 output columns, so the LayerNorm runs in
// the same launch: 8 warps, warp w computes columns [96 w, 96 w + 96) of
// both 16-row halves (24 accumulator tiles), Wo streamed in k slices of 32.
constexpr int OL_ROWS = 32, OL_THREADS = 256, OL_BK = 32, OL_LD = OL_BK + 8;
constexpr int OL_LDC = HID + 4;  // pitch of the fp32 pre-LayerNorm tile

size_t out_ln_smem_bytes() {
  const size_t a = (size_t)2 * OL_ROWS * OL_LD * 2;
  const size_t w = (size_t)2 * HID * OL_LD * 2;
  const size_t c = (size_t)OL_ROWS * OL_LDC * 4;
  return a + (w > c ? w : c);
}

__global__ void __launch_bounds__(OL_THREADS)
    out_ln_kernel(const bf16* __restrict__ ctx, const bf16* __restrict__ x,
                  const bf16* __restrict__ wo, const bf16* __restrict__ bo,
                  const bf16* __restrict__ gamma,
                  const bf16* __restrict__ beta, float eps,
                  bf16* __restrict__ out, int M) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);      // [2][32][OL_LD]
  bf16* sW = sA + 2 * OL_ROWS * OL_LD;           // [2][768][OL_LD]
  float* sC = reinterpret_cast<float*>(sW);      // epilogue, aliases sW
  const long m0 = (long)blockIdx.x * OL_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int valid = rows_left(m0, M, OL_ROWS);

  auto stage = [&](int st, int k0) {
    stage_tile(sA + st * OL_ROWS * OL_LD, OL_LD, ctx + m0 * HID + k0, HID,
               OL_ROWS, OL_BK, valid, tid, OL_THREADS);
    stage_tile(sW + st * HID * OL_LD, OL_LD, wo + k0, HID, HID, OL_BK, HID,
               tid, OL_THREADS);
  };
  float acc[2][12][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;
  const int a_off = (lane & 15) * OL_LD + (lane >> 4) * 8;
  const int b_off = (warp * 96 + (lane & 7) + ((lane >> 4) << 3)) * OL_LD +
                    ((lane >> 3) & 1) * 8;
  constexpr int NK = HID / OL_BK;
  stage(0, 0);
  cp_commit();
  for (int kt = 0; kt < NK; ++kt) {
    if (kt + 1 < NK) stage((kt + 1) & 1, (kt + 1) * OL_BK);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* a = sA + (kt & 1) * OL_ROWS * OL_LD + a_off;
    const bf16* b = sW + (kt & 1) * HID * OL_LD + b_off;
#pragma unroll
    for (int kk = 0; kk < OL_BK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldmatrix_x4(af[i], a + i * 16 * OL_LD + kk);
#pragma unroll
      for (int jj = 0; jj < 6; ++jj) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, b + jj * 16 * OL_LD + kk);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jj], af[i], bfr[0], bfr[1]);
          mma_bf16(acc[i][2 * jj + 1], af[i], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();
  }
  const int gr = lane >> 2, gc = (lane & 3) * 2;
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

  // h = (acc + bo) + x, then LayerNorm
  for (int r = warp * 4; r < warp * 4 + 4 && r < valid; ++r) {
    float h[HID / 32];
#pragma unroll
    for (int j = 0; j < HID / 32; ++j) {
      const int c = lane + 32 * j;
      h[j] = (sC[r * OL_LDC + c] + __bfloat162float(bo[c])) +
             __bfloat162float(x[(m0 + r) * HID + c]);
    }
    ln_row_store(h, gamma, beta, eps, out + (m0 + r) * HID, lane);
  }
}

}  // namespace

extern "C" int unimm_answer_block(
    const void* x, const void* kc, const void* vc, const void* b_ctx,
    const void* b_rr, const void* wq, const void* bq, const void* wk,
    const void* bk, const void* wv, const void* bv, const void* wo,
    const void* bo, const void* gamma, const void* beta, void* q_buf,
    void* k_buf, void* v_buf, void* ctx_buf, void* out, int G, int P,
    int Lcb, int RB, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = G * P;
  GemmArgs g{static_cast<const bf16*>(x),
             {static_cast<const bf16*>(wq), static_cast<const bf16*>(wk),
              static_cast<const bf16*>(wv)},
             M, HID, HID};
  QkvEpi e{{static_cast<const bf16*>(bq), static_cast<const bf16*>(bk),
            static_cast<const bf16*>(bv)},
           {static_cast<bf16*>(q_buf), static_cast<bf16*>(k_buf),
            static_cast<bf16*>(v_buf)},
           {0.125f, 1.0f, 1.0f}};  // q scale: 1 / sqrt(head_dim 64)
  cudaError_t err = launch_gemm_nt(g, 3, e, st);
  if (err != cudaSuccess) return err;

  const int qt = RB < AT_MAX_QT ? RB : AT_MAX_QT;
  const size_t at_smem = at_smem_bytes(qt);
  cudaFuncSetAttribute(rows_attn_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)at_smem);
  dim3 g2(P / qt, HID / AT_D, G);
  rows_attn_kernel<<<g2, qt * 2, at_smem, st>>>(
      static_cast<const bf16*>(q_buf), static_cast<const bf16*>(k_buf),
      static_cast<const bf16*>(v_buf), static_cast<const bf16*>(kc),
      static_cast<const bf16*>(vc), static_cast<const float*>(b_ctx),
      static_cast<const float*>(b_rr), static_cast<bf16*>(ctx_buf), P, Lcb,
      RB);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t ln_smem = out_ln_smem_bytes();
  cudaFuncSetAttribute(out_ln_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)ln_smem);
  out_ln_kernel<<<(M + OL_ROWS - 1) / OL_ROWS, OL_THREADS, ln_smem, st>>>(
      static_cast<const bf16*>(ctx_buf), static_cast<const bf16*>(x),
      static_cast<const bf16*>(wo), static_cast<const bf16*>(bo),
      static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta), eps,
      static_cast<bf16*>(out), M);
  return cudaGetLastError();
}
