// Differentiable whole-sequence BERT attention sub-block of the training
// step, with in-kernel attention-probability dropout.
//
// Replaces the TPU kernel unimm_tpu/ops/pallas_attention_v2.py:
// fused_attention_block_train (_train_call_fwd / _train_fwd_kernel and
// _train_call_bwd / _train_bwd_kernel). For x [B, L, 768] bf16 (L % 32 ==
// 0, 32 <= L <= 256), desc [B, 3] int32 and a hidden-dropout scale mask
// mo [B, L, 768] fp32 (or none):
//
// forward  (unimm_attention_block_train_fwd), three launches:
//   1. gemm_nt_kernel   q, k, v = bf16(x W^T + b); q = bf16(fp32(q) / 8)
//   2. seq_attn_kernel  p = softmax_fp32(s + bias(desc)) * Philox mask;
//                       ctx_h = bf16(bf16(p) v_h)          (seq_attn.cuh)
//   3. out_ln_kernel    y = LN((fp32(ctx Wo^T) + bo) * mo + x)
//                       (block_parts.cuh); ctx is kept for the backward
// backward (unimm_attention_block_train_bwd), three launches:
//   1. gemm_nt_kernel   recompute q_s, k, v as in the forward
//   2. seq_attn_bwd_kernel, one CTA per (head, sequence): q_s, k, v and
//      dctx of the head (<= 256 x 64 bf16 each) and the head's dropout
//      bits (one bit per (row, column): 8 KB at L 256, drawn once from the
//      forward's Philox stream, philox.cuh) sit in shared memory. Three
//      phases over 16-row warp tiles, every product on mma.sync with fp32
//      accumulators:
//        a. per query row: m, l of the softmax and D = sum_j dP_ij P_ij
//           (dP = dctx v^T * mask), one online pass over the keys;
//        b. per query row: dS = P (dP - D); dq = bf16(dS k / 8);
//        c. per key row: the same P and dS transposed; dv = bf16(Pd^T
//           dctx), dk = bf16(dS^T q_s) (Pd = P * mask).
//      P, Pd and dS enter the products rounded to bf16 (the plain twin,
//      ops/attention_block_train.py, rounds them at the same points).
//   3. gemm_nt_kernel   dx_qkv = bf16([dq | dk | dv] [Wq; Wk; Wv]), one
//                       GEMM with K = 2304 against the transposed weights
// The LayerNorm / Wo side of the backward and the weight gradients are
// large dense products that the TPU kernel also leaves outside; the
// wrapper runs them in PyTorch.
//
// What bounds it on an H100: the tensor-core rate. Forward 8 M 768^2 + 4 B
// L^2 768 flops; backward 8 M 768^2 (recompute, dx) + 9 x 2 B L^2 768 (the
// scores three times, dP three times, dq, dk, dv) against ~0.2 GB of x,
// dctx, outputs and weights. q, k, v, ctx and [dq | dk | dv] pass through
// device memory between launches; no [L, L] tensor leaves the SM.

#include "block_parts.cuh"
#include "seq_attn.cuh"

namespace {

// y = bf16(acc) with row pitch ld (the dx GEMM)
struct StoreEpi {
  bf16* y;
  int ld;
  __device__ __forceinline__ void operator()(int, long row, int col,
                                             float v0, float v1) const {
    *reinterpret_cast<__nv_bfloat162*>(y + row * ld + col) =
        __floats2bfloat162_rn(v0, v1);
  }
};

constexpr int BW_THREADS = 256, BW_WARPS = BW_THREADS / 32;
constexpr int QKV = 3 * HID;  // row pitch of the [dq | dk | dv] buffer

size_t bw_smem_bytes(int L) {
  const size_t nkp = sa_keys(L);
  return 4 * nkp * SA_LD * 2 + 3 * nkp * 4 + nkp * (nkp / 32) * 4;
}

template <bool DROP>
__global__ void __launch_bounds__(BW_THREADS, 1)
    seq_attn_bwd_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dctx,
                        const int* __restrict__ desc,
                        bf16* __restrict__ dqkv, int L, DropArgs drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int NKP = sa_keys(L), NW = NKP / 32;
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [NKP][SA_LD] each
  bf16* sK = sQ + NKP * SA_LD;
  bf16* sV = sK + NKP * SA_LD;
  bf16* sO = sV + NKP * SA_LD;               // dctx of the head
  float* sM = reinterpret_cast<float*>(sO + NKP * SA_LD);  // row max
  float* sL = sM + NKP;                                    // row exp-sum
  float* sD = sL + NKP;                                    // sum dP P
  uint32_t* sBits = reinterpret_cast<uint32_t*>(sD + NKP); // [NKP][NW]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long base = (long)b * L * HID + (long)h * SA_D;
  stage_tile(sQ, SA_LD, q + base, HID, NKP, SA_D, L, tid, BW_THREADS);
  stage_tile(sK, SA_LD, k + base, HID, NKP, SA_D, L, tid, BW_THREADS);
  stage_tile(sV, SA_LD, v + base, HID, NKP, SA_D, L, tid, BW_THREADS);
  stage_tile(sO, SA_LD, dctx + base, HID, NKP, SA_D, L, tid, BW_THREADS);
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
                                      0u, drop.seed, tag);
        bits |= ((uint32_t)(u.x < drop.thresh) << (4 * g)) |
                ((uint32_t)(u.y < drop.thresh) << (4 * g + 1)) |
                ((uint32_t)(u.z < drop.thresh) << (4 * g + 2)) |
                ((uint32_t)(u.w < drop.thresh) << (4 * g + 3));
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

  const int mode = desc[3 * b], L1 = desc[3 * b + 1], A = desc[3 * b + 2];
  const int gr = lane >> 2, gc = (lane & 3) * 2;
  const int nb_off = ((lane & 7) + ((lane >> 4) << 3)) * SA_LD +
                     ((lane >> 3) & 1) * 8;
  const int tb_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * SA_LD +
                     (lane >> 4) * 8;
  const int nchunks = NKP / SA_KC, ntiles = L / 16;

  auto mval = [&](int row, int col) -> float {
    if (!DROP) return 1.f;
    return ((sBits[row * NW + (col >> 5)] >> (col & 31)) & 1u) ? drop.inv_keep
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
  auto nt = [&](const uint32_t(&a)[4][4], const bf16* s, int c,
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
        mma_bf16(out[2 * jj], a[kd], f[0], f[1]);
        mma_bf16(out[2 * jj + 1], a[kd], f[2], f[3]);
      }
  };
  // acc += bf16(vals) (16 x 64, the chunk's rows as k) . rows 64 c .. of s
  auto nn_acc = [&](const float(&vals)[8][4], const bf16* s, int c,
                    float(&acc)[8][4]) {
    const bf16* bb = s + c * SA_KC * SA_LD + tb_off;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      uint32_t pa[4];
      pa[0] = pack_bf16(vals[2 * t][0], vals[2 * t][1]);
      pa[1] = pack_bf16(vals[2 * t][2], vals[2 * t][3]);
      pa[2] = pack_bf16(vals[2 * t + 1][0], vals[2 * t + 1][1]);
      pa[3] = pack_bf16(vals[2 * t + 1][2], vals[2 * t + 1][3]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, bb + t * 16 * SA_LD + jj * 16);
        mma_bf16(acc[2 * jj], pa, f[0], f[1]);
        mma_bf16(acc[2 * jj + 1], pa, f[2], f[3]);
      }
    }
  };
  // scores of query rows ra / rb against key chunk c: + mask, -inf past L
  auto add_bias = [&](int c, int ra, int rb, float(&sc)[8][4]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int col = c * SA_KC + j * 8 + gc + (t & 1);
        const int row = t < 2 ? ra : rb;
        sc[j][t] = col < L ? sc[j][t] + text_bias(row, col, mode, L1, A, L)
                           : -INFINITY;
      }
  };
  auto store = [&](const float(&o)[8][4], int ra, int col0, float scale) {
    bf16* pa = dqkv + ((long)b * L + ra) * QKV + col0 + h * SA_D;
    bf16* pb = pa + 8 * QKV;
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
    store(dq, ra, 0, 0.125f);  // through the q scale 1 / sqrt(64)
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
                expf(st[j][t] + text_bias(qi, key, mode, L1, A, L) -
                     sM[qi]) / sL[qi];
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
    store(dk, ka, HID, 1.0f);
    store(dv, ka, 2 * HID, 1.0f);
  }
}

cudaError_t launch_qkv(const void* x, const void* wq, const void* bq,
                       const void* wk, const void* bk, const void* wv,
                       const void* bv, void* q_buf, void* k_buf, void* v_buf,
                       int M, cudaStream_t st) {
  GemmArgs g{static_cast<const bf16*>(x),
             {static_cast<const bf16*>(wq), static_cast<const bf16*>(wk),
              static_cast<const bf16*>(wv)},
             M, HID, HID};
  QkvEpi e{{static_cast<const bf16*>(bq), static_cast<const bf16*>(bk),
            static_cast<const bf16*>(bv)},
           {static_cast<bf16*>(q_buf), static_cast<bf16*>(k_buf),
            static_cast<bf16*>(v_buf)},
           {0.125f, 1.0f, 1.0f},  // q scale: 1 / sqrt(head_dim 64)
           HID};
  return launch_gemm_nt(g, 3, e, st);
}

template <bool DROP>
cudaError_t launch_attn_bwd(const void* q, const void* k, const void* v,
                            const void* dctx, const void* desc, void* dqkv,
                            int B, int L, const DropArgs& drop,
                            cudaStream_t st) {
  const size_t smem = bw_smem_bytes(L);
  cudaFuncSetAttribute(seq_attn_bwd_kernel<DROP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(HID / SA_D, B);
  seq_attn_bwd_kernel<DROP><<<grid, BW_THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dctx),
      static_cast<const int*>(desc), static_cast<bf16*>(dqkv), L, drop);
  return cudaGetLastError();
}

}  // namespace

extern "C" int unimm_attention_block_train_fwd(
    const void* x, const void* desc, const void* wq, const void* bq,
    const void* wk, const void* bk, const void* wv, const void* bv,
    const void* wo, const void* bo, const void* gamma, const void* beta,
    const void* mo, void* q_buf, void* k_buf, void* v_buf, void* ctx_buf,
    void* out, int B, int L, float eps, unsigned seed, unsigned thresh,
    float inv_keep, int drop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * L;
  cudaError_t err = launch_qkv(x, wq, bq, wk, bk, wv, bv, q_buf, k_buf,
                               v_buf, M, st);
  if (err != cudaSuccess) return err;
  const DropArgs d{seed, thresh, inv_keep};
  err = drop ? launch_seq_attn<true>(q_buf, k_buf, v_buf, desc, ctx_buf, B,
                                     L, d, st)
             : launch_seq_attn<false>(q_buf, k_buf, v_buf, desc, ctx_buf, B,
                                      L, d, st);
  if (err != cudaSuccess) return err;
  return launch_out_ln(ctx_buf, x, wo, bo, gamma, beta, eps, out, M, HID,
                       st, static_cast<const float*>(mo));
}

extern "C" int unimm_attention_block_train_bwd(
    const void* x, const void* dctx, const void* desc, const void* wq,
    const void* bq, const void* wk, const void* bk, const void* wv,
    const void* bv, const void* w_cat_t, void* q_buf, void* k_buf,
    void* v_buf, void* dqkv, void* dx, int B, int L, unsigned seed,
    unsigned thresh, float inv_keep, int drop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * L;
  cudaError_t err = launch_qkv(x, wq, bq, wk, bk, wv, bv, q_buf, k_buf,
                               v_buf, M, st);
  if (err != cudaSuccess) return err;
  const DropArgs d{seed, thresh, inv_keep};
  err = drop ? launch_attn_bwd<true>(q_buf, k_buf, v_buf, dctx, desc, dqkv,
                                     B, L, d, st)
             : launch_attn_bwd<false>(q_buf, k_buf, v_buf, dctx, desc, dqkv,
                                      B, L, d, st);
  if (err != cudaSuccess) return err;
  // dx = [dq | dk | dv] [Wq; Wk; Wv]: C = A B^T with B = [Wq; Wk; Wv]^T
  GemmArgs g{static_cast<const bf16*>(dqkv),
             {static_cast<const bf16*>(w_cat_t), nullptr, nullptr},
             M, HID, QKV};
  return launch_gemm_nt(g, 1, StoreEpi{static_cast<bf16*>(dx), HID}, st);
}
