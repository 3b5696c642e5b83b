// Fused AdamW update of one parameter tensor.
//
// Replaces the TPU kernel unimm_tpu/ops/pallas_optim.py:adamw_update_leaf
// (_adamw_kernel). One pass reads (g, p, mu, nu) and writes (update, mu',
// nu'), with optax's op order:
//
//   mu' = b1 mu + (1 - b1) g
//   nu' = b2 nu + (1 - b2) (g g)
//   u   = -lr ((mu' / bc1) / (sqrt(nu' / bc2) + eps) + wd p)
//
// bc1 = 1 - b1^t and bc2 = 1 - b2^t arrive from the host and are divided
// by, as optax does. Every operation is an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), so no FMA contraction
// changes a rounding and the kernel equals its plain twin
// (ops/adamw.py:adamw_update_leaf_plain) bit for bit. As the TPU kernel
// donates them, the update is written over g and the moments over mu and
// nu.
//
// What bounds it on an H100: bytes. 4 reads and 3 writes of 4 bytes per
// element (28 n bytes: 656 MB, 0.196 ms at 3.35 TB/s, for the 30522 x 768
// embedding table) against ~12 flops per element. The design: float4
// loads and stores, a grid-stride loop, one launch per tensor (the JAX
// package's per-leaf structure).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct AdamArgs {
  float lr, wd, bc1, bc2, b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ void adamw_one(const AdamArgs& a, float g,
                                          float p, float& mu, float& nu,
                                          float& u) {
  mu = __fadd_rn(__fmul_rn(a.b1, mu), __fmul_rn(a.omb1, g));
  nu = __fadd_rn(__fmul_rn(a.b2, nu), __fmul_rn(a.omb2, __fmul_rn(g, g)));
  const float dir = __fdiv_rn(__fdiv_rn(mu, a.bc1),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, a.bc2)),
                                        a.eps));
  u = __fmul_rn(-a.lr, __fadd_rn(dir, __fmul_rn(a.wd, p)));
}

__global__ void __launch_bounds__(256)
    adamw_kernel(float* __restrict__ g_u, const float* __restrict__ p,
                 float* __restrict__ mu, float* __restrict__ nu, long n,
                 AdamArgs a) {
  const long n4 = n / 4;
  const long stride = (long)gridDim.x * blockDim.x;
  const long i0 = (long)blockIdx.x * blockDim.x + threadIdx.x;
  float4* g4 = reinterpret_cast<float4*>(g_u);
  const float4* p4 = reinterpret_cast<const float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(mu);
  float4* v4 = reinterpret_cast<float4*>(nu);
  for (long i = i0; i < n4; i += stride) {
    const float4 g = g4[i], pp = p4[i];
    float4 m = m4[i], v = v4[i], u;
    adamw_one(a, g.x, pp.x, m.x, v.x, u.x);
    adamw_one(a, g.y, pp.y, m.y, v.y, u.y);
    adamw_one(a, g.z, pp.z, m.z, v.z, u.z);
    adamw_one(a, g.w, pp.w, m.w, v.w, u.w);
    g4[i] = u;
    m4[i] = m;
    v4[i] = v;
  }
  for (long i = 4 * n4 + i0; i < n; i += stride) {
    float m = mu[i], v = nu[i], u;
    adamw_one(a, g_u[i], p[i], m, v, u);
    g_u[i] = u;
    mu[i] = m;
    nu[i] = v;
  }
}

}  // namespace

extern "C" int unimm_adamw(void* g_u, const void* p, void* mu, void* nu,
                           long n, float lr, float wd, float bc1, float bc2,
                           float b1, float omb1, float b2, float omb2,
                           float eps, void* stream) {
  const AdamArgs a{lr, wd, bc1, bc2, b1, omb1, b2, omb2, eps};
  const long n4 = (n + 3) / 4;
  long blocks = (n4 + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride past 16 per SM
  if (blocks < 1) blocks = 1;
  adamw_kernel<<<(unsigned)blocks, 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(g_u), static_cast<const float*>(p),
      static_cast<float*>(mu), static_cast<float*>(nu), n, a);
  return cudaGetLastError();
}
