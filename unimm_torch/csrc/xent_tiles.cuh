// The label heads' shared pieces: K3's (xent_head.cu) tile order and exp,
// which the training cross-entropy (xent_train.cu) runs too. Include it
// after the GEMM core (gemm_wg_core.cuh).
#pragma once

namespace {

constexpr int XW_GROUP = 16;  // row tiles of a tile group
constexpr float XW_LOG2E = 1.4426950408889634f;
constexpr float XW_PAD = -1e30f;

__device__ __forceinline__ float xw_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tile t's row and vocab tile: groups of XW_GROUP row tiles (the last one
// smaller), the row tile fastest inside a group
__device__ __forceinline__ void xw_tile(int t, int ntm, int ntn, int& tm,
                                        int& tn) {
  const int per = XW_GROUP * ntn;
  const int grp = t / per, w = t - grp * per;
  const int rows = min(XW_GROUP, ntm - grp * XW_GROUP);
  tm = grp * XW_GROUP + w % rows;
  tn = w / rows;
}

}  // namespace
