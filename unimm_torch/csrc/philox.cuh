// Philox4x32-10 (Salmon et al., SC'11; the Random123 constants): the
// attention-dropout bits of the training attention block
// (attention_block_train.cu), shared by its forward and backward kernels so
// both see one mask. Replaces the TPU hardware PRNG of
// unimm_tpu/ops/pallas_attention_v2.py:_prob_mask, whose bits cannot be
// reproduced off the TPU. The plain twin is unimm_torch/ops/philox.py (the
// same integer arithmetic; the two agree bit for bit).
//
//   key     = (seed, tag = sequence * heads + head)
//   counter = (column / 4, row, 0, 0); word w is the draw of column 4 c + w
//   keep where draw < thresh = uint32(keep * 2^32), scale by 1 / keep
#pragma once

#include <stdint.h>

namespace {

struct DropArgs {
  uint32_t seed;
  uint32_t thresh;   // keep where the draw is below it
  float inv_keep;    // 1 / keep, rounded to fp32 on the host
};

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

}  // namespace
