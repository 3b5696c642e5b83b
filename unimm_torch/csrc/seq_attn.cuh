// The attention kernels' common ground: the head layout and the launch
// arguments of the one-pass forward (seq_attn_fwd.cuh: B4, B5's forward,
// B6's forward, B9, and the bench's probes B10 / B11 in block_probe.cu)
// and of the backward (seq_attn_bwd.cuh: B5, B6). A head is a [L, 64]
// bf16 tile read through element strides (SeqLayout: sequence, head, row;
// the 64 columns are contiguous), so one kernel reads a block's
// projections (L 768, 64, 768), a contiguous [B, H, L, 64] tensor (H L 64,
// L 64, 64) and the head-split view of a [B, L, H 64] tensor (L H 64, 64,
// H 64) without a copy. The descriptor text mask is each query row's open
// key interval (seq_attn_fwd.cuh's row_span; ops/masks.row_intervals is
// its CPU twin).
#pragma once

#include "common.cuh"
#include "philox.cuh"

// The attention backward (seq_attn_bwd.cuh), defined in seq_attn_bwd.cu
// and called from text_attention.cu and attention_block_train.cu: q, k, v,
// dout [B, H, L, 64] (the in strides) into dq, dk, dv (the out strides);
// stats [B, H, 2, L] fp32 scratch; drop selects the Philox mask (seed,
// thresh, inv_keep), split the hi + lo operands of P and dS.
extern "C" int unimm_seq_attn_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, const void* desc,
                                  void* dq, void* dk, void* dv, void* stats,
                                  long in_sb, long in_sh, int in_sl,
                                  long out_sb, long out_sh, int out_sl, int B,
                                  int H, int L, float s_scale, float dq_scale,
                                  float dk_scale, unsigned seed,
                                  unsigned thresh, float inv_keep, int drop,
                                  int split, void* stream);

namespace {

constexpr int SA_KC = 64, SA_D = 64;  // key chunk, head width
// q arrives scaled (the block kernels), or the one-pass kernel scales the
// scores (B6) or q (B9)
enum : int { SCALE_NONE = 0, SCALE_SCORES = 1, SCALE_Q = 2 };

// element strides of a [sequences, heads, rows, 64] tensor
struct SeqLayout {
  long sb, sh;
  int sl;
};

// the layout of a block's [B, L, 768] projections, 12 heads of 64
SeqLayout block_layout(int L, int pitch = HID) {
  return SeqLayout{(long)L * pitch, SA_D, pitch};
}

struct SeqAttnArgs {
  const bf16 *q, *k, *v;
  const int* desc;
  bf16* ctx;
  SeqLayout in, out;  // q, k, v; ctx
  int B, H, L, bb;    // bb: sequences per CTA
  float scale;        // SCALE_SCORES / SCALE_Q
  DropArgs drop;      // the one-pass kernel's DROP
};

// key rows staged: L rounded up to the 64-key chunk, the tail zero-filled
__host__ __device__ __forceinline__ int sa_keys(int L) {
  return (L + SA_KC - 1) / SA_KC * SA_KC;
}

}  // namespace
