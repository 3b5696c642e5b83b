// The attention backward's launches (seq_attn_bwd.cuh) for their callers,
// text_attention.cu (B6's backward) and attention_block_train.cu (B5's
// attention backward). The kernels live in this translation unit of their
// own and the callers reach them by these C names, so the objects that
// hold the forward kernel (seq_attn_fwd_kernel) hold the same kernels as
// before (tools/sass_digest compares their SASS).

#include "seq_attn_bwd.cuh"

// declared in seq_attn.cuh; drop and split not both
extern "C" int unimm_seq_attn_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, const void* desc,
                                  void* dq, void* dk, void* dv, void* stats,
                                  long in_sb, long in_sh, int in_sl,
                                  long out_sb, long out_sh, int out_sl, int B,
                                  int H, int L, float s_scale, float dq_scale,
                                  float dk_scale, unsigned seed,
                                  unsigned thresh, float inv_keep, int drop,
                                  int split, void* stream) {
  const SeqAttnBwdArgs a{static_cast<const bf16*>(q),
                         static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v),
                         static_cast<const bf16*>(dout),
                         static_cast<const int*>(desc),
                         static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                         static_cast<bf16*>(dv), static_cast<float*>(stats),
                         SeqLayout{in_sb, in_sh, in_sl},
                         SeqLayout{out_sb, out_sh, out_sl}, H, L, s_scale,
                         dq_scale, dk_scale,
                         DropArgs{seed, thresh, inv_keep}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (drop && split) return cudaErrorInvalidValue;
  if (split) return launch_seq_attn_bwd<false, true>(a, B, st);
  if (drop) return launch_seq_attn_bwd<true, false>(a, B, st);
  return launch_seq_attn_bwd<false, false>(a, B, st);
}

// the registers, local bytes, shared memory and CTAs an SM at length L of
// kernel 0 (the dq launch) or 1 (the dk / dv launch) of the instance that
// drop and split select (seq_attn_bwd_info); out: int32[4]
extern "C" int unimm_seq_attn_bwd_info(int L, int kernel, int drop, int split,
                                       void* out) {
  int* o = static_cast<int*>(out);
  if (drop && split) return cudaErrorInvalidValue;
  if (split) return seq_attn_bwd_info<false, true>(kernel, L, o);
  if (drop) return seq_attn_bwd_info<true, false>(kernel, L, o);
  return seq_attn_bwd_info<false, false>(kernel, L, o);
}
