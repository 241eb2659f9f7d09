// BPD verify attention: k fresh queries against a dense KV cache.
//
// Replaces repro/kernels/block_attention.py: verify_attention_pallas
// (_verify_attn_kernel).  The contract, what bounds it on an H100 and the
// design are in attention.cuh, whose body it shares with the tree and paged
// variants; here keys are read from dense rows k/v (B, L, KV, hd).
#include "attention.cuh"

BPD_EXPORT int verify_attention(const void* q, const void* k, const void* v,
                                const void* q_pos, const void* kv_pos,
                                void* out, int dtype, int B, int kq, int heads,
                                int kv_heads, int hd, int L, int window,
                                int num_meta, void* stream) {
  const bpd_attn::Args a{q, k, v, static_cast<const int*>(q_pos),
                         static_cast<const int*>(kv_pos), nullptr, nullptr,
                         out, B, kq, heads, kv_heads, L, window, num_meta};
  return bpd_attn::run<bpd_attn::DenseRows, false>(
      dtype, hd, a, bpd_attn::DenseRows{L}, stream);
}
