// BPD verify attention: k fresh queries against a dense KV cache.
//
// Replaces repro/kernels/block_attention.py: verify_attention_pallas
// (_verify_attn_kernel).  Keys are read from dense rows k/v (B, L, KV, hd).
// The contract and the design are in split_attention.cuh, whose body it
// shares with the tree variant:
//   - bound: bytes, K and V read once (8.4 MB in bf16 at the serve path's
//     B 8, L 256, KV 8, hd 128: 2.5 us at 3.35 TB/s);
//   - too few blocks: the KV axis is split over a thread-block cluster
//     (split_plan(L), up to 8 ranges), partials combined through
//     distributed shared memory in the same launch;
//   - two shared loads per FMA: bf16 products on mma.sync m16n8k16 with
//     ldmatrix operands; fp32 on register tiles fed by float4 loads;
//   - serial softmax: row max and sum reduced across lanes by shuffles;
//   - unoverlapped staging: 16-byte cp.async copies, double buffered,
//     zero-filled past the range.
// ``splits`` is the wrapper's split_plan(L).splits and ``row_tiles`` its
// row_plan(kq * G).tiles (G = heads / kv_heads); the entry re-checks both.
#include "split_attention.cuh"

BPD_EXPORT int verify_attention(const void* q, const void* k, const void* v,
                                const void* q_pos, const void* kv_pos,
                                void* out, int dtype, int B, int kq, int heads,
                                int kv_heads, int hd, int L, int window,
                                int num_meta, int splits, int row_tiles,
                                void* stream) {
  const bpd_split::Args a{q, k, v, static_cast<const int*>(q_pos),
                          static_cast<const int*>(kv_pos), nullptr, nullptr,
                          out, B, kq, heads, kv_heads, L, window, num_meta};
  return bpd_split::run<bpd_split::DenseRows, false>(
      dtype, hd, a, splits, row_tiles, bpd_split::DenseRows{L}, stream);
}
