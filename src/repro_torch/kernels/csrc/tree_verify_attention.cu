// BPD tree-verification attention: the kq nodes of a candidate tree against
// a dense KV cache whose slots [length, length + kq) hold the block's nodes.
//
// Replaces repro/kernels/block_attention.py: tree_verify_attention_pallas
// (_tree_verify_attn_kernel).  What verify_attention computes, on the same
// split-KV body (split_attention.cuh: the contract and the design); in
// addition a slot with kv_node (B, L) >= 0 is visible to query node q only
// if bit kv_node of anc_bits[b, q] (B, kq) is set.  The bits are packed in
// an int32 (at most 32 nodes) and read as uint32, so node 31's bit shifts
// like any other.  q_pos and kv_pos are logical (RoPE) positions: the
// caller sets the block's slots to length + depth[node].
//   - bound: verify_attention's, reading K and V once; the bit test adds a
//     shared-memory read and a shift per score;
//   - too few blocks, shared loads per FMA, serial softmax, unoverlapped
//     staging: as verify_attention.cu (split-KV clusters, mma.sync with
//     ldmatrix, shuffle reductions, double-buffered cp.async).
// On a chain topology the bit test passes exactly the causal keys, so the
// kernel gives verify_attention's output bit for bit.  ``row_tiles`` is the
// wrapper's row_plan(kq * G).tiles: a 32-node tree at G 9 is 288 rows in
// five tiles.
#include "split_attention.cuh"

BPD_EXPORT int tree_verify_attention(const void* q, const void* k,
                                     const void* v, const void* q_pos,
                                     const void* kv_pos, const void* kv_node,
                                     const void* anc_bits, void* out, int dtype,
                                     int B, int kq, int heads, int kv_heads,
                                     int hd, int L, int window, int num_meta,
                                     int splits, int row_tiles, void* stream) {
  if (kq > 32) return cudaErrorInvalidValue;   // anc_bits holds 32 nodes
  const bpd_split::Args a{q, k, v, static_cast<const int*>(q_pos),
                          static_cast<const int*>(kv_pos),
                          static_cast<const int*>(kv_node),
                          static_cast<const int*>(anc_bits),
                          out, B, kq, heads, kv_heads, L, window, num_meta};
  return bpd_split::run<bpd_split::DenseRows, true>(
      dtype, hd, a, splits, row_tiles, bpd_split::DenseRows{L}, stream);
}
