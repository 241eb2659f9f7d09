// BPD verify attention over a paged KV cache.
//
// Replaces repro/kernels/paged_attention.py: paged_verify_attention_pallas
// (_paged_attn_kernel).  What verify_attention computes (attention.cuh holds
// the shared body, what bounds it and the design), over a shared pool
// kp/vp (num_pages, ps, KV, hd): key j of row b is slot j % ps of page
// tbl[b, j / ps] (tbl (B, P) int32), and kv_pos (B, P * ps) holds its
// logical position (-1 masks it).  The TPU kernel prefetches the table into
// SMEM so each grid step's DMA lands on the right page; here each thread
// reads the table entry of the key it stages, inside the kernel, so no
// dense (B, P * ps) copy of the pool is ever made.  Unmapped entries point
// at trash page 0 and carry pos -1.  The bound is reading each mapped page
// of K and V once (B * P * ps * KV * hd * 2 tensors).
#include "attention.cuh"

BPD_EXPORT int paged_verify_attention(const void* q, const void* kp,
                                      const void* vp, const void* tbl,
                                      const void* q_pos, const void* kv_pos,
                                      void* out, int dtype, int B, int kq,
                                      int heads, int kv_heads, int hd,
                                      int num_pages, int ps, int P, int window,
                                      int num_meta, void* stream) {
  if (num_pages < 1 || ps < 1 || P < 1) return cudaErrorInvalidValue;
  const bpd_attn::Args a{q, kp, vp, static_cast<const int*>(q_pos),
                         static_cast<const int*>(kv_pos), nullptr, nullptr,
                         out, B, kq, heads, kv_heads, P * ps, window,
                         num_meta};
  const bpd_attn::PagedRows rows{static_cast<const int*>(tbl), P, ps,
                                 num_pages};
  return bpd_attn::run<bpd_attn::PagedRows, false>(dtype, hd, a, rows,
                                                   stream);
}
