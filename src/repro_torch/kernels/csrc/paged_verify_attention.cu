// BPD verify attention over a paged KV cache.
//
// Replaces repro/kernels/paged_attention.py: paged_verify_attention_pallas
// (_paged_attn_kernel).  What verify_attention computes, over a shared pool
// kp/vp (num_pages, ps, KV, hd): key j of row b is slot j % ps of page
// tbl[b, j / ps] (tbl (B, P) int32), and kv_pos (B, P * ps) holds its
// logical position (-1 masks it).  Unmapped entries point at trash page 0
// and carry pos -1.  The contract, the bound and the design are in
// split_attention.cuh, whose split-KV body it shares with the dense
// kernels as the ``PagedRows`` instantiation:
//   - bound: bytes, each mapped page of K and V read once (4.7 MB in bf16
//     at the paged path's B 8, P 9 x ps 16, KV 8, hd 128; with q and the
//     output 1.72 us at 3.35 TB/s);
//   - the TPU kernel prefetches the table into SMEM so each grid step's DMA
//     lands on the right page; here each block stages its range's entries
//     of the table into shared memory once at entry, so the thread that
//     issues a key's 16-byte cp.async copy never waits on device memory,
//     and no dense (B, P * ps) copy of the pool is made;
//   - the split plan is split_plan(P * ps), a function of L alone (3 ranges
//     of 48 keys at L 144: 192 blocks in clusters of 3), so the kernel
//     equals verify_attention on the gathered view kp[tbl] bit for bit.
// ``splits`` is the wrapper's split_plan(P * ps).splits and ``row_tiles``
// its row_plan(kq * G).tiles; the entry re-checks both.
#include "split_attention.cuh"

BPD_EXPORT int paged_verify_attention(const void* q, const void* kp,
                                      const void* vp, const void* tbl,
                                      const void* q_pos, const void* kv_pos,
                                      void* out, int dtype, int B, int kq,
                                      int heads, int kv_heads, int hd,
                                      int num_pages, int ps, int P, int window,
                                      int num_meta, int splits, int row_tiles,
                                      void* stream) {
  if (num_pages < 1 || ps < 8 || ps % 8 != 0 || P < 1)
    return cudaErrorInvalidValue;
  const bpd_split::Args a{q, kp, vp, static_cast<const int*>(q_pos),
                          static_cast<const int*>(kv_pos), nullptr, nullptr,
                          out, B, kq, heads, kv_heads, P * ps, window,
                          num_meta};
  const bpd_split::PagedRows rows{static_cast<const int*>(tbl), P, ps,
                                  num_pages};
  return bpd_split::run<bpd_split::PagedRows, false>(dtype, hd, a, splits,
                                                     row_tiles, rows, stream);
}
