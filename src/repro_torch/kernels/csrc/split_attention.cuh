// The split-KV body of the BPD verify-attention kernels on Hopper: k fresh
// queries against a KV cache, with an fp32 online softmax.  It is the one
// attention body of the port; its three instantiations differ in where key
// j of row b lives (``Rows``) and in the tree's bit test (``kTree``):
//
//   verify_attention.cu        DenseRows: rows k/v (B, L, KV, hd)
//   tree_verify_attention.cu   DenseRows, plus the tree's ancestor bit test
//   paged_verify_attention.cu  PagedRows: a page pool kp/vp (num_pages, ps,
//                              KV, hd) through a block table tbl (B, P)
//
// Contract (repro/kernels/block_attention.py): q (B, kq, H, hd) in f32 or
// bf16, q_pos (B, kq) and kv_pos (B, L) int32; head h = kv * G + g; a key is
// visible when kv_pos >= 0, kv_pos <= q_pos and, with a window, q_pos -
// kv_pos < window or kv_pos < num_meta.  The tree variant also needs, for a
// key whose kv_node >= 0, bit kv_node of the query's packed anc_bits (a
// uint32 shift: bit 31 is a node like any other).  Masked scores are the
// finite -1e30 (a row with no visible key averages V over the L keys, no
// NaN); the output is in q's dtype.
//
// What bounds it on an H100: reading K and V once, B * L * KV * hd * 2
// tensors (8.4 MB in bf16 at B = 8, L = 256, KV = 8, hd = 128: 2.5 us at
// 3.35 TB/s).  Its tensor work, 4 * B * kq * H * L * hd = 268 MFLOP there,
// is 0.27 us at 989 TFLOP/s, a tenth of the byte bound.
//
// Design, against the four things that held the one-block-per-(row, head)
// body back:
//
// 1. Too few blocks.  The KV axis is cut into ``splits`` contiguous ranges
//    (split_plan: one per 64 keys of L, rounded up, at most 8, a multiple
//    of 16 keys per range), one block per (batch row, KV head, range): 256
//    blocks at the path's shape instead of 64.  The blocks of one (row,
//    head) form a thread-block cluster.  Each keeps its rows' unnormalised
//    (m, l, acc) in its own shared memory; after cluster.sync() every block
//    combines a share of the (rows, hd) outputs by reading all partials
//    through distributed shared memory (map_shared_rank), in rank order,
//    and writes them; a second cluster.sync() keeps every block's partials
//    alive until the others have read them.  One launch per call, no
//    second pass.  A range whose keys are all masked carries m = -1e30 and
//    weighs exp(-1e30 - M) = 0 unless every range is masked, and then all
//    weigh 1: the mean of V over the L keys, as the plain version.  Tiles
//    are 32 keys and three blocks fit an SM (at most 168 registers a
//    thread, 35 KB of shared memory at hd 128 in bf16), so the path's 64
//    clusters of four run in one wave.
//
//    A block holds at most 64 query rows.  A (row, head) with more, R =
//    kq * G > 64 (starcoder2-7b's 36 heads over 4 KV heads: G 9, 72 rows
//    at block_k 8, 288 under a 32-node tree), is cut into row tiles
//    (row_plan: ceil(R / 64) tiles of a multiple of 16 rows, the last one
//    shorter; 72 rows are 48 + 24, not 64 + 8), and the grid gains a tile
//    axis, blockIdx.y: (B * KV * splits, tiles) blocks, a cluster still
//    spanning the splits of one (row, head, tile).  Each tile reads the range's K and V
//    again (from L2 after the first), one launch per call as before.
// 2. Two shared-memory loads per FMA.  bf16: Q.K^T and P.V run on the
//    tensor cores, mma.sync m16n8k16 with fp32 accumulation, K and V read
//    with ldmatrix (V transposed on the way), one warp per 16 query rows
//    (the FlashAttention-2 layout).  The score fragment stays in registers,
//    masks are selects on the fp32 scores (in base 2: log2(e) is folded
//    into the scale), and P becomes the bf16 A-fragment of P.V in
//    registers.  The row tiles rotate over the warps with the block index,
//    so the busy warps of an SM's blocks spread over its four
//    sub-partitions when kq * G <= 32 leaves some warps without rows.
//    wgmma is not used: it needs 64-row tiles and the kernel has at most
//    kq * G = 64 rows, split over warps, and its products are a tenth of
//    the byte bound, so they are not what holds it back.  fp32 (no TF32:
//    the fp32 decode gates hold the card to the reference at 2e-5):
//    CUDA-core FMAs, each thread a register tile of 4 rows x 4 keys
//    (scores) and 4 rows x hd / 8 columns (outputs), fed by float4
//    shared-memory loads (a float2 for the output columns at hd 16), about
//    ten FMAs a load.
// 3. Serial softmax.  Each row's max and sum are reduced across the threads
//    that hold it with __shfl_xor_sync (4 in a quad for bf16, 8 lanes for
//    fp32); there are two block barriers per tile, both around the copy.
//    The range's sum l stays a per-thread partial until the range ends.
// 4. Staging with no overlap.  K/V tiles move with 16-byte cp.async.cg
//    copies, a row's threads on consecutive 16 bytes, into rows padded by
//    16 bytes (ldmatrix and float4 reads without bank conflicts), double
//    buffered: tile t + 1 is in flight while tile t is used.  The tile's
//    positions (and tree nodes) come by 4-byte cp.async in the same group,
//    so staging never waits on a load.  Keys past the range or past L are
//    zero-filled by the copy (src-size 0), never read.
//
// A query's result does not depend on kq or B: the split plan depends on L
// alone, the tile loop is the same for every row, and each row's sums run
// in the same order wherever the row sits in its block and whichever row
// tile holds it (BPD at kq = k and greedy at kq = 1 agree bit for bit, at
// 72 or 288 rows as at 8).  Addressing never enters the
// arithmetic, so the paged kernel equals the dense one on the gathered view
// kp[tbl] bit for bit.
//
// Head dims 16, 24, 32, 64, 128 and 160.  At 16 (the trained policy-sweep model) a
// bf16 row is one k16 step of Q.K^T and two n8 output tiles, a staged row
// two 16-byte copies (four in fp32), and each fp32 thread holds two output
// columns of its rows instead of four.  24 (the quickstart model, d 96 over
// four heads) is computed at the width 32, as the reference pads head_dim
// to its lane width: a row of HD elements in device memory is staged as HD
// columns and zero-filled to the compute width HDC (the copies of lanes
// 24-31 are cp.async with src-size 0), Q's fragments read zero there, so
// the padded lanes add nothing to Q.K^T and make zero output columns, which
// the combine never writes.  The softmax scale stays 1/sqrt(HD).  Every
// other head_dim is its own compute width, and its code is unchanged.  160
// (stablelm-12b) is ten k16 steps and twenty n8 output tiles: a bf16 warp
// holds 40 registers of Q fragments and 80 of accumulators, more than the
// 168 that three blocks an SM leave a thread, so HD 160 runs two blocks an
// SM (min_blocks: up to 255 registers).  Its bf16 block takes 43 KB of
// shared memory; in fp32 32-key tiles would take 135 KB, one block an SM,
// so fp32 at 160 stages tiles of 16 keys (88 KB, two blocks).  The
// reference pads 160 to 256 lanes; the padded lanes would only add zeros.
#pragma once

#include "common.cuh"

#include <cooperative_groups.h>

#include <atomic>
#include <cmath>
#include <cstdint>

namespace bpd_split {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;        // 4 warps
constexpr int kMaxRows = 64;         // query rows per block (one row tile)
constexpr int kRowAlign = 16;        // rows per tile: a multiple of one mma
constexpr int kMaxSplits = 8;        // the portable cluster size
constexpr int kMinSplitKeys = 64;
constexpr int kSplitAlign = 16;
constexpr float kMasked = -1e30f;

// The split plan, a function of L alone (the Python wrapper's
// block_attention.split_plan is its twin): splits ranges of ``keys`` keys,
// the last one ragged, none empty.
struct Plan {
  int splits, keys;
};
__host__ __device__ inline Plan split_plan(int L) {
  int s = (L + kMinSplitKeys - 1) / kMinSplitKeys;
  s = s < kMaxSplits ? s : kMaxSplits;
  const int per = (L + s - 1) / s;
  const int keys = (per + kSplitAlign - 1) / kSplitAlign * kSplitAlign;
  return Plan{(L + keys - 1) / keys, keys};
}

// The row plan, a function of R = kq * G alone (block_attention.row_plan
// is its twin): ``tiles`` tiles of ``rows`` rows, the last one ragged, none
// empty, none over kMaxRows.  Tile i holds rows [i * rows, min(R, (i + 1) *
// rows)).
struct RowPlan {
  int tiles, rows;
};
__host__ __device__ inline RowPlan row_plan(int R) {
  const int n = (R + kMaxRows - 1) / kMaxRows;
  const int per = (R + n - 1) / n;
  const int rows = (per + kRowAlign - 1) / kRowAlign * kRowAlign;
  return RowPlan{(R + rows - 1) / rows, rows};
}

// Where key j of batch row b lives: a slot of the flattened (slots, KV, hd)
// K/V arrays.  A block stages what it needs for its range [k_begin, k_end)
// once at entry (``stage``, into kStaged ints of shared memory, then a
// barrier), so ``slot``, called by the thread that issues a key's copy,
// never waits on device memory.  ``fits`` says whether a range of ``keys``
// keys fits the staging area; the launch refuses a plan that does not.

// Slot b * L + j of a (B, L, KV, hd) array; nothing to stage.
struct DenseRows {
  static constexpr int kStaged = 0;
  int L;
  __host__ __device__ bool fits(int) const { return true; }
  __device__ __forceinline__ void stage(int, int, int, int*, int) const {}
  __device__ __forceinline__ size_t slot(int b, int j, int, const int*) const {
    return size_t(b) * L + j;
  }
};

// Slot page * ps + j % ps of the flattened (num_pages * ps, KV, hd) pool,
// page = tbl[b, j / ps].  The block's pages k_begin / ps .. (k_end - 1) / ps
// are staged at entry (a range of ``keys`` keys touches at most keys / ps + 2
// pages: 3 at the path's L 144 with ps 16, 64 at L 4096 with ps 8), each
// clamped into [0, num_pages) as the reference's gather clamps, so a bad
// table never addresses memory outside the pool.  512 staged pages (2 KB)
// take ranges of up to 4,080 keys at ps 8: L up to 32,640.
struct PagedRows {
  static constexpr int kStaged = 512;
  const int* tbl;
  int P, ps, num_pages;
  __host__ __device__ bool fits(int keys) const {
    return keys / ps + 2 <= kStaged;
  }
  __device__ __forceinline__ void stage(int b, int k_begin, int k_end,
                                        int* s, int tid) const {
    const int p0 = k_begin / ps;
    const int n = (k_end - 1) / ps - p0 + 1;
    for (int i = tid; i < n; i += kThreads) {
      const int page = tbl[size_t(b) * P + p0 + i];
      s[i] = min(max(page, 0), num_pages - 1);
    }
  }
  __device__ __forceinline__ size_t slot(int, int j, int k_begin,
                                         const int* s) const {
    return size_t(s[j / ps - k_begin / ps]) * ps + j % ps;
  }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* kv_pos;
  const int* kv_node;    // tree only, else nullptr
  const int* anc_bits;   // tree only, else nullptr
  void* out;
  int B, kq, heads, kv_heads, L, window, num_meta;
};

// Keys per tile: two k16 steps of the bf16 products.  A range of 64 keys
// is two tiles, so the first is used while the second is in flight.  fp32
// rows wider than 128 take half (Layout::kKeys), so two blocks fit an SM.
constexpr int kTileKeys = 32;

// The compute width of a head_dim: 24 runs at 32 (see the header), every
// other supported head_dim at itself.
__host__ __device__ constexpr int compute_width(int hd) {
  return hd == 24 ? 32 : hd;
}

// Blocks an SM the kernel is compiled for: three (168 registers a thread)
// up to head_dim 128, two at 160 (see the header).
__host__ __device__ constexpr int min_blocks(int hd) {
  return hd > 128 ? 2 : 3;
}

// The softmax's exponential, per dtype.  bf16 works in base 2, log2(e)
// folded into the score scale (one ex2 a score); fp32 keeps expf, since the
// fp32 gates hold the card to the reference at 2e-5.
__device__ __forceinline__ float softmax_exp(float x, __nv_bfloat16) {
  return exp2f(x);
}
__device__ __forceinline__ float softmax_exp(float x, float) { return expf(x); }

template <typename T, int HD, bool kTree>
struct Layout {
  static constexpr int kKeys =
      sizeof(T) == 4 && HD > 128 ? kTileKeys / 2 : kTileKeys;
  static constexpr int kVec = 16 / sizeof(T);          // elements per copy
  static constexpr int kLd = HD + kVec;                // padded row
  static constexpr int kStageElems = kKeys * kLd;      // one K or V tile
  static constexpr size_t kStages = 2 * 2 * size_t(kStageElems) * sizeof(T);
  // after the tile loop the region holds this range's partials: acc
  // [64][hd], m [64], l [64] (local rows of the block's row tile)
  static constexpr size_t kPartials = sizeof(float) * (kMaxRows * HD + 2 * kMaxRows);
  static constexpr size_t kRegion = kStages > kPartials ? kStages : kPartials;
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kPsLd = kKeys + 1;
  // fp32 only: q rows [64][kLd] and probabilities [64][kPsLd]
  static constexpr size_t kF32Extra =
      kF32 ? sizeof(float) * (size_t(kMaxRows) * kLd + kMaxRows * kPsLd) : 0;
  static constexpr size_t kPos = sizeof(int) * 2 * kKeys * (kTree ? 2 : 1);
  static constexpr size_t kBytes = kRegion + kF32Extra + kPos;
};

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four consecutive outputs in one store (8 bytes of bf16, 16 of fp32).
__device__ __forceinline__ void store4(float* o, float x, float y, float z,
                                       float w) {
  *reinterpret_cast<float4*>(o) = make_float4(x, y, z, w);
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, float x, float y,
                                       float z, float w) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(z, w);
  uint2 v;
  v.x = *reinterpret_cast<const uint32_t*>(&lo);
  v.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(o) = v;
}

// kW consecutive floats of shared memory in one access (a float4, or a
// float2 at hd 16).
template <int kW>
__device__ __forceinline__ void load_cols(float (&x)[kW], const float* p) {
  static_assert(kW == 4 || kW == 2, "four or two columns a piece");
  if constexpr (kW == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  }
}
template <int kW>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[kW]) {
  if constexpr (kW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

// What one query row needs to test a key.
struct RowInfo {
  int qp;
  uint32_t anc;
};

template <bool kTree>
__device__ __forceinline__ bool visible(int kp, int kn, RowInfo r, int window,
                                        int num_meta) {
  bool vis = kp >= 0 && kp <= r.qp;
  if (window) vis = vis && (r.qp - kp < window || kp < num_meta);
  if constexpr (kTree) {
    if (kn >= 0) vis = vis && ((r.anc >> min(kn, 31)) & 1u);
  }
  return vis;
}

// Row r of the block's tile is query row r_begin + r of the (row, head);
// rows at or past the tile's R are padding.
template <bool kTree>
__device__ __forceinline__ RowInfo row_info(const int* q_pos,
                                            const int* anc_bits, int b, int kq,
                                            int G, int r_begin, int r, int R) {
  if (r >= R) return RowInfo{-1, 0u};  // a padding row sees no key
  const int at = b * kq + (r_begin + r) / G;
  return RowInfo{q_pos[at],
                 kTree ? static_cast<uint32_t>(anc_bits[at]) : 0u};
}

// The tile of 16 query rows warp tid / 32 holds.  Warp i runs on the SM's
// sub-partition i % 4; at kq * G <= 32 only one or two row tiles exist, so
// the tiles rotate with the block index to spread the busy warps of the
// blocks resident on one SM over all four sub-partitions (and their tensor
// cores).  Which warp holds a row does not change the row's arithmetic.
__device__ __forceinline__ int row_tile(int tid, int block) {
  return (tid / 32 + block) & 3;
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Three blocks an SM (at most 168 registers a thread): the 64 clusters of
// four at the path's shape then run in one wave.  Two at head_dim 160.
template <typename T, int HD, typename Rows, bool kTree>
__global__ void __launch_bounds__(kThreads, min_blocks(HD))
split_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ q_pos,
                       const int* __restrict__ kv_pos,
                       const int* __restrict__ kv_node,
                       const int* __restrict__ anc_bits, T* __restrict__ out,
                       Rows rows, int kq, int heads, int kv_heads, int L,
                       int window, int num_meta, int splits, int split_keys,
                       int tile_rows, float scale) {
  // HD: a row's width in device memory; HDC: the width computed on, with
  // lanes HD..HDC-1 zero (compute_width)
  constexpr int HDC = compute_width(HD);
  using Lay = Layout<T, HDC, kTree>;
  constexpr int kKeys = Lay::kKeys;
  constexpr int kVec = Lay::kVec;
  constexpr int kLd = Lay::kLd;
  constexpr int kChunks = HD / kVec;       // copies of a row's stored lanes
  constexpr int kChunksC = HDC / kVec;     // and of its padded compute row
  static_assert(HD % kVec == 0 && HDC % 16 == 0, "head_dim tiling");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bkv = blockIdx.x / splits;
  const int b = bkv / kv_heads;
  const int kvh = bkv % kv_heads;
  const int G = heads / kv_heads;
  // this block's row tile: rows [r_begin, r_begin + R) of the kq * G
  const int r_begin = blockIdx.y * tile_rows;
  const int R = min(tile_rows, kq * G - r_begin);
  const int tid = threadIdx.x;
  const int k_begin = rank * split_keys;
  const int k_end = min(L, k_begin + split_keys);
  const int n_tiles = (k_end - k_begin + kKeys - 1) / kKeys;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage_base = reinterpret_cast<T*>(smem_raw);     // [2][K, V][kKeys][kLd]
  float* part = reinterpret_cast<float*>(smem_raw);   // after the loop
  float* part_m = part + kMaxRows * HDC;
  float* part_l = part_m + kMaxRows;
  float* f32_extra = reinterpret_cast<float*>(smem_raw + Lay::kRegion);
  float* qs = f32_extra;                               // fp32: [64][kLd]
  float* ps = qs + kMaxRows * kLd;                     // fp32: [64][kPsLd]
  int* pos_s = reinterpret_cast<int*>(smem_raw + Lay::kRegion + Lay::kF32Extra);
  int* node_s = pos_s + 2 * kKeys;                     // tree: [2][kKeys]
  int* rows_s = reinterpret_cast<int*>(smem_raw + Lay::kBytes);  // Rows::kStaged

  auto k_tile = [&](int st) { return stage_base + (2 * st) * Lay::kStageElems; };
  auto v_tile = [&](int st) { return stage_base + (2 * st + 1) * Lay::kStageElems; };

  // Stage keys [base, base + kKeys) of this range and their positions (and
  // tree nodes), all by cp.async, so nothing here waits for memory; keys
  // past the range, and the lanes past HD of every key, are zero-filled,
  // and the tile's users test base + t < k_end before they read a position.
  auto load_tile = [&](int st, int base) {
    T* ks = k_tile(st);
    T* vs = v_tile(st);
    for (int e = tid; e < kKeys * kChunksC; e += kThreads) {
      const int t = e / kChunksC, c = e % kChunksC;
      const int j = base + t;
      const bool valid = j < k_end && c < kChunks;
      const size_t slot = rows.slot(b, j < k_end ? j : k_begin, k_begin,
                                    rows_s);
      const size_t off = (slot * kv_heads + kvh) * HD
                         + (c < kChunks ? c : 0) * kVec;
      cp_async16(ks + t * kLd + c * kVec, k + off, valid);
      cp_async16(vs + t * kLd + c * kVec, v + off, valid);
    }
    for (int t = tid; t < kKeys; t += kThreads) {
      const int j = base + t;
      const bool valid = j < k_end;
      const size_t at = size_t(b) * L + (valid ? j : k_begin);
      cp_async4(pos_s + st * kKeys + t, kv_pos + at, valid);
      if constexpr (kTree) cp_async4(node_s + st * kKeys + t, kv_node + at, valid);
    }
  };

  if constexpr (Rows::kStaged > 0) {
    rows.stage(b, k_begin, k_end, rows_s, tid);
    __syncthreads();
  }
  load_tile(0, k_begin);
  cp_async_commit();

  if constexpr (!Lay::kF32) {
    // ---- bf16: tensor cores, one warp per 16 query rows ------------------
    const int lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int row0 = row_tile(tid, blockIdx.x) * 16;
    const bool active = row0 < R;
    constexpr int kNT = kKeys / 8;    // n8 tiles of scores
    constexpr int kDT = HDC / 8;      // n8 tiles of the output
    constexpr int kKC = HDC / 16;     // k16 steps of Q.K^T

    // Q's A-fragments, straight from device memory (rows past R and lanes
    // past HD are zero)
    const float scale_log2 = scale * 1.4426950408889634f;   // log2(e)
    uint32_t qf[kKC][4];
    RowInfo ri[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = row0 + g + 8 * h2;
      ri[h2] = row_info<kTree>(q_pos, anc_bits, b, kq, G, r_begin, r, R);
      const uint32_t* qrow = nullptr;
      if (r < R) {
        const int qi = (r_begin + r) / G, h = kvh * G + (r_begin + r) % G;
        qrow = reinterpret_cast<const uint32_t*>(
            q + ((size_t(b) * kq + qi) * heads + h) * HD);
      }
#pragma unroll
      for (int kc = 0; kc < kKC; ++kc) {
        const int c0 = kc * 16 + 2 * t4, c1 = c0 + 8;   // even: a lane pair
        qf[kc][h2] = qrow && c0 < HD ? qrow[c0 / 2] : 0u;
        qf[kc][h2 + 2] = qrow && c1 < HD ? qrow[c1 / 2] : 0u;
      }
    }

    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float acc[kDT][4];
#pragma unroll
    for (int i = 0; i < kDT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it & 1;
      const int base = k_begin + it * kKeys;
      if (it + 1 < n_tiles) {
        load_tile(st ^ 1, base + kKeys);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      if (active) {
        const T* ks = k_tile(st);
        const T* vs = v_tile(st);
        float s[kNT][4];
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
        // S = Q K^T: B-fragments of two n8 tiles per ldmatrix.x4
#pragma unroll
        for (int kc = 0; kc < kKC; ++kc) {
#pragma unroll
          for (int np = 0; np < kNT / 2; ++np) {
            uint32_t bf[4];
            const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
            const int col = kc * 16 + ((lane >> 3) & 1) * 8;
            ldmatrix_x4(bf, ks + key * kLd + col);
            mma_bf16(s[2 * np], qf[kc], bf[0], bf[1]);
            mma_bf16(s[2 * np + 1], qf[kc], bf[2], bf[3]);
          }
        }
        // scale (to base 2) and mask on the fp32 scores; keys past the range
        // drop out
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = n * 8 + 2 * t4 + (e & 1);
            const int h2 = e >> 1;
            float x = -INFINITY;
            if (base + t < k_end) {
              const int kn = kTree ? node_s[st * kKeys + t] : -1;
              x = visible<kTree>(pos_s[st * kKeys + t], kn, ri[h2], window,
                                 num_meta)
                      ? s[n][e] * scale_log2
                      : kMasked;
            }
            s[n][e] = x;
            mx[h2] = fmaxf(mx[h2], x);
          }
        }
        float alpha[2];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
          mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
          const float m_new = fmaxf(m[h2], mx[h2]);
          alpha[h2] = exp2f(m[h2] - m_new);
          m[h2] = m_new;
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(s[n][e] - m[e >> 1]);
            s[n][e] = p;
            sum[e >> 1] += p;
          }
        }
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) l[h2] = fmaf(l[h2], alpha[h2], sum[h2]);
#pragma unroll
        for (int i = 0; i < kDT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] *= alpha[e >> 1];
        // O += P V: P's A-fragment from two score tiles, V transposed by
        // ldmatrix.trans into the B-fragments of two n8 output tiles
#pragma unroll
        for (int kc = 0; kc < kKeys / 16; ++kc) {
          const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                                  pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                                  pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                                  pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
          for (int dp = 0; dp < kDT / 2; ++dp) {
            uint32_t bf[4];
            const int key = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
            const int col = dp * 16 + (lane >> 4) * 8;
            ldmatrix_x4_trans(bf, vs + key * kLd + col);
            mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
            mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
          }
        }
      }
      __syncthreads();   // the tile is no longer read; the next one may land
    }

    // this range's partials, unnormalised, into shared memory
    if (active) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 1);
        l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 2);
        const int r = row0 + g + 8 * h2;
#pragma unroll
        for (int i = 0; i < kDT; ++i)
          *reinterpret_cast<float2*>(part + r * HDC + i * 8 + 2 * t4) =
              make_float2(acc[i][2 * h2], acc[i][2 * h2 + 1]);
        if (t4 == 0) {
          part_m[r] = m[h2];
          part_l[r] = l[h2];
        }
      }
    }
  } else {
    // ---- fp32: CUDA-core FMAs, thread (rg, kg) owns rows 4rg..4rg+3 -------
    constexpr int kSK = kKeys / 8;    // score columns per thread
    // output columns: pieces of kOW consecutive columns, thread kg holding
    // columns kg * kOW + 8 * kOW * c of its rows for c < kOC
    constexpr int kOW = HDC >= 32 ? 4 : HDC / 8;
    constexpr int kOC = HDC / (8 * kOW);
    constexpr int kPsLd = Lay::kPsLd;
    const int kg = tid & 7;
    // a warp's 4 row groups hold one row tile of 16: whole warps sit out, so
    // the row reductions' shuffles always run on full warps
    const int rb = row_tile(tid, blockIdx.x) * 16 + ((tid % 32) >> 3) * 4;
    const bool active = row_tile(tid, blockIdx.x) * 16 < R;

    for (int e = tid; e < kMaxRows * HDC; e += kThreads) {
      const int r = e / HDC, d = e % HDC;
      float x = 0.f;
      if (r < R && d < HD) {
        const int qi = (r_begin + r) / G, h = kvh * G + (r_begin + r) % G;
        x = to_f32(q[((size_t(b) * kq + qi) * heads + h) * HD + d]);
      }
      qs[r * kLd + d] = x;
    }
    RowInfo ri[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ri[i] = row_info<kTree>(q_pos, anc_bits, b, kq, G, r_begin, rb + i, R);

    float m[4], l[4];
    float acc[4][kOC][kOW];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < kOC; ++c)
#pragma unroll
        for (int w = 0; w < kOW; ++w) acc[i][c][w] = 0.f;
    }

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it & 1;
      const int base = k_begin + it * kKeys;
      if (it + 1 < n_tiles) {
        load_tile(st ^ 1, base + kKeys);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      if (active) {
        const float* ks = reinterpret_cast<const float*>(k_tile(st));
        const float* vs = reinterpret_cast<const float*>(v_tile(st));
        float s[4][kSK];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kSK; ++j) s[i][j] = 0.f;
        // scores of keys kg + 8j, summed over d in order
#pragma unroll 4
        for (int d = 0; d < HDC; d += 4) {
          float4 qv[4], kv[kSK];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            qv[i] = *reinterpret_cast<const float4*>(qs + (rb + i) * kLd + d);
#pragma unroll
          for (int j = 0; j < kSK; ++j)
            kv[j] = *reinterpret_cast<const float4*>(ks + (kg + 8 * j) * kLd + d);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < kSK; ++j) {
              float x = s[i][j];
              x = fmaf(qv[i].x, kv[j].x, x);
              x = fmaf(qv[i].y, kv[j].y, x);
              x = fmaf(qv[i].z, kv[j].z, x);
              x = fmaf(qv[i].w, kv[j].w, x);
              s[i][j] = x;
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < kSK; ++j) {
            const int t = kg + 8 * j;
            float x = -INFINITY;
            if (base + t < k_end) {
              const int kn = kTree ? node_s[st * kKeys + t] : -1;
              x = visible<kTree>(pos_s[st * kKeys + t], kn, ri[i], window,
                                 num_meta)
                      ? s[i][j] * scale
                      : kMasked;
            }
            s[i][j] = x;
            mx = fmaxf(mx, x);
          }
#pragma unroll
          for (int o = 1; o < 8; o <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_new = fmaxf(m[i], mx);
          const float alpha = expf(m[i] - m_new);
          m[i] = m_new;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < kSK; ++j) {
            const float p = expf(s[i][j] - m_new);
            ps[(rb + i) * kPsLd + kg + 8 * j] = p;
            sum += p;
          }
          l[i] = fmaf(l[i], alpha, sum);
#pragma unroll
          for (int c = 0; c < kOC; ++c)
#pragma unroll
            for (int w = 0; w < kOW; ++w) acc[i][c][w] *= alpha;
        }
      }
      __syncwarp();    // a row group's probabilities are its own warp's
      if (active) {
        const float* vs = reinterpret_cast<const float*>(v_tile(st));
#pragma unroll 4
        for (int t = 0; t < kKeys; ++t) {
          float p[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) p[i] = ps[(rb + i) * kPsLd + t];
#pragma unroll
          for (int c = 0; c < kOC; ++c) {
            float vv[kOW];
            load_cols<kOW>(vv, vs + t * kLd + kg * kOW + 8 * kOW * c);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int w = 0; w < kOW; ++w)
                acc[i][c][w] = fmaf(p[i], vv[w], acc[i][c][w]);
          }
        }
      }
      __syncthreads();   // the tile is no longer read; the next one may land
    }

    if (active) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int o = 1; o < 8; o <<= 1)
          l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
        const int r = rb + i;
#pragma unroll
        for (int c = 0; c < kOC; ++c)
          store_cols<kOW>(part + r * HDC + kg * kOW + 8 * kOW * c, acc[i][c]);
        if (kg == 0) {
          part_m[r] = m[i];
          part_l[r] = l[i];
        }
      }
    }
  }

  // ---- combine the ranges' partials through distributed shared memory ----
  // Each block writes its share of the tile's (R, HD) outputs, four columns a
  // thread (the padded lanes HD..HDC-1 are never written): it reads every
  // range's (m, l) of the row and its four accumulator columns, two
  // elements' worth of remote reads in flight at once, then weighs the
  // ranges in rank order.
  cluster.sync();
  const float* rp[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    rp[s] = cluster.map_shared_rank(part, s < splits ? s : 0);
  const int total = R * HD / 4;
  const int share = (total + splits - 1) / splits;
  const int e_end = min(total, (rank + 1) * share);
  for (int e0 = rank * share + tid; e0 < e_end; e0 += 2 * kThreads) {
    float ms[2][kMaxSplits], ls[2][kMaxSplits];
    float4 a[2][kMaxSplits];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = min(e0 + u * kThreads, e_end - 1);
      const int r = (4 * e) / HD, d = (4 * e) % HD;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        if (s < splits) {
          ms[u][s] = rp[s][kMaxRows * HDC + r];
          ls[u][s] = rp[s][kMaxRows * HDC + kMaxRows + r];
          a[u][s] = *reinterpret_cast<const float4*>(rp[s] + r * HDC + d);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= e_end) break;
      const int r = (4 * e) / HD, d = (4 * e) % HD;
      float mx = -INFINITY;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        if (s < splits) mx = fmaxf(mx, ms[u][s]);
      float num[4] = {0.f, 0.f, 0.f, 0.f};
      float den = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {   // in rank order
        if (s < splits) {
          const float w = softmax_exp(ms[u][s] - mx, T{});
          num[0] = fmaf(w, a[u][s].x, num[0]);
          num[1] = fmaf(w, a[u][s].y, num[1]);
          num[2] = fmaf(w, a[u][s].z, num[2]);
          num[3] = fmaf(w, a[u][s].w, num[3]);
          den = fmaf(w, ls[u][s], den);
        }
      }
      const int qi = (r_begin + r) / G, h = kvh * G + (r_begin + r) % G;
      store4(out + ((size_t(b) * kq + qi) * heads + h) * HD + d,
             num[0] / den, num[1] / den, num[2] / den, num[3] / den);
    }
  }
  cluster.sync();      // no block leaves while another reads its partials
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int HD, typename Rows, bool kTree>
cudaError_t launch(const Args& a, int splits, int row_tiles, Rows rows,
                   cudaStream_t stream) {
  using Lay = Layout<T, compute_width(HD), kTree>;
  const Plan plan = split_plan(a.L);
  const RowPlan rp = row_plan(a.kq * (a.heads / a.kv_heads));
  if (splits != plan.splits || row_tiles != rp.tiles || !rows.fits(plan.keys))
    return cudaErrorInvalidValue;
  constexpr size_t kBytes = Lay::kBytes + sizeof(int) * Rows::kStaged;
  auto kernel = split_attention_kernel<T, HD, Rows, kTree>;
  static std::atomic<unsigned long long> configured{0};
  cudaError_t err = allow_smem(kernel, static_cast<int>(kBytes), configured);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  const long long blocks =
      static_cast<long long>(a.B) * a.kv_heads * plan.splits;
  if (blocks > INT_MAX || rp.tiles > 65535) return cudaErrorInvalidValue;
  cfg.gridDim = dim3(static_cast<unsigned>(blocks),
                     static_cast<unsigned>(rp.tiles));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(plan.splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.q_pos, a.kv_pos, a.kv_node, a.anc_bits,
      static_cast<T*>(a.out), rows, a.kq, a.heads, a.kv_heads, a.L, a.window,
      a.num_meta, plan.splits, plan.keys, rp.rows, 1.0f / sqrtf(float(HD)));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, typename Rows, bool kTree>
cudaError_t dispatch_hd(int hd, const Args& a, int splits, int row_tiles,
                        Rows rows, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16, Rows, kTree>(a, splits, row_tiles, rows, s);
    case 24: return launch<T, 24, Rows, kTree>(a, splits, row_tiles, rows, s);
    case 32: return launch<T, 32, Rows, kTree>(a, splits, row_tiles, rows, s);
    case 64: return launch<T, 64, Rows, kTree>(a, splits, row_tiles, rows, s);
    case 128: return launch<T, 128, Rows, kTree>(a, splits, row_tiles, rows, s);
    case 160: return launch<T, 160, Rows, kTree>(a, splits, row_tiles, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

// The wrappers (kernels/*.py) have checked shapes, dtypes, contiguity and
// alignment and computed the split and row plans; this re-checks what would
// make the launch unsafe (the plans included), then picks the instantiation
// for the dtype and head_dim.
template <typename Rows, bool kTree>
cudaError_t run(int dtype, int hd, const Args& a, int splits, int row_tiles,
                Rows rows, void* stream) {
  if (a.B < 1 || a.kq < 1 || a.L < 1 || a.kv_heads < 1 ||
      a.heads % a.kv_heads != 0 ||
      static_cast<long long>(a.kq) * (a.heads / a.kv_heads) > INT_MAX / 256)
    return cudaErrorInvalidValue;
  if (kTree && (a.kv_node == nullptr || a.anc_bits == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_hd<float, Rows, kTree>(hd, a, splits, row_tiles, rows, s);
  if (dtype == kBFloat16)
    return dispatch_hd<__nv_bfloat16, Rows, kTree>(hd, a, splits, row_tiles,
                                                   rows, s);
  return cudaErrorInvalidValue;
}

}  // namespace bpd_split
