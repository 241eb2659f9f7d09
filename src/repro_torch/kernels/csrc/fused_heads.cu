// BPD heads' vocab projection with a running top-T; logits never written.
//
// Replaces repro/kernels/fused_heads.py: fused_heads_topk_pallas
// (_fused_heads_kernel).  Same contract: o (N, d) and w (d, Vp) in f32 or
// bf16 -> the top-T (value desc, id asc) of o @ w per row, accumulated in
// fp32, over lanes < vocab (lanes vocab..Vp are -1e30 and never win).  w is
// read through its strides, so the tied embedding table's transpose view
// (strides (1, d)) needs no copy.
//
// What bounds it on an H100: reading w once.  In bf16 that is 405 MB at
// granite's d 4096 x Vp 49408 (0.121 ms at 3.35 TB/s) and 268 MB for
// rwkv6's (2048, 65536) lm_head (0.080 ms).  Its 2 N d Vp operations (22.7 G
// at N 56) take 0.023 ms at the 989 TFLOP/s bf16 tensor rate, a fifth of the
// byte bound.  In fp32 w is 810 MB (0.242 ms); the three TF32 products of
// fp32 work (below) are 68 G operations at N 56, 0.137 ms at 495 TFLOP/s,
// and 0.157 ms at the 64 rows the products compute: 65% of the byte time,
// so the products have to overlap the copies.  On the fp32 CUDA cores the
// same 22.7 G take 0.34 ms, which is where the first fp32 body ran them.
//
// One body, heads_tc_kernel<T>, for both types:
//
// 1. Tensor cores with the vocab as M.  logits^T = W^T o^T: a tile of 128
//    vocab lanes is two m64 products of wgmma (fp32 accumulation) and the
//    N <= 64 rows of o (56 on the path, rows past N zero) are the narrow N
//    side: 64 fp32 accumulators a thread in bf16's one consumer
//    warpgroup, 32 (and 32 of partial sums) in each of fp32's two.  The
//    tied view (strides (1, d)) is K-major (W^T's rows are the table's
//    rows); the untied (d, Vp) row-major lm_heads are M-major.
//    bf16 (m64n64k16): both operands straight from the shared-memory tiles
//    (matrix descriptors, no ldmatrix), the M-major W read with wgmma's
//    transpose bit.  wgmma and not mma.sync: with mma.sync four warps spent
//    about 1,900 cycles on each 16 KB stage (ldmatrix and mma.sync latency,
//    the ring full 88% of the time: tools/trace_fused_heads.py on an H100),
//    twice the stage's share of the memory's rate; wgmma reads its operands
//    itself and runs asynchronously.
//    fp32 (m64n64k8 .tf32, "3xTF32"): each operand is split as hi =
//    rna(x), lo = rna(x - hi) (cvt.rna.tf32.f32's rounding: to nearest,
//    ties away from zero, in two integer operations; the tensor cores
//    would truncate the low 13 bits) and the products W_lo o_hi + W_hi o_lo
//    + W_hi o_hi, small terms first, run into the fp32 accumulators: fp32
//    accuracy (rwkv6_scan.cu does the same on mma.sync).  .tf32 takes a
//    shared-memory operand only K-major and has no transpose bit, so W (A)
//    comes from registers: each consumer thread loads its fragment from the
//    swizzled stage (either layout), splits it and issues the products; o
//    (B) is K-major, and its two parts come from a split kernel run first
//    in the same call (split_o_kernel) through TMA like bf16's o.  Two
//    consumer warpgroups take one m64 half each, so one's loads and splits
//    overlap the other's products (with one warpgroup for both halves, the
//    consumers spent 48% of their cycles loading and splitting W and 5%
//    waiting for data: tools/trace_fused_heads.py on an H100).  The
//    products of each 8-deep step are one commit group; a thread loads and
//    splits the next step's fragment while the tensor cores run this one,
//    and waits for the group before it (wgmma.wait_group 1).  The tensor
//    cores' fp32 sums lose low bits as the accumulator grows: summed over
//    a whole tile, the top logits were 2.0e-4 from float64 at d 4096 and
//    4.2e-4 at d 7168 (max|logit| 7.0 and 8.5), so each stage's products
//    sum into a fresh accumulator that is then added into the tile's
//    logits in fp32 registers: 3.8e-6 and 5.4e-6
//    (tools/fused_heads_accumulation.py on an H100).  An M-major
//    fragment's lanes are permuted (lane_of) so the loads are free of bank
//    conflicts.
// 2. W streams through a TMA ring.  One producer thread loads each stage,
//    128 lanes x 128 bytes of d of W (16 KB: 64 of d in bf16, 32 in fp32)
//    and the matching 64 rows of o (8 KB; fp32 16 KB, hi and lo), by
//    cp.async.bulk.tensor into a ring of 6 stages guarded by full / empty
//    mbarriers: up to 5 stages (80 KB of W) in flight per SM, against the
//    ~25 KB Little's law asks at 3.35 TB/s.  The 2-D tensor maps are
//    encoded on the host per call (cuTensorMapEncodeTiled, taken through
//    cudaGetDriverEntryPoint, so the library links no libcuda) and passed as
//    __grid_constant__ parameters.  Tiles land with the 128-byte swizzle in
//    1024-byte aligned stages, the layout wgmma's descriptors name (8-row or
//    8-k groups 1024 bytes apart), so its reads are free of bank conflicts.
//    An M-major W stage is 2 boxes of 64 lanes in bf16, 4 of 32 in fp32.
//    TMA zero-fills past d, Vp and N.  The small o is read again from L2 for
//    every vocab tile: 386 tiles x 458 KB = 177 MB at granite's shape in
//    bf16, 708 MB in fp32 (hi and lo).  Tiles of 128 lanes keep the blocks'
//    loads within 3% of even over 132 SMs (granite: 386 tiles, 2.92 a
//    block; rwkv6: 512, 3.88); 256-lane tiles would halve that L2 traffic
//    but give blocks 1 or 2 tiles, 37% uneven.
// 3. Persistent blocks carry the top-T, as the TPU carries it along its
//    sequential vocab axis.  min(tiles, SMs) blocks per 64-row tile of o;
//    block i walks tiles [i * tiles / blocks, (i + 1) * tiles / blocks) in
//    order.  After a tile's d loop the consumers write its fp32 logits
//    (64 x 128) into shared memory, and thread (row, part) folds every
//    second (bf16) or fourth (fp32) lane < vocab of its row into a running
//    top-T in registers (TopT<1>, or TopT<8>: 16 registers), while the
//    producer already loads the next tile's stages.  At the end each row's
//    lists merge and the block writes one partial per row; a second kernel
//    merges the blocks' partials (132 x T a row at the path's shape).
#include "common.cuh"

#include <cuda.h>   // CUtensorMap and its enums (types only: no libcuda link)

#include <atomic>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxTopT = 8;
constexpr int kMergeThreads = 256;

// ---------------------------------------------------------------------------
// merge: a block per row reduces the partial lists of its row
// ---------------------------------------------------------------------------

template <int TT>
__global__ void __launch_bounds__(kMergeThreads)
merge_topk_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                  int parts, int top_t, float* __restrict__ vals,
                  int* __restrict__ ids) {
  __shared__ float sv[kMergeThreads * TT];
  __shared__ int si[kMergeThreads * TT];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = size_t(row) * parts * top_t;
  TopT<TT> top;
  top.init();
  for (int e = tid; e < parts * top_t; e += kMergeThreads)
    top.insert(part_v[base + e], part_i[base + e]);
  top.store(sv + tid * TT, si + tid * TT);
  block_merge_top<TT>(sv, si, kMergeThreads);
  if (tid < top_t) {
    vals[size_t(row) * top_t + tid] = sv[tid];
    ids[size_t(row) * top_t + tid] = si[tid];
  }
}

// ---------------------------------------------------------------------------
// tensor cores fed by a TMA ring, persistent blocks carrying the top-T
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kTileV = 128;     // vocab lanes per tile (fused_heads.py: VOCAB_TILE)
constexpr int kTileRows = 64;   // rows of o per block: the products' N
constexpr int kStages = 6;
constexpr int kLgLd = kTileV + 2;                // fold reads conflict-free
constexpr int kLgBytes = int(sizeof(float)) * kTileRows * kLgLd;

// A stage for element type T: every tile row is one 128-byte swizzled row,
// so a stage covers 64 of d in bf16 and 32 in fp32, and W's part is 16 KB
// in both; fp32 carries o's TF32 high and low parts.  bf16 has one
// consumer warpgroup for both m64 halves of a tile; fp32, whose consumers
// also load and split W, one warpgroup per half, so one warpgroup's
// loads and splits overlap the other's products.
template <typename T>
struct Stage {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kGroups = kF32 ? 2 : 1;           // consumer warpgroups
  static constexpr int kHalves = 2 / kGroups;            // m64 halves each
  static constexpr int kConsumers = 128 * kGroups;
  static constexpr int kThreads = kConsumers + 32;       // + one producer warp
  static constexpr int kWays = kConsumers / kTileRows;   // threads folding a row
  static constexpr int kDepth = 128 / int(sizeof(T));   // d per stage
  static constexpr int kWBytes = kTileV * 128;           // 16 KB
  static constexpr int kOPart = kTileRows * 128;         // 8 KB
  static constexpr int kBytes = kWBytes + (kF32 ? 2 : 1) * kOPart;
  static constexpr int kRingBytes = kStages * kBytes;    // a multiple of 1024
  static constexpr int kSmemBytes = 1024 + kRingBytes + kLgBytes + 2 * 8 * kStages;
  // an M-major W stage: boxes of [kDepth of d][kDepth lanes]
  static constexpr int kBoxes = kTileV / kDepth;
  static_assert(kSmemBytes <= 232448, "a block's shared memory on an H100");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
// Arrive and add ``bytes`` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// Wait until the phase of parity ``parity`` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// A 2-D box at (c0 inner, c1 outer) of ``map`` into shared memory at
// ``dst``; its bytes count against ``bar``'s transaction count.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// A shared-memory matrix descriptor for wgmma: a tile TMA wrote with the
// 128-byte swizzle (layout type 1), 8-row groups (K-major) or 8-k groups
// (M-major) 1024 bytes apart.  The leading offset is only read for an
// M-major operand wider than one 64-lane swizzle atom, which no product
// here is.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// d (64 x 64, fp32) += a (64 x 16 bf16, K-major, or M-major with kTransA)
// * b (16 x 64 bf16, K-major), issued by the whole warpgroup.
template <int kTransA>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, %35, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(kTransA));
}
// d (64 x 64, fp32) = a (64 x 8 TF32, in registers: thread (warp w, g, t4)
// holds rows 16w + g (+ 8) at k t4 (+ 4), as mma.sync's m16n8k8) * b (8 x
// 64 TF32, K-major in shared memory) + d if ``accumulate``, issued by the
// whole warpgroup.
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
template <int kConsumers>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// x rounded to the nearest TF32 (ties away from zero): cvt.rna.tf32.f32's
// result, its low 13 bits zero, in two integer operations.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The vocab lane (0..127 in the tile) of the products' row m.  K-major: m
// itself.  M-major: the 8 rows g of a (warp, half, +8) fragment register
// take chunks c and c + 4 of one box's swizzled rows, so a warp's 32 loads
// (8 rows x 4 k, the swizzle XORing k into the chunk) hit 32 banks.
template <bool kRowMajor>
__device__ __forceinline__ int lane_of(int m) {
  if constexpr (!kRowMajor) return m;
  const int h = m >> 6, w = (m >> 4) & 3, r = (m >> 3) & 1, g = m & 7;
  return 32 * (2 * h + (w >> 1)) + 4 * (2 * (w & 1) + r) + 16 * (g >> 2) +
         (g & 3);
}
// The byte offset of W's element (lane, k) in an fp32 stage: K-major, a
// 128-byte row of 32 k per lane; M-major, [32 k][32 lanes] boxes of 4 KB.
// TMA's 128-byte swizzle XORs a row's 16-byte chunk index with the row's
// index mod 8.
template <bool kRowMajor>
__device__ __forceinline__ int w_offset(int lane, int k) {
  if constexpr (kRowMajor)
    return (lane >> 5) * 4096 + k * 128 +
           ((((lane & 31) >> 2) ^ (k & 7)) << 4) + ((lane & 3) << 2);
  return lane * 128 + (((k >> 2) ^ (lane & 7)) << 4) + ((k & 3) << 2);
}
// Thread (warp, g, t4)'s A fragment of the 8-deep step kc of an fp32
// stage, m64 half h, split into TF32 high and low parts.
template <bool kRowMajor>
__device__ __forceinline__ void load_split(const unsigned char* ws, int kc,
                                           int h, int warp, int g, int t4,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {   // a_j: row g + 8 (j & 1), k t4 + 4 (j >> 1)
    const int m = 64 * h + 16 * warp + g + 8 * (j & 1);
    const int k = 8 * kc + t4 + 4 * (j >> 1);
    const float x = *reinterpret_cast<const float*>(
        ws + w_offset<kRowMajor>(lane_of<kRowMajor>(m), k));
    hi[j] = tf32_rna(x);
    lo[j] = tf32_rna(x - __uint_as_float(hi[j]));
  }
}

// o's TF32 parts for the fp32 body: hi = rna(o), lo = rna(o - hi), each
// (N, d) like o, four elements a thread.
__global__ void __launch_bounds__(256)
split_o_kernel(const float4* __restrict__ o, uint4* __restrict__ hi,
               uint4* __restrict__ lo, int n4) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n4) return;
  const float4 x = o[i];
  const uint4 h = make_uint4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z),
                            tf32_rna(x.w));
  hi[i] = h;
  lo[i] = make_uint4(tf32_rna(x.x - __uint_as_float(h.x)),
                     tf32_rna(x.y - __uint_as_float(h.y)),
                     tf32_rna(x.z - __uint_as_float(h.z)),
                     tf32_rna(x.w - __uint_as_float(h.w)));
}

// kRowMajor: w is (d, Vp) with the vocab contiguous (a stage's W is
// kBoxes [kDepth of d][kDepth lanes] boxes); else w's transpose is (Vp, d)
// with d contiguous (a stage's W is one [128 lanes][kDepth of d] box).
// o_lo_map is read in fp32 only.
template <typename T, int TT, bool kRowMajor>
__global__ void __launch_bounds__(Stage<T>::kThreads, 1)
heads_tc_kernel(const __grid_constant__ CUtensorMap w_map,
                const __grid_constant__ CUtensorMap o_map,
                const __grid_constant__ CUtensorMap o_lo_map, int N, int d,
                int vocab, int top_t, int tiles, float* __restrict__ part_v,
                int* __restrict__ part_i) {
  using S = Stage<T>;
  constexpr int kDepth = S::kDepth;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;      // [kStages][W | o]
  float* lg = reinterpret_cast<float*>(smem_raw + (ring - raw) + S::kRingBytes);
  const uint32_t full0 = ring + S::kRingBytes + kLgBytes;  // kStages mbarriers
  const uint32_t empty0 = full0 + 8 * kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int blocks = gridDim.x;
  const int t_begin = int((long long)blockIdx.x * tiles / blocks);
  const int t_end = int((long long)(blockIdx.x + 1) * tiles / blocks);
  const int row0 = blockIdx.y * kTileRows;
  const int ksteps = (d + kDepth - 1) / kDepth;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, S::kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == S::kConsumers / 32) {
    // ---- producer: one thread keeps the ring full ----------------------
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        for (int ks = 0; ks < ksteps; ++ks) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1u);
          const uint32_t dst = ring + stage * S::kBytes;
          const uint32_t bar = full0 + 8 * stage;
          mbar_expect_tx(bar, S::kBytes);
          const int k0 = ks * kDepth, v0 = t * kTileV;
          if constexpr (kRowMajor) {
#pragma unroll
            for (int b = 0; b < S::kBoxes; ++b)
              tma_load_2d(dst + b * (S::kWBytes / S::kBoxes), &w_map, bar,
                          v0 + b * kDepth, k0);
          } else {
            tma_load_2d(dst, &w_map, bar, k0, v0);
          }
          tma_load_2d(dst + S::kWBytes, &o_map, bar, k0, row0);
          if constexpr (S::kF32)
            tma_load_2d(dst + S::kWBytes + S::kOPart, &o_lo_map, bar, k0, row0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroups of wgmma products, then the fold ---------
  const int g = lane >> 2, t4 = lane & 3;
  const int wg = warp / 4, wq = warp % 4;        // warpgroup, warp in it
  const int rows = min(kTileRows, N - row0);
  const int frow = tid / S::kWays, fpart = tid % S::kWays;   // fold row, part
  TopT<TT> top;
  top.init();
  int stage = 0;
  uint32_t phase = 0;
  for (int t = t_begin; t < t_end; ++t) {
    float acc[S::kHalves][32];    // rows 64h .. 64h + 63, h = wg kHalves + hh
    // fp32: the tensor cores' sums lose low bits as their accumulator
    // grows (see the header), so each stage's products sum into ``part``
    // afresh, which ``acc`` then adds, rounded to nearest
    float part[S::kHalves][32];
#pragma unroll
    for (int hh = 0; hh < S::kHalves; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[hh][i] = part[hh][i] = 0.f;

    for (int ks = 0; ks < ksteps; ++ks) {
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t sw = ring + stage * S::kBytes;
      const uint32_t so = sw + S::kWBytes;
      if constexpr (S::kF32) {
        const unsigned char* ws = smem_raw + (sw - raw);
#pragma unroll
        for (int kc = 0; kc < kDepth / 8; ++kc) {
          uint32_t hi[4], lo[4];                     // A's TF32 parts
          load_split<kRowMajor>(ws, kc, wg, wq, g, t4, hi, lo);
          wgmma_fence();   // A's registers written before the products read them
          const uint64_t b_hi = smem_desc(so + kc * 32);
          const uint64_t b_lo = smem_desc(so + S::kOPart + kc * 32);
          wgmma_m64n64k8_tf32(part[0], lo, b_hi, kc > 0);
          wgmma_m64n64k8_tf32(part[0], hi, b_lo, 1);
          wgmma_m64n64k8_tf32(part[0], hi, b_hi, 1);
          wgmma_commit();
          wgmma_wait<1>();   // the 8-deep step before this one is done
        }
        wgmma_wait<0>();
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * stage);   // the stage may refill
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[0][i] += part[0][i];
      } else {
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < kDepth / 16; ++kc) {
          const uint64_t b = smem_desc(so + kc * 32);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // K-major: 16 of d are 32 bytes along each lane's row; M-major:
            // 16 rows of d are two 1024-byte swizzle atoms
            const uint32_t a = sw + h * (S::kWBytes / 2) +
                               (kRowMajor ? kc * 2048 : kc * 32);
            wgmma_m64n64k16<kRowMajor>(acc[h], smem_desc(a), b);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * stage);   // the stage may refill
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1u;
      }
    }

    // the tile's logits into shared memory, [row][lane] (the accumulator
    // layout of wgmma: warp w holds rows 16w .. 16w + 15 of each m64 tile)
#pragma unroll
    for (int hh = 0; hh < S::kHalves; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int m = 64 * (wg * S::kHalves + hh) + 16 * wq + g +
                      8 * ((i >> 1) & 1);
        const int n = 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (n < rows)
          lg[n * kLgLd + (S::kF32 ? lane_of<kRowMajor>(m) : m)] = acc[hh][i];
      }
    consumer_sync<S::kConsumers>();
    // fold: thread (row, part) takes lanes part, part + kWays, ... below vocab
    if (frow < rows) {
      const int v0 = t * kTileV;
      const int m_end = min(kTileV, vocab - v0);
      for (int m = fpart; m < m_end; m += S::kWays)
        top.insert(lg[frow * kLgLd + m], v0 + m);
    }
    consumer_sync<S::kConsumers>();   // lg is free for the next tile
  }

  // each row's kWays lists merge into the block's partial for that row
  float* sv = lg;
  int* si = reinterpret_cast<int*>(lg + S::kConsumers * TT);
  top.store(sv + tid * TT, si + tid * TT);
  consumer_sync<S::kConsumers>();
  if (fpart == 0 && frow < rows) {
    const size_t base = (size_t(row0 + frow) * blocks + blockIdx.x) * top_t;
    int at[S::kWays];                   // the next entry of each list
#pragma unroll
    for (int q = 0; q < S::kWays; ++q) at[q] = 0;
    for (int j = 0; j < top_t; ++j) {   // the at[q] sum to j < top_t <= TT
      float bv = 0.f;
      int bi = 0, best = 0;
#pragma unroll
      for (int q = 0; q < S::kWays; ++q) {
        const float v = sv[(tid + q) * TT + at[q]];
        const int i = si[(tid + q) * TT + at[q]];
        if (q == 0 || ranks_before(v, i, bv, bi)) {
          bv = v;
          bi = i;
          best = q;
        }
      }
      part_v[base + j] = bv;
      part_i[base + j] = bi;
#pragma unroll
      for (int q = 0; q < S::kWays; ++q) at[q] += q == best;
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled lookup_encode() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
  return reinterpret_cast<EncodeTiled>(fn);
}

// A T (outer, inner) matrix, ``pitch`` elements between rows, cut in
// (box_outer, box_inner) boxes of 128-byte rows, swizzled, zero past its
// edges.
template <typename T>
bool encode_map(CUtensorMap* map, const void* ptr, long long inner,
                long long outer, long long pitch, int box_inner, int box_outer,
                CUtensorMapL2promotion l2) {
  static const EncodeTiled encode = lookup_encode();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(inner), cuuint64_t(outer)};
  const cuuint64_t strides[1] = {cuuint64_t(pitch) * sizeof(T)};
  const cuuint32_t box[2] = {cuuint32_t(box_inner), cuuint32_t(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, Stage<T>::kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, l2,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int TT, bool kRowMajor>
cudaError_t launch(const CUtensorMap& w_map, const CUtensorMap& o_map,
                   const CUtensorMap& o_lo_map, int N, int d, int vocab,
                   int top_t, int tiles, int blocks, float* part_v,
                   int* part_i, float* vals, int* ids, cudaStream_t stream) {
  auto kernel = heads_tc_kernel<T, TT, kRowMajor>;
  static std::atomic<unsigned long long> configured{0};
  cudaError_t err = allow_smem(kernel, Stage<T>::kSmemBytes, configured);
  if (err != cudaSuccess) return err;
  dim3 grid(blocks, (N + kTileRows - 1) / kTileRows);
  kernel<<<grid, Stage<T>::kThreads, Stage<T>::kSmemBytes, stream>>>(
      w_map, o_map, o_lo_map, N, d, vocab, top_t, tiles, part_v, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_topk_kernel<TT><<<N, kMergeThreads, 0, stream>>>(part_v, part_i, blocks,
                                                         top_t, vals, ids);
  return cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ``split`` is fp32's (2, N, d) scratch for o's TF32 parts (unused in bf16).
template <typename T, int TT>
cudaError_t run(const void* o, const void* w, void* split, long long ws0,
                long long ws1, int N, int d, int Vp, int vocab, int top_t,
                int blocks, float* part_v, int* part_i, float* vals, int* ids,
                cudaStream_t stream) {
  using S = Stage<T>;
  constexpr int kAlign = 16 / int(sizeof(T));    // 16 bytes, in elements
  const int tiles = (Vp + kTileV - 1) / kTileV;
  const bool k_major = ws0 == 1;
  const long long pitch = k_major ? ws1 : ws0;
  if (blocks < 1 || blocks > tiles || d % kAlign != 0 || pitch % kAlign != 0 ||
      (!k_major && ws1 != 1) || !aligned16(o) || !aligned16(w) ||
      (S::kF32 && (split == nullptr || !aligned16(split))))
    return cudaErrorInvalidValue;
  const void* o_hi = o;
  const void* o_lo = nullptr;
  if constexpr (S::kF32) {
    const long long n4 = (long long)N * d / 4;
    if (n4 > INT_MAX) return cudaErrorInvalidValue;
    float* hi = static_cast<float*>(split);
    o_hi = hi;
    o_lo = hi + (long long)N * d;
    split_o_kernel<<<int((n4 + 255) / 256), 256, 0, stream>>>(
        static_cast<const float4*>(o), reinterpret_cast<uint4*>(hi),
        reinterpret_cast<uint4*>(hi + (long long)N * d), int(n4));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  CUtensorMap o_map, o_lo_map, w_map;
  bool ok = encode_map<T>(&o_map, o_hi, d, N, d, S::kDepth, kTileRows,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
  if constexpr (S::kF32)
    ok = ok && encode_map<T>(&o_lo_map, o_lo, d, N, d, S::kDepth, kTileRows,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
  else
    o_lo_map = o_map;   // not read
  if (k_major)   // W^T (Vp, d): boxes of 128 lanes x kDepth of d
    ok = ok && encode_map<T>(&w_map, w, d, Vp, pitch, S::kDepth, kTileV,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  else           // W (d, Vp): boxes of kDepth of d x kDepth lanes
    ok = ok && encode_map<T>(&w_map, w, Vp, d, pitch, S::kDepth, S::kDepth,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (!ok) return cudaErrorInvalidValue;
  if (k_major)
    return launch<T, TT, false>(w_map, o_map, o_lo_map, N, d, vocab, top_t,
                                tiles, blocks, part_v, part_i, vals, ids,
                                stream);
  return launch<T, TT, true>(w_map, o_map, o_lo_map, N, d, vocab, top_t, tiles,
                             blocks, part_v, part_i, vals, ids, stream);
}

template <typename T>
cudaError_t run_top(const void* o, const void* w, void* split, long long ws0,
                    long long ws1, int N, int d, int Vp, int vocab, int top_t,
                    int blocks, float* pv, int* pi, float* vv, int* ii,
                    cudaStream_t s) {
  if (top_t == 1)
    return run<T, 1>(o, w, split, ws0, ws1, N, d, Vp, vocab, top_t, blocks,
                     pv, pi, vv, ii, s);
  return run<T, kMaxTopT>(o, w, split, ws0, ws1, N, d, Vp, vocab, top_t,
                          blocks, pv, pi, vv, ii, s);
}

}  // namespace tc

}  // namespace

// The wrapper (kernels/fused_heads.py) has checked shapes, dtypes, strides
// and alignment and allocated the (N, parts, top_t) scratch, parts being
// the persistent blocks (vocab_plan), and in fp32 the (2, N, d) scratch
// ``split`` for o's TF32 parts; this re-checks what would make the launch
// unsafe.
BPD_EXPORT int fused_heads_topk(const void* o, const void* w, void* split,
                                void* part_v, void* part_i, void* vals,
                                void* ids, long long ws0, long long ws1,
                                int dtype, int N, int d, int Vp, int vocab,
                                int top_t, int parts, void* stream) {
  if (N < 1 || d < 1 || ws0 < 1 || ws1 < 1 || top_t < 1 ||
      top_t > kMaxTopT || top_t > vocab || vocab > Vp ||
      (N + tc::kTileRows - 1) / tc::kTileRows > 65535)
    return cudaErrorInvalidValue;
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  float* vv = static_cast<float*>(vals);
  int* ii = static_cast<int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return tc::run_top<float>(o, w, split, ws0, ws1, N, d, Vp, vocab, top_t,
                              parts, pv, pi, vv, ii, s);
  if (dtype == kBFloat16)
    return tc::run_top<__nv_bfloat16>(o, w, split, ws0, ws1, N, d, Vp, vocab,
                                      top_t, parts, pv, pi, vv, ii, s);
  return cudaErrorInvalidValue;
}
