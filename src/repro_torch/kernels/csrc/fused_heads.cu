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
// byte bound, but 0.34 ms on the fp32 CUDA cores, which is where the first
// version of this kernel ran them.
//
// Design, bf16 (heads_tc_kernel):
//
// 1. Tensor cores with the vocab as M.  logits^T = W^T o^T: a tile of 128
//    vocab lanes is two m64 products of wgmma (m64n64k16, fp32
//    accumulation) and the N <= 64 rows of o (56 on the path, rows past N
//    zero) are the narrow N side.  One consumer warpgroup issues both
//    products straight from the shared-memory tiles (matrix descriptors,
//    no ldmatrix): 64 fp32 accumulators a thread.  The tied view (strides
//    (1, d)) is K-major (W^T's rows are the table's rows); rwkv6's untied
//    (d, Vp) row-major lm_head is M-major, read with wgmma's transpose bit.
//    wgmma and not mma.sync: the tensor work is a fifth of the byte bound,
//    but with mma.sync four warps (one per SM sub-partition) spent about
//    1,900 cycles on each 16 KB stage (ldmatrix and mma.sync latency, the
//    ring full 88% of the time: tools/trace_fused_heads.py on an H100),
//    twice the stage's share of the memory's rate; wgmma reads its operands
//    itself and runs asynchronously.
// 2. W streams through a TMA ring.  One producer thread loads each stage,
//    128 lanes x 64 of d of W (16 KB) and the matching 64 rows x 64 of o
//    (8 KB), by cp.async.bulk.tensor into a ring of 6 stages guarded by
//    full / empty mbarriers: up to 5 stages (80 KB of W) in flight per SM,
//    against the ~25 KB Little's law asks at 3.35 TB/s.  The 2-D tensor maps
//    are encoded on the host per call (cuTensorMapEncodeTiled, taken through
//    cudaGetDriverEntryPoint, so the library links no libcuda) and passed as
//    __grid_constant__ parameters.  Tiles land with the 128-byte swizzle in
//    1024-byte aligned stages, the layout wgmma's descriptors name (8-row or
//    8-k groups 1024 bytes apart), so its reads are free of bank conflicts.
//    TMA zero-fills past d, Vp and N.  The small o is read again from L2 for
//    every vocab tile: 386 tiles x 458 KB = 177 MB at granite's shape.
//    Tiles of 128 lanes keep the blocks' loads within 3% of even over 132
//    SMs (granite: 386 tiles, 2.92 a block; rwkv6: 512, 3.88); 256-lane
//    tiles would halve that L2 traffic but give blocks 1 or 2 tiles, 37%
//    uneven.
// 3. Persistent blocks carry the top-T, as the TPU carries it along its
//    sequential vocab axis.  min(tiles, SMs) blocks per 64-row tile of o;
//    block i walks tiles [i * tiles / blocks, (i + 1) * tiles / blocks) in
//    order.  After a tile's d loop the consumers write its fp32 logits
//    (64 x 128) into shared memory, and thread (row, half) folds every
//    second lane < vocab of its row into a running top-T in registers
//    (TopT<1>, or TopT<8>: 16 registers), while the producer already loads
//    the next tile's stages.  At the end each row's two halves merge and the
//    block writes one partial per row; a second kernel merges the blocks'
//    partials (132 x T a row at the path's shape).
//
// fp32 keeps the first version's CUDA-core body (chunk_topk_kernel; no TF32,
// the fp32 decode gates hold the card to the reference): blocks of 64 vocab
// columns x 64 rows, 32-deep steps of d through shared memory, a 4 x 4
// register tile of FMAs per thread, a top-T per (chunk, row), then the same
// merge.
#include "common.cuh"

#include <cuda.h>   // CUtensorMap and its enums (types only: no libcuda link)

#include <atomic>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxTopT = 8;
constexpr float kNegInf = -1e30f;
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
// fp32: CUDA-core FMAs, w read through any strides
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kThreads = 256;
constexpr int kRows = 64;      // rows per tile
constexpr int kCols = 64;      // vocab columns per chunk (fused_heads.py: VOCAB_CHUNK)
constexpr int kDepth = 32;     // d per shared-memory step

template <int TT>
__global__ void __launch_bounds__(kThreads)
chunk_topk_kernel(const float* __restrict__ o, const float* __restrict__ w,
                  long long ws0, long long ws1, int N, int d, int Vp,
                  int vocab, int top_t, int chunks, float* __restrict__ part_v,
                  int* __restrict__ part_i) {
  __shared__ float os[kDepth][kRows + 1];
  __shared__ float wt[kDepth][kCols + 1];
  __shared__ float lg[kRows][kCols + 1];

  const int chunk = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int col0 = chunk * kCols;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // rows ty + 16 r, cols tx + 16 c

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kDepth) {
    for (int e = tid; e < kRows * kDepth; e += kThreads) {
      const int r = e / kDepth, i = e % kDepth;
      const int row = row0 + r, kk = k0 + i;
      os[i][r] = (row < N && kk < d) ? o[size_t(row) * d + kk] : 0.f;
    }
    for (int e = tid; e < kCols * kDepth; e += kThreads) {
      int c, i;
      if (ws0 == 1) {          // d contiguous (tied table's transpose view)
        c = e / kDepth; i = e % kDepth;
      } else {                 // vocab contiguous
        i = e / kCols; c = e % kCols;
      }
      const int col = col0 + c, kk = k0 + i;
      wt[i][c] = (col < Vp && kk < d) ? w[kk * ws0 + col * ws1] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kDepth; ++i) {
      float a[4], bw[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = os[i][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bw[c] = wt[i][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bw[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      lg[ty + 16 * r][tx + 16 * c] =
          col0 + tx + 16 * c < vocab ? acc[r][c] : kNegInf;
  __syncthreads();

  if (tid < kRows && row0 + tid < N) {
    TopT<TT> top;
    top.init();
    for (int c = 0; c < kCols && col0 + c < Vp; ++c) top.insert(lg[tid][c], col0 + c);
    const size_t base = (size_t(row0 + tid) * chunks + chunk) * top_t;
    for (int t = 0; t < top_t; ++t) {
      part_v[base + t] = top.v[t];
      part_i[base + t] = top.i[t];
    }
  }
}

template <int TT>
cudaError_t launch(const float* o, const float* w, float* part_v, int* part_i,
                   float* vals, int* ids, long long ws0, long long ws1, int N,
                   int d, int Vp, int vocab, int top_t, int chunks,
                   cudaStream_t stream) {
  dim3 grid(chunks, (N + kRows - 1) / kRows);
  chunk_topk_kernel<TT><<<grid, kThreads, 0, stream>>>(
      o, w, ws0, ws1, N, d, Vp, vocab, top_t, chunks, part_v, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_topk_kernel<TT><<<N, kMergeThreads, 0, stream>>>(part_v, part_i, chunks,
                                                         top_t, vals, ids);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: tensor cores fed by a TMA ring, persistent blocks carrying the top-T
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kConsumerWarps = 4;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;        // + one producer warp
constexpr int kTileV = 128;     // vocab lanes per tile (fused_heads.py: VOCAB_TILE)
constexpr int kTileRows = 64;   // rows of o per block: the products' N
constexpr int kDepth = 64;      // d per stage: one 128-byte swizzled row
constexpr int kStages = 6;
constexpr int kWBytes = kTileV * kDepth * 2;     // 16 KB
constexpr int kOBytes = kTileRows * kDepth * 2;  // 8 KB
constexpr int kStageBytes = kWBytes + kOBytes;   // a multiple of 1024
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kLgLd = kTileV + 2;                // fold reads conflict-free
constexpr int kLgBytes = int(sizeof(float)) * kTileRows * kLgLd;
constexpr int kSmemBytes = 1024 + kRingBytes + kLgBytes + 2 * 8 * kStages;

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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}
// kRowMajor: w is (d, Vp) with the vocab contiguous (a stage's W is two
// [64 of d][64 lanes] boxes); else w's transpose is (Vp, d) with d
// contiguous (a stage's W is one [128 lanes][64 of d] box).
template <int TT, bool kRowMajor>
__global__ void __launch_bounds__(kThreads, 1)
heads_tc_kernel(const __grid_constant__ CUtensorMap w_map,
                const __grid_constant__ CUtensorMap o_map, int N, int d,
                int vocab, int top_t, int tiles, float* __restrict__ part_v,
                int* __restrict__ part_i) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;      // [kStages][W | o]
  float* lg = reinterpret_cast<float*>(smem_raw + (ring - raw) + kRingBytes);
  const uint32_t full0 = ring + kRingBytes + kLgBytes;  // kStages mbarriers
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
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: one thread keeps the ring full ----------------------
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        for (int ks = 0; ks < ksteps; ++ks) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1u);
          const uint32_t dst = ring + stage * kStageBytes;
          const uint32_t bar = full0 + 8 * stage;
          mbar_expect_tx(bar, kStageBytes);
          const int k0 = ks * kDepth, v0 = t * kTileV;
          if constexpr (kRowMajor) {
            tma_load_2d(dst, &w_map, bar, v0, k0);
            tma_load_2d(dst + kWBytes / 2, &w_map, bar, v0 + kTileV / 2, k0);
          } else {
            tma_load_2d(dst, &w_map, bar, k0, v0);
          }
          tma_load_2d(dst + kWBytes, &o_map, bar, k0, row0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: one warpgroup of wgmma products, then the fold -------
  const int g = lane >> 2, t4 = lane & 3;
  const int rows = min(kTileRows, N - row0);
  const int frow = tid >> 1, fhalf = tid & 1;    // the fold's row and lanes
  TopT<TT> top;
  top.init();
  int stage = 0;
  uint32_t phase = 0;
  for (int t = t_begin; t < t_end; ++t) {
    float acc[2][32];                            // lanes 64h .. 64h + 63
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;

    for (int ks = 0; ks < ksteps; ++ks) {
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t sw = ring + stage * kStageBytes;
      const uint32_t so = sw + kWBytes;
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kDepth / 16; ++kc) {
        const uint64_t b = smem_desc(so + kc * 32);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // K-major: 16 of d are 32 bytes along each lane's row; M-major:
          // 16 rows of d are two 1024-byte swizzle atoms
          const uint32_t a = sw + h * (kWBytes / 2) +
                             (kRowMajor ? kc * 2048 : kc * 32);
          wgmma_m64n64k16<kRowMajor>(acc[h], smem_desc(a), b);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);   // the stage may refill
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1u;
      }
    }

    // the tile's logits into shared memory, [row][lane] (the accumulator
    // layout of wgmma: warp w holds rows 16w .. 16w + 15 of each m64 tile)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int m = 64 * h + 16 * warp + g + 8 * ((i >> 1) & 1);
        const int n = 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (n < rows) lg[n * kLgLd + m] = acc[h][i];
      }
    consumer_sync();
    // fold: thread (row, half) takes lanes half, half + 2, ... below vocab
    if (frow < rows) {
      const int v0 = t * kTileV;
      const int m_end = min(kTileV, vocab - v0);
      for (int m = fhalf; m < m_end; m += 2)
        top.insert(lg[frow * kLgLd + m], v0 + m);
    }
    consumer_sync();   // lg is free for the next tile
  }

  // each row's two halves merge into the block's partial for that row
  float* sv = lg;
  int* si = reinterpret_cast<int*>(lg + kConsumers * TT);
  top.store(sv + tid * TT, si + tid * TT);
  consumer_sync();
  if (fhalf == 0 && frow < rows) {
    const float* av = sv + tid * TT;
    const int* ai = si + tid * TT;
    const float* bv = av + TT;
    const int* bi = ai + TT;
    const size_t base = (size_t(row0 + frow) * blocks + blockIdx.x) * top_t;
    int a = 0, b = 0;
    for (int j = 0; j < top_t; ++j) {   // a + b == j < top_t <= TT
      if (ranks_before(bv[b], bi[b], av[a], ai[a])) {
        part_v[base + j] = bv[b];
        part_i[base + j] = bi[b];
        ++b;
      } else {
        part_v[base + j] = av[a];
        part_i[base + j] = ai[a];
        ++a;
      }
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

// A bf16 (outer, inner) matrix, ``pitch`` elements between rows, cut in
// (box_outer, box_inner) boxes of 128-byte rows, swizzled, zero past its
// edges.
bool encode_map(CUtensorMap* map, const void* ptr, long long inner,
                long long outer, long long pitch, int box_inner, int box_outer,
                CUtensorMapL2promotion l2) {
  static const EncodeTiled encode = lookup_encode();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(inner), cuuint64_t(outer)};
  const cuuint64_t strides[1] = {cuuint64_t(pitch) * 2};
  const cuuint32_t box[2] = {cuuint32_t(box_inner), cuuint32_t(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, l2,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int TT, bool kRowMajor>
cudaError_t launch(const CUtensorMap& w_map, const CUtensorMap& o_map, int N,
                   int d, int vocab, int top_t, int tiles, int blocks,
                   float* part_v, int* part_i, float* vals, int* ids,
                   cudaStream_t stream) {
  auto kernel = heads_tc_kernel<TT, kRowMajor>;
  static std::atomic<unsigned long long> configured{0};
  cudaError_t err = allow_smem(kernel, kSmemBytes, configured);
  if (err != cudaSuccess) return err;
  dim3 grid(blocks, (N + kTileRows - 1) / kTileRows);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(w_map, o_map, N, d, vocab,
                                                 top_t, tiles, part_v, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_topk_kernel<TT><<<N, kMergeThreads, 0, stream>>>(part_v, part_i, blocks,
                                                         top_t, vals, ids);
  return cudaGetLastError();
}

template <int TT>
cudaError_t run(const void* o, const void* w, long long ws0, long long ws1,
                int N, int d, int Vp, int vocab, int top_t, int blocks,
                float* part_v, int* part_i, float* vals, int* ids,
                cudaStream_t stream) {
  const int tiles = (Vp + kTileV - 1) / kTileV;
  const bool k_major = ws0 == 1;
  const long long pitch = k_major ? ws1 : ws0;
  if (blocks < 1 || blocks > tiles || d % 8 != 0 || pitch % 8 != 0 ||
      (!k_major && ws1 != 1) ||
      reinterpret_cast<uintptr_t>(o) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap o_map, w_map;
  bool ok = encode_map(&o_map, o, d, N, d, kDepth, kTileRows,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
  if (k_major)   // W^T (Vp, d): boxes of 128 lanes x 64 of d
    ok = ok && encode_map(&w_map, w, d, Vp, pitch, kDepth, kTileV,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  else           // W (d, Vp): boxes of 64 of d x 64 lanes
    ok = ok && encode_map(&w_map, w, Vp, d, pitch, kTileV / 2, kDepth,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (!ok) return cudaErrorInvalidValue;
  if (k_major)
    return launch<TT, false>(w_map, o_map, N, d, vocab, top_t, tiles, blocks,
                             part_v, part_i, vals, ids, stream);
  return launch<TT, true>(w_map, o_map, N, d, vocab, top_t, tiles, blocks,
                          part_v, part_i, vals, ids, stream);
}

}  // namespace tc

}  // namespace

// The wrapper (kernels/fused_heads.py) has checked shapes, dtypes, strides
// and alignment and allocated the (N, parts, top_t) scratch: parts is the
// fp32 body's vocab chunks, or the bf16 body's persistent blocks
// (vocab_plan); this re-checks what would make the launch unsafe.
BPD_EXPORT int fused_heads_topk(const void* o, const void* w, void* part_v,
                                void* part_i, void* vals, void* ids,
                                long long ws0, long long ws1, int dtype, int N,
                                int d, int Vp, int vocab, int top_t, int parts,
                                void* stream) {
  if (N < 1 || d < 1 || ws0 < 1 || ws1 < 1 || top_t < 1 ||
      top_t > kMaxTopT || top_t > vocab || vocab > Vp)
    return cudaErrorInvalidValue;
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  float* vv = static_cast<float*>(vals);
  int* ii = static_cast<int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    if (parts != (Vp + f32::kCols - 1) / f32::kCols ||
        (N + f32::kRows - 1) / f32::kRows > 65535)
      return cudaErrorInvalidValue;
    const float* of = static_cast<const float*>(o);
    const float* wf = static_cast<const float*>(w);
    if (top_t == 1)
      return f32::launch<1>(of, wf, pv, pi, vv, ii, ws0, ws1, N, d, Vp, vocab,
                            top_t, parts, s);
    return f32::launch<kMaxTopT>(of, wf, pv, pi, vv, ii, ws0, ws1, N, d, Vp,
                                 vocab, top_t, parts, s);
  }
  if (dtype != kBFloat16 || (N + tc::kTileRows - 1) / tc::kTileRows > 65535)
    return cudaErrorInvalidValue;
  if (top_t == 1)
    return tc::run<1>(o, w, ws0, ws1, N, d, Vp, vocab, top_t, parts, pv, pi,
                      vv, ii, s);
  return tc::run<kMaxTopT>(o, w, ws0, ws1, N, d, Vp, vocab, top_t, parts, pv,
                           pi, vv, ii, s);
}
