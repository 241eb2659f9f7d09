// BPD heads' vocab projection with a running top-T; logits never written.
//
// Replaces repro/kernels/fused_heads.py: fused_heads_topk_pallas
// (_fused_heads_kernel).  Same contract: o (N, d) and w (d, Vp) in f32 or
// bf16 -> the top-T (value desc, id asc) of o @ w per row, accumulated in
// fp32, over lanes < vocab (lanes vocab..Vp are -1e30 and never win).  w is
// read through its strides, so the tied embedding table's transpose view
// (strides (1, d)) needs no copy.
//
// What bounds it on an H100: reading w once (405 MB in bf16 at d = 4096,
// Vp = 49408: 121 us at 3.35 TB/s).  Its 2 * N * d * Vp FLOPs (22.7 G at
// N = 56) run here on the fp32 FMA units, not the tensor cores, so this
// simple version is bound by operations, not bytes; tensor-core tiles
// (wgmma) and TMA loads are later work.
//
// Design: two passes, because thread blocks cannot carry a reduction
// across the grid the way the TPU's sequential vocab axis carries its VMEM
// top-T.  Pass 1: a block per (64-column vocab chunk, 64-row tile) loops over
// d in 32-deep steps, staging o and w tiles in shared memory and keeping a
// 4 x 4 register tile of fp32 sums per thread; it then writes each row's
// top-T over its chunk to scratch.  All N rows (56 on the path) fit one row
// tile, so w is read from device memory once per call; the small o (N x d)
// is re-read from L2 by every chunk.  The w tile is loaded along whichever
// of its axes is contiguous.  Pass 2: a block per row merges the chunks'
// lists.
#include "common.cuh"

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;      // rows per pass-1 tile
constexpr int kCols = 64;      // vocab columns per chunk (fused_heads.py: VOCAB_CHUNK)
constexpr int kDepth = 32;     // d per shared-memory step
constexpr int kMaxTopT = 8;
constexpr float kNegInf = -1e30f;

template <typename T, int TT>
__global__ void __launch_bounds__(kThreads)
chunk_topk_kernel(const T* __restrict__ o, const T* __restrict__ w,
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
      os[i][r] = (row < N && kk < d) ? to_f32(o[size_t(row) * d + kk]) : 0.f;
    }
    for (int e = tid; e < kCols * kDepth; e += kThreads) {
      int c, i;
      if (ws0 == 1) {          // d contiguous (tied table's transpose view)
        c = e / kDepth; i = e % kDepth;
      } else {                 // vocab contiguous
        i = e / kCols; c = e % kCols;
      }
      const int col = col0 + c, kk = k0 + i;
      wt[i][c] = (col < Vp && kk < d) ? to_f32(w[kk * ws0 + col * ws1]) : 0.f;
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
__global__ void __launch_bounds__(kThreads)
merge_topk_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                  int chunks, int top_t, float* __restrict__ vals,
                  int* __restrict__ ids) {
  __shared__ float sv[kThreads * TT];
  __shared__ int si[kThreads * TT];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = size_t(row) * chunks * top_t;
  TopT<TT> top;
  top.init();
  for (int e = tid; e < chunks * top_t; e += kThreads)
    top.insert(part_v[base + e], part_i[base + e]);
  top.store(sv + tid * TT, si + tid * TT);
  block_merge_top<TT>(sv, si, kThreads);
  if (tid < top_t) {
    vals[size_t(row) * top_t + tid] = sv[tid];
    ids[size_t(row) * top_t + tid] = si[tid];
  }
}

template <typename T, int TT>
cudaError_t launch_tt(const void* o, const void* w, float* part_v, int* part_i,
                      float* vals, int* ids, long long ws0, long long ws1, int N,
                      int d, int Vp, int vocab, int top_t, int chunks,
                      cudaStream_t stream) {
  dim3 grid(chunks, (N + kRows - 1) / kRows);
  chunk_topk_kernel<T, TT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(w), ws0, ws1, N, d, Vp,
      vocab, top_t, chunks, part_v, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_topk_kernel<TT><<<N, kThreads, 0, stream>>>(part_v, part_i, chunks,
                                                    top_t, vals, ids);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* o, const void* w, float* part_v, int* part_i,
                   float* vals, int* ids, long long ws0, long long ws1, int N,
                   int d, int Vp, int vocab, int top_t, int chunks,
                   cudaStream_t stream) {
  if (top_t == 1)
    return launch_tt<T, 1>(o, w, part_v, part_i, vals, ids, ws0, ws1, N, d,
                           Vp, vocab, top_t, chunks, stream);
  return launch_tt<T, kMaxTopT>(o, w, part_v, part_i, vals, ids, ws0, ws1, N,
                                d, Vp, vocab, top_t, chunks, stream);
}

}  // namespace

// The wrapper (kernels/fused_heads.py) has checked shapes, dtypes and
// strides and allocated the (N, chunks, top_t) scratch; this re-checks what
// would make the launch unsafe.
BPD_EXPORT int fused_heads_topk(const void* o, const void* w, void* part_v,
                                void* part_i, void* vals, void* ids,
                                long long ws0, long long ws1, int dtype, int N,
                                int d, int Vp, int vocab, int top_t, int chunks,
                                void* stream) {
  if (N < 1 || d < 1 || ws0 < 1 || ws1 < 1 || top_t < 1 ||
      top_t > kMaxTopT || top_t > vocab || vocab > Vp ||
      chunks != (Vp + kCols - 1) / kCols || (N + kRows - 1) / kRows > 65535)
    return cudaErrorInvalidValue;
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  float* vv = static_cast<float*>(vals);
  int* ii = static_cast<int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(o, w, pv, pi, vv, ii, ws0, ws1, N, d, Vp, vocab,
                         top_t, chunks, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(o, w, pv, pi, vv, ii, ws0, ws1, N, d, Vp,
                                 vocab, top_t, chunks, s);
  return cudaErrorInvalidValue;
}
