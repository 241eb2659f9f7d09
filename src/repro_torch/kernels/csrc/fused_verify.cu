// One-pass BPD block verification (paper §3, §5.1, §5.2).
//
// Replaces repro/kernels/fused_verify.py: fused_verify_pallas
// (_fused_verify_kernel, epilogue _accept_scan).  Same contract: p1 logits
// (B, k, V) in f32 or bf16 (compared as f32), proposals (B, k) int32 ->
// accepts (B, k) bool, k̂ (B,), accepted tokens (B, k) (zero past k̂) and the
// greedy token at slot k̂ - 1 (B,), all int32.  Slot i - 1's top-T checks
// proposal i; criterion 0 exact, 1 topk (T = top_k), 2 distance (|id -
// greedy| <= epsilon).  Ties go to the lowest id.
//
// What bounds it on an H100: reading the logits once, B * k * V elements
// (6.3 MB in bf16 at B = 8, k = 8, V = 49408: 1.9 us at 3.35 TB/s).
//
// Design: one thread-block cluster per batch row, so the partials merge and
// the prefix scan runs on chip in the same launch.  Each (slot, range) of
// the row's k x R work items (R contiguous vocab ranges a slot:
// kernels/fused_verify.py: verify_plan, recomputed and checked here) goes
// to block item % cluster of the row's cluster.  A block reads its ranges
// with 16-byte loads, eight in flight a thread (a scalar head up to the
// first 16-byte boundary and a scalar tail: a row starts aligned only when
// V * elem is a multiple of 16), each thread keeping a running top-T in
// registers; warp shuffles merge the threads' lists into the item's
// partial, kept in shared memory.  After cluster.sync(), rank 0 reads every
// partial through distributed shared memory, merges each slot's R partials,
// runs the criterion compare and the prefix scan; a second cluster.sync()
// keeps the partials alive until it has.  Every list orders by (value
// desc, id asc), so the result does not depend on the plan.  At B 8, k 8:
// 8 clusters of 8 blocks, a slot's 49408 logits a block.
#include "common.cuh"

#include <cooperative_groups.h>

#include <cmath>
#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;         // 16-byte loads in flight a thread
constexpr int kMaxK = 32;
constexpr int kMaxTopT = 8;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kMaxRanges = 8;
constexpr int kMaxItems = kMaxK * kMaxRanges;   // a block's items, at most

// Every lane of the warp ends with the warp's top-TT (an xor butterfly:
// each round inserts the partner's list into one's own).
template <int TT>
__device__ __forceinline__ void warp_merge(TopT<TT>& top) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float pv[TT];
    int pi[TT];
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      pv[j] = __shfl_xor_sync(0xffffffffu, top.v[j], off);
      pi[j] = __shfl_xor_sync(0xffffffffu, top.i[j], off);
    }
#pragma unroll
    for (int j = 0; j < TT; ++j) top.insert(pv[j], pi[j]);
  }
}

// The values of a 16-byte vector (4 fp32 or 8 bf16), in id order.
template <typename T>
__device__ __forceinline__ void unpack(uint4 x, float (&f)[16 / sizeof(T)]);
template <>
__device__ __forceinline__ void unpack<float>(uint4 x, float (&f)[4]) {
  f[0] = __uint_as_float(x.x);
  f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z);
  f[3] = __uint_as_float(x.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(uint4 x, float (&f)[8]) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {   // bf16 -> f32 is the top half of the bits
    f[2 * e] = __uint_as_float(w[e] << 16);
    f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

// The top-TT of ids [lo, hi) of `row`, reduced over the block into every
// lane of warp 0.  Ends with a barrier (the warp scratch is free again).
template <typename T, int TT>
__device__ TopT<TT> range_top(const T* __restrict__ row, int lo, int hi,
                              float* wv, int* wi) {
  constexpr int kVec = 16 / sizeof(T);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(row + lo);
  const int head = min(hi - lo, int((16 - addr % 16) % 16 / sizeof(T)));
  const int a = lo + head;
  const int nvec = (hi - a) / kVec;
  const int tail = a + nvec * kVec;
  TopT<TT> top;
  top.init();
  if (tid < head) top.insert(to_f32(row[lo + tid]), lo + tid);
  const uint4* vp = reinterpret_cast<const uint4*>(row + a);
  for (int v0 = tid; v0 < nvec; v0 += kThreads * kUnroll) {
    uint4 buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int vi = v0 + u * kThreads;
      if (vi < nvec) buf[u] = __ldcs(vp + vi);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int vi = v0 + u * kThreads;
      if (vi < nvec) {
        float f[kVec];
        unpack<T>(buf[u], f);
#pragma unroll
        for (int e = 0; e < kVec; ++e) top.insert(f[e], a + vi * kVec + e);
      }
    }
  }
  if (tid < hi - tail) top.insert(to_f32(row[tail + tid]), tail + tid);

  warp_merge<TT>(top);
  if (lane == 0) top.store(wv + warp * TT, wi + warp * TT);
  __syncthreads();
  if (warp == 0) {
    top.init();
    if (lane < kWarps)
#pragma unroll
      for (int j = 0; j < TT; ++j) top.insert(wv[lane * TT + j], wi[lane * TT + j]);
    warp_merge<TT>(top);
  }
  __syncthreads();
  return top;
}

template <typename T, int TT>
__global__ void __launch_bounds__(kThreads)
fused_verify_kernel(const T* __restrict__ logits, const int* __restrict__ props,
                    bool* __restrict__ acc_out, int* __restrict__ khat_out,
                    int* __restrict__ tok_out, int* __restrict__ nxt_out, int k,
                    int V, int top_t, int criterion, float epsilon, int ranges) {
  __shared__ float part_v[kMaxItems * TT];   // this block's items' partials
  __shared__ int part_i[kMaxItems * TT];
  __shared__ float wv[kWarps * TT];
  __shared__ int wi[kWarps * TT];
  __shared__ int top_ids[kMaxK * kMaxTopT];  // rank 0: [slot][top_t]
  __shared__ int ok_s[kMaxK];
  __shared__ int props_s[kMaxK];             // rank 0: this row's proposals

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / csize;
  const int tid = threadIdx.x;
  // rank 0 fetches the proposals now, so their latency hides behind the loads
  if (rank == 0 && tid < k) props_s[tid] = props[b * k + tid];

  for (int item = rank, n = 0; item < k * ranges; item += csize, ++n) {
    const int slot = item / ranges, rg = item - slot * ranges;
    const int lo = int(int64_t(V) * rg / ranges);
    const int hi = int(int64_t(V) * (rg + 1) / ranges);
    const T* row = logits + (size_t(b) * k + slot) * V;
    const TopT<TT> top = range_top<T, TT>(row, lo, hi, wv, wi);
    if (tid == 0) top.store(part_v + n * TT, part_i + n * TT);
  }
  cluster.sync();   // every partial of the row is in its block's memory

  if (rank == 0) {
    if (tid < k) {   // thread j merges slot j's ranges, in range order
      TopT<TT> top;
      top.init();
      for (int rg = 0; rg < ranges; ++rg) {
        const int item = tid * ranges + rg;
        const float* pv = cluster.map_shared_rank(part_v, item % csize);
        const int* pi = cluster.map_shared_rank(part_i, item % csize);
        const int at = (item / csize) * TT;
        for (int t = 0; t < top_t; ++t) top.insert(pv[at + t], pi[at + t]);
      }
#pragma unroll
      for (int t = 0; t < TT; ++t)
        if (t < top_t) top_ids[tid * top_t + t] = top.i[t];
    }
    __syncthreads();

    // criterion compare: lane i checks proposal i against slot i - 1
    if (tid < k) {
      bool ok = true;
      if (tid > 0) {
        const int cand = props_s[tid];
        const int* ids = top_ids + (tid - 1) * top_t;
        if (criterion == 0) {
          ok = cand == ids[0];
        } else if (criterion == 1) {
          ok = false;
          for (int t = 0; t < top_t; ++t) ok = ok || cand == ids[t];
        } else {
          ok = float(abs(cand - ids[0])) <= epsilon;
        }
      }
      ok_s[tid] = ok;
      acc_out[b * k + tid] = ok;
    }
    __syncthreads();

    if (tid == 0) {
      int khat = k;
      for (int i = 1; i < k; ++i) {
        if (!ok_s[i]) {
          khat = i;
          break;
        }
      }
      for (int i = 0; i < k; ++i)
        tok_out[b * k + i] = i < khat ? props_s[i] : 0;
      khat_out[b] = khat;
      nxt_out[b] = top_ids[(khat - 1) * top_t];
    }
  }
  cluster.sync();   // no block leaves while rank 0 reads its partials
}

template <typename T, int TT>
cudaError_t launch_tt(const void* logits, const int* props, bool* acc, int* khat,
                      int* toks, int* nxt, int B, int k, int V, int top_t,
                      int criterion, float epsilon, int cluster, int ranges,
                      cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, fused_verify_kernel<T, TT>, static_cast<const T*>(logits), props,
      acc, khat, toks, nxt, k, V, top_t, criterion, epsilon, ranges);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* logits, const int* props, bool* acc, int* khat,
                   int* toks, int* nxt, int B, int k, int V, int top_t,
                   int criterion, float epsilon, int cluster, int ranges,
                   cudaStream_t stream) {
  if (top_t == 1)
    return launch_tt<T, 1>(logits, props, acc, khat, toks, nxt, B, k, V, top_t,
                           criterion, epsilon, cluster, ranges, stream);
  return launch_tt<T, kMaxTopT>(logits, props, acc, khat, toks, nxt, B, k, V,
                                top_t, criterion, epsilon, cluster, ranges,
                                stream);
}

}  // namespace

// The wrapper (kernels/fused_verify.py) has checked shapes, dtypes and
// contiguity and computed the plan; this re-checks what would make the
// launch unsafe, the plan's limits included (no empty range, no idle block).
BPD_EXPORT int fused_verify(const void* logits, const void* proposals,
                            void* accepts, void* khat, void* tokens,
                            void* next_greedy, int dtype, int B, int k, int V,
                            int top_t, int criterion, float epsilon,
                            int cluster, int ranges, void* stream) {
  if (B < 1 || k < 1 || k > kMaxK || top_t < 1 || top_t > kMaxTopT ||
      top_t > V || criterion < 0 || criterion > 2)
    return cudaErrorInvalidValue;
  if (cluster < 1 || cluster > kMaxCluster || ranges < 1 ||
      ranges > kMaxRanges || ranges > V || cluster > k * ranges)
    return cudaErrorInvalidValue;
  const int* props = static_cast<const int*>(proposals);
  bool* acc = static_cast<bool*>(accepts);
  int* kh = static_cast<int*>(khat);
  int* toks = static_cast<int*>(tokens);
  int* nxt = static_cast<int*>(next_greedy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(logits, props, acc, kh, toks, nxt, B, k, V, top_t,
                         criterion, epsilon, cluster, ranges, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(logits, props, acc, kh, toks, nxt, B, k, V,
                                 top_t, criterion, epsilon, cluster, ranges, s);
  return cudaErrorInvalidValue;
}
