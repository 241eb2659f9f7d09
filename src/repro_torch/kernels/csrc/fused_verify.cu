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
// Design: one thread block per batch row, so the prefix scan never crosses
// blocks.  For each slot the block's threads stride over the vocab (adjacent
// threads on adjacent ids), each keeping a running top-T in registers; the
// per-thread lists are merged in shared memory by (value desc, id asc); one
// warp then runs the criterion compare and thread 0 the prefix scan.  The
// TPU kernel's vocab tiles and their lane padding do not carry over: every
// thread reads only ids < V.  B blocks (8 at the path's shape) use a few of
// the card's 132 SMs; splitting the vocab across blocks is later work.
#include "common.cuh"

#include <cmath>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxK = 32;
constexpr int kMaxTopT = 8;

template <typename T, int TT>
__global__ void __launch_bounds__(kThreads)
fused_verify_kernel(const T* __restrict__ logits, const int* __restrict__ props,
                    bool* __restrict__ acc_out, int* __restrict__ khat_out,
                    int* __restrict__ tok_out, int* __restrict__ nxt_out, int k,
                    int V, int top_t, int criterion, float epsilon) {
  __shared__ float sv[kThreads * TT];
  __shared__ int si[kThreads * TT];
  __shared__ int top_ids[kMaxK * kMaxTopT];  // [slot][top_t]
  __shared__ int ok_s[kMaxK];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int j = 0; j < k; ++j) {
    const T* row = logits + (size_t(b) * k + j) * V;
    TopT<TT> top;
    top.init();
    for (int i = tid; i < V; i += kThreads) top.insert(to_f32(row[i]), i);
    top.store(sv + tid * TT, si + tid * TT);
    block_merge_top<TT>(sv, si, kThreads);
    if (tid < top_t) top_ids[j * top_t + tid] = si[tid];
    __syncthreads();  // sv / si are rewritten for the next slot
  }

  // criterion compare: lane i checks proposal i against slot i - 1
  if (tid < k) {
    bool ok = true;
    if (tid > 0) {
      const int cand = props[b * k + tid];
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
      tok_out[b * k + i] = i < khat ? props[b * k + i] : 0;
    khat_out[b] = khat;
    nxt_out[b] = top_ids[(khat - 1) * top_t];
  }
}

template <typename T>
cudaError_t launch(const void* logits, const int* props, bool* acc, int* khat,
                   int* toks, int* nxt, int B, int k, int V, int top_t,
                   int criterion, float epsilon, cudaStream_t stream) {
  const T* lg = static_cast<const T*>(logits);
  if (top_t == 1)
    fused_verify_kernel<T, 1><<<B, kThreads, 0, stream>>>(
        lg, props, acc, khat, toks, nxt, k, V, top_t, criterion, epsilon);
  else
    fused_verify_kernel<T, kMaxTopT><<<B, kThreads, 0, stream>>>(
        lg, props, acc, khat, toks, nxt, k, V, top_t, criterion, epsilon);
  return cudaGetLastError();
}

}  // namespace

// The wrapper (kernels/fused_verify.py) has checked shapes, dtypes and
// contiguity; this re-checks what would make the launch unsafe.
BPD_EXPORT int fused_verify(const void* logits, const void* proposals,
                            void* accepts, void* khat, void* tokens,
                            void* next_greedy, int dtype, int B, int k, int V,
                            int top_t, int criterion, float epsilon,
                            void* stream) {
  if (B < 1 || k < 1 || k > kMaxK || top_t < 1 || top_t > kMaxTopT ||
      top_t > V || criterion < 0 || criterion > 2)
    return cudaErrorInvalidValue;
  const int* props = static_cast<const int*>(proposals);
  bool* acc = static_cast<bool*>(accepts);
  int* kh = static_cast<int*>(khat);
  int* toks = static_cast<int*>(tokens);
  int* nxt = static_cast<int*>(next_greedy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(logits, props, acc, kh, toks, nxt, B, k, V, top_t,
                         criterion, epsilon, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(logits, props, acc, kh, toks, nxt, B, k, V,
                                 top_t, criterion, epsilon, s);
  return cudaErrorInvalidValue;
}
