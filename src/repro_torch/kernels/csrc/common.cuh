// Shared helpers for the BPD kernels: dtype conversion, the (value desc,
// id asc) ordering every top-T uses, a block-wide merge of per-thread top-T
// lists, cp.async copies and the once-per-device shared-memory limit.  Lowest id wins ties, as jnp.argmax / lax.top_k
// (and the plain versions' argmax / stable sort) give.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>

#define BPD_EXPORT extern "C" __attribute__((visibility("default")))

// dtype codes passed from Python (kernels/*.py: DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// True when (va, ia) ranks strictly before (vb, ib).
__device__ __forceinline__ bool ranks_before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// A sorted running top-TT kept in registers (indices are compile-time after
// unrolling).  Empty entries are (-inf, INT_MAX): every real entry beats them.
template <int TT>
struct TopT {
  float v[TT];
  int i[TT];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      v[j] = -INFINITY;
      i[j] = INT_MAX;
    }
  }

  __device__ __forceinline__ void insert(float val, int id) {
    if (!ranks_before(val, id, v[TT - 1], i[TT - 1])) return;
    v[TT - 1] = val;
    i[TT - 1] = id;
#pragma unroll
    for (int j = TT - 1; j > 0; --j) {
      if (ranks_before(v[j], i[j], v[j - 1], i[j - 1])) {
        float tv = v[j]; v[j] = v[j - 1]; v[j - 1] = tv;
        int ti = i[j]; i[j] = i[j - 1]; i[j - 1] = ti;
      }
    }
  }

  __device__ __forceinline__ void store(float* sv, int* si) const {
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      sv[j] = v[j];
      si[j] = i[j];
    }
  }
};

// Merge the sorted TT-lists of threads [0, n) (n a power of two, n <=
// blockDim.x), stored at sv/si + thread * TT, into thread 0's list.
// Every thread of the block must call it; it ends with a barrier.
template <int TT>
__device__ void block_merge_top(float* sv, int* si, int n) {
  for (int stride = n / 2; stride > 0; stride >>= 1) {
    __syncthreads();
    const int t = threadIdx.x;
    if (t < stride) {
      float* av = sv + t * TT;
      int* ai = si + t * TT;
      const float* bv = sv + (t + stride) * TT;
      const int* bi = si + (t + stride) * TT;
      float mv[TT];
      int mi[TT];
      int a = 0, b = 0;
      for (int j = 0; j < TT; ++j) {  // a + b == j < TT: never past either list
        if (ranks_before(bv[b], bi[b], av[a], ai[a])) {
          mv[j] = bv[b]; mi[j] = bi[b]; ++b;
        } else {
          mv[j] = av[a]; mi[j] = ai[a]; ++a;
        }
      }
      for (int j = 0; j < TT; ++j) {
        av[j] = mv[j];
        ai[j] = mi[j];
      }
    }
  }
  __syncthreads();
}

// 16 bytes from device to shared memory, bypassing L1; zero-filled when
// !valid (the source is then not read, but must be a mapped address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Set a kernel's dynamic shared-memory limit once per device (the
// attribute belongs to the instantiation and the device, not the launch).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes,
                       std::atomic<unsigned long long>& configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << dev;
  if (configured.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) configured.fetch_or(bit);
  return err;
}

BPD_EXPORT const char* bpd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
