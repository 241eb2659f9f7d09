// RWKV-6 ("Finch") wkv scan from a zero state: the prefill's recurrence.
//
// Replaces repro/kernels/rwkv6_scan.py: rwkv6_scan_pallas
// (_rwkv6_chunk_kernel).  Same contract: r, k, v (B, S, H, D) in f32 or
// bf16, logw (B, S, H, D) f32 (the log-decay, <= 0) and u (H, D) f32 ->
// y (B, S, H, D) f32 and the final state (B, H, D, D) f32, where
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t,  y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),
// w_t = exp(logw_t) and S_0 = 0.
//
// What bounds it on an H100: reading r, k, v and logw once and writing y
// and the final state, 122 MB at the serve path's shape (bf16, B 8, S 512,
// H 32, D 64): 36 us at 3.35 TB/s.  Its 4·B·S·H·D² fp32 operations (2.1
// GFLOP there) need 32 us at 67 TFLOP/s, so bytes bound it, barely.
//
// Design: the TPU kernel's closed chunk form (cumulative decays, 1/a_s
// factors and the LOG_CLAMP midpoint renormalization, with the (D, D) state
// carried in VMEM across a sequential grid axis) is not used.  Blocks on the
// card run in no order, so the whole time loop runs inside one block per
// (b, h), and the block runs the oracle's own recurrence step by step: no
// clamp is needed, and strong decay stays exact.  Thread j owns column j
// of the state (D fp32 registers); column j evolves on its own.  Each step,
//   y_j = sum_i r_i S_ij + v_j (sum_i r_i u_i k_i),   S_ij <- w_i S_ij + k_i v_j;
// the bracket is shared by every j and computed once per step.  r, k, v and
// w = exp(logw) of 16 steps at a time are staged in shared memory, read
// once from device memory (coalesced: thread j loads channel j); a ragged
// last chunk stages fewer steps, so S needs no padding.  B·H blocks of D
// threads: 256 blocks of 64 at the serve shape.  The chunked closed form on
// wgmma, with TMA staging, is later work.
#include "common.cuh"

namespace {

constexpr int kChunk = 16;  // steps staged at a time (<= every D below)

template <typename T, int D>
__global__ void __launch_bounds__(D)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ logw,
                  const float* __restrict__ u, float* __restrict__ y,
                  float* __restrict__ state, int S, int H) {
  static_assert(kChunk <= D, "one thread computes each staged step's bonus");
  __shared__ __align__(16) float rs[kChunk][D];
  __shared__ __align__(16) float ks[kChunk][D];
  __shared__ __align__(16) float ws[kChunk][D];
  __shared__ float vs[kChunk][D];
  __shared__ float us[D];
  __shared__ float bonus[kChunk];

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int j = threadIdx.x;  // this thread's state column (and staged channel)
  const size_t step = size_t(H) * D;                  // from step t to t + 1
  const size_t base = (size_t(b) * S * H + h) * D;    // element (b, 0, h, 0)

  us[j] = u[h * D + j];
  float s[D];  // s[i] = S_ij
#pragma unroll
  for (int i = 0; i < D; ++i) s[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    __syncthreads();  // every read of the previous chunk is done
    for (int c = 0; c < n; ++c) {
      const size_t off = base + size_t(t0 + c) * step + j;
      rs[c][j] = to_f32(r[off]);
      ks[c][j] = to_f32(k[off]);
      vs[c][j] = to_f32(v[off]);
      ws[c][j] = expf(logw[off]);
    }
    __syncthreads();
    if (j < n) {  // thread j: the bonus bracket of staged step j
      float acc = 0.f;
      for (int i = 0; i < D; ++i) acc += rs[j][i] * us[i] * ks[j][i];
      bonus[j] = acc;
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = vs[c][j];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;  // four chains, not one
#pragma unroll
      for (int i = 0; i < D; i += 4) {
        a0 += rs[c][i] * s[i];
        a1 += rs[c][i + 1] * s[i + 1];
        a2 += rs[c][i + 2] * s[i + 2];
        a3 += rs[c][i + 3] * s[i + 3];
      }
      y[base + size_t(t0 + c) * step + j] = (a0 + a1) + (a2 + a3) + vj * bonus[c];
#pragma unroll
      for (int i = 0; i < D; ++i) s[i] = ws[c][i] * s[i] + ks[c][i] * vj;
    }
  }
  float* out = state + size_t(bh) * D * D;  // (b, h, i, j): coalesced over j
#pragma unroll
  for (int i = 0; i < D; ++i) out[i * D + j] = s[i];
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* logw, const float* u, float* y, float* state,
                   int B, int S, int H, int D, cudaStream_t stream) {
  const T* rr = static_cast<const T*>(r);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const dim3 grid(B * H);
  switch (D) {
    case 16:
      rwkv6_scan_kernel<T, 16><<<grid, 16, 0, stream>>>(rr, kk, vv, logw, u, y,
                                                          state, S, H);
      break;
    case 32:
      rwkv6_scan_kernel<T, 32><<<grid, 32, 0, stream>>>(rr, kk, vv, logw, u, y,
                                                          state, S, H);
      break;
    case 64:
      rwkv6_scan_kernel<T, 64><<<grid, 64, 0, stream>>>(rr, kk, vv, logw, u, y,
                                                          state, S, H);
      break;
    case 128:
      rwkv6_scan_kernel<T, 128><<<grid, 128, 0, stream>>>(rr, kk, vv, logw, u,
                                                            y, state, S, H);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// The wrapper (kernels/rwkv6_scan.py) has checked devices, shapes, dtypes
// and contiguity; this re-checks what would make the launch unsafe.
BPD_EXPORT int rwkv6_scan(const void* r, const void* k, const void* v,
                          const void* logw, const void* u, void* y,
                          void* state, int dtype, int B, int S, int H, int D,
                          void* stream) {
  if (B < 1 || S < 1 || H < 1 || size_t(B) * H > size_t(INT_MAX))
    return cudaErrorInvalidValue;
  const float* lw = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  float* yy = static_cast<float*>(y);
  float* st = static_cast<float*>(state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(r, k, v, lw, uu, yy, st, B, S, H, D, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(r, k, v, lw, uu, yy, st, B, S, H, D, s);
  return cudaErrorInvalidValue;
}
