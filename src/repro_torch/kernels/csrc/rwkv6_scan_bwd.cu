// RWKV-6 wkv scan, backward: the reverse scan from per-chunk states.
//
// Replaces no TPU kernel.  The reference trains through its jnp scan
// (repro/models/rwkv6.py:90 _wkv_scan: chunks of 128 steps under
// jax.checkpoint) and XLA differentiates it; its Pallas kernel
// (rwkv6_scan_pallas) has no backward.  This is the gradient of the
// forward kernel (csrc/rwkv6_scan.cu), which on the training path also
// writes the state at the start of every chunk of C steps.
//
// Contract: r, k, v (B, S, H, D) f32 or bf16, logw (B, S, H, D) f32, u
// (H, D) f32, the checkpoints (B, H, ceil(S / C), D, D) f32, dy (B, S, H, D)
// f32 and dstate (B, H, D, D) f32 or null (zeros) -> dr, dk, dv, dlogw
// (B, S, H, D) f32 and du's partial (B, H, D) f32, which the wrapper sums
// over B.  With w = exp(logw), dS = dL/dS_t carried from the future and
// dS = dstate after the last step, each step t, last first:
//   dr_t[i]    = sum_j dy_t[j] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
//   dk_t[i]    = sum_j dS[i,j] v_t[j] + u[i] r_t[i] (dy_t . v_t)
//   dv_t[j]    = sum_i dS[i,j] k_t[i] + (sum_i r_t[i] u[i] k_t[i]) dy_t[j]
//   dlogw_t[i] = w_t[i] sum_j dS[i,j] S_{t-1}[i,j]
//   du[i]     += r_t[i] k_t[i] (dy_t . v_t)
//   dS        <- diag(w_t) dS + r_t^T dy_t.
// The forward floors a step's logw at kLogwFloor (-16); the states here
// are recomputed with the same floor, and dS is carried with the floored
// decay.  dlogw is the unfloored recurrence's, exp(logw) times the sum,
// also below the floor (the floored function's derivative there is 0):
// both lie below e^-16 times the sum, within the tolerance of the plain
// version (kernels/ref.py: rwkv6_scan_bwd, which floors nothing).
//
// What bounds it on an H100: reading r, k, v, logw, dy and the checkpoints
// and writing the four gradients, about 215 MB at rwkv6-1.6b's training
// shape (fp32, B 4, S 512, H 32, D 64, C 16): 64 us at 3.35 TB/s; its
// about 12 B S H D^2 fp32 operations (the recomputed forward and the
// backward, 3.2 GFLOP there) need 48 us at 67 TFLOP/s.  So bytes bound it.
//
// Design: simple and right first, fp32 on the CUDA cores (no tensor
// cores: the chunked closed form on mma.sync / wgmma is later work).  One
// block per (b, h), 4 D threads: a quad of threads per state row i, thread
// q of the quad holding columns j = q + 4 m (m < D / 4) of that row, in
// registers for dS.  The block walks the chunks last first.  A chunk's
// states S_{t-1} are recomputed from its checkpoint into a global scratch
// that the wrapper allocates (C D^2 floats a block; each thread reads back
// only what it wrote, coalesced across the block), then the chunk is
// walked backwards a tile of 16 steps at a time, the tile's inputs staged
// in shared memory.  A step's row sums (dr, dk, dlogw) close inside the
// quad by shuffles; its column sums (dv) close over the warp's 8 rows by a
// reduce-scatter of shuffles and over the warps through shared memory,
// once a tile, with the bonus terms.  No barrier inside a tile's walk.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int kTile = 16;          // steps staged and reduced together
constexpr float kLogwFloor = -16.f;

template <int D>
struct Bwd {
  static constexpr int kThreads = 4 * D;
  static constexpr int kWarps = kThreads / 32;   // 8 rows a warp
  static constexpr int kM = D / 4;               // columns a thread
  static constexpr int kHeld = kM >= 8 ? kM / 8 : 1;   // dv sums a lane keeps
  // shared memory, in floats: the tile's inputs [kTile][D] (r, k, v, the
  // floored decay, logw, dy), then its row sums [kTile][D] (dr, dk,
  // dlogw), the warps' column sums [kTile][kWarps][D], u, and two scalars
  // a step (dy . v, sum_i r u k)
  static constexpr int kR = 0, kK = kR + kTile * D, kV = kK + kTile * D;
  static constexpr int kW = kV + kTile * D, kLw = kW + kTile * D;
  static constexpr int kDy = kLw + kTile * D;
  static constexpr int kDr = kDy + kTile * D, kDk = kDr + kTile * D;
  static constexpr int kDlw = kDk + kTile * D, kDvp = kDlw + kTile * D;
  static constexpr int kU = kDvp + kTile * kWarps * D;
  static constexpr int kDyv = kU + D, kRuk = kDyv + kTile;
  static constexpr int kFloats = kRuk + kTile;
  static constexpr int kBytes = 4 * kFloats;
  static_assert(kBytes <= 232448, "shared memory of one block");
};

// Stage steps [t0, t0 + n) of a tile (n <= kTile) into shared memory,
// rows past n zero (w = 1).  kAll: r, logw and dy too (the walk); else
// only k, v and the decay (the recompute).
template <typename T, int D, bool kAll>
__device__ __forceinline__ void stage(float* sm, const T* r, const T* k,
                                      const T* v, const float* logw,
                                      const float* dy, size_t base, size_t step,
                                      int t0, int n) {
  using L = Bwd<D>;
  for (int e = threadIdx.x; e < kTile * D; e += L::kThreads) {
    const int p = e / D, x = e - p * D;
    const bool in = p < n;
    const size_t g = base + size_t(t0 + (in ? p : 0)) * step + x;
    const float lw = in ? logw[g] : 0.f;
    sm[L::kK + e] = in ? to_f32(k[g]) : 0.f;
    sm[L::kV + e] = in ? to_f32(v[g]) : 0.f;
    sm[L::kW + e] = expf(fmaxf(lw, kLogwFloor));
    if (kAll) {
      sm[L::kR + e] = in ? to_f32(r[g]) : 0.f;
      sm[L::kLw + e] = lw;
      sm[L::kDy + e] = in ? dy[g] : 0.f;
    }
  }
}

// a[m] summed over the warp's 8 rows (lane bits 2-4), scattered: lane
// keeps a[0, kHeld), the sums of m = m' + (b4 ? kM/2 : 0) + (b3 ? kM/4 :
// 0) + (b2 ? kM/8 : 0) (for kM 4, b2's lanes both hold m = (b4 ? 2 : 0) +
// (b3 ? 1 : 0)).
template <int kM>
__device__ __forceinline__ void rows_reduce_scatter(float (&a)[kM], int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  {
    const bool up = lane & 16;
#pragma unroll
    for (int m = 0; m < kM / 2; ++m) {
      const float send = up ? a[m] : a[m + kM / 2];
      const float keep = up ? a[m + kM / 2] : a[m];
      a[m] = keep + __shfl_xor_sync(kAll, send, 16);
    }
  }
  {
    const bool up = lane & 8;
#pragma unroll
    for (int m = 0; m < kM / 4; ++m) {
      const float send = up ? a[m] : a[m + kM / 4];
      const float keep = up ? a[m + kM / 4] : a[m];
      a[m] = keep + __shfl_xor_sync(kAll, send, 8);
    }
  }
  if constexpr (kM >= 8) {
    const bool up = lane & 4;
#pragma unroll
    for (int m = 0; m < kM / 8; ++m) {
      const float send = up ? a[m] : a[m + kM / 8];
      const float keep = up ? a[m + kM / 8] : a[m];
      a[m] = keep + __shfl_xor_sync(kAll, send, 4);
    }
  } else {
    a[0] += __shfl_xor_sync(kAll, a[0], 4);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Bwd<D>::kThreads)
rwkv6_scan_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ logw,
                      const float* __restrict__ u,
                      const float* __restrict__ ckpt,
                      const float* __restrict__ dy,
                      const float* __restrict__ dstate, float* __restrict__ dr,
                      float* __restrict__ dk, float* __restrict__ dv,
                      float* __restrict__ dlogw, float* __restrict__ du_part,
                      float* __restrict__ scratch, int S, int H, int C) {
  using L = Bwd<D>;
  constexpr int kM = L::kM;
  extern __shared__ __align__(16) float sm[];
  const int bh = blockIdx.x;   // b * H + h
  const int h = bh % H;
  const int b = bh / H;
  const size_t step = size_t(H) * D;                 // from step t to t + 1
  const size_t base = (size_t(b) * S * H + h) * D;   // element (b, 0, h, 0)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid >> 2, q = tid & 3;               // row i, columns q + 4 m
  const int nchunks = (S + C - 1) / C;
  float* scr = scratch + size_t(bh) * C * D * D;     // [pos][m][thread]

  for (int e = tid; e < D; e += L::kThreads) sm[L::kU + e] = u[h * D + e];
  float ds[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m)
    ds[m] = dstate ? dstate[(size_t(bh) * D + i) * D + q + 4 * m] : 0.f;
  float du_acc = 0.f;

  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * C;
    const int n = min(C, S - t0);
    const int tiles = (n + kTile - 1) / kTile;

    // ---- the chunk's states S_{t-1}, from its checkpoint, into scratch --
    float st[kM];
    const float* ck = ckpt + ((size_t(bh) * nchunks + c) * D + i) * D + q;
#pragma unroll
    for (int m = 0; m < kM; ++m) st[m] = ck[4 * m];
    for (int tt = 0; tt < tiles; ++tt) {
      const int np = min(kTile, n - tt * kTile);
      __syncthreads();   // the last readers of the staged arrays are done
      stage<T, D, false>(sm, r, k, v, logw, dy, base, step, t0 + tt * kTile, np);
      __syncthreads();
      for (int p = 0; p < np; ++p) {
        const float* sk = sm + L::kK + p * D;
        const float* sv = sm + L::kV + p * D;
        const float wi = sm[L::kW + p * D + i], ki = sk[i];
        float* out = scr + size_t(tt * kTile + p) * kM * L::kThreads + tid;
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          out[m * L::kThreads] = st[m];
          st[m] = fmaf(wi, st[m], ki * sv[q + 4 * m]);
        }
      }
    }

    // ---- the chunk's steps backwards, a tile at a time ------------------
    for (int tt = tiles - 1; tt >= 0; --tt) {
      const int np = min(kTile, n - tt * kTile);
      const int ts = t0 + tt * kTile;
      __syncthreads();   // the last tile's sums are written out
      stage<T, D, true>(sm, r, k, v, logw, dy, base, step, ts, np);
      __syncthreads();
      // the step scalars dy . v and sum_i r u k, a warp a step
      for (int p = warp; p < kTile; p += L::kWarps) {
        float a = 0.f, s2 = 0.f;
        for (int x = lane; x < D; x += 32) {
          a = fmaf(sm[L::kDy + p * D + x], sm[L::kV + p * D + x], a);
          s2 = fmaf(sm[L::kR + p * D + x] * sm[L::kU + x], sm[L::kK + p * D + x], s2);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          a += __shfl_xor_sync(0xffffffffu, a, o);
          s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        }
        if (lane == 0) {
          sm[L::kDyv + p] = a;
          sm[L::kRuk + p] = s2;
        }
      }
      for (int p = np - 1; p >= 0; --p) {
        const float* sv = sm + L::kV + p * D;
        const float* sdy = sm + L::kDy + p * D;
        const float wi = sm[L::kW + p * D + i];
        const float ki = sm[L::kK + p * D + i];
        const float ri = sm[L::kR + p * D + i];
        const float* in = scr + size_t(tt * kTile + p) * kM * L::kThreads + tid;
        float a_dr = 0.f, a_dk = 0.f, a_dlw = 0.f, col[kM];
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          const float sp = in[m * L::kThreads];
          const float dyj = sdy[q + 4 * m];
          a_dr = fmaf(dyj, sp, a_dr);
          a_dk = fmaf(ds[m], sv[q + 4 * m], a_dk);
          a_dlw = fmaf(ds[m], sp, a_dlw);
          col[m] = ds[m] * ki;
          ds[m] = fmaf(wi, ds[m], ri * dyj);
        }
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          a_dr += __shfl_xor_sync(0xffffffffu, a_dr, o);
          a_dk += __shfl_xor_sync(0xffffffffu, a_dk, o);
          a_dlw += __shfl_xor_sync(0xffffffffu, a_dlw, o);
        }
        if (q == 0) {
          sm[L::kDr + p * D + i] = a_dr;
          sm[L::kDk + p * D + i] = a_dk;
          sm[L::kDlw + p * D + i] = a_dlw;
        }
        rows_reduce_scatter<kM>(col, lane);
        if (kM >= 8 || !(lane & 4)) {
          const int off = ((lane & 16) ? kM / 2 : 0) + ((lane & 8) ? kM / 4 : 0) +
                          (kM >= 8 && (lane & 4) ? kM / 8 : 0);
          float* dvp = sm + L::kDvp + (p * L::kWarps + warp) * D;
#pragma unroll
          for (int m = 0; m < L::kHeld; ++m) dvp[q + 4 * (off + m)] = col[m];
        }
      }
      __syncthreads();
      // the tile's gradients, with the bonus terms, written out
      for (int e = tid; e < np * D; e += L::kThreads) {
        const int p = e / D, x = e - p * D;
        const float dyv = sm[L::kDyv + p];
        float dvx = sm[L::kRuk + p] * sm[L::kDy + e];
#pragma unroll
        for (int w = 0; w < L::kWarps; ++w) dvx += sm[L::kDvp + (p * L::kWarps + w) * D + x];
        const size_t g = base + size_t(ts + p) * step + x;
        dr[g] = sm[L::kDr + e] + sm[L::kU + x] * sm[L::kK + e] * dyv;
        dk[g] = sm[L::kDk + e] + sm[L::kU + x] * sm[L::kR + e] * dyv;
        dv[g] = dvx;
        dlogw[g] = expf(sm[L::kLw + e]) * sm[L::kDlw + e];
      }
      if (q == 0) {
        for (int p = 0; p < np; ++p)
          du_acc = fmaf(sm[L::kR + p * D + i] * sm[L::kK + p * D + i],
                        sm[L::kDyv + p], du_acc);
      }
    }
  }
  if (q == 0) du_part[size_t(bh) * D + i] = du_acc;
}

template <typename T, int D>
cudaError_t launch_d(const void* r, const void* k, const void* v,
                     const float* logw, const float* u, const float* ckpt,
                     const float* dy, const float* dstate, float* dr, float* dk,
                     float* dv, float* dlogw, float* du_part, float* scratch,
                     int B, int S, int H, int C, cudaStream_t stream) {
  using L = Bwd<D>;
  auto kernel = rwkv6_scan_bwd_kernel<T, D>;
  static std::atomic<unsigned long long> configured{0};
  cudaError_t err = allow_smem(kernel, L::kBytes, configured);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, L::kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, ckpt, dy, dstate, dr, dk, dv, dlogw,
      du_part, scratch, S, H, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* logw, const float* u, const float* ckpt,
                   const float* dy, const float* dstate, float* dr, float* dk,
                   float* dv, float* dlogw, float* du_part, float* scratch,
                   int B, int S, int H, int D, int C, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_d<T, 16>(r, k, v, logw, u, ckpt, dy, dstate, dr, dk, dv, dlogw, du_part, scratch, B, S, H, C, stream);
    case 32: return launch_d<T, 32>(r, k, v, logw, u, ckpt, dy, dstate, dr, dk, dv, dlogw, du_part, scratch, B, S, H, C, stream);
    case 64: return launch_d<T, 64>(r, k, v, logw, u, ckpt, dy, dstate, dr, dk, dv, dlogw, du_part, scratch, B, S, H, C, stream);
    case 128: return launch_d<T, 128>(r, k, v, logw, u, ckpt, dy, dstate, dr, dk, dv, dlogw, du_part, scratch, B, S, H, C, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The wrapper (kernels/rwkv6_scan.py: rwkv6_scan_bwd_cuda) has checked
// devices, shapes, dtypes and contiguity, and allocated the outputs and
// the scratch (B H C D^2 floats); this re-checks what would make the launch
// unsafe.  dstate may be null.
BPD_EXPORT int rwkv6_scan_bwd(const void* r, const void* k, const void* v,
                              const void* logw, const void* u, const void* ckpt,
                              const void* dy, const void* dstate, void* dr,
                              void* dk, void* dv, void* dlogw, void* du_part,
                              void* scratch, int dtype, int B, int S, int H,
                              int D, int C, void* stream) {
  if (B < 1 || S < 1 || H < 1 || C < 1 || size_t(B) * H > size_t(INT_MAX))
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(r, k, v, f(logw), f(u), f(ckpt), f(dy), f(dstate),
                         o(dr), o(dk), o(dv), o(dlogw), o(du_part), o(scratch),
                         B, S, H, D, C, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(r, k, v, f(logw), f(u), f(ckpt), f(dy),
                                 f(dstate), o(dr), o(dk), o(dv), o(dlogw),
                                 o(du_part), o(scratch), B, S, H, D, C, s);
  return cudaErrorInvalidValue;
}
