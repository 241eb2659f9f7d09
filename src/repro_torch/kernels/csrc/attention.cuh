// The older verify-attention body, now run by paged_verify_attention.cu
// alone: k fresh queries against a paged KV cache, with an fp32 online
// softmax, one thread block per (batch row, KV head).
//
//   paged_verify_attention.cu  a page pool kp/vp (num_pages, ps, KV, hd)
//                              addressed through a block table tbl (B, P)
//
// verify_attention.cu and tree_verify_attention.cu moved to the split-KV
// body in split_attention.cuh.  The paged kernel moves there next, as an
// instantiation with ``PagedRows``, and this body goes.  ``DenseRows`` and
// ``kTree`` below are no longer instantiated.
//
// Contract (repro/kernels/block_attention.py, paged_attention.py): q (B, kq,
// H, hd) in f32 or bf16, q_pos (B, kq) and kv_pos (B, L) int32; head h =
// kv * G + g; a key is visible when kv_pos >= 0, kv_pos <= q_pos and, with a
// window, q_pos - kv_pos < window or kv_pos < num_meta.  The tree variant
// also needs, for a key whose kv_node >= 0, bit kv_node of the query's
// packed anc_bits (a uint32 shift: bit 31 is a node like any other).  Masked
// scores are the finite -1e30 (a row with no visible key averages V, no
// NaN); the output is in q's dtype.
//
// What bounds it on an H100: reading K and V once, B * L * KV * hd * 2
// tensors.  Its FLOPs (4 * B * kq * H * L * hd) are far below that line.
//
// Design: one thread block per (batch row, KV head) owns the kq * G query
// rows of that head group (32 at kq = 8, G = 4), so each K/V byte is read
// from device memory once.  The TPU kernels' sequential grid axis with a
// VMEM carry becomes a loop over KV tiles inside the block: a tile of kTile
// keys and values is staged in shared memory (as fp32), scores go to shared
// memory, each row's running max / sum is updated, and every thread keeps
// its slice of the (rows, hd) accumulator in registers.  Every row runs the
// same tile loop whatever kq and B are, so a query's result does not depend
// on the block size.  There is no lane or row padding; keys past L are
// skipped.  Where key j of row b lives is ``Rows`` (the page tbl[b, j / ps]
// looked up inside the kernel, so no dense copy of the pool is made).
// B * KV blocks at the path's shape leave part of the card's 132 SMs idle;
// split_attention.cuh is the fix.
#pragma once

#include "common.cuh"

#include <atomic>
#include <cmath>
#include <cstdint>

namespace bpd_attn {

constexpr int kThreads = 256;
constexpr int kTile = 32;      // keys per shared-memory tile
constexpr int kMaxRows = 64;   // kq * G query rows per block
constexpr float kNegInf = -1e30f;

// Key j of batch row b lives at slot b * L + j of a (B, L, KV, hd) array.
struct DenseRows {
  int L;
  __device__ __forceinline__ size_t slot(int b, int j) const {
    return size_t(b) * L + j;
  }
};

// Key j of batch row b lives at slot page * ps + j % ps of the flattened
// (num_pages * ps, KV, hd) pool, page = tbl[b, j / ps].  An entry outside
// [0, num_pages) is clamped, as the reference's gather clamps, so a bad
// table can never address memory outside the pool.
struct PagedRows {
  const int* tbl;
  int P, ps, num_pages;
  __device__ __forceinline__ size_t slot(int b, int j) const {
    int page = tbl[size_t(b) * P + j / ps];
    page = min(max(page, 0), num_pages - 1);
    return size_t(page) * ps + j % ps;
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

template <int HD>
size_t smem_bytes(int rows) {
  return sizeof(float) * (size_t(rows) * HD          // q rows, pre-scaled
                          + kTile * (HD + 1)         // k tile (padded rows)
                          + kTile * HD               // v tile
                          + size_t(rows) * kTile     // scores / probabilities
                          + 3 * size_t(rows))        // max, sum, rescale
         + sizeof(int) * 2 * (rows + kTile);         // positions, tree bits
}

template <typename T, int HD, typename Rows, bool kTree>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ q_pos,
                 const int* __restrict__ kv_pos,
                 const int* __restrict__ kv_node,
                 const int* __restrict__ anc_bits, T* __restrict__ out,
                 Rows rows, int kq, int heads, int kv_heads, int L, int window,
                 int num_meta, float scale) {
  static_assert(kThreads % HD == 0, "a thread owns one column of the output");
  constexpr int kRowStep = kThreads / HD;
  constexpr int kAcc = (kMaxRows + kRowStep - 1) / kRowStep;

  const int b = blockIdx.x / kv_heads;
  const int kvh = blockIdx.x % kv_heads;
  const int G = heads / kv_heads;
  const int R = kq * G;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* qs = smem;                      // [R][HD]
  float* ks = qs + R * HD;               // [kTile][HD + 1]
  float* vs = ks + kTile * (HD + 1);     // [kTile][HD]
  float* ps = vs + kTile * HD;           // [R][kTile]
  float* m_s = ps + R * kTile;           // [R]
  float* l_s = m_s + R;                  // [R]
  float* a_s = l_s + R;                  // [R]
  int* qp_s = reinterpret_cast<int*>(a_s + R);  // [R]
  int* kp_s = qp_s + R;                  // [kTile]
  uint32_t* ab_s = reinterpret_cast<uint32_t*>(kp_s + kTile);  // [R]
  int* kn_s = reinterpret_cast<int*>(ab_s + R);                // [kTile]

  // Row r = qi * G + g holds query qi of head kvh * G + g.
  for (int e = tid; e < R * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int qi = r / G, h = kvh * G + r % G;
    qs[e] = to_f32(q[((size_t(b) * kq + qi) * heads + h) * HD + d]) * scale;
  }
  for (int r = tid; r < R; r += kThreads) {
    qp_s[r] = q_pos[b * kq + r / G];
    if constexpr (kTree)
      ab_s[r] = static_cast<uint32_t>(anc_bits[b * kq + r / G]);
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int d = tid % HD;
  const int r0 = tid / HD;
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int n = min(kTile, L - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < kTile * HD; e += kThreads) {
      const int t = e / HD, dd = e % HD;
      float kv = 0.f, vv = 0.f;
      if (t < n) {
        const size_t off = (rows.slot(b, t0 + t) * kv_heads + kvh) * HD + dd;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[t * (HD + 1) + dd] = kv;
      vs[t * HD + dd] = vv;
    }
    if (tid < kTile) {
      const size_t at = size_t(b) * L + t0 + tid;
      kp_s[tid] = tid < n ? kv_pos[at] : -1;
      if constexpr (kTree) kn_s[tid] = tid < n ? kv_node[at] : -1;
    }
    __syncthreads();

    // scores of this tile; keys past L are left out of the softmax below
    for (int e = tid; e < R * kTile; e += kThreads) {
      const int r = e / kTile, t = e % kTile;
      float s = kNegInf;
      if (t < n) {
        const int kp = kp_s[t], qp = qp_s[r];
        bool vis = kp >= 0 && kp <= qp;
        if (window) vis = vis && (qp - kp < window || kp < num_meta);
        if constexpr (kTree) {
          const int kn = kn_s[t];
          if (kn >= 0) vis = vis && ((ab_s[r] >> min(kn, 31)) & 1u);
        }
        if (vis) {
          const float* qr = qs + r * HD;
          const float* kr = ks + t * (HD + 1);
          float dot = 0.f;
#pragma unroll 8
          for (int i = 0; i < HD; ++i) dot = fmaf(qr[i], kr[i], dot);
          s = dot;
        }
      }
      ps[e] = s;
    }
    __syncthreads();

    // online softmax update, one thread per row
    for (int r = tid; r < R; r += kThreads) {
      float* pr = ps + r * kTile;
      const float m_prev = m_s[r];
      float m_new = m_prev;
      for (int t = 0; t < n; ++t) m_new = fmaxf(m_new, pr[t]);
      float sum = 0.f;
      for (int t = 0; t < kTile; ++t) {
        const float p = t < n ? expf(pr[t] - m_new) : 0.f;
        pr[t] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int r = r0 + j * kRowStep;
      if (r < R) {
        const float* pr = ps + r * kTile;
        float s = acc[j] * a_s[r];
        for (int t = 0; t < n; ++t) s = fmaf(pr[t], vs[t * HD + d], s);
        acc[j] = s;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int r = r0 + j * kRowStep;
    if (r < R) {
      const int qi = r / G, h = kvh * G + r % G;
      out[((size_t(b) * kq + qi) * heads + h) * HD + d] =
          from_f32<T>(acc[j] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

template <typename T, int HD, typename Rows, bool kTree>
cudaError_t launch(const Args& a, Rows rows, cudaStream_t stream) {
  const int n_rows = a.kq * (a.heads / a.kv_heads);
  const size_t smem = smem_bytes<HD>(n_rows);
  auto kernel = attention_kernel<T, HD, Rows, kTree>;
  // The shared-memory limit is a per-device attribute of the instantiation:
  // set it on the first launch on each device, not on every launch.
  static std::atomic<unsigned long long> configured{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << dev;
  if (!(configured.load() & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes<HD>(kMaxRows)));
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit);
  }
  kernel<<<a.B * a.kv_heads, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.q_pos, a.kv_pos, a.kv_node, a.anc_bits,
      static_cast<T*>(a.out), rows, a.kq, a.heads, a.kv_heads, a.L, a.window,
      a.num_meta, 1.0f / sqrtf(float(HD)));
  return cudaGetLastError();
}

template <typename T, typename Rows, bool kTree>
cudaError_t dispatch_hd(int hd, const Args& a, Rows rows, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32, Rows, kTree>(a, rows, s);
    case 64: return launch<T, 64, Rows, kTree>(a, rows, s);
    case 128: return launch<T, 128, Rows, kTree>(a, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

// The wrappers (kernels/*.py) have checked shapes, dtypes and contiguity;
// this re-checks what would make the launch unsafe, then picks the
// instantiation for the dtype and head_dim.
template <typename Rows, bool kTree>
cudaError_t run(int dtype, int hd, const Args& a, Rows rows, void* stream) {
  if (a.B < 1 || a.kq < 1 || a.L < 1 || a.kv_heads < 1 ||
      a.heads % a.kv_heads != 0 || a.kq * (a.heads / a.kv_heads) > kMaxRows)
    return cudaErrorInvalidValue;
  if (kTree && (a.kv_node == nullptr || a.anc_bits == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_hd<float, Rows, kTree>(hd, a, rows, s);
  if (dtype == kBFloat16)
    return dispatch_hd<__nv_bfloat16, Rows, kTree>(hd, a, rows, s);
  return cudaErrorInvalidValue;
}

}  // namespace bpd_attn
