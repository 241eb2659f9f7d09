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
// Design: the reference's closed chunk form, on the tensor cores.  Within
// a sub-chunk of C = 8 steps, with la = cumsum(logw) per channel, la_prev
// = la - logw and ref = la_end / 2,
//   R~ = r ⊙ exp(la_prev - ref),  K~ = k ⊙ exp(ref - la),
//   y  = (r ⊙ exp(la_prev)) S0 + A V,   A = tril_strict(R~ K~^T) + diag((r ⊙ u)·k),
//   S  = diag(exp(la_end)) S0 + (k ⊙ exp(la_end - la))^T V.
// The reference's 16-step chunk with one midpoint per channel is exact only
// while a chunk decays by less than about e^-160 per channel: at logw -20
// the neighbours' weight exp(la_prev_t - la_{t-1}) = 1 comes out 0.  Here a
// step's logw is floored at -16 and a midpoint spans 8 steps, so |la_end| /
// 2 <= 64 and every factor stays inside fp32 (no clamp); a weight that the
// floor changes was below e^-16 and stays below it.  A tile of 16 steps is
// two sub-chunks; its A also holds the block between them (rows of
// sub-chunk 1, columns of sub-chunk 0: r decayed from sub-chunk 1's start
// times k decayed to sub-chunk 0's end, both factors <= 1), so y and S of
// all 16 steps come from the tile's S0 in one pass.  Masked (s >= t)
// entries of the scores may overflow; they are discarded by select, never
// multiplied by a 0/1 mask.  Exponentials are taken in base 2.
//
// One warp-specialised block of 4·D threads per (b, h).  The consumer
// warps (D / 16) each own 16 state columns and keep S^T's (16 x D) slice
// in mma.sync m16n8k8 accumulator fragments (D / 2 fp32 registers a lane);
// the slice feeds y's product as the A operand directly (its k index
// permuted to match the accumulator layout, as flash attention reuses P).
// The producer warps (as many) copy r, k, v and logw ahead into a cp.async
// ring (3 stages; 2 for fp32 at D 128), form the decays and exponentials
// (thread = channel x sub-chunk), compute the score partials over 16
// channels a warp, and hand a tile's arrays to the consumers through two
// buffers and named barriers (full / empty), so a tile's exponentials
// overlap the last tile's products.  Every product runs on TF32 tensor
// cores split three ways (x = hi + lo; hi·hi + hi·lo + lo·hi, fp32
// accumulation), which keeps fp32 accuracy; a bf16 v is exact in TF32, so
// its products take two terms.  Plain TF32 misses the 1e-4 tolerance
// (tests/test_torch_rwkv6_chunk.py).
// The result does not depend on the chunk length the caller names.
//
// Checkpoints (the training path): given a non-null ckpt and a chunk of C
// steps, C a multiple of the 16-step tile, the consumers also write the
// state at the start of every chunk, (B, H, ceil(S / C), D, D) f32, from
// the accumulators they hold at that tile boundary: what the backward
// (csrc/rwkv6_scan_bwd.cu) recomputes each chunk's states from.  A null
// ckpt writes nothing and leaves y and the final state bit for bit as they
// are.
#include "common.cuh"

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kSub = 8;            // steps of one midpoint renormalisation
constexpr int kTile = 2 * kSub;    // steps a tile: the unit staged and multiplied
constexpr float kLogwFloor = -16.f;
constexpr float kLog2e = 1.4426950408889634f;
// named barriers (0 is __syncthreads)
constexpr int kBarPrep = 1;        // the producer warps among themselves
constexpr int kBarFull = 2;        // + buffer: a tile's arrays are ready
constexpr int kBarEmpty = 4;       // + buffer: the consumers are done with them

template <typename T, int D>
struct Layout {
  static constexpr int kWarps = D / 16;        // consumer warps: 16 columns each
  static constexpr int kCons = 32 * kWarps;    // consumer threads = 2 D
  static constexpr int kProd = kCons;          // as many producers: (channel, sub-chunk)
  static constexpr int kThreads = kCons + kProd;
  static constexpr int kPadA = D + 4;          // producers' arrays' row pitch
  static constexpr int kPadB = D + 8;          // consumers' arrays' row pitch
  static constexpr int kPadP = kTile + 4;      // score partials' row pitch
  static constexpr int kGroups = D >= 32 ? D / 32 : 1;  // diagonal partials
  // a stage: r, k, v (T) then logw (f32), each [kTile][D]
  static constexpr int kStageBytes = kTile * D * (3 * int(sizeof(T)) + 4);
  // the producers' own arrays, in floats after the ring: midpoint-scaled
  // R~, K~ and the sub-chunk-decayed r, k (for the cross-sub-chunk block)
  static constexpr int kRt = 0;
  static constexpr int kKt = kRt + kTile * kPadA;
  static constexpr int kRsub = kKt + kTile * kPadA;
  static constexpr int kKsub = kRsub + kTile * kPadA;
  static constexpr int kOwn = kKsub + kTile * kPadA;
  // a tile's arrays for the consumers (two buffers): tile-decayed r and k,
  // v, exp(la_end), score partials [producer warp][t][s], diagonal partials
  static constexpr int kRs = 0;
  static constexpr int kKin = kRs + kTile * kPadB;
  static constexpr int kV = kKin + kTile * kPadB;
  static constexpr int kAc = kV + kTile * kPadB;
  static constexpr int kP = kAc + D;
  static constexpr int kDg = kP + kWarps * kTile * kPadP;   // [t][group]
  static constexpr int kBuf = kDg + kTile * kGroups;
  static constexpr int kRest = 4 * (kOwn + 2 * kBuf);
  // a 3-stage cp.async ring where it fits (all but fp32 at D 128), else 2
  static constexpr int kStages = 3 * kStageBytes + kRest <= 232448 ? 3 : 2;
  static constexpr int kBytes = kStages * kStageBytes + kRest;
  static_assert(kStageBytes % 16 == 0, "stages start on 16-byte boundaries");
  static_assert(kOwn % 4 == 0 && kBuf % 4 == 0, "buffers start on 16 bytes");
};

// A float as a TF32 pair: hi rounded to the nearest TF32 (ties away from
// zero, as cvt.rna, in two integer operations: cvt.rna is emulated on this
// target), lo = x - hi exactly (the mma reads lo's top 19 bits).
struct Tf32 {
  uint32_t hi, lo;
};

__device__ __forceinline__ Tf32 split(float x) {
  const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

__device__ __forceinline__ float ex2(float x) {   // 2^x, the SFU's own
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a b at fp32 accuracy: lo·hi (skipped when a is exact in TF32),
// hi·lo, then hi·hi.
template <bool kAExact>
__device__ __forceinline__ void mma3(float (&c)[4], const Tf32 (&a)[4],
                                     Tf32 b0, Tf32 b1) {
  if (!kAExact)
    mma_tf32(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b0.hi, b1.hi);
  mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.lo, b1.lo);
  mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.hi, b1.hi);
}

// One tensor's [kTile][D] rows of tile `tile` into `dst` by the producer
// thread p; steps past S are zero-filled (r = k = v = 0 and logw = 0:
// w = 1, the reference's padding).
template <typename E, int D, int kProd>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const E* src,
                                           size_t base, size_t step, int tile,
                                           int S, int p) {
  constexpr int kRow = D * int(sizeof(E)) / 16;   // 16-byte chunks a row
  constexpr int kVec = 16 / int(sizeof(E));
#pragma unroll
  for (int c0 = 0; c0 < kTile * kRow; c0 += kProd) {
    const int c = c0 + p;
    if (kTile * kRow % kProd == 0 || c < kTile * kRow) {
      const int t = tile * kTile + c / kRow;
      const E* g = src + base + size_t(t < S ? t : 0) * step + (c % kRow) * kVec;
      cp_async16(dst + 16 * c, g, t < S);
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void stage_tile(unsigned char* st, const T* r,
                                           const T* k, const T* v,
                                           const float* logw, size_t base,
                                           size_t step, int tile, int S, int p) {
  constexpr int kP = Layout<T, D>::kProd;
  constexpr int kBytesT = kTile * D * int(sizeof(T));
  stage_rows<T, D, kP>(st, r, base, step, tile, S, p);
  stage_rows<T, D, kP>(st + kBytesT, k, base, step, tile, S, p);
  stage_rows<T, D, kP>(st + 2 * kBytesT, v, base, step, tile, S, p);
  stage_rows<float, D, kP>(st + 3 * kBytesT, logw, base, step, tile, S, p);
  cp_async_commit();
}

// ---------------------------------------------------------------------------
// producers: copies, decays and exponentials, the score partials
// ---------------------------------------------------------------------------

template <typename T, int D>
__device__ __forceinline__ void produce(unsigned char* smem, float* own,
                                        float* bufs, const T* r, const T* k,
                                        const T* v, const float* logw,
                                        float uc, size_t base, size_t step,
                                        int S, int tiles) {
  using L = Layout<T, D>;
  constexpr int PA = L::kPadA, PB = L::kPadB, PP = L::kPadP;
  constexpr int kStages = L::kStages;
  const int p = threadIdx.x - L::kCons;   // 0 .. kProd - 1
  const int lane = p & 31, pw = p >> 5;   // producer warp pw: channels 16 pw ..
  const int g = lane >> 2, q = lane & 3;
  const int ch = p % D, half = p / D;     // prep: (channel, sub-chunk)
  float* Rt = own + L::kRt;
  float* Kt = own + L::kKt;
  float* Rsub = own + L::kRsub;
  float* Ksub = own + L::kKsub;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles)
      stage_tile<T, D>(smem + s * L::kStageBytes, r, k, v, logw, base, step, s, S, p);
    else
      cp_async_commit();
  }
  for (int tile = 0; tile < tiles; ++tile) {
    const int pb = tile & 1;
    float* buf = bufs + pb * L::kBuf;
    cp_async_wait<kStages - 2>();
    bar_sync(kBarPrep, L::kProd);   // the tile landed; Rt..Ksub are free
    {
      const int next = tile + kStages - 1;
      if (next < tiles)
        stage_tile<T, D>(smem + (next % kStages) * L::kStageBytes, r, k, v,
                         logw, base, step, next, S, p);
      else
        cp_async_commit();
    }
    if (tile >= 2) bar_sync(kBarEmpty + pb, L::kThreads);   // buffer pb is free

    // ---- prep: thread (ch, half) forms its channel's sub-chunk ----------
    {
      const unsigned char* stg = smem + (tile % kStages) * L::kStageBytes;
      const T* rr = reinterpret_cast<const T*>(stg);
      const T* kk = rr + kTile * D;
      const T* vv = kk + kTile * D;
      const float* lw = reinterpret_cast<const float*>(vv + kTile * D);
      // log2 decays, floored: this sub-chunk's steps, and the other's sum
      float l2[kSub], sum = 0.f, other = 0.f;
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        l2[t] = fmaxf(lw[(half * kSub + t) * D + ch], kLogwFloor) * kLog2e;
        sum += l2[t];
        other += fmaxf(lw[((half ^ 1) * kSub + t) * D + ch], kLogwFloor) * kLog2e;
      }
      const float ref = 0.5f * sum;   // the sub-chunk's midpoint
      const float er = ex2(ref);      // exp(ref) = exp(la_end - ref)
      // from the sub-chunk's decays to the tile's: r after sub-chunk 0's
      // steps, k before sub-chunk 1's
      const float to_tile = ex2(other);
      float la = 0.f, dg[kSub];
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        const int row = half * kSub + t;
        const float rv = to_f32(rr[row * D + ch]);
        const float kv = to_f32(kk[row * D + ch]);
        const float la_prev = la;
        la += l2[t];
        const float rt = rv * ex2(la_prev - ref);
        const float kt = kv * ex2(ref - la);
        const float rs = rt * er;             // r ⊙ exp(la_prev), sub-chunk
        const float ks = kt * er;             // k ⊙ exp(la_end - la), sub-chunk
        Rt[row * PA + ch] = rt;
        Kt[row * PA + ch] = kt;
        if (half)            // the cross block: rows of sub-chunk 1 ...
          Rsub[row * PA + ch] = rs;
        else                 // ... with columns of sub-chunk 0
          Ksub[row * PA + ch] = ks;
        buf[L::kRs + row * PB + ch] = half ? rs * to_tile : rs;
        buf[L::kKin + row * PB + ch] = half ? ks : ks * to_tile;
        buf[L::kV + row * PB + ch] = to_f32(vv[row * D + ch]);
        dg[t] = rv * uc * kv;
      }
      if (half == 0) buf[L::kAc + ch] = ex2(sum + other);   // exp(la_end)
      constexpr int kRed = D >= 32 ? 32 : D;   // lanes of one sub-chunk
#pragma unroll
      for (int t = 0; t < kSub; ++t)
#pragma unroll
        for (int o = kRed / 2; o > 0; o >>= 1)
          dg[t] += __shfl_xor_sync(0xffffffffu, dg[t], o);
      if ((lane & (kRed - 1)) == 0) {
#pragma unroll
        for (int t = 0; t < kSub; ++t)
          buf[L::kDg + (half * kSub + t) * L::kGroups + ch / 32] = dg[t];
      }
    }
    bar_sync(kBarPrep, L::kProd);

    // ---- score partials over this warp's 16 channels --------------------
    // diagonal blocks: R~ K~^T, rows t < 8 with sub-chunk 0's s (n tile
    // 0), rows t >= 8 with sub-chunk 1's (n tile 1); the cross block: the
    // sub-chunk-decayed r of rows t >= 8 with k of sub-chunk 0's s.
    {
      float sc[2][4] = {}, cr[4] = {};
#pragma unroll
      for (int kq = 0; kq < 2; ++kq) {
        const int i0 = 16 * pw + 8 * kq;
        const Tf32 a[4] = {split(Rt[g * PA + i0 + q]),
                           split(Rt[(g + 8) * PA + i0 + q]),
                           split(Rt[g * PA + i0 + q + 4]),
                           split(Rt[(g + 8) * PA + i0 + q + 4])};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma3<false>(sc[nt], a, split(Kt[(8 * nt + g) * PA + i0 + q]),
                      split(Kt[(8 * nt + g) * PA + i0 + q + 4]));
        const Tf32 ar[4] = {split(Rsub[g * PA + i0 + q]),
                            split(Rsub[(g + 8) * PA + i0 + q]),
                            split(Rsub[g * PA + i0 + q + 4]),
                            split(Rsub[(g + 8) * PA + i0 + q + 4])};
        mma3<false>(cr, ar, split(Ksub[g * PA + i0 + q]),
                    split(Ksub[g * PA + i0 + q + 4]));
      }
      float* P = buf + L::kP + pw * kTile * PP;
      *reinterpret_cast<float2*>(P + g * PP + 2 * q) = make_float2(sc[0][0], sc[0][1]);
      *reinterpret_cast<float2*>(P + (g + 8) * PP + 8 + 2 * q) =
          make_float2(sc[1][2], sc[1][3]);
      *reinterpret_cast<float2*>(P + (g + 8) * PP + 2 * q) = make_float2(cr[2], cr[3]);
    }
    bar_arrive(kBarFull + pb, L::kThreads);
  }
}

// ---------------------------------------------------------------------------
// consumers: the state's columns, a tile at a time
// ---------------------------------------------------------------------------

// S^T's accumulator slice of this warp's columns, as (i, j) rows of the
// (D, D) state at ``out``.
template <int D>
__device__ __forceinline__ void store_state(float* out, const float (&st)[D / 8][4],
                                            int j0, int g, int q) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int i = 8 * n + 2 * q;
    out[i * D + j0 + g] = st[n][0];
    out[(i + 1) * D + j0 + g] = st[n][1];
    out[i * D + j0 + g + 8] = st[n][2];
    out[(i + 1) * D + j0 + g + 8] = st[n][3];
  }
}

template <typename T, int D>
__device__ __forceinline__ void consume(const float* bufs, float* y,
                                        float* state, float* ckpt,
                                        int chunk_tiles, size_t base,
                                        size_t step, int S, int tiles, int bh) {
  using L = Layout<T, D>;
  constexpr bool kVExact = sizeof(T) == 2;   // bf16 is exact in TF32
  constexpr int PB = L::kPadB, PP = L::kPadP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;     // mma fragment coordinates
  const int j0 = 16 * warp;                  // this warp's state columns

  // st[n]: S^T rows j0 + g (+8), columns i = 8 n + 2 q (+1): the m16n8
  // accumulator layout, n over the D / 8 column tiles of i.
  float st[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;

  const int nchunks = (tiles + chunk_tiles - 1) / chunk_tiles;
  for (int tile = 0; tile < tiles; ++tile) {
    const int pb = tile & 1;
    const float* buf = bufs + pb * L::kBuf;
    if (ckpt != nullptr && tile % chunk_tiles == 0)   // a chunk starts here
      store_state<D>(ckpt + (size_t(bh) * nchunks + tile / chunk_tiles) * D * D,
                     st, j0, g, q);
    bar_sync(kBarFull + pb, L::kThreads);

    // V^T as the A operand (rows j, k index s), a k tile per sub-chunk
    Tf32 va[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const float* V = buf + L::kV + 8 * ks * PB + j0 + g;
      const float x[4] = {V[q * PB], V[q * PB + 8], V[(q + 4) * PB],
                          V[(q + 4) * PB + 8]};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        va[ks][e] = kVExact ? Tf32{__float_as_uint(x[e]), 0u} : split(x[e]);
    }

    // y^T = S^T Rs^T + V^T A^T, both n tiles of t (sub-chunks 0 and 1);
    // S^T's k index i is taken in the order its accumulator holds it (2 q,
    // 2 q + 1 in slots q, q + 4); two accumulators a tile, by k parity
    float yacc[2][2][4] = {};
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const Tf32 a[4] = {split(st[n][0]), split(st[n][2]), split(st[n][1]),
                         split(st[n][3])};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 rb = *reinterpret_cast<const float2*>(
            buf + L::kRs + (8 * nt + g) * PB + 8 * n + 2 * q);
        mma3<false>(yacc[nt][n & 1], a, split(rb.x), split(rb.y));
      }
    }
    // A (t, s): the partials' sum below the diagonal, the diagonal's bonus
    // on it, 0 above (selected, never multiplied by a mask: masked partials
    // may be inf or NaN); b0 = A[t = 8 nt + g][s = 8 ks + q], b1 at s + 4
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int t = 8 * nt + g;
      float dg = 0.f;
#pragma unroll
      for (int gr = 0; gr < L::kGroups; ++gr) dg += buf[L::kDg + t * L::kGroups + gr];
#pragma unroll
      for (int ks = 0; ks <= nt; ++ks) {   // s > t throughout for nt 0, ks 1
        Tf32 ab[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = 8 * ks + q + 4 * e;
          float p = 0.f;
#pragma unroll
          for (int w = 0; w < L::kWarps; ++w)
            p += buf[L::kP + (w * kTile + t) * PP + s];
          ab[e] = split(s < t ? p : (s == t ? dg : 0.f));
        }
        mma3<kVExact>(yacc[nt][ks], va[ks], ab[0], ab[1]);
      }
    }
    float* yo = y + base + j0 + g;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int t = tile * kTile + 8 * nt + 2 * q;
      if (t < S) {
        yo[size_t(t) * step] = yacc[nt][0][0] + yacc[nt][1][0];
        yo[size_t(t) * step + 8] = yacc[nt][0][2] + yacc[nt][1][2];
      }
      if (t + 1 < S) {
        yo[size_t(t + 1) * step] = yacc[nt][0][1] + yacc[nt][1][1];
        yo[size_t(t + 1) * step + 8] = yacc[nt][0][3] + yacc[nt][1][3];
      }
    }

    // S^T = S^T diag(exp(la_end)) + V^T (k ⊙ exp(la_end - la)), the tile's
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float2 ac = *reinterpret_cast<const float2*>(buf + L::kAc + 8 * n + 2 * q);
      st[n][0] *= ac.x;
      st[n][1] *= ac.y;
      st[n][2] *= ac.x;
      st[n][3] *= ac.y;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const float* K = buf + L::kKin + 8 * ks * PB + 8 * n + g;
        mma3<kVExact>(st[n], va[ks], split(K[q * PB]), split(K[(q + 4) * PB]));
      }
    }
    if (tile + 2 < tiles) bar_arrive(kBarEmpty + pb, L::kThreads);
  }

  store_state<D>(state + size_t(bh) * D * D, st, j0, g, q);   // (b, h, i, j)
}

template <typename T, int D>
__global__ void __launch_bounds__(Layout<T, D>::kThreads)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ logw,
                  const float* __restrict__ u, float* __restrict__ y,
                  float* __restrict__ state, float* __restrict__ ckpt,
                  int chunk_tiles, int S, int H) {
  using L = Layout<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* own = reinterpret_cast<float*>(smem + L::kStages * L::kStageBytes);
  float* bufs = own + L::kOwn;
  const int bh = blockIdx.x;   // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t step = size_t(H) * D;                 // from step t to t + 1
  const size_t base = (size_t(b) * S * H + h) * D;   // element (b, 0, h, 0)
  const int tiles = (S + kTile - 1) / kTile;
  // a warp index the compiler can see is uniform, so the producers'
  // shuffles need no convergence code
  const int warp = __shfl_sync(0xffffffffu, int(threadIdx.x) >> 5, 0);
  if (warp >= L::kWarps)
    produce<T, D>(smem, own, bufs, r, k, v, logw,
                  u[h * D + (threadIdx.x - L::kCons) % D], base, step, S, tiles);
  else
    consume<T, D>(bufs, y, state, ckpt, chunk_tiles, base, step, S, tiles, bh);
}

template <typename T, int D>
cudaError_t launch_d(const void* r, const void* k, const void* v,
                     const float* logw, const float* u, float* y, float* state,
                     float* ckpt, int chunk_tiles, int B, int S, int H,
                     cudaStream_t stream) {
  using L = Layout<T, D>;
  auto kernel = rwkv6_scan_kernel<T, D>;
  static std::atomic<unsigned long long> configured{0};
  cudaError_t err = allow_smem(kernel, L::kBytes, configured);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, L::kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, y, state, ckpt, chunk_tiles, S, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* logw, const float* u, float* y, float* state,
                   float* ckpt, int ct, int B, int S, int H, int D,
                   cudaStream_t stream) {
  switch (D) {
    case 16: return launch_d<T, 16>(r, k, v, logw, u, y, state, ckpt, ct, B, S, H, stream);
    case 32: return launch_d<T, 32>(r, k, v, logw, u, y, state, ckpt, ct, B, S, H, stream);
    case 64: return launch_d<T, 64>(r, k, v, logw, u, y, state, ckpt, ct, B, S, H, stream);
    case 128: return launch_d<T, 128>(r, k, v, logw, u, y, state, ckpt, ct, B, S, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The wrapper (kernels/rwkv6_scan.py) has checked devices, shapes, dtypes,
// contiguity and 16-byte alignment; this re-checks what would make the
// launch unsafe.  ckpt may be null (no checkpoints; chunk is then not
// read), else chunk is a positive multiple of 16.
BPD_EXPORT int rwkv6_scan(const void* r, const void* k, const void* v,
                          const void* logw, const void* u, void* y,
                          void* state, void* ckpt, int chunk, int dtype, int B,
                          int S, int H, int D, void* stream) {
  if (B < 1 || S < 1 || H < 1 || size_t(B) * H > size_t(INT_MAX))
    return cudaErrorInvalidValue;
  if (ckpt != nullptr && (chunk < kTile || chunk % kTile != 0))
    return cudaErrorInvalidValue;
  const int ct = ckpt != nullptr ? chunk / kTile : 1;
  float* ck = static_cast<float*>(ckpt);
  for (const void* p : {r, k, v, logw})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  const float* lw = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  float* yy = static_cast<float*>(y);
  float* st = static_cast<float*>(state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(r, k, v, lw, uu, yy, st, ck, ct, B, S, H, D, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(r, k, v, lw, uu, yy, st, ck, ct, B, S, H, D, s);
  return cudaErrorInvalidValue;
}
