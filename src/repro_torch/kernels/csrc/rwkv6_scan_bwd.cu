// RWKV-6 wkv scan, backward: the reverse scan from per-chunk states, in
// closed chunk form on the tensor cores.
//
// Replaces no TPU kernel.  The reference trains through its jnp scan
// (repro/models/rwkv6.py:90 _wkv_scan: chunks of 128 steps under
// jax.checkpoint) and XLA differentiates it; its Pallas kernel
// (rwkv6_scan_pallas) has no backward.  This is the gradient of the
// forward kernel (csrc/rwkv6_scan.cu), which on the training path also
// writes the state at the start of every chunk of C steps.
//
// Contract: r, k, v (B, S, H, D) f32 or bf16, logw (B, S, H, D) f32, u
// (H, D) f32, the checkpoints (B, H, ceil(S / C), D, D) f32 (C a multiple
// of 16), dy (B, S, H, D) f32 and dstate (B, H, D, D) f32 or null (zeros)
// -> dr, dk, dv, dlogw (B, S, H, D) f32 and du's partial (B, H, D) f32,
// which the wrapper sums over B.  With w = exp(logw), G_t = dL/dS_t and
// G = dstate after the last step, step by step (kernels/ref.py:
// rwkv6_scan_bwd, the plain version):
//   dr_t[i]    = sum_j dy_t[j] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
//   dk_t[i]    = sum_j G_t[i,j] v_t[j] + u[i] r_t[i] (dy_t . v_t)
//   dv_t[j]    = sum_i G_t[i,j] k_t[i] + (sum_i r_t[i] u[i] k_t[i]) dy_t[j]
//   dlogw_t[i] = w_t[i] sum_j G_t[i,j] S_{t-1}[i,j]
//   du[i]     += r_t[i] k_t[i] (dy_t . v_t),   G_{t-1} = diag(w_t) G_t + r_t^T dy_t.
//
// What bounds it on an H100: reading r, k, v, logw, dy and the checkpoints
// and writing the four gradients, 218 MB at rwkv6-1.6b's training shape
// (fp32, B 4, S 512, H 32, D 64, C 16): 65 us at 3.35 TB/s; its about 12 B
// S H D^2 operations (3.2 GFLOP there) need 19.5 us at the TF32 tensor
// cores' 495 TFLOP/s even split three ways.  So bytes bound it.
//
// Design: tiles of 16 steps, walked last first, each in closed form from
// the tile's start state S0 and G_end = dL/dS after its last step.  With
// F = the cumsum of the floored log2-decay over the tile (la in the forward),
// Fp = 2^(F_prev), Fe = 2^(F_end - F), Rs = r Fp, Kin = k Fe, Ac = 2^F_end,
// M[t,s] = dy_t . v_s (s < t) and A[t,s] = sum_i r_t k_s 2^(F_prev_t - F_s)
// (s < t: the forward's score matrix):
//   dr = Fp (.) (dY S0^T) + [M (.) decay] K + bonus
//   dk = Fe (.) (V G_end^T) + [M^T (.) decay] R + bonus
//   dv = Kin G_end + A^T dY + bonus
//   G_start = diag(Ac) G_end + Rs^T dY
//   dlogw_t = rho_t (Ac c0 + sum_{s<t} Kin_s VG_s + sum_{tau>t} Rs_tau HS_tau
//                    + sum_{s<t<tau} Z[tau,s]),
// with HS = dY S0^T, VG = V G_end^T, c0 = rowsum(G_end (.) S0), Z[tau,s] =
// M[tau,s] r_tau k_s 2^(F_prev_tau - F_s) and rho_t = w_t / floored w_t:
// every term of w_t sum_j G_t S_{t-1} at its own size, so nothing cancels
// and dlogw is exact at any decay (the reverse cumsum of dL/dF, r dr - k dk
// a step, cancels past fp32 at logw -8: tests/test_torch_rwkv6_chunk_bwd.py).
// The decays inside a tile are split as in the forward: two sub-chunks of
// 8 steps, each with its midpoint ref = la_end / 2 (R~ = r 2^(la_prev -
// ref), K~ = k 2^(ref - la)), and the cross block from r decayed from
// sub-chunk 1's start and k decayed to sub-chunk 0's end, so that every
// factor fits in fp32 with a step's logw floored at -16; masked score
// entries may overflow and are discarded by select.  The intra products
// take 24 rows of K (K~0, the cross k, K~1) against a 16 x 24 M, so one
// accumulator holds each gradient's intra part.  At C 16 the checkpoint
// is the tile's S0; past a chunk's first tile S0 is replayed step by step
// in fp32 from the checkpoint (C > 16 only, not the training path).
//
// Blocks: one per (b, h) of 8 D threads (16 warps at D 64); at D 128 two,
// each over half the key channels i, so that fp32 fits shared memory (the
// rows i of S and G are independent: each block owns its rows' G and
// writes its channels' dr, dk, dlogw and du, and the two add their dv
// partials into dv, which the entry zeroes first with a second kernel; two
// addends, so the sum does not depend on their order).  G stays in shared
// memory.  The warps form two teams; a tile runs in four phases between
// block barriers, with the next tile's inputs (cp.async, zero past S) and
// start state in flight and its prep (the decays, the scaled rows, and
// sum_i r u k, which rides on A's diagonal into dv) formed a tile ahead:
//   1. team A: HS, VG, c0; team B: Kin G_end, M, A;
//   2. team A: the intra products, dr and dk out; team B: dv out, G's update;
//   3. team A: the Z sums; team B: the next tile's prep;
//   4. all: dlogw and du.
// Every product runs on mma.sync m16n8k8 TF32 split three ways (x = hi +
// lo; lo·hi, hi·lo and hi·hi in accumulators of their own, three
// independent chains), which keeps fp32 accuracy; bf16 r/k/v are exact in
// TF32 and skip their low part.
//
// What holds it back: it takes about 3.4x its bound.  A tile costs some
// 11,000 cycles a block (tools/trace_rwkv6_scan_bwd.py), and every phase
// keeps the schedulers dispatching: the fragments' TF32 splits and
// addresses outnumber the mma instructions many times over, and taking out
// any one part (HS / VG, Kin G_end, M and A, G's update, the prep, dlogw,
// ...) saves 2-11% of the time (tools/ablate_rwkv6_scan_bwd.py); moving
// work between the phases did not shorten them.  Most of the card's
// bandwidth goes unused.
#include "common.cuh"

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kSub = 8;            // steps of one midpoint renormalisation
constexpr int kTile = 2 * kSub;    // steps a tile
constexpr float kLogwFloor = -16.f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
struct Bwd {
  static constexpr int kSplit = D >= 128 ? 2 : 1;  // blocks per (b, h)
  static constexpr int kDi = D / kSplit;           // key channels a block
  static constexpr int kGroups = kDi / 8;          // 8-channel n tiles
  static constexpr int kWarps = 2 * kGroups;       // two teams of kGroups warps
  static constexpr int kThreads = 32 * kWarps;     // = 8 kDi
  static constexpr int kZParts = 4;                // team A's threads a channel
  static constexpr int kMinBlocks = kThreads <= 256 ? 2 : 1;   // blocks an SM
  static constexpr int kNtv = kSplit;              // dv / G n tiles a team B warp
  static constexpr int kRedLanes = kDi >= 32 ? 32 : kDi;   // a sub-chunk's lanes a warp
  static constexpr int kRukGroups = kDi / kRedLanes;       // partial sums of r u k a step
  static constexpr int kPadT = 16 / int(sizeof(T));
  static constexpr int PT = kDi + kPadT;           // r, k rows (T)
  static constexpr int PVT = D + kPadT;            // v rows (T)
  static constexpr int PI = kDi + 4;               // f32 rows over the block's channels
  static constexpr int PD = D + 4;                 // f32 rows over all D
  static constexpr int PM = kTile + 4;             // 16 x 16 matrices
  // a stage, in bytes: r, k, v (T) then logw, dy (f32)
  static constexpr int kR = 0;
  static constexpr int kK = kR + kTile * PT * int(sizeof(T));
  static constexpr int kV = kK + kTile * PT * int(sizeof(T));
  static constexpr int kLw = kV + kTile * PVT * int(sizeof(T));
  static constexpr int kDy = kLw + kTile * PI * 4;
  static constexpr int kStage = kDy + kTile * PD * 4;
  // a tile's prep, in floats (two sets: the next tile's is formed while
  // this one is used)
  static constexpr int pRx = 0;                     // [24][PI] R~0, cross r, R~1
  static constexpr int pKx = pRx + 3 * kSub * PI;   // [24][PI] K~0, cross k, K~1
  static constexpr int pXs = pKx + 3 * kSub * PI;   // [16][PI] k to 0's end, r from 1's start
  static constexpr int pRs = pXs + kTile * PI;      // [16][PI] r 2^F_prev
  static constexpr int pKin = pRs + kTile * PI;     // [16][PI] k 2^(F_end - F)
  static constexpr int pLam = pKin + kTile * PI;    // [16][PI] sub-chunk la
  static constexpr int pSum0 = pLam + kTile * PI;   // [kDi] sub-chunk 0's la_end
  static constexpr int pSum1 = pSum0 + kDi;         // [kDi] sub-chunk 1's
  static constexpr int pAc = pSum1 + kDi;           // [kDi] 2^F_end
  static constexpr int pRuk = pAc + kDi;            // [16][kRukGroups] r u k partials
  static constexpr int kPrep = (pRuk + kTile * kRukGroups + 3) / 4 * 4;
  // the rest, in floats after the two stages
  static constexpr int fS0 = 0;                     // [kDi][PD] the tile's start state
  static constexpr int fG = fS0 + kDi * PD;         // [kDi][PD] G, carried
  static constexpr int fPrep = fG + kDi * PD;       // [2][kPrep]
  static constexpr int fPre = fPrep + 2 * kPrep;    // [16][PI] Kin VG
  static constexpr int fSuf = fPre + kTile * PI;    // [16][PI] Rs HS
  static constexpr int fU = fSuf + kTile * PI;      // [kZParts][16][PI] Z sums
  static constexpr int fM = fU + kZParts * kTile * PI;  // [16][PM] dy_t . v_s, s < t
  static constexpr int fSc = fM + kTile * PM;       // [16][PM] A, s < t; r u k on s = t
  static constexpr int fC0 = fSc + kTile * PM;      // [kDi] rowsum(G_end S0)
  static constexpr int fU_ = fC0 + kDi;             // [kDi] u over the block's channels
  static constexpr int fDyv = fU_ + kDi;            // [16] dy . v
  static constexpr int kFloats = fDyv + kTile;
  static constexpr int kBytes = 2 * kStage + 4 * kFloats;
  static_assert(kStage % 16 == 0 && (kTile * PT * int(sizeof(T))) % 16 == 0,
                "stage arrays start on 16 bytes");
  static_assert((PI * 4) % 16 == 0 && (PD * 4) % 16 == 0, "rows on 16 bytes");
  static_assert(kBytes <= 232448, "shared memory of one block");
};

struct Tf32 {
  uint32_t hi, lo;
};

// hi rounded to the nearest TF32 (ties away, as cvt.rna), lo = x - hi
// exactly (the mma reads lo's top 19 bits); an exact operand has lo 0.
template <bool kExact>
__device__ __forceinline__ Tf32 tf32(float x) {
  if (kExact) return {__float_as_uint(x), 0u};
  const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

__device__ __forceinline__ float ex2(float x) {   // 2^x, the SFU's own
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int kNt>
__device__ __forceinline__ void zero(float (&c)[kNt][4]) {
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
}

// c[nt] (16 x 8 accumulators, row g (+8), columns 8 nt + 2 q (+1)) +=
// A (16 x 8 kSteps) B (8 kSteps x 8 kNt), a warp's product: A(m, k) and
// B(k, n) return the operands' floats.  The three TF32 products (hi·hi,
// lo·hi, hi·lo) sum in accumulators of their own, three independent mma
// chains, and meet at the end.
template <int kSteps, int kNt, bool kAEx, bool kBEx, typename FA, typename FB>
__device__ __forceinline__ void warp_mm(float (&c)[kNt][4], FA A, FB B, int g,
                                        int q) {
  float la[kNt][4], lb[kNt][4];
  zero(la);
  zero(lb);
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const int k0 = 8 * ks;
    const Tf32 a[4] = {tf32<kAEx>(A(g, k0 + q)), tf32<kAEx>(A(g + 8, k0 + q)),
                       tf32<kAEx>(A(g, k0 + q + 4)),
                       tf32<kAEx>(A(g + 8, k0 + q + 4))};
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const Tf32 b0 = tf32<kBEx>(B(k0 + q, 8 * nt + g));
      const Tf32 b1 = tf32<kBEx>(B(k0 + q + 4, 8 * nt + g));
      if (!kAEx) mma_tf32(la[nt], a[0].lo, a[1].lo, a[2].lo, a[3].lo, b0.hi, b1.hi);
      if (!kBEx) mma_tf32(lb[nt], a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.lo, b1.lo);
      mma_tf32(c[nt], a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.hi, b1.hi);
    }
  }
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] += la[nt][e] + lb[nt][e];
}

// Tile `tile`'s r, k, logw (the block's channels) and v, dy (all D) into
// a stage, steps past S zero (w = 1).
template <typename T, int D>
__device__ __forceinline__ void stage_tile(unsigned char* st, const T* r,
                                           const T* k, const T* v,
                                           const float* logw, const float* dy,
                                           size_t base, size_t step, int i0,
                                           int tile, int S) {
  using L = Bwd<T, D>;
  constexpr int kVecT = 16 / int(sizeof(T));
  constexpr int kRowI = L::kDi / kVecT;   // 16-byte chunks of a (T) channel row
  constexpr int kRowD = D / kVecT;
  constexpr int kRowIf = L::kDi / 4;      // of an f32 channel row
  constexpr int kRowDf = D / 4;
  const int tid = threadIdx.x;
  for (int c = tid; c < kTile * kRowI; c += L::kThreads) {
    const int p = c / kRowI, x = (c % kRowI) * kVecT, t = tile * kTile + p;
    const size_t gi = base + size_t(t < S ? t : 0) * step + i0 + x;
    cp_async16(st + L::kR + (p * L::PT + x) * int(sizeof(T)), r + gi, t < S);
    cp_async16(st + L::kK + (p * L::PT + x) * int(sizeof(T)), k + gi, t < S);
  }
  for (int c = tid; c < kTile * kRowD; c += L::kThreads) {
    const int p = c / kRowD, x = (c % kRowD) * kVecT, t = tile * kTile + p;
    const size_t gj = base + size_t(t < S ? t : 0) * step + x;
    cp_async16(st + L::kV + (p * L::PVT + x) * int(sizeof(T)), v + gj, t < S);
  }
  for (int c = tid; c < kTile * kRowIf; c += L::kThreads) {
    const int p = c / kRowIf, x = (c % kRowIf) * 4, t = tile * kTile + p;
    cp_async16(st + L::kLw + (p * L::PI + x) * 4,
               logw + base + size_t(t < S ? t : 0) * step + i0 + x, t < S);
  }
  for (int c = tid; c < kTile * kRowDf; c += L::kThreads) {
    const int p = c / kRowDf, x = (c % kRowDf) * 4, t = tile * kTile + p;
    cp_async16(st + L::kDy + (p * L::PD + x) * 4,
               dy + base + size_t(t < S ? t : 0) * step + x, t < S);
  }
}

// The block's kDi rows of a (D, D) checkpoint into S0.
template <typename T, int D>
__device__ __forceinline__ void stage_state(float* s0, const float* ck) {
  using L = Bwd<T, D>;
  for (int c = threadIdx.x; c < L::kDi * D / 4; c += L::kThreads) {
    const int i = c / (D / 4), x = (c % (D / 4)) * 4;
    cp_async16(s0 + i * L::PD + x, ck + size_t(i) * D + x, true);
  }
}

// warp_mm for operands laid out by strides: a points at A(g, q), with
// A(m, k) at a[(m - g) kAm + (k - q) kAk]; b at B(q, g), with B(k, n) at
// b[(k - q) kBk + (n - g) kBn], so every fragment's offset is a constant.
template <int kSteps, int kNt, bool kAEx, bool kBEx, int kAm, int kAk, int kBk,
          int kBn, typename TA, typename TB>
__device__ __forceinline__ void warp_mm_s(float (&c)[kNt][4], const TA* a,
                                          const TB* b, int g, int q) {
  warp_mm<kSteps, kNt, kAEx, kBEx>(
      c, [&](int m, int k) { return to_f32(a[(m - g) * kAm + (k - q) * kAk]); },
      [&](int k, int n) { return to_f32(b[(k - q) * kBk + (n - g) * kBn]); }, g,
      q);
}

// The Z sums of one channel over tau = kPart, 7 - kPart, 8 + kPart and 15
// - kPart (as many pairs each): acc[t] += sum_{s < t < tau} Z[tau, s],
// Z[tau, s] = M[tau, s] (l_tau r_s) with each block's pair of factors.
template <int kPart, int PI, int PM>
__device__ __forceinline__ void z_sums(float (&acc)[kTile], const float* sRx,
                                       const float* sKx, const float* sXs,
                                       const float* sM, int ch) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int tau = m == 0 ? kPart
                    : m == 1 ? kSub - 1 - kPart
                    : m == 2 ? kSub + kPart : kTile - 1 - kPart;
    const bool late = tau >= kSub;
    const float l_same = sRx[(late ? tau + kSub : tau) * PI + ch];   // R~
    const float l_cross = late ? sXs[tau * PI + ch] : 0.f;          // r from 1's start
    float pref = 0.f;
#pragma unroll
    for (int s = 0; s < tau - 1; ++s) {
      float lr;
      if (s < kSub)
        lr = late ? l_cross * sXs[s * PI + ch] : l_same * sKx[s * PI + ch];
      else
        lr = l_same * sKx[(s + kSub) * PI + ch];
      pref += sM[tau * PM + s] * lr;
      acc[s + 1] += pref;
    }
  }
}

// A tile's prep, thread (channel, sub-chunk) of the 2 kDi it takes: the
// floored log2-decays and their sums, the rows scaled by them, and r u k
// summed over the warp's channels of the sub-chunk.
template <typename T, int D>
__device__ __forceinline__ void prep_tile(const unsigned char* st, float* P,
                                          const float* sUu, int tb) {
  using L = Bwd<T, D>;
  constexpr int PI = L::PI, PT = L::PT, kDi = L::kDi;
  const T* sr = reinterpret_cast<const T*>(st + L::kR);
  const T* sk = reinterpret_cast<const T*>(st + L::kK);
  const float* slw = reinterpret_cast<const float*>(st + L::kLw);
  const int ch = tb % kDi, half = tb / kDi;
  float l2[kSub], sum = 0.f, other = 0.f;
#pragma unroll
  for (int t = 0; t < kSub; ++t) {
    l2[t] = fmaxf(slw[(half * kSub + t) * PI + ch], kLogwFloor) * kLog2e;
    sum += l2[t];
    other += fmaxf(slw[((half ^ 1) * kSub + t) * PI + ch], kLogwFloor) * kLog2e;
  }
  const float ref = 0.5f * sum;
  const float to_other = ex2(0.5f * other);   // 2^(the other's midpoint)
  const float uu = sUu[ch];
  float la = 0.f, ruk[kSub];
#pragma unroll
  for (int t = 0; t < kSub; ++t) {
    const int row = half * kSub + t;
    const float rv = to_f32(sr[row * PT + ch]);
    const float kv = to_f32(sk[row * PT + ch]);
    const float lap = la;
    la += l2[t];
    const int xrow = half ? row + kSub : row;   // R~ / K~ rows of Rx / Kx
    P[L::pRx + xrow * PI + ch] = rv * ex2(lap - ref);
    P[L::pKx + xrow * PI + ch] = kv * ex2(ref - la);
    if (half) {          // r decayed from sub-chunk 1's start
      const float xs = rv * ex2(lap);
      P[L::pXs + row * PI + ch] = xs;
      P[L::pRx + row * PI + ch] = xs * to_other;
    } else {             // k decayed to sub-chunk 0's end
      const float xs = kv * ex2(sum - la);
      P[L::pXs + row * PI + ch] = xs;
      P[L::pKx + (row + kSub) * PI + ch] = xs * to_other;
    }
    P[L::pRs + row * PI + ch] = rv * ex2(half ? other + lap : lap);
    P[L::pKin + row * PI + ch] = kv * ex2(half ? sum - la : (sum - la) + other);
    P[L::pLam + row * PI + ch] = la;
    ruk[t] = rv * uu * kv;
  }
  if (half == 0) {
    P[L::pSum0 + ch] = sum;
    P[L::pAc + ch] = ex2(sum + other);
  } else {
    P[L::pSum1 + ch] = sum;
  }
#pragma unroll
  for (int t = 0; t < kSub; ++t)
#pragma unroll
    for (int o = L::kRedLanes / 2; o > 0; o >>= 1)
      ruk[t] += __shfl_xor_sync(0xffffffffu, ruk[t], o);
  if ((ch & (L::kRedLanes - 1)) == 0) {
#pragma unroll
    for (int t = 0; t < kSub; ++t)
      P[L::pRuk + (half * kSub + t) * L::kRukGroups + ch / L::kRedLanes] = ruk[t];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Bwd<T, D>::kThreads, Bwd<T, D>::kMinBlocks)
rwkv6_scan_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ logw,
                      const float* __restrict__ u,
                      const float* __restrict__ ckpt,
                      const float* __restrict__ dy,
                      const float* __restrict__ dstate, float* __restrict__ dr,
                      float* __restrict__ dk, float* __restrict__ dv,
                      float* __restrict__ dlogw, float* __restrict__ du_part,
                      int S, int H, int chunk_tiles) {
  using L = Bwd<T, D>;
  constexpr bool kEx = sizeof(T) == 2;        // bf16 r/k/v are exact in TF32
  constexpr int PI = L::PI, PD = L::PD, PM = L::PM, PT = L::PT, PVT = L::PVT;
  constexpr int kDi = L::kDi;
  extern __shared__ __align__(16) unsigned char smem[];
  float* f = reinterpret_cast<float*>(smem + 2 * L::kStage);
  float* sS0 = f + L::fS0;
  float* sG = f + L::fG;
  float* sPre = f + L::fPre;
  float* sSuf = f + L::fSuf;
  float* sU = f + L::fU;
  float* sM = f + L::fM;
  float* sSc = f + L::fSc;
  float* sC0 = f + L::fC0;
  float* sUu = f + L::fU_;
  float* sDyv = f + L::fDyv;

  const int bh = blockIdx.x / L::kSplit;      // b * H + h
  const int i0 = (blockIdx.x % L::kSplit) * kDi;
  const int b = bh / H, h = bh - b * H;
  const size_t step = size_t(H) * D;                 // from step t to t + 1
  const size_t base = (size_t(b) * S * H + h) * D;   // element (b, 0, h, 0)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int g = lane >> 2, q = lane & 3;
  // Two teams of kGroups warps.  Team A, warp grp: HS and VG for key
  // channels [8 grp, 8 grp + 8), their dr and dk, then the Z sums.  Team
  // B, warp grp: Kin G_end, dv and G's update on columns [8 kNtv grp, 8
  // kNtv (grp + 1)), M (grp 0) and A (grp 1); its first 2 kDi threads
  // form the next tile's prep.
  const bool team_a = warp < L::kGroups;
  const int grp = team_a ? warp : warp - L::kGroups;
  const int n0 = 8 * grp;
  const int j0 = 8 * L::kNtv * grp;
  const int tb = tid - 32 * L::kGroups;    // team B's thread index
  const int tiles = (S + kTile - 1) / kTile;
  const int nchunks = (tiles + chunk_tiles - 1) / chunk_tiles;
  auto ckpt_of = [&](int tile) {
    return ckpt + ((size_t(bh) * nchunks + tile / chunk_tiles) * D + i0) * D;
  };

  for (int e = tid; e < kDi * D; e += L::kThreads) {
    const int i = e / D, j = e - i * D;
    sG[i * PD + j] = dstate ? dstate[(size_t(bh) * D + i0 + i) * D + j] : 0.f;
  }
  for (int e = tid; e < kDi; e += L::kThreads) sUu[e] = u[h * D + i0 + e];
  stage_tile<T, D>(smem + ((tiles - 1) & 1) * L::kStage, r, k, v, logw, dy, base,
                   step, i0, tiles - 1, S);
  stage_state<T, D>(sS0, ckpt_of(tiles - 1));
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (!team_a && tb < 2 * kDi)
    prep_tile<T, D>(smem + ((tiles - 1) & 1) * L::kStage,
                    f + L::fPrep + ((tiles - 1) & 1) * L::kPrep, sUu, tb);
  float du_acc = 0.f;

  for (int tile = tiles - 1; tile >= 0; --tile) {
    const unsigned char* st = smem + (tile & 1) * L::kStage;
    const T* sr = reinterpret_cast<const T*>(st + L::kR);
    const T* sk = reinterpret_cast<const T*>(st + L::kK);
    const T* sv = reinterpret_cast<const T*>(st + L::kV);
    const float* slw = reinterpret_cast<const float*>(st + L::kLw);
    const float* sdy = reinterpret_cast<const float*>(st + L::kDy);
    const float* P = f + L::fPrep + (tile & 1) * L::kPrep;   // this tile's prep
    const float* sRx = P + L::pRx;
    const float* sKx = P + L::pKx;
    const float* sXs = P + L::pXs;
    const float* sRs = P + L::pRs;
    const float* sKin = P + L::pKin;
    const float* sLam = P + L::pLam;
    const float* sSum0 = P + L::pSum0;
    const float* sSum1 = P + L::pSum1;
    const float* sAc = P + L::pAc;
    const int t0 = tile * kTile;
    cp_async_wait<0>();
    __syncthreads();   // the tile's start state landed; its prep and the last tile are done
    if (tile > 0) {
      stage_tile<T, D>(smem + ((tile - 1) & 1) * L::kStage, r, k, v, logw, dy,
                       base, step, i0, tile - 1, S);
      cp_async_commit();
    }

    // ---- S0 past a chunk's first tile: replayed from the checkpoint ------
    if (tile % chunk_tiles != 0) {
      constexpr int kE = kDi * D / L::kThreads;   // D / 8 a thread
      float s[kE];
#pragma unroll
      for (int m = 0; m < kE; ++m) {
        const int e = tid + m * L::kThreads, i = e / D, j = e - i * D;
        s[m] = sS0[i * PD + j];
      }
      for (int p = (tile / chunk_tiles) * chunk_tiles * kTile; p < t0; ++p) {
        const size_t gp = base + size_t(p) * step;
#pragma unroll
        for (int m = 0; m < kE; ++m) {
          const int e = tid + m * L::kThreads, i = e / D, j = e - i * D;
          const float w = expf(fmaxf(logw[gp + i0 + i], kLogwFloor));
          s[m] = fmaf(w, s[m], to_f32(k[gp + i0 + i]) * to_f32(v[gp + j]));
        }
      }
#pragma unroll
      for (int m = 0; m < kE; ++m) {
        const int e = tid + m * L::kThreads, i = e / D, j = e - i * D;
        sS0[i * PD + j] = s[m];
      }
      __syncthreads();
    }

    float hs[1][4], vg[1][4], dva[L::kNtv][4];
    zero(hs);
    zero(vg);
    zero(dva);

    // ---- phase 1: the products with S0 and G_end, M and A ----------------
    if (team_a) {
      warp_mm_s<D / 8, 1, false, false, PD, 1, 1, PD>(
          hs, sdy + g * PD + q, sS0 + (n0 + g) * PD + q, g, q);
      warp_mm_s<D / 8, 1, kEx, false, PVT, 1, 1, PD>(
          vg, sv + g * PVT + q, sG + (n0 + g) * PD + q, g, q);
      // c0 = rowsum(G_end (.) S0), a quad a row
      const int i = tid >> 2, c = tid & 3;
      float a = 0.f;
#pragma unroll
      for (int m = 0; m < D / 4; ++m)
        a = fmaf(sG[i * PD + c + 4 * m], sS0[i * PD + c + 4 * m], a);
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      if (c == 0) sC0[i] = a;
    } else {
      warp_mm_s<kDi / 8, L::kNtv, false, false, PI, 1, PD, 1>(
          dva, sKin + g * PI + q, sG + q * PD + j0 + g, g, q);
      // M = dY V^T (strictly below its diagonal, dy . v on it) and A over
      // the block's channels (s < t; r u k on s = t): from 8 groups on a
      // warp for each of M's two n tiles and A's three blocks (00, 11 and
      // the cross block 10), else M on grp 0 and A on grp 1
      auto put_m = [&](const float (&mc)[4], int nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = g + 8 * (e >> 1), s = 8 * nt + 2 * q + (e & 1);
          sM[t * PM + s] = s < t ? mc[e] : 0.f;
          if (s == t) sDyv[t] = mc[e];
        }
      };
      // block 0: rows t < 8 of the product, s < 8 (and zeros for s >= 8);
      // block 1: rows t >= 8, s >= 8; block 2: rows t >= 8, s < 8
      auto put_a = [&](const float (&ac)[4], int blk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool low = e < 2;
          if (low != (blk == 0)) continue;
          const int t = g + 8 * (e >> 1), s = 8 * (blk == 1) + 2 * q + (e & 1);
          float ruk = 0.f;
#pragma unroll
          for (int gr = 0; gr < L::kRukGroups; ++gr)
            ruk += P[L::pRuk + t * L::kRukGroups + gr];
          // select: masked entries may be inf
          sSc[t * PM + s] = s < t ? ac[e] : (s == t ? ruk : 0.f);
          if (blk == 0) sSc[t * PM + s + kSub] = 0.f;
        }
      };
      auto a_block = [&](float (&ac)[1][4], int blk) {
        zero(ac);
        if (blk < 2)
          warp_mm_s<kDi / 8, 1, false, false, 2 * PI, 1, 1, 2 * PI>(
              ac, sRx + g * PI + q, sKx + (16 * blk + g) * PI + q, g, q);
        else
          warp_mm_s<kDi / 8, 1, false, false, PI, 1, 1, PI>(
              ac, sXs + g * PI + q, sXs + g * PI + q, g, q);
      };
      if (L::kGroups >= 8) {
        if (grp < 2) {
          float mc[1][4];
          zero(mc);
          warp_mm_s<D / 8, 1, false, kEx, PD, 1, 1, PVT>(
              mc, sdy + g * PD + q, sv + (8 * grp + g) * PVT + q, g, q);
          put_m(mc[0], grp);
        } else if (grp < 5) {
          float ac[1][4];
          a_block(ac, grp - 2);
          put_a(ac[0], grp - 2);
        }
      } else if (grp == 0) {
        float mc[2][4];
        zero(mc);
        warp_mm_s<D / 8, 2, false, kEx, PD, 1, 1, PVT>(
            mc, sdy + g * PD + q, sv + g * PVT + q, g, q);
        put_m(mc[0], 0);
        put_m(mc[1], 1);
      } else if (grp == 1) {
#pragma unroll
        for (int blk = 0; blk < 3; ++blk) {
          float ac[1][4];
          a_block(ac, blk);
          put_a(ac[0], blk);
        }
      }
    }
    __syncthreads();
    if (tile > 0) {             // S0's last readers are done
      stage_state<T, D>(sS0, ckpt_of(tile - 1));
      cp_async_commit();
    }

    // ---- phase 2: team A dr, dk out; team B dv out and G's update --------
    if (team_a) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = g + 8 * (e >> 1), i = n0 + 2 * q + (e & 1);
        sSuf[t * PI + i] = sRs[t * PI + i] * hs[0][e];
        sPre[t * PI + i] = sKin[t * PI + i] * vg[0][e];
      }
      float ri[1][4], ki[1][4];
      zero(ri);
      zero(ki);
      // M against Kx's 24 rows: [M00 | 0 | 0 ; 0 | M10 | M11]
      warp_mm<3, 1, false, false>(
          ri,
          [&](int m, int x) {
            if (x < kSub) return m < kSub ? sM[m * PM + x] : 0.f;
            if (x < 2 * kSub) return m >= kSub ? sM[m * PM + x - kSub] : 0.f;
            return sM[m * PM + x - kSub];
          },
          [&](int x, int n) { return sKx[x * PI + n0 + n]; }, g, q);
      // M^T against Rx's 24 rows: [M00^T | M10^T | 0 ; 0 | 0 | M11^T]
      warp_mm<3, 1, false, false>(
          ki,
          [&](int m, int x) {
            if (x < 2 * kSub) return m < kSub ? sM[x * PM + m] : 0.f;
            return m >= kSub ? sM[(x - kSub) * PM + m] : 0.f;
          },
          [&](int x, int n) { return sRx[x * PI + n0 + n]; }, g, q);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = g + 8 * hh;
        if (t0 + t >= S) continue;
        const bool h1 = t >= kSub;
        float o_dr[2], o_dk[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * hh + c, i = n0 + 2 * q + c;
          const float s0v = sSum0[i], s1v = sSum1[i];
          const float refh = 0.5f * (h1 ? s1v : s0v);
          const float la = sLam[t * PI + i];
          const float lap = (t & (kSub - 1)) ? sLam[(t - 1) * PI + i] : 0.f;
          const float fp = ex2(h1 ? s0v + lap : lap);
          const float fe = ex2(h1 ? s1v - la : (s0v - la) + s1v);
          const float dyv = sDyv[t];
          const float uu = sUu[i];
          o_dr[c] = fp * hs[0][e] + ex2(lap - refh) * ri[0][e] +
                    uu * to_f32(sk[t * PT + i]) * dyv;
          o_dk[c] = fe * vg[0][e] + ex2(refh - la) * ki[0][e] +
                    uu * to_f32(sr[t * PT + i]) * dyv;
        }
        const size_t gi = base + size_t(t0 + t) * step + i0 + n0 + 2 * q;
        *reinterpret_cast<float2*>(dr + gi) = make_float2(o_dr[0], o_dr[1]);
        *reinterpret_cast<float2*>(dk + gi) = make_float2(o_dk[0], o_dk[1]);
      }
    } else {
      warp_mm_s<2, L::kNtv, false, false, 1, PM, PD, 1>(   // dv += A^T dY
          dva, sSc + q * PM + g, sdy + q * PD + j0 + g, g, q);
#pragma unroll
      for (int nt = 0; nt < L::kNtv; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = g + 8 * hh;
          if (t0 + t >= S) continue;
          float* out = dv + base + size_t(t0 + t) * step + j0 + 8 * nt + 2 * q;
          if (L::kSplit > 1) {
            atomicAdd(out, dva[nt][2 * hh]);
            atomicAdd(out + 1, dva[nt][2 * hh + 1]);
          } else {
            *reinterpret_cast<float2*>(out) =
                make_float2(dva[nt][2 * hh], dva[nt][2 * hh + 1]);
          }
        }
      // G_start = diag(Ac) G_end + Rs^T dY
#pragma unroll
      for (int mt = 0; mt < kDi / 16; ++mt) {
        float gc[L::kNtv][4];
#pragma unroll
        for (int nt = 0; nt < L::kNtv; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 16 * mt + g + 8 * (e >> 1);
            gc[nt][e] = sAc[i] * sG[i * PD + j0 + 8 * nt + 2 * q + (e & 1)];
          }
        warp_mm_s<2, L::kNtv, false, false, 1, PI, PD, 1>(
            gc, sRs + q * PI + 16 * mt + g, sdy + q * PD + j0 + g, g, q);
#pragma unroll
        for (int nt = 0; nt < L::kNtv; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 16 * mt + g + 8 * (e >> 1);
            sG[i * PD + j0 + 8 * nt + 2 * q + (e & 1)] = gc[nt][e];
          }
      }
    }
    cp_async_wait<1>();   // this thread's copies of the next tile's inputs landed
    __syncthreads();

    // ---- phase 3: team A the Z sums; team B the next tile's prep ---------
    if (team_a) {
      const int ch = tid % kDi, part = tid / kDi;   // (channel, part)
      float acc[kTile];
#pragma unroll
      for (int t = 0; t < kTile; ++t) acc[t] = 0.f;
      switch (part) {
        case 0: z_sums<0, PI, PM>(acc, sRx, sKx, sXs, sM, ch); break;
        case 1: z_sums<1, PI, PM>(acc, sRx, sKx, sXs, sM, ch); break;
        case 2: z_sums<2, PI, PM>(acc, sRx, sKx, sXs, sM, ch); break;
        default: z_sums<3, PI, PM>(acc, sRx, sKx, sXs, sM, ch); break;
      }
#pragma unroll
      for (int t = 0; t < kTile; ++t) sU[(part * kTile + t) * PI + ch] = acc[t];
    } else if (tile > 0 && tb < 2 * kDi) {
      prep_tile<T, D>(smem + ((tile - 1) & 1) * L::kStage,
                      f + L::fPrep + ((tile - 1) & 1) * L::kPrep, sUu, tb);
    }
    __syncthreads();

    // ---- phase 4: dlogw and du, 8 lanes a channel, two steps each --------
    {
      const int ch = tid >> 3, tq = tid & 7, ta = 2 * tq;
      const float pa = sPre[ta * PI + ch], pb = sPre[(ta + 1) * PI + ch];
      const float sa = sSuf[ta * PI + ch], sb = sSuf[(ta + 1) * PI + ch];
      // sums over the lanes before (pre) and after (suf) this one
      float incl = pa + pb, sincl = sa + sb;
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        const float x = __shfl_up_sync(0xffffffffu, incl, o, 8);
        const float y = __shfl_down_sync(0xffffffffu, sincl, o, 8);
        if (tq >= o) incl += x;
        if (tq + o < 8) sincl += y;
      }
      float pre = __shfl_up_sync(0xffffffffu, incl, 1, 8);
      float suf = __shfl_down_sync(0xffffffffu, sincl, 1, 8);
      if (tq == 0) pre = 0.f;
      if (tq == 7) suf = 0.f;
      const float base_c = sAc[ch] * sC0[ch];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int t = ta + m;
        const float pre_t = m ? pre + pa : pre;
        const float suf_t = m ? suf : suf + sb;
        float zs = 0.f;
#pragma unroll
        for (int part = 0; part < L::kZParts; ++part)
          zs += sU[(part * kTile + t) * PI + ch];
        if (t0 + t < S) {
          const float lw = slw[t * PI + ch];
          const float rho = ex2(fminf(lw - kLogwFloor, 0.f) * kLog2e);
          dlogw[base + size_t(t0 + t) * step + i0 + ch] =
              rho * (((base_c + pre_t) + suf_t) + zs);
        }
        du_acc = fmaf(to_f32(sr[t * PT + ch]) * to_f32(sk[t * PT + ch]), sDyv[t],
                      du_acc);
      }
    }
  }
  du_acc += __shfl_xor_sync(0xffffffffu, du_acc, 1);
  du_acc += __shfl_xor_sync(0xffffffffu, du_acc, 2);
  du_acc += __shfl_xor_sync(0xffffffffu, du_acc, 4);
  if ((tid & 7) == 0) du_part[size_t(bh) * D + i0 + (tid >> 3)] = du_acc;
}

// dv's zeros, which the blocks of one (b, h) add their partials into.
__global__ void rwkv6_scan_bwd_zero_kernel(float4* __restrict__ out, size_t n4) {
  for (size_t e = blockIdx.x * size_t(blockDim.x) + threadIdx.x; e < n4;
       e += size_t(gridDim.x) * blockDim.x)
    out[e] = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <typename T, int D>
cudaError_t launch_d(const void* r, const void* k, const void* v,
                     const float* logw, const float* u, const float* ckpt,
                     const float* dy, const float* dstate, float* dr, float* dk,
                     float* dv, float* dlogw, float* du_part, int B, int S,
                     int H, int chunk_tiles, cudaStream_t stream) {
  using L = Bwd<T, D>;
  if (size_t(B) * H * L::kSplit > size_t(INT_MAX)) return cudaErrorInvalidValue;
  if (L::kSplit > 1) {
    const size_t n4 = size_t(B) * S * H * D / 4;
    const int blocks = int(n4 / 256 + 1 < 1024 ? n4 / 256 + 1 : 1024);
    rwkv6_scan_bwd_zero_kernel<<<blocks, 256, 0, stream>>>(
        reinterpret_cast<float4*>(dv), n4);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto kernel = rwkv6_scan_bwd_kernel<T, D>;
  static std::atomic<unsigned long long> configured{0};
  cudaError_t err = allow_smem(kernel, L::kBytes, configured);
  if (err != cudaSuccess) return err;
  kernel<<<B * H * L::kSplit, L::kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, ckpt, dy, dstate, dr, dk, dv, dlogw,
      du_part, S, H, chunk_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* logw, const float* u, const float* ckpt,
                   const float* dy, const float* dstate, float* dr, float* dk,
                   float* dv, float* dlogw, float* du_part, int B, int S, int H,
                   int D, int ct, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_d<T, 16>(r, k, v, logw, u, ckpt, dy, dstate, dr, dk, dv, dlogw, du_part, B, S, H, ct, stream);
    case 32: return launch_d<T, 32>(r, k, v, logw, u, ckpt, dy, dstate, dr, dk, dv, dlogw, du_part, B, S, H, ct, stream);
    case 64: return launch_d<T, 64>(r, k, v, logw, u, ckpt, dy, dstate, dr, dk, dv, dlogw, du_part, B, S, H, ct, stream);
    case 128: return launch_d<T, 128>(r, k, v, logw, u, ckpt, dy, dstate, dr, dk, dv, dlogw, du_part, B, S, H, ct, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The wrapper (kernels/rwkv6_scan.py: rwkv6_scan_bwd_cuda) has checked
// devices, shapes, dtypes, contiguity and 16-byte alignment and allocated
// the outputs; this re-checks what would make the launch unsafe.  dstate
// may be null; C is a positive multiple of 16.  For D 128 it first
// zeroes dv (a second kernel on the same stream).
BPD_EXPORT int rwkv6_scan_bwd(const void* r, const void* k, const void* v,
                              const void* logw, const void* u, const void* ckpt,
                              const void* dy, const void* dstate, void* dr,
                              void* dk, void* dv, void* dlogw, void* du_part,
                              int dtype, int B, int S, int H, int D, int C,
                              void* stream) {
  if (B < 1 || S < 1 || H < 1 || C < kTile || C % kTile != 0)
    return cudaErrorInvalidValue;
  for (const void* p : {r, k, v, logw, ckpt, dy, static_cast<const void*>(dv)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ct = C / kTile;
  if (dtype == kFloat32)
    return launch<float>(r, k, v, f(logw), f(u), f(ckpt), f(dy), f(dstate),
                         o(dr), o(dk), o(dv), o(dlogw), o(du_part), B, S, H, D,
                         ct, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(r, k, v, f(logw), f(u), f(ckpt), f(dy),
                                 f(dstate), o(dr), o(dk), o(dv), o(dlogw),
                                 o(du_part), B, S, H, D, ct, s);
  return cudaErrorInvalidValue;
}
