// The TF32 tensor-core route of flash attention (mma_tf32): every call that
// no other route takes, which is the fp32 prefill (the training forward and
// its remat recompute, the serving fp32 checks) and the bf16 prefill off the
// wgmma routes (hd not a multiple of 16, hd 129-575, a window over hd 128,
// rows not 16-byte aligned).  Included by flash_attention.cu, which holds
// the shared Args.  Replaces flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py:74) on those calls.
//
// What bounds it: operations.  The function does 4 * hd FLOPs a visible
// (row, key) pair (S = Q K^T and O = P V); in fp32 each product runs three
// times (split TF32, below), so 12 * hd FLOPs of mma.sync a pair, whose
// TF32 rate on the H100 is about 310 TFLOP/s (tools/mma_tf32_rate.py).
// wgmma would run TF32 at up to 495, but it takes TF32 operands only
// K-major, so P V would need V transposed in shared memory: later work.
//
// Design:
//   * Work split: one block per (batch, kv head, tile of BQ = 16 * RW rows),
//     rows being the (query, head) pairs of the kv head's G query heads
//     folded as r = i * G + g, so one K/V tile staged in shared memory
//     serves every head of the group.  Heavy (late, causal) tiles first.
//   * One pass over the block's visible key tiles of BC keys: the union of
//     its rows' ranges, widened to [0, Sk) when a row sees no key (uniform
//     weights over all Sk keys, as the reference gives).  Inside the range
//     a key a row does not see scores NEG_INF; outside it the key is
//     skipped (weight 0).  The masks (causal, window, kv_valid as an int or
//     a [B] tensor, runtime positions) are tested per element.
//   * Products: mma.sync.m16n8k8 TF32 with fp32 accumulators, a warp
//     owning 16 rows.  An fp32 operand is split into hi = tf32(x) and
//     lo = tf32(x - hi), rounded to nearest, and a product is
//     lo.hi + hi.lo + hi.hi: one TF32 rounding (2^-11) would miss the
//     2e-5 gate against the fp32 reference.  bf16 Q, K and V are exact in
//     TF32 and enter unsplit; P is split in both dtypes.  S's accumulator
//     fragment becomes P V's A operand through the permuted contraction
//     index (frag_c), V's rows read in the same order (frag_bk).
//   * Softmax: online, base 2 (scores scaled by scale * log2 e), a row's max
//     and sum over the 4 lanes that hold it.  Each tile's P V is summed in
//     a zeroed accumulator and then added to O in fp32: the tensor cores
//     truncate as they accumulate, and a sum carried through every tile
//     drifts.  out = O / max(l, 1e-30) in q's dtype.
//   * Wide heads: where a warp's 16 x hd accumulator would not fit its
//     registers (hd 256, 576), DW warps split hd; each computes S over its
//     hd slice, the slices are summed through shared memory in warp order
//     (the same bits in each warp of the group), and each keeps its slice
//     of O.  At hd 576 the fp32 Q tile alone is 74 KB for 32 rows.
//   * Staging: Q once, then K / V tiles double-buffered by 16-byte
//     cp.async (zero fill past hd and past the range), so the next tile's
//     copy overlaps this tile's products; rows not 16-byte aligned take
//     plain loads (Args.vec).
//   * Order: no atomics; every output element is written by one thread
//     after a fixed-order loop, so two calls give the same bits.
// Tile sizes per head-dim instance (Cfg) were picked by timing on the H100
// (tools/flash_fwd_variants.py).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>
#include <type_traits>

#include "mma_tf32.cuh"

namespace fmma {

using namespace tf32;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;       // the reference's mask value
constexpr int kMaxSmem = 232448;        // opt-in shared memory of a block

// RW groups of 16 rows, DW warps split hd, BC keys a tile
template <int HD> struct Cfg;
template <> struct Cfg<32> {
  static constexpr int RW = 4, DW = 1, BC = 32;
};
template <> struct Cfg<64> {
  static constexpr int RW = 4, DW = 1, BC = 32;
};
template <> struct Cfg<128> {
  static constexpr int RW = 4, DW = 1, BC = 32;
};
template <> struct Cfg<256> {
  static constexpr int RW = 4, DW = 2, BC = 16;
};
template <> struct Cfg<576> {
  static constexpr int RW = 2, DW = 4, BC = 16;
};

template <typename T, int HD>
constexpr size_t smem_bytes() {
  using C = Cfg<HD>;
  constexpr int NC = C::BC / 8;
  return (C::DW > 1 ? (size_t)C::RW * C::DW * NC * 32 * 16 : 0)
         + sizeof(T) * (size_t)(16 * C::RW + 4 * C::BC) * ld<T, HD>();
}

// x = A B^T over the k-steps [c0, c0 + 8 KS) of a warp's 16 rows ra.. of
// tile ta and NT x 8 rows of tb.  In fp32 the hi.hi, lo.hi and hi.lo terms
// go to three accumulators, with exact bf16 operands the even and odd
// k-steps to two: independent mma chains, summed in fp32 at the end.
template <typename T, int HD, int NT, int KS>
__device__ __forceinline__ void qk(float (&x)[NT][4], const T* ta, int ra,
                                   const T* tb, int c0, int g, int t) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  float ac[3][NT][4];
#pragma unroll
  for (int u = 0; u < 3; ++u)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ac[u][n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    Op fa[4];
    frag_a<T, HD, SPLIT>(fa, ta, ra, c0 + 8 * ks, g, t);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      Op fb[2];
      frag_bt<T, HD, SPLIT>(fb, tb, 8 * n, c0 + 8 * ks, g, t);
      if (SPLIT) {
        mma(ac[0][n], fa[0].hi, fa[1].hi, fa[2].hi, fa[3].hi, fb[0].hi,
            fb[1].hi);
        mma(ac[1][n], fa[0].lo, fa[1].lo, fa[2].lo, fa[3].lo, fb[0].hi,
            fb[1].hi);
        mma(ac[2][n], fa[0].hi, fa[1].hi, fa[2].hi, fa[3].hi, fb[0].lo,
            fb[1].lo);
      } else {
        mma(ac[ks & 1][n], fa[0].hi, fa[1].hi, fa[2].hi, fa[3].hi,
            fb[0].hi, fb[1].hi);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[n][e] = ac[0][n][e] + (ac[1][n][e] + ac[2][n][e]);
}

template <typename Args, typename T, int HD>
__global__ void __launch_bounds__(32 * Cfg<HD>::RW * Cfg<HD>::DW, 1)
flash_mma(const Args a) {
  using C = Cfg<HD>;
  constexpr int DW = C::DW, BC = C::BC, BQ = 16 * C::RW;
  constexpr int NTH = 32 * C::RW * DW;
  constexpr int DS = HD / DW, NC = BC / 8, ND = DS / 8;
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int LD = ld<T, HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* xch = reinterpret_cast<float4*>(smem_raw);  // [RW][DW][NC][32]
  T* Qs = reinterpret_cast<T*>(
      smem_raw + (DW > 1 ? C::RW * DW * NC * 32 * 16 : 0));
  T* Ks = Qs + BQ * LD;                 // [2][BC][LD]
  T* Vs = Ks + 2 * BC * LD;             // [2][BC][LD]

  const int nbh = a.B * a.KV, G = a.H / a.KV, rows = a.Sq * G;
  const int n_rt = (rows + BQ - 1) / BQ;
  const int bh = blockIdx.x % nbh;
  const int rt = n_rt - 1 - blockIdx.x / nbh;   // late (causal: heavy) first
  const int b = bh / a.KV, kvh = bh % a.KV, r0 = rt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp / DW, ds = warp % DW, d0 = ds * DS;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const float sl2 = a.scale * kLog2e;
  int valid = a.kv_valid ? a.kv_valid[b] : a.kv_valid_n;
  valid = min(max(valid, 0), a.Sk);

  stage<T, HD, BQ, NTH>(Qs, q, a.hd, a.vec, [&](int r) -> int64_t {
    const int rr = r0 + r;
    if (rr >= rows) return -1;
    const int i = rr / G;
    return b * a.q_sb + (int64_t)i * a.q_ss
           + (int64_t)(kvh * G + rr - i * G) * a.q_sh;
  });
  cp_commit();

  // the keys query i sees: [lo, hi) (clamped in 64 bits: pos - window + 1
  // and pos + 1 may leave int range)
  auto keys = [&](int i, int& lo, int& hi) {
    const int pos = a.q_pos ? a.q_pos[i] : a.q_offset + i;
    const long long l = a.has_window
        ? (long long)pos - (long long)a.window + 1 : 0;
    const long long h = a.causal ? (long long)pos + 1 : (long long)valid;
    lo = (int)(l < 0 ? 0 : (l > a.Sk ? a.Sk : l));
    hi = (int)(h < 0 ? 0 : (h > valid ? valid : h));
  };
  // the block's range [klo, khi), the same in every warp
  int klo = a.Sk, khi = 0;
  {
    bool none = false;
    const int i0 = r0 / G, i1 = min((r0 + BQ - 1) / G, a.Sq - 1);
    for (int i = i0 + lane; i <= i1; i += 32) {
      int lo, hi;
      keys(i, lo, hi);
      if (hi > lo) {
        klo = min(klo, lo);
        khi = max(khi, hi);
      } else {
        none = true;
      }
    }
    klo = __reduce_min_sync(0xffffffffu, klo);
    khi = __reduce_max_sync(0xffffffffu, khi);
    if (__any_sync(0xffffffffu, none)) {
      klo = 0;
      khi = a.Sk;
    }
  }
  // this lane's rows (g and g + 8 of its group) and their visible keys
  int rlo[2], rhi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r0 + rg * 16 + g + 8 * h;
    rlo[h] = rhi[h] = 0;
    if (rr < rows) keys(rr / G, rlo[h], rhi[h]);
  }

  const int t_lo = (klo / BC) * BC;
  auto stage_kv = [&](int j0, int s) {
    stage<T, HD, BC, NTH>(Ks + s * BC * LD, k, a.hd, a.vec,
                          [&](int j) -> int64_t {
      return j0 + j < khi ? b * a.k_sb + (int64_t)(j0 + j) * a.k_ss
                            + kvh * a.k_sh : -1; });
    stage<T, HD, BC, NTH>(Vs + s * BC * LD, v, a.hd, a.vec,
                          [&](int j) -> int64_t {
      return j0 + j < khi ? b * a.v_sb + (int64_t)(j0 + j) * a.v_ss
                            + kvh * a.v_sh : -1; });
  };
  float4* xs = xch + (rg * DW + ds) * NC * 32;     // this warp's slots
  const float4* xg = xch + rg * DW * NC * 32;      // its group's first

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  if (t_lo < khi) stage_kv(t_lo, 0);
  cp_commit();
  for (int j0 = t_lo, s = 0; j0 < khi; j0 += BC, s ^= 1) {
    if (j0 + BC < khi) stage_kv(j0 + BC, s ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const T* Kb = Ks + s * BC * LD;
    const T* Vb = Vs + s * BC * LD;
    float sc[NC][4];
    qk<T, HD, NC, DS / 8>(sc, Qs, rg * 16, Kb, d0, g, t);
    if (DW > 1) {
      xput<NC>(xs, lane, sc);
      __syncthreads();
      xsum<NC, DW>(xg, NC * 32, lane, sc);
    }
    // masks and the online softmax; P in sc's registers
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = j0 + 8 * n + 2 * t + e;
          float x = sc[n][2 * h + e] * sl2;
          if (key < klo || key >= khi) x = -CUDART_INF_F;       // skipped
          else if (key < rlo[h] || key >= rhi[h]) x = kNegInf;  // masked
          sc[n][2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = ex2(m[h] - mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(sc[n][2 * h + e] - mx);
          sum += p;
          sc[n][2 * h + e] = p;
        }
      l[h] = l[h] * corr + sum;
      m[h] = mx;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * h] *= corr;
        acc[n][2 * h + 1] *= corr;
      }
    }
    // this tile's P V over the warp's hd slice in a zeroed accumulator,
    // then one fp32 add
    Op fp[NC][4];
#pragma unroll
    for (int kk = 0; kk < NC; ++kk) frag_c(fp[kk], sc[kk]);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      float tv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NC; ++kk) {
        Op fv[2];
        frag_bk<T, HD, SPLIT>(fv, Vb, 8 * kk, d0 + 8 * n, g, t);
        mma3<true, SPLIT>(tv, fp[kk], fv);
      }
      add4(acc[n], tv);
    }
    __syncthreads();                    // before the next tile's copies
  }
  cp_wait<0>();

  // ---- out = O / max(l, 1e-30) in q's dtype, layout [B, Sq, H, hd]
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int rr = r0 + rg * 16 + g + 8 * h;
    if (rr >= rows) continue;
    const int i = rr / G;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    T* row = out + (((int64_t)b * a.Sq + i) * a.H + kvh * G + rr - i * G)
                   * a.hd;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = d0 + 8 * n + 2 * t + e;
        if (c < a.hd) store(row + c, acc[n][2 * h + e] * inv);
      }
  }
}

template <typename Args, typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<HD>;
  constexpr int BQ = 16 * C::RW, NTH = 32 * C::RW * C::DW;
  constexpr size_t smem = smem_bytes<T, HD>();
  static_assert(smem <= kMaxSmem, "flash_mma block over the shared memory");
  static bool configured = false;       // one attribute call per variant
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_mma<Args, T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int rows = a.Sq * (a.H / a.KV);
  const unsigned blocks = (unsigned)((rows + BQ - 1) / BQ) * a.B * a.KV;
  flash_mma<Args, T, HD><<<blocks, NTH, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Args, typename T>
int dispatch(const Args& a, cudaStream_t stream) {
  if (a.hd <= 32) return launch<Args, T, 32>(a, stream);
  if (a.hd <= 64) return launch<Args, T, 64>(a, stream);
  if (a.hd <= 128) return launch<Args, T, 128>(a, stream);
  if (a.hd <= 256) return launch<Args, T, 256>(a, stream);
  return launch<Args, T, 576>(a, stream);
}

}  // namespace fmma
