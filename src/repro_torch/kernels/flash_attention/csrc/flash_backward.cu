// Hopper (sm_90a) flash attention backward: dQ, dK and dV of the forward
// kernels' function (flash_attention.cu, flash_tc.cuh).  The JAX package
// has no backward Pallas kernel (jax.value_and_grad differentiates its jnp
// attention), so this kernel replaces none; it is what makes the port's
// attention differentiable on the card (ops.py wraps forward and backward
// in a torch.autograd.Function).
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  The
// entry point launches on the caller's stream, allocates nothing (lse and
// delta scratch come from the caller), does not synchronise, and returns
// cudaGetLastError().
//
// What it computes (autograd through ref.attention_ref, model layout):
//   q, dq [B, Sq, H, hd], k, v, dk, dv [B, Sk, KV, hd], o, do [B, Sq, H,
//   hd], H = KV * G.  q, k, v, o and do are read in place through their
//   strides (last dim contiguous); dq, dk, dv are written contiguous.
//   Query i sits at q_pos[i] (or q_offset + i); key j counts when j <= pos
//   (causal) and j > pos - window (window); every key j < Sk is valid (the
//   wrapper refuses kv_valid under autograd).  With s = scale * q.k over
//   the visible keys, P = softmax(s) and lse the row's log-sum-exp:
//     dV_j = sum_i P_ij dO_i            (summed over the G query heads)
//     dS_ij = P_ij (dO_i . V_j - D_i),  D_i = dO_i . O_i
//     dQ_i = scale sum_j dS_ij K_j,     dK_j = scale sum_i dS_ij Q_i
//   A row that sees no key has uniform weights 1 / Sk over all Sk keys in
//   the forward (every score NEG_INF): it adds dO_i / Sk to every dV_j and
//   nothing to dQ or dK (its scores do not depend on q or k).
//
// What bounds it: operations.  The function needs 10 * hd FLOPs a visible
// (row, key) pair (S, dP, dV, dK, dQ); this design does 14 * hd (S and dP
// in both kernels), and in fp32 each product runs three times (split TF32,
// below): 42 * hd FLOPs of mma.sync, whose TF32 rate on the H100 is about
// 310 TFLOP/s (tools/mma_tf32_rate.py), well under wgmma's 495.
//
// Design: every product on the tensor cores, two kernels, no atomics.
//   dq_mma   one block per (b, kv head, tile of 16 * RW query rows), rows
//            being the (query, head) pairs of the kv head's G heads, heavy
//            (late, causal) tiles first.  D = dO . O per row (fp32 FMAs),
//            then one pass over the visible key tiles: S = Q K^T and
//            dP = dO V^T, the row's softmax online (running max and sum,
//            base 2, as the forward takes it), dS, and dQ += dS K in
//            registers, rescaled when the max grows and divided by the sum
//            at the end.  Writes lse (base 2) and D to scratch.
//   dkdv_mma one block per (b, kv head, pair of key tiles p and n - 1 - p
//            of 16 * KW keys: under a causal mask the pair evens the
//            blocks' work): K and V of a tile stay in shared memory while
//            the block walks every query-row tile that can see them (all G
//            heads), computing S^T = K Q^T and dP^T = V dO^T, P^T and dS^T
//            from the saved lse and D, and dV += P^T dO, dK += dS^T Q in
//            registers.
// Warps: a warp owns 16 rows (dq) or 16 keys (dkdv), so S (or S^T) lies in
// its own mma accumulators.  An accumulator fragment feeds the next
// product's A operand with no shuffle: the contraction index of an m16n8k8
// tile is permuted (slot t holds column 2t, slot t + 4 column 2t + 1), and
// the B operand's rows are read in the same order.  Where a warp's 16 x hd
// output would not fit its registers (hd 128 in dkdv, 256, 576), DW warps
// split hd, each computes S and dP over its hd slice, and the slices are
// summed through shared memory in warp order (the same bits in every warp
// of the group).
// Products: mma.sync.m16n8k8 TF32 with fp32 accumulators.  An fp32 operand
// x is split into hi = tf32(x) and lo = tf32(x - hi); a product is
// lo.hi + hi.lo + hi.hi ("3xTF32"), within a few fp32 roundoffs of an fp32
// FMA loop.  bf16 q, k, v and do are exact in TF32 and enter unsplit; P
// and dS are fp32 and are split in both dtypes.  The tensor cores truncate
// as they accumulate, so a sum that runs over many tiles (dQ, dK, dV) is
// taken one tile at a time in zeroed accumulators and added in fp32.
// Staging: tiles go to shared memory with cp.async (16-byte chunks, zero
// fill past hd and past the last row), double-buffered: the next K/V tile
// (dq) or Q/dO tile (dkdv) loads while the current one multiplies.  Rows
// that are not 16-byte aligned (odd strides) are staged by plain loads.
// bf16 tiles stay bf16 in shared memory and widen as fragments are built.
// A tile's rows are padded by one 16-byte chunk, so both the row-major
// fragment reads and the permuted column reads hit 32 banks.
// Masks: a dq block visits only the key tiles between its rows' lowest and
// highest visible key; a dkdv block only the row tiles with a row that sees
// one of its keys (or sees none at all); inside a tile the mask is tested
// per element.
// Every output element is written by one thread of one block after a
// fixed-order loop: no atomics, and two calls give the same bits.  Head
// dims 1..576 run on instances padded to HD = 32, 64, 128, 256 and 576.
// The operand split, the mma wrappers, the fragments and the staging are
// in mma_tf32.cuh, shared with the forward's TF32 route (flash_mma.cuh).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>
#include <type_traits>

#include "mma_tf32.cuh"

namespace fa_bwd {

using namespace tf32;

constexpr int kF32 = 0;                 // dtype codes shared with the wrapper
constexpr int kBF16 = 1;
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void* q; const void* k; const void* v; const void* o;
  const void* dout;
  void* dq; void* dk; void* dv;
  float* lse; float* delta;             // scratch [B * KV * Sq * G] each
  int B, Sq, Sk, H, KV, hd;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh, d_sb, d_ss, d_sh;
  const int* q_pos; int q_offset;
  int causal, has_window, window;
  float scale;
  int vec;    // bit 0 q, 1 k, 2 v, 3 do: every row starts 16-byte aligned
};

// dq: RW groups of 16 rows, QDW warps split hd, BC keys a tile.
// dkdv: KW groups of 16 keys, KDW warps split hd, BR rows a tile.
// Sized so that accumulators stay in registers and, at HD 576, so that
// fp32 tiles fill the 227 KB a block may have; chosen by timing on the
// H100 at Qwen2's, Whisper's and MLA's training shapes
// (tools/flash_bwd_variants.py).  ptxas reports small spills in
// dkdv_mma<float, 64> (28 bytes) and dkdv_mma<float, 576> (8 bytes): the
// configurations that spill nothing ran slower there.
template <int HD> struct Cfg;
template <> struct Cfg<32> {
  static constexpr int RW = 4, QDW = 1, BC = 32, KW = 4, KDW = 1, BR = 32;
};
template <> struct Cfg<64> {
  static constexpr int RW = 4, QDW = 1, BC = 32, KW = 4, KDW = 1, BR = 32;
};
template <> struct Cfg<128> {
  static constexpr int RW = 4, QDW = 1, BC = 16, KW = 4, KDW = 2, BR = 32;
};
template <> struct Cfg<256> {
  static constexpr int RW = 4, QDW = 2, BC = 16, KW = 2, KDW = 4, BR = 16;
};
template <> struct Cfg<576> {
  static constexpr int RW = 2, QDW = 4, BC = 8, KW = 2, KDW = 4, BR = 8;
};

// rr / G for 0 <= rr < 2^24 (rows of one (b, kv head)): a float estimate,
// corrected by one step either way
__device__ __forceinline__ int div_g(int rr, int G, float inv_g) {
  int i = __float2int_rz((float)rr * inv_g);
  i += (i + 1) * G <= rr;
  i -= i * G > rr;
  return i;
}

// the keys a query at position pos sees: [lo, hi)
__device__ __forceinline__ void keys_at(const BwdArgs& a, int pos, int& lo,
                                        int& hi) {
  // clamp in 64 bits: pos - window + 1 and pos + 1 may leave int range
  const long long l = a.has_window
      ? (long long)pos - (long long)a.window + 1 : 0;
  const long long h = a.causal ? (long long)pos + 1 : (long long)a.Sk;
  lo = (int)(l < 0 ? 0 : (l > a.Sk ? a.Sk : l));
  hi = (int)(h < 0 ? 0 : (h > a.Sk ? a.Sk : h));
}
// the keys query i sees
__device__ __forceinline__ void key_range(const BwdArgs& a, int i, int& lo,
                                          int& hi) {
  keys_at(a, a.q_pos ? a.q_pos[i] : a.q_offset + i, lo, hi);
}

// x = A_x B_x^T and y = A_y B_y^T over the k-steps [c0, c0 + 8 KS) of a
// warp's 16 rows ra.. of tiles tax, tay and NT x 8 rows of tbx, tby (S and
// dP; S^T and dP^T).  In fp32 the hi.hi, lo.hi and hi.lo terms go to three
// accumulators (two, the small terms sharing one, when NT >= 4 tiles give
// enough independent chains and registers are short), with exact bf16
// operands the even and odd k-steps to two: independent mma chains, summed
// in fp32 at the end.
template <typename T, int HD, int NT, int KS>
__device__ __forceinline__ void qk_pair(float (&x)[NT][4], float (&y)[NT][4],
                                        const T* tax, const T* tay, int ra,
                                        const T* tbx, const T* tby, int c0,
                                        int g, int t) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int LAST = NT >= 4 ? 1 : 2;     // the hi.lo terms' accumulator
  float ax[3][NT][4], ay[3][NT][4];
#pragma unroll
  for (int u = 0; u < 3; ++u)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ax[u][n][e] = ay[u][n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    Op fx[4], fy[4];
    frag_a<T, HD, SPLIT>(fx, tax, ra, c0 + 8 * ks, g, t);
    frag_a<T, HD, SPLIT>(fy, tay, ra, c0 + 8 * ks, g, t);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      Op bx[2], by[2];
      frag_bt<T, HD, SPLIT>(bx, tbx, 8 * n, c0 + 8 * ks, g, t);
      frag_bt<T, HD, SPLIT>(by, tby, 8 * n, c0 + 8 * ks, g, t);
      if (SPLIT) {
        mma(ax[0][n], fx[0].hi, fx[1].hi, fx[2].hi, fx[3].hi, bx[0].hi,
            bx[1].hi);
        mma(ay[0][n], fy[0].hi, fy[1].hi, fy[2].hi, fy[3].hi, by[0].hi,
            by[1].hi);
        mma(ax[1][n], fx[0].lo, fx[1].lo, fx[2].lo, fx[3].lo, bx[0].hi,
            bx[1].hi);
        mma(ay[1][n], fy[0].lo, fy[1].lo, fy[2].lo, fy[3].lo, by[0].hi,
            by[1].hi);
        mma(ax[LAST][n], fx[0].hi, fx[1].hi, fx[2].hi, fx[3].hi, bx[0].lo,
            bx[1].lo);
        mma(ay[LAST][n], fy[0].hi, fy[1].hi, fy[2].hi, fy[3].hi, by[0].lo,
            by[1].lo);
      } else {
        mma(ax[ks & 1][n], fx[0].hi, fx[1].hi, fx[2].hi, fx[3].hi,
            bx[0].hi, bx[1].hi);
        mma(ay[ks & 1][n], fy[0].hi, fy[1].hi, fy[2].hi, fy[3].hi,
            by[0].hi, by[1].hi);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[n][e] = ax[0][n][e] + (ax[1][n][e] + ax[2][n][e]);
      y[n][e] = ay[0][n][e] + (ay[1][n][e] + ay[2][n][e]);
    }
}

template <typename T, int HD>
constexpr size_t dq_smem() {
  using C = Cfg<HD>;
  constexpr int BQ = 16 * C::RW, NC = C::BC / 8;
  return (C::QDW > 1 ? (size_t)C::RW * C::QDW * 2 * NC * 32 * 16 : 0)
         + sizeof(T) * (size_t)(2 * BQ + 4 * C::BC) * ld<T, HD>() + 4 * BQ;
}

template <typename T, int HD>
constexpr size_t dkdv_smem() {
  using C = Cfg<HD>;
  constexpr int BK = 16 * C::KW, NR = C::BR / 8;
  return (C::KDW > 1 ? (size_t)C::KW * C::KDW * 2 * NR * 32 * 16 : 0)
         + sizeof(T) * (size_t)(2 * BK + 4 * C::BR) * ld<T, HD>()
         + 12 * 2 * C::BR;
}

// ---------------------------------------------------------------------------
// dq_mma: D per row, then one pass over the key tiles for dQ and lse
// ---------------------------------------------------------------------------
// The row's softmax is taken online, as the forward does: with m the
// running max of the (base 2) scores and l = sum 2^(s - m),
//   dQ_i = scale / l_i * sum_j 2^(s_ij - m_i) (dP_ij - D_i) K_j,
// the sum rescaled by 2^(m_old - m_new) when m grows, and
// lse_i = m_i + log2 l_i at the end: no separate pass for lse.
template <typename T, int HD>
__global__ void __launch_bounds__(32 * Cfg<HD>::RW * Cfg<HD>::QDW, 1)
dq_mma(BwdArgs a) {
  using C = Cfg<HD>;
  constexpr int DW = C::QDW, BC = C::BC, BQ = 16 * C::RW;
  constexpr int NTH = 32 * C::RW * DW, NW = NTH / 32;
  constexpr int DS = HD / DW, NC = BC / 8, ND = DS / 8;
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int LD = ld<T, HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* xch = reinterpret_cast<float4*>(smem_raw);  // [RW][DW][2][NC][32]
  T* Qs = reinterpret_cast<T*>(
      smem_raw + (DW > 1 ? C::RW * DW * 2 * NC * 32 * 16 : 0));
  T* dOs = Qs + BQ * LD;                // [BQ][LD]
  T* Ks = dOs + BQ * LD;                // [2][BC][LD]
  T* Vs = Ks + 2 * BC * LD;             // [2][BC][LD]
  float* D_s = reinterpret_cast<float*>(Vs + 2 * BC * LD);  // [BQ]

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
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);
  const float sl2 = a.scale * kLog2e;

  const float inv_g = 1.f / (float)G;
  auto row_off = [&](int r, int64_t sb, int64_t ss, int64_t sh) -> int64_t {
    const int rr = r0 + r;
    if (rr >= rows) return -1;
    const int i = div_g(rr, G, inv_g);
    return b * sb + (int64_t)i * ss + (int64_t)(kvh * G + rr - i * G) * sh;
  };
  stage<T, HD, BQ, NTH>(Qs, q, a.hd, a.vec & 1, [&](int r) {
    return row_off(r, a.q_sb, a.q_ss, a.q_sh); });
  stage<T, HD, BQ, NTH>(dOs, dout, a.hd, a.vec & 8, [&](int r) {
    return row_off(r, a.d_sb, a.d_ss, a.d_sh); });
  cp_commit();

  // the tile's visible keys [klo, khi), the same in every warp
  int klo = a.Sk, khi = 0;
  {
    const int i0 = r0 / G, i1 = min((r0 + BQ - 1) / G, a.Sq - 1);
    for (int i = i0 + lane; i <= i1; i += 32) {
      int lo, hi;
      key_range(a, i, lo, hi);
      if (hi > lo) { klo = min(klo, lo); khi = max(khi, hi); }
    }
    klo = __reduce_min_sync(0xffffffffu, klo);
    khi = __reduce_max_sync(0xffffffffu, khi);
  }
  // this lane's rows (g and g + 8 of its group) and their visible keys
  int rlo[2], rhi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r0 + rg * 16 + g + 8 * h;
    rlo[h] = rhi[h] = 0;
    if (rr < rows) key_range(a, rr / G, rlo[h], rhi[h]);
  }
  // D = dO . O per row (fp32 FMAs in a fixed order)
  for (int r = warp; r < BQ; r += NW) {
    float s = 0.f;
    const int64_t od = row_off(r, a.o_sb, a.o_ss, a.o_sh);
    const int64_t dd = row_off(r, a.d_sb, a.d_ss, a.d_sh);
    if (od >= 0)
      for (int d = lane; d < a.hd; d += 32)
        s = fmaf(f32(dout[dd + d]), f32(o[od + d]), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) D_s[r] = s;
  }
  __syncthreads();
  const float Dr[2] = {D_s[rg * 16 + g], D_s[rg * 16 + g + 8]};

  const int t_lo = (klo / BC) * BC;
  auto stage_kv = [&](int j0, int s) {
    stage<T, HD, BC, NTH>(Ks + s * BC * LD, k, a.hd, a.vec & 2,
                          [&](int j) -> int64_t {
      return j0 + j < a.Sk ? b * a.k_sb + (int64_t)(j0 + j) * a.k_ss
                             + kvh * a.k_sh : -1; });
    stage<T, HD, BC, NTH>(Vs + s * BC * LD, v, a.hd, a.vec & 4,
                          [&](int j) -> int64_t {
      return j0 + j < a.Sk ? b * a.v_sb + (int64_t)(j0 + j) * a.v_ss
                             + kvh * a.v_sh : -1; });
  };
  float4* xs = xch + ((rg * DW + ds) * 2) * NC * 32;     // this warp's slots
  const float4* xg = xch + (rg * DW * 2) * NC * 32;      // its group's first

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
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
    float sc[NC][4], dp[NC][4];
    qk_pair<T, HD, NC, DS / 8>(sc, dp, Qs, dOs, rg * 16, Kb, Vb, d0, g, t);
    if (DW > 1) {
      xput<NC>(xs, lane, sc);
      xput<NC>(xs + NC * 32, lane, dp);
      __syncthreads();
      xsum<NC, DW>(xg, 2 * NC * 32, lane, sc);
      xsum<NC, DW>(xg + NC * 32, 2 * NC * 32, lane, dp);
    }
    // online softmax; dS before the 1 / l in dp's registers
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = j0 + 8 * n + 2 * t + e;
          const bool vis = key >= rlo[h] && key < rhi[h];
          const float x = vis ? sc[n][2 * h + e] * sl2 : -CUDART_INF_F;
          sc[n][2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[h], mx);
      // nothing visible yet: no scores, nothing to rescale
      const float mu = mn == -CUDART_INF_F ? 0.f : mn;
      const float corr = ex2(m[h] - mu);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(sc[n][2 * h + e] - mu);   // 0 where masked
          sum += p;
          dp[n][2 * h + e] = p * (dp[n][2 * h + e] - Dr[h]);
        }
      l[h] = l[h] * corr + sum;
      m[h] = mn;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * h] *= corr;
        acc[n][2 * h + 1] *= corr;
      }
    }
    // this tile's dS K in a zeroed accumulator, then one fp32 add: the
    // tensor cores truncate as they accumulate, and a sum carried through
    // every key tile would drift toward zero
    Op fs[NC][4];
#pragma unroll
    for (int kk = 0; kk < NC; ++kk) frag_c(fs[kk], dp[kk]);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      float tq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NC; ++kk) {
        Op fk[2];
        frag_bk<T, HD, SPLIT>(fk, Kb, 8 * kk, d0 + 8 * n, g, t);
        mma3<true, SPLIT>(tq, fs[kk], fk);
      }
      add4(acc[n], tq);
    }
    __syncthreads();
  }
  cp_wait<0>();
  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int rr = r0 + rg * 16 + g + 8 * h;
    if (rr >= rows) continue;
    if (ds == 0 && t == 0) {
      // a row with no visible key: lse = +inf marks it (uniform weights)
      const int64_t idx = (int64_t)bh * rows + rr;
      a.lse[idx] = lt > 0.f ? m[h] + log2f(lt) : CUDART_INF_F;
      a.delta[idx] = Dr[h];
    }
    const float f = lt > 0.f ? a.scale / lt : 0.f;
    T* row = dq + (((int64_t)b * a.Sq + rr / G) * a.H + kvh * G + rr % G)
                  * a.hd;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = d0 + 8 * n + 2 * t + e;
        if (c < a.hd) store(row + c, f * acc[n][2 * h + e]);
      }
  }
}

// ---------------------------------------------------------------------------
// dkdv_mma: dK and dV of a key tile over every row tile that sees it
// ---------------------------------------------------------------------------
// A block takes key tiles p and n - 1 - p in turn: under a causal mask the
// early tiles see the most rows, and the pair evens the blocks' work.
template <typename T, int HD>
__global__ void __launch_bounds__(32 * Cfg<HD>::KW * Cfg<HD>::KDW, 1)
dkdv_mma(BwdArgs a) {
  using C = Cfg<HD>;
  constexpr int DW = C::KDW, BR = C::BR, BK = 16 * C::KW;
  constexpr int NTH = 32 * C::KW * DW;
  constexpr int DS = HD / DW, NR = BR / 8, ND = DS / 8;
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int LD = ld<T, HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* xch = reinterpret_cast<float4*>(smem_raw);  // [KW][DW][2][NR][32]
  T* Ks = reinterpret_cast<T*>(
      smem_raw + (DW > 1 ? C::KW * DW * 2 * NR * 32 * 16 : 0));
  T* Vs = Ks + BK * LD;                 // [BK][LD]
  T* Qs = Vs + BK * LD;                 // [2][BR][LD]
  T* dOs = Qs + 2 * BR * LD;            // [2][BR][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BR * LD);  // [2][BR]
  float* D_s = lse_s + 2 * BR;          // [2][BR]
  int* pos_s = reinterpret_cast<int*>(D_s + 2 * BR);           // [2][BR]

  const int nbh = a.B * a.KV, G = a.H / a.KV, rows = a.Sq * G;
  const int n_rt = (rows + BR - 1) / BR, n_kt = (a.Sk + BK - 1) / BK;
  const int bh = blockIdx.x % nbh, pair = blockIdx.x / nbh;
  const int b = bh / a.KV, kvh = bh % a.KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kg = warp / DW, ds = warp % DW, d0 = ds * DS;
  const float sl2 = a.scale * kLog2e, inv_sk = 1.f / (float)a.Sk;
  const float inv_g = 1.f / (float)G;
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  float4* xs = xch + ((kg * DW + ds) * 2) * NR * 32;
  const float4* xg = xch + (kg * DW * 2) * NR * 32;
  auto row_off = [&](int rr, int64_t sb, int64_t ss, int64_t sh) -> int64_t {
    if (rr >= rows) return -1;
    const int i = div_g(rr, G, inv_g);
    return b * sb + (int64_t)i * ss + (int64_t)(kvh * G + rr - i * G) * sh;
  };

  for (int which = 0; which < 2; ++which) {
    const int kt = which ? n_kt - 1 - pair : pair;
    if (which && kt == pair) break;
    const int j0 = kt * BK, j1 = min(j0 + BK, a.Sk);
    stage<T, HD, BK, NTH>(Ks, static_cast<const T*>(a.k), a.hd, a.vec & 2,
                          [&](int j) -> int64_t {
      return j0 + j < a.Sk ? b * a.k_sb + (int64_t)(j0 + j) * a.k_ss
                             + kvh * a.k_sh : -1; });
    stage<T, HD, BK, NTH>(Vs, static_cast<const T*>(a.v), a.hd, a.vec & 4,
                          [&](int j) -> int64_t {
      return j0 + j < a.Sk ? b * a.v_sb + (int64_t)(j0 + j) * a.v_ss
                             + kvh * a.v_sh : -1; });

    // Row tile rt is needed when one of its rows sees a key of this tile or
    // sees no key at all.  next() walks the needed tiles in order: each
    // lane tests one of 32 tiles, a ballot keeps the answers (the same in
    // every warp).
    auto needed = [&](int rt) -> bool {
      if (rt >= n_rt) return false;
      const int i0 = rt * BR / G;
      const int i1 = min((rt * BR + BR - 1) / G, a.Sq - 1);
      for (int i = i0; i <= i1; ++i) {
        int lo, hi;
        key_range(a, i, lo, hi);
        if (hi <= lo || (lo < j1 && hi > j0)) return true;
      }
      return false;
    };
    uint32_t pending = 0;
    int base = -32;
    auto next = [&]() -> int {
      while (pending == 0) {
        base += 32;
        if (base >= n_rt) return n_rt;
        pending = __ballot_sync(0xffffffffu, needed(base + lane));
      }
      const int bit = __ffs(pending) - 1;
      pending &= pending - 1;
      return base + bit;
    };
    // Q, dO, lse, D and the positions of row tile rt into buffer s, all
    // by cp.async (a load the thread waited for would hold the block)
    auto stage_rows = [&](int rt, int s) {
      const int r0 = rt * BR;
      stage<T, HD, BR, NTH>(Qs + s * BR * LD, q, a.hd, a.vec & 1,
                            [&](int r) {
        return row_off(r0 + r, a.q_sb, a.q_ss, a.q_sh); });
      stage<T, HD, BR, NTH>(dOs + s * BR * LD, dout, a.hd, a.vec & 8,
                            [&](int r) {
        return row_off(r0 + r, a.d_sb, a.d_ss, a.d_sh); });
      for (int r = threadIdx.x; r < BR; r += NTH) {
        const int rr = r0 + r;
        if (rr < rows) {
          const int i = div_g(rr, G, inv_g);
          if (a.q_pos) cp4(pos_s + s * BR + r, a.q_pos + i);
          else pos_s[s * BR + r] = a.q_offset + i;
          const int64_t idx = (int64_t)bh * rows + rr;
          cp4(lse_s + s * BR + r, a.lse + idx);
          cp4(D_s + s * BR + r, a.delta + idx);
        } else {                        // past the last row (masked below)
          pos_s[s * BR + r] = 0;
          lse_s[s * BR + r] = D_s[s * BR + r] = 0.f;
        }
      }
    };

    float dk[ND][4], dv[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

    int rt = next();
    if (rt < n_rt) stage_rows(rt, 0);
    cp_commit();
    for (int s = 0; rt < n_rt; s ^= 1) {
      const int rt_next = next();
      if (rt_next < n_rt) stage_rows(rt_next, s ^ 1);
      cp_commit();
      cp_wait<1>();
      __syncthreads();
      const T* Qb = Qs + s * BR * LD;
      const T* dOb = dOs + s * BR * LD;
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BR rows
      float st[NR][4], dpt[NR][4];
      qk_pair<T, HD, NR, DS / 8>(st, dpt, Ks, Vs, kg * 16, Qb, dOb, d0, g,
                                 t);
      if (DW > 1) {
        xput<NR>(xs, lane, st);
        xput<NR>(xs + NR * 32, lane, dpt);
        __syncthreads();
        xsum<NR, DW>(xg, 2 * NR * 32, lane, st);
        xsum<NR, DW>(xg + NR * 32, 2 * NR * 32, lane, dpt);
      }
      // P^T into st, dS^T into dpt
#pragma unroll
      for (int n = 0; n < NR; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + kg * 16 + g + 8 * (e / 2);
          const int rl = 8 * n + 2 * t + (e & 1), r = s * BR + rl;
          const float lse = lse_s[r];
          int lo, hi;
          keys_at(a, pos_s[r], lo, hi);
          const bool vis = key >= lo && key < hi && rt * BR + rl < rows;
          const float p = vis ? ex2(st[n][e] * sl2 - lse)
                              : (lse == CUDART_INF_F ? inv_sk : 0.f);
          st[n][e] = p;
          dpt[n][e] = vis ? p * (dpt[n][e] - D_s[r]) : 0.f;
        }
      // dV += P^T dO, dK += dS^T Q over this warp's hd slice (each row
      // tile's sum in zeroed accumulators, then one fp32 add, as for dQ)
      Op fp[NR][4], fs[NR][4];
#pragma unroll
      for (int kk = 0; kk < NR; ++kk) {
        frag_c(fp[kk], st[kk]);
        frag_c(fs[kk], dpt[kk]);
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        float tv[4] = {0.f, 0.f, 0.f, 0.f}, tk[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < NR; ++kk) {
          Op fo[2], fq[2];
          frag_bk<T, HD, SPLIT>(fo, dOb, 8 * kk, d0 + 8 * n, g, t);
          frag_bk<T, HD, SPLIT>(fq, Qb, 8 * kk, d0 + 8 * n, g, t);
          mma3<true, SPLIT>(tv, fp[kk], fo);
          mma3<true, SPLIT>(tk, fs[kk], fq);
        }
        add4(dv[n], tv);
        add4(dk[n], tk);
      }
      __syncthreads();
      rt = rt_next;
    }
    cp_wait<0>();
    __syncthreads();                    // K and V free for the next tile
    T* dkp = static_cast<T*>(a.dk);
    T* dvp = static_cast<T*>(a.dv);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = j0 + kg * 16 + g + 8 * h;
      if (key >= a.Sk) continue;
      const int64_t row = (((int64_t)b * a.Sk + key) * a.KV + kvh) * a.hd;
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = d0 + 8 * n + 2 * t + e;
          if (c < a.hd) {
            store(dkp + row + c, a.scale * dk[n][2 * h + e]);
            store(dvp + row + c, dv[n][2 * h + e]);
          }
        }
    }
  }
}

template <typename T, int HD>
int launch(const BwdArgs& a, cudaStream_t stream) {
  using C = Cfg<HD>;
  constexpr int BQ = 16 * C::RW, BK = 16 * C::KW;
  const int G = a.H / a.KV, nbh = a.B * a.KV;
  const size_t dq_bytes = dq_smem<T, HD>(), kv_bytes = dkdv_smem<T, HD>();
  cudaFuncSetAttribute(dq_mma<T, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)dq_bytes);
  cudaFuncSetAttribute(dkdv_mma<T, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kv_bytes);
  const int g1 = (a.Sq * G + BQ - 1) / BQ * nbh;
  dq_mma<T, HD><<<g1, 32 * C::RW * C::QDW, dq_bytes, stream>>>(a);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return (int)e1;
  const int g2 = ((a.Sk + BK - 1) / BK + 1) / 2 * nbh;    // pairs of tiles
  dkdv_mma<T, HD><<<g2, 32 * C::KW * C::KDW, kv_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const BwdArgs& a, cudaStream_t s) {
  if (a.hd <= 32) return launch<T, 32>(a, s);
  if (a.hd <= 64) return launch<T, 64>(a, s);
  if (a.hd <= 128) return launch<T, 128>(a, s);
  if (a.hd <= 256) return launch<T, 256>(a, s);
  return launch<T, 576>(a, s);
}

}  // namespace fa_bwd

extern "C" {

// sizeof(BwdArgs), so the wrapper can check its ctypes mirror
int fa_backward_args_size() { return (int)sizeof(fa_bwd::BwdArgs); }

// Returns a cudaError_t (0 = launched).  dtype: q, k, v, o, do and the
// gradients (0 = fp32, 1 = bf16); 1 <= hd <= 576, H a multiple of KV,
// Sq * H / KV < 2^24.
int fa_backward(int dtype, const void* args, void* stream) {
  const fa_bwd::BwdArgs& a = *static_cast<const fa_bwd::BwdArgs*>(args);
  if (a.hd < 1 || a.hd > 576 || a.KV < 1 || a.H % a.KV
      || (int64_t)a.Sq * (a.H / a.KV) >= (1 << 24))    // div_g's range
    return (int)cudaErrorInvalidValue;
  if (a.B == 0 || a.Sq == 0 || a.Sk == 0 || a.H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fa_bwd::kF32) return fa_bwd::dispatch<float>(a, s);
  if (dtype == fa_bwd::kBF16) return fa_bwd::dispatch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
