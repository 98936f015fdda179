// Hopper (sm_90a) chunk-parallel WKV scan in fp32 on the CUDA cores: the
// "chunk_f32" route of repro_torch/kernels/rwkv_scan/ops.py, for fp32 r (or
// q), k, v and log_w at Nk <= 32, Nv <= 64 and T >= 16, and its inclusive
// mode (ops.inclusive_scan) at Nk <= 64.  At Nk 64 its tiles leave room
// for one block an SM and the step kernel is faster (PERF.md), so the
// route leaves fp32 RWKV6 heads there.  Included by wkv_scan.cu and
// built by the same nvcc call.  Replaces, like the other routes there,
// _wkv_kernel /
// wkv_scan_pallas of src/repro/kernels/rwkv_scan/kernel.py (mode "rwkv"),
// and computes, in mode "inclusive", the chunked_linear_recurrence(mode=
// "inclusive") of src/repro/models/linrec.py:44 that Hymba's SSM runs
// (the JAX package has no Pallas kernel for it; the step route reached it
// through r = q exp(log_w), u = 0 and an elementwise (q . k) v).
//
// Per (b, h), with S a [Nk, Nv] fp32 state and E_t = exp(log_w_t):
//   S_t = diag(E_t) S_{t-1} + k_t v_t^T
//   rwkv:       out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   inclusive:  out_t = q_t^T S_t
// Time is cut into chunks of kC steps, and the scan runs in three kernels
// launched back to back (plain version: ref.wkv_chunk_f32_ref):
//   (a) chunk_state, one block per (b h, chunk): each
//       chunk's dS = (k * 2^X)^T v, X the sum of w = log_w log2(e) over
//       the chunk's later steps, and its decay 2^(sum of w over it);
//   (b) chunk_scan, one thread per state element: S_c = decay_c S_{c-1} +
//       dS_c over the chunks from s0, writing each chunk's starting state
//       over its dS (in place) and the final state;
//   (c) chunk_out, one block per (b h, chunk): each
//       block of kL steps gets its starting state (S_0 the chunk's,
//       S_b+1 = 2^T_b S_b + (k * 2^Y)^T v over block b, T_b its sum of w,
//       Y the sum over its later steps), then the rows of block b take
//       out = (q * 2^P) S_b + M_b v, P the sum of w from the block's
//       start through the step the query reads (t, or t - 1 in mode
//       rwkv), M_b[t][s] = sum_i q_ti k_si g_tsi over the block's keys up
//       to that step, g the product of E over the steps after s through
//       it (M_b[t][t] = sum_i r_ti u_i k_ti in mode rwkv).
// Precision: every exponent is a sum of w over a run of steps (<= 0),
// never a difference of two running sums, so a strong decay early in a
// chunk (Hymba's log_w reaches -16 softplus(.)) costs later gates nothing
// to cancellation: partial sums over runs of steps, all of one sign, are
// added, never subtracted.  M_b's gates are running products of E: from
// the block's last step back, each key step multiplies the query's
// coefficients by its E, so each gate takes at most kL - 1 roundings and
// no exponential.  All products are fp32 FMAs: one TF32 rounding misses
// the fp32 tolerance (as it does flash's, PERF.md), and at about 7 FLOP a
// byte the work sits below the card's fp32 ridge (~20), so it needs no
// tensor cores.
//
// The machine: (a) and (c) run 256 threads a block, every phase of (c)
// spread over all of them with equal work a thread: four lanes a (block,
// i) for the block sums (each a quarter of the block's steps, the quarters'
// totals passed on by shuffles), a (row, part of i) for M_b (the parts
// joined by shuffles), 4 x 4 tiles of the states and of out; three
// barriers a chunk.  q, k, log_w, v and the chunk's starting state arrive
// by cp.async (16-byte copies when every stride and base allows, else
// 4-byte ones); rows past T and columns past nk / nv are zero-filled
// (log_w = 0: E = 1, the state stays).  One chunk a block: three blocks
// an SM at Nk 16 hide each other's loads, which measured faster than a
// block that walks chunks with the next one's copies in flight
// (PERF.md).  Nk is a template parameter (16, 32, 64), so Hymba's 16
// state rows are not padded.  No atomics: the same inputs give the same
// bits.  Scratch (the wrapper's torch.empty): the chunk states [B H, nc,
// nk, nv] and decays [B H, nc, nk] fp32.  What bounds it at Hymba's
// prefill (8 x 2,560, 25 heads, Nk 16, Nv 64): latency, at about half the
// card's memory rate over the three steps' bytes (PERF.md); (b)'s 40-step
// chains issue their loads kScanAhead chunks ahead.

#ifndef REPRO_WKV_CHUNK_F32_CUH
#define REPRO_WKV_CHUNK_F32_CUH

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace wkvf32 {

constexpr int kC = 64;                // steps a chunk
constexpr int kL = 16;                // steps a block (running products)
constexpr int kNB = kC / kL;          // blocks a chunk
constexpr int kCols = 64;             // v / state / out column tile
constexpr int kThreads = 256;         // threads a block of (a) and (c)
constexpr int kMinBlocksC = 3;        // (c)'s blocks an SM at Nk <= 16 (its
                                      // registers a thread follow)
constexpr int kScanAhead = 16;        // chunks whose loads (b) issues ahead
constexpr int kMDS = kL + 4;          // row stride of M's diagonal blocks
constexpr int kMaxSmem = 232448;      // shared memory a block may take
constexpr int kMinT = 16;             // shortest sequence the route takes
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kC % kL == 0 && kL % 16 == 0 && kThreads % kC == 0,
              "chunk shape");
static_assert(kThreads == 256, "(a) keeps 16 x 16 tiles of the state");

// The C entry point's arguments (ops.py mirrors them with ctypes).
struct Args {
  const float* q;                     // r in mode rwkv; [B, T, H, nk]
  const float* k;                     // [B, T, H, nk]
  const float* v;                     // [B, T, H, nv]
  const float* lw;                    // log_w, [B, T, H, nk]
  const float* u;                     // [H, nk] (rwkv; null: no bonus)
  const float* s0;                    // [B, H, nk, nv] contiguous, or null
  float* out;                         // [B, T, H, nv] contiguous
  float* sT;                          // [B, H, nk, nv] contiguous
  float* states;                      // scratch [B H, nc, nk, nv]
  float* decay;                       // scratch [B H, nc, nk]
  int64_t sq[3], sk[3], sv[3], sw[3];  // element strides of (b, t, h)
  int B, T, H, nk, nv;
  int vec;                            // 16-byte copies allowed
};

template <int NK>
struct StageA {                       // one chunk's tiles for (a)
  float k[kC][NK + 4];                // then k * 2^X in place
  float w[kC][NK + 4];                // log_w
  float v[kC][kCols];
};

template <int NK>
struct StageC {                       // one chunk's tiles for (c)
  float q[kC][NK + 4];
  float k[kC][NK + 4];
  float w[kC][NK + 4];                // log_w, then E = 2^w in place
  float v[kC][kCols];
  float S[NK][kCols];                 // the chunk's starting state
};

template <int NK>
struct __align__(16) SmemA {
  StageA<NK> st;
  float X[kC][NK + 4];                // sums of w after s, in its block
  float T[kNB][NK];                   // block totals
};

template <int NK>
struct SmemCFixed {                   // (c)'s buffers besides the tiles
  float Qh[kC][NK + 4];               // q * 2^(block sums of w through the
                                      // read step)
  float Kh[kC][NK + 4];               // k * 2^(block sums of w after s)
  float T[kNB][NK];                   // block totals
  float Sb[kNB - 1][NK][kCols];       // starting states of blocks 1 ..
  float Md[kNB][kL][kMDS];            // M's diagonal blocks
  float u[NK];
};

template <int NK>
struct __align__(16) SmemC {
  StageC<NK> st;
  SmemCFixed<NK> x;
};

// the parts of i a row of M's diagonal blocks is cut into (a power of 2,
// at least four i's a part)
template <int NK>
__host__ __device__ constexpr int qparts() {
  return kThreads / kC < NK / 4 ? kThreads / kC : NK / 4;
}

__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// rows [0, ROWS) x columns [0, COLS) of a tile with row stride LD from
// src (row stride `stride`); only rows < nrows and columns < ncols are
// read, the rest zero-filled
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t stride, int nrows,
                                          int ncols, bool vec, int tid) {
  if (vec) {                          // ncols % 4 == 0, 16-byte aligned
    constexpr int C4 = COLS / 4;
#pragma unroll 4
    for (int e = tid; e < ROWS * C4; e += kThreads) {
      const int r = e / C4, c = e % C4 * 4;
      const bool in = r < nrows && c < ncols;
      cp16(dst + r * LD + c, in ? src + r * stride + c : src, in);
    }
  } else {
    for (int e = tid; e < ROWS * COLS; e += kThreads) {
      const int r = e / COLS, c = e % COLS;
      const bool in = r < nrows && c < ncols;
      cp4(dst + r * LD + c, in ? src + r * stride + c : src, in);
    }
  }
}

// chunk c's tiles of (b, h) into `st`: k, log_w and v, and for (c) (a
// StageC) q and the starting state
template <int NK, typename St>
__device__ __forceinline__ void load_chunk(St& st, const Args& a,
                                           int b, int h, int c, int nc,
                                           int tid) {
  const int64_t t0 = int64_t(c) * kC;
  const int n = min(kC, a.T - c * kC);
  const bool vec = a.vec != 0;
  const auto at = [&](const float* p, const int64_t* s) {
    return p + b * s[0] + t0 * s[1] + h * s[2];
  };
  load_tile<kC, NK, NK + 4>(&st.k[0][0], at(a.k, a.sk), a.sk[1], n, a.nk,
                            vec, tid);
  load_tile<kC, NK, NK + 4>(&st.w[0][0], at(a.lw, a.sw), a.sw[1], n, a.nk,
                            vec, tid);
  load_tile<kC, kCols, kCols>(&st.v[0][0], at(a.v, a.sv), a.sv[1], n, a.nv,
                              vec, tid);
  if constexpr (std::is_same_v<St, StageC<NK>>) {
    load_tile<kC, NK, NK + 4>(&st.q[0][0], at(a.q, a.sq), a.sq[1], n, a.nk,
                              vec, tid);
    const int64_t bh = int64_t(b) * a.H + h;
    load_tile<NK, kCols, kCols>(
        &st.S[0][0], a.states + (bh * nc + c) * a.nk * a.nv, a.nv, a.nk,
        a.nv, vec, tid);
  }
}

// The block's chunk: its tiles by cp.async, then body(tiles, chunk, valid
// rows, chunks) once they have landed.
template <int NK, typename St, typename Body>
__device__ __forceinline__ void chunk_of_block(St& st, const Args& a,
                                               Body body) {
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H, c = blockIdx.y;
  const int nc = (a.T + kC - 1) / kC;
  load_chunk<NK>(st, a, b, h, c, nc, threadIdx.x);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  body(st, c, min(kC, a.T - c * kC), nc);
}

// ---- (a) each chunk's state dS and decay --------------------------------
template <int NK>
__global__ void __launch_bounds__(kThreads) chunk_state(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemA<NK>& sm = *reinterpret_cast<SmemA<NK>*>(smem_raw);
  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x;
  chunk_of_block<NK>(sm.st, a, [&](StageA<NK>& s, int c, int n, int nc) {
    // X[t] = sum of w over the later steps of t's block, summed back from
    // the block's end; T = the block's total
    for (int p = tid; p < kNB * NK; p += kThreads) {
      const int blk = p / NK, i = p % NK;
      float acc = 0.f;
#pragma unroll
      for (int l = kL - 1; l >= 0; --l) {
        const int t = blk * kL + l;
        sm.X[t][i] = acc;
        acc += s.w[t][i] * kLog2e;
      }
      sm.T[blk][i] = acc;
    }
    __syncthreads();
    // k * 2^(X + totals of the later blocks), in place; the decay
    for (int e = tid; e < kC * NK; e += kThreads) {
      const int t = e / NK, i = e % NK;
      float x = sm.X[t][i];
      for (int blk = t / kL + 1; blk < kNB; ++blk) x += sm.T[blk][i];
      s.k[t][i] *= exp2f(x);
    }
    for (int i = tid; i < a.nk; i += kThreads) {
      float tot = 0.f;
#pragma unroll
      for (int blk = 0; blk < kNB; ++blk) tot += sm.T[blk][i];
      a.decay[(bh * nc + c) * a.nk + i] = exp2f(tot);
    }
    __syncthreads();
    // dS[i][j] = sum_s k~[s][i] v[s][j]: thread (ig, cg) keeps rows ig RI
    // .. + RI - 1, columns 4 cg .. + 3
    constexpr int RI = NK / 16;
    const int ig = tid / 16, cg = tid % 16;
    float acc[RI][4] = {};
    for (int t = 0; t < n; ++t) {
      const float4 vv = *reinterpret_cast<const float4*>(&s.v[t][4 * cg]);
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        const float kk = s.k[t][ig * RI + r];
        acc[r][0] = fmaf(kk, vv.x, acc[r][0]);
        acc[r][1] = fmaf(kk, vv.y, acc[r][1]);
        acc[r][2] = fmaf(kk, vv.z, acc[r][2]);
        acc[r][3] = fmaf(kk, vv.w, acc[r][3]);
      }
    }
    float* dS = a.states + (bh * nc + c) * a.nk * a.nv;
#pragma unroll
    for (int r = 0; r < RI; ++r) {
      const int i = ig * RI + r;
      if (i >= a.nk) continue;
      for (int q = 0; q < 4; ++q)
        if (4 * cg + q < a.nv) dS[i * a.nv + 4 * cg + q] = acc[r][q];
    }
  });
}

// ---- (b) the scan over chunks, in place ---------------------------------
__global__ void __launch_bounds__(256) chunk_scan(const Args a, int nc) {
  const int64_t per = int64_t(a.nk) * a.nv;
  const int64_t idx = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= int64_t(a.B) * a.H * per) return;
  const int64_t bh = idx / per;
  const int e = static_cast<int>(idx % per), i = e / a.nv;
  float S = a.s0 ? a.s0[idx] : 0.f;
  float* st = a.states + bh * nc * per + e;
  const float* dc = a.decay + bh * nc * a.nk + i;
  for (int c0 = 0; c0 < nc; c0 += kScanAhead) {
    float x[kScanAhead], d[kScanAhead];
#pragma unroll
    for (int j = 0; j < kScanAhead; ++j)
      if (c0 + j < nc) {
        x[j] = st[(c0 + j) * per];
        d[j] = dc[(c0 + j) * a.nk];
      }
#pragma unroll
    for (int j = 0; j < kScanAhead; ++j)
      if (c0 + j < nc) {
        st[(c0 + j) * per] = S;       // chunk c0 + j starts from S
        S = fmaf(d[j], S, x[j]);
      }
  }
  a.sT[idx] = S;
}

// ---- (c) the outputs ----------------------------------------------------
// Per chunk: the starting state of each block of kL steps (S_0 the
// chunk's, S_b+1 = 2^T_b S_b + Kh_b^T v_b), then out = Qh S_b + Md v_b for
// the rows of block b, Md the block's own M with running-product gates.
template <int NK, bool INCL>
__global__ void __launch_bounds__(kThreads, NK <= 16 ? kMinBlocksC : 1)
    chunk_out(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemC<NK>& sm = *reinterpret_cast<SmemC<NK>*>(smem_raw);
  SmemCFixed<NK>& x = sm.x;
  const int tid = threadIdx.x;
  const int h = blockIdx.x % a.H;
  if (!INCL)
    for (int i = tid; i < NK; i += kThreads)
      x.u[i] = (a.u && i < a.nk) ? a.u[h * a.nk + i] : 0.f;
  chunk_of_block<NK>(sm.st, a, [&](StageC<NK>& s, int c, int n, int nc) {
    // ---- block sums: four lanes a (block, i), each over a quarter of the
    // block's steps, the quarters' totals passed on by shuffles (every sum
    // over a run of steps, of terms <= 0); forward Qh, T, E = 2^w in place
    // of w, back Kh
    constexpr int LQ = kL / 4;
    static_assert((kNB * NK * 4) % kThreads == 0, "whole warps in a pass");
    for (int p = tid; p < kNB * NK * 4; p += kThreads) {
      const int q4 = p % 4, pair = p / 4;
      const int blk = pair / NK, i = pair % NK, t0 = blk * kL + q4 * LQ;
      float w2[LQ], tot = 0.f;
#pragma unroll
      for (int l = 0; l < LQ; ++l) {
        w2[l] = s.w[t0 + l][i] * kLog2e;
        tot += w2[l];
      }
      // the totals of the quarters before and after this lane's, and the
      // block's
      float inc = tot, dec = tot;
      float y = __shfl_up_sync(0xffffffffu, inc, 1, 4);
      if (q4 >= 1) inc += y;
      y = __shfl_up_sync(0xffffffffu, inc, 2, 4);
      if (q4 >= 2) inc += y;
      y = __shfl_down_sync(0xffffffffu, dec, 1, 4);
      if (q4 <= 2) dec += y;
      y = __shfl_down_sync(0xffffffffu, dec, 2, 4);
      if (q4 <= 1) dec += y;
      const float before = __shfl_up_sync(0xffffffffu, inc, 1, 4);
      const float after = __shfl_down_sync(0xffffffffu, dec, 1, 4);
      const float total = __shfl_sync(0xffffffffu, inc, 3, 4);
      float acc = q4 == 0 ? 0.f : before;
#pragma unroll
      for (int l = 0; l < LQ; ++l) {
        if (INCL) acc += w2[l];
        x.Qh[t0 + l][i] = s.q[t0 + l][i] * exp2f(acc);
        if (!INCL) acc += w2[l];
        s.w[t0 + l][i] = exp2f(w2[l]);
      }
      if (q4 == 0) x.T[blk][i] = total;
      acc = q4 == 3 ? 0.f : after;
#pragma unroll
      for (int l = LQ - 1; l >= 0; --l) {
        x.Kh[t0 + l][i] = s.k[t0 + l][i] * exp2f(acc);
        acc += w2[l];
      }
    }
    __syncthreads();

    // ---- M's diagonal blocks: thread (t, part qi of i) walks its block's
    // keys back from the block's last step, the gate a running product of
    // E; the row's QP parts meet by shuffles
    if (tid < kC * qparts<NK>()) {
      constexpr int QP = qparts<NK>(), Q = NK / QP;
      static_assert(Q % 4 == 0 && (32 / QP) <= kL, "parts of a row");
      const int t = tid / QP, qi = tid % QP, i0 = qi * Q;
      const int blk = t / kL, e = blk * kL + kL - 1;
      float qt[Q], qq[Q], uq[Q];
#pragma unroll
      for (int i = 0; i < Q; i += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(&s.q[t][i0 + i]);
        qt[i] = v4.x; qt[i + 1] = v4.y; qt[i + 2] = v4.z; qt[i + 3] = v4.w;
      }
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        qq[i] = 0.f;
        uq[i] = INCL ? 0.f : qt[i] * x.u[i0 + i];
      }
#pragma unroll
      for (int j = 0; j < kL; ++j) {
        const int sk = e - j;               // key step, walked back
        const bool d = sk == t;
        if (INCL && d) {
#pragma unroll
          for (int i = 0; i < Q; ++i) qq[i] = qt[i];
        }
        float part[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < Q; i += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&s.k[sk][i0 + i]);
          const float kx[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
            part[q & 1] = fmaf((!INCL && d) ? uq[i + q] : qq[i + q], kx[q],
                               part[q & 1]);
        }
        float m = part[0] + part[1];
#pragma unroll
        for (int o = 1; o < QP; o <<= 1)
          m += __shfl_xor_sync(0xffffffffu, m, o);
        if (qi == j % QP) x.Md[blk][t - blk * kL][kL - 1 - j] = m;
#pragma unroll
        for (int i = 0; i < Q; i += 4) {
          const float4 ee = *reinterpret_cast<const float4*>(&s.w[sk][i0 + i]);
          qq[i] *= ee.x; qq[i + 1] *= ee.y; qq[i + 2] *= ee.z;
          qq[i + 3] *= ee.w;
        }
        if (!INCL && d) {
#pragma unroll
          for (int i = 0; i < Q; ++i) qq[i] = qt[i];
        }
      }
    }

    // ---- the blocks' starting states: thread (ig, cg) keeps rows ig RI
    // .. + RI - 1, columns 4 cg .. + 3 of the state in registers
    {
      constexpr int RI = NK / (kThreads / 16);
      static_assert(RI >= 1, "a state row a thread at least");
      const int ig = tid / 16, cg = tid % 16;
      float st[RI][4];
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(&s.S[ig * RI + r][4 * cg]);
        st[r][0] = v4.x; st[r][1] = v4.y; st[r][2] = v4.z; st[r][3] = v4.w;
      }
#pragma unroll 1
      for (int b = 0; b + 1 < kNB; ++b) {
        float acc[RI][4] = {};
#pragma unroll 4
        for (int l = 0; l < kL; ++l) {
          const int t = b * kL + l;
          const float4 vv = *reinterpret_cast<const float4*>(&s.v[t][4 * cg]);
#pragma unroll
          for (int r = 0; r < RI; ++r) {
            const float kk = x.Kh[t][ig * RI + r];
            acc[r][0] = fmaf(kk, vv.x, acc[r][0]);
            acc[r][1] = fmaf(kk, vv.y, acc[r][1]);
            acc[r][2] = fmaf(kk, vv.z, acc[r][2]);
            acc[r][3] = fmaf(kk, vv.w, acc[r][3]);
          }
        }
#pragma unroll
        for (int r = 0; r < RI; ++r) {
          const int i = ig * RI + r;
          const float dec = exp2f(x.T[b][i]);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            st[r][q] = fmaf(dec, st[r][q], acc[r][q]);
          *reinterpret_cast<float4*>(&x.Sb[b][i][4 * cg]) =
              make_float4(st[r][0], st[r][1], st[r][2], st[r][3]);
        }
      }
    }
    __syncthreads();

    // ---- out = Qh S_b + Md v_b: thread (rg, cg) keeps rows RW rg ..
    // + RW - 1 (in one block b), columns 4 cg .. + 3
    constexpr int RW = kC / (kThreads / 16);
    static_assert(RW >= 1 && kL % RW == 0, "out rows a thread");
    const int rg = tid / 16, cg = tid % 16, t0 = rg * RW;
    const int blk = t0 / kL, tl = t0 - blk * kL;
    const float(*Sst)[kCols] = blk == 0 ? s.S : x.Sb[blk - 1];
    float acc[RW][4] = {};
    const auto fma4 = [&](const float4 (&xr)[RW], const float4 (&y)[4]) {
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float xs[4] = {xr[r].x, xr[r].y, xr[r].z, xr[r].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[r][0] = fmaf(xs[q], y[q].x, acc[r][0]);
          acc[r][1] = fmaf(xs[q], y[q].y, acc[r][1]);
          acc[r][2] = fmaf(xs[q], y[q].z, acc[r][2]);
          acc[r][3] = fmaf(xs[q], y[q].w, acc[r][3]);
        }
      }
    };
#pragma unroll
    for (int i = 0; i < NK; i += 4) {
      float4 xr[RW], y[4];
#pragma unroll
      for (int r = 0; r < RW; ++r)
        xr[r] = *reinterpret_cast<const float4*>(&x.Qh[t0 + r][i]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        y[q] = *reinterpret_cast<const float4*>(&Sst[i + q][4 * cg]);
      fma4(xr, y);
    }
#pragma unroll
    for (int s0 = 0; s0 < kL; s0 += 4) {
      float4 xr[RW], y[4];
#pragma unroll
      for (int r = 0; r < RW; ++r)
        xr[r] = *reinterpret_cast<const float4*>(&x.Md[blk][tl + r][s0]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        y[q] = *reinterpret_cast<const float4*>(
            &s.v[blk * kL + s0 + q][4 * cg]);
      fma4(xr, y);
    }
    const int64_t row0 =
        (int64_t(blockIdx.x / a.H) * a.T + int64_t(c) * kC) * a.H + h;
    const bool vec_out = a.nv % 4 == 0;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      if (t0 + r >= n) break;
      float* o = a.out + (row0 + int64_t(t0 + r) * a.H) * a.nv + 4 * cg;
      if (vec_out) {
        if (4 * cg < a.nv)
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      } else {
        for (int q = 0; q < 4; ++q)
          if (4 * cg + q < a.nv) o[q] = acc[r][q];
      }
    }
  });
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

template <int NK>
constexpr int smem_c() {
  return sizeof(SmemC<NK>);
}

template <int NK, bool INCL>
cudaError_t prepare() {
  static const cudaError_t done = [] {
    cudaError_t e = set_smem(chunk_state<NK>, sizeof(SmemA<NK>));
    return e == cudaSuccess ? set_smem(chunk_out<NK, INCL>, smem_c<NK>())
                            : e;
  }();
  return done;
}

// The three kernels on `stream`; a cudaError_t (0 = launched).
template <int NK, bool INCL>
int launch(const Args& a, cudaStream_t stream) {
  static_assert(smem_c<NK>() <= kMaxSmem && sizeof(SmemA<NK>) <= kMaxSmem,
                "(a) and (c) fit an SM");
  cudaError_t e = prepare<NK, INCL>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nc = (a.T + kC - 1) / kC;
  const dim3 grid(a.B * a.H, nc);
  chunk_state<NK><<<grid, kThreads, sizeof(SmemA<NK>), stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int64_t elems = int64_t(a.B) * a.H * a.nk * a.nv;
  chunk_scan<<<static_cast<unsigned>((elems + 255) / 256), 256, 0,
               stream>>>(a, nc);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  chunk_out<NK, INCL><<<grid, kThreads, smem_c<NK>(), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// (shared memory bytes, blocks an SM) of (a) and (c) at Nk = NK
template <int NK>
void occupancy(int* out) {
  out[0] = sizeof(SmemA<NK>);
  out[2] = smem_c<NK>();
  out[1] = out[3] = -1;
  if (prepare<NK, true>() != cudaSuccess) return;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], chunk_state<NK>,
                                                kThreads, sizeof(SmemA<NK>));
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], chunk_out<NK, true>, kThreads, smem_c<NK>());
}

}  // namespace wkvf32

#endif  // REPRO_WKV_CHUNK_F32_CUH
