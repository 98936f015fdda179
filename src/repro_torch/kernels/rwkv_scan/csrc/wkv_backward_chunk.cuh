// Hopper (sm_90a) chunk-parallel WKV scan backward: the "chunk" route of
// repro_torch/kernels/rwkv_scan/backward.py, for fp32 and bf16 r, k, v,
// dout at Nk <= 64, Nv <= 64 and T >= kC (RWKV6's heads of 64 and Hymba's
// SSM, 16 x 64, through its WKV identity).  Included by wkv_backward.cu and
// built by the same nvcc call; the sequential kernels there stay as route
// "step" for every other shape.  Like them it computes dr, dk, dv, dlog_w
// and du of the forward (zero initial state, final state unused); the JAX
// package has no backward kernel (jax.value_and_grad differentiates
// src/repro/models/linrec.py:44).  Plain version: ref.wkv_backward_chunk_ref.
//
// Per (b, h), with w = log_w log2(e), E = 2^w, time cut into chunks of kC
// steps and each chunk into kNB blocks of kL steps; per block the in-block
// sums of w before a step (Pin), after it (Xin) and over it (T).  Every
// gate is 2^(a sum of w over a run of steps): a run that crosses blocks is
// Xin + the whole blocks' T + Pin, never a difference of running sums (at
// Hymba's decays those reach the hundreds and cancel).  Four kernels:
//   (a) chunk_local, one block per (b h, chunk): the chunk's state
//       (k 2^X)^T v, its gradient state (r 2^P)^T dout (X: sums of w after
//       a step to the chunk's end, P: before it from the chunk's start)
//       and its decay 2^(sum T);
//   (b) chunk_scans, one warp per (b h, state row): the starting states
//       S^c forward over the chunks (in place of (a)'s states), the ending
//       gradient states dS^c backward (dS_{c-1} = decay_c dS_c + (a)'s, in
//       place), and Q^c = dS^c . S^{c+1} row by row;
//   (c) chunk_grads, one block per (b h, chunk), from S^c, dS^c and Q^c:
//       M' = dout v^T and the forward's gated M (between blocks (r 2^Pin)
//       (k 2^Xin 2^gap)^T, gap the T of the blocks between; the diagonal
//       blocks in fp32 with gates as running products of E and the bonus
//       r u k on the diagonal), then per block
//         dr' = 2^Pin (dout S^T 2^pre + sum_earlier M' (k 2^Xin) 2^gap)
//               + sum_{s < t in the block} gate k_s M'[t][s]
//         dk' = 2^Xin (v dS^T 2^post + sum_later M'^T (r 2^Pin) 2^gap)
//               + sum_{t > s in the block} gate r_t M'[t][s]
//         dv  = (k 2^Xin 2^post) dS + sum_{later or same} M^T dout
//       dr = dr' + u k vd, dk = dk' + u r vd (vd = v . dout = M'[t][t]);
//       dlog_w back through each block (dlog_w_t = Q_t - k_t dk'_t,
//       Q_{t-1} = dlog_w_t + r_t dr'_t) from Q at its end, Q^c plus the
//       later blocks' sums of r dr' - k dk' (rounding runs over at most kC
//       additions); the chunk's sums of r k vd for du;
//   (d) du_sum: du = the partials summed over (batch, chunk) in order.
// Every product except the diagonal blocks' is mma.sync m16n8k8 TF32 with
// fp32 operands split into hi + lo (three mma a product; the helpers below
// are a copy of flash_attention/csrc/mma_tf32.cuh's, kept here so that the
// build's hash of this directory covers them), each product in fresh
// accumulators and the products added in fp32: one TF32 rounding misses
// fp32 gates.
// Tiles arrive by cp.async (fp32; bf16 is converted as it is staged), rows
// past T and columns past nk / nv zero-filled (log_w = 0: E = 1, nothing
// added).  No atomics: the same inputs give the same bits.

#ifndef REPRO_WKV_BACKWARD_CHUNK_CUH
#define REPRO_WKV_BACKWARD_CHUNK_CUH

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace wkvbc {

constexpr int kC = 64;                // steps a chunk
constexpr int kL = 16;                // steps a block (an mma's 16 rows)
constexpr int kNB = kC / kL;          // blocks a chunk
constexpr int kNV = 64;               // v / dout / state column tile
constexpr int kLDV = kNV + 4;         // its row stride
constexpr int kLDM = kC + 4;          // row stride of M' and M
// threads a block of (a) and (c): 16 warps at Nk 64, where a block takes
// most of an SM's shared memory, 8 below it (two blocks an SM)
template <int NK>
__host__ __device__ constexpr int threads() { return NK > 32 ? 512 : 256; }
constexpr int kScanAhead = 16;        // chunks whose loads (b) issues ahead
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kC % kL == 0 && kL == 16, "blocks are one mma's 16 rows");

// The C entry point's arguments (backward.py mirrors them with ctypes).
struct Args {
  const void* r;                      // [B, T, H, nk], strides sr
  const void* k;                      // [B, T, H, nk], strides sk
  const void* v;                      // [B, T, H, nv], strides sv
  const float* lw;                    // log_w, [B, T, H, nk], strides sw
  const float* u;                     // [H, nk] contiguous
  const void* dout;                   // [B, T, H, nv], strides sd
  void* dr; void* dk; void* dv;       // contiguous, the inputs' dtype
  float* dlw;                         // [B, T, H, nk] contiguous
  float* du;                          // [H, nk]
  float* states;                      // scratch [B H, nc, nk, nv]
  float* dstates;                     // scratch [B H, nc, nk, nv]
  float* decay;                       // scratch [B H, nc, nk]
  float* qend;                        // scratch [B H, nc, nk]
  float* du_part;                     // scratch [B, H, nc, nk]
  int64_t sr[3], sk[3], sv[3], sw[3], sd[3];  // element strides (b, t, h)
  int B, T, H, nk, nv;
  int vec;                            // 16-byte copies allowed (nk, nv and
                                      // the fp32 streams' strides % 4 == 0,
                                      // their bases 16-byte aligned)
};

// One chunk's tiles and block sums: what (a) and (c) share.
template <int NK>
struct __align__(16) Stage {
  float r[kC][NK + 4];
  float k[kC][NK + 4];
  float E[kC][NK + 4];                // log_w as staged, then 2^w
  float ePin[kC][NK + 4];             // 2^Pin; (c) then k dk'
  float eXin[kC][NK + 4];             // 2^Xin; (c) then r dr'
  float v[kC][kLDV];
  float d[kC][kLDV];                  // dout
  float T[kNB][NK];                   // the blocks' sums of w
  float span[kNB + 1][kNB + 1][NK];   // [a + 1][b]: 2^(T of blocks a+1..b-1)
  float u[NK];
  float q[NK];                        // Q^c
};

template <int NK>
struct __align__(16) SmemC {
  Stage<NK> st;
  float S[NK][kLDV];                  // the chunk's starting state
  float dS[NK][kLDV];                 // its ending gradient state
  float Mp[kC][kLDM];                 // M' = dout v^T (blocks t >= s)
  float M[kC][kLDM];                  // the forward's M (blocks t >= s)
};

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// an mma operand split: hi = x rounded to TF32 (nearest, ties away), lo =
// the rest, rounded by the add alone (the tensor cores ignore a .tf32
// operand's low 13 bits): hi + lo holds x to 2^-22 of |x|
struct Op { uint32_t hi, lo; };
__device__ __forceinline__ Op split(float x) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return {h, __float_as_uint(x - __uint_as_float(h)) + 0x1000u};
}

// d += a . b, m16n8k8, TF32 inputs, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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

// rows [0, ROWS) x columns [0, COLS) of a tile with row stride LD from src
// (row stride `stride`); rows >= nrows and columns >= ncols zero-filled.
// fp32 by cp.async (16-byte copies when vec), bf16 converted by plain loads
template <int ROWS, int COLS, int LD, int NT, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride, int nrows,
                                          int ncols, bool vec) {
  const int tid = threadIdx.x;
  if constexpr (std::is_same_v<T, float>) {
    if (vec) {                        // ncols % 4 == 0, 16-byte aligned
      constexpr int C4 = COLS / 4;
      for (int e = tid; e < ROWS * C4; e += NT) {
        const int r = e / C4, c = e % C4 * 4;
        const bool in = r < nrows && c < ncols;
        cp16(dst + r * LD + c, in ? src + r * stride + c : src, in);
      }
    } else {
      for (int e = tid; e < ROWS * COLS; e += NT) {
        const int r = e / COLS, c = e % COLS;
        const bool in = r < nrows && c < ncols;
        cp4(dst + r * LD + c, in ? src + r * stride + c : src, in);
      }
    }
  } else {
    for (int e = tid; e < ROWS * COLS; e += NT) {
      const int r = e / COLS, c = e % COLS;
      dst[r * LD + c] = (r < nrows && c < ncols) ? f32(src[r * stride + c])
                                                 : 0.f;
    }
  }
}

// acc += A . B over K (a multiple of 8) for one m16n8 tile, A(m, kk) and
// B(kk, n) read through fa and fb (m, n local to the tile), both split
// acc[j] += A . B_j over K (a multiple of 8) for NTL m16n8 tiles side by
// side (columns 8 j ..): A(m, kk) and B(kk, n) read through fa and fb (m
// local to the tile, n to the NTL tiles), both split; A's split is shared
// by the NTL tiles.  The three products of each k step go to three
// accumulators, so that three chains of dependent mma run side by side;
// they are added at the end, the small ones first.
template <int K, int NTL, typename FA, typename FB>
__device__ __forceinline__ void mma_tiles(float (&acc)[NTL][4], FA fa, FB fb,
                                          int g, int t) {
  float lh[NTL][4] = {}, hl[NTL][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    const Op a[4] = {split(fa(g, k0 + t)), split(fa(g + 8, k0 + t)),
                     split(fa(g, k0 + t + 4)), split(fa(g + 8, k0 + t + 4))};
#pragma unroll
    for (int j = 0; j < NTL; ++j) {
      const Op b[2] = {split(fb(k0 + t, 8 * j + g)),
                       split(fb(k0 + t + 4, 8 * j + g))};
      mma(lh[j], a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
      mma(hl[j], a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
      mma(acc[j], a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
    }
  }
#pragma unroll
  for (int j = 0; j < NTL; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += lh[j][e] + hl[j][e];
}

// an accumulator slot's row and column in its m16n8 tile
__device__ __forceinline__ int row_of(int e, int g) { return g + 8 * (e >> 1); }
__device__ __forceinline__ int col_of(int e, int t) { return 2 * t + (e & 1); }

// columns a warp tile of (a) takes: 32 at Nk 64 (16 warps, one tile each),
// 16 below
template <int NK>
__host__ __device__ constexpr int local_cols() { return NK > 32 ? 32 : 16; }

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// chunk c of (b, h): its tiles by cp.async into `st` in two groups (r, k
// and log_w, then v and dout), the bonus and (with Q) Q^c
template <int NK, typename T>
__device__ __forceinline__ void stage_chunk(Stage<NK>& st, const Args& a,
                                            int b, int h, int c, int n,
                                            bool with_q) {
  constexpr int NT = threads<NK>();
  const int64_t t0 = int64_t(c) * kC;
  const bool vec = a.vec != 0;
  const auto at = [&](const void* p, const int64_t* s) {
    return static_cast<const T*>(p) + b * s[0] + t0 * s[1] + h * s[2];
  };
  load_tile<kC, NK, NK + 4, NT>(&st.r[0][0], at(a.r, a.sr), a.sr[1], n,
                                a.nk, vec);
  load_tile<kC, NK, NK + 4, NT>(&st.k[0][0], at(a.k, a.sk), a.sk[1], n,
                                a.nk, vec);
  load_tile<kC, NK, NK + 4, NT>(
      &st.E[0][0], a.lw + b * a.sw[0] + t0 * a.sw[1] + h * a.sw[2],
      a.sw[1], n, a.nk, vec);
  cp_commit();
  load_tile<kC, kNV, kLDV, NT>(&st.v[0][0], at(a.v, a.sv), a.sv[1], n, a.nv,
                               vec);
  load_tile<kC, kNV, kLDV, NT>(&st.d[0][0], at(a.dout, a.sd), a.sd[1], n,
                               a.nv, vec);
  cp_commit();
  const int64_t bh = int64_t(b) * a.H + h, nc = (a.T + kC - 1) / kC;
  for (int i = threadIdx.x; i < NK; i += NT) {
    st.u[i] = i < a.nk ? a.u[h * a.nk + i] : 0.f;
    st.q[i] = (with_q && i < a.nk) ? a.qend[(bh * nc + c) * a.nk + i] : 0.f;
  }
}

// The block sums, E = 2^w in place of log_w, 2^Pin, 2^Xin and the spans,
// once r, k and log_w have landed; ends on a barrier.
template <int NK>
__device__ __forceinline__ void block_sums(Stage<NK>& st) {
  constexpr int NT = threads<NK>();
  const int tid = threadIdx.x;
  for (int p = tid; p < kNB * NK; p += NT) {
    const int blk = p / NK, i = p % NK, t0 = blk * kL;
    float w2[kL];
#pragma unroll
    for (int l = 0; l < kL; ++l) w2[l] = st.E[t0 + l][i] * kLog2e;
    float acc = 0.f;
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      st.ePin[t0 + l][i] = exp2f(acc);
      acc += w2[l];
    }
    st.T[blk][i] = acc;
    acc = 0.f;
#pragma unroll
    for (int l = kL - 1; l >= 0; --l) {
      st.eXin[t0 + l][i] = exp2f(acc);
      acc += w2[l];
    }
#pragma unroll
    for (int l = 0; l < kL; ++l) st.E[t0 + l][i] = exp2f(w2[l]);
  }
  __syncthreads();
  for (int p = tid; p < (kNB + 1) * (kNB + 1) * NK; p += NT) {
    const int a1 = p / ((kNB + 1) * NK), b = p / NK % (kNB + 1), i = p % NK;
    float s = 0.f;
    for (int j = a1; j < b; ++j) s += st.T[j][i];
    st.span[a1][b][i] = exp2f(s);
  }
  __syncthreads();
}

// ---- (a) each chunk's state, gradient state and decay -------------------
template <int NK, typename T>
__global__ void __launch_bounds__(threads<NK>()) chunk_local(const Args a) {
  constexpr int NT = threads<NK>(), NW = NT / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage<NK>& st = *reinterpret_cast<Stage<NK>*>(smem_raw);
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H, c = blockIdx.y;
  const int nc = (a.T + kC - 1) / kC, n = min(kC, a.T - c * kC);
  const int64_t bh = blockIdx.x;
  stage_chunk<NK, T>(st, a, b, h, c, n, false);
  cp_wait<1>();
  __syncthreads();
  block_sums<NK>(st);
  cp_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  constexpr int MT = NK / 16, CW = local_cols<NK>(), NTL = CW / 8;
  constexpr int NN = kNV / CW;                      // 16 x CW warp tiles
  float* out0 = a.states + (bh * nc + c) * a.nk * a.nv;
  float* out1 = a.dstates + (bh * nc + c) * a.nk * a.nv;
  for (int p = warp; p < 2 * MT * NN; p += NW) {
    const int which = p / (MT * NN), i0 = p / NN % MT * 16,
              n0 = p % NN * CW;
    float acc[NTL][4] = {};
    if (which == 0) {     // (k 2^Xin 2^post)^T v
      mma_tiles<kC>(
          acc,
          [&](int m, int s) {
            return st.k[s][i0 + m] * st.eXin[s][i0 + m] *
                   st.span[s / kL + 1][kNB][i0 + m];
          },
          [&](int s, int nn) { return st.v[s][n0 + nn]; }, g, t);
    } else {              // (r 2^Pin 2^pre)^T dout
      mma_tiles<kC>(
          acc,
          [&](int m, int s) {
            return st.r[s][i0 + m] * st.ePin[s][i0 + m] *
                   st.span[0][s / kL][i0 + m];
          },
          [&](int s, int nn) { return st.d[s][n0 + nn]; }, g, t);
    }
    float* out = which == 0 ? out0 : out1;
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + row_of(e, g), nn = n0 + 8 * j + col_of(e, t);
        if (i < a.nk && nn < a.nv) out[i * a.nv + nn] = acc[j][e];
      }
  }
  for (int i = threadIdx.x; i < a.nk; i += NT) {
    float tot = 0.f;
#pragma unroll
    for (int j = 0; j < kNB; ++j) tot += st.T[j][i];
    a.decay[(bh * nc + c) * a.nk + i] = exp2f(tot);
  }
}

// ---- (b) the scans over chunks, in place --------------------------------
// One warp a state row (bh, i); lane l keeps columns l and l + 32.
__global__ void __launch_bounds__(256) chunk_scans(const Args a, int nc) {
  const int64_t row = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= int64_t(a.B) * a.H * a.nk) return;   // whole warps
  const int64_t bh = row / a.nk;
  const int i = static_cast<int>(row % a.nk);
  const int64_t per = int64_t(a.nk) * a.nv;
  const bool in0 = lane < a.nv, in1 = lane + 32 < a.nv;
  float* st = a.states + bh * nc * per + int64_t(i) * a.nv;
  float* dst = a.dstates + bh * nc * per + int64_t(i) * a.nv;
  const float* dc = a.decay + bh * nc * a.nk + i;
  float* qe = a.qend + bh * nc * a.nk + i;
  // forward: chunk c starts from S; S <- decay_c S + its state
  float S0 = 0.f, S1 = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kScanAhead) {
    float x0[kScanAhead], x1[kScanAhead], d[kScanAhead];
#pragma unroll
    for (int j = 0; j < kScanAhead; ++j)
      if (c0 + j < nc) {
        x0[j] = in0 ? st[(c0 + j) * per + lane] : 0.f;
        x1[j] = in1 ? st[(c0 + j) * per + lane + 32] : 0.f;
        d[j] = dc[(c0 + j) * a.nk];
      }
#pragma unroll
    for (int j = 0; j < kScanAhead; ++j)
      if (c0 + j < nc) {
        if (in0) st[(c0 + j) * per + lane] = S0;
        if (in1) st[(c0 + j) * per + lane + 32] = S1;
        S0 = fmaf(d[j], S0, x0[j]);
        S1 = fmaf(d[j], S1, x1[j]);
      }
  }
  // backward: chunk c ends on dD (zero after the last), Q^c = dD . S^{c+1}
  // (the final state for the last chunk); dD <- decay_c dD + its own
  float D0 = 0.f, D1 = 0.f, N0 = S0, N1 = S1;
  for (int c1 = nc - 1; c1 >= 0; c1 -= kScanAhead) {
    float x0[kScanAhead], x1[kScanAhead], d[kScanAhead], s0[kScanAhead],
        s1[kScanAhead];
#pragma unroll
    for (int j = 0; j < kScanAhead; ++j)
      if (c1 - j >= 0) {
        const int64_t o = (c1 - j) * per;
        x0[j] = in0 ? dst[o + lane] : 0.f;
        x1[j] = in1 ? dst[o + lane + 32] : 0.f;
        s0[j] = in0 ? st[o + lane] : 0.f;
        s1[j] = in1 ? st[o + lane + 32] : 0.f;
        d[j] = dc[(c1 - j) * a.nk];
      }
#pragma unroll
    for (int j = 0; j < kScanAhead; ++j)
      if (c1 - j >= 0) {
        const int64_t o = (c1 - j) * per;
        if (in0) dst[o + lane] = D0;
        if (in1) dst[o + lane + 32] = D1;
        float q = fmaf(D1, N1, D0 * N0);
#pragma unroll
        for (int m = 16; m > 0; m >>= 1)
          q += __shfl_xor_sync(0xffffffffu, q, m);
        if (lane == 0) qe[(c1 - j) * a.nk] = q;
        D0 = fmaf(d[j], D0, x0[j]);
        D1 = fmaf(d[j], D1, x1[j]);
        N0 = s0[j];
        N1 = s1[j];
      }
  }
}

// ---- (c) the gradients of each chunk ------------------------------------
template <int NK, typename T>
__global__ void __launch_bounds__(threads<NK>(), NK <= 16 ? 2 : 1)
    chunk_grads(const Args a) {
  constexpr int NT = threads<NK>(), NW = NT / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemC<NK>& sm = *reinterpret_cast<SmemC<NK>*>(smem_raw);
  Stage<NK>& st = sm.st;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H, c = blockIdx.y;
  const int nc = (a.T + kC - 1) / kC, n = min(kC, a.T - c * kC);
  const int64_t bh = blockIdx.x;
  stage_chunk<NK, T>(st, a, b, h, c, n, true);
  {
    const float* S = a.states + (bh * nc + c) * a.nk * a.nv;
    const float* dS = a.dstates + (bh * nc + c) * a.nk * a.nv;
    const bool vs = a.nv % 4 == 0;
    load_tile<NK, kNV, kLDV, NT>(&sm.S[0][0], S, a.nv, a.nk, a.nv, vs);
    load_tile<NK, kNV, kLDV, NT>(&sm.dS[0][0], dS, a.nv, a.nk, a.nv, vs);
    cp_commit();
  }
  cp_wait<2>();
  __syncthreads();
  block_sums<NK>(st);
  cp_wait<0>();
  __syncthreads();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // ---- M' (blocks t >= s) and M between blocks on the tensor cores, a
  // 16 x 16 block a warp pass ----
  constexpr int kMpBlocks = kNB * (kNB + 1) / 2, kMBlocks = kNB * (kNB - 1) / 2;
  for (int p = warp; p < kMpBlocks + kMBlocks; p += NW) {
    const bool prime = p < kMpBlocks;
    int q = prime ? p : p - kMpBlocks, tb = 0;
    // the q-th block pair (tb, sb), sb <= tb (M': sb <= tb, M: sb < tb)
    while (q >= tb + (prime ? 1 : 0)) {
      q -= tb + (prime ? 1 : 0);
      ++tb;
    }
    const int sb = q, t0 = tb * kL, s0 = sb * kL;
    float acc[2][4] = {};
    if (prime) {
      mma_tiles<kNV>(acc, [&](int m, int j) { return st.d[t0 + m][j]; },
                     [&](int j, int nn) { return st.v[s0 + nn][j]; }, g, t);
    } else {
      const float* gap = st.span[sb + 1][tb];
      mma_tiles<NK>(
          acc,
          [&](int m, int i) { return st.r[t0 + m][i] * st.ePin[t0 + m][i]; },
          [&](int i, int nn) {
            return st.k[s0 + nn][i] * st.eXin[s0 + nn][i] * gap[i];
          },
          g, t);
    }
    float(*dst)[kLDM] = prime ? sm.Mp : sm.M;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[t0 + row_of(e, g)][s0 + 8 * j + col_of(e, t)] = acc[j][e];
  }
  // M's diagonal blocks in fp32: thread (t, part qi of i) walks its block's
  // keys back from the block's last step, the gate a running product of E;
  // the row's QP parts meet by shuffles
  {
    constexpr int QP = NT / kC < NK / 4 ? NT / kC : NK / 4;
    constexpr int Q = NK / QP;
    static_assert(Q % 4 == 0 && NT % kC == 0, "parts of a row");
    if (tid < kC * QP) {
      const int tq = tid / QP, qi = tid % QP, i0 = qi * Q;
      const int e = tq / kL * kL + kL - 1;
      float rt[Q], cf[Q], uq[Q];
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        rt[i] = st.r[tq][i0 + i];
        cf[i] = 0.f;
        uq[i] = rt[i] * st.u[i0 + i];
      }
#pragma unroll
      for (int j = 0; j < kL; ++j) {
        const int sk = e - j;
        const bool dg = sk == tq;
        float part[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < Q; i += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(&st.k[sk][i0 + i]);
          const float kx[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
            part[q & 1] = fmaf(dg ? uq[i + q] : cf[i + q], kx[q], part[q & 1]);
        }
        float m = part[0] + part[1];
#pragma unroll
        for (int o = 1; o < QP; o <<= 1)
          m += __shfl_xor_sync(0xffffffffu, m, o);
        if (qi == j % QP) sm.M[tq][sk] = m;
#pragma unroll
        for (int i = 0; i < Q; i += 4) {
          const float4 e4 = *reinterpret_cast<const float4*>(&st.E[sk][i0 + i]);
          const float ex[4] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
            cf[i + q] = dg ? rt[i + q] : cf[i + q] * ex[q];
        }
      }
    }
  }
  __syncthreads();

  // ---- dr', dk' of a (block, 16 columns of i) a warp pass; dv ---------
  constexpr int NJ = NK / 16;
  constexpr int PP = (kNB * NJ + NW - 1) / NW;      // passes a warp
  float kd[PP][2][4], rdr[PP][2][4];
  const int64_t row0 = (int64_t(b) * a.T + int64_t(c) * kC) * a.H + h;
#pragma unroll
  for (int pp = 0; pp < PP; ++pp) {
    const int p = warp + pp * NW;
    if (p >= kNB * NJ) break;
    const int blk = p / NJ, i0 = p % NJ * 16, t0 = blk * kL;
    // dr': the starting state, then the earlier blocks
    float dr[2][4] = {}, dk[2][4] = {};
    mma_tiles<kNV>(dr, [&](int m, int j) { return st.d[t0 + m][j]; },
                   [&](int j, int nn) { return sm.S[i0 + nn][j]; }, g, t);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dr[j][e] *= st.span[0][blk][i0 + 8 * j + col_of(e, t)];
    for (int sb = 0; sb < blk; ++sb) {
      float x[2][4] = {};
      const int s0 = sb * kL;
      mma_tiles<kL>(
          x, [&](int m, int j) { return sm.Mp[t0 + m][s0 + j]; },
          [&](int j, int nn) {
            return st.k[s0 + j][i0 + nn] * st.eXin[s0 + j][i0 + nn];
          },
          g, t);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dr[j][e] += x[j][e] * st.span[sb + 1][blk][i0 + 8 * j + col_of(e, t)];
    }
    // dk': the ending gradient state, then the later blocks
    mma_tiles<kNV>(dk, [&](int m, int j) { return st.v[t0 + m][j]; },
                   [&](int j, int nn) { return sm.dS[i0 + nn][j]; }, g, t);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dk[j][e] *= st.span[blk + 1][kNB][i0 + 8 * j + col_of(e, t)];
    for (int tb = blk + 1; tb < kNB; ++tb) {
      float x[2][4] = {};
      const int q0 = tb * kL;
      mma_tiles<kL>(
          x, [&](int m, int j) { return sm.Mp[q0 + j][t0 + m]; },
          [&](int j, int nn) {
            return st.r[q0 + j][i0 + nn] * st.ePin[q0 + j][i0 + nn];
          },
          g, t);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dk[j][e] += x[j][e] * st.span[blk + 1][tb][i0 + 8 * j + col_of(e, t)];
    }
    // the diagonal block's terms: the key tt - dd of the slot's query, and
    // the query tt + dd of its key, each gate a running product of E; the
    // eight slots and both walks side by side, a slot pair (one row, two
    // adjacent columns) by 8-byte loads
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float cx[4], cy[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = t0 + row_of(e, g), i = i0 + 8 * j + col_of(e, t);
        dr[j][e] *= st.ePin[tt][i];
        dk[j][e] *= st.eXin[tt][i];
        cx[e] = cy[e] = 1.f;
      }
      const int i = i0 + 8 * j + 2 * t;
#pragma unroll
      for (int dd = 1; dd < kL; ++dd) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int tl = row_of(e, g), tt = t0 + tl;
          if (tl >= dd) {
            const float2 k2 = *reinterpret_cast<const float2*>(
                &st.k[tt - dd][i]);
            const float2 e2 = *reinterpret_cast<const float2*>(
                &st.E[tt - dd][i]);
            const float m = sm.Mp[tt][tt - dd];
            dr[j][e] = fmaf(cx[e] * k2.x, m, dr[j][e]);
            dr[j][e + 1] = fmaf(cx[e + 1] * k2.y, m, dr[j][e + 1]);
            cx[e] *= e2.x;
            cx[e + 1] *= e2.y;
          }
          if (tl + dd < kL) {
            const float2 r2 = *reinterpret_cast<const float2*>(
                &st.r[tt + dd][i]);
            const float2 e2 = *reinterpret_cast<const float2*>(
                &st.E[tt + dd][i]);
            const float m = sm.Mp[tt + dd][tt];
            dk[j][e] = fmaf(cy[e] * r2.x, m, dk[j][e]);
            dk[j][e + 1] = fmaf(cy[e + 1] * r2.y, m, dk[j][e + 1]);
            cy[e] *= e2.x;
            cy[e + 1] *= e2.y;
          }
        }
      }
      // the bonus, the outputs
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = t0 + row_of(e, g), i = i0 + 8 * j + col_of(e, t);
        const float vd = sm.Mp[tt][tt], rr = st.r[tt][i], kk = st.k[tt][i];
        kd[pp][j][e] = kk * dk[j][e];
        rdr[pp][j][e] = rr * dr[j][e];
        if (tt < n && i < a.nk) {
          const int64_t off = (row0 + int64_t(tt) * a.H) * a.nk + i;
          store(static_cast<T*>(a.dr) + off,
                fmaf(st.u[i] * kk, vd, dr[j][e]));
          store(static_cast<T*>(a.dk) + off,
                fmaf(st.u[i] * rr, vd, dk[j][e]));
        }
      }
    }
  }
  // dv of a (block, 16 columns of v) a warp pass: the ending gradient
  // state, then M^T dout over the same and later blocks
  for (int p = warp; p < kNB * (kNV / 16); p += NW) {
    const int blk = p / (kNV / 16), n0 = p % (kNV / 16) * 16, s0 = blk * kL;
    float acc[2][4] = {};
    const float* post = st.span[blk + 1][kNB];
    mma_tiles<NK>(
        acc,
        [&](int m, int i) {
          return st.k[s0 + m][i] * st.eXin[s0 + m][i] * post[i];
        },
        [&](int i, int nn) { return sm.dS[i][n0 + nn]; }, g, t);
    for (int tb = blk; tb < kNB; ++tb) {
      float x[2][4] = {};
      const int q0 = tb * kL;
      mma_tiles<kL>(x, [&](int m, int j) { return sm.M[q0 + j][s0 + m]; },
                    [&](int j, int nn) { return st.d[q0 + j][n0 + nn]; }, g,
                    t);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += x[j][e];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = s0 + row_of(e, g), nn = n0 + 8 * j + col_of(e, t);
        if (s < n && nn < a.nv)
          store(static_cast<T*>(a.dv) + (row0 + int64_t(s) * a.H) * a.nv + nn,
                acc[j][e]);
      }
  }
  __syncthreads();
  // k dk' and r dr' over 2^Pin and 2^Xin (read by no one any more)
#pragma unroll
  for (int pp = 0; pp < PP; ++pp) {
    const int p = warp + pp * NW;
    if (p >= kNB * NJ) break;
    const int t0 = p / NJ * kL, i0 = p % NJ * 16;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = t0 + row_of(e, g), i = i0 + 8 * j + col_of(e, t);
        st.ePin[tt][i] = kd[pp][j][e];
        st.eXin[tt][i] = rdr[pp][j][e];
      }
  }
  __syncthreads();
  // dlog_w back through the chunk from Q^c, a thread a (block, i): each
  // block's sum of r dr' - k dk' (into T) and of r k vd (into span[0]:
  // both read by no one any more), then from the block's end Q = Q^c +
  // the later blocks' sums, dlog_w_t = Q - k dk', Q <- dlog_w_t + r dr';
  // the chunk's sum of r k vd for du, its blocks' added in order
  static_assert(kNB * NK <= NT, "a thread a (block, i)");
  const int blk = tid / NK, i = tid % NK;
  if (tid < kNB * NK) {
    float y = 0.f, part = 0.f;
#pragma unroll
    for (int l = kL - 1; l >= 0; --l) {
      const int tt = blk * kL + l;
      y += st.eXin[tt][i] - st.ePin[tt][i];
      part = fmaf(st.r[tt][i] * st.k[tt][i], sm.Mp[tt][tt], part);
    }
    st.T[blk][i] = y;
    st.span[0][blk][i] = part;
  }
  __syncthreads();
  if (tid < kNB * NK && i < a.nk) {
    if (blk == 0) {
      float part = 0.f;
#pragma unroll
      for (int bb = 0; bb < kNB; ++bb) part += st.span[0][bb][i];
      a.du_part[(bh * nc + c) * a.nk + i] = part;
    }
    float q = st.q[i];
    for (int later = kNB - 1; later > blk; --later) q += st.T[later][i];
#pragma unroll
    for (int l = kL - 1; l >= 0; --l) {
      const int tt = blk * kL + l;
      const float dlw = q - st.ePin[tt][i];
      if (tt < n) a.dlw[(row0 + int64_t(tt) * a.H) * a.nk + i] = dlw;
      q = dlw + st.eXin[tt][i];
    }
  }
}

// ---- (d) du[h][i] = the partials summed over (batch, chunk) in order ----
__global__ void du_sum(const Args a, int nc) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.H * a.nk) return;
  const int h = e / a.nk, i = e % a.nk;
  float s = 0.f;
  for (int b = 0; b < a.B; ++b)
    for (int c = 0; c < nc; ++c)
      s += a.du_part[((int64_t(b) * a.H + h) * nc + c) * a.nk + i];
  a.du[e] = s;
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

template <int NK, typename T>
cudaError_t prepare() {
  static const cudaError_t done = [] {
    cudaError_t e = set_smem(chunk_local<NK, T>, sizeof(Stage<NK>));
    return e == cudaSuccess ? set_smem(chunk_grads<NK, T>, sizeof(SmemC<NK>))
                            : e;
  }();
  return done;
}

// The four kernels on `stream`; a cudaError_t (0 = launched).
template <int NK, typename T>
int launch(const Args& a, cudaStream_t stream) {
  static_assert(sizeof(SmemC<NK>) <= 232448, "(c) fits an SM");
  cudaError_t e = prepare<NK, T>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nc = (a.T + kC - 1) / kC;
  const dim3 grid(a.B * a.H, nc);
  chunk_local<NK, T><<<grid, threads<NK>(), sizeof(Stage<NK>), stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int64_t warps = int64_t(a.B) * a.H * a.nk;
  chunk_scans<<<static_cast<unsigned>((warps * 32 + 255) / 256), 256, 0,
                stream>>>(a, nc);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  chunk_grads<NK, T><<<grid, threads<NK>(), sizeof(SmemC<NK>), stream>>>(
      a);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  du_sum<<<(a.H * a.nk + 255) / 256, 256, 0, stream>>>(a, nc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, cudaStream_t stream) {
  if (a.nk <= 16) return launch<16, T>(a, stream);
  if (a.nk <= 32) return launch<32, T>(a, stream);
  return launch<64, T>(a, stream);
}

}  // namespace wkvbc

#endif  // REPRO_WKV_BACKWARD_CHUNK_CUH
