// Hopper (sm_90a) chunked WKV scan on the tensor cores: the "tensor_core"
// route of repro_torch/kernels/rwkv_scan/ops.py, for bf16 r, k, v (log_w
// fp32 or bf16) at Nk = Nv = 64, RWKV6-3B's head.  Included by
// wkv_scan.cu and built by the same nvcc call.  Replaces, like the step
// kernel there, _wkv_kernel / wkv_scan_pallas of
// src/repro/kernels/rwkv_scan/kernel.py, and computes the Pallas kernel's
// chunked form without its [C, C, Nk] gate tensor.
//
// The algorithm (plain version: ref.wkv_subchunk_ref(chunk=32, sub=16,
// leaf=8)), per (b, h) and chunk of kC = 32 steps, A the in-chunk running
// sum of log_w (base 2 here) and A_q[t] = A[t-1] (0 at t = 0); every
// exponent is a difference <= 0:
//   inter-chunk   o = (r * 2^A_q) . S
//   sub-chunks    M[1][0] = (r * 2^(A_q - A[15])) . (k * 2^(A[15] - A))^T,
//                 and inside each 16-row sub-chunk rows 8-15 after keys
//                 0-7 the same way about its row 7
//   diagonal      M[t][s] = sum_i r_ti k_si 2^(A_q[t,i] - A[s,i]), s < t in
//                 one 8-row block, M[t][t] = sum_i r_ti u_i k_ti
//   output        o += M . v, rounded once to bf16
//   state         S = diag(2^A[31]) S + (k * 2^(A[31] - A))^T . v
// The products run as mma.sync m16n8k8 TF32 with fp32 accumulators, every
// operand rounded to TF32 (to nearest, ties away), everything else fp32.
// The 8 x 8 diagonal blocks take their gates as running products of E =
// 2^w (G[t][s] = G[t][s+1] * E[s+1], each factor <= 1): one exponential
// per (t, i), not one per (t, s, i).  TF32 products pass the bf16
// tolerance and bf16 products would not (PERF.md), so fp32 streams stay on
// the step kernel.
//
// The machine: one block of 4 warps per (b, h), time in a loop inside the
// block (only the state chains chunks).  Warp w = (rb, ch) owns output
// rows 16 rb .. 16 rb + 15 and columns 32 ch .. 32 ch + 31 of a chunk, half
// of the Nk sum of its row block's M (the two halves meet in shared
// memory) and of M[1][0]'s keys 8 rb .. 8 rb + 7, and state rows 16 w ..
// 16 w + 15, kept in fp32 registers across chunks (a TF32 copy in shared
// memory feeds the inter product).  Chunk c + 1's r, k, v, log_w tiles go
// in flight (cp.async, two stages) as chunk c starts (issued after its
// running sums they cost 7 %, PERF.md); rows past T are zero-filled, which
// leaves the state alone, and their outputs are not stored.  75,296 bytes
// of shared memory a block, so three blocks (12 warps) fit on an SM and
// all B * h = 320 blocks of the RWKV6-3B prefill are resident at once.
// What bounds it: instruction issue and latency at some 10 warps an SM, in
// a chunk of four barriers (PERF.md); bytes (each input read once) and
// TF32 operations are far below.

#ifndef REPRO_WKV_CHUNK_CUH
#define REPRO_WKV_CHUNK_CUH

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wkvtc {

constexpr int kN = 64;           // Nk = Nv
constexpr int kC = 32;           // steps a chunk
constexpr int kL = 16;           // steps a sub-chunk (one mma row tile)
constexpr int kThreads = 128;    // 4 warps
constexpr int kAS = 72;          // row stride of A (floats): no conflicts
constexpr int kM0S = 20;         // row strides of the M partials: no
constexpr int kM1S = 36;         // conflicts for the M . v reads
constexpr int kMinT = kL;        // shortest sequence the route takes
constexpr float kLog2e = 1.4426950408889634f;

struct Smem {
  __nv_bfloat16 r[2][kC * kN];   // two stages; 128-byte rows, 16-byte
  __nv_bfloat16 k[2][kC * kN];   // chunks swizzled by (row & 7)
  __nv_bfloat16 v[2][kC * kN];   // rows permuted in eights (vrow)
  float w[2][kC * kN];           // log_w as loaded, then E = 2^w in place
  float A[(kC + 1) * kAS];       // row t + 1: base-2 running sum of log_w
                                 // through step t; row 0 stays 0
  float S[kN * kN];              // TF32 copy of the state, swizzled
  float m0[2][kL * kM0S];        // row block 0's M, one partial per ch
  float m1[2][kL * kM1S];        // row block 1's M (cols 0-15 off-diag)
  float u[kN];
  float tot[4][kN];              // each warp's sum of its 8 rows of log_w
};

// x as a TF32 operand, rounded to nearest with ties away from zero (what
// cvt.rna.tf32.f32 gives): the tensor cores ignore the low 13 bits of a
// .tf32 operand, so adding half a TF32 ulp to the magnitude rounds it, in
// one integer add (x is finite)
__device__ __forceinline__ uint32_t tf32(float x) {
  return __float_as_uint(x) + 0x1000u;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

// element (row, col) of a swizzled bf16 tile
__device__ __forceinline__ int swz(int row, int col) {
  return row * kN + (((col >> 3) ^ (row & 7)) << 3) + (col & 7);
}
__device__ __forceinline__ float bf(const __nv_bfloat16* t, int row,
                                    int col) {
  return __bfloat162float(t[swz(row, col)]);
}
// t[row][col], t[row][col + 1], col even
__device__ __forceinline__ float2 bf2(const __nv_bfloat16* t, int row,
                                      int col) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(t + swz(row, col));
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
// where v's step s lies in its tile: in each eight, steps 0-3 on the even
// rows and 4-7 on the odd ones, so that ldmatrix.trans hands thread
// (g, tq) steps tq and tq + 4 of a column, a product step's B operands
__device__ __forceinline__ int vrow(int s) {
  return (s & ~7) | ((s & 3) << 1) | ((s >> 2) & 1);
}
// B operands of four m16n8k8 steps from v: steps 8 kk .. 8 kk + 7 and, for
// q = 0-3, columns 8 (nb + q) .. + 7 (b[q][0] step tq, b[q][1] step tq +
// 4, column g), as bf16 values are exact TF32 operands
__device__ __forceinline__ void ldm_v(const __nv_bfloat16* vs, int kk,
                                      int nb, int lane,
                                      uint32_t (&b)[4][2]) {
  const int row = 8 * kk + (lane & 7), chunk = nb + (lane >> 3);
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(
      vs + row * kN + ((chunk ^ (row & 7)) << 3)));
  uint32_t x[4];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
      : "r"(a));
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    b[q][0] = x[q] << 16;
    b[q][1] = x[q] & 0xffff0000u;
  }
}
// eight bf16 values t[row][col .. col + 7], col a multiple of 8
__device__ __forceinline__ void bf8(const __nv_bfloat16* t, int row,
                                    int col, float (&x)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(t + swz(row, col));
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[2 * e] = __uint_as_float(w[e] << 16);
    x[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}
// element (i, j) of the swizzled state copy (no conflicts for the inter
// product's reads of rows 2 tq + 8 kk and + 1, columns g + 8 nt)
__device__ __forceinline__ int sidx(int i, int j) {
  return i * kN + (j ^ (((i >> 1) & 3) << 3));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0));
}

// chunk rows [0, n) of one (b, h) into stage st, by nt threads (tid <
// nt); rows past n zero-filled
template <typename TW>
__device__ __forceinline__ void load_chunk(
    Smem& sm, int st, const __nv_bfloat16* r, const __nv_bfloat16* k,
    const __nv_bfloat16* v, const TW* lw, int64_t row0, int64_t stride,
    int n, int tid, int nt) {
#pragma unroll 4
  for (int q = tid; q < kC * 8; q += nt) {
    const int row = q >> 3, c = q & 7;
    const bool in = row < n;
    const int64_t g = row0 + (in ? row : 0) * stride + c * 8;
    const int s = row * kN + ((c ^ (row & 7)) << 3);
    const int pv = vrow(row);
    cp16(&sm.r[st][s], r + g, in);
    cp16(&sm.k[st][s], k + g, in);
    cp16(&sm.v[st][pv * kN + ((c ^ (pv & 7)) << 3)], v + g, in);
  }
  constexpr int per = 16 / sizeof(TW);           // elements a 16-byte copy
  constexpr int cols = kN / per;
  TW* wt = reinterpret_cast<TW*>(sm.w[st]);      // bf16 log_w: first half
#pragma unroll 8
  for (int q = tid; q < kC * cols; q += nt) {
    const int row = q / cols, c = q % cols;
    const bool in = row < n;
    cp16(&wt[row * kN + c * per], lw + row0 + (in ? row : 0) * stride
                                      + c * per, in);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename TW>
__global__ void __launch_bounds__(kThreads, 3)
wkv_chunk_tc(const __nv_bfloat16* __restrict__ r,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const TW* __restrict__ lw,
             const float* __restrict__ u, const float* __restrict__ s0,
             __nv_bfloat16* __restrict__ out, float* __restrict__ sT,
             int T_len, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;        // mma group and thread
  const int rb = wid >> 1, ch = wid & 1;         // row block, column half
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int64_t stride = int64_t(H) * kN;        // elements between steps
  const int64_t base = (int64_t(b) * T_len * H + h) * kN;   // (b, 0, h, 0)
  const int nc = (T_len + kC - 1) / kC;

  load_chunk<TW>(sm, 0, r, k, v, lw, base, stride, min(kC, T_len), tid,
                 kThreads);
  asm volatile("cp.async.commit_group;");
  if (tid < kN) sm.u[tid] = u[h * kN + tid];
  if (tid < kAS) sm.A[tid] = 0.f;                // A[-1] = 0: A_q[0]

  // the state: rows i0 = 16 wid + g and i1 = i0 + 8, columns 8 nt + 2 tq
  // and + 1 (the accumulator layout of m16n8k8)
  const int i0 = 16 * wid + g, i1 = i0 + 8;
  // where the inter product's B operands lie in the state copy: row 2 tq
  // (+ 8 kk, + 1), column 32 ch + 8 nt + g, swizzled (sidx)
  int s_at[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    s_at[nt] = 2 * tq * kN + 32 * ch + ((nt ^ tq) << 3) + g;
  const float* s0h = s0 ? s0 + int64_t(bh) * kN * kN : nullptr;
  float st[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = 8 * nt + 2 * tq;
    st[nt][0] = s0h ? s0h[i0 * kN + j] : 0.f;
    st[nt][1] = s0h ? s0h[i0 * kN + j + 1] : 0.f;
    st[nt][2] = s0h ? s0h[i1 * kN + j] : 0.f;
    st[nt][3] = s0h ? s0h[i1 * kN + j + 1] : 0.f;
    *reinterpret_cast<float2*>(&sm.S[sidx(i0, j)]) = make_float2(
        __uint_as_float(tf32(st[nt][0])), __uint_as_float(tf32(st[nt][1])));
    *reinterpret_cast<float2*>(&sm.S[sidx(i1, j)]) = make_float2(
        __uint_as_float(tf32(st[nt][2])), __uint_as_float(tf32(st[nt][3])));
  }

  for (int c = 0; c < nc; ++c) {
    const int cur = c & 1;
    const int t0 = c * kC;
    const int n = min(kC, T_len - t0);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();       // stage cur landed; chunk c - 1 done with both
    const __nv_bfloat16* rs = sm.r[cur];
    const __nv_bfloat16* ks = sm.k[cur];
    const __nv_bfloat16* vs = sm.v[cur];
    float* E = sm.w[cur];
    const float* A = sm.A;

    if (c + 1 < nc)
      load_chunk<TW>(sm, cur ^ 1, r, k, v, lw, base + (t0 + kC) * stride,
                     stride, min(kC, T_len - t0 - kC), tid, kThreads);
    asm volatile("cp.async.commit_group;");

    // ---- running sums of log_w: warp w takes rows 8 w .. 8 w + 7, lane l
    // columns 2 l and 2 l + 1; the warps' sums meet in shared memory -----
    {
      const TW* wt = reinterpret_cast<const TW*>(E);
      float2 wl[8], run[8];
      float2 a = make_float2(0.f, 0.f);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int e = (8 * wid + t) * kN + 2 * lane;
        wl[t] = make_float2(__fmul_rn(to_f32(wt[e]), kLog2e),
                            __fmul_rn(to_f32(wt[e + 1]), kLog2e));
        a = make_float2(__fadd_rn(a.x, wl[t].x), __fadd_rn(a.y, wl[t].y));
        run[t] = a;
      }
      *reinterpret_cast<float2*>(&sm.tot[wid][2 * lane]) = a;
      __syncthreads();     // every read of log_w is done before E lands
      float2 pre = make_float2(0.f, 0.f);                 // rows before
      for (int w = 0; w < wid; ++w) {
        const float2 x = ld2(&sm.tot[w][2 * lane]);
        pre = make_float2(__fadd_rn(pre.x, x.x), __fadd_rn(pre.y, x.y));
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int row = 8 * wid + t;
        *reinterpret_cast<float2*>(&sm.A[(row + 1) * kAS + 2 * lane]) =
            make_float2(__fadd_rn(pre.x, run[t].x),
                        __fadd_rn(pre.y, run[t].y));
        *reinterpret_cast<float2*>(&E[row * kN + 2 * lane]) =
            make_float2(ex2(wl[t].x), ex2(wl[t].y));
      }
    }
    __syncthreads();

    // ---- inter-chunk: rows of row block rb, columns of half ch --------
    // (k index tq of a product step is column 2 tq, tq + 4 is 2 tq + 1)
    const int ra = kL * rb + g;                  // rows ra and ra + 8
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kN / 8; ++kk) {
      const int c0 = 8 * kk + 2 * tq;
      const float2 x0 = bf2(rs, ra, c0), x1 = bf2(rs, ra + 8, c0);
      const float2 q0 = ld2(&A[ra * kAS + c0]);          // A_q = A[t - 1]
      const float2 q1 = ld2(&A[(ra + 8) * kAS + c0]);
      const uint32_t a0 = tf32(x0.x * ex2(q0.x)), a1 = tf32(x1.x * ex2(q1.x));
      const uint32_t a2 = tf32(x0.y * ex2(q0.y)), a3 = tf32(x1.y * ex2(q1.y));
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* sp = &sm.S[s_at[nt] + 8 * kk * kN];   // sidx(c0, j)
        mma(acc[nt], a0, a1, a2, a3, __float_as_uint(sp[0]),
            __float_as_uint(sp[kN]));
      }
    }

    // ---- diagonal sub-chunk, Nk half ch --------------------------------
    // Its 16 x 16 block splits again at row 8: rows 8-15 after keys 0-7
    // are one more (half-empty) TF32 product, and the two 8 x 8 blocks on
    // the diagonal are computed directly.
    {
      float* mp = rb ? sm.m1[ch] : sm.m0[ch];
      const int ms = rb ? kM1S : kM0S;
      const int off = kL * rb;                   // block's first row/col
      const int ib = 32 * ch + 8 * tq;           // this lane's 8 columns
      float r1[8], r2[8], kv[8], e[8];
      {  // rows 8-15 after keys 0-7, e2 the last of those keys
        float m2[4] = {0.f, 0.f, 0.f, 0.f};
        const int t = off + 8 + g, sk = off + g;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int c0 = 32 * ch + 8 * kk + 2 * tq;
          const float2 ze = ld2(&A[(off + 8) * kAS + c0]);  // A[e2]
          const float2 x = bf2(rs, t, c0), q = ld2(&A[t * kAS + c0]);
          const float2 y = bf2(ks, sk, c0);
          const float2 as = ld2(&A[(sk + 1) * kAS + c0]);
          mma(m2, tf32(x.x * ex2(q.x - ze.x)), 0u,
              tf32(x.y * ex2(q.y - ze.y)), 0u,
              tf32(y.x * ex2(ze.x - as.x)), tf32(y.y * ex2(ze.y - as.y)));
        }
        *reinterpret_cast<float2*>(&mp[(8 + g) * ms + off + 2 * tq]) =
            make_float2(m2[0], m2[1]);
      }
      // the 8 x 8 diagonal blocks: quad g takes rows q1 = g & 3 and
      // q2 = 7 - q1 of block bq = g / 4; h = r_q 2^(A[q - 1] - A[s]) is
      // walked from s = q - 1 down, each step a factor E[s + 1] <= 1
      const int ob = off + 8 * (g >> 2);         // the block's first row
      const int q1 = g & 3, q2 = 7 - q1;
      float* m1row = mp + (ob - off + q1) * ms + ob;
      float* m2row = mp + (ob - off + q2) * ms + ob;
      bf8(rs, ob + q1, ib, r1);
      bf8(rs, ob + q2, ib, r2);
      {  // the bonus u on the diagonal
        float d1 = 0.f, d2 = 0.f;
        bf8(ks, ob + q1, ib, kv);
#pragma unroll
        for (int x = 0; x < 8; ++x)
          d1 = fmaf(r1[x] * sm.u[ib + x], kv[x], d1);
        bf8(ks, ob + q2, ib, kv);
#pragma unroll
        for (int x = 0; x < 8; ++x)
          d2 = fmaf(r2[x] * sm.u[ib + x], kv[x], d2);
        d1 = quad_sum(d1);
        d2 = quad_sum(d2);
        if (tq == 0) m1row[q1] = d1;
        if (tq == 1) m2row[q2] = d2;
      }
      float h1[8], h2[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        h1[x] = r1[x];
        h2[x] = r2[x];
      }
      auto key_row = [&](int s) {
        bf8(ks, ob + s, ib, kv);
        const float4 e0 = *reinterpret_cast<const float4*>(
            &E[(ob + s + 1) * kN + ib]);
        const float4 e1 = *reinterpret_cast<const float4*>(
            &E[(ob + s + 1) * kN + ib + 4]);
        e[0] = e0.x; e[1] = e0.y; e[2] = e0.z; e[3] = e0.w;
        e[4] = e1.x; e[5] = e1.y; e[6] = e1.z; e[7] = e1.w;
      };
      // keys 6 .. 3: row q2 alone (q1 <= 3 has no key there)
#pragma unroll
      for (int s = 6; s >= 3; --s) {
        key_row(s);
        const bool first = s == q2 - 1;
        float pa = 0.f, pb = 0.f;
#pragma unroll
        for (int x = 0; x < 8; x += 2) {
          h2[x] = first ? r2[x] : h2[x] * e[x];
          h2[x + 1] = first ? r2[x + 1] : h2[x + 1] * e[x + 1];
          pa = fmaf(h2[x], kv[x], pa);
          pb = fmaf(h2[x + 1], kv[x + 1], pb);
        }
        const float p = quad_sum(pa + pb);
        if (tq == 1 && s < q2) m2row[s] = p;
      }
      // keys 2 .. 0: both rows
#pragma unroll
      for (int s = 2; s >= 0; --s) {
        key_row(s);
        const bool first = s == q1 - 1;
        float p1 = 0.f, p2 = 0.f;
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          h1[x] = first ? r1[x] : h1[x] * e[x];
          h2[x] *= e[x];
          p1 = fmaf(h1[x], kv[x], p1);
          p2 = fmaf(h2[x], kv[x], p2);
        }
        p1 = quad_sum(p1);
        p2 = quad_sum(p2);
        if (tq == 0 && s < q1) m1row[s] = p1;
        if (tq == 1) m2row[s] = p2;
      }
    }

    // ---- row block 1 after key block 0, Nk half ch: keys 8 rb .. + 7 ---
    {
      float mo[4] = {0.f, 0.f, 0.f, 0.f};
      const int t = kL + g, sk = 8 * rb + g;     // rows t, t + 8; key sk
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int c0 = 32 * ch + 8 * kk + 2 * tq;
        const float2 ze = ld2(&A[kL * kAS + c0]);          // A[15]
        const float2 x0 = bf2(rs, t, c0), x1 = bf2(rs, t + 8, c0);
        const float2 q0 = ld2(&A[t * kAS + c0]);
        const float2 q1 = ld2(&A[(t + 8) * kAS + c0]);
        const float2 y = bf2(ks, sk, c0);
        const float2 as = ld2(&A[(sk + 1) * kAS + c0]);
        mma(mo, tf32(x0.x * ex2(q0.x - ze.x)), tf32(x1.x * ex2(q1.x - ze.x)),
            tf32(x0.y * ex2(q0.y - ze.y)), tf32(x1.y * ex2(q1.y - ze.y)),
            tf32(y.x * ex2(ze.x - as.x)), tf32(y.y * ex2(ze.y - as.y)));
      }
      float* mp = sm.m1[ch] + 8 * rb + 2 * tq;
      *reinterpret_cast<float2*>(&mp[g * kM1S]) = make_float2(mo[0], mo[1]);
      *reinterpret_cast<float2*>(&mp[(g + 8) * kM1S]) =
          make_float2(mo[2], mo[3]);
    }

    // ---- state: rows i0, i1 += (k 2^(A[31] - A))^T . v ------------------
    {
      const float z0 = A[kC * kAS + i0], z1 = A[kC * kAS + i1];   // A[31]
      const float d0 = ex2(z0), d1 = ex2(z1);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        st[nt][0] *= d0;
        st[nt][1] *= d0;
        st[nt][2] *= d1;
        st[nt][3] *= d1;
      }
#pragma unroll
      for (int kk = 0; kk < kC / 8; ++kk) {
        const int s0r = 8 * kk + tq, s1r = s0r + 4;
        const uint32_t a0 =
            tf32(bf(ks, s0r, i0) * ex2(z0 - A[(s0r + 1) * kAS + i0]));
        const uint32_t a1 =
            tf32(bf(ks, s0r, i1) * ex2(z1 - A[(s0r + 1) * kAS + i1]));
        const uint32_t a2 =
            tf32(bf(ks, s1r, i0) * ex2(z0 - A[(s1r + 1) * kAS + i0]));
        const uint32_t a3 =
            tf32(bf(ks, s1r, i1) * ex2(z1 - A[(s1r + 1) * kAS + i1]));
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t bv[4][2];
          ldm_v(vs, kk, 4 * half, lane, bv);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            mma(st[4 * half + q], a0, a1, a2, a3, bv[q][0], bv[q][1]);
        }
      }
    }
    __syncthreads();       // M complete; every warp done reading S

    // ---- o += M . v: key rows 0 .. 16 rb + 15 ---------------------------
    {
      const float* ma = rb ? sm.m1[0] : sm.m0[0];
      const float* mb = rb ? sm.m1[1] : sm.m0[1];
      const int ms = rb ? kM1S : kM0S;
      const int off = kL * rb;
      // row q of the block (0-15), key column s; the entries above the
      // diagonal were never written
      auto mval = [&](int q, int s) {
        return s < off || s - off <= q ? ma[q * ms + s] + mb[q * ms + s]
                                       : 0.f;
      };
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= 2 * (rb + 1)) break;
        const int c0 = 8 * kk + tq, c1 = c0 + 4;
        const uint32_t a0 = tf32(mval(g, c0)), a1 = tf32(mval(g + 8, c0));
        const uint32_t a2 = tf32(mval(g, c1)), a3 = tf32(mval(g + 8, c1));
        uint32_t bv[4][2];
        ldm_v(vs, kk, 4 * ch, lane, bv);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma(acc[nt], a0, a1, a2, a3, bv[nt][0], bv[nt][1]);
      }
      __nv_bfloat16* o = out + base + int64_t(t0) * stride;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int j = 32 * ch + 8 * nt + 2 * tq;
        if (ra < n)
          *reinterpret_cast<__nv_bfloat162*>(o + ra * stride + j) =
              __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
        if (ra + 8 < n)
          *reinterpret_cast<__nv_bfloat162*>(o + (ra + 8) * stride + j) =
              __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
      }
    }

    // ---- the new state's TF32 copy: every warp is past its inter
    // product (the barrier above) -----------------------------------------
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int j = 8 * nt + 2 * tq;
      *reinterpret_cast<float2*>(&sm.S[sidx(i0, j)]) =
          make_float2(__uint_as_float(tf32(st[nt][0])),
                      __uint_as_float(tf32(st[nt][1])));
      *reinterpret_cast<float2*>(&sm.S[sidx(i1, j)]) =
          make_float2(__uint_as_float(tf32(st[nt][2])),
                      __uint_as_float(tf32(st[nt][3])));
    }
  }

  float* sTh = sT + int64_t(bh) * kN * kN;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = 8 * nt + 2 * tq;
    *reinterpret_cast<float2*>(&sTh[i0 * kN + j]) =
        make_float2(st[nt][0], st[nt][1]);
    *reinterpret_cast<float2*>(&sTh[i1 * kN + j]) =
        make_float2(st[nt][2], st[nt][3]);
  }
}

template <typename TW>
cudaError_t set_smem() {
  static cudaError_t done = [] {
    cudaError_t e = cudaFuncSetAttribute(
        wkv_chunk_tc<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(Smem)));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wkv_chunk_tc<TW>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return done;
}

template <typename TW>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const float* u, const float* s0, void* out, float* sT, int B,
           int T_len, int H, cudaStream_t stream) {
  const cudaError_t e = set_smem<TW>();
  if (e != cudaSuccess) return static_cast<int>(e);
  wkv_chunk_tc<TW><<<B * H, kThreads, sizeof(Smem), stream>>>(
      static_cast<const __nv_bfloat16*>(r),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const TW*>(lw), u, s0,
      static_cast<__nv_bfloat16*>(out), sT, T_len, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename TW>
int blocks_per_sm() {
  int n = 0;
  if (set_smem<TW>() != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n, wkv_chunk_tc<TW>, kThreads, sizeof(Smem)) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace wkvtc

#endif  // REPRO_WKV_CHUNK_CUH
