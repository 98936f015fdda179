// TF32 mma.sync helpers shared by the flash attention kernels that run every
// product as mma.sync.m16n8k8 TF32 with fp32 accumulators: the forward
// (flash_mma.cuh, included by flash_attention.cu) and the backward
// (flash_backward.cu).  Each source is built into its own library, so each
// holds its own copy of these inline functions.
//
// Operands: an fp32 value x enters as hi = tf32(x) and lo = tf32(x - hi)
// (op<true>), and a product as lo.hi + hi.lo + hi.hi (mma3), within a few
// fp32 roundoffs of an fp32 FMA loop; bf16 data is exact in TF32 and enters
// unsplit (op<false>).  Tiles are staged in shared memory with rows padded
// by one 16-byte chunk (ld), by cp.async when every row is 16-byte aligned.
// Fragments (g = lane / 4, t = lane % 4): frag_a and frag_bt read row-major
// operands, frag_c turns an accumulator tile into the next product's A
// operand with its contraction index permuted (slot t: column 2t, slot
// t + 4: column 2t + 1), and frag_bk reads a B operand's rows in that order.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tf32 {

// ---------------------------------------------------------------------------
// small device helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// an mma operand: hi = x rounded to TF32 (nearest, ties away), lo = the
// rest rounded to TF32: hi + lo holds x to 2^-22 of |x|.  The tensor cores
// ignore a .tf32 operand's low 13 bits, so lo is rounded by the add alone
// (hi is masked: lo needs its value).  Truncating both parts instead takes
// two instructions a value, not four, and holds x to 2^-20: 13 % faster at
// Qwen2's shape, but its roundoff in gradients that are zero in exact
// arithmetic (Whisper's key biases) moved Adam's first step past
// chip_smoke.py's 1e-4 card-against-CPU gate (phase 9 (c))
struct Op { uint32_t hi, lo; };
template <bool SPLIT>
__device__ __forceinline__ Op op(float x) {
  if (SPLIT) {
    const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    return {h, __float_as_uint(x - __uint_as_float(h)) + 0x1000u};
  }
  return {__float_as_uint(x), 0u};     // exact in TF32 (bf16 data)
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

// d += a . b with split operands: the small terms first, then hi . hi
template <bool SA, bool SB>
__device__ __forceinline__ void mma3(float (&d)[4], const Op (&a)[4],
                                     const Op (&b)[2]) {
  if (SA) mma(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  if (SB) mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

__device__ __forceinline__ void add4(float (&d)[4], const float (&x)[4]) {
  d[0] += x[0]; d[1] += x[1]; d[2] += x[2]; d[3] += x[3];
}

// Row stride of a staged [rows][HD] tile: one 16-byte chunk of padding, so
// that the row-major fragment reads (row g, column t) and the permuted
// column reads (row 2t, column g) both hit 32 different banks, and every
// offset is the lane's base plus a constant
template <typename T, int HD>
__device__ __host__ constexpr int ld() { return HD + 16 / (int)sizeof(T); }

__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Stage ROWS rows of HD elements into the padded tile dst: row r from
// base + off(r), zero past hd and where off(r) < 0.  16-byte cp.async
// chunks when every row is 16-byte aligned (vec), plain loads otherwise.
template <typename T, int HD, int ROWS, int NTH, typename OffFn>
__device__ __forceinline__ void stage(T* dst, const T* base, int hd,
                                      bool vec, OffFn off) {
  constexpr int V = 16 / (int)sizeof(T), CPR = HD / V;
  for (int e = threadIdx.x; e < ROWS * CPR; e += NTH) {
    const int r = e / CPR, c = (e % CPR) * V;
    const int64_t o = off(r);
    T* d = dst + r * ld<T, HD>() + c;
    const int n = o < 0 ? 0 : max(0, min(V, hd - c));
    if (vec) {
      cp16(d, n ? (const void*)(base + o + c) : (const void*)base,
           n * (int)sizeof(T));
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) d[u] = u < n ? base[o + c + u] : zero<T>();
    }
  }
}

// Fragments of staged tiles (g = lane / 4, t = lane % 4).
// A: rows r0..r0+15, contraction columns c0..c0+7
template <typename T, int HD, bool SPLIT>
__device__ __forceinline__ void frag_a(Op (&f)[4], const T* tile, int r0,
                                       int c0, int g, int t) {
  constexpr int LD = ld<T, HD>();
  f[0] = op<SPLIT>(f32(tile[(r0 + g) * LD + c0 + t]));
  f[1] = op<SPLIT>(f32(tile[(r0 + g + 8) * LD + c0 + t]));
  f[2] = op<SPLIT>(f32(tile[(r0 + g) * LD + c0 + t + 4]));
  f[3] = op<SPLIT>(f32(tile[(r0 + g + 8) * LD + c0 + t + 4]));
}
// B[k][n] = tile[r0 + n][c0 + k]: n over rows r0..r0+7
template <typename T, int HD, bool SPLIT>
__device__ __forceinline__ void frag_bt(Op (&f)[2], const T* tile, int r0,
                                        int c0, int g, int t) {
  constexpr int LD = ld<T, HD>();
  f[0] = op<SPLIT>(f32(tile[(r0 + g) * LD + c0 + t]));
  f[1] = op<SPLIT>(f32(tile[(r0 + g) * LD + c0 + t + 4]));
}
// B[k][n] = tile[r0 + k][c0 + n], k in the permuted order (slot t: row
// 2t, slot t + 4: row 2t + 1) that matches frag_c
template <typename T, int HD, bool SPLIT>
__device__ __forceinline__ void frag_bk(Op (&f)[2], const T* tile, int r0,
                                        int c0, int g, int t) {
  constexpr int LD = ld<T, HD>();
  f[0] = op<SPLIT>(f32(tile[(r0 + 2 * t) * LD + c0 + g]));
  f[1] = op<SPLIT>(f32(tile[(r0 + 2 * t + 1) * LD + c0 + g]));
}
// A operand (16 x 8, permuted contraction) from a 16 x 8 accumulator tile:
// lane (g, t) holds columns 2t and 2t + 1 of rows g and g + 8
__device__ __forceinline__ void frag_c(Op (&f)[4], const float (&c)[4]) {
  f[0] = op<true>(c[0]);
  f[1] = op<true>(c[2]);
  f[2] = op<true>(c[1]);
  f[3] = op<true>(c[3]);
}

// x (NT accumulator tiles of a warp) summed over the DW warps of its group
// through shared memory, in warp order: the same bits in each of them.
// xput for every slot, one __syncthreads, then xsum.
template <int NT>
__device__ __forceinline__ void xput(float4* slot, int lane,
                                     const float (&x)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
    slot[n * 32 + lane] = make_float4(x[n][0], x[n][1], x[n][2], x[n][3]);
}
template <int NT, int DW>
__device__ __forceinline__ void xsum(const float4* first, int stride,
                                     int lane, float (&x)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float4 s = first[n * 32 + lane];
#pragma unroll
    for (int w = 1; w < DW; ++w) {
      const float4 p = first[w * stride + n * 32 + lane];
      s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
    }
    x[n][0] = s.x; x[n][1] = s.y; x[n][2] = s.z; x[n][3] = s.w;
  }
}

}  // namespace tf32
