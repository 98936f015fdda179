// Hopper (sm_90a) kernels for the paper's linear combining function f(.)
// and its GF(2) variant: the coded-multicast encode at stage-1 senders and
// the decode at receivers of the hybrid shuffle.
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// (no --use_fast_math) into a shared library with a plain C interface,
// loaded with ctypes.  Every entry point launches on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().
//
// All four ops are elementwise over the n = T * d elements of one stream:
// each input element is read once from HBM and each output element written
// once, so each kernel is bound by HBM bytes, not by arithmetic (r
// multiply-adds per output element against (r + 1) * itemsize bytes).  The
// encode is a single pass: a grid-stride loop that moves 16 bytes per
// thread per stream when every pointer and stream stride is 16-byte aligned
// (float4 / 8 x bf16), and a scalar tail for whatever is left.  No shared
// memory, no tensor cores: neither helps a pass that does no reuse.  The
// decode (linear_decode.cuh) and the XOR pair (xor_stream.cuh) take one
// vector a thread and one tile a block, with the stream count a template.
//
// Arithmetic matches the Pallas kernels it replaces, in their order:
// fp32 accumulation over i = 0..r-1 with an explicit multiply then add
// (__fmul_rn / __fadd_rn, so the compiler cannot contract them into an
// FMA), one round to the stream dtype at the end, and a true IEEE division
// in the decode (__fdiv_rn, never a multiply by the reciprocal).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// dtype codes shared with ops.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// ---------------------------------------------------------------------------
// 16-byte vector of V elements, converted to and from fp32
// ---------------------------------------------------------------------------

template <typename T> struct Vec16;

template <> struct Vec16<float> {
  static constexpr int V = 4;
  __device__ static void load(const float* p, float* x) {
    float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  __device__ static void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <> struct Vec16<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static void load(const __nv_bfloat16* p, float* x) {
    uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = __bfloat162float(h[k]);
  }
  __device__ static void store(__nv_bfloat16* p, const float* x) {
    uint4 v;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
    for (int k = 0; k < V; ++k) h[k] = __float2bfloat16_rn(x[k]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ inline void from_f32(float* p, float v) { *p = v; }
__device__ inline void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// Linear encode:  out = sum_i c[i] * x[i]
// Replaces _encode_kernel / encode_pallas (repro/kernels/coded_combine/
// kernel.py:26, :58).  Bound: HBM bytes, (r + 1) * T * d * itemsize (r
// streams read, one written).  Single pass, fp32 accumulate in order.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const T* __restrict__ x, int64_t stride, int r,
              const float* __restrict__ c, T* __restrict__ out, int64_t n,
              int64_t n_vec) {
  constexpr int V = Vec16<T>::V;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t v = tid; v < n_vec; v += step) {
    const int64_t e = v * V;
    float acc[V], xi[V];
    Vec16<T>::load(x + e, xi);
    const float c0 = __ldg(c);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = __fmul_rn(c0, xi[k]);
    for (int i = 1; i < r; ++i) {
      Vec16<T>::load(x + i * stride + e, xi);
      const float ci = __ldg(c + i);
#pragma unroll
      for (int k = 0; k < V; ++k)
        acc[k] = __fadd_rn(acc[k], __fmul_rn(ci, xi[k]));
    }
    Vec16<T>::store(out + e, acc);
  }
  for (int64_t e = n_vec * V + tid; e < n; e += step) {
    float acc = __fmul_rn(__ldg(c), to_f32(x[e]));
    for (int i = 1; i < r; ++i)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(c + i), to_f32(x[i * stride + e])));
    from_f32(out + e, acc);
  }
}

// ---------------------------------------------------------------------------
// Launch helpers
// ---------------------------------------------------------------------------

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Vectors of V elements a kernel may take at a time: all of them when
// every base pointer and the stream stride are 16-byte aligned, otherwise
// none (the scalar tail then covers every element).
int64_t vector_count(int64_t n, int64_t stride, int elem_bytes, int V,
                     const void* a, const void* b, const void* o) {
  const bool ok = aligned16(a) && (b == nullptr || aligned16(b)) &&
                  aligned16(o) && ((stride * elem_bytes) % 16 == 0);
  return ok ? n / V : 0;
}

int grid_for(int64_t items) {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (items + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)(sms[dev] > 0 ? sms[dev] : 132) * 16;
  return (int)(want < 1 ? 1 : (want < cap ? want : cap));
}

template <typename T>
int launch_encode(const void* x, int64_t stride, int r, const float* c,
                  void* out, int64_t n, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const int V = Vec16<T>::V;
  const int64_t n_vec = vector_count(n, stride, sizeof(T), V, x, nullptr, out);
  const int64_t items = n_vec > 0 ? n_vec : n;
  encode_kernel<T><<<grid_for(items), kThreads, 0, s>>>(xp, stride, r, c, op,
                                                        n, n_vec);
  return (int)cudaGetLastError();
}

}  // namespace

// the decode and the XOR kernel (their own design; each reopens the unnamed
// namespace)
#include "linear_decode.cuh"
#include "xor_stream.cuh"

// ---------------------------------------------------------------------------
// C interface (ctypes).  x / known: [r, n] (resp. [r - 1, n]) streams laid
// out stream-major with `stride` elements between streams; c: [r] fp32 on
// the device; n > 0.  Returns cudaGetLastError() after the launch.
// ---------------------------------------------------------------------------

extern "C" int cc_encode(int dtype, const void* x, int64_t stride, int r,
                         const void* c, void* out, int64_t n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(c);
  if (dtype == kF32) return launch_encode<float>(x, stride, r, cf, out, n, s);
  if (dtype == kBF16)
    return launch_encode<__nv_bfloat16>(x, stride, r, cf, out, n, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int cc_decode(int dtype, const void* f, const void* known,
                         int64_t stride, int n_known, const void* c, void* out,
                         int64_t n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(c);
  if (dtype == kF32)
    return launch_decode<float>(f, known, stride, n_known, cf, out, n, s);
  if (dtype == kBF16)
    return launch_decode<__nv_bfloat16>(f, known, stride, n_known, cf, out, n,
                                        s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int cc_xor(const void* first, const void* rest, int64_t stride,
                      int n_rest, void* out, int64_t n, void* stream) {
  return launch_xor_r(first, rest, stride, n_rest, out, n,
                      static_cast<cudaStream_t>(stream));
}
