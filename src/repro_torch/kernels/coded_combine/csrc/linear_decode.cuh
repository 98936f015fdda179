// Linear decode for Hopper (sm_90a):
//   out = (f - c[1] known[0] - ... - c[r-1] known[r-2]) / c[0]
// over float32 or bfloat16 streams: the missing stream of a coded packet f
// whose other r - 1 components the receiver holds.
//
// Replaces _decode_kernel / decode_pallas (repro/kernels/coded_combine/
// kernel.py:34, :74).  Included by coded_combine.cu after its launch
// helpers (it uses vector_count, to_f32, from_f32), built by the same nvcc
// call.
//
// Bound: HBM bytes, (r + 1) * n * itemsize for f and the r - 1 known
// streams read and one written.  The multiply-subtracts are no work against
// that, but the true division is: __fdiv_rn is some ten instructions, the
// reciprocal on the SFU and a check for the slow path, and the compiler
// runs a thread's divisions one after another.  The design is the XOR
// kernel's (xor_stream.cuh), which ties ATen's vectorised loop at the HBM
// ceiling, with four elements a thread:
//
// * one tile per block and no grid-stride loop: a tile is kDecodeThreads
//   vectors of every stream, one a thread, neighbouring threads on
//   neighbouring vectors; a vector is 4 elements, a float4 (16 bytes) or
//   4 bf16 (8 bytes), so every thread divides 4 times in either dtype (on
//   an H100, 16 bytes of bf16 a thread, 8 divisions, ran 0.3-1.0 % over
//   torch.sub's device time, 8 bytes under it: PERF.md, section 6);
// * every load of a thread is issued before its first subtract: the stream
//   count is a template for r <= 4 (fully unrolled); larger r takes a
//   runtime loop over the known streams that keeps four loads in flight;
//   at r = 1 no known stream is read;
// * loads on the read-only path (ld.global.nc), stores streaming
//   (st.global.cs): every byte is touched once.
//
// Arithmetic, in the reference's order and bit for bit (ref.decode_ref):
// fp32 accumulation i = 1..r-1 as __fsub_rn(acc, __fmul_rn(c[i], x_i)) (no
// FMA contraction), then one true division by c[0] (__fdiv_rn, never a
// multiply by the reciprocal), then one round to the stream dtype.  The
// work does not depend on the coefficients' values.
//
// The elements split two ways, by vector_count: when f, every known stream,
// the output and the stream stride are 16-byte aligned, elements
// [0, 4 n_vec) go as vectors and the threads past the body take the tail
// [4 n_vec, n) an element a thread, in the same launch; otherwise
// n_vec = 0 and every element is taken singly.

namespace {

constexpr int kDecodeThreads = 256;   // one vector a thread: a tile

// Four elements of T as one load, widened to fp32 and rounded back.
template <typename T> struct Quad;

template <> struct Quad<float> {
  using Raw = uint4;
  __device__ static void widen(const Raw& v, float* x) {
    x[0] = __uint_as_float(v.x); x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z); x[3] = __uint_as_float(v.w);
  }
  __device__ static Raw narrow(const float* x) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                      __float_as_uint(x[2]), __float_as_uint(x[3]));
  }
};

template <> struct Quad<__nv_bfloat16> {
  using Raw = uint2;                  // element 2k in the low half of word k
  __device__ static void widen(const Raw& v, float* x) {
    x[0] = __uint_as_float(v.x << 16);
    x[1] = __uint_as_float(v.x & 0xffff0000u);
    x[2] = __uint_as_float(v.y << 16);
    x[3] = __uint_as_float(v.y & 0xffff0000u);
  }
  __device__ static Raw narrow(const float* x) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    return make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                      *reinterpret_cast<const unsigned*>(&hi));
  }
};

// acc[e] -= c * x[e] for the 4 elements of one vector
template <typename T>
__device__ __forceinline__ void sub_scaled(float* acc, float c,
                                           const typename Quad<T>::Raw& raw) {
  float x[4];
  Quad<T>::widen(raw, x);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = __fsub_rn(acc[e], __fmul_rn(c, x[e]));
}

// R: number of streams (f and R - 1 known) when 1..4, or 0 for
// n_known + 1 streams at run time.  Thread i takes vector i of the body,
// or, past the body's n_vec vectors, tail element 4 n_vec + (i - n_vec).
template <typename T, int R>
__global__ void __launch_bounds__(kDecodeThreads)
linear_decode_kernel(const T* __restrict__ f, const T* __restrict__ known,
                     int64_t stride, int n_known,
                     const float* __restrict__ c, T* __restrict__ out,
                     int64_t n, int64_t n_vec) {
  using Raw = typename Quad<T>::Raw;
  const int64_t i = (int64_t)blockIdx.x * kDecodeThreads + threadIdx.x;
  if (i >= n_vec) {
    const int64_t e = 3 * n_vec + i;
    if (e >= n) return;
    float acc = to_f32(f[e]);
    for (int k = 0; k < n_known; ++k)
      acc = __fsub_rn(acc, __fmul_rn(__ldg(c + k + 1),
                                     to_f32(known[k * stride + e])));
    from_f32(out + e, __fdiv_rn(acc, __ldg(c)));
    return;
  }
  const Raw* kv = reinterpret_cast<const Raw*>(known) + i;
  const int64_t sv = stride / 4;
  const Raw fv = __ldg(reinterpret_cast<const Raw*>(f) + i);
  float acc[4];
  if constexpr (R > 1) {
    Raw x[R - 1];
#pragma unroll
    for (int k = 0; k < R - 1; ++k) x[k] = __ldg(kv + k * sv);
    Quad<T>::widen(fv, acc);
#pragma unroll
    for (int k = 0; k < R - 1; ++k) sub_scaled<T>(acc, __ldg(c + k + 1), x[k]);
  } else {
    Quad<T>::widen(fv, acc);
    if constexpr (R == 0) {
      int k = 0;
      for (; k + 4 <= n_known; k += 4) {       // four loads in flight
        Raw x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) x[u] = __ldg(kv + (k + u) * sv);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          sub_scaled<T>(acc, __ldg(c + k + u + 1), x[u]);
      }
      for (; k < n_known; ++k)
        sub_scaled<T>(acc, __ldg(c + k + 1), __ldg(kv + k * sv));
    }
  }
  const float c0 = __ldg(c);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = __fdiv_rn(acc[e], c0);
  __stcs(reinterpret_cast<Raw*>(out) + i, Quad<T>::narrow(acc));
}

template <typename T, int R>
int launch_linear_decode(const T* f, const T* known, int64_t stride,
                         int n_known, const float* c, T* out, int64_t n,
                         cudaStream_t s) {
  const int64_t n_vec = vector_count(n, stride, sizeof(T), 4, f,
                                     n_known > 0 ? known : nullptr, out);
  // one thread per body vector and per tail element
  const int64_t items = n_vec + (n - 4 * n_vec);
  const int64_t blocks = (items + kDecodeThreads - 1) / kDecodeThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  linear_decode_kernel<T, R><<<(unsigned)blocks, kDecodeThreads, 0, s>>>(
      f, known, stride, n_known, c, out, n, n_vec);
  return (int)cudaGetLastError();
}

// The instance for r = n_known + 1 streams.
template <typename T>
int launch_decode(const void* f_p, const void* known_p, int64_t stride,
                  int n_known, const float* c, void* out_p, int64_t n,
                  cudaStream_t s) {
  const T* f = static_cast<const T*>(f_p);
  const T* known = static_cast<const T*>(known_p);
  T* out = static_cast<T*>(out_p);
  switch (n_known) {
    case 0: return launch_linear_decode<T, 1>(f, known, stride, 0, c, out,
                                              n, s);
    case 1: return launch_linear_decode<T, 2>(f, known, stride, 1, c, out,
                                              n, s);
    case 2: return launch_linear_decode<T, 3>(f, known, stride, 2, c, out,
                                              n, s);
    case 3: return launch_linear_decode<T, 4>(f, known, stride, 3, c, out,
                                              n, s);
    default:
      return launch_linear_decode<T, 0>(f, known, stride, n_known, c, out, n,
                                        s);
  }
}

}  // namespace
