// XOR combine for Hopper (sm_90a):  out = first ^ rest[0] ^ ... ^
// rest[n_rest - 1]  over 32-bit words (int32 and uint32 share it).
//
// Replaces _xor_encode_kernel / xor_encode_pallas and _xor_decode_kernel /
// xor_decode_pallas (repro/kernels/coded_combine/kernel.py:44, :91 and
// :51, :105).  One kernel serves both: a decode is an encode whose first
// stream is f.  Included by coded_combine.cu after its launch helpers
// (it uses their vector_count), built by the same nvcc call.
//
// Bound: HBM bytes, (r + 1) * n * 4 for r = n_rest + 1 streams read and one
// written; one XOR per 4 bytes read is no work.  So the design only has to
// keep enough bytes in flight with few instructions per byte:
//
// * one tile per block and no grid-stride loop (ATen's shape): a tile is
//   kXorThreads 16-byte vectors of every stream, one a thread,
//   neighbouring threads on neighbouring vectors;
// * every load of a thread is issued before its first XOR: the stream
//   count is a template for r <= 4 (fully unrolled); larger r takes a
//   runtime loop over streams that keeps four loads in flight;
// * loads on the read-only path (ld.global.nc), stores streaming
//   (st.global.cs): every byte is touched once.
//
// Chosen over a ring of TMA bulk copies through shared memory and over
// register-streaming variants (two or four vectors a thread, a persistent
// grid, loads marked L1::no_allocate or an L2 evict_first policy), all of
// which read slower on an H100 (PERF.md, section 6).
//
// The words split two ways, by vector_count: when every stream, the output
// and the stream stride are 16-byte aligned, words [0, 4 n_vec) are read
// and written as 16-byte vectors and the threads past the body take the
// tail [4 n_vec, n) a word a thread, in the same launch; otherwise
// n_vec = 0 and every word is taken singly.

namespace {

constexpr int kXorThreads = 256;   // one 16-byte vector a thread: a tile

__device__ __forceinline__ void xor_into(int4& a, const int4& b) {
  a.x ^= b.x; a.y ^= b.y; a.z ^= b.z; a.w ^= b.w;
}

// R: number of streams when 1..4, or 0 for n_rest + 1 streams at run time.
// Thread i takes vector i of the body, or, past the body's n_vec vectors,
// tail word 4 n_vec + (i - n_vec).
template <int R>
__global__ void __launch_bounds__(kXorThreads)
xor_stream_kernel(const int32_t* __restrict__ first,
                  const int32_t* __restrict__ rest, int64_t stride,
                  int n_rest, int32_t* __restrict__ out, int64_t n,
                  int64_t n_vec) {
  const int64_t i = (int64_t)blockIdx.x * kXorThreads + threadIdx.x;
  if (i >= n_vec) {
    const int64_t e = 3 * n_vec + i;
    if (e >= n) return;
    int32_t acc = first[e];
    for (int k = 0; k < n_rest; ++k) acc ^= rest[k * stride + e];
    out[e] = acc;
    return;
  }
  const int4* r4 = reinterpret_cast<const int4*>(rest) + i;
  const int64_t sv = stride / 4;
  int4 acc = __ldg(reinterpret_cast<const int4*>(first) + i);
  if constexpr (R > 1) {
    int4 x[R - 1];
#pragma unroll
    for (int k = 0; k < R - 1; ++k) x[k] = __ldg(r4 + k * sv);
#pragma unroll
    for (int k = 0; k < R - 1; ++k) xor_into(acc, x[k]);
  } else if constexpr (R == 0) {
    int k = 0;
    for (; k + 4 <= n_rest; k += 4) {          // four loads in flight
      int4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) x[u] = __ldg(r4 + (k + u) * sv);
#pragma unroll
      for (int u = 0; u < 4; ++u) xor_into(acc, x[u]);
    }
    for (; k < n_rest; ++k) xor_into(acc, __ldg(r4 + k * sv));
  }
  __stcs(reinterpret_cast<int4*>(out) + i, acc);
}

template <int R>
int launch_xor(const int32_t* first, const int32_t* rest, int64_t stride,
               int n_rest, int32_t* out, int64_t n, cudaStream_t s) {
  const int64_t n_vec = vector_count(n, stride, 4, 4, first,
                                     n_rest > 0 ? rest : nullptr, out);
  // one thread per body vector and per tail word
  const int64_t items = n_vec + (n - 4 * n_vec);
  const int64_t blocks = (items + kXorThreads - 1) / kXorThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  xor_stream_kernel<R><<<(unsigned)blocks, kXorThreads, 0, s>>>(
      first, rest, stride, n_rest, out, n, n_vec);
  return (int)cudaGetLastError();
}

// The instance for r = n_rest + 1 streams.
int launch_xor_r(const void* first_p, const void* rest_p, int64_t stride,
                 int n_rest, void* out_p, int64_t n, cudaStream_t s) {
  const int32_t* first = static_cast<const int32_t*>(first_p);
  const int32_t* rest = static_cast<const int32_t*>(rest_p);
  int32_t* out = static_cast<int32_t*>(out_p);
  switch (n_rest) {
    case 0: return launch_xor<1>(first, rest, stride, 0, out, n, s);
    case 1: return launch_xor<2>(first, rest, stride, 1, out, n, s);
    case 2: return launch_xor<3>(first, rest, stride, 2, out, n, s);
    case 3: return launch_xor<4>(first, rest, stride, 3, out, n, s);
    default: return launch_xor<0>(first, rest, stride, n_rest, out, n, s);
  }
}

}  // namespace
