// Hopper (sm_90a) RWKV6 WKV scan.  Replaces _wkv_kernel / wkv_scan_pallas
// of src/repro/kernels/rwkv_scan/kernel.py (the Pallas TPU kernel).
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  The
// entry point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().
//
// What it computes, per (batch b, head h), with S a [Nk, Nv] fp32 state:
//   out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t   = diag(exp(log_w_t)) S_{t-1} + k_t v_t^T
// and the final state S_T.  r, k, log_w [B, T, h, Nk] and v [B, T, h, Nv]
// are read in place (contiguous, no transpose, no padding); log_w may be
// fp32 while r, k, v are bf16 (the model computes the decay in fp32);
// u [h, Nk], s0 and sT [B, h, Nk, Nv] are fp32; out [B, T, h, Nv] has r's
// dtype.
//
// Three routes (ops.route picks one by dtype and shape).  "tensor_core",
// for bf16 r, k, v at Nk = Nv = 64 and T >= 16, is the chunked form on
// the tensor cores in wkv_chunk.cuh (wkv_forward_tc below).  "chunk_f32",
// for fp32 r, k, v at Nk <= 32, Nv <= 64 and T >= 16, is the
// chunk-parallel fp32 form in wkv_chunk_f32.cuh (wkv_forward_chunk_f32
// below), which also computes the recurrence's inclusive mode (Hymba's
// SSM).  "step", for everything else (decode's T = 1, bf16 off the tensor
// core shapes, wider heads), is wkv_fwd here: the step form of
// linrec.recurrent_step.  One block per
// (b, h); thread j owns state column S[:, j] in registers (NK fp32
// values).  Time runs in a loop inside the block: r_t, k_t, exp(log_w_t)
// and v_t of kTS steps at a time are staged in shared memory, each thread
// issuing all its loads of a pass before its first store (rows past Nk
// padded with r = k = 0 and w = 1, so the padded state rows stay 0); then
// each thread walks the kTS steps with float4 broadcast reads.  Each
// input element is read once, so at the model's sizes the step kernel is
// bound by the card's latency and its B * h blocks of Nv threads, far from
// the HBM bound of the bytes it moves.  fp32 throughout; results differ
// from the chunked form only in rounding.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "wkv_chunk.cuh"
#include "wkv_chunk_f32.cuh"

namespace {

constexpr int kMaxNv = 256;             // threads (state columns) a block
constexpr int kTS = 16;                 // time steps staged per pass

constexpr int kF32 = 0;                 // dtype codes shared with ops.py
constexpr int kBF16 = 1;

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, typename TW, int NK>
__global__ void __launch_bounds__(kMaxNv)
wkv_fwd(const T* __restrict__ r, const T* __restrict__ k,
        const T* __restrict__ v, const TW* __restrict__ lw,
        const float* __restrict__ u, const float* __restrict__ s0,
        T* __restrict__ out, float* __restrict__ sT, int T_len, int H,
        int nk, int nv) {
  __shared__ __align__(16) float rs[kTS][NK];
  __shared__ __align__(16) float ks[kTS][NK];
  __shared__ __align__(16) float ws[kTS][NK];
  __shared__ __align__(16) float us[NK];
  __shared__ float vs[kTS][kMaxNv];

  const int bh = blockIdx.x;            // b * H + h
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;            // the state column this thread owns
  const bool col = j < nv;
  const int64_t rows0 = int64_t(b) * T_len * H + h;   // (b, t = 0, h)

  for (int e = j; e < NK; e += blockDim.x)
    us[e] = e < nk ? u[h * nk + e] : 0.f;
  float st[NK];
#pragma unroll
  for (int i = 0; i < NK; ++i)
    st[i] = (col && i < nk && s0) ? s0[(int64_t(bh) * nk + i) * nv + j]
                                  : 0.f;

  for (int t0 = 0; t0 < T_len; t0 += kTS) {
    const int n = min(kTS, T_len - t0);
    __syncthreads();                    // previous pass done with the tiles
    // every load of the pass is issued before the first store
    for (int i = j; i < NK; i += blockDim.x) {
      float rx[kTS], kx[kTS], wx[kTS];
#pragma unroll
      for (int tt = 0; tt < kTS; ++tt) {
        const bool in = tt < n && i < nk;
        const int64_t off = (rows0 + int64_t(t0 + tt) * H) * nk + i;
        rx[tt] = in ? to_f32(r[off]) : 0.f;
        kx[tt] = in ? to_f32(k[off]) : 0.f;
        wx[tt] = in ? to_f32(lw[off]) : 0.f;
      }
#pragma unroll
      for (int tt = 0; tt < kTS; ++tt) {
        rs[tt][i] = rx[tt];
        ks[tt][i] = kx[tt];
        ws[tt][i] = expf(wx[tt]);       // w = 1 on padding: S unchanged
      }
    }
    if (col) {
      float vx[kTS];
#pragma unroll
      for (int tt = 0; tt < kTS; ++tt)
        vx[tt] = tt < n ? to_f32(v[(rows0 + int64_t(t0 + tt) * H) * nv + j])
                        : 0.f;
#pragma unroll
      for (int tt = 0; tt < kTS; ++tt) vs[tt][j] = vx[tt];
    }
    __syncthreads();
    if (!col) continue;
    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt][j];
      float o[4] = {0.f, 0.f, 0.f, 0.f};  // four partial sums of r . read
#pragma unroll
      for (int i4 = 0; i4 < NK / 4; ++i4) {
        const float4 r4 = reinterpret_cast<const float4*>(rs[tt])[i4];
        const float4 k4 = reinterpret_cast<const float4*>(ks[tt])[i4];
        const float4 w4 = reinterpret_cast<const float4*>(ws[tt])[i4];
        const float4 u4 = reinterpret_cast<const float4*>(us)[i4];
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 4 * i4 + c;
          const float kv = kk[c] * vj;
          o[c] += rr[c] * (st[i] + uu[c] * kv);  // read S_{t-1} + u k v^T
          st[i] = st[i] * ww[c] + kv;           // S_t = w S_{t-1} + k v^T
        }
      }
      const int64_t row = rows0 + int64_t(t0 + tt) * H;
      store(out + row * nv + j, (o[0] + o[1]) + (o[2] + o[3]));
    }
  }
  if (col) {
#pragma unroll
    for (int i = 0; i < NK; ++i)
      if (i < nk) sT[(int64_t(bh) * nk + i) * nv + j] = st[i];
  }
}

template <typename T, typename TW, int NK>
void launch(const void* r, const void* k, const void* v, const void* lw,
            const float* u, const float* s0, void* out, float* sT, int B,
            int T_len, int H, int nk, int nv, cudaStream_t stream) {
  wkv_fwd<T, TW, NK><<<B * H, (nv + 31) / 32 * 32, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TW*>(lw), u, s0,
      static_cast<T*>(out), sT, T_len, H, nk, nv);
}

template <typename T, typename TW>
int dispatch(const void* r, const void* k, const void* v, const void* lw,
             const float* u, const float* s0, void* out, float* sT, int B,
             int T_len, int H, int nk, int nv, cudaStream_t stream) {
  if (nk <= 16)
    launch<T, TW, 16>(r, k, v, lw, u, s0, out, sT, B, T_len, H, nk, nv,
                      stream);
  else if (nk <= 32)
    launch<T, TW, 32>(r, k, v, lw, u, s0, out, sT, B, T_len, H, nk, nv,
                      stream);
  else if (nk <= 64)
    launch<T, TW, 64>(r, k, v, lw, u, s0, out, sT, B, T_len, H, nk, nv,
                      stream);
  else
    launch<T, TW, 128>(r, k, v, lw, u, s0, out, sT, B, T_len, H, nk, nv,
                       stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).  dtype: r, k, v and out (0 = fp32,
// 1 = bf16); w_dtype: log_w (0 = fp32, or equal to dtype).  nk <= 128,
// nv <= 256; s0 may be null (zero initial state).
int wkv_forward(int dtype, int w_dtype, const void* r, const void* k,
                const void* v, const void* log_w, const float* u,
                const float* s0, void* out, float* sT, int B, int T_len,
                int H, int nk, int nv, void* stream) {
  if (nk < 1 || nk > 128 || nv < 1 || nv > kMaxNv)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && w_dtype == kF32)
    return dispatch<float, float>(r, k, v, log_w, u, s0, out, sT, B, T_len,
                                  H, nk, nv, s);
  if (dtype == kBF16 && w_dtype == kF32)
    return dispatch<__nv_bfloat16, float>(r, k, v, log_w, u, s0, out, sT, B,
                                          T_len, H, nk, nv, s);
  if (dtype == kBF16 && w_dtype == kBF16)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(r, k, v, log_w, u, s0, out,
                                                  sT, B, T_len, H, nk, nv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The "tensor_core" route: bf16 r, k, v and out; w_dtype 0 (fp32 log_w) or
// 1 (bf16).  Takes nk = nv = 64 and T_len >= 16 only, and 16-byte aligned
// r, k, v, log_w; anything else returns cudaErrorInvalidValue unlaunched.
int wkv_forward_tc(int w_dtype, const void* r, const void* k, const void* v,
                   const void* log_w, const float* u, const float* s0,
                   void* out, float* sT, int B, int T_len, int H, int nk,
                   int nv, void* stream) {
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (nk != wkvtc::kN || nv != wkvtc::kN || T_len < wkvtc::kMinT
      || misaligned(r) || misaligned(k) || misaligned(v)
      || misaligned(log_w) || (w_dtype != kF32 && w_dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype == kF32)
    return wkvtc::launch<float>(r, k, v, log_w, u, s0, out, sT, B, T_len, H,
                                s);
  return wkvtc::launch<__nv_bfloat16>(r, k, v, log_w, u, s0, out, sT, B,
                                      T_len, H, s);
}

// The "chunk_f32" route: `args` points at a wkvf32::Args; inclusive 1
// computes out_t = q_t^T S_t, 0 the rwkv form with u (null: no bonus).
// Takes 1 <= nk <= 64, 1 <= nv <= 64 and at most 65,535 chunks (a grid
// dimension), and 16-byte copies only where
// args->vec says every base and stride allows them; anything else returns
// cudaErrorInvalidValue unlaunched.  Launches three kernels on `stream`.
int wkv_forward_chunk_f32(int inclusive, const void* args, void* stream) {
  const wkvf32::Args& a = *static_cast<const wkvf32::Args*>(args);
  if (a.nk < 1 || a.nk > 64 || a.nv < 1 || a.nv > wkvf32::kCols
      || a.T < 1 || (a.T - 1) / wkvf32::kC >= 65535 || (inclusive && a.u))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B == 0 || a.H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.nk <= 16)
    return inclusive ? wkvf32::launch<16, true>(a, s)
                     : wkvf32::launch<16, false>(a, s);
  if (a.nk <= 32)
    return inclusive ? wkvf32::launch<32, true>(a, s)
                     : wkvf32::launch<32, false>(a, s);
  return inclusive ? wkvf32::launch<64, true>(a, s)
                   : wkvf32::launch<64, false>(a, s);
}

int wkv_chunk_f32_args_size() {
  return static_cast<int>(sizeof(wkvf32::Args));
}

// steps a chunk (the wrapper sizes the scratch by it)
int wkv_chunk_f32_chunk() { return wkvf32::kC; }

// out[0..3] = shared memory bytes and blocks an SM of (a) chunk_state and
// (c) chunk_out at Nk = nk's instance (-1: a CUDA error)
void wkv_chunk_f32_occupancy(int nk, int* out) {
  if (nk <= 16)
    wkvf32::occupancy<16>(out);
  else if (nk <= 32)
    wkvf32::occupancy<32>(out);
  else
    wkvf32::occupancy<64>(out);
}

// Shared memory a block of the tensor-core route takes (bytes), and how
// many of its blocks fit on one SM (-1 on a CUDA error).
int wkv_tc_smem_bytes() { return static_cast<int>(sizeof(wkvtc::Smem)); }

int wkv_tc_blocks_per_sm(int w_dtype) {
  return w_dtype == kF32 ? wkvtc::blocks_per_sm<float>()
                         : wkvtc::blocks_per_sm<__nv_bfloat16>();
}

}  // extern "C"
