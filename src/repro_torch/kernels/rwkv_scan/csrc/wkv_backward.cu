// Hopper (sm_90a) RWKV6 WKV scan backward, route "step" (the chunk-parallel
// route "chunk" is wkv_backward_chunk.cuh, included below and reached by
// wkv_backward_chunked): dr, dk, dv, dlog_w and du of
// the forward kernels' function (wkv_scan.cu, wkv_chunk.cuh) for a zero
// initial state and an unused final state.  The JAX package has no
// backward Pallas kernel (jax.value_and_grad differentiates its jnp
// chunked recurrence), so this kernel replaces none; it is what makes the
// port's time-mix and Hymba's SSM differentiable on the card (ops.py wraps
// forward and backward in a torch.autograd.Function).
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  The
// entry point launches on the caller's stream, allocates nothing (scratch
// comes from the caller), does not synchronise, and returns
// cudaGetLastError().
//
// The forward, per (batch b, head h), S_0 = 0, w_t = exp(log_w_t):
//   out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t   = diag(w_t) S_{t-1} + k_t v_t^T
// With dS_t the gradient reaching S_t from the steps after t (dS_T = 0),
// vd_t = v_t . dout_t and row k of the Nk x Nv state:
//   dr_t[k]   = dr'_t[k] + u[k] k_t[k] vd_t,  dr'_t[k] = S_{t-1}[k] . dout_t
//   dk_t[k]   = dk'_t[k] + u[k] r_t[k] vd_t,  dk'_t[k] = dS_t[k] . v_t
//   dv_t[n]   = sum_k dS_t[k][n] k_t[k] + dout_t[n] sum_k r_t[k] u[k] k_t[k]
//   dlog_w_t[k] = w_t[k] (dS_t[k] . S_{t-1}[k])
//   du[k]     = sum_b sum_t r_t[k] k_t[k] vd_t
//   dS_{t-1}  = diag(w_t) dS_t + r_t dout_t^T
// Rows of S and of dS evolve independently, and so do their columns; the
// row-wise gradients (dr, dk, dlog_w, du) and the column-wise one (dv) go
// to two kernels that each own the state the way its sums need it:
//   wkv_bwd_rows  one block per (b, h); thread (k, s) owns CPT columns of
//                 row k (the row spread over NS adjacent lanes, summed with
//                 xor shuffles).  A forward sweep carries S, writes dr and
//                 r_t dr'_t (fp32 scratch) and stores S at the end of every
//                 kC-step chunk; a reverse sweep carries dS.  dlog_w needs
//                 S_{t-1} in reverse order: with Q_t[k] = dS_t[k] . S_t[k],
//                   dlog_w_t = Q_t - k_t dk'_t,
//                   Q_{t-1} = dlog_w_t + r_t dr'_t
//                 (both exact identities), and Q is computed afresh from
//                 the stored state at every chunk end, so rounding runs
//                 over at most kC additions.  S_{t-1} is never rebuilt as
//                 exp(-log_w_t) (S_t - k_t v_t^T): log_w is unbounded below
//                 and that division overflows.
//   wkv_bwd_cols  one block per (b, h); thread n owns column n of dS (Nk
//                 registers) and computes dv in a reverse sweep.
//   wkv_bwd_du    du = the per-(b, h) partials summed over b in order.
// Each block stages kC steps of its inputs in shared memory as fp32 (w as
// exp(log_w)); every output element is written by one thread after a
// fixed-order loop: no atomics, and two calls give the same bits.  Like the
// forward's step route the sweeps are sequential in time and bound by the
// card's latency, not by the bytes they move.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "wkv_backward_chunk.cuh"

namespace wkv_bwd {

constexpr int kC = 32;                  // steps a chunk (staging, checkpoints)
constexpr int kRowThreads = 512;        // most threads of a rows block
constexpr int kF32 = 0;                 // dtype codes shared with the wrapper
constexpr int kBF16 = 1;

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Args {
  const void* r; const void* k; const void* v; const float* log_w;
  const float* u; const void* dout;
  void* dr; void* dk; void* dv; float* dlog_w; float* du;
  float* du_part;                       // scratch [B, H, nk]
  float* ckpt;                          // scratch [B, H, chunks, nk, nv]
  float* rdr;                           // scratch [B, H, T, nk]
  int B, T, H, nk, nv;
};

// Stage steps [c0, c0 + L) of r, k, w = exp(log_w) ([kC][nk] each) and of
// v, dout ([kC][nv] each) for (b, h) as fp32.
template <typename T>
__device__ inline void stage_chunk(const Args& a, int b, int h, int c0,
                                   int L, float* rs, float* ks, float* ws,
                                   float* vs, float* ds, int nthreads) {
  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  for (int e = threadIdx.x; e < L * a.nk; e += nthreads) {
    const int t = e / a.nk, kk = e % a.nk;
    const int64_t off = (((int64_t)b * a.T + c0 + t) * a.H + h) * a.nk + kk;
    rs[t * a.nk + kk] = to_f32(r[off]);
    ks[t * a.nk + kk] = to_f32(k[off]);
    ws[t * a.nk + kk] = expf(a.log_w[off]);
  }
  for (int e = threadIdx.x; e < L * a.nv; e += nthreads) {
    const int t = e / a.nv, n = e % a.nv;
    const int64_t off = (((int64_t)b * a.T + c0 + t) * a.H + h) * a.nv + n;
    vs[t * a.nv + n] = to_f32(v[off]);
    ds[t * a.nv + n] = to_f32(dout[off]);
  }
}

template <int NS>
__device__ inline float row_sum(float x) {
#pragma unroll
  for (int o = NS / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// wkv_bwd_rows: dr, dk, dlog_w, du partials (row ownership)
// ---------------------------------------------------------------------------
template <typename T, int CPT, int NS>
__global__ void __launch_bounds__(kRowThreads) wkv_bwd_rows(Args a) {
  extern __shared__ float smem[];
  float* rs = smem;                     // [kC][nk]
  float* ks = rs + kC * a.nk;
  float* ws = ks + kC * a.nk;
  float* vs = ws + kC * a.nk;           // [kC][nv]
  float* ds = vs + kC * a.nv;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int bh = blockIdx.x;
  const int kk_raw = threadIdx.x / NS, s = threadIdx.x % NS;
  const bool live = kk_raw < a.nk;
  const int kk = live ? kk_raw : a.nk - 1;   // idle lanes read a live row
  const float uk = a.u[h * a.nk + kk];
  const int chunks = (a.T + kC - 1) / kC;
  T* dr = static_cast<T*>(a.dr);
  T* dk = static_cast<T*>(a.dk);
  float* ckpt = a.ckpt + (int64_t)bh * chunks * a.nk * a.nv;
  float* rdr = a.rdr + (int64_t)bh * a.T * a.nk;

  // forward sweep: S, dr, r * dr', du, checkpoints
  float S[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) S[c] = 0.f;
  float du_acc = 0.f;
  for (int ci = 0; ci < chunks; ++ci) {
    const int c0 = ci * kC, L = min(kC, a.T - c0);
    stage_chunk<T>(a, b, h, c0, L, rs, ks, ws, vs, ds, blockDim.x);
    __syncthreads();
    for (int t = 0; t < L; ++t) {
      const float rr = rs[t * a.nk + kk], kv = ks[t * a.nk + kk];
      const float ww = ws[t * a.nk + kk];
      float drp = 0.f, vd = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int n = s + NS * c;
        if (n < a.nv) {
          const float dd = ds[t * a.nv + n], vv = vs[t * a.nv + n];
          drp = fmaf(S[c], dd, drp);
          vd = fmaf(vv, dd, vd);
          S[c] = fmaf(ww, S[c], kv * vv);
        }
      }
      drp = row_sum<NS>(drp);
      vd = row_sum<NS>(vd);
      if (live && s == 0) {
        const int64_t off = (((int64_t)b * a.T + c0 + t) * a.H + h) * a.nk
                            + kk;
        store(dr + off, fmaf(uk * kv, vd, drp));
        rdr[(int64_t)(c0 + t) * a.nk + kk] = rr * drp;
        du_acc = fmaf(rr * kv, vd, du_acc);
      }
    }
    if (live) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int n = s + NS * c;
        if (n < a.nv) ckpt[((int64_t)ci * a.nk + kk) * a.nv + n] = S[c];
      }
    }
    __syncthreads();
  }
  if (live && s == 0) a.du_part[(int64_t)bh * a.nk + kk] = du_acc;

  // reverse sweep: dS, dk, dlog_w (Q re-anchored at every chunk end)
  float dS[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) dS[c] = 0.f;
  for (int ci = chunks - 1; ci >= 0; --ci) {
    const int c0 = ci * kC, L = min(kC, a.T - c0);
    stage_chunk<T>(a, b, h, c0, L, rs, ks, ws, vs, ds, blockDim.x);
    float q = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int n = s + NS * c;
      if (n < a.nv) q = fmaf(dS[c], ckpt[((int64_t)ci * a.nk + kk) * a.nv
                                          + n], q);
    }
    q = row_sum<NS>(q);
    __syncthreads();
    for (int t = L - 1; t >= 0; --t) {
      const float rr = rs[t * a.nk + kk], kv = ks[t * a.nk + kk];
      const float ww = ws[t * a.nk + kk];
      float dkp = 0.f, vd = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int n = s + NS * c;
        if (n < a.nv) {
          const float dd = ds[t * a.nv + n], vv = vs[t * a.nv + n];
          dkp = fmaf(dS[c], vv, dkp);
          vd = fmaf(vv, dd, vd);
          dS[c] = fmaf(ww, dS[c], rr * dd);
        }
      }
      dkp = row_sum<NS>(dkp);
      vd = row_sum<NS>(vd);
      const float dlw = q - kv * dkp;
      const int64_t off = (((int64_t)b * a.T + c0 + t) * a.H + h) * a.nk + kk;
      if (live && s == 0) {
        a.dlog_w[off] = dlw;
        store(dk + off, fmaf(uk * rr, vd, dkp));
      }
      q = dlw + rdr[(int64_t)(c0 + t) * a.nk + kk];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// wkv_bwd_cols: dv (column ownership)
// ---------------------------------------------------------------------------
template <typename T, int NKP>
__global__ void __launch_bounds__(256) wkv_bwd_cols(Args a) {
  extern __shared__ float smem[];
  __shared__ float u_s[NKP];
  float* rs = smem;                     // [kC][nk]
  float* ks = rs + kC * a.nk;
  float* ws = ks + kC * a.nk;
  float* vs = ws + kC * a.nk;           // [kC][nv]
  float* ds = vs + kC * a.nv;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int n = threadIdx.x;
  const bool live = n < a.nv;
  const int nn = live ? n : a.nv - 1;
  const int chunks = (a.T + kC - 1) / kC;
  T* dv = static_cast<T*>(a.dv);
  for (int kk = threadIdx.x; kk < NKP; kk += blockDim.x)
    u_s[kk] = kk < a.nk ? a.u[h * a.nk + kk] : 0.f;
  float dS[NKP];
#pragma unroll
  for (int kk = 0; kk < NKP; ++kk) dS[kk] = 0.f;
  for (int ci = chunks - 1; ci >= 0; --ci) {
    const int c0 = ci * kC, L = min(kC, a.T - c0);
    stage_chunk<T>(a, b, h, c0, L, rs, ks, ws, vs, ds, blockDim.x);
    __syncthreads();
    for (int t = L - 1; t >= 0; --t) {
      const float dd = ds[t * a.nv + nn];
      float acc = 0.f, ruk = 0.f;
#pragma unroll
      for (int kk = 0; kk < NKP; ++kk) {
        if (kk < a.nk) {
          const float rr = rs[t * a.nk + kk], kv = ks[t * a.nk + kk];
          acc = fmaf(dS[kk], kv, acc);
          ruk = fmaf(rr * u_s[kk], kv, ruk);
          dS[kk] = fmaf(ws[t * a.nk + kk], dS[kk], rr * dd);
        }
      }
      if (live)
        store(dv + (((int64_t)b * a.T + c0 + t) * a.H + h) * a.nv + n,
              fmaf(dd, ruk, acc));
    }
    __syncthreads();
  }
}

// du[h][k] = sum over b, in order, of the rows kernel's partials
__global__ void wkv_bwd_du(Args a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.H * a.nk) return;
  float s = 0.f;
  for (int b = 0; b < a.B; ++b) s += a.du_part[(int64_t)b * a.H * a.nk + e];
  a.du[e] = s;
}

inline size_t smem_bytes(const Args& a) {
  return sizeof(float) * kC * (3 * a.nk + 2 * a.nv);
}

template <typename T, int CPT, int NS>
int launch_rows(const Args& a, cudaStream_t s) {
  const size_t bytes = smem_bytes(a);
  cudaFuncSetAttribute(wkv_bwd_rows<T, CPT, NS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  const int threads = ((a.nk * NS + 31) / 32) * 32;
  wkv_bwd_rows<T, CPT, NS><<<a.B * a.H, threads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int NKP>
int launch_cols(const Args& a, cudaStream_t s) {
  const size_t bytes = smem_bytes(a);
  cudaFuncSetAttribute(wkv_bwd_cols<T, NKP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  const int threads = ((a.nv + 31) / 32) * 32;
  wkv_bwd_cols<T, NKP><<<a.B * a.H, threads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, cudaStream_t s) {
  // rows kernel: NS lanes a row, CPT columns a lane, nk * NS <= 512 threads
  int rc;
  if (a.nv <= 16) rc = launch_rows<T, 16, 1>(a, s);
  else if (a.nv <= 32) rc = launch_rows<T, 16, 2>(a, s);
  else if (a.nv <= 64) rc = launch_rows<T, 16, 4>(a, s);
  else if (a.nv <= 128 && a.nk <= 64) rc = launch_rows<T, 16, 8>(a, s);
  else if (a.nv <= 128) rc = launch_rows<T, 32, 4>(a, s);
  else if (a.nk <= 64) rc = launch_rows<T, 32, 8>(a, s);
  else rc = launch_rows<T, 64, 4>(a, s);
  if (rc) return rc;
  if (a.nk <= 16) rc = launch_cols<T, 16>(a, s);
  else if (a.nk <= 32) rc = launch_cols<T, 32>(a, s);
  else if (a.nk <= 64) rc = launch_cols<T, 64>(a, s);
  else rc = launch_cols<T, 128>(a, s);
  if (rc) return rc;
  wkv_bwd_du<<<(a.H * a.nk + 255) / 256, 256, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace wkv_bwd

extern "C" {

// sizeof(Args), so the wrapper can check its ctypes mirror
int wkv_backward_args_size() { return (int)sizeof(wkv_bwd::Args); }

// Checkpoint chunk length: the wrapper sizes ckpt as [B, H, ceil(T / kC),
// nk, nv].
int wkv_backward_chunk() { return wkv_bwd::kC; }

// Returns a cudaError_t (0 = launched).  dtype: r, k, v, dout, dr, dk, dv
// (0 = fp32, 1 = bf16); log_w, u, dlog_w and du are fp32.  1 <= nk <= 128,
// 1 <= nv <= 256.
int wkv_backward(int dtype, const void* args, void* stream) {
  const wkv_bwd::Args& a = *static_cast<const wkv_bwd::Args*>(args);
  if (a.nk < 1 || a.nk > 128 || a.nv < 1 || a.nv > 256)
    return (int)cudaErrorInvalidValue;
  if (a.B == 0 || a.H == 0 || a.T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == wkv_bwd::kF32) return wkv_bwd::dispatch<float>(a, s);
  if (dtype == wkv_bwd::kBF16)
    return wkv_bwd::dispatch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

// sizeof(wkvbc::Args), so the wrapper can check its ctypes mirror
int wkv_backward_chunked_args_size() { return (int)sizeof(wkvbc::Args); }

// The chunk route's chunk and block lengths (the wrapper sizes its scratch
// by the first and routes shorter sequences to "step").
int wkv_backward_chunked_len() { return wkvbc::kC; }
int wkv_backward_chunked_block() { return wkvbc::kL; }

// The chunk route: returns a cudaError_t (0 = launched).  dtype as
// wkv_backward's; 1 <= nk <= 64, 1 <= nv <= 64, T >= 1.
int wkv_backward_chunked(int dtype, const void* args, void* stream) {
  const wkvbc::Args& a = *static_cast<const wkvbc::Args*>(args);
  if (a.nk < 1 || a.nk > 64 || a.nv < 1 || a.nv > wkvbc::kNV)
    return (int)cudaErrorInvalidValue;
  if (a.B == 0 || a.H == 0 || a.T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == wkv_bwd::kF32) return wkvbc::dispatch<float>(a, s);
  if (dtype == wkv_bwd::kBF16) return wkvbc::dispatch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
