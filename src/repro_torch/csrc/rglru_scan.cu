// rglru_scan: RecurrentGemma's RG-LRU diagonal gated linear recurrence.
//
// Replaces the TPU kernel `rglru_scan_pallas` (body `_rglru_kernel`) in
// src/repro/kernels/rglru_scan/kernel.py and computes what `rglru_scan_ref`
// (src/repro_torch/kernels/rglru_scan/ref.py) computes:
//
//   h[b,t,d] = exp(la[b,t,d]) * h[b,t-1,d] + sqrt(-expm1(2 la[b,t,d])) * gx[b,t,d]
//
// with h[b,-1,:] = h0 (zeros when none is given), in float32, rounding each
// product and the sum separately as the reference does (--fmad=false, IEEE
// expf/expm1f/sqrtf, no fast math). Outputs: every state, in gx's dtype, and
// the final state in f32. log_a and gx are f32, bf16 or f16 (one dtype for
// both), contiguous (B, T, D); any T and D.
//
// Bound on an H100 (published peaks, 700 W): bytes. At recurrentgemma-2b's
// prefill, (8, 2048, 2560) f32, it reads 2 x 168 MB and writes 168 MB:
// 0.15 ms at 3.35 TB/s; ~10 operations per element are nothing beside it.
//
// Design. Channels are independent and time is sequential, so one thread
// owns one (b, d) and walks t with h in a register; a warp's 32 threads
// read 32 neighbouring channels of one step (128-byte coalesced loads and
// stores). The loads do not depend on h, so the thread keeps the next
// kUnroll steps' la and gx in flight in registers while it computes the
// current ones (register double buffering). B * D threads (20,480 at the
// prefill shape) are few for 132 SMs, so blocks are small (64 threads) to
// spread them over every SM.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

// grid (ceil(D / kThreads), B): thread (b, d).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const T* __restrict__ la, const T* __restrict__ gx,
                      const float* __restrict__ h0, T* __restrict__ out,
                      float* __restrict__ h_final, int T_len, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const long long base = (long long)b * T_len * D + d;
  const T* lap = la + base;
  const T* gxp = gx + base;
  T* op = out + base;

  float h = h0 == nullptr ? 0.0f : h0[(long long)b * D + d];
  float la_cur[kUnroll], gx_cur[kUnroll], la_nxt[kUnroll], gx_nxt[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const bool ok = u < T_len;
    la_cur[u] = ok ? to_f(lap[(long long)u * D]) : 0.0f;
    gx_cur[u] = ok ? to_f(gxp[(long long)u * D]) : 0.0f;
  }
  for (int t0 = 0; t0 < T_len; t0 += kUnroll) {
    const int t1 = t0 + kUnroll;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // the next block of steps, in flight
      const bool ok = t1 + u < T_len;
      la_nxt[u] = ok ? to_f(lap[(long long)(t1 + u) * D]) : 0.0f;
      gx_nxt[u] = ok ? to_f(gxp[(long long)(t1 + u) * D]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < T_len) {
        const float a = expf(la_cur[u]);
        const float mult = sqrtf(-expm1f(2.0f * la_cur[u]));
        h = a * h + mult * gx_cur[u];
        op[(long long)(t0 + u) * D] = from_f<T>(h);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      la_cur[u] = la_nxt[u];
      gx_cur[u] = gx_nxt[u];
    }
  }
  h_final[(long long)b * D + d] = h;
}

template <typename T>
int launch(const void* la, const void* gx, const float* h0, void* out, float* h_final,
           int B, int T_len, int D, cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)la, (const T*)gx, h0, (T*)out, h_final, T_len, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16, 2 = f16 (log_a, gx and out alike). log_a, gx and
// out are contiguous (B, T, D); h0 (may be null) and h_final are contiguous
// (B, D) f32. Launches on `stream`; returns cudaGetLastError() (0 = launched).
int rglru_scan_launch(const void* la, const void* gx, const void* h0, void* out,
                      void* h_final, int dtype, int B, int T, int D, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* h0f = (const float*)h0;
  float* hf = (float*)h_final;
  switch (dtype) {
    case 0: return launch<float>(la, gx, h0f, out, hf, B, T, D, s);
    case 1: return launch<__nv_bfloat16>(la, gx, h0f, out, hf, B, T, D, s);
    case 2: return launch<__half>(la, gx, h0f, out, hf, B, T, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
