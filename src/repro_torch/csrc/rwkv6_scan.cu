// rwkv6_scan: the RWKV-6 (Finch) data-dependent-decay linear recurrence.
//
// Replaces the TPU kernel `rwkv6_scan_pallas` (body `_rwkv6_kernel`) in
// src/repro/kernels/rwkv6_scan/kernel.py and computes what `rwkv6_scan_ref`
// (src/repro_torch/kernels/rwkv6_scan/ref.py) computes, per (b, h) with an
// N x N state S (key index i, value index j):
//
//   o[t,j] = sum_i r[t,i] * (S[i,j] + u[i] * k[t,i] v[t,j])
//   S[i,j] <- w[t,i] * S[i,j] + k[t,i] v[t,j]
//
// in float32, each product and sum rounded separately as the reference
// rounds them (--fmad=false); the sum over i runs in order. r, k, v are f32,
// bf16 or f16 (one dtype), w, u and the states f32; the output has r's
// dtype. Any T, 1 included (decode); N in {16, 32, 64}.
//
// Bound on an H100 (published peaks, 700 W). At rwkv6-7b's prefill, r, k,
// v, w (8, 64, 1024, 64) f32: 0.67 GB of inputs and outputs (0.20 ms at
// 3.35 TB/s) against 7 N^2 operations per token and head, 15 GFLOP (0.22 ms
// at 67 TFLOP/s): operations, barely. At T = 1 it is the 8.4 MB state read
// and written: bytes, ~5 us. The time dependence keeps it above both.
//
// Design. One CTA of N threads per (b, h); thread j holds column j of S
// (N floats) in registers for the whole sequence, so the state never
// leaves the SM and s0 and s_final may be one tensor (each thread reads its
// own column before it writes it: decode updates the cache in place). Time
// runs in chunks of kChunk steps: the chunk's r, k, w, v rows sit in shared
// memory (double-buffered), where every thread reads r, k, w, u of all i by
// broadcast float4 loads. While a chunk is computed, the next chunk's rows
// are already loaded into registers (coalesced: thread j loads element j of
// each row), and go to shared memory after it: one barrier per chunk.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;

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

struct Strides {  // element strides (batch, head, time) of r, k, v, w
  long long b[4], h[4], t[4];
};

// grid (H, B), N threads: thread j owns S[:, j].
template <typename T, int N>
__global__ void __launch_bounds__(N)
    rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, const float* s0, T* __restrict__ out,
                      float* s_final, int H, int T_len, Strides st) {
  __shared__ __align__(16) float sR[2][kChunk][N];
  __shared__ __align__(16) float sK[2][kChunk][N];
  __shared__ __align__(16) float sW[2][kChunk][N];
  __shared__ __align__(16) float sV[2][kChunk][N];
  __shared__ __align__(16) float sU[N];

  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const T* rp = r + b * st.b[0] + h * st.h[0] + j;
  const T* kp = k + b * st.b[1] + h * st.h[1] + j;
  const T* vp = v + b * st.b[2] + h * st.h[2] + j;
  const float* wp = w + b * st.b[3] + h * st.h[3] + j;
  const long long bh = (long long)b * H + h;
  T* op = out + bh * T_len * N + j;

  sU[j] = u[h * N + j];
  float S[N];
  const long long s_off = bh * N * N + j;
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = s0 == nullptr ? 0.0f : s0[s_off + (long long)i * N];

  // A chunk's rows are loaded into registers (FETCH), then stored to shared
  // memory buffer `buf` (STAGE).
  float pr[kChunk], pk[kChunk], pv[kChunk], pw[kChunk];
#define RWKV6_FETCH(t0)                                   \
  _Pragma("unroll") for (int c = 0; c < kChunk; ++c) {    \
    const long long t = (t0) + c;                         \
    const bool ok = t < T_len;                            \
    pr[c] = ok ? to_f(rp[t * st.t[0]]) : 0.0f;            \
    pk[c] = ok ? to_f(kp[t * st.t[1]]) : 0.0f;            \
    pv[c] = ok ? to_f(vp[t * st.t[2]]) : 0.0f;            \
    pw[c] = ok ? wp[t * st.t[3]] : 0.0f;                  \
  }
#define RWKV6_STAGE(buf)                                  \
  _Pragma("unroll") for (int c = 0; c < kChunk; ++c) {    \
    sR[buf][c][j] = pr[c];                                \
    sK[buf][c][j] = pk[c];                                \
    sV[buf][c][j] = pv[c];                                \
    sW[buf][c][j] = pw[c];                                \
  }

  RWKV6_FETCH(0)
  RWKV6_STAGE(0)
  __syncthreads();
  const int n_chunks = (T_len + kChunk - 1) / kChunk;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int buf = ci & 1;
    const int t0 = ci * kChunk;
    if (ci + 1 < n_chunks) {  // in flight during the chunk
      RWKV6_FETCH(t0 + kChunk)
    }
    const int n = min(kChunk, T_len - t0);
    for (int c = 0; c < n; ++c) {
      const float vj = sV[buf][c][j];
      const float4* r4 = reinterpret_cast<const float4*>(sR[buf][c]);
      const float4* k4 = reinterpret_cast<const float4*>(sK[buf][c]);
      const float4* w4 = reinterpret_cast<const float4*>(sW[buf][c]);
      const float4* u4 = reinterpret_cast<const float4*>(sU);
      float o = 0.0f;
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 rr = r4[q], kk = k4[q], ww = w4[q], uu = u4[q];
        const float ri[4] = {rr.x, rr.y, rr.z, rr.w};
        const float ki[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wi[4] = {ww.x, ww.y, ww.z, ww.w};
        const float ui[4] = {uu.x, uu.y, uu.z, uu.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          const float kv = ki[e] * vj;
          o = o + (S[i] + ui[e] * kv) * ri[e];
          S[i] = wi[e] * S[i] + kv;
        }
      }
      op[(long long)(t0 + c) * N] = from_f<T>(o);
    }
    if (ci + 1 < n_chunks) {  // that buffer was last read before the previous barrier
      RWKV6_STAGE(buf ^ 1)
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < N; ++i) s_final[s_off + (long long)i * N] = S[i];
#undef RWKV6_FETCH
#undef RWKV6_STAGE
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           const float* s0, void* out, float* s_final, int B, int H, int T_len,
           const Strides& st, cudaStream_t stream) {
  rwkv6_scan_kernel<T, N><<<dim3(H, B), N, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, w, u, s0, (T*)out, s_final, H, T_len, st);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(const void* r, const void* k, const void* v, const float* w, const float* u,
             const float* s0, void* out, float* s_final, int B, int H, int T_len, int N,
             const Strides& st, cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, 16>(r, k, v, w, u, s0, out, s_final, B, H, T_len, st, s);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, out, s_final, B, H, T_len, st, s);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, out, s_final, B, H, T_len, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16, 2 = f16 (r, k, v and out alike). r, k, v, w are
// (B, H, T, N) with element strides (batch, head, time) given in that
// order for each, 12 in all, and a contiguous last dimension; w, u (H, N),
// s0 (may be null) and s_final (B, H, N, N) are f32, u and the states
// contiguous; s0 may equal s_final. out is contiguous (B, H, T, N).
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
int rwkv6_scan_launch(const void* r, const void* k, const void* v, const void* w,
                      const void* u, const void* s0, void* out, void* s_final, int dtype,
                      int B, int H, int T, int N, const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  Strides st;
  for (int a = 0; a < 4; ++a) {
    st.b[a] = strides[3 * a];
    st.h[a] = strides[3 * a + 1];
    st.t[a] = strides[3 * a + 2];
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* wf = (const float*)w;
  const float* uf = (const float*)u;
  const float* s0f = (const float*)s0;
  float* sf = (float*)s_final;
  switch (dtype) {
    case 0: return launch_n<float>(r, k, v, wf, uf, s0f, out, sf, B, H, T, N, st, s);
    case 1: return launch_n<__nv_bfloat16>(r, k, v, wf, uf, s0f, out, sf, B, H, T, N, st, s);
    case 2: return launch_n<__half>(r, k, v, wf, uf, s0f, out, sf, B, H, T, N, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* rwkv6_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
