// decode_attention: one new query token per sequence against a KV cache.
//
// Replaces the TPU kernel `decode_attention_pallas` (body `_decode_kernel`)
// in src/repro/kernels/decode_attention/kernel.py and computes what
// `decode_attention_ref` (src/repro_torch/kernels/decode_attention/ref.py)
// computes:
//
//   O[b,h,:] = softmax_{j < lengths[b]}(scale * q[b,h,:] . K[b,h/G,j,:])
//              @ V[b,h/G,:,:]
//
// with G = H / KVH, float32 logits, softmax and accumulation, and the output
// in q's dtype. q and the cache may differ in type: serving gives a float32
// query against a bf16 cache.
//
// Bound on an H100 (published peaks, 700 W): memory. Every valid cache
// position is read once: at the qwen3-0.6b serving shape (8 sequences, 8 KV
// heads, head_dim 128, bf16, mean valid length 1,056) that is 34.6 MB of K
// and V, 10.3 us at 3.35 TB/s; the 2*G*D FLOP per position are nothing.
//
// Design: flash-decoding. B * KVH = 64 sequences of heads would fill half
// of the 132 SMs, so the sequence axis splits into 64-position chunks, one
// CTA of 128 threads per (b, kv head, chunk). The CTA serves all G query
// heads of its group, so each cache byte is read once:
//   1. it copies its chunk's valid positions of K and V into shared memory
//      as f32 (8- or 16-byte vector loads, coalesced; positions at or
//      beyond lengths[b] are never loaded, and a chunk that starts beyond
//      the length returns before any load);
//   2. each warp takes positions in turn and forms the G logits of each
//      with its lanes splitting D and a shuffle reduction;
//   3. one warp per head takes the chunk's max and exp-sum;
//   4. threads over (head, column) pairs form the unnormalised P @ V,
//   and the partial (max, sum, acc) of every (b, h, chunk) goes to a
//   workspace. A second kernel, one CTA per (b, h), combines the valid
//   chunks' partials (rescaled to the common max) and divides.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

// Four consecutive cache elements as f32 (one 16-byte load for f32, one
// 8-byte load for 16-bit types).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __half2 a = *reinterpret_cast<const __half2*>(&raw.x);
  const __half2 b = *reinterpret_cast<const __half2*>(&raw.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}

// grid (n_chunks, KVH, B). Partials: m, l (B, H, n_chunks); acc (.., D).
template <typename QT, typename CT>
__global__ void __launch_bounds__(kThreads)
    decode_partial_kernel(const QT* __restrict__ q, const CT* __restrict__ kc,
                          const CT* __restrict__ vc, const int* __restrict__ lengths,
                          float* __restrict__ part_m, float* __restrict__ part_l,
                          float* __restrict__ part_acc, int H, int KVH, int S, int D,
                          long long qsB, long long qsH, float scale) {
  const int chunk = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int len = min(lengths[b], S);
  const int p0 = chunk * kChunk;
  if (p0 >= len) return;  // wholly beyond the valid length: no loads
  const int n = min(kChunk, len - p0);
  const int G = H / KVH;

  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);  // kChunk x D
  float* sV = sK + kChunk * D;                  // kChunk x D
  float* sQ = sV + kChunk * D;                  // G x D
  float* sS = sQ + G * D;                       // G x kChunk

  const long long base = (((long long)b * KVH + kvh) * S + p0) * D;
  const CT* kp = kc + base;
  const CT* vp = vc + base;
  for (int e = threadIdx.x * 4; e < n * D; e += kThreads * 4) {
    *reinterpret_cast<float4*>(&sK[e]) = load4(kp + e);
    *reinterpret_cast<float4*>(&sV[e]) = load4(vp + e);
  }
  for (int e = threadIdx.x; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    sQ[e] = to_f(q[b * qsB + (long long)(kvh * G + g) * qsH + d]);
  }
  __syncthreads();

  // 2. logits: warp per position, lanes over D.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p = warp; p < n; p += kWarps) {
    const float* krow = sK + p * D;
    for (int g = 0; g < G; ++g) {
      const float* qrow = sQ + g * D;
      float t = 0.0f;
      for (int d = lane; d < D; d += 32) t = fmaf(qrow[d], krow[d], t);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
      if (lane == 0) sS[g * kChunk + p] = t * scale;
    }
  }
  __syncthreads();

  // 3. chunk max and exp-sum, warp per head.
  for (int g = warp; g < G; g += kWarps) {
    float* srow = sS + g * kChunk;
    float mx = -INFINITY;
    for (int p = lane; p < n; p += 32) mx = fmaxf(mx, srow[p]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.0f;
    for (int p = lane; p < n; p += 32) {
      const float e = expf(srow[p] - mx);
      srow[p] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      const long long w = ((long long)b * H + kvh * G + g) * n_chunks + chunk;
      part_m[w] = mx;
      part_l[w] = sum;
    }
  }
  __syncthreads();

  // 4. unnormalised P @ V over the chunk.
  for (int e = threadIdx.x; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    const float* srow = sS + g * kChunk;
    float a = 0.0f;
    for (int p = 0; p < n; ++p) a = fmaf(srow[p], sV[p * D + d], a);
    const long long w = ((long long)b * H + kvh * G + g) * n_chunks + chunk;
    part_acc[w * D + d] = a;
  }
}

// grid (H, B): combine the valid chunks of one (b, h).
template <typename QT>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const float* __restrict__ part_m,
                          const float* __restrict__ part_l,
                          const float* __restrict__ part_acc,
                          const int* __restrict__ lengths, QT* __restrict__ out, int H,
                          int D, int n_chunks) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int nv = (min(lengths[b], n_chunks * kChunk) + kChunk - 1) / kChunk;
  const long long w0 = ((long long)b * H + h) * n_chunks;
  float mx = -INFINITY;
  for (int c = 0; c < nv; ++c) mx = fmaxf(mx, part_m[w0 + c]);
  float L = 0.0f;
  for (int c = 0; c < nv; ++c) L += part_l[w0 + c] * expf(part_m[w0 + c] - mx);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float a = 0.0f;
    for (int c = 0; c < nv; ++c)
      a += part_acc[(w0 + c) * D + d] * expf(part_m[w0 + c] - mx);
    out[((long long)b * H + h) * D + d] = from_f<QT>(a / L);
  }
}

template <typename QT, typename CT>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
           float* ws, int B, int H, int KVH, int S, int D, long long qsB, long long qsH,
           float scale, cudaStream_t stream) {
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const int G = H / KVH;
  const size_t smem = sizeof(float) * ((size_t)2 * kChunk * D + (size_t)G * D + G * kChunk);
  static size_t configured = 48 * 1024;
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(decode_partial_kernel<QT, CT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  const size_t P = (size_t)B * H * n_chunks;
  float* part_m = ws;
  float* part_l = ws + P;
  float* part_acc = ws + 2 * P;
  decode_partial_kernel<QT, CT><<<dim3(n_chunks, KVH, B), kThreads, smem, stream>>>(
      (const QT*)q, (const CT*)k, (const CT*)v, lengths, part_m, part_l, part_acc, H, KVH,
      S, D, qsB, qsH, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<QT><<<dim3(H, B), kThreads, 0, stream>>>(
      part_m, part_l, part_acc, lengths, (QT*)out, H, D, n_chunks);
  return (int)cudaGetLastError();
}

template <typename QT>
int launch_c(int cache_dtype, const void* q, const void* k, const void* v,
             const int* lengths, void* out, float* ws, int B, int H, int KVH, int S, int D,
             long long qsB, long long qsH, float scale, cudaStream_t s) {
  switch (cache_dtype) {
    case 0:
      return launch<QT, float>(q, k, v, lengths, out, ws, B, H, KVH, S, D, qsB, qsH, scale, s);
    case 1:
      return launch<QT, __nv_bfloat16>(q, k, v, lengths, out, ws, B, H, KVH, S, D, qsB, qsH,
                                       scale, s);
    case 2:
      return launch<QT, __half>(q, k, v, lengths, out, ws, B, H, KVH, S, D, qsB, qsH, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Workspace floats needed for (B, H, S, D): partial max, sum and acc.
long long decode_attention_workspace(int B, int H, int S, int D) {
  const long long n_chunks = (S + kChunk - 1) / kChunk;
  return (long long)B * H * n_chunks * (2 + D);
}

// dtypes: 0 = f32, 1 = bf16, 2 = f16. q is (B, H, D) with element strides
// (qsB, qsH) and a contiguous last dimension; the caches are contiguous
// (B, KVH, S, D) and 16-byte aligned (8-byte for 16-bit types), D % 4 == 0;
// lengths is (B,) int32; out is contiguous (B, H, D) in q's dtype.
// Launches both kernels on `stream`; returns cudaGetLastError() (0 = launched).
int decode_attention_launch(const void* q, const void* k, const void* v, const void* lengths,
                            void* out, void* workspace, int q_dtype, int cache_dtype, int B,
                            int H, int KVH, int S, int D, long long qsB, long long qsH,
                            float scale, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || S <= 0 || D <= 0 || D % 4 != 0 ||
      B > 65535 || H > 65535 || KVH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* len = (const int*)lengths;
  float* ws = (float*)workspace;
  switch (q_dtype) {
    case 0:
      return launch_c<float>(cache_dtype, q, k, v, len, out, ws, B, H, KVH, S, D, qsB, qsH,
                             scale, s);
    case 1:
      return launch_c<__nv_bfloat16>(cache_dtype, q, k, v, len, out, ws, B, H, KVH, S, D,
                                     qsB, qsH, scale, s);
    case 2:
      return launch_c<__half>(cache_dtype, q, k, v, len, out, ws, B, H, KVH, S, D, qsB, qsH,
                              scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
