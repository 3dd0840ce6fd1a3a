// costmap: fused latency -> LUT performance -> integer arc cost (paper Eq. 6).
//
// Replaces the TPU kernel `costmap_pallas` (body `_costmap_kernel`) in
// src/repro/kernels/costmap/kernel.py. It follows the LUT reference
// (`costmap_ref`: perf_model.lookup_perf + perf_to_cost), not the Pallas
// body, which re-evaluates the polynomial with Horner's rule: the gather
// from the (4, 101) table is bit-identical to the reference by
// construction.
//
//   s    = rint(lat / 10)           IEEE division, round half to even
//   step = (int) clamp(s, 0, L-1)
//   p    = max(lut[model][step], 1e-6)
//   cost = (int) (rint((1 / p) * 10) * 10)
//
// Bound on an H100: memory. 8 bytes move per element (f32 latency in, i32
// cost out) against ~15 operations, so at (1024, 12500) the floor is
// 102.4 MB / 3.35 TB/s = 30.6 us. Design: each thread handles four
// consecutive elements with one 16-byte load and one 16-byte store
// (scalar tail and scalar fallback for unaligned pointers); the table sits
// in shared memory (1,616 bytes), so the gather costs no device-memory
// traffic. Build without --use_fast_math and with --fmad=false: the two
// divisions must stay IEEE round-to-nearest, which is what the reference
// computes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kMaxLut = 1024;  // floats of table the kernel holds in shared memory

__device__ __forceinline__ int cost_of(float lat, const float* lut, int row_base,
                                       int lut_size) {
  float s = rintf(lat / 10.0f);
  s = fminf(fmaxf(s, 0.0f), (float)(lut_size - 1));
  float p = fmaxf(lut[row_base + (int)s], 1e-6f);
  float inv = 1.0f / p;
  return (int)(rintf(inv * 10.0f) * 10.0f);
}

__device__ __forceinline__ int row_base_of(const int* perf_idx, int row, int n_models,
                                           int lut_size) {
  int m = perf_idx[row];
  // Out-of-range model ids clamp, as the reference's jnp gather does.
  m = min(max(m, 0), n_models - 1);
  return m * lut_size;
}

// T * M < 2^31 (checked by the wrapper), so flat offsets are 32-bit.
template <bool kAligned>
__global__ void costmap_kernel(const int* __restrict__ perf_idx,
                               const float* __restrict__ lat,
                               const float* __restrict__ lut_g,
                               int* __restrict__ out, int T, int M, int n_models,
                               int lut_size) {
  __shared__ float lut[kMaxLut];
  const int n_lut = n_models * lut_size;
  for (int i = threadIdx.x; i < n_lut; i += blockDim.x) lut[i] = lut_g[i];
  __syncthreads();

  const int n = T * M;
  const int base = (blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  if (base >= n) return;
  // One division per thread; the (at most kVec) following elements walk
  // forward from (row, col).
  int row = base / M;
  int col = base - row * M;
  int rbase = row_base_of(perf_idx, row, n_models, lut_size);
  const int cnt = min(kVec, n - base);
  int c[kVec];
  float l[kVec];
  if (kAligned && cnt == kVec) {
    const float4 v = *reinterpret_cast<const float4*>(lat + base);
    l[0] = v.x; l[1] = v.y; l[2] = v.z; l[3] = v.w;
  } else {
    for (int k = 0; k < cnt; ++k) l[k] = lat[base + k];
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (k < cnt) {
      c[k] = cost_of(l[k], lut, rbase, lut_size);
      if (++col == M && k + 1 < cnt) {
        col = 0;
        rbase = row_base_of(perf_idx, ++row, n_models, lut_size);
      }
    }
  }
  if (kAligned && cnt == kVec) {
    *reinterpret_cast<int4*>(out + base) = make_int4(c[0], c[1], c[2], c[3]);
  } else {
    for (int k = 0; k < cnt; ++k) out[base + k] = c[k];
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
int costmap_launch(const void* perf_idx, const void* lat, const void* lut, void* out,
                   int T, int M, int n_models, int lut_size, void* stream) {
  if (n_models * lut_size > kMaxLut || n_models <= 0 || lut_size <= 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)T * M;
  if (n == 0) return 0;
  const long long per_block = (long long)kThreads * kVec;
  if (n > 2147483647LL - per_block) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  const bool aligned = (((uintptr_t)lat | (uintptr_t)out) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (aligned)
    costmap_kernel<true><<<blocks, kThreads, 0, s>>>(
        (const int*)perf_idx, (const float*)lat, (const float*)lut, (int*)out, T, M,
        n_models, lut_size);
  else
    costmap_kernel<false><<<blocks, kThreads, 0, s>>>(
        (const int*)perf_idx, (const float*)lat, (const float*)lut, (int*)out, T, M,
        n_models, lut_size);
  return (int)cudaGetLastError();
}

const char* costmap_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
