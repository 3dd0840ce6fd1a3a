// auction_bid: per-row top-2 bid of the auction solver ("similar objects").
//
// Replaces the TPU kernel `bid_top2_pallas` (body `_bid_kernel`) in
// src/repro/kernels/auction_bid/kernel.py and computes what
// `bid_top2_ref` (src/repro/kernels/auction_bid/ref.py) computes. For each
// row t of the (T, C) value matrix V, with per-column lowest and
// second-lowest slot prices p1 <= p2:
//
//   idx    = argmax_j (V[t,j] - p1[j])            first index on ties
//   best   = max_j    (V[t,j] - p1[j])
//   second = max(-2^62, max_{j != idx} (V[t,j] - p1[j]), V[t,idx] - p2[idx])
//
// The reduction: every column j seeds the triple
// (best = V-p1, idx = j, second = max(V-p2, -2^62)) and triples combine
// with an associative, commutative merge:
//
//   best   = max(a.best, b.best)
//   idx    = index of the greater best; the lower index when equal
//   second = max(min(a.best, b.best), max(a.second, b.second))
//
// A merged second is the largest value of the set other than one copy of
// its best, over both every V-p1 and every seed's V-p2. Since p2 >= p1 per
// column, a non-winning column's V-p2 never exceeds its own V-p1, so this
// equals the reference, index included, in any merge order. Values are
// integer-valued float32, so every subtraction and comparison is exact.
//
// Bound on an H100: memory. The kernel reads V once (4*T*C bytes; p1 and p2
// are C floats each, L2-resident across rows) and writes 12*T bytes: at
// (1024, 12500) 51.2 MB, 15.3 us at 3.35 TB/s. At (8, 12500) the floor is
// 0.12 us and the launch dominates. Design: the columns of a row split into
// chunks, one CTA per (row, chunk), so that an 8-row round still spreads
// over the SMs; each thread strides its chunk (coalesced loads), then a
// warp-shuffle and a shared-memory stage reduce the CTA to one triple. With
// one chunk per row the CTA writes the result; otherwise a second kernel
// merges each row's chunk triples. The ragged edge is masked by bounds,
// never padded.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -4611686018427387904.0f;  // -2^62, the reference's floor

__device__ __forceinline__ void merge(float& best, int& idx, float& second, float ob,
                                      int oi, float os) {
  const int ni = (ob > best || (ob == best && oi < idx)) ? oi : idx;
  second = fmaxf(fminf(best, ob), fmaxf(second, os));
  best = fmaxf(best, ob);
  idx = ni;
}

__device__ __forceinline__ void warp_merge(float& best, int& idx, float& second) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    const float os = __shfl_down_sync(0xffffffffu, second, off);
    merge(best, idx, second, ob, oi, os);
  }
}

// grid (n_chunks, T). Partial triples live in `part` as three planes of
// T * n_chunks words: best (f32), idx (i32), second (f32).
__global__ void bid_chunk_kernel(const float* __restrict__ values,
                                 const float* __restrict__ p1,
                                 const float* __restrict__ p2, int* __restrict__ out_idx,
                                 float* __restrict__ out_best,
                                 float* __restrict__ out_second, int* __restrict__ part,
                                 int T, int C, int chunk_cols) {
  const int row = blockIdx.y;
  const int chunk = blockIdx.x;
  const int c0 = chunk * chunk_cols;
  const int c1 = min(C, c0 + chunk_cols);
  const float* v = values + (size_t)row * C;

  float best = -INFINITY, second = -INFINITY;
  int idx = INT_MAX;
  for (int j = c0 + threadIdx.x; j < c1; j += kThreads) {
    const float x = v[j];
    merge(best, idx, second, x - p1[j], j, fmaxf(x - p2[j], kNeg));
  }
  warp_merge(best, idx, second);

  __shared__ float s_best[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ float s_second[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_best[warp] = best;
    s_idx[warp] = idx;
    s_second[warp] = second;
  }
  __syncthreads();
  if (warp != 0) return;
  if (lane < kWarps) {
    best = s_best[lane];
    idx = s_idx[lane];
    second = s_second[lane];
  } else {
    best = -INFINITY;
    idx = INT_MAX;
    second = -INFINITY;
  }
  warp_merge(best, idx, second);
  if (lane != 0) return;
  if (gridDim.x == 1) {
    out_idx[row] = idx;
    out_best[row] = best;
    out_second[row] = second;
  } else {
    const int P = T * gridDim.x;
    const int k = row * gridDim.x + chunk;
    reinterpret_cast<float*>(part)[k] = best;
    part[P + k] = idx;
    reinterpret_cast<float*>(part)[2 * P + k] = second;
  }
}

// One thread per row: merge the row's chunk triples.
__global__ void bid_merge_kernel(const int* __restrict__ part, int* __restrict__ out_idx,
                                 float* __restrict__ out_best,
                                 float* __restrict__ out_second, int T, int n_chunks) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= T) return;
  const int P = T * n_chunks;
  const float* pb = reinterpret_cast<const float*>(part);
  float best = -INFINITY, second = -INFINITY;
  int idx = INT_MAX;
  for (int k = row * n_chunks; k < (row + 1) * n_chunks; ++k)
    merge(best, idx, second, pb[k], part[P + k], pb[2 * P + k]);
  out_idx[row] = idx;
  out_best[row] = best;
  out_second[row] = second;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// `part` holds 3 * T * ceil(C / chunk_cols) words when that count is > 1.
int bid_top2_launch(const void* values, const void* p1, const void* p2, void* idx,
                    void* best, void* second, void* part, int T, int C, int chunk_cols,
                    void* stream) {
  if (T <= 0 || C <= 0 || chunk_cols <= 0 || T > 65535) return (int)cudaErrorInvalidValue;
  const int n_chunks = (C + chunk_cols - 1) / chunk_cols;
  cudaStream_t s = (cudaStream_t)stream;
  bid_chunk_kernel<<<dim3(n_chunks, T), kThreads, 0, s>>>(
      (const float*)values, (const float*)p1, (const float*)p2, (int*)idx, (float*)best,
      (float*)second, (int*)part, T, C, chunk_cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return (int)err;
  bid_merge_kernel<<<(T + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      (const int*)part, (int*)idx, (float*)best, (float*)second, T, n_chunks);
  return (int)cudaGetLastError();
}

const char* bid_top2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
