// rglru_scan: RecurrentGemma's RG-LRU diagonal gated linear recurrence.
//
// Replaces the TPU kernel `rglru_scan_pallas` (body `_rglru_kernel`) in
// src/repro/kernels/rglru_scan/kernel.py and computes what `rglru_scan_ref`
// (src/repro_torch/kernels/rglru_scan/ref.py) computes:
//
//   a = exp(la[b,t,d]),  x = sqrt(-expm1(2 la[b,t,d])) * gx[b,t,d]
//   h[b,t,d] = a * h[b,t-1,d] + x
//
// with h[b,-1,:] = h0 (zeros when none is given), in float32, rounding each
// product and the sum separately, in this order, as the reference does
// (--fmad=false, IEEE expf/expm1f/sqrtf, no fast math; the recurrence as
// explicit __fmul_rn and __fadd_rn). So the f32 states are bit-equal to the
// plain version's on the card. Outputs: every state, in gx's dtype, and the
// final state in f32. log_a and gx are f32, bf16 or f16 (one dtype for
// both), contiguous (B, T, D); any T >= 1 and D, B <= 65,535.
//
// Bound on an H100 (published peaks, 700 W): bytes. At recurrentgemma-2b's
// prefill, (8, 2048, 2560) f32, it reads la and gx once (2 x 167.8 MB) and
// writes the states once (167.8 MB): 503 MB, 0.1503 ms at 3.35 TB/s. Its ~8
// operations per element take 0.005 ms at 67 TFLOP/s. But the IEEE exp,
// expm1 and sqrt cost some 60-80 issued instructions per element, ~0.1 ms of
// the card's issue rate: they need many warps to hide behind the bytes.
//
// Design (tile per dtype in `Tile`, chosen on the card by
// tools/rglru_tiles.py):
//   - One CTA per batch row b and channel group of G = 32 kVec channels:
//     lane l of a warp takes channels l, l + 32, ... of the group, so every
//     load and store of a warp is one contiguous run of the row (128 bytes
//     of f32 at kVec = 1; 2 x 64 bytes of bf16 or f16 at kVec = 2).
//   - Time runs in chunks of kChunk steps. kProducers producer warps split a
//     chunk's steps (warp p takes steps p, p + kProducers, ...): each loads
//     its steps' la and gx into registers first (all in flight at once),
//     then computes a = expf(la) and x = sqrtf(-expm1f(2 la)) * gx with the
//     reference's expressions and writes the pair to the chunk's stage in
//     shared memory. The prologue, nearly all the instructions, is so
//     time-parallel: at the prefill shape 640 CTAs of 8 warps, all resident
//     at 5 CTAs per SM (40 warps per SM, against 4.8 in a design with one
//     thread per channel and no prologue warps).
//   - One scan warp per CTA walks the chunk from shared memory, h =
//     __fadd_rn(__fmul_rn(a, h), x) per step and channel, and writes each
//     step's h to global memory in gx's dtype (streaming stores: written
//     once, not read again here); after the last chunk, the final state.
//     It starts from h0 where one is given.
//   - The stages form a ring of kStages: the producers fill chunk c + 1
//     while the scan warp drains chunk c. Each stage has two mbarriers:
//     `full` (every producer thread arrives once its pairs are written) and
//     `empty` (every scan lane arrives once it has read the chunk); a
//     producer waits on `empty` only to refill a stage, after issuing its
//     loads. No CTA-wide barrier after the set-up.
//   - Ragged edges: steps past T (the last chunk) are neither computed nor
//     read; channels past D are neither loaded nor stored.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// kVec channels per lane, kProducers producer warps, kChunk steps per stage,
// kStages stages in the ring, kMinBlocks CTAs per SM the registers are
// budgeted for. f32: 32-channel groups of 128-byte rows, 8 warps, 48
// registers a thread at 5 CTAs per SM (on an H100, 8 producers at 40
// registers ran 10% slower: tools/rglru_tiles.py); bf16 and f16: 64-channel
// groups (2 x 64 bytes).
template <typename T>
struct Tile;
template <>
struct Tile<float> { static constexpr int kVec = 1, kProducers = 7, kChunk = 56, kStages = 2, kMinBlocks = 5; };
template <>
struct Tile<__nv_bfloat16> { static constexpr int kVec = 2, kProducers = 7, kChunk = 56, kStages = 2, kMinBlocks = 3; };
template <>
struct Tile<__half> { static constexpr int kVec = 2, kProducers = 7, kChunk = 56, kStages = 2, kMinBlocks = 3; };

template <typename T>
struct Plan {
  static constexpr int V = Tile<T>::kVec, P = Tile<T>::kProducers;
  static constexpr int C = Tile<T>::kChunk, S = Tile<T>::kStages;
  static constexpr int G = 32 * V;                 // channels per CTA
  static constexpr int kThreads = 32 * (P + 1);    // the producers, then the scan warp
  static constexpr int kSteps = C / P;             // steps per producer warp and chunk
  // A stage: (a, x) pairs, [kChunk][kVec][32] float2. Then the full and the
  // empty mbarrier of every stage.
  static constexpr int kStagePairs = C * G;
  static constexpr int kSmem = S * kStagePairs * 8 + 2 * S * 8;
  static_assert(V >= 1 && V <= 4, "a few channels per lane");
  static_assert(C % P == 0, "the producers take as many steps of a chunk each");
  static_assert(S >= 2, "a ring: the producers fill one stage while the scan drains another");
};

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
// One arrival (release: this thread's shared-memory writes and reads before
// it are ordered before the phase completes).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Waits (acquire) until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// grid (ceil(D / G), B): CTA (channel group, b); warps 0 .. kProducers - 1
// produce, warp kProducers scans.
template <typename T>
__global__ void __launch_bounds__(Plan<T>::kThreads, Tile<T>::kMinBlocks)
    rglru_scan_kernel(const T* __restrict__ la, const T* __restrict__ gx,
                      const float* __restrict__ h0, T* __restrict__ out,
                      float* __restrict__ h_final, int T_len, int D) {
  using Pl = Plan<T>;
  constexpr int V = Pl::V, P = Pl::P, C = Pl::C, S = Pl::S;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* stages = reinterpret_cast<float2*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * Pl::kStagePairs * 8);
  uint64_t* empty = full + S;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * Pl::G + lane;  // this lane's channel v = 0
  const long long row0 = (long long)b * T_len;
  const int n_chunks = (T_len + C - 1) / C;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 32 * P);
      mbar_init(empty + s, 32);
    }
  }
  __syncthreads();

  if (warp < P) {
    // Producer: steps warp, warp + P, ... of every chunk.
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % S, t0 = c * C, n = min(C, T_len - t0);
      float lv[Pl::kSteps][V], gv[Pl::kSteps][V];
#pragma unroll
      for (int i = 0; i < Pl::kSteps; ++i) {
        const int t = i * P + warp;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int d = d0 + 32 * v;
          const bool ok = t < n && d < D;
          const long long at = (row0 + t0 + t) * D + d;
          lv[i][v] = ok ? to_f(la[at]) : 0.0f;
          gv[i][v] = ok ? to_f(gx[at]) : 0.0f;
        }
      }
      if (c >= S) mbar_wait(empty + s, ((c / S) - 1) & 1);  // the scan left chunk c - S
      float2* st = stages + s * Pl::kStagePairs;
#pragma unroll
      for (int i = 0; i < Pl::kSteps; ++i) {
        const int t = i * P + warp;
        if (t < n) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float a = expf(lv[i][v]);
            const float mult = sqrtf(-expm1f(2.0f * lv[i][v]));
            st[(t * V + v) * 32 + lane] = make_float2(a, mult * gv[i][v]);
          }
        }
      }
      mbar_arrive(full + s);
    }
    return;
  }

  // The scan warp.
  bool ok[V];
  float h[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    ok[v] = d0 + 32 * v < D;
    h[v] = (h0 != nullptr && ok[v]) ? h0[(long long)b * D + d0 + 32 * v] : 0.0f;
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % S, t0 = c * C, n = min(C, T_len - t0);
    mbar_wait(full + s, (c / S) & 1);
    const float2* st = stages + s * Pl::kStagePairs + lane;
    T* op = out + (row0 + t0) * D + d0;
    auto step = [&](int t) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float2 ax = st[(t * V + v) * 32];
        h[v] = __fadd_rn(__fmul_rn(ax.x, h[v]), ax.y);
        if (ok[v]) __stcs(op + (long long)t * D + 32 * v, from_f<T>(h[v]));  // streaming
      }
    };
    if (n == C) {
#pragma unroll 16
      for (int t = 0; t < C; ++t) step(t);
    } else {
      for (int t = 0; t < n; ++t) step(t);
    }
    mbar_arrive(empty + s);
  }
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (ok[v]) h_final[(long long)b * D + d0 + 32 * v] = h[v];
}

template <typename T>
int launch(const void* la, const void* gx, const float* h0, void* out, float* h_final,
           int B, int T_len, int D, cudaStream_t stream) {
  using Pl = Plan<T>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(rglru_scan_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Pl::kSmem);
    if (err == cudaSuccess)  // the largest carveout, so that kMinBlocks CTAs fit
      err = cudaFuncSetAttribute(rglru_scan_kernel<T>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((D + Pl::G - 1) / Pl::G, B);
  rglru_scan_kernel<T><<<grid, Pl::kThreads, Pl::kSmem, stream>>>(
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
