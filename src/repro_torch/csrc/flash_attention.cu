// flash_attention: blocked causal (or full) GQA attention, online softmax.
//
// Replaces the TPU kernel `flash_attention_pallas` (body `_flash_kernel`) in
// src/repro/kernels/flash_attention/kernel.py and computes what
// `attention_ref` (src/repro_torch/kernels/flash_attention/ref.py) computes:
//
//   O[b,h,i,:] = softmax_j(scale * Q[b,h,i,:] . K[b,h/G,j,:], j <= i if causal)
//                @ V[b,h/G,:,:]
//
// with G = H / KVH query heads per KV head (K/V are never repeated in
// memory), float32 logits, softmax and accumulation, and the output in q's
// dtype (f32, bf16 or f16 inputs; bf16/f16 are widened to f32 on load).
//
// Bound on an H100 (published peaks, 700 W): operations. At the prefill
// shape of qwen3-0.6b, (8, 16, 1024, 128) f32 causal, the two products take
// 4*B*H*D*S(S+1)/2 = 34.4 GFLOP, 0.51 ms at the 67 TFLOP/s f32 peak of the
// CUDA cores, while the 201 MB of q, k, v and o take 0.06 ms at 3.35 TB/s.
// This first version does its products with f32 FMAs on the CUDA cores (so
// f32 inputs keep f32 accuracy); tensor cores (wgmma) are later work.
//
// Design. One CTA of 256 threads per (b, h, 64-row query tile); the grid
// walks query tiles from the last (longest causal row range) to the first,
// so the heavy tiles start first. The CTA stages its Q tile once and then
// streams 64-key K/V tiles through shared memory (as f32, rows padded by 4
// floats so the float4 reads of K rows hit distinct banks), keeping the
// running (max, sum, acc) triple of its rows in registers:
//   - thread (ty, tx) = (tid / 16, tid % 16) owns query rows ty + 16 i
//     (i < 4) and, of each 64x64 logit tile, columns tx + 16 j (j < 4);
//     a row's 16 owners are one half-warp, so its max and sum reduce with
//     four xor shuffles;
//   - the probabilities P go back to shared memory (over the K tile, which
//     is no longer read) for the P @ V product, where the thread owns D/16
//     output columns of its four rows (float4 groups when D % 64 == 0);
//   - K tiles entirely above the diagonal are never visited; the diagonal
//     tile and the ragged tail (any S: keys and queries beyond S are zeros,
//     masked keys get -inf, rows beyond S are not stored) are masked per
//     element. A row whose every key so far is masked keeps max -inf and
//     takes exp against 0, so no NaN is formed.
// 100 KB of shared memory at D = 128, so two CTAs share an SM. At D = 256
// (recurrentgemma-2b) it is 198,656 bytes, one CTA per SM, and each thread
// holds 64 accumulator floats: that instance is compiled for one CTA per
// SM, so ptxas may give it up to 255 registers instead of 128.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

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

// The K tile's region also holds P (kBQ x (kBK + 4)) once Q K^T is done.
template <int D>
__host__ __device__ constexpr int k_region_floats() {
  return kBK * (D + 4) > kBQ * (kBK + 4) ? kBK * (D + 4) : kBQ * (kBK + 4);
}

template <int D>
__host__ __device__ constexpr int smem_floats() {
  return kBQ * (D + 4) + k_region_floats<D>() + kBK * D;
}

// Copies rows [row0, row0 + 64) of one (b, head) slice, D contiguous
// elements each, into shared memory as f32 with row stride `ld`; rows at or
// beyond S become zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                                          long long row_stride, int row0, int S) {
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int row = row0 + r;
    dst[r * ld + d] = row < S ? to_f(src[(long long)row * row_stride + d]) : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, (D > 128 ? 1 : 2))
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int H, int KVH,
                           int S, long long qsB, long long qsH, long long qsS,
                           long long ksB, long long ksH, long long ksS, long long vsB,
                           long long vsH, long long vsS, float scale, int causal) {
  constexpr int LDQ = D + 4;  // padded rows: float4 reads of K rows by tx
  constexpr int LDP = kBK + 4;
  constexpr int NC = D / 16;  // output columns per thread
  constexpr bool kVec = (D % 64) == 0;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * LDQ;  // also holds P (kBQ x LDP) after Q K^T
  float* sV = sK + k_region_floats<D>();
  float* sP = sK;

  const int h = blockIdx.x, b = blockIdx.y;
  const int nq = gridDim.z;
  const int qt = nq - 1 - blockIdx.z;
  const int q0 = qt * kBQ;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  const T* qb = q + b * qsB + h * qsH;
  const T* kb = k + b * ksB + kvh * ksH;
  const T* vb = v + b * vsB + kvh * vsH;
  load_tile<T, D>(sQ, LDQ, qb, qsS, q0, S);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  const int nk_all = (S + kBK - 1) / kBK;
  const int nk = causal ? min(nk_all, (q0 + kBQ - 1) / kBK + 1) : nk_all;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile's P and V reads are done
    load_tile<T, D>(sK, LDQ, kb, ksS, k0, S);
    load_tile<T, D>(sV, D, vb, vsS, k0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&sQ[(ty + 16 * i) * LDQ + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * LDQ + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          s[i][j] = t;
        }
    }

    // Scale, mask, online softmax over this tile's 64 keys.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < S && (!causal || col <= row);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float alpha = expf(m[i] - m_use);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done reading the K tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&sP[(ty + 16 * i) * LDP + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = sV + (c + cc) * D;
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[i] = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
        if constexpr (kVec) {
#pragma unroll
          for (int k4 = 0; k4 < D / 64; ++k4) {
            const float4 vv = *reinterpret_cast<const float4*>(&vrow[k4 * 64 + tx * 4]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][k4 * 4 + 0] = fmaf(p[i], vv.x, acc[i][k4 * 4 + 0]);
              acc[i][k4 * 4 + 1] = fmaf(p[i], vv.y, acc[i][k4 * 4 + 1]);
              acc[i][k4 * 4 + 2] = fmaf(p[i], vv.z, acc[i][k4 * 4 + 2]);
              acc[i][k4 * 4 + 3] = fmaf(p[i], vv.w, acc[i][k4 * 4 + 3]);
            }
          }
        } else {
#pragma unroll
          for (int cn = 0; cn < NC; ++cn) {
            const float vv = vrow[tx + 16 * cn];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][cn] = fmaf(p[i], vv, acc[i][cn]);
          }
        }
      }
    }
  }

  T* ob = o + ((long long)b * H + h) * S * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float inv_l = 1.0f / l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = kVec ? (c / 4) * 64 + tx * 4 + (c % 4) : tx + 16 * c;
      ob[(long long)row * D + d] = from_f<T>(acc[i][c] * inv_l);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KVH,
           int S, const long long* st, float scale, int causal, cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats<D>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(H, B, (S + kBQ - 1) / kBQ);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, KVH, S, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B, int H, int KVH,
             int S, int D, const long long* st, float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, KVH, S, st, scale, causal, s);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KVH, S, st, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KVH, S, st, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KVH, S, st, scale, causal, s);
    case 256: return launch<T, 256>(q, k, v, o, B, H, KVH, S, st, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16, 2 = f16 (q, k, v and o alike). D in {16, 32,
// 64, 128, 256}. Strides are in elements, (batch, head, sequence) for q, k, v in
// that order; the last dimension is contiguous. o is contiguous (B, H, S, D).
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int dtype,
                           int B, int H, int KVH, int S, int D, long long qsB,
                           long long qsH, long long qsS, long long ksB, long long ksH,
                           long long ksS, long long vsB, long long vsH, long long vsS,
                           float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || S <= 0 || B > 65535 ||
      (S + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsB, qsH, qsS, ksB, ksH, ksS, vsB, vsH, vsS};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_d<float>(q, k, v, o, B, H, KVH, S, D, st, scale, causal, s);
    case 1: return launch_d<__nv_bfloat16>(q, k, v, o, B, H, KVH, S, D, st, scale, causal, s);
    case 2: return launch_d<__half>(q, k, v, o, B, H, KVH, S, D, st, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
