// flash_attention: blocked causal (or full) GQA attention, online softmax,
// both products on the tensor cores in 3xTF32.
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
// Under autograd the caller also asks for each row's log-sum-exp
// L = m + log(l) of the scaled logits, (B, H, S) f32, which the backward
// (csrc/flash_attention_bwd.cu) recomputes the probabilities from; it is a
// compile-time flag, so inference runs the instance without it.
//
// Bound on an H100 (published peaks, 700 W): operations. The two products
// take 4*B*H*D*P operations, P the (query, key) pairs (S(S+1)/2 causal).
// They run as warp-level `mma.sync.m16n8k8` TF32 products (495 TFLOP/s
// dense), and an f32 operand x goes in as two TF32 values, big = rna(x)
// and small = rna(x - big): a*b ~ a_small*b_big + a_big*b_small +
// a_big*b_big keeps f32 accuracy (one TF32 pass rounds each operand to
// 2^-11 relative, too coarse for the 2e-5 tolerance) at 3 passes per
// product. bf16 and f16 values are exact in TF32 (small = 0), so with those
// inputs Q K^T takes one pass and P V two (P is f32): 1.5 passes on
// average. At qwen3-0.6b's prefill, (8, 16, 1024, 128) f32 causal, the
// products are 34.4 GFLOP, 3 x 34.4 / 495e12 = 0.208 ms; recurrentgemma-2b's
// (8, 10, 2048, 256) f32 causal, 171.9 GFLOP, 1.042 ms. The 201 MB and 336
// MB of q, k, v and o take 0.06 and 0.10 ms at 3.35 TB/s.
//
// Design. One CTA of NW warps per (b, h, 16*NW-row query tile); the grid
// walks query tiles from the last (longest causal key range) to the first,
// so the heavy tiles start first.
//   - Each warp owns 16 query rows. Its logit tile S (16 x BK) and its
//     output accumulator O (16 x D) stay in registers as m16n8k8
//     accumulator fragments: lane (g, t) = (lane / 4, lane % 4) holds rows
//     g and g + 8, columns 2t and 2t + 1 of each 8-column block. A row's
//     max and sum reduce over the 4 lanes of a quad (2 xor shuffles).
//   - Q K^T: A = Q (rows g, g + 8), B = K^T (key g of the 8-key block),
//     both read from shared memory. A sum over d does not depend on its
//     order, so of each 8-wide step d0 the fragments' column (A) and row
//     (B) t stand for d0 + 2t and t + 4 for d0 + 2t + 1: one 8-byte read
//     per row gives both. P V: P never leaves registers. The accumulator
//     fragment of S holds keys 2t and 2t + 1 of each 8-key block, so it is
//     the A fragment of P V when A's column t stands for key 2t and column
//     t + 4 for key 2t + 1; the B fragment then reads V rows 2t and 2t + 1
//     (not t and t + 4). A sum over keys does not depend on their order.
//     (Fragment layouts: PTX ISA, mma.m16n8k8 .tf32; CuTe's
//     SM80_16x8x8_F32TF32TF32F32_TN traits give the same.)
//   - Shared memory: the Q tile (staged once) and a ring of two K/V stages.
//     Rows are padded so that every fragment read is free of bank
//     conflicts: Q and K rows to D + 8 floats (8-byte reads at
//     g*(D + 8) + 2t: each half-warp covers the 32 banks once), V rows to
//     D + 4 (4-byte reads at 2t*(D + 4) + g: 32 distinct banks). f32
//     tiles arrive by 16-byte `cp.async.cg` copies: the copy of tile k + 1
//     is issued right after the barrier that opens tile k and lands while
//     tile k is computed; one `__syncthreads` per tile (the wrapper refuses
//     pointers and strides that are not 16-byte aligned).
//     bf16/f16 tiles are widened by synchronous 16-byte loads into the same
//     ring (the serving path is f32).
//   - Masking: key tiles entirely above the diagonal are never loaded; a
//     warp skips a tile with no key at or below any of its rows, and masks
//     per element only a tile that crosses its diagonal or the end of the
//     sequence (any S: rows beyond S load as zeros, masked keys get -inf,
//     rows beyond S are not stored). A row whose every key so far is
//     masked keeps max -inf and takes exp against 0, so no NaN is formed.
//     A warp rescales O only when a row max of its moved (alpha != 1).
// Tiles (NW warps, BK keys) per head_dim are in `Tile` below, chosen on
// the card by ptxas' report (no spill) and the measured time:
// tools/flash_tiles.py builds and times the alternatives side by side
// (PERF.md records its runs). At D = 256 the O accumulator is 128
// registers a thread; 8 warps, BK = 16 and two stages take 202,240 bytes
// of shared memory, one CTA per SM. At D = 128, 8 warps and BK = 64 take
// 206,848 bytes, one CTA per SM.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// NW warps (BQ = 16 * NW query rows), BK keys per K/V stage, and the CTAs
// per SM the register budget is compiled for.
template <int D>
struct Tile;
template <>
struct Tile<16> { static constexpr int NW = 4, BK = 64, kMinBlocks = 2; };
template <>
struct Tile<32> { static constexpr int NW = 4, BK = 64, kMinBlocks = 2; };
template <>
struct Tile<64> { static constexpr int NW = 4, BK = 64, kMinBlocks = 2; };
template <>
struct Tile<128> { static constexpr int NW = 8, BK = 64, kMinBlocks = 1; };
template <>
struct Tile<256> { static constexpr int NW = 8, BK = 16, kMinBlocks = 1; };

// Row strides in shared memory: Q and K rows D + 8 floats (8-byte fragment
// reads), V rows D + 4 (4-byte reads).
template <int D>
__host__ __device__ constexpr int smem_floats() {
  return (16 * Tile<D>::NW + 2 * Tile<D>::BK) * (D + 8) + 2 * Tile<D>::BK * (D + 4);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y);
template <>
__device__ __forceinline__ void store2<float>(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
template <>
__device__ __forceinline__ void store2<__half>(__half* p, float x, float y) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
}

// Two 16-bit values packed in a 32-bit word, as f32 (first = low half).
__device__ __forceinline__ float2 widen2(uint32_t w, __nv_bfloat16*) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float2 widen2(uint32_t w, __half*) {
  __half2 h;
  *reinterpret_cast<uint32_t*>(&h) = w;
  return __half22float2(h);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 writes 16 zero bytes and reads nothing.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies rows [row0, row0 + R) of one (b, head) slice, D contiguous
// elements each, into shared memory as f32 with row stride LD; rows at or
// beyond S become zeros. f32: asynchronous (cp.async, not waited for here);
// bf16/f16: synchronous, widened.
template <typename T, int D, int LD, int R, int NT>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          long long row_stride, int row0, int S) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int C = D / E;           // chunks per row
#pragma unroll
  for (int i = 0; i < (R * C + NT - 1) / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    if ((R * C) % NT != 0 && e >= R * C) break;
    const int r = e / C, c = (e % C) * E;
    const int row = row0 + r;
    const bool ok = row < S;
    const T* from = src + (ok ? (long long)row * row_stride + c : 0);
    if constexpr (std::is_same<T, float>::value) {
      cp_async16(dst + r * LD + c, from, ok);
    } else {
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (ok) w = *reinterpret_cast<const uint4*>(from);
      const float2 a = widen2(w.x, (T*)nullptr), b = widen2(w.y, (T*)nullptr);
      const float2 x = widen2(w.z, (T*)nullptr), y = widen2(w.w, (T*)nullptr);
      *reinterpret_cast<float4*>(dst + r * LD + c) = make_float4(a.x, a.y, b.x, b.y);
      *reinterpret_cast<float4*>(dst + r * LD + c + 4) = make_float4(x.x, x.y, y.x, y.y);
    }
  }
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small + (a remainder below 2^-22 |x|), both TF32.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// c += A B, A 16 x 8 (row), B 8 x 8 (col), TF32 operands, f32 accumulator.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(32 * Tile<D>::NW, Tile<D>::kMinBlocks)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ lse, int H, int KVH,
                           int S, long long qsB, long long qsH, long long qsS,
                           long long ksB, long long ksH, long long ksS, long long vsB,
                           long long vsH, long long vsS, float scale, int causal) {
  constexpr int NW = Tile<D>::NW, BK = Tile<D>::BK;
  constexpr int BQ = 16 * NW, NT = 32 * NW, LDK = D + 8, LDV = D + 4;
  constexpr int NJ = BK / 8;  // 8-key blocks of a tile
  constexpr int ND = D / 8;   // 8-column blocks of O
  // f32 operands take 3 TF32 passes per product; bf16/f16 ones are exact
  // in TF32: 1 pass for Q K^T, 2 for P V (P is f32).
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * LDK;  // 2 stages of BK x LDK
  float* sV = sK + 2 * BK * LDK;  // 2 stages of BK x LDV

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * warp;  // the warp's first query row

  const T* qb = q + b * qsB + h * qsH;
  const T* kb = k + b * ksB + kvh * ksH;
  const T* vb = v + b * vsB + kvh * vsH;
  const int nk_all = (S + BK - 1) / BK;
  const int nk = causal ? min(nk_all, (q0 + BQ - 1) / BK + 1) : nk_all;

  load_rows<T, D, LDK, BQ, NT>(sQ, qb, qsS, q0, S);
  load_rows<T, D, LDK, BK, NT>(sK, kb, ksS, 0, S);
  load_rows<T, D, LDV, BK, NT>(sV, vb, vsS, 0, S);
  cp_async_commit();

  float acc[ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  const float* qw = sQ + 16 * warp * LDK;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_all();
    // Tile kt is in place for every thread, and every warp is done with
    // tile kt - 1, whose stage the next copies overwrite.
    __syncthreads();
    if (kt + 1 < nk) {
      const int st = (kt + 1) & 1;
      load_rows<T, D, LDK, BK, NT>(sK + st * BK * LDK, kb, ksS, (kt + 1) * BK, S);
      load_rows<T, D, LDV, BK, NT>(sV + st * BK * LDV, vb, vsS, (kt + 1) * BK, S);
      cp_async_commit();
    }
    const int k0 = kt * BK;
    if (r0 >= S || (causal && k0 > r0 + 15)) continue;  // no valid pair (warp-uniform)
    const float* kt_s = sK + (kt & 1) * BK * LDK;
    const float* vt_s = sV + (kt & 1) * BK * LDV;

    // S = Q K^T over this tile's NJ blocks of 8 keys. Of each 8-wide step
    // d0, A column t and B row t stand for d0 + 2t, column and row t + 4
    // for d0 + 2t + 1: one 8-byte read gives both.
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 8) {
      const float2 lo = *reinterpret_cast<const float2*>(qw + g * LDK + d0 + 2 * t);
      const float2 hi = *reinterpret_cast<const float2*>(qw + (g + 8) * LDK + d0 + 2 * t);
      const float qx[4] = {lo.x, hi.x, lo.y, hi.y};
      uint32_t qa[4], qs[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (kF32) split(qx[i], qa[i], qs[i]);
        else qa[i] = __float_as_uint(qx[i]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 kk =
            *reinterpret_cast<const float2*>(kt_s + (8 * j + g) * LDK + d0 + 2 * t);
        const float k0v = kk.x, k1v = kk.y;
        if constexpr (kF32) {
          uint32_t b0, b1, s0, s1;
          split(k0v, b0, s0);
          split(k1v, b1, s1);
          mma(s[j], qs, b0, b1);
          mma(s[j], qa, s0, s1);
          mma(s[j], qa, b0, b1);
        } else {
          mma(s[j], qa, __float_as_uint(k0v), __float_as_uint(k1v));
        }
      }
    }

    // Scale, mask, online softmax over the tile (rows g and g + 8).
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > r0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (edge) {
          const int row = r0 + g + (e >> 1) * 8;
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          if (!(col < S && (!causal || col <= row))) x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      m_use[i] = m_new == -INFINITY ? 0.0f : m_new;
      alpha[i] = expf(m[i] - m_use[i]);
      m[i] = m_new;
    }
    float rs[2] = {0.0f, 0.0f};  // this lane's share of the row sums
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_use[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
    if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
    }

    // O += P V: A column t is key 2t, column t + 4 key 2t + 1.
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t pa[4], ps[4];
      split(s[j][0], pa[0], ps[0]);
      split(s[j][2], pa[1], ps[1]);
      split(s[j][1], pa[2], ps[2]);
      split(s[j][3], pa[3], ps[3]);
      const float* v0 = vt_s + (8 * j + 2 * t) * LDV + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const float x0 = v0[8 * n], x1 = v0[LDV + 8 * n];
        if constexpr (kF32) {
          uint32_t b0, b1, s0, s1;
          split(x0, b0, s0);
          split(x1, b1, s1);
          mma(acc[n], ps, b0, b1);
          mma(acc[n], pa, s0, s1);
          mma(acc[n], pa, b0, b1);
        } else {
          mma(acc[n], ps, __float_as_uint(x0), __float_as_uint(x1));
          mma(acc[n], pa, __float_as_uint(x0), __float_as_uint(x1));
        }
      }
    }
  }

  T* ob = o + ((long long)b * H + h) * S * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = r0 + g + 8 * i;
    if (row >= S) continue;
    if constexpr (kLse) {
      if (t == 0) lse[((long long)b * H + h) * S + row] = m[i] + logf(l[i]);
    }
    const float inv_l = 1.0f / l[i];
#pragma unroll
    for (int n = 0; n < ND; ++n)
      store2<T>(ob + (long long)row * D + 8 * n + 2 * t, acc[n][2 * i] * inv_l,
                acc[n][2 * i + 1] * inv_l);
  }
}

template <typename T, int D, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
           int KVH, int S, const long long* st, float scale, int causal,
           cudaStream_t stream) {
  constexpr int BQ = 16 * Tile<D>::NW;
  if ((S + BQ - 1) / BQ > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_floats<D>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, D, kLse>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  flash_attention_kernel<T, D, kLse><<<grid, 32 * Tile<D>::NW, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, H, KVH, S, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, bool kLse>
int launch_d(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
             int KVH, int S, int D, const long long* st, float scale, int causal,
             cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16, kLse>(q, k, v, o, lse, B, H, KVH, S, st, scale, causal, s);
    case 32: return launch<T, 32, kLse>(q, k, v, o, lse, B, H, KVH, S, st, scale, causal, s);
    case 64: return launch<T, 64, kLse>(q, k, v, o, lse, B, H, KVH, S, st, scale, causal, s);
    case 128: return launch<T, 128, kLse>(q, k, v, o, lse, B, H, KVH, S, st, scale, causal, s);
    case 256: return launch<T, 256, kLse>(q, k, v, o, lse, B, H, KVH, S, st, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_l(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
             int KVH, int S, int D, const long long* st, float scale, int causal,
             cudaStream_t s) {
  return lse ? launch_d<T, true>(q, k, v, o, lse, B, H, KVH, S, D, st, scale, causal, s)
             : launch_d<T, false>(q, k, v, o, lse, B, H, KVH, S, D, st, scale, causal, s);
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16, 2 = f16 (q, k, v and o alike). D in {16, 32,
// 64, 128, 256}. Strides are in elements, (batch, head, sequence) for q, k, v in
// that order; the last dimension is contiguous, and every pointer and
// stride is 16-byte aligned. o is contiguous (B, H, S, D); lse, where not
// null, contiguous (B, H, S) f32.
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, float* lse,
                           int dtype, int B, int H, int KVH, int S, int D, long long qsB,
                           long long qsH, long long qsS, long long ksB, long long ksH,
                           long long ksS, long long vsB, long long vsH, long long vsS,
                           float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || S <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsB, qsH, qsS, ksB, ksH, ksS, vsB, vsH, vsS};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_l<float>(q, k, v, o, lse, B, H, KVH, S, D, st, scale, causal, s);
    case 1:
      return launch_l<__nv_bfloat16>(q, k, v, o, lse, B, H, KVH, S, D, st, scale, causal, s);
    case 2: return launch_l<__half>(q, k, v, o, lse, B, H, KVH, S, D, st, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
