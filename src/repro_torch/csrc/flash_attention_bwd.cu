// flash_attention_bwd: the gradients of csrc/flash_attention.cu's blocked
// causal (or full) GQA attention, every product on the tensor cores in
// 3xTF32, the probabilities recomputed tile by tile and never stored.
//
// Replaces no TPU kernel. The reference's `flash_attention_pallas` has no
// VJP (a `pallas_call` is not differentiable); its only differentiable
// attention is the plain XLA form, which the port ran under autograd
// (`attention_ref`, src/repro_torch/kernels/flash_attention/ref.py), over
// (B, H, S, S) float32 logits, mask and probabilities. Given the forward's
// output O and each row's log-sum-exp L = m + log(l) of the scaled logits
// (the forward's optional `lse` output), and the output's gradient dO:
//
//   P  = exp(scale * Q K^T - L)     (masked: 0 above the diagonal)
//   Δ  = rowsum(dO ∘ O)             (= rowsum(P ∘ dP))
//   dP = dO V^T,   dS = P ∘ (dP - Δ)
//   dQ = scale * dS K,   dK = scale * dS^T Q,   dV = P^T dO
//
// dK and dV sum over the G = H / KVH query heads of each KV head. Logits,
// softmax, Δ and every sum are f32; the gradients are stored in q's dtype.
//
// Bound on an H100 (published peaks, 700 W): operations. With P the
// (query, key) pairs (S(S+1)/2 causal), each product takes 2*B*H*D*P. The
// gradients need 5: S recomputed, dP, dV, dK and dQ, 10*B*H*D*P, 2.5
// times the forward's. Each runs as warp-level `mma.sync.m16n8k8` TF32
// products (495 TFLOP/s dense) in 3 passes for f32 operands (big =
// rna(x), small = x - big read as TF32, small*small dropped: the forward's
// split but for the rounding of small, which one TF32 pass is too coarse
// for); bf16 / f16 values are exact in TF32, so with those inputs the
// recomputed S and dP take one pass and the products with P or dS (f32)
// two. At qwen3-0.6b's training shape, (4, 16 / 8, 4,096, 128) f32 causal,
// the 5 products are 0.687 TFLOP a call, 3 x 0.687 / 495e12 = 4.17 ms; the
// 0.8 GB of q, k, v, o, dO and the gradients take 0.25 ms at 3.35 TB/s.
// This design computes 7 (its dQ pass recomputes S and dP, the price of
// writing dQ without atomics): 5.83 ms at that shape.
//
// Design. Three launches, no atomics (two runs give the same bits):
//   - flash_bwd_delta_kernel: Δ per (b, h, row), one warp a row; bytes.
//   - flash_bwd_dq_kernel: one CTA of QW warps per (b, h, 16*QW-row query
//     tile), heavy (late) tiles first, as the forward. Each warp owns 16
//     query rows; Q and dO stay in shared memory, K/V tiles of BK keys
//     stream through a ring of two cp.async stages. Per tile: S = Q K^T and
//     dP = dO V^T as accumulator fragments, P and dS in registers, then
//     dQ += dS K with dS as the A fragment straight from the registers.
//   - flash_bwd_dkdv_kernel: one CTA of KW warps per (b, KV head,
//     16*KW-key tile), key tile 0 (the longest causal query range) first.
//     Each warp owns 16 keys; the CTA's K/V rows stay in shared memory. It
//     walks the G query heads of its KV head and, in each, the query tiles
//     of BQ rows at or below the diagonal, through a ring of two stages (Q,
//     dO, L and Δ). Per tile: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T
//     in registers, then dV += P^T dO and dK += dS^T Q. dK and dV stay in
//     registers over all G heads and are written once.
//   - Fragments (PTX ISA, mma.m16n8k8 .tf32): lane (g, t) = (lane / 4,
//     lane % 4). A product of two row-major tiles (S = Q K^T and the like)
//     reads A's rows g, g + 8 and B's row g at columns d0 + t and
//     d0 + t + 4. A product with P or dS takes the accumulator fragment as
//     A: it holds columns 2t and 2t + 1 of each 8-column block, so A's
//     column t stands for 2t and t + 4 for 2t + 1 (a sum does not depend
//     on its order), and B's rows 2t and 2t + 1 are read to match.
//   - Sums: the tensor cores truncate as they accumulate. Summed straight
//     into the registers that hold them, dK and dV drifted by 8e-5 of
//     their largest value over the 512 query tiles of a 4,096-token KV
//     head (measured on the card). So a product with P or dS sums JG
//     8-row blocks in a fresh fragment, which is then added in f32.
//   - Splits: big is rounded by two integer operations and small is read
//     raw (see `split`); `cvt.rna.tf32.f32` runs on the scarcer conversion
//     pipe, and with it a call took 24 ms instead of 18 at train-4k's
//     shape (`tools/flash_tiles.py --backward`, PERF.md).
//   - Shared memory rows are D + 4 floats (D a multiple of 16): the reads
//     g*(D + 4) + t and 2t*(D + 4) + g each hit 32 distinct banks.
//     f32 tiles arrive by 16-byte cp.async copies (the wrapper copies a
//     view whose pointer or strides are not 16-byte aligned to contiguous
//     storage first), L and Δ by 4-byte ones; bf16 / f16 tiles are
//     widened by synchronous loads.
//   - Masking: a warp skips a tile with no (query, key) pair at or below
//     the diagonal and masks per element only a tile that crosses it or
//     the end of the sequence. Rows beyond S load as zeros; the rows a
//     warp owns beyond S are never stored, and the keys (dQ) or queries
//     (dK/dV) it sums over beyond S get P = 0.
//   - At D = 256, two 16 x D accumulators would take 256 registers a
//     thread: the dK/dV kernel runs twice (`kTwoPass`), dV in one launch
//     and dK in the other, S recomputed in both.
// Tiles per head_dim are in `Tile` below, chosen on the card by ptxas'
// report (no spill) and the measured time (PERF.md records the runs).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// KW warps of the dK/dV kernel (16 * KW keys a CTA), BQ query rows a stage
// of it; QW warps of the dQ kernel (16 * QW query rows a CTA), BK keys a
// stage of it; JG 8-row blocks of P (or dS) per fresh accumulator fragment
// in the products with P or dS (`mma_regs`); kTwoPass: dV and dK in two
// launches of the dK/dV kernel.
template <int D>
struct Tile;
template <>
struct Tile<16> { static constexpr int KW = 4, BQ = 64, QW = 4, BK = 64, JG = 4, kTwoPass = 0; };
template <>
struct Tile<32> { static constexpr int KW = 4, BQ = 64, QW = 4, BK = 64, JG = 4, kTwoPass = 0; };
template <>
struct Tile<64> { static constexpr int KW = 4, BQ = 32, QW = 4, BK = 64, JG = 4, kTwoPass = 0; };
template <>
struct Tile<128> { static constexpr int KW = 8, BQ = 16, QW = 8, BK = 32, JG = 2, kTwoPass = 0; };
template <>
struct Tile<256> { static constexpr int KW = 4, BQ = 16, QW = 4, BK = 16, JG = 2, kTwoPass = 1; };

// Shared memory of each kernel, in floats: dK/dV holds the CTA's K and V
// rows, two stages of Q and dO rows and two of L and Δ; dQ holds its Q and
// dO rows and two stages of K and V rows. Rows are D + 4 floats.
template <int D>
__host__ __device__ constexpr int dkdv_smem_floats() {
  return (2 * 16 * Tile<D>::KW + 4 * Tile<D>::BQ) * (D + 4) + 4 * Tile<D>::BQ;
}
template <int D>
__host__ __device__ constexpr int dq_smem_floats() {
  return (2 * 16 * Tile<D>::QW + 4 * Tile<D>::BK) * (D + 4);
}

// The helpers below are those of csrc/flash_attention.cu (each source
// builds alone into its own library).
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

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

// Two 16-bit values packed in a 32-bit word, as f32 (first = low half).
__device__ __forceinline__ float2 widen2(uint32_t w, __nv_bfloat16*) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float2 widen2(uint32_t w, __half*) {
  __half2 h;
  *reinterpret_cast<uint32_t*>(&h) = w;
  return __half22float2(h);
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 writes 16 zero bytes and reads nothing.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
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

// Copies src[row0, row0 + R) (f32) into shared memory, zeros beyond S.
template <int R, int NT>
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src, int row0,
                                         int S) {
  for (int r = threadIdx.x; r < R; r += NT) {
    const bool ok = row0 + r < S;
    cp_async4(dst + r, src + (ok ? row0 + r : 0), ok);
  }
}

// x = big + small + (a remainder below 2^-21 |x|). big is x rounded to
// TF32, to nearest with ties away from zero (what `cvt.rna.tf32.f32` gives,
// here by two integer operations: the conversion's pipe is the scarcer one
// in these loops). small is x - big as an f32 value, whose low 13 bits the
// tensor cores drop when they read it as TF32 (a truncation: 2^-10 of
// small, below 2^-21 of x).
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += A B, A 16 x 8 (row), B 8 x 8 (col), TF32 operands, f32 accumulator.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[j] += A B_j^T, summed over D columns: A the 16 rows at `a` (this lane's
// rows g and g + 8), B_j the 8 rows at b + 8j*LD (row g), every row D
// floats at stride LD. kExact: both operands are exact in TF32 (widened
// bf16 / f16), one pass; else 3xTF32.
template <int D, int LD, int NJ, bool kExact>
__device__ __forceinline__ void mma_rows(float (&c)[NJ][4], const float* a, const float* b,
                                         int g, int t) {
#pragma unroll
  for (int d0 = 0; d0 < D; d0 += 8) {
    const float ax[4] = {a[g * LD + d0 + t], a[(g + 8) * LD + d0 + t],
                         a[g * LD + d0 + t + 4], a[(g + 8) * LD + d0 + t + 4]};
    uint32_t ab[4], as[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kExact) ab[i] = __float_as_uint(ax[i]);
      else split(ax[i], ab[i], as[i]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* bj = b + (8 * j + g) * LD + d0 + t;
      const float x0 = bj[0], x1 = bj[4];
      if constexpr (kExact) {
        mma(c[j], ab, __float_as_uint(x0), __float_as_uint(x1));
      } else {
        uint32_t b0, b1, s0, s1;
        split(x0, b0, s0);
        split(x1, b1, s1);
        mma(c[j], as, b0, b1);
        mma(c[j], ab, s0, s1);
        mma(c[j], ab, b0, b1);
      }
    }
  }
}

// c[n] += P B: P the 16 x 8NJ accumulator fragments p (f32: 3xTF32, or 2
// passes where B is exact), B the 8NJ rows at b, D floats each at stride
// LD; c the 16 x D accumulator fragments. As an A fragment, column t of
// block j stands for 8j + 2t and t + 4 for 8j + 2t + 1. The tensor cores
// truncate as they accumulate (they do not round to nearest), which over
// the thousands of tiles a dK row sums would bias it: each 8-column block
// sums the products of JG blocks of P in a fresh fragment, added to c in
// f32 (JG < NJ holds fewer of P's TF32 pieces in registers at once).
template <int D, int LD, int NJ, int JG, bool kExactB>
__device__ __forceinline__ void mma_regs(float (&c)[D / 8][4], const float (&p)[NJ][4],
                                         const float* b, int g, int t) {
  static_assert(NJ % JG == 0, "JG must divide NJ");
#pragma unroll
  for (int j0 = 0; j0 < NJ; j0 += JG) {
    uint32_t pa[JG][4], ps[JG][4];
#pragma unroll
    for (int j = 0; j < JG; ++j) {
      split(p[j0 + j][0], pa[j][0], ps[j][0]);
      split(p[j0 + j][2], pa[j][1], ps[j][1]);
      split(p[j0 + j][1], pa[j][2], ps[j][2]);
      split(p[j0 + j][3], pa[j][3], ps[j][3]);
    }
    const float* bt = b + (8 * j0 + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < JG; ++j) {
        const float x0 = bt[8 * j * LD + 8 * n], x1 = bt[(8 * j + 1) * LD + 8 * n];
        if constexpr (kExactB) {
          mma(part, ps[j], __float_as_uint(x0), __float_as_uint(x1));
          mma(part, pa[j], __float_as_uint(x0), __float_as_uint(x1));
        } else {
          uint32_t b0, b1, s0, s1;
          split(x0, b0, s0);
          split(x1, b1, s1);
          mma(part, ps[j], b0, b1);
          mma(part, pa[j], s0, s1);
          mma(part, pa[j], b0, b1);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) c[n][e] += part[e];
    }
  }
}

// Δ[row] = sum_d dO[row, d] * O[row, d], one warp a row (o and dout
// contiguous, rows of D).
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ delta, long long rows, int D) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // warp-uniform
  const T* a = o + row * D;
  const T* b = dout + row * D;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) acc += widen(a[d]) * widen(b[d]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(32 * Tile<D>::QW, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int H, int KVH, int S, long long qsB,
                        long long qsH, long long qsS, long long ksB, long long ksH,
                        long long ksS, long long vsB, long long vsH, long long vsS,
                        float scale, int causal) {
  constexpr int QW = Tile<D>::QW, BK = Tile<D>::BK;
  constexpr int BQ = 16 * QW, NT = 32 * QW, LD = D + 4;
  constexpr int NJ = BK / 8;  // 8-key blocks of a tile
  constexpr int ND = D / 8;   // 8-column blocks of dQ
  constexpr bool kExact = !std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sO = sQ + BQ * LD;       // dO rows
  float* sK = sO + BQ * LD;       // 2 stages of BK x LD
  float* sV = sK + 2 * BK * LD;   // 2 stages of BK x LD

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * warp;  // the warp's first query row

  const long long bh = (long long)b * H + h;
  const T* kb = k + b * ksB + kvh * ksH;
  const T* vb = v + b * vsB + kvh * vsH;
  const int nk_all = (S + BK - 1) / BK;
  const int nk = causal ? min(nk_all, (q0 + BQ - 1) / BK + 1) : nk_all;

  load_rows<T, D, LD, BQ, NT>(sQ, q + b * qsB + h * qsH, qsS, q0, S);
  load_rows<T, D, LD, BQ, NT>(sO, dout + bh * S * D, D, q0, S);
  load_rows<T, D, LD, BK, NT>(sK, kb, ksS, 0, S);
  load_rows<T, D, LD, BK, NT>(sV, vb, vsS, 0, S);
  cp_async_commit();

  // L and Δ of this lane's rows g and g + 8 (0 beyond S: never stored).
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    lr[i] = row < S ? lse[bh * S + row] : 0.0f;
    dr[i] = row < S ? delta[bh * S + row] : 0.0f;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  const float* qw = sQ + 16 * warp * LD;
  const float* ow = sO + 16 * warp * LD;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_all();
    // Tile kt is in place for every thread, and every warp is done with
    // tile kt - 1, whose stage the next copies overwrite.
    __syncthreads();
    if (kt + 1 < nk) {
      const int st = (kt + 1) & 1;
      load_rows<T, D, LD, BK, NT>(sK + st * BK * LD, kb, ksS, (kt + 1) * BK, S);
      load_rows<T, D, LD, BK, NT>(sV + st * BK * LD, vb, vsS, (kt + 1) * BK, S);
      cp_async_commit();
    }
    const int k0 = kt * BK;
    if (r0 >= S || (causal && k0 > r0 + 15)) continue;  // no valid pair (warp-uniform)
    const float* ks = sK + (kt & 1) * BK * LD;
    const float* vs = sV + (kt & 1) * BK * LD;

    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    mma_rows<D, LD, NJ, kExact>(s, qw, ks, g, t);   // S = Q K^T
    mma_rows<D, LD, NJ, kExact>(dp, ow, vs, g, t);  // dP = dO V^T

    // P = exp(scale S - L), masked; dS = P (dP - Δ), in place of dP.
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > r0);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(s[j][e] * scale - lr[e >> 1]);
        if (edge) {
          const int row = r0 + g + (e >> 1) * 8;
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          if (!(col < S && (!causal || col <= row))) p = 0.0f;
        }
        dp[j][e] = p * (dp[j][e] - dr[e >> 1]);
      }
    mma_regs<D, LD, NJ, Tile<D>::JG, kExact>(acc, dp, ks, g, t);  // dQ += dS K
  }

  T* out = dq + bh * S * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      store2<T>(out + (long long)row * D + 8 * n + 2 * t, acc[n][2 * i] * scale,
                acc[n][2 * i + 1] * scale);
  }
}

// kPart: 1 = dV, 2 = dK, 3 = both.
template <typename T, int D, int kPart>
__global__ void __launch_bounds__(32 * Tile<D>::KW, 1)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int H, int KVH, int S,
                          long long qsB, long long qsH, long long qsS, long long ksB,
                          long long ksH, long long ksS, long long vsB, long long vsH,
                          long long vsS, float scale, int causal) {
  constexpr int KW = Tile<D>::KW, BQ = Tile<D>::BQ;
  constexpr int BN = 16 * KW, NT = 32 * KW, LD = D + 4;
  constexpr int NJ = BQ / 8;  // 8-query blocks of a stage
  constexpr int ND = D / 8;   // 8-column blocks of dK and dV
  constexpr bool kExact = !std::is_same<T, float>::value;
  constexpr bool kDV = (kPart & 1) != 0, kDK = (kPart & 2) != 0;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + BN * LD;
  float* sQ = sV + BN * LD;      // 2 stages of BQ x LD
  float* sO = sQ + 2 * BQ * LD;  // dO: 2 stages of BQ x LD
  float* sL = sO + 2 * BQ * LD;  // L: 2 stages of BQ
  float* sD = sL + 2 * BQ;       // Δ: 2 stages of BQ

  const int kvh = blockIdx.x, b = blockIdx.y, n0 = blockIdx.z * BN;
  const int G = H / KVH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int c0 = n0 + 16 * warp;  // the warp's first key

  // Stages: the G heads of this KV head, in each the query tiles from the
  // first that holds a query at or after key n0 (causal) to the last.
  const int mt0 = causal ? n0 / BQ : 0;
  const int nq = (S + BQ - 1) / BQ - mt0;
  const int n_it = G * nq;
  auto load_stage = [&](int it, int st) {
    const int h = kvh * G + it / nq, m0 = (mt0 + it % nq) * BQ;
    const long long bh = (long long)b * H + h;
    load_rows<T, D, LD, BQ, NT>(sQ + st * BQ * LD, q + b * qsB + h * qsH, qsS, m0, S);
    load_rows<T, D, LD, BQ, NT>(sO + st * BQ * LD, dout + bh * S * D, D, m0, S);
    load_vec<BQ, NT>(sL + st * BQ, lse + bh * S, m0, S);
    if constexpr (kDK) load_vec<BQ, NT>(sD + st * BQ, delta + bh * S, m0, S);
  };

  load_rows<T, D, LD, BN, NT>(sK, k + b * ksB + kvh * ksH, ksS, n0, S);
  if constexpr (kDK) load_rows<T, D, LD, BN, NT>(sV, v + b * vsB + kvh * vsH, vsS, n0, S);
  load_stage(0, 0);
  cp_async_commit();

  float dka[kDK ? ND : 1][4], dva[kDV ? ND : 1][4];
#pragma unroll
  for (int n = 0; n < (kDK ? ND : 1); ++n) dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.0f;
#pragma unroll
  for (int n = 0; n < (kDV ? ND : 1); ++n) dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.0f;
  const float* kw = sK + 16 * warp * LD;
  const float* vw = sV + 16 * warp * LD;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();
    // Stage it is in place for every thread, and every warp is done with
    // stage it - 1, whose buffers the next copies overwrite.
    __syncthreads();
    if (it + 1 < n_it) {
      load_stage(it + 1, (it + 1) & 1);
      cp_async_commit();
    }
    const int m0 = (mt0 + it % nq) * BQ;
    if (c0 >= S || (causal && m0 + BQ - 1 < c0)) continue;  // no valid pair (warp-uniform)
    const float* qs = sQ + (it & 1) * BQ * LD;
    const float* os = sO + (it & 1) * BQ * LD;
    const float* ls = sL + (it & 1) * BQ;
    const float* ds = sD + (it & 1) * BQ;

    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's keys, columns
    // the stage's queries.
    float s[NJ][4], dp[kDK ? NJ : 1][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    mma_rows<D, LD, NJ, kExact>(s, kw, qs, g, t);
    if constexpr (kDK) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
      mma_rows<D, LD, NJ, kExact>(dp, vw, os, g, t);
    }

    // P^T = exp(scale S^T - L), masked; dS^T = P^T (dP^T - Δ) in place of dP^T.
    const bool edge = m0 + BQ > S || (causal && m0 < c0 + 15);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        float p = expf(s[j][e] * scale - ls[col]);
        if (edge) {
          const int key = c0 + g + (e >> 1) * 8, query = m0 + col;
          if (!(query < S && (!causal || key <= query))) p = 0.0f;
        }
        s[j][e] = p;
        if constexpr (kDK) dp[j][e] = p * (dp[j][e] - ds[col]);
      }
    if constexpr (kDV) mma_regs<D, LD, NJ, Tile<D>::JG, kExact>(dva, s, os, g, t);  // dV += P^T dO
    if constexpr (kDK) mma_regs<D, LD, NJ, Tile<D>::JG, kExact>(dka, dp, qs, g, t);  // dK += dS^T Q
  }

  const long long base = ((long long)b * KVH + kvh) * S;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = c0 + g + 8 * i;
    if (key >= S) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const long long at = (base + key) * D + 8 * n + 2 * t;
      if constexpr (kDV) store2<T>(dv + at, dva[n][2 * i], dva[n][2 * i + 1]);
      if constexpr (kDK) store2<T>(dk + at, dka[n][2 * i] * scale, dka[n][2 * i + 1] * scale);
    }
  }
}

// Raises the dynamic shared memory limit of `kernel` once per instance.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  done = err == cudaSuccess;
  return err;
}

template <typename T, int D, int kPart>
int launch_dkdv(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                const float* delta, T* dk, T* dv, int B, int H, int KVH, int S,
                const long long* st, float scale, int causal, cudaStream_t stream) {
  constexpr int BN = 16 * Tile<D>::KW;
  const size_t smem = (size_t)dkdv_smem_floats<D>() * sizeof(float);
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<T, D, kPart>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(KVH, B, (S + BN - 1) / BN);
  flash_bwd_dkdv_kernel<T, D, kPart><<<grid, 32 * Tile<D>::KW, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, KVH, S, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const T* q, const T* k, const T* v, const T* o, const T* dout, const float* lse,
           float* delta, T* dq, T* dk, T* dv, int B, int H, int KVH, int S,
           const long long* st, float scale, int causal, cudaStream_t stream) {
  constexpr int BQ = 16 * Tile<D>::QW, BN = 16 * Tile<D>::KW;
  if ((S + BQ - 1) / BQ > 65535 || (S + BN - 1) / BN > 65535) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H * S;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(o, dout, delta,
                                                                             rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = (size_t)dq_smem_floats<D>() * sizeof(float);
  static bool configured = false;
  err = allow_smem(flash_bwd_dq_kernel<T, D>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  flash_bwd_dq_kernel<T, D><<<grid, 32 * Tile<D>::QW, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, H, KVH, S, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if constexpr (Tile<D>::kTwoPass != 0) {
    const int rc = launch_dkdv<T, D, 1>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, S, st,
                                        scale, causal, stream);
    if (rc != 0) return rc;
    return launch_dkdv<T, D, 2>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, S, st, scale,
                                causal, stream);
  } else {
    return launch_dkdv<T, D, 3>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, S, st, scale,
                                causal, stream);
  }
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* o, const void* dout,
             const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H,
             int KVH, int S, int D, const long long* st, float scale, int causal,
             cudaStream_t s) {
#define FLASH_BWD_CASE(DIM)                                                                   \
  case DIM:                                                                                   \
    return launch<T, DIM>((const T*)q, (const T*)k, (const T*)v, (const T*)o,                 \
                          (const T*)dout, lse, delta, (T*)dq, (T*)dk, (T*)dv, B, H, KVH, S,   \
                          st, scale, causal, s);
  switch (D) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(128)
    FLASH_BWD_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_BWD_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16, 2 = f16 (q, k, v, o, dout and the gradients
// alike). D in {16, 32, 64, 128, 256}. q, k, v and their strides as
// flash_attention_launch takes them (16-byte aligned); o and dout contiguous
// (B, H, S, D); lse the forward's (B, H, S) f32; delta (B, H, S) f32
// scratch; dq (B, H, S, D), dk and dv (B, KVH, S, D) contiguous, written
// whole. Launches on `stream`; returns cudaGetLastError() (0 = launched).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const float* lse, float* delta, void* dq,
                               void* dk, void* dv, int dtype, int B, int H, int KVH, int S,
                               int D, long long qsB, long long qsH, long long qsS,
                               long long ksB, long long ksH, long long ksS, long long vsB,
                               long long vsH, long long vsS, float scale, int causal,
                               void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || S <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsB, qsH, qsS, ksB, ksH, ksS, vsB, vsH, vsS};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_d<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KVH, S, D, st,
                             scale, causal, s);
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KVH, S,
                                     D, st, scale, causal, s);
    case 2:
      return launch_d<__half>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KVH, S, D, st,
                              scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
