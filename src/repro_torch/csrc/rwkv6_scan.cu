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
// in float32. r, k, v are f32, bf16 or f16 (one dtype), w, u and the states
// f32; the output has r's dtype. Any T, 1 included (decode); N in {16, 32,
// 64}. The kernel contracts and reorders: the bonus factors out as
// v[t,j] * c[t] with c[t] = sum_i r[t,i] u[i] k[t,i], every multiply-add is
// one explicit fused `__fmaf_rn` (the build's --fmad=false does not touch
// intrinsics), and the sum over i runs in key groups that are added at the
// end. Its tolerance against the plain version stays 1e-4 abs/rel (f32
// inputs; 2e-2 for bf16 outputs); tests/test_torch_rwkv6_twin.py follows
// this order on the CPU.
//
// Bound on an H100 (published peaks, 700 W): bytes. At rwkv6-7b's prefill,
// r, k, v, w (8, 64, 1024, 64) f32: r, k, v, w and the output once, u and
// the final state, 679.5 MB, 0.2028 ms at 3.35 TB/s. The recurrence needs
// 5 operations per state entry and step (an FMA r*S into o, k*v, an FMA
// w*S + kv): 10.7 GFLOP, 0.160 ms at 67 TFLOP/s, so three issued
// instructions per entry, ~0.19 ms at ~1.98 GHz, sit at the byte time. At
// T = 1 it is the 8.4 MB state read and written: bytes, ~5 us. The time
// dependence keeps it above both.
//
// Design (tile per N in `Tile`, chosen on the card by tools/rwkv6_tiles.py):
//   - One CTA of kWarps warps per (b, h). Each warp spans all N columns and
//     is KG key groups of LG = 32 / KG lanes; lane (g, l) of warp w keeps
//     keys (w KG + g) KPT .. (KPT = N / (kWarps KG)) of columns
//     l CPT .. (CPT = N / LG) of the state in registers for the whole
//     sequence. At N = 64: 4 warps (128 threads) of 2 groups of 16 lanes,
//     8 keys by 4 columns, 32 state entries a thread; 4 CTAs per SM.
//   - Per step and entry: acc = fma(r_i, S_ij, acc), kv = k_i * v_j,
//     S_ij = fma(w_i, S_ij, kv). The r, k, w values of a group's keys are
//     16-byte shared-memory reads of 4 keys that all its lanes share, each
//     feeding 4 CPT fused operations; v comes CPT columns at a time.
//   - The first group's accumulator starts at v_j * c[t], the others' at
//     0. A warp's KG partials meet by xor shuffles (each lane sends the
//     half of its columns its partner keeps), and each warp leaves one
//     partial row per step in shared memory; after the chunk's barrier the
//     CTA adds the kWarps rows in warp order and writes kChunk output rows
//     coalesced.
//   - c[t] is computed once per step and head as its chunk lands: 16
//     threads per step, thread q over keys q N/16 .. in order, then four
//     xor shuffles.
//   - Time runs in chunks of kChunk steps. Each chunk's r, k, v, w rows
//     (N contiguous elements at the time stride, in their own type; bf16
//     and f16 widen as they are read) arrive by four `cp.async.bulk.tensor`
//     copies, one per operand: the TMA unit walks a box of N by kChunk rows
//     of a 4-D tensor map (N, T, H, B), or (N, H, T, B) for heads split out
//     of a (B, T, H N) projection, built on the host for each call, and
//     fills rows past T with zeros. (Copies per row, or per 16 bytes, kept
//     the lanes that issue them busy, and through the barrier the whole
//     CTA.) A call of one chunk (T <= kChunk: decode) skips the maps and
//     spreads its 4 kChunk row copies (`cp.async.bulk`) over the lanes of
//     all warps. The stages form a ring of kStages, each with an mbarrier
//     that counts the bytes. In iteration ci, after one barrier: the
//     copies of chunk ci + kStages - 1 go into the stage chunk ci - 1 left,
//     c of chunk ci + 1 is computed, chunk ci - 1's partials are added and
//     written out, and chunk ci is computed (two partial buffers, two rows
//     of c).
//   - Each thread reads its own entries of s0 before it writes them to
//     s_final, so the two may be one tensor (decode updates in place).
//   - r, k, v, w must be 16-byte aligned, with 16-byte batch, head and time
//     strides (the tensor maps need them); the wrapper copies views that
//     are not.

#include <cuda.h>  // CUtensorMap; the encoder is looked up at run time (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// KG key groups per warp, kWarps warps per CTA, kChunk steps per stage,
// kStages stages in the ring, kMinBlocks CTAs per SM the registers are
// budgeted for.
template <int N>
struct Tile;
template <>
struct Tile<16> { static constexpr int KG = 2, kWarps = 2, kChunk = 8, kStages = 4, kMinBlocks = 8; };
template <>
struct Tile<32> { static constexpr int KG = 2, kWarps = 2, kChunk = 8, kStages = 4, kMinBlocks = 8; };
template <>
struct Tile<64> { static constexpr int KG = 2, kWarps = 4, kChunk = 8, kStages = 4, kMinBlocks = 4; };

template <typename T, int N>
struct Plan {
  static constexpr int KG = Tile<N>::KG, kWarps = Tile<N>::kWarps;
  static constexpr int C = Tile<N>::kChunk, S = Tile<N>::kStages;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int LG = 32 / KG;              // lanes per key group
  static constexpr int CPT = N / LG;              // columns per lane
  static constexpr int KPT = N / (kWarps * KG);   // keys per thread
  static constexpr int KB = N / 16;               // keys per thread of the bonus sum
  // Row bytes: r, k, v (N in T), w (N f32). Stage: r, k, v rows (C x N),
  // then w rows (C x N f32).
  static constexpr int kRowT = N * (int)sizeof(T), kRowW = N * 4;
  static constexpr int kOffW = 3 * C * kRowT;
  static constexpr int kStageBytes = kOffW + C * kRowW;
  static constexpr int kPartialFloats = kWarps * C * N;  // [kWarps][C][N]
  // + two partial buffers, two c rows and one mbarrier per stage
  static constexpr int kSmem = S * kStageBytes + (2 * kPartialFloats + 2 * C) * 4 + S * 8;
  static_assert(KG == 1 || KG == 2 || KG == 4, "key groups split a warp evenly");
  static_assert(N % LG == 0 && (CPT == 1 || CPT == 2 || CPT % 4 == 0), "a warp spans N columns");
  static_assert(KPT % 4 == 0 && N % (kWarps * KG) == 0, "quads of keys");
  static_assert(S >= 3, "the ring runs one chunk ahead of its c row");
  static_assert(C <= 256 && 4 * C <= 32 * kWarps && C % 2 == 0, "a box of C rows, a row copy "
                "per lane; both halves of a warp take as many steps of the bonus sum");
  static_assert(kRowT % 16 == 0 && C * kRowT % 128 == 0, "rows of whole 16-byte units; "
                "boxes at 128-byte offsets");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

__device__ __forceinline__ float2 to_f2(uint32_t x, __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}
__device__ __forceinline__ float2 to_f2(uint32_t x, __half) {
  return __half22float2(*reinterpret_cast<const __half2*>(&x));
}

// Four consecutive elements of a row, widened.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = to_f2(x.x, T()), b = to_f2(x.y, T());
  return make_float4(a.x, a.y, b.x, b.y);
}

// n consecutive elements of a row (n = 1, 2 or a multiple of 4), widened.
template <int n, typename T>
__device__ __forceinline__ void load_n(const T* p, float* x) {
  if constexpr (n % 4 == 0) {
#pragma unroll
    for (int q = 0; q < n / 4; ++q) {
      const float4 a = load4(p + 4 * q);
      x[4 * q] = a.x, x[4 * q + 1] = a.y, x[4 * q + 2] = a.z, x[4 * q + 3] = a.w;
    }
  } else if constexpr (n == 2 && sizeof(T) == 4) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x, x[1] = a.y;
  } else if constexpr (n == 2) {
    const float2 a = to_f2(*reinterpret_cast<const uint32_t*>(p), T());
    x[0] = a.x, x[1] = a.y;
  } else {
    x[0] = to_f(p[0]);
  }
}

template <int n>
__device__ __forceinline__ void store_n(float* p, const float* x) {
  if constexpr (n % 4 == 0) {
#pragma unroll
    for (int q = 0; q < n / 4; ++q)
      *reinterpret_cast<float4*>(p + 4 * q) =
          make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  } else if constexpr (n == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

__device__ __forceinline__ void store4(float* p, float4 o) {
  *reinterpret_cast<float4*>(p) = o;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 o) {
  __nv_bfloat162 a = __floats2bfloat162_rn(o.x, o.y), b = __floats2bfloat162_rn(o.z, o.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<uint32_t*>(&a), *reinterpret_cast<uint32_t*>(&b));
}
__device__ __forceinline__ void store4(__half* p, float4 o) {
  __half2 a = __floats2half2_rn(o.x, o.y), b = __floats2half2_rn(o.z, o.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<uint32_t*>(&a), *reinterpret_cast<uint32_t*>(&b));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
// One arrival that also announces `bytes` of copies to complete the phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
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
// The TMA unit copies the box of `map` at coordinates (0, c1, c2, c3) (its
// N elements by kChunk rows) to shared memory, completing on `bar`.
__device__ __forceinline__ void tma_copy(void* dst, const CUtensorMap* map, int c1, int c2,
                                         int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// A bulk copy of `bytes` from global to shared memory by the TMA unit,
// completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

struct Maps {  // r, k, v, w as (N, T, H, B) tensors, the middle two swapped in those of `th`
  CUtensorMap m[4];
};

struct Operands {  // r, k, v, w: base pointers, (batch, head, time) strides in bytes
  const unsigned char* p[4];
  long long sb[4], sh[4], st[4];
};

// A call of one chunk (decode) skips the tensor maps: every warp issues its
// share of the chunk's row copies (4 C of them: r, k, v, w of each step;
// lane l of warp w takes copy l kWarps + w) after one arrival on the
// chunk's mbarrier that announces their bytes. Rows past T_len are not
// copied (what the stage held stays there and is never used).
template <typename T, int N>
__device__ __forceinline__ void issue_rows(unsigned char* stage, uint64_t* bar,
                                           const Operands& ops, int x, int h, int b, int T_len,
                                           int warp, int lane) {
  using Pl = Plan<T, N>;
  const int t0 = x * Pl::C, n = min(Pl::C, T_len - t0);
  const int q = lane * Pl::kWarps + warp, c = q / 4, a = q % 4;
  const bool ok = q < 4 * Pl::C && c < n;
  const unsigned bytes = a == 3 ? Pl::kRowW : Pl::kRowT;
  const unsigned total = __reduce_add_sync(0xffffffffu, ok ? bytes : 0u);
  if (lane == 0) mbar_expect(bar, total);
  __syncwarp();
  if (ok)
    bulk_copy(stage + a * Pl::C * Pl::kRowT + c * bytes,
              ops.p[a] + b * ops.sb[a] + h * ops.sh[a] + (t0 + c) * ops.st[a], bytes, bar);
}

// Warp 0 issues chunk `x`'s copies: lane 0 announces their bytes, then
// lane a < 4 copies the C rows of r, k, v or w (bit a of `th`: its map has
// the heads before the time). Rows past the end of the sequence arrive as
// zeros and are never used.
template <typename T, int N>
__device__ __forceinline__ void issue_box(unsigned char* stage, uint64_t* bar, const Maps& maps,
                                          int x, int h, int b, unsigned th, int lane) {
  using Pl = Plan<T, N>;
  if (lane == 0) mbar_expect(bar, Pl::kStageBytes);
  __syncwarp();
  if (lane < 4) {
    const int t0 = x * Pl::C;
    const bool swap = (th >> lane) & 1;
    tma_copy(stage + lane * Pl::C * Pl::kRowT, &maps.m[lane], swap ? h : t0, swap ? t0 : h, b,
             bar);
  }
}

// c[t] = sum_i (r_i * u_i) k_i for the chunk's C steps of `stage`: 16
// threads per step, thread q over keys q * KB .. q * KB + KB - 1 in order,
// then four xor shuffles within the 16.
template <typename T, int N>
__device__ __forceinline__ void bonus_rows(const unsigned char* stage,
                                           const float (&ul)[Plan<T, N>::KB], float* c_row,
                                           int tid) {
  using Pl = Plan<T, N>;
  constexpr int KB = Pl::KB;
  const T* sR = reinterpret_cast<const T*>(stage);
  const T* sK = sR + Pl::C * N;
  const int q = tid & 15;
  for (int c = tid >> 4; c < Pl::C; c += Pl::kThreads / 16) {
    float ri[KB], ki[KB];
    load_n<KB>(sR + c * N + q * KB, ri);
    load_n<KB>(sK + c * N + q * KB, ki);
    float acc = 0.0f;
#pragma unroll
    for (int e = 0; e < KB; ++e) acc = __fmaf_rn(__fmul_rn(ri[e], ul[e]), ki[e], acc);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
    if (q == 0) c_row[c] = acc;
  }
}

// Adds chunk x's kWarps partial rows in warp order and writes its n output
// rows.
template <typename T, int N>
__device__ __forceinline__ void write_rows(const float* part, T* op, int x, int n, int tid) {
  using Pl = Plan<T, N>;
  for (int q = tid; q < Pl::C * N / 4; q += Pl::kThreads) {
    const int c = q / (N / 4), j = (q % (N / 4)) * 4;
    if (c < n) {
      float4 o = *reinterpret_cast<const float4*>(part + c * N + j);
#pragma unroll
      for (int g = 1; g < Pl::kWarps; ++g) {
        const float4 p = *reinterpret_cast<const float4*>(part + (g * Pl::C + c) * N + j);
        o.x = __fadd_rn(o.x, p.x), o.y = __fadd_rn(o.y, p.y);
        o.z = __fadd_rn(o.z, p.z), o.w = __fadd_rn(o.w, p.w);
      }
      store4(op + ((long long)x * Pl::C + c) * N + j, o);
    }
  }
}

// Adds a warp's KG key groups' partials of the lane's CPT columns by xor
// shuffles over the group bits, highest first; while a lane holds more than
// one column it sends the half its partner keeps. Leaves kOut values in
// acc[0 ..] for columns `first` ..; lanes that differ only in the group
// bits added whole hold the same values.
template <int KG, int CPT>
struct GroupSum {
  static constexpr int kLevels = KG == 4 ? 2 : KG == 2 ? 1 : 0;
  static constexpr int kHalving = kLevels < (CPT >= 4 ? 2 : CPT == 2 ? 1 : 0)
                                      ? kLevels
                                      : (CPT >= 4 ? 2 : CPT == 2 ? 1 : 0);
  static constexpr int kOut = CPT >> kHalving;
  // Group bits whose lanes end with equal values: store from bit value 0.
  static constexpr int kDupMask = (1 << (kLevels - kHalving)) - 1;

  static __device__ __forceinline__ void run(float (&acc)[CPT], int g, int& first) {
    constexpr int LG = 32 / KG;
    first = 0;
    int cnt = CPT;
#pragma unroll
    for (int lvl = 0; lvl < kLevels; ++lvl) {
      const int bit = KG >> (lvl + 1);
      const bool upper = (g & bit) != 0;
      if (cnt > 1) {
        const int half = cnt / 2;
#pragma unroll
        for (int e = 0; e < half; ++e) {
          const float keep = upper ? acc[e + half] : acc[e];
          const float send = upper ? acc[e] : acc[e + half];
          acc[e] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, bit * LG));
        }
        first += upper ? half : 0;
        cnt = half;
      } else {
        acc[0] = __fadd_rn(acc[0], __shfl_xor_sync(0xffffffffu, acc[0], bit * LG));
      }
    }
  }
};

// One step c of a chunk in `stage`: the lane's state entries move on and
// the warp's partial row of o (its KG groups added) goes to `pw`.
template <typename T, int N>
__device__ __forceinline__ void step(
    float (&Sr)[Plan<T, N>::KPT][Plan<T, N>::CPT], const unsigned char* stage, int c,
    int key0, int j0, int g, float ct, float* pw) {
  using Pl = Plan<T, N>;
  using Sum = GroupSum<Pl::KG, Pl::CPT>;
  constexpr int C = Pl::C, CPT = Pl::CPT, KPT = Pl::KPT;
  const T* sR = reinterpret_cast<const T*>(stage);
  const T* sK = sR + C * N;
  const T* sV = sK + C * N;
  const float* sW = reinterpret_cast<const float*>(stage + Pl::kOffW);
  float vj[CPT], acc[CPT];
  load_n<CPT>(sV + c * N + j0, vj);
#pragma unroll
  for (int e = 0; e < CPT; ++e) acc[e] = __fmul_rn(vj[e], ct);
#pragma unroll
  for (int m4 = 0; m4 < KPT; m4 += 4) {
    const float4 r4 = load4(sR + c * N + key0 + m4), k4 = load4(sK + c * N + key0 + m4);
    const float4 w4 = load4(sW + c * N + key0 + m4);
    const float ri[4] = {r4.x, r4.y, r4.z, r4.w};
    const float ki[4] = {k4.x, k4.y, k4.z, k4.w};
    const float wi[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int e = 0; e < CPT; ++e) {
        float& s = Sr[m4 + q][e];
        acc[e] = __fmaf_rn(ri[q], s, acc[e]);
        s = __fmaf_rn(wi[q], s, __fmul_rn(ki[q], vj[e]));
      }
    }
  }
  int first;
  Sum::run(acc, g, first);
  if ((g & Sum::kDupMask) == 0) store_n<Sum::kOut>(pw + c * N + first, acc);
}

// grid (H, B), Plan::kThreads threads; dynamic shared memory Plan::kSmem.
template <typename T, int N>
__global__ void __launch_bounds__(Plan<T, N>::kThreads, Tile<N>::kMinBlocks)
    rwkv6_scan_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Operands ops,
                      bool rows,
                      unsigned th, const float* __restrict__ u, const float* s0,
                      T* __restrict__ out, float* s_final, int H, int T_len) {
  using Pl = Plan<T, N>;
  constexpr int C = Pl::C, S = Pl::S, CPT = Pl::CPT, KPT = Pl::KPT;
  extern __shared__ __align__(128) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem + S * Pl::kStageBytes);  // [2][kWarps][C][N]
  float* c_rows = part + 2 * Pl::kPartialFloats;                        // [2][C]
  uint64_t* bars = reinterpret_cast<uint64_t*>(c_rows + 2 * C);         // [S]

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane / Pl::LG;
  const int j0 = (lane % Pl::LG) * CPT;          // the lane's first column
  const int key0 = (warp * Pl::KG + g) * KPT;    // and first key
  const bool first_group = warp == 0 && g == 0;  // starts its sums at v_j c[t]
  const long long bh = (long long)b * H + h;
  T* op = out + bh * T_len * N;
  const int n_chunks = (T_len + C - 1) / C;
  auto stage = [&](int x) { return smem + (x % S) * Pl::kStageBytes; };
  auto bar = [&](int x) { return bars + x % S; };
  auto parity = [&](int x) { return (unsigned)((x / S) & 1); };
  auto issue = [&](int x) {
    if (rows)
      issue_rows<T, N>(stage(x), bar(x), ops, x, h, b, T_len, warp, lane);
    else if (warp == 0)
      issue_box<T, N>(stage(x), bar(x), maps, x, h, b, th, lane);
  };

  if (!rows && warp == 0 && lane < 4)  // the copies' descriptors, while the barriers start
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&maps.m[lane]))
                 : "memory");
  if (tid == 0) {
#pragma unroll
    for (int x = 0; x < S; ++x) mbar_init(bars + x, rows ? Pl::kWarps : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // The first S - 1 chunks in flight, then the state and u.
#pragma unroll
  for (int x = 0; x < S - 1; ++x)
    if (x < n_chunks) issue(x);
  float Sr[KPT][CPT];
  const long long s_off = bh * N * N + (long long)key0 * N + j0;
  if (s0 != nullptr) {
#pragma unroll
    for (int m = 0; m < KPT; ++m) load_n<CPT>(s0 + s_off + m * N, Sr[m]);
  } else {
#pragma unroll
    for (int m = 0; m < KPT; ++m)
#pragma unroll
      for (int e = 0; e < CPT; ++e) Sr[m][e] = 0.0f;
  }
  float ul[Pl::KB];
#pragma unroll
  for (int e = 0; e < Pl::KB; ++e) ul[e] = u[h * N + (tid & 15) * Pl::KB + e];
  mbar_wait(bar(0), parity(0));
  bonus_rows<T, N>(stage(0), ul, c_rows, tid);

  for (int ci = 0; ci < n_chunks; ++ci) {
    if (ci + 1 < n_chunks) mbar_wait(bar(ci + 1), parity(ci + 1));  // chunk ci + 1 landed
    __syncthreads();  // c and partials of chunk ci - 1 written; its stage's readers done
    {
      const int x = ci + S - 1;
      if (x < n_chunks) issue(x);
    }
    if (ci + 1 < n_chunks) bonus_rows<T, N>(stage(ci + 1), ul, c_rows + ((ci + 1) & 1) * C, tid);
    if (ci > 0) write_rows<T, N>(part + ((ci - 1) & 1) * Pl::kPartialFloats, op, ci - 1, C, tid);

    const unsigned char* st_c = stage(ci);
    const float* c_row = c_rows + (ci & 1) * C;
    float* pw = part + (ci & 1) * Pl::kPartialFloats + warp * C * N + j0;
    const int n = min(C, T_len - ci * C);
    if (n == C) {  // a whole chunk, unrolled
#pragma unroll
      for (int c = 0; c < C; ++c)
        step<T, N>(Sr, st_c, c, key0, j0, g, first_group ? c_row[c] : 0.0f, pw);
    } else {
      for (int c = 0; c < n; ++c)
        step<T, N>(Sr, st_c, c, key0, j0, g, first_group ? c_row[c] : 0.0f, pw);
    }
  }
  __syncthreads();
  write_rows<T, N>(part + ((n_chunks - 1) & 1) * Pl::kPartialFloats, op, n_chunks - 1,
                   T_len - (n_chunks - 1) * C, tid);

#pragma unroll
  for (int m = 0; m < KPT; ++m) store_n<CPT>(s_final + s_off + m * N, Sr[m]);
}

template <typename T, int N>
int launch(const Maps& maps, const Operands& ops, bool rows, unsigned th, const float* u,
           const float* s0, void* out, float* s_final, int B, int H, int T_len,
           cudaStream_t stream) {
  using Pl = Plan<T, N>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(rwkv6_scan_kernel<T, N>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Pl::kSmem);
    if (err == cudaSuccess)  // the largest carveout, so that kMinBlocks CTAs fit
      err = cudaFuncSetAttribute(rwkv6_scan_kernel<T, N>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  rwkv6_scan_kernel<T, N><<<dim3(H, B), Pl::kThreads, Pl::kSmem, stream>>>(
      maps, ops, rows, th, u, s0, (T*)out, s_final, H, T_len);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(const Maps& maps, const Operands& ops, bool rows, unsigned th, const float* u,
             const float* s0, void* out, float* s_final, int B, int H, int T_len, int N,
             cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, 16>(maps, ops, rows, th, u, s0, out, s_final, B, H, T_len, s);
    case 32: return launch<T, 32>(maps, ops, rows, th, u, s0, out, s_final, B, H, T_len, s);
    case 64: return launch<T, 64>(maps, ops, rows, th, u, s0, out, s_final, B, H, T_len, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, looked up once through the runtime.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map of one (B, H, T, N) operand: dims (N, T, H, B), or (N, H, T, B)
// when `th` (the heads' stride is below the time stride, as for heads split
// out of a (B, T, H N) projection), boxes of N by C rows. A dimension of
// length 1 gets a packed stride, as its stride is never used. Returns false
// if the driver refuses it (a stride or address that is not a multiple of
// 16 bytes).
bool make_map(CUtensorMap* map, const void* base, CUtensorMapDataType dt, int esize, int B,
              int H, int T, int N, int C, long long sb, long long sh, long long st, bool th) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const long long size[3] = {th ? H : T, th ? T : H, B};
  long long stride[3] = {(th ? sh : st) * esize, (th ? st : sh) * esize, sb * esize};
  long long packed = (long long)N * esize;
  for (int i = 0; i < 3; ++i) {
    if (size[i] == 1) stride[i] = packed;
    packed = stride[i] * size[i];
  }
  const cuuint64_t dims[4] = {(cuuint64_t)N, (cuuint64_t)size[0], (cuuint64_t)size[1],
                              (cuuint64_t)size[2]};
  const cuuint64_t strides[3] = {(cuuint64_t)stride[0], (cuuint64_t)stride[1],
                                 (cuuint64_t)stride[2]};
  const cuuint32_t box[4] = {(cuuint32_t)N, th ? 1u : (cuuint32_t)C, th ? (cuuint32_t)C : 1u,
                             1u};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, dt, 4, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

int chunk_of(int N) {
  switch (N) {
    case 16: return Tile<16>::kChunk;
    case 32: return Tile<32>::kChunk;
    case 64: return Tile<64>::kChunk;
    default: return 0;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16, 2 = f16 (r, k, v and out alike). r, k, v, w are
// (B, H, T, N) with element strides (batch, head, time) given in that
// order for each, 12 in all, and a contiguous last dimension; w, u (H, N),
// s0 (may be null) and s_final (B, H, N, N) are f32, u and the states
// contiguous; s0 may equal s_final. out is contiguous (B, H, T, N).
// Launches on `stream`; returns cudaGetLastError() (0 = launched),
// cudaErrorMisalignedAddress (before anything runs) for r, k, v or w not
// 16-byte aligned or with a stride that is not, or cudaErrorInvalidValue
// for other arguments it does not take.
int rwkv6_scan_launch(const void* r, const void* k, const void* v, const void* w,
                      const void* u, const void* s0, void* out, void* s_final, int dtype,
                      int B, int H, int T, int N, const long long* strides, void* stream) {
  const int C = chunk_of(N);
  if (B <= 0 || H <= 0 || T <= 0 || B > 65535 || H > 65535 || dtype < 0 || dtype > 2 || C == 0)
    return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType dt = dtype == 0   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                 : dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                              : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const int es = dtype == 0 ? 4 : 2;
  const void* ptrs[4] = {r, k, v, w};
  // strides: (batch, head, time) of r, k, v, w. A call of one chunk copies
  // rows; longer ones build a tensor map per operand, the time dimension
  // first unless the head stride is the smaller one.
  Maps maps = {};
  Operands ops;
  unsigned th = 0;
  const bool rows = T <= C;
  for (int a = 0; a < 4; ++a) {
    const long long* sa = strides + 3 * a;
    const int esz = a == 3 ? 4 : es;
    ops.p[a] = static_cast<const unsigned char*>(ptrs[a]);
    ops.sb[a] = sa[0] * esz, ops.sh[a] = sa[1] * esz, ops.st[a] = sa[2] * esz;
    if (reinterpret_cast<uintptr_t>(ptrs[a]) % 16 || (B > 1 && ops.sb[a] % 16) ||
        (H > 1 && ops.sh[a] % 16) || (T > 1 && ops.st[a] % 16))
      return (int)cudaErrorMisalignedAddress;
    if (rows) continue;
    const bool swap = H > 1 && sa[1] < sa[2];
    th |= (unsigned)swap << a;
    if (!make_map(&maps.m[a], ptrs[a], a == 3 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : dt, esz, B,
                  H, T, N, C, sa[0], sa[1], sa[2], swap))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* uf = (const float*)u;
  const float* s0f = (const float*)s0;
  float* sf = (float*)s_final;
  switch (dtype) {
    case 0: return launch_n<float>(maps, ops, rows, th, uf, s0f, out, sf, B, H, T, N, s);
    case 1:
      return launch_n<__nv_bfloat16>(maps, ops, rows, th, uf, s0f, out, sf, B, H, T, N, s);
    default: return launch_n<__half>(maps, ops, rows, th, uf, s0f, out, sf, B, H, T, N, s);
  }
}

const char* rwkv6_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
