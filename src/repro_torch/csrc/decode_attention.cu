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
// query against a bf16 cache. Any head_dim D >= 1 (up to what a block's
// shared memory holds).
//
// Bound on an H100 (published peaks, 700 W): memory. Every valid cache
// position is read once: at qwen3-0.6b's serving shape (8 sequences, 8 KV
// heads, D = 128, bf16, mean valid length 1,056) 34.6 MB of K and V, 10.3
// us at 3.35 TB/s; at recurrentgemma-2b's (8 sequences, 1 KV head, G = 10,
// D = 256, 2,048 positions) 16.8 MB, 5.0 us. There the 2 G D products per
// position (84 M in all, 2.5 us at the CUDA cores' 67 TFLOP/s) are half the
// byte time, so a bf16 cache goes through the tensor cores.
//
// Design: flash-decoding, one launch.
//   - Grid (split, KVH * head blocks, B), 4 warps per CTA. A CTA serves the
//     query heads of one KV head (all G of them up to kTcHeads on the
//     tensor cores, kMaxHeads on the CUDA cores; more go to further head
//     blocks), so each cache byte is read once, over one split of the
//     sequence axis. Splits are sized to the card (`make_plan`): as many as
//     keep every CTA resident at once, at most kMaxSplits. A split that
//     starts at or beyond lengths[b] loads nothing.
//   - The CTA walks its split in tiles of kTile = 32 positions. K and V
//     tiles stay in the cache's type in shared memory (a bf16 tile is never
//     widened there) and arrive through a ring of up to kMaxStages stages by
//     16-byte `cp.async.cg` copies, neighbouring threads on neighbouring
//     addresses: the copies of tile t + stages - 1 run while tile t is
//     used. Rows are padded to an odd number of 16-byte chunks, so that row
//     reads (per lane, or by ldmatrix) are free of bank conflicts. Where
//     D * sizeof(cache) is not a multiple of 16 or a cache is not 16-byte
//     aligned, an element path copies with plain loads into rows of an odd
//     number of words.
//   - Tensor cores (bf16 cache, head_dim in kTcDims): `mma.sync.m16n8k16`
//     bf16 with the heads as the 16 rows (rows past G are zero). The cache
//     is exact in bf16; q and p enter as three bf16 pieces each (`split3`:
//     24 bits, f32 accuracy), the smallest piece first. Warp w takes the
//     16-column k-steps w, w + 4, ... of Q K^T with its q fragments in
//     registers, B fragments straight from the K rows (ldmatrix), and the
//     8-column blocks w, w + 4, ... of P V (A = p's pieces by ldmatrix,
//     B = V rows by ldmatrix.trans), whose accumulators it keeps.
//   - CUDA cores (f32 or f16 cache, other head_dims): for the logits lane
//     = position (no shuffle reduction per position and head): warp w
//     takes the 16-byte chunks w, w + 4, ... of its position's K row,
//     widens each once, and multiplies it with every head of q (f32 in
//     shared memory, one broadcast 16-byte read per 4 FMAs). For P V thread
//     (c, r) owns column chunk c of every head over positions r, r + nr, ...
//     with explicit `fmaf` (the build uses --fmad=false); the nr position
//     phases add up at the split's end.
//   - Softmax, either way: the 4 warps' partial logits meet in shared
//     memory; 8 threads per head, 4 positions each, keep the head's running
//     max and sum (3 shuffles per reduction).
//   - Combine: the splits of a (b, kv head, head block) form one thread
//     block cluster. Each split leaves (max, sum, acc) in its shared
//     memory; after a cluster barrier, CTA s merges a slice of the columns
//     of every head from the valid splits through distributed shared
//     memory, taking each split's factor exp(m - M) once. No workspace, no
//     second launch. A sequence with one valid split writes its output
//     directly.
//   - Log-sum-exp (optional): where the caller passes `lse`, the writer of
//     a row's output also writes m + log(l), the log-sum-exp of its scaled
//     logits over the valid positions, from the same (max, sum) the combine
//     merged: a cache whose sequence is split over ranks merges the ranks'
//     partial outputs by it. A row with no valid position then gets a zero
//     output and -inf (without `lse`: NaN, as the plain version's 0 / 0).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;       // positions per tile (one per lane in the CUDA cores' logits)
constexpr int kThreads = 128;   // 4 warps per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kCtasPerSm = 2;   // split rule: this many CTAs per SM, on 7/8 of the SMs
constexpr int kMaxHeads = 12;   // query heads per CTA; more go to further head blocks
constexpr int kMaxSplits = 16;  // splits of a (b, kv head, head block): one cluster
constexpr int kMaxStages = 3;   // ring stages, as many as leave room for the CTAs of an SM
constexpr int kTcHeads = 16;    // query heads per CTA on the tensor cores (the mma's rows)
constexpr int kTcDims[] = {64, 128, 256};  // head_dims of the tensor-core path
constexpr int kTcRow = kTile + 8;  // row stride of its S and P tiles: no bank conflict
constexpr int kSmemPerBlock = 232448;  // H100: dynamic shared memory a block may use
constexpr int kSmemPerSm = 233472;     // H100: shared memory of an SM
constexpr int kSmemReserved = 1024;    // the runtime's share per resident block

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;
  float* lse;  // (B, H) log-sum-exp of each row, or null
  long long qsB, qsH;
  int H, KVH, S, D, G;
  int hp, nhb;           // heads per CTA, head blocks per KV head
  int splits, tiles_per_split;
  int nst;               // ring stages
  int nch, dq, row_bytes;
  int q_dtype;
  int off_q, off_s, off_p, off_a, off_f;  // shared memory offsets in bytes
  float scale;
};

// How a call is cut: head blocks, splits, ring stages and shared memory.
struct Plan {
  bool tc;  // the tensor-core path
  int nhb, hp, hb_tmpl, splits, tiles_per_split, nch, dq, row_bytes, nst, smem;
  int off_q, off_s, off_p, off_a, off_f;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// 16-byte chunks (vector path) or words (element path) per row, made odd.
inline int row_bytes_of(int D, int esize, bool vec) {
  if (vec) return ((D * esize / 16) | 1) * 16;
  return (cdiv(D * esize, 4) | 1) * 4;
}

inline void layout(Plan& p, int D, int esize, bool vec, int nst) {
  const int hb = p.hb_tmpl;
  p.row_bytes = row_bytes_of(D, esize, vec);
  const int ring = nst * 2 * kTile * p.row_bytes;
  const int acc = p.hp * D * 4;  // the split's accumulator, over the ring once it is free
  int off = ((ring > acc ? ring : acc) + 15) / 16 * 16;
  p.off_q = off;
  off += p.hp * p.dq * 4;
  p.off_s = off;
  off += p.tc ? kWarps * kTcHeads * kTcRow * 4 : kWarps * hb * kTile * 4;
  p.off_p = off;
  off += p.tc ? 3 * kTcHeads * kTcRow * 2 : kTile * hb * 4;
  p.off_a = off;
  off += 3 * hb * 4;
  p.off_f = off;
  off += hb * kMaxSplits * 4;
  p.smem = off;
  p.nst = nst;
}

// 0 if the shape can run; the split rule and the shared memory layout.
// cache_dtype: 0 = f32, 1 = bf16, 2 = f16.
int make_plan(Plan& p, int B, int H, int KVH, int S, int D, int cache_dtype, bool vec,
              int sms) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || S <= 0 || D <= 0) return 1;
  const int G = H / KVH, esize = cache_dtype == 0 ? 4 : 2;
  // bf16 tiles go through the tensor cores where whole 16-column k-steps fit.
  p.nhb = cdiv(G, kTcHeads);
  p.hp = cdiv(G, p.nhb);
  p.tc = cache_dtype == 1 && vec && (D == kTcDims[0] || D == kTcDims[1] || D == kTcDims[2]);
  p.hb_tmpl = kTcHeads;
  if (!p.tc) {
    p.nhb = cdiv(G, kMaxHeads);
    p.hp = cdiv(G, p.nhb);
    p.hb_tmpl = p.hp <= 4 ? 4 : kMaxHeads;  // few heads: a smaller instance
  }
  const int E = 16 / esize;
  p.nch = cdiv(D, E);
  p.dq = p.nch * E;
  if (p.nch > kThreads) return 1;
  const long long groups = (long long)B * KVH * p.nhb;
  const int n_tiles = cdiv(S, kTile);
  // As many splits as keep every CTA resident at once (one wave), with an
  // eighth of the slots left over (a cluster must fit within one group of
  // SMs), at most kMaxSplits; then as many ring stages as leave room for
  // kCtasPerSm CTAs on an SM.
  long long want = (long long)kCtasPerSm * sms * 7 / 8 / groups;
  const int cap = n_tiles < kMaxSplits ? n_tiles : kMaxSplits;
  if (want > cap) want = cap;
  if (want < 1) want = 1;
  p.tiles_per_split = cdiv(n_tiles, (int)want);
  p.splits = cdiv(n_tiles, p.tiles_per_split);
  for (int nst = kMaxStages; nst >= 2; --nst) {
    layout(p, D, esize, vec, nst);
    if (kCtasPerSm * (p.smem + kSmemReserved) <= kSmemPerSm) break;
  }
  if (p.smem > kSmemPerBlock) return 1;
  if (B > 65535 || (long long)KVH * p.nhb > 65535) return 1;
  return 0;
}

__device__ __forceinline__ float load_q(const void* q, long long i, int dt) {
  if (dt == 0) return static_cast<const float*>(q)[i];
  if (dt == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i]);
  return __half2float(static_cast<const __half*>(q)[i]);
}

__device__ __forceinline__ void store_out(void* out, long long i, float x, int dt) {
  if (dt == 0) static_cast<float*>(out)[i] = x;
  else if (dt == 1) static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(x);
  else static_cast<__half*>(out)[i] = __float2half_rn(x);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

__device__ __forceinline__ void widen(uint32_t w, float* x, __nv_bfloat16*) {
  x[0] = __uint_as_float(w << 16);
  x[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void widen(uint32_t w, float* x, __half*) {
  __half2 h;
  *reinterpret_cast<uint32_t*>(&h) = w;
  const float2 f = __half22float2(h);
  x[0] = f.x;
  x[1] = f.y;
}

// Chunk c (E = 16 / sizeof(CT) elements) of a row in shared memory, as f32;
// the element path zeroes columns at or beyond D.
template <typename CT, bool VEC>
__device__ __forceinline__ void read_chunk(const char* row, int c, int D,
                                           float (&x)[16 / sizeof(CT)]) {
  constexpr int E = 16 / sizeof(CT);
  if constexpr (VEC) {
    const uint4 w = *reinterpret_cast<const uint4*>(row + c * 16);
    if constexpr (std::is_same<CT, float>::value) {
      x[0] = __uint_as_float(w.x);
      x[1] = __uint_as_float(w.y);
      x[2] = __uint_as_float(w.z);
      x[3] = __uint_as_float(w.w);
    } else {
      widen(w.x, x + 0, (CT*)nullptr);
      widen(w.y, x + 2, (CT*)nullptr);
      widen(w.z, x + 4, (CT*)nullptr);
      widen(w.w, x + 6, (CT*)nullptr);
    }
  } else {
    const CT* r = reinterpret_cast<const CT*>(row);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = c * E + e;
      x[e] = d < D ? to_f(r[d]) : 0.0f;
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 writes 16 zero bytes and reads nothing.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Waits until at most n copy groups are pending (n <= kMaxStages - 2).
template <int N = kMaxStages - 2>
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  if constexpr (N <= 0) {
    cp_async_wait<0>();
  } else {
    if (n >= N) cp_async_wait<N>();
    else cp_async_wait_at_most<N - 1>(n);
  }
}


// x = s[0] + s[1] + s[2] + (below 2^-24 |x|), each a bf16 (round to nearest even).
__device__ __forceinline__ void split3(float x, __nv_bfloat16 (&s)[3]) {
  s[0] = __float2bfloat16_rn(x);
  const float r1 = x - __bfloat162float(s[0]);
  s[1] = __float2bfloat16_rn(r1);
  s[2] = __float2bfloat16_rn(r1 - __bfloat162float(s[1]));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Four 8x8 b16 matrices from shared memory; lane l gives row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// c += A B, A 16 x 16 (row), B 16 x 8 (col), bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// TD: the head_dim of a tensor-core instance (0: the CUDA cores, any D).
template <typename CT, bool VEC, int HB, int TD>
__global__ void __launch_bounds__(kThreads, HB <= 4 ? 4 : 2)
    decode_attention_kernel(const Params p) {
  constexpr bool TC = TD > 0;
  constexpr int T = kTile;
  constexpr int TP = T / 8;  // positions per softmax thread
  // Q K^T k-steps (16 columns) and P V blocks (8 columns) per warp.
  constexpr int KSW = TC ? TD / 64 : 1, NBW = TC ? TD / 32 : 1;
  constexpr int E = 16 / sizeof(CT);
  constexpr int SROW = TC ? kTcRow : kTile;  // row stride of the logits in sS
  using Raw = typename std::conditional<sizeof(CT) == 4, uint32_t, uint16_t>::type;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* sQ = reinterpret_cast<float*>(smem + p.off_q);  // hp x dq
  float* sS = reinterpret_cast<float*>(smem + p.off_s);  // kWarps x HB x SROW
  float* sP = reinterpret_cast<float*>(smem + p.off_p);  // kTile x HB (f32)
  // TC: p in three bf16 pieces, 3 x kTcHeads x kTcRow.
  __nv_bfloat16* sPb = reinterpret_cast<__nv_bfloat16*>(smem + p.off_p);
  float* sA = reinterpret_cast<float*>(smem + p.off_a);  // alpha, max, sum: HB each
  float* sM = sA + HB;
  float* sL = sM + HB;
  float* sF = reinterpret_cast<float*>(smem + p.off_f);  // HB x kMaxSplits

  const int split = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int kvh = grp / p.nhb, h0 = (grp % p.nhb) * p.hp;
  const int hc = min(p.hp, p.G - h0);  // heads of this CTA
  const int hq0 = kvh * p.G + h0;      // its first query head
  const int D = p.D;
  const int len = min(p.lengths[b], p.S);
  const int L = p.tiles_per_split * T;
  const int nv = len > 0 ? cdiv(len, L) : 0;  // splits with a valid position
  const long long out_base = ((long long)b * p.H + hq0) * D;
  // A single valid split writes the output itself; with more, every CTA of
  // the cluster (the sequence's splits) takes part in the combine, those
  // past the valid length without loading anything.
  if (nv <= 1 && split > 0) return;
  if (nv == 0) {  // nothing to attend to: NaN, as the plain version's 0 / 0
    // (with the log-sum-exp: a zero output and -inf, an empty shard's share)
    const float fill = p.lse ? 0.0f : __int_as_float(0x7fffffff);
    for (int i = threadIdx.x; i < hc * D; i += kThreads)
      store_out(p.out, out_base + i, fill, p.q_dtype);
    if (p.lse)
      for (int h = threadIdx.x; h < hc; h += kThreads)
        p.lse[(long long)b * p.H + hq0 + h] = -INFINITY;
    return;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int p_begin = split * L;
  const int p_end = min(p_begin + L, len);
  const int nt = split < nv ? cdiv(p_end - p_begin, T) : 0;
  const long long base = ((long long)b * p.KVH + kvh) * p.S * D;
  const CT* kg = static_cast<const CT*>(p.k) + base;
  const CT* vg = static_cast<const CT*>(p.v) + base;
  const int rb = p.row_bytes, nch = p.nch;
  const int nr = kThreads / nch;  // rows (positions) a pass of the CTA covers
  const int pc = tid % nch, pr = tid / nch;

  // The first q values are asked for before any K/V copy, so that they do
  // not queue behind the stream.
  constexpr int kQPre = 32;  // q values per thread
  float qx[kQPre];
  {
    int h = tid / p.dq, d = tid % p.dq;
#pragma unroll
    for (int u = 0; u < kQPre; ++u) {
      qx[u] = h < hc && d < D
                  ? load_q(p.q, b * p.qsB + (long long)(hq0 + h) * p.qsH + d, p.q_dtype)
                  : 0.0f;
      for (d += kThreads; d >= p.dq; d -= p.dq) ++h;
    }
  }

  // Tile t into ring stage t % nst (rows past the split's end as zeros):
  // 16-byte cp.async copies, thread (pc, pr) on chunk pc of rows pr, pr +
  // nr, ...; one commit group per call, empty past the last tile.
  auto load_tile = [&](int t) {
    if (t < nt) {
      char* dk = smem + (size_t)(2 * (t % p.nst)) * T * rb;
      char* dv = dk + (size_t)T * rb;
      const int r0 = p_begin + t * T;
      const int rows = min(T, p_end - r0);
      if constexpr (VEC) {
        if (pr < nr) {
          for (int r = pr; r < T; r += nr) {
            const bool ok = r < rows;
            const long long off = ok ? (long long)(r0 + r) * D + pc * E : 0;
            cp_async16(dk + r * rb + pc * 16, kg + off, ok);
            cp_async16(dv + r * rb + pc * 16, vg + off, ok);
          }
        }
      } else {
        const Raw* kr = reinterpret_cast<const Raw*>(kg);
        const Raw* vr = reinterpret_cast<const Raw*>(vg);
        for (int r = warp; r < T; r += kWarps)
          for (int c = lane; c < D; c += 32) {
            Raw x = 0, y = 0;
            if (r < rows) {
              x = kr[(long long)(r0 + r) * D + c];
              y = vr[(long long)(r0 + r) * D + c];
            }
            reinterpret_cast<Raw*>(dk + r * rb)[c] = x;
            reinterpret_cast<Raw*>(dv + r * rb)[c] = y;
          }
      }
    }
    cp_async_commit();
  };

  for (int t = 0; t < p.nst - 1; ++t) load_tile(t);
  // q as f32 (zero beyond D): the values asked for up front, then the rest
  // (more than kQPre per thread only for head_dims above 256).
#pragma unroll
  for (int u = 0; u < kQPre; ++u)
    if (tid + u * kThreads < hc * p.dq) sQ[tid + u * kThreads] = qx[u];
  for (int i = tid + kQPre * kThreads; i < hc * p.dq; i += kThreads) {
    const int h = i / p.dq, d = i % p.dq;
    sQ[i] = d < D ? load_q(p.q, b * p.qsB + (long long)(hq0 + h) * p.qsH + d, p.q_dtype)
                  : 0.0f;
  }
  if constexpr (TC) {
    for (int i = tid; i < 3 * kTcHeads * kTcRow; i += kThreads)
      sPb[i] = __float2bfloat16_rn(0.0f);
    if (tid < kTcHeads) sA[tid] = 1.0f;
  }
  __syncthreads();  // sQ in place

  // The softmax: 8 threads per head (sh = tid / 8), TP positions each, with
  // the head's running max and sum.
  const int sh = tid >> 3, sp = TP * (tid & 7);
  float m_run = -INFINITY, l_run = 0.0f;
  float acc[TC ? 1 : HB][E];
#pragma unroll
  for (int h = 0; h < (TC ? 1 : HB); ++h)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[h][e] = 0.0f;
  // The tensor-core path: mma rows are heads (rows at or beyond hc are
  // zero), lane (g, tq) = (lane / 4, lane % 4) of a fragment. Warp w takes
  // the 16-column k-steps w, w + 4, ... of Q K^T, with its q fragments in
  // registers as three bf16 pieces each, and the 8-column blocks w, w + 4,
  // ... of P V, whose accumulators it keeps.
  const int g = lane >> 2, tq = lane & 3;
  float oacc[NBW][4];
#pragma unroll
  for (int i = 0; i < NBW; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.0f;
  uint32_t qa[KSW][3][4];
  if constexpr (TC) {
#pragma unroll
    for (int i = 0; i < KSW; ++i) {
      const int ks = warp + kWarps * i;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = g + 8 * (r & 1), col = 16 * ks + 2 * tq + 8 * (r >> 1);
        const bool ok = row < hc;
        __nv_bfloat16 x0[3], x1[3];
        split3(ok ? sQ[row * p.dq + col] : 0.0f, x0);
        split3(ok ? sQ[row * p.dq + col + 1] : 0.0f, x1);
#pragma unroll
        for (int c = 0; c < 3; ++c) qa[i][c][r] = pack(x0[c], x1[c]);
      }
    }
  }

  for (int t = 0; t < nt; ++t) {
    cp_async_wait_at_most(p.nst - 2);
    // Tile t is in place for every thread, and every thread is done with
    // tile t - 1, whose stage the next copies overwrite.
    __syncthreads();
    load_tile(t + p.nst - 1);
    const char* tk = smem + (size_t)(2 * (t % p.nst)) * T * rb;
    const char* tv = tk + (size_t)T * rb;
    const int rows = min(T, p_end - (p_begin + t * T));

    if constexpr (TC) {
      // S = Q K^T over this warp's k-steps, the tile's T positions in
      // blocks of 8: B fragments straight from the K rows (ldmatrix).
      float sacc[T / 8][4];
#pragma unroll
      for (int j = 0; j < T / 8; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.0f;
      const int mi = lane >> 3;
#pragma unroll
      for (int i = 0; i < KSW; ++i) {
        const int ks = warp + kWarps * i;
        uint32_t bk[T / 16][4];  // n-blocks 2 jp and 2 jp + 1
#pragma unroll
        for (int jp = 0; jp < T / 16; ++jp)
          ldsm_x4(bk[jp], tk + (8 * (2 * jp + (mi >> 1)) + (lane & 7)) * rb +
                              (16 * ks + 8 * (mi & 1)) * 2);
        // T / 8 independent accumulators per step, smallest piece first.
#pragma unroll
        for (int c = 2; c >= 0; --c)
#pragma unroll
          for (int j = 0; j < T / 8; ++j)
            mma_bf16(sacc[j], qa[i][c], bk[j >> 1][2 * (j & 1)], bk[j >> 1][2 * (j & 1) + 1]);
      }
#pragma unroll
      for (int j = 0; j < T / 8; ++j) {
        *reinterpret_cast<float2*>(sS + (warp * HB + g) * SROW + 8 * j + 2 * tq) =
            make_float2(sacc[j][0], sacc[j][1]);
        *reinterpret_cast<float2*>(sS + (warp * HB + g + 8) * SROW + 8 * j + 2 * tq) =
            make_float2(sacc[j][2], sacc[j][3]);
      }
    } else {
      // Logits, partial over this warp's chunks: lane = position.
      float s[HB];
#pragma unroll
      for (int h = 0; h < HB; ++h) s[h] = 0.0f;
      const char* krow = tk + lane * rb;
      for (int c = warp; c < nch; c += kWarps) {
        float kx[E];
        read_chunk<CT, VEC>(krow, c, D, kx);
        const float* qc = sQ + c * E;
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          if (h < hc) {
#pragma unroll
            for (int e = 0; e < E; e += 4) {
              const float4 qq = *reinterpret_cast<const float4*>(qc + h * p.dq + e);
              s[h] = fmaf(qq.x, kx[e], s[h]);
              s[h] = fmaf(qq.y, kx[e + 1], s[h]);
              s[h] = fmaf(qq.z, kx[e + 2], s[h]);
              s[h] = fmaf(qq.w, kx[e + 3], s[h]);
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < HB; ++h)
        if (h < hc) sS[(warp * HB + h) * SROW + lane] = s[h];
    }
    __syncthreads();

    // Online softmax over the tile, every head at once.
    {
      float x[TP];
#pragma unroll
      for (int k = 0; k < TP; ++k) {
        x[k] = -INFINITY;
        if (sh < hc && sp + k < rows) {
          float sum = 0.0f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) sum += sS[(w * HB + sh) * SROW + sp + k];
          x[k] = sum * p.scale;
        }
      }
      float mx = x[0];
#pragma unroll
      for (int k = 1; k < TP; ++k) mx = fmaxf(mx, x[k]);
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // Finite for a head of this CTA: every tile has a valid position.
      const float m_new = fmaxf(m_run, mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float alpha = expf(m_run - m_use);
      float e[TP], es = 0.0f;
#pragma unroll
      for (int k = 0; k < TP; ++k) {
        e[k] = expf(x[k] - m_use);
        es += e[k];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) es += __shfl_xor_sync(0xffffffffu, es, off);
      l_run = l_run * alpha + es;
      m_run = m_new;
      if (sh < hc) {
        if constexpr (TC) {
          __nv_bfloat16 pe[TP][3];
#pragma unroll
          for (int k = 0; k < TP; ++k) split3(e[k], pe[k]);
#pragma unroll
          for (int c = 0; c < 3; ++c)
#pragma unroll
            for (int k = 0; k < TP; k += 4)
              *reinterpret_cast<uint2*>(sPb + (c * kTcHeads + sh) * kTcRow + sp + k) =
                  make_uint2(pack(pe[k][c], pe[k + 1][c]), pack(pe[k + 2][c], pe[k + 3][c]));
        } else {
#pragma unroll
          for (int k = 0; k < TP; ++k) sP[(sp + k) * HB + sh] = e[k];
        }
        if ((tid & 7) == 0) sA[sh] = alpha;
      }
    }
    __syncthreads();

    if constexpr (TC) {
      // O += P V over this warp's 8-column blocks: A = p's pieces
      // (ldmatrix), B = V rows (ldmatrix.trans), 16-position k-steps.
      bool rescale = false;
#pragma unroll
      for (int h = 0; h < kTcHeads; ++h) rescale |= sA[h] != 1.0f;
      if (rescale) {
        const float a0 = sA[g], a1 = sA[g + 8];
#pragma unroll
        for (int i = 0; i < NBW; ++i) {
          oacc[i][0] *= a0;
          oacc[i][1] *= a0;
          oacc[i][2] *= a1;
          oacc[i][3] *= a1;
        }
      }
      const int mi = lane >> 3;
#pragma unroll
      for (int k2 = 0; k2 < T / 32; ++k2) {  // pairs of k-steps: 32 positions
        uint32_t pa[2][3][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            ldsm_x4(pa[ks][c], sPb + (c * kTcHeads + (lane & 7) + 8 * (mi & 1)) * kTcRow +
                                   32 * k2 + 16 * ks + 8 * (mi >> 1));
#pragma unroll
        for (int u0 = 0; u0 < NBW; u0 += 4) {
          // Up to four blocks' V fragments, then their independent accumulators.
          constexpr int U = NBW < 4 ? NBW : 4;
          uint32_t bv[U][4];
#pragma unroll
          for (int u = 0; u < U; ++u)
            ldsm_x4_trans(bv[u], tv + (32 * k2 + 8 * mi + (lane & 7)) * rb +
                                     (warp + kWarps * (u0 + u)) * 16);
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
#pragma unroll
            for (int c = 2; c >= 0; --c)
#pragma unroll
              for (int u = 0; u < U; ++u)
                mma_bf16(oacc[u0 + u], pa[ks][c], bv[u][2 * ks], bv[u][2 * ks + 1]);
        }
      }
    } else if (pr < nr) {
      // P V: thread (pc, pr) accumulates column chunk pc of every head.
      bool rescale = false;
#pragma unroll
      for (int h = 0; h < HB; ++h)
        if (h < hc) rescale |= sA[h] != 1.0f;
      if (rescale) {
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          if (h < hc) {
            const float a = sA[h];
#pragma unroll
            for (int e = 0; e < E; ++e) acc[h][e] *= a;
          }
        }
      }
      for (int r = pr; r < rows; r += nr) {
        float vx[E];
        read_chunk<CT, VEC>(tv + r * rb, pc, D, vx);
#pragma unroll
        for (int h4 = 0; h4 < HB; h4 += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(sP + r * HB + h4);
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (h4 + j < hc) {
#pragma unroll
              for (int e = 0; e < E; ++e) acc[h4 + j][e] = fmaf(pv[j], vx[e], acc[h4 + j][e]);
            }
          }
        }
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // every tile consumed: the ring is free for the accumulator
  float* sAcc = reinterpret_cast<float*>(smem);  // hc x D
  if (sh < hc && (tid & 7) == 0) {
    sM[sh] = m_run;
    sL[sh] = l_run;
  }
  if constexpr (TC) {
#pragma unroll
    for (int i = 0; i < NBW; ++i) {
      const int d = 8 * (warp + kWarps * i) + 2 * tq;
      if (g < hc) {
        sAcc[g * D + d] = oacc[i][0];
        sAcc[g * D + d + 1] = oacc[i][1];
      }
      if (g + 8 < hc) {
        sAcc[(g + 8) * D + d] = oacc[i][2];
        sAcc[(g + 8) * D + d + 1] = oacc[i][3];
      }
    }
    __syncthreads();
  } else {
    // The position phases add up in turn.
    for (int r = 0; r < nr; ++r) {
      if (pr == r) {
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          if (h < hc) {
#pragma unroll
            for (int e = 0; e < E; ++e) {
              const int d = pc * E + e;
              if (VEC || d < D) {
                float* dst = sAcc + h * D + d;
                *dst = r == 0 ? acc[h][e] : *dst + acc[h][e];
              }
            }
          }
        }
      }
      __syncthreads();
    }
  }

  if (nv == 1) {
    for (int i = tid; i < hc * D; i += kThreads)
      store_out(p.out, out_base + i, sAcc[i] / sL[i / D], p.q_dtype);
    if (p.lse)
      for (int h = tid; h < hc; h += kThreads)
        p.lse[(long long)b * p.H + hq0 + h] = sM[h] + logf(sL[h]);
    return;
  }
  // Combine through distributed shared memory: CTA `split` of the cluster
  // merges columns [c0, c0 + nc) of every head from the valid splits'
  // (max, sum, acc), each split's factor exp(m - M) computed once.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partial in place
  float* sL2 = sA;  // the merged sums (the rescale factors are done with)
  for (int h = tid; h < hc; h += kThreads) {
    float m[kMaxSplits], l[kMaxSplits];
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j) {  // every load in flight at once
      m[j] = j < nv ? *cluster.map_shared_rank(sM + h, j) : -INFINITY;
      l[j] = j < nv ? *cluster.map_shared_rank(sL + h, j) : 0.0f;
    }
    float M = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j) M = fmaxf(M, m[j]);
    float Lh = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j) {
      if (j < nv) {
        const float f = expf(m[j] - M);
        sF[h * kMaxSplits + j] = f;
        Lh += f * l[j];
      }
    }
    sL2[h] = Lh;
    if (p.lse && split == 0) p.lse[(long long)b * p.H + hq0 + h] = M + logf(Lh);
  }
  __syncthreads();
  const int cw = cdiv(D, p.splits), c0 = split * cw, nc = max(0, min(D, c0 + cw) - c0);
  for (int i = tid; i < hc * nc; i += kThreads) {
    const int h = i / nc, d = c0 + i % nc;
    float v[kMaxSplits];
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)  // every load in flight at once
      v[j] = j < nv ? *cluster.map_shared_rank(sAcc + h * D + d, j) : 0.0f;
    float a = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)
      if (j < nv) a = fmaf(sF[h * kMaxSplits + j], v[j], a);
    store_out(p.out, out_base + (long long)h * D + d, a / sL2[h], p.q_dtype);
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

template <typename CT, bool VEC, int HB, int TD = 0>
int launch(Params& prm, const Plan& pl, int B, cudaStream_t stream) {
  static int configured = 0;
  if (pl.smem > configured) {
    // The largest shared memory carveout, so that kCtasPerSm CTAs fit.
    cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<CT, VEC, HB, TD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           pl.smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(decode_attention_kernel<CT, VEC, HB, TD>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)  // clusters of up to kMaxSplits CTAs (above the portable 8)
      err = cudaFuncSetAttribute(decode_attention_kernel<CT, VEC, HB, TD>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    configured = pl.smem;
  }
  // One cluster per (b, kv head, head block): its splits.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.splits, prm.KVH * pl.nhb, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, decode_attention_kernel<CT, VEC, HB, TD>, prm);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename CT>
int launch_c(Params& prm, const Plan& pl, bool vec, int B, cudaStream_t s) {
  if constexpr (std::is_same<CT, __nv_bfloat16>::value)
    if (pl.tc) {
      switch (prm.D) {
        case kTcDims[0]: return launch<CT, true, kTcHeads, kTcDims[0]>(prm, pl, B, s);
        case kTcDims[1]: return launch<CT, true, kTcHeads, kTcDims[1]>(prm, pl, B, s);
        default: return launch<CT, true, kTcHeads, kTcDims[2]>(prm, pl, B, s);
      }
    }
  if (pl.hb_tmpl == 4)
    return vec ? launch<CT, true, 4>(prm, pl, B, s) : launch<CT, false, 4>(prm, pl, B, s);
  return vec ? launch<CT, true, kMaxHeads>(prm, pl, B, s)
             : launch<CT, false, kMaxHeads>(prm, pl, B, s);
}

}  // namespace

extern "C" {

// The splits of a call on the current device (the cluster size), or 0 if
// the shape cannot run (head_dim beyond what a block's shared memory holds,
// or grid limits); -1 without a device. cache_dtype: 0 = f32, 1 = bf16,
// 2 = f16.
int decode_attention_splits(int B, int H, int KVH, int S, int D, int cache_dtype) {
  const int sms = sm_count();
  if (sms <= 0) return -1;
  Plan a, e;  // the vector and the element path
  if (make_plan(a, B, H, KVH, S, D, cache_dtype, true, sms) ||
      make_plan(e, B, H, KVH, S, D, cache_dtype, false, sms))
    return 0;
  return a.splits;
}

// dtypes: 0 = f32, 1 = bf16, 2 = f16. q is (B, H, D) with element strides
// (qsB, qsH) and a contiguous last dimension; the caches are contiguous
// (B, KVH, S, D) (16-byte copies where D * element size is a multiple of 16
// and both are 16-byte aligned, element copies otherwise); lengths is (B,)
// int32; out is contiguous (B, H, D) in q's dtype; lse is null or a
// contiguous (B, H) float32 buffer for each row's log-sum-exp. One launch on `stream`;
// returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue.
int decode_attention_launch(const void* q, const void* k, const void* v, const void* lengths,
                            void* out, void* lse, int q_dtype,
                            int cache_dtype, int B, int H, int KVH, int S, int D,
                            long long qsB, long long qsH, float scale, void* stream) {
  if (q_dtype < 0 || q_dtype > 2 || cache_dtype < 0 || cache_dtype > 2)
    return (int)cudaErrorInvalidValue;
  const int esize = cache_dtype == 0 ? 4 : 2;
  const bool vec = (D * esize) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  Plan pl;
  const int sms = sm_count();
  if (sms <= 0 || make_plan(pl, B, H, KVH, S, D, cache_dtype, vec, sms))
    return (int)cudaErrorInvalidValue;
  Params prm;
  prm.q = q;
  prm.k = k;
  prm.v = v;
  prm.lengths = static_cast<const int*>(lengths);
  prm.out = out;
  prm.lse = static_cast<float*>(lse);
  prm.qsB = qsB;
  prm.qsH = qsH;
  prm.H = H;
  prm.KVH = KVH;
  prm.S = S;
  prm.D = D;
  prm.G = H / KVH;
  prm.hp = pl.hp;
  prm.nhb = pl.nhb;
  prm.splits = pl.splits;
  prm.tiles_per_split = pl.tiles_per_split;
  prm.nst = pl.nst;
  prm.nch = pl.nch;
  prm.dq = pl.dq;
  prm.row_bytes = pl.row_bytes;
  prm.q_dtype = q_dtype;
  prm.off_q = pl.off_q;
  prm.off_s = pl.off_s;
  prm.off_p = pl.off_p;
  prm.off_a = pl.off_a;
  prm.off_f = pl.off_f;

  prm.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cache_dtype) {
    case 0: return launch_c<float>(prm, pl, vec, B, s);
    case 1: return launch_c<__nv_bfloat16>(prm, pl, vec, B, s);
    default: return launch_c<__half>(prm, pl, vec, B, s);
  }
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
