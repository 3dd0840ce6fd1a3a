// auction_phase: the auction solver's whole Jacobi phase in one persistent,
// cooperative launch.
//
// Replaces the TPU kernel `bid_top2_pallas` (src/repro/kernels/auction_bid/
// kernel.py:71) together with the `jax.lax.while_loop` around it in
// `auction_phase_step` (src/repro/core/auction.py:79-222), and computes what
// `auction_phase_ref` (src/repro_torch/kernels/auction_phase/ref.py) computes,
// bit for bit, the iteration count included. Given slot prices price0 (M, S),
// machine values V (Tp, M), each task's unscheduled value u (Tp,), its
// unscheduled column (Tp,) and an active mask (Tp,), each iteration, while an
// active task is unassigned and it < max_iters:
//
//   per machine  price1 = min over its S slots, slot1 its first index,
//                price2 = min over the slots with slot1 set to PRICE_LOCK
//   per bidder t (an unassigned active task), over the M columns:
//                (bm, best, second) = (first argmax of V - price1, its value,
//                the runner-up, which may be V[bm] - price2[bm]; >= -2^62)
//                if u[t] > best: t takes its unscheduled column
//                else it bids  price1[bm] + (best - max(second, u[t])) + eps
//   per machine  the highest bid wins, the lowest task id on equal bids; the
//                winner takes slot1 at its bid and evicts that slot's owner.
//
// Both of the reference's conflict strategies (the (T, T) dominance table
// and the segment max over machines) give exactly this. A machine bid is
// never below eps > 0 (price1 >= 0, and best >= max(second, u) when not
// u[t] > best), so the reference's `win_bid >= 0` test excludes nobody, and
// a bid's float order is the order of its bits.
//
// Bound on an H100 (published peaks, 700 W). A solve has to read the value
// row of every task that bids once (4 M bytes each; every active task bids in
// the first iteration), and a row bid on again may come from L2; it has to
// fold every element of every bidder row in every iteration (7 f32
// operations). At the full-width round (1,024 tasks, 12,500 machines) that is
// bytes: 51.2 MB, 15.3 us at 3.35 TB/s. A price war of a few rows bid on for
// thousands of iterations is bound by the operations and, below both, by
// latency: two grid barriers an iteration. What held the host loop back was
// ~60 launches and a host sync per iteration (1.13 ms). Here the loop runs
// on the card and the host reads the result once:
//   - One cooperative launch per solve: the grid (at most kCtasPerSm CTAs of
//     kThreads threads per SM, fewer for a small Tp) is co-resident, so a
//     grid-wide barrier (hand-written: an arrival counter and a generation
//     word) separates the phases. Two barriers per iteration.
//   - Bidders are a compacted list (double-buffered by iteration parity;
//     counts in a ring of three). Rows of assigned tasks, masked in the
//     reference, are never read.
//   - Phase 1, the bid: a warp takes one (row, column chunk) unit at a time.
//     A row is split into `row_splits` chunks, so that a few bidders still
//     spread over the warps; a lane walks its chunk's columns at stride 32
//     (coalesced), folds them with the merge below and the warp reduces by
//     shuffles. With more than one chunk, each warp stores its partial
//     triple, fences and counts the row on an atomic counter; the warp that
//     counts last merges the row's partials. The row's finisher forms the
//     bid level and claims the machine with one 64-bit atomicMax on
//     (order bits of the bid) << 32 | (0xFFFFFFFF - task id): the highest
//     bid, then the lowest id, wins.
//   - Phase 2, the apply: a bidder whose key survived writes the price and
//     owner of slot1, takes the machine, un-assigns the evicted owner and
//     pushes it onto the next list, then recomputes price1/slot1/price2 of
//     that machine alone (the one row that changed). A loser pushes itself.
//     Pushes are warp-aggregated atomics; the order of a list is free, since
//     every tie is broken by machine or task id.
//   - The keys of an iteration are cleared at the next one (the machines its
//     bidders named), when nobody reads them.
//   - Arrays written inside the launch are read through L2 (__ldcg); only
//     V, u, the unscheduled columns, the mask and price0 go through the
//     read-only path.
//
// The triple merge (as in auction_bid.cu): every column j seeds
// (V - p1, j, max(V - p2, -2^62)); two triples combine as
//   best = max, idx = index of the greater best (the lower index when equal),
//   second = max(min(a.best, b.best), max(a.second, b.second)),
// which is associative and commutative and equals the reference in any order
// whenever p2 >= p1. Bid arithmetic is rounded as the reference rounds it:
// --fmad=false, and the three operations written out in its order.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;           // threads per CTA
constexpr int kWarps = kThreads / 32;   // warps per CTA
constexpr int kCtasPerSm = 1;           // CTAs per SM at most
constexpr int kMinColsPerSplit = 256;   // columns of a row chunk, at least
constexpr float kNeg = -4611686018427387904.0f;  // -2^62, the reference's floor
constexpr float kLock = 1099511627776.0f;        // 2^40, PRICE_LOCK
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kBarrierTimeoutNs = 20ull * 1000 * 1000 * 1000;

struct Params {
  const float* price0;        // (M, S)
  const float* values;        // (Tp, M)
  const float* value_u;       // (Tp,)
  const int* job_col;         // (Tp,)
  const unsigned char* active;  // (Tp,)
  float* price;               // (M, S) out
  int* owner;                 // (M, S) out
  int* assigned;              // (Tp,) out
  long long* stats;           // (2,) out: iterations, bidder rows summed
  unsigned long long* key;    // (2, M) claims, by iteration parity
  unsigned long long* my_key; // (Tp,) each bidder's own claim
  float* p1;                  // (M,) price1
  float* p2;                  // (M,) price2
  int* slot1;                 // (M,)
  int* list;                  // (2, Tp) bidders, by iteration parity
  int* bm_of;                 // (2, Tp) machine bid on, -1 unscheduled
  int* row_cnt;               // (Tp,) chunks of a row done
  float* part_best;           // (n_part,) partial triples of split rows
  int* part_idx;
  float* part_second;
  unsigned* ctl;              // [0..2] list counts (ring), [4] arrivals, [5] generation
  int Tp, M, S, max_iters;
  float eps;
};

// Chunks per bidder row when n rows are bid on by `warps` warps: enough that
// every warp has a unit, none narrower than kMinColsPerSplit columns.
__device__ __forceinline__ int row_splits(int n, int warps, int M) {
  const int most = (M + kMinColsPerSplit - 1) / kMinColsPerSplit;
  const int want = (warps + n - 1) / n;
  return want < most ? (want > 1 ? want : 1) : most;
}

__device__ __forceinline__ void merge(float& best, int& idx, float& second, float ob,
                                      int oi, float os) {
  const int ni = (ob > best || (ob == best && oi < idx)) ? oi : idx;
  second = fmaxf(fminf(best, ob), fmaxf(second, os));
  best = fmaxf(best, ob);
  idx = ni;
}

// Lane 0 ends with the warp's merged triple.
__device__ __forceinline__ void warp_merge(float& best, int& idx, float& second) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(kFull, best, off);
    const int oi = __shfl_down_sync(kFull, idx, off);
    const float os = __shfl_down_sync(kFull, second, off);
    merge(best, idx, second, ob, oi, os);
  }
}

// Order-preserving bits of a float (greater float, greater unsigned).
__device__ __forceinline__ unsigned order_bits(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// Lowest, its first slot, and second-lowest price of a machine's row, with
// slot `s_new` read as `v_new` (s_new < 0: the row as stored).
__device__ __forceinline__ void slot_prices(const float* row, int S, int s_new, float v_new,
                                            float& pr1, int& s1, float& pr2) {
  pr1 = s_new == 0 ? v_new : __ldcg(row);
  s1 = 0;
  for (int s = 1; s < S; ++s) {
    const float x = s == s_new ? v_new : __ldcg(row + s);
    if (x < pr1) {
      pr1 = x;
      s1 = s;
    }
  }
  pr2 = kLock;
  for (int s = 0; s < S; ++s)
    if (s != s1) pr2 = fminf(pr2, s == s_new ? v_new : __ldcg(row + s));
}

// Warp-aggregated push of `value` where `pred`; every lane of the warp calls.
__device__ __forceinline__ void push(int* list, unsigned* count, int value, bool pred) {
  const unsigned m = __ballot_sync(kFull, pred);
  if (m == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  unsigned base = 0;
  if (lane == leader) base = atomicAdd(count, (unsigned)__popc(m));
  base = __shfl_sync(kFull, base, leader);
  if (pred) list[base + __popc(m & ((1u << lane) - 1u))] = value;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Grid-wide barrier over co-resident CTAs: bar[0] counts arrivals, bar[1] is
// the generation. Traps (a launch failure) rather than hang past the timeout.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const unsigned long long t0 = globaltimer();
      while (*gen == g) {
        if (globaltimer() - t0 > kBarrierTimeoutNs) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// The triple of columns [c0, c1) of one value row; lane 0 ends with it.
__device__ __forceinline__ void chunk_triple(const float* __restrict__ v, const float* p1,
                                             const float* p2, int c0, int c1, int lane,
                                             float& best, int& idx, float& second) {
  best = -INFINITY;
  idx = INT_MAX;
  second = -INFINITY;
  int j = c0 + lane;
  for (; j + 96 < c1; j += 128) {
    float x[4], a[4], b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[k] = __ldg(v + j + 32 * k);
      a[k] = __ldcg(p1 + j + 32 * k);
      b[k] = __ldcg(p2 + j + 32 * k);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      merge(best, idx, second, x[k] - a[k], j + 32 * k, fmaxf(x[k] - b[k], kNeg));
  }
  for (; j < c1; j += 32) {
    const float x = __ldg(v + j);
    merge(best, idx, second, x - __ldcg(p1 + j), j, fmaxf(x - __ldcg(p2 + j), kNeg));
  }
  warp_merge(best, idx, second);
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm) auction_phase_kernel(Params p) {
  const int lane = threadIdx.x & 31;
  const int gtid = blockIdx.x * kThreads + threadIdx.x;
  const int nthreads = gridDim.x * kThreads;
  const int gwarp = gtid >> 5;
  const int nwarps = nthreads >> 5;
  const int M = p.M, S = p.S, Tp = p.Tp;
  unsigned* count = p.ctl;
  unsigned* bar = p.ctl + 4;

  // Set-up: working prices and owners, per-machine slot prices, clear claims,
  // assignments, and the first list (every active task).
  for (int k = gtid; k < M * S; k += nthreads) {
    p.price[k] = __ldg(p.price0 + k);
    p.owner[k] = -1;
  }
  for (int m = gtid; m < M; m += nthreads) {
    const float* row = p.price0 + (size_t)m * S;
    float pr1 = __ldg(row), pr2 = kLock;
    int s1 = 0;
    for (int s = 1; s < S; ++s) {
      const float x = __ldg(row + s);
      if (x < pr1) {
        pr1 = x;
        s1 = s;
      }
    }
    for (int s = 0; s < S; ++s)
      if (s != s1) pr2 = fminf(pr2, __ldg(row + s));
    p.p1[m] = pr1;
    p.p2[m] = pr2;
    p.slot1[m] = s1;
    p.key[m] = 0;
    p.key[M + m] = 0;
  }
  for (int base = gtid - lane; base < Tp; base += nthreads) {
    const int t = base + lane;
    bool act = false;
    if (t < Tp) {
      act = __ldg(p.active + t) != 0;
      p.assigned[t] = act ? -1 : 0;
      p.row_cnt[t] = 0;
    }
    push(p.list, count, t, act);
  }
  grid_sync(bar);

  int it = 0;
  long long rows = 0;
  for (;;) {
    const int n = (int)__ldcg(count + it % 3);
    if (n == 0 || it >= p.max_iters) break;
    rows += n;
    const int par = it & 1;
    const int* list = p.list + (size_t)par * Tp;
    int* bm_of = p.bm_of + (size_t)par * Tp;
    unsigned long long* key = p.key + (size_t)par * M;

    // Phase 1: clear the previous iteration's claims, then bid.
    if (gtid == 0) count[(it + 1) % 3] = 0;
    {
      const int n_prev = (int)__ldcg(count + (it + 2) % 3);
      const int* bm_prev = p.bm_of + (size_t)(par ^ 1) * Tp;
      unsigned long long* key_prev = p.key + (size_t)(par ^ 1) * M;
      for (int i = gtid; i < n_prev; i += nthreads) {
        const int m = __ldcg(bm_prev + i);
        if (m >= 0) key_prev[m] = 0;
      }
    }
    const int splits = row_splits(n, nwarps, M);
    const int chunk = (M + splits - 1) / splits;
    for (int u = gwarp; u < n * splits; u += nwarps) {
      const int i = u / splits;
      const int part = u - i * splits;
      const int t = __ldcg(list + i);
      const int c0 = part * chunk;
      const int c1 = min(M, c0 + chunk);
      float best, second;
      int idx;
      chunk_triple(p.values + (size_t)t * M, p.p1, p.p2, c0, c1, lane, best, idx, second);
      bool finish = splits == 1;
      if (!finish) {
        int last = 0;
        if (lane == 0) {
          p.part_best[u] = best;
          p.part_idx[u] = idx;
          p.part_second[u] = second;
          __threadfence();
          last = atomicAdd(p.row_cnt + i, 1) == splits - 1;
        }
        finish = __shfl_sync(kFull, last, 0) != 0;
        if (finish) {
          __syncwarp();
          __threadfence();
          best = -INFINITY;
          idx = INT_MAX;
          second = -INFINITY;
          for (int k = lane; k < splits; k += 32) {
            const int at = i * splits + k;
            merge(best, idx, second, __ldcg(p.part_best + at), __ldcg(p.part_idx + at),
                  __ldcg(p.part_second + at));
          }
          warp_merge(best, idx, second);
          if (lane == 0) p.row_cnt[i] = 0;
        }
      }
      if (finish && lane == 0) {
        const float vu = __ldg(p.value_u + t);
        if (vu > best) {  // the task's own unscheduled offer is better
          p.assigned[t] = __ldg(p.job_col + t);
          bm_of[i] = -1;
        } else {
          const float second_m = fmaxf(second, vu);
          const float level =
              __fadd_rn(__fadd_rn(__ldcg(p.p1 + idx), __fsub_rn(best, second_m)), p.eps);
          const unsigned long long k =
              ((unsigned long long)order_bits(level) << 32) | (0xffffffffu - (unsigned)t);
          p.my_key[i] = k;
          bm_of[i] = idx;
          atomicMax(key + idx, k);
        }
      }
    }
    grid_sync(bar);

    // Phase 2: winners take their slot, losers and evictees bid again.
    {
      int* next = p.list + (size_t)(par ^ 1) * Tp;
      unsigned* next_count = count + (it + 1) % 3;
      for (int base = gtid - lane; base < n; base += nthreads) {
        const int i = base + lane;
        int again = -1;
        if (i < n) {
          const int bm = __ldcg(bm_of + i);
          if (bm >= 0) {
            const int t = __ldcg(list + i);
            const unsigned long long k = __ldcg(p.my_key + i);
            if (__ldcg(key + bm) == k) {
              const int s = __ldcg(p.slot1 + bm);
              const size_t at = (size_t)bm * S + s;
              const int old = __ldcg(p.owner + at);
              const float level = from_order_bits((unsigned)(k >> 32));
              p.price[at] = level;
              p.owner[at] = t;
              p.assigned[t] = bm;
              if (old >= 0) {
                p.assigned[old] = -1;
                again = old;
              }
              float pr1, pr2;
              int s1;
              slot_prices(p.price + (size_t)bm * S, S, s, level, pr1, s1, pr2);
              p.p1[bm] = pr1;
              p.p2[bm] = pr2;
              p.slot1[bm] = s1;
            } else {
              again = t;
            }
          }
        }
        push(next, next_count, again, again >= 0);
      }
    }
    grid_sync(bar);
    ++it;
  }
  if (gtid == 0) {
    p.stats[0] = it;
    p.stats[1] = rows;
  }
}

size_t align_up(size_t x) { return (x + 255) & ~(size_t)255; }

// Byte offsets of the workspace's arrays, in Params order from `key`.
struct Layout {
  size_t key, my_key, p1, p2, slot1, list, bm_of, row_cnt, part_best, part_idx,
      part_second, ctl, total;
};

Layout layout(int Tp, int M, int ctas) {
  const size_t n_part = 2 * (size_t)ctas * kWarps;
  Layout l;
  size_t at = 0;
  l.key = at;         at = align_up(at + 2 * (size_t)M * 8);
  l.my_key = at;      at = align_up(at + (size_t)Tp * 8);
  l.p1 = at;          at = align_up(at + (size_t)M * 4);
  l.p2 = at;          at = align_up(at + (size_t)M * 4);
  l.slot1 = at;       at = align_up(at + (size_t)M * 4);
  l.list = at;        at = align_up(at + 2 * (size_t)Tp * 4);
  l.bm_of = at;       at = align_up(at + 2 * (size_t)Tp * 4);
  l.row_cnt = at;     at = align_up(at + (size_t)Tp * 4);
  l.part_best = at;   at = align_up(at + n_part * 4);
  l.part_idx = at;    at = align_up(at + n_part * 4);
  l.part_second = at; at = align_up(at + n_part * 4);
  l.ctl = at;         at = align_up(at + 8 * 4);
  l.total = at;
  return l;
}

}  // namespace

extern "C" {

// CTAs that can be co-resident on the current device (kCtasPerSm at most per
// SM); 0 if the query failed.
int auction_phase_max_ctas() {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, auction_phase_kernel, kThreads, 0) !=
      cudaSuccess)
    return 0;
  return sms * (per_sm < kCtasPerSm ? per_sm : kCtasPerSm);
}

// The default grid: co-resident, and no more CTAs than a first iteration of
// Tp bidders split at most ceil(M / kMinColsPerSplit) ways has units for.
int auction_phase_default_ctas(int Tp, int M, int max_ctas) {
  const long long units = (long long)Tp * ((M + kMinColsPerSplit - 1) / kMinColsPerSplit);
  const long long want = (units + kWarps - 1) / kWarps;
  return (int)(want < max_ctas ? (want > 0 ? want : 1) : max_ctas);
}

size_t auction_phase_workspace_bytes(int Tp, int M, int ctas) {
  return layout(Tp, M, ctas).total;
}

// price0, values, value_u, job_col (int32), active (uint8) in; price, owner
// (int32), assigned (int32), stats (2 int64) out; work holds
// auction_phase_workspace_bytes(Tp, M, ctas) bytes, 256-byte aligned.
// Launches on `stream`; returns a CUDA error code (0 = launched), and
// cudaErrorCooperativeLaunchTooLarge where the grid cannot be co-resident.
int auction_phase_launch(const void* price0, const void* values, const void* value_u,
                         const void* job_col, const void* active, void* price, void* owner,
                         void* assigned, void* stats, void* work, int Tp, int M, int S,
                         float eps, int max_iters, int ctas, void* stream) {
  if (Tp <= 0 || M <= 0 || S <= 0 || ctas <= 0 || !(eps > 0.0f) || (long long)M * S >= INT_MAX ||
      (long long)Tp * ((M + kMinColsPerSplit - 1) / kMinColsPerSplit) >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int max_ctas = auction_phase_max_ctas();
  if (ctas > max_ctas) return (int)cudaErrorCooperativeLaunchTooLarge;
  const Layout l = layout(Tp, M, ctas);
  char* w = (char*)work;
  Params p;
  p.price0 = (const float*)price0;
  p.values = (const float*)values;
  p.value_u = (const float*)value_u;
  p.job_col = (const int*)job_col;
  p.active = (const unsigned char*)active;
  p.price = (float*)price;
  p.owner = (int*)owner;
  p.assigned = (int*)assigned;
  p.stats = (long long*)stats;
  p.key = (unsigned long long*)(w + l.key);
  p.my_key = (unsigned long long*)(w + l.my_key);
  p.p1 = (float*)(w + l.p1);
  p.p2 = (float*)(w + l.p2);
  p.slot1 = (int*)(w + l.slot1);
  p.list = (int*)(w + l.list);
  p.bm_of = (int*)(w + l.bm_of);
  p.row_cnt = (int*)(w + l.row_cnt);
  p.part_best = (float*)(w + l.part_best);
  p.part_idx = (int*)(w + l.part_idx);
  p.part_second = (float*)(w + l.part_second);
  p.ctl = (unsigned*)(w + l.ctl);
  p.Tp = Tp;
  p.M = M;
  p.S = S;
  p.max_iters = max_iters;
  p.eps = eps;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(p.ctl, 0, 8 * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)auction_phase_kernel, dim3(ctas), dim3(kThreads),
                                    args, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* auction_phase_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
