// The fog-arrival planner's kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of fognetsimpp_tpu/ops/pallas_kernels.py:
//   fused_arrival_plan (body _arrival_plan_kernel, pallas_call at :175)
//   pairwise_rank      (body _rank_kernel,         pallas_call at :333)
// and computes what they compute, not tile for tile.  The TPU kernels
// compare every row of the window with every column (K x K work whatever
// the inputs); a first Hopper version did the same and took 0.23 ms on an
// empty 136,568-row window and about 10 ms on one with 86,103 masked rows.
// Here the work follows the masked rows: bucket them by fog, sort each
// bucket, and read each row's rank off its sorted position.
//
// A masked row i with time t and fog f gets the key
//   key = order(t) << L | i        (L bits hold any position of the window)
// where order() maps float32 bits to an unsigned integer of the same order,
// -0.0 first mapped to +0.0 (the plain version, the Pallas kernels and
// jnp.lexsort all hold the two zeros equal, so a +-0 tie goes by position).
// t_min is XLA's min, which orders -0.0 below +0.0: a fog whose earliest
// time is a zero gets -0.0 if any of its rows holds -0.0 (a flag a fog).
// Keys are unique, so they fix the (time, position) order with no tie
// left, and the rank of a row is the number of keys of its fog below its
// own.  Fog f goes to bucket f & (B - 1) with q = f >> log2(B); B is a power
// of two at least F (fused) or 2K up to 2,048 (pairwise_rank, which is not
// told F), so on the engine's windows q = 0 and a bucket is one fog.  A
// masked fog with q != 0 (any int32 key is taken) raises a flag, and then
// each bucket is ordered by (fog, key), which is (q, key) order, so the
// result stays exact.
//
// At most five launches a call, grids sized from K and B only (no host
// sync):
//   1. init:    zero the bucket counts and cursors (fused: per-fog tables);
//   2. pass:    rank = -1 on unmasked rows; per bucket, the count of masked
//               rows (fused: per fog the count and the 64-bit lex-min key),
//               warp-aggregated (__match_any_sync), then shared-memory and
//               one global integer atomic a block and bucket;
//   3. scatter: (fused: t_min and first from the lex-min keys) each block
//               scans the bucket counts into offsets itself; each key goes
//               to offset + a slot from a block-aggregated cursor (the order
//               inside a bucket is arbitrary: step 4 sorts it);
//   4. sort:    one block a run of up to kRun = 4,096 keys of a bucket of
//               more than kTiny = 32: a bucket of at most kDirect = 256 keys
//               is ranked in shared memory by direct count and done; a
//               larger one is sorted (cub::BlockRadixSort, 6-bit digits,
//               over the bits the run's keys span) and written back in
//               place;
//   5. rank:    each key of a tiny bucket: a direct count over the bucket;
//               each key of a sorted bucket: its position in its own run
//               plus, for every other run of the bucket, the number of keys
//               below it there (a binary search).
// Blocks with nothing to do exit at once, so an empty window costs its
// launches.  Only integer atomics; the result does not depend on the order
// of blocks.
//
// Contract: t is NaN-free (the engine's times are finite or +inf).
//
// What bounds it on the card: the function reads the mask (K B) and the
// fog and time keys of the 32-B sectors that hold a masked row (up to
// K * 8 B), and writes K * 4 B of rank (plus 12 B a fog): at K = 136,568
// and F = 64, about 1,776,000 B with 86,103 masked rows at random (0.53 us
// at 3.35 TB/s) and 683,608 B on an empty window (0.20 us).  A comparison
// sort of each fog's c_f masked rows needs sum c_f * ceil(log2 c_f)
// compares, 1.5e6 at 86,103 rows in one fog (0.02 us at 67 TFLOP/s), so
// bytes bound it; at K = 4,096 that is at most 53 KB, 0.016 us, far below
// one launch, and launches bound the call.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

namespace {

typedef unsigned long long u64;

constexpr int kRowThreads = 256;  // pass, scatter and rank: a row a thread
// Buckets the sort kernel counts directly, a key a thread: each thread's
// count walks the bucket, so past a key a thread the radix sort is faster
// (fognetsimpp_tpu_torch/tools/arrival_tiers.py times builds with other
// -DFNS_ARRIVAL_DIRECT; 32 sends every bucket to the radix sort).
#ifndef FNS_ARRIVAL_DIRECT
#define FNS_ARRIVAL_DIRECT 256
#endif
constexpr int kTiny = 32;  // buckets the rank kernel counts directly
constexpr int kDirect = FNS_ARRIVAL_DIRECT;
static_assert(kDirect >= kTiny, "the sort kernel takes buckets past kTiny");
constexpr int kSortThreads = 256;
constexpr int kSortItems = 16;
constexpr int kRadixBits = 6;  // digits a pass: 7 passes at a 40-bit span
constexpr int kRun = kSortThreads * kSortItems;  // keys a sorted run
constexpr int kMaxBucketBits = 11;
constexpr int kMaxBuckets = 1 << kMaxBucketBits;
constexpr int kMaxFogs = 1024;  // the fused kernel's per-fog tables
constexpr u64 kEmptyKey = ~0ull;

using RowScan = cub::BlockScan<int, kRowThreads>;
using SortKeys = cub::BlockRadixSort<u64, kSortThreads, kSortItems,
                                     cub::NullType, kRadixBits>;
using SortByKey = cub::BlockRadixSort<u64, kSortThreads, kSortItems, unsigned,
                                      kRadixBits>;
using SortByFog = cub::BlockRadixSort<unsigned, kSortThreads, kSortItems, u64,
                                      kRadixBits>;

__device__ __forceinline__ unsigned order_bits(float t) {
  unsigned u = __float_as_uint(t);
  if (u == 0x80000000u) u = 0u;  // -0.0 ranks as +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ u64 make_key(float t, int i, int L) {
  return (static_cast<u64>(order_bits(t)) << L) | static_cast<unsigned>(i);
}

// Scratch in one int32 buffer, B = 1 << b buckets:
//   [bcount B][cursor B][offsets B + 1][run_base B + 1][flag 1][fog K]
// where fog holds each bucketed key's fog (its bucket is fog & (B - 1)),
// and, for the fused kernel, [negz F] past them: a fog holds a -0.0.
struct Words {
  int *bcount, *cursor, *offsets, *run_base, *flag;
  unsigned* fog;
};

__host__ __device__ inline Words words_of(int* w, int B) {
  return {w, w + B, w + 2 * B, w + 3 * B + 1, w + 4 * B + 2,
          reinterpret_cast<unsigned*>(w + 4 * B + 3)};
}

// The last x in [0, n) with table[x] <= v (table ascending, table[0] <= v).
__device__ __forceinline__ int last_at_most(const int* table, int n, int v) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid] <= v) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// out[x] = sum of val(x') over x' < x, for x < n <= kMaxBuckets; returns
// the sum of all n.  Every thread of the block calls it.
template <typename Val>
__device__ int scan_buckets(int n, Val val, int* out,
                            typename RowScan::TempStorage& tmp) {
  constexpr int kPer = kMaxBuckets / kRowThreads;
  const int x0 = threadIdx.x * kPer;
  int v[kPer];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    v[k] = x0 + k < n ? val(x0 + k) : 0;
    sum += v[k];
  }
  int pre, total;
  RowScan(tmp).ExclusiveSum(sum, pre, total);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (x0 + k < n) out[x0 + k] = pre;
    pre += v[k];
  }
  __syncthreads();
  return total;
}

// Keys of a sorted run below (f, key): in (fog, key) order when use_q,
// else by key.  Within a bucket the fogs differ only in q = f >> b, so
// (fog, key) order is (q, key) order.
__device__ __forceinline__ int count_below(const u64* keys,
                                           const unsigned* fogs, int n,
                                           bool use_q, unsigned f, u64 key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    bool below;
    if (use_q) {
      const unsigned fm = fogs[mid];
      below = fm < f || (fm == f && keys[mid] < key);
    } else {
      below = keys[mid] < key;
    }
    if (below) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void arrival_init_kernel(int B, int F, int* __restrict__ words,
                                    int* __restrict__ counts,
                                    u64* __restrict__ fog_key,
                                    int* __restrict__ negz) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const Words w = words_of(words, B);
  if (x < B) {
    w.bcount[x] = 0;
    w.cursor[x] = 0;
  }
  if (x == 0) *w.flag = 0;
  if (counts != nullptr && x < F) {
    counts[x] = 0;
    fog_key[x] = kEmptyKey;
    negz[x] = 0;
  }
}

template <bool kFused>
__global__ void __launch_bounds__(kRowThreads) arrival_pass_kernel(
    const uint8_t* __restrict__ mask, const int* __restrict__ fkey,
    const float* __restrict__ tkey, int K, int F, int b, int L,
    int* __restrict__ rank, int* __restrict__ words, int* __restrict__ counts,
    u64* __restrict__ fog_key, int* __restrict__ negz) {
  __shared__ int s_bcnt[kMaxBuckets];
  __shared__ int s_fcnt[kFused ? kMaxFogs : 1];
  __shared__ u64 s_key[kFused ? kMaxFogs : 1];

  const int B = 1 << b;
  const Words w = words_of(words, B);
  const int i = blockIdx.x * kRowThreads + threadIdx.x;
  const bool m = i < K && mask[i] != 0;
  if (i < K && !m) rank[i] = -1;
  if (!__syncthreads_or(m)) return;

  for (int x = threadIdx.x; x < B; x += kRowThreads) s_bcnt[x] = 0;
  if constexpr (kFused) {
    for (int x = threadIdx.x; x < F; x += kRowThreads) {
      s_fcnt[x] = 0;
      s_key[x] = kEmptyKey;
    }
  }
  __syncthreads();

  const unsigned f = m ? static_cast<unsigned>(fkey[i]) : 0u;
  // lanes of one fog (masked) form a group; unmasked lanes another
  const unsigned peers =
      __match_any_sync(0xffffffffu, m ? static_cast<u64>(f) : (1ull << 32));
  if (m) {
    const unsigned lane = threadIdx.x & 31;
    const float t = tkey[i];
    if constexpr (kFused) {
      if (__float_as_uint(t) == 0x80000000u && f < static_cast<unsigned>(F)) {
        atomicOr(&negz[f], 1);
      }
    }
    const u64 k = make_key(t, i, L);
    const unsigned hi = static_cast<unsigned>(k >> 32);
    const unsigned lo = static_cast<unsigned>(k);
    const unsigned min_hi = __reduce_min_sync(peers, hi);
    const unsigned min_lo = __reduce_min_sync(peers, hi == min_hi ? lo : ~0u);
    if (lane == static_cast<unsigned>(__ffs(peers) - 1)) {
      const int n = __popc(peers);
      atomicAdd(&s_bcnt[f & (B - 1)], n);
      if (f >> b) atomicOr(w.flag, 1);
      if constexpr (kFused) {
        if (f < static_cast<unsigned>(F)) {
          atomicAdd(&s_fcnt[f], n);
          atomicMin(&s_key[f], (static_cast<u64>(min_hi) << 32) | min_lo);
        }
      }
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < B; x += kRowThreads) {
    if (s_bcnt[x]) atomicAdd(&w.bcount[x], s_bcnt[x]);
  }
  if constexpr (kFused) {
    for (int x = threadIdx.x; x < F; x += kRowThreads) {
      if (s_fcnt[x]) {
        atomicAdd(&counts[x], s_fcnt[x]);
        atomicMin(&fog_key[x], s_key[x]);
      }
    }
  }
}

template <bool kFused>
__global__ void __launch_bounds__(kRowThreads) arrival_scatter_kernel(
    const uint8_t* __restrict__ mask, const int* __restrict__ fkey,
    const float* __restrict__ tkey, int K, int F, int b, int L,
    int* __restrict__ words, u64* __restrict__ skey,
    const u64* __restrict__ fog_key, const int* __restrict__ negz,
    float* __restrict__ t_min, int* __restrict__ first) {
  __shared__ int s_off[kMaxBuckets];
  __shared__ int s_cur[kMaxBuckets];
  __shared__ typename RowScan::TempStorage s_scan;

  const int B = 1 << b;
  const Words w = words_of(words, B);
  const int i = blockIdx.x * kRowThreads + threadIdx.x;
  if constexpr (kFused) {
    // (t_min, first) of each fog; an untouched key is an empty fog, +inf
    // and K (the Pallas kernel's contract)
    if (i < F) {
      const u64 k = fog_key[i];
      if (k == kEmptyKey) {
        t_min[i] = __int_as_float(0x7f800000);
        first[i] = K;
      } else {
        const int pos = static_cast<int>(k & ((1ull << L) - 1));
        const float t = tkey[pos];
        t_min[i] = t == 0.0f && negz[i] ? -0.0f : t;
        first[i] = pos;
      }
    }
  }
  const bool m = i < K && mask[i] != 0;
  const bool active = __syncthreads_or(m);
  if (!active && blockIdx.x != 0) return;

  const int* bcount = w.bcount;
  const int n_masked =
      scan_buckets(B, [=](int x) { return bcount[x]; }, s_off, s_scan);
  if (blockIdx.x == 0) {
    // the bucket offsets and each bucket's first run, for launches 4 and 5
    for (int x = threadIdx.x; x < B; x += kRowThreads) w.offsets[x] = s_off[x];
    const int n_runs = scan_buckets(
        B,
        [=](int x) {
          return bcount[x] > kTiny ? (bcount[x] + kRun - 1) / kRun : 0;
        },
        w.run_base, s_scan);
    if (threadIdx.x == 0) {
      w.offsets[B] = n_masked;
      w.run_base[B] = n_runs;
    }
  }
  if (!active) return;

  for (int x = threadIdx.x; x < B; x += kRowThreads) s_cur[x] = 0;
  __syncthreads();
  const unsigned f = m ? static_cast<unsigned>(fkey[i]) : 0u;
  const unsigned bkt = f & (B - 1);
  const unsigned peers =
      __match_any_sync(0xffffffffu, m ? static_cast<u64>(f) : (1ull << 32));
  int local = 0;
  if (m) {
    const unsigned lane = threadIdx.x & 31;
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (lane == static_cast<unsigned>(leader)) {
      base = atomicAdd(&s_cur[bkt], __popc(peers));
    }
    base = __shfl_sync(peers, base, leader);
    local = base + __popc(peers & ((1u << lane) - 1));
  }
  __syncthreads();
  // this block's share of each bucket, taken from the bucket's cursor
  for (int x = threadIdx.x; x < B; x += kRowThreads) {
    if (s_cur[x]) s_cur[x] = atomicAdd(&w.cursor[x], s_cur[x]);
  }
  __syncthreads();
  if (m) {
    const int pos = s_off[bkt] + s_cur[bkt] + local;
    skey[pos] = make_key(tkey[i], i, L);
    w.fog[pos] = f;
  }
}

union SortShared {
  SortKeys::TempStorage keys;
  SortByKey::TempStorage by_key;
  SortByFog::TempStorage by_fog;
  struct {
    u64 key[kDirect];
    unsigned fog[kDirect];
  } small;
};

__device__ __forceinline__ u64 warp_min(u64 v) {
  for (int d = 16; d; d >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

__device__ __forceinline__ u64 warp_max(u64 v) {
  for (int d = 16; d; d >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

// One block a run of a bucket of more than kTiny keys.
__global__ void __launch_bounds__(kSortThreads) arrival_sort_kernel(
    int b, int L, int* __restrict__ words, u64* __restrict__ skey,
    int* __restrict__ rank) {
  __shared__ SortShared s;
  __shared__ int s_runs[kMaxBuckets + 1];
  __shared__ u64 s_lo, s_hi;

  const int B = 1 << b;
  const Words w = words_of(words, B);
  const int r = blockIdx.x;
  if (r >= w.run_base[B]) return;
  const int t = threadIdx.x;
  for (int x = t; x <= B; x += kSortThreads) s_runs[x] = w.run_base[x];
  if (t == 0) {
    s_lo = kEmptyKey;
    s_hi = 0;
  }
  __syncthreads();
  const int x = last_at_most(s_runs, B, r);
  const int off = w.offsets[x];
  const int c = w.offsets[x + 1] - off;
  const int j = r - s_runs[x];
  const int start = off + j * kRun;
  const int n = min(kRun, c - j * kRun);
  const bool use_q = *w.flag != 0;

  if (c <= kDirect) {
    // a small bucket: each key counts the keys of its fog below it
    for (int y = t; y < n; y += kSortThreads) {
      s.small.key[y] = skey[start + y];
      s.small.fog[y] = w.fog[start + y];
    }
    __syncthreads();
    for (int y0 = t; y0 < n; y0 += kSortThreads) {
      const u64 k = s.small.key[y0];
      const unsigned f = s.small.fog[y0];
      int cnt = 0;
      for (int y = 0; y < n; ++y) {
        cnt += (s.small.fog[y] == f && s.small.key[y] < k) ? 1 : 0;
      }
      rank[static_cast<int>(k & ((1ull << L) - 1))] = cnt;
    }
    return;
  }

  u64 keys[kSortItems];
  unsigned fogs[kSortItems];
  u64 lo = kEmptyKey, hi = 0;
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    const int p = k * kSortThreads + t;  // striped: coalesced loads
    keys[k] = p < n ? skey[start + p] : kEmptyKey;
    fogs[k] = p < n ? w.fog[start + p] : ~0u;
    if (p < n) {
      lo = min(lo, keys[k]);
      hi = max(hi, keys[k]);
    }
  }
  lo = warp_min(lo);
  hi = warp_max(hi);
  if ((t & 31) == 0) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();
  // sort key - min over the bits the run's keys span, plus one bit that
  // is clear on every key and set on the padding (all ones)
  lo = s_lo;
  const int bits = min(64, 65 - __clzll(s_hi - lo));
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    if (keys[k] != kEmptyKey) keys[k] -= lo;
  }
  if (use_q) {
    // (fog, key) order: by key, then stably by fog
    SortByKey(s.by_key).Sort(keys, fogs, 0, bits);
    __syncthreads();
    SortByFog(s.by_fog).SortBlockedToStriped(fogs, keys, 0, 32);
  } else {
    SortKeys(s.keys).SortBlockedToStriped(keys, 0, bits);
  }
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    const int p = k * kSortThreads + t;
    if (p < n) {
      skey[start + p] = keys[k] + lo;
      if (use_q) w.fog[start + p] = fogs[k];
    }
  }
}

__global__ void __launch_bounds__(kRowThreads) arrival_rank_kernel(
    int b, int L, const int* __restrict__ words, const u64* __restrict__ skey,
    int* __restrict__ rank) {
  const int B = 1 << b;
  const Words w = words_of(const_cast<int*>(words), B);
  const int p = blockIdx.x * kRowThreads + threadIdx.x;
  if (p >= w.offsets[B]) return;
  const unsigned f = w.fog[p];
  const int x = f & (B - 1);
  const int off = w.offsets[x];
  const int c = w.offsets[x + 1] - off;
  const u64 k = skey[p];
  int cnt = 0;
  if (c <= kTiny) {
    // a tiny bucket, not sorted: count the keys of its fog below this one
    for (int y = off; y < off + c; ++y) {
      cnt += (w.fog[y] == f && skey[y] < k) ? 1 : 0;
    }
  } else if (c <= kDirect) {
    return;  // ranked by the sort kernel
  } else {
    const bool use_q = *w.flag != 0;
    const int j = (p - off) / kRun;
    const int run0 = off + j * kRun;
    // below it in its own run: its position, less the keys of lower fogs
    cnt = p - run0;
    if (use_q) cnt -= count_below(skey + run0, w.fog + run0, p - run0, true, f, 0);
    const int n_runs = (c + kRun - 1) / kRun;
    for (int s = 0; s < n_runs; ++s) {
      if (s == j) continue;
      const int s0 = off + s * kRun;
      const int n = min(kRun, c - s * kRun);
      cnt += count_below(skey + s0, w.fog + s0, n, use_q, f, k);
      if (use_q) cnt -= count_below(skey + s0, w.fog + s0, n, true, f, 0);
    }
  }
  rank[static_cast<int>(k & ((1ull << L) - 1))] = cnt;
}

int blocks_of(int n, int per) { return (n + per - 1) / per; }

int key_bits(int K) {
  int L = 1;
  while (L < 31 && (1 << L) < K) ++L;
  return L;
}

// The launches on `stream` (at most five); returns the first nonzero
// cudaGetLastError(), else 0.
template <bool kFused>
int launch_plan(const void* mask, const void* fkey, const void* tkey, int K,
                int F, int b, void* rank, void* counts, void* t_min,
                void* first, void* words, void* keys, void* stream) {
  if (K < 0 || b < 1 || b > kMaxBucketBits ||
      (kFused && (F < 1 || F > kMaxFogs))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int B = 1 << b;
  const int L = key_bits(K);
  auto* m = static_cast<const uint8_t*>(mask);
  auto* fk = static_cast<const int*>(fkey);
  auto* tk = static_cast<const float*>(tkey);
  auto* rank_i = static_cast<int*>(rank);
  auto* w = static_cast<int*>(words);
  auto* skey = static_cast<u64*>(keys);
  u64* fog_key = kFused ? skey + K : nullptr;
  int* negz = kFused ? w + 4 * B + 3 + K : nullptr;
  auto* counts_i = static_cast<int*>(counts);

  arrival_init_kernel<<<blocks_of(B > F ? B : F, 256), 256, 0, st>>>(
      B, kFused ? F : 0, w, kFused ? counts_i : nullptr, fog_key, negz);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_blocks = blocks_of(K, kRowThreads);
  if (K > 0) {
    arrival_pass_kernel<kFused><<<row_blocks, kRowThreads, 0, st>>>(
        m, fk, tk, K, F, b, L, rank_i, w, counts_i, fog_key, negz);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int scatter_blocks = kFused && blocks_of(F, kRowThreads) > row_blocks
                                 ? blocks_of(F, kRowThreads)
                                 : (row_blocks > 0 ? row_blocks : 1);
  arrival_scatter_kernel<kFused><<<scatter_blocks, kRowThreads, 0, st>>>(
      m, fk, tk, K, F, b, L, w, skey, fog_key, negz,
      static_cast<float*>(t_min), static_cast<int*>(first));
  err = cudaGetLastError();
  if (err != cudaSuccess || K == 0) return static_cast<int>(err);
  // at most floor(K / kRun) full runs plus one run a bucket of more than
  // kTiny keys
  const int sort_blocks = K / kRun + (B < K / (kTiny + 1) ? B : K / (kTiny + 1));
  if (sort_blocks > 0) {
    arrival_sort_kernel<<<sort_blocks, kSortThreads, 0, st>>>(b, L, w, skey,
                                                              rank_i);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  arrival_rank_kernel<<<row_blocks, kRowThreads, 0, st>>>(b, L, w, skey,
                                                          rank_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Writes rank (K,), counts (F,), t_min (F,) and first (F,), F <= 1,024;
// B = 1 << bucket_bits buckets.  Scratch: words, int32 (4B + 3 + K + F,);
// keys, int64 (K + F,).
extern "C" int fns_fused_arrival_plan(const void* mask, const void* fkey,
                                      const void* tkey, int K, int F,
                                      int bucket_bits, void* rank,
                                      void* counts, void* t_min, void* first,
                                      void* words, void* keys, void* stream) {
  return launch_plan<true>(mask, fkey, tkey, K, F, bucket_bits, rank, counts,
                           t_min, first, words, keys, stream);
}

// Writes rank (K,).  Scratch: words, int32 (4B + 3 + K,); keys, int64 (K,).
extern "C" int fns_pairwise_rank(const void* mask, const void* fkey,
                                 const void* tkey, int K, int bucket_bits,
                                 void* rank, void* words, void* keys,
                                 void* stream) {
  return launch_plan<false>(mask, fkey, tkey, K, 0, bucket_bits, rank,
                            nullptr, nullptr, nullptr, words, keys, stream);
}
