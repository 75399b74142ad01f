// The ordered per-cell float32 sum for Hopper (sm_90a).
//
// No TPU kernel stands behind it.  The wireless tick sums each 802.11
// cell's offered load, a float32 scatter-add of N per-node rates into A
// cells (fognetsimpp_tpu/net/topology.py:191-195,
// `zeros(A + 1).at[cell].add(rate, mode="drop")[:A]`).  XLA on the CPU
// adds the entries of a cell one by one in index order, and float32
// addition does not associate, so that order is part of the result; an
// atomic scatter-add on the card adds in no fixed order.  This kernel
// adds in index order: out[c] = (((+0.0 + v_i0) + v_i1) + ...) over the
// entries i0 < i1 < ... whose cell is c, each add rounded, so an empty
// cell and a cell of only -0.0 give +0.0.
//
// Domain: cell >= 0.  Entries whose cell lies outside [0, n_cells) are
// dropped, negative cells included.  XLA's `.at[]` wraps a negative index
// as NumPy does: in the (A + 1)-slot helper above, cell -1 lands in the
// spare slot A (dropped by the slice), cells -2 .. -(A + 1) land in cells
// A - 1 .. 0 and are added, and cells below -(A + 1) are dropped.  The
// wireless tick never passes a negative cell (`associate` passes
// where(on_air, assoc, A)), so the two agree on every cell it passes.
//
// The adds of a cell form one dependent chain, so one thread adds a cell;
// the work lies in finding each cell's entries in index order.  Two
// tiers, each its own entry point; the wrapper (ops/cell_kernels.py)
// picks one from N, A and the card's block slots, with no sync:
//
// one block a cell (fns_cell_sum_one_block; where a block slot of the
// card walks few tiles: ceil(A / slots) * ceil(N / kTile) at
// most the wrapper's measured limit, as at the wireless tick, N = 10,069,
// A = 64): one launch of A blocks.  Each block walks all N entries in
// tiles of kTile, compacts its cell's entries into shared memory in index
// order (a block scan of the threads' match counts), and one thread adds
// them.  Work A * N, but one launch and no scratch: the faster tier where
// A * N is small.
//
// segments (fns_cell_sum_segments; the rest, such as config 4's 128
// replicas flattened, N = 1,288,832, A = 8,192): the work follows the
// entries, O(N + A), each entry read by one block; four launches, scratch
// from the wrapper:
//   1. init:    zero the per-cell counts and the done-ticket;
//   2. count:   a block of kCountTile entries counts them by cell in a
//               shared hash table (warp-aggregated), then takes each
//               cell's share of its segment with one global integer
//               atomic; each entry's slot in its segment (arbitrary order)
//               goes to scratch.  The last block to finish (the ticket)
//               scans the counts into each cell's offset and lists the
//               cells of more than kWarpCap entries;
//   3. scatter: each kept entry's index goes to its segment at its slot;
//   4. order:   a warp a cell of at most kWarpCap entries: a bitonic sort
//               of the segment's indices in registers, across lanes by
//               shuffles (the indices are distinct, so any sort restores
//               index order), the values gathered in that order into
//               shared memory, one lane adds.  A block a listed cell,
//               ahead of them (the grid holds N / (kWarpCap + 1) such
//               blocks, those past the list exit): each run of kRun
//               indices radix-sorted in place (cub::BlockRadixSort), each
//               index ranked across the runs (its place in its run plus a
//               binary search in each other run), then the values gathered
//               tile by tile in that order and added by one thread.
// Only integer atomics, and the result does not depend on the order of
// blocks or of the atomics.
//
// What bounds it on the card: the bytes, N * 8 read and A * 4 written
// (80,808 B at the wireless tick, 0.024 us at 3.35 TB/s; 10,343,424 B at
// 128 replicas, 3.09 us), and the chain of the largest cell at about 4
// cycles an add (321 entries at the wireless tick, about 0.65 us at
// 1.98 GHz).  Each launch returns cudaGetLastError() on the host, which
// the wrapper raises on.
#include <climits>
#include <cstddef>

#include <cuda_runtime.h>

#include <cub/block/block_radix_sort.cuh>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// the segments tier
constexpr int kCountItems = 16;  // entries a thread of the count
constexpr int kCountTile = kThreads * kCountItems;
constexpr int kHash = 2 * kCountTile;  // slots: at most half full
constexpr int kHashBits = 13;
static_assert(kHash == 1 << kHashBits, "hash size");
constexpr size_t kCountSmem = 2 * kHash * sizeof(int);
constexpr int kScanItems = 16;
constexpr int kWarpCap = 1024;  // segments a warp sorts
static_assert(kWarpCap == 32 * 32, "the widest warp sort");
constexpr int kItems = 16;
constexpr int kOrderMinBlocks = 3;  // 80 registers: three blocks an SM
constexpr int kRun = kThreads * kItems;  // indices of a radix-sorted run
constexpr int kRadixBits = 6;

using RunSort =
    cub::BlockRadixSort<unsigned, kThreads, kItems, cub::NullType, kRadixBits>;

// Exclusive scan of one int a thread, in thread order; every thread of the
// block calls it.  Returns the thread's prefix and sets *total.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  constexpr int kW = kWarps;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kW ? warp_sums[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += y;
    }
    if (lane < kW) warp_sums[lane] = wi - w;
    if (lane == 31) warp_sums[kW] = wi;
  }
  __syncthreads();
  const int pre = warp_sums[warp] + incl - v;
  *total = warp_sums[kW];
  __syncthreads();  // warp_sums is rewritten by the next call
  return pre;
}

// The lanes of the warp whose key equals this lane's, for keys below
// 2^bits: one ballot a bit (__match_any_sync gives the same, and issued
// slower here).
__device__ __forceinline__ unsigned match_key(unsigned key, int bits) {
  unsigned peers = kFull;
  for (int b = 0; b < bits; ++b) {
    const bool on = (key >> b) & 1u;
    const unsigned set = __ballot_sync(kFull, on);
    peers &= on ? set : ~set;
  }
  return peers;
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// The chain (((acc + s[b]) + s[b + 1]) + ...) over s[b, e), s 16-byte
// aligned.  Eight values are loaded ahead of their adds, so the shared
// loads overlap the dependent adds.
__device__ float chain_add(float acc, const float* s, int b, int e) {
  int j = b;
  for (; j < e && (j & 3); ++j) acc += s[j];
  if (e - j >= 8) {
    float4 p0 = *reinterpret_cast<const float4*>(s + j);
    float4 p1 = *reinterpret_cast<const float4*>(s + j + 4);
    for (j += 8; e - j >= 8; j += 8) {
      const float4 q0 = *reinterpret_cast<const float4*>(s + j);
      const float4 q1 = *reinterpret_cast<const float4*>(s + j + 4);
      acc += p0.x; acc += p0.y; acc += p0.z; acc += p0.w;
      acc += p1.x; acc += p1.y; acc += p1.z; acc += p1.w;
      p0 = q0;
      p1 = q1;
    }
    acc += p0.x; acc += p0.y; acc += p0.z; acc += p0.w;
    acc += p1.x; acc += p1.y; acc += p1.z; acc += p1.w;
  }
  for (; j < e; ++j) acc += s[j];
  return acc;
}

// ---- one block a cell ----------------------------------------------------

constexpr int kBlockThreads = 1024;
constexpr int kBlockItems = 4;  // consecutive entries a thread
constexpr int kTile = kBlockThreads * kBlockItems;
constexpr int kBlockWarps = kBlockThreads / 32;
static_assert(kBlockWarps == 32, "the second scan level is one warp");

// Block c walks the n entries tile by tile, compacts the tile's entries of
// cell c into shared memory in index order, and thread 0 adds them.
__global__ void __launch_bounds__(kBlockThreads)
    cell_sum_kernel(const int* __restrict__ cell,
                    const float* __restrict__ vals, int n,
                    float* __restrict__ out) {
  __shared__ float list[kTile];
  __shared__ int warp_off[kBlockWarps];
  __shared__ int tile_total;
  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float acc = 0.0f;  // thread 0's running sum
  for (int base = 0; base < n; base += kTile) {
    const int i0 = base + threadIdx.x * kBlockItems;
    float v[kBlockItems];
    bool m[kBlockItems];
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < kBlockItems; ++k) {
      const int i = i0 + k;
      m[k] = i < n && cell[i] == c;
      v[k] = m[k] ? vals[i] : 0.0f;
      cnt += m[k];
    }
    // exclusive scan of the threads' counts, in thread (= index) order
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_off[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = warp_off[lane];
      int wi = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, wi, o);
        if (lane >= o) wi += y;
      }
      warp_off[lane] = wi - w;
      if (lane == 31) tile_total = wi;
    }
    __syncthreads();
    int off = warp_off[warp] + incl - cnt;
#pragma unroll
    for (int k = 0; k < kBlockItems; ++k) {
      if (m[k]) list[off++] = v[k];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int total = tile_total;
      for (int j = 0; j < total; ++j) acc += list[j];
    }
    __syncthreads();  // list and warp_off are rewritten by the next tile
  }
  if (threadIdx.x == 0) out[c] = acc;
}

// ---- the segments tier ---------------------------------------------------

// Cells a call can hold of more than kWarpCap entries.
__host__ __device__ inline int max_large(int n) { return n / (kWarpCap + 1); }

// Scratch in one int32 buffer, L = max_large(n):
//   [cursor A][offset A + 1][done 1][n_large 1][large L][seg n][ord n]
// cursor holds the counts; offset each cell's first slot in seg; large
// lists the cells of more than kWarpCap entries; seg holds the entries'
// indices by cell; ord holds each entry's slot in its segment (count to
// scatter), then a large segment's indices in index order (order).
struct Scratch {
  int *cursor, *offset, *done, *n_large, *large, *seg, *ord;
};

__host__ __device__ inline Scratch scratch_of(int* w, int A, int n) {
  const size_t a = static_cast<size_t>(A);
  const size_t l = static_cast<size_t>(max_large(n));
  const size_t m = static_cast<size_t>(n);
  int* seg = w + 2 * a + 3 + l;
  return {w, w + a, w + 2 * a + 1, w + 2 * a + 2, w + 2 * a + 3, seg, seg + m};
}

__global__ void cell_sum_init_kernel(int* words, int A, int n) {
  const Scratch s = scratch_of(words, A, n);
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x < A) s.cursor[x] = 0;
  if (x == 0) *s.done = 0;
}

// The entry's cell, or A where it is dropped.
__device__ __forceinline__ unsigned key_of(const int* cell, int i, int n,
                                           int A) {
  const int c = i < n ? cell[i] : -1;
  return c >= 0 && c < A ? c : A;
}

// The slot of key in the block's hash table, inserted if new.
__device__ __forceinline__ int hash_slot(int* keys, unsigned key) {
  unsigned h = (key * 2654435761u) >> (32 - kHashBits);
  while (true) {
    const int prev = atomicCAS(&keys[h], -1, static_cast<int>(key));
    if (prev == -1 || prev == static_cast<int>(key)) return static_cast<int>(h);
    h = (h + 1) & (kHash - 1);
  }
}

__global__ void __launch_bounds__(kThreads)
    cell_sum_count_kernel(const int* __restrict__ cell, int n, int A, int bits,
                          int* words) {
  extern __shared__ int h_key[];  // [kHash] cells, then [kHash] counts
  int* h_cnt = h_key + kHash;     // the block's count a cell, then its base
  __shared__ int warp_sums[kWarps + 1];
  __shared__ int s_large;
  __shared__ bool s_last;
  const Scratch s = scratch_of(words, A, n);
  const int lane = threadIdx.x & 31;
  const int i0 = blockIdx.x * kCountTile + threadIdx.x;
  unsigned key[kCountItems];
#pragma unroll
  for (int k = 0; k < kCountItems; ++k) {
    key[k] = key_of(cell, i0 + k * kThreads, n, A);
  }
  for (int x = threadIdx.x; x < kHash; x += kThreads) {
    h_key[x] = -1;
    h_cnt[x] = 0;
  }
  __syncthreads();
  int h[kCountItems];      // the entry's cell's slot in the hash table
  int local[kCountItems];  // its place among the block's entries of the cell
#pragma unroll
  for (int k = 0; k < kCountItems; ++k) {
    const bool kept = key[k] < static_cast<unsigned>(A);
    const unsigned peers = match_key(key[k], bits);
    const int leader = __ffs(peers) - 1;
    int hk = 0;
    int lk = 0;
    if (kept && lane == leader) {
      hk = hash_slot(h_key, key[k]);
      lk = atomicAdd(&h_cnt[hk], __popc(peers));
    }
    h[k] = __shfl_sync(kFull, hk, leader);
    local[k] = __shfl_sync(kFull, lk, leader) + __popc(peers & lanes_below());
  }
  __syncthreads();
  // the block's share of each of its cells' segments: one atomic a cell
  for (int x = threadIdx.x; x < kHash; x += kThreads) {
    if (h_key[x] != -1) h_cnt[x] = atomicAdd(&s.cursor[h_key[x]], h_cnt[x]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kCountItems; ++k) {
    if (key[k] < static_cast<unsigned>(A)) {
      s.ord[i0 + k * kThreads] = h_cnt[h[k]] + local[k];
    }
  }

  // the last block to finish scans the counts
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(s.done, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (threadIdx.x == 0) s_large = 0;
  int carry = 0;
  for (int base = 0; base < A; base += kThreads * kScanItems) {
    const int x0 = base + threadIdx.x * kScanItems;
    int v[kScanItems];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      v[k] = x0 + k < A ? __ldcg(&s.cursor[x0 + k]) : 0;
      sum += v[k];
    }
    int total;
    int pre = carry + block_exclusive_scan(sum, warp_sums, &total);
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      if (x0 + k < A) {
        s.offset[x0 + k] = pre;
        if (v[k] > kWarpCap) s.large[atomicAdd(&s_large, 1)] = x0 + k;
      }
      pre += v[k];
    }
    carry += total;
  }
  __syncthreads();  // every large cell listed
  if (threadIdx.x == 0) {
    s.offset[A] = carry;
    *s.n_large = s_large;
  }
}

__global__ void __launch_bounds__(kThreads)
    cell_sum_scatter_kernel(const int* __restrict__ cell, int n, int A,
                            int* words) {
  const Scratch s = scratch_of(words, A, n);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const unsigned key = key_of(cell, i, n, A);
  if (key < static_cast<unsigned>(A)) s.seg[s.offset[key] + s.ord[i]] = i;
}

union alignas(16) OrderShared {
  float warp_buf[kWarps][kWarpCap];
  RunSort::TempStorage sort;
  float run_val[kRun];
};

// Bitonic sort of the warp's 32 * J keys, lane l holding keys l * J ..
// l * J + J - 1: partners J or more apart trade by shuffle, nearer ones
// within the lane.  Every loop is unrolled, so the keys stay in registers.
template <int J>
__device__ __forceinline__ void warp_sort(int (&x)[J]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32 * J; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= J) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int e = lane * J + j;
          const int y = __shfl_xor_sync(kFull, x[j], stride / J);
          const bool up = (e & size) == 0;
          const bool lower = (e & stride) == 0;
          x[j] = lower == up ? min(x[j], y) : max(x[j], y);
        }
      } else {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if ((j & stride) == 0) {
            const bool up = ((lane * J + j) & size) == 0;
            const int a = x[j];
            const int b = x[j + stride];
            x[j] = up ? min(a, b) : max(a, b);
            x[j + stride] = up ? max(a, b) : min(a, b);
          }
        }
      }
    }
  }
}

// One warp, m <= 32 * J: the indices of seg sorted, their values gathered
// in that order into buf and added by lane 0 into *out_c.
template <int J>
__device__ void warp_order_and_add_j(const int* seg, int m,
                                     const float* __restrict__ vals,
                                     float* buf, float* out_c) {
  const int lane = threadIdx.x & 31;
  int x[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int e = lane * J + j;
    x[j] = e < m ? seg[e] : INT_MAX;
  }
  warp_sort<J>(x);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int e = lane * J + j;
    if (e < m) buf[e] = vals[x[j]];
  }
  __syncwarp();
  if (lane == 0) *out_c = chain_add(0.0f, buf, 0, m);
}

// One warp: the m <= kWarpCap indices of seg, sorted (the indices are
// distinct, so the sort restores index order), their values added in that
// order into *out_c.
__device__ void warp_order_and_add(const int* seg, int m,
                                   const float* __restrict__ vals, float* buf,
                                   float* out_c) {
  if (m <= 32) {
    warp_order_and_add_j<1>(seg, m, vals, buf, out_c);
  } else if (m <= 64) {
    warp_order_and_add_j<2>(seg, m, vals, buf, out_c);
  } else if (m <= 128) {
    warp_order_and_add_j<4>(seg, m, vals, buf, out_c);
  } else if (m <= 256) {
    warp_order_and_add_j<8>(seg, m, vals, buf, out_c);
  } else if (m <= 512) {
    warp_order_and_add_j<16>(seg, m, vals, buf, out_c);
  } else {
    warp_order_and_add_j<32>(seg, m, vals, buf, out_c);
  }
}

// Keys of the ascending a[0, n) below key.
__device__ __forceinline__ int count_below(const int* a, int n, int key) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The whole block: the m > kWarpCap indices of seg (sorted in place, run
// by run), ranked into ord, their values added in order into *out_c.
__device__ void block_order_and_add(int* seg, int* ord, int m, int index_bits,
                                    const float* __restrict__ vals,
                                    OrderShared& sh, float* out_c) {
  const int t = threadIdx.x;
  const int n_runs = (m + kRun - 1) / kRun;
  const unsigned pad = 1u << index_bits;  // above every index
  for (int r = 0; r < n_runs; ++r) {
    int* run = seg + r * kRun;
    const int len = min(kRun, m - r * kRun);
    unsigned keys[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int p = k * kThreads + t;
      keys[k] = p < len ? static_cast<unsigned>(run[p]) : pad;
    }
    RunSort(sh.sort).SortBlockedToStriped(keys, 0, index_bits + 1);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int p = k * kThreads + t;
      if (p < len) run[p] = static_cast<int>(keys[k]);
    }
    __syncthreads();  // sh.sort is reused; the run is read below
  }
  const int* src = seg;
  if (n_runs > 1) {
    for (int p = t; p < m; p += kThreads) {
      const int r = p / kRun;
      const int key = seg[p];
      int pos = p - r * kRun;
      for (int o = 0; o < n_runs; ++o) {
        if (o != r) pos += count_below(seg + o * kRun, min(kRun, m - o * kRun), key);
      }
      ord[pos] = key;
    }
    __syncthreads();
    src = ord;
  }
  float acc = 0.0f;  // thread 0's
  for (int base = 0; base < m; base += kRun) {
    const int len = min(kRun, m - base);
    for (int q = t; q < len; q += kThreads) sh.run_val[q] = vals[src[base + q]];
    __syncthreads();
    if (t == 0) acc = chain_add(acc, sh.run_val, 0, len);
    __syncthreads();
  }
  if (t == 0) *out_c = acc;
}

__global__ void __launch_bounds__(kThreads, kOrderMinBlocks)
    cell_sum_order_kernel(const float* __restrict__ vals, int n, int A,
                          int index_bits, int* words, float* __restrict__ out) {
  __shared__ OrderShared sh;
  const Scratch s = scratch_of(words, A, n);
  // the first max_large(n) blocks: a listed cell each, if there is one
  const int n_big = max_large(n);
  if (static_cast<int>(blockIdx.x) < n_big) {
    if (static_cast<int>(blockIdx.x) >= *s.n_large) return;
    const int c = s.large[blockIdx.x];
    const int off = s.offset[c];
    block_order_and_add(s.seg + off, s.ord + off, s.offset[c + 1] - off,
                        index_bits, vals, sh, out + c);
    return;
  }
  // the rest: a warp a cell
  const int warp = threadIdx.x >> 5;
  const int c = (blockIdx.x - n_big) * kWarps + warp;
  if (c >= A) return;
  const int off = s.offset[c];
  const int m = s.offset[c + 1] - off;
  if (m <= kWarpCap) {
    warp_order_and_add(s.seg + off, m, vals, sh.warp_buf[warp], out + c);
  }
}

int blocks_of(int n, int per) {
  return static_cast<int>((static_cast<long long>(n) + per - 1) / per);
}

// The least b >= 1 with 2^b >= n: every index below n fits b bits.
int bits_below(int n) {
  int b = 1;
  while (b < 31 && (1 << b) < n) ++b;
  return b;
}

}  // namespace

// Blocks of fns_cell_sum_one_block the card `device` holds at once (its
// SMs times the kernel's blocks an SM), or minus a cudaError_t.  Host-side
// queries only: no sync.
extern "C" int fns_cell_sum_one_block_slots(int device) {
  int sms = 0;
  int per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cell_sum_kernel, kBlockThreads, 0);
  }
  return err == cudaSuccess ? sms * per_sm : -static_cast<int>(err);
}

// cell: (n,) int32 cell of each entry; vals: (n,) float32; out: (n_cells,)
// float32, every cell written.  One launch on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int fns_cell_sum_one_block(const void* cell, const void* vals,
                                      int n, int n_cells, void* out,
                                      void* stream) {
  if (n_cells <= 0) return 0;
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cell_sum_kernel<<<n_cells, kBlockThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cell), static_cast<const float*>(vals), n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// int32 words of scratch fns_cell_sum_segments needs for n entries and
// n_cells cells.
extern "C" long long fns_cell_sum_words(int n, int n_cells) {
  if (n_cells <= 0) return 0;
  return 2LL * n_cells + 3 + max_large(n) + 2LL * n;
}

// As fns_cell_sum_one_block, with words: fns_cell_sum_words(n, n_cells)
// int32 of scratch.  Four launches on `stream`; returns the first nonzero
// cudaGetLastError() (0 on success).
extern "C" int fns_cell_sum_segments(const void* cell, const void* vals,
                                     int n, int n_cells, void* out,
                                     void* words, void* stream) {
  if (n_cells <= 0) return 0;
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<const int*>(cell);
  auto* v = static_cast<const float*>(vals);
  auto* o = static_cast<float*>(out);
  auto* w = static_cast<int*>(words);
  // the bits of a key: a kept cell, or n_cells for a dropped entry
  const int key_bits = 32 - __builtin_clz(static_cast<unsigned>(n_cells));
  cell_sum_init_kernel<<<blocks_of(n_cells, kThreads), kThreads, 0, st>>>(
      w, n_cells, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(cell_sum_count_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kCountSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int count_blocks = n > 0 ? blocks_of(n, kCountTile) : 1;
  cell_sum_count_kernel<<<count_blocks, kThreads, kCountSmem, st>>>(
      c, n, n_cells, key_bits, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    cell_sum_scatter_kernel<<<blocks_of(n, kThreads), kThreads, 0, st>>>(
        c, n, n_cells, w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cell_sum_order_kernel<<<max_large(n) + blocks_of(n_cells, kWarps), kThreads,
                          0, st>>>(v, n, n_cells, bits_below(n), w, o);
  return static_cast<int>(cudaGetLastError());
}
