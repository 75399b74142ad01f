// The ordered per-cell float32 sum for Hopper (sm_90a).
//
// No TPU kernel stands behind it.  The wireless tick sums each 802.11
// cell's offered load, a float32 scatter-add of N per-node rates into A
// cells (fognetsimpp_tpu/net/topology.py:191-195,
// `zeros(A + 1).at[cell].add(rate, mode="drop")[:A]`).  XLA on the CPU
// adds the entries of a cell one by one in index order, and float32
// addition does not associate, so that order is part of the result; an
// atomic scatter-add on the card adds in no fixed order.  This kernel
// adds in index order: out[c] = (((0 + v_i0) + v_i1) + ...) over the
// entries i0 < i1 < ... whose cell is c.  Entries whose cell lies
// outside [0, n_cells) are dropped.
//
// One block a cell.  The block walks the N entries in tiles of
// kThreads * kItems (a thread kItems consecutive entries), compacts the
// tile's entries of its cell into shared memory in index order (a
// block-wide exclusive scan of the threads' match counts), and one
// thread adds them to the running sum in that order.  The adds of a cell
// form one dependent chain whatever the design, so the parallelism is
// across cells and, within a cell, in finding its entries.
//
// What bounds it on the card: at config 4's shape (N = 10,069 entries,
// A = 64 cells) the bytes it must move are N * 8 read and A * 4 written,
// about 24 ns at 3.35 TB/s; the kernel takes the time of a launch, the
// tiles' loads and barriers, and the longest cell's chain of adds (at
// 4 cycles an add, 10k entries in one cell cost about 22 us).  This
// first version is simple and right, not yet fast: every block reads all
// N entries (from L2 after the first), and the one adding thread does
// not overlap the next tile's compaction.  The launch returns
// cudaGetLastError(), which the wrapper raises on.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
    cell_sum_kernel(const int* __restrict__ cell,
                    const float* __restrict__ vals, int n,
                    float* __restrict__ out) {
  __shared__ float list[kTile];
  __shared__ int warp_off[kWarps];
  __shared__ int tile_total;
  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float acc = 0.0f;  // thread 0's running sum
  for (int base = 0; base < n; base += kTile) {
    const int i0 = base + threadIdx.x * kItems;
    float v[kItems];
    bool m[kItems];
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
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
      const int w = warp_off[lane];  // kWarps == 32
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
    for (int k = 0; k < kItems; ++k) {
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

static_assert(kWarps == 32, "the second scan level is one warp");

}  // namespace

// cell: (n,) int32 cell of each entry; vals: (n,) float32; out: (n_cells,)
// float32, every cell written.  One launch on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int fns_cell_sum_ordered(const void* cell, const void* vals, int n,
                                    int n_cells, void* out, void* stream) {
  if (n_cells <= 0) return 0;
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cell_sum_kernel<<<n_cells, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cell), static_cast<const float*>(vals), n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
