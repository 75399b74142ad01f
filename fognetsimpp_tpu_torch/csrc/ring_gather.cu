// The task-sharded tick's arrival exchange for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ring_all_gather_pallas of
// fognetsimpp_tpu/ops/pallas_kernels.py (wrapper :234, body :264,
// pallas_call :286): every shard's packed (K, C) int32 block of arrival
// candidates becomes every shard's (n*K, C) window, the blocks in global
// shard order.  The TPU kernel gets there by n-1 remote-DMA hops to the
// right neighbour, double-buffered through VMEM with DMA semaphores,
// because its chips are linked to their neighbours.  Here every block
// sits in the same device memory (and NVLink between cards is all to
// all), so this kernel computes what the ring computes and not its hops:
// one launch copies block s of every source to offset s*K*C of every
// destination.
//
// The operands are n source pointers (one (K, C) block per shard) and n
// destination pointers (one (n*K, C) output per shard), passed by value
// in the launch's parameters (at most kMaxShards of each, 1 KB in all),
// so a launch needs no pointer table in device memory and no copy to
// the card.  The grid is (chunks of a block, source, destination); a
// thread copies 16-byte vectors while the source and the destination
// offset are both 16-byte aligned, and single words at the ragged end or
// where they are not.  The launch returns cudaGetLastError(), which the
// wrapper raises on.
//
// What bounds it on the card: bytes.  At the main shape (n = 4 shards,
// K = 34,142 rows, C = 4 columns, 546,272 B a block) the n*n output blocks
// are written once and the n input blocks read once: n^2 + n = 20 block
// copies, 10.9 MB at 3.35 TB/s, about 3.3 us.  It does no arithmetic.
// This first version is simple and right, not yet fast: each source block
// is read n times (once per destination, mostly from L2), and there is no
// tuning of the chunk size or of the grid's shape.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;  // 16-byte vectors a thread, per chunk
constexpr int kMaxShards = 64;

struct ShardPtrs {
  const int* src[kMaxShards];
  int* dst[kMaxShards];
};

__global__ void ring_gather_kernel(const ShardPtrs p, long long elems) {
  const int s = blockIdx.y;
  const int d = blockIdx.z;
  const int* a = p.src[s];
  int* b = p.dst[d] + static_cast<long long>(s) * elems;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
       15u) == 0;
  if (vec) {
    const long long nv = elems >> 2;
    const int4* a4 = reinterpret_cast<const int4*>(a);
    int4* b4 = reinterpret_cast<int4*>(b);
    for (long long v = t0; v < nv; v += stride) b4[v] = __ldg(a4 + v);
    done = nv << 2;
  }
  for (long long e = done + t0; e < elems; e += stride) b[e] = a[e];
}

}  // namespace

// ptrs: a host array of 2n device pointers, the n (K, C) int32 blocks
// then the n (n*K, C) int32 outputs; elems = K*C.  One launch on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int fns_ring_all_gather(const unsigned long long* ptrs, int n,
                                   long long elems, void* stream) {
  if (n <= 0 || elems <= 0) return 0;
  if (n > kMaxShards) return static_cast<int>(cudaErrorInvalidValue);
  ShardPtrs p{};
  for (int i = 0; i < n; ++i) {
    p.src[i] = reinterpret_cast<const int*>(ptrs[i]);
    p.dst[i] = reinterpret_cast<int*>(ptrs[n + i]);
  }
  const long long per_block = static_cast<long long>(kThreads) * kVecPerThread;
  long long chunks = ((elems + 3) / 4 + per_block - 1) / per_block;
  if (chunks > 65535) chunks = 65535;  // the grid-stride loop covers the rest
  const dim3 grid(static_cast<unsigned int>(chunks), n, n);
  ring_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, elems);
  return static_cast<int>(cudaGetLastError());
}
