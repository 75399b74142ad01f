// The broker's local-pool scan: the sequential debit of LOCAL_FIRST's
// MIPS pool over one tick's window, in arrival order.
//
// Counterpart of the ``jax.lax.scan`` bodies in the JAX engine's broker
// phase (the v1 body, and the v2 body with the shared release timer).
// Each world's K rows arrive sorted by (arrival time, slot).  Row k is
// taken when it is valid and its MIPS lies strictly below the pool, and
// a taken row debits the pool.  Under v2 a timer armed at ``fire_t0``
// pops before the first valid row at or after that time: the pool gains
// ``refund0`` first, and every take disarms the timer.
//
// Neither bytes (about 6 a row) nor operations bound it on this card: the
// chain does.  Each row's take depends on the pool that every earlier
// row left, so a world's time is its rows' chain of dependent float32
// operations (2 a row in v1, 4 in v2) at the SM clock.  The design keeps
// everything but that chain off the critical path: one block walks one
// world; its threads load a chunk of rows into shared memory together
// (coalesced), thread 0 walks the chunk in order with single-rounded
// float32 adds and subtracts (__fadd_rn/__fsub_rn, never contracted into
// a multiply-add), and the threads write the chunk's takes together.  A
// replica batch is R worlds laid end to end, one block each, so R worlds
// take about the time of one.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;

__global__ void __launch_bounds__(kThreads) local_pool_scan_kernel(
    const float* __restrict__ mips, const uint8_t* __restrict__ valid,
    const float* __restrict__ t, const float* __restrict__ pool0,
    const float* __restrict__ fire_t0, const float* __restrict__ refund0,
    int K, int v2, uint8_t* __restrict__ take, float* __restrict__ pool_out,
    uint8_t* __restrict__ fired_out) {
  __shared__ float s_mips[kChunk];
  __shared__ float s_t[kChunk];
  __shared__ uint8_t s_valid[kChunk];
  __shared__ uint8_t s_take[kChunk];
  const int r = blockIdx.x;
  const size_t base = static_cast<size_t>(r) * K;
  float pool = pool0[r];
  const float fire_t = v2 ? fire_t0[r] : 0.0f;
  const float refund = v2 ? refund0[r] : 0.0f;
  bool armed = v2 && isfinite(fire_t);
  bool fired = false;
  for (int c0 = 0; c0 < K; c0 += kChunk) {
    const int n = min(kChunk, K - c0);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      s_mips[i] = mips[base + c0 + i];
      s_valid[i] = valid[base + c0 + i];
      if (v2) s_t[i] = t[base + c0 + i];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < n; ++i) {
        const float m = s_mips[i];
        const bool v = s_valid[i] != 0;
        if (v2) {
          // the timer pops before an arrival at the same instant
          const bool fire_now = armed && v && (s_t[i] >= fire_t);
          pool = __fadd_rn(pool, fire_now ? refund : 0.0f);
          fired = fired || fire_now;
          armed = armed && !fire_now;
        }
        const bool tk = v && (m < pool);  // strict <
        pool = __fsub_rn(pool, tk ? m : 0.0f);
        if (v2) armed = armed && !tk;  // every accept cancels the timer
        s_take[i] = tk ? 1 : 0;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) take[base + c0 + i] = s_take[i];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    pool_out[r] = pool;
    fired_out[r] = fired ? 1 : 0;
  }
}

}  // namespace

extern "C" int fns_local_pool_scan(
    const void* mips, const void* valid, const void* t, const void* pool0,
    const void* fire_t0, const void* refund0, int K, int R, int v2,
    void* take, void* pool_out, void* fired_out, void* stream) {
  if (R <= 0) return 0;
  local_pool_scan_kernel<<<R, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mips), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(t), static_cast<const float*>(pool0),
      static_cast<const float*>(fire_t0), static_cast<const float*>(refund0),
      K, v2, static_cast<uint8_t*>(take), static_cast<float*>(pool_out),
      static_cast<uint8_t*>(fired_out));
  return static_cast<int>(cudaGetLastError());
}
