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
// What bounds it.  Neither bytes (about 6 a row) nor operations: the
// chain does, and only over the rows that change the pool, plus the
// launch.  A row is a candidate when it is valid and its MIPS lies below
// the pool, or (v2) the armed timer is due at it.  Every other row adds
// 0.0 to the pool and subtracts 0.0 from it, which leaves its bits as they
// are once v2's first ``+ 0.0`` has folded -0.0 into +0.0.  So the
// dependent float32 chain is as long as the takes plus at most one fire,
// not K.  Between two candidates the pool cannot change, and in v1 it
// never grows, so the candidates under the current pool are the only
// rows left that can change it; in v2 only the fire grows it.
//
// The design.  A warp walks a world; a block holds up to kWarps worlds,
// so any R is one launch.  The warp keeps a ring of kRing stages of
// kStage rows in dynamic shared memory, filled by ``cp.async`` copies
// kRing - 1 stages ahead of the walk, so no load sits on the chain.  The
// copies read the world's own rows and nothing past them: 16 bytes a copy
// where the rows are 16-byte aligned, else 4 (floats) or plain byte loads
// (the valid flags at the world's two ends).  An invalid row is read as
// a MIPS of +inf and a time of -inf, which no test takes or fires on.  On
// a stage each lane tests its 16 rows (rows 32 j + lane) against the
// current carry, and one warp OR-reduction gives the groups of 32 rows
// that hold a candidate; a stage without one costs those tests and the
// takes' stores.  In a group with candidates a warp ballot finds the first (``__ffs``); every lane
// applies that row's event, its MIPS and time broadcast by
// ``__shfl_sync`` (the fire first, then the take), and ballots again over
// the lanes after it.  A group with kSerialFrom candidates or more is
// walked row by row instead, its 32 rows read four at a time into
// registers ahead of the chain (a compare and a predicated subtract a row
// once the timer is disarmed), which is cheaper than a ballot a take on a
// dense window.  After a fire the stage's later groups are tested again.
// The pool moves only by single-rounded adds and subtracts
// (__fadd_rn/__fsub_rn, never contracted into a multiply-add), so every
// take, pool and fired bit equals the row-by-row scan's.
//
// Measured on an H100 (PERF.md; tools/pool_scan_ab.py), what is left is
// the launch, the copies that one SM can have in flight, one test a
// stage, and the chain itself on a dense window (about 30 cycles a row
// in v1 and 45 in v2, against the 8 and 16 of its dependent adds).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 4;               // worlds a block
constexpr int kGroups = 16;             // groups of 32 rows a stage
constexpr int kStage = 32 * kGroups;    // rows a stage
constexpr int kRing = 8;                // stages a warp holds (a power of 2)
constexpr unsigned kAll = 0xffffffffu;
// Candidates in a group of 32 rows from which the warp walks the group row
// by row.  On an H100 (tools/pool_scan_ab.py, PERF.md) 4 to 16 timed the
// same within 3 %; 33 (a ballot a take everywhere) was 1.6x slower on the
// bench world's windows and 3.1-3.6x on dense ones.
constexpr int kSerialFrom = 8;

// One stage of a world's rows as copied: row c0 + i of the stage lies at
// m[i], t[i] and v[ov + i], where ov is the valid flags' offset from
// 16-byte alignment in device memory.  The slots of rows outside the
// world are never written, and what is read from them is masked out.
template <bool V2>
struct __align__(16) Stage {
  float m[kStage];
  float t[V2 ? kStage : 4];
  uint8_t v[kStage + 16];
};

// Where a world's rows start in device memory.
template <bool V2>
struct Rows {
  const float* m;
  const float* t;
  const uint8_t* v;  // 16-byte aligned, ov bytes before the first row
  bool m16, t16;     // m and t 16-byte aligned
  int ov, K;
};

// A world's carry: the pool and, under v2, the timer.
struct Carry {
  float pool;
  float fire_t;
  float refund;
  bool armed;
  bool fired;
};

// A row as the walk sees it: an invalid row's MIPS is +inf (never below
// the pool) and its time -inf (never at or past an armed timer's finite
// time), so no test below reads the valid flag.  Can it change the pool?
template <bool V2>
__device__ __forceinline__ bool candidate(const Carry& c, float m, float t) {
  return m < c.pool || (V2 && c.armed && t >= c.fire_t);
}

// The event of a row: the timer pops first (equality included), then the
// row is taken if its MIPS lies strictly below the pool (a NaN MIPS or a
// tie never is); every take and every fire disarms.  Returns the take.
template <bool V2>
__device__ __forceinline__ bool apply_row(Carry& c, float m, float t) {
  if (V2) {
    const bool fire_now = c.armed && t >= c.fire_t;
    c.pool = fire_now ? __fadd_rn(c.pool, c.refund) : c.pool;
    c.fired = c.fired || fire_now;
    c.armed = c.armed && !fire_now;
  }
  const bool tk = m < c.pool;
  c.pool = tk ? __fsub_rn(c.pool, m) : c.pool;
  if (V2) c.armed = c.armed && !tk;
  return tk;
}

// Copy n floats of a stage, 16 bytes a copy where they are aligned so,
// else 4; an aligned stage's last partial quad (n not a multiple of 4)
// goes 4 bytes a copy, one lane a row.
__device__ __forceinline__ void copy_floats(float* dst, const float* src, bool aligned,
                                            int n, int lane) {
  if (aligned) {
    const int whole = n & ~3;
#pragma unroll
    for (int k = 0; k < kStage / 128; ++k) {
      const int q = lane + 32 * k;
      if (4 * q < whole) __pipeline_memcpy_async(dst + 4 * q, src + 4 * q, 16);
    }
    if (lane < n - whole) __pipeline_memcpy_async(dst + whole + lane, src + whole + lane, 4);
  } else {
#pragma unroll
    for (int k = 0; k < kStage / 32; ++k) {
      const int i = lane + 32 * k;
      if (i < n) __pipeline_memcpy_async(dst + i, src + i, 4);
    }
  }
}

// Copy the stage at row c0 (if any) into ``b`` and commit it as one group
// of this lane's copies.  The valid flags go in 16-byte blocks from the
// aligned address at or before them, by ``cp.async`` where every block of
// the stage lies inside the world's rows (one test a stage).  Else, at a
// world's unaligned ends only, a block crossing an end (the first or the
// last) goes by plain byte loads of the world's own rows (lanes 0-15 the
// first block, 16-31 the last).
template <bool V2>
__device__ __forceinline__ void issue_stage(Stage<V2>& b, const Rows<V2>& w, int64_t c0,
                                            int lane) {
  if (c0 < w.K) {
    const int n = w.K - c0 < kStage ? static_cast<int>(w.K - c0) : kStage;
    copy_floats(b.m, w.m + c0, w.m16, n, lane);
    if (V2) copy_floats(b.t, w.t + c0, w.t16, n, lane);
    const int blocks = (w.ov + n + 15) >> 4;
    const int64_t lo0 = c0 - w.ov;  // the world's row at block 0's start
    if (lo0 >= 0 && lo0 + 16 * blocks <= w.K) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int q = lane + 32 * k;
        if (q < blocks) __pipeline_memcpy_async(b.v + 16 * q, w.v + c0 + 16 * q, 16);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int q = lane + 32 * k;
        const int64_t lo = lo0 + 16 * q;
        if (q < blocks && lo >= 0 && lo + 16 <= w.K)
          __pipeline_memcpy_async(b.v + 16 * q, w.v + c0 + 16 * q, 16);
      }
      const int q = lane < 16 ? 0 : blocks - 1;
      const int64_t lo = lo0 + 16 * q, row = lo + (lane & 15);
      const bool crosses = lo < 0 || lo + 16 > w.K;
      if (crosses && (lane < 16 || q > 0) && row >= 0 && row < w.K)
        b.v[16 * q + (lane & 15)] = w.v[c0 + 16 * q + (lane & 15)];
    }
  }
  __pipeline_commit();
}

// Row i of stage ``b`` (n rows) as the walk sees it, and whether it is
// valid: rows past n are not.  The reads do not wait on each other.
template <bool V2>
__device__ __forceinline__ bool row_of(const Stage<V2>& b, const Rows<V2>& w, int n, int i,
                                       float& m, float& t) {
  const uint8_t flag = b.v[w.ov + i];
  const float mm = b.m[i];
  const float tt = V2 ? b.t[i] : 0.0f;
  const bool v = (i < n) & (flag != 0);
  m = v ? mm : INFINITY;
  t = v ? tt : -INFINITY;
  return v;
}

// The groups of the stage from group ``from`` on that hold a candidate
// under the carry, as bits: lane l tests rows 32 j + l, the lanes on
// neighbouring words.
template <bool V2>
__device__ __forceinline__ unsigned candidate_groups(const Carry& c, const Stage<V2>& b,
                                                     const Rows<V2>& w, int n, int from,
                                                     int lane) {
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    float m, t;
    row_of<V2>(b, w, n, 32 * j + lane, m, t);
    bits |= (j >= from && candidate<V2>(c, m, t) ? 1u : 0u) << j;
  }
  return __reduce_or_sync(kAll, bits);
}

// Every row of a group in order, its values in registers: rows that are
// not candidates leave the carry as it is.  Once the timer is disarmed
// the v1 event is enough.
template <bool V2>
__device__ __forceinline__ unsigned walk_rows(Carry& c, const float (&mk)[32],
                                              const float (&tk)[32]) {
  unsigned taken = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) taken |= (apply_row<V2>(c, mk[k], tk[k]) ? 1u : 0u) << k;
  return taken;
}

// Group j of the stage, lane l holding its row l: the takes as bits.
template <bool V2>
__device__ __forceinline__ unsigned walk_group(Carry& c, const Stage<V2>& b,
                                               const Rows<V2>& w, int n, int j, int lane) {
  float m, t;
  const bool v = row_of<V2>(b, w, n, 32 * j + lane, m, t);
  unsigned cand = __ballot_sync(kAll, candidate<V2>(c, m, t));
  unsigned taken = 0;
  if (cand == 0) return 0;
  if (__popc(cand) >= kSerialFrom) {
    // dense: the group's rows read four at a time, ahead of the chain
    const unsigned vmask = __ballot_sync(kAll, v);
    float mk[32], tk[32];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 m4 = reinterpret_cast<const float4*>(b.m + 32 * j)[q];
      const float4 t4 = V2 ? reinterpret_cast<const float4*>(b.t + 32 * j)[q]
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float ms[4] = {m4.x, m4.y, m4.z, m4.w}, ts[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool v = (vmask >> (4 * q + e)) & 1u;
        mk[4 * q + e] = v ? ms[e] : INFINITY;
        tk[4 * q + e] = v ? ts[e] : -INFINITY;
      }
    }
    return V2 && c.armed ? walk_rows<V2>(c, mk, tk) : walk_rows<false>(c, mk, tk);
  }
  do {
    const int i = __ffs(cand) - 1;
    const float mi = __shfl_sync(kAll, m, i);
    const float ti = V2 ? __shfl_sync(kAll, t, i) : 0.0f;
    taken |= (apply_row<V2>(c, mi, ti) ? 1u : 0u) << i;
    const unsigned after = i == 31 ? 0u : kAll << (i + 1);
    cand = __ballot_sync(kAll, candidate<V2>(c, m, t)) & after;
  } while (cand != 0);
  return taken;
}

template <bool V2>
__global__ void __launch_bounds__(32 * kWarps) local_pool_scan_kernel(
    const float* __restrict__ mips, const uint8_t* __restrict__ valid,
    const float* __restrict__ t, const float* __restrict__ pool0,
    const float* __restrict__ fire_t0, const float* __restrict__ refund0, int K,
    int R, uint8_t* __restrict__ take, float* __restrict__ pool_out,
    uint8_t* __restrict__ fired_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= R) return;  // a whole warp: the ballots below keep every lane
  Stage<V2>* ring = reinterpret_cast<Stage<V2>*>(smem) + (threadIdx.x >> 5) * kRing;
  const size_t base = static_cast<size_t>(r) * K;
  take += base;
  Rows<V2> w;
  w.m = mips + base;
  w.t = V2 ? t + base : nullptr;
  w.m16 = (reinterpret_cast<uintptr_t>(w.m) & 15) == 0;
  w.t16 = V2 && (reinterpret_cast<uintptr_t>(w.t) & 15) == 0;
  w.ov = static_cast<int>(reinterpret_cast<uintptr_t>(valid + base) & 15);
  w.v = valid + base - w.ov;
  w.K = K;
  // the first stages' copies go out before anything waits on a load
  for (int s = 0; s < kRing - 1; ++s) issue_stage<V2>(ring[s], w, int64_t{s} * kStage, lane);
  Carry c;
  c.pool = pool0[r];
  c.fire_t = V2 ? fire_t0[r] : 0.0f;
  c.refund = V2 ? refund0[r] : 0.0f;
  c.armed = V2 && isfinite(c.fire_t);
  c.fired = false;
  // the rows that cannot change the pool have one effect: v2's + 0.0
  // folds -0.0 into +0.0 (v1's - 0.0 keeps it)
  if (K > 0) c.pool = V2 ? __fadd_rn(c.pool, 0.0f) : __fsub_rn(c.pool, 0.0f);

  const int64_t stages = (static_cast<int64_t>(K) + kStage - 1) / kStage;
  for (int64_t s = 0; s < stages; ++s) {
    issue_stage<V2>(ring[(s + kRing - 1) & (kRing - 1)], w, (s + kRing - 1) * kStage, lane);
    __pipeline_wait_prior(kRing - 1);  // this lane's copies of stage s
    __syncwarp();                      // and every lane's
    const Stage<V2>& b = ring[s & (kRing - 1)];
    const int64_t c0 = s * kStage;
    const int n = K - c0 < kStage ? static_cast<int>(K - c0) : kStage;
    unsigned groups = candidate_groups<V2>(c, b, w, n, 0, lane);
    unsigned mine = 0;  // this lane's takes: bit j for row 32 j + lane
    while (groups != 0) {
      const int j = __ffs(groups) - 1;
      groups &= groups - 1;
      const bool fired = c.fired;
      mine |= ((walk_group<V2>(c, b, w, n, j, lane) >> lane) & 1u) << j;
      // a fire grows the pool: the later groups may hold new candidates
      if (V2 && c.fired != fired) groups = candidate_groups<V2>(c, b, w, n, j + 1, lane);
    }
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
      if (32 * j + lane < n) take[c0 + 32 * j + lane] = static_cast<uint8_t>((mine >> j) & 1u);
    __syncwarp();  // every lane is done with the buffer before it is refilled
  }
  if (lane == 0) {
    pool_out[r] = c.pool;
    fired_out[r] = c.fired ? 1 : 0;
  }
}

template <bool V2>
int launch(const void* mips, const void* valid, const void* t, const void* pool0,
           const void* fire_t0, const void* refund0, int K, int R, void* take,
           void* pool_out, void* fired_out, cudaStream_t stream) {
  // a block of as many warps as there are worlds, up to kWarps, each with
  // its ring; the shared memory a full block needs is allowed once a
  // device (bit d of ``allowed``: device d)
  constexpr int kMaxBytes = static_cast<int>(sizeof(Stage<V2>)) * kRing * kWarps;
  static std::atomic<unsigned long long> allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if ((allowed.load(std::memory_order_relaxed) & bit) == 0) {
    err = cudaFuncSetAttribute(local_pool_scan_kernel<V2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed.fetch_or(bit, std::memory_order_relaxed);
  }
  const int warps = R < kWarps ? R : kWarps;
  const int bytes = static_cast<int>(sizeof(Stage<V2>)) * kRing * warps;
  local_pool_scan_kernel<V2><<<(R + warps - 1) / warps, 32 * warps, bytes, stream>>>(
      static_cast<const float*>(mips), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(t), static_cast<const float*>(pool0),
      static_cast<const float*>(fire_t0), static_cast<const float*>(refund0), K, R,
      static_cast<uint8_t*>(take), static_cast<float*>(pool_out),
      static_cast<uint8_t*>(fired_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fns_local_pool_scan(
    const void* mips, const void* valid, const void* t, const void* pool0,
    const void* fire_t0, const void* refund0, int K, int R, int v2,
    void* take, void* pool_out, void* fired_out, void* stream) {
  if (R <= 0) return 0;
  auto* fn = v2 ? launch<true> : launch<false>;
  return fn(mips, valid, t, pool0, fire_t0, refund0, K, R, take, pool_out, fired_out,
            static_cast<cudaStream_t>(stream));
}
