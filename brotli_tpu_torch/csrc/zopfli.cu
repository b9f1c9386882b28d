// CUDA q10 Zopfli DP: one warp per lane.  Replaces the XLA `lax.scan` of
// brotli_tpu/ops/device_zopfli.py (_build_dp, step at :166), which has no
// `pallas_call`: on the TPU it is a scan over positions with `while_loop`s
// inside, every lane in lockstep.
//
// Bound on Hopper: bytes, by far (inputs read once and 24 B of node arrays
// written a position: a few MB at 64 KB, about a microsecond), but the DP
// is a chain of n dependent steps a lane: each step reads node costs that
// the steps before it wrote.  So the kernels run far from their bound and
// their time is the chain's latency: the loads a step waits for one after
// another.  Both kernels take a lane a warp.  The serial part of a step
// (csrc/zopfli.cuh) is warp-uniform, its loads broadcast, and only the
// leader writes the shortcut.  A match length is found 32 bytes a step
// with a ballot, and the lengths of a candidate or a match are relaxed 32
// at a time, a thread a length (the targets are distinct).
//
// `zopfli_kernel` (the default, zopfli_dp): a warp a block, the lane's
// window of nodes, literal costs, noted shortcut walks and distance-cache
// records and its cost tables in the block's shared memory, the queue in
// registers (zopfli_lane_win).  Measured by phase on an H100
// (tools/zopfli_phases.py), that takes a step of a 64 KB lane from about
// 8,200 cycles to 2,400: the candidates' byte tests in one round, the queue
// and the distance cache off the chain of dependent loads, the minimum
// length 32 costs a ballot.  Shared memory: 13,824 B of tables + 68 B a
// window slot, dynamic (above 48 KB through cudaFuncSetAttribute);
// ops/device_zopfli.launch_config sizes the window from the card's shared
// memory and the lanes an SM holds.
//
// `zopfli_direct_kernel` (the first form, zopfli_dp_direct): 4 lanes a
// block, every node in device memory (24 B a position, L2-resident at 64
// KB), ordered between phases by __syncwarp; the queue in shared memory,
// written by the leader; the distance cache walked hop by hop and the
// minimum length scanned a cost at a time.
//
// Built with -fmad=false (build.py): the costs are sums in the host's
// order, and no multiply-add may contract one.  Built again with
// -DZOPFLI_PHASE_CLOCKS by tools/zopfli_phases.py, every step's phases
// (Steps::mark) sum clock64() deltas into zopfli_clocks.
#include <cuda_runtime.h>

#include "zopfli.cuh"

namespace brotli_torch {

constexpr int ZOPFLI_BLOCK = 128;  // the direct kernel: 4 warps, 4 lanes
constexpr int ZOPFLI_WARPS = ZOPFLI_BLOCK / 32;
constexpr int ZOPFLI_BLOCKS_PER_SM = 8;
constexpr u32 ZOPFLI_FULL = 0xFFFFFFFFu;
constexpr int ZOPFLI_TABLES = ZOPFLI_NUM_CMD + ZOPFLI_DIST_ROW;  // float64s
constexpr int ZOPFLI_WINDOW_MIN = 64;
// bytes of a window slot: a node (24), a literal cost (8), next and its
// walk (20), a record (16)
constexpr int ZOPFLI_SLOT = 68;

#if defined(ZOPFLI_PHASE_CLOCKS)
constexpr int ZOPFLI_PHASES = 12;
// clock64() cycles by [kernel (0 direct, 1 window)][phase], summed over the
// threads of every lane
__device__ unsigned long long zopfli_clocks[2][ZOPFLI_PHASES];
#endif

struct ZopfliArgs {
  const u8* data;
  const double* lit;
  const double* cmd;
  const double* dist;
  const double* min_cost_cmd;
  const i32* start_cache;
  const i32* n_valid;
  const i32* moff;
  const i32* mlen;
  const i32* mdist;
  const i32* mdelta;
  const u8* active;
  double* cost;
  u32* len;
  i32* ndist;
  u32* dci;
  i32* sc;
  i32* result;
  i64* tried;
  int n_lanes, n_max, stride, max_zlen;
};

struct WarpSteps {
  int t;
  __device__ __forceinline__ bool leader() const { return t == 0; }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  // find_match_length: 32 byte pairs a step, the first mismatch by ballot
  __device__ __forceinline__ i32 match_length(const u8* a, const u8* b, i32 limit) const {
    for (i32 base = 0;; base += 32) {
      const i32 k = base + t;
      const bool eq = k < limit && __ldg(a + k) == __ldg(b + k);
      const u32 ne = __ballot_sync(ZOPFLI_FULL, !eq);
      if (ne) return base + __ffs((int)ne) - 1;
    }
  }
  template <class F>
  __device__ __forceinline__ void lengths(i32 lo, i32 hi, F f) const {
    for (i32 base = lo; base <= hi; base += 32) {
      const i32 l = base + t;
      if (l <= hi) f(l);
    }
    __syncwarp();
  }
  template <class F>
  __device__ __forceinline__ void spread(i32 lo, i32 hi, F f) const {
    for (i32 l = lo + t; l <= hi; l += 32) f(l);
  }
  template <class F>
  __device__ __forceinline__ void each_thread(F f) const {
    f(t);
  }
  template <class F>
  __device__ __forceinline__ void each(i32 lo, i32 hi, F f) const {
    for (i32 i = lo + t; i < hi; i += 32) f(i);
    __syncwarp();
  }
  template <class F>
  __device__ __forceinline__ u32 ballot(F f) const {
    return __ballot_sync(ZOPFLI_FULL, f(t));
  }

  template <class F>
  __device__ __forceinline__ i32 first_false(i32 lo, F f) const {
    for (i32 base = lo;; base += 32) {
      const u32 bad = __ballot_sync(ZOPFLI_FULL, !f(base + t));
      if (bad) return base + __ffs((int)bad) - 1;
    }
  }
  __device__ __forceinline__ i32 reduce_max(i32 x) const {
    return (i32)__reduce_max_sync(ZOPFLI_FULL, (u32)x);
  }
#if defined(ZOPFLI_PHASE_CLOCKS)
  mutable long long last = 0, acc[ZOPFLI_PHASES] = {};
  __device__ __forceinline__ void mark(int k) const {
    const long long now = clock64();
    acc[k] += now - last;
    last = now;
  }
  __device__ __forceinline__ void begin() const { last = clock64(); }
  __device__ __forceinline__ void flush(int kernel) const {
    for (int k = 0; k < ZOPFLI_PHASES; ++k) {
      atomicAdd(&zopfli_clocks[kernel][k], (unsigned long long)acc[k]);
      acc[k] = 0;
    }
  }
#else
  __device__ __forceinline__ void mark(int) const {}
  __device__ __forceinline__ void begin() const {}
  __device__ __forceinline__ void flush(int) const {}
#endif
};

__device__ __forceinline__ ZopfliLane zopfli_lane_args(const ZopfliArgs& A, int lane) {
  const i64 nrow = (i64)lane * (A.n_max + 1);
  return ZopfliLane{A.data + (i64)lane * A.stride,
                    A.lit + (i64)lane * (A.n_max + 2),
                    A.cmd + (i64)lane * ZOPFLI_NUM_CMD,
                    A.dist + (i64)lane * ZOPFLI_DIST_ROW,
                    A.min_cost_cmd[lane],
                    A.start_cache + 4 * lane,
                    A.moff + nrow,
                    A.mlen,
                    A.mdist,
                    A.mdelta,
                    A.active + (i64)lane * A.n_max,
                    A.n_valid[lane],
                    A.max_zlen};
}

__device__ __forceinline__ ZopfliNodes zopfli_lane_nodes(const ZopfliArgs& A, int lane) {
  const i64 nrow = (i64)lane * (A.n_max + 1);
  return ZopfliNodes{A.cost + nrow, A.len + nrow, A.ndist + nrow, A.dci + nrow, A.sc + nrow};
}

__global__ void __launch_bounds__(32, 1) zopfli_kernel(ZopfliArgs A, i32* rec, int window) {
  extern __shared__ double zopfli_smem[];
  const int t = threadIdx.x;
  const WarpSteps w{t};
  double* cost = zopfli_smem + ZOPFLI_TABLES;
  double* lit = cost + window;
  u32* fields = (u32*)(lit + window);  // len, dist, dci, sc, nx; records; walks
  const ZopfliWindow V{ZopfliNodes{cost, fields, (i32*)(fields + window), fields + 2 * window,
                                   (i32*)(fields + 3 * window)},
                       lit, (i32*)(fields + 4 * window), (i32*)(fields + 9 * window),
                       (i32*)(fields + 5 * window), zopfli_smem, zopfli_smem + ZOPFLI_NUM_CMD,
                       window, 0, 0.0};
  for (int lane = blockIdx.x; lane < A.n_lanes; lane += gridDim.x) {
    w.begin();
    const i64 tried = zopfli_lane_win(w, zopfli_lane_args(A, lane), zopfli_lane_nodes(A, lane), V,
                                      rec + (i64)lane * (A.n_max + 1) * 4,
                                      A.result + (i64)lane * A.n_max, A.n_max);
    w.flush(1);
    if (t == 0) A.tried[lane] = tried;
    __syncwarp();
  }
}

__global__ void __launch_bounds__(ZOPFLI_BLOCK) zopfli_direct_kernel(ZopfliArgs A) {
  __shared__ ZopfliQueue queues[ZOPFLI_WARPS];
  const int t = threadIdx.x & 31;
  ZopfliQueue& q = queues[threadIdx.x >> 5];
  const WarpSteps w{t};
  for (int lane = blockIdx.x * ZOPFLI_WARPS + (threadIdx.x >> 5); lane < A.n_lanes;
       lane += gridDim.x * ZOPFLI_WARPS) {
    const ZopfliNodes N = zopfli_lane_nodes(A, lane);
    const ZopfliLane L = zopfli_lane_args(A, lane);
    i32* result = A.result + (i64)lane * A.n_max;
    for (i32 i = t; i <= A.n_max; i += 32) {
      zopfli_nodes_init(N, i);
      if (i < A.n_max) result[i] = 0;
    }
    if (t == 0) zopfli_queue_init(q);
    __syncwarp();
    w.begin();
    i64 tried = 0;
    for (i32 pos = 0; pos + 3 < L.n; ++pos) {
      if (!__ldg(L.active + pos)) continue;
      w.mark(7);
      const ZopfliStep s = zopfli_step(w, L, N, q, pos);
      const i32 r = (i32)__reduce_max_sync(ZOPFLI_FULL, (u32)s.result);
      if (t == 0) result[pos] = r;
      tried += s.tried;
      __syncwarp();
    }
    w.flush(0);
    if (t == 0) A.tried[lane] = tried;
    __syncwarp();
  }
}

}  // namespace brotli_torch

using namespace brotli_torch;

static ZopfliArgs zopfli_args(const void* data, const void* lit, const void* cmd,
                              const void* dist, const void* min_cost_cmd,
                              const void* start_cache, const void* n_valid, const void* moff,
                              const void* mlen, const void* mdist, const void* mdelta,
                              const void* active, void* cost, void* len, void* ndist, void* dci,
                              void* sc, void* result, void* tried, int n_lanes, int n_max,
                              int stride, int max_zlen) {
  return ZopfliArgs{(const u8*)data,       (const double*)lit,  (const double*)cmd,
                    (const double*)dist,   (const double*)min_cost_cmd,
                    (const i32*)start_cache, (const i32*)n_valid, (const i32*)moff,
                    (const i32*)mlen,      (const i32*)mdist,   (const i32*)mdelta,
                    (const u8*)active,     (double*)cost,       (u32*)len,
                    (i32*)ndist,           (u32*)dci,           (i32*)sc,
                    (i32*)result,          (i64*)tried,         n_lanes,
                    n_max,                 stride,              max_zlen};
}

// Both entries launch on `stream` and return cudaGetLastError() (0 on
// success).  Inputs: data (n_lanes, stride) bytes, lit (n_lanes, n_max +
// 2), cmd (n_lanes, 704), dist (n_lanes, 1024) and min_cost_cmd (n_lanes,)
// float64, start_cache (n_lanes, 4), n_valid (n_lanes,) and moff (n_lanes,
// n_max + 1) int32, mlen, mdist, mdelta int32 (the matches of all lanes,
// moff's offsets absolute), active (n_lanes, n_max) bytes.  Outputs: cost
// (float64), len, ndist, dci, sc (int32) (n_lanes, n_max + 1), result
// (n_lanes, n_max) int32, tried (n_lanes,) int64.

// The window kernel: `blocks` blocks of one warp step over the lanes, each
// with a window of `window` slots (a power of two, at least 64).  rec:
// scratch of (n_lanes, n_max + 1, 4) int32, the memoised distance caches
// (read only where written).
extern "C" int brotli_torch_zopfli(const void* data, const void* lit, const void* cmd,
                                   const void* dist, const void* min_cost_cmd,
                                   const void* start_cache, const void* n_valid,
                                   const void* moff, const void* mlen, const void* mdist,
                                   const void* mdelta, const void* active, void* cost,
                                   void* len, void* ndist, void* dci, void* sc, void* result,
                                   void* tried, void* rec, int n_lanes, int n_max, int stride,
                                   int max_zlen, int blocks, int window, void* stream) {
  if (n_lanes <= 0 || n_max <= 0 || stride < n_max || blocks <= 0 ||
      window < ZOPFLI_WINDOW_MIN || (window & (window - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(double) * (size_t)ZOPFLI_TABLES + (size_t)ZOPFLI_SLOT * window;
  if (cudaFuncSetAttribute(zopfli_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return (int)cudaGetLastError();
  const ZopfliArgs A = zopfli_args(data, lit, cmd, dist, min_cost_cmd, start_cache, n_valid, moff,
                                   mlen, mdist, mdelta, active, cost, len, ndist, dci, sc, result,
                                   tried, n_lanes, n_max, stride, max_zlen);
  zopfli_kernel<<<blocks < n_lanes ? blocks : n_lanes, 32, smem, (cudaStream_t)stream>>>(
      A, (i32*)rec, window);
  return (int)cudaGetLastError();
}

// The direct kernel: the grid holds at most ZOPFLI_BLOCKS_PER_SM blocks on
// each of the card's `sms` SMs; its warps step over the lanes.
extern "C" int brotli_torch_zopfli_direct(const void* data, const void* lit, const void* cmd,
                                          const void* dist, const void* min_cost_cmd,
                                          const void* start_cache, const void* n_valid,
                                          const void* moff, const void* mlen, const void* mdist,
                                          const void* mdelta, const void* active, void* cost,
                                          void* len, void* ndist, void* dci, void* sc,
                                          void* result, void* tried, int n_lanes, int n_max,
                                          int stride, int max_zlen, int sms, void* stream) {
  if (n_lanes <= 0 || n_max <= 0 || stride < n_max || sms <= 0)
    return (int)cudaErrorInvalidValue;
  int blocks = (n_lanes + ZOPFLI_WARPS - 1) / ZOPFLI_WARPS;
  if (blocks > sms * ZOPFLI_BLOCKS_PER_SM) blocks = sms * ZOPFLI_BLOCKS_PER_SM;
  const ZopfliArgs A = zopfli_args(data, lit, cmd, dist, min_cost_cmd, start_cache, n_valid, moff,
                                   mlen, mdist, mdelta, active, cost, len, ndist, dci, sc, result,
                                   tried, n_lanes, n_max, stride, max_zlen);
  zopfli_direct_kernel<<<blocks, ZOPFLI_BLOCK, 0, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

#if defined(ZOPFLI_PHASE_CLOCKS)
// The phase clocks since the last call, [kernel][phase] as 14 uint64, then
// zeroed.
extern "C" int brotli_torch_zopfli_clocks(void* out) {
  cudaError_t rc = cudaMemcpyFromSymbol(out, zopfli_clocks, sizeof(zopfli_clocks));
  if (rc != cudaSuccess) return (int)rc;
  static const unsigned long long zero[2][ZOPFLI_PHASES] = {};
  return (int)cudaMemcpyToSymbol(zopfli_clocks, zero, sizeof(zero));
}
#endif
