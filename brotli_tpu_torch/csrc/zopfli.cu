// CUDA q10 Zopfli DP: one warp per lane.  Replaces the XLA `lax.scan` of
// brotli_tpu/ops/device_zopfli.py (_build_dp, step at :166), which has no
// `pallas_call`: on the TPU it is a scan over positions with `while_loop`s
// inside, every lane in lockstep.
//
// Bound on Hopper: bytes, by far (inputs read once and 24 B of node arrays
// written a position: a few MB at 64 KB, about a microsecond), but the DP
// is a chain of n dependent steps a lane: each step reads node costs that
// the steps before it wrote.  So the kernel runs far from its bound and
// its time is the chain's latency.  A warp takes a lane.  The serial part
// of a step (csrc/zopfli.cuh) is warp-uniform, its loads broadcast; the
// queue sits in shared memory and only the leader writes it.  A match
// length is found 32 bytes a step with a ballot, and the lengths of a
// candidate or a match are relaxed 32 at a time, a thread a length (the
// targets are distinct).  The node arrays stay in device memory (24 B a
// position, L2-resident at 64 KB), ordered between phases by __syncwarp.
//
// Built with -fmad=false (build.py): the costs are sums in the host's
// order, and no multiply-add may contract one.
#include <cuda_runtime.h>

#include "zopfli.cuh"

namespace brotli_torch {

constexpr int ZOPFLI_BLOCK = 128;  // 4 warps, 4 lanes
constexpr int ZOPFLI_WARPS = ZOPFLI_BLOCK / 32;
constexpr int ZOPFLI_BLOCKS_PER_SM = 8;
constexpr u32 ZOPFLI_FULL = 0xFFFFFFFFu;

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
  __device__ bool leader() const { return t == 0; }
  __device__ void sync() const { __syncwarp(); }
  // find_match_length: 32 byte pairs a step, the first mismatch by ballot
  __device__ i32 match_length(const u8* a, const u8* b, i32 limit) const {
    for (i32 base = 0;; base += 32) {
      const i32 k = base + t;
      const bool eq = k < limit && __ldg(a + k) == __ldg(b + k);
      const u32 ne = __ballot_sync(ZOPFLI_FULL, !eq);
      if (ne) return base + __ffs((int)ne) - 1;
    }
  }
  template <class F>
  __device__ void lengths(i32 lo, i32 hi, F f) const {
    for (i32 base = lo; base <= hi; base += 32) {
      const i32 l = base + t;
      if (l <= hi) f(l);
    }
    __syncwarp();
  }
};

__global__ void __launch_bounds__(ZOPFLI_BLOCK) zopfli_kernel(ZopfliArgs A) {
  __shared__ ZopfliQueue queues[ZOPFLI_WARPS];
  const int t = threadIdx.x & 31;
  ZopfliQueue& q = queues[threadIdx.x >> 5];
  const WarpSteps w{t};
  for (int lane = blockIdx.x * ZOPFLI_WARPS + (threadIdx.x >> 5); lane < A.n_lanes;
       lane += gridDim.x * ZOPFLI_WARPS) {
    const i64 nrow = (i64)lane * (A.n_max + 1);
    const ZopfliNodes N{A.cost + nrow, A.len + nrow, A.ndist + nrow, A.dci + nrow, A.sc + nrow};
    const ZopfliLane L{A.data + (i64)lane * A.stride,
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
    i32* result = A.result + (i64)lane * A.n_max;
    for (i32 i = t; i <= A.n_max; i += 32) {
      zopfli_nodes_init(N, i);
      if (i < A.n_max) result[i] = 0;
    }
    if (t == 0) zopfli_queue_init(q);
    __syncwarp();
    i64 tried = 0;
    for (i32 pos = 0; pos + 3 < L.n; ++pos) {
      if (!__ldg(L.active + pos)) continue;
      const ZopfliStep s = zopfli_step(w, L, N, q, pos);
      const i32 r = (i32)__reduce_max_sync(ZOPFLI_FULL, (u32)s.result);
      if (t == 0) result[pos] = r;
      tried += s.tried;
      __syncwarp();
    }
    if (t == 0) A.tried[lane] = tried;
    __syncwarp();
  }
}

}  // namespace brotli_torch

using namespace brotli_torch;

// Launch on `stream`; returns cudaGetLastError() (0 on success).  Inputs:
// data (n_lanes, stride) bytes, lit (n_lanes, n_max + 2), cmd (n_lanes,
// 704), dist (n_lanes, 1024) and min_cost_cmd (n_lanes,) float64,
// start_cache (n_lanes, 4), n_valid (n_lanes,) and moff (n_lanes, n_max + 1)
// int32, mlen, mdist, mdelta int32 (the matches of all lanes, moff's
// offsets absolute), active (n_lanes, n_max) bytes.  Outputs: cost (float64),
// len, ndist, dci, sc (int32) (n_lanes, n_max + 1), result (n_lanes, n_max)
// int32, tried (n_lanes,) int64.  The grid holds at most
// ZOPFLI_BLOCKS_PER_SM blocks on each of the card's `sms` SMs; its warps
// step over the lanes.
extern "C" int brotli_torch_zopfli(const void* data, const void* lit, const void* cmd,
                                   const void* dist, const void* min_cost_cmd,
                                   const void* start_cache, const void* n_valid,
                                   const void* moff, const void* mlen, const void* mdist,
                                   const void* mdelta, const void* active, void* cost,
                                   void* len, void* ndist, void* dci, void* sc, void* result,
                                   void* tried, int n_lanes, int n_max, int stride,
                                   int max_zlen, int sms, void* stream) {
  if (n_lanes <= 0 || n_max <= 0 || stride < n_max || sms <= 0)
    return (int)cudaErrorInvalidValue;
  int blocks = (n_lanes + ZOPFLI_WARPS - 1) / ZOPFLI_WARPS;
  if (blocks > sms * ZOPFLI_BLOCKS_PER_SM) blocks = sms * ZOPFLI_BLOCKS_PER_SM;
  const ZopfliArgs A{(const u8*)data,       (const double*)lit,  (const double*)cmd,
                     (const double*)dist,   (const double*)min_cost_cmd,
                     (const i32*)start_cache, (const i32*)n_valid, (const i32*)moff,
                     (const i32*)mlen,      (const i32*)mdist,   (const i32*)mdelta,
                     (const u8*)active,     (double*)cost,       (u32*)len,
                     (i32*)ndist,           (u32*)dci,           (i32*)sc,
                     (i32*)result,          (i64*)tried,         n_lanes,
                     n_max,                 stride,              max_zlen};
  zopfli_kernel<<<blocks, ZOPFLI_BLOCK, 0, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}
