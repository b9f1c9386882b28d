// CUDA v2 entropy decode: the queued kernel (the main path's) and the
// direct kernel beside it.
// Replaces brotli_tpu/ops/pallas_decode2.py `_build` / `kernel`.
//
// Bound on Hopper: each lane is a serial chain of dependent table reads
// and bit shifts, one row at a time, so the card is fed by lanes in
// flight and by how few instructions and waits a lane's row costs.  A
// batch of 4,096 lanes is only 31 lanes an SM.
//
// `decode2_kernel` (the main path's): `lpw` lanes in each warp of a
// 128-thread block (the other threads only help copy the tables), so a
// small batch still spreads over every SM and each warp serializes the
// phases of few lanes; the wrapper picks lpw from the lane and SM counts
// (ops/decode2.py `lanes_per_warp`).  The block copies its group's tables
// (about 14 KB) into shared memory, and each lane's words come through a
// look-ahead queue of cp.async loads (queue.cuh).  Tokens are stored
// token-major, as resolve reads them.
//
// `decode2_direct_kernel`: 128 lanes a block, one lane a thread, each word
// loaded when the row rule asks for it.
#include <cuda_runtime.h>

#include "decode2.cuh"

namespace brotli_torch {

constexpr int DECODE2_BLOCK = 128;  // divides the 1024 lanes of a group
constexpr int GROUP_LANES = 1024;
constexpr int WARPS2 = 4;           // warps a block of decode2_kernel

__device__ void load_tables2(const i32* lit, const i32* cmd, const i32* dist,
                             const i32* dx, const i32* consts, int g,
                             int lit_k, int cmd_k, int dist_k, i32* s_lit,
                             i32* s_cmd, i32* s_dist, i32* s_dx,
                             i32* s_consts) {
  const int n = blockDim.x;
  for (int i = threadIdx.x; i < lit_k * 128; i += n)
    s_lit[i] = lit[g * lit_k * 128 + i];
  for (int i = threadIdx.x; i < cmd_k * 128; i += n)
    s_cmd[i] = cmd[g * cmd_k * 128 + i];
  for (int i = threadIdx.x; i < dist_k * 128; i += n)
    s_dist[i] = dist[g * dist_k * 128 + i];
  for (int i = threadIdx.x; i < DX_N; i += n) s_dx[i] = dx[i];
  for (int i = threadIdx.x; i < CONSTS_N; i += n) s_consts[i] = consts[i];
  __syncthreads();
}

__global__ void __launch_bounds__(DECODE2_BLOCK)
decode2_direct_kernel(const u32* __restrict__ wt, const i32* __restrict__ lit,
                      const i32* __restrict__ cmd, const i32* __restrict__ dist,
                      const i32* __restrict__ dx, const i32* __restrict__ consts,
                      const i32* __restrict__ start_bit,
                      const i32* __restrict__ mlen, u32* __restrict__ tok,
                      i32* __restrict__ count, i32* __restrict__ phase,
                      i32* __restrict__ widx, int n_lanes, Decode2Params P,
                      int lit_k, int cmd_k, int dist_k) {
  __shared__ i32 s_lit[LIT_K * 128];
  __shared__ i32 s_cmd[CMD_K * 128];
  __shared__ i32 s_dist[DIST_K * 128];
  __shared__ i32 s_dx[DX_N];
  __shared__ i32 s_consts[CONSTS_N];

  const int lane0 = blockIdx.x * DECODE2_BLOCK;
  load_tables2(lit, cmd, dist, dx, consts, lane0 / GROUP_LANES, lit_k, cmd_k,
               dist_k, s_lit, s_cmd, s_dist, s_dx, s_consts);
  const int lane = lane0 + threadIdx.x;
  if (lane >= n_lanes) return;
  const Decode2Tables T{s_lit, s_cmd, s_dist, s_dx, s_consts,
                        lit_k, cmd_k, dist_k};
  const Decode2Result r = decode2_lane(T, P, wt + lane, n_lanes,
                                       start_bit[lane], mlen[lane],
                                       tok + lane, n_lanes);
  count[lane] = r.count;
  phase[lane] = r.phase;
  widx[lane] = r.widx;
}

__global__ void __launch_bounds__(32 * WARPS2)
decode2_kernel(const u32* __restrict__ wt, const i32* __restrict__ lit,
               const i32* __restrict__ cmd, const i32* __restrict__ dist,
               const i32* __restrict__ dx, const i32* __restrict__ consts,
               const i32* __restrict__ start_bit, const i32* __restrict__ mlen,
               u32* __restrict__ tok, i32* __restrict__ count,
               i32* __restrict__ phase, i32* __restrict__ widx, int n_lanes,
               Decode2Params P, int lit_k, int cmd_k, int dist_k, int lpw) {
  __shared__ i32 s_lit[LIT_K * 128];
  __shared__ i32 s_cmd[CMD_K * 128];
  __shared__ i32 s_dist[DIST_K * 128];
  __shared__ i32 s_dx[DX_N];
  __shared__ i32 s_consts[CONSTS_N];
  __shared__ u32 s_q[QUEUE_R * 32 * WARPS2];

  const int lpb = lpw * WARPS2;
  const int lane0 = blockIdx.x * lpb;
  load_tables2(lit, cmd, dist, dx, consts, lane0 / GROUP_LANES, lit_k, cmd_k,
               dist_k, s_lit, s_cmd, s_dist, s_dx, s_consts);
  const int li = threadIdx.x & 31;
  if (li >= lpw) return;
  const int t = (threadIdx.x >> 5) * lpw + li;
  const int lane = lane0 + t;
  const Decode2Tables T{s_lit, s_cmd, s_dist, s_dx, s_consts,
                        lit_k, cmd_k, dist_k};
  Queued2 O{WordQueue{wt + lane, n_lanes, P.wpad, s_q + t, lpb}, tok + lane,
            n_lanes};
  const Decode2Result r =
      decode2_lane_queued(T, P, start_bit[lane], mlen[lane], O);
  count[lane] = r.count;
  phase[lane] = r.phase;
  widx[lane] = r.widx;
}

}  // namespace brotli_torch

using namespace brotli_torch;

static bool decode2_args_ok(int n_lanes, int lit_k, int cmd_k, int dist_k) {
  return n_lanes > 0 && n_lanes % GROUP_LANES == 0 && lit_k >= 2 &&
         lit_k <= LIT_K && cmd_k >= 2 && cmd_k <= CMD_K && dist_k >= 2 &&
         dist_k <= DIST_K;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// n_lanes must be a multiple of 1024 (whole groups).
extern "C" int brotli_torch_decode2_direct(
    const void* wt, const void* lit, const void* cmd, const void* dist,
    const void* dx, const void* consts, const void* start_bit,
    const void* mlen, void* tok, void* count, void* phase, void* widx,
    int n_lanes, int wpad, int cap, int npostfix, int ndirect, int maxbw,
    int lit_k, int cmd_k, int dist_k, void* stream) {
  if (!decode2_args_ok(n_lanes, lit_k, cmd_k, dist_k))
    return (int)cudaErrorInvalidValue;
  const Decode2Params P{npostfix, ndirect, maxbw, wpad, cap};
  decode2_direct_kernel<<<n_lanes / DECODE2_BLOCK, DECODE2_BLOCK, 0,
                          (cudaStream_t)stream>>>(
      (const u32*)wt, (const i32*)lit, (const i32*)cmd, (const i32*)dist,
      (const i32*)dx, (const i32*)consts, (const i32*)start_bit,
      (const i32*)mlen, (u32*)tok, (i32*)count, (i32*)phase, (i32*)widx,
      n_lanes, P, lit_k, cmd_k, dist_k);
  return (int)cudaGetLastError();
}

// The same through decode2_kernel, `lpw` lanes a warp (a power of two up
// to 32).
extern "C" int brotli_torch_decode2(
    const void* wt, const void* lit, const void* cmd, const void* dist,
    const void* dx, const void* consts, const void* start_bit,
    const void* mlen, void* tok, void* count, void* phase, void* widx,
    int n_lanes, int wpad, int cap, int npostfix, int ndirect, int maxbw,
    int lit_k, int cmd_k, int dist_k, int lpw, void* stream) {
  if (!decode2_args_ok(n_lanes, lit_k, cmd_k, dist_k) || lpw < 1 ||
      lpw > 32 || (lpw & (lpw - 1)) != 0 || n_lanes % (lpw * WARPS2) != 0)
    return (int)cudaErrorInvalidValue;
  const Decode2Params P{npostfix, ndirect, maxbw, wpad, cap};
  decode2_kernel<<<n_lanes / (lpw * WARPS2), 32 * WARPS2, 0,
                   (cudaStream_t)stream>>>(
      (const u32*)wt, (const i32*)lit, (const i32*)cmd, (const i32*)dist,
      (const i32*)dx, (const i32*)consts, (const i32*)start_bit,
      (const i32*)mlen, (u32*)tok, (i32*)count, (i32*)phase, (i32*)widx,
      n_lanes, P, lit_k, cmd_k, dist_k, lpw);
  return (int)cudaGetLastError();
}
