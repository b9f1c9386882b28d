// CUDA entropy kernel: v2 shared-table decode, one thread per stream.
// Replaces brotli_tpu/ops/pallas_decode2.py `_build` / `kernel`.
//
// Bound on Hopper: latency.  Each lane is a serial chain of dependent table
// reads and bit shifts (one row at a time), so a thread issues little work
// per cycle and the card is fed only by having many lanes in flight.  The
// design keeps the chain short: a block holds 128 lanes of ONE group, copies
// that group's tables (about 14 KB) into shared memory once, and each
// thread reads its words from the word-major table (neighbouring lanes at
// neighbouring addresses) and writes its tokens token-major.  With 4096
// lanes that is 32 blocks on 132 SMs: the occupancy limit of this simple
// first version.
#include <cuda_runtime.h>

#include "decode2.cuh"

namespace brotli_torch {

constexpr int DECODE2_BLOCK = 128;  // divides the 1024 lanes of a group
constexpr int GROUP_LANES = 1024;

__global__ void __launch_bounds__(DECODE2_BLOCK)
decode2_kernel(const u32* __restrict__ wt, const i32* __restrict__ lit,
               const i32* __restrict__ cmd, const i32* __restrict__ dist,
               const i32* __restrict__ dx, const i32* __restrict__ consts,
               const i32* __restrict__ start_bit, const i32* __restrict__ mlen,
               u32* __restrict__ tok, i32* __restrict__ count,
               i32* __restrict__ phase, i32* __restrict__ widx, int n_lanes,
               Decode2Params P, int lit_k, int cmd_k, int dist_k) {
  __shared__ i32 s_lit[LIT_K * 128];
  __shared__ i32 s_cmd[CMD_K * 128];
  __shared__ i32 s_dist[DIST_K * 128];
  __shared__ i32 s_dx[DX_N];
  __shared__ i32 s_consts[CONSTS_N];

  const int lane0 = blockIdx.x * DECODE2_BLOCK;
  const int g = lane0 / GROUP_LANES;
  for (int i = threadIdx.x; i < lit_k * 128; i += DECODE2_BLOCK)
    s_lit[i] = lit[g * lit_k * 128 + i];
  for (int i = threadIdx.x; i < cmd_k * 128; i += DECODE2_BLOCK)
    s_cmd[i] = cmd[g * cmd_k * 128 + i];
  for (int i = threadIdx.x; i < dist_k * 128; i += DECODE2_BLOCK)
    s_dist[i] = dist[g * dist_k * 128 + i];
  for (int i = threadIdx.x; i < DX_N; i += DECODE2_BLOCK) s_dx[i] = dx[i];
  for (int i = threadIdx.x; i < CONSTS_N; i += DECODE2_BLOCK)
    s_consts[i] = consts[i];
  __syncthreads();

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

}  // namespace brotli_torch

using namespace brotli_torch;

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// n_lanes must be a multiple of 1024 (whole groups).
extern "C" int brotli_torch_decode2(
    const void* wt, const void* lit, const void* cmd, const void* dist,
    const void* dx, const void* consts, const void* start_bit,
    const void* mlen, void* tok, void* count, void* phase, void* widx,
    int n_lanes, int wpad, int cap, int npostfix, int ndirect, int maxbw,
    int lit_k, int cmd_k, int dist_k, void* stream) {
  if (n_lanes <= 0 || n_lanes % GROUP_LANES != 0 || lit_k < 2 ||
      lit_k > LIT_K || cmd_k < 2 || cmd_k > CMD_K || dist_k < 2 ||
      dist_k > DIST_K)
    return (int)cudaErrorInvalidValue;
  const Decode2Params P{npostfix, ndirect, maxbw, wpad, cap};
  decode2_kernel<<<n_lanes / DECODE2_BLOCK, DECODE2_BLOCK, 0,
                   (cudaStream_t)stream>>>(
      (const u32*)wt, (const i32*)lit, (const i32*)cmd, (const i32*)dist,
      (const i32*)dx, (const i32*)consts, (const i32*)start_bit,
      (const i32*)mlen, (u32*)tok, (i32*)count, (i32*)phase, (i32*)widx,
      n_lanes, P, lit_k, cmd_k, dist_k);
  return (int)cudaGetLastError();
}
