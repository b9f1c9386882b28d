// CUDA greedy parse of the device encoder: one warp per lane.  Replaces the
// XLA `lax.scan` of brotli_tpu/ops/device_encode.py (greedy_parse), which
// has no `pallas_call`: on the TPU it is a scan over 64-position cells.
//
// Bound on Hopper: bytes.  mlen and mdist in (8 B a position), is_cs,
// is_lit and dcode_short out (6 B): 14 B x 1024 lanes x 32 KB = 470 MB at
// the main shape, 0.14 ms at 3.35 TB/s.  The work is serial only along a
// lane's walk, and the walk touches only copy starts (csrc/parse.cuh).  So
// a warp takes a lane and reads it in windows of 32 positions: the rows are
// lane-major, so each window is one coalesced 128-byte load of each input,
// with the next window's loads started before this one's walk.  Every thread
// computes the score gate and the lazy look-ahead for its own position; the
// look-ahead into the next window is a shuffle of that window's scores.
// One ballot turns the gate into the window's take mask, and the warp steps
// from copy to copy on it, fetching a copy's length and distance by a
// shuffle from the thread that holds them.  The frontier and the distance
// ring are warp-uniform registers.  Each window's three outputs are written
// once, coalesced.  1024 lanes are 1024 warps, about 8 an SM.
#include <cuda_runtime.h>

#include "parse.cuh"

namespace brotli_torch {

constexpr int PARSE_BLOCK = 128;  // 4 warps, 4 lanes
constexpr int PARSE_BLOCKS_PER_SM = 16;
constexpr u32 FULL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(PARSE_BLOCK)
parse_kernel(const i32* __restrict__ mlen, const i32* __restrict__ mdist,
             const i32* __restrict__ n_valid, u8* __restrict__ is_cs,
             u8* __restrict__ is_lit, i32* __restrict__ dcode, int n_lanes,
             int n, ParseKnobs K) {
  const int t = threadIdx.x & 31;
  const int warps = PARSE_BLOCK / 32;
  for (int lane = blockIdx.x * warps + (threadIdx.x >> 5); lane < n_lanes;
       lane += gridDim.x * warps) {
    const i64 row = (i64)lane * n;
    const i32 nv = n_valid[lane];
    ParseLane s = parse_lane_init();
    i32 l_cur = 0, d_cur = 0, sc_cur = 0;
    if (t < n) {
      l_cur = mlen[row + t];
      d_cur = mdist[row + t];
      sc_cur = parse_score(l_cur, d_cur);
    }
    for (i32 base = 0; base < n; base += PARSE_W) {
      const i32 p = base + t;
      const i32 q = p + PARSE_W;  // this thread's position in the next window
      i32 l_nxt = 0, d_nxt = 0, sc_nxt = 0;
      if (q < n) {
        l_nxt = mlen[row + q];
        d_nxt = mdist[row + q];
        sc_nxt = parse_score(l_nxt, d_nxt);
      }
      // scores one and two positions ahead (0 past the lane's end)
      const int t1 = (t + 1) & 31, t2 = (t + 2) & 31;
      const i32 a1 = __shfl_sync(FULL, sc_cur, t1);
      const i32 b1 = __shfl_sync(FULL, sc_nxt, t1);
      const i32 a2 = __shfl_sync(FULL, sc_cur, t2);
      const i32 b2 = __shfl_sync(FULL, sc_nxt, t2);
      const i32 s1 = t < 31 ? a1 : b1;
      const i32 s2 = t < 30 ? a2 : b2;
      const bool here = p < n;
      const u32 take = __ballot_sync(
          FULL, here && parse_take(K, l_cur, sc_cur, s1, s2, p, nv));
      const u32 in_chunk = __ballot_sync(FULL, here && p < nv);
      i32 my_dc = -1;
      const ParseWindow w = parse_window(
          s, base, take, in_chunk,
          [&](int i, i32& len, i32& d) {
            len = __shfl_sync(FULL, l_cur, i);
            d = __shfl_sync(FULL, d_cur, i);
          },
          [&](int i, i32 dc) {
            if (t == i) my_dc = dc;
          });
      if (here) {
        is_cs[row + p] = (u8)((w.cs >> t) & 1u);
        is_lit[row + p] = (u8)((w.lit >> t) & 1u);
        dcode[row + p] = my_dc;
      }
      l_cur = l_nxt;
      d_cur = d_nxt;
      sc_cur = sc_nxt;
    }
  }
}

}  // namespace brotli_torch

using namespace brotli_torch;

// Launch on `stream`; returns cudaGetLastError() (0 on success).  mlen,
// mdist, dcode are (n_lanes, n) int32, is_cs and is_lit (n_lanes, n) bytes
// (torch.bool), n_valid (n_lanes,) int32.  The grid holds at most
// PARSE_BLOCKS_PER_SM blocks on each of the card's `sms` SMs; its warps
// step over the lanes.
extern "C" int brotli_torch_parse(const void* mlen, const void* mdist,
                                  const void* n_valid, void* is_cs,
                                  void* is_lit, void* dcode, int n_lanes,
                                  int n, int lazy0, int lazy1, int min_gate,
                                  int sms, void* stream) {
  if (n_lanes <= 0 || n <= 0 || sms <= 0) return (int)cudaErrorInvalidValue;
  const int warps = PARSE_BLOCK / 32;
  int blocks = (n_lanes + warps - 1) / warps;
  if (blocks > sms * PARSE_BLOCKS_PER_SM) blocks = sms * PARSE_BLOCKS_PER_SM;
  parse_kernel<<<blocks, PARSE_BLOCK, 0, (cudaStream_t)stream>>>(
      (const i32*)mlen, (const i32*)mdist, (const i32*)n_valid, (u8*)is_cs,
      (u8*)is_lit, (i32*)dcode, n_lanes, n, ParseKnobs{lazy0, lazy1, min_gate});
  return (int)cudaGetLastError();
}
