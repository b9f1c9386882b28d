// CUDA greedy parse of the device encoder.  Replaces the XLA `lax.scan` of
// brotli_tpu/ops/device_encode.py (greedy_parse), which has no
// `pallas_call`: on the TPU it is a scan over 64-position cells.
//
// Bound on Hopper: bytes.  mlen and mdist in (8 B a position), is_cs,
// is_lit and dcode_short out (6 B): 14 B x 1024 lanes x 32 KB = 470 MB at
// the main shape, 0.14 ms at 3.35 TB/s.  The work is serial only along a
// lane's frontier: the next copy starts at the first take position at or
// after the end of the last one.
//
// `parse_kernel` (the main path's, greedy_parse): a block of
// PARSE_THREADS threads a lane on a persistent grid (the blocks an SM
// holds on every SM, from cudaOccupancyMaxActiveBlocksPerMultiprocessor;
// at 25 KB of shared memory and 128 threads, 8 an SM, so 1024 lanes are
// resident at once on 132 SMs).  The lane in tiles of PARSE_TILE
// positions, each through the phases of csrc/parse.cuh, two tiles at a
// time: while warp 0 walks tile k (speculative walks of its
// PARSE_SEG-position segments at once, then one thread that follows the
// lane's path and jumps a segment where it meets its speculative path),
// lists its copies and finds its words' copy starts and literals, warps
// 1-3 wait for tile k + 1's mlen and mdist (cp.async), gate it (take words
// from four positions a thread, four ballots) and compute each take
// position's successor.  Then the block codes tile k (a block-wide prefix
// count of ring pushes), issues tile k + 2's copies into tile k's staging
// buffer and stores tile k's rows, coalesced.
//
// `parse_direct_kernel` (the first form, greedy_parse_direct, kept to be
// timed against): one warp per lane, in windows of 32 positions: the rows
// are lane-major, so each window is one coalesced 128-byte load of each
// input, with the next window's loads started before this one's walk.
// Every thread computes the score gate and the lazy look-ahead for its own
// position; the look-ahead into the next window is a shuffle of that
// window's scores.  One ballot turns the gate into the window's take mask,
// and the warp steps from copy to copy on it (parse_window), fetching a
// copy's length and distance by a shuffle from the thread that holds them.
// The frontier and the distance ring are warp-uniform registers, so the
// whole lane is one chain.  1024 lanes are 1024 warps, about 8 an SM.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "parse.cuh"

namespace brotli_torch {

constexpr int PARSE_BLOCK = 128;  // the direct kernel: 4 warps, 4 lanes
constexpr int PARSE_BLOCKS_PER_SM = 16;
constexpr u32 FULL = 0xFFFFFFFFu;

// Phases of a lane, for the build with -DENC_PHASE_CLOCKS
// (tools/enc_phases.py): the lane's leader thread (thread 0 of the warp in
// the direct kernel, of the block in parse_kernel) adds the clock64()
// cycles since its last mark to parse_clocks[kernel][phase].  The direct
// kernel's phases: the wait for the window's loads, the gate (scores,
// shuffles, ballots), the copy walk with the ring, the stores;
// parse_kernel's leader is thread 0, the walk's: the speculative walks,
// the resolution (the walk), the list and the words, then its wait for the
// gate warps (the next tile's copies, gate and succ), the codes and the
// stores.  A phase ends at a barrier, so the leader's cycles are the
// block's.
constexpr int PARSE_PH_LOAD = 0, PARSE_PH_GATE = 1, PARSE_PH_WALK = 2,
              PARSE_PH_STORE = 3, PARSE_PH_SPEC = 4, PARSE_PH_WORDS = 5,
              PARSE_PH_CODES = 6;

#if defined(ENC_PHASE_CLOCKS)
constexpr int PARSE_PHASES = 7;
__device__ unsigned long long parse_clocks[2][PARSE_PHASES];
// The sums stay in registers over a lane (a phase lasts a few hundred
// cycles, and an atomic a window would queue 1024 warps on a few words);
// the leader adds them to the counters when its lane ends.
struct ParseClock {
  unsigned long long* acc;
  unsigned long long sum[PARSE_PHASES];
  long long last;
  bool leader;
  __device__ ParseClock(int kernel, bool lead)
      : acc(parse_clocks[kernel]), leader(lead) {
    for (int k = 0; k < PARSE_PHASES; ++k) sum[k] = 0;
    last = clock64();
  }
  __device__ void mark(int phase) {
    const long long now = clock64();
    sum[phase] += (unsigned long long)(now - last);
    last = now;
  }
  __device__ void flush() {
#pragma unroll
    for (int k = 0; k < PARSE_PHASES; ++k) {
      if (leader && sum[k]) atomicAdd(&acc[k], sum[k]);
      sum[k] = 0;
    }
  }
};
#else
struct ParseClock {
  __device__ ParseClock(int, bool) {}
  __device__ void mark(int) {}
  __device__ void flush() {}
};
#endif

__global__ void __launch_bounds__(PARSE_BLOCK)
parse_direct_kernel(const i32* __restrict__ mlen, const i32* __restrict__ mdist,
                    const i32* __restrict__ n_valid, u8* __restrict__ is_cs,
                    u8* __restrict__ is_lit, i32* __restrict__ dcode,
                    int n_lanes, int n, ParseKnobs K) {
  const int t = threadIdx.x & 31;
  const int warps = PARSE_BLOCK / 32;
  ParseClock clk(0, t == 0);
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
      clk.mark(PARSE_PH_LOAD);
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
      clk.mark(PARSE_PH_GATE);
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
      clk.mark(PARSE_PH_WALK);
      if (here) {
        is_cs[row + p] = (u8)((w.cs >> t) & 1u);
        is_lit[row + p] = (u8)((w.lit >> t) & 1u);
        dcode[row + p] = my_dc;
      }
      l_cur = l_nxt;
      d_cur = d_nxt;
      sc_cur = sc_nxt;
      clk.mark(PARSE_PH_STORE);
    }
    clk.flush();
  }
}

// Phase 0, the gate warps (gt: a thread's index among them): the copies of
// the tile at `base` (PARSE_STAGE positions, cut at the lane's end) into
// staging buffer `buf`, as one commit group: 16-byte copies where the rows
// allow (`vec`: 16-byte aligned, n % 4 == 0, so the tile's length is a
// multiple of 4 too), else 4-byte ones.
__device__ void parse_stage(ParseTile& m, int buf, const i32* ml_g,
                            const i32* md_g, i32 base, i32 n, bool vec,
                            int gt) {
  const i32 len = min(PARSE_STAGE, n - base);
  if (vec) {
    const i32 q = len >> 2;
    for (i32 k = gt; k < 2 * q; k += PARSE_GATE_THREADS) {
      const bool d = k >= q;
      const i32 j = 4 * (d ? k - q : k);
      __pipeline_memcpy_async((d ? m.md[buf] : m.ml[buf]) + j,
                              (d ? md_g : ml_g) + base + j, 16);
    }
  } else {
    for (i32 k = gt; k < 2 * len; k += PARSE_GATE_THREADS) {
      const bool d = k >= len;
      const i32 j = d ? k - len : k;
      __pipeline_memcpy_async((d ? m.md[buf] : m.ml[buf]) + j,
                              (d ? md_g : ml_g) + base + j, 4);
    }
  }
  __pipeline_commit();
}

// bits x0..x7 of a byte to bits 0, 4, ..., 28
__device__ __forceinline__ u32 parse_spread4(u32 x) {
  x = (x | (x << 12)) & 0x000F000Fu;
  x = (x | (x << 6)) & 0x03030303u;
  return (x | (x << 3)) & 0x11111111u;
}

// The gate warps' barrier, apart from warp 0.
__device__ __forceinline__ void parse_gate_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(PARSE_GATE_THREADS) : "memory");
}

// Phases 1-2, the gate warps (gt: a thread's index among them): the take
// words and nz, then succ.  A thread takes four positions of its warp's run
// of 128 (parse_tile_take4), four ballots carry the bits, and lanes 0-3
// interleave them into the run's four words.
__device__ void parse_gate(ParseTile& m, const ParseTileCtx& c, int gt) {
  constexpr int runs = PARSE_TILE / 128, warps = PARSE_GATE_THREADS / 32;
  const int lt = gt & 31;
  u32 nzl = 0;
#pragma unroll
  for (int run = gt >> 5; run < runs; run += warps) {
    const u32 nib = parse_tile_take4(m, c, 128 * run + 4 * lt);
    u32 b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) b[k] = __ballot_sync(FULL, (nib >> k) & 1u);
    if (lt < 4) {
      u32 word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) word |= parse_spread4((b[k] >> (8 * lt)) & 0xFFu) << k;
      const int w = 4 * run + lt;
      m.take[c.buf][w] = word;
      nzl |= (u32)(word != 0) << w;
    }
  }
  nzl = __reduce_or_sync(FULL, nzl);
  if (lt == 0 && nzl) atomicOr(&m.nz[c.buf], nzl);
  parse_gate_sync();
  parse_tile_succ<PARSE_GATE_THREADS>(m, c, gt);
}

// Phase 3c, warp 0, a word a lane: each word's copy starts, the copies
// before it (an exclusive prefix count) and the last of them (a max scan),
// its copies into the list and its entry frontier; the tile's count.
__device__ void parse_list(ParseTile& m, const ParseTileCtx& c, int lt) {
  const u32 cs = lt < c.nw ? parse_word_starts(m, c, lt) : 0u;
  i32 count = __popc(cs), last = cs ? (lt << 5) + parse_top(cs) : -1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const i32 y = __shfl_up_sync(FULL, count, off);
    const i32 z = __shfl_up_sync(FULL, last, off);
    if (lt >= off) {
      count += y;
      last = max(last, z);
    }
  }
  const i32 before = __shfl_up_sync(FULL, last, 1);
  if (lt < c.nw)
    parse_word_list(m, c, lt, cs, count - __popc(cs), lt ? before : -1);
  if (lt == 31) m.cnt = count;
}

__global__ void __launch_bounds__(PARSE_THREADS, 8)
parse_kernel(const i32* __restrict__ mlen, const i32* __restrict__ mdist,
             const i32* __restrict__ n_valid, u8* __restrict__ is_cs,
             u8* __restrict__ is_lit, i32* __restrict__ dcode, int n_lanes,
             int n, ParseKnobs K) {
  __shared__ __align__(16) ParseTile m;
  const int tid = threadIdx.x, lt = tid & 31, warp = tid >> 5;
  const int gt = tid - 32;  // a gate warp's thread among them
  constexpr int warps = PARSE_THREADS / 32;
  const int n_tiles = (n + PARSE_TILE - 1) / PARSE_TILE;
  const bool vec =
      (n & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(mlen) | reinterpret_cast<uintptr_t>(mdist) |
        reinterpret_cast<uintptr_t>(dcode)) & 15) == 0 &&
      ((reinterpret_cast<uintptr_t>(is_cs) | reinterpret_cast<uintptr_t>(is_lit)) &
       3) == 0;
  ParseClock clk(1, tid == 0);
  for (int lane = blockIdx.x; lane < n_lanes; lane += gridDim.x) {
    const i64 row = (i64)lane * n;
    const i32 nv = n_valid[lane];
    i64 front = 0;  // thread 0's
    i32 ring[4] = {4, 11, 15, 16};
    auto ctx = [&](int k) {
      return parse_tile_ctx(K, n, nv, PARSE_TILE, PARSE_SEG_LOG, k);
    };
    // tile 0 through phases 0-2, tile 1's copies issued
    if (warp > 0) {
      if (gt == 0) m.nz[0] = m.nz[1] = 0;
      parse_stage(m, 0, mlen + row, mdist + row, 0, n, vec, gt);
      __pipeline_wait_prior(0);
      parse_gate_sync();
      parse_gate(m, ctx(0), gt);
      if (n_tiles > 1)
        parse_stage(m, 1, mlen + row, mdist + row, PARSE_TILE, n, vec, gt);
    }
    __syncthreads();
    for (int k = 0; k < n_tiles; ++k) {
      const ParseTileCtx c = ctx(k);
      if (warp == 0) {
        // 3-4 of tile k: the speculative walks, the resolution, the list
        // with the words' entry frontiers, the words (a word a lane)
        if (lt << PARSE_SEG_LOG < c.tn) parse_tile_spec(m, c, lt);
        __syncwarp();
        clk.mark(PARSE_PH_SPEC);
        if (lt == 0) front = parse_tile_resolve(m, c, front);
        __syncwarp();
        clk.mark(PARSE_PH_WALK);
        parse_list(m, c, lt);
        __syncwarp();
        parse_tile_words(m, c, lt, 32);
        clk.mark(PARSE_PH_WORDS);
      } else if (k + 1 < n_tiles) {
        // 0-2 of tile k + 1
        __pipeline_wait_prior(0);
        parse_gate_sync();
        parse_gate(m, ctx(k + 1), gt);
      }
      __syncthreads();
      clk.mark(PARSE_PH_GATE);

      // 5 of tile k, in chunks of a copy a thread: push flags, a ballot
      // prefix count a warp and the warps' totals, the pushed distances
      // (over the tile's staged mlen), each copy's code from the four
      // pushed before it
      i32* pushed = m.ml[c.buf];
      if (tid == 0) {
        m.nz[c.buf] = 0;
        for (int r = 0; r < 4; ++r) pushed[3 - r] = ring[r];
      }
      const i32 cnt = m.cnt;
      const i32* md = m.md[c.buf];
      i32 total = 0;
      for (i32 c0 = 0; c0 < cnt; c0 += PARSE_THREADS) {
        const i32 j = c0 + tid;
        i32 s = 0, d = 0;
        bool push = false;
        if (j < cnt) {
          s = m.list[j];
          d = md[s];
          push = parse_pushes(d, j ? md[m.list[j - 1]] : ring[0]);
        }
        const u32 bal = __ballot_sync(FULL, push);
        if (lt == 0) m.wsum[warp] = __popc(bal);
        __syncthreads();
        i32 pj = total + __popc(bal & ((1u << lt) - 1u));
        for (int w = 0; w < warps; ++w) {
          if (w < warp) pj += m.wsum[w];
          total += m.wsum[w];
        }
        if (push) pushed[4 + pj] = d;
        __syncthreads();
        if (j < cnt) m.code[s] = (i8)parse_code(pushed + 3 + pj, d);
      }
      if (cnt)
        for (int r = 0; r < 4; ++r) ring[r] = pushed[3 + total - r];
      __syncthreads();
      clk.mark(PARSE_PH_CODES);

      // tile k + 2's copies into tile k's staging; 6 of tile k
      if (warp > 0 && k + 2 < n_tiles)
        parse_stage(m, c.buf, mlen + row, mdist + row,
                    c.base + 2 * PARSE_TILE, n, vec, gt);
      parse_tile_store(m, c, is_cs + row, is_lit + row, dcode + row, vec, tid,
                       PARSE_THREADS);
      __syncthreads();
      clk.mark(PARSE_PH_STORE);
    }
    clk.flush();
  }
  __pipeline_wait_prior(0);
}

}  // namespace brotli_torch

using namespace brotli_torch;

// Launch parse_kernel on `stream`; returns cudaGetLastError() (0 on
// success).  mlen, mdist, dcode are (n_lanes, n) int32, is_cs and is_lit
// (n_lanes, n) bytes (torch.bool), n_valid (n_lanes,) int32.  A block a
// lane on a persistent grid: the blocks an SM holds on each of the card's
// `sms` SMs, at most one a lane.
extern "C" int brotli_torch_parse(const void* mlen, const void* mdist,
                                  const void* n_valid, void* is_cs,
                                  void* is_lit, void* dcode, int n_lanes,
                                  int n, int lazy0, int lazy1, int min_gate,
                                  int sms, void* stream) {
  if (n_lanes <= 0 || n <= 0 || sms <= 0) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, parse_kernel, PARSE_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const int blocks = n_lanes < sms * per_sm ? n_lanes : sms * per_sm;
  parse_kernel<<<blocks, PARSE_THREADS, 0, (cudaStream_t)stream>>>(
      (const i32*)mlen, (const i32*)mdist, (const i32*)n_valid, (u8*)is_cs,
      (u8*)is_lit, (i32*)dcode, n_lanes, n, ParseKnobs{lazy0, lazy1, min_gate});
  return (int)cudaGetLastError();
}

// The launch shape of parse_kernel on this card: threads a block, static
// shared bytes, blocks an SM, registers a thread, positions a tile.
extern "C" int brotli_torch_parse_config(void* out) {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, parse_kernel) != cudaSuccess) return 1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, parse_kernel, PARSE_THREADS, 0) != cudaSuccess)
    return 1;
  ((int*)out)[0] = PARSE_THREADS;
  ((int*)out)[1] = (int)a.sharedSizeBytes;
  ((int*)out)[2] = per_sm;
  ((int*)out)[3] = a.numRegs;
  ((int*)out)[4] = PARSE_TILE;
  return 0;
}

// Launch the first form (parse_direct_kernel, kept to be timed against);
// arguments as brotli_torch_parse.  The grid holds at most
// PARSE_BLOCKS_PER_SM blocks on each of the card's `sms` SMs; its warps
// step over the lanes.
extern "C" int brotli_torch_parse_direct(const void* mlen, const void* mdist,
                                         const void* n_valid, void* is_cs,
                                         void* is_lit, void* dcode,
                                         int n_lanes, int n, int lazy0,
                                         int lazy1, int min_gate, int sms,
                                         void* stream) {
  if (n_lanes <= 0 || n <= 0 || sms <= 0) return (int)cudaErrorInvalidValue;
  const int warps = PARSE_BLOCK / 32;
  int blocks = (n_lanes + warps - 1) / warps;
  if (blocks > sms * PARSE_BLOCKS_PER_SM) blocks = sms * PARSE_BLOCKS_PER_SM;
  parse_direct_kernel<<<blocks, PARSE_BLOCK, 0, (cudaStream_t)stream>>>(
      (const i32*)mlen, (const i32*)mdist, (const i32*)n_valid, (u8*)is_cs,
      (u8*)is_lit, (i32*)dcode, n_lanes, n, ParseKnobs{lazy0, lazy1, min_gate});
  return (int)cudaGetLastError();
}

#if defined(ENC_PHASE_CLOCKS)
// The phase clocks since the last call, [kernel][phase] as 2 x
// PARSE_PHASES uint64 (kernel 0 the direct one, 1 parse_kernel), then
// zeroed.
extern "C" int brotli_torch_parse_clocks(void* out) {
  cudaError_t rc = cudaMemcpyFromSymbol(out, parse_clocks, sizeof(parse_clocks));
  if (rc != cudaSuccess) return (int)rc;
  static const unsigned long long zero[2][PARSE_PHASES] = {};
  return (int)cudaMemcpyToSymbol(parse_clocks, zero, sizeof(zero));
}
#endif
