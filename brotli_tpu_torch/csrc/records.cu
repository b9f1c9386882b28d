// CUDA record builder of the device encoder.  Replaces the XLA stage
// brotli_tpu/ops/device_encode.py `build_records` (stage 3 of
// `_jitted_stages`), which has no `pallas_call`: on the TPU it is a
// `lax.cummax`, three reversed `lax.cummin`s and some thirty elementwise
// ops over (B, N) arrays.
//
// Bound on Hopper: bytes.  A 32 KB lane reads the data, mlen, mdist,
// dcode_short (4 B each), is_cs and is_lit (1 B each), 15 B a position,
// and writes rec0 and rec1 (8 B a row): 1024 lanes move 772 MB, 0.23 ms
// at 3.35 TB/s.  Both scans are carried across the lane, so a lane's
// positions cannot be handed out independently; what the card needs is
// enough loads in flight.
//
// `records_kernel` (the main path's, build_records): a block of
// REC_THREADS threads a lane, the grid persistent (the blocks an SM holds
// on every SM, from cudaOccupancyMaxActiveBlocksPerMultiprocessor).  The
// lane is cut into tiles of REC_TILE positions, a run of REC_ITEMS
// consecutive positions a thread (records.cuh rec_run_*):
//
// 0. the tiles' maxima of copy ends (coalesced loads of is_cs and mlen),
//    and from them each tile's running maximum from the tiles below it
//    and the tail command;
// 1. tiles from the top: the tile's inputs staged in shared memory with
//    coalesced loads (one pad word every 32, so a thread's run of 8 falls
//    in distinct banks; the byte arrays with 16 positions of halo, as
//    words where the row is 4-byte aligned);
// 2. forward: each run's maximum, a block-wide exclusive max-scan from the
//    tile's carry, and each run's aggregate of the packed payloads;
// 3. backward: a block-wide exclusive suffix-min scan of the aggregates
//    from the tile above's carry, then each thread walks its run down and
//    writes its rows into a staging tile in shared memory;
// 4. the staged rows stored with coalesced writes.
//
// The insert lengths never touch device memory: each thread recomputes its
// run's from the scan's carry (the staged mlen is read twice), so no
// scratch row and no barrier between the passes' reads and writes.  A
// scan is one shuffle scan a warp and one over the warps' totals a tile,
// where the direct kernel takes three 5-step shuffle scans a window of 32
// positions.
//
// `records_direct_kernel` (the first form, build_records_direct, kept to
// be timed against): a warp a lane in blocks of 4 warps, the lane in
// windows of 32 positions, one a thread:
//
// 1. forward, windows ascending: the running maximum of copy ends (a
//    shuffle max-scan) gives each copy start its insert length, which is
//    kept in the lane's own rec1 row at index p + 1 until the backward pass
//    reads it (no scratch buffer);
// 2. backward, windows descending: each thread takes position q, computes
//    its copy's codes (csrc/records.cuh) and the suffix minima of the three
//    packed payloads (a shuffle min-scan from the top lane, the carry from
//    the window above), then writes the row of position q + 1, which needs
//    exactly the copy data and minima at q.  The row lands on rec1 index
//    q + 2, the slot the thread of q + 1 read its insert length from, so a
//    __syncwarp separates the window's reads from its writes; lower
//    windows read only lower indices.  Thread 0 of the last window also
//    writes rows 0 and 1.
//
// The constant tables (insert and copy offsets, the two context LUTs: 4.3
// KB) are staged once a block in shared memory.
#include <cuda_runtime.h>

#include "records.cuh"

namespace brotli_torch {

constexpr int REC_BLOCK = 128;  // the direct kernel: 4 warps, 4 lanes
constexpr int REC_BLOCKS_PER_SM = 16;
constexpr u32 REC_FULL = 0xFFFFFFFFu;

// Phases of a lane, for the build with -DENC_PHASE_CLOCKS
// (tools/enc_phases.py): the lane's leader thread (thread 0 of the warp in
// the direct kernel, of the block in records_kernel) adds the clock64()
// cycles since its last mark to rec_clocks[kernel][phase].
constexpr int REC_PH_TABLE = 0, REC_PH_FORWARD = 1, REC_PH_BACKWARD = 2,
              REC_PH_MAXIMA = 3, REC_PH_LOAD = 4, REC_PH_STORE = 5;

#if defined(ENC_PHASE_CLOCKS)
constexpr int REC_PHASES = 6;
__device__ unsigned long long rec_clocks[2][REC_PHASES];
struct RecClock {
  unsigned long long* acc;
  long long last;
  bool leader;
  __device__ RecClock(int kernel, bool lead)
      : acc(rec_clocks[kernel]), leader(lead) {
    last = clock64();
  }
  __device__ void mark(int phase) {
    if (leader) {
      const long long now = clock64();
      atomicAdd(&acc[phase], (unsigned long long)(now - last));
      last = now;
    }
  }
};
#else
struct RecClock {
  __device__ RecClock(int, bool) {}
  __device__ void mark(int) {}
};
#endif

__global__ void __launch_bounds__(REC_BLOCK)
records_direct_kernel(const u8* __restrict__ data, const i32* __restrict__ mlen,
               const i32* __restrict__ mdist, const u8* __restrict__ is_cs,
               const u8* __restrict__ is_lit, const i32* __restrict__ dshort,
               const i32* __restrict__ n_valid, const i32* __restrict__ tab_g,
               i32* __restrict__ rec0, i32* __restrict__ rec1,
               i32* __restrict__ n_rec, int n_lanes, int n, int dstride,
               bool lit_ctx) {
  __shared__ i32 tab[REC_TAB_N];
  RecClock clk(0, (threadIdx.x & 31) == 0);
  for (int i = threadIdx.x; i < REC_TAB_N; i += blockDim.x) tab[i] = tab_g[i];
  __syncthreads();
  clk.mark(REC_PH_TABLE);
  const int t = threadIdx.x & 31;
  const int warps = REC_BLOCK / 32;
  for (int lane = blockIdx.x * warps + (threadIdx.x >> 5); lane < n_lanes;
       lane += gridDim.x * warps) {
    const i64 row = (i64)lane * n;
    const i64 orow = (i64)lane * (n + 1);
    const u8* d = data + (i64)lane * dstride;
    const i32 nv = n_valid[lane];

    // 1: insert lengths
    i32 carry = -1;
    for (i32 base = 0; base < n; base += 32) {
      const i32 p = base + t;
      const bool cs = p < n && is_cs[row + p];
      i32 x = cs ? p + mlen[row + p] : -1;
      for (int off = 1; off < 32; off <<= 1) {
        const i32 y = __shfl_up_sync(REC_FULL, x, off);
        if (t >= off) x = max(x, y);
      }
      x = max(x, carry);
      i32 prev = __shfl_up_sync(REC_FULL, x, 1);
      if (t == 0) prev = carry;
      if (p < n) rec1[orow + p + 1] = cs ? p - max(prev, 0) : 0;
      carry = __shfl_sync(REC_FULL, x, 31);
    }
    const RecTail tail = rec_tail(tab, nv, carry);
    clk.mark(REC_PH_FORWARD);

    // 2: codes, suffix minima and rows
    RecNext above{REC_BIG, REC_BIG, REC_BIG};
    i32 count = 0;
    for (i32 base = ((n - 1) >> 5) << 5; base >= 0; base -= 32) {
      const i32 q = base + t;
      RecCopy rc = rec_no_copy();
      bool cs = false;
      if (q < n) {
        cs = is_cs[row + q];
        rc = rec_copy(tab, cs, rec1[orow + q + 1], mlen[row + q],
                      mdist[row + q], dshort[row + q]);
      }
      RecNext s = rec_next_of(cs, q, rc);
      for (int off = 1; off < 32; off <<= 1) {
        const RecNext y{__shfl_down_sync(REC_FULL, s.p, off),
                        __shfl_down_sync(REC_FULL, s.i, off),
                        __shfl_down_sync(REC_FULL, s.c, off)};
        if (t + off < 32) s = rec_next_min(s, y);
      }
      s = rec_next_min(s, above);
      __syncwarp();
      i32 r0, r1;
      if (q + 1 < n) {
        const i32 p = q + 1;
        const bool cmd_slot = q >= 1 && is_cs[row + q - 1];
        const i32 lc = rec_lit_code(tab, lit_ctx, d[p], d[q],
                                    q >= 1 ? d[q - 1] : 0);
        rec_row(cmd_slot, rc, s, is_lit[row + p], lc, tail, r0, r1);
        rec0[orow + p + 1] = r0;
        rec1[orow + p + 1] = r1;
        count += r0 != 0;
      }
      if (q == 0) {
        rec_row(false, rec_no_copy(), s, is_lit[row],
                rec_lit_code(tab, lit_ctx, d[0], 0, 0), tail, r0, r1);
        rec0[orow + 1] = r0;
        rec1[orow + 1] = r1;
        count += r0 != 0;
        rec_first(s, nv, tail, r0, r1);
        rec0[orow] = r0;
        rec1[orow] = r1;
        count += r0 != 0;
      }
      above = RecNext{__shfl_sync(REC_FULL, s.p, 0),
                      __shfl_sync(REC_FULL, s.i, 0),
                      __shfl_sync(REC_FULL, s.c, 0)};
    }
    for (int off = 16; off > 0; off >>= 1)
      count += __shfl_down_sync(REC_FULL, count, off);
    if (t == 0) n_rec[lane] = count;
    clk.mark(REC_PH_BACKWARD);
  }
}

// ---------------------------------------------------------------------------
// records_kernel: a block a lane
// ---------------------------------------------------------------------------

constexpr int REC_THREADS = 256;
constexpr int REC_WARPS = REC_THREADS / 32;
constexpr int REC_TILE = REC_THREADS * REC_ITEMS;    // positions a tile
constexpr int REC_HALO = 16;                          // staged bytes past it
constexpr int REC_SPAN = REC_TILE + 2 * REC_HALO;     // staged bytes a tile
constexpr int REC_PADDED = REC_TILE + REC_TILE / 32;  // staged words a tile

// Word j of a staged tile, one pad word every 32: the words of a thread's
// run (8 t .. 8 t + 7) fall in 32 distinct banks across a warp.
BROTLI_HD int rec_pad(int j) { return j + (j >> 5); }

// The block's shared memory; the lane's tile carries (n_tiles words)
// follow it.
struct RecTile {
  i32 tab[REC_TAB_N];
  // mlen, mdist, dshort; then each copy start's prefix, insert and copy
  // extras (RecTileKeep)
  i32 ml[REC_PADDED], md[REC_PADDED], ds[REC_PADDED];
  // the staged rows; before them each copy start's distance record
  i32 o0[REC_PADDED], o1[REC_PADDED];
  alignas(16) u8 cs[REC_SPAN];
  alignas(16) u8 lit[REC_SPAN];
  alignas(16) u8 d[REC_SPAN];
  i32 wmax[REC_WARPS];
  RecNext wnext[REC_WARPS];
  i32 total, count;
};

struct RecTileIn {
  const RecTile& s;
  i32 base;
  BROTLI_HD bool cs(i32 p) const { return s.cs[p - base + REC_HALO] != 0; }
  BROTLI_HD bool lit(i32 p) const { return s.lit[p - base + REC_HALO] != 0; }
  BROTLI_HD i32 byte(i32 p) const { return s.d[p - base + REC_HALO]; }
  BROTLI_HD i32 mlen(i32 p) const { return s.ml[rec_pad(p - base)]; }
  BROTLI_HD i32 mdist(i32 p) const { return s.md[rec_pad(p - base)]; }
  BROTLI_HD i32 dshort(i32 p) const { return s.ds[rec_pad(p - base)]; }
};

// A copy start's data in its own staged slots, which nothing reads after
// its run has read them: the packed payloads' fields where mlen, mdist and
// dcode_short were, the distance record where its row will be staged.
struct RecTileKeep {
  RecTile& s;
  i32 base;
  BROTLI_HD void put(i32 q, const RecCopy& rc) const {
    const int j = rec_pad(q - base);
    s.ml[j] = rc.prefix;
    s.md[j] = rc.insval;
    s.ds[j] = rc.cpval;
    s.o0[j] = rc.dist_rec ? rc.dcode : -1;
    s.o1[j] = rc.dval;
  }
  BROTLI_HD RecCopy get(i32 q) const {
    const int j = rec_pad(q - base);
    const i32 dc = s.o0[j];
    return RecCopy{s.ml[j], s.md[j], s.ds[j], dc >= 0, dc >= 0 ? dc : 0,
                   s.o1[j]};
  }
};

// Rows from base + 2 go to the staging tile (the row of position q + 1
// at q's slot), rows 0 and 1 straight to the lane's rows.
struct RecTileOut {
  RecTile& s;
  i32 base;
  i32* rec0;
  i32* rec1;
  BROTLI_HD void row(i32 r, i32 a, i32 b) const {
    if (r >= base + 2) {
      const int j = rec_pad(r - base - 2);
      s.o0[j] = a;
      s.o1[j] = b;
    } else {
      rec0[r] = a;
      rec1[r] = b;
    }
  }
};

// dst[j] = src[lo + j] for lo + j in [0, n), else 0, for j < REC_SPAN: as
// words where src is 4-byte aligned (lo is a multiple of 4).
__device__ void rec_stage_bytes(u8* dst, const u8* src, i32 lo, i32 n) {
  if ((reinterpret_cast<uintptr_t>(src) & 3) == 0) {
    for (int w = threadIdx.x; w < REC_SPAN / 4; w += REC_THREADS) {
      const i32 p = lo + 4 * w;
      u32 v = 0;
      if (p >= 0 && p + 4 <= n) {
        v = *reinterpret_cast<const u32*>(src + p);
      } else {
        for (int k = 0; k < 4; ++k)
          if (p + k >= 0 && p + k < n) v |= (u32)src[p + k] << (8 * k);
      }
      reinterpret_cast<u32*>(dst)[w] = v;
    }
  } else {
    for (int j = threadIdx.x; j < REC_SPAN; j += REC_THREADS) {
      const i32 p = lo + j;
      dst[j] = (p >= 0 && p < n) ? src[p] : 0;
    }
  }
}

__global__ void __launch_bounds__(REC_THREADS)
records_kernel(const u8* __restrict__ data, const i32* __restrict__ mlen,
               const i32* __restrict__ mdist, const u8* __restrict__ is_cs,
               const u8* __restrict__ is_lit, const i32* __restrict__ dshort,
               const i32* __restrict__ n_valid, const i32* __restrict__ tab_g,
               i32* __restrict__ rec0, i32* __restrict__ rec1,
               i32* __restrict__ n_rec, int n_lanes, int n, int dstride,
               bool lit_ctx) {
  extern __shared__ __align__(16) unsigned char rec_smem[];
  RecTile& s = *reinterpret_cast<RecTile*>(rec_smem);
  i32* below = reinterpret_cast<i32*>(rec_smem + sizeof(RecTile));
  const int tid = threadIdx.x, lane_t = tid & 31, warp = tid >> 5;
  RecClock clk(1, tid == 0);
  for (int i = tid; i < REC_TAB_N; i += REC_THREADS) s.tab[i] = tab_g[i];
  const int n_tiles = (n + REC_TILE - 1) / REC_TILE;
  __syncthreads();
  clk.mark(REC_PH_TABLE);
  for (int lane = blockIdx.x; lane < n_lanes; lane += gridDim.x) {
    const i64 row = (i64)lane * n;
    const i64 orow = (i64)lane * (n + 1);
    const u8* cs_g = is_cs + row;
    const i32* ml_g = mlen + row;
    const i32 nv = n_valid[lane];

    // 0: each tile's maximum of copy ends, every thread its run of each
    // tile (the loads of all tiles independent, mlen as 16-byte vectors
    // where the row allows); then each tile's carry from the tiles below
    // it, and the lane's
    for (int k = tid; k < n_tiles; k += REC_THREADS) below[k] = -1;
    __syncthreads();
    const bool vec = ((reinterpret_cast<uintptr_t>(ml_g) & 15) |
                      (reinterpret_cast<uintptr_t>(cs_g) & 7)) == 0;
#pragma unroll 4
    for (int k = 0; k < n_tiles; ++k) {
      const i32 lo = k * REC_TILE + tid * REC_ITEMS;
      i32 m = -1;
      if (vec && lo + REC_ITEMS <= n) {
        const unsigned long long c8 =
            *reinterpret_cast<const unsigned long long*>(cs_g + lo);
        const int4 a = *reinterpret_cast<const int4*>(ml_g + lo);
        const int4 b = *reinterpret_cast<const int4*>(ml_g + lo + 4);
        const i32 e[REC_ITEMS] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int j = 0; j < REC_ITEMS; ++j)
          if ((c8 >> (8 * j)) & 0xFFu) m = max(m, lo + j + e[j]);
      } else {
        for (int j = 0; j < REC_ITEMS && lo + j < n; ++j)
          if (cs_g[lo + j]) m = max(m, lo + j + ml_g[lo + j]);
      }
      for (int off = 16; off > 0; off >>= 1)
        m = max(m, __shfl_xor_sync(REC_FULL, m, off));
      if (lane_t == 0 && m >= 0) atomicMax(&below[k], m);
    }
    __syncthreads();
    if (tid == 0) {
      i32 c = -1;
      for (int k = 0; k < n_tiles; ++k) {
        const i32 m = below[k];
        below[k] = c;
        c = max(c, m);
      }
      s.total = c;
      s.count = 0;
    }
    __syncthreads();
    clk.mark(REC_PH_MAXIMA);
    const RecTail tail = rec_tail(s.tab, nv, s.total);

    RecNext above{REC_BIG, REC_BIG, REC_BIG};
    i32 count = 0;
    for (int k = n_tiles - 1; k >= 0; --k) {
      const i32 base = k * REC_TILE;
      // 1: stage the tile
      rec_stage_bytes(s.cs, cs_g, base - REC_HALO, n);
      rec_stage_bytes(s.lit, is_lit + row, base - REC_HALO, n);
      rec_stage_bytes(s.d, data + (i64)lane * dstride, base - REC_HALO, n);
      for (int j = tid; j < REC_TILE; j += REC_THREADS) {
        const i32 p = base + j;
        const bool in = p < n;
        s.ml[rec_pad(j)] = in ? ml_g[p] : 0;
        s.md[rec_pad(j)] = in ? mdist[row + p] : 0;
        s.ds[rec_pad(j)] = in ? dshort[row + p] : 0;
      }
      __syncthreads();
      clk.mark(REC_PH_LOAD);

      // 2: forward.  The exclusive running maximum of copy ends at the
      // run, from the tile's carry; the run's copies and aggregate
      const RecTileIn in{s, base};
      const i32 lo = base + tid * REC_ITEMS;
      const u32 starts = rec_run_starts(in, lo, n);
      i32 x = rec_run_max(in, lo, starts, -1);
      for (int off = 1; off < 32; off <<= 1) {
        const i32 y = __shfl_up_sync(REC_FULL, x, off);
        if (lane_t >= off) x = max(x, y);
      }
      if (lane_t == 31) s.wmax[warp] = x;
      i32 prev = __shfl_up_sync(REC_FULL, x, 1);
      __syncthreads();
      i32 wpre = below[k];
      for (int w = 0; w < warp; ++w) wpre = max(wpre, s.wmax[w]);
      prev = lane_t == 0 ? wpre : max(wpre, prev);
      const RecTileKeep keep{s, base};
      RecNext agg = rec_run_copies(s.tab, in, lo, starts, prev, keep);
      clk.mark(REC_PH_FORWARD);

      // 3: backward.  The exclusive suffix minima past the run, from the
      // tile above's carry; the run's rows into the staging tile
      RecNext y = agg;
      for (int off = 1; off < 32; off <<= 1) {
        const RecNext z{__shfl_down_sync(REC_FULL, y.p, off),
                        __shfl_down_sync(REC_FULL, y.i, off),
                        __shfl_down_sync(REC_FULL, y.c, off)};
        if (lane_t + off < 32) y = rec_next_min(y, z);
      }
      if (lane_t == 0) s.wnext[warp] = y;
      RecNext nx{__shfl_down_sync(REC_FULL, y.p, 1),
                 __shfl_down_sync(REC_FULL, y.i, 1),
                 __shfl_down_sync(REC_FULL, y.c, 1)};
      __syncthreads();
      RecNext wsuf = above;
      for (int w = REC_WARPS - 1; w > warp; --w)
        wsuf = rec_next_min(wsuf, s.wnext[w]);
      nx = lane_t == 31 ? wsuf : rec_next_min(wsuf, nx);
      for (int w = 0; w < REC_WARPS; ++w)
        above = rec_next_min(above, s.wnext[w]);
      RecTileOut out{s, base, rec0 + orow, rec1 + orow};
      count += rec_run_rows(s.tab, in, lo, n, starts, nx, tail, lit_ctx, nv,
                            keep, out);
      __syncthreads();
      clk.mark(REC_PH_BACKWARD);

      // 4: the tile's rows base + 2 .. base + REC_TILE + 1, coalesced
      for (int j = tid; j < REC_TILE; j += REC_THREADS) {
        const i32 r = base + 2 + j;
        if (r <= n) {
          rec0[orow + r] = s.o0[rec_pad(j)];
          rec1[orow + r] = s.o1[rec_pad(j)];
        }
      }
      clk.mark(REC_PH_STORE);
    }
    for (int off = 16; off > 0; off >>= 1)
      count += __shfl_xor_sync(REC_FULL, count, off);
    if (lane_t == 0) atomicAdd(&s.count, count);
    __syncthreads();
    if (tid == 0) n_rec[lane] = s.count;
  }
}

// Dynamic shared bytes of a records_kernel block at n.
inline size_t rec_smem_bytes(int n) {
  return sizeof(RecTile) + 4 * (size_t)((n + REC_TILE - 1) / REC_TILE);
}

}  // namespace brotli_torch

using namespace brotli_torch;

// Launch the first form (the first design, kept to be timed against) on
// `stream`; returns cudaGetLastError() (0 on success).  data is (n_lanes,
// dstride) bytes with dstride >= n; mlen, mdist, dshort (n_lanes, n) int32;
// is_cs, is_lit (n_lanes, n) bytes (torch.bool); n_valid (n_lanes,) int32;
// tab the REC_TAB_N-word table of records.cuh; rec0 and rec1 (n_lanes,
// n + 1) int32; n_rec (n_lanes,) int32.  The grid holds at most
// REC_BLOCKS_PER_SM blocks on each of the card's `sms` SMs; its warps step
// over the lanes.
extern "C" int brotli_torch_records_direct(
    const void* data, const void* mlen, const void* mdist, const void* is_cs,
    const void* is_lit, const void* dshort, const void* n_valid,
    const void* tab, void* rec0, void* rec1, void* n_rec, int n_lanes, int n,
    int dstride, int lit_ctx, int sms, void* stream) {
  if (n_lanes <= 0 || n <= 0 || dstride < n || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const int warps = REC_BLOCK / 32;
  int blocks = (n_lanes + warps - 1) / warps;
  if (blocks > sms * REC_BLOCKS_PER_SM) blocks = sms * REC_BLOCKS_PER_SM;
  records_direct_kernel<<<blocks, REC_BLOCK, 0, (cudaStream_t)stream>>>(
      (const u8*)data, (const i32*)mlen, (const i32*)mdist,
      (const u8*)is_cs, (const u8*)is_lit, (const i32*)dshort,
      (const i32*)n_valid, (const i32*)tab, (i32*)rec0, (i32*)rec1,
      (i32*)n_rec, n_lanes, n, dstride, lit_ctx != 0);
  return (int)cudaGetLastError();
}

// Launch records_kernel on `stream`, a block a lane on a persistent grid:
// the blocks an SM holds at this shared memory on each of the card's `sms`
// SMs, at most one a lane.  Arguments as brotli_torch_records_direct.
extern "C" int brotli_torch_records(const void* data, const void* mlen,
                                    const void* mdist, const void* is_cs,
                                    const void* is_lit, const void* dshort,
                                    const void* n_valid, const void* tab,
                                    void* rec0, void* rec1, void* n_rec,
                                    int n_lanes, int n, int dstride,
                                    int lit_ctx, int sms, void* stream) {
  if (n_lanes <= 0 || n <= 0 || dstride < n || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = rec_smem_bytes(n);
  cudaError_t e = cudaFuncSetAttribute(
      records_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, records_kernel,
                                                    REC_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const int blocks = n_lanes < sms * per_sm ? n_lanes : sms * per_sm;
  records_kernel<<<blocks, REC_THREADS, smem, (cudaStream_t)stream>>>(
      (const u8*)data, (const i32*)mlen, (const i32*)mdist,
      (const u8*)is_cs, (const u8*)is_lit, (const i32*)dshort,
      (const i32*)n_valid, (const i32*)tab, (i32*)rec0, (i32*)rec1,
      (i32*)n_rec, n_lanes, n, dstride, lit_ctx != 0);
  return (int)cudaGetLastError();
}

// The launch shape of records_kernel at n on this card: threads a block,
// dynamic shared bytes, blocks an SM.
extern "C" int brotli_torch_records_config(int n, void* out) {
  if (n <= 0) return 1;
  const size_t smem = rec_smem_bytes(n);
  if (cudaFuncSetAttribute(records_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, records_kernel, REC_THREADS, smem) != cudaSuccess)
    return 1;
  ((int*)out)[0] = REC_THREADS;
  ((int*)out)[1] = (int)smem;
  ((int*)out)[2] = per_sm;
  return 0;
}

#if defined(ENC_PHASE_CLOCKS)
// The phase clocks since the last call, [kernel][phase] as 2 x REC_PHASES
// uint64 (kernel 0 the direct one, 1 records_kernel), then zeroed.
extern "C" int brotli_torch_records_clocks(void* out) {
  cudaError_t rc = cudaMemcpyFromSymbol(out, rec_clocks, sizeof(rec_clocks));
  if (rc != cudaSuccess) return (int)rc;
  static const unsigned long long zero[2][REC_PHASES] = {};
  return (int)cudaMemcpyToSymbol(rec_clocks, zero, sizeof(zero));
}
#endif
