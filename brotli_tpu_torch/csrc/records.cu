// CUDA record builder of the device encoder: one warp per lane.  Replaces
// the XLA stage brotli_tpu/ops/device_encode.py `build_records` (stage 3 of
// `_jitted_stages`), which has no `pallas_call`: on the TPU it is a
// `lax.cummax`, three reversed `lax.cummin`s and some thirty elementwise
// ops over (B, N) arrays.
//
// Bound on Hopper: bytes.  A 32 KB lane reads the data, mlen, mdist,
// dcode_short (4 B each), is_cs and is_lit (1 B each), 15 B a position,
// and writes rec0 and rec1 (8 B a row): 1024 lanes move 772 MB, 0.23 ms
// at 3.35 TB/s.  The plain version's flips and int64 temporaries are gone:
// a lane is two passes over windows of 32 positions, one position a
// thread, with the scans as warp shuffles and the carry in a register.
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

constexpr int REC_BLOCK = 128;  // 4 warps, 4 lanes
constexpr int REC_BLOCKS_PER_SM = 16;
constexpr u32 REC_FULL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(REC_BLOCK)
records_kernel(const u8* __restrict__ data, const i32* __restrict__ mlen,
               const i32* __restrict__ mdist, const u8* __restrict__ is_cs,
               const u8* __restrict__ is_lit, const i32* __restrict__ dshort,
               const i32* __restrict__ n_valid, const i32* __restrict__ tab_g,
               i32* __restrict__ rec0, i32* __restrict__ rec1,
               i32* __restrict__ n_rec, int n_lanes, int n, int dstride,
               bool lit_ctx) {
  __shared__ i32 tab[REC_TAB_N];
  for (int i = threadIdx.x; i < REC_TAB_N; i += blockDim.x) tab[i] = tab_g[i];
  __syncthreads();
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
  }
}

}  // namespace brotli_torch

using namespace brotli_torch;

// Launch on `stream`; returns cudaGetLastError() (0 on success).  data is
// (n_lanes, dstride) bytes with dstride >= n; mlen, mdist, dshort (n_lanes,
// n) int32; is_cs, is_lit (n_lanes, n) bytes (torch.bool); n_valid
// (n_lanes,) int32; tab the REC_TAB_N-word table of records.cuh; rec0 and
// rec1 (n_lanes, n + 1) int32; n_rec (n_lanes,) int32.  The grid holds at
// most REC_BLOCKS_PER_SM blocks on each of the card's `sms` SMs; its warps
// step over the lanes.
extern "C" int brotli_torch_records(const void* data, const void* mlen,
                                    const void* mdist, const void* is_cs,
                                    const void* is_lit, const void* dshort,
                                    const void* n_valid, const void* tab,
                                    void* rec0, void* rec1, void* n_rec,
                                    int n_lanes, int n, int dstride,
                                    int lit_ctx, int sms, void* stream) {
  if (n_lanes <= 0 || n <= 0 || dstride < n || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const int warps = REC_BLOCK / 32;
  int blocks = (n_lanes + warps - 1) / warps;
  if (blocks > sms * REC_BLOCKS_PER_SM) blocks = sms * REC_BLOCKS_PER_SM;
  records_kernel<<<blocks, REC_BLOCK, 0, (cudaStream_t)stream>>>(
      (const u8*)data, (const i32*)mlen, (const i32*)mdist,
      (const u8*)is_cs, (const u8*)is_lit, (const i32*)dshort,
      (const i32*)n_valid, (const i32*)tab, (i32*)rec0, (i32*)rec1,
      (i32*)n_rec, n_lanes, n, dstride, lit_ctx != 0);
  return (int)cudaGetLastError();
}
