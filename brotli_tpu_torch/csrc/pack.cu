// CUDA bit-pack kernels of the device encoder: symbol records -> LSB-first
// u32 words.  Replace brotli_tpu/ops/device_encode.py `_build_pack` /
// `kernel`.
//
// Bound on Hopper: bytes, the live records in and the words out (about
// 0.04 ms at the main shape).  Two kernels compute the same words and
// status:
//
// * the segmented scan (brotli_torch_pack, the encoder's): a row's bits
//   depend only on its own record, only its offset on the rows before it
//   (csrc/pack.cuh).  Pass 1 gives every (segment of PACK_SEG rows, lane)
//   its bit count and the two numbers of its prefix minimum; pass 2 scans
//   each lane's segments in order (one thread a lane, the segments' counts
//   read across lanes coalesced); pass 3 re-walks every segment from its
//   start bit and writes its words at their final indices: interior words
//   by plain stores, the first and last words of a segment (which the
//   neighbours share) and the buffer limbs by atomicOr into the zeroed
//   outputs; pass 4 runs the row machine for the lanes whose buffer
//   overflowed (ovf), which the scan cannot reproduce.  Threads of a warp
//   take 32 neighbouring lanes of one segment, so a row loads as 128
//   contiguous bytes; 1024 lanes x 33,024 rows are 4,224 warps.  The
//   tables (at most 8 groups x 22 chunks x 512 B = 90 KB with the context
//   maps) are read through the read-only cache: every lane of a warp may
//   use another group, and the whole set stays resident in L1/L2.
// * the serial kernel (brotli_torch_pack_serial, the first port): one
//   thread a lane runs the row machine over all its rows, a chain of
//   dependent row steps; 1024 lanes are 32 warps.  It stays as the
//   yardstick the segmented kernel is timed against.
#include <cuda_runtime.h>

#include "pack.cuh"

namespace brotli_torch {

constexpr int PACK_BLOCK = 32;
constexpr int SEG_WARPS = 4;  // segments a block of the scan takes
constexpr int SCAN_BLOCK = 128;

__global__ void __launch_bounds__(PACK_BLOCK)
pack_kernel(const i32* __restrict__ rec0, const i32* __restrict__ rec1,
            PackTables T, const i32* __restrict__ grp,
            const i32* __restrict__ init0, const i32* __restrict__ initav,
            const i32* __restrict__ sw, const i32* __restrict__ stype,
            i32* __restrict__ words, i32* __restrict__ status, PackParams P) {
  const int lane = blockIdx.x * PACK_BLOCK + threadIdx.x;
  if (lane >= P.n_lanes) return;
  const PackResult r = pack_lane(
      T, P, rec0 + lane, rec1 + lane, grp[lane], init0[lane], initav[lane],
      P.nbt > 1 ? sw + lane : nullptr, P.nbt > 1 ? stype + lane : nullptr,
      words + lane);
  const i64 n = P.n_lanes;
  status[0 * n + lane] = (i32)r.widx;
  status[1 * n + lane] = (i32)r.avail;
  status[2 * n + lane] = (i32)r.b0;
  status[3 * n + lane] = (i32)r.b1;
  status[4 * n + lane] = (i32)r.b2;
  status[5 * n + lane] = (i32)r.ovf;
}

// Passes 1 and 3: thread (lane, segment) of a 2-D grid.
struct SegThread {
  int lane, g;
  i32 r_lo, r_hi;
};

__device__ __forceinline__ bool seg_thread(const PackParams& P, int nsegr,
                                           SegThread& s) {
  s.lane = blockIdx.x * 32 + (threadIdx.x & 31);
  s.g = blockIdx.y * SEG_WARPS + (threadIdx.x >> 5);
  if (s.lane >= P.n_lanes || s.g >= nsegr) return false;
  s.r_lo = s.g * PACK_SEG;
  s.r_hi = min(P.rows, s.r_lo + PACK_SEG);
  return true;
}

__global__ void __launch_bounds__(32 * SEG_WARPS)
pack_count_kernel(const i32* __restrict__ rec0, const i32* __restrict__ rec1,
                  PackTables T, const i32* __restrict__ grp,
                  const i32* __restrict__ sw, const i32* __restrict__ stype,
                  i32* __restrict__ cnt, int nsegr, PackParams P) {
  SegThread s;
  if (!seg_thread(P, nsegr, s)) return;
  const PackLaneCtx L = pack_lane_ctx(T, P, grp[s.lane]);
  const PackSegCount c = pack_seg_count(
      T, P, L, s.r_lo, s.r_hi, rec0 + s.lane, rec1 + s.lane,
      P.nbt > 1 ? sw + s.lane : nullptr, P.nbt > 1 ? stype + s.lane : nullptr);
  const i64 n = P.n_lanes, at = (i64)s.g * n + s.lane, plane = (i64)nsegr * n;
  cnt[at] = c.bits;
  cnt[plane + at] = c.a;
  cnt[2 * plane + at] = c.t;
}

__global__ void __launch_bounds__(SCAN_BLOCK)
pack_scan_kernel(i32* __restrict__ cnt, const i32* __restrict__ init0,
                 const i32* __restrict__ initav, i32* __restrict__ status,
                 i32* __restrict__ words, int nsegr, PackParams P) {
  const int lane = blockIdx.x * SCAN_BLOCK + threadIdx.x;
  if (lane >= P.n_lanes) return;
  pack_scan_lane(cnt + lane, nsegr, P.n_lanes, P.rows, init0[lane],
                 initav[lane], status + lane, words + lane);
}

__global__ void __launch_bounds__(32 * SEG_WARPS)
pack_emit_kernel(const i32* __restrict__ rec0, const i32* __restrict__ rec1,
                 PackTables T, const i32* __restrict__ grp,
                 const i32* __restrict__ sw, const i32* __restrict__ stype,
                 const i32* __restrict__ cnt, i32* __restrict__ words,
                 i32* __restrict__ status, int nsegr, PackParams P) {
  SegThread s;
  if (!seg_thread(P, nsegr, s)) return;
  const i64 n = P.n_lanes, at = (i64)s.g * n + s.lane;
  const i32 widx = status[s.lane];
  const PackLaneCtx L = pack_lane_ctx(T, P, grp[s.lane]);
  u32* body = (u32*)words + s.lane;
  u32* limbs = (u32*)status + 2 * n + s.lane;
  const bool ovf = pack_seg_emit(
      T, P, L, s.r_lo, s.r_hi, rec0 + s.lane, rec1 + s.lane,
      P.nbt > 1 ? sw + s.lane : nullptr, P.nbt > 1 ? stype + s.lane : nullptr,
      cnt[at], cnt[(i64)nsegr * n + at], [&](i32 k, u32 v, bool shared) {
        if (k < widx) {
          if (shared)
            atomicOr(body + (i64)k * n, v);
          else
            body[(i64)k * n] = v;
        } else if (k - widx < 3) {
          atomicOr(limbs + (i64)(k - widx) * n, v);
        }
      });
  if (ovf) status[5 * n + s.lane] = 1;
}

// Pass 4: the row machine for the lanes that overflowed, over a zeroed
// column.
__global__ void __launch_bounds__(SCAN_BLOCK)
pack_finish_kernel(const i32* __restrict__ rec0, const i32* __restrict__ rec1,
                   PackTables T, const i32* __restrict__ grp,
                   const i32* __restrict__ init0,
                   const i32* __restrict__ initav, const i32* __restrict__ sw,
                   const i32* __restrict__ stype, i32* __restrict__ words,
                   i32* __restrict__ status, PackParams P) {
  const int lane = blockIdx.x * SCAN_BLOCK + threadIdx.x;
  const i64 n = P.n_lanes;
  if (lane >= P.n_lanes || status[5 * n + lane] == 0) return;
  for (i32 r = 0; r < P.rows; ++r) words[(i64)r * n + lane] = 0;
  const PackResult r = pack_lane(
      T, P, rec0 + lane, rec1 + lane, grp[lane], init0[lane], initav[lane],
      P.nbt > 1 ? sw + lane : nullptr, P.nbt > 1 ? stype + lane : nullptr,
      words + lane);
  status[0 * n + lane] = (i32)r.widx;
  status[1 * n + lane] = (i32)r.avail;
  status[2 * n + lane] = (i32)r.b0;
  status[3 * n + lane] = (i32)r.b1;
  status[4 * n + lane] = (i32)r.b2;
  status[5 * n + lane] = (i32)r.ovf;
}

}  // namespace brotli_torch

using namespace brotli_torch;

// The segmented kernel's passes, launched on `stream` in order; returns the
// first cudaGetLastError() that is not 0 (0 on success).  rec0/rec1/words
// are (rows, n_lanes), words zeroed; sw/stype (nseg, n_lanes) (unused when
// nbt <= 1); status (6, n_lanes): widx, avail, b0, b1, b2, ovf; scratch
// (3, ceil(rows / 256), n_lanes).
extern "C" int brotli_torch_pack(
    const void* rec0, const void* rec1, const void* tab, const void* cmap,
    const void* consts, const void* grp, const void* init0,
    const void* initav, const void* sw, const void* stype, void* words,
    void* status, void* scratch, int n_lanes, int rows, int n_groups,
    int tab_n, int cmap_n, int nt, int nbt, int pseg, int nseg,
    void* stream) {
  if (!pack_args_ok(sw, stype, n_lanes, rows, n_groups, tab_n, cmap_n, nt,
                    nbt, pseg, nseg) ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const PackTables T{(const i32*)tab, (const i32*)cmap, (const i32*)consts,
                     tab_n, cmap_n, n_groups};
  const PackParams P{nt, nbt, pseg, nseg, rows, n_lanes};
  const cudaStream_t st = (cudaStream_t)stream;
  const int nsegr = (rows + PACK_SEG - 1) / PACK_SEG;
  const dim3 seg_grid((n_lanes + 31) / 32, (nsegr + SEG_WARPS - 1) / SEG_WARPS);
  const int lane_blocks = (n_lanes + SCAN_BLOCK - 1) / SCAN_BLOCK;
  i32* cnt = (i32*)scratch;
  if (nsegr > 0) {
    pack_count_kernel<<<seg_grid, 32 * SEG_WARPS, 0, st>>>(
        (const i32*)rec0, (const i32*)rec1, T, (const i32*)grp,
        (const i32*)sw, (const i32*)stype, cnt, nsegr, P);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
  }
  pack_scan_kernel<<<lane_blocks, SCAN_BLOCK, 0, st>>>(
      cnt, (const i32*)init0, (const i32*)initav, (i32*)status, (i32*)words,
      nsegr, P);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  if (nsegr > 0) {
    pack_emit_kernel<<<seg_grid, 32 * SEG_WARPS, 0, st>>>(
        (const i32*)rec0, (const i32*)rec1, T, (const i32*)grp,
        (const i32*)sw, (const i32*)stype, cnt, (i32*)words, (i32*)status,
        nsegr, P);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
  }
  pack_finish_kernel<<<lane_blocks, SCAN_BLOCK, 0, st>>>(
      (const i32*)rec0, (const i32*)rec1, T, (const i32*)grp,
      (const i32*)init0, (const i32*)initav, (const i32*)sw,
      (const i32*)stype, (i32*)words, (i32*)status, P);
  return (int)cudaGetLastError();
}

// The serial kernel, launched on `stream`; returns cudaGetLastError().  The
// arguments are brotli_torch_pack's without the scratch.
extern "C" int brotli_torch_pack_serial(
    const void* rec0, const void* rec1, const void* tab, const void* cmap,
    const void* consts, const void* grp, const void* init0,
    const void* initav, const void* sw, const void* stype, void* words,
    void* status, int n_lanes, int rows, int n_groups, int tab_n, int cmap_n,
    int nt, int nbt, int pseg, int nseg, void* stream) {
  if (!pack_args_ok(sw, stype, n_lanes, rows, n_groups, tab_n, cmap_n, nt,
                    nbt, pseg, nseg))
    return (int)cudaErrorInvalidValue;
  const PackTables T{(const i32*)tab, (const i32*)cmap, (const i32*)consts,
                     tab_n, cmap_n, n_groups};
  const PackParams P{nt, nbt, pseg, nseg, rows, n_lanes};
  const int blocks = (n_lanes + PACK_BLOCK - 1) / PACK_BLOCK;
  pack_kernel<<<blocks, PACK_BLOCK, 0, (cudaStream_t)stream>>>(
      (const i32*)rec0, (const i32*)rec1, T, (const i32*)grp,
      (const i32*)init0, (const i32*)initav, (const i32*)sw,
      (const i32*)stype, (i32*)words, (i32*)status, P);
  return (int)cudaGetLastError();
}
