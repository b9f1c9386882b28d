// CUDA bit-pack kernel of the device encoder: symbol records -> LSB-first
// u32 words, one thread per lane.  Replaces brotli_tpu/ops/device_encode.py
// `_build_pack` / `kernel`.
//
// Bound on Hopper: latency.  Each lane is one serial chain over its record
// rows (a table read, three appends into a 128-bit buffer, at most one word
// out per row), so a thread issues little work per cycle and 1024 lanes are
// only 32 warps.  Blocks of 32 threads spread those warps over 32 SMs, one
// warp each.  Records are record-major (row, lane): a warp's loads of one
// row are 128 contiguous bytes, and each thread loads its next row before
// running this one.  The tables (at most 8 groups x 22 chunks x 512 B = 90
// KB with the context maps beside them) are read from global memory through
// the read-only cache rather than staged in shared memory: every lane of a
// block may use another group, and the whole set stays resident in L1/L2.
// Each emitted word goes to row widx of the lane's column, so the body
// comes out compact and the assembly is a copy.
#include <cuda_runtime.h>

#include "pack.cuh"

namespace brotli_torch {

constexpr int PACK_BLOCK = 32;

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

}  // namespace brotli_torch

using namespace brotli_torch;

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// rec0/rec1/words are (rows, n_lanes), sw/stype (nseg, n_lanes) (unused
// when nbt <= 1), status (6, n_lanes): widx, avail, b0, b1, b2, ovf.
extern "C" int brotli_torch_pack(
    const void* rec0, const void* rec1, const void* tab, const void* cmap,
    const void* consts, const void* grp, const void* init0,
    const void* initav, const void* sw, const void* stype, void* words,
    void* status, int n_lanes, int rows, int n_groups, int tab_n, int cmap_n,
    int nt, int nbt, int pseg, int nseg, void* stream) {
  if (n_lanes <= 0 || rows < 0 || n_groups <= 0 || tab_n <= 0 ||
      cmap_n < 128 || nt < 1 || pseg <= 0 || nseg <= 0 ||
      (nbt > 1 && (sw == nullptr || stype == nullptr)))
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
