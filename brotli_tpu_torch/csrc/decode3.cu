// CUDA v3 full-format decode, one thread per lane.
// Replaces brotli_tpu/ops/pallas_decode3.py:532 (`_build`, inner `kernel`).
//
// Bound on Hopper: latency.  Each lane is a serial chain of dependent reads
// (context map -> tree -> subtable -> length/distance LUT) and bit shifts,
// so a thread has little to issue per cycle and the card is fed only by
// having many lanes in flight.  At full caps one group's literal trees alone
// are 160 x 640 entries (400 KB), more than a block's shared memory, so the
// tables, the 122 KB static dictionary, the transform strings and the
// context LUT are read from global memory through the read-only cache; the
// group's tables of a typical stream (about 8 KB) stay hot in L1.  Each
// lane writes its bytes into its own output slot and copies from it, so the
// TPU kernel's ring, FIFO, flush frontier and far-fetch window have no
// counterpart.  A block is 128 lanes of one group, whose configuration and
// table offsets come from a config row, so one launch serves every group.
#include <cuda_runtime.h>

#include "decode3.cuh"

namespace brotli_torch {

constexpr int DECODE3_BLOCK = 128;  // divides the 1024 lanes of a group
constexpr int GROUP3_LANES = 1024;

__global__ void __launch_bounds__(DECODE3_BLOCK)
decode3_kernel(const u32* __restrict__ wt, const i32* __restrict__ lit,
               const i32* __restrict__ cmd, const i32* __restrict__ dist,
               const i32* __restrict__ bsw, const i32* __restrict__ cmap,
               const i32* __restrict__ dx, const i32* __restrict__ consts,
               const i32* __restrict__ lut, const i32* __restrict__ tfm,
               const u8* __restrict__ dict, const u8* __restrict__ tfs,
               const u8* __restrict__ cdict, const i32* __restrict__ cfg,
               const i32* __restrict__ scal, u8* __restrict__ out,
               i32* __restrict__ status, int n_lanes, int wpad, int out_cap,
               int hrb, Decode3Shared S) {
  const int lane = blockIdx.x * DECODE3_BLOCK + threadIdx.x;
  if (lane >= n_lanes) return;
  S.consts = consts;
  S.lut = lut;
  S.tfm = tfm;
  S.dict = dict;
  S.tfs = tfs;
  S.cdict = cdict;
  const Decode3Group G = make_group3(cfg + (lane / GROUP3_LANES) * NCFG3, lit,
                                     cmd, dist, bsw, cmap, dx);
  const i64 stride = (i64)hrb + out_cap;
  const Decode3Lane L{wt + lane, n_lanes, wpad, scal + lane, n_lanes,
                      out + (i64)lane * stride, hrb, out_cap, status + lane,
                      n_lanes};
  decode3_lane(S, G, L);
}

}  // namespace brotli_torch

using namespace brotli_torch;

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// n_lanes must be a multiple of 1024 (whole groups); out is
// (n_lanes, hrb + out_cap) bytes with each lane's prefix already in place.
extern "C" int brotli_torch_decode3(
    const void* wt, const void* lit, const void* cmd, const void* dist,
    const void* bsw, const void* cmap, const void* dx, const void* consts,
    const void* lut, const void* tfm, const void* dict, const void* tfs,
    const void* cdict, const void* cfg, const void* scal, void* out,
    void* status, int n_lanes, int wpad, int out_cap, int hrb, int dict_n,
    int tfs_n, int cd_n, int cd_t, int use_dict, void* stream) {
  if (n_lanes <= 0 || n_lanes % GROUP3_LANES != 0 || wpad < 1 ||
      out_cap < 1 || hrb < 0 || dict_n < 1 || tfs_n < 1 || cd_n < 1 ||
      cd_t < 0 || cd_t > cd_n)
    return (int)cudaErrorInvalidValue;
  Decode3Shared S{};
  S.dict_n = dict_n;
  S.tfs_n = tfs_n;
  S.cd_n = cd_n;
  S.cd_t = cd_t;
  S.use_dict = use_dict != 0;
  decode3_kernel<<<n_lanes / DECODE3_BLOCK, DECODE3_BLOCK, 0,
                   (cudaStream_t)stream>>>(
      (const u32*)wt, (const i32*)lit, (const i32*)cmd, (const i32*)dist,
      (const i32*)bsw, (const i32*)cmap, (const i32*)dx, (const i32*)consts,
      (const i32*)lut, (const i32*)tfm, (const u8*)dict, (const u8*)tfs,
      (const u8*)cdict, (const i32*)cfg, (const i32*)scal, (u8*)out,
      (i32*)status, n_lanes, wpad, out_cap, hrb, S);
  return (int)cudaGetLastError();
}
