// CUDA v3 full-format decode: the windowed kernel (the main path's) and
// the direct kernel beside it.
// Replaces brotli_tpu/ops/pallas_decode3.py:532 (`_build`, inner `kernel`).
//
// Bound on Hopper: each lane is a serial chain of dependent table reads
// (context map -> tree -> subtable -> length/distance LUT) and bit shifts,
// a few hundred instructions a row, so the card is fed by lanes in flight
// and by how few instructions and waits a lane's row costs.  A batch of
// 6,144 lanes is only 47 lanes an SM.
//
// `decode3_kernel` (the main path's):
// * lane map: `lpw` lanes in each warp of a 128-thread block (the other
//   threads of the warp only help stage the tables), so that a small batch
//   still puts several warps on every SM, and each warp serializes the
//   phases of few lanes.  The wrapper picks lpw from the lane and SM counts
//   (ops/decode3.py `launch_config`);
// * bytes: each lane's window in shared memory, flushed to its slot in
//   16-byte stores; copies read the window, 8 bytes a step, and only a
//   copy from past the window reads the slot in global memory
//   (decode3.cuh `Ring3`);
// * words: a look-ahead queue of cp.async loads per lane (queue.cuh);
// * tables: the block stages its group's tables and the context LUT into
//   shared memory, each whole table while the `tab_ints` budget lasts; the
//   rest, the static dictionary and the transform strings stay in global
//   memory (the windows take much of the SM's shared memory, so little is
//   left of L1 for them).
// Shared memory per block: lanes x (win + 4 * QUEUE_R) + 4 * tab_ints
// bytes, above 48 KB through cudaFuncSetAttribute.
//
// `decode3_direct_kernel`: 128 lanes a block, one lane a thread, each byte
// stored straight into the slot and copies read back from it, words loaded
// when the row rule asks, tables through the read-only cache.
#include <cuda_runtime.h>

#include "decode3.cuh"

namespace brotli_torch {

constexpr int DECODE3_BLOCK = 128;  // divides the lanes of a group
constexpr int WARPS3 = 4;           // warps a block of decode3_kernel
constexpr i32 BSW3_N = (3 * BTCH3 + 3 * BLCH3) * 128;

__global__ void __launch_bounds__(DECODE3_BLOCK)
decode3_direct_kernel(const u32* __restrict__ wt, const i32* __restrict__ lit,
                      const i32* __restrict__ cmd, const i32* __restrict__ dist,
                      const i32* __restrict__ bsw, const i32* __restrict__ cmap,
                      const i32* __restrict__ dx, const i32* __restrict__ consts,
                      const i32* __restrict__ lut, const i32* __restrict__ tfm,
                      const u8* __restrict__ dict, const u8* __restrict__ tfs,
                      const u8* __restrict__ cdict, const i32* __restrict__ cfg,
                      const i32* __restrict__ scal, u8* __restrict__ out,
                      i32* __restrict__ status, int n_lanes, int wpad,
                      int out_cap, int hrb, int group_lanes,
                      Decode3Shared S) {
  const int lane = blockIdx.x * DECODE3_BLOCK + threadIdx.x;
  if (lane >= n_lanes) return;
  S.consts = consts;
  S.lut = lut;
  S.tfm = tfm;
  S.dict = dict;
  S.tfs = tfs;
  S.cdict = cdict;
  const Decode3Group G = make_group3(cfg + (lane / group_lanes) * NCFG3, lit,
                                     cmd, dist, bsw, cmap, dx);
  const i64 stride = (i64)hrb + out_cap;
  const Decode3Lane L{wt + lane, n_lanes, wpad, scal + lane, n_lanes,
                      out + (i64)lane * stride, hrb, out_cap, status + lane,
                      n_lanes};
  decode3_lane(S, G, L);
}

// `src` (n entries) staged into the block's table area while the budget
// lasts; the same decision in every thread, so the copy is the block's.
__device__ const i32* stage_table(const i32* src, i32 n, i32* area,
                                  i32& used, i32 budget) {
  if (n <= 0 || used + n > budget) return src;
  i32* dst = area + used;
  for (i32 i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  used += n;
  return dst;
}

__global__ void __launch_bounds__(32 * WARPS3)
decode3_kernel(const u32* __restrict__ wt, const i32* lit, const i32* cmd,
               const i32* dist, const i32* bsw, const i32* cmap,
               const i32* dx, const i32* consts, const i32* lut,
               const i32* tfm, const u8* __restrict__ dict,
               const u8* __restrict__ tfs, const u8* __restrict__ cdict,
               const i32* __restrict__ cfg, const i32* __restrict__ scal,
               u8* out, i32* __restrict__ status, int n_lanes, int wpad,
               int out_cap, int hrb, int group_lanes, Decode3Shared S,
               int lpw, int win, int tab_ints) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lpb = lpw * WARPS3;
  const int lane0 = blockIdx.x * lpb;
  u8* s_win = smem;
  u32* s_q = (u32*)(smem + (i64)lpb * win);
  i32* s_tab = (i32*)(s_q + QUEUE_R * lpb);

  // a block's lanes lie in one group (launch_shape_ok)
  Decode3Group G = make_group3(cfg + (lane0 / group_lanes) * NCFG3, lit,
                               cmd, dist, bsw, cmap, dx);
  i32 used = 0;
  S.consts = stage_table(consts, CONSTS3_N, s_tab, used, tab_ints);
  G.cmap = stage_table(G.cmap, (G.lcmch + G.dcmch + 1) * 128, s_tab, used,
                       tab_ints);
  S.lut = stage_table(lut, LUT3_N, s_tab, used, tab_ints);
  G.dx = stage_table(G.dx, DX3_N, s_tab, used, tab_ints);
  G.cmd = stage_table(G.cmd, G.nc * CCH3 * 128, s_tab, used, tab_ints);
  G.dist = stage_table(G.dist, G.nd * DCH3 * 128, s_tab, used, tab_ints);
  if (G.nbt[0] > 1 || G.nbt[1] > 1 || G.nbt[2] > 1)
    G.bsw = stage_table(G.bsw, BSW3_N, s_tab, used, tab_ints);
  G.lit = stage_table(G.lit, G.nl * LCH3 * 128, s_tab, used, tab_ints);
  S.tfm = tfm;
  S.dict = dict;
  S.tfs = tfs;
  S.cdict = cdict;
  __syncthreads();

  const int li = threadIdx.x & 31;
  if (li >= lpw) return;
  const int t = (threadIdx.x >> 5) * lpw + li;
  const int lane = lane0 + t;
  const i64 stride = (i64)hrb + out_cap;
  u8* slot = out + (i64)lane * stride;
  const Decode3Lane L{nullptr, n_lanes, wpad, scal + lane, n_lanes, slot,
                      hrb, out_cap, status + lane, n_lanes};
  Ring3 O{L, WordQueue{wt + lane, n_lanes, wpad, s_q + t, lpb},
          s_win + (i64)t * win, win - 1, (i32)((uintptr_t)slot & 15), 0};
  decode3_lane_windowed(S, G, L, O);
}

// every block inside one group: lpw * WARPS3 divides the group's lanes
static bool launch_shape_ok(int group_lanes, int lpw) {
  return lpw >= 1 && lpw <= 32 && (lpw & (lpw - 1)) == 0 &&
         group_lanes % (lpw * WARPS3) == 0;
}

}  // namespace brotli_torch

using namespace brotli_torch;

// whole groups of group_lanes lanes, each a whole number of the direct
// kernel's blocks
static bool decode3_args_ok(int n_lanes, int wpad, int out_cap, int hrb,
                            int dict_n, int tfs_n, int cd_n, int cd_t,
                            int group_lanes) {
  return group_lanes > 0 && group_lanes % DECODE3_BLOCK == 0 &&
         n_lanes > 0 && n_lanes % group_lanes == 0 && wpad >= 1 &&
         out_cap >= 1 && hrb >= 0 && dict_n >= 1 && tfs_n >= 1 && cd_n >= 1 &&
         cd_t >= 0 && cd_t <= cd_n;
}

static Decode3Shared decode3_shared(int dict_n, int tfs_n, int cd_n, int cd_t,
                                    int use_dict) {
  Decode3Shared S{};
  S.dict_n = dict_n;
  S.tfs_n = tfs_n;
  S.cd_n = cd_n;
  S.cd_t = cd_t;
  S.use_dict = use_dict != 0;
  return S;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// Lane l decodes with group l / group_lanes's config row; n_lanes must be
// whole groups, and group_lanes a multiple of 128; out is (n_lanes, hrb +
// out_cap) bytes with each lane's prefix already in place.
extern "C" int brotli_torch_decode3_direct(
    const void* wt, const void* lit, const void* cmd, const void* dist,
    const void* bsw, const void* cmap, const void* dx, const void* consts,
    const void* lut, const void* tfm, const void* dict, const void* tfs,
    const void* cdict, const void* cfg, const void* scal, void* out,
    void* status, int n_lanes, int wpad, int out_cap, int hrb, int dict_n,
    int tfs_n, int cd_n, int cd_t, int use_dict, int group_lanes,
    void* stream) {
  if (!decode3_args_ok(n_lanes, wpad, out_cap, hrb, dict_n, tfs_n, cd_n, cd_t,
                       group_lanes))
    return (int)cudaErrorInvalidValue;
  decode3_direct_kernel<<<n_lanes / DECODE3_BLOCK, DECODE3_BLOCK, 0,
                          (cudaStream_t)stream>>>(
      (const u32*)wt, (const i32*)lit, (const i32*)cmd, (const i32*)dist,
      (const i32*)bsw, (const i32*)cmap, (const i32*)dx, (const i32*)consts,
      (const i32*)lut, (const i32*)tfm, (const u8*)dict, (const u8*)tfs,
      (const u8*)cdict, (const i32*)cfg, (const i32*)scal, (u8*)out,
      (i32*)status, n_lanes, wpad, out_cap, hrb, group_lanes,
      decode3_shared(dict_n, tfs_n, cd_n, cd_t, use_dict));
  return (int)cudaGetLastError();
}

// The same, through decode3_kernel: `lpw` lanes a warp (a power of two up
// to 32, lpw * 4 dividing group_lanes), a window of `win` bytes a lane (a
// power of two >= 64) and `tab_ints` table entries a block.  `out` must be
// 16-byte aligned.
extern "C" int brotli_torch_decode3(
    const void* wt, const void* lit, const void* cmd, const void* dist,
    const void* bsw, const void* cmap, const void* dx, const void* consts,
    const void* lut, const void* tfm, const void* dict, const void* tfs,
    const void* cdict, const void* cfg, const void* scal, void* out,
    void* status, int n_lanes, int wpad, int out_cap, int hrb, int dict_n,
    int tfs_n, int cd_n, int cd_t, int use_dict, int group_lanes, int lpw,
    int win, int tab_ints, void* stream) {
  if (!decode3_args_ok(n_lanes, wpad, out_cap, hrb, dict_n, tfs_n, cd_n,
                       cd_t, group_lanes) ||
      !launch_shape_ok(group_lanes, lpw) || win < 64 ||
      (win & (win - 1)) != 0 || tab_ints < 0 || ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int lpb = lpw * WARPS3;
  const size_t smem = (size_t)lpb * win + (size_t)QUEUE_R * lpb * 4 +
                      (size_t)tab_ints * 4;
  if (cudaFuncSetAttribute(decode3_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return (int)cudaGetLastError();
  decode3_kernel<<<n_lanes / lpb, 32 * WARPS3, smem, (cudaStream_t)stream>>>(
      (const u32*)wt, (const i32*)lit, (const i32*)cmd, (const i32*)dist,
      (const i32*)bsw, (const i32*)cmap, (const i32*)dx, (const i32*)consts,
      (const i32*)lut, (const i32*)tfm, (const u8*)dict, (const u8*)tfs,
      (const u8*)cdict, (const i32*)cfg, (const i32*)scal, (u8*)out,
      (i32*)status, n_lanes, wpad, out_cap, hrb, group_lanes,
      decode3_shared(dict_n, tfs_n, cd_n, cd_t, use_dict), lpw, win,
      tab_ints);
  return (int)cudaGetLastError();
}
