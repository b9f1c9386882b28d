// CUDA per-lane-table decode: streams that each carry their own Huffman
// tables -> bytes.  Replaces brotli_tpu/ops/device_decode.py:204 (`kernel`
// in `_build_kernel`, jitted lax.while_loops: the round-1 lockstep decode).
//
// Bound on Hopper: each lane's serial chain, not bytes.  The table
// entries a lane's code can address (its 256-entry roots, second-level
// entries and used distance extras and offsets), its words and its bytes
// out are read or written once, but every symbol's table index depends
// on the bits the previous symbol consumed, so a lane is a chain of
// dependent shared-memory and register steps.
//
// One warp a lane (dd_decode_lane in device_decode.cuh): the warp stages
// the lane's table row in its slice of shared memory with coalesced loads,
// then its 32 threads run the same serial decode (the same addresses, so
// every load is a broadcast), thread 0 stores the literals and a copy is
// spread over the threads (the copied bytes repeat with period distance,
// so all of them read bytes from before the copy).  The block holds
// DD_WARPS lanes and the LUT; the grid is a whole number of blocks an SM
// (as many as shared memory allows, from the SM count the caller passes),
// and each warp walks the lanes grid-stride.
#include <cuda_runtime.h>

#include "device_decode.cuh"

namespace brotli_torch {

constexpr int DD_WARPS = 4;  // lanes (warps) a block
constexpr int DD_SMEM = (DD_CONSTS_N + DD_WARPS * DD_TAB_N) * 4;  // 60,000 B
constexpr int DD_BLOCKS_SM = 3;  // blocks an SM holds at DD_SMEM each
// an H100 SM has 228 KB of shared memory and reserves 1 KB a block
static_assert(DD_BLOCKS_SM * (DD_SMEM + 1024) <= 228 * 1024,
              "DD_BLOCKS_SM blocks of DD_SMEM do not fit an SM");

__global__ void __launch_bounds__(32 * DD_WARPS)
device_decode_kernel(const u32* __restrict__ body,
                     const i32* __restrict__ scal,
                     const i32* __restrict__ tabs,
                     const i32* __restrict__ consts, u8* __restrict__ out,
                     i32* __restrict__ pos, u8* __restrict__ err, int n_lanes,
                     int max_words, int out_size) {
  extern __shared__ __align__(16) i32 dd_smem[];
  i32* lut = dd_smem;
  for (int i = threadIdx.x; i < DD_CONSTS_N; i += blockDim.x) lut[i] = consts[i];
  __syncthreads();
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  i32* tab = dd_smem + DD_CONSTS_N + w * DD_TAB_N;
  for (int lane = blockIdx.x * DD_WARPS + w; lane < n_lanes;
       lane += gridDim.x * DD_WARPS) {
    const i32* row = tabs + (i64)lane * DD_TAB_N;
    __syncwarp();  // the last lane's reads of the slice are done
    for (int i = t; i < DD_TAB_N; i += 32) tab[i] = __ldg(row + i);
    __syncwarp();
    const DDResult r = dd_decode_lane(
        dd_lane(body, scal + (i64)lane * DD_SCAL_N, tab, lut,
                out + (i64)lane * out_size, max_words, out_size),
        t);
    if (t == 0) {
      pos[lane] = r.pos;
      err[lane] = r.err ? 1 : 0;
    }
  }
}

}  // namespace brotli_torch

using namespace brotli_torch;

// Launch on `stream` over a card of `sms` SMs; returns cudaGetLastError()
// (0 on success).  body: every lane's u32 words one lane after another;
// scal: (n_lanes, DD_SCAL_N); tabs: (n_lanes, DD_TAB_N); consts: the
// LUT; out: (n_lanes, out_size) u8, zero on entry; pos (n_lanes,) i32;
// err (n_lanes,) u8.
extern "C" int brotli_torch_device_decode(const void* body, const void* scal,
                                          const void* tabs, const void* consts,
                                          void* out, void* pos, void* err,
                                          int n_lanes, int max_words,
                                          int out_size, int sms,
                                          void* stream) {
  if (n_lanes <= 0 || max_words < 0 || out_size < 0 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  if (cudaFuncSetAttribute(device_decode_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DD_SMEM) != cudaSuccess)
    return (int)cudaGetLastError();
  const int need = (n_lanes + DD_WARPS - 1) / DD_WARPS;
  const int blocks = need < sms * DD_BLOCKS_SM ? need : sms * DD_BLOCKS_SM;
  device_decode_kernel<<<blocks, 32 * DD_WARPS, DD_SMEM,
                         (cudaStream_t)stream>>>(
      (const u32*)body, (const i32*)scal, (const i32*)tabs,
      (const i32*)consts, (u8*)out, (i32*)pos, (u8*)err, n_lanes, max_words,
      out_size);
  return (int)cudaGetLastError();
}
