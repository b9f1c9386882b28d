// CUDA per-lane-table decode: streams that each carry their own Huffman
// tables -> bytes.  Replaces brotli_tpu/ops/device_decode.py:204 (`kernel`
// in `_build_kernel`, jitted lax.while_loops: the round-1 lockstep decode).
//
// Bound on Hopper: each lane's serial chain, not bytes.  The table
// entries a lane's code can address (its 256-entry roots, second-level
// entries and used distance extras and offsets), its words and its bytes
// out are read or written once, but every symbol's table index depends
// on the bits the previous symbol consumed, so a lane is a chain of
// dependent shared-memory and register steps.  With a lane a warp and
// every lane of a 1024-lane batch resident at once, the kernel's time is
// its slowest lane's chain; only a shorter step shortens it.
//
// device_decode_kernel (the shared form, dd_decode_lane_shared): a block
// is one warp and one lane at a time, 8 blocks an SM.  The warp issues
// its lane's first DD_RING words into a ring in shared memory with
// cp.async, compacts the table row into its slice while they land (u16
// Huffman entries, u8 extra bits: 7,984 B where the row is 14,872) and
// expands the literal and command tables to one level (1,024 entries
// each), then its 32 threads run the same serial decode.  The bits come
// from a 64-bit buffer in registers, topped up a word at a time from the
// ring, whose next half is in flight while the reader is in the other,
// so no step waits on device memory.  On the fast path a command is one
// table load and literals go in sub-groups of three loads without a
// branch; a lane whose bits jump (malformed) decodes again by the
// direct form.  Literals and copies go to a DD_WIN-byte window in
// shared memory, which reaches the output row in 16-byte stores as it
// wraps and when the lane ends; at 8 KB rows the whole row fits.  A copy
// spreads over the warp by its period, with no division when it does not
// overlap itself.
//
// device_decode_direct_kernel (the direct form, dd_decode_lane; the first
// design, kept to be timed against): 4 warps a block, each staging its
// lane's 14,872-B table row in shared memory, then running the decode
// with words read from device memory as the bit position crosses them,
// thread 0 storing each literal to device memory and copies read back
// from there.
//
// Both grids are a whole number of blocks an SM (as many as shared memory
// allows, from the SM count the caller passes), and each block or warp
// walks the lanes grid-stride.  Built with -DDD_PHASE_CLOCKS
// (tools/dd_phases.py), each lane's leader adds clock64() cycles by phase
// (device_decode.cuh DDPhase) and counts its events into dd_lane_clocks.
#include <cuda_runtime.h>

#include "device_decode.cuh"

namespace brotli_torch {

// the direct form
constexpr int DD_WARPS = 4;  // lanes (warps) a block
constexpr int DD_SMEM = (DD_CONSTS_N + DD_WARPS * DD_TAB_N) * 4;  // 60,000 B
constexpr int DD_BLOCKS_SM = 3;  // blocks an SM holds at DD_SMEM each
// an H100 SM has 228 KB of shared memory and reserves 1 KB a block
static_assert(DD_BLOCKS_SM * (DD_SMEM + 1024) <= 228 * 1024,
              "DD_BLOCKS_SM blocks of DD_SMEM do not fit an SM");

// the shared form: a lane's words ring and window, and its block
constexpr int DD_RING = 1024;  // words (4 KB), two halves of 2 KB
constexpr int DD_WIN = 8192;   // bytes: a whole 8 KB row
constexpr int DD_SMEM_SHARED =
    DD_CONSTS_N * 4 + DD_STAB_BYTES + 4 * DD_RING + DD_WIN;  // 24,880 B
constexpr int DD_BLOCKS_SM_SHARED = 8;  // 1,056 lanes at once on 132 SMs
static_assert(DD_BLOCKS_SM_SHARED * (DD_SMEM_SHARED + 1024) <= 228 * 1024,
              "DD_BLOCKS_SM_SHARED blocks of DD_SMEM_SHARED do not fit an SM");
static_assert(DD_RING >= DD_RING_MIN && DD_WIN >= DD_WIN_MIN &&
                  (DD_RING & (DD_RING - 1)) == 0 && (DD_WIN & (DD_WIN - 1)) == 0,
              "the ring and the window are powers of two");

#if defined(DD_PHASE_CLOCKS)
constexpr int DD_CLOCK_LANES = 4096;  // lanes recorded one by one
// [kernel][lane][phase] cycles and [kernel][lane][event] counts; kernel 0
// the direct form, 1 the shared one
__device__ unsigned long long dd_lane_clocks[2][DD_CLOCK_LANES][DD_PHASES];
__device__ unsigned dd_lane_events[2][DD_CLOCK_LANES][DD_EVENTS];
__device__ __forceinline__ void dd_record(const DDClock& clk, int kernel,
                                          int lane) {
  if (lane >= DD_CLOCK_LANES) return;
#pragma unroll
  for (int k = 0; k < DD_PHASES; ++k)
    dd_lane_clocks[kernel][lane][k] = (unsigned long long)clk.sum[k];
#pragma unroll
  for (int k = 0; k < DD_EVENTS; ++k) dd_lane_events[kernel][lane][k] = clk.ev[k];
}
#else
__device__ __forceinline__ void dd_record(const DDClock&, int, int) {}
#endif

__global__ void __launch_bounds__(32 * DD_WARPS)
device_decode_direct_kernel(const u32* __restrict__ body,
                            const i32* __restrict__ scal,
                            const i32* __restrict__ tabs,
                            const i32* __restrict__ consts,
                            u8* __restrict__ out, i32* __restrict__ pos,
                            u8* __restrict__ err, int n_lanes, int max_words,
                            int out_size) {
  extern __shared__ __align__(16) i32 dd_smem[];
  i32* lut = dd_smem;
  for (int i = threadIdx.x; i < DD_CONSTS_N; i += blockDim.x) lut[i] = consts[i];
  __syncthreads();
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  i32* tab = dd_smem + DD_CONSTS_N + w * DD_TAB_N;
  for (int lane = blockIdx.x * DD_WARPS + w; lane < n_lanes;
       lane += gridDim.x * DD_WARPS) {
    DDClock clk;
    const i32* row = tabs + (i64)lane * DD_TAB_N;
    __syncwarp();  // the last lane's reads of the slice are done
    for (int i = t; i < DD_TAB_N; i += 32) tab[i] = __ldg(row + i);
    __syncwarp();
    clk.mark(DD_PH_STAGE);
    const DDResult r = dd_decode_lane(
        dd_lane(body, scal + (i64)lane * DD_SCAL_N, tab, lut,
                out + (i64)lane * out_size, max_words, out_size),
        t, clk);
    if (t == 0) {
      pos[lane] = r.pos;
      err[lane] = r.err ? 1 : 0;
      dd_record(clk, 0, lane);
    }
  }
}

__global__ void __launch_bounds__(32)
device_decode_kernel(const u32* __restrict__ body, const i32* __restrict__ scal,
                     const i32* __restrict__ tabs,
                     const i32* __restrict__ consts, u8* __restrict__ out,
                     i32* __restrict__ pos, u8* __restrict__ err, int n_lanes,
                     int max_words, int out_size) {
  extern __shared__ __align__(16) u8 dd_shared[];
  i32* lut = (i32*)dd_shared;
  u8* slice = dd_shared + DD_CONSTS_N * 4;
  const int t = threadIdx.x;
  for (int i = t; i < DD_CONSTS_N; i += 32) lut[i] = consts[i];
  __syncwarp();
  for (int lane = blockIdx.x; lane < n_lanes; lane += gridDim.x) {
    DDClock clk;
    const DDResult r = dd_decode_lane_shared(
        body, scal + (i64)lane * DD_SCAL_N, tabs + (i64)lane * DD_TAB_N, lut,
        out + (i64)lane * out_size, max_words, out_size, slice, DD_RING - 1,
        DD_WIN - 1, clk);
    if (t == 0) {
      pos[lane] = r.pos;
      err[lane] = r.err ? 1 : 0;
      dd_record(clk, 1, lane);
    }
  }
}

}  // namespace brotli_torch

using namespace brotli_torch;

// Both entries launch on `stream` over a card of `sms` SMs and return
// cudaGetLastError() (0 on success).  body: every lane's u32 words one
// lane after another; scal: (n_lanes, DD_SCAL_N); tabs: (n_lanes,
// DD_TAB_N); consts: the LUT; out: (n_lanes, out_size) u8, zero on entry;
// pos (n_lanes,) i32; err (n_lanes,) u8.
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
                           DD_SMEM_SHARED) != cudaSuccess)
    return (int)cudaGetLastError();
  const int slots = sms * DD_BLOCKS_SM_SHARED;
  const int blocks = n_lanes < slots ? n_lanes : slots;
  device_decode_kernel<<<blocks, 32, DD_SMEM_SHARED, (cudaStream_t)stream>>>(
      (const u32*)body, (const i32*)scal, (const i32*)tabs,
      (const i32*)consts, (u8*)out, (i32*)pos, (u8*)err, n_lanes, max_words,
      out_size);
  return (int)cudaGetLastError();
}

extern "C" int brotli_torch_device_decode_direct(
    const void* body, const void* scal, const void* tabs, const void* consts,
    void* out, void* pos, void* err, int n_lanes, int max_words, int out_size,
    int sms, void* stream) {
  if (n_lanes <= 0 || max_words < 0 || out_size < 0 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  if (cudaFuncSetAttribute(device_decode_direct_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DD_SMEM) != cudaSuccess)
    return (int)cudaGetLastError();
  const int need = (n_lanes + DD_WARPS - 1) / DD_WARPS;
  const int blocks = need < sms * DD_BLOCKS_SM ? need : sms * DD_BLOCKS_SM;
  device_decode_direct_kernel<<<blocks, 32 * DD_WARPS, DD_SMEM,
                                (cudaStream_t)stream>>>(
      (const u32*)body, (const i32*)scal, (const i32*)tabs,
      (const i32*)consts, (u8*)out, (i32*)pos, (u8*)err, n_lanes, max_words,
      out_size);
  return (int)cudaGetLastError();
}

// The launch shape of the shared form: threads a block, dynamic shared
// bytes a block, blocks an SM, ring words, window bytes.
extern "C" int brotli_torch_device_decode_config(void* out) {
  int* o = (int*)out;
  o[0] = 32;
  o[1] = DD_SMEM_SHARED;
  o[2] = DD_BLOCKS_SM_SHARED;
  o[3] = DD_RING;
  o[4] = DD_WIN;
  return 0;
}

#if defined(DD_PHASE_CLOCKS)
// The lanes' clocks and events since the last call (dd_lane_clocks, u64
// [2][DD_CLOCK_LANES][DD_PHASES]; dd_lane_events, u32
// [2][DD_CLOCK_LANES][DD_EVENTS]), then zeroed; the lanes recorded.
extern "C" int brotli_torch_device_decode_clocks(void* clocks, void* events,
                                                 void* lanes) {
  *(int*)lanes = DD_CLOCK_LANES;
  cudaError_t rc =
      cudaMemcpyFromSymbol(clocks, dd_lane_clocks, sizeof(dd_lane_clocks));
  if (rc == cudaSuccess)
    rc = cudaMemcpyFromSymbol(events, dd_lane_events, sizeof(dd_lane_events));
  if (rc != cudaSuccess) return (int)rc;
  void* p = nullptr;
  rc = cudaGetSymbolAddress(&p, dd_lane_clocks);
  if (rc == cudaSuccess) rc = cudaMemset(p, 0, sizeof(dd_lane_clocks));
  if (rc == cudaSuccess) rc = cudaGetSymbolAddress(&p, dd_lane_events);
  if (rc == cudaSuccess) rc = cudaMemset(p, 0, sizeof(dd_lane_events));
  return (int)rc;
}
#endif
