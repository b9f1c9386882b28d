// CUDA LZ-resolve kernels: v2 tokens -> decoded bytes.  Both replace
// brotli_tpu/ops/pallas_resolve.py:127 (`_build`, inner `kernel`).
//
// Bound on Hopper: the lane's serial chain, not bytes (70.7 MB of tokens
// in and bytes out on the v2 cell are 0.02 ms at 3.35 TB/s).  The direct
// kernel walks a lane in one thread: every token is a device-memory load
// that the next step's control flow waits on, and every copy byte reads
// back a byte the thread stored a moment before, so a lane costs about
// 1.4 us a token.
//
// `resolve_kernel` (the main path's) takes one lane a warp, 32 tokens a
// step (resolve.cuh resolve_lane_warp): lengths, the pending copy length
// and the faults by ballots, start positions by a warp scan, the step's
// literal bytes and the bytes of its copies from before the step at
// once, then its other copies in order, each over the 32 threads.  So a
// lane's chain is one step per 32 tokens and one warp-wide pass per copy
// that reads the step's own bytes.  A block holds RESOLVE_WARPS adjacent
// lanes, so one token row of the block is one 32-byte sector, loaded for
// each warp by cp.async into a ring of 4 chunks of 32 tokens.  Each
// lane's bytes live in a window of `win` bytes in shared memory, flushed
// to the slot in 16-byte stores; only a copy from further back than the
// window reads the slot.  Shared memory a block: RESOLVE_WARPS x (win +
// 4 * TOKQ) bytes, above 48 KB through cudaFuncSetAttribute;
// ops/resolve.py `launch_config` sizes `win` from the SM count and the
// SM's shared memory.
//
// `resolve_direct_kernel`: one lane a thread in blocks of 128, each token
// read and each byte written in device memory (resolve.cuh resolve_lane).
#include <cuda_runtime.h>

#include "resolve.cuh"

namespace brotli_torch {

constexpr int RESOLVE_DIRECT_BLOCK = 128;
constexpr int RESOLVE_WARPS = 8;  // lanes (warps) a block of resolve_kernel

__global__ void __launch_bounds__(RESOLVE_DIRECT_BLOCK)
resolve_direct_kernel(const u32* __restrict__ tok,
                      const i32* __restrict__ count,
                      const i32* __restrict__ mlen, u8* __restrict__ out,
                      i32* __restrict__ err, int n_lanes, int cap,
                      long long out_stride) {
  const int lane = blockIdx.x * RESOLVE_DIRECT_BLOCK + threadIdx.x;
  if (lane >= n_lanes) return;
  err[lane] = resolve_lane(tok + lane, n_lanes, count[lane], cap, mlen[lane],
                           out + (i64)lane * out_stride, out_stride);
}

__global__ void __launch_bounds__(32 * RESOLVE_WARPS)
resolve_kernel(const u32* __restrict__ tok, const i32* __restrict__ count,
               const i32* __restrict__ mlen, u8* __restrict__ out,
               i32* __restrict__ err, int n_lanes, int cap,
               long long out_stride, int win) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = threadIdx.x >> 5;
  const int lane = blockIdx.x * RESOLVE_WARPS + w;
  if (lane >= n_lanes) return;  // the whole warp
  const i32 cnt = count[lane];
  const ResolveWarpLane L{
      tok + lane, n_lanes, cnt < cap ? cnt : cap, mlen[lane],
      out + (i64)lane * out_stride, out_stride,
      smem + RESOLVE_WARPS * TOKQ * 4 + (i64)w * win, win - 1,
      (u32*)smem + w * TOKQ};
  const i32 flags = resolve_lane_warp(L);
  if ((threadIdx.x & 31) == 0) err[lane] = flags;
}

}  // namespace brotli_torch

using namespace brotli_torch;

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// tok is (cap, n_lanes) token-major; out is (n_lanes, out_stride).
extern "C" int brotli_torch_resolve_direct(const void* tok, const void* count,
                                           const void* mlen, void* out,
                                           void* err, int n_lanes, int cap,
                                           long long out_stride,
                                           void* stream) {
  if (n_lanes <= 0 || cap < 0 || out_stride < 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n_lanes + RESOLVE_DIRECT_BLOCK - 1) / RESOLVE_DIRECT_BLOCK;
  resolve_direct_kernel<<<blocks, RESOLVE_DIRECT_BLOCK, 0,
                          (cudaStream_t)stream>>>(
      (const u32*)tok, (const i32*)count, (const i32*)mlen, (u8*)out,
      (i32*)err, n_lanes, cap, out_stride);
  return (int)cudaGetLastError();
}

// The same through resolve_kernel, with a window of `win` bytes a lane (a
// power of two >= RESOLVE_WIN_MIN).  `out` must be 16-byte aligned.
extern "C" int brotli_torch_resolve(const void* tok, const void* count,
                                    const void* mlen, void* out, void* err,
                                    int n_lanes, int cap, long long out_stride,
                                    int win, void* stream) {
  if (n_lanes <= 0 || cap < 0 || out_stride < 0 || win < RESOLVE_WIN_MIN ||
      (win & (win - 1)) != 0 || ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)RESOLVE_WARPS * ((size_t)win + 4 * TOKQ);
  if (cudaFuncSetAttribute(resolve_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return (int)cudaGetLastError();
  const int blocks = (n_lanes + RESOLVE_WARPS - 1) / RESOLVE_WARPS;
  resolve_kernel<<<blocks, 32 * RESOLVE_WARPS, smem, (cudaStream_t)stream>>>(
      (const u32*)tok, (const i32*)count, (const i32*)mlen, (u8*)out,
      (i32*)err, n_lanes, cap, out_stride, win);
  return (int)cudaGetLastError();
}
