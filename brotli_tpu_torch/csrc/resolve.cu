// CUDA LZ-resolve kernel: v2 tokens -> decoded bytes, one thread per lane.
// Replaces brotli_tpu/ops/pallas_resolve.py `_build` / `kernel`.
//
// Bound on Hopper: memory latency.  Each lane walks its own tokens and
// writes its bytes, in order, into its own slot of a slot-major
// (n_lanes, out_stride) u8 output; a copy reads bytes this thread wrote
// earlier in the same slot, so no ring, window or cross-lane cursor is
// needed.  The per-byte stores of neighbouring lanes fall out_stride bytes
// apart (uncoalesced) and the L2 absorbs them; a later version can stage
// words in registers or shared memory.
#include <cuda_runtime.h>

#include "resolve.cuh"

namespace brotli_torch {

constexpr int RESOLVE_BLOCK = 128;

__global__ void __launch_bounds__(RESOLVE_BLOCK)
resolve_kernel(const u32* __restrict__ tok, const i32* __restrict__ count,
               const i32* __restrict__ mlen, u8* __restrict__ out,
               i32* __restrict__ err, int n_lanes, int cap,
               long long out_stride) {
  const int lane = blockIdx.x * RESOLVE_BLOCK + threadIdx.x;
  if (lane >= n_lanes) return;
  err[lane] = resolve_lane(tok + lane, n_lanes, count[lane], cap, mlen[lane],
                           out + (i64)lane * out_stride, out_stride);
}

}  // namespace brotli_torch

using namespace brotli_torch;

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// tok is (cap, n_lanes) token-major; out is (n_lanes, out_stride).
extern "C" int brotli_torch_resolve(const void* tok, const void* count,
                                    const void* mlen, void* out, void* err,
                                    int n_lanes, int cap, long long out_stride,
                                    void* stream) {
  if (n_lanes <= 0 || cap < 0 || out_stride < 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n_lanes + RESOLVE_BLOCK - 1) / RESOLVE_BLOCK;
  resolve_kernel<<<blocks, RESOLVE_BLOCK, 0, (cudaStream_t)stream>>>(
      (const u32*)tok, (const i32*)count, (const i32*)mlen, (u8*)out,
      (i32*)err, n_lanes, cap, out_stride);
  return (int)cudaGetLastError();
}
