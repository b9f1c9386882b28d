// CUDA structure probes: what one row of the v2 entropy kernel's operations
// and the kernel structure around it cost on Hopper, in ns per row.
// Replaces the TPU probes tools/probe_v2.py `bench` / `kernel` and
// tools/probe_v2b.py `bench` / `kernel`.
//
// Bound on Hopper: latency.  Each tile element is one thread running a
// serial chain of dependent integer operations over ROWS rows, 1024 threads
// in all, so the card is nearly idle and the time is the chain's length
// times the latency of each operation (plus, for probe_v2b, the block-wide
// barriers of its reductions and copies).  The bytes (a 4 KB tile, at most
// a 1 MB staging array) and the operations (~10^8) are far below what
// bounds the card.  That is what a probe measures: the per-row cost of a
// serial lane, which is the decode kernels' shape too.
//
// Layout: block b holds row b of the (8, 128) tile, 128 threads, one per
// lane.
//
// probe_v2: the carries live in registers and the level is a template
// parameter.  The TPU kernel's staging scratch is (256, 8, 128) u32 = 1 MB,
// beyond a block's shared memory, so level 4 stores to a global staging
// array that the wrapper allocates and returns.  The level-5 gather reads
// across the 128 lanes of a tile row, so the block keeps its tile row of the
// input in shared memory.
//
// probe_v2b: the TPU window is (64, 8, 128) u32 = 256 KB, over the 227 KB a
// block may have.  Splitting the tile's 1024 lanes over 8 blocks of 128
// threads gives each block a 64-row window of its own lanes (32 KB) and a
// staging array (16 KB at 32 rows) in shared memory.  A reduction then spans
// a block's 128 lanes, one tile row, where the TPU's spans the whole tile:
// the plain version reduces per tile row too.  The output does not depend on
// the window's contents or on `filled`, only on how many blocks run, and the
// while loop's any() differs only if a whole tile row of carry[0] is
// 0xFFFFFFFF.  The refill is cp.async (16 bytes a copy) into the window
// ring, then a wait and a barrier; the staging flush is a block-wide copy to
// global memory between two barriers; a reduction is warp shuffles, then
// shared memory.
#include <cuda_runtime.h>

#include "probe.cuh"

namespace brotli_torch {

template <int LEVEL>
__global__ void __launch_bounds__(PROBE_LANES)
probe_v2_kernel(const i32* __restrict__ a, i32* __restrict__ carry,
                u32* __restrict__ staging, int blocks, int block_rows) {
  __shared__ i32 arow[PROBE_LANES];
  const int lane = threadIdx.x;
  const int e = blockIdx.x * PROBE_LANES + lane;
  arow[lane] = a[e];
  __syncthreads();
  const u32 st0 = (u32)arow[lane];
  ProbeV2 c{st0, st0 + 1u, st0 + 2u, 0};
  for (int blk = 0; blk < blocks; ++blk) {
    for (int r = 0; r < block_rows; ++r) {
      probe_v2_row<LEVEL>(c, arow);
      if (LEVEL >= 4) staging[(i64)r * PROBE_TILE + e] = c.b0;
    }
  }
  carry[e] = (i32)c.b0;
  carry[PROBE_TILE + e] = (i32)c.b1;
  carry[2 * PROBE_TILE + e] = (i32)c.b2;
  carry[3 * PROBE_TILE + e] = c.q;
}

// Minimum of v over the block's 128 threads: warp shuffles, then the four
// warps' minima through shared memory.  Every thread gets the result.
__device__ __forceinline__ i32 block_min(i32 v, i32* red) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  i32 m = red[0];
  for (int w = 1; w < PROBE_LANES / 32; ++w) m = min(m, red[w]);
  __syncthreads();
  return m;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int NCARRY, bool WHILE, bool REDUCES, bool DMA_IN, bool DMA_OUT>
__global__ void __launch_bounds__(PROBE_LANES)
probe_v2b_kernel(const i32* __restrict__ a, const u32* __restrict__ wt,
                 u32* __restrict__ out, i32* __restrict__ stat, int blocks,
                 int block_rows) {
  extern __shared__ __align__(16) u32 smem[];
  u32* win = smem;                                 // (PROBE_WIN, 128)
  u32* staging = smem + PROBE_WIN * PROBE_LANES;   // (block_rows, 128)
  __shared__ i32 red[PROBE_LANES / 32];
  const int sub = blockIdx.x;
  const int lane = threadIdx.x;
  const int e = sub * PROBE_LANES + lane;
  const u32 st0 = (u32)a[e];
  u32 c[NCARRY];
#pragma unroll
  for (int i = 0; i < NCARRY; ++i) c[i] = st0 + (u32)i;
  for (int r = 0; r < block_rows; ++r) staging[r * PROBE_LANES + lane] = 0;
  i32 filled = PROBE_WIN;
  int blk = 0;
  for (;; ++blk) {
    if (blk >= blocks) break;
    if (WHILE && REDUCES &&
        block_min(c[0] < 0xFFFFFFFFu ? 0 : 1, red) != 0)
      break;  // no lane of the tile row has carry[0] < 0xFFFFFFFF
    const i32 minp =
        REDUCES ? block_min(probe_v2b_minkey(c[0], c[1]), red) : 0;
    const bool refill = probe_v2b_refill(REDUCES, minp, filled);
    if (DMA_IN && refill) {
      // 32 rows x 128 u32 of this tile row, 16 bytes a copy, into the ring
      const int slot = filled % PROBE_WIN;
      constexpr int per_row = PROBE_LANES / 4;
      for (int k = lane; k < PROBE_REFILL * per_row; k += PROBE_LANES) {
        const int row = k / per_row, q4 = k % per_row;
        cp_async16(win + (slot + row) * PROBE_LANES + q4 * 4,
                   wt + (i64)(filled + row) * PROBE_TILE + sub * PROBE_LANES +
                       q4 * 4);
      }
      cp_async_wait_all();
      __syncthreads();
    }
    if (refill) filled += PROBE_REFILL;
    for (int r = 0; r < block_rows; ++r) {
      probe_v2b_row<NCARRY>(c);
      staging[r * PROBE_LANES + lane] = c[0];
    }
    if (DMA_OUT) {
      __syncthreads();
      constexpr int per_row = PROBE_LANES / 4;
      for (int k = lane; k < block_rows * per_row; k += PROBE_LANES) {
        const int row = k / per_row, q4 = k % per_row;
        *reinterpret_cast<uint4*>(out + (i64)row * PROBE_TILE +
                                  sub * PROBE_LANES + q4 * 4) =
            *reinterpret_cast<const uint4*>(staging + row * PROBE_LANES +
                                            q4 * 4);
      }
      __syncthreads();
    }
  }
  // the TPU kernel's last copy: staging[0] = carry[0], then rows 0-7 out
  staging[lane] = c[0];
  for (int r = 0; r < 8; ++r)
    out[(i64)r * PROBE_TILE + e] = staging[r * PROBE_LANES + lane];
  if (lane == 0) {
    stat[2 * sub] = blk;
    stat[2 * sub + 1] = filled;
  }
}

template <int LEVEL>
int launch_v2(const void* a, void* carry, void* staging, int blocks,
              int block_rows, cudaStream_t stream) {
  probe_v2_kernel<LEVEL><<<PROBE_SUB, PROBE_LANES, 0, stream>>>(
      (const i32*)a, (i32*)carry, (u32*)staging, blocks, block_rows);
  return (int)cudaGetLastError();
}

template <int NCARRY, bool WHILE, bool REDUCES, bool DMA_IN, bool DMA_OUT>
int launch_v2b(const void* a, const void* wt, void* out, void* stat,
               int blocks, int block_rows, cudaStream_t stream) {
  auto* kernel = probe_v2b_kernel<NCARRY, WHILE, REDUCES, DMA_IN, DMA_OUT>;
  const int smem = (PROBE_WIN + block_rows) * PROBE_LANES * (int)sizeof(u32);
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<PROBE_SUB, PROBE_LANES, smem, stream>>>(
      (const i32*)a, (const u32*)wt, (u32*)out, (i32*)stat, blocks,
      block_rows);
  return (int)cudaGetLastError();
}

}  // namespace brotli_torch

using namespace brotli_torch;

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// a is the (8, 128) tile; carry is (4, 8, 128): b0, b1, b2, q; staging is
// (block_rows, 8, 128), written at level >= 4.
extern "C" int brotli_torch_probe_v2(const void* a, void* carry,
                                     void* staging, int level, int blocks,
                                     int block_rows, void* stream) {
  if (blocks < 1 || block_rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (level) {
    case 1: return launch_v2<1>(a, carry, staging, blocks, block_rows, s);
    case 2: return launch_v2<2>(a, carry, staging, blocks, block_rows, s);
    case 3: return launch_v2<3>(a, carry, staging, blocks, block_rows, s);
    case 4: return launch_v2<4>(a, carry, staging, blocks, block_rows, s);
    case 5: return launch_v2<5>(a, carry, staging, blocks, block_rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// a is the (8, 128) tile, wt the (wrows, 8, 128) word table; out is
// (block_rows, 8, 128) and stat (8, 2): blocks run and the final fill level
// of each tile row.  Built for the six variants of tools/probe_v2b.py.
extern "C" int brotli_torch_probe_v2b(const void* a, const void* wt,
                                      void* out, void* stat, int ncarry,
                                      int while_outer, int reduces,
                                      int dma_in, int dma_out, int blocks,
                                      int block_rows, int wrows,
                                      void* stream) {
  if (blocks < 1 || block_rows < 8 ||
      wrows < PROBE_FILL_CAP)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int key = ncarry * 16 + (while_outer != 0) * 8 + (reduces != 0) * 4 +
                  (dma_in != 0) * 2 + (dma_out != 0);
  switch (key) {
    case 4 * 16:
      return launch_v2b<4, false, false, false, false>(a, wt, out, stat,
                                                       blocks, block_rows, s);
    case 18 * 16:
      return launch_v2b<18, false, false, false, false>(a, wt, out, stat,
                                                        blocks, block_rows, s);
    case 18 * 16 + 8:
      return launch_v2b<18, true, false, false, false>(a, wt, out, stat,
                                                       blocks, block_rows, s);
    case 18 * 16 + 12:
      return launch_v2b<18, true, true, false, false>(a, wt, out, stat,
                                                      blocks, block_rows, s);
    case 18 * 16 + 14:
      return launch_v2b<18, true, true, true, false>(a, wt, out, stat,
                                                     blocks, block_rows, s);
    case 18 * 16 + 15:
      return launch_v2b<18, true, true, true, true>(a, wt, out, stat,
                                                    blocks, block_rows, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
