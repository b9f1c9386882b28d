// CUDA match finder of the device encoder: one thread block per lane.
// Replaces the XLA stage brotli_tpu/ops/device_encode.py `find_matches`
// (stage 1 of `_jitted_stages`), which has no `pallas_call`: on the TPU it
// is a `lax.sort` of each row's hash keys with the window words as payload,
// shifted compares and doubling rounds, all whole-array ops.
//
// Bound on Hopper: bytes.  A 32 KB lane reads 32,780 data bytes and writes
// mlen and mdist (8 B a position): 1024 lanes move 302 MB, 0.090 ms at
// 3.35 TB/s.  Everything between the load and the store stays in the
// block's shared memory, so the kernel touches device memory only for
// those bytes (and, with hash2, one stash of the first pass's distances in
// the mdist row, read back once):
//
//   words    the lane's bytes as little-endian u32 words; a window word at
//            any byte is a funnel shift of two of them;
//   a, b     two u16 arrays of N entries: the radix sort's ping-pong
//            buffers of hashed-position ids, then the match lengths and
//            distances in position order;
//   counts   the radix counts (256 digits x warps), then the byte-run
//            scan's window minima.
//
// At N = 32,768 that is 196,752 B: one block of 1024 threads an SM, 1024
// lanes in 8 waves over 132 SMs.  Phases, each ended by a barrier:
//
// 1. sort: the ids 0..n2-1 in position order, then a stable LSD radix sort
//    on the 17-bit hash key, 8 bits a pass (2 passes at 32 KB, where the
//    key has 16 bits; 3 elsewhere).  A warp owns a contiguous run of ids
//    and ranks 32 of them at a time with __match_any_sync, so equal
//    digits keep their order: a hashed position's sorted neighbours are
//    its nearest earlier positions with the same hash, as in the plain
//    version's sort of (hash << pbits | pos).  Keys are recomputed from the
//    words at each pass rather than stored (no room for 128 KB of keys);
// 2. neighbours: each sorted id looks back at most `depth` ids while the
//    hash is the same and keeps the best candidate's distance, written at
//    its position in the other buffer.  A distance determines its match
//    length (the two windows' common prefix), so one u16 a position
//    carries the pass's result; the sorted ids' buffer then takes the
//    lengths.  hash2 stashes the first pass's distances in the mdist row,
//    sorts again on the 7-byte hash and merges the two by the tie rule;
// 3. byte runs: a ballot a window of 32 positions finds where runs stop;
//    one warp takes the suffix minimum over the windows, and every
//    position gets its run length without a doubling round;
// 4. extension: the synchronous rounds at strides 8..256, in place: each
//    round walks the lane in tiles of blockDim positions from the front,
//    reading a tile's lengths and those a stride ahead before a barrier and
//    writing the tile after it.  A write only lands on a position that no
//    later tile reads, so every read sees the last round's value;
// 5. the clamp to n_valid, and one coalesced store of mlen and mdist.
#include <cuda_runtime.h>

#include "matches.cuh"

namespace brotli_torch {

constexpr int MATCH_BINS = 256;  // radix digit of 8 bits
constexpr u32 MATCH_FULL = 0xFFFFFFFFu;

// Threads of a lane's block: a power of two with at most 8 positions a
// thread below 8 KB, and 1024 from there.
inline int match_threads(int n) {
  int t = 64;
  while (t < 1024 && t * 8 < n) t *= 2;
  return t;
}

__host__ __device__ inline int match_words(int n) {
  return (n + MATCH_TAIL + 3) / 4 + 1;
}
__host__ __device__ inline int match_buf(int n) { return (n + 7) & ~7; }

inline size_t match_smem_bytes(int n, int threads) {
  return 4 * (size_t)match_words(n) + 4 * (size_t)match_buf(n) +
         4 * (size_t)MATCH_BINS * (threads / 32) + 4 * 32;
}

// The 32-bit window word starting at byte q.
__device__ __forceinline__ u32 win_at(const u32* w, i32 q) {
  return funnel_r(w[q >> 2], w[(q >> 2) + 1], (u32)(q & 3) * 8u);
}

__device__ __forceinline__ u32 byte_at(const u32* w, i32 q) {
  return (w[q >> 2] >> ((q & 3) * 8)) & 0xFFu;
}

__device__ __forceinline__ u32 entry_key(const u32* w, i32 e,
                                         const MatchKnobs& K, bool h7) {
  const i32 p = e * K.st;
  return match_key(win_at(w, p), h7 ? win_at(w, p + 4) : 0u, h7, K.pbits);
}

// Common prefix of the windows at p and p - d (0 for d == 0).
__device__ __forceinline__ i32 len_at(const u32* w, i32 p, i32 d) {
  if (d == 0) return 0;
  return match_len(win_at(w, p), win_at(w, p + 4), win_at(w, p - d),
                   win_at(w, p - d + 4));
}

// The byte-run terminator at q: past the lane, or d[q] != d[q-4].
__device__ __forceinline__ bool run_stops(const u32* w, i32 q, i32 n) {
  return q >= n || q < 4 || byte_at(w, q) != byte_at(w, q - 4);
}

// Exclusive sum of one value a thread over the block (tmp: 32 words).
__device__ u32 block_exclusive_sum(u32 v, u32* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  u32 x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const u32 y = __shfl_up_sync(MATCH_FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    u32 s = lane < nwarps ? tmp[lane] : 0u;
    for (int off = 1; off < 32; off <<= 1) {
      const u32 y = __shfl_up_sync(MATCH_FULL, s, off);
      if (lane >= off) s += y;
    }
    tmp[lane] = s;
  }
  __syncthreads();
  const u32 out = (warp ? tmp[warp - 1] : 0u) + x - v;
  __syncthreads();
  return out;
}

// One stable pass of the radix sort: src -> dst by the digit at `shift`.
__device__ void radix_pass(const u32* w, const u16* src, u16* dst,
                           u32* counts, u32* tmp, int n2, int shift,
                           const MatchKnobs& K, bool h7) {
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, W = T >> 5;
  for (int i = tid; i < MATCH_BINS * W; i += T) counts[i] = 0;
  __syncthreads();
  const int seg = (((n2 + W - 1) / W) + 31) & ~31;
  const int lo = warp * seg;
  const int hi = min(lo + seg, n2);
  for (int i = lo + lane; i < hi; i += 32) {
    const u32 dg = (entry_key(w, src[i], K, h7) >> shift) & 0xFFu;
    atomicAdd(&counts[dg * W + warp], 1u);
  }
  __syncthreads();
  // digit-major, warp-minor exclusive offsets: 8 counts a thread
  u32 sum = 0;
  for (int k = 0; k < 8; ++k) sum += counts[tid * 8 + k];
  u32 at = block_exclusive_sum(sum, tmp);
  for (int k = 0; k < 8; ++k) {
    const u32 c = counts[tid * 8 + k];
    counts[tid * 8 + k] = at;
    at += c;
  }
  __syncthreads();
  for (int g = lo; g < lo + seg; g += 32) {
    const int i = g + lane;
    const bool valid = i < hi;
    u32 e = 0, dg = MATCH_BINS;  // a digit no valid id has
    if (valid) {
      e = src[i];
      dg = (entry_key(w, (i32)e, K, h7) >> shift) & 0xFFu;
    }
    const u32 peers = __match_any_sync(MATCH_FULL, dg);
    u32 base = 0;
    if (valid) {
      base = counts[dg * W + warp];
      dst[base + __popc(peers & ((1u << lane) - 1u))] = (u16)e;
    }
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1)
      counts[dg * W + warp] = base + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
}

// The ids 0..n2-1 sorted by hash key, stably; returns the buffer that holds
// them (a or b).
__device__ u16* sort_ids(const u32* w, u16* a, u16* b, u32* counts, u32* tmp,
                         int n2, const MatchKnobs& K, bool h7) {
  for (int i = threadIdx.x; i < n2; i += blockDim.x) a[i] = (u16)i;
  __syncthreads();
  const int kbits = min(31 - K.pbits, 17);
  u16* src = a;
  u16* dst = b;
  for (int shift = 0; shift < kbits; shift += 8) {
    radix_pass(w, src, dst, counts, tmp, n2, shift, K, h7);
    u16* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

// Each sorted id's best candidate among its `depth` nearest earlier ids of
// the same hash: the distance, at its position in `dist` (0 elsewhere).
__device__ void neighbours(const u32* w, const u16* sorted, u16* dist, int n,
                           int n2, const MatchKnobs& K, bool h7, int depth) {
  for (int p = threadIdx.x; p < n; p += blockDim.x) dist[p] = 0;
  __syncthreads();
  for (int k = threadIdx.x; k < n2; k += blockDim.x) {
    const i32 p = (i32)sorted[k] * K.st;
    const u32 a0 = win_at(w, p), a1 = win_at(w, p + 4);
    const u32 key = match_key(a0, a1, h7, K.pbits);
    i32 sl = 0, sd = 0;
    for (int j = 1; j <= depth && k - j >= 0; ++j) {
      const i32 c = (i32)sorted[k - j] * K.st;
      const u32 b0 = win_at(w, c), b1 = win_at(w, c + 4);
      if (match_key(b0, b1, h7, K.pbits) != key) break;
      i32 l, d;
      match_candidate(K, match_len(a0, a1, b0, b1), p - c, l, d);
      match_take(sl, sd, l, d);
    }
    dist[p] = (u16)sd;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(1024)
match_kernel(const u8* __restrict__ data, const i32* __restrict__ n_valid,
             i32* __restrict__ mlen, i32* __restrict__ mdist, int n,
             MatchKnobs K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, W = T >> 5;
  const int nw = match_words(n);
  u32* w = (u32*)smem;
  u16* a = (u16*)(w + nw);
  u16* b = a + match_buf(n);
  u32* counts = (u32*)(b + match_buf(n));
  u32* tmp = counts + MATCH_BINS * W;

  const i64 lane_id = blockIdx.x;
  const int rbytes = n + MATCH_TAIL;
  const u8* src = data + lane_id * rbytes;
  const i64 row = lane_id * n;
  const i32 nv = n_valid[lane_id];
  for (int i = tid; i < nw; i += T) {
    u32 v = 0;
    for (int k = 0; k < 4; ++k) {
      const int q = 4 * i + k;
      if (q < rbytes) v |= (u32)src[q] << (8 * k);
    }
    w[i] = v;
  }
  __syncthreads();

  // 1-2: the hash passes
  const int n2 = n / K.st;
  u16* len = sort_ids(w, a, b, counts, tmp, n2, K, false);
  u16* dist = len == a ? b : a;
  neighbours(w, len, dist, n, n2, K, false, K.depth);
  if (K.hash2) {
    for (int p = tid; p < n; p += T) mdist[row + p] = dist[p];
    __syncthreads();
    len = sort_ids(w, a, b, counts, tmp, n2, K, true);
    dist = len == a ? b : a;
    neighbours(w, len, dist, n, n2, K, true, 2);
    for (int p = tid; p < n; p += T) {
      i32 sd = mdist[row + p];
      i32 sl = len_at(w, p, sd);
      const i32 d7 = dist[p];
      match_take(sl, sd, len_at(w, p, d7), d7);
      dist[p] = (u16)sd;
    }
    __syncthreads();
  }
  for (int p = tid; p < n; p += T) len[p] = (u16)len_at(w, p, dist[p]);
  __syncthreads();

  // 3: byte runs.  fpos[v]: the first terminator at or after window v
  const int nwin = (n + 31) >> 5;
  u32* fpos = counts;
  for (int v = warp; v < nwin; v += W) {
    const u32 m = __ballot_sync(MATCH_FULL, run_stops(w, v * 32 + lane, n));
    if (lane == 0) fpos[v] = m ? (u32)(v * 32 + __ffs(m) - 1) : (u32)n;
  }
  __syncthreads();
  if (warp == 0) {
    u32 carry = (u32)n;
    for (int base = ((nwin - 1) >> 5) << 5; base >= 0; base -= 32) {
      const int v = base + lane;
      u32 x = v < nwin ? fpos[v] : (u32)n;
      for (int off = 1; off < 32; off <<= 1) {
        const u32 y = __shfl_down_sync(MATCH_FULL, x, off);
        if (lane + off < 32) x = min(x, y);
      }
      x = min(x, carry);
      if (v < nwin) fpos[v] = x;
      carry = __shfl_sync(MATCH_FULL, x, 0);
    }
  }
  __syncthreads();
  for (int v = warp; v < nwin; v += W) {
    const i32 q = v * 32 + lane;
    const u32 m = __ballot_sync(MATCH_FULL, run_stops(w, q, n)) >> lane;
    const i32 stop = m ? q + __ffs(m) - 1
                       : (v + 1 < nwin ? (i32)fpos[v + 1] : n);
    if (q < n) {
      i32 l = len[q], d = dist[q];
      match_run(stop - q, l, d);
      len[q] = (u16)l;
      dist[q] = (u16)d;
    }
  }
  __syncthreads();

  // 4: extension rounds, in place, tile by tile from the front
  const i32 lim = match_ext_limit(n);
  for (i32 s = MATCH_CAP_BYTES; s < lim; s *= 2) {
    for (int t0 = 0; t0 < n; t0 += T) {
      const i32 p = t0 + tid;
      i32 l = 0, d = 0, nl = 0, nd = 0;
      if (p < n) {
        l = len[p];
        d = dist[p];
        if (p + s < n) {
          nl = len[p + s];
          nd = dist[p + s];
        }
      }
      __syncthreads();
      if (p < n) {
        const i32 grown = match_extend(s, l, d, nl, nd);
        if (grown != l) len[p] = (u16)grown;
      }
    }
    __syncthreads();
  }

  // 5: clamp and store
  for (int p = tid; p < n; p += T) {
    i32 l = len[p], d = dist[p];
    match_final(p, nv, l, d);
    mlen[row + p] = l;
    mdist[row + p] = d;
  }
}

}  // namespace brotli_torch

using namespace brotli_torch;

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for knobs the kernel does not take.  data is
// (n_lanes, n + 12) bytes, n_valid (n_lanes,) int32, mlen and mdist
// (n_lanes, n) int32; max_dist < 0 means no cap.  One block per lane.
extern "C" int brotli_torch_matches(const void* data, const void* n_valid,
                                    void* mlen, void* mdist, int n_lanes,
                                    int n, int st, int max_dist, int depth,
                                    int hash2, void* stream) {
  if (!match_args_ok(n_lanes, n, st, max_dist, depth))
    return (int)cudaErrorInvalidValue;
  const int threads = match_threads(n);
  const size_t smem = match_smem_bytes(n, threads);
  const cudaError_t e = cudaFuncSetAttribute(
      match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const MatchKnobs K{st, match_pbits(n / st), max_dist, depth, hash2 != 0};
  match_kernel<<<n_lanes, threads, smem, (cudaStream_t)stream>>>(
      (const u8*)data, (const i32*)n_valid, (i32*)mlen, (i32*)mdist, n, K);
  return (int)cudaGetLastError();
}

// The block shape a launch at n takes: threads, dynamic shared bytes.
extern "C" int brotli_torch_matches_config(int n, void* out) {
  if (n <= 0 || n > MATCH_MAX_N) return 1;
  const int threads = match_threads(n);
  ((int*)out)[0] = threads;
  ((int*)out)[1] = (int)match_smem_bytes(n, threads);
  return 0;
}
