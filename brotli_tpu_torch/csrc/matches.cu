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
// the mdist row, read back once).  What holds it back is the block's
// shared memory: a 32 KB lane's words and two u16 buffers of N entries
// (161 KB) leave room for one block of 1024 threads an SM, so every
// barrier idles the SM and each phase runs at the pace of its 32 warps'
// chains of shared-memory loads (tools/enc_phases.py).
//
//   words    the lane's bytes as little-endian u32 words; a window word at
//            any byte is a funnel shift of two of them;
//   a, b     two u16 arrays of N entries: the radix sort's ping-pong
//            buffers of hashed-position ids, then the match lengths and
//            distances in position order;
//   high     (match_kernel) a byte an id: the sort key's high digit, then
//            each hashed position's match length;
//   counts   the radix counts, then the byte-run scan's window minima.
//
// `match_kernel` (the main path's, find_matches), at N = 32,768 229,648 B
// of shared memory (blocks of 1024 threads; 512 where the first digit has
// 9 bits, hash_stride 2 at N = 32,768, so that its counts fit); built a
// second time for blocks of up to 512 threads (N <= 4096) at 4 blocks an
// SM.  Phases, each ended by a barrier:
//
// 1. sort: a stable LSD radix sort of the ids 0..n2-1 on the 16- or 17-bit
//    hash key in two passes (its low 8 or 9 bits, then the high 8).  A
//    warp owns a contiguous run of ids and ranks 32 of them at a time (the
//    lanes of equal digits from a ballot a digit bit in the first pass of
//    the 1024-thread build, __match_any_sync elsewhere), so equal digits
//    keep their order: a hashed position's sorted neighbours are its
//    nearest earlier positions with the same hash, as in the plain
//    version's sort of (hash << pbits | pos).  The counts are warp-major
//    (a warp's lanes count and rank in distinct banks).  The first pass
//    reads the ids in position order and computes each key from
//    consecutive windows; its scatter writes the key's high digit beside
//    each id (`high`), so the second pass reads its digit instead of a
//    permuted id's windows;
// 2. neighbours: each sorted id looks back at most `depth` ids while the
//    hash is the same and keeps the best candidate's distance, written at
//    its position in the other buffer, and its length in `high`.  A
//    distance determines its match length (the two windows' common
//    prefix), so one u16 a position carries the pass's result.  hash2
//    stashes the first pass's distances in the mdist row, sorts again on
//    the 7-byte hash and merges the two by the tie rule;
// 3. lengths and byte runs: a ballot a window of 32 positions finds where
//    runs stop, a block-wide suffix minimum over the windows (one a
//    thread) where each run ends, and every position gets its length and
//    run in one pass;
// 4. extension: the synchronous rounds at strides 8..256, in place, in
//    tiles of 8 positions a thread (4 in the 512-thread build) from the
//    front: a position reads its neighbour a stride ahead only when its
//    length is the stride, and a tile's reads all come before the barrier
//    that precedes its writes.  A write only lands on a position that no
//    later tile reads, so every read sees the last round's value: 5
//    barriers a round at 32 KB, where the direct kernel takes 33;
// 5. the clamp to n_valid, and one coalesced store of mlen and mdist.
//
// `match_direct_kernel` (the first form, find_matches_direct, kept to be
// timed against): the same phases with the ids sorted 8 bits a pass (2
// passes at 32 KB, 3 below) from a buffer of ids, keys recomputed from the
// windows of permuted ids at both the count and the scatter, the counts
// digit-major; byte runs by one warp's serial scan over the windows and
// lengths in a pass of their own; extension tiles of blockDim positions.
#include <cuda_runtime.h>

#include "matches.cuh"

namespace brotli_torch {

constexpr int MATCH_BINS = 256;  // radix digit of 8 bits
constexpr u32 MATCH_FULL = 0xFFFFFFFFu;

// Phases of a lane, for the build with -DENC_PHASE_CLOCKS
// (tools/enc_phases.py): thread 0 of each block adds the clock64() cycles
// since its last mark, each taken after the barrier that ends a phase, to
// match_clocks[kernel][phase].  Sort pass k (0-2 of the 4-byte hash, 3-5 of
// the 7-byte one) counts at MATCH_PH_SORT + 3k, scans at + 1 and scatters
// at + 2.
constexpr int MATCH_PH_LOAD = 0, MATCH_PH_IDS = 1, MATCH_PH_SORT = 2,
              MATCH_PH_NEIGHBOURS = 20, MATCH_PH_MERGE = 21,
              MATCH_PH_LENGTHS = 22, MATCH_PH_RUNS = 23, MATCH_PH_EXTEND = 24,
              MATCH_PH_STORE = 25;

#if defined(ENC_PHASE_CLOCKS)
constexpr int MATCH_PHASES = 26;
__device__ unsigned long long match_clocks[2][MATCH_PHASES];
struct MatchClock {
  unsigned long long* acc;
  long long last;
  __device__ explicit MatchClock(int kernel) : acc(match_clocks[kernel]) {
    last = clock64();
  }
  __device__ void mark(int phase) {
    if (threadIdx.x == 0) {
      const long long now = clock64();
      atomicAdd(&acc[phase], (unsigned long long)(now - last));
      last = now;
    }
  }
};
#else
struct MatchClock {
  __device__ explicit MatchClock(int) {}
  __device__ void mark(int) {}
};
#endif

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
                           const MatchKnobs& K, bool h7, MatchClock& clk,
                           int phase) {
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
  clk.mark(phase);
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
  clk.mark(phase + 1);
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
  clk.mark(phase + 2);
}

// The ids 0..n2-1 sorted by hash key, stably; returns the buffer that holds
// them (a or b).
__device__ u16* sort_ids(const u32* w, u16* a, u16* b, u32* counts, u32* tmp,
                         int n2, const MatchKnobs& K, bool h7,
                         MatchClock& clk) {
  for (int i = threadIdx.x; i < n2; i += blockDim.x) a[i] = (u16)i;
  __syncthreads();
  clk.mark(MATCH_PH_IDS);
  const int kbits = min(31 - K.pbits, 17);
  u16* src = a;
  u16* dst = b;
  for (int shift = 0, k = h7 ? 3 : 0; shift < kbits; shift += 8, ++k) {
    radix_pass(w, src, dst, counts, tmp, n2, shift, K, h7, clk,
               MATCH_PH_SORT + 3 * k);
    u16* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

// Each sorted id's best candidate among its `depth` nearest earlier ids of
// the same hash: the distance, at its position in `dist` (0 elsewhere).
// With `lens`, each hashed position's match length too, at its id.
__device__ void neighbours(const u32* w, const u16* sorted, u16* dist, int n,
                           int n2, const MatchKnobs& K, bool h7, int depth,
                           u8* lens = nullptr) {
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
    if (lens) lens[sorted[k]] = (u8)sl;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(1024)
match_direct_kernel(const u8* __restrict__ data,
                    const i32* __restrict__ n_valid, i32* __restrict__ mlen,
                    i32* __restrict__ mdist, int n, MatchKnobs K) {
  extern __shared__ __align__(16) unsigned char smem[];
  MatchClock clk(0);
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
  clk.mark(MATCH_PH_LOAD);

  // 1-2: the hash passes
  const int n2 = n / K.st;
  u16* len = sort_ids(w, a, b, counts, tmp, n2, K, false, clk);
  u16* dist = len == a ? b : a;
  neighbours(w, len, dist, n, n2, K, false, K.depth);
  clk.mark(MATCH_PH_NEIGHBOURS);
  if (K.hash2) {
    for (int p = tid; p < n; p += T) mdist[row + p] = dist[p];
    __syncthreads();
    clk.mark(MATCH_PH_MERGE);
    len = sort_ids(w, a, b, counts, tmp, n2, K, true, clk);
    dist = len == a ? b : a;
    neighbours(w, len, dist, n, n2, K, true, 2);
    clk.mark(MATCH_PH_NEIGHBOURS);
    for (int p = tid; p < n; p += T) {
      i32 sd = mdist[row + p];
      i32 sl = len_at(w, p, sd);
      const i32 d7 = dist[p];
      match_take(sl, sd, len_at(w, p, d7), d7);
      dist[p] = (u16)sd;
    }
    __syncthreads();
    clk.mark(MATCH_PH_MERGE);
  }
  for (int p = tid; p < n; p += T) len[p] = (u16)len_at(w, p, dist[p]);
  __syncthreads();
  clk.mark(MATCH_PH_LENGTHS);

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
  clk.mark(MATCH_PH_RUNS);

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
  clk.mark(MATCH_PH_EXTEND);

  // 5: clamp and store
  for (int p = tid; p < n; p += T) {
    i32 l = len[p], d = dist[p];
    match_final(p, nv, l, d);
    mlen[row + p] = l;
    mdist[row + p] = d;
  }
  __syncthreads();
  clk.mark(MATCH_PH_STORE);
}

// ---------------------------------------------------------------------------
// match_kernel: the same block a lane, its phases redesigned
// ---------------------------------------------------------------------------


// Radix digit bits of the first pass: the key's bits below the second
// pass's 8 (the key has 16 bits at N = 32768, 17 below).
inline int match_digit0(int n, int st) {
  const int kbits = min(31 - match_pbits(n / st), 17);
  return kbits - 8;
}

// Shared memory of match_kernel: the words, the two id / length / distance
// buffers, each sorted id's high digit (a byte a hashed position), the
// counts (a row of (1 << bits0) + 1 words a warp: warp-major, so a warp's
// lanes count in distinct banks) and 32 words of scan scratch: 229,648 B
// at N = 32768.
__host__ __device__ inline int match_high_bytes(int n) {
  return (n + 15) & ~15;
}
inline size_t match_smem_bytes_ranked(int n, int threads, int bits0) {
  return 4 * (size_t)match_words(n) + 4 * (size_t)match_buf(n) +
         (size_t)match_high_bytes(n) +
         4 * (size_t)((1 << bits0) + 1) * (threads / 32) + 4 * 32;
}

// match_threads(n), halved while the counts of a 9-bit digit do not fit
// the card's `limit` bytes a block (hash_stride 2 at N = 32768: 512).
inline int match_threads_fit(int n, int bits0, size_t limit) {
  int t = match_threads(n);
  while (t > 64 && match_smem_bytes_ranked(n, t, bits0) > limit) t /= 2;
  return t;
}

// One stable pass of the radix sort, each warp ranking its contiguous run
// of ids 32 at a time; counts[w * (bins + 1) + digit] is warp w's count.
// The first pass (`first`) takes the ids 0..n2-1 in order (src unused),
// their digit the key's low bits0 bits, the key computed from the windows
// of consecutive positions (no bank conflicts); its scatter writes each
// id's high digit (key >> bits0) beside it in `high`.  The second pass
// reads its digit from `high`: no key is computed from the windows of a
// permuted id.
__device__ void radix_pass_ranked(const u32* w, const u16* src, u16* dst,
                                  u8* high, u32* counts, u32* tmp, int n2,
                                  int bits0, bool first, bool ballots,
                                  const MatchKnobs& K, bool h7,
                                  MatchClock& clk, int phase) {
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, W = T >> 5;
  const int bins = 1 << (first ? bits0 : 8), row = bins + 1;
  const u32 mask = (u32)(1 << bits0) - 1u;
  for (int i = tid; i < row * W; i += T) counts[i] = 0;
  __syncthreads();
  const int seg = (((n2 + W - 1) / W) + 31) & ~31;
  const int lo = warp * seg;
  const int hi = min(lo + seg, n2);
  u32* mine = counts + warp * row;
  for (int i = lo + lane; i < hi; i += 32) {
    const u32 dg = first ? entry_key(w, i, K, h7) & mask : (u32)high[i];
    atomicAdd(&mine[dg], 1u);
  }
  __syncthreads();
  clk.mark(phase);
  // digit-major, warp-minor exclusive offsets: bins / 32 entries a thread
  const int per = bins >> 5;
  u32 sum = 0;
  for (int j = 0; j < per; ++j) {
    const int k = tid * per + j;
    sum += counts[(k % W) * row + k / W];
  }
  u32 at = block_exclusive_sum(sum, tmp);
  for (int j = 0; j < per; ++j) {
    const int k = tid * per + j;
    u32& c = counts[(k % W) * row + k / W];
    const u32 v = c;
    c = at;
    at += v;
  }
  __syncthreads();
  clk.mark(phase + 1);
  for (int g = lo; g < hi; g += 32) {  // warp-uniform
    const int i = g + lane;
    const bool valid = i < hi;
    u32 key = 0, dg = (u32)bins;  // a digit no valid id has
    if (valid) {
      if (first) {
        key = entry_key(w, i, K, h7);
        dg = key & mask;
      } else {
        dg = high[i];
      }
    }
    u32 peers;
    if (first && ballots) {
      // ids in position order: their digits nearly all differ, which is
      // when __match_any_sync costs most; a ballot a digit bit costs the
      // same whatever the digits (bit bits0 marks a lane past the run).
      // Measured faster in blocks of 1024 threads (one an SM), slower
      // where 4 blocks share an SM's issue slots.
      peers = MATCH_FULL;
      for (int bit = 0; bit <= bits0; ++bit) {
        const u32 set = __ballot_sync(MATCH_FULL, (dg >> bit) & 1u);
        peers &= (dg >> bit) & 1u ? set : ~set;
      }
    } else {
      peers = __match_any_sync(MATCH_FULL, dg);
    }
    u32 base = 0;
    if (valid) {
      base = mine[dg];
      const u32 r = base + __popc(peers & ((1u << lane) - 1u));
      if (first) {
        dst[r] = (u16)i;
        high[r] = (u8)(key >> bits0);
      } else {
        dst[r] = src[i];
      }
    }
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) mine[dg] = base + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  clk.mark(phase + 2);
}

// The ids 0..n2-1 sorted by hash key, stably, in two passes (bits0 bits,
// then 8); returns the buffer that holds them (a).
__device__ u16* sort_ids_ranked(const u32* w, u16* a, u16* b, u8* high,
                                u32* counts, u32* tmp, int n2, int bits0,
                                bool ballots, const MatchKnobs& K, bool h7,
                                MatchClock& clk) {
  const int k = h7 ? 3 : 0;
  radix_pass_ranked(w, nullptr, b, high, counts, tmp, n2, bits0, true,
                    ballots, K, h7, clk, MATCH_PH_SORT + 3 * k);
  radix_pass_ranked(w, b, a, high, counts, tmp, n2, bits0, false, ballots, K,
                    h7, clk, MATCH_PH_SORT + 3 * (k + 1));
  return a;
}

// Exclusive suffix minimum of one value a thread over the block: the
// minimum over the threads after this one, `none` for the last (tmp: 32
// words).
__device__ u32 block_suffix_min_excl(u32 v, u32 none, u32* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  u32 x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const u32 y = __shfl_down_sync(MATCH_FULL, x, off);
    if (lane + off < 32) x = min(x, y);
  }
  if (lane == 0) tmp[warp] = x;
  u32 next = __shfl_down_sync(MATCH_FULL, x, 1);
  __syncthreads();
  u32 after = none;
  for (int u = warp + 1; u < nwarps; ++u) after = min(after, tmp[u]);
  __syncthreads();
  return lane == 31 ? after : min(next, after);
}

// Built twice: blocks of 1024 threads (N > 4096: one block an SM, shared
// memory allowing), and blocks of up to 512 built to fit 4 blocks an SM.
template <int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
match_kernel(const u8* __restrict__ data, const i32* __restrict__ n_valid,
             i32* __restrict__ mlen, i32* __restrict__ mdist, int n,
             MatchKnobs K, int bits0) {
  extern __shared__ __align__(16) unsigned char smem[];
  MatchClock clk(1);
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, W = T >> 5;
  const int nw = match_words(n);
  u32* w = (u32*)smem;
  u16* a = (u16*)(w + nw);
  u16* b = a + match_buf(n);
  u8* high = (u8*)(b + match_buf(n));
  u32* counts = (u32*)(high + match_high_bytes(n));
  u32* tmp = counts + ((1 << bits0) + 1) * W;

  const i64 lane_id = blockIdx.x;
  const int rbytes = n + MATCH_TAIL;
  const u8* src = data + lane_id * rbytes;
  const i64 row = lane_id * n;
  const i32 nv = n_valid[lane_id];
  // words straight from device memory where the row is 4-byte aligned,
  // the loads of a thread's words all in flight; bytes elsewhere
  const int full = (reinterpret_cast<uintptr_t>(src) & 3) ? 0 : rbytes / 4;
#pragma unroll 8
  for (int i = tid; i < full; i += T)
    w[i] = reinterpret_cast<const u32*>(src)[i];
  for (int i = full + tid; i < nw; i += T) {
    u32 v = 0;
    for (int k = 0; k < 4; ++k) {
      const int q = 4 * i + k;
      if (q < rbytes) v |= (u32)src[q] << (8 * k);
    }
    w[i] = v;
  }
  __syncthreads();
  clk.mark(MATCH_PH_LOAD);

  // 1-2: the hash passes
  const int n2 = n / K.st;
  constexpr bool ballots = MAXT > 512;
  u16* len = sort_ids_ranked(w, a, b, high, counts, tmp, n2, bits0, ballots,
                             K, false, clk);
  u16* dist = len == a ? b : a;
  neighbours(w, len, dist, n, n2, K, false, K.depth, high);
  clk.mark(MATCH_PH_NEIGHBOURS);
  if (K.hash2) {
    for (int p = tid; p < n; p += T) mdist[row + p] = dist[p];
    __syncthreads();
    clk.mark(MATCH_PH_MERGE);
    len = sort_ids_ranked(w, a, b, high, counts, tmp, n2, bits0, ballots, K,
                          true, clk);
    dist = len == a ? b : a;
    neighbours(w, len, dist, n, n2, K, true, 2);
    clk.mark(MATCH_PH_NEIGHBOURS);
    for (int p = tid; p < n; p += T) {
      i32 sd = mdist[row + p];
      i32 sl = len_at(w, p, sd);
      const i32 d7 = dist[p];
      match_take(sl, sd, len_at(w, p, d7), d7);
      dist[p] = (u16)sd;
      if (p % K.st == 0) high[p / K.st] = (u8)sl;
    }
    __syncthreads();
    clk.mark(MATCH_PH_MERGE);
  }

  // 3: lengths and byte runs.  stops[v]: the ballot of window v's
  // terminators; fpos[v]: the first terminator at or after window v, a
  // block-wide suffix minimum over the windows, a thread a run of `per`
  const int nwin = (n + 31) >> 5;
  u32* fpos = counts;
  u32* stops = counts + nwin;
  for (int v = warp; v < nwin; v += W) {
    const u32 m = __ballot_sync(MATCH_FULL, run_stops(w, v * 32 + lane, n));
    if (lane == 0) {
      stops[v] = m;
      fpos[v] = m ? (u32)(v * 32 + __ffs(m) - 1) : (u32)n;
    }
  }
  __syncthreads();
  const int per = (nwin + T - 1) / T;
  u32 mine = (u32)n;
  for (int v = tid * per; v < nwin && v < (tid + 1) * per; ++v)
    mine = min(mine, fpos[v]);
  mine = block_suffix_min_excl(mine, (u32)n, tmp);
  for (int v = min(nwin, (tid + 1) * per) - 1; v >= tid * per; --v) {
    mine = min(mine, fpos[v]);
    fpos[v] = mine;
  }
  __syncthreads();
  for (int v = warp; v < nwin; v += W) {
    const i32 q = v * 32 + lane;
    const u32 m = stops[v] >> lane;
    const i32 stop = m ? q + __ffs(m) - 1
                       : (v + 1 < nwin ? (i32)fpos[v + 1] : n);
    if (q < n) {
      i32 d = dist[q];
      i32 l = q % K.st ? 0 : high[q / K.st];  // len_at(w, q, d)
      match_run(stop - q, l, d);
      len[q] = (u16)l;
      dist[q] = (u16)d;
    }
  }
  __syncthreads();
  clk.mark(MATCH_PH_RUNS);

  // 4: extension rounds in tiles of T * EXT_ITEMS positions from the
  // front, EXT_ITEMS a thread: a position reads its neighbour only when its
  // length is the stride, every read of a tile before its writes
  // positions a thread holds in an extension tile and their grown
  // lengths (0: unchanged): 8 in blocks of 1024 threads, 4 in the blocks
  // built for 4 an SM
  constexpr int EXT_ITEMS = MAXT > 512 ? 8 : 4;
  const i32 lim = match_ext_limit(n);
  for (i32 s = MATCH_CAP_BYTES; s < lim; s *= 2) {
    for (int t0 = 0; t0 < n; t0 += T * EXT_ITEMS) {
      u32 grown[EXT_ITEMS];
#pragma unroll
      for (int it = 0; it < EXT_ITEMS; ++it) {
        const i32 p = t0 + it * T + tid;
        grown[it] = 0;
        if (p < n && len[p] == s) {
          const bool in = p + s < n;
          const i32 g = match_extend(s, s, dist[p], in ? len[p + s] : 0,
                                     in ? dist[p + s] : 0);
          if (g != s) grown[it] = (u32)g;
        }
      }
      __syncthreads();
#pragma unroll
      for (int it = 0; it < EXT_ITEMS; ++it)
        if (grown[it]) len[t0 + it * T + tid] = (u16)grown[it];
    }
    __syncthreads();
  }
  clk.mark(MATCH_PH_EXTEND);

  // 5: clamp and store
  for (int p = tid; p < n; p += T) {
    i32 l = len[p], d = dist[p];
    match_final(p, nv, l, d);
    mlen[row + p] = l;
    mdist[row + p] = d;
  }
  __syncthreads();
  clk.mark(MATCH_PH_STORE);
}

}  // namespace brotli_torch

using namespace brotli_torch;

// Launch the first form (the first design, kept to be timed against) on
// `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for knobs the kernel does not take.  data is
// (n_lanes, n + 12) bytes, n_valid (n_lanes,) int32, mlen and mdist
// (n_lanes, n) int32; max_dist < 0 means no cap.  One block per lane.
extern "C" int brotli_torch_matches_direct(const void* data,
                                           const void* n_valid, void* mlen,
                                           void* mdist, int n_lanes, int n,
                                           int st, int max_dist, int depth,
                                           int hash2, void* stream) {
  if (!match_args_ok(n_lanes, n, st, max_dist, depth))
    return (int)cudaErrorInvalidValue;
  const int threads = match_threads(n);
  const size_t smem = match_smem_bytes(n, threads);
  const cudaError_t e = cudaFuncSetAttribute(
      match_direct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const MatchKnobs K{st, match_pbits(n / st), max_dist, depth, hash2 != 0};
  match_direct_kernel<<<n_lanes, threads, smem, (cudaStream_t)stream>>>(
      (const u8*)data, (const i32*)n_valid, (i32*)mlen, (i32*)mdist, n, K);
  return (int)cudaGetLastError();
}

// The block shape a launch of the direct kernel at n takes: threads,
// dynamic shared bytes.
extern "C" int brotli_torch_matches_direct_config(int n, void* out) {
  if (n <= 0 || n > MATCH_MAX_N) return 1;
  const int threads = match_threads(n);
  ((int*)out)[0] = threads;
  ((int*)out)[1] = (int)match_smem_bytes(n, threads);
  return 0;
}

// Launch match_kernel on `stream`: arguments and return as
// brotli_torch_matches_direct.  One block per lane.
extern "C" int brotli_torch_matches(const void* data, const void* n_valid,
                                    void* mlen, void* mdist, int n_lanes,
                                    int n, int st, int max_dist, int depth,
                                    int hash2, void* stream) {
  if (!match_args_ok(n_lanes, n, st, max_dist, depth))
    return (int)cudaErrorInvalidValue;
  const int bits0 = match_digit0(n, st);
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  const int threads = match_threads_fit(n, bits0, (size_t)limit);
  const size_t smem = match_smem_bytes_ranked(n, threads, bits0);
  const auto kernel =
      threads > 512 ? match_kernel<1024, 1> : match_kernel<512, 4>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const MatchKnobs K{st, match_pbits(n / st), max_dist, depth, hash2 != 0};
  kernel<<<n_lanes, threads, smem, (cudaStream_t)stream>>>(
      (const u8*)data, (const i32*)n_valid, (i32*)mlen, (i32*)mdist, n, K,
      bits0);
  return (int)cudaGetLastError();
}

// The block shape a launch of match_kernel at n takes with the 4-byte hash
// on every position: threads, dynamic shared bytes.
extern "C" int brotli_torch_matches_config(int n, void* out) {
  if (n <= 0 || n > MATCH_MAX_N) return 1;
  const int threads = match_threads(n);
  ((int*)out)[0] = threads;
  ((int*)out)[1] =
      (int)match_smem_bytes_ranked(n, threads, match_digit0(n, 1));
  return 0;
}

#if defined(ENC_PHASE_CLOCKS)
// The phase clocks since the last call, [kernel][phase] as 2 x
// MATCH_PHASES uint64 (kernel 0 the direct one, 1 match_kernel), then zeroed.
extern "C" int brotli_torch_matches_clocks(void* out) {
  cudaError_t rc = cudaMemcpyFromSymbol(out, match_clocks, sizeof(match_clocks));
  if (rc != cudaSuccess) return (int)rc;
  static const unsigned long long zero[2][MATCH_PHASES] = {};
  return (int)cudaMemcpyToSymbol(match_clocks, zero, sizeof(zero));
}
#endif
