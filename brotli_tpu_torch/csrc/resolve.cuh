// Per-lane LZ resolve: one lane's v2 tokens -> exactly mlen bytes, in two
// forms.  Both replace the Pallas kernel brotli_tpu/ops/pallas_resolve.py
// (_build and its `kernel`).
//
// On the TPU every lane shared a VMEM history ring (H bytes), a recent-emit
// mini-ring and a lockstep token cursor, so copies further back than H-16
// had to be flagged ERR_FAR_DIST.  Here each lane owns its output slot in
// device memory and copies within it, so there is no distance cap and no
// far flag: a lane the reference flags far decodes here, and its bytes
// equal the host decoder's.  Oracles: native/lz_resolve.cpp
// (resolve_lane_v2) and pallas_decode2.resolve_tokens_py.
//
// * resolve_lane: one thread walks the lane token by token (the direct
//   kernel's code, and the contract);
// * resolve_lane_warp: one warp takes the lane 32 tokens a step (the main
//   path's kernel); on the host, the 32 threads of a step run as a loop.
#pragma once

#include "common.cuh"

#if defined(__CUDA_ARCH__)
#include <cuda_pipeline.h>
#else
#include <cstring>
#endif

namespace brotli_torch {

// lane flags, same values as pallas_resolve.py
constexpr i32 ERR_FAR_DIST = 1;   // never set here (no ring)
constexpr i32 ERR_STARVED = 2;    // tokens ended before mlen bytes
constexpr i32 ERR_MALFORMED = 4;  // tag-2 without a pending tag-1, a
                                  // distance outside [1, pos], or a size
                                  // larger than the lane's output slot

// Resolve tokens tok[i * tstride], i < min(count, cap), into out[0, mlen)
// of a slot of out_cap bytes.  Bytes a token would put past mlen are
// dropped, as the reference kernel emits exactly mlen bytes.  The bounds
// come from the buffers, so inconsistent counts or sizes from a caller can
// never read or write outside them.  Returns the lane's flags.
BROTLI_HD i32 resolve_lane(const u32* tok, i64 tstride, i32 count, i32 cap,
                           i32 mlen, u8* out, i64 out_cap) {
  if (mlen > out_cap) return ERR_MALFORMED;
  if (count > cap) count = cap;
  i32 pos = 0;
  i32 pend = -1;  // copy length of a tag-1 token awaiting its tag-2
  for (i32 i = 0; pos < mlen; ++i) {
    if (i >= count) return ERR_STARVED;
    const u32 t = tok[(i64)i * tstride];
    if (t == 0) continue;  // PAD
    const u32 tag = t >> 30;
    if (tag == 0) {
      const i32 cnt = (i32)((t >> 24) & 3u);
      for (i32 k = 0; k < cnt && pos < mlen; ++k) {
        out[pos++] = (u8)((t >> (8 * k)) & 0xFFu);
      }
    } else if (tag == 1) {
      pend = (i32)(t & 0xFFFFFFu);
    } else {
      i32 len, dist;
      if (tag == 3) {
        len = (i32)((t >> 22) & 0xFFu);
        dist = (i32)(t & 0x3FFFFFu);
      } else {
        if (pend < 0) return ERR_MALFORMED;
        len = pend;
        dist = (i32)(t & 0x3FFFFFFFu);
        pend = -1;
      }
      if (dist < 1 || dist > pos) return ERR_MALFORMED;
      const i32 end = len < mlen - pos ? pos + len : mlen;
      // forward byte copy: correct for dist < len, where the source
      // overlaps the bytes being written
      for (; pos < end; ++pos) out[pos] = out[pos - dist];
    }
  }
  return 0;
}

// ---- the warp form ----------------------------------------------------
//
// A step takes the tokens i0 .. i0+31, thread t token i0+t:
// * each thread works out its token's length: the literal count; 0 for a
//   PAD or a tag-1; the pending length for a tag-2; (tok >> 22) & 0xFF for
//   a tag-3.  A tag-2's pending length is that of the nearest earlier tag-1
//   or tag-2 of the step (a tag-2 there means none is pending), found with
//   two ballots, or the pending length carried in from the last step;
// * a saturating inclusive scan of the lengths gives each token's start;
//   a token whose start is at or past mlen is not looked at;
// * the first fault is the lowest token that is a tag-2 with nothing
//   pending, or a copy with dist < 1 or dist > start.  The step ends
//   before it, or before the first token that does not fit the window;
// * the step's literal bytes, and the bytes of its copies whose sources
//   all precede the step, are stored in parallel; then its other copies
//   in token order, each spread over the 32 threads as
//   out[p] = out[s - d + (p - s) mod d], exact for an overlapping copy
//   (d < len) because every source lies before s, which is final.
//
// Bytes: the lane's window of W bytes (a power of two) in shared memory
// holds positions [flushed, flushed + W), byte p at (p + phase) & (W - 1)
// where phase is the slot's address mod 16, so the window flushes to the
// slot in aligned 16-byte stores.  A step may write only below
// flushed + W; the window flushes when half full.  A source at or past
// step_end - W is still in the window (nothing written since overwrote
// it); an older one is below `flushed`, so the warp reads the slot.
// A copy longer than the window is taken alone, in pieces.
//
// Tokens: a ring of TOKQ_CHUNKS chunks of 32 tokens in shared memory,
// loaded by cp.async, thread t loading token 32c + t of chunk c: a step
// reads chunks c and c + 1 (c = i0 / 32) while c + 2 and c + 3 are in
// flight.  Tokens at or past `count` are never read.

constexpr int WARP = 32;
constexpr i32 TOKQ_CHUNKS = 4;
constexpr i32 TOKQ = TOKQ_CHUNKS * WARP;  // tokens a lane's ring holds
constexpr i32 RESOLVE_WIN_MIN = 64;       // smallest window (power of two)

// On the card a Lanes<T> is the calling thread's value and the collectives
// are warp intrinsics; on the host it holds all 32 values, `each` runs its
// body for t = 0..31 in turn, and a collective reads the whole array.  A
// collective reads only values an earlier `each` finished, and is called
// by the whole warp.
#if defined(__CUDA_ARCH__)
constexpr u32 WARP_FULL = 0xFFFFFFFFu;
template <class T>
struct Lanes {
  T v;
  __device__ __forceinline__ T& operator[](int) { return v; }
  __device__ __forceinline__ const T& operator[](int) const { return v; }
};
template <class F>
__device__ __forceinline__ void each(F f) { f((int)(threadIdx.x & 31)); }
__device__ __forceinline__ u32 ballot(const Lanes<bool>& x) {
  return __ballot_sync(WARP_FULL, x.v);
}
template <class T>
__device__ __forceinline__ T shfl(const Lanes<T>& x, int src) {
  return __shfl_sync(WARP_FULL, x.v, src);
}
// x[t - 1], 0 for t = 0
__device__ __forceinline__ u32 shfl_prev(const Lanes<u32>& x, int t) {
  const u32 y = __shfl_up_sync(WARP_FULL, x.v, 1);
  return t ? y : 0u;
}
// inclusive prefix sums saturating at `top` (min(a + b, top) is
// associative over [0, top]); top < 2^31, so the sum of two fits a u32
__device__ __forceinline__ void scan_sat(Lanes<u32>& x, u32 top) {
  const int t = (int)(threadIdx.x & 31);
#pragma unroll
  for (int d = 1; d < WARP; d <<= 1) {
    const u32 y = __shfl_up_sync(WARP_FULL, x.v, d);
    if (t >= d) x.v = x.v + y < top ? x.v + y : top;
  }
}
__device__ __forceinline__ void sync_warp() { __syncwarp(); }
__device__ __forceinline__ int lowest_bit(u32 m) { return __ffs((int)m) - 1; }
__device__ __forceinline__ int highest_bit(u32 m) { return 31 - __clz((int)m); }
__device__ __forceinline__ void copy16(u8* dst, const u8* src) {
  *(uint4*)dst = *(const uint4*)src;
}
#else
template <class T>
struct Lanes {
  T v[WARP];
  T& operator[](int t) { return v[t]; }
  const T& operator[](int t) const { return v[t]; }
};
template <class F>
inline void each(F f) {
  for (int t = 0; t < WARP; ++t) f(t);
}
inline u32 ballot(const Lanes<bool>& x) {
  u32 m = 0;
  for (int t = 0; t < WARP; ++t) m |= (u32)x.v[t] << t;
  return m;
}
template <class T>
inline T shfl(const Lanes<T>& x, int src) { return x.v[src]; }
inline u32 shfl_prev(const Lanes<u32>& x, int t) { return t ? x.v[t - 1] : 0u; }
inline void scan_sat(Lanes<u32>& x, u32 top) {
  for (int t = 1; t < WARP; ++t)
    x.v[t] = x.v[t - 1] + x.v[t] < top ? x.v[t - 1] + x.v[t] : top;
}
inline void sync_warp() {}
inline int lowest_bit(u32 m) { return __builtin_ctz(m); }
inline int highest_bit(u32 m) { return 31 - __builtin_clz(m); }
inline void copy16(u8* dst, const u8* src) { std::memcpy(dst, src, 16); }
#endif

// One lane for resolve_lane_warp: its tokens and slot in device memory,
// its window and token ring in shared memory.
struct ResolveWarpLane {
  const u32* tok;  // token i at tok[i * tstride]
  i64 tstride;
  i32 count;       // tokens, cut to the token slots
  i32 mlen;
  u8* slot;        // out_cap bytes in device memory
  i64 out_cap;
  u8* win;         // the window, 16-byte aligned
  i32 wmask;       // window bytes - 1
  u32* tq;         // the token ring, TOKQ words
};

// The lane's window and flush state, all warp-uniform.
struct ResolveWindow {
  const ResolveWarpLane& L;
  i32 phase;    // the slot's address mod 16
  i32 flushed;  // bytes [0, flushed) are in the slot

  BROTLI_HD u8& at(i32 p) const { return L.win[(p + phase) & L.wmask]; }

  // byte q of the lane, q below every position the warp writes now; `lo`
  // is (the highest position written since the window last moved) + 1 - W
  BROTLI_HD u8 src(i32 q, i32 lo) const { return q >= lo ? at(q) : L.slot[q]; }

  // store bytes [flushed, lim) to the slot: the head up to a 16-byte
  // boundary of the slot and the tail byte by byte, the rest 16 bytes a
  // thread
  BROTLI_HD void flush(i32 lim) {
    const i32 a = flushed;
    const i32 to16 = (16 - ((a + phase) & 15)) & 15;
    const i32 head = lim < a + to16 ? lim : a + to16;
    const i32 down = lim - ((lim + phase) & 15);
    const i32 body = down > head ? down : head;
    each([&](int t) {
      for (i32 p = a + t; p < head; p += WARP) L.slot[p] = at(p);
      for (i32 p = head + 16 * t; p < body; p += 16 * WARP)
        copy16(L.slot + p, &at(p));
      for (i32 p = body + t; p < lim; p += WARP) L.slot[p] = at(p);
    });
    flushed = lim;
    sync_warp();
  }

  // flush every whole 16-byte chunk of the slot below `pos`
  BROTLI_HD void flush_down(i32 pos) {
    const i32 lim = pos - ((pos + phase) & 15);
    if (lim > flushed) flush(lim);
  }

  // bytes [s + from, s + from + n) of a copy that starts at s, d back,
  // spread over the warp; `lo` as for src
  BROTLI_HD void copy(i32 s, i32 from, i32 n, i32 d, i32 lo) {
    each([&](int t) {
      if (d >= from + n) {
        for (i32 k = t; k < n; k += WARP)
          at(s + from + k) = src(s - d + from + k, lo);
      } else {
        i32 r = (from + t) % d;  // (from + k) mod d, k = t, t + 32, ...
        const i32 step = WARP % d;
        for (i32 k = t; k < n; k += WARP) {
          at(s + from + k) = src(s - d + r, lo);
          r += step;
          if (r >= d) r -= d;
        }
      }
    });
    sync_warp();
  }
};

// chunk c of the lane's tokens into the ring, thread t row 32c + t
BROTLI_HD void tq_issue(const ResolveWarpLane& L, i32 c) {
  each([&](int t) {
    const i32 i = c * WARP + t;
    if (i < L.count) {
      u32* dst = L.tq + (i & (TOKQ - 1));
      const u32* src = L.tok + (i64)i * L.tstride;
#if defined(__CUDA_ARCH__)
      __pipeline_memcpy_async(dst, src, sizeof(u32));
#else
      *dst = *src;
#endif
    }
#if defined(__CUDA_ARCH__)
    __pipeline_commit();
#endif
  });
}

// every chunk but the two newest issued has landed, for the whole warp
BROTLI_HD void tq_wait() {
#if defined(__CUDA_ARCH__)
  __pipeline_wait_prior(TOKQ_CHUNKS - 2);
#endif
  sync_warp();
}

// resolve_lane's result for the lane, by the whole warp; the flags.
// L.count must already be cut to the token slots, and L.wmask + 1 be a
// power of two >= RESOLVE_WIN_MIN.
BROTLI_HD i32 resolve_lane_warp(const ResolveWarpLane& L) {
  if (L.mlen > L.out_cap) return ERR_MALFORMED;
  const i32 W = L.wmask + 1;
  ResolveWindow B{L, (i32)((uintptr_t)L.slot & 15), 0};
  i32 pos = 0, i0 = 0, pend = -1, flag = 0;
  for (i32 c = 0; c < TOKQ_CHUNKS; ++c) tq_issue(L, c);
  i32 chunk = 0;
  tq_wait();
  while (pos < L.mlen) {
    if (i0 >= L.count) {
      flag = ERR_STARVED;
      break;
    }
    if ((i0 >> 5) != chunk) {  // a step moves at most one chunk on
      ++chunk;
      tq_issue(L, chunk + TOKQ_CHUNKS - 1);  // the slot of chunk - 1
      tq_wait();
    }
    if (pos - B.flushed >= W / 2) B.flush_down(pos);
    const u32 left = (u32)(L.mlen - pos);
    const i32 room = B.flushed + W - pos;
    Lanes<u32> tk, len, end, l1;
    Lanes<bool> is1, is2;
    each([&](int t) {
      const bool valid = i0 + t < L.count;
      tk[t] = valid ? L.tq[(i0 + t) & (TOKQ - 1)] : 0u;
      is1[t] = valid && (tk[t] >> 30) == 1u;
      is2[t] = valid && (tk[t] >> 30) == 2u;
      l1[t] = tk[t] & 0xFFFFFFu;
    });
    const u32 m1 = ballot(is1), m2 = ballot(is2);
    Lanes<i32> dist;
    Lanes<bool> is_cp, bad;
    each([&](int t) {
      const u32 prev = (m1 | m2) & ((1u << t) - 1u);
      const int h = prev ? highest_bit(prev) : t;
      const u32 pl = shfl(l1, h);
      const i32 p = prev == 0 ? pend : ((m1 >> h) & 1u) ? (i32)pl : -1;
      const u32 x = tk[t], tag = x >> 30;
      u32 n = 0;
      is_cp[t] = i0 + t < L.count && tag >= 2u;
      bad[t] = false;
      dist[t] = 0;
      if (tag == 0u) {
        n = (x >> 24) & 3u;
      } else if (tag == 2u) {
        bad[t] = p < 0;
        n = p < 0 ? 0u : (u32)p;
        dist[t] = (i32)(x & 0x3FFFFFFFu);
      } else if (tag == 3u) {
        n = (x >> 22) & 0xFFu;
        dist[t] = (i32)(x & 0x3FFFFFu);
      }
      len[t] = n < left ? n : left;
      end[t] = len[t];
    });
    scan_sat(end, left);
    Lanes<u32> ex;
    Lanes<bool> fault, nofit;
    each([&](int t) {
      ex[t] = shfl_prev(end, t);
      len[t] = end[t] - ex[t];  // cut at mlen; 0 for a token not looked at
      const bool live = i0 + t < L.count && ex[t] < left;
      const i32 start = pos + (i32)ex[t];
      fault[t] = live && is_cp[t] &&
                 (bad[t] || dist[t] < 1 || dist[t] > start);
      nofit[t] = live && (i64)ex[t] + len[t] > (i64)room;
    });
    const u32 fm = ballot(fault), nf = ballot(nofit);
    const int f = fm ? lowest_bit(fm) : WARP;
    const int cut = nf ? lowest_bit(nf) : WARP;
    const int take = f < cut ? f : cut;
    const i32 step_end = pos + (i32)(take ? shfl(end, take - 1) : 0u);
    const i32 lo = step_end - W;
    // the bytes of the step that read nothing the step writes, in
    // parallel: the literals, a thread a token, then the copies whose
    // sources all precede the step (ex + len <= dist), byte by byte over
    // the warp; byte b of those copies' bytes is in copy j, the first with
    // ee[j] > b (ee: their inclusive length scan)
    Lanes<bool> cp;
    each([&](int t) {
      cp[t] = t < take && is_cp[t] && len[t] > 0u;
      if (t < take && (tk[t] >> 30) == 0u) {
        const i32 s = pos + (i32)ex[t];
        for (u32 k = 0; k < len[t]; ++k) B.at(s + (i32)k) = (u8)(tk[t] >> (8 * k));
      }
    });
    u32 copies = ballot(cp);
    if (copies) {
      Lanes<bool> early;
      Lanes<u32> el, ee;
      each([&](int t) {
        early[t] = cp[t] && (i64)ex[t] + len[t] <= (i64)dist[t];
        el[t] = early[t] ? len[t] : 0u;
        ee[t] = el[t];
      });
      const u32 em = ballot(early);
      if (em) {
        copies &= ~em;
        scan_sat(ee, left);  // at most the step's bytes: never above `left`
        const u32 n_early = shfl(ee, WARP - 1);
        Lanes<i32> eoff;  // copy j's byte b lands at pos + eoff[j] + b
        each([&](int t) { eoff[t] = (i32)ex[t] - (i32)(ee[t] - el[t]); });
        for (u32 b0 = 0; b0 < n_early; b0 += WARP) {
          each([&](int t) {
            const u32 b = b0 + (u32)t;
            int j = 0;
            for (int k = WARP / 2; k > 0; k >>= 1)
              if (shfl(ee, j + k - 1) <= b) j += k;
            const i32 p = pos + shfl(eoff, j) + (i32)b;
            const i32 d = shfl(dist, j);
            if (b < n_early) B.at(p) = B.src(p - d, lo);
          });
        }
      }
    }
    sync_warp();
    // the other copies, in token order
    for (u32 m = copies; m; m &= m - 1) {
      const int j = lowest_bit(m);
      B.copy(pos + (i32)shfl(ex, j), 0, (i32)shfl(len, j), shfl(dist, j), lo);
    }
    const u32 seen = (m1 | m2) & (take < WARP ? (1u << take) - 1u : ~0u);
    if (seen) {
      const int h = highest_bit(seen);
      const u32 pl = shfl(l1, h);
      pend = ((m1 >> h) & 1u) ? (i32)pl : -1;
    }
    pos = step_end;
    i0 += take;
    if (f <= cut && f < WARP) {
      flag = ERR_MALFORMED;
      break;
    }
    if (take > 0) continue;
    // the first token does not fit: make room, or take a long copy alone
    const i32 before = B.flushed;
    B.flush_down(pos);
    if (B.flushed > before) continue;
    const i32 n = (i32)shfl(len, 0), d = shfl(dist, 0);
    for (i32 done = 0; done < n;) {
      B.flush_down(pos);
      const i32 room1 = B.flushed + W - pos;
      const i32 piece = n - done < room1 ? n - done : room1;
      B.copy(pos - done, done, piece, d, pos + piece - W);
      done += piece;
      pos += piece;
    }
    if (m2 & 1u) pend = -1;
    i0 += 1;
  }
  B.flush(pos);
#if defined(__CUDA_ARCH__)
  __pipeline_wait_prior(0);  // no copy left in flight when the lane ends
#endif
  return flag;
}

}  // namespace brotli_torch
