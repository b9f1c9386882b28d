// Per-lane greedy parse of the device encoder: match lengths and distances
// -> copy starts, literals and short distance codes.  Replaces the XLA
// `lax.scan` of brotli_tpu/ops/device_encode.py (greedy_parse).
//
// Two forms, each the per-lane code of one kernel of csrc/parse.cu, both
// built by nvcc and by the g++ host shim (csrc/host_shim.cpp):
//
// * the window walk (parse_window; parse_direct_kernel, the first design):
//   a lane in windows of PARSE_W positions, the gate of a window as bit
//   masks, then the frontier and the distance ring stepped copy by copy;
// * the tile form (ParseTile and the parse_tile_* phases below;
//   parse_kernel): a lane in tiles of up to PARSE_TILE positions, where
//   only the frontier stays serial.
//
// The window walk.  For each window the caller computes `take` (the score
// gate and the lazy look-ahead, below)
// and `in_chunk` for every position and hands them over as bit masks; the
// walk then visits only the copy starts: the next set take bit at or after
// the free frontier starts a copy, the frontier jumps past it, and every
// free position that is not a copy start is a literal when it lies inside
// the chunk.  So a window costs one step per copy, not one per position.
// The caller supplies the match at a copy start and receives its short
// distance code: on the card a warp shuffle and the thread of that
// position (csrc/parse.cu), on the host array reads (csrc/host_shim.cpp).
//
// The distance ring is the decoder's (RFC 7932 section 4): the short code
// of a copy is the first k in 3..0 -- the last hit wins -- with
// d == ring[k] (codes 0-3 repeat an earlier distance exactly; the delta
// codes 4-15 are not probed, as in JAX), -1 where none hits, and every
// copy whose code is not 0 pushes its distance.
//
// The tile form rests on three facts of that recurrence:
//
// 1. the gate is pointwise: `take` at p reads the matches at p, p + 1 and
//    p + 2 and n_valid only, so a tile's take words come from all its
//    positions at once;
// 2. the ring never feeds the frontier, which is the one serial chain:
//    s' = the first take position at or after the end of the copy at s.
//    That successor is itself pointwise given the take words (succ, phase
//    2), so the walk is one shared-memory load a copy (phase 3);
// 3. the ring's front is always the previous copy's distance (a copy
//    pushes its distance, or has code 0, which means d == ring[0] > 0).
//    So copy j pushes unless d_j == d_{j-1} > 0 (d_{-1} the ring's front),
//    its ring is the last four distances pushed before it, and its code
//    the least k with ring[k] == d_j > 0: a prefix count of pushes over
//    the lane's ordered copies and a look-back of four (phase 4), checked
//    against parse_copy by parse_ring_collapsed's tests.
#pragma once

#include <cstring>

#include "common.cuh"

#if defined(__CUDA_ARCH__)
#include <cuda_pipeline.h>
#endif

namespace brotli_torch {

constexpr int PARSE_W = 32;  // positions per window: one warp's width

struct ParseKnobs {
  i32 lazy0, lazy1;  // defer a copy when the score 1 / 2 ahead beats it by this
  i32 min_gate;      // a 4-byte copy is weak at distance >= 2^min_gate
};

// floor(log2(x)) from the float32 exponent, as the port and JAX compute it
// (exact for 1 <= x < 2^24; above that the float rounding is part of the
// function).
BROTLI_HD i32 parse_ilog2(i32 x) {
  const float f = (float)x;
#if defined(__CUDA_ARCH__)
  const i32 u = __float_as_int(f);
#else
  i32 u;
  std::memcpy(&u, &f, sizeof u);
#endif
  return (u >> 23) - 127;
}

// score = 135*len - 30*ilog2(max(dist, 1)), wrapping like int32 XLA.
BROTLI_HD i32 parse_score(i32 mlen, i32 mdist) {
  const i32 lg = parse_ilog2(mdist > 1 ? mdist : 1);
  return (i32)(135u * (u32)mlen - 30u * (u32)lg);
}

// Whether position p starts a copy when it is free: a strong match that is
// not beaten by the scores s1, s2 of the next two positions (0 past the
// lane's end), inside the chunk.
BROTLI_HD bool parse_take(const ParseKnobs& K, i32 mlen, i32 score, i32 s1,
                          i32 s2, i32 p, i32 n_valid) {
  const bool strong = mlen >= 4 && score >= 135 * 4 - 30 * K.min_gate;
  return strong && !(s1 >= add_wrap(score, K.lazy0)) &&
         !(s2 >= add_wrap(score, K.lazy1)) && p < n_valid;
}

struct ParseLane {
  i32 next_free;  // first position not covered by a copy
  i32 ring[4];    // last distance first
};

BROTLI_HD ParseLane parse_lane_init() { return ParseLane{0, {4, 11, 15, 16}}; }

// The copy of length len at distance d that starts at p: its short code,
// and the lane's frontier and ring after it.
BROTLI_HD i32 parse_copy(ParseLane& s, i32 p, i32 len, i32 d) {
  i32 dc = -1;
  for (int k = 3; k >= 0; --k)
    if (d == s.ring[k] && s.ring[k] > 0) dc = k;
  s.next_free = add_wrap(p, len);
  if (dc != 0) {
    s.ring[3] = s.ring[2];
    s.ring[2] = s.ring[1];
    s.ring[1] = s.ring[0];
    s.ring[0] = d;
  }
  return dc;
}

BROTLI_HD int parse_ctz(u32 m) {
#if defined(__CUDA_ARCH__)
  return __ffs((int)m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

struct ParseWindow {
  u32 cs;   // bit i: a copy starts at base + i
  u32 lit;  // bit i: base + i is a literal
};

// The walk over one window at `base`.  take / in_chunk hold bit i for
// position base + i (0 past the lane's end).  fetch(i, len, d) gives the
// match at base + i; emit(i, dc) takes the short code of the copy there.
// The frontier is compared in 64 bits, so a copy end that wrapped past
// int32 (as the int32 reference wraps it) frees every later position, and
// each step moves at least one bit on.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class Fetch, class Emit>
BROTLI_HD ParseWindow parse_window(ParseLane& s, i32 base, u32 take,
                                   u32 in_chunk, Fetch fetch, Emit emit) {
  u32 cs = 0, freem = 0;
  i64 cur = (i64)s.next_free - base;
  if (cur < 0) cur = 0;
  while (cur < PARSE_W) {
    const u32 from = ~0u << (u32)cur;
    const u32 m = take & from;
    if (m == 0) {
      freem |= from;
      break;
    }
    const int i = parse_ctz(m);
    freem |= from & ((2u << i) - 1u);  // bits cur..i (i == 31: all of from)
    cs |= 1u << i;
    i32 len, d;
    fetch(i, len, d);
    emit(i, parse_copy(s, base + i, len, d));
    cur = (i64)s.next_free - base;
    if (cur < i + 1) cur = i + 1;
  }
  return ParseWindow{cs, freem & ~take & in_chunk};
}


// ---------------------------------------------------------------------------
// The tile form (parse_kernel).  A block takes a lane, in tiles of `tile`
// positions (PARSE_TILE on the card; on the host any multiple of 32 up to
// it, so that copies cross many tiles in the tests).  Per tile:
//
// 0. stage: mlen and mdist of the tile and of PARSE_HALO positions past it
//    (the look-ahead reads two) into shared memory with cp.async;
// 1. gate: `take` of every position as 32-bit words, and `nz`, bit w set
//    where take word w is not 0;
// 2. succ: for every take position s, the copy start that follows a copy
//    at s: the first take position at or after its end E when E lies in
//    the tile (the tile's length where none does), else PARSE_EXIT, and
//    then the step is E itself (relative to the tile, so >= its length);
// 3. walk, in three steps:
//    a. speculation: the tile in segments of 2^seg_log positions, and
//       for each at once a walk s -> succ[s] from its first take position
//       while s lies in the segment: the path's copy starts as bits
//       (`path`), and the first step past the segment (`exit`);
//    b. resolution, one thread, from the lane's frontier: at a copy start
//       T on its segment's path, the path from T is the lane's own (the
//       same succ from there), so T is the segment's entry (`mark`) and
//       the walk jumps to the segment's exit; off the path it steps one
//       copy (`slow`).  The frontier leaves as the tile's base + T;
//    c. the copy starts of each word (the path from the mark, and the slow
//       steps), their order (a prefix count over the words) and each
//       word's entry frontier (the end of the last copy that starts before
//       it);
// 4. words: each word's copy starts and literals from its entry frontier,
//    its take word and the ends of the copies that start in it;
// 5. codes: each copy's push flag, a block-wide prefix count of the
//    pushes, the pushed distances stored in order after the four carried
//    in (over the tile's staged mlen, which nothing reads any more), and
//    each copy's short code from the four pushed before it;
// 6. store: is_cs, is_lit and dcode_short, four positions a thread, as a
//    word, a word and a 16-byte vector where the rows allow.
//
// On the card warp 0 takes tile k through phases 3-4 while warps 1-3 (the
// gate warps) take tile k + 1 through phases 0-2; then the block takes
// tile k through phases 5-6.  A tile's staging, take words, nz and succ
// are double buffered (index t % 2).  Phases 1, 2, 3a, 3c and 4-6 spread
// positions, segments, copies or words over threads and read only what
// earlier phases wrote, so the host shim runs them as loops over the
// threads in the same order.

constexpr int PARSE_TILE = 1024;  // positions a tile: 32 take words, one nz
constexpr int PARSE_WORDS = PARSE_TILE / 32;
constexpr int PARSE_SEG_LOG = 7;  // a speculation segment: 128 positions
constexpr int PARSE_SEG = 1 << PARSE_SEG_LOG;
constexpr int PARSE_HALO = 4;     // staged past the tile, a 16-byte copy
constexpr int PARSE_STAGE = PARSE_TILE + PARSE_HALO;
constexpr int PARSE_THREADS = 128;  // a block: 4 warps
constexpr int PARSE_GATE_THREADS = PARSE_THREADS - 32;  // warps 1-3
constexpr u16 PARSE_EXIT = 0xFFFF;  // succ: the copy ends past the tile

// A block's shared memory on the card; a lane's buffers on the host.
struct ParseTile {
  i32 ml[2][PARSE_STAGE];    // mlen, mdist of a tile (phase 5 stores the
  i32 md[2][PARSE_STAGE];    // pushed distances over its mlen)
  u16 succ[2][PARSE_TILE];   // succ at a tile's take positions
  u16 list[PARSE_TILE];      // the tile's copy starts, in order
  i8 code[PARSE_TILE];       // the short code at a copy start
  u32 take[2][PARSE_WORDS];
  u32 nz[2];
  u32 cs[PARSE_WORDS], lit[PARSE_WORDS];
  u32 path[PARSE_WORDS];     // 3a: the segments' speculative copy starts
  u32 slow[PARSE_WORDS];     // 3b: copy starts stepped one by one
  i32 exit[PARSE_WORDS];     // 3a: a segment's first step past it
  i32 mark[PARSE_WORDS];     // 3b: where the lane enters a segment's path
  i32 front[PARSE_WORDS];    // the frontier entering word w, relative to
                             // the tile, clipped to [0, tile + 32]
  i32 wsum[PARSE_THREADS / 32];
  i32 cnt;                   // copies in the list
  i32 entry;                 // the frontier entering the tile, clipped so
};

struct ParseTileCtx {
  ParseKnobs K;
  i32 n, nv;      // the lane's length and n_valid
  i32 tile;       // positions a tile
  i32 seg_log;    // log2 of the positions a speculation segment
  i32 base, tn;   // the tile's first position and its length (<= tile)
  i32 nw, buf;    // its words, and its buffers' index
};

// The context of tile t of a lane.
BROTLI_HD ParseTileCtx parse_tile_ctx(ParseKnobs K, i32 n, i32 nv, i32 tile,
                                      i32 seg_log, i32 t) {
  const i32 base = t * tile;
  const i32 tn = n - base < tile ? n - base : tile;
  return ParseTileCtx{K, n, nv, tile, seg_log, base, tn, (tn + 31) >> 5,
                      (i32)(t & 1)};
}

// The end of the copy of length len at base + i, relative to base: at
// least i + 1, since an end that wrapped past int32 (as the int32
// reference wraps it) frees every later position.
BROTLI_HD i32 parse_end(i32 base, i32 i, i32 len) {
  const i32 p = base + i;
  const i32 e = add_wrap(p, len);
  return e > p ? e - base : i + 1;
}

// The first take position at or after r < tn in the tile, or tn.
BROTLI_HD i32 parse_next_take(const ParseTile& m, const ParseTileCtx& c,
                              i32 r) {
  const u32* take = m.take[c.buf];
  const int w = r >> 5;
  const u32 here = take[w] & (~0u << (r & 31));
  if (here) return (w << 5) + parse_ctz(here);
  const u32 nz = m.nz[c.buf];
  const u32 later = w >= 31 ? 0u : nz & (~0u << (w + 1));
  if (!later) return c.tn;
  const int w2 = parse_ctz(later);
  return (w2 << 5) + parse_ctz(take[w2]);
}

// The step after a copy at take position s: succ, or past the tile the
// copy's end.
BROTLI_HD i32 parse_step(const ParseTile& m, const ParseTileCtx& c, i32 s) {
  const u16 a = m.succ[c.buf][s];
  return a != PARSE_EXIT ? (i32)a : parse_end(c.base, s, m.ml[c.buf][s]);
}

// Phase 1 for positions i .. i + 3 of the tile (i a multiple of 4): their
// take bits (bit k for i + k), the gate of parse_take with the scores of
// i .. i + 5 from the staged tile and its halo (0 past the lane's end).
BROTLI_HD u32 parse_tile_take4(const ParseTile& m, const ParseTileCtx& c,
                               i32 i) {
  const i32* ml = m.ml[c.buf] + i;
  const i32* md = m.md[c.buf] + i;
#if defined(__CUDA_ARCH__)
  const int4 la = *reinterpret_cast<const int4*>(ml);
  const int2 lb = *reinterpret_cast<const int2*>(ml + 4);
  const int4 da = *reinterpret_cast<const int4*>(md);
  const int2 db = *reinterpret_cast<const int2*>(md + 4);
  const i32 L[6] = {la.x, la.y, la.z, la.w, lb.x, lb.y};
  const i32 D[6] = {da.x, da.y, da.z, da.w, db.x, db.y};
#else
  i32 L[6], D[6];
  for (int k = 0; k < 6; ++k) {
    L[k] = ml[k];
    D[k] = md[k];
  }
#endif
  i32 sc[6];
#if defined(__CUDA_ARCH__)
#pragma unroll
#endif
  for (int k = 0; k < 6; ++k)
    sc[k] = c.base + i + k < c.n ? parse_score(L[k], D[k]) : 0;
  u32 nib = 0;
#if defined(__CUDA_ARCH__)
#pragma unroll
#endif
  for (int k = 0; k < 4; ++k)
    nib |= (u32)(i + k < c.tn && parse_take(c.K, L[k], sc[k], sc[k + 1],
                                             sc[k + 2], c.base + i + k, c.nv))
           << k;
  return nib;
}

// Phase 2, thread t of NT: succ of the take positions t + NT * r, all
// loads issued before any is used.
template <int NT>
BROTLI_HD void parse_tile_succ(ParseTile& m, const ParseTileCtx& c, int t) {
  constexpr int R = (PARSE_TILE + NT - 1) / NT;
  const i32* ml = m.ml[c.buf];
  const u32* take = m.take[c.buf];
  i32 e[R];
  u32 tk = 0;
#if defined(__CUDA_ARCH__)
#pragma unroll
#endif
  for (int r = 0; r < R; ++r) {
    const i32 i = t + r * NT;
    const bool in = i < c.tn;
    tk |= (u32)(in && ((take[i >> 5] >> (i & 31)) & 1u)) << r;
    e[r] = in ? parse_end(c.base, i, ml[i]) : 0;
  }
#if defined(__CUDA_ARCH__)
#pragma unroll
#endif
  for (int r = 0; r < R; ++r)
    if ((tk >> r) & 1u)
      m.succ[c.buf][t + r * NT] =
          e[r] < c.tn ? (u16)parse_next_take(m, c, e[r]) : PARSE_EXIT;
}

// Phase 3a for segment g: its speculative path and exit.  The path's bits
// gather in a register word by word (the path only moves on).
BROTLI_HD void parse_tile_spec(ParseTile& m, const ParseTileCtx& c, int g) {
  const i32 lo = g << c.seg_log;
  const i32 hi = lo + (1 << c.seg_log) < c.tn ? lo + (1 << c.seg_log) : c.tn;
  for (i32 k = lo >> 5; k < (hi + 31) >> 5; ++k) m.path[k] = m.slow[k] = 0u;
  i32 s = parse_next_take(m, c, lo), w = lo >> 5;
  u32 bits = 0;
  while (s < hi) {
    const i32 next = parse_step(m, c, s);
    if (s >> 5 != w) {
      m.path[w] = bits;
      bits = 0;
      w = s >> 5;
    }
    bits |= 1u << (s & 31);
    s = next;
  }
  m.path[w] = bits;
  m.exit[g] = s;
  m.mark[g] = c.tile;  // not entered
}

// Phase 3b, one thread: the lane's path through the tile from the frontier
// `front` (absolute); returns the frontier leaving the tile.  A step loads
// the path word, the segment's exit and succ at once, and the slow steps'
// bits gather in a register word by word.
BROTLI_HD i64 parse_tile_resolve(ParseTile& m, const ParseTileCtx& c,
                                 i64 front) {
  const i64 fr = front - c.base;
  m.entry = (i32)(fr < 0 ? 0 : (fr > c.tile + 32 ? c.tile + 32 : fr));
  if (fr >= c.tn) return front;
  i32 t = parse_next_take(m, c, m.entry), w = 0;
  u32 bits = 0;
  while (t < c.tn) {
    const u32 on = m.path[t >> 5] >> (t & 31);
    const i32 g = t >> c.seg_log;
    const i32 ex = m.exit[g], next = m.succ[c.buf][t];
    if (on & 1u) {
      m.mark[g] = t;
      t = ex;
    } else {
      if (t >> 5 != w) {
        m.slow[w] |= bits;
        bits = 0;
        w = t >> 5;
      }
      bits |= 1u << (t & 31);
      t = next != PARSE_EXIT ? next : parse_end(c.base, t, m.ml[c.buf][t]);
    }
  }
  m.slow[w] |= bits;
  return (i64)c.base + t;
}

// Phase 3c for word w: its copy starts, the path's from its segment's
// mark on, and the slow steps.
BROTLI_HD u32 parse_word_starts(const ParseTile& m, const ParseTileCtx& c,
                                int w) {
  const i32 from = m.mark[(w << 5) >> c.seg_log] - (w << 5);
  const u32 on = from <= 0 ? ~0u : (from < 32 ? ~0u << from : 0u);
  return (m.path[w] & on) | m.slow[w];
}

// Phase 3c for word w, given `before`, the copies that start before it,
// and `last`, the last of them (-1: none): its copies into the list, and
// its entry frontier.
BROTLI_HD void parse_word_list(ParseTile& m, const ParseTileCtx& c, int w,
                               u32 cs, i32 before, i32 last) {
  for (u32 b = cs; b; b &= b - 1) m.list[before++] = (u16)((w << 5) + parse_ctz(b));
  const i32 lim = c.tile + 32;
  if (last < 0) {
    m.front[w] = m.entry;
  } else {
    const i32 e = parse_end(c.base, last, m.ml[c.buf][last]);
    m.front[w] = e < lim ? e : lim;
  }
}

// The highest set bit of m (not 0).
BROTLI_HD int parse_top(u32 m) {
#if defined(__CUDA_ARCH__)
  return 31 - __clz((int)m);
#else
  return 31 - __builtin_clz(m);
#endif
}

// Whether a copy at distance d pushes it, after a copy at distance prev
// (the ring's front): all but code 0.
BROTLI_HD bool parse_pushes(i32 d, i32 prev) { return !(d == prev && prev > 0); }

// The short code of a copy at distance d whose ring is top[0], top[-1],
// top[-2], top[-3] (the last four distances pushed before it): the least
// k with ring[k] == d > 0, else -1.
BROTLI_HD i32 parse_code(const i32* top, i32 d) {
  if (d <= 0) return -1;
  for (int k = 0; k < 4; ++k)
    if (top[-k] == d) return k;
  return -1;
}

// Phase 4, thread t of nt: each word's copy starts and literals.  The
// frontier walk of parse_window over one word from its entry frontier,
// without the ring.
BROTLI_HD void parse_tile_words(ParseTile& m, const ParseTileCtx& c, int t,
                                int nt) {
  for (int w = t; w < c.nw; w += nt) {
    const i32 wb = w << 5;
    const u32 take = m.take[c.buf][w];
    i32 cur = m.front[w] - wb;
    if (cur < 0) cur = 0;
    u32 cs = 0, freem = 0;
    while (cur < 32) {
      const u32 from = ~0u << cur;
      const u32 mm = take & from;
      if (mm == 0) {
        freem |= from;
        break;
      }
      const int i = parse_ctz(mm);
      freem |= from & ((2u << i) - 1u);  // bits cur..i
      cs |= 1u << i;
      cur = parse_end(c.base, wb + i, m.ml[c.buf][wb + i]) - wb;
    }
    const i32 left = c.nv - (c.base + wb);  // in-chunk positions from wb
    const u32 in_chunk = left <= 0 ? 0u : (left >= 32 ? ~0u : (1u << left) - 1u);
    m.cs[w] = cs;
    m.lit[w] = freem & ~take & in_chunk;
  }
}

// bit k of b (k < 4) -> byte k
BROTLI_HD u32 parse_bytes4(u32 b) {
  return (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) | ((b & 8u) << 21);
}

// Phase 6, thread t of nt: the tile's rows from base, four positions a
// thread; `vec` where the rows take a word and a 16-byte store there.
BROTLI_HD void parse_tile_store(const ParseTile& m, const ParseTileCtx& c,
                                u8* is_cs, u8* is_lit, i32* dcode, bool vec,
                                int t, int nt) {
  for (i32 i = 4 * t; i < c.tn; i += 4 * nt) {
    const u32 cs = (m.cs[i >> 5] >> (i & 31)) & 0xFu;
    const u32 lit = (m.lit[i >> 5] >> (i & 31)) & 0xFu;
    i32 dc[4];
    for (int k = 0; k < 4; ++k) dc[k] = (cs >> k) & 1u ? m.code[i + k] : -1;
    const i32 p = c.base + i;
    if (vec && i + 4 <= c.tn) {
#if defined(__CUDA_ARCH__)
      *reinterpret_cast<u32*>(is_cs + p) = parse_bytes4(cs);
      *reinterpret_cast<u32*>(is_lit + p) = parse_bytes4(lit);
      *reinterpret_cast<int4*>(dcode + p) = make_int4(dc[0], dc[1], dc[2], dc[3]);
#else
      const u32 a = parse_bytes4(cs), b = parse_bytes4(lit);
      std::memcpy(is_cs + p, &a, 4);
      std::memcpy(is_lit + p, &b, 4);
      std::memcpy(dcode + p, dc, 16);
#endif
    } else {
      for (int k = 0; k < 4 && i + k < c.tn; ++k) {
        is_cs[p + k] = (u8)((cs >> k) & 1u);
        is_lit[p + k] = (u8)((lit >> k) & 1u);
        dcode[p + k] = dc[k];
      }
    }
  }
}

}  // namespace brotli_torch
