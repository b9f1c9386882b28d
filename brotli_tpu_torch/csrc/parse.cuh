// Per-lane greedy parse of the device encoder: match lengths and distances
// -> copy starts, literals and short distance codes.  Replaces the XLA
// `lax.scan` of brotli_tpu/ops/device_encode.py (greedy_parse).
//
// A lane is cut into windows of PARSE_W positions.  For each window the
// caller computes `take` (the score gate and the lazy look-ahead, below)
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
#pragma once

#include <cstring>

#include "common.cuh"

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

}  // namespace brotli_torch
