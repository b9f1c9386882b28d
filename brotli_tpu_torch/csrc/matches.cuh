// Per-position logic of the device encoder's match finder: window words,
// the two hashes, the match length of two windows, the candidate and tie
// rules, the byte-run merge, one extension step and the final clamp.  The
// CUDA kernel (csrc/matches.cu) and its host build (csrc/host_shim.cpp)
// run these same functions; they differ only in how a lane's hashed
// positions are ordered (a radix sort in shared memory on the card, a
// serial stable sort on the host) and in how the scans over a lane are
// split among threads.
//
// The function is brotli_tpu/ops/device_encode.py `find_matches` (an XLA
// stage: no `pallas_call`), as the plain PyTorch version
// `find_matches_ref` in ops/device_encode.py computes it:
//
// * hashed positions p = e * st, e < n2 = N / st, each with the window
//   words w0 = bytes p..p+3 and w1 = p+4..p+7 (little-endian);
// * sort keys (h << pbits) | e, pbits = bit length of n2 - 1, so a key is
//   unique in its lane and neighbour j of an entry in sorted order, when
//   its hash is the same, is the j-th nearest earlier hashed position with
//   that hash;
// * the match with neighbour j: the common prefix of the two 8-byte
//   windows in bytes (8 when they agree), taken when it is >= 4 and, with
//   a distance cap, the distance is within it; the best of neighbours
//   1..depth by `match_take`'s rule; with hash2 a second pass on the 7-byte
//   hash (depth 2) competes by the same rule;
// * byte runs (d[p] == d[p-4]) of length >= 4, capped at MATCH_MAX_LEN,
//   replace a shorter match with distance 4;
// * synchronous extension rounds at strides 8, 16, ..., 256: a match of
//   exactly the stride length whose position + stride holds a match at the
//   same distance grows by that match's length, capped at MATCH_MAX_LEN;
// * the clamp to the lane's valid bytes.
#pragma once

#include "common.cuh"

namespace brotli_torch {

constexpr i32 MATCH_CAP_BYTES = 8;  // window bytes compared (MATCH_CAP)
constexpr i32 MATCH_TAIL = 12;      // bytes a row holds past N (MATCH_CAP + 4)
constexpr i32 MATCH_MAX_LEN = 512;  // MAX_LEN
constexpr i32 MATCH_MAX_N = 32768;  // CHUNK_N: distances fit 15 bits
constexpr u32 MATCH_HASH_MUL = 0x1E35A7BDu;
constexpr u32 MATCH_HASH_MUL2 = 0x9E3779B1u;
// A hash is an int32 shifted right arithmetically by 15: 17 significant
// bits, sign-extended.  Masked to 31 - pbits bits, its bits above bit 16
// copy bit 16, so its order and its equality are those of its low 17 bits.
constexpr u32 MATCH_KEY_MASK = (1u << 17) - 1u;

struct MatchKnobs {
  i32 st;        // hash stride: 1 or 2
  i32 pbits;     // bit length of n2 - 1
  i32 max_dist;  // distance cap; < 0 for none
  i32 depth;     // chain depth of the first pass (>= 1)
  bool hash2;    // a second pass on the 7-byte hash
};

// Bit length of x - 1 for x >= 1 (Python's (x - 1).bit_length()).
BROTLI_HD i32 match_pbits(i32 x) {
  i32 b = 0;
  while (b < 31 && (1 << b) < x) ++b;
  return b;
}

// The sort key of a hashed position: the 4-byte hash, or with `h7` the
// 7-byte one (device_encode.find_matches's h4 and h7), reduced to its low
// 17 bits.  The products wrap as int32 products do.
BROTLI_HD u32 match_key(u32 w0, u32 w1, bool h7, i32 pbits) {
  u32 m = w0 * MATCH_HASH_MUL;
  if (h7) m ^= (w1 & 0xFFFFFFu) * MATCH_HASH_MUL2;
  const u32 h = (u32)((i32)m >> 15) & ((1u << (31 - pbits)) - 1u);
  return h & MATCH_KEY_MASK;
}

// Bytes two 8-byte windows (a0 a1, b0 b1) share from their start.
BROTLI_HD i32 match_len(u32 a0, u32 a1, u32 b0, u32 b1) {
  u32 x = a0 ^ b0;
  i32 base = 0;
  if (x == 0) {
    x = a1 ^ b1;
    base = 4;
    if (x == 0) return MATCH_CAP_BYTES;
  }
  return base + ((x & 0xFFu) ? 0 : (x & 0xFFFFu) ? 1 : (x & 0xFFFFFFu) ? 2 : 3);
}

// The candidate at distance `dist` with common prefix `len`: (len, dist)
// when taken, (0, 0) otherwise.
BROTLI_HD void match_candidate(const MatchKnobs& K, i32 len, i32 dist,
                               i32& l, i32& d) {
  const bool ok = len >= 4 && (K.max_dist < 0 || dist <= K.max_dist);
  l = ok ? len : 0;
  d = ok ? dist : 0;
}

// The tie rule between depths and between the passes: longer wins, then
// nearer among equal non-zero lengths.
BROTLI_HD void match_take(i32& sl, i32& sd, i32 l, i32 d) {
  if (l > sl || (l == sl && d < sd && l > 0)) {
    sl = l;
    sd = d;
  }
}

// A byte run of length `run` (uncapped) from p at distance 4.
BROTLI_HD void match_run(i32 run, i32& l, i32& d) {
  const i32 L = run < MATCH_MAX_LEN ? run : MATCH_MAX_LEN;
  if (L >= 4 && L > l) {
    l = L;
    d = 4;
  }
}

// One extension step at stride s: the new length at p from the last
// round's (l, d) at p and (nl, nd) at p + s (0, 0 past the lane's end).
BROTLI_HD i32 match_extend(i32 s, i32 l, i32 d, i32 nl, i32 nd) {
  if (l == s && nd == d && nl > 0) {
    const i32 t = l + nl;
    return t < MATCH_MAX_LEN ? t : MATCH_MAX_LEN;
  }
  return l;
}

// The clamp to the lane's nv valid bytes and the validity mask.
BROTLI_HD void match_final(i32 p, i32 nv, i32& l, i32& d) {
  const i32 room = nv - p > 0 ? nv - p : 0;
  if (l > room) l = room;
  if (!(p < nv && l >= 4 && d >= 1 && d <= p)) l = d = 0;
}

// Extension strides run while s < min(MATCH_MAX_LEN, n).
BROTLI_HD i32 match_ext_limit(i32 n) {
  return n < MATCH_MAX_LEN ? n : MATCH_MAX_LEN;
}

// The knobs the kernel and the host form take; false for anything else.
inline bool match_args_ok(int n_lanes, int n, int st, int max_dist,
                          int depth) {
  return n_lanes > 0 && n > 0 && n <= MATCH_MAX_N && (st == 1 || st == 2) &&
         n % st == 0 && depth >= 1 && max_dist >= -1;
}

}  // namespace brotli_torch
