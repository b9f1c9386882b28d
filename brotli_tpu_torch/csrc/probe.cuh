// Per-element arithmetic of the two structure probes, shared by the CUDA
// kernels (probe.cu) and the host shim (host_shim.cpp).
//
// probe_v2 is the counterpart of tools/probe_v2.py: the v2 entropy row's
// operations on one (8, 128) tile, added level by level (elementwise, four
// variable-shift peeks, the limb consume, a staging store, a lane gather).
// probe_v2b is the counterpart of tools/probe_v2b.py: the kernel structure
// around a trivial row (loop form, reductions, a refill copy, a staging
// flush) with 4 or 18 carries.
#pragma once

#include "common.cuh"

namespace brotli_torch {

constexpr int PROBE_SUB = 8;
constexpr int PROBE_LANES = 128;
constexpr int PROBE_TILE = PROBE_SUB * PROBE_LANES;  // 1024 elements
constexpr int PROBE_WIN = 64;        // probe_v2b window rows (a ring)
constexpr int PROBE_REFILL = 32;     // rows one refill copies
constexpr int PROBE_FILL_CAP = 960;  // no refill beyond this row

// probe_v2's carries: the 96-bit buffer (b2:b1:b0) and the bit cursor q.
struct ProbeV2 {
  u32 b0, b1, b2;
  i32 q;
};

// One row of probe_v2 at LEVEL (1..5) for one tile element.  `arow` is the
// element's tile row of the input, the lane gather's source.  Level 4's
// staging store of b0 is the caller's (where staging lives differs between
// the card and the host); level 5 changes only b1, so the caller may store
// b0 after this returns.
template <int LEVEL>
BROTLI_HD void probe_v2_row(ProbeV2& c, const i32* arow) {
  c.b0 = c.b0 ^ (c.b1 + 12345u);
  c.q = (c.q + 7) & 31;
  if (LEVEL >= 2) {
    for (int k = 0; k < 4; ++k) {
      const u32 r = funnel_r(c.b0, c.b1, (u32)(c.q & 31));
      c.q = c.q + (i32)(r & 7u);
    }
  }
  if (LEVEL >= 3) {
    const bool hi = (c.q >> 5) >= 1;
    const u32 c0 = hi ? c.b1 : c.b0;
    const u32 c1 = hi ? c.b2 : c.b1;
    const u32 c2 = hi ? 0u : c.b2;
    const u32 mq = (u32)(c.q & 31);
    c.b0 = funnel_r(c0, c1, mq);
    c.b1 = funnel_r(c1, c2, mq);
    c.b2 = c2 >> mq;
  }
  if (LEVEL >= 5) c.b1 = c.b1 + (u32)arow[c.b0 & 127u];
}

// One row of probe_v2b over NCARRY carries.
template <int NCARRY>
BROTLI_HD void probe_v2b_row(u32 (&c)[NCARRY]) {
  c[0] = c[0] ^ (c[1] + 12345u);
  c[1] = c[1] + (c[0] >> 3);
  for (int i = 2; i < NCARRY; ++i) c[i] = c[i] + (u32)i;
}

// An element's term of the refill test's minimum (JAX: carry[1] as int32
// where carry[0] > 0, else 1 << 30).
BROTLI_HD i32 probe_v2b_minkey(u32 c0, u32 c1) {
  return c0 > 0 ? (i32)c1 : (1 << 30);
}

// Whether a block refills its window, from the minimum over the reduced
// elements (`reduces`) or from the fill level alone.
BROTLI_HD bool probe_v2b_refill(bool reduces, i32 minp, i32 filled) {
  if (reduces)
    return minp >= filled - PROBE_REFILL &&
           filled + PROBE_REFILL <= PROBE_FILL_CAP;
  return filled < PROBE_FILL_CAP;
}

}  // namespace brotli_torch
