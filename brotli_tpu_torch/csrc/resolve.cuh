// Per-lane LZ resolve: one lane's v2 tokens -> exactly mlen bytes.
// Replaces the Pallas kernel brotli_tpu/ops/pallas_resolve.py (_build and
// its `kernel`).
//
// On the TPU every lane shared a VMEM history ring (H bytes), a recent-emit
// mini-ring and a lockstep token cursor, so copies further back than H-16
// had to be flagged ERR_FAR_DIST.  Here each lane owns its output slot in
// device memory and copies within it, so there is no ring, no distance cap
// and no far flag: a lane the reference flags far decodes here, and its
// bytes equal the host decoder's.  Oracles: native/lz_resolve.cpp
// (resolve_lane_v2) and pallas_decode2.resolve_tokens_py.
#pragma once

#include "common.cuh"

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

}  // namespace brotli_torch
