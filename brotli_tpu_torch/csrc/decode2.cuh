// Per-lane v2 entropy decode: one single-metablock, shared-table Brotli
// stream -> v2 LZ tokens.  Replaces the lockstep Pallas kernel
// brotli_tpu/ops/pallas_decode2.py (_build, `kernel` and its `row_step`).
//
// The TPU kernel advances 1024 streams one "row" at a time in (8, 128)
// vregs; here one thread (or one host loop iteration) runs one stream's
// rows in sequence.  A row is the same unit of work as the JAX row_step:
// one refill of at most one 32-bit word when avail <= 64, then at most one
// phase step that consumes <= 32 bits, so the words consumed (widx) and the
// token sequence match the reference lane for lane.  The TPU-only parts
// (sliding DMA window and its stalls, chunked lane gathers, block/row
// budgets, interleave groups) have no counterpart: words are read straight
// from the word-major table and tables are plain flat arrays.
//
// Token format (u32, as the JAX module docstring):
//   tag 0 literals (count (t>>24)&3, bytes at bits 0-7 / 8-15), tag 1 copy
//   length, tag 2 distance of the pending tag-1, tag 3 fused copy
//   (len (t>>22)&0xFF, distance t & 0x3FFFFF).
#pragma once

#include "common.cuh"
#include "queue.cuh"

namespace brotli_torch {

enum Phase : i32 {
  PH_INIT = 0, PH_CMD, PH_INS_EX, PH_CP_EX, PH_LIT, PH_DIST, PH_DIST_EX,
  PH_DIST2, PH_DONE, PH_ERR
};

constexpr u32 TAG_COPY = 1u << 30;
constexpr u32 TAG_DIST = 2u << 30;
constexpr u32 TAG_FUSED = 3u << 30;

// table capacities in 128-entry chunks (pallas_decode2.py LIT_K .. DX_K)
constexpr int LIT_K = 5;
constexpr int CMD_K = 9;
constexpr int DIST_K = 8;
constexpr int DX_N = 5 * 128;  // packed (extra << 26) | offset, 544 used
constexpr int CONSTS_N = 128;  // [0,24) ins, [64,88) copy, [96,112) short

// One group's tables.  lit/cmd/dist are two-level Huffman tables in the
// host format (decode/huffman.py): 8-bit root, entries (nbits << 16) | sym.
struct Decode2Tables {
  const i32* lit;
  const i32* cmd;
  const i32* dist;
  const i32* dx;
  const i32* consts;
  i32 lit_k, cmd_k, dist_k;
};

struct Decode2Params {
  i32 npostfix, ndirect, maxbw;
  i32 wpad;  // words per lane in the word table
  i32 cap;   // token slots per lane
};

struct Decode2Result {
  i32 count, phase, widx;
};

// flat[idx] inside the table's k chunks, else 0 (the JAX chunk select
// yields 0 for an index outside every chunk)
BROTLI_HD i32 tab_lookup(const i32* t, i32 k, i32 idx) {
  return (idx >= 0 && idx < k * 128) ? t[idx] : 0;
}

// Two-level table read (JAX `read_symbol`): v15 holds the next 15 bits.
BROTLI_HD void read_symbol(const i32* t, i32 k, u32 v15, i32& sym, i32& nb) {
  const i32 root = (i32)(v15 & 0xFFu);
  const i32 e0 = t[root];  // the root spans chunks 0-1; k >= 2 always
  const i32 bits0 = e0 >> 16;
  if (bits0 > 8) {
    const u32 sub_mask = (1u << (u32)(bits0 > 15 ? 15 : bits0)) - 1u;
    const i32 idx2 = root + (e0 & 0xFFFF) + (i32)((v15 & sub_mask) >> 8);
    const i32 e1 = tab_lookup(t, k, idx2);
    sym = e1 & 0xFFFF;
    nb = (e1 >> 16) + 8;
  } else {
    sym = e0 & 0xFFFF;
    nb = bits0;
  }
}

// Decode one lane.  B is the lane's backend: O.word(w) is the lane's w-th
// 32-bit word (rebased to its command start word), asked for in order
// w = 0, 1, ...; O.token(i, t) stores the lane's i-th token.
template <class B>
BROTLI_HD Decode2Result decode2_run(const Decode2Tables& T,
                                    const Decode2Params& P, i32 start_bit,
                                    i32 mlen, B& O) {
  i32 phase = mlen > 0 ? PH_INIT : PH_DONE;
  i32 widx = 0, avail = 0, mbl = mlen, count = 0;
  u32 b0 = 0, b1 = 0, b2 = 0;
  i32 lit_rem = 0, copy_len = 0, ins_code = 0, cp_code = 0, implicit = 0;
  i32 dcode = 0, dist_save = 0;
  i32 r0 = 4, r1 = 11, r2 = 15, r3 = 16;
  // Hang guard, not a contract: an honest lane takes at most ~3 phase rows
  // per output byte plus about two refill stalls per word.
  const i64 budget = 8 * (i64)mlen + 4 * (i64)P.wpad + 64;

  for (i64 row = 0; phase < PH_DONE && row < budget; ++row) {
    // ---- refill: one word when avail <= 64 ----
    const bool need = avail <= 64 && widx < P.wpad;
    if (need) {
      const u32 acc = O.word(widx);
      const u32 sh = (u32)(avail & 31);
      const i32 limb = avail >> 5;
      const u32 lo = acc << sh;
      const u32 hi = sh ? acc >> (32u - sh) : 0u;
      if (limb == 0) {
        b0 |= lo;
        b1 |= hi;
      } else if (limb == 1) {
        b1 |= lo;
        b2 |= hi;
      } else if (limb == 2) {
        b2 |= lo;
      }
      avail += 32;
      widx += 1;
    }
    const bool run = avail >= 65 || (phase == PH_INIT && avail >= 32);
    if (!run) {
      if (need) continue;  // stall row: the buffer fills first
      break;               // out of words: the lane can never run again
    }

    i32 q = 0;
    u32 token = 0;
    bool finalize = false;
    i32 distance = 0;
    bool is_imp = false;
    switch (phase) {
      case PH_INIT:
        q = start_bit;
        phase = PH_CMD;
        break;
      case PH_CMD: {
        i32 sym, nb;
        read_symbol(T.cmd, T.cmd_k, peek32(b0, b1, b2, q) & 0x7FFFu, sym, nb);
        const i32 cell = sym >> 6;
        const i32 range_idx = cell < 2 ? cell : cell - 2;
        const i32 ins_high = shr_sat(0x29850, 2 * range_idx) & 3;
        const i32 cp_high = shr_sat(0x26244, 2 * range_idx) & 3;
        ins_code = ins_high * 8 + ((sym >> 3) & 7);
        cp_code = cp_high * 8 + (sym & 7);
        implicit = cell < 2 ? 1 : 0;
        const i32 ins_pack = T.consts[ins_code & 127];
        const i32 cp_pack = T.consts[(cp_code + 64) & 127];
        const i32 nb_i = ins_pack >> 20, off_i = ins_pack & 0xFFFFF;
        const i32 nb_c = cp_pack >> 20, off_c = cp_pack & 0xFFFFF;
        q += nb;
        const bool can_i = q + nb_i <= 32;
        if (can_i) {
          lit_rem = off_i + (i32)(peek32(b0, b1, b2, q) & 0xFFFFFFu &
                                  low_mask((u32)nb_i));
          q += nb_i;
        }
        const bool can_c = can_i && q + nb_c <= 32;
        if (can_c) {
          copy_len = off_c + (i32)(peek32(b0, b1, b2, q) & 0xFFFFFFu &
                                   low_mask((u32)nb_c));
          q += nb_c;
        }
        phase = !can_i ? PH_INS_EX
                : !can_c ? PH_CP_EX
                : lit_rem > 0 ? PH_LIT : PH_DIST;
        break;
      }
      case PH_INS_EX: {
        const i32 ins_pack = T.consts[ins_code & 127];
        const i32 cp_pack = T.consts[(cp_code + 64) & 127];
        const i32 nb_i = ins_pack >> 20, off_i = ins_pack & 0xFFFFF;
        const i32 nb_c = cp_pack >> 20, off_c = cp_pack & 0xFFFFF;
        lit_rem = off_i + (i32)(peek32(b0, b1, b2, q) & 0xFFFFFFu &
                                low_mask((u32)nb_i));
        q += nb_i;
        const bool can_c = q + nb_c <= 32;
        if (can_c) {
          copy_len = off_c + (i32)(peek32(b0, b1, b2, q) & 0xFFFFFFu &
                                   low_mask((u32)nb_c));
          q += nb_c;
        }
        phase = !can_c ? PH_CP_EX : lit_rem > 0 ? PH_LIT : PH_DIST;
        break;
      }
      case PH_CP_EX: {
        const i32 cp_pack = T.consts[(cp_code + 64) & 127];
        const i32 nb_c = cp_pack >> 20, off_c = cp_pack & 0xFFFFF;
        copy_len = off_c + (i32)(peek32(b0, b1, b2, q) & 0xFFFFFFu &
                                 low_mask((u32)nb_c));
        q += nb_c;
        phase = lit_rem > 0 ? PH_LIT : PH_DIST;
        break;
      }
      case PH_LIT: {
        // two literals per row iff lit_rem >= 2 and mbl >= 2, never three
        i32 sym0, nb0, sym1 = 0, nb1 = 0;
        read_symbol(T.lit, T.lit_k, peek32(b0, b1, b2, q) & 0x7FFFu, sym0, nb0);
        q += nb0;
        const bool have2 = lit_rem >= 2 && mbl >= 2;
        if (have2) {
          read_symbol(T.lit, T.lit_k, peek32(b0, b1, b2, q) & 0x7FFFu, sym1,
                      nb1);
          q += nb1;
        }
        const i32 took = have2 ? 2 : 1;
        token = (u32)sym0 | (have2 ? (u32)sym1 << 8 : 0u) | ((u32)took << 24);
        lit_rem -= took;
        mbl -= took;
        if (mbl <= 0) {
          phase = PH_DONE;
        } else if (lit_rem <= 0) {
          phase = PH_DIST;
        }
        break;
      }
      case PH_DIST: {
        is_imp = implicit == 1;
        if (!is_imp) {
          i32 sym, nb;
          read_symbol(T.dist, T.dist_k, peek32(b0, b1, b2, q) & 0x7FFFu, sym,
                      nb);
          q += nb;
          dcode = sym;
        } else {
          dcode = -1;
        }
        const bool is_short = dcode >= 0 && dcode < 16;
        const bool is_direct =
            P.ndirect > 0 && dcode >= 16 && dcode < 16 + P.ndirect;
        if (is_imp) {
          distance = r0;
        } else if (is_short) {
          const i32 sp = T.consts[(dcode + 96) & 127];
          const i32 k_idx = sp >> 4;
          const i32 delta = (sp & 15) - 3;
          const i32 ring = k_idx == 0 ? r0 : k_idx == 1 ? r1 : k_idx == 2 ? r2 : r3;
          distance = add_wrap(ring, delta);
        } else if (is_direct) {
          distance = dcode - 16 + 1;
        } else {  // long code: extra bits now if they fit, else spill a row
          const i32 dxp = T.dx[dcode < DX_N ? dcode : DX_N - 1];
          const i32 nbx = dxp >> 26, offx = dxp & 0x3FFFFFF;
          if (q + nbx > 32) {
            phase = PH_DIST_EX;
            break;
          }
          const u32 xv = peek32(b0, b1, b2, q) & 0xFFFFFFu & low_mask((u32)nbx);
          q += nbx;
          distance = add_wrap(offx, shl_wrap((i32)xv, P.npostfix));
        }
        finalize = true;
        break;
      }
      case PH_DIST_EX: {
        const i32 di = dcode < 0 ? 0 : (dcode < DX_N ? dcode : DX_N - 1);
        const i32 dxp = T.dx[di];
        const i32 nbx = dxp >> 26, offx = dxp & 0x3FFFFFF;
        const u32 xv = peek32(b0, b1, b2, q) & 0xFFFFFFu & low_mask((u32)nbx);
        q += nbx;
        distance = add_wrap(offx, shl_wrap((i32)xv, P.npostfix));
        is_imp = implicit == 1;
        finalize = true;
        break;
      }
      case PH_DIST2:
        token = TAG_DIST | (u32)dist_save;
        mbl -= copy_len;
        phase = mbl <= 0 ? PH_DONE : PH_CMD;
        break;
      default:
        break;
    }

    if (finalize) {
      // a completed distance (from DIST or DIST_EX): validate, push the
      // ring, then a fused token or the tag-1 half of a long-form pair
      const i32 pos = mlen - mbl;
      const i32 max_dist = pos < P.maxbw ? pos : P.maxbw;
      if (distance < 1 || distance > max_dist || copy_len > mbl) {
        phase = PH_ERR;
      } else {
        if (!is_imp && dcode > 0) {
          r3 = r2;
          r2 = r1;
          r1 = r0;
          r0 = distance;
        }
        if (copy_len <= 255 && distance <= 0x3FFFFF) {
          token = TAG_FUSED | ((u32)copy_len << 22) | (u32)distance;
          mbl -= copy_len;
          phase = mbl <= 0 ? PH_DONE : PH_CMD;
        } else {
          token = TAG_COPY | (u32)copy_len;
          dist_save = distance;
          phase = PH_DIST2;
        }
      }
    }

    // ---- consume q bits ----
    const bool hi = (q >> 5) >= 1;
    const u32 c0 = hi ? b1 : b0, c1 = hi ? b2 : b1, c2 = hi ? 0u : b2;
    const u32 mq = (u32)(q & 31);
    b0 = funnel_r(c0, c1, mq);
    b1 = funnel_r(c1, c2, mq);
    b2 = c2 >> mq;
    avail -= q;

    if (token != 0) {
      if (count >= P.cap) {
        phase = PH_ERR;  // more tokens than an honest lane can produce
      } else {
        O.token(count, token);
        ++count;
      }
    }
  }
  return Decode2Result{count, phase, widx};
}

// The direct backend (csrc/decode2.cu `decode2_direct_kernel`): each
// word loaded when the row rule asks for it, each token stored at once.
struct Direct2 {
  const u32* words;
  i64 wstride;
  u32* tok;
  i64 tstride;
  BROTLI_HD u32 word(i32 w) const { return words[(i64)w * wstride]; }
  BROTLI_HD void token(i32 i, u32 t) const { tok[(i64)i * tstride] = t; }
};

// words[w * wstride] is the lane's w-th word; tokens go to tok[i * tstride].
BROTLI_HD Decode2Result decode2_lane(const Decode2Tables& T,
                                     const Decode2Params& P,
                                     const u32* words, i64 wstride,
                                     i32 start_bit, i32 mlen,
                                     u32* tok, i64 tstride) {
  Direct2 O{words, wstride, tok, tstride};
  return decode2_run(T, P, start_bit, mlen, O);
}

// The queued backend (csrc/decode2.cu `decode2_kernel`): words come
// through the lane's look-ahead queue (queue.cuh), tokens are stored at
// once, token-major.
struct Queued2 {
  WordQueue wq;
  u32* tok;
  i64 tstride;
  BROTLI_HD u32 word(i32 w) { return wq.pop(w); }
  BROTLI_HD void token(i32 i, u32 t) const { tok[(i64)i * tstride] = t; }
};

BROTLI_HD Decode2Result decode2_lane_queued(const Decode2Tables& T,
                                            const Decode2Params& P,
                                            i32 start_bit, i32 mlen,
                                            Queued2& O) {
  O.wq.start();
  const Decode2Result r = decode2_run(T, P, start_bit, mlen, O);
  O.wq.drain();
  return r;
}

}  // namespace brotli_torch
