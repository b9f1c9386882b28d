// Per-lane v3 full-format decode: one compressed metablock of one Brotli
// stream -> its bytes, written straight into the lane's output slot.
// Replaces the fused Pallas kernel brotli_tpu/ops/pallas_decode3.py
// (_build, `kernel`: row_step, block_switch, read_symbol, lut2, dict_byte,
// drain).
//
// The format handled is the whole of a compressed metablock: block
// switching in all three categories, literal and distance context maps with
// per-block-type context modes, tree groups, static-dictionary words with
// the 121 transforms, the compound dictionary, and a history prefix of
// earlier output for streams of several metablocks.
//
// The entropy row is the JAX row_step's, kept exactly: refill one word when
// avail <= 64, then at most one phase step when avail >= 65 (>= 32 in
// INIT).  Extra bits are read inside a step only while q + nbits <= 32, and
// otherwise spill to INS_EX / CP_EX / DIST_EX / BSW2.  So the step sequence,
// and with it the final widx and avail (from which the host finds the next
// metablock header), match the reference lane for lane.  The byte side is
// not the reference's: the TPU kernel streams bytes through an 8-byte FIFO
// into a VMEM ring under a shared flush frontier and fetches far sources
// through a staging window.  Those are stalls of the step sequence, never
// changes to it (a blocked row refills at most once and then waits), so
// here a step writes its literals, its copy or its dictionary word into the
// lane's slot at once: out[0, hrb) is the lane's earlier output,
// right-aligned, and this metablock follows it.
//
// One row of the reference survives from its byte side: a dictionary word
// keeps the lane in the DICT phase for its bytes, during which the lane is
// live and refills, so a word that ends the metablock is followed by one
// refill when avail <= 64.
#pragma once

#include "common.cuh"
#include "queue.cuh"

namespace brotli_torch {

// phases (pallas_decode3.py INIT .. DONE)
enum Phase3 : i32 {
  P3_INIT = 0, P3_CMD, P3_INS_EX, P3_CP_EX, P3_LIT, P3_DIST, P3_DIST_EX,
  P3_BSW2, P3_DICT, P3_DONE
};

constexpr i32 ERR3_FAR_DIST = 1;  // dictionary reference without the dictionary
constexpr i32 ERR3_STREAM = 8;    // malformed stream

// 128-entry chunks per tree (pallas_decode3.py LCH .. BLCH)
constexpr i32 LCH3 = 5, CCH3 = 9, DCH3 = 8, BTCH3 = 6, BLCH3 = 4;
constexpr i32 DX3_N = 5 * 128;        // (extra << 26) | offset per group
constexpr i32 CONSTS3_N = 256;        // _build_consts, un-replicated
constexpr i32 LUT3_N = 16 * 128;      // the context LUT
constexpr i32 TFM3_N = 256;           // transform meta, two words each
constexpr i32 SCAL3_ROWS = 12;        // per-lane scalar rows (preflight_v3)
constexpr i32 STATUS3_ROWS = 16;      // err, r_lane, phase, mbl, widx, avail,
                                      // r0..r3, zeros

// columns of a group's row in the config tensor (ops/decode3.py CFG_*)
enum Cfg3 : i32 {
  CFG_NL = 0, CFG_NC, CFG_ND, CFG_NBT0, CFG_NBT1, CFG_NBT2, CFG_NPOSTFIX,
  CFG_NDIRECT, CFG_MAXBW, CFG_TRIVIAL, CFG_LCMCH, CFG_DCMCH, CFG_OFF_LIT,
  CFG_OFF_CMD, CFG_OFF_DIST, CFG_OFF_BSW, CFG_OFF_CMAP, CFG_OFF_DX, NCFG3
};

// One group's configuration and tables.  Trees are two-level tables in the
// host format (decode/huffman.py): 8-bit root, entries (nbits << 16) | sym.
struct Decode3Group {
  const i32* lit;   // nl trees of LCH3 chunks
  const i32* cmd;   // nc trees of CCH3 chunks
  const i32* dist;  // nd trees of DCH3 chunks
  const i32* bsw;   // 3 block-type trees of BTCH3, then 3 length trees of BLCH3
  const i32* cmap;  // literal map (lcmch chunks), distance map (dcmch), modes
  const i32* dx;    // DX3_N
  i32 nl, nc, nd, nbt[3], npostfix, ndirect, maxbw, trivial_lit, lcmch, dcmch;
};

BROTLI_HD Decode3Group make_group3(const i32* row, const i32* lit,
                                   const i32* cmd, const i32* dist,
                                   const i32* bsw, const i32* cmap,
                                   const i32* dx) {
  Decode3Group G;
  G.lit = lit + row[CFG_OFF_LIT];
  G.cmd = cmd + row[CFG_OFF_CMD];
  G.dist = dist + row[CFG_OFF_DIST];
  G.bsw = bsw + row[CFG_OFF_BSW];
  G.cmap = cmap + row[CFG_OFF_CMAP];
  G.dx = dx + row[CFG_OFF_DX];
  G.nl = row[CFG_NL];
  G.nc = row[CFG_NC];
  G.nd = row[CFG_ND];
  G.nbt[0] = row[CFG_NBT0];
  G.nbt[1] = row[CFG_NBT1];
  G.nbt[2] = row[CFG_NBT2];
  G.npostfix = row[CFG_NPOSTFIX];
  G.ndirect = row[CFG_NDIRECT];
  G.maxbw = row[CFG_MAXBW];
  G.trivial_lit = row[CFG_TRIVIAL];
  G.lcmch = row[CFG_LCMCH];
  G.dcmch = row[CFG_DCMCH];
  return G;
}

// Tables every group shares.  Byte tables are padded with zeros to whole
// 512-byte chunks (dict_n, tfs_n, cd_n), and offsets are clipped into them
// as the reference clips them into its chunk ranges.
struct Decode3Shared {
  const i32* consts;  // [0,24) ins, [64,88) copy, [96,112) short codes;
                      // [128,154) block length, [160,185) dictionary
                      // size bits, [192,218) dictionary word offsets
  const i32* lut;     // context LUT (modes 2/3 read)
  const i32* tfm;     // (pre_off<<9)|(pre_len<<5)|op, (suf_off<<4)|suf_len
  const u8* dict;     // static dictionary
  const u8* tfs;      // transform prefix/suffix strings
  const u8* cdict;    // compound dictionary
  i32 dict_n, tfs_n, cd_n;
  i32 cd_t;           // compound dictionary size (0: none)
  bool use_dict;
};

// One lane's input and output.
struct Decode3Lane {
  const u32* words;  // words[w * wstride]: the lane's words from the
  i64 wstride;       // one holding its first command bit
  i32 wpad;
  const i32* scal;   // scal[r * sstride], r < SCAL3_ROWS: start_bit, mlen,
  i64 sstride;       // blen0..2, pos0, p1, p2, r0..r3
  u8* out;           // [0, hrb) earlier output, then out_cap bytes
  i32 hrb, out_cap;
  i32* status;       // status[r * tstride], r < STATUS3_ROWS
  i64 tstride;
};

struct State3 {
  i32 phase, widx, avail, mbl, wpos;
  u32 b0, b1, b2;
  i32 lit_rem, copy_len, ins_code, cp_code, implicit, dcode;
  i32 blen[3], bt[3], btp[3];
  i32 clo, p1, p2, r0, r1, r2, r3, bsw_cat, bsw_code, err;
};

// Two-level read from tree `tree` of a group of `ntrees` trees of `tc`
// chunks (JAX read_symbol).  The reference's select chains give entry 0
// for a tree outside the group and for a level-2 index outside the chunks
// 2.. of some tree, and so does this.
template <class B>
BROTLI_HD void read_symbol3(const i32* tab, i32 tc, i32 ntrees, i32 tree,
                            u32 v15, i32& sym, i32& nb) {
  if (tree < 0 || tree >= ntrees) {
    sym = 0;
    nb = 0;
    return;
  }
  const i32 root = (i32)(v15 & 0xFFu);
  const i32 base = tree * tc;
  const i32 e0 = B::ld(tab + base * 128 + root);
  const i32 bits0 = e0 >> 16;
  if (bits0 > 8) {
    const u32 sub_mask = (1u << (u32)(bits0 > 15 ? 15 : bits0)) - 1u;
    const i32 idx2 = root + (e0 & 0xFFFF) + (i32)((v15 & sub_mask) >> 8);
    const i32 a = base + (idx2 >> 7);
    const i32 e1 = (a < ntrees * tc && a % tc >= 2)
                       ? B::ld(tab + a * 128 + (idx2 & 127)) : 0;
    sym = e1 & 0xFFFF;
    nb = (e1 >> 16) + 8;
  } else {
    sym = e0 & 0xFFFF;
    nb = bits0;
  }
}

// entry idx of a map of n_chunks chunks, 0 outside it (JAX chunk_lookup)
template <class B>
BROTLI_HD i32 map_get(const i32* t, i32 n_chunks, i32 idx) {
  return (idx >= 0 && (idx >> 7) < n_chunks) ? B::ld(t + idx) : 0;
}

// Literal context id (JAX lut2): modes 0/1 closed-form, modes 2/3 from the
// LUT, read only in chunks 8-15 as the reference reads them.
template <class B>
BROTLI_HD i32 lut2(const i32* lut, i32 clo, i32 p1, i32 p2) {
  const i32 mode = clo >> 9;
  if (mode == 0) return p1 & 63;
  if (mode == 1) return p1 >> 2;
  const i32 i1 = clo + p1, i2 = clo + 256 + p2;
  const i32 c1 = i1 >> 7, c2 = i2 >> 7;
  const i32 a = (c1 == 8 || c1 == 9 || c1 == 12 || c1 == 13) ? B::ld(lut + i1) : 0;
  const i32 b = (c2 == 10 || c2 == 11 || c2 == 14 || c2 == 15) ? B::ld(lut + i2) : 0;
  return a | b;
}

// One refill of the row rule: `acc` is the lane's word at s.widx.
BROTLI_HD void refill3(State3& s, u32 acc) {
  const u32 sh = (u32)(s.avail & 31);
  const i32 limb = s.avail >> 5;
  const u32 lo = acc << sh;
  const u32 hi = sh ? acc >> (32u - sh) : 0u;
  if (limb == 0) {
    s.b0 |= lo;
    s.b1 |= hi;
  } else if (limb == 1) {
    s.b1 |= lo;
    s.b2 |= hi;
  } else if (limb == 2) {
    s.b2 |= lo;
  }
  s.avail += 32;
  s.widx += 1;
}

BROTLI_HD u32 pk(const State3& s, i32 q) { return peek32(s.b0, s.b1, s.b2, q); }

BROTLI_HD void put_byte(State3& s, const Decode3Lane& L, u32 b) {
  if (s.wpos < L.out_cap) L.out[L.hrb + s.wpos] = (u8)b;
  s.wpos += 1;
  s.p2 = s.p1;
  s.p1 = (i32)(b & 0xFFu);
}

BROTLI_HD void push_ring(State3& s, i32 distance) {
  s.r3 = s.r2;
  s.r2 = s.r1;
  s.r1 = s.r0;
  s.r0 = distance;
}

// Block switch of category CAT when its block length is 0 (JAX
// block_switch).  Returns whether the lane switched: the row's step is then
// the switch alone.  Length extra bits that do not fit spill to BSW2.
template <int CAT, class B>
BROTLI_HD bool block_switch3(State3& s, const Decode3Shared& S,
                             const Decode3Group& G, i32& q) {
  const i32 nbt = G.nbt[CAT];
  if (nbt < 2 || s.blen[CAT] != 0) return false;
  i32 tsym, tnb, lsym, lnb;
  read_symbol3<B>(G.bsw + CAT * BTCH3 * 128, BTCH3, 1, 0, pk(s, q) & 0x7FFFu,
               tsym, tnb);
  q += tnb;
  read_symbol3<B>(G.bsw + (3 * BTCH3 + CAT * BLCH3) * 128, BLCH3, 1, 0,
               pk(s, q) & 0x7FFFu, lsym, lnb);
  q += lnb;
  const i32 bt_cur = s.bt[CAT];
  i32 bt = tsym == 0 ? s.btp[CAT] : tsym == 1 ? bt_cur + 1 : tsym - 2;
  if (bt >= nbt) bt -= nbt;
  s.btp[CAT] = bt_cur;
  s.bt[CAT] = bt;
  if (CAT == 0) s.clo = B::ld(G.cmap + (G.lcmch + G.dcmch) * 128 + (bt & 127));
  const i32 pack = B::ld(S.consts + 128 + clip(lsym, 0, 25));
  const i32 nbx = pack >> 20, offx = pack & 0xFFFFF;
  if (q + nbx <= 32) {
    s.blen[CAT] = offx + (i32)(pk(s, q) & 0xFFFFFFu & low_mask((u32)nbx));
    q += nbx;
  } else {
    s.bsw_cat = CAT;
    s.bsw_code = lsym;
    s.phase = P3_BSW2;
  }
  return true;
}

// tree of the next literal after bytes p1, p2 (JAX lit_tree)
template <class B>
BROTLI_HD i32 lit_tree(const State3& s, const Decode3Shared& S,
                       const Decode3Group& G, i32 p1, i32 p2) {
  const i32 cidx = (s.bt[0] << 6) +
                   (G.trivial_lit ? 0 : lut2<B>(S.lut, s.clo, p1, p2));
  return map_get<B>(G.cmap, G.lcmch, cidx);
}

// The bytes of a dictionary word (JAX dict_byte, all at once): prefix,
// body, suffix; the body from the static dictionary with the uppercase
// ("ferment") UTF-8 state machine, or from the compound dictionary as is.
template <class B>
BROTLI_HD void dict_bytes(State3& s, const Decode3Shared& S, B& O,
                          bool compound, i32 total,
                          i32 pre, i32 bodyn, i32 woff, i32 poff, i32 soff,
                          i32 op) {
  i32 clpos = 0, cllen = 0, clxp = 0, clxv = 0, fdone = 0;
  for (i32 i = 0; i < total; ++i) {
    const bool in_pre = i < pre;
    const i32 bi = i - pre;
    if (!in_pre && bi < bodyn) {
      i32 d_b = compound ? (i32)ldg(S.cdict + clip(woff + bi, 0, S.cd_n - 1))
                         : (i32)ldg(S.dict + clip(woff + bi, 0, S.dict_n - 1));
      const bool ferm_on = !compound && ((op == 10 && fdone == 0) || op == 11);
      if (ferm_on) {
        if (clpos >= cllen) {
          const bool is_lo = d_b >= 97 && d_b <= 122;
          clpos = 0;
          cllen = d_b < 0xC0 ? 1 : d_b < 0xE0 ? 2 : 3;
          clxp = d_b < 0xC0 ? 0 : d_b < 0xE0 ? 1 : 2;
          clxv = d_b < 0xC0 ? (is_lo ? 32 : 0) : d_b < 0xE0 ? 32 : 5;
        }
        if (clpos == clxp) d_b ^= clxv;
        if (clpos + 1 >= cllen && op == 10) fdone = 1;
        clpos += 1;
      }
      O.put(s, (u32)d_b & 0xFFu);
    } else {
      const i32 off = in_pre ? poff + i : soff + (bi - bodyn);
      O.put(s, ldg(S.tfs + clip(off, 0, S.tfs_n - 1)));
    }
  }
}

// A distance beyond the window (JAX "finalize distance", dictionary half).
// Returns whether a word was written that keeps the lane in DICT rows.
template <class B>
BROTLI_HD bool dict_ref(State3& s, const Decode3Shared& S, B& O,
                        i32 distance, i32 max_dist) {
  if (!S.use_dict) {
    s.err |= ERR3_FAR_DIST;
    return false;
  }
  const i32 wlen = s.copy_len;
  i32 addr = distance - max_dist - 1;
  const bool too_big = distance > 0x7FFFFFFC;
  if (S.cd_t > 0) {
    // compound dictionary: the first cd_t addresses past the window,
    // counted from its end; a plain copy that pushes the distance ring
    if (!too_big && addr < S.cd_t) {
      const i32 cd_addr = S.cd_t - addr - 1;
      if (cd_addr + wlen > S.cd_t || wlen > s.mbl) {
        s.err |= ERR3_STREAM;
        return false;
      }
      push_ring(s, distance);
      s.mbl -= wlen;
      dict_bytes(s, S, O, true, wlen, 0, wlen, cd_addr, 0, 0, 0);
      return true;
    }
    addr -= S.cd_t;
  }
  // static dictionary word with one of the 121 transforms; no ring push
  const i32 shift = B::ld(S.consts + 160 + clip(wlen, 0, 31));
  if (too_big || wlen > 31 || wlen < 4 || shift == 0) {
    s.err |= ERR3_STREAM;
    return false;
  }
  const u32 sh = (u32)clip(shift, 0, 30);
  const i32 word_idx = addr & (i32)((1u << sh) - 1u);
  const i32 tfi = (i32)((u32)addr >> sh);
  if (tfi >= 121) {
    s.err |= ERR3_STREAM;
    return false;
  }
  const i32 meta1 = ldg(S.tfm + clip(2 * tfi, 0, TFM3_N - 1));
  const i32 meta2 = ldg(S.tfm + clip(2 * tfi + 1, 0, TFM3_N - 1));
  const i32 pre_off = meta1 >> 9, pre_len = (meta1 >> 5) & 15, op = meta1 & 31;
  const i32 suf_off = meta2 >> 4, suf_len = meta2 & 15;
  i32 omit_first = (op >= 12 && op <= 20) ? op - 11 : 0;
  if (omit_first > wlen) omit_first = wlen;
  const i32 omit_last = (op >= 1 && op <= 9) ? op : 0;
  i32 body = wlen - omit_first - omit_last;
  if (body < 0) body = 0;
  const i32 woff = B::ld(S.consts + 192 + clip(wlen, 0, 31)) + wlen * word_idx +
                   omit_first;
  const i32 total = pre_len + body + suf_len;
  if (total > s.mbl) {
    s.err |= ERR3_STREAM;
    return false;
  }
  s.mbl -= total;
  dict_bytes(s, S, O, false, total, pre_len, body, woff, pre_off, suf_off, op);
  return total > 0;
}

// Decode one lane and write its status.  B is the lane's backend: where
// its words come from, where its bytes go and how its copies read them,
// and how it loads tables (Direct3 and Ring3 below).
template <class B>
BROTLI_HD void decode3_run(const Decode3Shared& S, const Decode3Group& G,
                           const Decode3Lane& L, B& O) {
  const i32 start_bit = L.scal[0];
  const i32 mlen = L.scal[1 * L.sstride];
  const i32 pos0 = L.scal[5 * L.sstride];
  State3 s;
  s.phase = mlen > 0 ? P3_INIT : P3_DONE;
  s.widx = s.avail = s.wpos = 0;
  s.mbl = mlen;
  s.b0 = s.b1 = s.b2 = 0;
  s.lit_rem = s.copy_len = s.ins_code = s.cp_code = s.implicit = s.dcode = 0;
  for (int c = 0; c < 3; ++c) {
    s.blen[c] = L.scal[(2 + c) * L.sstride];
    s.bt[c] = 0;
    s.btp[c] = 1;
  }
  s.clo = B::ld(G.cmap + (G.lcmch + G.dcmch) * 128);
  s.p1 = L.scal[6 * L.sstride];
  s.p2 = L.scal[7 * L.sstride];
  s.r0 = L.scal[8 * L.sstride];
  s.r1 = L.scal[9 * L.sstride];
  s.r2 = L.scal[10 * L.sstride];
  s.r3 = L.scal[11 * L.sstride];
  s.bsw_cat = s.bsw_code = s.err = 0;

  // Hang guard, not a contract: an honest lane takes at most a few rows per
  // output byte plus about two refill stalls per word.
  const i64 budget = 8 * (i64)mlen + 4 * (i64)L.wpad + 64;
  for (i64 row = 0; s.phase < P3_DONE && s.err == 0; ++row) {
    if (row >= budget) {
      s.err |= ERR3_STREAM;
      break;
    }
    const bool need = s.avail <= 64 && s.widx < L.wpad;
    if (need) refill3(s, O.word(s));
    const bool run = s.avail >= 65 || (s.phase == P3_INIT && s.avail >= 32);
    if (!run) {
      if (need) continue;  // stall row: the buffer fills first
      s.err |= ERR3_STREAM;  // out of words: the lane can never step again
      break;
    }

    i32 q = 0;
    bool fin = false, tail_refill = false;
    i32 distance = 0;
    switch (s.phase) {
      case P3_INIT:
        q = start_bit;
        s.phase = P3_CMD;
        break;
      case P3_CMD: {
        if (block_switch3<1, B>(s, S, G, q)) break;
        s.blen[1] -= 1;
        i32 sym, nb;
        read_symbol3<B>(G.cmd, CCH3, G.nc, s.bt[1], pk(s, q) & 0x7FFFu, sym, nb);
        const i32 cell = sym >> 6;
        const i32 range_idx = cell < 2 ? cell : cell - 2;
        s.ins_code = (shr_sat(0x29850, 2 * range_idx) & 3) * 8 + ((sym >> 3) & 7);
        s.cp_code = (shr_sat(0x26244, 2 * range_idx) & 3) * 8 + (sym & 7);
        s.implicit = cell < 2 ? 1 : 0;
        const i32 ins_pack = B::ld(S.consts + (s.ins_code & 127));
        const i32 cp_pack = B::ld(S.consts + ((s.cp_code + 64) & 127));
        const i32 nb_i = ins_pack >> 20, off_i = ins_pack & 0xFFFFF;
        const i32 nb_c = cp_pack >> 20, off_c = cp_pack & 0xFFFFF;
        q += nb;
        const bool can_i = q + nb_i <= 32;
        if (can_i) {
          s.lit_rem = off_i + (i32)(pk(s, q) & 0xFFFFFFu & low_mask((u32)nb_i));
          q += nb_i;
        }
        const bool can_c = can_i && q + nb_c <= 32;
        if (can_c) {
          s.copy_len = off_c + (i32)(pk(s, q) & 0xFFFFFFu & low_mask((u32)nb_c));
          q += nb_c;
        }
        s.phase = !can_i ? P3_INS_EX
                  : !can_c ? P3_CP_EX
                  : s.lit_rem > 0 ? P3_LIT : P3_DIST;
        break;
      }
      case P3_INS_EX: {
        const i32 ins_pack = B::ld(S.consts + (s.ins_code & 127));
        const i32 cp_pack = B::ld(S.consts + ((s.cp_code + 64) & 127));
        const i32 nb_i = ins_pack >> 20, off_i = ins_pack & 0xFFFFF;
        const i32 nb_c = cp_pack >> 20, off_c = cp_pack & 0xFFFFF;
        s.lit_rem = off_i + (i32)(pk(s, q) & 0xFFFFFFu & low_mask((u32)nb_i));
        q += nb_i;
        const bool can_c = q + nb_c <= 32;
        if (can_c) {
          s.copy_len = off_c + (i32)(pk(s, q) & 0xFFFFFFu & low_mask((u32)nb_c));
          q += nb_c;
        }
        s.phase = !can_c ? P3_CP_EX : s.lit_rem > 0 ? P3_LIT : P3_DIST;
        break;
      }
      case P3_CP_EX: {
        const i32 cp_pack = B::ld(S.consts + ((s.cp_code + 64) & 127));
        const i32 nb_c = cp_pack >> 20, off_c = cp_pack & 0xFFFFF;
        s.copy_len = off_c + (i32)(pk(s, q) & 0xFFFFFFu & low_mask((u32)nb_c));
        q += nb_c;
        s.phase = s.lit_rem > 0 ? P3_LIT : P3_DIST;
        break;
      }
      case P3_BSW2: {
        const i32 pack = B::ld(S.consts + 128 + clip(s.bsw_code, 0, 25));
        const i32 nbx = pack >> 20, offx = pack & 0xFFFFF;
        const i32 v = offx + (i32)(pk(s, q) & 0xFFFFFFu & low_mask((u32)nbx));
        q += nbx;
        if (s.bsw_cat == 0) {
          s.blen[0] = v;
        } else if (s.bsw_cat == 1) {
          s.blen[1] = v;
        } else if (s.bsw_cat == 2) {
          s.blen[2] = v;
        }
        s.phase = s.bsw_cat == 0 ? P3_LIT : s.bsw_cat == 1 ? P3_CMD : P3_DIST;
        break;
      }
      case P3_LIT: {
        if (block_switch3<0, B>(s, S, G, q)) break;
        if (s.blen[0] <= 0) {
          // one block type and its length spent: the reference stalls this
          // lane for good (and flags it), so flag it now
          s.err |= ERR3_STREAM;
          break;
        }
        i32 sym0, nb0, sym1 = 0, nb1 = 0;
        read_symbol3<B>(G.lit, LCH3, G.nl, lit_tree<B>(s, S, G, s.p1, s.p2),
                     pk(s, q) & 0x7FFFu, sym0, nb0);
        q += nb0;
        const bool have2 = s.lit_rem >= 2 && s.mbl >= 2 && s.blen[0] >= 2;
        if (have2) {
          read_symbol3<B>(G.lit, LCH3, G.nl, lit_tree<B>(s, S, G, sym0, s.p1),
                       pk(s, q) & 0x7FFFu, sym1, nb1);
          q += nb1;
        }
        const i32 took = have2 ? 2 : 1;
        O.put(s, (u32)sym0 & 0xFFu);
        if (have2) O.put(s, (u32)sym1 & 0xFFu);
        s.blen[0] -= took;
        s.lit_rem -= took;
        s.mbl -= took;
        if (s.mbl <= 0) {
          s.phase = P3_DONE;
        } else if (s.lit_rem <= 0) {
          s.phase = P3_DIST;
        }
        break;
      }
      case P3_DIST: {
        const bool is_imp = s.implicit == 1;
        if (!is_imp && block_switch3<2, B>(s, S, G, q)) break;
        if (is_imp) {
          s.dcode = -1;
        } else {
          s.blen[2] -= 1;
          const i32 dctx = (s.copy_len < 5 ? s.copy_len : 5) - 2;
          const i32 tree = map_get<B>(G.cmap + G.lcmch * 128, G.dcmch,
                                   (s.bt[2] << 2) + dctx);
          i32 sym, nb;
          read_symbol3<B>(G.dist, DCH3, G.nd, tree, pk(s, q) & 0x7FFFu, sym, nb);
          q += nb;
          s.dcode = sym;
        }
        const i32 dcode = s.dcode;
        if (is_imp) {
          distance = s.r0;
        } else if (dcode >= 0 && dcode < 16) {
          const i32 sp = B::ld(S.consts + 96 + dcode);
          const i32 k_idx = sp >> 4;
          const i32 ring = k_idx == 0 ? s.r0 : k_idx == 1 ? s.r1
                           : k_idx == 2 ? s.r2 : s.r3;
          distance = add_wrap(ring, (sp & 15) - 3);
        } else if (dcode >= 16 && dcode < 16 + G.ndirect) {
          distance = dcode - 16 + 1;
        } else {  // long code: extra bits now if they fit, else spill a row
          const i32 dxp = B::ld(G.dx + clip(dcode, 0, DX3_N - 1));
          const i32 nbx = dxp >> 26, offx = dxp & 0x3FFFFFF;
          if (q + nbx > 32) {
            s.phase = P3_DIST_EX;
            break;
          }
          const u32 xv = pk(s, q) & 0xFFFFFFu & low_mask((u32)nbx);
          q += nbx;
          distance = add_wrap(offx, shl_wrap((i32)xv, G.npostfix));
        }
        fin = true;
        break;
      }
      case P3_DIST_EX: {
        const i32 dxp = B::ld(G.dx + clip(s.dcode, 0, DX3_N - 1));
        const i32 nbx = dxp >> 26, offx = dxp & 0x3FFFFFF;
        const u32 xv = pk(s, q) & 0xFFFFFFu & low_mask((u32)nbx);
        q += nbx;
        distance = add_wrap(offx, shl_wrap((i32)xv, G.npostfix));
        fin = true;
        break;
      }
      default:
        break;
    }

    if (fin) {
      // a completed distance: a copy inside the window (and the prefix),
      // else a dictionary word
      const i32 pos = pos0 + (mlen - s.mbl);
      const i32 max_dist = pos < G.maxbw ? pos : G.maxbw;
      if (distance > max_dist) {
        if (dict_ref(s, S, O, distance, max_dist)) tail_refill = s.mbl <= 0;
        if (s.err == 0) s.phase = s.mbl <= 0 ? P3_DONE : P3_CMD;
      } else if (distance < 1 || s.copy_len > s.mbl ||
                 (i64)L.hrb + s.wpos - distance < 0) {
        s.err |= ERR3_STREAM;
      } else {
        if (s.implicit != 1 && s.dcode > 0) push_ring(s, distance);
        O.copy(s, distance);
        s.mbl -= s.copy_len;
        s.phase = s.mbl <= 0 ? P3_DONE : P3_CMD;
      }
    }

    // ---- consume q bits ----
    const bool hi = (q >> 5) >= 1;
    const u32 c0 = hi ? s.b1 : s.b0, c1 = hi ? s.b2 : s.b1, c2 = hi ? 0u : s.b2;
    const u32 mq = (u32)(q & 31);
    s.b0 = funnel_r(c0, c1, mq);
    s.b1 = funnel_r(c1, c2, mq);
    s.b2 = c2 >> mq;
    s.avail -= q;
    // the reference's DICT rows of a word that ends the metablock
    if (tail_refill && s.avail <= 64 && s.widx < L.wpad) refill3(s, O.word(s));
  }

  O.finish(s);
  i32* st = L.status;
  const i64 ts = L.tstride;
  st[0 * ts] = s.err;
  st[1 * ts] = (s.wpos + 3) >> 2;
  st[2 * ts] = s.phase;
  st[3 * ts] = s.mbl;
  st[4 * ts] = s.widx;
  st[5 * ts] = s.avail;
  st[6 * ts] = s.r0;
  st[7 * ts] = s.r1;
  st[8 * ts] = s.r2;
  st[9 * ts] = s.r3;
  for (int r = 10; r < STATUS3_ROWS; ++r) st[r * ts] = 0;
}

// The direct backend (csrc/decode3.cu `decode3_direct_kernel`): words
// read one at a time when the row rule asks for them, each byte stored
// straight into the lane's slot, copies read back from the slot a byte at
// a time, tables through the read-only cache.
struct Direct3 {
  const Decode3Lane& L;
  template <typename T>
  BROTLI_HD static T ld(const T* p) { return ldg(p); }
  BROTLI_HD u32 word(const State3& s) const {
    return ldg(L.words + (i64)s.widx * L.wstride);
  }
  BROTLI_HD void put(State3& s, u32 b) const { put_byte(s, L, b); }
  BROTLI_HD void copy(State3& s, i32 distance) const {
    const u8* src = L.out + L.hrb - distance;
    for (i32 j = 0; j < s.copy_len; ++j) put_byte(s, L, src[s.wpos]);
  }
  BROTLI_HD void finish(const State3&) const {}
};

BROTLI_HD void decode3_lane(const Decode3Shared& S, const Decode3Group& G,
                            const Decode3Lane& L) {
  Direct3 O{L};
  decode3_run(S, G, L, O);
}

// The windowed backend (csrc/decode3.cu `decode3_kernel`).
//
// The lane's bytes land in a window of W bytes (a power of two >= 64; in
// shared memory on the card) that rings over the lane's slot: slot offset
// g sits at window byte (g + a0) & (W - 1), where a0 is the slot's address
// mod 16.  So a 16-byte-aligned run of the slot is an aligned run of the
// window, and each such chunk goes to the slot in one 16-byte store as
// soon as its last byte is written; runs shorter than a chunk (the slot's
// first and last, and the end of what a far copy finds written) go byte
// by byte.  `fl` is the slot offset up to which the slot holds the lane's
// bytes: its history prefix from the start, the metablock's as they are
// flushed.
//
// A copy reads the window when its distance is at most W - 16, and moves
// 8 bytes a step when the distance is 8 or more (the 8 bytes it reads are
// all written before it writes any); a shorter distance repeats the d
// bytes before the copy.  A copy from further back (past the window, into
// flushed output or the history prefix) first flushes every byte written,
// then reads the slot in global memory, 8 bytes a step: each byte it reads
// lies more than 48 bytes behind the next write, so in the flushed part.
// The window starts with the last W bytes of the history prefix.
//
// Words come through the lane's look-ahead queue (queue.cuh).  Tables
// are read with plain loads, from shared memory where the kernel staged
// them, else from global memory.
struct Ring3 {
  const Decode3Lane& L;
  WordQueue wq;
  u8* win;
  i32 wmask;  // W - 1
  i32 a0;
  i32 fl;

  template <typename T>
  BROTLI_HD static T ld(const T* p) { return *p; }

  BROTLI_HD u8& at(i32 g) { return win[(g + a0) & wmask]; }

  BROTLI_HD void start() {
    const i32 w = wmask + 1;
    for (i32 g = L.hrb > w ? L.hrb - w : 0; g < L.hrb; ++g) at(g) = L.out[g];
    fl = L.hrb;
    wq.start();
  }

  BROTLI_HD u32 word(const State3& s) { return wq.pop(s.widx); }

  // the bytes [fl, e) into the slot
  BROTLI_HD void flush_to(i32 e) {
    const i32 stride = L.hrb + L.out_cap;
    if (e > stride) e = stride;
    if (e <= fl) return;
    if (e - fl == 16 && ((fl + a0) & 15) == 0) {
#if defined(__CUDA_ARCH__)
      *(uint4*)(L.out + fl) = *(const uint4*)(win + ((fl + a0) & wmask));
#else
      for (i32 g = fl; g < e; ++g) L.out[g] = at(g);
#endif
    } else {
      for (i32 g = fl; g < e; ++g) L.out[g] = at(g);
    }
    fl = e;
  }

  // after writing up to slot offset e: flush through the last chunk
  // boundary at or before e
  BROTLI_HD void flushed(i32 e) { flush_to(e - ((e + a0) & 15)); }

  BROTLI_HD void put(State3& s, u32 b) {
    const i32 g = L.hrb + s.wpos;
    if (s.wpos < L.out_cap) at(g) = (u8)b;
    s.wpos += 1;
    s.p2 = s.p1;
    s.p1 = (i32)(b & 0xFFu);
    if (((g + 1 + a0) & 15) == 0) flush_to(g + 1);
  }

  // 8 bytes a step from `src(j)`, for a distance of 8 or more
  template <class Src>
  BROTLI_HD void copy8(i32 g0, i32 len, Src src) {
    for (i32 j = 0; j < len; j += 8) {
      const i32 n = len - j < 8 ? len - j : 8;
      u8 b[8];
#pragma unroll
      for (i32 k = 0; k < 8; ++k)
        if (k < n) b[k] = src(j + k);
#pragma unroll
      for (i32 k = 0; k < 8; ++k)
        if (k < n) at(g0 + j + k) = b[k];
      flushed(g0 + j + n);
    }
  }

  // the caller checked 1 <= distance <= hrb + wpos and copy_len <= mbl
  BROTLI_HD void copy(State3& s, i32 distance) {
    const i32 len = s.copy_len;
    if (len <= 0) return;
    const i32 g0 = L.hrb + s.wpos;
    const i32 src0 = g0 - distance;
    if (distance > wmask + 1 - 16) {
      flush_to(g0);
      const u8* out = L.out;
      copy8(g0, len, [&](i32 j) { return out[src0 + j]; });
    } else if (distance >= 8) {
      copy8(g0, len, [&](i32 j) { return at(src0 + j); });
    } else {
      u64 pat = 0;
      for (i32 k = 0; k < distance; ++k) pat |= (u64)at(src0 + k) << (8 * k);
      i32 k = 0;
      for (i32 j = 0; j < len; ++j) {
        at(g0 + j) = (u8)(pat >> (8 * k));
        k = k + 1 == distance ? 0 : k + 1;
        if (((g0 + j + 1 + a0) & 15) == 0) flush_to(g0 + j + 1);
      }
    }
    s.p2 = len >= 2 ? at(g0 + len - 2) : s.p1;
    s.p1 = at(g0 + len - 1);
    s.wpos += len;
  }

  BROTLI_HD void finish(const State3& s) {
    flush_to(L.hrb + s.wpos);
    wq.drain();
  }
};

BROTLI_HD void decode3_lane_windowed(const Decode3Shared& S,
                                     const Decode3Group& G,
                                     const Decode3Lane& L, Ring3& O) {
  O.start();
  decode3_run(S, G, L, O);
}

}  // namespace brotli_torch
