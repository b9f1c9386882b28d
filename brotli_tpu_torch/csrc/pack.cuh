// Per-lane bit packing of the device encoder: one lane's stream-ordered
// symbol records -> LSB-first u32 words.  Replaces the Pallas kernel
// brotli_tpu/ops/device_encode.py (_build_pack, `kernel` and its
// `row_body`).
//
// The TPU kernel advances 1024 lanes one record row at a time in (8, 128)
// vregs and, because it cannot scatter per lane, writes a word and a sort
// key on every row (KEY_PAD where nothing was emitted); a later sort
// compacts them.  Here one thread (or one host loop iteration) runs one
// lane's rows in sequence and writes each emitted word straight to its own
// index widx, so the body comes out compact.  The row is the JAX row: the
// block-switch word (block types > 1, flagged literals), the symbol code,
// extra 1 and extra 2 are appended to a 128-bit buffer, then at most ONE
// 32-bit word leaves it, and ovf is set once the buffer holds more than 80
// bits.  So widx, avail, the tail limbs and ovf match the reference lane
// for lane.
//
// Record format (device_encode.build_records):
//   rec0 = kind << 28 | code (bits 0-13), literal context ids at bits 14-19
//          (UTF8) and 20-25 (SIGNED), block-switch flag at bit 26;
//   rec1 = CMD: ins extra | copy extra << 16; DIST: distance extra.
#pragma once

#include "common.cuh"

namespace brotli_torch {

constexpr i32 REC_PAD = 0, REC_CMD = 1, REC_LIT = 2, REC_DIST = 3;

// Tables shared by all lanes.  tab is (n_groups, tab_n) flat: per group
// nt*256 literal entries, 704 command and 64 distance entries, each
// (nbits << 16) | bits.  cmap is (n_groups, cmap_n): with block types,
// entry btype*64 + ctx names the literal tree; otherwise entries 0-63 map
// the context and entry 127 is 1 when the group codes SIGNED contexts.
// consts[0:24] are the insert-length extra-bit counts, consts[64:88] the
// copy-length ones.
struct PackTables {
  const i32* tab;
  const i32* cmap;
  const i32* consts;
  i32 tab_n, cmap_n, n_groups;
};

struct PackParams {
  i32 nt;     // literal trees per group
  i32 nbt;    // literal block types (> 1: switch words and type map)
  i32 pseg;   // positions per block-type segment
  i32 nseg;   // segments per lane
  i32 rows;   // record rows per lane, padding included
  i32 n_lanes;
};

struct PackResult {
  u32 widx, avail, b0, b1, b2, ovf;
};

// Appends the low nb bits of v at bit `avail` of the buffer b0..b3.  The
// mask is built in 64 bits: XLA's `(1 << nb) - 1` is all ones for nb >= 32,
// where a 32-bit C++ shift is undefined.  Bits past the 128th are dropped,
// as the JAX append drops them.
BROTLI_HD void pack_append(u32& b0, u32& b1, u32& b2, u32& b3, u32& avail,
                           u32 v, u32 nb) {
  const u32 nbu = nb & 63u;
  v &= (u32)((1ull << nbu) - 1ull);
  const u32 sh = avail & 31u;
  const u32 limb = avail >> 5;
  const u32 lo = v << sh;
  const u32 hi = sh > 0 ? v >> ((32u - sh) & 31u) : 0u;
  if (limb == 0) {
    b0 |= lo;
    b1 |= hi;
  } else if (limb == 1) {
    b1 |= lo;
    b2 |= hi;
  } else if (limb == 2) {
    b2 |= lo;
    b3 |= hi;
  } else if (limb == 3) {
    b3 |= lo;
  }
  avail += nbu;
}

BROTLI_HD i32 pack_load(const i32* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

// One lane.  rec0/rec1/sw/stype point at the lane's element of row 0 and
// step n_lanes per row; words likewise.  sw/stype are read only when
// nbt > 1.
BROTLI_HD PackResult pack_lane(const PackTables& T, const PackParams& P,
                               const i32* rec0, const i32* rec1, i32 grpv,
                               i32 init0, i32 initav, const i32* sw,
                               const i32* stype, i32* words) {
  const i64 stride = P.n_lanes;
  const i32 grp = P.nbt > 1 ? (grpv & 0xFF) : grpv;
  const i32 mode = (grpv >> 8) & 1;
  const i64 gbase = (i64)grp * T.tab_n;
  const i64 tab_total = (i64)T.n_groups * T.tab_n;
  // a group id outside the stack finds no tree and no code (entry 0), as
  // the JAX selects over g in range(n_groups) do
  const bool grp_ok = grp >= 0 && grp < T.n_groups;
  const i32* cm = T.cmap + (grp_ok ? (i64)grp * T.cmap_n : 0);
  const i32 cmd_off = P.nt * 256;
  const i32 dist_off = P.nt * 256 + 704;
  // the group's SIGNED flag (context-mapped trees without block types)
  const bool signed_ctx =
      grp_ok && P.nt > 1 && P.nbt <= 1 && pack_load(cm + 127) > 0;

  u32 b0 = (u32)init0, b1 = 0, b2 = 0, b3 = 0;
  u32 avail = (u32)initav, widx = 0, ovf = 0;
  i32 n0 = P.rows > 0 ? pack_load(rec0) : 0;
  i32 n1 = P.rows > 0 ? pack_load(rec1) : 0;
  for (i32 r = 0; r < P.rows; ++r) {
    const i32 r0 = n0, r1 = n1;
    // the next row's records are loaded before this row's chain runs
    if (r + 1 < P.rows) {
      n0 = pack_load(rec0 + (i64)(r + 1) * stride);
      n1 = pack_load(rec1 + (i64)(r + 1) * stride);
    }
    const i32 kind = (r0 >> 28) & 0xF;
    const i32 code = r0 & 0x3FFF;
    const bool is_cmd = kind == REC_CMD;
    const bool is_dist = kind == REC_DIST;
    const bool live = kind != REC_PAD;
    const i32 ctx_u = (r0 >> 14) & 0x3F;
    const i32 ctx_s = (r0 >> 20) & 0x3F;

    i32 seg = 0;
    i32 lit_idx;
    if (P.nbt > 1) {
      seg = (r - 1 > 0 ? r - 1 : 0) / P.pseg;
      if (seg > P.nseg - 1) seg = P.nseg - 1;
      const i32 btype = pack_load(stype + (i64)seg * stride);
      const i32 cidx = btype * 64 + (mode > 0 ? ctx_s : ctx_u);
      const i32 tree = (grp_ok && cidx >= 0 && cidx < T.cmap_n)
                           ? pack_load(cm + cidx)
                           : 0;
      lit_idx = tree * 256 + (code & 0xFF);
    } else if (P.nt > 1) {
      const i32 tree =
          grp_ok ? pack_load(cm + ((signed_ctx ? ctx_s : ctx_u) & 127)) : 0;
      lit_idx = tree * 256 + (code & 0xFF);
    } else {
      lit_idx = code & 0xFF;
    }
    const i64 idx =
        live ? gbase + (is_cmd ? cmd_off + code
                               : (is_dist ? dist_off + code : lit_idx))
             : 0;
    const i32 ent = (idx >= 0 && idx < tab_total) ? pack_load(T.tab + idx) : 0;
    const u32 sym_nb = live ? (u32)(ent >> 16) : 0u;
    const u32 sym_bits = (u32)(ent & 0xFFFF);

    u32 ex1_nb = 0, ex1_v = 0, ex2_nb = 0, ex2_v = 0;
    if (is_cmd) {
      const i32 cell = code >> 6;
      const i32 ri = cell < 2 ? cell : cell - 2;
      const i32 s2 = 2 * ri;
      const i32 ins_hi = shr_sat(0x29850, s2) & 3;
      const i32 cp_hi = shr_sat(0x26244, s2) & 3;
      const i32 ins_code = ins_hi * 8 + ((code >> 3) & 7);
      const i32 cp_code = cp_hi * 8 + (code & 7);
      ex1_nb = (u32)pack_load(T.consts + (ins_code & 127));
      ex2_nb = (u32)pack_load(T.consts + ((cp_code + 64) & 127));
      ex1_v = (u32)(r1 & 0xFFFF);
      ex2_v = (u32)((r1 >> 16) & 0xFFFF);
    } else if (is_dist) {
      ex1_nb = code >= 16 ? (u32)(((code - 16) >> 1) + 1) : 0u;
      ex1_v = (u32)r1;
    }

    if (P.nbt > 1 && ((r0 >> 26) & 1)) {
      // the block switch that ends the previous block precedes this
      // literal: host-made pattern, nbits in the word's top 5 bits
      const u32 sww = (u32)pack_load(sw + (i64)seg * stride);
      pack_append(b0, b1, b2, b3, avail, sww & 0x07FFFFFFu, sww >> 27);
    }
    pack_append(b0, b1, b2, b3, avail, sym_bits, sym_nb);
    pack_append(b0, b1, b2, b3, avail, ex1_v, ex1_nb);
    pack_append(b0, b1, b2, b3, avail, ex2_v, ex2_nb);

    if (avail >= 32u) {
      words[(i64)widx * stride] = (i32)b0;
      b0 = b1;
      b1 = b2;
      b2 = b3;
      b3 = 0;
      avail -= 32u;
      widx += 1;
    }
    ovf |= avail > 80u ? 1u : 0u;
  }
  return PackResult{widx, avail, b0, b1, b2, ovf};
}

}  // namespace brotli_torch
