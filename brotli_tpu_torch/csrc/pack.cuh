// Per-lane bit packing of the device encoder: one lane's stream-ordered
// symbol records -> LSB-first u32 words.  Replaces the Pallas kernel
// brotli_tpu/ops/device_encode.py (_build_pack, `kernel` and its
// `row_body`).
//
// The TPU kernel advances 1024 lanes one record row at a time in (8, 128)
// vregs and, because it cannot scatter per lane, writes a word and a sort
// key on every row (KEY_PAD where nothing was emitted); a later sort
// compacts them.  Here each emitted word goes straight to its own index of
// the lane's column, so the body comes out compact.  The row is the JAX
// row: the block-switch word (block types > 1, flagged literals), the
// symbol code, extra 1 and extra 2 are appended to a 128-bit buffer, then
// at most ONE 32-bit word leaves it, and ovf is set once the buffer holds
// more than 80 bits.  So widx, avail, the tail limbs and ovf match the
// reference lane for lane.  Two ways compute it: `pack_lane` runs one
// lane's rows in sequence (the row machine); the segmented scan below
// computes every row's word index from prefix sums and minima, so that
// segments of a lane's rows can be packed apart.
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

// The scalar arguments both pack entry points (and their host shims) take.
inline bool pack_args_ok(const void* sw, const void* stype, int n_lanes,
                         int rows, int n_groups, int tab_n, int cmap_n, int nt,
                         int nbt, int pseg, int nseg) {
  return !(n_lanes <= 0 || rows < 0 || n_groups <= 0 || tab_n <= 0 ||
           cmap_n < 128 || nt < 1 || pseg <= 0 || nseg <= 0 ||
           (nbt > 1 && (sw == nullptr || stype == nullptr)));
}

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

// A lane's constants: its table group, context mode and map.
struct PackLaneCtx {
  i64 gbase;        // the group's first table entry
  const i32* cm;    // the group's context map
  i32 mode;         // 1: literal contexts are SIGNED (block types)
  bool grp_ok;      // the group exists
  bool signed_ctx;  // the group codes SIGNED contexts (ctx trees, no types)
};

BROTLI_HD PackLaneCtx pack_lane_ctx(const PackTables& T, const PackParams& P,
                                    i32 grpv) {
  const i32 grp = P.nbt > 1 ? (grpv & 0xFF) : grpv;
  // a group id outside the stack finds no tree and no code (entry 0), as
  // the JAX selects over g in range(n_groups) do
  const bool grp_ok = grp >= 0 && grp < T.n_groups;
  const i32* cm = T.cmap + (grp_ok ? (i64)grp * T.cmap_n : 0);
  return PackLaneCtx{(i64)grp * T.tab_n, cm, (grpv >> 8) & 1, grp_ok,
                     grp_ok && P.nt > 1 && P.nbt <= 1 &&
                         pack_load(cm + 127) > 0};
}

// What one record row appends, in order: the block-switch word (block
// types > 1, flagged literals), the symbol code, extra 1 and extra 2.
// nb is the count pack_append takes (it adds nb & 63 bits).
struct PackRow {
  u32 v[4], nb[4];
};

BROTLI_HD u32 pack_row_bits(const PackRow& x) {
  return (x.nb[0] & 63u) + (x.nb[1] & 63u) + (x.nb[2] & 63u) + (x.nb[3] & 63u);
}

// Row r of a lane: rec0/rec1 are its records; sw/stype point at the lane's
// element of segment 0 and step `stride` per segment (read when nbt > 1).
BROTLI_HD PackRow pack_row(const PackTables& T, const PackParams& P,
                           const PackLaneCtx& L, i32 r, i32 r0, i32 r1,
                           const i32* sw, const i32* stype, i64 stride) {
  const i64 tab_total = (i64)T.n_groups * T.tab_n;
  const i32 cmd_off = P.nt * 256;
  const i32 dist_off = P.nt * 256 + 704;
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
    const i32 cidx = btype * 64 + (L.mode > 0 ? ctx_s : ctx_u);
    const i32 tree = (L.grp_ok && cidx >= 0 && cidx < T.cmap_n)
                         ? pack_load(L.cm + cidx)
                         : 0;
    lit_idx = tree * 256 + (code & 0xFF);
  } else if (P.nt > 1) {
    const i32 tree =
        L.grp_ok ? pack_load(L.cm + ((L.signed_ctx ? ctx_s : ctx_u) & 127))
                 : 0;
    lit_idx = tree * 256 + (code & 0xFF);
  } else {
    lit_idx = code & 0xFF;
  }
  const i64 idx =
      live ? L.gbase + (is_cmd ? cmd_off + code
                               : (is_dist ? dist_off + code : lit_idx))
           : 0;
  const i32 ent = (idx >= 0 && idx < tab_total) ? pack_load(T.tab + idx) : 0;

  PackRow x{{0u, (u32)(ent & 0xFFFF), 0u, 0u},
            {0u, live ? (u32)(ent >> 16) : 0u, 0u, 0u}};
  if (is_cmd) {
    const i32 cell = code >> 6;
    const i32 ri = cell < 2 ? cell : cell - 2;
    const i32 s2 = 2 * ri;
    const i32 ins_hi = shr_sat(0x29850, s2) & 3;
    const i32 cp_hi = shr_sat(0x26244, s2) & 3;
    const i32 ins_code = ins_hi * 8 + ((code >> 3) & 7);
    const i32 cp_code = cp_hi * 8 + (code & 7);
    x.nb[2] = (u32)pack_load(T.consts + (ins_code & 127));
    x.nb[3] = (u32)pack_load(T.consts + ((cp_code + 64) & 127));
    x.v[2] = (u32)(r1 & 0xFFFF);
    x.v[3] = (u32)((r1 >> 16) & 0xFFFF);
  } else if (is_dist) {
    x.nb[2] = code >= 16 ? (u32)(((code - 16) >> 1) + 1) : 0u;
    x.v[2] = (u32)r1;
  }
  if (P.nbt > 1 && ((r0 >> 26) & 1)) {
    // the block switch that ends the previous block precedes this
    // literal: host-made pattern, nbits in the word's top 5 bits
    const u32 sww = (u32)pack_load(sw + (i64)seg * stride);
    x.v[0] = sww & 0x07FFFFFFu;
    x.nb[0] = sww >> 27;
  }
  return x;
}

// One lane, the row machine.  rec0/rec1/sw/stype point at the lane's
// element of row 0 and step n_lanes per row; words likewise.  sw/stype are
// read only when nbt > 1.  The serial kernel runs it for every lane, the
// segmented one for the lanes whose buffer overflowed.
BROTLI_HD PackResult pack_lane(const PackTables& T, const PackParams& P,
                               const i32* rec0, const i32* rec1, i32 grpv,
                               i32 init0, i32 initav, const i32* sw,
                               const i32* stype, i32* words) {
  const i64 stride = P.n_lanes;
  const PackLaneCtx L = pack_lane_ctx(T, P, grpv);
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
    const PackRow x = pack_row(T, P, L, r, r0, r1, sw, stype, stride);
    for (int k = 0; k < 4; ++k)
      pack_append(b0, b1, b2, b3, avail, x.v[k], x.nb[k]);
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

// ---------------------------------------------------------------------------
// The segmented scan.  A row's bits depend only on its own record; only its
// bit offset depends on the rows before it.  Let S_r be the lane's bits
// through row r (initav + n_0 + ... + n_r) and F_r = floor(S_r / 32).  The
// row machine emits a word on row r when S_r - 32 W_{r-1} >= 32, so while
// nothing is dropped the words emitted through row r are
//     W_r = min(W_{r-1} + 1, F_r) = r + min(1, min_{j <= r} (F_j - j)),
// a prefix minimum beside the prefix sum, and its words are the bit stream's
// words, whatever row emits them: word k is bits [32k, 32k + 32) of init0
// followed (at bit initav) by every row's pieces.  The lane overflows (ovf)
// at the first row with S_r - 32 W_r > 80; bits are dropped only at or
// after such a row, so the scan finds exactly the lanes the row machine
// flags, and those lanes run the row machine instead (pack_lane).
//
// Pass 1 (count) takes each segment of PACK_SEG rows alone: its bits x_j
// through its j-th row, and the minimum of floor((c + x_j) / 32) - j over
// its rows, which depends on the unknown start residue c = S mod 32 only
// through one step: it is A + [c >= Tm], with A the minimum of
// floor(x_j / 32) - j and Tm the largest 32 - (x_j mod 32) among the rows
// that reach A.  Pass 2 (scan) walks a lane's segments in order: each
// segment's start bit S and the prefix minimum M before it, then widx =
// W_last and avail.  Pass 3 (emit) re-walks every segment's rows from its
// start bit and writes its words; it checks each row for ovf.
// ---------------------------------------------------------------------------

constexpr i32 PACK_SEG = 256;            // record rows per segment
constexpr i32 PACK_NO_MIN = 0x3FFFFFFF;  // the minimum over no rows

struct PackSegCount {
  i32 bits;  // the segment's bits
  i32 a;     // min over its rows of floor(x_j / 32) - j
  i32 t;     // max of 32 - (x_j mod 32) over the rows that reach a
};

// A lane's rows [r_lo, r_hi); rec0/rec1 point at the lane's element of row
// 0 and step n_lanes per row.
BROTLI_HD PackSegCount pack_seg_count(const PackTables& T, const PackParams& P,
                                      const PackLaneCtx& L, i32 r_lo, i32 r_hi,
                                      const i32* rec0, const i32* rec1,
                                      const i32* sw, const i32* stype) {
  const i64 stride = P.n_lanes;
  i32 x = 0, a = PACK_NO_MIN, t = 0;
  for (i32 r = r_lo; r < r_hi; ++r) {
    const PackRow row =
        pack_row(T, P, L, r, pack_load(rec0 + (i64)r * stride),
                 pack_load(rec1 + (i64)r * stride), sw, stype, stride);
    x += (i32)pack_row_bits(row);
    const i32 aj = (x >> 5) - (r - r_lo);
    const i32 tj = 32 - (x & 31);
    if (aj < a) {
      a = aj;
      t = tj;
    } else if (aj == a && tj > t) {
      t = tj;
    }
  }
  return PackSegCount{x, a, t};
}

// The prefix minimum of F_j - j over a segment that starts at bit s and row
// r_lo, from its count.
BROTLI_HD i32 pack_seg_min(const PackSegCount& c, i32 s, i32 r_lo) {
  if (c.a == PACK_NO_MIN) return PACK_NO_MIN;
  return (s >> 5) + c.a + ((s & 31) >= c.t ? 1 : 0) - r_lo;
}

// W_last of a lane of `rows` rows whose prefix minimum over all rows is m.
BROTLI_HD i32 pack_widx(i32 rows, i32 m) {
  return rows > 0 ? rows - 1 + (m < 1 ? m : 1) : 0;
}

// Pass 3 for one segment: rows [r_lo, r_hi) of a lane, starting at bit s
// with prefix minimum m before them.  Word k of the stream goes to
// put(k, value, shared): words below widx to the body, the (at most three)
// words from widx on to the buffer limbs b0..b2.  `shared` marks a word
// that another segment (or init0) may also set: the segment's first word
// and its last, partial one; they must be ORed in, the others may be
// stored.  Returns whether a row overflowed the buffer.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class Put>
BROTLI_HD bool pack_seg_emit(const PackTables& T, const PackParams& P,
                             const PackLaneCtx& L, i32 r_lo, i32 r_hi,
                             const i32* rec0, const i32* rec1, const i32* sw,
                             const i32* stype, i32 s, i32 m, Put put) {
  const i64 stride = P.n_lanes;
  u64 acc = 0;           // bits from 32k on
  u32 fill = s & 31;     // bits in acc, those below s included (zero)
  i32 k = s >> 5;
  bool first = true;
  bool ovf = false;
  for (i32 r = r_lo; r < r_hi; ++r) {
    const PackRow row =
        pack_row(T, P, L, r, pack_load(rec0 + (i64)r * stride),
                 pack_load(rec1 + (i64)r * stride), sw, stype, stride);
    for (int q = 0; q < 4; ++q) {
      const u32 nbu = row.nb[q] & 63u;
      acc |= (u64)(row.v[q] & (u32)((1ull << nbu) - 1ull)) << fill;
      fill += nbu;
      while (fill >= 32u) {
        if ((u32)acc) put(k, (u32)acc, first);
        first = false;
        acc >>= 32;
        fill -= 32u;
        ++k;
      }
    }
    s += (i32)pack_row_bits(row);
    const i32 f = (s >> 5) - r;
    if (f < m) m = f;
    ovf |= s - 32 * (r + (m < 1 ? m : 1)) > 80;
  }
  if ((u32)acc) put(k, (u32)acc, true);
  return ovf;
}

// Pass 2 for one lane: its segments' counts -> each segment's start bit and
// the prefix minimum before it, in place (cnt rows 0 and 1; row 2 is
// free), then the lane's status: widx, avail, the limbs zero but for init0
// when no word leaves, ovf 0.  init0 goes to word 0 otherwise, stored
// before any segment ORs its bits in.  cnt is (3, nsegr, n_lanes) and
// points at the lane's element; status and words likewise.
BROTLI_HD void pack_scan_lane(i32* cnt, i32 nsegr, i64 n, i32 rows,
                              i32 init0, i32 initav, i32* status,
                              i32* words) {
  i32 s = initav, m = PACK_NO_MIN;
  for (i32 g = 0; g < nsegr; ++g) {
    i32* c = cnt + (i64)g * n;
    const PackSegCount sc{c[0], c[(i64)nsegr * n], c[2 * (i64)nsegr * n]};
    c[0] = s;
    c[(i64)nsegr * n] = m;
    const i32 mg = pack_seg_min(sc, s, g * PACK_SEG);
    if (mg < m) m = mg;
    s += sc.bits;
  }
  const i32 widx = pack_widx(rows, m);
  status[0] = widx;
  status[n] = s - 32 * widx;
  status[2 * n] = widx == 0 ? init0 : 0;
  status[3 * n] = 0;
  status[4 * n] = 0;
  status[5 * n] = 0;
  if (widx > 0) words[0] = init0;
}

}  // namespace brotli_torch
