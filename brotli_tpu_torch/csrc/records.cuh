// Per-position logic of the device encoder's record builder: the command
// and distance codes of a copy start, the tail command, and the records of
// one row.  The CUDA kernel (csrc/records.cu) and its host build
// (csrc/host_shim.cpp) run these same functions over a lane's two scans.
//
// The block kernel and the host form split a lane into runs of REC_ITEMS
// positions (a thread's share of a tile) and walk each run with
// rec_run_max, rec_run_next and rec_run_rows below; the carries between
// runs are a running maximum and a component-wise minimum, both
// associative, so any grouping of the runs gives the same bits.
//
// The function is brotli_tpu/ops/device_encode.py `build_records` (an XLA
// stage: no `pallas_call`), as the plain PyTorch version
// `build_records_ref` in ops/device_encode.py computes it.  Per lane, with
// positions p < N and output rows 0..N (row p + 1 holds position p):
//
// * forward: cend = p + mlen at copy starts (-1 elsewhere), its running
//   maximum, and each copy's insert length p - max(running max at p - 1, 0);
// * per copy start: the insert and copy codes (the offset tables), their
//   extras, the command prefix (`rec_combine`, with the implicit
//   distance-0 rule), and the distance code: the parse's short code, else
//   the long code of mdist + 3 with its extra bits;
// * backward: for the prefix, the insert extra and the copy extra, the
//   minimum over copy starts at or after p of (p << 16) | payload, the
//   sentinel 0x7FFFFFFF where there is none;
// * rows: a distance record one row after its copy start (unless
//   implicit), the next command two rows after (the tail command of the
//   trailing literals when no copy follows), literals at literal
//   positions (with lit_ctx, the context ids of modes 2 and 3 at bits 14
//   and 20), row 0 the first command; n_records counts the rows that are
//   not padding.
#pragma once

#include "common.cuh"
#include "parse.cuh"

namespace brotli_torch {

constexpr i32 REC_K_PAD = 0, REC_K_CMD = 1, REC_K_LIT = 2, REC_K_DIST = 3;
constexpr i32 REC_BIG = 0x7FFFFFFF;
// The constant table the caller hands over (device_encode._records_table):
// the insert offsets, the copy offsets, and the literal context LUTs of
// modes 2 and 3 (512 entries each: previous byte, then 256 + the one
// before).
constexpr int REC_TAB_INS = 0, REC_TAB_COPY = 24, REC_TAB_CTX2 = 48,
              REC_TAB_CTX3 = 560, REC_TAB_N = 1072;

// max k with x >= off[k], counted as the plain version counts it
BROTLI_HD i32 rec_code(const i32* off, i32 x) {
  i32 c = 0;
  for (int k = 1; k < 24; ++k) c += x >= off[k];
  return c;
}

// The command prefix of an insert code and a copy code
// (device_encode.combine_length_codes).
BROTLI_HD i32 rec_combine(i32 ins_code, i32 cp_code, bool use_last) {
  const i32 bits64 = ((ins_code & 7) << 3) | (cp_code & 7);
  const i32 ih = ins_code >> 3, ch = cp_code >> 3;
  i32 cell = 0;
  if (ih == 0 && ch == 0) cell = 2;
  else if (ih == 0 && ch == 1) cell = 3;
  else if (ih == 1 && ch == 0) cell = 4;
  else if (ih == 1 && ch == 1) cell = 5;
  else if (ih == 0 && ch == 2) cell = 6;
  else if (ih == 2 && ch == 0) cell = 7;
  else if (ih == 1 && ch == 2) cell = 8;
  else if (ih == 2 && ch == 1) cell = 9;
  else if (ih == 2 && ch == 2) cell = 10;
  const bool implicit_ok = use_last && ins_code < 8 && cp_code < 16;
  if (implicit_ok) return cp_code < 8 ? bits64 : (bits64 | 64);
  return (cell << 6) | bits64;
}

// What a copy start contributes: its command's prefix code and extras,
// and its distance record.
struct RecCopy {
  i32 prefix, insval, cpval;
  bool dist_rec;  // a distance record follows (a copy, not implicit)
  i32 dcode, dval;
};

BROTLI_HD RecCopy rec_copy(const i32* tab, bool cs, i32 ins_len, i32 mlen,
                           i32 mdist, i32 dshort) {
  RecCopy r;
  const bool has_short = cs && dshort >= 0;
  const bool code0 = cs && dshort == 0;
  const i32 ins_code = rec_code(tab + REC_TAB_INS, ins_len);
  const i32 cp_code = rec_code(tab + REC_TAB_COPY, mlen);
  r.insval = ins_len - tab[REC_TAB_INS + ins_code];
  r.cpval = mlen - tab[REC_TAB_COPY + cp_code];
  r.prefix = rec_combine(ins_code, cp_code, code0);
  r.dist_rec = cs && !(code0 && ins_code < 8 && cp_code < 16);
  const i32 dd = mdist + 3;
  const i32 bucket = parse_ilog2(dd > 4 ? dd : 4) - 1;
  const i32 pre = (dd >> bucket) & 1;
  r.dcode = has_short ? dshort : 16 + 2 * (bucket - 1) + pre;
  r.dval = has_short ? 0 : dd - ((2 + pre) << bucket);
  return r;
}

// (q << 16) | payload in int32, the plain version's packing
BROTLI_HD i32 rec_pack(i32 q, i32 payload) {
  return (i32)(((u32)q << 16) | (u32)payload);
}

// The suffix minima at a position: the next copy start's packed prefix,
// insert extra and copy extra (REC_BIG where no copy starts at or after).
struct RecNext {
  i32 p, i, c;
};

BROTLI_HD RecNext rec_next_of(bool cs, i32 q, const RecCopy& r) {
  if (!cs) return RecNext{REC_BIG, REC_BIG, REC_BIG};
  return RecNext{rec_pack(q, r.prefix), rec_pack(q, r.insval),
                 rec_pack(q, r.cpval)};
}

BROTLI_HD RecNext rec_next_min(const RecNext& a, const RecNext& b) {
  return RecNext{a.p < b.p ? a.p : b.p, a.i < b.i ? a.i : b.i,
                 a.c < b.c ? a.c : b.c};
}

// The command of the trailing literals, from n_valid and the last copy's
// end (the running maximum at N - 1).
struct RecTail {
  i32 prefix, rec1;
  bool has;
};

BROTLI_HD RecTail rec_tail(const i32* tab, i32 nv, i32 cend_last) {
  const i32 n_lit = nv - (cend_last > 0 ? cend_last : 0);
  const i32 code = rec_code(tab + REC_TAB_INS, n_lit);
  return RecTail{rec_combine(code, 0, code < 8),
                 n_lit - tab[REC_TAB_INS + code], n_lit > 0};
}

// A command record's rec1 from the next copy's extras
BROTLI_HD i32 rec_cmd_extras(const RecNext& nx) {
  return (i32)(((u32)nx.i & 0xFFFFu) | (((u32)nx.c & 0xFFFFu) << 16));
}

// The literal code of position p: the byte d0, with lit_ctx the context
// ids of modes 2 and 3 from the bytes before it (d1 at p - 1, d2 at p - 2;
// 0 before the lane's start).
BROTLI_HD i32 rec_lit_code(const i32* tab, bool lit_ctx, i32 d0, i32 d1,
                           i32 d2) {
  if (!lit_ctx) return d0;
  const i32 c2 = tab[REC_TAB_CTX2 + d1] | tab[REC_TAB_CTX2 + 256 + d2];
  const i32 c3 = tab[REC_TAB_CTX3 + d1] | tab[REC_TAB_CTX3 + 256 + d2];
  return d0 | (c2 << 14) | (c3 << 20);
}

// The records of position p (row p + 1): cmd_slot = a copy starts at
// p - 2; prev = the copy data at p - 1 and nx the suffix minima there;
// lit = p is a literal, with its literal code.
BROTLI_HD void rec_row(bool cmd_slot, const RecCopy& prev, const RecNext& nx,
                       bool lit, i32 lit_code, const RecTail& t, i32& r0,
                       i32& r1) {
  const bool next_exists = nx.p != REC_BIG;
  i32 kind = REC_K_PAD, code = 0;
  r1 = 0;
  if (cmd_slot && (next_exists || t.has)) {
    kind = REC_K_CMD;
    code = next_exists ? (nx.p & 0xFFFF) : t.prefix;
    r1 = next_exists ? rec_cmd_extras(nx) : t.rec1;
  } else if (prev.dist_rec) {
    kind = REC_K_DIST;
    code = prev.dcode;
    r1 = prev.dval;
  } else if (lit) {
    kind = REC_K_LIT;
    code = lit_code;
  }
  r0 = kind == REC_K_PAD ? 0 : (i32)(((u32)kind << 28) | (u32)code);
}

// Row 0: the first command, from the suffix minima at position 0.
BROTLI_HD void rec_first(const RecNext& nx0, i32 nv, const RecTail& t,
                         i32& r0, i32& r1) {
  const bool first = nx0.p != REC_BIG;
  r0 = (first || nv > 0)
           ? (i32)(((u32)REC_K_CMD << 28) |
                   (u32)(first ? (nx0.p & 0xFFFF) : t.prefix))
           : 0;
  r1 = first ? rec_cmd_extras(nx0) : t.rec1;
}

// The copy data of a position that is no copy start (rows 0 and 1 have
// no distance slot).
BROTLI_HD RecCopy rec_no_copy() {
  return RecCopy{0, 0, 0, false, 0, 0};
}

// ---------------------------------------------------------------------------
// A run of REC_ITEMS positions [lo, lo + REC_ITEMS), clipped to the lane's
// n, read through an accessor `in` with cs(p), lit(p), byte(p), mlen(p),
// mdist(p) and dshort(p) at absolute positions (cs and byte of p = -1 are
// false and 0; lit and byte are read up to lo + REC_ITEMS, cs from lo - 1).
// A run's copy starts keep their copy data through keep.put(q, rc) until
// the run's rows read it back with keep.get(q).
// ---------------------------------------------------------------------------

constexpr int REC_ITEMS = 8;

BROTLI_HD i32 rec_max(i32 a, i32 b) { return a > b ? a : b; }

// The run's copy starts, bit k for position lo + k.
template <class In>
BROTLI_HD u32 rec_run_starts(const In& in, i32 lo, i32 n) {
  u32 m = 0;
#pragma unroll
  for (int k = 0; k < REC_ITEMS; ++k)
    if (lo + k < n && in.cs(lo + k)) m |= 1u << k;
  return m;
}

BROTLI_HD int rec_lowest(u32 m) {
#if defined(__CUDA_ARCH__)
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// The running maximum of copy ends (p + mlen at copy starts) after the
// run, from `carry` before it (-1: no copy yet).
template <class In>
BROTLI_HD i32 rec_run_max(const In& in, i32 lo, u32 starts, i32 carry) {
  for (u32 m = starts; m; m &= m - 1) {
    const i32 p = lo + rec_lowest(m);
    carry = rec_max(carry, p + in.mlen(p));
  }
  return carry;
}

// Each copy start's codes, its insert length from `prev` (the running
// maximum of copy ends before lo), kept through keep.put; returns the
// run's aggregate for the backward scan, the component-wise minimum of the
// packed payloads (REC_BIG where the run has no copy start).
template <class In, class Keep>
BROTLI_HD RecNext rec_run_copies(const i32* tab, const In& in, i32 lo,
                                 u32 starts, i32 prev, Keep& keep) {
  RecNext s{REC_BIG, REC_BIG, REC_BIG};
  for (u32 m = starts; m; m &= m - 1) {
    const i32 p = lo + rec_lowest(m);
    const i32 ml = in.mlen(p);
    const RecCopy rc = rec_copy(tab, true, p - rec_max(prev, 0), ml,
                                in.mdist(p), in.dshort(p));
    keep.put(p, rc);
    s = rec_next_min(s, rec_next_of(true, p, rc));
    prev = rec_max(prev, p + ml);
  }
  return s;
}

// The rows the run writes, through out.row(r, r0, r1): the row of q + 1
// for each position q of the run with q + 1 < n, and rows 0 and 1 from
// the run at 0.  s: the suffix minima past the run (at lo + REC_ITEMS);
// tail: the lane's tail command.  Returns how many of the rows are not
// padding.
template <class In, class Keep, class Out>
BROTLI_HD i32 rec_run_rows(const i32* tab, const In& in, i32 lo, i32 n,
                           u32 starts, RecNext s, const RecTail& tail,
                           bool lit_ctx, i32 nv, const Keep& keep, Out& out) {
  i32 count = 0;
#pragma unroll
  for (int k = REC_ITEMS - 1; k >= 0; --k) {
    const i32 q = lo + k;
    if (q >= n) continue;
    const bool cs = (starts >> k) & 1u;
    const RecCopy rc = cs ? keep.get(q) : rec_no_copy();
    s = rec_next_min(rec_next_of(cs, q, rc), s);
    i32 r0, r1;
    if (q + 1 < n) {
      const i32 p = q + 1;
      rec_row(q >= 1 && in.cs(q - 1), rc, s, in.lit(p),
              rec_lit_code(tab, lit_ctx, in.byte(p), in.byte(q),
                           in.byte(q - 1)),
              tail, r0, r1);
      out.row(p + 1, r0, r1);
      count += r0 != 0;
    }
    if (q == 0) {
      rec_row(false, rec_no_copy(), s, in.lit(0),
              rec_lit_code(tab, lit_ctx, in.byte(0), 0, 0), tail, r0, r1);
      out.row(1, r0, r1);
      count += r0 != 0;
      rec_first(s, nv, tail, r0, r1);
      out.row(0, r0, r1);
      count += r0 != 0;
    }
  }
  return count;
}

}  // namespace brotli_torch
