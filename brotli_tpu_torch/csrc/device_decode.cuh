// Per-lane logic of the per-lane-table decode: one stream that carries its
// own Huffman tables (a single compressed metablock, one block type and
// one tree a category) -> its bytes.  Replaces the lockstep
// `kernel` of brotli_tpu/ops/device_decode.py (`_build_kernel`, the
// jax.jit of lax.while_loops).
//
// The JAX kernel advances every lane of the batch one command, then one
// byte, a step, masking lanes that are done; a lane's result does not
// depend on the others, so here each lane runs its own command loop
// (dd_decode_lane) and the results are the same array for array:
//
// * a word read past the lane's own words gives 0 up to the batch's
//   max_words (the JAX words array is zero-padded per lane) and
//   0xFFFFFFFF past it (take_along_axis fills past the array's end);
// * a table read past the table's end gives INT32_MIN, its fill value;
// * bit positions are u32 and wrap (an INT32_MIN entry's length is
//   negative, so the position goes back);
// * bytes are written at clip(pos, 0, out_size - 1) and pos is not
//   clipped; a copy reads clip(pos - distance, 0, out_size - 1);
// * flags: distance < 1, distance > min(pos, max_backward) (a static-
//   dictionary reference), copy_len > the bytes left; an insert past the
//   bytes left is not flagged at the insert, but leaves the bytes left
//   negative, which the copy check then flags with a copy length of 0;
// * the ring starts [16, 15, 11, 4] at index 3 and takes only explicit
//   non-zero distance codes within max_distance.
//
// On the card a warp takes a lane (device_decode.cu): its 32 threads run
// the same serial decode, thread 0 stores the literals, and a copy is
// spread over the threads.  On the host (host_shim.cpp) the 32 threads of
// a copy run as a loop.
#pragma once

#include "common.cuh"

namespace brotli_torch {

// a lane's tables, one row: literal, command and distance Huffman tables
// (host format: 8-bit root, entries (nbits << 16) | sym), then the
// distance codes' extra bits and offsets (device_decode.py's padded sizes)
constexpr int DD_LIT_N = 630;
constexpr int DD_CMD_N = 1080;
constexpr int DD_DIST_N = 920;
constexpr int DD_DX_N = 544;
constexpr int DD_LIT_AT = 0;
constexpr int DD_CMD_AT = DD_LIT_AT + DD_LIT_N;
constexpr int DD_DIST_AT = DD_CMD_AT + DD_CMD_N;
constexpr int DD_DXE_AT = DD_DIST_AT + DD_DIST_N;
constexpr int DD_DXO_AT = DD_DXE_AT + DD_DX_N;
constexpr int DD_TAB_N = DD_DXO_AT + DD_DX_N;  // 3718 int32, 14,872 B

// a lane's scalars, one row: where its words start in the body, how many
// it has, the command loop's first bit, mlen, max_backward, npostfix
constexpr int DD_SCAL_N = 8;
enum DDScal : int { DD_AT = 0, DD_NWORDS, DD_BIT, DD_MLEN, DD_MAXBW,
                    DD_NPOSTFIX };

// the length and short-distance LUT (preflight2._build_consts' row):
// [0, 24) insert (nbits << 20) | offset, [64, 88) copy, [96, 112) short
// codes (ring index << 4) | (delta + 3)
constexpr int DD_CONSTS_N = 128;

constexpr u32 DD_WORD_FILL = 0xFFFFFFFFu;
constexpr i32 DD_TAB_FILL = INT32_MIN;

// The lane's bit stream, the last two words read kept (cw, c0, c1).
struct DDBits {
  const u32* words;
  i32 n_words, max_words;
  i32 cw;
  u32 c0, c1;

  BROTLI_HD u32 word(i32 w) const {
    if (w < n_words) return ldg(words + w);
    return w < max_words ? 0u : DD_WORD_FILL;
  }

  // 32 bits from bit `bitpos` (JAX `peek32`)
  BROTLI_HD u32 peek(u32 bitpos) {
    const i32 w = (i32)(bitpos >> 5);
    if (w != cw) {
      c0 = w == cw + 1 ? c1 : word(w);
      c1 = word(w + 1);
      cw = w;
    }
    return funnel_r(c0, c1, bitpos & 31u);
  }
};

// (1 << n) - 1 as XLA computes it for a u32 n: all ones from n = 32 on
BROTLI_HD u32 dd_mask(u32 n) { return n >= 32u ? 0xFFFFFFFFu : (1u << n) - 1u; }

// Two-level table read (JAX `read_symbol`): the symbol and its length,
// INT32_MIN for a second-level index past the table's end.
BROTLI_HD void dd_read_symbol(const i32* t, i32 n, u32 v, i32& sym, u32& nb) {
  const i32 e0 = t[v & 0xFFu];
  const i32 bits0 = e0 >> 16;
  if (bits0 <= 8) {
    sym = e0 & 0xFFFF;
    nb = (u32)bits0;
    return;
  }
  const u32 mask = (1u << (u32)(bits0 > 15 ? 15 : bits0)) - 1u;
  const u32 idx2 = (v & 0xFFu) + (u32)(e0 & 0xFFFF) + ((v & mask) >> 8);
  const i32 e1 = idx2 < (u32)n ? t[idx2] : DD_TAB_FILL;
  sym = e1 & 0xFFFF;
  nb = (u32)((e1 >> 16) + 8);
}

// One lane's inputs.  `tab` is the lane's table row, `consts` the LUT.
struct DDLane {
  DDBits bits;
  const i32* tab;
  const i32* consts;
  u32 bitpos;
  i32 mlen, max_backward, npostfix;
  u8* out;  // the lane's row of out_size bytes
  i32 out_size;
};

struct DDResult {
  i32 pos;
  bool err;
};

// Copy `len` bytes from `distance` back to `pos` in the lane's row.  The
// caller guarantees 1 <= distance <= pos and pos + len <= out_size, so the
// bytes repeat with period `distance` and byte j is the one at
// pos - distance + j % distance: every source lies before pos, so all
// threads copy at once, byte t, t + 32, ... each.
BROTLI_HD void dd_copy(u8* out, i32 pos, i32 distance, i32 len, int thread) {
  const u8* src = out + pos - distance;
#if defined(__CUDA_ARCH__)
  __syncwarp();  // thread 0's literals and the last copy are in place
  for (i32 j = thread; j < len; j += 32) out[pos + j] = src[j % distance];
  __syncwarp();
#else
  (void)thread;
  for (int t = 0; t < 32; ++t) {
    for (i32 j = t; j < len; j += 32) out[pos + j] = src[j % distance];
  }
#endif
}

// Decode one lane as the JAX kernel does; `thread` is the caller's thread
// of the warp (0 on the host): thread 0 stores the literals.
BROTLI_HD DDResult dd_decode_lane(DDLane L, int thread) {
  const i32* lit_t = L.tab + DD_LIT_AT;
  const i32* cmd_t = L.tab + DD_CMD_AT;
  const i32* dist_t = L.tab + DD_DIST_AT;
  const i32 last = L.out_size - 1;
  u32 bp = L.bitpos;
  i32 mbl = L.mlen, pos = 0;
  i32 ring[4] = {16, 15, 11, 4};
  i32 rb = 3;
  bool err = false;
  while (mbl > 0 && !err) {
    // ---- command: symbol, insert and copy extra bits ----
    i32 cmd;
    u32 nb;
    dd_read_symbol(cmd_t, DD_CMD_N, L.bits.peek(bp), cmd, nb);
    bp += nb;
    const i32 cell = cmd >> 6;
    const i32 range_idx = cell < 2 ? cell : cell - 2;
    const i32 ins_code =
        (shr_sat(0x29850, 2 * range_idx) & 3) * 8 + ((cmd >> 3) & 7);
    const i32 cp_code = (shr_sat(0x26244, 2 * range_idx) & 3) * 8 + (cmd & 7);
    const bool implicit = cell < 2;
    const i32 ins_pack = L.consts[ins_code & 127];
    const i32 cp_pack = L.consts[(cp_code + 64) & 127];
    u32 n = (u32)(ins_pack >> 20);
    const i32 insert_len =
        add_wrap(ins_pack & 0xFFFFF, (i32)(L.bits.peek(bp) & dd_mask(n)));
    bp += n;
    n = (u32)(cp_pack >> 20);
    const i32 copy_len =
        add_wrap(cp_pack & 0xFFFFF, (i32)(L.bits.peek(bp) & dd_mask(n)));
    bp += n;

    // ---- literals ----
    for (i32 k = 0; k < insert_len; ++k) {
      i32 sym;
      dd_read_symbol(lit_t, DD_LIT_N, L.bits.peek(bp), sym, nb);
      bp += nb;
      if (thread == 0) L.out[clip(pos, 0, last)] = (u8)sym;
      ++pos;
    }
    mbl -= insert_len;
    if (mbl <= 0) {
      err = mbl < 0;  // the copy check with a copy length of 0
      break;
    }

    // ---- distance ----
    i32 dcode = 0;
    if (!implicit) {
      dd_read_symbol(dist_t, DD_DIST_N, L.bits.peek(bp), dcode, nb);
      bp += nb;
    }
    i32 distance;
    if (implicit) {
      distance = ring[rb & 3];
    } else if (dcode < 16) {
      const i32 sc = L.consts[96 + dcode];
      distance = add_wrap(ring[(rb - (sc >> 4)) & 3], (sc & 15) - 3);
    } else {
      const i32 code = dcode < DD_DX_N ? dcode : DD_DX_N - 1;
      n = (u32)L.tab[DD_DXE_AT + code];
      const u32 ev = L.bits.peek(bp) & dd_mask(n);
      bp += n;
      distance = add_wrap(L.tab[DD_DXO_AT + code],
                          shl_wrap((i32)ev, L.npostfix));
    }
    const i32 max_distance = pos < L.max_backward ? pos : L.max_backward;
    if (!implicit && dcode > 0 && distance <= max_distance) {
      rb = (rb + 1) & 3;
      ring[rb] = distance;
    }
    if (distance < 1 || distance > max_distance || copy_len > mbl) {
      err = true;
      break;
    }

    // ---- copy ----
    dd_copy(L.out, pos, distance, copy_len, thread);
    pos += copy_len;
    mbl -= copy_len;
  }
  return DDResult{pos, err};
}

// The lane's inputs from the batch's arrays (device_decode.cu's layout).
BROTLI_HD DDLane dd_lane(const u32* body, const i32* scal, const i32* tab,
                         const i32* consts, u8* out, int max_words,
                         int out_size) {
  return DDLane{DDBits{body + scal[DD_AT], scal[DD_NWORDS], max_words, -2, 0u,
                       0u},
                tab, consts, (u32)scal[DD_BIT], scal[DD_MLEN],
                scal[DD_MAXBW], scal[DD_NPOSTFIX], out, out_size};
}

}  // namespace brotli_torch
