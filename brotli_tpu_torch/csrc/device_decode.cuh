// Per-lane logic of the per-lane-table decode: one stream that carries its
// own Huffman tables (a single compressed metablock, one block type and
// one tree a category) -> its bytes.  Replaces the lockstep
// `kernel` of brotli_tpu/ops/device_decode.py (`_build_kernel`, the
// jax.jit of lax.while_loops).
//
// The JAX kernel advances every lane of the batch one command, then one
// byte, a step, masking lanes that are done; a lane's result does not
// depend on the others, so here each lane runs its own command loop and
// the results are the same array for array:
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
// Two forms, both a warp a lane whose 32 threads run the same serial
// decode (so every shared-memory read is a broadcast):
//
// * the direct form (dd_decode_lane, device_decode_direct_kernel, the
//   first design): the table row in shared memory, the words read from
//   device memory as the bit position crosses them, thread 0 storing the
//   literals to device memory, a copy read back from device memory;
// * the shared form (dd_decode_lane_shared, device_decode_kernel): the
//   lane's tables compacted into shared memory, its words in a ring there
//   (cp.async, the next half in flight while the lane decodes the other),
//   the words around the bit position in registers, and its output in a
//   window there that goes to device memory in 16-byte stores: as the
//   window wraps, and when the lane ends.  A copy is read from the window
//   (from device memory only where its source lies past the window).  A
//   lane whose tables or bits this form cannot take decodes by the
//   direct form.
//
// On the host (host_shim.cpp) a warp's 32 threads run as a loop
// (resolve.cuh `each`), and the window and ring take any power-of-two
// size, so small tests reach the wrap and refill paths.
#pragma once

#include "common.cuh"
#include "resolve.cuh"  // each, Lanes, ballot, sync_warp, copy16 (a warp's collectives)

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

// Phases of a lane and events counted in it, for the build with
// -DDD_PHASE_CLOCKS (tools/dd_phases.py): the leader thread adds the
// clock64() cycles since the last mark to the phase a mark names.  Word
// fetches are timed inside the phase that makes them and moved aside.
enum DDPhase : int { DD_PH_STAGE = 0, DD_PH_CMD, DD_PH_LIT, DD_PH_DIST,
                     DD_PH_COPY, DD_PH_WORDS, DD_PH_FLUSH, DD_PH_LITF,
                     DD_PHASES };
enum DDEvent : int { DD_EV_LIT = 0, DD_EV_CMD, DD_EV_COPY, DD_EV_COPY_BYTES,
                     DD_EV_MOVE, DD_EV_LITF, DD_EV_RESTART, DD_EVENTS };
#if defined(DD_PHASE_CLOCKS)
struct DDClock {
  long long sum[DD_PHASES];
  unsigned ev[DD_EVENTS];
  long long last;
  BROTLI_HD static long long tick() {
#if defined(__CUDA_ARCH__)
    return clock64();
#else
    return 0;
#endif
  }
  BROTLI_HD DDClock() {
    for (int k = 0; k < DD_PHASES; ++k) sum[k] = 0;
    for (int k = 0; k < DD_EVENTS; ++k) ev[k] = 0;
    last = tick();
  }
  BROTLI_HD void mark(int phase) {
    const long long now = tick();
    sum[phase] += now - last;
    last = now;
  }
  BROTLI_HD long long now() const { return tick(); }
  // the cycles since t0 go to `phase`, out of the running one
  BROTLI_HD void aside(int phase, long long t0) {
    const long long d = tick() - t0;
    sum[phase] += d;
    last += d;
  }
  BROTLI_HD void count(int e, i32 n = 1) { ev[e] += (unsigned)n; }
};
#else
struct DDClock {
  BROTLI_HD void mark(int) {}
  BROTLI_HD long long now() const { return 0; }
  BROTLI_HD void aside(int, long long) {}
  BROTLI_HD void count(int, i32 = 1) {}
};
#endif

// ---------------------------------------------------------------------
// The direct form: the table row in shared memory, words and bytes in
// device memory (device_decode_direct_kernel).
// ---------------------------------------------------------------------

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
  BROTLI_HD u32 peek(u32 bitpos, DDClock& clk) {
    const i32 w = (i32)(bitpos >> 5);
    if (w != cw) {
      const long long t0 = clk.now();
      c0 = w == cw + 1 ? c1 : word(w);
      c1 = word(w + 1);
      cw = w;
      const u32 v = funnel_r(c0, c1, bitpos & 31u);
      clk.aside(DD_PH_WORDS, t0);
      clk.count(DD_EV_MOVE);
      return v;
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
BROTLI_HD DDResult dd_decode_lane(DDLane L, int thread, DDClock& clk) {
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
    clk.count(DD_EV_CMD);
    i32 cmd;
    u32 nb;
    dd_read_symbol(cmd_t, DD_CMD_N, L.bits.peek(bp, clk), cmd, nb);
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
        add_wrap(ins_pack & 0xFFFFF, (i32)(L.bits.peek(bp, clk) & dd_mask(n)));
    bp += n;
    n = (u32)(cp_pack >> 20);
    const i32 copy_len =
        add_wrap(cp_pack & 0xFFFFF, (i32)(L.bits.peek(bp, clk) & dd_mask(n)));
    bp += n;
    clk.mark(DD_PH_CMD);

    // ---- literals ----
    for (i32 k = 0; k < insert_len; ++k) {
      i32 sym;
      dd_read_symbol(lit_t, DD_LIT_N, L.bits.peek(bp, clk), sym, nb);
      bp += nb;
      if (thread == 0) L.out[clip(pos, 0, last)] = (u8)sym;
      ++pos;
    }
    clk.count(DD_EV_LIT, insert_len);
    clk.mark(DD_PH_LIT);
    mbl -= insert_len;
    if (mbl <= 0) {
      err = mbl < 0;  // the copy check with a copy length of 0
      break;
    }

    // ---- distance ----
    i32 dcode = 0;
    if (!implicit) {
      dd_read_symbol(dist_t, DD_DIST_N, L.bits.peek(bp, clk), dcode, nb);
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
      const u32 ev = L.bits.peek(bp, clk) & dd_mask(n);
      bp += n;
      distance = add_wrap(L.tab[DD_DXO_AT + code],
                          shl_wrap((i32)ev, L.npostfix));
    }
    const i32 max_distance = pos < L.max_backward ? pos : L.max_backward;
    if (!implicit && dcode > 0 && distance <= max_distance) {
      rb = (rb + 1) & 3;
      ring[rb] = distance;
    }
    clk.mark(DD_PH_DIST);
    if (distance < 1 || distance > max_distance || copy_len > mbl) {
      err = true;
      break;
    }

    // ---- copy ----
    dd_copy(L.out, pos, distance, copy_len, thread);
    clk.count(DD_EV_COPY);
    clk.count(DD_EV_COPY_BYTES, copy_len);
    clk.mark(DD_PH_COPY);
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

// ---------------------------------------------------------------------
// The shared form: tables, words and output in shared memory
// (device_decode_kernel).
// ---------------------------------------------------------------------

// the widths of the one-level literal and command tables the fast path
// reads in one load (a sub-group takes 32 / DD_LIT_BITS literals, all
// within the bits one fill guarantees)
constexpr int DD_LIT_BITS = 10;
constexpr int DD_SPEC = 32 / DD_LIT_BITS;  // literals a sub-group
constexpr int DD_CMD_BITS = 10;

constexpr i32 DD_WIN_MIN = 64;   // smallest output window, bytes (a power of two)
// words a command may need past the reader: its symbols and extra bits
// (at most 23 + 24 + 24 + 23 + 24 bits), or a sub-group of literals of
// at most 23 bits each (read one by one), plus the word a fill reads
constexpr i32 DD_AHEAD = 6;
// smallest words ring, words (a power of two): a half holds DD_AHEAD
constexpr i32 DD_RING_MIN = 16;

// A lane's slice of shared memory: the three Huffman tables compacted to
// u16 (nbits << 12) | sym at their row offsets, the distance offsets as
// i32 and the extra bits as u8; the literal and command tables expanded
// to one level (dd_expand); then the words ring, then the window.
constexpr int DD_CTAB_BYTES = (2 * DD_DXE_AT + 15) / 16 * 16;  // 5,264
constexpr int DD_DXO_OFF = DD_CTAB_BYTES;
constexpr int DD_DXE_OFF = DD_DXO_OFF + 4 * DD_DX_N;
constexpr int DD_LIT1_OFF = (DD_DXE_OFF + DD_DX_N + 15) / 16 * 16;  // 7,984
constexpr int DD_CMD1_OFF = DD_LIT1_OFF + (2 << DD_LIT_BITS);
constexpr int DD_STAB_BYTES = DD_CMD1_OFF + (2 << DD_CMD_BITS);  // 12,080
// an expanded entry the fast path cannot take (the two-level read does):
// a command's top bit; a literal's bit 11, its length 0
constexpr u32 DD_LONG = 0x8000u;
constexpr u32 DD_LIT_LONG = 0x800u;

// the way a fast-path branch is expected to go, so that it falls through
#define DD_LIKELY(c) __builtin_expect(!!(c), 1)
#define DD_UNLIKELY(c) __builtin_expect(!!(c), 0)

BROTLI_HD int dd_slice_bytes(int ring_words, int win) {
  return DD_STAB_BYTES + 4 * ring_words + win;
}

// An entry the u16 form holds exactly: nbits in [0, 15], sym below 4096
// (every entry a preflight builds; the padding's 0 too).
BROTLI_HD bool dd_compactable(i32 e) {
  return (u32)e < (16u << 16) && (e & 0xF000) == 0;
}

// The two-level read of the compact table t (n entries) at the low
// DD_LIT_BITS or DD_CMD_BITS bits i: the symbol and its length, or false
// where the read needs more bits than `bits` or goes past the table.
BROTLI_HD bool dd_expand(const u16* t, i32 n, u32 i, u32 bits, u32& sym,
                         u32& nb) {
  const u32 e0 = t[i & 0xFFu];
  const u32 bits0 = e0 >> 12;
  if (bits0 <= 8) {
    sym = e0 & 0xFFFu;
    nb = bits0;
    return true;
  }
  if (bits0 > bits) return false;
  const u32 idx2 = (i & 0xFFu) + (e0 & 0xFFFu) + ((i & ((1u << bits0) - 1u)) >> 8);
  if (idx2 >= (u32)n) return false;
  const u32 e1 = t[idx2];
  sym = e1 & 0xFFFu;
  nb = (e1 >> 12) + 8;
  return true;
}

// A command symbol's insert and copy length codes and whether its
// distance is implicit, as dd_decode_lane computes them, packed:
// (implicit << 10) | (ins_code << 5) | cp_code.
BROTLI_HD u32 dd_cmd_codes(i32 cmd) {
  const i32 cell = cmd >> 6;
  const i32 range_idx = cell < 2 ? cell : cell - 2;
  const i32 ins_code =
      (shr_sat(0x29850, 2 * range_idx) & 3) * 8 + ((cmd >> 3) & 7);
  const i32 cp_code = (shr_sat(0x26244, 2 * range_idx) & 3) * 8 + (cmd & 7);
  return ((u32)(cell < 2) << 10) | ((u32)ins_code << 5) | (u32)cp_code;
}

// The lane's table row into its slice, the warp's threads on alternate
// entries; whether every entry fit the compact form (otherwise the lane
// reads its row where it lies).  Then the one-level tables from the
// compact ones: a literal entry (nb << 12) | sym, a command entry (nb <<
// 11) | dd_cmd_codes; DD_LIT_LONG or DD_LONG where the fast path needs
// the two-level read (a code longer than the width, a read past the
// table, a literal longer than DD_LIT_BITS or above 255, a command length
// above 15).
BROTLI_HD bool dd_stage_tables(const i32* row, u8* slice) {
  u16* ct = (u16*)slice;
  i32* dxo = (i32*)(slice + DD_DXO_OFF);
  u8* dxe = slice + DD_DXE_OFF;
  Lanes<bool> bad;
  each([&](int t) {
    bool ok = true;
#if defined(__CUDA_ARCH__)
#pragma unroll 8
#endif
    for (int i = t; i < DD_DXE_AT; i += WARP) {
      const i32 e = ldg(row + i);
      ok &= dd_compactable(e);
      ct[i] = (u16)((((u32)e >> 16) << 12) | ((u32)e & 0xFFFu));
    }
#if defined(__CUDA_ARCH__)
#pragma unroll 4
#endif
    for (int i = t; i < DD_DX_N; i += WARP) {
      const i32 x = ldg(row + DD_DXE_AT + i);
      ok &= (u32)x < 256u;
      dxe[i] = (u8)x;
      dxo[i] = ldg(row + DD_DXO_AT + i);
    }
    bad[t] = !ok;
  });
  sync_warp();
  u16* lit1 = (u16*)(slice + DD_LIT1_OFF);
  u16* cmd1 = (u16*)(slice + DD_CMD1_OFF);
  each([&](int t) {
    u32 sym, nb;
    for (u32 i = t; i < (1u << DD_LIT_BITS); i += WARP) {
      const bool one = dd_expand(ct + DD_LIT_AT, DD_LIT_N, i, DD_LIT_BITS,
                                 sym, nb);
      lit1[i] = (u16)(one && nb <= (u32)DD_LIT_BITS && sym < 256u
                          ? (nb << 12) | sym : DD_LIT_LONG);
    }
    for (u32 i = t; i < (1u << DD_CMD_BITS); i += WARP) {
      const bool one = dd_expand(ct + DD_CMD_AT, DD_CMD_N, i, DD_CMD_BITS,
                                 sym, nb);
      cmd1[i] = (u16)(one && nb <= 15u ? (nb << 11) | dd_cmd_codes((i32)sym)
                                       : DD_LONG);
    }
  });
  return ballot(bad) == 0u;
}

// The lane's words: a ring of R words in shared memory that holds words
// [vlo, vhi), word w in slot w & rmask; while `pend`, words [vhi, vhi +
// R/2) are in flight into the slots of the half behind the reader.  Past
// the lane's own words the ring holds the fill values.  The command loop
// keeps the words it may read in range (dd_keep), so a read is one
// shared-memory load.
struct DDRing {
  const u32* words;
  i32 n_words, max_words;
  u32* ring;
  i32 rmask;
  i32 vlo, vhi;
  bool pend;

  BROTLI_HD i32 half() const { return (rmask + 1) >> 1; }

  // words [a, a + n) into their slots, thread t word a + t, a + t + 32,
  // ...: cp.async for the lane's own words, the fill value past them
  BROTLI_HD void issue(i32 a, i32 n) {
    each([&](int t) {
      for (i32 i = t; i < n; i += WARP) {
        const i32 w = a + i;
        u32* dst = ring + (w & rmask);
        if (w < n_words) {
#if defined(__CUDA_ARCH__)
          __pipeline_memcpy_async(dst, words + w, sizeof(u32));
#else
          *dst = words[w];
#endif
        } else {
          *dst = w < max_words ? 0u : DD_WORD_FILL;
        }
      }
#if defined(__CUDA_ARCH__)
      __pipeline_commit();
#endif
    });
  }

  // every word issued has landed, for the whole warp
  BROTLI_HD void wait() {
#if defined(__CUDA_ARCH__)
    __pipeline_wait_prior(0);
#endif
    sync_warp();
  }

  // the reader is at word w: keep DD_AHEAD words past it in the ring
  // (waiting for the half in flight), and once it is a half past vlo,
  // send the next half into the slots behind it
  BROTLI_HD void advance(i32 w) {
    if (pend && w + DD_AHEAD > vhi) {
      wait();
      vhi += half();
      pend = false;
    }
    if (!pend && w >= vlo + half()) {
      vlo += half();
      issue(vhi, half());
      pend = true;
    }
  }
};

// The lane's bit buffer: bits [bp, bp + avail) of the stream in `buf`,
// lowest first, and widx the next word to append.  Words come from their
// ring slots unchecked: the bit position only moves forward, a length
// that would move it otherwise (an INT32_MIN entry, extra bits past 24)
// aborts the fast path instead.
struct DDBuf {
  DDRing r;
  u64 buf;
  i32 avail, widx;

  // the buffer from bit position p, whose two words are in the ring
  BROTLI_HD void start(u32 p) {
    const i32 w = (i32)(p >> 5);
    const u32 sh = p & 31u;
    const u64 two = (u64)r.ring[w & r.rmask] |
                    ((u64)r.ring[(w + 1) & r.rmask] << 32);
    buf = two >> sh;
    avail = 64 - (i32)sh;
    widx = w + 2;
  }

  // at least 32 bits, without a branch
  BROTLI_HD void fill() {
    const bool need = avail < 32;
    const u32 nxt = r.ring[widx & r.rmask];
    buf |= (u64)(need ? nxt : 0u) << (avail & 31);
    avail += need ? 32 : 0;
    widx += need ? 1 : 0;
  }

  BROTLI_HD u32 peek() const { return (u32)buf; }

  // n <= avail bits, n < 64
  BROTLI_HD void drop(i32 n) {
    buf >>= n;
    avail -= n;
  }
};

// The compact tables in shared memory.  sym() reads a symbol at the
// buffer's bits and drops its length (dd_read_symbol on the u16 entries,
// exact for entries that fit them); the buffer holds at least 8 bits on
// entry, and at least 32 after a second-level read.  A second-level index
// past the table's end (INT32_MIN, whose length takes the bit position
// back) drops nothing and sets `abort`.
struct DDCompactTabs {
  const u8* slice;

  BROTLI_HD i32 sym(int at, i32 n, DDBuf& R, bool& abort) const {
    const u16* t = (const u16*)slice + at;
    const i32 e0 = t[R.peek() & 0xFFu];
    const i32 bits0 = e0 >> 12;
    if (DD_LIKELY(bits0 <= 8)) {
      R.drop(bits0);
      return e0 & 0xFFF;
    }
    R.fill();
    const u32 v = R.peek();
    const u32 mask = (1u << (u32)bits0) - 1u;
    const u32 idx2 = (v & 0xFFu) + (u32)(e0 & 0xFFF) + ((v & mask) >> 8);
    i32 sym = 0;
    if (idx2 < (u32)n) {
      const i32 e1 = t[idx2];
      R.drop((e1 >> 12) + 8);
      sym = e1 & 0xFFF;
    } else {
      abort = true;
    }
    R.fill();
    return sym;
  }
  BROTLI_HD u32 extra(i32 code) const { return slice[DD_DXE_OFF + code]; }
  BROTLI_HD i32 offset(i32 code) const {
    return ((const i32*)(slice + DD_DXO_OFF))[code];
  }
  // the one-level tables (dd_stage_tables)
  BROTLI_HD u32 lit1(u32 v) const {
    return ((const u16*)(slice + DD_LIT1_OFF))[v & ((1u << DD_LIT_BITS) - 1u)];
  }
  BROTLI_HD u32 cmd1(u32 v) const {
    return ((const u16*)(slice + DD_CMD1_OFF))[v & ((1u << DD_CMD_BITS) - 1u)];
  }
};

// The lane's output: a window of W bytes in shared memory holding
// positions [flushed, flushed + W), byte p in slot (p + phase) & (W - 1)
// with `phase` the row's address mod 16, so the window goes to the row in
// aligned 16-byte stores.  Bytes [0, flushed) are in the row.
struct DDWindow {
  u8* win;
  i32 wmask;
  i32 phase;
  i32 flushed;
  u8* row;

  BROTLI_HD u8& at(i32 p) const { return win[(p + phase) & wmask]; }

  // bytes [flushed, lim) to the row: the head up to a 16-byte boundary
  // and the tail byte by byte, the rest 16 bytes a thread
  BROTLI_HD void flush(i32 lim) {
    const i32 a = flushed;
    const i32 to16 = (16 - ((a + phase) & 15)) & 15;
    const i32 head = lim < a + to16 ? lim : a + to16;
    const i32 down = lim - ((lim + phase) & 15);
    const i32 body = down > head ? down : head;
    each([&](int t) {
      for (i32 p = a + t; p < head; p += WARP) row[p] = at(p);
      for (i32 p = head + 16 * t; p < body; p += 16 * WARP)
        copy16(row + p, &at(p));
      for (i32 p = body + t; p < lim; p += WARP) row[p] = at(p);
    });
    if (lim > flushed) flushed = lim;
    sync_warp();
  }

  // flush every whole 16-byte chunk of the row below `pos`
  BROTLI_HD void flush_down(i32 pos) {
    const i32 lim = pos - ((pos + phase) & 15);
    if (lim > flushed) flush(lim);
  }

  // `len` bytes from `d` back to `pos` (1 <= d <= pos, pos + len within
  // the row): byte j is the one at pos - d + j % d, all before pos, so
  // the warp copies a piece at once, byte t, t + 32, ... a thread; a
  // piece ends where the window would overwrite a byte not yet in the
  // row.  A source the piece's writes would overwrite (below lo) was
  // flushed: it is read from the row.
  BROTLI_HD void copy(i32 pos, i32 d, i32 len) {
    const i32 W = wmask + 1;
    if (DD_LIKELY(len <= WARP && pos + len <= flushed + W && d + len <= W)) {
      // the common copy: one byte a thread, every source in the window
      if (d >= len) {
        each([&](int t) {
          if (t < len) at(pos + t) = at(pos - d + t);
        });
      } else {
        each([&](int t) {
          if (t < len) at(pos + t) = at(pos - d + t % d);
        });
      }
      sync_warp();
      return;
    }
    for (i32 done = 0; done < len;) {
      const i32 s = pos + done;
      if (s + (len - done) > flushed + W) flush_down(s);
      const i32 room = flushed + W - s;
      const i32 piece = len - done < room ? len - done : room;
      const i32 lo = s + piece - W;
      each([&](int t) {
        if (d >= len) {
          for (i32 k = t; k < piece; k += WARP) {
            const i32 q = s - d + k;
            at(s + k) = q >= lo ? at(q) : row[q];
          }
        } else {
          i32 r = (done + t) % d;  // (done + k) mod d, k = t, t + 32, ...
          const i32 step = WARP % d;
          for (i32 k = t; k < piece; k += WARP) {
            const i32 q = pos - d + r;
            at(s + k) = q >= lo ? at(q) : row[q];
            r += step;
            if (r >= d) r -= d;
          }
        }
      });
      sync_warp();
      done += piece;
    }
  }
};

// The distance ring in registers: slot i of four, i in [0, 3].
struct DDDist {
  i32 d0, d1, d2, d3;
  BROTLI_HD i32 get(i32 i) const {
    return i == 0 ? d0 : i == 1 ? d1 : i == 2 ? d2 : d3;
  }
  BROTLI_HD void set(i32 i, i32 v) {
    d0 = i == 0 ? v : d0;
    d1 = i == 1 ? v : d1;
    d2 = i == 2 ? v : d2;
    d3 = i == 3 ? v : d3;
  }
};

// The words a command or a literal sub-group may read are in the ring.
BROTLI_HD void dd_keep(DDBuf& R) {
  if (DD_UNLIKELY(R.widx + DD_AHEAD > R.r.vhi ||
                  R.widx >= R.r.vlo + R.r.half()))
    R.r.advance(R.widx);
}

// The shared form's command loop: dd_decode_lane's, with the tables in
// `T`, the bits from the buffer `R` and the bytes into the window `O`;
// the path of every well-formed lane.  Words come from the ring unchecked
// (dd_keep), every fill is branch-free and every length is dropped
// without a check, which holds while no length jumps (an INT32_MIN
// entry, extra bits past 24); at the first one it sets `abort` and stops,
// and the caller decodes the lane again by the direct form.  A command is one
// load of the one-level command table; an insert that lies inside the
// row and the window runs in sub-groups of up to DD_SPEC literals after
// one fill, each a load of the one-level literal table read without a
// branch (the sub-group's extra reads past the insert are dropped); a
// DD_LONG entry among them sends the sub-group back to the two-level
// read.  Each literal is stored by every thread (the same byte to the
// same slot).  Otherwise a literal at a time, clipped to the row,
// flushing the window as it wraps.
BROTLI_HD DDResult dd_decode_shared(const DDCompactTabs& T, DDBuf& R,
                                    DDWindow& O,
                                    const i32* consts, i32 mlen,
                                    i32 max_backward, i32 npostfix,
                                    i32 out_size, DDClock& clk, bool& abort) {
  const i32 last = out_size - 1;
  const i32 W = O.wmask + 1;
  i32 mbl = mlen, pos = 0;
  DDDist ring{16, 15, 11, 4};
  i32 rb = 3;
  bool err = false;
  // n extra bits: unchecked up to 24 (the most a valid table or the LUT
  // gives); more aborts
  auto extra_bits = [&](u32 n) -> u32 {
    R.fill();
    abort |= n > 24u;
    const u32 m = n > 24u ? 24u : n;
    const u32 v = R.peek() & ((1u << m) - 1u);
    R.drop((i32)m);
    return v;
  };
  while (mbl > 0 && !err) {
    // ---- command: symbol, insert and copy extra bits ----
    clk.count(DD_EV_CMD);
    dd_keep(R);
    R.fill();
    u32 codes;
    const u32 ce = T.cmd1(R.peek());
    if (DD_LIKELY(!(ce & DD_LONG))) {
      R.drop((i32)(ce >> 11));
      codes = ce & 0x7FFu;
    } else {
      codes = dd_cmd_codes(T.sym(DD_CMD_AT, DD_CMD_N, R, abort));
    }
    const bool implicit = (codes >> 10) & 1u;
    const i32 ins_pack = consts[(codes >> 5) & 31u];
    const i32 cp_pack = consts[64 + (codes & 31u)];
    const i32 insert_len =
        add_wrap(ins_pack & 0xFFFFF, (i32)extra_bits((u32)(ins_pack >> 20)));
    const i32 copy_len =
        add_wrap(cp_pack & 0xFFFFF, (i32)extra_bits((u32)(cp_pack >> 20)));
    clk.mark(DD_PH_CMD);
    if (DD_UNLIKELY(abort)) break;

    // ---- literals, into the window ----
    i32 k = 0;
    if (pos + insert_len <= out_size &&
        pos + insert_len <= O.flushed + W) {
      while (k < insert_len && !abort) {
        dd_keep(R);
        R.fill();
        const i32 c = insert_len - k < DD_SPEC ? insert_len - k : DD_SPEC;
        u64 b = R.buf;
        i32 a = R.avail;
        u32 e[DD_SPEC], flags = 0;
#pragma unroll
        for (int u = 0; u < DD_SPEC; ++u) {
          e[u] = T.lit1((u32)b);
          if (u < c) {  // predicated: the reads past the insert are dropped
            const u32 nb = e[u] >> 12;
            b >>= nb;
            a -= (i32)nb;
            flags |= e[u];
          }
        }
        if (DD_LIKELY(!(flags & DD_LIT_LONG))) {
          R.buf = b;  // at most DD_SPEC * DD_LIT_BITS <= 32 <= avail bits
          R.avail = a;
#pragma unroll
          for (int u = 0; u < DD_SPEC; ++u)
            if (u < c) O.at(pos + u) = (u8)e[u];
        } else {
          for (int u = 0; u < c; ++u) {
            R.fill();
            O.at(pos + u) = (u8)T.sym(DD_LIT_AT, DD_LIT_N, R, abort);
          }
        }
        pos += c;
        k += c;
      }
      clk.count(DD_EV_LITF, k);
      clk.mark(DD_PH_LITF);
    }
    for (; k < insert_len && !abort; ++k) {
      dd_keep(R);
      R.fill();
      const i32 sym = T.sym(DD_LIT_AT, DD_LIT_N, R, abort);
      const i32 p = pos < last ? pos : last;  // pos >= 0
      if (p - O.flushed >= W) O.flush_down(p);
      O.at(p) = (u8)sym;
      ++pos;
    }
    clk.count(DD_EV_LIT, insert_len);
    clk.mark(DD_PH_LIT);
    if (DD_UNLIKELY(abort)) break;
    mbl -= insert_len;
    if (mbl <= 0) {
      err = mbl < 0;  // the copy check with a copy length of 0
      break;
    }

    // ---- distance ----
    dd_keep(R);
    i32 dcode = 0;
    if (!implicit) {
      R.fill();
      dcode = T.sym(DD_DIST_AT, DD_DIST_N, R, abort);
    }
    i32 distance;
    if (implicit) {
      distance = ring.get(rb & 3);
    } else if (dcode < 16) {
      const i32 sc = consts[96 + dcode];
      distance = add_wrap(ring.get((rb - (sc >> 4)) & 3), (sc & 15) - 3);
    } else {
      const i32 code = dcode < DD_DX_N ? dcode : DD_DX_N - 1;
      const u32 ev = extra_bits(T.extra(code));
      distance = add_wrap(T.offset(code), shl_wrap((i32)ev, npostfix));
    }
    clk.mark(DD_PH_DIST);
    if (DD_UNLIKELY(abort)) break;
    const i32 max_distance = pos < max_backward ? pos : max_backward;
    if (!implicit && dcode > 0 && distance <= max_distance) {
      rb = (rb + 1) & 3;
      ring.set(rb, distance);
    }
    if (distance < 1 || distance > max_distance || copy_len > mbl) {
      err = true;
      break;
    }

    // ---- copy, within the window ----
    O.copy(pos, distance, copy_len);
    clk.count(DD_EV_COPY);
    clk.count(DD_EV_COPY_BYTES, copy_len);
    clk.mark(DD_PH_COPY);
    pos += copy_len;
    mbl -= copy_len;
  }
  return DDResult{pos, err};
}

// One lane of the shared form, by the whole warp: its words ring and
// table row staged into `slice` (dd_slice_bytes(rmask + 1, wmask + 1)
// bytes, 16-byte aligned), the decode, the window's last bytes to `out`.
// rmask + 1 >= DD_RING_MIN and wmask + 1 >= DD_WIN_MIN, powers of two.
// A lane the fast path cannot take (entries the compact tables do not
// hold, a first bit past the ring's first half, a length that jumps)
// decodes from its start by the direct form, on its row and words where
// they lie and straight into `out`: up to the jump both forms write the
// same bytes at the same positions, so the direct form writes again every
// byte the fast path flushed, and the window is dropped.
BROTLI_HD DDResult dd_decode_lane_shared(const u32* body, const i32* scal,
                                         const i32* tab, const i32* consts,
                                         u8* out, int max_words, int out_size,
                                         u8* slice, i32 rmask, i32 wmask,
                                         DDClock& clk) {
  const i32 R = rmask + 1;
  DDRing ring{body + scal[DD_AT], scal[DD_NWORDS], max_words,
              (u32*)(slice + DD_STAB_BYTES), rmask, 0, R, false};
  ring.issue(0, R);  // in flight while the tables load
  const bool compact = dd_stage_tables(tab, slice);
  ring.wait();
  const u32 start = (u32)scal[DD_BIT];
  bool abort = !compact || (i32)(start >> 5) + 2 + DD_AHEAD > R;
  DDBuf bits{ring, 0u, 0, 0};
  if (!abort) bits.start(start);
  clk.mark(DD_PH_STAGE);
  DDWindow win{slice + DD_STAB_BYTES + 4 * R, wmask,
               (i32)((uintptr_t)out & 15), 0, out};
  DDResult r{0, false};
  if (!abort) {
    r = dd_decode_shared(DDCompactTabs{slice}, bits, win, consts,
                         scal[DD_MLEN], scal[DD_MAXBW], scal[DD_NPOSTFIX],
                         out_size, clk, abort);
  }
  if (abort) {
    clk.count(DD_EV_RESTART);
#if defined(__CUDA_ARCH__)
    const int thread = (int)(threadIdx.x & 31);
#else
    const int thread = 0;  // the host's dd_copy runs the 32 threads itself
#endif
    r = dd_decode_lane(dd_lane(body, scal, tab, consts, out, max_words,
                               out_size),
                       thread, clk);
  } else {
    // every position below min(pos, out_size) was written
    win.flush(r.pos < out_size ? r.pos : out_size);
  }
  bits.r.wait();  // no word left in flight into the slice
  clk.mark(DD_PH_FLUSH);
  return r;
}

}  // namespace brotli_torch
