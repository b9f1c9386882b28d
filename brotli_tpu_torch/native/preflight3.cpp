// Batch host preflight of the v3 full-format decode, called by
// ops/preflight3_native.py: the C++ counterpart of ops/preflight3.py's
// preflight_one_v3 (per stream) and of the binning in assemble_v3, over a
// whole batch in one call.
//
// Built as a library of its own, never linked beside decoder.cpp's: it
// includes decoder.cpp for the host decoder's bit reader, Huffman table
// builder and MetablockState, which sit in that file's anonymous namespace.
// The tables it builds are the host decoder's, in the same flat
// (nbits << 16 | payload) layout as decode/engine.py's _MetablockState.
//
// A unit is either a stream, parsed from its first bit (window bits,
// ISLAST, ISEMPTY, MLEN: one compressed last metablock, as
// preflight_one_v3), or a (stream, bit) pair whose metablock tables start at
// that bit (the multi-metablock path, whose header walk is the second entry,
// brotli_v3_walk_batch).
// A unit within the caller's caps is binned by its tables alone.  Its key
// is the bin's GroupCfg and its tables in assemble_v3's padded chunk layout:
// every field of _sig_of except the initial block lengths (each lane's own
// scalars), plus the window's maxbw.  A 64-bit hash picks the candidate
// bins and memcmp confirms, so a hash collision never merges two table
// sets.  Bins are numbered in the order in which units first reach them,
// whatever the thread count.
//
// A third pair of entries, brotli_v3_plan and brotli_v3_fill, stage a batch
// in the port's own layout (ops/stage3_native.py): the same units, parse
// and bins, the lanes laid out as assemble_v3 lays them out in groups of a
// caller's width, and the batch written into one caller buffer (each lane's
// words one after another, the tables without the TPU's sublane
// replication, the config rows, the per-lane scalars).  There a thread
// remembers the table sections it parsed last: a unit whose section (the
// bits from its tables' first bit to its first command) equals one of
// them takes that parse, and is binned by one lookup.

#include "decoder.cpp"

#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>

namespace {

// chunks of 128 entries a table is padded to (ops/preflight3.py)
constexpr int LCH = 5;    // literal tree
constexpr int CCH = 9;    // command tree
constexpr int DCH = 8;    // distance tree
constexpr int BTCH = 6;   // block-type tree
constexpr int BLCH = 4;   // block-length tree
constexpr int DX_CHUNKS = 5;
constexpr int NCFG = 10;  // NL NC ND NBT0 NBT1 NBT2 npostfix ndirect maxbw
                          // trivial_lit
constexpr int UNIT_COLS = 8;  // status mlen cmd_start_bit maxbw blen0..2 bin
constexpr int WALK_COLS = 6;  // status mlen table_bit maxbw is_last copied
constexpr int CAPS_REFUSED = -99;
constexpr int SHAPE_REFUSED = -100;

struct Ctx {
  const uint8_t* data;
  const int64_t* offsets;
  const int64_t* lens;
  const int64_t* unit_stream;
  const int64_t* unit_bit;
  const int64_t* unit_maxbw;
  bool full;
  const int32_t* caps;  // block types, literal, command, distance trees
  Tables T;
  uint64_t hash_mask;
};

struct Parsed {
  int64_t out[UNIT_COLS - 1];  // status .. blen2
  std::vector<int32_t> key;    // cfg, then the padded tables
  uint64_t hash = 0;
};

// table `src` into `chunks` chunks of 128 at dst; false if it does not fit
bool pad_into(int32_t* dst, const std::vector<int32_t>& src, int chunks) {
  if (static_cast<int64_t>(src.size()) > chunks * 128) return false;
  if (!src.empty()) std::memcpy(dst, src.data(), src.size() * sizeof(int32_t));
  return true;
}

int lit_cmap_chunks(int nbt0) { return std::max(4, (nbt0 * 64 + 127) / 128); }
int dist_cmap_chunks(int nbt2) { return std::max(1, (nbt2 * 4 + 127) / 128); }

// cfg + tables in assemble_v3's order: literal trees, command trees,
// distance trees, block-switch trees (3 type, 3 length), context maps and
// modes, distance LUT.  Returns false where a table outgrows its chunks.
bool build_key(const MetablockState& st, int64_t maxbw,
               std::vector<int32_t>& key) {
  const int NL = static_cast<int>(st.lit_group.size());
  const int NC = static_cast<int>(st.cmd_group.size());
  const int ND = static_cast<int>(st.dist_group.size());
  const int lcm = lit_cmap_chunks(st.num_types[0]);
  const int dcm = dist_cmap_chunks(st.num_types[2]);
  const int64_t n = NCFG + 128ll * (NL * LCH + NC * CCH + ND * DCH +
                                    3 * BTCH + 3 * BLCH + lcm + dcm + 1 +
                                    DX_CHUNKS);
  key.assign(static_cast<size_t>(n), 0);
  int32_t* k = key.data();
  const int32_t cfg[NCFG] = {NL, NC, ND, st.num_types[0], st.num_types[1],
                             st.num_types[2], st.npostfix, st.ndirect,
                             static_cast<int32_t>(maxbw),
                             st.trivial_literal ? 1 : 0};
  std::memcpy(k, cfg, sizeof(cfg));
  k += NCFG;
  for (const auto& t : st.lit_group) {
    if (!pad_into(k, t, LCH)) return false;
    k += LCH * 128;
  }
  for (const auto& t : st.cmd_group) {
    if (!pad_into(k, t, CCH)) return false;
    k += CCH * 128;
  }
  for (const auto& t : st.dist_group) {
    if (!pad_into(k, t, DCH)) return false;
    k += DCH * 128;
  }
  for (int c = 0; c < 3; c++) {
    if (!pad_into(k, st.type_tables[c], BTCH)) return false;
    k += BTCH * 128;
  }
  for (int c = 0; c < 3; c++) {
    if (!pad_into(k, st.len_tables[c], BLCH)) return false;
    k += BLCH * 128;
  }
  for (size_t j = 0; j < st.cmap.size(); j++) k[j] = st.cmap[j];
  for (size_t j = 0; j < st.dist_cmap.size(); j++)
    k[lcm * 128 + j] = st.dist_cmap[j];
  for (int bt = 0; bt < st.num_types[0]; bt++)
    k[(lcm + dcm) * 128 + bt] = st.context_modes[bt] << 9;
  k += (lcm + dcm + 1) * 128;
  const size_t ndx = std::min<size_t>(DX_CHUNKS * 128, st.dist_extra.size());
  for (size_t j = 0; j < ndx; j++) {
    const int64_t v = (static_cast<int64_t>(st.dist_extra[j]) << 26) |
                      static_cast<int64_t>(st.dist_offset[j]);
    k[j] = static_cast<int32_t>(static_cast<uint32_t>(v));
  }
  return true;
}

uint64_t hash_key(const std::vector<int32_t>& key) {
  uint64_t h = 0x9E3779B97F4A7C15ull ^ key.size();
  for (int32_t v : key) {
    h ^= static_cast<uint32_t>(v);
    h *= 0xFF51AFD7ED558CCDull;
    h ^= h >> 32;
  }
  return h;
}

// window bits as decode/engine.py _decode_window_bits without the large
// window; -1 where the stream asks for one
int window_bits(BitReader& br, Err& e) {
  if (br.read(1, e) == 0) return 16;
  int n = br.read(3, e);
  if (n != 0) return 17 + n;
  n = br.read(3, e);
  if (n == 1) return -1;
  return n != 0 ? 8 + n : 17;
}

// runs work(tid) for tid in [0, n_threads) on as many threads
template <class F>
void on_threads(int n_threads, F&& work) {
  if (n_threads == 1) {
    work(0);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(n_threads));
  for (int t = 0; t < n_threads; t++) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
}

// The multi-metablock path's header walk, as the host decoder's loop
// (decoder.cpp brotli_native_decode): from bit `bit` of a stream (0: its
// first bit, the window bits first) to its next compressed metablock.
// Metadata is skipped; the bytes of uncompressed metablocks are copied to
// `copy` (at most cap bytes, which the stream's length bounds).
// out: status (1 = a compressed metablock, whose tables start at out[2];
// 0 = the stream ended; else the error code), its MLEN, the tables' bit,
// maxbw (read from the window bits when bit == 0, else 0), ISLAST, the
// bytes copied.
void walk_unit(const uint8_t* data, int64_t len, int64_t bit, uint8_t* copy,
               int64_t cap, int64_t* out) {
  for (int k = 0; k < WALK_COLS; k++) out[k] = 0;
  Err e;
  BitReader br(data, len);
  if (bit == 0) {
    const int wbits = window_bits(br, e);
    if (wbits < 0 || e.code) { out[0] = e.code ? e.code : -11; return; }
    out[3] = (1ll << wbits) - 16;
  } else {
    br.bitpos_ = bit;
  }
  int64_t copied = 0;
  while (true) {
    br.check_health(false, e);
    if (e.code) break;
    const bool input_end = br.read(1, e) != 0;
    if (input_end && br.read(1, e)) break;
    int64_t mbl;
    bool is_unc, is_meta;
    if (read_metablock_length(br, input_end, &mbl, &is_unc, &is_meta, e))
      break;
    if (is_meta || is_unc) {
      br.jump_to_byte_boundary(e);
      if (e.code) break;
      const uint8_t* src = br.copy_bytes(mbl, e);
      if (!src) break;
      if (is_unc) {
        if (copied + mbl > cap) { e.code = -10; break; }
        std::memcpy(copy + copied, src, static_cast<size_t>(mbl));
        copied += mbl;
      }
      if (input_end) break;
      continue;
    }
    if (mbl == 0) {
      if (input_end) break;
      continue;
    }
    out[0] = 1;
    out[1] = mbl;
    out[2] = br.bitpos_;
    out[4] = input_end ? 1 : 0;
    out[5] = copied;
    return;
  }
  out[0] = e.code;
  out[5] = copied;
}

void parse_unit(const Ctx& c, int64_t u, Parsed& p) {
  for (auto& v : p.out) v = 0;
  p.key.clear();
  const int64_t s = c.unit_stream[u];
  Err e;
  BitReader br(c.data + c.offsets[s], c.lens[s]);
  int64_t mlen = 0, maxbw;
  if (!c.full) {
    int wbits = window_bits(br, e);
    if (wbits < 0) { p.out[0] = -11; return; }
    bool input_end = br.read(1, e) != 0;
    if (input_end && br.read(1, e)) { p.out[0] = SHAPE_REFUSED; return; }
    bool is_unc, is_meta;
    if (read_metablock_length(br, input_end, &mlen, &is_unc, &is_meta, e) ||
        e.code) {
      p.out[0] = e.code ? e.code : -1;
      return;
    }
    if (is_meta || is_unc || mlen == 0 || !input_end) {
      p.out[0] = SHAPE_REFUSED;
      return;
    }
    maxbw = (1ll << wbits) - 16;
  } else {
    br.bitpos_ = c.unit_bit[u];
    maxbw = c.unit_maxbw[u];
  }
  MetablockState st;
  if (st.init(c.T, br, false, e) || e.code) {
    p.out[0] = e.code ? e.code : -1;
    return;
  }
  const int max_types =
      std::max(st.num_types[0], std::max(st.num_types[1], st.num_types[2]));
  if (max_types > c.caps[0] ||
      static_cast<int>(st.lit_group.size()) > c.caps[1] ||
      static_cast<int>(st.cmd_group.size()) > c.caps[2] ||
      static_cast<int>(st.dist_group.size()) > c.caps[3] ||
      !build_key(st, maxbw, p.key)) {
    p.key.clear();
    p.out[0] = CAPS_REFUSED;
    return;
  }
  p.hash = hash_key(p.key) & c.hash_mask;
  p.out[0] = 1;
  p.out[1] = mlen;
  p.out[2] = br.bitpos_;
  p.out[3] = maxbw;
  for (int k = 0; k < 3; k++)
    p.out[4 + k] = std::min<int64_t>(st.block_len[k], HUGE_BLOCK);
}

}  // namespace

extern "C" {

// Parses n_units units and bins those within caps.
//
// data: the streams; stream s is lens[s] bytes at data + offsets[s].
// unit_stream[u]: the unit's stream.  full == 0: each unit is its whole
// stream (unit_bit, unit_maxbw unused).  full != 0: unit u's metablock
// tables start at bit unit_bit[u], in a window of unit_maxbw[u].
// caps: most block types of a category, literal, command, distance trees.
// unit_out (n_units, 8) int64: status (1 = binned; else the error code,
// -99 over the caps, -100 another stream shape), mlen (0 when full),
// cmd_start_bit (the bit after the tables), maxbw, the three initial block
// lengths (capped at 1 << 28), bin (-1 when not binned).
// Returns the number of bins, or -1 when the bins' tables do not fit in
// pool_cap entries.  Only when it is at most max_bins are these written:
// bin_cfg (n_bins, 10) int32 (NL NC ND NBT0 NBT1 NBT2 npostfix ndirect
// maxbw trivial_lit), bin_off (n_bins + 1) int64 and pool, each bin's
// tables in assemble_v3's padded chunk layout one after the other (literal,
// command, distance, block-switch, context-map and distance-LUT chunks).
// hash_mask is and-ed into every key's hash (all ones in use; 0 makes every
// key collide).
int64_t brotli_v3_preflight_batch(
    const uint8_t* data, const int64_t* offsets, const int64_t* lens,
    const int64_t* unit_stream, const int64_t* unit_bit,
    const int64_t* unit_maxbw, int64_t n_units, int32_t full,
    const int32_t* caps, const int32_t* blen_nbits,
    const int32_t* blen_offset, const int32_t* clc_order,
    const int32_t* clc_lengths, int32_t n_threads, uint64_t hash_mask,
    int64_t* unit_out, int64_t max_bins, int32_t* bin_cfg, int64_t* bin_off,
    int32_t* pool, int64_t pool_cap) {
  Ctx c{data, offsets, lens, unit_stream, unit_bit, unit_maxbw, full != 0,
        caps,
        Tables{nullptr, nullptr, nullptr, nullptr, blen_nbits, blen_offset,
               nullptr, nullptr, clc_order, clc_lengths, nullptr, nullptr,
               nullptr, 0, nullptr, nullptr, nullptr, 0},
        hash_mask};
  if (n_threads < 1) n_threads = 1;
  // units are parsed a chunk at a time, in parallel, then binned in order,
  // so that at most one chunk's keys are held beside the bins'
  const int64_t chunk = 64ll * n_threads;
  std::vector<Parsed> parsed(static_cast<size_t>(std::min(chunk, n_units)));
  std::vector<std::vector<int32_t>> bins;
  std::unordered_map<uint64_t, std::vector<int64_t>> by_hash;
  for (int64_t base = 0; base < n_units; base += chunk) {
    const int64_t m = std::min(chunk, n_units - base);
    auto work = [&](int tid) {
      for (int64_t j = tid; j < m; j += n_threads)
        parse_unit(c, base + j, parsed[static_cast<size_t>(j)]);
    };
    on_threads(m == 1 ? 1 : n_threads, work);
    for (int64_t j = 0; j < m; j++) {
      Parsed& p = parsed[static_cast<size_t>(j)];
      int64_t* out = unit_out + (base + j) * UNIT_COLS;
      std::memcpy(out, p.out, sizeof(p.out));
      out[UNIT_COLS - 1] = -1;
      if (p.out[0] != 1) continue;
      auto& cands = by_hash[p.hash];
      int64_t bin = -1;
      for (int64_t b : cands) {
        const auto& k = bins[static_cast<size_t>(b)];
        if (k.size() == p.key.size() &&
            std::memcmp(k.data(), p.key.data(),
                        k.size() * sizeof(int32_t)) == 0) {
          bin = b;
          break;
        }
      }
      if (bin < 0) {
        bin = static_cast<int64_t>(bins.size());
        cands.push_back(bin);
        bins.push_back(std::move(p.key));
      }
      out[UNIT_COLS - 1] = bin;
    }
  }
  const int64_t n_bins = static_cast<int64_t>(bins.size());
  if (n_bins > max_bins) return n_bins;
  int64_t need = 0;
  for (const auto& k : bins) need += static_cast<int64_t>(k.size()) - NCFG;
  if (need > pool_cap) return -1;
  int64_t off = 0;
  for (int64_t b = 0; b < n_bins; b++) {
    const auto& k = bins[static_cast<size_t>(b)];
    std::memcpy(bin_cfg + b * NCFG, k.data(), NCFG * sizeof(int32_t));
    bin_off[b] = off;
    std::memcpy(pool + off, k.data() + NCFG,
                (k.size() - NCFG) * sizeof(int32_t));
    off += static_cast<int64_t>(k.size()) - NCFG;
  }
  bin_off[n_bins] = off;
  return n_bins;
}

// The multi-metablock path's header walk over n_units units: unit u walks
// stream unit_stream[u] from bit unit_bit[u] (0 = the stream's first bit)
// to its next compressed metablock (walk_unit above).  unit_out (n_units,
// 6) int64: status (1 = a compressed metablock; 0 = the stream ended; else
// the error code), MLEN, the bit at which its tables start, maxbw (when
// the walk began at bit 0), ISLAST, the bytes of uncompressed metablocks
// copied on the way, which go to copy_out + copy_off[u] (room for
// copy_off[u + 1] - copy_off[u] bytes).
void brotli_v3_walk_batch(const uint8_t* data, const int64_t* offsets,
                          const int64_t* lens, const int64_t* unit_stream,
                          const int64_t* unit_bit, int64_t n_units,
                          int32_t n_threads, int64_t* unit_out,
                          uint8_t* copy_out, const int64_t* copy_off) {
  if (n_threads < 1) n_threads = 1;
  on_threads(n_units < 2 ? 1 : n_threads, [&](int tid) {
    for (int64_t u = tid; u < n_units; u += n_threads) {
      const int64_t s = unit_stream[u];
      walk_unit(data + offsets[s], lens[s], unit_bit[u], copy_out + copy_off[u],
                copy_off[u + 1] - copy_off[u], unit_out + u * WALK_COLS);
    }
  });
}

}  // extern "C"

// ---- the native staging: brotli_v3_plan, brotli_v3_fill ----

namespace {

constexpr int SCAL_ROWS = 12;  // start bit, mlen, blen0..2, pos0, p1, p2,
                               // r0..r3 (ops/preflight3.py)
constexpr int CFG_ROW = 18;    // the port's config row (ops/decode3.py)
constexpr int BSW_N = (3 * BTCH + 3 * BLCH) * 128;
constexpr int DX_N = DX_CHUNKS * 128;
constexpr int SECTS = 16;      // table sections a thread remembers

// the plan's meta, in ops/stage3_native.py's order
enum { P_STATUS, P_BINS, P_GROUPS, P_SLOTS, P_WPAD, P_BODY, P_LIT, P_CMD,
       P_DIST, P_CMAP, P_MAX_MLEN, P_PARSES, P_N };
enum { ST_STAGED = 0, ST_NONE = 1, ST_OVER = 2 };
// where brotli_v3_fill writes each field (seg), in int32 units
enum { F_BODY, F_LIT, F_CMD, F_DIST, F_BSW, F_CMAP, F_DX, F_CFG, F_SCAL,
       F_LANE_AT, F_LANE_WORDS, F_N };

// 64 bits of a stream from bit `bit` on (zeros past its end)
inline uint64_t bits64_at(const uint8_t* p, int64_t len, int64_t bit) {
  const int64_t i = bit >> 3;
  const int sh = static_cast<int>(bit & 7);
  uint64_t lo = 0, hi = 0;
  if (i + 9 <= len) {
    std::memcpy(&lo, p + i, 8);
    hi = p[i + 8];
  } else {
    for (int k = 0; k < 8 && i + k < len; k++)
      lo |= static_cast<uint64_t>(p[i + k]) << (8 * k);
    if (i + 8 < len) hi = p[i + 8];
  }
  return sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
}

inline uint64_t low_bits(int64_t n) {
  return n >= 64 ? ~0ull : (1ull << n) - 1;
}

// One parse of a table section: from the tables' first bit to the first
// command.
struct Section {
  int32_t status = 0;         // 1, CAPS_REFUSED or the error code
  int64_t nbits = 0;          // the section's length
  int64_t blen[3] = {0, 0, 0};
  std::vector<int32_t> key;   // cfg (maxbw 0) + tables, until binned
  uint64_t hash = 0;
  int64_t table = -1;         // its table set
  std::vector<uint64_t> bits; // the section from bit 0, while remembered
};

// A thread's parses and the sections it remembers (indices into secs, the
// last one used first).
struct Worker {
  std::vector<Section> secs;
  std::vector<int64_t> recent;
};

// The call's table sets, shared by its threads: a key's hash picks the
// candidates and memcmp confirms.  Table ids follow the threads' timing;
// bins, numbered by units in order, do not.
struct TableSets {
  std::mutex mu;
  std::vector<std::vector<int32_t>> keys;
  std::unordered_map<uint64_t, std::vector<int64_t>> by_hash;

  int64_t find_or_add(std::vector<int32_t>& key, uint64_t hash) {
    std::lock_guard<std::mutex> lock(mu);
    auto& cands = by_hash[hash];
    for (int64_t t : cands) {
      const auto& k = keys[static_cast<size_t>(t)];
      if (k.size() == key.size() &&
          std::memcmp(k.data(), key.data(), k.size() * sizeof(int32_t)) == 0)
        return t;
    }
    cands.push_back(static_cast<int64_t>(keys.size()));
    keys.push_back(std::move(key));
    return cands.back();
  }
};

struct UnitPlan {
  int32_t status = 0;
  int64_t mlen = 0, table_bit = 0, maxbw = 0;
  int32_t worker = -1;
  int64_t sec = -1;
};

struct PlanCtx {
  const uint8_t* const* data;
  const int64_t* lens;
  const int64_t* unit_stream;
  const int64_t* unit_bit;
  const int64_t* unit_maxbw;
  bool full;
  const int32_t* caps;
  Tables T;
  uint64_t hash_mask;
};

bool section_equal(const uint8_t* p, int64_t len, int64_t tb,
                   const Section& r) {
  if (tb + r.nbits > 8 * len) return false;
  for (size_t k = 0; k < r.bits.size(); k++) {
    const int64_t left = r.nbits - 64 * static_cast<int64_t>(k);
    if (((bits64_at(p, len, tb + 64 * static_cast<int64_t>(k)) ^ r.bits[k]) &
         low_bits(left)) != 0)
      return false;
  }
  return true;
}

// the tables' parse at br.bitpos_, as parse_unit's
void parse_section(const PlanCtx& c, BitReader& br, Section& s) {
  const int64_t tb = br.bitpos_;
  Err e;
  MetablockState st;
  if (st.init(c.T, br, false, e) || e.code) {
    s.status = e.code ? e.code : -1;
    return;
  }
  const int max_types =
      std::max(st.num_types[0], std::max(st.num_types[1], st.num_types[2]));
  if (max_types > c.caps[0] ||
      static_cast<int>(st.lit_group.size()) > c.caps[1] ||
      static_cast<int>(st.cmd_group.size()) > c.caps[2] ||
      static_cast<int>(st.dist_group.size()) > c.caps[3] ||
      !build_key(st, 0, s.key)) {
    s.key.clear();
    s.status = CAPS_REFUSED;
    return;
  }
  s.status = 1;
  s.nbits = br.bitpos_ - tb;
  for (int k = 0; k < 3; k++)
    s.blen[k] = std::min<int64_t>(st.block_len[k], HUGE_BLOCK);
  s.hash = hash_key(s.key) & c.hash_mask;
}

// Unit u: its header (a whole stream) or its given bit, then its section,
// through a remembered one where the bits are equal; a new section's
// tables join the table sets.
void plan_unit(const PlanCtx& c, int64_t u, int32_t wid, Worker& w,
               TableSets& sets, UnitPlan& up) {
  up = UnitPlan{};
  const int64_t s = c.unit_stream[u];
  const uint8_t* p = c.data[s];
  const int64_t len = c.lens[s];
  int64_t tb;
  if (!c.full) {
    // the header takes fewer than 64 bits: a reader of 64 bytes at most
    // reads and refuses exactly as one of the whole stream
    Err e;
    BitReader br(p, std::min<int64_t>(len, 64));
    const int wbits = window_bits(br, e);
    if (wbits < 0) { up.status = -11; return; }
    const bool input_end = br.read(1, e) != 0;
    if (input_end && br.read(1, e)) { up.status = SHAPE_REFUSED; return; }
    bool is_unc, is_meta;
    if (read_metablock_length(br, input_end, &up.mlen, &is_unc, &is_meta,
                              e) ||
        e.code) {
      up.status = e.code ? e.code : -1;
      return;
    }
    if (is_meta || is_unc || up.mlen == 0 || !input_end) {
      up.status = SHAPE_REFUSED;
      return;
    }
    up.maxbw = (1ll << wbits) - 16;
    tb = br.bitpos_;
  } else {
    tb = c.unit_bit[u];
    up.maxbw = c.unit_maxbw[u];
  }
  up.table_bit = tb;
  up.worker = wid;
  for (size_t k = 0; k < w.recent.size(); k++) {
    const int64_t i = w.recent[k];
    if (section_equal(p, len, tb, w.secs[static_cast<size_t>(i)])) {
      std::rotate(w.recent.begin(), w.recent.begin() + k,
                  w.recent.begin() + k + 1);
      up.status = 1;
      up.sec = i;
      return;
    }
  }
  Section sec;
  BitReader br(p, len);
  br.bitpos_ = tb;
  parse_section(c, br, sec);
  up.status = sec.status;
  if (sec.status != 1) return;
  sec.table = sets.find_or_add(sec.key, sec.hash);
  sec.key.clear();
  sec.key.shrink_to_fit();
  sec.bits.resize(static_cast<size_t>((sec.nbits + 63) >> 6));
  for (size_t k = 0; k < sec.bits.size(); k++)
    sec.bits[k] = bits64_at(p, len, tb + 64 * static_cast<int64_t>(k));
  up.sec = static_cast<int64_t>(w.secs.size());
  w.secs.push_back(std::move(sec));
  w.recent.insert(w.recent.begin(), up.sec);
  if (static_cast<int>(w.recent.size()) > SECTS) {
    w.secs[static_cast<size_t>(w.recent.back())].bits.clear();
    w.secs[static_cast<size_t>(w.recent.back())].bits.shrink_to_fit();
    w.recent.pop_back();
  }
}

struct Plan {
  int64_t n_units = 0, width = 0, G = 0, n_slots = 0;
  std::vector<std::vector<int32_t>> tables;  // each table set's key
  std::vector<int64_t> bin_table, bin_maxbw;
  std::vector<int64_t> group_bin;
  // per unit: its section's initial block lengths (units that binned)
  std::vector<int64_t> unit_blen;
  // per slot
  std::vector<int64_t> slot_unit, slot_w0, slot_mlen, slot_bit, lane_at;
  std::vector<int32_t> slot_words, lane_words;
};

}  // namespace

extern "C" {

// Parses and bins n_units units as brotli_v3_preflight_batch does (the same
// unit statuses, keys and first-seen bins), reading stream s at data[s]
// (lens[s] bytes), and lays out the binned units as assemble_v3: each bin
// stably sorted on mlen / (4 * its stream's padded words), cut into groups
// of `width` lanes.  unit_mlen[u]: the unit's MLEN when full != 0 (the
// header's otherwise).  A thread reuses the parse of a section it
// remembers when the unit's section bits equal it.  unit_out (n_units,
// 8): brotli_v3_preflight_batch's columns (bin -1 where the plan stops
// early).  meta[P_N]: status (0 staged; 1 none: no unit binned, or a
// whole-stream unit was refused; 2 over: more than max_lanes lanes), bins,
// groups, slots, Wpad (the lanes' most words rounded up to D, plus D), the
// lanes' words, the literal, command, distance and map tables' entries,
// the largest MLEN, the sections parsed.  Returns the plan (free it with
// brotli_v3_free), or null where status is not 0.
void* brotli_v3_plan(
    const uint8_t* const* data, const int64_t* lens,
    const int64_t* unit_stream, const int64_t* unit_bit,
    const int64_t* unit_maxbw, const int64_t* unit_mlen, int64_t n_units,
    int32_t full, const int32_t* caps, const int32_t* blen_nbits,
    const int32_t* blen_offset, const int32_t* clc_order,
    const int32_t* clc_lengths, int32_t n_threads, uint64_t hash_mask,
    int64_t width, int64_t max_lanes, int64_t D,
    int64_t* meta, int64_t* unit_out) {
  for (int k = 0; k < P_N; k++) meta[k] = 0;
  meta[P_STATUS] = ST_NONE;
  for (int64_t u = 0; u < n_units; u++) {
    for (int k = 0; k < UNIT_COLS; k++) unit_out[u * UNIT_COLS + k] = 0;
    unit_out[u * UNIT_COLS + UNIT_COLS - 1] = -1;
  }
  if (n_units < 1 || width < 1 || D < 1) return nullptr;
  const PlanCtx ctx{data, lens, unit_stream, unit_bit, unit_maxbw, full != 0,
                    caps,
                    Tables{nullptr, nullptr, nullptr, nullptr, blen_nbits,
                           blen_offset, nullptr, nullptr, clc_order,
                           clc_lengths, nullptr, nullptr, nullptr, 0, nullptr,
                           nullptr, nullptr, 0},
                    hash_mask};
  if (n_threads < 1) n_threads = 1;
  // each thread one run of units (threads start once a call: on the
  // H100's host a thread's start costs more than most units' parse)
  const int threads = static_cast<int>(
      std::min<int64_t>(n_threads, (n_units + 255) / 256));
  const int64_t per = (n_units + threads - 1) / threads;
  std::vector<Worker> workers(static_cast<size_t>(threads));
  std::vector<UnitPlan> ups(static_cast<size_t>(n_units));
  TableSets sets;
  on_threads(threads, [&](int t) {
    const int64_t end = std::min(n_units, (t + 1) * per);
    for (int64_t u = t * per; u < end; u++)
      plan_unit(ctx, u, t, workers[static_cast<size_t>(t)], sets,
                ups[static_cast<size_t>(u)]);
  });
  auto plan = std::make_unique<Plan>();
  Plan& P = *plan;
  P.n_units = n_units;
  P.width = width;
  P.tables = std::move(sets.keys);
  P.unit_blen.assign(static_cast<size_t>(3 * n_units), 0);
  for (const auto& w : workers)
    meta[P_PARSES] += static_cast<int64_t>(w.secs.size());
  // units in order: a bin a (table set, window), numbered as first seen
  std::unordered_map<int64_t, std::vector<int64_t>> bins_of_table;
  std::vector<int64_t> unit_bin(static_cast<size_t>(n_units), -1);
  bool any_refused = false;
  for (int64_t u = 0; u < n_units; u++) {
    const UnitPlan& up = ups[static_cast<size_t>(u)];
    int64_t* out = unit_out + u * UNIT_COLS;
    out[0] = up.status;
    if (up.status != 1) {
      any_refused = true;
      continue;
    }
    const Section& sec = workers[static_cast<size_t>(up.worker)]
                             .secs[static_cast<size_t>(up.sec)];
    out[1] = full ? 0 : up.mlen;
    out[2] = up.table_bit + sec.nbits;
    out[3] = up.maxbw;
    for (int k = 0; k < 3; k++) {
      out[4 + k] = sec.blen[k];
      P.unit_blen[static_cast<size_t>(3 * u + k)] = sec.blen[k];
    }
    auto& cands = bins_of_table[sec.table];
    int64_t bin = -1;
    for (int64_t b : cands)
      if (P.bin_maxbw[static_cast<size_t>(b)] == up.maxbw) {
        bin = b;
        break;
      }
    if (bin < 0) {
      bin = static_cast<int64_t>(P.bin_table.size());
      cands.push_back(bin);
      P.bin_table.push_back(sec.table);
      P.bin_maxbw.push_back(up.maxbw);
      // every bin takes a group at least
      if (static_cast<int64_t>(P.bin_table.size()) * width > max_lanes) {
        meta[P_BINS] = static_cast<int64_t>(P.bin_table.size());
        meta[P_STATUS] = ST_OVER;
        return nullptr;
      }
    }
    out[UNIT_COLS - 1] = bin;
    unit_bin[static_cast<size_t>(u)] = bin;
  }
  const int64_t n_bins = static_cast<int64_t>(P.bin_table.size());
  meta[P_BINS] = n_bins;
  if (n_bins == 0 || (!full && any_refused)) return nullptr;

  // each bin's units, stably sorted on mlen / (4 * padded words)
  std::vector<std::vector<int64_t>> members(static_cast<size_t>(n_bins));
  std::vector<double> ratio(static_cast<size_t>(n_units), 0.0);
  auto mlen_of = [&](int64_t u) {
    return full ? unit_mlen[u] : ups[static_cast<size_t>(u)].mlen;
  };
  auto padded_words = [&](int64_t u) {
    return (lens[unit_stream[u]] + 3) / 4 + 3;
  };
  for (int64_t u = 0; u < n_units; u++) {
    const int64_t b = unit_bin[static_cast<size_t>(u)];
    if (b < 0) continue;
    members[static_cast<size_t>(b)].push_back(u);
    ratio[static_cast<size_t>(u)] =
        static_cast<double>(mlen_of(u)) /
        static_cast<double>(std::max<int64_t>(1, 4 * padded_words(u)));
  }
  int64_t G = 0;
  for (const auto& mb : members)
    G += (static_cast<int64_t>(mb.size()) + width - 1) / width;
  meta[P_GROUPS] = G;
  if (G * width > max_lanes) {
    meta[P_STATUS] = ST_OVER;
    return nullptr;
  }
  P.G = G;
  P.n_slots = G * width;
  const size_t ns = static_cast<size_t>(P.n_slots);
  P.slot_unit.assign(ns, -1);
  P.slot_w0.assign(ns, 0);
  P.slot_mlen.assign(ns, 0);
  P.slot_bit.assign(ns, 0);
  P.slot_words.assign(ns, 0);
  P.lane_words.assign(ns, 0);
  P.lane_at.assign(ns + 1, 0);
  int64_t slot_base = 0, max_words = 0, max_mlen = 0;
  for (int64_t b = 0; b < n_bins; b++) {
    auto& mb = members[static_cast<size_t>(b)];
    std::stable_sort(mb.begin(), mb.end(), [&](int64_t x, int64_t y) {
      return ratio[static_cast<size_t>(x)] < ratio[static_cast<size_t>(y)];
    });
    for (size_t j = 0; j < mb.size(); j++) {
      const int64_t u = mb[j];
      const size_t sl = static_cast<size_t>(slot_base) + j;
      const int64_t bit = unit_out[u * UNIT_COLS + 2];
      const int64_t w0 = bit >> 5;
      const int64_t len = lens[unit_stream[u]];
      P.slot_unit[sl] = u;
      P.slot_w0[sl] = w0;
      P.slot_bit[sl] = bit;
      P.slot_mlen[sl] = mlen_of(u);
      P.slot_words[sl] = static_cast<int32_t>(padded_words(u) - w0);
      P.lane_words[sl] = static_cast<int32_t>(
          std::max<int64_t>(0, (len + 3) / 4 - w0));
      max_words = std::max<int64_t>(max_words, P.slot_words[sl]);
      max_mlen = std::max(max_mlen, P.slot_mlen[sl]);
    }
    const int64_t used = (static_cast<int64_t>(mb.size()) + width - 1) / width;
    for (int64_t k = 0; k < used; k++) P.group_bin.push_back(b);
    slot_base += used * width;
  }
  for (size_t sl = 0; sl < ns; sl++)
    P.lane_at[sl + 1] = P.lane_at[sl] + P.lane_words[sl];
  int64_t lit = 0, cmd = 0, dist = 0, cmap = 0;
  for (int64_t b : P.group_bin) {
    const int32_t* k = P.tables[static_cast<size_t>(
        P.bin_table[static_cast<size_t>(b)])].data();
    lit += static_cast<int64_t>(k[0]) * LCH * 128;
    cmd += static_cast<int64_t>(k[1]) * CCH * 128;
    dist += static_cast<int64_t>(k[2]) * DCH * 128;
    cmap += static_cast<int64_t>(lit_cmap_chunks(k[3]) + dist_cmap_chunks(k[5]) +
                                 1) * 128;
  }
  meta[P_SLOTS] = P.n_slots;
  meta[P_WPAD] = (max_words + D - 1) / D * D + D;
  meta[P_BODY] = P.lane_at[ns];
  meta[P_LIT] = lit;
  meta[P_CMD] = cmd;
  meta[P_DIST] = dist;
  meta[P_CMAP] = cmap;
  meta[P_MAX_MLEN] = max_mlen;
  meta[P_STATUS] = ST_STAGED;
  return plan.release();
}

// Writes a plan's batch into dst (int32), each field at seg[field]: body,
// each lane's words from its first command's word to its stream's end (the
// last one zero-padded), at word lane_at[l]; lit, cmd, dist, bsw, cmap, dx,
// each group its bin's tables at the offsets of its config row; cfg (G,
// 18), the port's config rows; scal (12, slots), each lane's scalars, with
// extras (7, n_units: pos0, p1, p2, r0..r3; null: none) for the units that
// continue a stream; lane_at and lane_words (slots).  Per slot: its unit
// (-1 for an empty one), words (from its first command's word to the
// padded stream's end), MLEN and first command's word.  The lanes' words
// go over threads.
void brotli_v3_fill(const void* plan_p, const uint8_t* const* data,
                    const int64_t* lens, const int64_t* unit_stream,
                    const int64_t* extras, int32_t* dst, const int64_t* seg,
                    int64_t* slot_unit, int32_t* slot_words,
                    int64_t* slot_mlen, int64_t* slot_w0, int32_t n_threads) {
  const Plan& P = *static_cast<const Plan*>(plan_p);
  const int64_t ns = P.n_slots;
  if (n_threads < 1) n_threads = 1;
  uint8_t* body = reinterpret_cast<uint8_t*>(dst + seg[F_BODY]);
  const int threads = ns < 256 ? 1 : n_threads;
  const int64_t per = (ns + threads - 1) / threads;
  on_threads(threads, [&](int t) {
    const int64_t end = std::min(ns, (t + 1) * per);
    for (int64_t l = t * per; l < end; l++) {
      const int64_t u = P.slot_unit[static_cast<size_t>(l)];
      if (u < 0) continue;
      const int64_t s = unit_stream[u];
      const int64_t skip = 4 * P.slot_w0[static_cast<size_t>(l)];
      const int64_t n = std::max<int64_t>(0, lens[s] - skip);
      uint8_t* to = body + 4 * P.lane_at[static_cast<size_t>(l)];
      if (n) std::memcpy(to, data[s] + skip, static_cast<size_t>(n));
      std::memset(to + n, 0, static_cast<size_t>((4 - n % 4) % 4));
    }
  });
  int64_t o_lit = 0, o_cmd = 0, o_dist = 0, o_cmap = 0;
  for (int64_t g = 0; g < P.G; g++) {
    const int64_t b = P.group_bin[static_cast<size_t>(g)];
    const int32_t* k = P.tables[static_cast<size_t>(
        P.bin_table[static_cast<size_t>(b)])].data();
    const int32_t NL = k[0], NC = k[1], ND = k[2];
    const int lcm = lit_cmap_chunks(k[3]), dcm = dist_cmap_chunks(k[5]);
    const int64_t n_lit = static_cast<int64_t>(NL) * LCH * 128;
    const int64_t n_cmd = static_cast<int64_t>(NC) * CCH * 128;
    const int64_t n_dist = static_cast<int64_t>(ND) * DCH * 128;
    const int64_t n_cmap = static_cast<int64_t>(lcm + dcm + 1) * 128;
    const int32_t* t = k + NCFG;
    std::memcpy(dst + seg[F_LIT] + o_lit, t, n_lit * sizeof(int32_t));
    t += n_lit;
    std::memcpy(dst + seg[F_CMD] + o_cmd, t, n_cmd * sizeof(int32_t));
    t += n_cmd;
    std::memcpy(dst + seg[F_DIST] + o_dist, t, n_dist * sizeof(int32_t));
    t += n_dist;
    std::memcpy(dst + seg[F_BSW] + g * BSW_N, t, BSW_N * sizeof(int32_t));
    t += BSW_N;
    std::memcpy(dst + seg[F_CMAP] + o_cmap, t, n_cmap * sizeof(int32_t));
    t += n_cmap;
    std::memcpy(dst + seg[F_DX] + g * DX_N, t, DX_N * sizeof(int32_t));
    const int32_t row[CFG_ROW] = {
        NL, NC, ND, k[3], k[4], k[5], k[6], k[7],
        static_cast<int32_t>(P.bin_maxbw[static_cast<size_t>(b)]), k[9], lcm,
        dcm, static_cast<int32_t>(o_lit), static_cast<int32_t>(o_cmd),
        static_cast<int32_t>(o_dist), static_cast<int32_t>(g * BSW_N),
        static_cast<int32_t>(o_cmap), static_cast<int32_t>(g * DX_N)};
    std::memcpy(dst + seg[F_CFG] + g * CFG_ROW, row, sizeof(row));
    o_lit += n_lit;
    o_cmd += n_cmd;
    o_dist += n_dist;
    o_cmap += n_cmap;
  }
  int32_t* scal = dst + seg[F_SCAL];
  const int32_t ring0[4] = {4, 11, 15, 16};
  for (int64_t l = 0; l < ns; l++) {
    const size_t sl = static_cast<size_t>(l);
    const int64_t u = P.slot_unit[sl];
    int32_t v[SCAL_ROWS] = {0, 0, 0, 0, 0, 0, 0, 0,
                            ring0[0], ring0[1], ring0[2], ring0[3]};
    if (u >= 0) {
      v[0] = static_cast<int32_t>(P.slot_bit[sl] & 31);
      v[1] = static_cast<int32_t>(P.slot_mlen[sl]);
      for (int k = 0; k < 3; k++)
        v[2 + k] = static_cast<int32_t>(
            P.unit_blen[static_cast<size_t>(3 * u + k)]);
      if (extras) {
        for (int k = 0; k < 7; k++)
          v[5 + k] = static_cast<int32_t>(extras[k * P.n_units + u]);
        v[5] = static_cast<int32_t>(
            std::min<int64_t>(extras[u], int64_t{1} << 30));
      }
    }
    for (int r = 0; r < SCAL_ROWS; r++) scal[r * ns + l] = v[r];
    dst[seg[F_LANE_AT] + l] = static_cast<int32_t>(P.lane_at[sl]);
    dst[seg[F_LANE_WORDS] + l] = P.lane_words[sl];
    slot_unit[l] = u;
    slot_words[l] = P.slot_words[sl];
    slot_mlen[l] = P.slot_mlen[sl];
    slot_w0[l] = P.slot_w0[sl];
  }
}

void brotli_v3_free(void* plan) { delete static_cast<Plan*>(plan); }

// brotli_v3_walk_batch over streams read where they lie: stream s is
// lens[s] bytes at data[s].
void brotli_v3_walk_ptrs(const uint8_t* const* data, const int64_t* lens,
                         const int64_t* unit_stream, const int64_t* unit_bit,
                         int64_t n_units, int32_t n_threads, int64_t* unit_out,
                         uint8_t* copy_out, const int64_t* copy_off) {
  if (n_threads < 1) n_threads = 1;
  on_threads(n_units < 2 ? 1 : n_threads, [&](int tid) {
    for (int64_t u = tid; u < n_units; u += n_threads) {
      const int64_t s = unit_stream[u];
      walk_unit(data[s], lens[s], unit_bit[u], copy_out + copy_off[u],
                copy_off[u + 1] - copy_off[u], unit_out + u * WALK_COLS);
    }
  });
}

}  // extern "C"
