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

#include "decoder.cpp"

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
