// Batch host preflight and staging of the v2 decode, called by
// ops/preflight2_native.py: the C++ counterpart of ops/preflight2.py's
// preflight / preflight_many (per stream), _parse_dedup, preflight_shared
// and preflight_binned (per batch), writing the port's own layout.
//
// Built as a library of its own, never linked beside decoder.cpp's: it
// includes decoder.cpp for the host decoder's bit reader, Huffman table
// code and MetablockState, which sit in that file's anonymous namespace.
//
// Two entries.  brotli_v2_plan parses every stream's header and tables
// over threads (a thread remembers the last few headers it parsed, and a
// stream whose header bits equal one of them takes that parse, as
// _parse_dedup), bins the streams by their tables in the order in which
// they first appear, and lays the lanes out as stage_v2 does: one bin that
// fits the caller's groups takes preflight_shared's layout (every stream
// rate-sorted), else preflight_binned's (each bin rate-sorted and cut into
// groups of 1024).  brotli_v2_fill then writes the batch into one caller
// buffer over threads: each lane's words from its command start on, one
// lane after another (the device spreads them into the kernel's
// word-major (Wpad, lanes) table, ops/preflight2_native.to_device), each
// group's tables without the TPU's sublane replication, the distance LUT,
// the length LUT, each lane's start bit and decoded size.

#include "decoder.cpp"

#include <algorithm>
#include <thread>
#include <unordered_map>

namespace {

// padded table sizes and chunk caps (ops/preflight2.py)
constexpr int LIT_N = 630;
constexpr int CMD_N = 1080;
constexpr int DIST_N = 920;
constexpr int TAB_N = LIT_N + CMD_N + DIST_N;  // a bin's key
constexpr int LIT_K = 5, CMD_K = 9, DIST_K = 8;
constexpr int DX_N = 544;     // MAX_DIST_ALPHABET
constexpr int DX_SLOTS = 640; // DX_K chunks of 128
constexpr int CONSTS_N = 128;
constexpr int NSTREAM = 1024; // lanes a group
constexpr int WORD_PAD = 64;  // Wpad = round_up(max words, 64) + 64
constexpr int SIGS = 16;      // headers a thread remembers

// meta: what the plan tells the caller
enum { M_GROUPS, M_BINS, M_WPAD, M_LIT_K, M_CMD_K, M_DIST_K, M_NPOSTFIX,
       M_NDIRECT, M_MAXBW, M_MAX_MLEN, M_N };
// seg: where brotli_v2_fill writes each field, in int32 units
enum { S_BODY, S_LIT, S_CMD, S_DIST, S_DX, S_CONSTS, S_START, S_MLEN,
       S_LANE_AT, S_LANE_WORDS, S_N };

struct Parse {
  int64_t mlen = 0, bit = 0;
  int32_t npostfix = 0, ndirect = 0, maxbw = 0;
  std::vector<int32_t> tab;  // literal, command, distance tables, padded
  std::vector<int32_t> dx;   // (extra << 26) | offset, DX_SLOTS
};

// a parsed header's bits: the first nf bytes, then the low bits of the next
struct Sig {
  const uint8_t* bytes;
  int64_t nf;
  int mask, last;
  int32_t parse;
};

// preflight's parse of one stream (window bits without the large window,
// one compressed last metablock, one block type a category, one literal
// and one distance tree, trivial literal contexts); false where preflight
// returns None
bool parse_stream(const Tables& T, const uint8_t* p, int64_t len,
                  Parse& out) {
  Err e;
  BitReader br(p, len);
  int wbits;
  if (br.read(1, e) == 0) {
    wbits = 16;
  } else {
    int n = br.read(3, e);
    if (n != 0) {
      wbits = 17 + n;
    } else {
      n = br.read(3, e);
      if (n == 1) return false;  // large window
      wbits = n != 0 ? 8 + n : 17;
    }
  }
  const bool input_end = br.read(1, e) != 0;
  if (!input_end || br.read(1, e)) return false;  // not last, or empty
  int64_t mbl;
  bool is_unc, is_meta;
  if (read_metablock_length(br, input_end, &mbl, &is_unc, &is_meta, e))
    return false;
  if (is_meta || is_unc || mbl == 0 || e.code) return false;
  MetablockState st;
  if (st.init(T, br, false, e) || e.code) return false;
  if (st.num_types[0] != 1 || st.num_types[1] != 1 || st.num_types[2] != 1 ||
      st.lit_group.size() != 1 || st.dist_group.size() != 1 ||
      !st.trivial_literal)
    return false;
  out.tab.assign(TAB_N, 0);
  auto put = [&](int at, const std::vector<int32_t>& t, int cap) {
    const size_t n = std::min<size_t>(cap, t.size());
    std::memcpy(out.tab.data() + at, t.data(), n * sizeof(int32_t));
  };
  put(0, st.lit_group[0], LIT_N);
  put(LIT_N, st.cmd_group[0], CMD_N);
  put(LIT_N + CMD_N, st.dist_group[0], DIST_N);
  out.dx.assign(DX_SLOTS, 0);
  const size_t nd = std::min<size_t>(DX_N, st.dist_extra.size());
  for (size_t k = 0; k < nd; k++)
    out.dx[k] = static_cast<int32_t>(
        (static_cast<uint32_t>(st.dist_extra[k]) << 26) |
        static_cast<uint32_t>(st.dist_offset[k]));
  out.mlen = mbl;
  out.bit = br.bitpos_;
  out.npostfix = st.npostfix;
  out.ndirect = st.ndirect;
  out.maxbw = (1 << wbits) - 16;
  return true;
}

bool sig_matches(const Sig& g, const uint8_t* p, int64_t len) {
  return len > g.nf && std::memcmp(p, g.bytes, g.nf) == 0 &&
         (!g.mask || (p[g.nf] & g.mask) == g.last);
}

uint64_t hash_tab(const std::vector<int32_t>& t) {
  uint64_t h = 0x9E3779B97F4A7C15ull;
  for (int32_t v : t) {
    h ^= static_cast<uint32_t>(v);
    h *= 0xFF51AFD7ED558CCDull;
    h ^= h >> 32;
  }
  return h;
}

// chunks of 128 a table of `n` entries occupies (trailing zeros cut), at
// least 2 (the root is always addressable), at most cap
int used_k(const int32_t* t, int n, int cap) {
  while (n > 1 && t[n - 1] == 0) n--;
  return std::max(2, std::min(cap, (n + 127) / 128));
}

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

}  // namespace

extern "C" {

// Parses and lays out n streams (stream s is lens[s] bytes at data[s]).
// groups: preflight_shared's group count; group_cap: preflight_binned's
// max_groups; binned == 0 leaves preflight_binned out.
// Returns the batch's groups G (1 <= G <= max_groups, the room of the
// outputs), 0 where stage_v2 returns None, -1 where G would exceed
// max_groups.  On success, for the G * 1024 lanes: perm (stream, -1 for a
// pad lane), bit (the stream's command start bit), mlen, n_words (the
// lane's real words, as preflight_shared counts them); group_bin[G];
// bin_tab[bin][TAB_N] (literal, command, distance tables); dx[640] (stream
// 0's distance LUT); meta[M_N].
int64_t brotli_v2_plan(
    const uint8_t* const* data, const int64_t* lens,
    int64_t n, int32_t groups, int32_t group_cap, int32_t binned,
    const int32_t* blen_nbits, const int32_t* blen_offset,
    const int32_t* clc_order, const int32_t* clc_lengths, int32_t n_threads,
    int64_t max_groups, int64_t* meta, int64_t* perm, int64_t* bit,
    int64_t* mlen, int32_t* n_words, int32_t* group_bin, int32_t* bin_tab,
    int32_t* dx) {
  if (n < 1) return 0;
  const Tables T{nullptr, nullptr, nullptr, nullptr, blen_nbits, blen_offset,
                 nullptr, nullptr, clc_order, clc_lengths, nullptr, nullptr,
                 nullptr, 0, nullptr, nullptr, nullptr, 0};
  if (n_threads < 1) n_threads = 1;
  if (n < 64) n_threads = 1;
  const int64_t per = (n + n_threads - 1) / n_threads;

  // parse: each thread a contiguous run of streams, its parses in stream
  // order; ok[t] == 0 once one of its streams is ineligible
  std::vector<std::vector<Parse>> parses(static_cast<size_t>(n_threads));
  std::vector<int32_t> local(static_cast<size_t>(n));
  std::vector<int> ok(static_cast<size_t>(n_threads), 1);
  on_threads(n_threads, [&](int t) {
    auto& mine = parses[static_cast<size_t>(t)];
    std::vector<Sig> sigs;
    const int64_t end = std::min(n, (t + 1) * per);
    for (int64_t s = t * per; s < end; s++) {
      const uint8_t* p = data[s];
      const int64_t len = lens[s];
      int32_t hit = -1;
      for (size_t k = 0; k < sigs.size(); k++) {
        if (sig_matches(sigs[k], p, len)) {
          hit = sigs[k].parse;
          std::rotate(sigs.begin(), sigs.begin() + k, sigs.begin() + k + 1);
          break;
        }
      }
      if (hit < 0) {
        Parse r;
        if (!parse_stream(T, p, len, r)) {
          ok[static_cast<size_t>(t)] = 0;
          return;
        }
        hit = static_cast<int32_t>(mine.size());
        const int64_t nf = r.bit >> 3;
        const int rem = static_cast<int>(r.bit & 7);
        const int mask = (1 << rem) - 1;
        const int last = rem && len > nf ? (p[nf] & mask) : 0;
        mine.push_back(std::move(r));
        sigs.insert(sigs.begin(), Sig{p, nf, mask, last, hit});
        if (static_cast<int>(sigs.size()) > SIGS) sigs.pop_back();
      }
      local[static_cast<size_t>(s)] = hit;
    }
  });
  for (int v : ok)
    if (!v) return 0;

  // number the parses in stream order, bin them by their tables
  std::vector<int64_t> base(static_cast<size_t>(n_threads) + 1, 0);
  for (int t = 0; t < n_threads; t++)
    base[t + 1] = base[t] + static_cast<int64_t>(parses[t].size());
  std::vector<const Parse*> all;
  all.reserve(static_cast<size_t>(base[n_threads]));
  for (auto& v : parses)
    for (auto& r : v) all.push_back(&r);
  const Parse& p0 = *all[0];
  std::vector<int32_t> parse_bin(all.size());
  std::vector<const Parse*> bins;
  std::unordered_map<uint64_t, std::vector<int32_t>> by_hash;
  for (size_t i = 0; i < all.size(); i++) {
    const Parse& r = *all[i];
    if (r.npostfix != p0.npostfix || r.ndirect != p0.ndirect ||
        r.maxbw != p0.maxbw)
      return 0;
    auto& cands = by_hash[hash_tab(r.tab)];
    int32_t b = -1;
    for (int32_t c : cands)
      if (std::memcmp(bins[c]->tab.data(), r.tab.data(),
                      TAB_N * sizeof(int32_t)) == 0) {
        b = c;
        break;
      }
    if (b < 0) {
      b = static_cast<int32_t>(bins.size());
      cands.push_back(b);
      bins.push_back(&r);
    }
    parse_bin[i] = b;
  }
  std::vector<const Parse*> of(static_cast<size_t>(n));
  std::vector<int32_t> bin_of(static_cast<size_t>(n));
  for (int t = 0; t < n_threads; t++) {
    const int64_t end = std::min(n, (t + 1) * per);
    for (int64_t s = t * per; s < end; s++) {
      const int64_t g = base[t] + local[static_cast<size_t>(s)];
      of[static_cast<size_t>(s)] = all[static_cast<size_t>(g)];
      bin_of[static_cast<size_t>(s)] = parse_bin[static_cast<size_t>(g)];
    }
  }

  // lanes: preflight_shared's layout, else preflight_binned's
  const int64_t n_bins = static_cast<int64_t>(bins.size());
  std::vector<std::vector<int64_t>> members;
  int64_t G;
  if (n_bins == 1 && n <= static_cast<int64_t>(NSTREAM) * groups) {
    G = groups;
    members.resize(1);
    for (int64_t s = 0; s < n; s++) members[0].push_back(s);
  } else {
    if (!binned) return 0;
    members.resize(static_cast<size_t>(n_bins));
    for (int64_t s = 0; s < n; s++)
      members[static_cast<size_t>(bin_of[static_cast<size_t>(s)])]
          .push_back(s);
    G = 0;
    for (const auto& m : members)
      G += (static_cast<int64_t>(m.size()) + NSTREAM - 1) / NSTREAM;
    if (G > group_cap) return 0;
  }
  if (G > max_groups) return -1;
  const int64_t n_slots = G * NSTREAM;
  std::vector<double> rate(static_cast<size_t>(n));
  for (int64_t s = 0; s < n; s++)
    rate[static_cast<size_t>(s)] =
        static_cast<double>(of[static_cast<size_t>(s)]->mlen) /
        static_cast<double>(std::max<int64_t>(1, lens[s]));
  for (int64_t k = 0; k < n_slots; k++) {
    perm[k] = -1;
    bit[k] = 0;
    mlen[k] = 0;
    n_words[k] = 0;
  }
  // members[b]: bin b's streams, stably rate-sorted, in ceil(size / 1024)
  // groups of their own
  int64_t slot_base = 0, g = 0;
  for (size_t b = 0; b < members.size(); b++) {
    auto& m = members[b];
    std::stable_sort(m.begin(), m.end(), [&](int64_t x, int64_t y) {
      return rate[static_cast<size_t>(x)] < rate[static_cast<size_t>(y)];
    });
    for (size_t j = 0; j < m.size(); j++) {
      const int64_t s = m[j], slot = slot_base + static_cast<int64_t>(j);
      const Parse& r = *of[static_cast<size_t>(s)];
      perm[slot] = s;
      bit[slot] = r.bit;
      mlen[slot] = r.mlen;
      n_words[slot] =
          static_cast<int32_t>((lens[s] + 3) / 4 + 3 - (r.bit >> 5));
    }
    const int64_t used =
        (static_cast<int64_t>(m.size()) + NSTREAM - 1) / NSTREAM;
    for (int64_t k = 0; k < used; k++) group_bin[g++] = static_cast<int32_t>(b);
    slot_base += used * NSTREAM;
  }
  while (g < G) group_bin[g++] = 0;  // the shared layout's empty groups

  int64_t max_words = 0, max_mlen = 0;
  for (int64_t k = 0; k < n_slots; k++) {
    max_words = std::max<int64_t>(max_words, n_words[k]);
    max_mlen = std::max(max_mlen, mlen[k]);
  }
  int lit_k = 0, cmd_k = 0, dist_k = 0;
  for (int64_t b = 0; b < n_bins; b++) {
    const int32_t* t = bins[static_cast<size_t>(b)]->tab.data();
    std::memcpy(bin_tab + b * TAB_N, t, TAB_N * sizeof(int32_t));
    lit_k = std::max(lit_k, used_k(t, LIT_N, LIT_K));
    cmd_k = std::max(cmd_k, used_k(t + LIT_N, CMD_N, CMD_K));
    dist_k = std::max(dist_k, used_k(t + LIT_N + CMD_N, DIST_N, DIST_K));
  }
  std::memcpy(dx, p0.dx.data(), DX_SLOTS * sizeof(int32_t));
  meta[M_GROUPS] = G;
  meta[M_BINS] = n_bins;
  meta[M_WPAD] = (max_words + WORD_PAD - 1) / WORD_PAD * WORD_PAD + WORD_PAD;
  meta[M_LIT_K] = lit_k;
  meta[M_CMD_K] = cmd_k;
  meta[M_DIST_K] = dist_k;
  meta[M_NPOSTFIX] = p0.npostfix;
  meta[M_NDIRECT] = p0.ndirect;
  meta[M_MAXBW] = p0.maxbw;
  meta[M_MAX_MLEN] = max_mlen;
  return G;
}

// Writes a planned batch into dst (int32), each field at seg[field]:
// body, lane l's words from word bit[l] >> 5 of its stream to the
// stream's end (the last one zero-padded), at word lane_at[l] (pad lanes
// have none); lit, cmd, dist (G, k * 128), each group its bin's tables
// cut to k chunks; dx (640); consts (128); start_bit, mlen, lane_at and
// lane_words (n_slots).  The lanes' words go over threads.
void brotli_v2_fill(const uint8_t* const* data, const int64_t* lens,
                    const int64_t* perm, const int64_t* bit,
                    const int64_t* mlen, const int64_t* lane_at,
                    int64_t n_slots, const int32_t* group_bin,
                    const int32_t* bin_tab, int32_t lit_k, int32_t cmd_k,
                    int32_t dist_k, const int32_t* dx, const int32_t* consts,
                    int32_t* dst, const int64_t* seg, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  uint8_t* body = reinterpret_cast<uint8_t*>(dst + seg[S_BODY]);
  const int64_t per = (n_slots + n_threads - 1) / n_threads;
  on_threads(n_threads, [&](int t) {
    const int64_t end = std::min(n_slots, (t + 1) * per);
    for (int64_t l = t * per; l < end; l++) {
      const int64_t s = perm[l];
      if (s < 0) continue;
      const int64_t skip = 4 * (bit[l] >> 5);
      const int64_t n = std::max<int64_t>(0, lens[s] - skip);
      uint8_t* to = body + 4 * lane_at[l];
      if (n) std::memcpy(to, data[s] + skip, static_cast<size_t>(n));
      std::memset(to + n, 0, static_cast<size_t>((4 - n % 4) % 4));
    }
  });
  const int64_t G = n_slots / NSTREAM;
  const struct { int seg, at, n, k; } tabs[3] = {
      {S_LIT, 0, LIT_N, lit_k},
      {S_CMD, LIT_N, CMD_N, cmd_k},
      {S_DIST, LIT_N + CMD_N, DIST_N, dist_k}};
  for (const auto& tb : tabs) {
    const int64_t width = static_cast<int64_t>(tb.k) * 128;
    for (int64_t g = 0; g < G; g++) {
      const int32_t* from = bin_tab + static_cast<int64_t>(group_bin[g]) *
                                          TAB_N + tb.at;
      int32_t* to = dst + seg[tb.seg] + g * width;
      const int64_t n = std::min<int64_t>(width, tb.n);
      std::memcpy(to, from, n * sizeof(int32_t));
      for (int64_t j = n; j < width; j++) to[j] = 0;
    }
  }
  std::memcpy(dst + seg[S_DX], dx, DX_SLOTS * sizeof(int32_t));
  std::memcpy(dst + seg[S_CONSTS], consts, CONSTS_N * sizeof(int32_t));
  for (int64_t l = 0; l < n_slots; l++) {
    const bool live = perm[l] >= 0;
    dst[seg[S_START] + l] = live ? static_cast<int32_t>(bit[l] & 31) : 0;
    dst[seg[S_MLEN] + l] = static_cast<int32_t>(mlen[l]);
    dst[seg[S_LANE_AT] + l] = static_cast<int32_t>(lane_at[l]);
    dst[seg[S_LANE_WORDS] + l] =
        live ? static_cast<int32_t>(lane_at[l + 1] - lane_at[l]) : 0;
  }
}

}  // extern "C"
