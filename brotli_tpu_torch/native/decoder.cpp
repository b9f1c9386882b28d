// Native (C++) RFC 7932 Brotli decoder — the host runtime's fast path.
//
// Mirrors the python golden decoder (brotli_tpu/decode/engine.py) structure
// for structure: flat two-level Huffman tables in the same
// (nbits<<16|payload) int32 layout, whole-output buffer (no ring), full
// format coverage (context maps, block switching, static + compound
// dictionaries, large window). All format constants and the static
// dictionary are passed in from Python so there is a single source of truth
// (brotli_tpu/constants.py + data/).
//
// Error codes follow the reference's negative code scheme.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int MAX_CODE_LENGTH = 15;
constexpr int HUGE_BLOCK = 1 << 28;
constexpr int NUM_LITERAL_SYMBOLS = 256;
constexpr int NUM_COMMAND_SYMBOLS = 704;

struct Tables {
  const int32_t* ins_nbits;      // 24
  const int32_t* ins_offset;     // 24
  const int32_t* cp_nbits;       // 24
  const int32_t* cp_offset;      // 24
  const int32_t* blen_nbits;     // 26
  const int32_t* blen_offset;    // 26
  const int32_t* cmd_lut;        // 704*4: ins_code, cp_code, implicit, dist_ctx
  const int32_t* context_lut;    // 2048
  const int32_t* clc_order;      // 18 code-length-code order
  const int32_t* clc_lengths;    // 6 fixed code-length-code lengths (RFC 3.5)
  const int32_t* dict_offsets;   // 32 (offset by word length)
  const int32_t* dict_sizebits;  // 32
  const uint8_t* dict_data;      // static dictionary bytes
  int64_t dict_len;
  const int32_t* tf_spans;       // 121*4: pre_off, pre_len, suf_off, suf_len
  const int32_t* tf_ops;         // 121
  const uint8_t* tf_storage;
  int32_t num_transforms;
};

struct Err {
  int code = 0;
};

class BitReader {
 public:
  BitReader(const uint8_t* data, int64_t len) : data_(data), len_(len) {
    total_bits_ = len * 8;
    words_.resize((len + 3) / 4 + 4, 0);
    std::memcpy(words_.data(), data, static_cast<size_t>(len));
    fast_words_ = static_cast<int64_t>(words_.size()) - 2;
    bitpos_ = 0;
  }

  inline uint32_t peek(int nbits, Err& e) {
    int64_t w = bitpos_ >> 5;
    if (w >= fast_words_) { e.code = -10; return 0; }
    uint64_t v = (static_cast<uint64_t>(words_[w]) |
                  (static_cast<uint64_t>(words_[w + 1]) << 32)) >> (bitpos_ & 31);
    return static_cast<uint32_t>(v & ((1u << nbits) - 1));
  }

  inline uint32_t read(int nbits, Err& e) {
    uint32_t v = peek(nbits, e);
    bitpos_ += nbits;
    return v;
  }

  inline void skip(int nbits) { bitpos_ += nbits; }

  void jump_to_byte_boundary(Err& e) {
    int pad = static_cast<int>((-bitpos_) & 7);
    if (pad && read(pad, e) != 0 && !e.code) e.code = -5;
  }

  int64_t byte_pos() const { return bitpos_ >> 3; }

  const uint8_t* copy_bytes(int64_t n, Err& e) {
    int64_t start = byte_pos();
    if (start + n > len_) { e.code = -10; return nullptr; }
    bitpos_ += n * 8;
    return data_ + start;
  }

  void check_health(bool end_of_stream, Err& e) {
    if (bitpos_ > total_bits_) e.code = -10;
    (void)end_of_stream;
  }

  int64_t bitpos_ = 0;

 private:
  const uint8_t* data_;
  int64_t len_;
  int64_t total_bits_;
  int64_t fast_words_;
  std::vector<uint32_t> words_;
};

// ---- canonical two-level table build (mirrors decode/huffman.py) ----

int next_key(int key, int length) {
  int step = 1 << (length - 1);
  while (key & step) step >>= 1;
  return (key & (step - 1)) + step;
}

int next_table_bit_size(const int* count, int length, int root_bits) {
  int left = 1 << (length - root_bits);
  while (length < MAX_CODE_LENGTH) {
    left -= count[length];
    if (left <= 0) break;
    length++;
    left <<= 1;
  }
  return length - root_bits;
}

int build_huffman_table(int32_t* table, int table_off, int root_bits,
                        const int* code_lengths, int n) {
  int count[MAX_CODE_LENGTH + 1] = {0};
  for (int i = 0; i < n; i++) count[code_lengths[i]]++;
  int offsets[MAX_CODE_LENGTH + 2] = {0};
  for (int ln = 1; ln <= MAX_CODE_LENGTH; ln++)
    offsets[ln + 1] = offsets[ln] + count[ln];
  int num_used = offsets[MAX_CODE_LENGTH + 1];
  std::vector<int> sorted_syms(num_used ? num_used : 1);
  {
    int fill[MAX_CODE_LENGTH + 2];
    std::memcpy(fill, offsets, sizeof(offsets));
    for (int sym = 0; sym < n; sym++) {
      int ln = code_lengths[sym];
      if (ln) sorted_syms[fill[ln]++] = sym;
    }
  }

  int table_size = 1 << root_bits;
  int total_size = table_size;
  if (num_used == 1) {
    for (int i = 0; i < total_size; i++) table[table_off + i] = sorted_syms[0];
    return total_size;
  }

  int key = 0, symbol = 0, step = 1;
  for (int ln = 1; ln <= root_bits; ln++) {
    step <<= 1;
    while (count[ln] > 0) {
      int item = (ln << 16) | sorted_syms[symbol++];
      for (int pos = table_size; pos > 0;) {
        pos -= step;
        table[table_off + key + pos] = item;
      }
      key = next_key(key, ln);
      count[ln]--;
    }
  }

  int mask = total_size - 1;
  int low = -1;
  int cur_off = table_off;
  int sub_size = table_size;
  for (int ln = root_bits + 1; ln <= MAX_CODE_LENGTH; ln++) {
    step <<= 1;
    while (count[ln] > 0) {
      if ((key & mask) != low) {
        cur_off += sub_size;
        int sub_bits = next_table_bit_size(count, ln, root_bits);
        sub_size = 1 << sub_bits;
        total_size += sub_size;
        low = key & mask;
        table[table_off + low] =
            ((sub_bits + root_bits) << 16) | (cur_off - table_off - low);
      }
      int item = ((ln - root_bits) << 16) | sorted_syms[symbol++];
      int sub_step = 1 << (ln - root_bits);
      int base = cur_off + (key >> root_bits);
      for (int pos = sub_size; pos > 0;) {
        pos -= sub_step;
        table[base + pos] = item;
      }
      key = next_key(key, ln);
      count[ln]--;
    }
  }
  return total_size;
}

inline int read_symbol(const int32_t* table, BitReader& br, Err& e) {
  uint32_t v = br.peek(15, e);
  int slot = v & 0xFF;
  int entry = table[slot];
  int bits = entry >> 16;
  if (bits <= 8) {
    br.skip(bits);
    return entry & 0xFFFF;
  }
  slot += entry & 0xFFFF;
  entry = table[slot + ((v & ((1u << bits) - 1)) >> 8)];
  br.skip((entry >> 16) + 8);
  return entry & 0xFFFF;
}

// ---- prefix-code description reading (mirrors huffman.py) ----

int read_code_lengths(const Tables& T, const int* clcl, int num_symbols,
                      BitReader& br, std::vector<int>& code_lengths, Err& e) {
  code_lengths.assign(num_symbols, 0);
  int32_t table[32];
  build_huffman_table(table, 0, 5, clcl, 18);
  int symbol = 0, prev_len = 8, repeat = 0, repeat_len = 0;
  int space = 32768;
  while (symbol < num_symbols && space > 0) {
    uint32_t p = br.peek(5, e);
    if (e.code) return e.code;
    int entry = table[p];
    br.skip(entry >> 16);
    int code_len = entry & 0xFFFF;
    if (code_len < 16) {
      repeat = 0;
      code_lengths[symbol++] = code_len;
      if (code_len) {
        prev_len = code_len;
        space -= 32768 >> code_len;
      }
    } else {
      int extra_bits = code_len - 14;
      int new_len = (code_len == 16) ? prev_len : 0;
      if (repeat_len != new_len) { repeat = 0; repeat_len = new_len; }
      int old_repeat = repeat;
      if (repeat > 0) repeat = (repeat - 2) << extra_bits;
      repeat += br.read(extra_bits, e) + 3;
      int delta = repeat - old_repeat;
      if (symbol + delta > num_symbols) return e.code = -2;
      for (int i = 0; i < delta; i++) code_lengths[symbol++] = repeat_len;
      if (repeat_len) space -= delta << (15 - repeat_len);
    }
  }
  if (space != 0) return e.code = -18;
  return 0;
}

int bit_length(uint32_t x) {
  int n = 0;
  while (x) { n++; x >>= 1; }
  return n;
}

int read_huffman_code(const Tables& T, int alpha_max, int alpha_limit,
                      int32_t* table, int table_off, BitReader& br, Err& e) {
  // fixed 4-bit table for the code-length-code lengths (6-symbol code)
  static thread_local int32_t fixed_clcl[16];
  static thread_local bool fixed_init = false;
  if (!fixed_init) {
    int clc_lengths[6];
    for (int i = 0; i < 6; i++) clc_lengths[i] = T.clc_lengths[i];
    build_huffman_table(fixed_clcl, 0, 4, clc_lengths, 6);
    fixed_init = true;
  }

  uint32_t simple_or_skip = br.read(2, e);
  if (e.code) return e.code;
  if (simple_or_skip == 1) {
    int max_bits = bit_length(alpha_max - 1);
    int num_symbols = br.read(2, e) + 1;
    int symbols[4];
    for (int i = 0; i < num_symbols; i++) {
      symbols[i] = br.read(max_bits, e);
      if (symbols[i] >= alpha_limit) return e.code = -15;
      for (int j = 0; j < i; j++)
        if (symbols[j] == symbols[i]) return e.code = -7;
    }
    std::vector<int> code_lengths(alpha_limit, 0);
    int shape = num_symbols;
    if (num_symbols == 4 && br.read(1, e)) shape = 5;
    static const int L[6][4] = {
        {0}, {1, 0, 0, 0}, {1, 1, 0, 0}, {1, 2, 2, 0}, {2, 2, 2, 2},
        {1, 2, 3, 3}};
    for (int i = 0; i < num_symbols; i++) code_lengths[symbols[i]] = L[shape][i];
    build_huffman_table(table, table_off, 8, code_lengths.data(), alpha_limit);
    return 0;
  }

  int clcl[18] = {0};
  int space = 32, num_codes = 0;
  for (int i = simple_or_skip; i < 18; i++) {
    int idx = T.clc_order[i];
    uint32_t p = br.peek(4, e);
    if (e.code) return e.code;
    int entry = fixed_clcl[p];
    br.skip(entry >> 16);
    int v = entry & 0xFFFF;
    clcl[idx] = v;
    if (v) {
      space -= 32 >> v;
      num_codes++;
      if (space <= 0) break;
    }
  }
  if (space != 0 && num_codes != 1) return e.code = -4;
  std::vector<int> code_lengths;
  if (read_code_lengths(T, clcl, alpha_limit, br, code_lengths, e)) return e.code;
  build_huffman_table(table, table_off, 8, code_lengths.data(), alpha_limit);
  return 0;
}

int max_table_size(int alpha_limit) {
  // MAX_HUFFMAN_TABLE_SIZE by (alphabet+31)>>5, RFC-derived (huffman.py)
  static const int sizes[] = {256, 402, 436, 468, 500, 534, 566, 598, 630, 662,
                              694, 726, 758, 790, 822, 854, 886, 920, 952,
                              984, 1016, 1048, 1080};
  int idx = (alpha_limit + 31) >> 5;
  if (idx >= static_cast<int>(sizeof(sizes) / sizeof(int)))
    idx = sizeof(sizes) / sizeof(int) - 1;
  return sizes[idx];
}

int var_len_uint8(BitReader& br, Err& e) {
  if (br.read(1, e) == 0) return 0;
  int n = br.read(3, e);
  if (n == 0) return 1;
  return br.read(n, e) + (1 << n);
}

void inverse_mtf(std::vector<int>& values) {
  uint8_t mtf[256];
  for (int i = 0; i < 256; i++) mtf[i] = static_cast<uint8_t>(i);
  for (size_t i = 0; i < values.size(); i++) {
    int idx = values[i];
    uint8_t v = mtf[idx];
    values[i] = v;
    for (int j = idx; j > 0; j--) mtf[j] = mtf[j - 1];
    mtf[0] = v;
  }
}

int decode_context_map(const Tables& T, int size, BitReader& br,
                       std::vector<int>& cmap, int* num_trees, Err& e) {
  cmap.assign(size, 0);
  *num_trees = var_len_uint8(br, e) + 1;
  if (e.code) return e.code;
  if (*num_trees == 1) return 0;
  int use_rle = br.read(1, e);
  int max_run_prefix = use_rle ? br.read(4, e) + 1 : 0;
  int alphabet = *num_trees + max_run_prefix;
  std::vector<int32_t> table(max_table_size(alphabet) + 1, 0);
  if (read_huffman_code(T, alphabet, alphabet, table.data(), 0, br, e))
    return e.code;
  int i = 0;
  while (i < size) {
    int code = read_symbol(table.data(), br, e);
    if (e.code) return e.code;
    if (code == 0) {
      i++;
    } else if (code <= max_run_prefix) {
      int64_t reps = (1ll << code) + br.read(code, e);
      if (i + reps > size) return e.code = -3;
      i += static_cast<int>(reps);
    } else {
      cmap[i++] = code - max_run_prefix;
    }
  }
  if (br.read(1, e)) inverse_mtf(cmap);
  return e.code;
}

void calc_distance_lut(int alpha_limit, int npostfix, int ndirect,
                       std::vector<int>& extra, std::vector<int>& offset) {
  extra.assign(alpha_limit, 0);
  offset.assign(alpha_limit, 0);
  int postfix = 1 << npostfix;
  int i = 16;
  for (int j = 0; j < ndirect && i < alpha_limit; j++, i++) {
    extra[i] = 0;
    offset[i] = j + 1;
  }
  int bits = 1, half = 0;
  while (i < alpha_limit) {
    int base = ndirect + ((((2 + half) << bits) - 4) << npostfix) + 1;
    for (int j = 0; j < postfix && i < alpha_limit; j++, i++) {
      extra[i] = bits;
      offset[i] = base + j;
    }
    bits += half;
    half ^= 1;
  }
}

struct Output {
  std::vector<uint8_t> buf;
  int64_t pos = 0;

  void ensure(int64_t need) {
    if (need > static_cast<int64_t>(buf.size()))
      buf.resize(std::max<int64_t>(need, buf.size() * 2));
  }
  void append(const uint8_t* d, int64_t n) {
    ensure(pos + n);
    std::memcpy(buf.data() + pos, d, static_cast<size_t>(n));
    pos += n;
  }
  void copy_within(int64_t distance, int64_t length) {
    ensure(pos + length);
    uint8_t* dst = buf.data() + pos;
    const uint8_t* src = buf.data() + pos - distance;
    if (distance >= length) {
      std::memcpy(dst, src, static_cast<size_t>(length));
    } else {
      int64_t written = distance;
      std::memcpy(dst, src, static_cast<size_t>(distance));
      while (written < length) {
        int64_t n = std::min(written, length - written);
        std::memcpy(dst + written, dst, static_cast<size_t>(n));
        written += n;
      }
    }
    pos += length;
  }
};

void uppercase_span(uint8_t* buf, int64_t start, int64_t length,
                    bool first_only) {
  int64_t off = start;
  int64_t remaining = first_only ? 1 : length;
  int64_t end = start + length;
  while (remaining > 0 && off < end) {
    uint8_t c0 = buf[off];
    if (c0 < 0xC0) {
      if (c0 >= 97 && c0 <= 122) buf[off] ^= 32;
      off += 1;
      remaining -= 1;
    } else if (c0 < 0xE0) {
      if (off + 1 < end) buf[off + 1] ^= 32;
      off += 2;
      remaining -= 2;
    } else {
      if (off + 2 < end) buf[off + 2] ^= 5;
      off += 3;
      remaining -= 3;
    }
    if (first_only) break;
  }
}

// appends transformed dictionary word; returns transformed length or <0
int64_t transform_word(const Tables& T, const uint8_t* word, int word_len,
                       int transform_idx, Output& out) {
  const int32_t* span = T.tf_spans + transform_idx * 4;
  int op = T.tf_ops[transform_idx];
  int omit_first = (op >= 12 && op <= 20) ? op - 11 : 0;
  int omit_last = (op >= 1 && op <= 9) ? op : 0;
  if (omit_first > word_len) omit_first = word_len;
  int body_len = word_len - omit_first - omit_last;
  if (body_len < 0) body_len = 0;
  out.ensure(out.pos + span[1] + body_len + span[3]);
  out.append(T.tf_storage + span[0], span[1]);
  int64_t body_start = out.pos;
  out.append(word + omit_first, body_len);
  if (op == 10) uppercase_span(out.buf.data(), body_start, body_len, true);
  else if (op == 11) uppercase_span(out.buf.data(), body_start, body_len, false);
  out.append(T.tf_storage + span[2], span[3]);
  return span[1] + body_len + span[3];
}

struct MetablockState {
  int num_types[3];
  int64_t block_len[3];
  int btype[3];
  int btype_prev[3];
  std::vector<int32_t> type_tables[3];
  std::vector<int32_t> len_tables[3];
  std::vector<int> context_modes;
  std::vector<int> cmap, dist_cmap;
  std::vector<std::vector<int32_t>> lit_group, cmd_group, dist_group;
  bool trivial_literal = true;
  int npostfix = 0, ndirect = 0;
  std::vector<int> dist_extra, dist_offset;

  int read_block_length(const Tables& T, BitReader& br, int c, Err& e) {
    int code = read_symbol(len_tables[c].data(), br, e);
    return T.blen_offset[code] + br.read(T.blen_nbits[code], e);
  }

  void block_switch(const Tables& T, BitReader& br, int c, Err& e) {
    int sym = read_symbol(type_tables[c].data(), br, e);
    int length = read_block_length(T, br, c, e);
    int bt;
    if (sym == 0) bt = btype_prev[c];
    else if (sym == 1) bt = btype[c] + 1;
    else bt = sym - 2;
    if (bt >= num_types[c]) bt -= num_types[c];
    btype_prev[c] = btype[c];
    btype[c] = bt;
    block_len[c] = length;
  }

  int init(const Tables& T, BitReader& br, bool large_window, Err& e) {
    for (int c = 0; c < 3; c++) {
      int n = var_len_uint8(br, e) + 1;
      num_types[c] = n;
      btype[c] = 0;
      btype_prev[c] = 1;
      if (n >= 2) {
        type_tables[c].assign(max_table_size(n + 2) + 1, 0);
        if (read_huffman_code(T, n + 2, n + 2, type_tables[c].data(), 0, br, e))
          return e.code;
        len_tables[c].assign(max_table_size(26) + 1, 0);
        if (read_huffman_code(T, 26, 26, len_tables[c].data(), 0, br, e))
          return e.code;
        block_len[c] = read_block_length(T, br, c, e);
      } else {
        block_len[c] = HUGE_BLOCK;
      }
      if (e.code) return e.code;
    }
    npostfix = br.read(2, e);
    ndirect = br.read(4, e) << npostfix;
    context_modes.resize(num_types[0]);
    for (int i = 0; i < num_types[0]; i++) context_modes[i] = br.read(2, e);
    int num_lit_trees, num_dist_trees;
    if (decode_context_map(T, num_types[0] << 6, br, cmap, &num_lit_trees, e))
      return e.code;
    trivial_literal = true;
    for (size_t j = 0; j < cmap.size(); j++)
      if (cmap[j] != static_cast<int>(j >> 6)) { trivial_literal = false; break; }
    if (decode_context_map(T, num_types[2] << 2, br, dist_cmap, &num_dist_trees, e))
      return e.code;

    lit_group.resize(num_lit_trees);
    for (auto& t : lit_group) {
      t.assign(max_table_size(NUM_LITERAL_SYMBOLS) + 1, 0);
      if (read_huffman_code(T, NUM_LITERAL_SYMBOLS, NUM_LITERAL_SYMBOLS,
                            t.data(), 0, br, e))
        return e.code;
    }
    cmd_group.resize(num_types[1]);
    for (auto& t : cmd_group) {
      t.assign(max_table_size(NUM_COMMAND_SYMBOLS) + 1, 0);
      if (read_huffman_code(T, NUM_COMMAND_SYMBOLS, NUM_COMMAND_SYMBOLS,
                            t.data(), 0, br, e))
        return e.code;
    }
    auto alpha_size = [&](int maxb) {
      return 16 + ndirect + (2 * maxb << npostfix);
    };
    int dist_alpha_max = alpha_size(24);
    int dist_alpha_limit = dist_alpha_max;
    if (large_window) {
      dist_alpha_max = alpha_size(62);
      // calculateDistanceAlphabetLimit(0x7FFFFFFC)
      int64_t offset = ((0x7FFFFFFCll - ndirect) >> npostfix) + 4;
      int ndistbits = bit_length(static_cast<uint32_t>(offset)) - 1 - 1;
      int group = ((ndistbits - 1) << 1) | ((offset >> ndistbits) & 1);
      dist_alpha_limit = ((group - 1) << npostfix) + (1 << npostfix) + ndirect + 16;
    }
    dist_group.resize(num_dist_trees);
    for (auto& t : dist_group) {
      t.assign(max_table_size(dist_alpha_limit) + 1, 0);
      if (read_huffman_code(T, dist_alpha_max, dist_alpha_limit, t.data(), 0,
                            br, e))
        return e.code;
    }
    calc_distance_lut(dist_alpha_limit, npostfix, ndirect, dist_extra,
                      dist_offset);
    return 0;
  }
};

int read_metablock_length(BitReader& br, bool input_end, int64_t* mbl,
                          bool* is_uncompressed, bool* is_metadata, Err& e) {
  *is_uncompressed = false;
  *is_metadata = false;
  int size_nibbles = br.read(2, e) + 4;
  if (size_nibbles == 7) {
    *is_metadata = true;
    if (br.read(1, e) != 0) return e.code ? e.code : (e.code = -6);
    int size_bytes = br.read(2, e);
    if (size_bytes == 0) { *mbl = 0; return 0; }
    int64_t m = 0;
    for (int i = 0; i < size_bytes; i++) {
      uint32_t bits = br.read(8, e);
      if (bits == 0 && i + 1 == size_bytes && size_bytes > 1)
        return e.code = -8;
      m += static_cast<int64_t>(bits) << (i * 8);
    }
    *mbl = m + 1;
    return 0;
  }
  int64_t m = 0;
  for (int i = 0; i < size_nibbles; i++) {
    uint32_t bits = br.read(4, e);
    if (bits == 0 && i + 1 == size_nibbles && size_nibbles > 4)
      return e.code = -8;
    m += static_cast<int64_t>(bits) << (i * 4);
  }
  *mbl = m + 1;
  if (!input_end) *is_uncompressed = br.read(1, e) != 0;
  return e.code;
}

}  // namespace

extern "C" {

// Returns 0 on success, negative brotli error code on failure, or
// -1000 when out_cap is insufficient (*out_len then holds a size hint).
int brotli_native_decode(
    const uint8_t* data, int64_t data_len,
    const int32_t* ins_nbits, const int32_t* ins_offset,
    const int32_t* cp_nbits, const int32_t* cp_offset,
    const int32_t* blen_nbits, const int32_t* blen_offset,
    const int32_t* cmd_lut, const int32_t* context_lut,
    const int32_t* clc_order, const int32_t* clc_lengths,
    const int32_t* dict_offsets, const int32_t* dict_sizebits,
    const uint8_t* dict_data, int64_t dict_data_len,
    const int32_t* tf_spans, const int32_t* tf_ops,
    const uint8_t* tf_storage, int32_t num_transforms,
    const uint8_t* cd_data, const int64_t* cd_offsets, int32_t n_cd,
    int32_t large_window,
    uint8_t* out, int64_t out_cap, int64_t* out_len) {
  Tables T{ins_nbits, ins_offset, cp_nbits, cp_offset, blen_nbits,
           blen_offset, cmd_lut, context_lut, clc_order, clc_lengths,
           dict_offsets, dict_sizebits, dict_data, dict_data_len,
           tf_spans, tf_ops, tf_storage, num_transforms};
  Err e;
  BitReader br(data, data_len);
  Output o;
  o.buf.resize(1 << 16);

  int64_t cd_total = n_cd > 0 ? cd_offsets[n_cd] : 0;

  // window bits
  int wbits;
  bool is_large = false;
  if (br.read(1, e) == 0) {
    wbits = 16;
  } else {
    int n = br.read(3, e);
    if (n != 0) {
      wbits = 17 + n;
    } else {
      n = br.read(3, e);
      if (n != 0) {
        if (n == 1) {
          if (!large_window) return -11;
          if (br.read(1, e) == 1) return -11;
          wbits = br.read(6, e);
          if (wbits < 10 || wbits > 30) return -11;
          is_large = true;
        } else {
          wbits = 8 + n;
        }
      } else {
        wbits = 17;
      }
    }
  }
  if (e.code) return e.code;
  int64_t max_backward = (1ll << wbits) - 16;

  int64_t dist_rb[4] = {16, 15, 11, 4};
  int dist_rb_idx = 3;

  bool input_end = false;
  while (!input_end) {
    br.check_health(false, e);
    if (e.code) return e.code;
    input_end = br.read(1, e) != 0;
    if (input_end && br.read(1, e)) break;
    int64_t mbl;
    bool is_uncompressed, is_metadata;
    if (read_metablock_length(br, input_end, &mbl, &is_uncompressed,
                              &is_metadata, e))
      return e.code;
    if (is_metadata) {
      br.jump_to_byte_boundary(e);
      if (e.code) return e.code;
      if (!br.copy_bytes(mbl, e)) return e.code;
      continue;
    }
    if (mbl == 0) continue;
    if (is_uncompressed) {
      br.jump_to_byte_boundary(e);
      if (e.code) return e.code;
      const uint8_t* p = br.copy_bytes(mbl, e);
      if (!p) return e.code;
      o.append(p, mbl);
      continue;
    }

    MetablockState st;
    if (st.init(T, br, is_large, e)) return e.code;

    const int32_t* cmd_table = st.cmd_group[0].data();
    bool trivial = st.trivial_literal;
    const int32_t* lit_table = st.lit_group[st.cmap[0]].data();
    int clo = st.context_modes[0] << 9;
    int cmap_slice = 0;
    int dist_cmap_slice = 0;

    while (mbl > 0) {
      if (st.block_len[1] == 0) {
        st.block_switch(T, br, 1, e);
        cmd_table = st.cmd_group[st.btype[1]].data();
      }
      st.block_len[1]--;
      int cmd = read_symbol(cmd_table, br, e);
      if (e.code) return e.code;
      const int32_t* cl = cmd_lut + cmd * 4;
      int ins_code = cl[0], cp_code = cl[1];
      int64_t insert_len = ins_offset[ins_code] + br.read(ins_nbits[ins_code], e);
      int64_t copy_len = cp_offset[cp_code] + br.read(cp_nbits[cp_code], e);

      if (insert_len > 0) {
        o.ensure(o.pos + insert_len);
        uint8_t* buf = o.buf.data();
        int64_t pos = o.pos;
        int64_t j = 0;
        if (trivial) {
          while (j < insert_len) {
            if (st.block_len[0] == 0) {
              st.block_switch(T, br, 0, e);
              int bt = st.btype[0];
              cmap_slice = bt << 6;
              lit_table = st.lit_group[st.cmap[cmap_slice]].data();
              clo = st.context_modes[bt] << 9;
            }
            int64_t batch = std::min<int64_t>(insert_len - j, st.block_len[0]);
            st.block_len[0] -= batch;
            j += batch;
            for (int64_t k = 0; k < batch; k++) {
              buf[pos++] = static_cast<uint8_t>(read_symbol(lit_table, br, e));
            }
            if (e.code) return e.code;
          }
        } else {
          int p1 = pos > 0 ? buf[pos - 1] : 0;
          int p2 = pos > 1 ? buf[pos - 2] : 0;
          while (j < insert_len) {
            if (st.block_len[0] == 0) {
              st.block_switch(T, br, 0, e);
              int bt = st.btype[0];
              cmap_slice = bt << 6;
              clo = st.context_modes[bt] << 9;
            }
            int64_t batch = std::min<int64_t>(insert_len - j, st.block_len[0]);
            st.block_len[0] -= batch;
            j += batch;
            int clo2 = clo + 256;
            for (int64_t k = 0; k < batch; k++) {
              int ctx = context_lut[clo + p1] | context_lut[clo2 + p2];
              int sym = read_symbol(
                  st.lit_group[st.cmap[cmap_slice + ctx]].data(), br, e);
              buf[pos++] = static_cast<uint8_t>(sym);
              p2 = p1;
              p1 = sym;
            }
            if (e.code) return e.code;
          }
        }
        o.pos = pos;
        mbl -= insert_len;
        if (mbl <= 0) break;
      }

      int64_t distance;
      int distance_code;
      if (cl[2]) {
        distance_code = -1;
        distance = dist_rb[dist_rb_idx];
      } else {
        if (st.block_len[2] == 0) {
          st.block_switch(T, br, 2, e);
          dist_cmap_slice = st.btype[2] << 2;
        }
        st.block_len[2]--;
        int tree_idx = st.dist_cmap[dist_cmap_slice + cl[3]];
        distance_code = read_symbol(st.dist_group[tree_idx].data(), br, e);
        if (e.code) return e.code;
        if (distance_code < 16) {
          static const int sidx[] = {0, 1, 2, 3, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1};
          static const int sdel[] = {0, 0, 0, 0, -1, 1, -2, 2, -3, 3, -1, 1, -2, 2, -3, 3};
          int idx = (dist_rb_idx - sidx[distance_code]) & 3;
          distance = dist_rb[idx] + sdel[distance_code];
          if (distance < 1) return -12;
        } else {
          int64_t bits = br.read(st.dist_extra[distance_code], e);
          distance = st.dist_offset[distance_code] + (bits << st.npostfix);
        }
      }

      int64_t max_distance = std::min<int64_t>(o.pos, max_backward);
      if (distance > max_distance) {
        if (distance > 0x7FFFFFFCll) return -9;
        int64_t address = distance - max_distance - 1 - cd_total;
        if (address < 0) {
          // compound dictionary
          int64_t cd_addr = -address - 1;
          if (cd_addr + copy_len > cd_total) return -9;
          dist_rb_idx = (dist_rb_idx + 1) & 3;
          dist_rb[dist_rb_idx] = distance;
          int chunk_idx = 0;
          while (cd_addr >= cd_offsets[chunk_idx + 1]) chunk_idx++;
          int64_t copied = 0;
          while (copied < copy_len) {
            int64_t off_in = cd_addr - cd_offsets[chunk_idx];
            int64_t n = std::min(copy_len - copied,
                                 cd_offsets[chunk_idx + 1] - cd_offsets[chunk_idx] - off_in);
            o.append(cd_data + cd_offsets[chunk_idx] + off_in, n);
            copied += n;
            cd_addr += n;
            if (copied < copy_len) chunk_idx++;
          }
          mbl -= copy_len;
        } else {
          int64_t word_len = copy_len;
          if (word_len > 31) return -9;
          int shift = (word_len >= 0 && word_len <= 24)
                          ? dict_sizebits[word_len] : 0;
          if (shift == 0) return -9;
          int64_t word_idx = address & ((1ll << shift) - 1);
          int64_t transform_idx = address >> shift;
          if (transform_idx >= T.num_transforms) return -9;
          const uint8_t* word =
              T.dict_data + dict_offsets[word_len] + word_idx * word_len;
          int64_t tlen = transform_word(T, word, static_cast<int>(word_len),
                                        static_cast<int>(transform_idx), o);
          mbl -= tlen;
        }
        continue;
      }

      if (distance_code > 0) {
        dist_rb_idx = (dist_rb_idx + 1) & 3;
        dist_rb[dist_rb_idx] = distance;
      }
      if (copy_len > mbl) return -9;
      o.copy_within(distance, copy_len);
      mbl -= copy_len;
    }
    if (mbl < 0) return -9;
  }

  br.jump_to_byte_boundary(e);
  if (e.code) return e.code;
  br.check_health(true, e);
  if (e.code) return e.code;

  *out_len = o.pos;
  if (o.pos > out_cap) return -1000;
  std::memcpy(out, o.buf.data(), static_cast<size_t>(o.pos));
  return 0;
}


// Batch header preflight for the v2 lockstep decode path: parses each
// stream's prologue + first-metablock tables and reports device
// eligibility (single compressed ISLAST metablock, trivial entropy layout:
// one block type per category, one literal tree, one distance tree).
// Replaces the per-stream Python header parse that cost ~1 ms/stream on
// the 1-core host (bench preflight_ms_per_batch).
//
// data: concatenated streams; offsets: (n_streams+1) byte offsets.
// Outputs per stream i (row-major):
//   lit_tables (630), cmd_tables (1080), dist_tables (920),
//   dist_extra (544), dist_offset (544),
//   scalars (8): [eligible, mlen, cmd_start_bit, npostfix, ndirect, wbits,
//                 0, 0]
int brotli_native_preflight_batch(
    const uint8_t* data, const int64_t* offsets, int64_t n_streams,
    const int32_t* blen_nbits, const int32_t* blen_offset,
    const int32_t* clc_order, const int32_t* clc_lengths,
    int32_t* lit_tables, int32_t* cmd_tables, int32_t* dist_tables,
    int32_t* dist_extra_out, int32_t* dist_offset_out, int64_t* scalars) {
  Tables T{nullptr, nullptr, nullptr, nullptr, blen_nbits, blen_offset,
           nullptr, nullptr, clc_order, clc_lengths,
           nullptr, nullptr, nullptr, 0, nullptr, nullptr, nullptr, 0};
  for (int64_t i = 0; i < n_streams; i++) {
    int64_t* sc = scalars + i * 8;
    for (int k = 0; k < 8; k++) sc[k] = 0;
    const uint8_t* p = data + offsets[i];
    int64_t len = offsets[i + 1] - offsets[i];
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
        if (n == 1) continue;            // large-window: host path
        wbits = n != 0 ? 8 + n : 17;
      }
    }
    bool input_end = br.read(1, e) != 0;
    if (!input_end) continue;            // multi-metablock: host path
    if (br.read(1, e)) continue;         // ISLAST+ISEMPTY
    int64_t mbl;
    bool is_uncompressed, is_metadata;
    if (read_metablock_length(br, input_end, &mbl, &is_uncompressed,
                              &is_metadata, e))
      continue;
    if (is_metadata || is_uncompressed || mbl == 0 || e.code) continue;
    MetablockState st;
    if (st.init(T, br, false, e) || e.code) continue;
    if (st.num_types[0] != 1 || st.num_types[1] != 1 || st.num_types[2] != 1
        || st.lit_group.size() != 1 || st.dist_group.size() != 1
        || !st.trivial_literal)
      continue;
    auto copy_tab = [](int32_t* dst, const std::vector<int32_t>& src,
                      int cap) {
      int n = std::min<int>(cap, static_cast<int>(src.size()));
      std::memcpy(dst, src.data(), n * sizeof(int32_t));
      for (int k = n; k < cap; k++) dst[k] = 0;
    };
    copy_tab(lit_tables + i * 630, st.lit_group[0], 630);
    copy_tab(cmd_tables + i * 1080, st.cmd_group[0], 1080);
    copy_tab(dist_tables + i * 920, st.dist_group[0], 920);
    int32_t* dxe = dist_extra_out + i * 544;
    int32_t* dxo = dist_offset_out + i * 544;
    for (int k = 0; k < 544; k++) { dxe[k] = 0; dxo[k] = 0; }
    int nd = std::min<int>(544, static_cast<int>(st.dist_extra.size()));
    for (int k = 0; k < nd; k++) {
      dxe[k] = st.dist_extra[k];
      dxo[k] = st.dist_offset[k];
    }
    sc[0] = 1;
    sc[1] = mbl;
    sc[2] = br.bitpos_;
    sc[3] = st.npostfix;
    sc[4] = st.ndirect;
    sc[5] = wbits;
  }
  return 0;
}

}  // extern "C"

