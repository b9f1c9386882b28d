// One stream header of the device encoder, built on the host: the C++
// counterpart of ops/encode_host._header_bits (the window bits and the
// metablock header of encode/bitwriter.py and encode/metablock.py, the
// literal block-split trees, encode/context_map.py's context-map coding
// and encode/entropy.py's tree storage), called by
// ops/encode_host._header_words_native.  Every step is the Python one
// written again with the same integers, so the bits are the same.
//
// brotli_enc_cluster_groups runs table_builder.cpp's context-map
// clustering for several table groups at once over threads.
//
// Built as a library of its own, never linked beside table_builder.cpp's:
// it includes table_builder.cpp for create_huffman_depths and
// depths_to_bits (entropy.py's), which sit in that file's anonymous
// namespace.

#include "table_builder.cpp"

#include <algorithm>
#include <thread>

namespace {

constexpr int REPEAT_PREVIOUS = 16;
constexpr int STORAGE_ORDER[CODE_LENGTH_CODES] = {
    1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15};
constexpr int CLCL_SYMBOLS[6] = {0, 7, 3, 2, 1, 15};
constexpr int CLCL_NBITS[6] = {2, 4, 3, 2, 2, 4};

// BitWriter: LSB first, whole bytes flushed
struct Writer {
    std::vector<uint8_t> out;
    uint64_t acc = 0;
    int nbits = 0;

    void write(int n, uint64_t v) {
        acc |= (v & ((1ull << n) - 1)) << nbits;
        nbits += n;
        while (nbits >= 8) {
            out.push_back((uint8_t)(acc & 0xFF));
            acc >>= 8;
            nbits -= 8;
        }
    }
    int64_t bit_pos() const { return (int64_t)out.size() * 8 + nbits; }
};

int bit_length(uint64_t v) {
    int n = 0;
    while (v) { n++; v >>= 1; }
    return n;
}

void store_var_len_uint8(Writer& w, int n) {
    if (n == 0) {
        w.write(1, 0);
    } else {
        int nb = bit_length((uint64_t)n) - 1;
        w.write(1, 1);
        w.write(3, nb);
        w.write(nb, (uint64_t)(n - (1 << nb)));
    }
}

// a built code: entropy.build_huffman_code's (depths, bits, count, s4)
struct Code {
    std::vector<uint8_t> depths;
    std::vector<uint16_t> bits;
    int count = 0;
    int s4[4] = {0, 0, 0, 0};
};

Code build_code(const int64_t* hist, int n) {
    Code c;
    c.depths.assign(n, 0);
    c.bits.assign(n, 0);
    for (int i = 0; i < n; i++) {
        if (hist[i]) {
            if (c.count < 4) c.s4[c.count] = i;
            c.count++;
        }
    }
    if (c.count <= 1) return c;
    create_huffman_depths(hist, n, MAX_HUFFMAN_BITS, c.depths.data());
    depths_to_bits(c.depths.data(), n, c.bits.data());
    return c;
}

void write_tree_repetitions(int prev, int value, int reps,
                            std::vector<int>& tree, std::vector<int>& extra) {
    if (prev != value) {
        tree.push_back(value);
        extra.push_back(0);
        reps--;
    }
    if (reps == 7) {
        tree.push_back(value);
        extra.push_back(0);
        reps--;
    }
    if (reps < 3) {
        for (int k = 0; k < reps; k++) {
            tree.push_back(value);
            extra.push_back(0);
        }
    } else {
        reps -= 3;
        size_t start = tree.size();
        while (true) {
            tree.push_back(REPEAT_PREVIOUS);
            extra.push_back(reps & 3);
            reps >>= 2;
            if (reps == 0) break;
            reps--;
        }
        std::reverse(tree.begin() + start, tree.end());
        std::reverse(extra.begin() + start, extra.end());
    }
}

void write_tree_zeros(int reps, std::vector<int>& tree,
                      std::vector<int>& extra) {
    if (reps == 11) {
        tree.push_back(0);
        extra.push_back(0);
        reps--;
    }
    if (reps < 3) {
        for (int k = 0; k < reps; k++) {
            tree.push_back(0);
            extra.push_back(0);
        }
    } else {
        reps -= 3;
        size_t start = tree.size();
        while (true) {
            tree.push_back(REPEAT_ZERO);
            extra.push_back(reps & 7);
            reps >>= 3;
            if (reps == 0) break;
            reps--;
        }
        std::reverse(tree.begin() + start, tree.end());
        std::reverse(extra.begin() + start, extra.end());
    }
}

void store_code_length_code(Writer& w, int num_codes, const uint8_t* cl) {
    int codes_to_store = CODE_LENGTH_CODES;
    if (num_codes > 1) {
        while (codes_to_store > 0 &&
               cl[STORAGE_ORDER[codes_to_store - 1]] == 0)
            codes_to_store--;
    }
    int skip_some = 0;
    if (cl[STORAGE_ORDER[0]] == 0 && cl[STORAGE_ORDER[1]] == 0) {
        skip_some = 2;
        if (cl[STORAGE_ORDER[2]] == 0) skip_some = 3;
    }
    w.write(2, skip_some);
    for (int i = skip_some; i < codes_to_store; i++) {
        int ln = cl[STORAGE_ORDER[i]];
        w.write(CLCL_NBITS[ln], CLCL_SYMBOLS[ln]);
    }
}

void store_complex_tree(Writer& w, const uint8_t* depths, int length) {
    std::vector<int> tree, extra;
    int new_length = length;
    while (new_length > 0 && depths[new_length - 1] == 0) new_length--;
    int prev = 8;
    int i = 0;
    while (i < new_length) {
        int value = depths[i];
        int reps = 1;
        while (i + reps < new_length && depths[i + reps] == value) reps++;
        i += reps;
        if (value == 0) {
            write_tree_zeros(reps, tree, extra);
        } else {
            write_tree_repetitions(prev, value, reps, tree, extra);
            prev = value;
        }
    }
    int64_t cl_hist[CODE_LENGTH_CODES] = {0};
    for (int code : tree) cl_hist[code]++;
    int num_codes = 0, first_code = 0;
    for (int k = 0; k < CODE_LENGTH_CODES; k++) {
        if (cl_hist[k]) {
            if (num_codes == 0) first_code = k;
            num_codes++;
        }
    }
    uint8_t cl_depths[CODE_LENGTH_CODES];
    uint16_t cl_bits[CODE_LENGTH_CODES];
    create_huffman_depths(cl_hist, CODE_LENGTH_CODES, 5, cl_depths);
    depths_to_bits(cl_depths, CODE_LENGTH_CODES, cl_bits);
    store_code_length_code(w, num_codes, cl_depths);
    if (num_codes == 1) cl_depths[first_code] = 0;
    for (size_t k = 0; k < tree.size(); k++) {
        int code = tree[k];
        w.write(cl_depths[code], cl_bits[code]);
        if (code == REPEAT_PREVIOUS) w.write(2, extra[k]);
        else if (code == REPEAT_ZERO) w.write(3, extra[k]);
    }
}

void store_tree(Writer& w, const uint8_t* depths, int alphabet_size,
                int count, const int* s4) {
    int max_bits = bit_length((uint64_t)(alphabet_size - 1));
    if (count <= 1) {
        w.write(4, 1);
        w.write(max_bits, s4[0]);
    } else if (count <= 4) {
        int syms[4];
        std::copy(s4, s4 + count, syms);
        std::stable_sort(syms, syms + count, [&](int a, int b) {
            return depths[a] < depths[b];
        });
        w.write(2, 1);
        w.write(2, count - 1);
        for (int k = 0; k < count; k++) w.write(max_bits, syms[k]);
        if (count == 4) w.write(1, depths[syms[0]] == 1 ? 1 : 0);
    } else {
        store_complex_tree(w, depths, alphabet_size);
    }
}

Code build_and_store(Writer& w, const int64_t* hist, int n) {
    Code c = build_code(hist, n);
    store_tree(w, c.depths.data(), n, c.count, c.s4);
    return c;
}

void encode_context_map(Writer& w, const std::vector<int>& cmap,
                        int num_clusters) {
    store_var_len_uint8(w, num_clusters - 1);
    if (num_clusters == 1) return;
    // move-to-front
    int mx = 0;
    for (int v : cmap) mx = std::max(mx, v);
    std::vector<int> mtf(mx + 1);
    for (int k = 0; k <= mx; k++) mtf[k] = k;
    std::vector<int> vals;
    vals.reserve(cmap.size());
    for (int v : cmap) {
        int idx = (int)(std::find(mtf.begin(), mtf.end(), v) - mtf.begin());
        vals.push_back(idx);
        if (idx) {
            mtf.erase(mtf.begin() + idx);
            mtf.insert(mtf.begin(), v);
        }
    }
    // zero runs
    const int n = (int)vals.size();
    int max_reps = 0;
    for (int i = 0; i < n;) {
        while (i < n && vals[i] != 0) i++;
        int reps = 0;
        while (i < n && vals[i] == 0) { reps++; i++; }
        max_reps = std::max(max_reps, reps);
    }
    int max_prefix = max_reps > 0 ? bit_length((uint64_t)max_reps) - 1 : 0;
    max_prefix = std::min(max_prefix, 6);
    std::vector<int> rle;
    for (int i = 0; i < n;) {
        if (vals[i] != 0) {
            rle.push_back(vals[i] + max_prefix);
            i++;
        } else {
            int reps = 1;
            int k = i + 1;
            while (k < n && vals[k] == 0) { reps++; k++; }
            i += reps;
            while (reps != 0) {
                if (reps < (2 << max_prefix)) {
                    int prefix = bit_length((uint64_t)reps) - 1;
                    int ex = reps - (1 << prefix);
                    rle.push_back(prefix | (ex << 9));
                    break;
                }
                rle.push_back(max_prefix | (((1 << max_prefix) - 1) << 9));
                reps -= (2 << max_prefix) - 1;
            }
        }
    }
    const int alpha = num_clusters + max_prefix;
    std::vector<int64_t> hist(alpha, 0);
    for (int s : rle) hist[s & 0x1FF]++;
    bool use_rle = max_prefix > 0;
    w.write(1, use_rle ? 1 : 0);
    if (use_rle) w.write(4, max_prefix - 1);
    Code c = build_and_store(w, hist.data(), alpha);
    for (int s : rle) {
        int sym = s & 0x1FF;
        w.write(c.depths[sym], c.bits[sym]);
        if (0 < sym && sym <= max_prefix) w.write(sym, s >> 9);
    }
    w.write(1, 1);  // IMTF flag
}

}  // namespace

extern "C" {

// _header_bits(mlen, lgwin, tables, split): writes the header's bytes (the
// last one zero-padded, as BitWriter.finish) to `out` and returns its bit
// count, or -1 when `cap` bytes are too few.  Trees: `meta` rows of five
// int32 a tree (count, s4[4]), the nt literal trees, then the command and
// the distance tree; `depths` the same trees' depths, 256 a literal tree,
// then 704, then `dist_alphabet`.  cmap: nbt * 64 entries.  nbt > 1 adds
// the block-split trees (thist nbt + 2, lhist 26 counts) and the first
// block length; blen_offset and blen_nbits are constants.BLOCK_LENGTH_*.
int64_t brotli_enc_header(int mlen, int lgwin, int nt, const uint8_t* depths,
                          const int32_t* meta, int dist_alphabet,
                          const int32_t* cmap_in, int mode, int nbt,
                          const int64_t* thist, const int64_t* lhist,
                          int first_blen, int t0, const int32_t* blen_offset,
                          const int32_t* blen_nbits, uint8_t* out,
                          int64_t cap) {
    Writer w;
    w.out.reserve(4096);
    // encode_window_bits(lgwin, false)
    if (lgwin == 16) w.write(1, 0);
    else if (lgwin == 17) w.write(7, 1);
    else if (lgwin > 17 && lgwin <= 24) w.write(4, ((lgwin - 17) << 1) | 1);
    else w.write(7, ((lgwin - 8) << 4) | 1);
    // store_compressed_metablock_header(w, True, mlen)
    w.write(1, 1);
    w.write(1, 0);
    int lg = mlen == 1 ? 1 : bit_length((uint64_t)(mlen - 1));
    int mnibbles = (lg < 16 ? 16 : lg + 3) / 4;
    w.write(2, mnibbles - 4);
    w.write(mnibbles * 4, (uint64_t)(mlen - 1));
    if (nbt > 1) {
        store_var_len_uint8(w, nbt - 1);
        build_and_store(w, thist, nbt + 2);
        Code lc = build_and_store(w, lhist, 26);
        int code = 0;   // searchsorted(BLOCK_LENGTH_OFFSET, fb, right) - 1
        for (int k = 0; k < 26; k++)
            if (blen_offset[k] <= first_blen) code = k;
        w.write(lc.depths[code], lc.bits[code]);
        w.write(blen_nbits[code], (uint64_t)(first_blen - blen_offset[code]));
    } else {
        store_var_len_uint8(w, 0);
    }
    store_var_len_uint8(w, 0);
    store_var_len_uint8(w, 0);
    w.write(2, 0);
    w.write(4, 0);
    int m = nt > 1 ? mode : 0;
    for (int k = 0; k < nbt; k++) w.write(2, m);
    std::vector<int> cmap(cmap_in, cmap_in + nbt * 64);
    if (nbt > 1) {
        std::vector<int> rows(nbt);
        for (int r = 0; r < nbt; r++) rows[r] = r;
        std::swap(rows[0], rows[t0]);
        for (int r = 0; r < nbt; r++)
            for (int c = 0; c < 64; c++)
                cmap[r * 64 + c] = cmap_in[rows[r] * 64 + c];
    }
    encode_context_map(w, cmap, nt);
    store_var_len_uint8(w, 0);   // the trivial distance context map
    for (int t = 0; t < nt; t++)
        store_tree(w, depths + t * 256, 256, meta[t * 5], meta + t * 5 + 1);
    store_tree(w, depths + nt * 256, 704, meta[nt * 5], meta + nt * 5 + 1);
    store_tree(w, depths + nt * 256 + 704, dist_alphabet, meta[nt * 5 + 5],
               meta + nt * 5 + 6);
    int64_t bits = w.bit_pos();
    if (w.nbits) w.out.push_back((uint8_t)(w.acc & 0xFF));
    if ((int64_t)w.out.size() > cap) return -1;
    std::copy(w.out.begin(), w.out.end(), out);
    return bits;
}

// native_cluster_context_map of each of `groups` (rows x syms) int64
// histogram blocks, the groups over `n_threads` threads: block g's map
// into cmaps[g * rows ...] and its cluster count into counts[g].
void brotli_enc_cluster_groups(const int64_t* hists, int groups, int rows,
                               int syms, int max_histograms, int32_t* cmaps,
                               int32_t* counts, int n_threads) {
    init_log2();
    n_threads = std::max(1, std::min(n_threads, groups));
    auto work = [&](int t) {
        for (int g = t; g < groups; g += n_threads)
            counts[g] = native_cluster_context_map(
                hists + (size_t)g * rows * syms, rows, syms, max_histograms,
                cmaps + (size_t)g * rows);
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < n_threads; t++) pool.emplace_back(work, t);
    work(0);
    for (auto& th : pool) th.join();
}

}  // extern "C"
