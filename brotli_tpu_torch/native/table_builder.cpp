// Native Huffman table construction + histogram clustering for the device
// encoder's per-batch table build (the host-side step between the XLA
// stages and the Pallas pack kernel).
//
// Exact ports of encode/entropy.py (create_huffman_depths - the
// count-limit-retry tree build, reference entropy-encode.ts:24-131) and
// encode/cluster.py (greedy pairwise merge clustering, cluster.ts:317-378)
// including float accumulation order and tie-breaking: outputs are
// bit-identical to the python implementations (tests/test_native_tables.py
// asserts this on real + random histograms), so device-encoded streams do
// not change when the native path is used.  The python path remains the
// golden reference; this exists because the per-batch table build was
// seconds-class in python (64-256 context histograms x groups per batch)
// and caps encode throughput (VERDICT r4 weak #3).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int MAX_HUFFMAN_BITS = 15;
constexpr double LOG2_INV = 1.4426950408889634;

double log2_table[256];
bool log2_init_done = false;

void init_log2() {
    if (log2_init_done) return;
    log2_table[0] = 0.0;
    log2_table[1] = 0.0;
    for (int i = 2; i < 256; i++) log2_table[i] = std::log((double)i) * LOG2_INV;
    log2_init_done = true;
}

double fast_log2(double v) {
    if (v < 256.0) return log2_table[(int)v];
    return std::log(v) * LOG2_INV;
}

// ---------------------------------------------------------------------------
// Huffman depths (entropy.py:create_huffman_depths)
// ---------------------------------------------------------------------------

bool set_depths(int root, const std::vector<int>& node_left,
                const std::vector<int>& node_right,
                uint8_t* depths, int max_depth) {
    std::vector<std::pair<int, int>> stack;
    stack.emplace_back(root, 0);
    while (!stack.empty()) {
        auto [p, level] = stack.back();
        stack.pop_back();
        if (node_left[p] >= 0) {
            if (level + 1 > max_depth) return false;
            stack.emplace_back(node_left[p], level + 1);
            stack.emplace_back(node_right[p], level + 1);
        } else {
            depths[node_right[p]] = (uint8_t)level;
        }
    }
    return true;
}

void create_huffman_depths(const int64_t* histogram, int alphabet_size,
                           int tree_limit, uint8_t* depths) {
    std::memset(depths, 0, alphabet_size);
    int n_leaves = 0;
    int last_leaf = 0;
    for (int i = 0; i < alphabet_size; i++)
        if (histogram[i] > 0) { n_leaves++; last_leaf = i; }
    if (n_leaves == 0) return;
    if (n_leaves == 1) { depths[last_leaf] = 1; return; }

    int64_t count_limit = 1;
    for (;;) {
        // leaves in reverse symbol order, clamped counts
        std::vector<int64_t> counts;
        std::vector<int> values;
        counts.reserve(n_leaves);
        values.reserve(n_leaves);
        for (int i = alphabet_size - 1; i >= 0; i--) {
            if (histogram[i] > 0) {
                counts.push_back(std::max(histogram[i], count_limit));
                values.push_back(i);
            }
        }
        int n = (int)counts.size();
        // stable sort ascending by count, ties by larger symbol value
        std::vector<int> order(n);
        for (int k = 0; k < n; k++) order[k] = k;
        std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
            if (counts[a] != counts[b]) return counts[a] < counts[b];
            return values[a] > values[b];
        });
        std::vector<int64_t> node_count;
        std::vector<int> node_left, node_right;
        node_count.reserve(2 * n + 2);
        node_left.reserve(2 * n + 2);
        node_right.reserve(2 * n + 2);
        for (int k = 0; k < n; k++) {
            node_count.push_back(counts[order[k]]);
            node_left.push_back(-1);
            node_right.push_back(values[order[k]]);
        }
        for (int k = 0; k < 2; k++) {
            node_count.push_back(0xFFFFFFFFLL);
            node_left.push_back(-1);
            node_right.push_back(-1);
        }
        node_count.resize(2 * n + 2, 0);
        node_left.resize(2 * n + 2, 0);
        node_right.resize(2 * n + 2, 0);

        int i = 0;      // next leaf
        int j = n + 1;  // next internal node
        for (int k = n - 1; k > 0; k--) {
            int left, right;
            if (node_count[i] <= node_count[j]) { left = i; i++; }
            else { left = j; j++; }
            if (node_count[i] <= node_count[j]) { right = i; i++; }
            else { right = j; j++; }
            int j_end = 2 * n - k;
            node_count[j_end] = node_count[left] + node_count[right];
            node_left[j_end] = left;
            node_right[j_end] = right;
            if (j_end + 1 < (int)node_count.size()) {
                node_count[j_end + 1] = 0xFFFFFFFFLL;
                node_left[j_end + 1] = -1;
                node_right[j_end + 1] = -1;
            } else {
                node_count.push_back(0xFFFFFFFFLL);
                node_left.push_back(-1);
                node_right.push_back(-1);
            }
        }
        if (set_depths(2 * n - 1, node_left, node_right, depths, tree_limit))
            return;
        std::memset(depths, 0, alphabet_size);
        count_limit *= 2;
    }
}

uint16_t reverse_bits(int nbits, uint32_t bits) {
    uint32_t out = 0;
    for (int k = 0; k < nbits; k++) { out = (out << 1) | (bits & 1); bits >>= 1; }
    return (uint16_t)out;
}

void depths_to_bits(const uint8_t* depths, int n, uint16_t* bits) {
    int bl_count[MAX_HUFFMAN_BITS + 1] = {0};
    for (int i = 0; i < n; i++) bl_count[depths[i]]++;
    bl_count[0] = 0;
    uint32_t next_code[MAX_HUFFMAN_BITS + 1] = {0};
    uint32_t code = 0;
    for (int ln = 1; ln <= MAX_HUFFMAN_BITS; ln++) {
        code = (code + bl_count[ln - 1]) << 1;
        next_code[ln] = code;
    }
    for (int i = 0; i < n; i++) {
        bits[i] = 0;
        if (depths[i] > 0) bits[i] = reverse_bits(depths[i], next_code[depths[i]]++);
    }
}

// ---------------------------------------------------------------------------
// population cost (bit_cost.py) - float accumulation order preserved
// ---------------------------------------------------------------------------

constexpr int CODE_LENGTH_CODES = 18;
constexpr int REPEAT_ZERO = 17;

double bits_entropy(const int64_t* histogram, int n) {
    int64_t total = 0;
    double retval = 0.0;
    for (int i = 0; i < n; i++) {
        int64_t p = histogram[i];
        if (p > 0) {
            total += p;
            retval -= (double)p * fast_log2((double)p);
        }
    }
    if (total > 0) retval += (double)total * fast_log2((double)total);
    if (retval < (double)total) retval = (double)total;
    return retval;
}

double population_cost(const int64_t* data, int size, int64_t total_count) {
    if (total_count == 0) return 12.0;  // ONE_SYMBOL_COST
    int s[5];
    int count = 0;
    for (int i = 0; i < size && count <= 4; i++) {
        if (data[i] > 0) {
            s[count++] = i;
            if (count > 4) break;
        }
    }
    if (count == 1) return 12.0;
    if (count == 2) return 20.0 + (double)total_count;
    if (count == 3) {
        int64_t h0 = data[s[0]], h1 = data[s[1]], h2 = data[s[2]];
        int64_t mx = std::max(h0, std::max(h1, h2));
        return 28.0 + (double)(2 * (h0 + h1 + h2) - mx);
    }
    if (count == 4) {
        int64_t histo[4] = {data[s[0]], data[s[1]], data[s[2]], data[s[3]]};
        std::sort(histo, histo + 4, std::greater<int64_t>());
        int64_t h23 = histo[2] + histo[3];
        int64_t mx = std::max(h23, histo[0]);
        return 37.0 + (double)(3 * h23 + 2 * (histo[0] + histo[1]) - mx);
    }
    double bits = 0.0;
    int max_depth = 1;
    int64_t depth_histo[CODE_LENGTH_CODES] = {0};
    double log2total = fast_log2((double)total_count);
    int i = 0;
    while (i < size) {
        if (data[i] > 0) {
            double log2p = log2total - fast_log2((double)data[i]);
            int depth = (int)std::floor(log2p + 0.5);
            bits += (double)data[i] * log2p;
            if (depth > 15) depth = 15;
            if (depth > max_depth) max_depth = depth;
            depth_histo[depth]++;
            i++;
        } else {
            int64_t reps = 1;
            int k = i + 1;
            while (k < size && data[k] == 0) { reps++; k++; }
            i += (int)reps;
            if (i == size) break;
            if (reps < 3) depth_histo[0] += reps;
            else {
                reps -= 2;
                while (reps > 0) {
                    depth_histo[REPEAT_ZERO]++;
                    bits += 3;
                    reps >>= 3;
                }
            }
        }
    }
    bits += (double)(18 + 2 * max_depth);
    bits += bits_entropy(depth_histo, CODE_LENGTH_CODES);
    return bits;
}

// ---------------------------------------------------------------------------
// clustering (cluster.py / cluster.ts)
// ---------------------------------------------------------------------------

struct Hist {
    std::vector<int64_t> data;
    int64_t total_count = 0;
    double bit_cost = 0.0;

    void clear() {
        std::fill(data.begin(), data.end(), 0);
        total_count = 0;
        bit_cost = 0.0;
    }
    void copy_from(const Hist& o) {
        data = o.data;
        total_count = o.total_count;
        bit_cost = o.bit_cost;
    }
    void add(const Hist& o) {
        for (size_t k = 0; k < data.size(); k++) data[k] += o.data[k];
        total_count += o.total_count;
    }
    double compute_bit_cost() const {
        return population_cost(data.data(), (int)data.size(), total_count);
    }
};

struct Pair {
    int idx1, idx2;
    double cost_combo, cost_diff;
};

double cluster_cost_diff(int64_t size_a, int64_t size_b) {
    int64_t size_c = size_a + size_b;
    return (double)size_c * fast_log2((double)size_c)
         - (double)size_a * fast_log2((double)size_a)
         - (double)size_b * fast_log2((double)size_b);
}

bool pair_is_less(const Pair& a, const Pair& b) {
    if (a.cost_diff != b.cost_diff) return a.cost_diff > b.cost_diff;
    return (a.idx2 - a.idx1) > (b.idx2 - b.idx1);
}

void compare_and_push(std::vector<Hist>& out, Hist& tmp,
                      const std::vector<int64_t>& cluster_size,
                      int idx1, int idx2, size_t max_num_pairs,
                      std::vector<Pair>& pairs) {
    if (idx1 == idx2) return;
    if (idx2 < idx1) std::swap(idx1, idx2);
    Pair p;
    p.idx1 = idx1;
    p.idx2 = idx2;
    p.cost_combo = 0.0;
    p.cost_diff = 0.5 * cluster_cost_diff(cluster_size[idx1], cluster_size[idx2]);
    p.cost_diff -= out[idx1].bit_cost;
    p.cost_diff -= out[idx2].bit_cost;

    bool is_good = false;
    if (out[idx1].total_count == 0) {
        p.cost_combo = out[idx2].bit_cost;
        is_good = true;
    } else if (out[idx2].total_count == 0) {
        p.cost_combo = out[idx1].bit_cost;
        is_good = true;
    } else {
        double threshold = pairs.empty() ? 1e99 : std::max(0.0, pairs[0].cost_diff);
        tmp.copy_from(out[idx1]);
        tmp.add(out[idx2]);
        double cost_combo = tmp.compute_bit_cost();
        if (cost_combo < threshold - p.cost_diff) {
            p.cost_combo = cost_combo;
            is_good = true;
        }
    }
    if (is_good) {
        p.cost_diff += p.cost_combo;
        if (!pairs.empty() && pair_is_less(pairs[0], p)) {
            if (pairs.size() < max_num_pairs) pairs.push_back(pairs[0]);
            pairs[0] = p;
        } else if (pairs.size() < max_num_pairs) {
            pairs.push_back(p);
        }
    }
}

int histogram_combine(std::vector<Hist>& out, Hist& tmp,
                      std::vector<int64_t>& cluster_size,
                      std::vector<int>& symbols,
                      std::vector<int>& clusters, int num_clusters,
                      int symbols_off, int symbols_size,
                      int max_clusters, size_t max_num_pairs) {
    double cost_diff_threshold = 0.0;
    int min_cluster_size = 1;
    std::vector<Pair> pairs;

    for (int i1 = 0; i1 < num_clusters; i1++)
        for (int i2 = i1 + 1; i2 < num_clusters; i2++)
            compare_and_push(out, tmp, cluster_size, clusters[i1],
                             clusters[i2], max_num_pairs, pairs);

    while (num_clusters > min_cluster_size) {
        if (pairs[0].cost_diff >= cost_diff_threshold) {
            cost_diff_threshold = 1e99;
            min_cluster_size = max_clusters;
            continue;
        }
        int best1 = pairs[0].idx1;
        int best2 = pairs[0].idx2;
        out[best1].add(out[best2]);
        out[best1].bit_cost = pairs[0].cost_combo;
        cluster_size[best1] += cluster_size[best2];
        for (int i = 0; i < symbols_size; i++)
            if (symbols[symbols_off + i] == best2)
                symbols[symbols_off + i] = best1;
        for (int i = 0; i < num_clusters; i++) {
            if (clusters[i] == best2) {
                clusters.erase(clusters.begin() + i);
                clusters.push_back(0);  // keep backing length stable
                break;
            }
        }
        num_clusters--;

        // drop invalidated pairs in place, keeping best at slot 0
        size_t copy_to = 0;
        for (size_t i = 0; i < pairs.size(); i++) {
            Pair p = pairs[i];
            if (p.idx1 == best1 || p.idx1 == best2 || p.idx2 == best1 ||
                p.idx2 == best2)
                continue;
            if (pair_is_less(pairs[0], p)) {
                Pair front = pairs[0];
                pairs[0] = p;
                pairs[copy_to] = front;
            } else {
                pairs[copy_to] = p;
            }
            copy_to++;
        }
        pairs.resize(copy_to);

        for (int i = 0; i < num_clusters; i++)
            compare_and_push(out, tmp, cluster_size, best1, clusters[i],
                             max_num_pairs, pairs);
    }
    return num_clusters;
}

double bit_cost_distance(const Hist& histogram, const Hist& candidate, Hist& tmp) {
    if (histogram.total_count == 0) return 0.0;
    tmp.copy_from(histogram);
    tmp.add(candidate);
    return tmp.compute_bit_cost() - candidate.bit_cost;
}

void histogram_remap(const std::vector<Hist>& inputs, int in_size,
                     const std::vector<int>& clusters, int num_clusters,
                     std::vector<Hist>& out, Hist& tmp,
                     std::vector<int>& symbols) {
    for (int i = 0; i < in_size; i++) {
        int best_out = (i == 0) ? symbols[0] : symbols[i - 1];
        double best_bits = bit_cost_distance(inputs[i], out[best_out], tmp);
        for (int j = 0; j < num_clusters; j++) {
            double cur = bit_cost_distance(inputs[i], out[clusters[j]], tmp);
            if (cur < best_bits) {
                best_bits = cur;
                best_out = clusters[j];
            }
        }
        symbols[i] = best_out;
    }
    for (int j = 0; j < num_clusters; j++) out[clusters[j]].clear();
    for (int i = 0; i < in_size; i++) out[symbols[i]].add(inputs[i]);
}

int histogram_reindex(std::vector<Hist>& out, std::vector<int>& symbols,
                      int length) {
    std::vector<int> new_index(length, -1);
    int next_index = 0;
    for (int i = 0; i < length; i++)
        if (new_index[symbols[i]] == -1) new_index[symbols[i]] = next_index++;
    std::vector<Hist> tmp(next_index);
    next_index = 0;
    for (int i = 0; i < length; i++) {
        if (new_index[symbols[i]] == next_index) {
            tmp[next_index].copy_from(out[symbols[i]]);
            next_index++;
        }
        symbols[i] = new_index[symbols[i]];
    }
    for (size_t i = 0; i < tmp.size(); i++) out[i].copy_from(tmp[i]);
    return (int)tmp.size();
}

}  // namespace

extern "C" {

// depths (u8[n]) and bits (u16[n]); mirrors entropy.build_huffman_code for
// count >= 2 (callers handle the trivial 0/1-symbol cases).
void native_build_huffman_code(const int64_t* hist, int n, uint8_t* depths,
                               uint16_t* bits) {
    init_log2();
    create_huffman_depths(hist, n, MAX_HUFFMAN_BITS, depths);
    depths_to_bits(depths, n, bits);
}

// hists: rows x syms int64, row-major.  Writes cmap[rows]; returns cluster
// count.  Mirror of metablock_full._cluster_and_build_context_map.
int native_cluster_context_map(const int64_t* hists, int rows, int syms,
                               int max_histograms, int32_t* cmap) {
    init_log2();
    if (rows <= 1) {
        if (rows == 1) cmap[0] = 0;
        return 1;
    }
    std::vector<Hist> inputs(rows), out(rows);
    for (int r = 0; r < rows; r++) {
        inputs[r].data.assign(hists + (size_t)r * syms,
                              hists + (size_t)(r + 1) * syms);
        int64_t t = 0;
        for (int k = 0; k < syms; k++) t += inputs[r].data[k];
        inputs[r].total_count = t;
        inputs[r].bit_cost = inputs[r].compute_bit_cost();
        out[r].data.assign((size_t)syms, 0);
    }
    std::vector<int> symbols(rows, 0);
    std::vector<int64_t> cluster_size(rows, 1);
    std::vector<int> clusters(rows, 0);
    constexpr int MAX_INPUT = 64;
    size_t pairs_capacity = (MAX_INPUT * MAX_INPUT) / 2;
    Hist tmp;
    tmp.data.assign((size_t)syms, 0);

    for (int i = 0; i < rows; i++) {
        out[i].copy_from(inputs[i]);
        out[i].bit_cost = inputs[i].compute_bit_cost();
        symbols[i] = i;
    }
    int num_clusters = 0;
    for (int i = 0; i < rows; i += MAX_INPUT) {
        int num_to_combine = std::min(rows - i, MAX_INPUT);
        std::vector<int> batch_clusters(num_to_combine);
        for (int k = 0; k < num_to_combine; k++) batch_clusters[k] = i + k;
        int num_new = histogram_combine(
            out, tmp, cluster_size, symbols, batch_clusters, num_to_combine,
            i, num_to_combine, max_histograms, pairs_capacity);
        for (int k = 0; k < num_new; k++)
            clusters[num_clusters + k] = batch_clusters[k];
        num_clusters += num_new;
    }
    size_t max_num_pairs = std::min((size_t)(64 * num_clusters),
                                    (size_t)((num_clusters / 2) * num_clusters));
    std::vector<int> live(clusters.begin(), clusters.begin() + num_clusters);
    live.resize(rows, 0);
    num_clusters = histogram_combine(out, tmp, cluster_size, symbols, live,
                                     num_clusters, 0, rows, max_histograms,
                                     max_num_pairs);
    histogram_remap(inputs, rows, live, num_clusters, out, tmp, symbols);
    int n = histogram_reindex(out, symbols, rows);
    for (int r = 0; r < rows; r++) cmap[r] = symbols[r];
    return n;
}

}  // extern "C"
