"""Greedy histogram clustering (cluster.ts).

Pairwise merges with a cost-diff priority queue; batch-of-64 first pass then
a global pass; remap + canonical reindex.  Tie-breaking in the queue
(histogramPairIsLess) decides context maps and must match the reference.
"""

from __future__ import annotations

import numpy as np

from .bit_cost import population_cost
from .cost_model import fast_log2


class ClusterHistogram:
    __slots__ = ("data", "total_count", "bit_cost")

    def __init__(self, size: int):
        self.data = np.zeros(size, dtype=np.int64)
        self.total_count = 0
        self.bit_cost = 0.0

    def clear(self):
        self.data[:] = 0
        self.total_count = 0
        self.bit_cost = 0.0

    def copy_from(self, other: "ClusterHistogram"):
        self.data[:] = other.data
        self.total_count = other.total_count
        self.bit_cost = other.bit_cost

    def add(self, other: "ClusterHistogram"):
        self.data += other.data
        self.total_count += other.total_count

    def compute_bit_cost(self) -> float:
        return population_cost(self.data, self.total_count)


class _Pair:
    __slots__ = ("idx1", "idx2", "cost_combo", "cost_diff")

    def __init__(self, idx1, idx2, cost_combo, cost_diff):
        self.idx1 = idx1
        self.idx2 = idx2
        self.cost_combo = cost_combo
        self.cost_diff = cost_diff


def _cluster_cost_diff(size_a: int, size_b: int) -> float:
    size_c = size_a + size_b
    return (
        size_c * fast_log2(size_c)
        - size_a * fast_log2(size_a)
        - size_b * fast_log2(size_b)
    )


def _pair_is_less(a: _Pair, b: _Pair) -> bool:
    if a.cost_diff != b.cost_diff:
        return a.cost_diff > b.cost_diff
    return (a.idx2 - a.idx1) > (b.idx2 - b.idx1)


def _compare_and_push(out, tmp, cluster_size, idx1, idx2, max_num_pairs, pairs):
    """pairs is a list; index 0 holds the best pair (cluster.ts:65-132)."""
    if idx1 == idx2:
        return
    if idx2 < idx1:
        idx1, idx2 = idx2, idx1
    cost_diff = 0.5 * _cluster_cost_diff(cluster_size[idx1], cluster_size[idx2])
    cost_diff -= out[idx1].bit_cost
    cost_diff -= out[idx2].bit_cost
    p = _Pair(idx1, idx2, 0.0, cost_diff)

    is_good = False
    if out[idx1].total_count == 0:
        p.cost_combo = out[idx2].bit_cost
        is_good = True
    elif out[idx2].total_count == 0:
        p.cost_combo = out[idx1].bit_cost
        is_good = True
    else:
        threshold = 1e99 if not pairs else max(0.0, pairs[0].cost_diff)
        tmp.copy_from(out[idx1])
        tmp.add(out[idx2])
        cost_combo = tmp.compute_bit_cost()
        if cost_combo < threshold - p.cost_diff:
            p.cost_combo = cost_combo
            is_good = True

    if is_good:
        p.cost_diff += p.cost_combo
        if pairs and _pair_is_less(pairs[0], p):
            if len(pairs) < max_num_pairs:
                pairs.append(pairs[0])
            pairs[0] = p
        elif len(pairs) < max_num_pairs:
            pairs.append(p)


def _histogram_combine(
    out, tmp, cluster_size, symbols, clusters, num_clusters,
    symbols_off, symbols_size, max_clusters, max_num_pairs,
) -> int:
    """clusters is a mutable list view; symbols indexed from symbols_off."""
    cost_diff_threshold = 0.0
    min_cluster_size = 1
    pairs: list[_Pair] = []

    for i1 in range(num_clusters):
        for i2 in range(i1 + 1, num_clusters):
            _compare_and_push(
                out, tmp, cluster_size, clusters[i1], clusters[i2],
                max_num_pairs, pairs,
            )

    while num_clusters > min_cluster_size:
        if pairs[0].cost_diff >= cost_diff_threshold:
            cost_diff_threshold = 1e99
            min_cluster_size = max_clusters
            continue
        best1 = pairs[0].idx1
        best2 = pairs[0].idx2
        out[best1].add(out[best2])
        out[best1].bit_cost = pairs[0].cost_combo
        cluster_size[best1] += cluster_size[best2]
        for i in range(symbols_size):
            if symbols[symbols_off + i] == best2:
                symbols[symbols_off + i] = best1
        for i in range(num_clusters):
            if clusters[i] == best2:
                del clusters[i:i + 1]
                clusters.append(0)  # keep backing length stable (unused tail)
                break
        num_clusters -= 1

        # drop invalidated pairs in place, keeping best at slot 0
        # (faithful to cluster.ts:191-208 incl. its evolving-front compare)
        copy_to = 0
        for i in range(len(pairs)):
            p = pairs[i]
            if p.idx1 in (best1, best2) or p.idx2 in (best1, best2):
                continue
            if _pair_is_less(pairs[0], p):
                front = pairs[0]
                pairs[0] = p
                pairs[copy_to] = front
            else:
                pairs[copy_to] = p
            copy_to += 1
        del pairs[copy_to:]

        for i in range(num_clusters):
            _compare_and_push(
                out, tmp, cluster_size, best1, clusters[i], max_num_pairs, pairs
            )
    return num_clusters


def _bit_cost_distance(histogram, candidate, tmp) -> float:
    if histogram.total_count == 0:
        return 0.0
    tmp.copy_from(histogram)
    tmp.add(candidate)
    return tmp.compute_bit_cost() - candidate.bit_cost


def _histogram_remap(inputs, in_size, clusters, num_clusters, out, tmp, symbols):
    for i in range(in_size):
        best_out = symbols[0] if i == 0 else symbols[i - 1]
        best_bits = _bit_cost_distance(inputs[i], out[best_out], tmp)
        for j in range(num_clusters):
            cur = _bit_cost_distance(inputs[i], out[clusters[j]], tmp)
            if cur < best_bits:
                best_bits = cur
                best_out = clusters[j]
        symbols[i] = best_out
    for j in range(num_clusters):
        out[clusters[j]].clear()
    for i in range(in_size):
        out[symbols[i]].add(inputs[i])


def _histogram_reindex(out, symbols, length) -> int:
    INVALID = -1
    new_index = [INVALID] * length
    next_index = 0
    for i in range(length):
        if new_index[symbols[i]] == INVALID:
            new_index[symbols[i]] = next_index
            next_index += 1
    tmp = [ClusterHistogram(len(out[0].data)) for _ in range(next_index)]
    next_index = 0
    for i in range(length):
        if new_index[symbols[i]] == next_index:
            tmp[next_index].copy_from(out[symbols[i]])
            next_index += 1
        symbols[i] = new_index[symbols[i]]
    for i, t in enumerate(tmp):
        out[i].copy_from(t)
    return len(tmp)


def cluster_histograms(inputs, in_size, max_histograms, out, symbols) -> int:
    """Cluster `inputs` into <= max_histograms; fills `out` and `symbols`.

    `symbols` is a list of length in_size (modified in place).
    Returns number of clusters.
    """
    data_size = len(inputs[0].data)
    cluster_size = [1] * in_size
    clusters = [0] * in_size
    MAX_INPUT = 64
    pairs_capacity = (MAX_INPUT * MAX_INPUT) // 2
    tmp = ClusterHistogram(data_size)

    for i in range(in_size):
        out[i].copy_from(inputs[i])
        out[i].bit_cost = inputs[i].compute_bit_cost()
        symbols[i] = i

    num_clusters = 0
    i = 0
    while i < in_size:
        num_to_combine = min(in_size - i, MAX_INPUT)
        batch_clusters = list(range(i, i + num_to_combine))
        num_new = _histogram_combine(
            out, tmp, cluster_size, symbols, batch_clusters, num_to_combine,
            i, num_to_combine, max_histograms, pairs_capacity,
        )
        clusters[num_clusters : num_clusters + num_new] = batch_clusters[:num_new]
        num_clusters += num_new
        i += MAX_INPUT

    max_num_pairs = min(64 * num_clusters, (num_clusters // 2) * num_clusters)
    live_clusters = clusters[:num_clusters] + [0] * (in_size - num_clusters)
    num_clusters = _histogram_combine(
        out, tmp, cluster_size, symbols, live_clusters, num_clusters,
        0, in_size, max_histograms, max_num_pairs,
    )
    _histogram_remap(inputs, in_size, live_clusters, num_clusters, out, tmp, symbols)
    return _histogram_reindex(out, symbols, in_size)
